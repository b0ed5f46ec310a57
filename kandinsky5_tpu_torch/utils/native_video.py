"""ctypes binding for the native C++ video writer (``native/video_writer.cc``).

Counterpart of ``kandinsky5_tpu/utils/native_video.py``. The writer is
compiled from source with ``g++`` into the port's build directory at first
use (and again when the source changes), never loaded from a prebuilt
binary, so it matches the machine it runs on. It converts RGB frames to
YUV420 and pipes a y4m stream into ffmpeg (libx264), or writes the raw
``.y4m`` when no ffmpeg exists.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO, "native", "video_writer.cc")
BUILD_ROOT = os.path.join(_REPO, "kandinsky5_tpu_torch", "_build")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _build() -> Optional[str]:
    if not os.path.exists(SOURCE) or shutil.which("g++") is None:
        return None
    with open(SOURCE, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:16]
    out_dir = os.path.join(BUILD_ROOT, f"video-{tag}")
    lib = os.path.join(out_dir, "libk5video.so")
    if not os.path.exists(lib):
        os.makedirs(out_dir, exist_ok=True)
        tmp = f"{lib}.{os.getpid()}.tmp"
        res = subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                              "-o", tmp, SOURCE], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"building the video writer failed:\n{res.stderr}")
        os.replace(tmp, lib)
    return lib


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    with _lock:
        if _lib is None:
            path = _build()
            if path is None:
                return None
            lib = ctypes.CDLL(path)
            lib.vw_open.restype = ctypes.c_void_p
            lib.vw_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
            lib.vw_write_frames.restype = ctypes.c_int
            lib.vw_write_frames.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_int]
            lib.vw_close.restype = ctypes.c_int
            lib.vw_close.argtypes = [ctypes.c_void_p]
            _lib = lib
    return _lib


def ffmpeg_exe() -> str:
    """An ffmpeg binary: imageio-ffmpeg's if installed, else one on PATH."""
    try:
        import imageio_ffmpeg

        return imageio_ffmpeg.get_ffmpeg_exe()
    except ImportError:
        return shutil.which("ffmpeg") or ""


def write_video_native(path: str, frames: np.ndarray, fps: int = 24,
                       crf: int = 5) -> bool:
    """frames (T, H, W, 3) uint8. Returns False when the writer or, for a
    non-.y4m path, an encoder is unavailable."""
    lib = _load()
    if lib is None:
        return False
    frames = np.ascontiguousarray(frames, dtype=np.uint8)
    t, h, w, c = frames.shape
    if c != 3:
        raise ValueError(f"frames must be RGB, got {frames.shape}")
    ffmpeg = ffmpeg_exe()
    if not ffmpeg and not path.endswith(".y4m"):
        return False
    handle = lib.vw_open(path.encode(), ffmpeg.encode(), w, h, fps, crf)
    if not handle:
        return False
    try:
        rc = lib.vw_write_frames(handle, frames.ctypes.data_as(ctypes.c_char_p), t)
    finally:
        rc_close = lib.vw_close(handle)
    return rc == 0 and rc_close == 0
