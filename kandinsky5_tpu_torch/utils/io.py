"""Video and image writers for the PyTorch port.

Counterpart of the media half of ``kandinsky5_tpu/utils/io.py``: mp4 at
24 fps through the native writer and ffmpeg, a raw ``.y4m`` beside the
requested path where no encoder exists, and stills through Pillow.
"""

from __future__ import annotations

import numpy as np

from kandinsky5_tpu_torch.utils.native_video import write_video_native


def write_video(path: str, frames: np.ndarray, fps: int = 24,
                crf: int = 5) -> str:
    """frames (T, H, W, 3) uint8 -> mp4 at ``path``, or, with no encoder,
    the raw stream at ``path`` with a ``.y4m`` suffix. Returns the path
    written."""
    if write_video_native(path, frames, fps=fps, crf=crf):
        return path
    y4m = path.rsplit(".", 1)[0] + ".y4m"
    if not write_video_native(y4m, frames, fps=fps):
        raise RuntimeError("no usable video writer (g++ or ffmpeg missing)")
    return y4m


def write_image(path: str, frame: np.ndarray) -> str:
    """frame (H, W, 3) uint8 -> an image file at ``path`` (format from its
    suffix)."""
    from PIL import Image

    Image.fromarray(np.asarray(frame, dtype=np.uint8)).save(path)
    return path
