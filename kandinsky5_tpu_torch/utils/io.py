"""Checkpoint shard loading and the video and image writers of the port.

Counterpart of ``kandinsky5_tpu/utils/io.py``: safetensors checkpoints as
one file, a directory of shards or an HF shard index; mp4 at 24 fps through
the native writer and ffmpeg, a raw ``.y4m`` beside the requested path where
no encoder exists, and stills through Pillow.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np
import torch

from kandinsky5_tpu_torch.utils.native_video import write_video_native


def load_sharded_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A safetensors checkpoint as CPU tensors in their stored dtype: one
    file, a directory with an HF shard index
    (``model.safetensors.index.json``: the shards it names), or a directory
    of ``*.safetensors`` files. No fp32 copy is made: a bf16 7B checkpoint
    stays 15 GB."""
    from safetensors.torch import load_file

    if os.path.isfile(path):
        files = [path]
    else:
        index = os.path.join(path, "model.safetensors.index.json")
        if os.path.exists(index):
            with open(index) as f:
                names = sorted(set(json.load(f)["weight_map"].values()))
            files = [os.path.join(path, n) for n in names]
        else:
            files = sorted(os.path.join(path, f) for f in os.listdir(path)
                           if f.endswith(".safetensors"))
    out: Dict[str, torch.Tensor] = {}
    for file in files:
        out.update(load_file(file))
    return out


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
