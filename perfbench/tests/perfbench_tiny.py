"""Small sizes of the benchmark's cells for the CPU tests: the published
structure, cut in width and depth, run through the harness on the CPU (the
port's kernels take their plain versions there)."""

from __future__ import annotations

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from perfbench import harness  # noqa: E402

DENOISE_LIMITS = {"update_rel_l2": {"limit": 0.04},
                  "worst_frame_rel_l2": {"limit": 0.04},
                  # between the bf16 port's 0.0025-0.0029 and its int8
                  # path's 0.0095-0.0115 at these sizes
                  "attn0_rel_l2": {"limit": 0.006}}
DECODE_LIMITS = {"frames_rmse": {"limit": 2.0},
                 "worst_frame_rmse": {"limit": 2.0}}


def tiny_config(config: str, dtype: str = "float32") -> dict:
    """The cell's configuration at width 128, 1 + 2 blocks, 4 steps, a
    (3, 32, 32) latent (5 s) or (13, 48, 48) (10 s: enough 8x8 tiles that
    the sliding-tile window and the top-CDF drop blocks), 24 text tokens,
    and a decoder of (128, 128, 256, 256) channels."""
    cfg = copy.deepcopy(harness.config_file(config))
    d = cfg["published"]["model"]["dit_params"]
    d.update(model_dim=128, ff_dim=256, num_text_blocks=1,
             num_visual_blocks=2, time_dim=64, in_text_dim=32,
             in_text_dim2=16)
    cfg["published"]["model"]["num_steps"] = 4
    cfg["latent_shape"] = ([1, 13, 48, 48, 16] if "10s" in config
                           else [1, 3, 32, 32, 16])
    cfg["text"] = {"qwen_tokens": 24, "qwen_dim": 32, "clip_dim": 16,
                   "clip_tokens": 77}
    cfg["decode"]["block_out_channels"] = [128, 128, 256, 256]
    cfg["dtype"] = dtype
    return cfg


def tiny_decode_config(dtype: str = "float32") -> dict:
    cfg = tiny_config("k5_t2v_5s_distil", dtype)
    cfg["latent_shape"] = [1, 5, 16, 16, 16]
    return cfg


def run(cell: str, cfg: dict, seed: int = 2 ** 31 + 17, **kw) -> dict:
    limits = DECODE_LIMITS if cell.endswith("decode") else DENOISE_LIMITS
    return harness.run_cell(cell, seed, 0.05, False, "cpu", cfg=cfg,
                            limits=limits, **kw)
