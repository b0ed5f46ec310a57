"""Quality metrics of the parity gate: decoded-frame PSNR (the gate asks
for more than 35 dB against the reference) and a summary of how far two
latents are apart.

Counterpart of ``kandinsky5_tpu/utils/metrics.py``; takes numpy arrays or
torch tensors (on any device) and computes in float64 on the host.
"""

from __future__ import annotations

import numpy as np
import torch


def _f64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().double().numpy()
    return np.asarray(a, np.float64)


def psnr(a, b, max_val: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB of ``a`` against ``b``; inf when
    they are equal."""
    a, b = _f64(a), _f64(b)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(20.0 * np.log10(max_val) - 10.0 * np.log10(mse))


def latent_stats(a, b) -> dict:
    """How far latents ``a`` are from ``b``: max and mean absolute
    difference, mean relative difference and cosine similarity."""
    a, b = _f64(a), _f64(b)
    diff = np.abs(a - b)
    denom = np.maximum(np.abs(b), 1e-6)
    return {
        "max_abs": float(diff.max()),
        "mean_abs": float(diff.mean()),
        "rel_mean": float((diff / denom).mean()),
        "cosine": float(
            (a * b).sum() / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12)),
    }
