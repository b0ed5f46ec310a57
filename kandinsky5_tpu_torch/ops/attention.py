"""Attention dispatch: dense PyTorch attention and the flash kernels.

Counterpart of ``kandinsky5_tpu/ops/attention.py`` on one device. Layout
is (B, L, H, D). ``impl``:
  * "dense": :func:`dense_attention` (fp32 softmax);
  * "flash": :func:`ops.flash.flash_attention` — K1 for 64-wide heads
    without segment ids, K4 otherwise;
  * "auto": "flash", except short-KV cross-attention (k_len <= 512 and
    q_len >= 4 k_len, e.g. 47,616 visual queries against 256 text keys),
    which goes dense as in the JAX package. An explicit "flash" is
    honoured;
  * "flash_int8": the int8-QK K5 (``ops.flash.flash_int8``) for every
    attention but short-KV cross-attention, which runs dense: the name
    means "int8 where the JAX package uses it", and the JAX dispatch sends
    short-KV cross-attention dense for every impl but "dense". Text
    self-attention (q_len == k_len = 256) takes K5;
  * "flash_int8_pipe": the same routing with K7, K5's pipelined schedule.
The short-KV rule sees the call's global query length (``q_len``), as the
JAX package decides it before its shard_map: under sequence parallelism a
rank's queries are a 1/sp shard of it. No environment flag is read.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kandinsky5_tpu_torch.ops.flash import flash_attention


def dense_attention(q, k, v, kv_mask: Optional[torch.Tensor] = None,
                    scale: Optional[float] = None):
    """Non-causal softmax attention with fp32 scores and softmax; the
    weights are cast to v.dtype for the PV product (fp32 accumulation).
    kv_mask (B, Lk) bool, True where the key is valid."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask.bool()[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhlm,bmhd->blhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def short_kv(q_len: int, k_len: int) -> bool:
    """The short-KV cross-attention rule of the JAX dispatch."""
    return k_len <= 512 and q_len >= 4 * k_len


INT8_IMPLS = ("flash_int8", "flash_int8_pipe")


def attention(q, k, v, kv_mask=None, impl: str = "auto",
              q_len: Optional[int] = None):
    """Dispatch between the flash kernels and dense on the local shapes;
    ``q_len`` (default q's length) is the query length of the whole call,
    which the short-KV rule reads."""
    short = short_kv(q.shape[1] if q_len is None else q_len, k.shape[1])
    if impl == "auto":
        impl = "dense" if short else "flash"
    elif impl in INT8_IMPLS and short:
        impl = "dense"
    if impl == "dense":
        return dense_attention(q, k, v, kv_mask=kv_mask)
    if impl == "flash":
        return flash_attention(q, k, v, kv_mask=kv_mask)
    if impl in INT8_IMPLS:
        return flash_attention(q, k, v, kv_mask=kv_mask, qk_int8=True,
                               pipe=impl == "flash_int8_pipe")
    raise ValueError(f"unknown attention impl {impl!r}")
