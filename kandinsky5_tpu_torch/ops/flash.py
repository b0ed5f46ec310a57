"""Flash attention: kernels K1 (fixed shift, d = 64) and K4 (online softmax
with key mask and segment ids), each beside its plain PyTorch version.

Counterpart of ``kandinsky5_tpu/ops/flash_pallas.py``. Layout is the JAX
public (B, L, H, D) throughout. The wrappers send a CPU tensor to the plain
version and a CUDA tensor to the kernel (``csrc/flash_fixed.cu``,
``csrc/flash_online.cu``); on a CUDA tensor they launch or raise.

Semantics kept from the TPU kernels:
  * K1: one global shift per call, ``score_bound`` = max|q| max|k| / sqrt(d)
    over all batches and heads; p = exp2(s log2(e)/sqrt(d) - shift log2(e));
    p rounds to bf16 before the PV product and the normalizer sums the
    rounded weights; the normalizer is clamped at 1e-30.
  * K4: scale 1/sqrt(d); keys masked by ``kv_mask`` or by monotone segment
    ids (query i sees key j iff q_id[i] >= kv_id[j]) score -1e30; running
    max and sum; p rounds to bf16 before PV.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from kandinsky5_tpu_torch.ops import _kernels

LOG2E = math.log2(math.e)
_NEG = -1e30
# fp32 score elements per plain-version chunk (1 GiB) — bounds its memory
_PLAIN_CHUNK = 1 << 28


def score_bound(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """max_i |q_i| * max_j |k_j| / sqrt(D) as a (1,) fp32 tensor on q's
    device (one reduction over Q and K, no host sync)."""
    d = q.shape[-1]
    qn = torch.linalg.vector_norm(q, dim=-1, dtype=torch.float32).amax()
    kn = torch.linalg.vector_norm(k, dim=-1, dtype=torch.float32).amax()
    return (qn * kn / math.sqrt(d)).reshape(1)


def _row_chunks(lq: int, lk: int):
    n = max(1, min(lq, _PLAIN_CHUNK // max(lk, 1)))
    for i in range(0, lq, n):
        yield i, min(i + n, lq)


# ---------------------------------------------------------------------------
# K1: fixed-shift attention
# ---------------------------------------------------------------------------

def flash_fixed_plain(q, k, v, kv_mask=None, shift=None):
    """Plain PyTorch K1: the same fixed-shift arithmetic, looped over
    (batch, head, query chunk) to bound memory."""
    b, lq, h, d = q.shape
    if shift is None:
        shift = score_bound(q, k)
    c = LOG2E / math.sqrt(d)
    sh = shift.float() * LOG2E
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            kh = k[bi, :, hi].float()
            vh = v[bi, :, hi]
            for lo, hi_ in _row_chunks(lq, kh.shape[0]):
                s = q[bi, lo:hi_, hi].float() @ kh.T
                p = torch.exp2(s * c - sh)
                if kv_mask is not None:
                    p = p * kv_mask[bi].to(p.dtype)[None]
                p = p.to(v.dtype).float()
                num = p @ vh.float()
                den = p.sum(-1, keepdim=True).clamp_min(1e-30)
                out[bi, lo:hi_, hi] = (num / den).to(q.dtype)
    return out


def flash_fixed(q, k, v, kv_mask: Optional[torch.Tensor] = None):
    """K1 wrapper. q (B, Lq, H, 64), k/v (B, Lk, H, 64) bf16; kv_mask
    (B, Lk) bool, True where the key is valid."""
    shift = score_bound(q, k)
    if q.device.type == "cpu":
        return flash_fixed_plain(q, k, v, kv_mask, shift)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d != 64 or q.dtype != torch.bfloat16 or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"K1 takes bf16 heads of 64, got {q.dtype} d={d}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"K1 shape mismatch: {q.shape} {k.shape} {v.shape}")
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, lk):
            raise ValueError(f"K1 kv_mask must be (B, Lk), got {kv_mask.shape}")
        mask = kv_mask.to(torch.uint8).contiguous()
    _kernels.check_cuda("K1", q=q, k=k, v=v, mask=mask)
    out = torch.empty_like(q)
    _kernels.launch("k5_flash_fixed", "K1_flash_fixed", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), _kernels.ptr(mask),
                    shift.data_ptr(), out.data_ptr(), b, lq, lk, h)
    return out


# ---------------------------------------------------------------------------
# K4: online-softmax attention with key mask and segment ids
# ---------------------------------------------------------------------------

def flash_online_plain(q, k, v, kv_mask=None, q_ids=None, kv_ids=None):
    """Plain PyTorch K4: exact softmax with the same masking, bf16-rounded
    weights in the PV product, looped over (batch, head, query chunk)."""
    b, lq, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            kh = k[bi, :, hi].float()
            vh = v[bi, :, hi].float()
            for lo, hi_ in _row_chunks(lq, kh.shape[0]):
                s = (q[bi, lo:hi_, hi].float() @ kh.T) * scale
                allowed = torch.ones_like(s, dtype=torch.bool)
                if kv_mask is not None:
                    allowed &= kv_mask[bi].bool()[None]
                if q_ids is not None:
                    allowed &= q_ids[bi, lo:hi_, None] >= kv_ids[bi][None]
                s = torch.where(allowed, s, torch.full_like(s, _NEG))
                m = s.amax(-1, keepdim=True)
                p = torch.exp(s - m)
                den = p.sum(-1, keepdim=True).clamp_min(1e-30)
                num = p.to(v.dtype).float() @ vh
                out[bi, lo:hi_, hi] = (num / den).to(q.dtype)
    return out


def flash_online(q, k, v, kv_mask=None, q_ids=None, kv_ids=None):
    """K4 wrapper. q (B, Lq, H, 512), k/v (B, Lk, H, 512) bf16; kv_mask
    (B, Lk) bool; q_ids (B, Lq) / kv_ids (B, Lk) non-decreasing int ids."""
    if (q_ids is None) != (kv_ids is None):
        raise ValueError("q_ids and kv_ids come together")
    if q.device.type == "cpu":
        return flash_online_plain(q, k, v, kv_mask, q_ids, kv_ids)
    b, lq, h, d = q.shape
    lk = k.shape[1]
    if d != 512 or q.dtype != torch.bfloat16 or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"K4 takes bf16 heads of 512, got {q.dtype} d={d}")
    if k.shape != (b, lk, h, d) or v.shape != k.shape:
        raise ValueError(f"K4 shape mismatch: {q.shape} {k.shape} {v.shape}")
    mask = None
    if kv_mask is not None:
        if kv_mask.shape != (b, lk):
            raise ValueError(f"K4 kv_mask must be (B, Lk), got {kv_mask.shape}")
        mask = kv_mask.to(torch.uint8).contiguous()
    qi = ki = None
    if q_ids is not None:
        if q_ids.shape != (b, lq) or kv_ids.shape != (b, lk):
            raise ValueError("K4 ids must be (B, Lq) and (B, Lk)")
        qi = q_ids.to(torch.int32).contiguous()
        ki = kv_ids.to(torch.int32).contiguous()
    _kernels.check_cuda("K4", q=q, k=k, v=v, mask=mask, q_ids=qi, kv_ids=ki)
    out = torch.empty_like(q)
    _kernels.launch("k5_flash_online", "K4_flash_online", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), _kernels.ptr(mask),
                    _kernels.ptr(qi), _kernels.ptr(ki), out.data_ptr(),
                    b, lq, lk, h)
    return out


def flash_attention(q, k, v, kv_mask=None, q_ids=None, kv_ids=None):
    """(B, L, H, D) flash attention, as ``flash_pallas.flash_attention``
    routes it: the fixed-shift K1 for 64-wide heads (d % 128 == 64)
    without segment ids, otherwise the online K4. The fixed shift is valid
    only for bounded scores: the DiT's 64-wide heads are QK-RMSNorm'd."""
    if q_ids is None and q.shape[-1] % 128 == 64:
        return flash_fixed(q, k, v, kv_mask)
    return flash_online(q, k, v, kv_mask, q_ids, kv_ids)
