"""NABLA block-sparse attention: kernel K6 beside its plain PyTorch
version.

Counterpart of ``kandinsky5_tpu/ops/sparse_pallas.py`` (``sparse_attention``
with ``q_rows=1``, ``kv_page_blocks=1``). Each 64-token query block
attends the 64-token KV blocks of its row of the kv lists that
``ops/nabla.block_mask_to_kv_lists`` builds: ``kv_inds`` (B, H, S/64,
Sk/64) int32 with the row's active blocks first, ``kv_nb`` (B, H, S/64)
their count. Layout is (B, S, H, 64). The wrapper sends a CPU tensor to
the plain version and a CUDA tensor to the kernel
(``csrc/sparse_nabla.cu``); on a CUDA tensor it launches or raises.

Rounding points kept from the TPU kernel:
  * q is scaled by log2(e)/sqrt(d) and rounded to q's dtype before QK;
  * one shift for the call, ``score_bound(q, k) * log2(e)`` over all
    batches and heads (a device scalar, no host sync);
  * keys past a row's ``nb`` blocks score -1e30;
  * p = exp2(s - shift); the PV product takes p rounded to v's dtype, the
    normalizer sums the unrounded fp32 p (unlike K1, whose normalizer
    sums the rounded weights) and is clamped at 1e-30.
"""

from __future__ import annotations

import math

import torch

from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.flash import _NEG, _PLAIN_CHUNK, LOG2E, score_bound

BLOCK = 64


def sparse_attention_plain(q, k, v, kv_inds, kv_nb, shift=None):
    """Plain PyTorch K6: each query block gathers its listed K/V blocks
    (padded to the longest list of its head, the padding scored -1e30),
    looped over (batch, head, chunk of query blocks) to bound memory."""
    b, s, h, d = q.shape
    nq, s1 = s // BLOCK, k.shape[1] // BLOCK
    if shift is None:
        shift = score_bound(q, k)
    sh = shift.float() * LOG2E
    c = LOG2E / math.sqrt(d)
    out = torch.empty_like(q)
    for bi in range(b):
        for hi in range(h):
            nb = kv_nb[bi, hi].long()
            n_max = int(nb.max()) if nq else 0
            if n_max == 0:
                out[bi, :, hi] = 0
                continue
            qh = (q[bi, :, hi].float() * c).to(q.dtype).float().reshape(
                nq, BLOCK, d)
            kh = k[bi, :, hi].reshape(s1, BLOCK, d)
            vh = v[bi, :, hi].reshape(s1, BLOCK, d)
            inds = kv_inds[bi, hi, :, :n_max].long()
            live = torch.arange(n_max, device=q.device)[None] < nb[:, None]
            live = live.repeat_interleave(BLOCK, dim=1)
            rows = max(1, _PLAIN_CHUNK // (BLOCK * BLOCK * n_max))
            for r0 in range(0, nq, rows):
                r1 = min(r0 + rows, nq)
                kg = kh[inds[r0:r1]].reshape(r1 - r0, n_max * BLOCK, d).float()
                sc = torch.bmm(qh[r0:r1], kg.transpose(1, 2))
                sc = sc.masked_fill(~live[r0:r1, None], _NEG)
                p = torch.exp2(sc - sh)
                den = p.sum(-1, keepdim=True).clamp_min(1e-30)
                vg = vh[inds[r0:r1]].reshape(r1 - r0, n_max * BLOCK, d).float()
                num = torch.bmm(p.to(v.dtype).float(), vg)
                out[bi, r0 * BLOCK:r1 * BLOCK, hi] = (num / den).reshape(
                    -1, d).to(q.dtype)
    return out


# query blocks a K6 block takes (csrc/sparse_nabla.cu NWG)
GROUP = 4


def group_order(kv_nb):
    """K6's schedule: the kernel takes the query blocks of one (batch, head)
    ``GROUP`` at a time (blocks G g .. G g + G - 1, a group); returns the
    groups' linear ids ((b H + h) NG + g, NG = ceil(S / 64 / G)) as
    (B H NG,) int32, head by head (so the groups running together share
    one head's K and V in L2) and longest first within a head by the
    group's listed blocks (stable), on the device."""
    b, h, nq = kv_nb.shape
    n = kv_nb.to(torch.int32)
    pad = -nq % GROUP
    if pad:
        n = torch.cat([n, n.new_zeros((b, h, pad))], dim=-1)
    work = n.view(b * h, -1, GROUP).sum(-1)
    order = torch.sort(work, dim=-1, descending=True, stable=True).indices
    heads = torch.arange(b * h, device=kv_nb.device)[:, None] * work.shape[1]
    return (order + heads).flatten().to(torch.int32)


def sparse_attention(q, k, v, kv_inds, kv_nb):
    """K6 wrapper. q (B, S, H, 64), k/v (B, Sk, H, 64) bf16 with S and Sk
    multiples of 64; kv_inds (B, H, S/64, Sk/64) and kv_nb (B, H, S/64)
    integer kv lists. The kernel reads a block listed by several rows of
    a group once when the lists are ascending, as
    ``nabla.block_mask_to_kv_lists`` builds them; any order gives the same
    result."""
    _kernels.refuse_grad("K6", q, k, v)
    b, s, h, d = q.shape
    sk = k.shape[1]
    if s % BLOCK or sk % BLOCK:
        raise ValueError(f"K6 needs lengths divisible by {BLOCK}: {s}, {sk}")
    nq, s1 = s // BLOCK, sk // BLOCK
    if kv_inds.shape != (b, h, nq, s1) or kv_nb.shape != (b, h, nq):
        raise ValueError(f"K6 kv lists must be {(b, h, nq, s1)} and "
                         f"{(b, h, nq)}: {kv_inds.shape} {kv_nb.shape}")
    shift = score_bound(q, k)
    if q.device.type == "cpu":
        return sparse_attention_plain(q, k, v, kv_inds, kv_nb, shift)
    if d != 64 or q.dtype != torch.bfloat16 or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"K6 takes bf16 heads of 64, got {q.dtype} d={d}")
    if k.shape != (b, sk, h, d) or v.shape != k.shape:
        raise ValueError(f"K6 shape mismatch: {q.shape} {k.shape} {v.shape}")
    inds = kv_inds.to(torch.int32).contiguous()
    nb = kv_nb.to(torch.int32).contiguous()
    _kernels.check_cuda("K6", q=q, k=k, v=v, kv_inds=inds, kv_nb=nb)
    _kernels.check_tma_aligned("K6", q=q, k=k, v=v)
    order = group_order(nb)
    out = torch.empty_like(q)
    _kernels.launch("k5_sparse_nabla", "K6_sparse_nabla", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), inds.data_ptr(),
                    nb.data_ptr(), order.data_ptr(), shift.data_ptr(),
                    out.data_ptr(), b, s, sk, h)
    return out
