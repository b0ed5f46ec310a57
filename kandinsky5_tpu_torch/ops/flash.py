"""Flash attention: kernels K1 (fixed shift, d = 64), K4 (online softmax
with key mask and segment ids), K5 (int8 QK^T, fixed shift) and K7 (K5's
lag-1 pipelined schedule), each beside its plain PyTorch version.

Counterpart of ``kandinsky5_tpu/ops/flash_pallas.py``. Layout is the JAX
public (B, L, H, D) throughout. The wrappers send a CPU tensor to the plain
version and a CUDA tensor to the kernel (``csrc/flash_fixed.cu``,
``csrc/flash_online.cu``, ``csrc/flash_int8.cu``); on a CUDA tensor they
launch or raise.

Semantics kept from the TPU kernels:
  * K1: one global shift per call, ``score_bound`` = max|q| max|k| / sqrt(d)
    over all batches and heads; p = exp2(s log2(e)/sqrt(d) - shift log2(e));
    p rounds to bf16 before the PV product and the normalizer sums the
    rounded weights; the normalizer is clamped at 1e-30.
  * K4: scale 1/sqrt(d); keys masked by ``kv_mask`` or by monotone segment
    ids (query i sees key j iff q_id[i] >= kv_id[j]) score -1e30; running
    max and sum; p rounds to bf16 before PV.
  * K5/K7: the ``_pack_int8`` pre-pass (:func:`pack_int8`), then
    s = float(q8 . k8) * coeff_j - shift, -1e30 for masked keys,
    p = exp2(s) cast to V's dtype, normalizer = sum of the cast p clamped at
    1e-30. K7 equals K5 bit for bit.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.profiler import record_function

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
    _kernels.refuse_grad("K1", q, k, v)
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
    _kernels.check_tma_aligned("K1", q=q, k=k, v=v)
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


# K4's tiles: 64 query rows a block, 32 keys a tile (csrc/flash_online.cu)
K4_BLOCK_Q, K4_BLOCK_K = 64, 32
# the code of a key no query may see (masked, or past Lk)
_NO_KEY = 2 ** 31 - 1


def online_plan(b: int, lq: int, lk: int, kv_mask=None, q_ids=None,
                kv_ids=None, device=None):
    """K4's work tables, on the device, with no host sync:

      codes (B, nt * 32) int32: the kv id of each valid key (0 without ids),
        ``_NO_KEY`` where kv_mask removes it or past Lk; a query with id q
        sees a key iff its code <= q (q = 0 without ids);
      plan (B, nqb, 2) int32: per 64-row query block, the number of live
        32-key tiles (a prefix: the TPU kernel's liveness rule, a tile is
        dead where the block's largest q id is below its smallest kv id,
        ``flash_pallas._flash_bhld``), and 1 where the kernel may also skip
        tiles whose keys kv_mask removes entirely: every row of the block
        has an allowed key (the first valid key's id is at most the block's
        first q id), so such a tile changes no output;
      nxt (B, nt + 1) int32 or None (no mask): the first tile at or after t
        that holds a valid key (nt where none does).

    nt = ceil(lk / 32), nqb = ceil(lq / 64)."""
    bq, bk = K4_BLOCK_Q, K4_BLOCK_K
    nt, nqb = -(-lk // bk), -(-lq // bq)
    if kv_ids is not None:
        codes = kv_ids.to(torch.int32)
    else:
        codes = torch.zeros((b, lk), dtype=torch.int32, device=device)
    if kv_mask is not None:
        codes = torch.where(kv_mask.bool(), codes, _NO_KEY)
    codes = torch.cat([codes, codes.new_full((b, nt * bk - lk), _NO_KEY)], 1)
    if q_ids is not None:
        last = (torch.arange(1, nqb + 1, device=device) * bq).clamp_max(lq) - 1
        qmax = q_ids.to(torch.int32)[:, last].contiguous()
        kmin = kv_ids.to(torch.int32)[:, ::bk].contiguous()
        n_live = torch.searchsorted(kmin, qmax, right=True).to(torch.int32)
        q_first = q_ids.to(torch.int32)[:, ::bq]
    else:
        n_live = torch.full((b, nqb), nt, dtype=torch.int32, device=device)
        q_first = torch.zeros((b, nqb), dtype=torch.int32, device=device)
    nxt = None
    skip = torch.zeros_like(n_live)
    if kv_mask is not None:
        valid = codes.view(b, nt, bk).lt(_NO_KEY).any(-1)
        idx = torch.arange(nt, dtype=torch.int32, device=device)
        nxt = torch.where(valid, idx, nt)
        nxt = torch.cat([nxt, nxt.new_full((b, 1), nt)], dim=1)
        nxt = nxt.flip(-1).cummin(-1).values.flip(-1).contiguous()
        skip = (codes.amin(-1, keepdim=True) <= q_first).to(torch.int32)
    plan = torch.stack([n_live, skip], dim=-1).contiguous()
    return codes.contiguous(), plan, nxt


def flash_online(q, k, v, kv_mask=None, q_ids=None, kv_ids=None):
    """K4 wrapper. q (B, Lq, H, 512), k/v (B, Lk, H, 512) bf16; kv_mask
    (B, Lk) bool; q_ids (B, Lq) / kv_ids (B, Lk) non-decreasing int ids."""
    _kernels.refuse_grad("K4", q, k, v)
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
    if kv_mask is not None and kv_mask.shape != (b, lk):
        raise ValueError(f"K4 kv_mask must be (B, Lk), got {kv_mask.shape}")
    if q_ids is not None and (q_ids.shape != (b, lq)
                              or kv_ids.shape != (b, lk)):
        raise ValueError("K4 ids must be (B, Lq) and (B, Lk)")
    _kernels.check_cuda("K4", q=q, k=k, v=v)
    for key, t in (("kv_mask", kv_mask), ("q_ids", q_ids), ("kv_ids", kv_ids)):
        if t is not None and not t.is_cuda:
            raise ValueError(f"K4: {key} is not on a CUDA device")
    _kernels.check_tma_aligned("K4", q=q, k=k, v=v)
    with record_function("k4_plan"):
        codes, plan, nxt = online_plan(b, lq, lk, kv_mask, q_ids, kv_ids,
                                       q.device)
        qi = None if q_ids is None else q_ids.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    _kernels.launch("k5_flash_online", "K4_flash_online", q.data_ptr(),
                    k.data_ptr(), v.data_ptr(), codes.data_ptr(),
                    plan.data_ptr(), _kernels.ptr(nxt), _kernels.ptr(qi),
                    out.data_ptr(), b, lq, lk, h)
    return out


# ---------------------------------------------------------------------------
# K5 / K7: int8-QK fixed-shift attention (SageAttention-style)
# ---------------------------------------------------------------------------

# the JAX package's default kv blocks for the int8 path (flash_pallas
# BLOCK_K, BLOCK_K_I8): its K is zero-padded to a block before quantizing
_BLOCK_K, _BLOCK_K_I8 = 768, 512


def int8_padded_len(lk: int) -> int:
    """The length ``flash_pallas.flash_attention`` pads K to on its int8
    path with the default blocks: ``lk`` rounded up to 128 when that is
    below 768 (lk <= 640), else rounded up to 512. The padded rows count in
    K's mean and in the shift, so the port reproduces them."""
    blk = min(_BLOCK_K, -(-lk // 128) * 128)
    if blk == _BLOCK_K:
        blk = _BLOCK_K_I8
    return -(-lk // blk) * blk


def _heads_first(x):
    b, l, h, d = x.shape
    return x.float().permute(0, 2, 1, 3).reshape(b * h, l, d).contiguous()


def pack_int8(q, k):
    """Quantize Q and K for K5/K7, as ``flash_pallas._pack_int8`` does
    (an O(L d) plain-PyTorch pre-pass; the JAX package runs it in XLA).

    q (B, Lq, H, d), k (B, Lk, H, d). K is mean-centred per (batch, head)
    over its keys zero-padded to :func:`int8_padded_len` (so the mean is the
    sum over real keys divided by the padded length, and the padded rows,
    exactly -mean, take part in the shift); masked keys count like any
    other. Q has one scale per (batch, head), K one per key; each scale is
    max(max|x|, 1e-6) / 127 and x8 = clip(round(x / scale), -127, 127),
    rounding half to even. Returns
      q8 (B*H, Lq, d) int8, k8 (B*H, Lk, d) int8 (real keys only);
      coeff (B*H, Lk) fp32 = sq * sk * log2(e)/sqrt(d), the dequant factor;
      shift (1,) fp32 = qn * kn * log2(e)/sqrt(d), the log2-domain bound,
    with qn, kn the largest row norms of Q and of the centred (padded) K
    over all batches and heads. No host sync."""
    with record_function("pack_int8"):
        d = q.shape[-1]
        lk = k.shape[1]
        lk_pad = int8_padded_len(lk)
        scale = LOG2E / math.sqrt(d)
        qf, kf = _heads_first(q), _heads_first(k)
        km = kf.sum(1, keepdim=True) / lk_pad
        kc = kf - km
        sq = qf.abs().amax((1, 2)).clamp_min(1e-6) / 127.0
        sk = kc.abs().amax(-1).clamp_min(1e-6) / 127.0
        q8 = torch.round(qf / sq[:, None, None]).clamp(-127, 127).to(torch.int8)
        k8 = torch.round(kc / sk[..., None]).clamp(-127, 127).to(torch.int8)
        kn2 = kc.square().sum(-1).amax()
        if lk_pad != lk:
            kn2 = torch.maximum(kn2, km.square().sum(-1).amax())
        qn = qf.square().sum(-1).amax().sqrt()
        shift = (qn * kn2.sqrt() * scale).reshape(1)
        coeff = sq[:, None] * sk * scale
    return q8, k8, coeff, shift


def flash_int8_plain(q8, k8, v, coeff, shift, kv_mask=None):
    """Plain PyTorch K5/K7 (the two compute one function). q8 (B*H, Lq, d)
    and k8 (B*H, Lk, d) int8, v (B, Lk, H, d), coeff (B*H, Lk), shift (1,)
    from :func:`pack_int8`. Scores s = float(q8 . k8) * coeff - shift (the
    int8 products are exact in fp32: |s32| <= 64 * 127^2 < 2^24); masked
    keys score -1e30; p = exp2(s) cast to v.dtype; out = p v / max(sum p,
    1e-30) in v.dtype, the sum over the cast p. Looped over (batch, head,
    query chunk)."""
    b, lk, h, d = v.shape
    lq = q8.shape[1]
    out = torch.empty((b, lq, h, d), dtype=v.dtype, device=v.device)
    sh = shift.float()
    for bi in range(b):
        for hi in range(h):
            bh = bi * h + hi
            kh = k8[bh].float()
            vh = v[bi, :, hi].float()
            c = coeff[bh].float()
            for lo, hi_ in _row_chunks(lq, lk):
                s = (q8[bh, lo:hi_].float() @ kh.T) * c - sh
                if kv_mask is not None:
                    s = torch.where(kv_mask[bi].bool()[None], s,
                                    torch.full_like(s, _NEG))
                p = torch.exp2(s).to(v.dtype).float()
                den = p.sum(-1, keepdim=True).clamp_min(1e-30)
                out[bi, lo:hi_, hi] = ((p @ vh) / den).to(v.dtype)
    return out


def flash_int8(q, k, v, kv_mask: Optional[torch.Tensor] = None,
               pipe: bool = False):
    """K5 (``pipe=False``) or K7 (``pipe=True``) wrapper. q (B, Lq, H, 64),
    k/v (B, Lk, H, 64) bf16; kv_mask (B, Lk) bool, True where the key is
    valid. Packs with :func:`pack_int8`, then runs
    :func:`flash_int8_packed`."""
    _kernels.refuse_grad("K7" if pipe else "K5", q, k, v)
    q8, k8, coeff, shift = pack_int8(q, k)
    return flash_int8_packed(q8, k8, v, coeff, shift, kv_mask, pipe)


def tma_coeff(coeff):
    """``coeff`` (B*H, Lk) with zero columns appended up to a multiple of 4
    keys, the row length K5/K7/T5 read it at: their TMA tensor map needs a
    row stride that is a multiple of 16 bytes. The tensor itself where Lk %
    4 == 0; otherwise an O(B*H*Lk) copy, with no host sync."""
    pad = -coeff.shape[-1] % 4
    return torch.nn.functional.pad(coeff, (0, pad)) if pad else coeff


def int8_operands(name, q8, k8, v, coeff, shift, mask=None):
    """Check what K5, K7 and T5 (one kernel) take, and return (B, Lq, Lk, H)
    and ``coeff`` as the kernel reads it. q8 (B*H, Lq, 64) and k8 (B*H, Lk,
    64) int8, v (B, Lk, H, 64) bf16, coeff (B*H, Lk) fp32, all contiguous on
    the card; mask (B, Lk) uint8 or None. The kernel reads q8, k8, v and
    coeff (padded by :func:`tma_coeff`) through TMA tensor maps, so their
    base addresses must be 16-byte aligned. Raises ValueError otherwise."""
    b, lk, h, d = v.shape
    lq = q8.shape[1]
    if d != 64 or v.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 V and heads of 64, got "
                         f"{v.dtype} d={d}")
    if q8.shape != (b * h, lq, d) or k8.shape != (b * h, lk, d) \
            or coeff.shape != (b * h, lk):
        raise ValueError(f"{name} shapes: q8 {tuple(q8.shape)} k8 "
                         f"{tuple(k8.shape)} v {tuple(v.shape)} coeff "
                         f"{tuple(coeff.shape)}")
    if q8.dtype != torch.int8 or k8.dtype != torch.int8 \
            or coeff.dtype != torch.float32:
        raise ValueError(f"{name} takes int8 q8, k8 and fp32 coeff, got "
                         f"{q8.dtype} {k8.dtype} {coeff.dtype}")
    if mask is not None and mask.shape != (b, lk):
        raise ValueError(f"{name} kv_mask must be (B, Lk), got {mask.shape}")
    _kernels.check_cuda(name, q8=q8, k8=k8, v=v, coeff=coeff, shift=shift,
                        mask=mask)
    coeff = tma_coeff(coeff)
    _kernels.check_tma_aligned(name, q8=q8, k8=k8, v=v, coeff=coeff)
    return (b, lq, lk, h), coeff


def flash_int8_packed(q8, k8, v, coeff, shift, kv_mask=None,
                      pipe: bool = False):
    """K5/K7 on :func:`pack_int8`'s outputs: the plain version for a CPU
    tensor, the kernel (K7 with ``pipe``) for a CUDA one, or raise
    (:func:`int8_operands` says what the kernel takes)."""
    _kernels.refuse_grad("K7" if pipe else "K5", v, coeff, shift)
    if v.device.type == "cpu":
        return flash_int8_plain(q8, k8, v, coeff, shift, kv_mask)
    name = "K7" if pipe else "K5"
    mask = None if kv_mask is None else kv_mask.to(torch.uint8).contiguous()
    (b, lq, lk, h), coeff = int8_operands(name, q8, k8, v, coeff, shift, mask)
    out = torch.empty((b, lq, h, 64), dtype=v.dtype, device=v.device)
    entry, counter = (("k5_flash_int8_pipe", "K7_flash_int8_pipe") if pipe
                      else ("k5_flash_int8", "K5_flash_int8"))
    _kernels.launch(entry, counter, q8.data_ptr(), k8.data_ptr(),
                    v.data_ptr(), coeff.data_ptr(), _kernels.ptr(mask),
                    shift.data_ptr(), out.data_ptr(), b, lq, lk, h)
    return out


def flash_attention(q, k, v, kv_mask=None, q_ids=None, kv_ids=None,
                    qk_int8: bool = False, pipe: bool = False):
    """(B, L, H, D) flash attention, as ``flash_pallas.flash_attention``
    routes it: the fixed-shift K1 for 64-wide heads (d % 128 == 64)
    without segment ids, otherwise the online K4. ``qk_int8`` selects the
    int8-QK K5 (K7 with ``pipe``), which the JAX package builds only in
    fixed-shift mode: it raises for segment ids or a head not 64 wide. The
    fixed shift is valid only for bounded scores: the DiT's 64-wide heads
    are QK-RMSNorm'd."""
    if qk_int8:
        if q_ids is not None or q.shape[-1] != 64:
            raise ValueError("the int8-QK kernels take 64-wide heads without "
                             f"segment ids, got d={q.shape[-1]}")
        return flash_int8(q, k, v, kv_mask, pipe)
    if q_ids is None and q.shape[-1] % 128 == 64:
        return flash_fixed(q, k, v, kv_mask)
    return flash_online(q, k, v, kv_mask, q_ids, kv_ids)
