"""K1-K8 (K3 in all its modes), T1-T5 on the card against their plain
PyTorch versions, at
small shapes (ragged lengths, masks, kv lists) and at the shapes the 5 s
distil and 10 s NABLA paths give them. K7 must equal K5 bit for bit, and
T1's int8 instance its exact integer product.

Needs a CUDA device and nvcc; skips without a card. Run on a GPU machine
with ``pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py`` (the
repository's conftest configures JAX, which the GPU machine need not have).

Tolerances: the kernels and the plain versions round the same values to
bf16 (softmax weights, hidden activations, outputs) but sum in different
orders, so outputs may differ by an ulp of bf16 (2^-8 relative) here and
there; the checks bound the relative L2 error at 1e-2 and the max-abs
error at a few bf16 ulps of the output's scale. The attention inputs give
scores of standard deviation 1, and a control shows the bound has teeth:
uniform weights over the allowed keys (q = 0 in the plain version) fail
it.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.conv import causal_conv3d_fused, conv3d_plain
from kandinsky5_tpu_torch.ops.ff import (
    ff_mod_plain,
    ff_plain,
    fused_ff,
    fused_ff_modulated,
    modulate,
    modulate_plain,
)
from kandinsky5_tpu_torch.ops.flash import (
    flash_fixed,
    flash_fixed_plain,
    flash_int8,
    flash_int8_packed,
    flash_int8_plain,
    flash_online,
    flash_online_plain,
    pack_int8,
)
from kandinsky5_tpu_torch.ops.nabla import block_mask_to_kv_lists, sta_mask
from kandinsky5_tpu_torch.ops.sparse import (
    sparse_attention,
    sparse_attention_plain,
)
from kandinsky5_tpu_torch.tools.bench_i8_decomp import (
    MODES,
    i8_decomp,
    i8_decomp_plain,
)
from kandinsky5_tpu_torch.tools import bench_pallas_gemm
from kandinsky5_tpu_torch.tools.bench_int8mm import gemm, gemm_plain, operands

from . import _torch_tp_ranks

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _err(out, ref):
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    max_abs = (o - r).abs().max().item()
    rel = ((o - r).norm() / r.norm().clamp_min(1e-30)).item()
    return max_abs, rel


def _fails_bound(out, ref, atol, rtol):
    max_abs, rel = _err(out, ref)
    return not (rel < rtol and max_abs < atol)


def _normed(g, shape, dev):
    x = torch.randn(shape, generator=g, device=dev)
    return (x * torch.rsqrt(x.square().mean(-1, keepdim=True))).bfloat16()


@pytest.mark.parametrize("b,lq,lk,h,masked", [
    (2, 300, 300, 3, True), (1, 256, 256, 28, True), (1, 1000, 700, 2, False),
    (2, 1000, 700, 3, True), (1, 47616, 47616, 28, False),
    (1, 47616, 47616, 14, False), (1, 47616, 47616, 7, False)])
def test_k1_matches_plain(dev, b, lq, lk, h, masked):
    """K1 against its plain version: ragged lengths against the 128-row
    and 128-key tiles, a key mask with a valid length per batch, and the
    5 s shape at the tp = 1 / 2 / 4 ranks' shares of the heads."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = _normed(g, (b, lq, h, 64), dev)
    k = _normed(g, (b, lk, h, 64), dev)
    v = torch.randn((b, lk, h, 64), generator=g, device=dev).bfloat16()
    mask = None
    if masked:
        n_valid = torch.tensor([lk * 2 // 3, lk // 5][:b], device=dev)
        mask = torch.arange(lk, device=dev)[None] < n_valid[:, None]
    out = flash_fixed(q, k, v, mask)
    torch.cuda.synchronize()
    ref = flash_fixed_plain(q, k, v, mask)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    assert _fails_bound(flash_fixed_plain(q * 0, k, v, mask), ref, 3e-2, 1e-2)


def test_k1_rejects_unaligned(dev):
    """K1 reads its inputs through TMA tensor maps, which need 16-byte
    aligned base addresses: the wrapper raises rather than launch."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = _normed(g, (1, 128, 2, 64), dev)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flash_fixed(shifted, q, q)


@pytest.mark.parametrize("kernel", ["K4", "K6"])
def test_k4_k6_reject_unaligned(dev, kernel):
    """K4 and K6 read their inputs through TMA tensor maps too: an
    unaligned base raises rather than launch."""
    g = torch.Generator(device=dev).manual_seed(0)
    d = 512 if kernel == "K4" else 64
    q = _normed(g, (1, 128, 1, d), dev)
    flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=dev)
    shifted = flat[1:].view(q.shape)
    shifted.copy_(q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if kernel == "K4":
            flash_online(shifted, q, q)
        else:
            inds, nb = block_mask_to_kv_lists(
                torch.ones((1, 1, 2, 2), dtype=torch.bool, device=dev))
            sparse_attention(shifted, q, q, inds, nb)


@pytest.mark.parametrize("b,lq,lk,h,masked", [
    (2, 300, 300, 3, True), (1, 256, 256, 28, True), (1, 1000, 700, 2, False),
    (1, 47616, 47616, 28, False), (2, 300, 301, 3, True),
    (1, 50, 77, 2, False), (2, 300, 300, 3, "first item none")])
def test_k5_k7_match_plain(dev, b, lq, lk, h, masked):
    """K5 against its plain version on the same packed inputs (they differ
    only in exp2's last bits and the order of sums), with the uniform-weight
    control failing the bound; K7 equal to K5 bit for bit. Edges of the
    128-row and 128-key tiles: Lk not a multiple of 4 (the coefficients
    padded for their tensor map), Lq below 64 and Lk below 128, and a batch
    item whose mask admits no key, which must come out 0 as in the plain
    version."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = _normed(g, (b, lq, h, 64), dev)
    k = _normed(g, (b, lk, h, 64), dev)
    v = torch.randn((b, lk, h, 64), generator=g, device=dev).bfloat16()
    mask = None
    if masked:
        first = 0 if masked == "first item none" else lk * 2 // 3
        n_valid = torch.tensor([first, lk // 5][:b], device=dev)
        mask = torch.arange(lk, device=dev)[None] < n_valid[:, None]
    out = flash_int8(q, k, v, mask)
    pipe = flash_int8(q, k, v, mask, pipe=True)
    torch.cuda.synchronize()
    assert torch.equal(out, pipe)
    q8, k8, coeff, shift = pack_int8(q, k)
    ref = flash_int8_plain(q8, k8, v, coeff, shift, mask)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    assert _fails_bound(flash_int8_plain(q8 * 0, k8, v, coeff, shift, mask),
                        ref, 3e-2, 1e-2)
    if masked == "first item none":
        assert not ref[0].any() and not out[0].any()


@pytest.mark.parametrize("operand", ["q8", "v"])
def test_k5_rejects_unaligned(dev, operand):
    """K5/K7 read q8, k8, v and the coefficients through TMA tensor maps,
    which need 16-byte aligned base addresses: the wrapper raises rather
    than launch."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = _normed(g, (1, 128, 2, 64), dev)
    v = torch.randn((1, 128, 2, 64), generator=g, device=dev).bfloat16()
    args = dict(zip(("q8", "k8", "coeff", "shift"), pack_int8(q, q)), v=v)
    t = args[operand]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    shifted = flat[1:].view(t.shape)
    shifted.copy_(t)
    args[operand] = shifted
    for pipe in (False, True):
        with pytest.raises(ValueError, match="16-byte aligned"):
            flash_int8_packed(args["q8"], args["k8"], args["v"],
                              args["coeff"], args["shift"], pipe=pipe)


@pytest.mark.parametrize("operand", ["q8", "k8", "coeff"])
def test_int8_wrappers_reject_bad_dtypes(dev, operand):
    """K5, K7 and T5 share one check of their operands: a q8 or k8 that is
    not int8, or coefficients that are not fp32, raise rather than reach
    the kernel's tensor maps as raw bytes."""
    g = torch.Generator(device=dev).manual_seed(0)
    q = _normed(g, (1, 128, 2, 64), dev)
    v = torch.randn((1, 128, 2, 64), generator=g, device=dev).bfloat16()
    args = dict(zip(("q8", "k8", "coeff", "shift"), pack_int8(q, q)), v=v)
    args[operand] = args[operand].to(
        torch.bfloat16 if operand == "coeff" else torch.uint8)
    for pipe in (False, True):
        with pytest.raises(ValueError, match="takes int8"):
            flash_int8_packed(args["q8"], args["k8"], args["v"],
                              args["coeff"], args["shift"], pipe=pipe)
    with pytest.raises(ValueError, match="takes int8"):
        i8_decomp(args["q8"], args["k8"], args["v"], args["coeff"],
                  args["shift"], "full")


@pytest.mark.parametrize("lq,lk,h", [(200, 150, 3), (47616, 47616, 28),
                                     (50, 77, 2)])
@pytest.mark.parametrize("mode", MODES)
def test_t5_modes_match_plain(dev, mode, lq, lk, h):
    """Each of T5's modes against its plain version; the outputs are
    garbage of any scale, so the bound is relative: rel_l2 1e-2 and
    max-abs 1e-2 of the output's largest magnitude. The ragged case has Lq
    below 64 and Lk below 128 and not a multiple of 4."""
    g = torch.Generator(device=dev).manual_seed(6)
    q = _normed(g, (1, lq, h, 64), dev)
    k = _normed(g, (1, lk, h, 64), dev)
    v = torch.randn((1, lk, h, 64), generator=g, device=dev).bfloat16()
    q8, k8, coeff, shift = pack_int8(q, k)
    out = i8_decomp(q8, k8, v, coeff, shift, mode)
    torch.cuda.synchronize()
    ref = i8_decomp_plain(q8, k8, v, coeff, shift, mode)
    max_abs, rel = _err(out, ref)
    scale = ref.float().abs().max().item()
    assert rel < 1e-2 and max_abs < 1e-2 * scale, (max_abs, scale, rel)


@pytest.mark.parametrize("m,k,n", [
    (256, 320, 384), (8192, 8192, 8192), (47616, 1792, 7168),
    (47616, 7168, 1792), (1000, 1792, 1792), (1000, 320, 136), (77, 8192, 8)])
def test_t1_matches_plain(dev, m, k, n):
    """T1's int8 instance equals the exact integer product; the bf16
    instance is within fp32 summation order of the fp32 product of the
    same bf16 values (K2's bound). Full shapes with K up to 8192, and
    ragged ones: M not a multiple of the 128-row tile, N not a multiple of
    the 256-column tile, K not a multiple of the 128-byte k step. The
    control, the product with the last 128-byte k step left out, must fail
    each check."""
    g = torch.Generator(device=dev).manual_seed(7)
    a, b = operands(m, k, n, torch.int8, g, dev)
    out = gemm(a, b)
    ref = gemm_plain(a, b)
    assert out.dtype == torch.int32 and torch.equal(out, ref)
    assert not torch.equal(out, gemm_plain(a[:, :-128], b[:, :-128]))
    del a, b, out, ref
    a, b = operands(m, k, n, torch.bfloat16, g, dev)
    out = gemm(a, b)
    torch.cuda.synchronize()
    ref = gemm_plain(a, b)
    max_abs, rel = _err(out, ref)
    assert out.dtype == torch.float32
    assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)
    assert _fails_bound(gemm_plain(a[:, :-64], b[:, :-64]), ref, 6e-2, 1e-2)


# (kernel, K) per schedule of the shared GEMM that an entry launches:
# clusters of two storing by TMA (T1 int8 at K <= 2048, T2), clusters of two
# storing directly (T1 int8 beyond, T1 bf16), single blocks (K8's products)
GEMM_SCHEDULES = [("T1_gemm_i8", 1792), ("T2_gemm", 1792), ("T1_gemm_i8", 2304),
                  ("T1_gemm_bf16", 1792), ("K8_ff", 1792)]


@pytest.mark.parametrize("kind,k", GEMM_SCHEDULES)
@pytest.mark.parametrize("m", [1100, 3000])
def test_gemm_schedules_match_plain(dev, kind, k, m):
    """Each schedule of the shared GEMM that an entry launches, on ragged
    shapes: M = 1,100 leaves the last cluster's second row tile empty (9
    row tiles) and gives a block a single tile, M = 3,000 gives blocks
    several tiles each; int8 exact, bf16 within K2's bound."""
    g = torch.Generator(device=dev).manual_seed(11)
    n = 520 if m < 2000 else 7168
    dtype = torch.int8 if kind == "T1_gemm_i8" else torch.bfloat16
    _kernels.reset_launches()
    if kind == "K8_ff":
        ff = 640 if m < 2000 else 7168  # a multiple of K8's 128
        x = torch.randn((m, k), generator=g, device=dev).bfloat16()
        w1 = (torch.randn((ff, k), generator=g, device=dev)
              / math.sqrt(k)).bfloat16()
        w2 = (torch.randn((k, ff), generator=g, device=dev)
              / math.sqrt(ff)).bfloat16()
        out, ref = fused_ff(x, w1, w2), ff_plain(x, w1, w2)
    else:
        a, b = operands(m, k, n, dtype, g, dev)
        if kind == "T2_gemm":
            out = bench_pallas_gemm.gemm(a, b)
            ref = bench_pallas_gemm.gemm_plain(a, b)
        else:
            out, ref = gemm(a, b), gemm_plain(a, b)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[kind] == 1
    if dtype == torch.int8:
        assert torch.equal(out, ref)
    else:
        max_abs, rel = _err(out, ref)
        assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)


@pytest.mark.parametrize("case", ["n_not_8", "k_not_16_bytes", "k_mismatch",
                                  "unaligned"])
def test_t1_t2_reject_bad_operands(dev, case):
    """The wrappers raise on what the shared GEMM does not take: N not a
    multiple of 8, K times the element size not a multiple of 16, B's K
    unlike A's, a base pointer not 16-byte aligned."""
    a = torch.zeros((256, 64), dtype=torch.bfloat16, device=dev)
    b = torch.zeros((128, 64), dtype=torch.bfloat16, device=dev)
    if case == "n_not_8":
        b = b[:100]
    elif case == "k_not_16_bytes":
        a, b = a[:, :60].contiguous(), b[:, :60].contiguous()
    elif case == "k_mismatch":
        b = b[:, :32].contiguous()
    else:
        a = a.view(-1)[4:4 + 255 * 64].view(255, 64)
    with pytest.raises(ValueError):
        gemm(a, b)
    with pytest.raises(ValueError):
        bench_pallas_gemm.gemm(a, b)


@pytest.mark.parametrize("b,grid,h,extra", [
    (1, (4, 4, 6), 4, 0.0), (2, (3, 2, 2), 3, 0.3), (1, (13, 4, 6), 28, 0.0)])
def test_k6_matches_plain(dev, b, grid, h, extra):
    """K6 under the STA mask of a tile grid (plus seeded random blocks),
    one empty row, batches with lists of their own."""
    g = torch.Generator(device=dev).manual_seed(4)
    s1 = grid[0] * grid[1] * grid[2]
    s = s1 * 64
    q = _normed(g, (b, s, h, 64), dev)
    k = _normed(g, (b, s, h, 64), dev)
    v = torch.randn((b, s, h, 64), generator=g, device=dev).bfloat16()
    mask = torch.from_numpy(sta_mask(*grid)).to(dev).expand(b, h, s1, s1).clone()
    mask |= torch.rand((b, h, s1, s1), generator=g, device=dev) < extra
    mask[0, 0, 1] = False
    inds, nb = block_mask_to_kv_lists(mask)
    out = sparse_attention(q, k, v, inds, nb)
    torch.cuda.synchronize()
    ref = sparse_attention_plain(q, k, v, inds, nb)
    assert torch.all(out[0, 64:128, 0] == 0)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    assert _fails_bound(sparse_attention_plain(q * 0, k, v, inds, nb), ref,
                        3e-2, 1e-2)


@pytest.mark.parametrize("lengths", [
    (40, 4, 3, 39, 7, 1, 40, 0), (4, 40, 5, 40, 3, 9, 1, 11), (40,) * 8,
    (3, 5, 7, 9, 11, 13, 15, 17)])
def test_k6_lists(dev, lengths):
    """K6 on hand-made lists of 40 KV blocks per row (s1 = 40): odd
    lengths, dense rows (every block listed), rows 10x apart in one head,
    an empty row, and neighbouring rows that share few blocks (each row's
    blocks drawn at random), over two heads (the second with the lengths
    rotated) and two batches."""
    g = torch.Generator(device=dev).manual_seed(9)
    s1, b, h = 40, 2, 2
    nq = s1
    s = nq * 64
    rows = []
    for hi in range(b * h):
        for r in range(nq):
            n = lengths[(r + hi) % len(lengths)]
            row = torch.zeros(s1, dtype=torch.bool, device=dev)
            row[torch.randperm(s1, generator=g, device=dev)[:n]] = True
            rows.append(row)
    mask = torch.stack(rows).view(b, h, nq, s1)
    inds, nb = block_mask_to_kv_lists(mask)
    q = _normed(g, (b, s, h, 64), dev)
    k = _normed(g, (b, s, h, 64), dev)
    v = torch.randn((b, s, h, 64), generator=g, device=dev).bfloat16()
    out = sparse_attention(q, k, v, inds, nb)
    torch.cuda.synchronize()
    ref = sparse_attention_plain(q, k, v, inds, nb)
    empty = (nb == 0).nonzero().tolist()
    for bi, hi, r in empty:
        assert torch.all(out[bi, r * 64:(r + 1) * 64, hi] == 0)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    assert _fails_bound(sparse_attention_plain(q * 0, k, v, inds, nb), ref,
                        3e-2, 1e-2)


def _stream_case(dev, b, h, t, s, past, filled, seed=1):
    """The streaming mid attention's layout: `past` carried frames (the
    newest `filled[i]` valid in batch i) then `t` chunk frames of `s`
    tokens, frame-causal ids."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lq, lk = t * s, (past + t) * s
    q = torch.randn((b, lq, h, 512), generator=g, device=dev).bfloat16()
    k = torch.randn((b, lk, h, 512), generator=g, device=dev).bfloat16()
    v = torch.randn((b, lk, h, 512), generator=g, device=dev).bfloat16()
    slot = torch.arange(past, device=dev)
    kv_ids = torch.cat([slot.repeat_interleave(s), (past + torch.arange(
        t, device=dev)).repeat_interleave(s)])[None].expand(b, lk).contiguous()
    q_ids = kv_ids[:, past * s:].contiguous()
    mask = torch.stack([torch.cat([
        (slot >= past - f).repeat_interleave(s),
        torch.ones(t * s, dtype=torch.bool, device=dev)]) for f in filled])
    return q, k, v, mask, q_ids, kv_ids


@pytest.mark.parametrize("b,h,t,s,past,filled", [
    (1, 1, 2, 64, 4, (2,)), (1, 1, 1, 200, 4, (0,)), (1, 1, 3, 100, 2, (1,)),
    (2, 2, 2, 96, 3, (3, 1)), (1, 1, 4, 6144, 4, (0,)),
    (1, 1, 3, 6144, 4, (4,)), (1, 1, 4, 6144, 4, (4,))])
def test_k4_matches_plain(dev, b, h, t, s, past, filled):
    """K4 at the streaming mid attention's layout: Lq not a multiple of
    the 64-row block (200, 300), two batches with their own buffer masks
    and two heads, a chunk whose past slots are all masked (the first
    chunk of a decode, whose masked tiles the kernel skips), and the 1 s
    stream decode's chunks at 512x768 (4 frames with nothing carried, 3
    frames after a full buffer) with a 4-frame chunk after a full buffer."""
    q, k, v, mask, q_ids, kv_ids = _stream_case(dev, b, h, t, s, past, filled)
    out = flash_online(q, k, v, mask, q_ids, kv_ids)
    torch.cuda.synchronize()
    ref = flash_online_plain(q, k, v, mask, q_ids, kv_ids)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    uniform = flash_online_plain(q * 0, k, v, mask, q_ids, kv_ids)
    assert _fails_bound(uniform, ref, 3e-2, 1e-2)


@pytest.mark.parametrize("t,h,w", [(5, 64, 96), (2, 24, 40)])
def test_k4_tiled_decode_tile(dev, t, h, w):
    """K4 as the tiled decode's mid block calls it: q = kv, frame ids, no
    mask: a 512x768 tile of the 1 s and 5 s decodes (5 latent frames), and
    a small ragged one (frames of 960 tokens)."""
    g = torch.Generator(device=dev).manual_seed(3)
    n = t * h * w
    q, k, v = (torch.randn((1, n, 1, 512), generator=g, device=dev).bfloat16()
               for _ in range(3))
    ids = torch.arange(t, device=dev).repeat_interleave(h * w)[None]
    out = flash_online(q, k, v, None, ids, ids)
    torch.cuda.synchronize()
    ref = flash_online_plain(q, k, v, None, ids, ids)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    assert _fails_bound(flash_online_plain(q * 0, k, v, None, ids, ids), ref,
                        3e-2, 1e-2)


def test_k4_row_without_allowed_key(dev):
    """A row with no allowed key (its own frame and every carried slot
    masked) scores -1e30 everywhere, so its weights are all exp(0) = 1 and
    its output is the mean of V over the tiles its block visits: the keys
    of frames up to its own (frames are 128 tokens, so the 32-key tiles,
    the 64-row blocks and the earlier kernel's 64-key tiles and 32-row
    blocks all see the same live keys). The kernel must not skip that
    block's masked tiles; the next frame's rows, which have allowed keys,
    match the plain version. Control: the plain version's answer for the
    row (the mean over every key) must fail the bound."""
    s, past, t = 128, 2, 2
    q, k, v, mask, q_ids, kv_ids = _stream_case(dev, 1, 1, t, s, past, (0,))
    mask[0, past * s:(past + 1) * s] = False
    out = flash_online(q, k, v, mask, q_ids, kv_ids)
    torch.cuda.synchronize()
    ref = flash_online_plain(q, k, v, mask, q_ids, kv_ids)
    max_abs, rel = _err(out[:, s:], ref[:, s:])
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    want = v[:, :(past + 1) * s].float().mean(1, keepdim=True).expand(1, s, 1, 512)
    max_abs, rel = _err(out[:, :s], want)
    assert rel < 1e-2 and max_abs < 3e-2, (max_abs, rel)
    assert _fails_bound(ref[:, :s], want, 3e-2, 1e-2)


@pytest.mark.parametrize("b,l,d,ff", [
    (2, 300, 256, 512), (1, 47616, 1792, 7168), (2, 1000, 1792, 7168),
    (1, 256, 1792, 7168), (1, 1536, 1792, 7168), (1, 200, 384, 640)])
def test_k2_matches_plain(dev, b, l, d, ff):
    """K2 at the 5 s shape, the text blocks' 256 rows, the image's 1,536,
    batches of two whose L is not a multiple of the 128-row tile (a tile
    holds rows of both items: the control swaps their gates), and widths
    that are not multiples of the 256-column tile."""
    g = torch.Generator(device=dev).manual_seed(2)
    x = torch.randn((b, l, d), generator=g, device=dev).bfloat16()
    scale, shift, gate = (torch.randn((b, d), generator=g, device=dev) * 0.1
                          for _ in range(3))
    w1 = (torch.randn((ff, d), generator=g, device=dev) / math.sqrt(d)).bfloat16()
    w2 = (torch.randn((d, ff), generator=g, device=dev) / math.sqrt(ff)).bfloat16()
    _kernels.reset_launches()
    out = fused_ff_modulated(x, scale, shift, w1, w2, gate)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K2_ff_mod"] == 1
    ref = ff_mod_plain(x, scale, shift, w1, w2, gate)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)
    if b == 2:
        swapped = ff_mod_plain(x, scale, shift, w1, w2, gate.flip(0))
        assert _fails_bound(swapped, ref, 6e-2, 1e-2)


@pytest.mark.parametrize("b,l,d", [(1, 47616, 1792), (2, 1000, 1792),
                                   (2, 77, 384)])
def test_modulate_matches_plain(dev, b, l, d):
    """K2's modulation pass alone: the same fp32 operations as the plain
    version but for the order of the row sums, so each bf16 output is
    within one ulp of the plain one (or 2^-20 where the shift cancels the
    normed term to near zero); the other item's scale must fail that."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.randn((b, l, d), generator=g, device=dev) * 3 + 0.5).bfloat16()
    scale, shift = (torch.randn((b, d), generator=g, device=dev) * 0.1
                    for _ in range(2))
    _kernels.reset_launches()
    out = modulate(x, scale, shift)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["K2_modulate"] == 1
    ref = modulate_plain(x, scale, shift)
    _, e = torch.frexp(ref.float())
    bound = torch.ldexp(torch.ones_like(ref, dtype=torch.float32),
                        e - 8).clamp_min(2.0 ** -20)
    diff = (out.float() - ref.float()).abs()
    assert bool((diff <= bound).all()), (diff / bound).max().item()
    if b == 2:
        wrong = modulate_plain(x, scale.flip(0), shift)
        assert not bool(((wrong.float() - ref.float()).abs() <= bound).all())


@pytest.mark.parametrize("lead,d,ff", [
    ((600,), 256, 512), ((2, 300), 256, 1024), ((47616,), 1792, 7168 // 4),
    ((1, 47616), 1792, 7168 // 2), ((47616,), 1792, 7168), ((100,), 256, 512),
    ((1, 77), 1792, 7168)])
def test_k8_matches_plain(dev, lead, d, ff):
    """K8 at ragged rows, leading dims, row counts below one 128-row tile
    and each tensor-parallel rank's share of the 5 s FF (tp 4, 2, 1), at
    K2's bound: both sides round the same hidden to bf16 and differ in the
    order of the fp32 sums."""
    g = torch.Generator(device=dev).manual_seed(8)
    x = torch.randn((*lead, d), generator=g, device=dev).bfloat16()
    w1 = (torch.randn((ff, d), generator=g, device=dev) / math.sqrt(d)).bfloat16()
    w2 = (torch.randn((d, ff), generator=g, device=dev) / math.sqrt(ff)).bfloat16()
    _kernels.reset_launches()
    out = fused_ff(x, w1, w2)
    torch.cuda.synchronize()
    assert out.shape == x.shape and _kernels.LAUNCHES["K8_ff"] == 1
    ref = ff_plain(x, w1, w2)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)
    # the control: the last 128 hidden units (one tile) left out
    assert _fails_bound(ff_plain(x, w1[:-128], w2[:, :-128]), ref, 6e-2, 1e-2)


@pytest.mark.parametrize("name", ["T2_gemm", "T3_ff", "T4_ff_tiled"])
@pytest.mark.parametrize("rows", [1024, 47616, 1000])
def test_t2_t4_match_plain(dev, name, rows):
    """T2-T4 at the tool's shapes and at 1,000 rows (not a multiple of the
    128-row tile), each with the tool's control (one tile of the reduction
    left out); T2 also at N = 136 (not a multiple of its 256-column
    tile)."""
    g = torch.Generator(device=dev).manual_seed(9)
    x, wo, w1, w2 = bench_pallas_gemm.operands(g, dev, rows)
    case = {c[0]: c for c in bench_pallas_gemm.cases(x, wo, w1, w2)}[name]
    _kernels.reset_launches()
    out = case[1]()
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES[name] == 1
    ref = case[2]()
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)
    assert _fails_bound(case[5](), ref, 6e-2, 1e-2)
    if name == "T2_gemm":
        w = wo[:136]
        max_abs, rel = _err(bench_pallas_gemm.gemm(x, w),
                            bench_pallas_gemm.gemm_plain(x, w))
        assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)


def _k3_zero_padded(x, wt, bias, time_padded):
    """Control for K3's edges: the plain conv with zeros where the kernel
    replicates the edge rows and columns (and, unpadded, the first frame)."""
    xc = x.permute(0, 4, 1, 2, 3).float()
    if not time_padded:
        xc = F.pad(xc, (0, 0, 0, 0, 2, 0))
    y = F.conv3d(xc, wt.float(), bias.float(), padding=(0, 1, 1))
    return y.permute(0, 2, 3, 4, 1).to(x.dtype)


@pytest.mark.parametrize("b,t,h,w,cin,cout,time_padded", [
    (1, 3, 8, 20, 128, 256, False), (1, 5, 8, 20, 256, 128, True),
    (1, 2, 64, 96, 512, 512, False), (1, 1, 5, 13, 128, 128, False),
    (1, 3, 13, 35, 256, 128, True), (2, 3, 9, 21, 128, 256, False)])
def test_k3_matches_plain(dev, b, t, h, w, cin, cout, time_padded):
    """K3 in bf16, with ragged tiles: H and W that are not multiples of the
    kernel's 8 x 16 output tile, a single output frame, a batch of two.
    Control: zeros in place of the replicated edges (and leading frames)
    fail the bound."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((b, t, h, w, cin), generator=g, device=dev).bfloat16()
    wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
          / math.sqrt(27 * cin)).bfloat16()
    bias = torch.randn((cout,), generator=g, device=dev).bfloat16()
    out = causal_conv3d_fused(x, wt, bias, time_padded=time_padded)
    torch.cuda.synchronize()
    ref = conv3d_plain(x, wt, bias, time_padded=time_padded)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)
    assert _fails_bound(_k3_zero_padded(x, wt, bias, time_padded), ref, 6e-2,
                        1e-2)
    if b > 1:  # the batch items swapped
        assert _fails_bound(out.flip(0), ref, 6e-2, 1e-2)


def _k3_inputs(dev, t, h, w, cin, cout, seed=3, b=1):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = (torch.randn((b, t, h, w, cin), generator=g, device=dev)
         * (1 + torch.arange(w, device=dev)[:, None] / w)).bfloat16()
    wt = (torch.randn((cout, cin, 3, 3, 3), generator=g, device=dev)
          / math.sqrt(27 * cin)).bfloat16()
    bias = torch.randn((cout,), generator=g, device=dev).bfloat16()
    scale = 1 + 0.2 * torch.randn((cin,), generator=g, device=dev)
    shift = 0.1 * torch.randn((cin,), generator=g, device=dev)
    return x, wt, bias, scale, shift


@pytest.mark.parametrize("b,t,h,w,cin,cout,time_padded,prefix,act", [
    (1, 3, 8, 20, 128, 256, False, 0, True), (1, 5, 8, 64, 256, 128, True, 2, True),
    (1, 2, 64, 96, 512, 512, False, 0, False), (1, 1, 5, 13, 128, 128, False, 0, True),
    (1, 4, 11, 27, 128, 256, True, 4, True), (2, 3, 9, 21, 256, 128, True, 1, True)])
def test_k3_fused_matches_plain(dev, b, t, h, w, cin, cout, time_padded, prefix,
                                act):
    """The GroupNorm-fold (+ SiLU) prologue, with carried prefix planes in
    some cases (in one, every input plane is carried), on ragged tiles, one
    output frame and a batch of two. Kernel and plain version transform with
    the same fp32 operations and round once to bf16, so they differ only in
    summation order. Control: the plain conv without the prologue fails the
    bound; where every plane is carried (and the prologue touches nothing),
    the plain conv that transforms every plane fails it."""
    x, wt, bias, scale, shift = _k3_inputs(dev, t, h, w, cin, cout, b=b)
    kw = dict(time_padded=time_padded, scale=scale, shift=shift, act=act,
              prefix_planes=prefix)
    out = causal_conv3d_fused(x, wt, bias, **kw)
    torch.cuda.synchronize()
    ref = conv3d_plain(x, wt, bias, **kw)
    max_abs, rel = _err(out, ref)
    assert rel < 1e-2 and max_abs < 6e-2, (max_abs, rel)
    control = (conv3d_plain(x, wt, bias, **dict(kw, prefix_planes=0))
               if prefix == t else
               conv3d_plain(x, wt, bias, time_padded=time_padded))
    assert _fails_bound(control, ref, 6e-2, 1e-2)


def test_k3_prologue_exact_on_every_bf16(dev):
    """The prologue inside K3 equals torch's on the card bit for bit (up to
    the sign of zero) for every finite bf16 input below 1e30 under 128
    (scale, shift) pairs: the conv's only nonzero weight is an identity
    matrix on the centre tap of the newest frame, so each output is its
    input's transformed value. Control: the same values without SiLU
    differ."""
    from kandinsky5_tpu_torch.ops.conv import conv_prologue

    g = torch.Generator(device=dev).manual_seed(5)
    vals = torch.arange(65536, dtype=torch.int32, device=dev).to(
        torch.int16).view(torch.bfloat16)
    vals = vals[vals.float().abs() < 1e30]
    cols = 256
    rows = -(-vals.numel() // cols)
    x = torch.zeros(rows * cols, dtype=torch.bfloat16, device=dev)
    x[:vals.numel()] = vals
    c = 128
    x = x.reshape(1, 1, rows, cols, 1).expand(1, 1, rows, cols, c).contiguous()
    scale = torch.randn((c,), generator=g, device=dev) * 2
    shift = torch.randn((c,), generator=g, device=dev) * 3
    wt = torch.zeros((c, c, 3, 3, 3), device=dev)
    wt[:, :, 2, 1, 1] = torch.eye(c, device=dev)
    zero = torch.zeros(c, device=dev)
    out = causal_conv3d_fused(x, wt.bfloat16(), zero, scale=scale, shift=shift,
                              act=True)
    torch.cuda.synchronize()
    ref = conv_prologue(x, scale, shift, True)
    o, r = out.float(), ref.float()
    assert bool(((o == r) | (o.isnan() & r.isnan())).all())
    assert not bool((o == conv_prologue(x, scale, shift, False).float()).all())


def _assert_flips_only(out, ref, x, wt, flips=4):
    """W8A8 kernel against its plain version: the same codes, exact int32
    sums and the same epilogue, so equal, except where a transformed value
    lies within an ulp of a rounding (the prologue's exp on this card against
    torch's): at most ``flips`` flipped codes, each moving the outputs of
    its 3x3x3 neighbourhood by at most s * max|w|."""
    d = (out.float() - ref.float()).abs()
    step = x.float().abs().max() / 127.0 * wt.float().abs().max()
    assert int((d > 0).sum()) <= flips * 27 * out.shape[-1]
    assert float(d.max()) <= 2 * float(step)


@pytest.mark.parametrize("t,h,w,cin,cout,time_padded,fuse", [
    (3, 16, 320, 128, 128, False, False), (3, 16, 320, 128, 128, False, True),
    (6, 16, 384, 256, 256, True, True), (3, 16, 144, 128, 128, False, False),
    (2, 8, 576, 128, 128, False, True), (1, 16, 160, 128, 128, False, True)])
def test_k3_quant_matches_plain(dev, monkeypatch, t, h, w, cin, cout,
                                time_padded, fuse):
    """W8A8 over several TPU tiles in H and W (bw 64 at W 320, 96 at W 384
    with 256 channels, 48 at W 144, 192 at W 576, 32 at W 160 with one
    output frame), plain and with the prologue (time_padded with two prefix
    planes in the third case). K3's output tile (8 rows x 16 columns) lies
    in one scale tile at every bw, the widths that are not powers of two
    included. Control: the plain version with one scale for the whole
    tensor fails, so the windows matter."""
    from kandinsky5_tpu_torch.ops import conv as conv_mod

    assert conv_mod.quant_tile_width(w, cin, cout) < w
    x, wt, bias, scale, shift = _k3_inputs(dev, t, h, w, cin, cout)
    kw = dict(time_padded=time_padded, quant=True)
    if fuse:
        kw.update(scale=scale, shift=shift, act=True,
                  prefix_planes=2 if time_padded else 0)
    out = causal_conv3d_fused(x, wt, bias, **kw)
    torch.cuda.synchronize()
    ref = conv3d_plain(x, wt, bias, **kw)
    xt = (conv_mod.conv_prologue(x, scale, shift, True, kw.get("prefix_planes", 0))
          if fuse else x)
    _assert_flips_only(out, ref, xt, wt)
    real = conv_mod.window_scales

    def one_scale(*args):
        s, _ = real(*args)
        return torch.full_like(s, s.max()), torch.full_like(s, 1.0 / s.max())

    monkeypatch.setattr(conv_mod, "window_scales", one_scale)
    with pytest.raises(AssertionError):
        _assert_flips_only(out, conv3d_plain(x, wt, bias, **kw), xt, wt)


def test_launch_counters_count_kernel_launches(dev):
    _kernels.reset_launches()
    x = torch.randn((1, 3, 8, 64, 128), device=dev).bfloat16()
    wt = torch.randn((128, 128, 3, 3, 3), device=dev).bfloat16() * 0.01
    b = torch.zeros(128, device=dev)
    causal_conv3d_fused(x, wt, b)
    assert _kernels.LAUNCHES["K3_conv3d"] == 1
    causal_conv3d_fused(x.cpu(), wt.cpu(), torch.zeros(128))
    assert _kernels.LAUNCHES["K3_conv3d"] == 1
    one = torch.ones(128, device=dev)
    causal_conv3d_fused(x, wt, b, scale=one, shift=b, act=True)
    causal_conv3d_fused(x, wt, b, quant=True)
    assert _kernels.LAUNCHES["K3_conv3d_fused"] == 1
    assert _kernels.LAUNCHES["K3_conv3d_quant"] == 1
    assert _kernels.LAUNCHES["K3_quant_windows"] == 1
    assert _kernels.LAUNCHES["K3_conv3d"] == 1


# a DiT whose visual FF K8 takes at tp 2 (256-wide model, 4 heads of 64,
# ff 1024 -> 512 a rank, 512 visual tokens), small enough for a test
TP_DIT = dict(in_visual_dim=16, out_visual_dim=16, in_text_dim=64,
              in_text_dim2=32, time_dim=64, model_dim=256, ff_dim=1024,
              num_text_blocks=1, num_visual_blocks=2, axes_dims=(16, 24, 24),
              visual_cond=True)


def test_tp_dit_on_one_card(dev):
    """Two gloo ranks share the card: each runs its share of the bf16 DiT
    (K1 on its 2 heads, K8 on its FF share, bf16 all-reduces through the
    host) and both match the single-device forward (K2 FF) to bf16 rounding
    through three blocks; K8 launches once per visual block, K2 never."""
    from kandinsky5_tpu_torch.config import DiTParams
    from kandinsky5_tpu_torch.models.dit import dit_forward, fast_init_dit_params
    from kandinsky5_tpu_torch.parallel import launch

    cfg = DiTParams(**TP_DIT)
    model = fast_init_dit_params(cfg, device=dev, seed=3)
    ref = dit_forward(model, *_torch_tp_ranks.card_inputs(cfg, dev),
                      scale_factor=(1.0, 2.0, 2.0)).float().cpu()
    results = launch(_torch_tp_ranks.card_forward, 2, "gloo", "cuda",
                     args=(TP_DIT, 3), timeout=600)
    for out, launches, calls in results:
        max_abs, rel = _err(out, ref)
        assert rel < 2e-2, (max_abs, rel)
        assert launches["K8_ff"] == cfg.num_visual_blocks
        assert launches["K2_ff_mod"] == 0
        assert launches["K1_flash_fixed"] == (cfg.num_text_blocks
                                              + cfg.num_visual_blocks)
        assert calls == 3 * cfg.num_visual_blocks
    assert torch.equal(results[0][0], results[1][0])
