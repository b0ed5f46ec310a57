"""The port's NABLA pieces (kandinsky5_tpu_torch/ops/fractal.py, nabla.py,
sparse.py) against the JAX package on the CPU, on the same seeded numpy
inputs: the fractal permutation, the STA mask, the adaptive block mask
(faithful mode: sort, q_rows=1, no cap) and its kv lists exactly; K6's
plain version against the Pallas kernel in interpret mode at 2e-5 in fp32
(the bound of tests/test_pallas_interpret.py) and at 2e-2 in bf16 (both
round q, the weights and the output to bf16 at the same points, and sum in
different orders). And the port's import contract: no module of it, and
not chip_smoke.py, imports jax or the JAX package."""

import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.ops import fractal as jfractal
from kandinsky5_tpu.ops import nabla as jnabla
from kandinsky5_tpu.ops.sparse_pallas import sparse_attention as jax_sparse
from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.fractal import (
    fractal_flatten,
    fractal_inverse_permutation,
    fractal_permutation,
    fractal_unflatten,
)
from kandinsky5_tpu_torch.ops.nabla import (
    BLOCK,
    block_mask_to_kv_lists,
    masked_block_attention,
    nabla_attention,
    nabla_block_mask,
    nabla_build_mask,
    sta_mask,
)
from kandinsky5_tpu_torch.ops.sparse import (
    GROUP,
    group_order,
    sparse_attention,
    sparse_attention_plain,
)

from ._torch_parity import rand, to_np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("grid", [(1, 8, 8), (3, 16, 24), (61, 32, 48)])
def test_fractal_permutation_matches_jax(grid):
    np.testing.assert_array_equal(fractal_permutation(grid),
                                  jfractal.fractal_permutation(grid))
    np.testing.assert_array_equal(fractal_inverse_permutation(grid),
                                  jfractal.fractal_inverse_permutation(grid))


def test_fractal_flatten_round_trip_matches_jax():
    grid = (2, 16, 24)
    x = rand(np.random.default_rng(0), 2, int(np.prod(grid)), 3)
    xt = torch.from_numpy(x)
    got = fractal_flatten(xt, grid)
    np.testing.assert_array_equal(
        to_np(got), np.asarray(jfractal.fractal_flatten(jnp.asarray(x), grid)))
    np.testing.assert_array_equal(to_np(fractal_unflatten(got, grid)), x)
    assert fractal_flatten(xt, grid, block_mask=False) is xt
    with pytest.raises(ValueError):
        fractal_permutation((1, 12, 16))


@pytest.mark.parametrize("shape,win", [((4, 4, 4), (11, 3, 3)),
                                       ((4, 2, 2), (3, 1, 1)),
                                       ((61, 4, 6), (11, 3, 3)),
                                       ((13, 4, 6), (5, 3, 1))])
def test_sta_mask_matches_jax(shape, win):
    got = sta_mask(*shape, *win)
    np.testing.assert_array_equal(got, jnabla.sta_mask(*shape, *win))
    assert got.dtype == np.bool_ and got.shape == (np.prod(shape),) * 2


def _peaked_qk(seed, s1=64, h=2, d=64):
    """q/k whose block-pooled attention is peaked: blocks drawn around a
    few cluster directions, as a trained model's attention is."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((8, h, d)).astype(np.float32)
    assign = rng.integers(0, 8, s1)
    qb = centers[assign] * 2.0 + rng.standard_normal((s1, h, d)) * 0.5
    kb = centers[assign] * 2.0 + rng.standard_normal((s1, h, d)) * 0.5
    q = np.repeat(qb, BLOCK, axis=0) + rng.standard_normal((s1 * BLOCK, h, d))
    k = np.repeat(kb, BLOCK, axis=0) + rng.standard_normal((s1 * BLOCK, h, d))
    return q[None].astype(np.float32), k[None].astype(np.float32)


@pytest.mark.parametrize("thr,win", [(0.9, (3, 1, 1)), (0.9, (11, 3, 3)),
                                     (0.5, (3, 1, 1)), (0.99, (1, 1, 1))])
def test_nabla_block_mask_matches_jax(thr, win):
    q, k = _peaked_qk(1)
    sta = sta_mask(4, 4, 4, *win)
    got = to_np(nabla_block_mask(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(sta), thr=thr)) > 0
    want = np.asarray(jnabla.nabla_block_mask(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(sta), thr=thr,
        method="sort", q_rows=1, max_density=None))
    flipped = np.argwhere(got != want)
    assert flipped.size == 0, f"blocks flipped against JAX: {flipped.tolist()}"
    # the adaptive part keeps blocks beyond the STA window
    assert got.sum() > np.broadcast_to(sta, got.shape).sum()


def test_kv_lists_bit_equal_to_jax():
    rng = np.random.default_rng(3)
    mask = rng.random((2, 3, 24, 24)) < 0.3
    mask[0, 0, 0] = False   # an empty row
    mask[0, 0, 1] = True    # a full row
    got_i, got_n = block_mask_to_kv_lists(torch.from_numpy(mask))
    want_i, want_n = jnabla.block_mask_to_kv_lists(jnp.asarray(mask))
    assert got_i.dtype == torch.int32 and got_n.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


def _sparse_case(seed, dtype=np.float32, s1=16, h=2):
    rng = np.random.default_rng(seed)
    q, k, v = (rand(rng, 1, s1 * BLOCK, h, 64) for _ in range(3))
    sta = jnp.asarray(jnabla.sta_mask(4, 2, 2, 3, 3, 3))
    jmask = jnabla.nabla_block_mask(jnp.asarray(q), jnp.asarray(k), sta,
                                    thr=0.5, method="sort")
    ji, jn = jnabla.block_mask_to_kv_lists(jmask)
    cast = (lambda a: a.astype(jnp.bfloat16)) if dtype != np.float32 else (
        lambda a: a)
    jqkv = [cast(jnp.asarray(a)) for a in (q, k, v)]
    tdt = torch.bfloat16 if dtype != np.float32 else torch.float32
    tqkv = [torch.from_numpy(a).to(tdt) for a in (q, k, v)]
    lists = (torch.from_numpy(np.array(ji)), torch.from_numpy(np.array(jn)))
    return jqkv, tqkv, jmask, lists


def test_sparse_plain_matches_jax_kernel_fp32():
    jqkv, tqkv, jmask, (inds, nb) = _sparse_case(2)
    assert 0 < int(nb.sum()) < nb.numel() * 16
    want = jax_sparse(*jqkv, *map(jnp.asarray, (inds.numpy(), nb.numpy())),
                      q_rows=1, interpret=True)
    got = sparse_attention_plain(*tqkv, inds, nb)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)
    dense = masked_block_attention(*tqkv, torch.from_numpy(np.array(jmask)))
    np.testing.assert_allclose(to_np(got), to_np(dense), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        to_np(dense), to_np(jnabla.masked_block_attention_xla(*jqkv, jmask)),
        rtol=2e-5, atol=2e-5)


def test_sparse_plain_matches_jax_kernel_bf16():
    jqkv, tqkv, _, (inds, nb) = _sparse_case(4, dtype="bf16")
    want = jax_sparse(*jqkv, *map(jnp.asarray, (inds.numpy(), nb.numpy())),
                      q_rows=1, interpret=True)
    got = sparse_attention(*tqkv, inds, nb)  # CPU tensors: the plain version
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2, atol=2e-2)


def test_sparse_plain_empty_row_is_zero():
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rand(rng, 1, 4 * BLOCK, 1, 64)) for _ in range(3))
    mask = torch.ones((1, 1, 4, 4), dtype=torch.bool)
    mask[0, 0, 2] = False
    inds, nb = block_mask_to_kv_lists(mask)
    out = sparse_attention_plain(q, k, v, inds, nb)
    assert torch.all(out[:, 2 * BLOCK:3 * BLOCK] == 0)
    ref = masked_block_attention(q, k, v, mask)
    torch.testing.assert_close(out[:, :2 * BLOCK], ref[:, :2 * BLOCK],
                               rtol=2e-5, atol=2e-5)


def test_nabla_attention_matches_jax():
    q, k = _peaked_qk(6, s1=16)
    v = rand(np.random.default_rng(7), *q.shape)
    sta = sta_mask(4, 2, 2, 3, 1, 1)
    got = nabla_attention(*map(torch.from_numpy, (q, k, v)),
                          torch.from_numpy(sta), thr=0.9)
    want = jnabla.nabla_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(sta), thr=0.9,
                                  q_rows=1, max_density=None, method="sort")
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-5, atol=2e-5)
    m = nabla_build_mask(*map(torch.from_numpy, (q, k)), torch.from_numpy(sta))
    assert torch.equal(m.kv_nb, m.mask.sum(-1, dtype=torch.int32))


@pytest.mark.parametrize("kw", [dict(q_rows=8), dict(method="bisect"),
                                dict(max_density=0.75)])
def test_nabla_attention_rejects_tpu_modes(kw):
    x = torch.zeros((1, 4 * BLOCK, 1, 64))
    with pytest.raises(ValueError, match="faithful"):
        nabla_attention(x, x, x, torch.ones((4, 4), dtype=torch.bool), **kw)


def test_sparse_wrapper_checks_and_cpu_never_launches():
    _kernels.reset_launches()
    x = torch.randn((1, 2 * BLOCK, 1, 64))
    inds, nb = block_mask_to_kv_lists(torch.ones((1, 1, 2, 2), dtype=torch.bool))
    sparse_attention(x, x, x, inds, nb)
    assert _kernels.LAUNCHES["K6_sparse_nabla"] == 0
    with pytest.raises(ValueError):
        sparse_attention(x[:, :100], x, x, inds, nb)
    with pytest.raises(ValueError):
        sparse_attention(x, x, x, inds[..., :1], nb)


@pytest.mark.parametrize("b,h,nq", [(1, 3, 9), (2, 2, 10), (1, 1, 1)])
def test_k6_group_order(b, h, nq):
    """K6's schedule (``group_order``): every group of GROUP query blocks
    once, head by head, and within a head longest first by the group's
    listed blocks, ties in block order."""
    rng = np.random.default_rng(b * 100 + nq)
    nb = torch.from_numpy(rng.integers(0, 6, (b, h, nq)).astype(np.int32))
    order = group_order(nb).numpy()
    ng = -(-nq // GROUP)
    assert order.dtype == np.int32
    assert sorted(order.tolist()) == list(range(b * h * ng))
    padded = np.pad(nb.numpy(), ((0, 0), (0, 0), (0, ng * GROUP - nq)))
    work = padded.reshape(b * h * ng, GROUP).sum(-1)
    heads = order // ng
    assert (np.diff(heads) >= 0).all()
    for hd in range(b * h):
        ids = order[heads == hd]
        w = work[ids]
        assert (np.diff(w) <= 0).all()
        assert all(ids[i] < ids[i + 1] for i in range(len(ids) - 1)
                   if w[i] == w[i + 1])


def test_port_sources_import_no_jax():
    """No module of the port, and not chip_smoke.py, imports jax, jaxlib
    or the JAX package (kandinsky5_tpu)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|kandinsky5_tpu)(\.|\s|$)",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "kandinsky5_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            bad += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                    for m in pat.finditer(f.read())]
    assert not bad, bad
