"""The port's attention (kandinsky5_tpu_torch/ops/attention.py, flash.py)
against the JAX package: K1's and K4's plain versions against the Pallas
kernels run in interpret mode, and against dense attention in fp32; and
the short-KV dispatch rule."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from kandinsky5_tpu.ops.attention import dense_attention as jax_dense
from kandinsky5_tpu.ops.flash_pallas import flash_attention as jax_flash
from kandinsky5_tpu_torch.ops import attention as tatt
from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.ops.flash import (
    K4_BLOCK_K,
    K4_BLOCK_Q,
    flash_attention,
    flash_fixed_plain,
    flash_online_plain,
    online_plan,
    score_bound,
)

from ._torch_parity import rand, to_np


def _normed(rng, *shape):
    x = rand(rng, *shape)
    return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True))


def _stream_layout(s, past, t, filled):
    """vae_stream.attention_stream's ids and buffer mask."""
    slot = np.arange(past)
    kv_ids = np.concatenate([np.repeat(slot, s),
                             np.repeat(past + np.arange(t), s)])[None]
    q_ids = kv_ids[:, past * s:]
    mask = np.concatenate([np.repeat(slot >= past - filled, s),
                           np.ones(t * s, bool)])[None]
    return q_ids.astype(np.int32), kv_ids.astype(np.int32), mask


@pytest.mark.parametrize("masked", [False, True])
def test_k1_plain_matches_pallas_interpret_bf16(masked):
    """bf16, ragged L = 300 (not a block multiple), d = 64. The Pallas
    kernel rounds q * log2(e)/sqrt(d) and the shift to bf16 before its
    product; K1 keeps them in fp32. Both round the softmax weights and the
    output to bf16, so they agree to a few bf16 ulps: 2e-2."""
    rng = np.random.default_rng(0)
    q, k = _normed(rng, 2, 300, 2, 64), _normed(rng, 2, 300, 2, 64)
    v = rand(rng, 2, 300, 2, 64)
    mask = np.arange(300)[None] < np.array([[300], [111]]) if masked else None
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = jax_flash(jq, jk, jv, kv_mask=None if mask is None else
                     jnp.asarray(mask), interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    got = flash_attention(tq, tk, tv, None if mask is None else
                          torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2, atol=2e-2)


def test_k4_plain_matches_pallas_interpret_bf16():
    """bf16, d = 512, the streaming mid attention's id and mask layout
    (4 carried frames, 2 of them filled, then 2 chunk frames of 8x8). Unit
    q and k give scores of standard deviation 1, so the weights are far
    from uniform. Same bf16 roundings on both sides, summation order
    differs: 2e-2. Control: uniform weights over the allowed keys (q = 0)
    fail that bound."""
    rng = np.random.default_rng(1)
    s, past, t = 64, 4, 2
    q_ids, kv_ids, mask = _stream_layout(s, past, t, filled=2)
    q = rand(rng, 1, t * s, 1, 512)
    k = rand(rng, 1, (past + t) * s, 1, 512)
    v = rand(rng, 1, (past + t) * s, 1, 512)
    want = jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                     kv_mask=jnp.asarray(mask), q_ids=jnp.asarray(q_ids),
                     kv_ids=jnp.asarray(kv_ids), fixed_shift=False,
                     interpret=True)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    ids = dict(kv_mask=torch.from_numpy(mask), q_ids=torch.from_numpy(q_ids),
               kv_ids=torch.from_numpy(kv_ids))
    got = flash_attention(tq, tk, tv, **ids)
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-2, atol=2e-2)
    uniform = flash_attention(torch.zeros_like(tq), tk, tv, **ids)
    assert not np.allclose(to_np(uniform), to_np(want), rtol=2e-2, atol=2e-2)


def test_k4_plain_matches_pallas_interpret_fp32():
    """The same layout in fp32, unit q and k: the algorithms agree to fp32
    summation order, 2e-4."""
    rng = np.random.default_rng(2)
    s, past, t = 48, 4, 3
    q_ids, kv_ids, mask = _stream_layout(s, past, t, filled=1)
    q = rand(rng, 1, t * s, 1, 512)
    k = rand(rng, 1, (past + t) * s, 1, 512)
    v = rand(rng, 1, (past + t) * s, 1, 512)
    want = jax_flash(*(jnp.asarray(a) for a in (q, k, v)),
                     kv_mask=jnp.asarray(mask), q_ids=jnp.asarray(q_ids),
                     kv_ids=jnp.asarray(kv_ids), fixed_shift=False,
                     interpret=True)
    got = flash_online_plain(*(torch.from_numpy(a) for a in (q, k, v)),
                             torch.from_numpy(mask), torch.from_numpy(q_ids),
                             torch.from_numpy(kv_ids))
    np.testing.assert_allclose(to_np(got), to_np(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("masked", [False, True])
def test_plain_kernels_match_dense_fp32(masked):
    """fp32, QK-RMSNorm'd inputs (the regime the fixed shift is valid
    for): K1's and K4's plain versions equal dense softmax attention to
    2e-4."""
    rng = np.random.default_rng(3)
    q, k = _normed(rng, 2, 200, 3, 64), _normed(rng, 2, 150, 3, 64)
    v = rand(rng, 2, 150, 3, 64)
    mask = np.arange(150)[None] < np.array([[150], [40]]) if masked else None
    want = to_np(jax_dense(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           kv_mask=None if mask is None else jnp.asarray(mask)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tm = None if mask is None else torch.from_numpy(mask)
    np.testing.assert_allclose(to_np(flash_fixed_plain(tq, tk, tv, tm)), want,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(flash_online_plain(tq, tk, tv, tm)), want,
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(to_np(tatt.dense_attention(tq, tk, tv, tm)),
                               want, rtol=2e-4, atol=2e-4)


def test_score_bound_matches_jax():
    from kandinsky5_tpu.ops.flash_pallas import score_bound as jax_bound

    rng = np.random.default_rng(4)
    q, k = rand(rng, 2, 33, 3, 64), rand(rng, 2, 17, 3, 64)
    np.testing.assert_allclose(
        to_np(score_bound(torch.from_numpy(q), torch.from_numpy(k))),
        to_np(jax_bound(jnp.asarray(q), jnp.asarray(k))), rtol=1e-6)


def test_short_kv_rule_applies_to_auto_only(monkeypatch):
    """k_len <= 512 and q_len >= 4 k_len goes dense under "auto"; an
    explicit "flash" is honoured (the JAX dispatch overrides it); text
    self-attention (q_len == k_len) stays on the kernel."""
    assert tatt.short_kv(47616, 256) and tatt.short_kv(1024, 256)
    assert not tatt.short_kv(256, 256) and not tatt.short_kv(4096, 513)
    calls = []

    def fake_flash(q, k, v, kv_mask=None):
        calls.append(q.shape[1])
        return torch.zeros_like(q)

    monkeypatch.setattr(tatt, "flash_attention", fake_flash)
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rand(rng, 1, 1024, 2, 64))
    kv = torch.from_numpy(rand(rng, 1, 256, 2, 64))
    tatt.attention(q, kv, kv, impl="auto")
    assert calls == []
    tatt.attention(q, kv, kv, impl="flash")
    assert calls == [1024]
    tatt.attention(kv, kv, kv, impl="auto")
    assert calls == [1024, 256]


def test_cpu_tensors_never_launch():
    _kernels.reset_launches()
    rng = np.random.default_rng(6)
    q = torch.from_numpy(_normed(rng, 1, 64, 2, 64))
    flash_attention(q, q, q)
    q5 = torch.from_numpy(rand(rng, 1, 64, 1, 512))
    flash_attention(q5, q5, q5)
    assert all(n == 0 for n in _kernels.LAUNCHES.values())


def _k4_visits(n_live, skip, nxt):
    """The tiles K4's producer walks for one block, from its plan row and
    the batch's nxt row (csrc/flash_online.cu)."""
    seen, t = [], 0
    while True:
        if skip:
            t = int(nxt[t])
        if t >= n_live:
            return seen
        seen.append(t)
        t += 1


@pytest.mark.parametrize("s,past,t,filled", [
    (64, 4, 4, 2), (96, 4, 3, 4), (128, 2, 2, 0), (40, 3, 5, 1),
    (100, 4, 3, 2)])
def test_k4_liveness_matches_jax_rule(s, past, t, filled):
    """K4's live tiles per 64-row block (``online_plan``'s first column, a
    prefix) against the TPU kernel's liveness table
    (``flash_pallas._flash_bhld``: the block's largest q id >= the tile's
    smallest kv id, ids padded with 2**30) on the same ids, at K4's blocks
    of 64 queries and 32 keys. Where Lq is ragged (the last two cases) the
    JAX padding makes its last block live everywhere; the port reads the
    last real row, so there it may visit fewer tiles, never more."""
    q_ids, kv_ids, mask = _stream_layout(s, past, t, filled)
    lq, lk = q_ids.shape[1], kv_ids.shape[1]
    bq, bk = K4_BLOCK_Q, K4_BLOCK_K
    _, plan, _ = online_plan(1, lq, lk, torch.from_numpy(mask),
                             torch.from_numpy(q_ids), torch.from_numpy(kv_ids))
    qi = jnp.pad(jnp.asarray(q_ids), ((0, 0), (0, -lq % bq)),
                 constant_values=2 ** 30)
    ki = jnp.pad(jnp.asarray(kv_ids), ((0, 0), (0, -lk % bk)),
                 constant_values=2 ** 30)
    qmax = qi.reshape(1, -1, bq).max(axis=-1)
    kmin = ki.reshape(1, -1, bk).min(axis=-1)
    live = np.asarray(qmax[:, :, None] >= kmin[:, None, :])[0]
    nt = live.shape[1]
    got = np.arange(nt)[None] < plan[0, :, 0].numpy()[:, None]
    if lq % bq == 0:
        np.testing.assert_array_equal(got, live)
    else:
        np.testing.assert_array_equal(got[:-1], live[:-1])
        assert not (got[-1] & ~live[-1]).any()


def test_k4_plan_codes_skips_and_walk():
    """``online_plan``'s key codes (the kv id of a valid key, 2**31 - 1
    where the mask removes it or past Lk), its skip flags (set exactly
    where every row of the block has an allowed key) and the walk they
    give (csrc/flash_online.cu's producer): every tile that holds a key
    some row of the block may see is visited, a block with a row that
    sees no key visits all its live tiles (so that row's output is the
    mean of V over them), and a block that skips visits only live tiles
    holding a valid key. The layout: 2 carried slots, both masked, then
    2 chunk frames of 100 tokens, the first frame's keys masked too."""
    s, past, t = 100, 2, 2
    q_ids, kv_ids, mask = _stream_layout(s, past, t, 0)
    mask[0, past * s:(past + 1) * s] = False
    lq, lk = q_ids.shape[1], kv_ids.shape[1]
    codes, plan, nxt = online_plan(1, lq, lk, torch.from_numpy(mask),
                                   torch.from_numpy(q_ids),
                                   torch.from_numpy(kv_ids))
    bq, bk = K4_BLOCK_Q, K4_BLOCK_K
    nt = -(-lk // bk)
    want = np.full(nt * bk, 2 ** 31 - 1, np.int64)
    want[:lk] = np.where(mask[0], kv_ids[0], 2 ** 31 - 1)
    np.testing.assert_array_equal(codes[0].numpy(), want)
    allowed = (q_ids[0][:, None] >= kv_ids[0][None]) & mask[0][None]
    for qb in range(-(-lq // bq)):
        rows = allowed[qb * bq:(qb + 1) * bq]
        n_live, skip = (int(x) for x in plan[0, qb])
        assert skip == int(rows.any(1).all())
        seen = _k4_visits(n_live, skip, nxt[0].numpy())
        needed = {j // bk for j in np.flatnonzero(rows.any(0))}
        assert needed <= set(seen)
        if skip:
            assert seen == [j for j in range(n_live)
                            if mask[0, j * bk:(j + 1) * bk].any()]
        else:
            assert seen == list(range(n_live))


def test_k4_plan_without_mask_or_ids():
    """No mask: no nxt and no skips; no ids: every tile live and every
    valid key coded 0."""
    ids = torch.arange(3).repeat_interleave(70)[None]
    codes, plan, nxt = online_plan(1, 210, 210, None, ids, ids)
    assert nxt is None and not plan[..., 1].any()
    codes, plan, nxt = online_plan(2, 100, 90, None, None, None)
    assert nxt is None and plan.shape == (2, 2, 2)
    assert (plan[..., 0] == 3).all()
    assert (codes[:, :90] == 0).all() and (codes[:, 90:] == 2 ** 31 - 1).all()
