"""The port's flow-matching trainer (``kandinsky5_tpu_torch/training.py``)
against the JAX package's ``training.py`` on the CPU.

The config is ``tests/test_training_zero.py``'s (a 128-wide DiT, one text
and two visual blocks, fp32, dense attention), with every parameter drawn
from a seeded numpy generator (``_torch_parity.random_dit_pair``: modulation
not zero, so every block does work) and handed to both packages. Steps of
the port are taken on JAX's own t and noise (``train_step_on``)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu import training as jt
from kandinsky5_tpu.checkpoint import (
    convert_dit_state_dict,
    dit_params_to_state_dict,
)
from kandinsky5_tpu_torch import training as tt
from kandinsky5_tpu_torch.checkpoint import dit_state_dict_from_jax

from ._torch_parity import both_cfgs, rand, random_dit_pair, to_np

SETUP = dict(in_text_dim=32, in_text_dim2=16, time_dim=32,
             patch_size=(1, 2, 2), model_dim=128, ff_dim=256,
             num_text_blocks=1, num_visual_blocks=2, axes_dims=(8, 4, 4))
CFGS = {"plain": dict(SETUP, in_visual_dim=4, out_visual_dim=4,
                      visual_cond=False),
        "visual_cond": dict(SETUP, in_visual_dim=4, out_visual_dim=4,
                            visual_cond=True)}


def _setup(case="plain", seed=0):
    jcfg, pcfg = both_cfgs(**CFGS[case])
    jparams, model = random_dit_pair(jcfg, pcfg, seed=seed)
    rng = np.random.default_rng(seed + 10)
    b, length = 4, 8
    mask = np.ones((b, length), bool)
    mask[1, 5:] = False
    batch = (rand(rng, b, 2, 8, 8, 4), rand(rng, b, length, 32),
             rand(rng, b, 16), mask)
    return jcfg, pcfg, jparams, model, batch


def _jax_draws(x0, key):
    """The t and noise JAX's ``train_step`` draws from ``key``."""
    t_key, n_key = jax.random.split(key)
    t = jax.random.uniform(t_key, (x0.shape[0],), jnp.float32, 1e-4, 1.0)
    noise = jax.random.normal(n_key, x0.shape, jnp.float32)
    return np.asarray(t), np.asarray(noise)


def _torch(batch):
    return [torch.from_numpy(np.asarray(a)) for a in batch]


def _port_named(model, tensors):
    return dict(zip((k for k, p in model.named_parameters()), tensors))


def _jax_named(tree):
    return dit_state_dict_from_jax(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("case", list(CFGS))
def test_loss_and_grads_match_jax(case):
    """``flow_matching_loss`` and the gradient of every parameter against
    JAX's ``value_and_grad`` of its loss, fp32, rtol 1e-4 (atol 1e-4 of the
    tensor's largest gradient)."""
    jcfg, pcfg, jparams, model, batch = _setup(case)
    t, noise = _jax_draws(batch[0], jax.random.PRNGKey(3))
    jb = [jnp.asarray(a) for a in batch]

    def loss_fn(p):
        return jt.flow_matching_loss(p, jcfg, *jb, jnp.asarray(t),
                                     jnp.asarray(noise), attn_impl="dense")

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams)
    params = list(model.parameters())
    loss = tt.flow_matching_loss(model, pcfg, *_torch(batch),
                                 torch.from_numpy(t), torch.from_numpy(noise),
                                 attn_impl="dense")
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    want = _jax_named(want_grads)
    got = _port_named(model, grads)
    assert got.keys() == want.keys()
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(to_np(got[k]), want[k], rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clip-active",
                                                  "clip-inactive"])
def test_train_step_matches_jax(clip):
    """One optimizer step on JAX's t and noise at lr 1e-4: the loss and
    every parameter against JAX's ``train_step`` (rtol 2e-4, atol 2e-5, the
    JAX package's own ZeRO test bound), with the global-norm clip active
    (norm above 1) and inactive."""
    jcfg, pcfg, jparams, model, batch = _setup()
    key = jax.random.PRNGKey(5)
    jopt = jt.make_optimizer(lr=1e-4, clip=clip)
    jstate, jloss = jt.train_step(jt.init_train_state(jparams, jopt), jcfg,
                                  jopt, *[jnp.asarray(a) for a in batch], key,
                                  attn_impl="dense")
    t, noise = _jax_draws(batch[0], key)
    loss = tt.flow_matching_loss(model, pcfg, *_torch(batch),
                                 torch.from_numpy(t), torch.from_numpy(noise),
                                 attn_impl="dense")
    norm = torch.sqrt(sum(g.square().sum() for g in torch.autograd.grad(
        loss, list(model.parameters()))))
    assert bool(norm >= clip) == (clip == 1.0), norm

    opt = tt.make_optimizer(lr=1e-4, clip=clip)
    state, loss = tt.train_step_on(tt.init_train_state(model, opt), pcfg, opt,
                                   *_torch(batch), torch.from_numpy(t),
                                   torch.from_numpy(noise), attn_impl="dense")
    assert state.step == 1 and state.opt_state["count"] == 1
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-4)
    want = _jax_named(jstate.params)
    got = {k: to_np(v) for k, v in model.state_dict().items()}
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5,
                                   err_msg=k)


def test_train_step_draws_from_its_generator():
    """``train_step`` is ``train_step_on`` at t ~ U(1e-4, 1) and noise ~ N(0,
    1) drawn, in that order, from the generator it is given."""
    _, pcfg, _, model, batch = _setup()
    _, _, _, model2, _ = _setup()
    opt = tt.make_optimizer(lr=1e-4)
    s1, loss1 = tt.train_step(tt.init_train_state(model, opt), pcfg, opt,
                              *_torch(batch), torch.Generator().manual_seed(9),
                              attn_impl="dense")
    g = torch.Generator().manual_seed(9)
    t = 1e-4 + (1.0 - 1e-4) * torch.rand(4, generator=g)
    noise = torch.randn(batch[0].shape, generator=g)
    s2, loss2 = tt.train_step_on(tt.init_train_state(model2, opt), pcfg, opt,
                                 *_torch(batch), t, noise, attn_impl="dense")
    assert loss1.item() == loss2.item()
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


def test_save_restore_resumes_bit_equal(tmp_path):
    """Two steps uninterrupted against save after step 1, restore into a
    fresh state (``step=None``: the latest of steps 0 and 1), step 2: the
    loss and every parameter and moment bit-equal, as JAX's test asserts
    of its orbax round trip."""
    _, pcfg, _, model, batch = _setup()
    opt = tt.make_optimizer(lr=1e-4)
    b = _torch(batch)
    s0 = tt.init_train_state(model, opt)
    tt.save_train_state(s0, str(tmp_path), step=0)
    s1, _ = tt.train_step(s0, pcfg, opt, *b, torch.Generator().manual_seed(5),
                          attn_impl="dense")
    tt.save_train_state(s1, str(tmp_path), step=1)
    s2, loss = tt.train_step(s1, pcfg, opt, *b,
                             torch.Generator().manual_seed(6),
                             attn_impl="dense")
    want = {k: v.clone() for k, v in model.state_dict().items()}

    _, _, _, fresh, _ = _setup(seed=1)
    restored = tt.load_train_state(str(tmp_path),
                                   tt.init_train_state(fresh, opt))
    assert restored.step == 1 and restored.opt_state["count"] == 1
    r2, rloss = tt.train_step(restored, pcfg, opt, *b,
                              torch.Generator().manual_seed(6),
                              attn_impl="dense")
    assert rloss.item() == loss.item()
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, want[k]), k
    for key in ("mu", "nu"):
        for a, c in zip(r2.opt_state[key], s2.opt_state[key]):
            assert torch.equal(a, c)
    # control: resuming from step 0 gives another step 2
    _, _, _, other, _ = _setup(seed=1)
    early = tt.load_train_state(str(tmp_path), tt.init_train_state(other, opt),
                                step=0)
    _, eloss = tt.train_step(early, pcfg, opt, *b,
                             torch.Generator().manual_seed(6),
                             attn_impl="dense")
    assert early.step == 0 and eloss.item() != loss.item()


def test_save_checkpoint_matches_jax_export(tmp_path):
    """JAX params -> the port's model -> ``save_checkpoint`` writes the
    arrays of the JAX package's ``dit_params_to_state_dict``, and its
    ``convert_dit_state_dict`` reads them back to the JAX params."""
    from safetensors.numpy import load_file

    jcfg, _, jparams, model, _ = _setup()
    path = str(tmp_path / "dit.safetensors")
    tt.save_checkpoint(model, path)
    saved = load_file(path)
    want = dit_params_to_state_dict(jax.tree.map(np.asarray, jparams))
    assert saved.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(saved[k], want[k])
    back = convert_dit_state_dict(saved, jcfg, dtype=jnp.float32)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_shard_train_state_raises():
    """ZeRO-1 placement without processes: dp rank d of 2 keeps the slice
    [d n, (d + 1) n) of each moment along its first dim that dp divides,
    the two ranks' slices joining to the whole moment, half of its
    elements each; a dp group of one leaves the state as it is, and a
    state sharded twice raises."""
    from kandinsky5_tpu_torch.parallel import (
        DataParallel,
        RankMesh,
        TensorParallel,
    )
    from kandinsky5_tpu_torch.parallel.ranks import RankGroup

    _, _, _, model, _ = _setup()
    opt = tt.make_optimizer()
    state = tt.init_train_state(model, opt)
    for key in ("mu", "nu"):
        for i, m in enumerate(state.opt_state[key]):
            m.copy_(torch.arange(m.numel(), dtype=m.dtype).reshape(m.shape)
                    + i)

    def place(rank, size):
        return RankMesh(DataParallel(None, rank, size, "gloo", "cpu"),
                        TensorParallel(None, 0, 1, "gloo", "cpu"),
                        RankGroup(None, rank, size, "gloo", "cpu"))

    assert tt.shard_train_state(state, place(0, 1)) is state
    shards = [tt.shard_train_state(state, place(d, 2)) for d in range(2)]
    total = sum(m.numel() for m in state.opt_state["mu"])
    for d, sh in enumerate(shards):
        assert sh.dp.rank == d and sh.model is model and sh.step == 0
        assert sum(m.numel() for m in sh.opt_state["mu"]) == total // 2
        with pytest.raises(ValueError, match="sharded already"):
            tt.shard_train_state(sh, place(d, 2))
    for key in ("mu", "nu"):
        for i, whole in enumerate(state.opt_state[key]):
            dim = shards[0].opt_state["dims"][i]
            assert dim == tt.moment_dim(whole.shape, None, 2)
            assert dim == next(a for a, n in enumerate(whole.shape)
                               if n % 2 == 0)
            joined = torch.cat([sh.opt_state[key][i] for sh in shards], dim)
            assert torch.equal(joined, whole)


def test_zero1_state_saves_one_file_per_dp_rank(tmp_path):
    """A ZeRO-1 state writes its rank's moment slices to a file of its own
    (two ranks sharing a directory do not overwrite each other) and loads
    them back into a state sharded alike."""
    from kandinsky5_tpu_torch.parallel import (
        DataParallel,
        RankMesh,
        TensorParallel,
    )
    from kandinsky5_tpu_torch.parallel.ranks import RankGroup

    def place(rank):
        return RankMesh(DataParallel(None, rank, 2, "gloo", "cpu"),
                        TensorParallel(None, 0, 1, "gloo", "cpu"),
                        RankGroup(None, rank, 2, "gloo", "cpu"))

    opt = tt.make_optimizer()
    paths = []
    for rank in range(2):
        _, _, _, model, _ = _setup()
        state = tt.shard_train_state(tt.init_train_state(model, opt),
                                     place(rank))
        for m in state.opt_state["mu"]:
            m.fill_(rank + 1.0)
        paths.append(tt.save_train_state(state._replace(step=3),
                                         str(tmp_path), 3))
    assert len(set(paths)) == 2
    for rank in range(2):
        _, _, _, model, _ = _setup()
        like = tt.shard_train_state(tt.init_train_state(model, opt),
                                    place(rank))
        back = tt.load_train_state(str(tmp_path), like)
        assert back.step == 3 and back.dp is like.dp
        assert all(torch.equal(m, torch.full_like(m, rank + 1.0))
                   for m in back.opt_state["mu"])
