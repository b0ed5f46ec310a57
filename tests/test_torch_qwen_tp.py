"""The port's sharded Qwen text tower (``text/qwen.py`` ``shard_qwen``)
against the JAX package's (``shard_qwen_params``), as
tests/test_qwen_tp.py holds JAX's: the specs shard every large matrix and
replicate the norms, name for name as JAX's ``qwen_param_specs`` (dense and
int8 decode trees, mapped from JAX's (in, out) layout and stacked layers);
on four gloo CPU ranks (sp 2 x tp 2: k/v's 32 features split 8 a rank,
half a head) the fp32 hidden states and the cropped encode within 1e-4 of
JAX's ``make_mesh(4, sp=2)`` run and of the port's one device, 8 greedy
tokens equal to both, the int8 decode tree's 4 tokens equal (quantized
whole then sharded, or quantized on the shares: the same tensors); a rank's
share drawn one tensor at a time equals the whole draw cut; the control, a
sharded tower whose ``o_proj`` skips its sum, fails 1e-4.

One launch (``tests/_torch_qwen_tp_ranks.py``, no JAX); JAX computes its
side while the ranks run."""

import concurrent.futures

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.parallel.sharding import make_mesh
from kandinsky5_tpu.text.qwen import (
    QwenTextConfig as JaxQwenTextConfig,
    init_qwen_params_random as jax_init_qwen,
    qwen_generate as jax_qwen_generate,
    qwen_hidden_states as jax_qwen_hidden_states,
    qwen_param_specs as jax_qwen_param_specs,
    quantize_qwen_decode_params as jax_quantize_qwen,
    shard_qwen_params,
)
from kandinsky5_tpu_torch.checkpoint import (
    qwen_from_state_dict,
    qwen_state_dict_from_jax,
)
from kandinsky5_tpu_torch.parallel import launch
from kandinsky5_tpu_torch.text.qwen import (
    QwenTextConfig,
    quantize_qwen_decode_params,
    qwen_generate,
    qwen_hidden_states,
    qwen_param_specs,
)

from . import _torch_qwen_tp_ranks as ranks_mod

# tests/test_qwen_tp.py's tower: every shardable dim divides by 8
TINY = dict(vocab_size=1024, hidden_size=64, intermediate_size=128,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, head_dim=16)
TOL = 1e-4


def _jax_params():
    return jax_init_qwen(jax.random.PRNGKey(0), JaxQwenTextConfig(**TINY),
                         dtype=jnp.float32)


def _port(params):
    return qwen_from_state_dict(
        qwen_state_dict_from_jax(jax.tree.map(np.asarray, params)),
        QwenTextConfig(**TINY), device="cpu", dtype=torch.float32)


def _case():
    rng = np.random.RandomState(0)
    ids = rng.randint(0, TINY["vocab_size"], (1, 24)).astype(np.int64)
    mask = np.ones((1, 24), bool)
    mask[0, 20:] = False
    return dict(cfg=TINY, ids=ids, mask=mask,
                prompt=np.random.RandomState(1).randint(
                    0, TINY["vocab_size"], (1, 12)).astype(np.int32),
                prompt8=np.random.RandomState(2).randint(
                    0, TINY["vocab_size"], (1, 12)).astype(np.int32))


def _jax_side(params, case):
    mesh = make_mesh(n_devices=4, sp=2)
    cfg = JaxQwenTextConfig(**TINY)
    sharded = shard_qwen_params(params, mesh)
    q8 = shard_qwen_params(jax_quantize_qwen(params), mesh)
    return dict(
        hidden=np.asarray(jax_qwen_hidden_states(
            sharded, cfg, jnp.asarray(case["ids"], jnp.int32),
            jnp.asarray(case["mask"])), np.float32),
        greedy=np.asarray(jax_qwen_generate(sharded, cfg, case["prompt"],
                                            max_new_tokens=8,
                                            eos_token_ids=(0,))),
        int8=np.asarray(jax_qwen_generate(q8, cfg, case["prompt8"],
                                          max_new_tokens=4,
                                          eos_token_ids=(0,))))


@pytest.fixture(scope="module")
def qwen_ranks():
    params = _jax_params()
    case = _case()
    case["state_dict"] = qwen_state_dict_from_jax(
        jax.tree.map(np.asarray, params))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        future = pool.submit(launch, ranks_mod.run, 4, "gloo", "cpu",
                             args=(case,), timeout=600, sp=2)
        want = _jax_side(params, case)
        model = _port(params)
        ids, mask = (torch.from_numpy(case[k]) for k in ("ids", "mask"))
        want["one_hidden"] = qwen_hidden_states(model, ids, mask).numpy()
        want["one_greedy"] = qwen_generate(model, case["prompt"], 8,
                                           eos_token_ids=(0,))
        want["one_int8"] = qwen_generate(quantize_qwen_decode_params(model),
                                         case["prompt8"], 4,
                                         eos_token_ids=(0,))
        want["whole_bytes"] = sum(t.numel() * t.element_size()
                                  for t in model.state_dict().values())
        got = future.result()
    return got, want, case


def _jax_dims(tree, specs):
    """JAX's split of every leaf, as the port's dim, by the port's name."""
    out = {}
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))[0]
    for path, spec in flat:
        keys = [p.key for p in path]
        stacked = keys[0] == "layers"
        axes = tuple(spec)[1:] if stacked else tuple(spec)
        dim = None
        if any(a is not None for a in axes):
            axis = next(i for i, a in enumerate(axes) if a is not None)
            # a linear's (in, out) is the port's (out, in); the embedding
            # table keeps its (vocab, hidden)
            dim = 1 - axis if len(axes) == 2 and keys[0] != "embed_tokens" \
                else axis
        for i in range(TINY["num_hidden_layers"]) if stacked else [None]:
            out[".".join(keys if i is None else
                         [keys[0], str(i)] + keys[1:])] = dim
    return out


@pytest.mark.parametrize("tree", ["dense", "int8"])
def test_specs_match_jax(tree):
    """Every leaf's split, name for name, is JAX's ``qwen_param_specs`` on a
    (sp 2, tp 4) mesh; every large matrix is split and no norm is."""
    params = _jax_params()
    model = _port(params)
    if tree == "int8":
        params, model = jax_quantize_qwen(params), \
            quantize_qwen_decode_params(model)
    mesh = make_mesh(n_devices=8, sp=2)
    want = _jax_dims(params, jax_qwen_param_specs(params, mesh))
    got = qwen_param_specs(model, 8)
    assert got == want
    for name in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                 "up_proj", "down_proj", "embed_tokens", "lm_head"):
        assert any(name in k and d is not None for k, d in got.items()), name
    assert all(d is None for k, d in got.items() if "norm" in k)
    assert got["layers.0.self_attn.o_proj." + (
        "weight_q" if tree == "int8" else "weight")] == 1


def test_sharded_hidden_states_match(qwen_ranks):
    """Every rank's fp32 hidden states and cropped encode within 1e-4 of
    JAX's sharded tower and of the port's one device, on a quarter of the
    weight bytes; the ranks sit on the sp * tp group in JAX's order."""
    got, want, case = qwen_ranks
    for rank, r in enumerate(got):
        assert (r["rank"], r["size"], r["ranks"]) == (rank, 4, [0, 1, 2, 3])
        for ref in (want["hidden"], want["one_hidden"]):
            np.testing.assert_allclose(r["hidden"], ref, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(r["encode"], ref[:, 3:], rtol=TOL,
                                       atol=TOL)
        np.testing.assert_array_equal(r["encode_mask"], case["mask"][:, 3:])
        assert r["weight_bytes"] < 0.3 * want["whole_bytes"]


def test_sharded_greedy_decode_matches(qwen_ranks):
    got, want, _ = qwen_ranks
    assert len(want["greedy"]) == 8
    np.testing.assert_array_equal(want["one_greedy"], want["greedy"])
    for r in got:
        np.testing.assert_array_equal(r["greedy"], want["greedy"])


def test_int8_decode_tree_shards(qwen_ranks):
    """The int8 tree quantized whole then sharded equals the shares
    quantized (row-parallel scales from the max over the group), and its
    4 greedy tokens equal JAX's sharded int8 tree's and the port's one
    device's."""
    got, want, _ = qwen_ranks
    np.testing.assert_array_equal(want["one_int8"], want["int8"])
    for r in got:
        assert r["int8_differ"] == []
        np.testing.assert_array_equal(r["int8"], want["int8"])


def test_share_drawn_alone_equals_the_cut(qwen_ranks):
    got, _, _ = qwen_ranks
    for r in got:
        assert r["drawn_differ"] == [] and r["drawn_tensors"] > 20


def test_o_proj_sum_control_fails(qwen_ranks):
    got, want, _ = qwen_ranks
    for r in got:
        bad = r["no_o_proj_sum"]
        assert not np.allclose(bad, want["one_hidden"], rtol=TOL, atol=TOL)
