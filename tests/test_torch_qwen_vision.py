"""The port's Qwen2.5-VL vision tower (``kandinsky5_tpu_torch/text/
qwen_vision.py``) against the JAX package's ``vision_forward`` and HF's
``Qwen2_5_VisionTransformerPretrainedModel`` on the CPU.

A tiny HF tower is built from a config by ``transformers`` (no download),
seeded; both packages take its weights through their converters. fp32
throughout; the bound is ``tests/test_qwen_vision.py``'s (rtol 2e-4, atol
2e-5)."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.checkpoint import (
    convert_qwen_vision_state_dict as jax_convert_vision,
)
from kandinsky5_tpu.text import qwen_vision as jax_qv
from kandinsky5_tpu_torch.checkpoint import (
    convert_qwen_vision_state_dict,
    qwen_vision_state_dict_from_jax,
    vision_from_state_dict,
)
from kandinsky5_tpu_torch.text import qwen_vision as qv

TINY = dict(depth=4, hidden_size=32, intermediate_size=64, num_heads=2,
            in_channels=3, patch_size=14, spatial_merge_size=2,
            temporal_patch_size=2, out_hidden_size=48, window_size=56)
GRIDS = {
    "one-image": [(1, 8, 12)],            # windows tile a 4 x 6 merge grid
    "image+video": [(1, 4, 4), (2, 8, 8)],  # several samples
    "ragged": [(1, 6, 10)],               # window padding exercised
}


@pytest.fixture(scope="module")
def towers():
    from transformers.models.qwen2_5_vl.configuration_qwen2_5_vl import (
        Qwen2_5_VLVisionConfig,
    )
    from transformers.models.qwen2_5_vl.modeling_qwen2_5_vl import (
        Qwen2_5_VisionTransformerPretrainedModel,
    )

    hf_cfg = Qwen2_5_VLVisionConfig(**TINY, fullatt_block_indexes=[1, 3],
                                    hidden_act="silu")
    torch.manual_seed(0)
    hf = Qwen2_5_VisionTransformerPretrainedModel._from_config(hf_cfg)
    hf = hf.eval().float()
    hf.config._attn_implementation = "eager"
    sd = {f"visual.{k}": v.detach().float().numpy()
          for k, v in hf.state_dict().items()}
    jcfg = jax_qv.QwenVisionConfig(**TINY, fullatt_block_indexes=(1, 3))
    pcfg = qv.QwenVisionConfig(**TINY, fullatt_block_indexes=(1, 3))
    jparams = jax_convert_vision(sd, dtype=jnp.float32)
    model = vision_from_state_dict(sd, pcfg, device="cpu", dtype=torch.float32)
    return hf, jcfg, jparams, model


def _patches(cfg, grid, seed=0):
    total = int(sum(t * h * w for t, h, w in grid))
    return np.random.RandomState(seed).randn(total, cfg.patch_dim).astype(
        np.float32)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_vision_forward_matches_jax_and_hf(towers, grid):
    """The port's ``vision_forward`` against JAX's and HF's on each grid."""
    hf, jcfg, jparams, model = towers
    grid_thw = np.asarray(GRIDS[grid], np.int64)
    patches = _patches(model.cfg, GRIDS[grid])
    got = qv.vision_forward(model, torch.from_numpy(patches), grid_thw)
    want = np.asarray(jax_qv.vision_forward(jparams, jcfg, patches, grid_thw))
    with torch.no_grad():
        ref = hf(torch.from_numpy(patches),
                 grid_thw=torch.from_numpy(grid_thw)).numpy()
    assert got.shape == want.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("grid", list(GRIDS))
def test_index_tables_equal_jax(grid):
    """``rot_pos_ids``, ``window_index`` and ``vision_indices`` equal the
    JAX package's exactly, at the tiny and the released configs."""
    grid_thw = np.asarray(GRIDS[grid], np.int64)
    for kw in (dict(TINY, fullatt_block_indexes=(1, 3)), {}):
        pc, jc = qv.QwenVisionConfig(**kw), jax_qv.QwenVisionConfig(**kw)
        np.testing.assert_array_equal(qv.rot_pos_ids(pc, grid_thw),
                                      jax_qv.rot_pos_ids(jc, grid_thw))
        for a, b in zip(qv.window_index(pc, grid_thw),
                        jax_qv.window_index(jc, grid_thw)):
            np.testing.assert_array_equal(a, b)
        got, want = qv.vision_indices(pc, grid_thw), jax_qv.vision_indices(
            jc, grid_thw)
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_converters_round_trip(towers):
    """JAX params -> ``qwen_vision_state_dict_from_jax`` gives HF's state
    dict exactly, and the HF converter keeps the ``visual.*`` entries of
    either layout and nothing else."""
    hf, jcfg, jparams, model = towers
    sd = qwen_vision_state_dict_from_jax(jax.tree.map(np.asarray, jparams),
                                         model.cfg)
    want = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    assert sd.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(sd[k], want[k])
    mixed = {"model.visual.merger.ln_q.weight": np.ones(3),
             "visual.blocks.0.norm1.weight": np.ones(2),
             "model.language_model.norm.weight": np.ones(4),
             "lm_head.weight": np.ones((2, 2))}
    conv = convert_qwen_vision_state_dict(mixed)
    assert sorted(conv) == ["blocks.0.norm1.weight", "merger.ln_q.weight"]


def test_load_vision_tower_reads_config_and_shards(towers, tmp_path):
    """``load_vision_tower`` on a directory holding ``config.json`` and an
    HF-layout safetensors file (``model.visual.*`` beside a text entry):
    the config's dims and the HF tower's outputs."""
    from safetensors.torch import save_file

    hf, jcfg, jparams, model = towers
    tensors = {f"model.visual.{k}": v.detach().contiguous()
               for k, v in hf.state_dict().items()}
    tensors["model.language_model.norm.weight"] = torch.ones(8)
    save_file(tensors, str(tmp_path / "model.safetensors"))
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"vision_config": dict(TINY, fullatt_block_indexes=[1, 3],
                                         hidden_act="silu")}, f)
    loaded = qv.load_vision_tower(str(tmp_path), device="cpu",
                                  dtype=torch.float32)
    assert loaded.cfg == model.cfg
    grid = np.asarray(GRIDS["one-image"], np.int64)
    patches = torch.from_numpy(_patches(model.cfg, GRIDS["one-image"], 1))
    torch.testing.assert_close(qv.vision_forward(loaded, patches, grid),
                               qv.vision_forward(model, patches, grid),
                               rtol=0, atol=0)
