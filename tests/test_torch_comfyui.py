"""The port's ComfyUI nodes (kandinsky5_tpu_torch/comfyui_nodes.py): the
same node names, inputs and outputs as the JAX package's, an import with no
ComfyUI host, and the node chain (load the text embedders, the DiT and the
VAE from reference-layout checkpoints on disk -> encode -> generate ->
decode) against ``get_T2V_pipeline`` on the same files and seed."""

import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from kandinsky5_tpu import comfyui_nodes as jax_nodes
from kandinsky5_tpu_torch import comfyui_nodes as nodes
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.pipeline import (
    DEFAULT_NEGATIVE,
    RESOLUTIONS,
    get_T2V_pipeline,
)

from .test_torch_entry import DIT_KW, PROMPT, REPO, ckpt  # noqa: F401


@pytest.mark.parametrize("name", sorted(jax_nodes.NODE_CLASS_MAPPINGS))
def test_nodes_match_jax(name):
    assert set(nodes.NODE_CLASS_MAPPINGS) == set(jax_nodes.NODE_CLASS_MAPPINGS)
    assert set(nodes.NODE_DISPLAY_NAME_MAPPINGS) == set(
        jax_nodes.NODE_DISPLAY_NAME_MAPPINGS)
    mine, theirs = nodes.NODE_CLASS_MAPPINGS[name], \
        jax_nodes.NODE_CLASS_MAPPINGS[name]
    assert mine.INPUT_TYPES() == theirs.INPUT_TYPES()
    assert mine.RETURN_TYPES == theirs.RETURN_TYPES
    assert mine.FUNCTION == theirs.FUNCTION
    assert callable(getattr(mine(), mine.FUNCTION))


def test_nodes_import_without_comfyui_or_jax():
    code = ("import sys, kandinsky5_tpu_torch.comfyui_nodes, "
            "kandinsky5_tpu_torch.serve; "
            "assert 'jax' not in sys.modules and 'comfy' not in sys.modules")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_node_chain_matches_pipeline(ckpt, monkeypatch, tmp_path):  # noqa: F811
    """Load -> encode (caption and negative) -> generate -> decode at the
    tiny config: the latents equal the pipeline's bit for bit and the frames
    in [0, 1] are the pipeline's uint8 frames / 255 to within one level.
    The nodes load the text encoders at their released lengths (256, 77),
    so the pipeline's YAML says the same."""
    root, conf_path, _ = ckpt
    with open(conf_path) as f:
        conf = yaml.safe_load(f)
    conf["model"]["text_embedder"]["qwen"]["max_length"] = 256
    conf["model"]["text_embedder"]["clip"]["max_length"] = 77
    conf_path = str(tmp_path / "nodes.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    pipe = get_T2V_pipeline(conf_path=conf_path, device="cpu",
                            dtype=torch.float32)
    kept = []
    real = pipe.decode_latents
    pipe.decode_latents = lambda lat, mode=None: (kept.append(lat),
                                                  real(lat, mode))[1]
    want = pipe(PROMPT, time_length=0, width=64, height=64, seed=9,
                expand_prompts=False)

    cpu = dict(device="cpu", dtype=torch.float32)
    m = conf["model"]
    (emb,) = nodes.Kandinsky5LoadTextEmbedders().load(
        m["text_embedder"]["qwen"]["checkpoint_path"],
        m["text_embedder"]["clip"]["checkpoint_path"], **cpu)
    (dit,) = nodes.Kandinsky5LoadDiT().load(
        m["checkpoint_path"], "flash", dit_params=DiTParams(**DIT_KW), **cpu)
    (vae,) = nodes.Kandinsky5LoadVAE().load(m["vae"]["checkpoint_path"], **cpu)
    (cond,) = nodes.Kandinsky5TextEncode().encode(emb, PROMPT, "image")
    (neg,) = nodes.Kandinsky5TextEncode().encode(emb, DEFAULT_NEGATIVE,
                                                 "image")
    (latents,) = nodes.Kandinsky5Generate().generate(
        dit, cond, neg, width=64, height=64, length=1, steps=2,
        guidance_weight=3.0, scheduler_scale=10.0, seed=9)
    assert torch.equal(latents, kept[0])
    (frames,) = nodes.Kandinsky5VAEDecode().decode(vae, latents)
    assert frames.shape == (1, 64, 64, 3) and frames.dtype == torch.float32
    assert 0.0 <= frames.min() and frames.max() <= 1.0
    diff = frames.numpy() * 255.0 - want[0].astype(np.float64)
    assert diff.min() > -1e-3 and diff.max() < 1.0 + 1e-3
    (text,) = nodes.Kandinsky5PromptExpand().expand(emb, PROMPT)
    assert isinstance(text, str) and text
