"""The released checkpoint layouts load with no ``transformers``,
``tokenizers`` or ``safetensors``: in a fresh process whose import system
refuses those packages (and JAX and the JAX package), tiny models are
written by the port's safetensors writer in the released layouts (a DiT
file, a diffusers VAE, Qwen2.5-VL in shards under an HF index with a vision
entry beside the text tower, the whole-CLIPModel names for CLIP), with
byte-level BPE tokenizer directories written by hand in both released
layouts, then loaded back through ``get_T2V_pipeline(device="cpu")`` and
``Kandinsky5TextEmbedder.from_pretrained``: every parameter, a DiT forward
and a text encode bit-equal to the models in memory, none of the three
packages imported, and a header with one offset changed refused
(``_torch_released.load_round_trip``, which phase 8 of ``chip_smoke.py``
runs at full width)."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r'''
import importlib.abc, json, os, sys
BLOCKED = ("transformers", "tokenizers", "safetensors", "jax", "jaxlib",
           "kandinsky5_tpu")

class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, Blocker())
for name in ("safetensors", "tokenizers", "transformers"):
    try:
        __import__(name)
        raise SystemExit(f"{name} imported despite the blocker")
    except ImportError:
        pass
import torch
from tests._torch_released import load_round_trip
from kandinsky5_tpu_torch.config import load_config
from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
from kandinsky5_tpu_torch.text.clip import ClipTextConfig, init_clip_params_random
from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder
from kandinsky5_tpu_torch.text.qwen import QwenTextConfig, init_qwen_params_random

root, conf_path = sys.argv[1], sys.argv[2]
conf = load_config(conf_path)
cfg = conf.model.dit_params
dit = fast_init_dit_params(cfg, device="cpu", dtype=torch.bfloat16, seed=0)
vae = HunyuanVideoVAE(init_vae_params(device="cpu", dtype=torch.bfloat16, seed=1,
                                      block_out_channels=(32, 32, 64, 64)),
                      dtype=torch.bfloat16)
qwen = init_qwen_params_random(QwenTextConfig(
    vocab_size=151680, hidden_size=64, intermediate_size=128,
    num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
    head_dim=16), device="cpu", dtype=torch.bfloat16, seed=2)
clip = init_clip_params_random(ClipTextConfig(
    vocab_size=49408, hidden_size=32, intermediate_size=64,
    num_hidden_layers=2, num_attention_heads=4, eos_token_id=49407),
    device="cpu", dtype=torch.float32, seed=3)
towers = Kandinsky5TextEmbedder(conf.model.text_embedder, qwen, clip)
g = torch.Generator().manual_seed(8)
inputs = (torch.randn(1, 2, 8, 8, cfg.visual_embed_dim, generator=g).bfloat16(),
          torch.randn(1, 16, cfg.in_text_dim, generator=g).bfloat16(),
          torch.randn(1, cfg.in_text_dim2, generator=g).bfloat16(),
          torch.tensor([500.0]), (torch.arange(16) < 10)[None])
out = load_round_trip(root, dit, vae, towers, conf, "cpu", inputs,
                      conf_path=conf_path)
print(json.dumps(out))
'''

DIT = dict(in_visual_dim=16, out_visual_dim=16, in_text_dim=64,
           in_text_dim2=32, time_dim=32, patch_size=[1, 2, 2],
           model_dim=128, ff_dim=256, num_text_blocks=1, num_visual_blocks=2,
           axes_dims=[16, 24, 24], visual_cond=True)


def test_released_layouts_load_with_the_three_packages_blocked(tmp_path):
    import yaml

    conf = {"model": {
        "checkpoint_path": "@dit@",
        "vae": {"checkpoint_path": "@vae@", "name": "hunyuan"},
        "text_embedder": {
            "qwen": {"checkpoint_path": "@qwen@", "emb_size": 64, "max_length": 16},
            "clip": {"checkpoint_path": "@clip@", "emb_size": 32, "max_length": 20}},
        "dit_params": DIT,
        "attention": {"type": "flash", "causal": False, "local": False,
                      "glob": False, "window": 3},
        "num_steps": 2, "guidance_weight": 3.0},
        "metrics": {"scale_factor": [1.0, 2.0, 2.0], "resolution": 512}}
    conf_path = str(tmp_path / "tiny.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    root = tmp_path / "released"
    root.mkdir()
    res = subprocess.run([sys.executable, "-c", CHILD, str(root), conf_path],
                         cwd=REPO, capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-4000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["faults"] == []
    assert out["absent"] == ["transformers", "tokenizers", "safetensors"]
    assert "not a valid safetensors file" in out["control"]
    assert out["qwen_ids"] > 10 and out["written_gb"] > 0
    names = sorted(os.listdir(root / "text_encoder"))
    assert "model.safetensors.index.json" in names and "tokenizer.json" in names


def test_port_sources_import_none_of_the_three_packages():
    """No module of the port, not chip_smoke.py and not the test helpers it
    imports (``_torch_released``, ``_torch_windows``) import
    ``transformers``, ``tokenizers`` or ``safetensors``; the helpers import
    no JAX either (the port and the smoke are held to that in
    ``test_torch_nabla.py``)."""
    import re

    three = re.compile(r"^\s*(import|from)\s+(transformers|tokenizers|safetensors)"
                       r"(\.|\s|$)", re.M)
    jax = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|kandinsky5_tpu)(\.|\s|$)",
                     re.M)
    helpers = [os.path.join(REPO, "tests", n)
               for n in ("_torch_released.py", "_torch_windows.py")]
    files = [os.path.join(REPO, "chip_smoke.py")] + helpers
    for root, _, names in os.walk(os.path.join(REPO, "kandinsky5_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    bad = []
    for path in files:
        with open(path) as f:
            text = f.read()
        found = list(three.finditer(text))
        if path in helpers:
            found += list(jax.finditer(text))
        bad += [f"{os.path.relpath(path, REPO)}: {m.group(0).strip()}"
                for m in found]
    assert not bad, bad
