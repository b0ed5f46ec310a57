"""The port's pipeline (kandinsky5_tpu_torch/pipeline.py) end to end on the
CPU with a stub text embedder, a tiny DiT and the full-channel VAE decoder:
image and video shapes, uint8 frames, files written. And the package's
import contract: no jax, and CPU tensors never reach a kernel launch."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from kandinsky5_tpu_torch.config import (
    CONFIG_DIR,
    Config,
    DiTParams,
    MetricsConfig,
    ModelConfig,
    load_config,
)
from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
from kandinsky5_tpu_torch.ops import _kernels
from kandinsky5_tpu_torch.pipeline import (
    RESOLUTIONS,
    Kandinsky5T2VPipeline,
    TextEmbeddings,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class StubEmbedder:
    """Seeded random conditioning with a partly padded mask."""

    def __init__(self, text_dim, pooled_dim, length=8):
        self.text_dim, self.pooled_dim, self.length = text_dim, pooled_dim, length

    def encode(self, texts, type_of_content="video"):
        g = torch.Generator().manual_seed(len(texts[0]))
        mask = torch.arange(self.length)[None].repeat(len(texts), 1) < 5
        return TextEmbeddings(
            torch.randn(len(texts), self.length, self.text_dim, generator=g),
            torch.randn(len(texts), self.pooled_dim, generator=g), mask)

    def expand_prompt(self, prompt):
        return prompt + " (expanded)"


@pytest.fixture(scope="module")
def tiny_pipe():
    cfg = DiTParams(in_visual_dim=16, out_visual_dim=16, in_text_dim=32,
                    in_text_dim2=16, time_dim=32, model_dim=128, ff_dim=256,
                    num_text_blocks=1, num_visual_blocks=2,
                    axes_dims=(16, 24, 24), visual_cond=True)
    dit = fast_init_dit_params(cfg, device="cpu", dtype=torch.float32, seed=0,
                               scale=0.05)
    conf = Config(model=ModelConfig(dit_params=cfg, num_steps=2,
                                    guidance_weight=1.0),
                  metrics=MetricsConfig())
    vae = HunyuanVideoVAE(init_vae_params(device="cpu", dtype=torch.float32,
                                          seed=1),
                          dtype=torch.float32)
    return Kandinsky5T2VPipeline(dit, conf, StubEmbedder(32, 16), vae)


def test_pipeline_image(tiny_pipe, tmp_path, monkeypatch):
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    out = str(tmp_path / "image.png")
    frames = tiny_pipe("a test image", time_length=0, width=64, height=64,
                       seed=3, save_path=out)
    assert frames.shape == (1, 1, 64, 64, 3) and frames.dtype == np.uint8
    with open(out, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    np.testing.assert_array_equal(np.asarray(Image.open(out)), frames[0, 0])
    assert tiny_pipe.timings["latents_finite"]


def test_pipeline_video(tiny_pipe, tmp_path, monkeypatch):
    """1 s -> 7 latent frames -> 25 video frames; an mp4, or the raw .y4m
    where no encoder exists."""
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    out = str(tmp_path / "clip.mp4")
    frames = tiny_pipe("a test video", time_length=1, width=64, height=64,
                       seed=3, save_path=out, expand_prompts=False)
    assert frames.shape == (1, 25, 64, 64, 3) and frames.dtype == np.uint8
    written = tiny_pipe.timings["saved"][0]
    assert written in (out, str(tmp_path / "clip.y4m"))
    assert os.path.getsize(written) > 25 * 64 * 64


def test_pipeline_rejects_unknown_resolution(tiny_pipe):
    with pytest.raises(ValueError):
        tiny_pipe("x", time_length=0, width=100, height=100)


def test_distil_config_loads_by_path():
    conf = load_config(os.path.join(CONFIG_DIR, "config_5s_distil.yaml"))
    cfg = conf.model.dit_params
    assert (cfg.model_dim, cfg.ff_dim, cfg.num_heads, cfg.head_dim) == \
        (1792, 7168, 28, 64)
    assert conf.model.num_steps == 16 and conf.model.guidance_weight == 1.0
    assert tuple(conf.metrics.scale_factor) == (1.0, 2.0, 2.0)


def test_import_leaves_jax_out_and_cpu_never_launches():
    code = (
        "import sys, torch\n"
        "import kandinsky5_tpu_torch\n"
        "import kandinsky5_tpu_torch.pipeline, kandinsky5_tpu_torch.checkpoint\n"
        "import kandinsky5_tpu_torch.models.vae_stream\n"
        "import kandinsky5_tpu_torch.text, kandinsky5_tpu_torch.cli\n"
        "import kandinsky5_tpu_torch.utils.offload\n"
        "from kandinsky5_tpu_torch.text import clip, embedder, qwen\n"
        "assert 'transformers' not in sys.modules\n"
        "from kandinsky5_tpu_torch.ops import _kernels\n"
        "from kandinsky5_tpu_torch.ops.flash import flash_attention\n"
        "from kandinsky5_tpu_torch.ops.conv import causal_conv3d_fused\n"
        "from kandinsky5_tpu_torch.ops.ff import fused_ff_modulated\n"
        "q = torch.randn(1, 16, 2, 64)\n"
        "flash_attention(q, q, q)\n"
        "flash_attention(torch.randn(1, 8, 1, 512), torch.randn(1, 8, 1, 512),"
        " torch.randn(1, 8, 1, 512))\n"
        "causal_conv3d_fused(torch.randn(1, 2, 4, 4, 128),"
        " torch.randn(128, 128, 3, 3, 3), torch.zeros(128))\n"
        "v = torch.zeros(1, 128)\n"
        "fused_ff_modulated(torch.randn(1, 4, 128), v, v,"
        " torch.randn(256, 128), torch.randn(128, 256), v)\n"
        "qc = qwen.QwenTextConfig(vocab_size=32, hidden_size=64,"
        " intermediate_size=64, num_hidden_layers=1, num_attention_heads=4,"
        " num_key_value_heads=2, head_dim=16)\n"
        "qm = qwen.init_qwen_params_random(qc, device='cpu')\n"
        "qwen.qwen_generate(qm, [[1, 2, 3]], max_new_tokens=2)\n"
        "cc = clip.ClipTextConfig(vocab_size=32, hidden_size=32,"
        " intermediate_size=64, num_hidden_layers=1, num_attention_heads=2)\n"
        "clip.clip_pooled(clip.init_clip_params_random(cc, device='cpu'),"
        " [[1, 31]], [[1, 1]])\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in"
        " ('jax', 'jaxlib', 'kandinsky5_tpu', 'transformers', 'tokenizers',"
        " 'safetensors'))\n"
        "assert not bad, bad\n"
        "assert all(n == 0 for n in _kernels.LAUNCHES.values()), _kernels.LAUNCHES\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("name", ["config_10s_distil.yaml",
                                  "config_10s_nocfg.yaml",
                                  "config_10s_sft.yaml",
                                  "config_10s_pretrain.yaml"])
def test_10s_configs_build_a_nabla_spec(name):
    """Every 10 s config runs NABLA in its faithful mode, its CFG pair (if
    any) as two sequential forwards; no 10 s spec leaves the visual
    self-attention dense."""
    conf = load_config(os.path.join(CONFIG_DIR, name))
    att = conf.model.attention
    assert (att.type, att.q_rows, att.max_density, att.threshold_method) == \
        ("nabla", 1, None, "sort")
    pipe = Kandinsky5T2VPipeline(None, conf)
    spec = pipe._spec(conf.model.num_steps, conf.model.guidance_weight, 5.0)
    assert spec.attention_type == "nabla" and spec.sequential_cfg
    assert (spec.nabla_P, spec.nabla_wT, spec.nabla_wH, spec.nabla_wW) == \
        (att.P, att.wT, att.wH, att.wW) == (0.9, 11, 3, 3)
    assert spec.use_cfg == (name not in ("config_10s_distil.yaml",
                                         "config_10s_nocfg.yaml"))
    conf5 = load_config(os.path.join(CONFIG_DIR, "config_5s_distil.yaml"))
    spec5 = Kandinsky5T2VPipeline(None, conf5)._spec(16, 1.0, 5.0)
    assert spec5.attention_type == "flash" and not spec5.sequential_cfg


def test_nabla_config_rejects_tpu_modes():
    import dataclasses

    conf = load_config(os.path.join(CONFIG_DIR, "config_10s_distil.yaml"))
    att = dataclasses.replace(conf.model.attention, q_rows=8,
                              threshold_method="bisect", max_density=0.75)
    conf = dataclasses.replace(
        conf, model=dataclasses.replace(conf.model, attention=att))
    with pytest.raises(ValueError, match="faithful"):
        Kandinsky5T2VPipeline(None, conf)._spec(16, 1.0, 5.0)


def test_constructors_default_to_the_card(monkeypatch):
    """The entry points build on the CUDA card unless told otherwise:
    without one, ``device=None`` raises and names ``device="cpu"`` (the
    DiT, the VAE, the text towers, the embedder and ``get_T2V_pipeline``)."""
    from kandinsky5_tpu_torch.checkpoint import (
        clip_from_state_dict,
        qwen_from_state_dict,
        vae_params_from_state_dict,
    )
    from kandinsky5_tpu_torch.config import TextEmbedderConfig
    from kandinsky5_tpu_torch.models.dit import init_dit_params
    from kandinsky5_tpu_torch.pipeline import get_T2V_pipeline
    from kandinsky5_tpu_torch.text.clip import (
        ClipTextConfig,
        init_clip_params_random,
    )
    from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder
    from kandinsky5_tpu_torch.text.qwen import (
        QwenTextConfig,
        init_qwen_params_random,
    )

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = DiTParams(in_visual_dim=4, out_visual_dim=4, in_text_dim=8,
                    in_text_dim2=8, time_dim=16, model_dim=64, ff_dim=64,
                    num_text_blocks=1, num_visual_blocks=1,
                    axes_dims=(16, 24, 24), visual_cond=False)
    for build in (lambda: fast_init_dit_params(cfg),
                  lambda: init_dit_params(cfg),
                  lambda: init_vae_params(),
                  lambda: vae_params_from_state_dict({}),
                  lambda: init_qwen_params_random(QwenTextConfig()),
                  lambda: init_clip_params_random(ClipTextConfig()),
                  lambda: qwen_from_state_dict({}),
                  lambda: clip_from_state_dict({}),
                  lambda: Kandinsky5TextEmbedder.from_pretrained(
                      TextEmbedderConfig()),
                  lambda: get_T2V_pipeline()):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    assert next(fast_init_dit_params(cfg, device="cpu").parameters()).is_cuda \
        is False


@pytest.mark.parametrize("name", sorted(os.listdir(CONFIG_DIR)))
def test_port_configs_equal_the_jax_package_files(name):
    """The port's copy of each released YAML holds what the JAX package's
    file holds (only the header comment names the port's loader) and
    parses to the same DiT and sampling settings as the JAX loader gives,
    so the two cannot drift apart."""
    import dataclasses

    import yaml

    from kandinsky5_tpu.config import load_config as jax_load_config

    jax_path = os.path.join(REPO, "kandinsky5_tpu", "configs", name)
    with open(jax_path) as a, open(os.path.join(CONFIG_DIR, name)) as b:
        assert yaml.safe_load(a) == yaml.safe_load(b)
    assert len(os.listdir(CONFIG_DIR)) == 8
    mine, theirs = load_config(os.path.join(CONFIG_DIR, name)), jax_load_config(jax_path)
    assert dataclasses.asdict(mine.model.dit_params) == \
        dataclasses.asdict(theirs.model.dit_params)
    for key in ("num_steps", "guidance_weight"):
        assert getattr(mine.model, key) == getattr(theirs.model, key)
    assert mine.model.attention.type == theirs.model.attention.type
    assert tuple(mine.metrics.scale_factor) == tuple(theirs.metrics.scale_factor)
