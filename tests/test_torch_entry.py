"""The port's main-path entry points on the CPU: ``get_T2V_pipeline`` on tiny
reference-layout checkpoints written to disk (a DiT safetensors and a
diffusers VAE, both through the JAX carriers, Qwen2.5-VL in HF shards under ``model.safetensors.index.json`` and CLIP,
both with their tokenizers and ``config.json``, and a YAML) against the JAX
package's loaders and sampler on the same files; offload staging; the CLI
writing a file (also with ``--magcache``); MagCache through
``get_T2V_pipeline``; and the errors the entry points raise."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from kandinsky5_tpu.checkpoint import load_dit_checkpoint as jax_load_dit
from kandinsky5_tpu.config import load_config as jax_load_config
from kandinsky5_tpu.sampling import DenoiseSpec as JaxSpec
from kandinsky5_tpu.sampling import generate_latents as jax_generate
from kandinsky5_tpu.text.embedder import Kandinsky5TextEmbedder as JaxEmbedder
from kandinsky5_tpu_torch.checkpoint import vae_state_dict_from_jax
from kandinsky5_tpu_torch.models.vae import init_vae_params
from kandinsky5_tpu_torch.pipeline import (
    DEFAULT_NEGATIVE,
    RESOLUTIONS,
    Kandinsky5T2VPipeline,
    get_T2V_pipeline,
)

from ._torch_parity import both_cfgs, random_dit_pair, rand, to_np
from ._torch_text import write_text_checkpoints

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
DIT_KW = dict(in_visual_dim=16, out_visual_dim=16, in_text_dim=64,
              in_text_dim2=32, time_dim=32, patch_size=(1, 2, 2),
              model_dim=128, ff_dim=256, num_text_blocks=1,
              num_visual_blocks=2, axes_dims=(16, 24, 24), visual_cond=True)
# a VAE decoder of the checkpoint's structure at narrow widths, so that a
# 512 x 512 decode stays cheap on the CPU
VAE_CHANNELS = (32, 32, 64, 64)
PROMPT = "a man in a gray sweater sits at a wooden desk in an office"


def _jax_layout(params):
    """The port's VAE params as the JAX package lays them out (convs DHWIO,
    linears (in, out)), numpy, for ``vae_state_dict_from_jax``."""
    if isinstance(params, dict):
        return {k: _jax_layout(v) for k, v in params.items()}
    a = params.numpy()
    return a.transpose(2, 3, 4, 1, 0) if a.ndim == 5 else \
        a.T if a.ndim == 2 else a


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    from safetensors.torch import save_file

    root = tmp_path_factory.mktemp("k5")
    qdir, cdir = write_text_checkpoints(root)
    jcfg, pcfg = both_cfgs(**DIT_KW)
    _, model = random_dit_pair(jcfg, pcfg, seed=3)
    dit_path = str(root / "dit.safetensors")
    save_file({k: v.contiguous() for k, v in model.state_dict().items()},
              dit_path)
    os.makedirs(root / "vae")
    vp = init_vae_params(device="cpu", dtype=torch.float32, seed=1,
                         block_out_channels=VAE_CHANNELS)
    save_file({k: torch.from_numpy(v) for k, v in
               vae_state_dict_from_jax(_jax_layout(vp)).items()},
              str(root / "vae" / "diffusion_pytorch_model.safetensors"))
    conf = {
        "model": {
            "checkpoint_path": dit_path,
            "vae": {"checkpoint_path": str(root / "vae"), "name": "hunyuan"},
            "text_embedder": {
                "qwen": {"checkpoint_path": qdir, "emb_size": 64,
                         "max_length": 16},
                "clip": {"checkpoint_path": cdir, "emb_size": 32,
                         "max_length": 20}},
            "dit_params": {k: list(v) if isinstance(v, tuple) else v
                           for k, v in DIT_KW.items()},
            "attention": {"type": "flash", "causal": False, "local": False,
                          "glob": False, "window": 3},
            "num_steps": 2,
            "guidance_weight": 3.0,
        },
        "metrics": {"scale_factor": [1.0, 2.0, 2.0], "resolution": 512},
    }
    conf_path = str(root / "tiny.yaml")
    with open(conf_path, "w") as f:
        yaml.safe_dump(conf, f)
    return root, conf_path, jcfg


def _keep_latents(pipe):
    kept = []
    real = pipe.decode_latents

    def decode_latents(lat, mode=None):
        kept.append(lat)
        return real(lat, mode)

    pipe.decode_latents = decode_latents
    return kept


def test_get_T2V_pipeline_matches_jax(ckpt, monkeypatch):
    """On the same files: the embeddings equal JAX's
    ``Kandinsky5TextEmbedder.from_pretrained``, and a 2-step CFG image
    request's latents, from explicit noise, equal JAX's ``generate_latents``
    on JAX's embeddings and JAX's loaded DiT."""
    root, conf_path, jcfg = ckpt
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    pipe = get_T2V_pipeline(conf_path=conf_path, device="cpu",
                            dtype=torch.float32)
    jconf = jax_load_config(conf_path)
    jemb = JaxEmbedder.from_pretrained(jconf.model.text_embedder,
                                       dtype=jnp.float32)
    names = ("text_embeds", "pooled_embed", "mask")
    conds = []
    for text in (PROMPT, DEFAULT_NEGATIVE):
        want = jemb.encode([text], "image")
        got = pipe.text_embedder.encode([text], "image")
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        m = got.mask.numpy()
        assert m.any()
        np.testing.assert_allclose(got.text_embeds.numpy()[m],
                                   np.asarray(want.text_embeds)[m], **TOL)
        np.testing.assert_allclose(got.pooled_embed.numpy(),
                                   np.asarray(want.pooled_embed), **TOL)
        conds.append(dict(zip(names, (want.text_embeds, want.pooled_embed,
                                      want.mask))))
    noise = rand(np.random.default_rng(8), 1, 1, 8, 8, 16)
    kept = _keep_latents(pipe)
    frames = pipe(PROMPT, time_length=0, width=64, height=64,
                  noise=torch.from_numpy(noise), expand_prompts=False)
    assert frames.shape == (1, 1, 64, 64, 3) and frames.dtype == np.uint8
    assert set(pipe.timings) >= {"text_s", "denoise_s", "decode_s"}
    spec = JaxSpec(dit_params=jcfg, attn_impl="auto", num_steps=2,
                   guidance_weight=3.0, scheduler_scale=10.0,
                   scale_factor=(1.0, 2.0, 2.0))
    want = jax_generate(jax_load_dit(jconf.model.checkpoint_path, jcfg,
                                     dtype=jnp.float32),
                        spec, noise.shape, conds[0], conds[1], seed=0,
                        noise=jnp.asarray(noise))
    np.testing.assert_allclose(to_np(kept[0]), to_np(want), **TOL)


def test_offload_gives_the_same_frames(ckpt, monkeypatch):
    """``offload=True`` stages the towers, the DiT and the VAE in turn and
    leaves each unstaged after the request; an expanded request gives the
    frames of the resident pipeline."""
    _, conf_path, _ = ckpt
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    noise = torch.from_numpy(rand(np.random.default_rng(9), 1, 1, 8, 8, 16))
    frames = []
    for offload in (False, True):
        pipe = get_T2V_pipeline(conf_path=conf_path, device="cpu",
                                dtype=torch.float32, offload=offload)
        frames.append(pipe(PROMPT, time_length=0, width=64, height=64,
                           noise=noise, expand_prompts=True))
        assert pipe.timings["expand_tokens"] > 0
        stores = pipe._stores
        assert sorted(stores) == ([] if not offload else ["dit", "text", "vae"])
        assert not any(s.staged for s in stores.values())
    np.testing.assert_array_equal(frames[0], frames[1])


def test_offload_builds_in_host_memory(ckpt):
    """With ``offload=True`` every checkpoint loads into host memory and
    only the stages move to the target device (here ``meta``: nothing may
    land there while building); an embedder that ``.to()`` cannot move is
    refused, not left on its device."""
    _, conf_path, _ = ckpt
    pipe = get_T2V_pipeline(conf_path=conf_path, device="meta",
                            dtype=torch.float32, offload=True)
    assert pipe.device == torch.device("meta")
    assert all(s.device == torch.device("meta") for s in pipe._stores.values())
    for module in (pipe.dit, pipe.text_embedder):
        assert {p.device.type for p in module.parameters()} == {"cpu"}
    leaves = [pipe.vae.params]
    while leaves:
        leaf = leaves.pop()
        if isinstance(leaf, dict):
            leaves += leaf.values()
        else:
            assert leaf.device.type == "cpu"
    with pytest.raises(TypeError, match="nn.Module"):
        Kandinsky5T2VPipeline(pipe.dit, pipe.conf, object(), pipe.vae,
                              offload=True, device="cpu")


@pytest.mark.parametrize("extra", [[], ["--tp", "2"]], ids=["one", "tp2"])
def test_cli_writes_a_file(ckpt, extra):
    """``python -m kandinsky5_tpu_torch.cli --device cpu`` with the reference
    flags: a 512 x 512 image written where asked; with ``--tp 2`` by rank 0
    of two gloo ranks."""
    root, conf_path, _ = ckpt
    out = str(root / f"cli{len(extra)}.png")
    res = subprocess.run(
        [sys.executable, "-m", "kandinsky5_tpu_torch.cli", "--device", "cpu",
         "--config", conf_path, "--prompt", PROMPT, "--video_duration", "0",
         "--width", "512", "--height", "512", "--seed", "1",
         "--expand_prompt", "0", "--output_filename", out] + extra,
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    assert out in res.stdout
    from PIL import Image

    assert Image.open(out).size == (512, 512)


def _magcache_yaml(conf_path, tmp_path):
    """The tiny YAML with a MagCache table (12 ratios: 6 steps)."""
    with open(conf_path) as f:
        conf = yaml.safe_load(f)
    conf["magcache"] = {"mag_ratios": [1.0 + 0.02 * float(np.sin(i))
                                       for i in range(12)],
                        "threshold": 0.05, "K": 2, "retention_ratio": 0.25}
    path = str(tmp_path / "magcache.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(conf, f)
    return path


def test_cli_magcache_writes_a_file(ckpt, tmp_path):
    """``--magcache`` on a YAML that carries MagCache ratios, 6 steps, with
    ``--trace_dir``: the request's profiler trace is written there."""
    root, conf_path, _ = ckpt
    out = str(tmp_path / "mag.png")
    trace_dir = str(tmp_path / "trace")
    res = subprocess.run(
        [sys.executable, "-m", "kandinsky5_tpu_torch.cli", "--device", "cpu",
         "--config", _magcache_yaml(conf_path, tmp_path), "--magcache",
         "--prompt", PROMPT, "--video_duration", "0", "--width", "512",
         "--height", "512", "--seed", "1", "--sample_steps", "6",
         "--expand_prompt", "0", "--output_filename", out,
         "--trace_dir", trace_dir],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    from PIL import Image

    assert Image.open(out).size == (512, 512)
    assert os.path.getsize(os.path.join(trace_dir, "trace.json")) > 0


def test_entry_points_raise_for_what_the_port_lacks(ckpt, monkeypatch,
                                                   tmp_path):
    """``magcache=True`` builds (on a YAML with MagCache ratios) and answers
    a tiny request on the schedule; a configuration without ratios, a tp
    width for a group and the (768, 768) size raise."""
    _, conf_path, _ = ckpt
    mag_path = _magcache_yaml(conf_path, tmp_path)
    monkeypatch.setitem(RESOLUTIONS, 512, [(64, 64)])
    pipe = get_T2V_pipeline(conf_path=mag_path, device="cpu",
                            dtype=torch.float32, magcache=True)
    frames = pipe(PROMPT, time_length=0, width=64, height=64, seed=2,
                  num_steps=6, expand_prompts=False)
    assert frames.shape == (1, 1, 64, 64, 3) and frames.dtype == np.uint8
    assert pipe.timings["magcache"] and pipe.timings["latents_finite"]
    with pytest.raises(ValueError, match="MagCache ratios"):
        get_T2V_pipeline(conf_path=conf_path, device="cpu", magcache=True)
    with pytest.raises(TypeError, match="TensorParallel"):
        get_T2V_pipeline(conf_path=conf_path, device="cpu", tp=2)
    with pytest.raises(ValueError, match="768, 768"):
        from kandinsky5_tpu_torch.cli import main

        main(["--width", "768", "--height", "768"])


def test_cli_tp8_launches_the_jax_plan(monkeypatch):
    """``--tp 8`` launches 8 ranks on the mesh JAX's ``get_T2V_pipeline(tp=8)``
    plans for the default configuration's 28 heads: (dp, sp, tp) = (1, 2,
    4). The launch is recorded, not run."""
    from kandinsky5_tpu_torch import cli, parallel

    calls = []

    def fake_launch(fn, world, backend, device, args=(), dp=1, sp=1, **kw):
        calls.append(dict(fn=fn, world=world, backend=backend,
                          device=device, dp=dp, sp=sp))
        return ["written.mp4"] + [None] * (world - 1)

    monkeypatch.setattr(parallel, "launch", fake_launch)
    assert cli.main(["--tp", "8", "--device", "cpu"]) == "written.mp4"
    assert calls == [dict(fn=cli.generate, world=8, backend="gloo",
                          device="cpu", dp=1, sp=2)]
    assert cli.mesh_plan(cli.parse_args(["--tp", "8"])) == (1, 2, 4)
