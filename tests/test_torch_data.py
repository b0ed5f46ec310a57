"""The port's latent shards and loader (``kandinsky5_tpu_torch/data.py``)
against the JAX package's ``data.py`` on the CPU: the shard format both
ways, the loader's batches and their order, ``host_shard``, the producer
thread, and ``precompute_shard`` on a tiny pipeline."""

import threading
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu import data as jd
from kandinsky5_tpu.models import vae as jax_vae
from kandinsky5_tpu_torch import data as td
from kandinsky5_tpu_torch.checkpoint import (
    vae_params_from_state_dict,
    vae_state_dict_from_jax,
)
from kandinsky5_tpu_torch.config import (
    Config,
    DiTParams,
    MetricsConfig,
    ModelConfig,
)
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline


def _arrays(rng, n):
    mask = rng.random((n, 16)) < 0.8
    return (rng.standard_normal((n, 2, 8, 8, 4)),
            rng.standard_normal((n, 16, 32)), rng.standard_normal((n, 8)),
            mask)


def _shards(tmp_path, writer, sizes=(10, 10, 10)):
    rng = np.random.default_rng(0)
    paths = []
    for i, n in enumerate(sizes):
        p = str(tmp_path / f"shard{i}.npz")
        writer(p, *_arrays(rng, n))
        paths.append(p)
    return paths


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_shards_load_across_packages(tmp_path, writer):
    """A shard written by either package holds the same arrays (fp16, the
    bool mask) and loads in the other's loader."""
    arrays = _arrays(np.random.default_rng(1), 6)
    for name, write in (("jax", jd.write_shard), ("port", td.write_shard)):
        write(str(tmp_path / f"{name}.npz"), *arrays)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    path = [str(tmp_path / f"{writer}.npz")]
    loader = (td.LatentShardLoader(path, 6, device="cpu", dtype=torch.float32)
              if writer == "jax" else
              jd.LatentShardLoader(path, 6, dtype=jnp.float32))
    batch = next(iter(loader))
    assert batch["text_mask"].dtype in (torch.bool, jnp.bool_)
    assert sorted(np.asarray(batch["latents"]).ravel().tolist()) == sorted(
        arrays[0].astype(np.float16).astype(np.float32).ravel().tolist())


@pytest.mark.parametrize("epoch,drop", [(0, True), (1, True), (2, False)])
def test_loader_batches_equal_jax(tmp_path, epoch, drop):
    """The same shards (ragged sizes, so batches straddle shards and a
    remainder is left), seed and epoch give the same batches in the same
    order, bit-equal after the bf16 cast; the remainder comes last only
    without ``drop_remainder``."""
    paths = _shards(tmp_path, td.write_shard, sizes=(7, 10, 6))
    mine = list(td.LatentShardLoader(paths, 4, seed=3, device="cpu",
                                     drop_remainder=drop).epoch(epoch))
    theirs = list(jd.LatentShardLoader(paths, 4, seed=3,
                                       drop_remainder=drop).epoch(epoch))
    assert len(mine) == len(theirs) == (5 if drop else 6)
    for a, b in zip(mine, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == (torch.bool if k == "text_mask"
                                  else torch.bfloat16)
            np.testing.assert_array_equal(a[k].float().numpy(),
                                          np.asarray(b[k], np.float32))


def test_epochs_differ_and_repeat(tmp_path):
    paths = _shards(tmp_path, td.write_shard)
    loader = td.LatentShardLoader(paths, 4, seed=7, device="cpu")

    def first(epoch):
        return next(iter(loader.epoch(epoch)))["latents"]

    assert torch.equal(first(0), first(0))
    assert not torch.equal(first(0), first(1))


def test_host_shard_partitions(tmp_path):
    """``host_shard=(i, n)`` takes every n-th shard from the i-th, as the
    JAX loader does: disjoint, covering, equal subsets."""
    paths = _shards(tmp_path, td.write_shard, sizes=(2, 2, 2, 2, 2))
    parts = [td.LatentShardLoader(paths, 2, host_shard=(i, 2),
                                  device="cpu").paths for i in range(2)]
    assert set(parts[0]).isdisjoint(parts[1])
    assert set(parts[0]) | set(parts[1]) == set(paths)
    for i in range(2):
        assert parts[i] == jd.LatentShardLoader(paths, 2,
                                                host_shard=(i, 2)).paths
    with pytest.raises(ValueError, match="no shards"):
        td.LatentShardLoader(paths[:1], 2, host_shard=(1, 2), device="cpu")


def test_producer_error_reraises_and_abandon_stops(tmp_path):
    """A corrupt shard's error surfaces in the consumer; a generator
    abandoned after one batch stops its producer thread."""
    paths = _shards(tmp_path, td.write_shard)
    bad = tmp_path / "broken.npz"
    bad.write_bytes(b"not a zip")
    with pytest.raises(Exception):
        for _ in td.LatentShardLoader([str(bad)], 2, device="cpu"):
            pass
    before = threading.active_count()
    it = td.LatentShardLoader(paths, 2, prefetch=1, device="cpu").epoch(0)
    next(it)
    it.close()
    assert threading.active_count() == before


class _Embedder:
    """Seeded conditioning, numpy arrays (either package reads them)."""

    def encode(self, texts, type_of_content="video"):
        rng = np.random.default_rng(len(texts[0]))
        length = 6 + len(texts[0]) % 5
        return types.SimpleNamespace(
            text_embeds=rng.standard_normal((1, length, 32)).astype(np.float32),
            pooled_embed=rng.standard_normal((1, 8)).astype(np.float32),
            mask=np.arange(length)[None] < length - 1)


def test_precompute_shard_matches_jax(tmp_path):
    """``precompute_shard`` on two 5 x 32 x 32 clips and captions with the
    same VAE weights (fp32) and conditioning: the JAX package's shard, the
    latents to an fp16 ulp, the text arrays exactly (padded to 8 and cut to
    8)."""
    jparams = jax_vae.init_vae_params(jax.random.PRNGKey(0), dtype=jnp.float32)
    params = vae_params_from_state_dict(
        vae_state_dict_from_jax(jax.tree.map(np.asarray, jparams)),
        device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(4)
    videos = rng.integers(0, 256, (2, 5, 32, 32, 3), dtype=np.uint8)
    captions = ["a cat", "a long caption of a dog"]
    jpipe = types.SimpleNamespace(
        vae=jax_vae.HunyuanVideoVAE(jparams, dtype=jnp.float32),
        text_embedder=_Embedder())
    jd.precompute_shard(str(tmp_path / "jax.npz"), jpipe, videos, captions,
                        text_len=8)
    conf = Config(model=ModelConfig(dit_params=DiTParams(), num_steps=1,
                                    guidance_weight=1.0),
                  metrics=MetricsConfig())
    pipe = Kandinsky5T2VPipeline(None, conf, _Embedder(),
                                 HunyuanVideoVAE(params, dtype=torch.float32),
                                 device="cpu")
    td.precompute_shard(str(tmp_path / "port.npz"), pipe, videos, captions,
                        text_len=8)
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert a["latents"].shape == b["latents"].shape == (2, 2, 4, 4, 16)
        np.testing.assert_allclose(b["latents"].astype(np.float32),
                                   a["latents"].astype(np.float32),
                                   rtol=2e-3, atol=2e-4)
        for k in ("text_embeds", "pooled_embed", "text_mask"):
            np.testing.assert_array_equal(a[k], b[k])
