"""Shared helpers for the PyTorch port's parity tests: seeded numpy inputs
handed to both the JAX package and the port, and the parameter converters
between them."""

import dataclasses

import numpy as np
import torch

import jax
import jax.numpy as jnp

from kandinsky5_tpu.config import DiTParams as JaxDiTParams
from kandinsky5_tpu.models.dit import init_dit_params as jax_init_dit
from kandinsky5_tpu_torch.checkpoint import (
    dit_from_state_dict,
    dit_state_dict_from_jax,
)
from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def both_cfgs(**kw):
    """The same DiT architecture as a JAX and a port config."""
    return JaxDiTParams(**kw), DiTParams(**kw)


def random_dit_pair(jcfg, pcfg, seed=0, dtype=torch.float32):
    """JAX DiT params with every leaf drawn from a seeded numpy generator
    (modulation not zero, so every block does work) and the port's DiT
    holding the same values through ``dit_state_dict_from_jax``."""
    params = jax_init_dit(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = np.shape(leaf)
        if "norm" in name and "weight" in name:
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.08 * rng.standard_normal(shape)).astype(np.float32)

    params_np = jax.tree_util.tree_map_with_path(draw, params)
    model = DiffusionTransformer3D(pcfg, device="cpu", dtype=dtype)
    dit_from_state_dict(model, dit_state_dict_from_jax(params_np))
    return jax.tree.map(jnp.asarray, params_np), model


def dataclass_kw(cfg):
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
