"""A tiny MagCache pipeline of the port on the CPU, shared by the resume,
serving and ComfyUI tests: a seeded fp32 DiT with visual conditioning, a
narrow VAE decoder, a stub text embedder and a 6-step CFG configuration
whose MagCache table skips steps 1, 2, 4 and 5 of a branch. The caller
admits 64 x 64 images (``RESOLUTIONS[512] = [(64, 64)]``)."""

import numpy as np
import torch

from kandinsky5_tpu_torch.config import (
    Config,
    DiTParams,
    MagCacheConfig,
    MetricsConfig,
    ModelConfig,
)
from kandinsky5_tpu_torch.models.dit import fast_init_dit_params
from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE, init_vae_params
from kandinsky5_tpu_torch.pipeline import Kandinsky5T2VPipeline

from .test_torch_pipeline import StubEmbedder

MAG = MagCacheConfig(mag_ratios=tuple(1.0 + 0.02 * np.sin(np.arange(12))),
                     threshold=0.05, K=2, retention_ratio=0.25)
PIPE_DIT = DiTParams(in_visual_dim=16, out_visual_dim=16, in_text_dim=32,
                     in_text_dim2=16, time_dim=32, model_dim=128, ff_dim=256,
                     num_text_blocks=1, num_visual_blocks=2,
                     axes_dims=(16, 24, 24), visual_cond=True)


def tiny_mag_pipeline(magcache: bool = True, tp=None
                      ) -> Kandinsky5T2VPipeline:
    """The pipeline; ``tp`` makes it one rank's of a mesh (a ``RankMesh``)."""
    dit = fast_init_dit_params(PIPE_DIT, device="cpu", dtype=torch.float32,
                               seed=0, scale=0.05)
    conf = Config(model=ModelConfig(dit_params=PIPE_DIT, num_steps=6,
                                    guidance_weight=5.0),
                  metrics=MetricsConfig(), magcache=MAG)
    vae = HunyuanVideoVAE(init_vae_params(device="cpu", dtype=torch.float32,
                                          seed=1,
                                          block_out_channels=(32, 32, 64, 64)),
                          dtype=torch.float32)
    return Kandinsky5T2VPipeline(dit, conf, StubEmbedder(32, 16), vae,
                                 magcache=magcache, tp=tp)
