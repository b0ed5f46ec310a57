"""Kandinsky5T2VPipeline — text-to-video on one GPU, in PyTorch.

Counterpart of ``kandinsky5_tpu/pipeline.py``: conditioning from an
injected text embedder -> Euler flow-matching denoise of the DiT
(``sampling.py``) -> VAE decode -> uint8 frames -> mp4 / PNG.
The attention implementation is ``DenoiseSpec.attn_impl``, not sniffed
from the backend: "auto" (K1 for self-attention, dense for the short text
cross-attention; the JAX package's default off its accelerator),
"flash_int8" (K5, the JAX package's single-chip default) or
"flash_int8_pipe" (K7). ``int8_linear=True`` quantizes the visual blocks'
projections to W8A8 (``quantize_dit_params``), as the JAX package's
``KANDINSKY5_TPU_INT8_LINEAR`` does. A config with ``attention.type:
nabla`` (the 10 s configs) runs the visual self-attention through NABLA
and K6 whatever the impl; its text blocks then follow the impl.
``decode_mode`` picks the VAE decode: None is the JAX package's
single-device default, "stream"; "tiled" is the reference's overlap-tiled
decode (its parity gate and bench protocol). ``int8_conv=True`` runs the
decoder's convs that the TPU kernel admits W8A8, as the JAX package's
``KANDINSKY5_TPU_INT8_CONV`` does. ``tp`` (a
:class:`~kandinsky5_tpu_torch.parallel.TensorParallel`) makes this one rank
of a tensor-parallel pipeline (the JAX package's ``get_T2V_pipeline(tp=)``
mesh, tp axis only): the DiT is the rank's share (a full DiT is sharded
here), every rank runs the same Euler loop on rank 0's noise, and rank 0
alone decodes, tiled by default as the JAX package decodes on a mesh, and
writes; the other ranks return None. ``get_T2V_pipeline`` and the Qwen/CLIP
text towers wait for a later slice; the embedder passed in must offer
``encode(texts, type_of_content) -> TextEmbeddings`` (and
``expand_prompt`` when ``expand_prompts`` is set).
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Union

import numpy as np
import torch

from kandinsky5_tpu_torch.config import Config
from kandinsky5_tpu_torch.models.dit import quantize_dit_params
from kandinsky5_tpu_torch.models.vae import DECODE_MODES
from kandinsky5_tpu_torch.ops.attention import INT8_IMPLS
from kandinsky5_tpu_torch.sampling import DenoiseSpec, generate_latents

DEFAULT_NEGATIVE = (
    "Static, 2D cartoon, cartoon, 2d animation, paintings, images, worst "
    "quality, low quality, ugly, deformed, walking backwards"
)

RESOLUTIONS = {512: [(512, 512), (512, 768), (768, 512)]}

ATTN_IMPLS = ("auto", "flash", "dense", "flash_int8", "flash_int8_pipe")


class TextEmbeddings(NamedTuple):
    """What a text embedder hands the DiT: (B, L, in_text_dim) embeddings,
    (B, in_text_dim2) pooled embedding, (B, L) bool validity mask."""

    text_embeds: torch.Tensor
    pooled_embed: torch.Tensor
    mask: torch.Tensor


class Kandinsky5T2VPipeline:
    def __init__(self, dit, conf: Config, text_embedder=None, vae=None,
                 attn_impl: str = "auto", int8_linear: bool = False,
                 decode_mode: Optional[str] = None, int8_conv: bool = False,
                 tp=None):
        if tp is not None:
            if dit.tp is None:
                from kandinsky5_tpu_torch.parallel.sharding import shard_dit

                dit = shard_dit(dit, tp)
            elif dit.tp is not tp:
                raise ValueError("the DiT is sharded for another group")
            tp = dit.tp  # None for a group of one
        if tp is not None and (int8_linear or attn_impl in INT8_IMPLS):
            raise ValueError("int8-QK attention and W8A8 under tensor "
                             "parallelism are not ported yet (ROADMAP.md, "
                             "queue 1, item 7)")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if decode_mode not in (None,) + DECODE_MODES:
            raise ValueError(f"decode_mode must be None or one of "
                             f"{DECODE_MODES}, got {decode_mode!r}")
        self.dit = quantize_dit_params(dit) if int8_linear else dit
        self.int8_linear = int8_linear
        self.conf = conf
        self.text_embedder = text_embedder
        self.vae = vae.replace(int8_conv=True) if int8_conv and vae else vae
        self.tp = tp
        self.decode_mode = decode_mode or ("stream" if tp is None else "tiled")
        self.attn_impl = attn_impl
        self.resolution = conf.resolution
        if self.resolution not in RESOLUTIONS:
            raise ValueError("Resolution can be only 512")
        # per-request timings of the last call (seconds)
        self.timings: dict = {}

    @property
    def device(self) -> torch.device:
        return next(self.dit.parameters()).device

    def _spec(self, num_steps, guidance_weight, scheduler_scale) -> DenoiseSpec:
        att = self.conf.model.attention
        nabla = att.type == "nabla"
        if nabla and (att.q_rows != 1 or att.threshold_method != "sort"
                      or att.max_density is not None or att.shared_mask):
            raise ValueError(
                "the port runs NABLA in its faithful mode only (q_rows 1, "
                "threshold_method sort, no max_density, no shared_mask); "
                f"got {att}")
        # a 10 s CFG pair runs as two sequential forwards on one device, as
        # in the JAX package (half the activation memory)
        return DenoiseSpec(
            dit_params=self.conf.model.dit_params, num_steps=num_steps,
            guidance_weight=guidance_weight, scheduler_scale=scheduler_scale,
            scale_factor=tuple(self.conf.metrics.scale_factor),
            attn_impl=self.attn_impl, int8_linear=self.int8_linear,
            sequential_cfg=nabla,
            attention_type=att.type, nabla_P=att.P, nabla_wT=att.wT,
            nabla_wH=att.wH, nabla_wW=att.wW)

    def expand_prompt(self, prompt: str) -> str:
        return self.text_embedder.expand_prompt(prompt)

    def _encode(self, texts, type_of_content) -> dict:
        e = self.text_embedder.encode(texts, type_of_content)
        dev = self.device
        return {"text_embeds": e.text_embeds.to(dev),
                "pooled_embed": e.pooled_embed.to(dev),
                "mask": e.mask.to(dev).bool()}

    def __call__(
        self,
        text: Union[str, List[str]],
        time_length: int = 5,  # seconds; 0 => one image
        width: int = 768,
        height: int = 512,
        seed: Optional[int] = None,
        num_steps: Optional[int] = None,
        guidance_weight: Optional[float] = None,
        scheduler_scale: float = 10.0,
        negative_caption: str = DEFAULT_NEGATIVE,
        expand_prompts: bool = True,
        save_path: Optional[Union[str, List[str]]] = None,
        progress: bool = False,
        noise: Optional[torch.Tensor] = None,
    ) -> Optional[np.ndarray]:
        """Generate (B, T, H, W, 3) uint8 frames; T = 1 for an image, else
        time_length * 24 // 4 + 1. ``noise`` (B, T', H/8, W/8, 16) replaces
        the seeded noise. Under ``tp`` rank 0 returns the frames and the
        other ranks None."""
        num_steps = self.conf.model.num_steps if num_steps is None else num_steps
        guidance_weight = (self.conf.model.guidance_weight
                           if guidance_weight is None else guidance_weight)
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        if (height, width) not in RESOLUTIONS[self.resolution]:
            raise ValueError(
                f"Wrong height, width pair. Available (height, width) are: "
                f"{RESOLUTIONS[self.resolution]}")
        num_frames = 1 if time_length == 0 else time_length * 24 // 4 + 1
        type_of_content = "image" if time_length == 0 else "video"

        captions = [text] if isinstance(text, str) else list(text)
        if expand_prompts:
            captions = [self.expand_prompt(c) for c in captions]
        batch = len(captions)
        cond = self._encode(captions, type_of_content)
        uncond = self._encode([negative_caption] * batch, type_of_content)

        latent_shape = (batch, num_frames, height // 8, width // 8, 16)
        spec = self._spec(num_steps, guidance_weight, scheduler_scale)
        on_step: Optional[Callable[[int], None]] = None
        if progress:
            def on_step(i):
                print(f"denoise step {i + 1}/{num_steps}", flush=True)

        _sync(self.device)
        if self.tp is not None:
            self.tp.reset_stats()
        t0 = time.perf_counter()
        latents = generate_latents(self.dit, spec, latent_shape, cond, uncond,
                                   seed=seed, noise=noise, on_step=on_step)
        finite = bool(torch.isfinite(latents).all())
        t1 = time.perf_counter()
        self.timings = {"denoise_s": t1 - t0, "steps": num_steps,
                        "cfg": spec.use_cfg, "latents_finite": finite}
        if self.tp is not None:
            self.timings.update(all_reduce_s=self.tp.seconds,
                                all_reduce_calls=self.tp.calls,
                                all_reduce_bytes=self.tp.bytes)
            if self.tp.rank != 0:
                return None
        frames = self.decode_latents(latents)
        self.timings["decode_s"] = time.perf_counter() - t1
        if save_path is not None:
            self.timings["saved"] = self.save(frames, save_path, time_length)
        return frames

    @property
    def int8_conv(self) -> bool:
        """Whether the decodes run W8A8 convs: the VAE's own option, which
        ``int8_conv=True`` sets on the pipeline's copy."""
        return bool(self.vae is not None and self.vae.int8_conv)

    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor,
                       mode: Optional[str] = None) -> np.ndarray:
        """(B, T', H', W', 16) -> (B, T, H, W, 3) uint8, by the decode
        ``mode`` names, else the pipeline's ``decode_mode``."""
        z = latents / self.vae.scaling_factor
        video = self.vae.decode(z, mode=mode or self.decode_mode)
        video = video.float().clamp(-1.0, 1.0)
        video = ((video + 1.0) * 127.5).to(torch.uint8)
        return video.cpu().numpy()

    def save(self, frames: np.ndarray, save_path: Union[str, List[str]],
             time_length: int) -> List[str]:
        """Write each item: PNG for an image, mp4 (or .y4m) for a video.
        Returns the paths written."""
        from kandinsky5_tpu_torch.utils.io import write_image, write_video

        if isinstance(save_path, str):
            save_path = [save_path]
        written = []
        for path, video in zip(save_path, frames):
            if time_length == 0:
                written.append(write_image(path, video[0]))
            else:
                written.append(write_video(path, video, fps=24, crf=5))
        return written


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
