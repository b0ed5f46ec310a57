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
On a mesh the int8 options run as on one device: K5/K7 on the rank's
heads and query rows against the gathered keys, W8A8 with its row-parallel
products reduced in int32 (``models/dit.py``).
``decode_mode`` picks the VAE decode: None is the JAX package's
single-device default, "stream"; "tiled" is the reference's overlap-tiled
decode (its parity gate and bench protocol). ``int8_conv=True`` runs the
decoder's convs that the TPU kernel admits W8A8, as the JAX package's
``KANDINSKY5_TPU_INT8_CONV`` does. ``tp`` (the rank's place: a
:class:`~kandinsky5_tpu_torch.parallel.RankMesh`, or a bare
:class:`~kandinsky5_tpu_torch.parallel.TensorParallel` as a (1, 1, tp)
mesh) makes this one rank of a pipeline on a (dp, sp, tp) mesh (the JAX
package's ``Kandinsky5T2VPipeline(mesh=)``): the DiT is the rank's tp
share running its visual blocks on its 1/sp of the tokens (a full DiT is
sharded here), each DiT call's batch is split over dp
(the CFG pair and extra prompts; replicated where dp does not divide it),
every rank runs the same Euler loop on rank 0's noise and rank 0's seed,
and every rank decodes its share of the tiles (tiled by default, as the
JAX package decodes on a mesh, its VAE's tiles over every device of a host:
over several hosts the tiles split over the ranks of each host,
``RankMesh.local``); rank 0 blends them, returns the frames and writes, the
other ranks return None.

The text stage is the Qwen2.5-VL + CLIP embedder of ``text/embedder.py``
(prompt expansion, then the encode of the captions and of the negative
caption); any object with ``encode(texts, type_of_content) ->
TextEmbeddings`` (and ``expand_prompt`` when ``expand_prompts`` is set)
serves. ``offload=True`` keeps the towers (an ``nn.Module`` embedder), the
DiT and the VAE in host memory and moves each to ``device`` (the DiT's
device unless given) only for its stage (``utils/offload.py``).
``magcache=True`` runs the denoise on the configuration's MagCache schedule
(the ``*_sft`` and ``*_nocfg`` YAMLs carry its ratios), and
``checkpoint_path=`` on a call makes the denoise resumable
(``utils/resume.py``): chunks of 4 steps, the sampler's state saved after
each (on a mesh by rank 0 alone, with the whole MagCache residual), a
rerun resuming where a killed one stopped. :meth:`check_request` holds the
checks a request must pass; a call runs them before anything else, so that
on a mesh a bad request raises on every rank before any collective. A call
runs under ``torch.no_grad()`` whatever thread makes it (grad mode is per
thread).
``timings`` holds ``text_s`` (expansion and encode), ``denoise_s`` and
``decode_s`` of the last request, its ``seed`` (and ``start_step`` with a
``checkpoint_path``; on a mesh the tp group's all-reduce, the sp group's
gather and the dp group's gather seconds, calls and bytes, whether dp split
the batch
(``dp_split``) and the tiles this rank decoded (``decoded_tiles``)).
:func:`get_T2V_pipeline` builds the whole pipeline from reference-layout
checkpoints and a YAML (or the default configuration), as the JAX
package's does.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, Optional, Union

import numpy as np
import torch
from torch import nn

from kandinsky5_tpu_torch.config import Config, get_default_conf, load_config
from kandinsky5_tpu_torch.models.dit import quantize_dit_params
from kandinsky5_tpu_torch.models.vae import DECODE_MODES
from kandinsky5_tpu_torch.sampling import (
    DenoiseSpec,
    dp_splits,
    generate_latents,
)
from kandinsky5_tpu_torch.text.embedder import TextEmbeddings
from kandinsky5_tpu_torch.utils import default_device
from kandinsky5_tpu_torch.utils.offload import ParamStore, staged
from kandinsky5_tpu_torch.utils.resume import resumable_generate
from kandinsky5_tpu_torch.utils.trace import StageTimer

DEFAULT_NEGATIVE = (
    "Static, 2D cartoon, cartoon, 2d animation, paintings, images, worst "
    "quality, low quality, ugly, deformed, walking backwards"
)

RESOLUTIONS = {512: [(512, 512), (512, 768), (768, 512)]}

#: the timestep grid's default scheduler scale, the reference pipeline's
SCHEDULER_SCALE = 10.0

ATTN_IMPLS = ("auto", "flash", "dense", "flash_int8", "flash_int8_pipe")


def _multi(group):
    """``group`` where it spans more than one rank, else None (as a model
    holds its groups)."""
    return group if group is not None and group.size > 1 else None


class Kandinsky5T2VPipeline:
    def __init__(self, dit, conf: Config, text_embedder=None, vae=None,
                 attn_impl: str = "auto", int8_linear: bool = False,
                 decode_mode: Optional[str] = None, int8_conv: bool = False,
                 tp=None, offload: bool = False, magcache: bool = False,
                 device=None):
        if magcache and (conf.magcache is None
                         or not conf.magcache.mag_ratios):
            raise ValueError("magcache=True needs a configuration with "
                             "MagCache ratios (the *_sft and *_nocfg YAMLs)")
        mesh = None
        if tp is not None:
            from kandinsky5_tpu_torch.parallel.ranks import as_mesh

            mesh = as_mesh(tp)
            if dit.tp is None and dit.sp is None:
                from kandinsky5_tpu_torch.parallel.sharding import shard_dit

                dit = shard_dit(dit, mesh)
            elif (dit.tp is not _multi(mesh.tp)
                  or dit.sp is not _multi(mesh.sp)):
                raise ValueError("the DiT is sharded for another group")
            if mesh.size == 1:
                mesh = None
        if mesh is not None and vae is None:
            raise ValueError("on a mesh every rank decodes its share of the "
                             "tiles: give every rank the VAE")
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                             f"{attn_impl!r}")
        if decode_mode not in (None,) + DECODE_MODES:
            raise ValueError(f"decode_mode must be None or one of "
                             f"{DECODE_MODES}, got {decode_mode!r}")
        # a rank's share quantizes shard-aware (its row-parallel scales from
        # the max over the tp group): the slices of the whole model's W8A8
        self.dit = quantize_dit_params(dit) if int8_linear else dit
        self.int8_linear = int8_linear
        self.conf = conf
        self.text_embedder = text_embedder
        if vae is not None and (int8_conv or mesh is not None):
            # the tiles split over the ranks of this host, as the JAX
            # factory builds the VAE's mesh from jax.local_devices()
            vae = vae.replace(int8_conv=int8_conv or vae.int8_conv,
                              group=None if mesh is None else mesh.local)
        self.vae = vae
        self.mesh = mesh
        self.tp = dit.tp if dit is not None else None  # None for one rank
        self.sp = dit.sp if dit is not None else None
        self.dp = mesh.dp if mesh is not None and mesh.dp.size > 1 else None
        self.decode_mode = decode_mode or ("stream" if mesh is None
                                           else "tiled")
        self.attn_impl = attn_impl
        self.magcache = magcache
        self.resolution = conf.resolution
        if self.resolution not in RESOLUTIONS:
            raise ValueError("Resolution can be only 512")
        # per-request timings of the last call (seconds)
        self.timings: dict = {}
        self._device = (torch.device(device) if device is not None
                        else None if dit is None
                        else next(self.dit.parameters()).device)
        self._stores = {}
        if offload:
            if not isinstance(text_embedder, nn.Module):
                raise TypeError(
                    "offload stages the text embedder with .to(): it must "
                    "be an nn.Module (Kandinsky5TextEmbedder), got "
                    f"{type(text_embedder).__name__}")
            for stage, obj in (("text", text_embedder), ("dit", self.dit),
                               ("vae", self.vae and self.vae.params)):
                if obj is not None:
                    self._stores[stage] = ParamStore(obj, self._device)

    @property
    def device(self) -> torch.device:
        return self._device

    def _staged(self, stage: str):
        """The stage's weights on the card for the ``with`` block (offload);
        else nothing to do."""
        store = self._stores.get(stage)
        return staged(store) if store is not None else contextlib.nullcontext()

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
        # in the JAX package (half the activation memory); on two devices
        # or more it is one batched call, split over dp
        world = 1 if self.mesh is None else self.mesh.size
        return DenoiseSpec(
            dit_params=self.conf.model.dit_params, num_steps=num_steps,
            guidance_weight=guidance_weight, scheduler_scale=scheduler_scale,
            scale_factor=tuple(self.conf.metrics.scale_factor),
            attn_impl=self.attn_impl, int8_linear=self.int8_linear,
            sequential_cfg=nabla and world < 2,
            attention_type=att.type, nabla_P=att.P, nabla_wT=att.wT,
            nabla_wH=att.wH, nabla_wW=att.wW)

    def expand_prompt(self, prompt: str) -> str:
        return self.text_embedder.expand_prompt(prompt)

    def check_request(self, time_length: int = 5, width: int = 768,
                      height: int = 512, num_steps: Optional[int] = None,
                      noise=None, checkpoint_path: Optional[str] = None
                      ) -> None:
        """Raise ValueError for a request this pipeline does not take: a size
        outside ``RESOLUTIONS``, a negative length, fewer than one step, or
        both ``noise`` and ``checkpoint_path``. It touches no rank and no
        device."""
        if checkpoint_path is not None and noise is not None:
            raise ValueError("a resumable request draws its noise from its "
                             "seed: pass checkpoint_path or noise, not both")
        if (height, width) not in RESOLUTIONS[self.resolution]:
            raise ValueError(
                f"Wrong height, width pair. Available (height, width) are: "
                f"{RESOLUTIONS[self.resolution]}")
        if time_length < 0:
            raise ValueError(f"time_length must be 0 (an image) or more "
                             f"seconds, got {time_length}")
        if num_steps is not None and num_steps < 1:
            raise ValueError(f"num_steps must be at least 1, got {num_steps}")

    def agreed_seed(self, seed: Optional[int]) -> int:
        """The request's seed: ``seed``, or a fresh draw when None; on a mesh
        world rank 0's, broadcast to every rank (so that every rank seeds,
        and fingerprints a resumable state, with one seed)."""
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        if self.mesh is not None:
            world = self.mesh.world
            seed = int(world.broadcast(torch.tensor(
                [seed], dtype=torch.int64, device=world.wire)).item())
        return seed

    def _encode(self, texts, type_of_content) -> dict:
        e = self.text_embedder.encode(texts, type_of_content)
        dev = self.device
        return {"text_embeds": e.text_embeds.to(dev),
                "pooled_embed": e.pooled_embed.to(dev),
                "mask": e.mask.to(dev).bool()}

    @torch.no_grad()
    def __call__(
        self,
        text: Union[str, List[str]],
        time_length: int = 5,  # seconds; 0 => one image
        width: int = 768,
        height: int = 512,
        seed: Optional[int] = None,
        num_steps: Optional[int] = None,
        guidance_weight: Optional[float] = None,
        scheduler_scale: float = SCHEDULER_SCALE,
        negative_caption: str = DEFAULT_NEGATIVE,
        expand_prompts: bool = True,
        save_path: Optional[Union[str, List[str]]] = None,
        progress: bool = False,
        noise: Optional[torch.Tensor] = None,
        checkpoint_path: Optional[str] = None,
    ) -> Optional[np.ndarray]:
        """Generate (B, T, H, W, 3) uint8 frames; T = 1 for an image, else
        time_length * 24 // 4 + 1. ``noise`` (B, T', H/8, W/8, 16) replaces
        the seeded noise. ``checkpoint_path`` makes the denoise resumable
        from that state file (seeded noise only). On a mesh every rank makes
        the call; rank 0 returns the frames and the other ranks None."""
        self.check_request(time_length, width, height, num_steps, noise,
                           checkpoint_path)
        num_steps = self.conf.model.num_steps if num_steps is None else num_steps
        guidance_weight = (self.conf.model.guidance_weight
                           if guidance_weight is None else guidance_weight)
        seed = self.agreed_seed(seed)
        num_frames = 1 if time_length == 0 else time_length * 24 // 4 + 1
        type_of_content = "image" if time_length == 0 else "video"

        captions = [text] if isinstance(text, str) else list(text)
        timer = StageTimer(self.device)
        expansion = {"expand_s": 0.0, "expand_tokens": 0}
        with timer.stage("text_s"), self._staged("text"):
            if expand_prompts:
                expanded = []
                for c in captions:
                    expanded.append(self.expand_prompt(c))
                    last = getattr(self.text_embedder, "last_expansion", {})
                    expansion["expand_s"] += last.get("seconds", 0.0)
                    expansion["expand_tokens"] += last.get("new_tokens", 0)
                captions = expanded
            batch = len(captions)
            cond = self._encode(captions, type_of_content)
            uncond = self._encode([negative_caption] * batch, type_of_content)

        latent_shape = (batch, num_frames, height // 8, width // 8, 16)
        spec = self._spec(num_steps, guidance_weight, scheduler_scale)
        on_step: Optional[Callable[[int], None]] = None
        if progress:
            def on_step(i):
                print(f"denoise step {i + 1}/{num_steps}", flush=True)

        magcache = self.conf.magcache if self.magcache else None
        resume = {}
        with self._staged("dit"):
            for group in (self.tp, self.sp, self.dp):
                if group is not None:
                    group.reset_stats()
            with timer.stage("denoise_s"):
                if checkpoint_path is not None:
                    latents = resumable_generate(
                        self.dit, spec, latent_shape, cond, uncond, seed=seed,
                        checkpoint_path=checkpoint_path, magcache=magcache,
                        progress=progress, report=resume, mesh=self.mesh)
                else:
                    latents = generate_latents(
                        self.dit, spec, latent_shape, cond, uncond, seed=seed,
                        noise=noise, magcache=magcache, on_step=on_step,
                        dp=self.dp)
                finite = bool(torch.isfinite(latents).all())
        self.timings = {**timer.report(), **expansion, "seed": seed,
                        "steps": num_steps, "cfg": spec.use_cfg,
                        "magcache": magcache is not None,
                        "latents_finite": finite, **resume}
        if self.tp is not None:
            self.timings.update(all_reduce_s=self.tp.seconds,
                                all_reduce_calls=self.tp.calls,
                                all_reduce_bytes=self.tp.bytes)
        if self.sp is not None:
            self.timings.update(sp_gather_s=self.sp.seconds,
                                sp_gather_calls=self.sp.calls,
                                sp_gather_bytes=self.sp.bytes)
        if self.dp is not None:
            self.timings.update(gather_s=self.dp.seconds,
                                gather_calls=self.dp.calls,
                                gather_bytes=self.dp.bytes,
                                dp_split=dp_splits(spec, batch, self.dp))
        with timer.stage("decode_s"):
            frames = self.decode_latents(latents)
        self.timings["decode_s"] = timer.stages["decode_s"]
        if self.mesh is not None:
            self.timings["decoded_tiles"] = self.vae.decoded_tiles
            if self.mesh.rank != 0:
                return None
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
                       mode: Optional[str] = None) -> Optional[np.ndarray]:
        """(B, T', H', W', 16) -> (B, T, H, W, 3) uint8, by the decode
        ``mode`` names, else the pipeline's ``decode_mode``. On a mesh every
        rank calls it with the same latents and decodes its share; rank 0
        gets the frames, the others None."""
        with self._staged("vae"):
            z = latents / self.vae.scaling_factor
            video = self.vae.decode(z, mode=mode or self.decode_mode)
            if video is None:
                return None
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


def get_T2V_pipeline(
    device_map=None,
    resolution: int = 512,
    cache_dir: str = "./weights/",
    dit_path: Optional[str] = None,
    text_encoder_path: Optional[str] = None,
    text_encoder2_path: Optional[str] = None,
    vae_path: Optional[str] = None,
    conf_path: Optional[str] = None,
    offload: bool = False,
    magcache: bool = False,
    tp=None,
    dtype=torch.bfloat16,
    int8_linear: bool = False,
    int8_expand: bool = False,
    attn_impl: str = "auto",
    device=None,
) -> Kandinsky5T2VPipeline:
    """The whole pipeline from reference-layout checkpoints, as the JAX
    package's ``get_T2V_pipeline``: the YAML at ``conf_path``, else the
    default configuration over ``cache_dir``'s layout (or the paths given);
    the DiT safetensors, the diffusers VAE, the Qwen2.5-VL and CLIP
    directories (weights, ``config.json``, tokenizer). Built on ``device``,
    the CUDA card when None (with ``offload``, loaded into host memory and
    moved to ``device`` stage by stage); ``dtype`` for the DiT, the VAE and Qwen (CLIP
    stays fp32). ``device_map`` is accepted and ignored, as in the JAX
    package. ``magcache`` runs every request on the YAML's MagCache
    schedule. ``tp`` is this rank's place: a
    :class:`~kandinsky5_tpu_torch.parallel.RankMesh` or a bare
    :class:`~kandinsky5_tpu_torch.parallel.TensorParallel` (each rank calls
    this; the DiT is sharded over the tp group and runs its visual blocks
    over the sp group, every rank holds the VAE and decodes its share of
    the tiles). ``int8_linear`` quantizes the
    visual blocks' projections to W8A8, ``int8_expand`` runs prompt
    expansion on int8 decode weights (the whole tower on every rank of a
    mesh, as in the JAX pipeline), ``attn_impl`` is the DiT's attention
    (``ATTN_IMPLS``; "flash_int8" is K5): arguments, where the JAX package
    reads environment flags."""
    if tp is not None and not hasattr(tp, "rank"):
        raise TypeError("tp takes a rank's place, a RankMesh or a "
                        "TensorParallel group (one process per rank; "
                        "parallel.launch), not a width")
    if resolution not in RESOLUTIONS:
        raise ValueError("Resolution can be only 512")
    from kandinsky5_tpu_torch.checkpoint import (
        dit_from_state_dict,
        load_state_dict_file,
        load_vae_state_dict,
        vae_params_from_state_dict,
    )
    from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D
    from kandinsky5_tpu_torch.models.vae import HunyuanVideoVAE
    from kandinsky5_tpu_torch.text.embedder import Kandinsky5TextEmbedder

    device = default_device(device if tp is None else tp.device)
    # with offload every checkpoint loads into host memory, so the card never
    # holds all three; a rank's DiT share is cut on its own device
    host = torch.device("cpu") if offload else device
    if conf_path is not None:
        conf = load_config(conf_path)
    else:
        conf = get_default_conf(
            dit_path or f"{cache_dir}/model/kandinsky5lite_t2v_sft_5s.safetensors",
            vae_path or f"{cache_dir}/vae/",
            text_encoder_path or f"{cache_dir}/text_encoder/",
            text_encoder2_path or f"{cache_dir}/text_encoder2/")
    with torch.device("meta"):
        dit = DiffusionTransformer3D(conf.model.dit_params, dtype=dtype)
    dit = dit.to_empty(device=host if tp is None else device)
    dit = dit_from_state_dict(dit, load_state_dict_file(
        conf.model.checkpoint_path))
    vae = HunyuanVideoVAE(vae_params_from_state_dict(
        load_vae_state_dict(conf.model.vae.checkpoint_path),
        device=host, dtype=dtype), dtype=dtype)
    text_embedder = Kandinsky5TextEmbedder.from_pretrained(
        conf.model.text_embedder, dtype=dtype, device=host,
        int8_expand=int8_expand)
    return Kandinsky5T2VPipeline(dit, conf, text_embedder, vae,
                                 attn_impl=attn_impl,
                                 int8_linear=int8_linear, tp=tp,
                                 offload=offload, magcache=magcache,
                                 device=device)
