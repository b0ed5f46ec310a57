"""Flow-matching training of the DiT.

Counterpart of ``kandinsky5_tpu/training.py`` (the reference repository is
inference only; the JAX package adds this loop for fine-tuning and
distillation):

  * the rectified-flow objective: x_t = (1 - t) x0 + t eps, target velocity
    v* = eps - x0, loss = mean (DiT(x_t, 1000 t, cond) - v*)^2 in fp32 (the
    Euler sampler integrates exactly this field);
  * optax's ``chain(clip_by_global_norm(clip), adamw(lr, b1=0.9, b2=0.95,
    weight_decay))`` written out (:class:`AdamW`): the moments are this
    module's own tensors, not ``torch.optim.AdamW``'s, whose clip
    (``clip_grad_norm_`` adds 1e-6 to the norm) and update round
    differently;
  * the forward is ``models.dit.dit_apply`` with autograd on and each
    visual block checkpointed (the JAX package remats every scanned block),
    so the 32-deep backward holds one block's activations at a time.

No kernel has a backward, as no ``pallas_call`` of the JAX package has one:
a kernel reached under autograd raises (``ops/_kernels.refuse_grad``). So
training runs where the JAX package trains, on ``attn_impl="dense"`` with
fp32 parameters (whose FFs the K2 gate refuses); ``"auto"`` reaches K1 and
raises, on the CPU as on the card.

``shard_train_state`` (ZeRO-1 over dp) is not ported (ROADMAP.md, queue 1,
item 7).
"""

from __future__ import annotations

import os
import re
from typing import List, NamedTuple, Optional, Sequence

import torch

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import DiffusionTransformer3D, dit_apply

STATE_FILE = "train_state.pt"


# the JAX package's AdamW constants
B1, B2, EPS = 0.9, 0.95, 1e-8


class AdamW(NamedTuple):
    """Global-norm clipping then AdamW, as optax chains them. The update of
    a step, for gradients g of the parameters p:
      g <- g / ||g|| * clip where ||g|| >= clip (no epsilon);
      mu <- (1 - b1) g + b1 mu; nu <- (1 - b2) g^2 + b2 nu; t <- t + 1;
      u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) + wd p;
      p <- p + (-lr) u,
    with b1, b2, eps = B1, B2, EPS and weight decay on every parameter
    (optax's default mask)."""

    lr: float
    weight_decay: float = 0.01
    clip: float = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        """Zero moments like ``params`` and a step count of 0."""
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict) -> dict:
        """One step: the parameters and moments change in place; returns
        the state with its count advanced."""
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clipped = bool(norm >= self.clip)
        count = state["count"] + 1
        bc1 = 1.0 - B1 ** count
        bc2 = 1.0 - B2 ** count
        for p, g, mu, nu in zip(params, grads, state["mu"], state["nu"]):
            if clipped:
                g = g / norm.to(g.dtype) * self.clip
            mu.mul_(B1).add_((1.0 - B1) * g)
            nu.mul_(B2).add_((1.0 - B2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = u + self.weight_decay * p
            p.add_(-self.lr * u)
        return dict(state, count=count)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.01,
                   clip: float = 1.0) -> AdamW:
    return AdamW(lr, weight_decay, clip)


class TrainState(NamedTuple):
    """The model (its parameters), the optimizer's moments and the step."""

    model: DiffusionTransformer3D
    opt_state: dict
    step: int


def trained_params(model: torch.nn.Module) -> List[torch.Tensor]:
    """The parameters a step updates, in ``model.parameters()`` order."""
    return [p for p in model.parameters() if p.requires_grad]


def init_train_state(model: DiffusionTransformer3D,
                     optimizer: AdamW) -> TrainState:
    return TrainState(model, optimizer.init(trained_params(model)), 0)


def flow_matching_loss(model: DiffusionTransformer3D, cfg: DiTParams, x0,
                       text_embeds, pooled_embed, text_mask, t, noise,
                       scale_factor=(1.0, 2.0, 2.0),
                       attn_impl: str = "auto"):
    """x0 clean latents (B, T, H, W, C); t (B,) in (0, 1]; noise like x0.
    The fp32 MSE against the true velocity, differentiable in the model's
    parameters. A visual-cond model gets zero condition channels and a zero
    mask channel."""
    tb = t.float()[:, None, None, None, None]
    x0f, nf = x0.float(), noise.float()
    x_t = (1.0 - tb) * x0f + tb * nf
    target = nf - x0f
    if cfg.visual_cond:
        zmask = x_t.new_zeros((*x_t.shape[:-1], 1))
        x_t = torch.cat([x_t, torch.zeros_like(x_t), zmask], dim=-1)
    pred = dit_apply(model, x_t.to(model.dtype), text_embeds, pooled_embed,
                     t.float() * 1000.0, text_mask, scale_factor, attn_impl,
                     remat=True)
    return (pred.float() - target).square().mean()


def train_step_on(state: TrainState, cfg: DiTParams, optimizer: AdamW, x0,
                  text_embeds, pooled_embed, text_mask, t, noise,
                  attn_impl: str = "auto"):
    """One optimization step at the given t and noise: the loss, its
    gradients, then the optimizer's update in place. Returns (the state
    with its step advanced, the loss as a detached fp32 scalar)."""
    params = trained_params(state.model)
    with torch.enable_grad():
        loss = flow_matching_loss(state.model, cfg, x0, text_embeds,
                                  pooled_embed, text_mask, t, noise,
                                  attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    opt_state = optimizer.update(params, grads, state.opt_state)
    return TrainState(state.model, opt_state, state.step + 1), loss.detach()


def train_step(state: TrainState, cfg: DiTParams, optimizer: AdamW, x0,
               text_embeds, pooled_embed, text_mask,
               generator: torch.Generator, attn_impl: str = "auto"):
    """One step with t ~ U(1e-4, 1) per item and noise ~ N(0, 1) like x0,
    drawn from ``generator`` on its device (not the JAX package's PRNG
    stream); see :func:`train_step_on`."""
    dev = generator.device
    t = 1e-4 + (1.0 - 1e-4) * torch.rand(x0.shape[0], generator=generator,
                                         device=dev)
    noise = torch.randn(x0.shape, generator=generator, device=dev)
    return train_step_on(state, cfg, optimizer, x0, text_embeds,
                         pooled_embed, text_mask, t, noise, attn_impl)


def shard_train_state(state: TrainState, mesh) -> TrainState:
    raise NotImplementedError(
        "ZeRO-1 placement of the optimizer state over dp is not ported yet "
        "(ROADMAP.md, queue 1, item 7)")


def save_checkpoint(model: DiffusionTransformer3D, path: str) -> None:
    """Export the parameters as reference-named safetensors (the port's
    state dict is already in the reference's names and layouts)."""
    from safetensors.torch import save_file

    save_file({k: v.detach().contiguous().cpu()
               for k, v in model.state_dict().items()}, path)


def save_train_state(state: TrainState, ckpt_dir: str, step: int) -> str:
    """The whole training state (parameters, moments, step) with
    ``torch.save`` under ``ckpt_dir/<step>/``, restartable mid-run. The
    port's own format, not the JAX package's orbax checkpoint. Returns the
    file written."""
    path = os.path.join(ckpt_dir, str(step), STATE_FILE)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({"model": state.model.state_dict(),
                "opt_state": state.opt_state, "step": state.step}, path)
    return path


def load_train_state(ckpt_dir: str, state_like: TrainState,
                     step: Optional[int] = None) -> TrainState:
    """Restore a :func:`save_train_state` checkpoint into ``state_like``'s
    tensors (a state of the same architecture, on its devices and dtypes),
    in place; ``step`` None takes the latest."""
    if step is None:
        steps = [int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d)]
        if not steps:
            raise FileNotFoundError(f"no training state under {ckpt_dir}")
        step = max(steps)
    saved = torch.load(os.path.join(ckpt_dir, str(step), STATE_FILE),
                       map_location="cpu", weights_only=True, mmap=True)
    state_like.model.load_state_dict(saved["model"])
    opt = state_like.opt_state
    with torch.no_grad():
        for key in ("mu", "nu"):
            for dst, src in zip(opt[key], saved["opt_state"][key]):
                dst.copy_(src)
    return TrainState(state_like.model, dict(opt, count=saved["opt_state"][
        "count"]), saved["step"])
