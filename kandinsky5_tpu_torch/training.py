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

The mesh: a step runs on any (dp, sp, tp) mesh, as the JAX ``train_step``
does under ``sharding_ctx``. The model is the rank's share
(``parallel/sharding.shard_dit``) and its forward runs the autograd-aware
collectives of ``parallel/ranks.py``, whose docstring states where each
gradient is replicated and where partial. Then, in one place
(:func:`reduce_gradients`), the visual blocks' gradients, partial over sp,
are summed over sp, and every gradient is averaged over dp. The clip takes
the global norm (:func:`global_norm`): the squares of the tp shares'
gradients summed over tp, a replicated gradient's counted once, which is
optax's ``clip_by_global_norm`` over JAX's whole tree. The loss is the
global mean: each sp and tp rank of a dp index computes it whole.

ZeRO-1 over dp (:func:`shard_train_state`, the JAX package's placement of
Adam's moments over the mesh's "dp" axis): each dp rank keeps the moments
of its slice of every rank-local parameter, along the first dim that tp
leaves whole and dp divides (a moment with no such dim stays whole on every
rank). A step then computes the loss on the rank's rows of the global
batch, puts the gradients together as above, clips, updates the rank's
slices and all-gathers the updated parameters. The JAX package lets GSPMD
place the same collectives; here they are explicit.

A state file (:func:`save_train_state`) holds one (dp, tp) index's
parameters and moments: the sp ranks of that index hold the same ones, so
sp rank 0 alone writes it and every rank of the index reads it.
"""

from __future__ import annotations

import os
import re
from typing import List, NamedTuple, Optional, Sequence

import torch

from kandinsky5_tpu_torch.config import DiTParams
from kandinsky5_tpu_torch.models.dit import (
    DiffusionTransformer3D,
    dit_apply,
    sp_rows,
)
from kandinsky5_tpu_torch.parallel.sharding import split_dim

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
    (optax's default mask). Every term is elementwise, so under ZeRO-1 a
    rank updates its slices of p, mu and nu alone and the slices gather to
    what the whole update gives."""

    lr: float
    weight_decay: float = 0.01
    clip: float = 1.0

    def init(self, params: Sequence[torch.Tensor]) -> dict:
        """Zero moments like ``params`` and a step count of 0."""
        return {"mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params], "count": 0}

    @torch.no_grad()
    def update(self, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], state: dict,
               norm: torch.Tensor, dp=None) -> dict:
        """One step: the parameters and moments change in place; returns
        the state with its count advanced. A ZeRO-1 state (``state["dims"]``,
        :func:`shard_train_state`) updates this dp rank's slice of each
        sharded parameter and all-gathers it over ``dp``; ``grads`` are the
        whole (dp-averaged) gradients on every rank. ``norm`` is the clip's
        global norm (:func:`global_norm`)."""
        clipped = bool(norm >= self.clip)
        count = state["count"] + 1
        bc1 = 1.0 - B1 ** count
        bc2 = 1.0 - B2 ** count
        dims = state.get("dims") or [None] * len(params)
        for p, g, mu, nu, dim in zip(params, grads, state["mu"], state["nu"],
                                     dims):
            whole = p
            if dim is not None:
                n = p.shape[dim] // dp.size
                p = p.narrow(dim, dp.rank * n, n)
                g = g.narrow(dim, dp.rank * n, n)
            if clipped:
                g = g / norm.to(g.dtype) * self.clip
            mu.mul_(B1).add_((1.0 - B1) * g)
            nu.mul_(B2).add_((1.0 - B2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + EPS)
            u = u + self.weight_decay * p
            p.add_(-self.lr * u)
            if dim is not None:
                slices = dp.all_gather(p.movedim(dim, 0).contiguous())
                whole.copy_(slices.movedim(0, dim))
        return dict(state, count=count)


def make_optimizer(lr: float = 1e-5, weight_decay: float = 0.01,
                   clip: float = 1.0) -> AdamW:
    return AdamW(lr, weight_decay, clip)


class TrainState(NamedTuple):
    """The model (its parameters), the optimizer's moments and the step;
    ``dp`` the data-parallel group of a ZeRO-1 state
    (:func:`shard_train_state`), else None; ``tp`` and ``sp`` the model's
    tensor- and sequence-parallel groups (None for one rank)."""

    model: DiffusionTransformer3D
    opt_state: dict
    step: int
    dp: Optional[object] = None
    tp: Optional[object] = None
    sp: Optional[object] = None


def trained_params(model: torch.nn.Module) -> List[torch.Tensor]:
    """The parameters a step updates, in ``model.parameters()`` order."""
    return [p for p in model.parameters() if p.requires_grad]


def _trained_names(model: torch.nn.Module) -> List[str]:
    return [n for n, p in model.named_parameters() if p.requires_grad]


def init_train_state(model: DiffusionTransformer3D,
                     optimizer: AdamW) -> TrainState:
    """A fresh state of ``model``, a whole model or a rank's share on any
    mesh (its tp and sp groups are the model's)."""
    return TrainState(model, optimizer.init(trained_params(model)), 0,
                      tp=model.tp, sp=model.sp)


def global_norm(grads: Sequence[torch.Tensor],
                sharded: Optional[Sequence[bool]] = None,
                tp=None) -> torch.Tensor:
    """The L2 norm of the whole model's gradients, optax's
    ``global_norm`` over JAX's tree: with a tp group the squares of the
    gradients of the tp shares (``sharded``: ``parallel/sharding.
    split_dim`` not None) are summed over ``tp``, each replicated gradient
    counted once. The gradients are whole over sp and dp by then
    (:func:`reduce_gradients`)."""
    if tp is None:
        return torch.sqrt(sum(g.float().square().sum() for g in grads))
    own = [g.float().square().sum() for g, s in zip(grads, sharded) if s]
    rep = [g.float().square().sum() for g, s in zip(grads, sharded)
           if not s]
    shares = tp.all_reduce(torch.stack(own).sum().reshape(1))
    return torch.sqrt(torch.stack(rep).sum() + shares[0])


def reduce_gradients(state: TrainState, grads: Sequence[torch.Tensor],
                     stack_split: bool) -> None:
    """The rank's gradients made whole, in place: with ``stack_split``
    (the visual block stack ran on the rank's 1/sp of the tokens) the
    visual blocks' parameters' gradients, partial over sp, are summed over
    sp; then every gradient becomes its mean over dp. Every other gradient
    is whole already (``parallel/ranks.py``)."""
    if stack_split:
        for name, g in zip(_trained_names(state.model), grads):
            if name.startswith("visual_transformer_blocks."):
                state.sp.all_reduce(g)
    if state.dp is not None:
        mean_over_dp(state.dp, grads)


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


def mean_over_dp(dp, tensors: Sequence[torch.Tensor]) -> None:
    """Each tensor replaced in place by its mean over the dp group."""
    for x in tensors:
        dp.all_reduce(x).div_(dp.size)


def loss_and_gradients(state: TrainState, cfg: DiTParams, x0, text_embeds,
                       pooled_embed, text_mask, t, noise,
                       attn_impl: str = "auto"):
    """The loss and the gradients of the trained parameters at the given t
    and noise, made whole on the mesh (:func:`reduce_gradients`): (the loss
    as a detached fp32 scalar, the gradients in ``trained_params`` order).
    Under a ZeRO-1 state the batch, t and noise are this dp rank's rows of
    the global batch's (all ranks holding as many), the same on every sp
    and tp rank of its dp index, and the loss is the global mean."""
    params = trained_params(state.model)
    with torch.enable_grad():
        loss = flow_matching_loss(state.model, cfg, x0, text_embeds,
                                  pooled_embed, text_mask, t, noise,
                                  attn_impl=attn_impl)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(params, grads)]
    loss = loss.detach()
    grid = [n // p for n, p in zip(x0.shape[1:4], cfg.patch_size)]
    reduce_gradients(state, grads, sp_rows(
        state.sp, grid[0] * grid[1] * grid[2]) is not None)
    if state.dp is not None:
        loss = loss.clone()
        mean_over_dp(state.dp, [loss])
    return loss, grads


def train_step_on(state: TrainState, cfg: DiTParams, optimizer: AdamW, x0,
                  text_embeds, pooled_embed, text_mask, t, noise,
                  attn_impl: str = "auto"):
    """One optimization step at the given t and noise: the loss and its
    whole gradients (:func:`loss_and_gradients`), the global norm, then
    the optimizer's update in place. Returns (the state with its step
    advanced, the loss as a detached fp32 scalar, the global mean)."""
    loss, grads = loss_and_gradients(state, cfg, x0, text_embeds,
                                     pooled_embed, text_mask, t, noise,
                                     attn_impl)
    sharded = None
    if state.tp is not None:
        sharded = [split_dim(n) is not None
                   for n in _trained_names(state.model)]
    norm = global_norm(grads, sharded, state.tp)
    opt_state = optimizer.update(trained_params(state.model), grads,
                                 state.opt_state, norm, state.dp)
    return state._replace(opt_state=opt_state, step=state.step + 1), loss


def train_step(state: TrainState, cfg: DiTParams, optimizer: AdamW, x0,
               text_embeds, pooled_embed, text_mask,
               generator: torch.Generator, attn_impl: str = "auto"):
    """One step with t ~ U(1e-4, 1) per item and noise ~ N(0, 1) like x0,
    drawn from ``generator`` on its device (not the JAX package's PRNG
    stream); see :func:`train_step_on`. Under a ZeRO-1 state every rank
    draws the global batch's t and noise (x0 holds this rank's rows of it)
    and takes its rows, so the step is the unsharded one whatever the dp
    width."""
    dev = generator.device
    dp = state.dp
    n = x0.shape[0]
    total = n if dp is None else n * dp.size
    t = 1e-4 + (1.0 - 1e-4) * torch.rand(total, generator=generator,
                                         device=dev)
    noise = torch.randn((total,) + tuple(x0.shape[1:]), generator=generator,
                        device=dev)
    if dp is not None:
        rows = slice(dp.rank * n, (dp.rank + 1) * n)
        t, noise = t[rows], noise[rows]
    return train_step_on(state, cfg, optimizer, x0, text_embeds,
                         pooled_embed, text_mask, t, noise, attn_impl)


def moment_dim(shape: Sequence[int], tp_dim: Optional[int],
               dp: int) -> Optional[int]:
    """The dim along which ZeRO-1 splits a moment of ``shape`` over ``dp``
    ranks: the first that tp leaves whole (not ``tp_dim``) and that dp
    divides, as the JAX package's ``moment_spec``; None keeps it whole."""
    for ax, n in enumerate(shape):
        if ax != tp_dim and n % dp == 0 and n >= dp > 1:
            return ax
    return None


def shard_train_state(state: TrainState, mesh) -> TrainState:
    """ZeRO-1: the state with Adam's moments cut to this rank's slices over
    the dp group of ``mesh`` (a :class:`~kandinsky5_tpu_torch.parallel.
    RankMesh`), each along :func:`moment_dim` (the tp split of a sharded
    model's parameter excluded); the parameters stay whole on every dp rank,
    in their tp shares. A dp group of one rank leaves the state as it is."""
    from kandinsky5_tpu_torch.parallel.ranks import as_mesh

    mesh = as_mesh(mesh)
    dp = mesh.dp
    if dp.size == 1:
        return state
    if state.dp is not None:
        raise ValueError("the state is sharded already")
    model = state.model
    dims, mu, nu = [], [], []
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    for (name, p), m, v in zip(named, state.opt_state["mu"],
                               state.opt_state["nu"]):
        tp_dim = None if model.tp is None else split_dim(name)
        dim = moment_dim(p.shape, tp_dim, dp.size)
        if dim is not None:
            n = p.shape[dim] // dp.size
            m = m.narrow(dim, dp.rank * n, n).clone()
            v = v.narrow(dim, dp.rank * n, n).clone()
        dims.append(dim)
        mu.append(m)
        nu.append(v)
    return state._replace(opt_state=dict(state.opt_state, mu=mu, nu=nu,
                                         dims=dims), dp=dp)


def save_checkpoint(model: DiffusionTransformer3D, path: str) -> None:
    """Export the parameters as reference-named safetensors (the port's
    state dict is already in the reference's names and layouts)."""
    from kandinsky5_tpu_torch.utils.io import save_safetensors

    save_safetensors(model.state_dict(), path)


def _state_file(state: TrainState) -> str:
    """The state's file name: one per (dp, tp) index, the dp rank's under
    ZeRO-1 (each holds its moment slices) and the tp rank's under tp (each
    holds its shares)."""
    name = "train_state"
    for kind, group in (("dp", state.dp), ("tp", state.tp)):
        if group is not None:
            name += f".{kind}{group.rank}of{group.size}"
    return f"{name}.pt"


def save_train_state(state: TrainState, ckpt_dir: str, step: int) -> str:
    """The whole training state (parameters, moments, step) with
    ``torch.save`` under ``ckpt_dir/<step>/``, restartable mid-run. On a
    mesh each (dp, tp) index has a file of its own (its tp shares and
    ZeRO-1 moment slices), which its sp rank 0 alone writes: every sp rank
    of the index calls this, and returns once the file is written. The
    port's own format, not the JAX package's orbax checkpoint. Returns the
    file's path."""
    path = os.path.join(ckpt_dir, str(step), _state_file(state))
    if state.sp is None or state.sp.rank == 0:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save({"model": state.model.state_dict(),
                    "opt_state": state.opt_state, "step": state.step}, path)
    if state.sp is not None:
        path = state.sp.broadcast_object(path)
    return path


def load_train_state(ckpt_dir: str, state_like: TrainState,
                     step: Optional[int] = None) -> TrainState:
    """Restore a :func:`save_train_state` checkpoint into ``state_like``'s
    tensors (a state of the same architecture, on its devices and dtypes,
    on the same mesh), in place; ``step`` None takes the latest. Every rank
    reads the file of its (dp, tp) index."""
    if step is None:
        steps = [int(d) for d in os.listdir(ckpt_dir) if re.fullmatch(r"\d+", d)]
        if not steps:
            raise FileNotFoundError(f"no training state under {ckpt_dir}")
        step = max(steps)
    saved = torch.load(os.path.join(ckpt_dir, str(step),
                                    _state_file(state_like)),
                       map_location="cpu", weights_only=True, mmap=True)
    state_like.model.load_state_dict(saved["model"])
    opt = state_like.opt_state
    with torch.no_grad():
        for key in ("mu", "nu"):
            for dst, src in zip(opt[key], saved["opt_state"][key]):
                dst.copy_(src)
    return state_like._replace(
        opt_state=dict(opt, count=saved["opt_state"]["count"]),
        step=saved["step"])
