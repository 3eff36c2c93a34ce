"""Train state: the trainable partition, the optimizer, the EMA shadow.

Counterpart of ``fgdm_tpu/train/state.py``:

* ``adapter_filter`` (``:42-49``): adapter-only fine-tuning trains the
  parameters whose name mentions ``adapter`` (reference ``ddpm.py:1601-1618``).
  ``joint_image_adapter_filter`` (``:76-85``): joint two-factor training
  trains ``SeqTwoUNet``'s ``unet1.adapter.*`` and ``channel_mapper.*``.
  ``TrainState.create`` sets ``requires_grad_(False)`` on every other
  parameter, so autograd allocates no gradient for them, as ``jax.grad``
  differentiates only the trainable subtree.
* ``EmaState`` (``:87-111``): per-parameter shadow with the warmup decay
  ``min(decay, (1 + n) / (10 + n))`` (reference ``ldm/modules/ema.py``).
* ``make_adamw`` (``:202-226``): ``torch.optim.AdamW`` (eps 1e-8, weight
  decay 0.01: optax's ``adamw`` computes the same update) behind optax's
  ``clip_by_global_norm`` rule ``g / |g| * c`` when ``|g| >= c`` (not
  ``clip_grad_norm_``'s ``+ 1e-6``) and ``optax.MultiSteps``' accumulation,
  which averages k gradients and updates on the k-th.
* ``TrainState`` (``:114-166``): step count, optimizer, EMA and
  ``ema_full_params``.  The torch state updates the model's own parameters
  in place; the optimizer's ``step`` reads their ``.grad``.
* ``randomize_zero_heads`` (``:52-73``), seeded by crc32 of the name.

* ``state_to_pytree``/``state_from_pytree`` (``:169-199``): the whole
  state as a tree of tensors, and back in place, for
  ``checkpoint/state_io.py`` (JAX's orbax resume).

Sharded states (``parallel/fsdp.py``, ``parallel/tp.py``) hold DTensor
parameters, gradients, moments and EMA shadows: ``global_norm`` sums each
leaf's squares over its shards, the clip scales a DTensor gradient shard by
shard, and ``state_to_pytree`` gathers every DTensor into a whole tensor
(a collective: every rank calls it) while ``state_from_pytree`` hands each
rank its shard of a whole tensor.  So a checkpoint file is the same whether
the run was sharded or not, and resumes either way.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Callable, Dict, List, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

__all__ = ["adapter_filter", "joint_image_adapter_filter",
           "randomize_zero_heads", "global_norm",
           "EmaState", "AdamW", "Optimizer", "make_adamw", "TrainState",
           "state_to_pytree", "state_from_pytree"]

Params = Dict[str, torch.Tensor]


def adapter_filter(optim_key: str = "adapter") -> Callable[[str], bool]:
    """freeze_backbone rule: train parameters whose name mentions
    ``adapter`` or ``optim_key`` (``ddpm.py:1611-1616``)."""

    def f(name: str) -> bool:
        return "adapter" in name or optim_key in name

    return f


def joint_image_adapter_filter() -> Callable[[str], bool]:
    """AdaptDiffusion's freeze rule (``ddpm.py:1866-1870``): only the image
    UNet's adapter and the condition -> adapter channel mapper train; both
    UNet backbones stay frozen."""

    def f(name: str) -> bool:
        return (name.startswith("unet1.adapter.")
                or name.startswith("channel_mapper."))

    return f


@torch.no_grad()
def randomize_zero_heads(module: nn.Module, scale: float = 0.02) -> nn.Module:
    """Replace all-zero weights of two or more dims (zero convs, output
    heads) by ``scale`` * N(0, 1), so a frozen backbone passes gradients to
    the trainable branch in scratch-init runs.  Each draw is seeded by crc32
    of the parameter's name: reproducible across processes."""
    for name, p in module.named_parameters():
        if p.dim() >= 2 and not p.any():
            gen = torch.Generator().manual_seed(
                zlib.crc32(name.encode()) % 2 ** 31)
            p.copy_(torch.randn(p.shape, generator=gen) * scale)
    return module


def _sq(t: torch.Tensor) -> torch.Tensor:
    s = torch.sum(torch.square(t.float()))
    return s.full_tensor() if isinstance(s, DTensor) else s


def global_norm(tensors) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the f32 sum of squares (a DTensor's
    summed over its shards)."""
    return torch.sqrt(sum(_sq(t) for t in tensors))


def _full(t):
    """A DTensor gathered whole (every rank calls it); else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def _shard_like(live: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """``value`` (whole) as ``live``'s shard when ``live`` is a DTensor: the
    rank's part, cut locally; else ``value`` on ``live``'s device."""
    value = value.to(live.device)
    if isinstance(live, DTensor):
        return distribute_tensor(value, live.device_mesh, live.placements,
                                 src_data_rank=None)
    return value


def _clip(g: torch.Tensor, norm: torch.Tensor, c: float) -> torch.Tensor:
    """optax's ``where(norm < c, g, g / norm * c)``, on a DTensor's local
    shard."""
    if isinstance(g, DTensor):
        return DTensor.from_local(_clip(g.to_local(), norm, c),
                                  g.device_mesh, g.placements,
                                  shape=g.shape, stride=g.stride())
    return torch.where(norm < c, g, g / norm * c)


class EmaState:
    """Shadow copies of the trainable parameters."""

    def __init__(self, decay: float, shadow: Params):
        self.decay = decay
        self.num_updates = 0
        self.shadow = shadow

    @staticmethod
    def create(params: Params, decay: float = 0.9999) -> "EmaState":
        return EmaState(decay, {k: p.detach().clone()
                                for k, p in params.items()})

    @torch.no_grad()
    def update(self, params: Params) -> "EmaState":
        n = self.num_updates + 1
        one_minus = 1.0 - min(self.decay, (1.0 + n) / (10.0 + n))
        for k, s in self.shadow.items():
            s.lerp_(params[k].to(s.dtype), one_minus)
        self.num_updates = n
        return self


@dataclasses.dataclass(frozen=True)
class AdamW:
    """What ``make_adamw`` configures; ``init(params)`` binds it to the
    parameters, as ``optax`` transformations are initialised."""

    lr: float
    schedule_fn: Optional[Callable[[int], float]] = None
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.999
    grad_clip: Optional[float] = None
    accumulate_steps: int = 1

    def init(self, params: Params) -> "Optimizer":
        return Optimizer(self, params)


class Optimizer:
    """``torch.optim.AdamW`` behind optax's global-norm clip and
    ``MultiSteps`` accumulation.  ``step()`` consumes the parameters'
    ``.grad`` and sets them to None."""

    def __init__(self, tx: AdamW, params: Params):
        self.tx = tx
        self.params: List[torch.Tensor] = list(params.values())
        # the multi-tensor path groups tensors by device and dtype, and a
        # group may not mix DTensors with plain tensors (an FSDP state's
        # whole leaves beside its shards): per-tensor updates then
        sharded = any(isinstance(p, DTensor) for p in self.params)
        self.inner = torch.optim.AdamW(self.params, lr=tx.lr,
                                       betas=(tx.b1, tx.b2), eps=1e-8,
                                       weight_decay=tx.weight_decay,
                                       foreach=False if sharded else None)
        self.count = 0        # updates applied (optax's inner count)
        self.mini_step = 0    # gradients accumulated toward the next update
        self.acc = ([torch.zeros_like(p) for p in self.params]
                    if tx.accumulate_steps > 1 else None)

    @torch.no_grad()
    def step(self) -> None:
        """Take the gradients in ``.grad``; update the parameters (on every
        k-th call when accumulating k)."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p in self.params:
            p.grad = None
        if self.acc is not None:
            for a, g in zip(self.acc, grads):
                a.add_((g - a) / (self.mini_step + 1))
            self.mini_step += 1
            if self.mini_step < self.tx.accumulate_steps:
                return
            grads, self.mini_step = [a.clone() for a in self.acc], 0
            for a in self.acc:
                a.zero_()
        if self.tx.grad_clip:
            norm, c = global_norm(grads), self.tx.grad_clip
            grads = [_clip(g, norm, c) for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        lr = self.tx.lr
        if self.tx.schedule_fn is not None:
            lr = lr * self.tx.schedule_fn(self.count)
        for group in self.inner.param_groups:
            group["lr"] = lr
        self.inner.step()
        for p in self.params:
            p.grad = None
        self.count += 1

    def state_dict(self) -> Dict:
        """torch AdamW's state, the update count and the accumulation, each
        DTensor gathered whole."""
        inner = self.inner.state_dict()
        inner["state"] = {i: {k: _full(v) for k, v in st.items()}
                          for i, st in inner["state"].items()}
        return {"inner": inner, "count": self.count,
                "mini_step": self.mini_step,
                "acc": None if self.acc is None else [_full(a)
                                                      for a in self.acc]}

    @torch.no_grad()
    def load_state_dict(self, tree: Dict) -> None:
        """Restore ``state_dict()``; the accumulation buffers are copied
        into in place, AdamW's moments moved to the parameters' device (a
        DTensor parameter's moments cut to its shard)."""
        inner = dict(tree["inner"])
        inner["state"] = {
            i: {k: (_shard_like(self.params[int(i)], v)
                    if torch.is_tensor(v) and v.dim() else v)
                for k, v in st.items()}
            for i, st in inner["state"].items()}
        self.inner.load_state_dict(inner)
        self.count, self.mini_step = tree["count"], tree["mini_step"]
        if self.acc is not None:
            for a, v in zip(self.acc, tree["acc"]):
                a.copy_(_shard_like(a, v))


def make_adamw(lr: float, schedule_fn: Optional[Callable] = None,
               weight_decay: float = 0.01, b1: float = 0.9, b2: float = 0.999,
               grad_clip: Optional[float] = None,
               accumulate_steps: int = 1) -> AdamW:
    """AdamW with torch's default weight decay (the reference's optimizer,
    ``ddpm.py:1618``), an optional LambdaLR-style multiplier schedule,
    gradient clipping and gradient accumulation."""
    return AdamW(lr, schedule_fn, weight_decay, b1, b2, grad_clip,
                 accumulate_steps)


class TrainState:
    """The model under training, its trainable partition (``params``), the
    optimizer and the optional EMA."""

    def __init__(self, model: nn.Module, params: Params,
                 optimizer: Optimizer, ema: Optional[EmaState]):
        self.step = 0
        self.model = model
        self.params = params
        self.optimizer = optimizer
        self.ema = ema

    @property
    def frozen(self) -> Params:
        return {k: p for k, p in self.model.named_parameters()
                if k not in self.params}

    def apply_gradients(self) -> "TrainState":
        """One optimizer step on the gradients in ``.grad``, then EMA."""
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update(self.params)
        self.step += 1
        return self

    def ema_full_params(self) -> Params:
        """The model's parameters with the EMA shadow swapped in (LitEma
        ``copy_to``), as a state dict."""
        full = {k: p.detach() for k, p in self.model.named_parameters()}
        if self.ema is not None:
            full.update(self.ema.shadow)
        return full

    @staticmethod
    def create(model: nn.Module, tx: AdamW,
               trainable_filter: Optional[Callable[[str], bool]] = None,
               use_ema: bool = False,
               ema_decay: float = 0.9999) -> "TrainState":
        if trainable_filter is None:
            trainable_filter = lambda name: True  # noqa: E731
        params = {}
        for name, p in model.named_parameters():
            p.requires_grad_(trainable_filter(name))
            p.grad = None
            if p.requires_grad:
                params[name] = p
        return TrainState(model, params, tx.init(params),
                          EmaState.create(params, ema_decay) if use_ema
                          else None)


def state_to_pytree(state: TrainState, include_frozen: bool = True) -> Dict:
    """The whole train state, as JAX's ``state_to_pytree`` (``:169-185``):
    ``step``, the trainable ``params``, ``opt_state`` (the optimizer's
    ``state_dict``), with ``include_frozen`` the ``frozen`` parameters, and
    with EMA ``ema`` (``shadow`` and ``num_updates``).  Tensors are the live
    ones, detached: save it before the next step changes them.  DTensors
    are gathered whole: every rank of a sharded state calls it."""
    tree = {"step": state.step,
            "params": {k: _full(p.detach()) for k, p in state.params.items()},
            "opt_state": state.optimizer.state_dict()}
    if include_frozen:
        tree["frozen"] = {k: _full(p.detach())
                          for k, p in state.frozen.items()}
    if state.ema is not None:
        tree["ema"] = {"shadow": {k: _full(v)
                                  for k, v in state.ema.shadow.items()},
                       "num_updates": state.ema.num_updates}
    return tree


@torch.no_grad()
def state_from_pytree(state: TrainState, tree: Dict) -> TrainState:
    """Restore ``state_to_pytree``'s output into ``state``, in place: every
    saved tensor is copied into the live one (a host tree costs no second
    copy on the device); what was not saved (the frozen parameters without
    ``include_frozen``) keeps its value."""
    live = dict(state.model.named_parameters())
    for part in ("params", "frozen"):
        for k, v in tree.get(part, {}).items():
            live[k].copy_(_shard_like(live[k], v))
    state.optimizer.load_state_dict(tree["opt_state"])
    if state.ema is not None and "ema" in tree:
        for k, v in tree["ema"]["shadow"].items():
            s = state.ema.shadow[k]
            s.copy_(_shard_like(s, v))
        state.ema.num_updates = int(tree["ema"]["num_updates"])
    state.step = int(tree["step"])
    return state
