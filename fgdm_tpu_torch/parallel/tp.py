"""Tensor-parallel parameter sharding for the UNet/transformer stack.

Counterpart of ``fgdm_tpu/parallel/tp.py``: the rule table of ``:24-66``
in the port's own names and ``[out, in]``/OIHW layouts.  JAX's flax names
map as ``emb_proj`` -> ``emb_layers.1``, ``time_embed_0/2`` ->
``time_embed.0/2``, ``net_0`` -> ``ff.net.0.proj``, ``net_2`` ->
``ff.net.2`` (``checkpoint/convert.py`` maps the rest of the schema):

* column parallel (the output features split over ``model``): the
  attention ``to_q``/``to_k``/``to_v`` (and CLIP's ``q_proj``/``k_proj``/
  ``v_proj``, ``fc1``), the GEGLU input ``ff.net.0.proj``, the ResBlock
  time projection ``emb_layers.1`` and the time MLP ``time_embed.0/2``;
* row parallel (the input features split): ``to_out.0``, ``out_proj``,
  ``fc2`` and the feed-forward output ``ff.net.2``;
* every conv with at least ``min_shard_dim`` output channels: split over
  its output channels;
* everything else (norms, biases of the rule's own, embeddings) whole.

A dimension shards only if it divides by ``n_model`` and is at least
``min_shard_dim`` (256).  ``tp_spec`` gives the dimension of the port's
parameter that is split (or None): JAX's ``P(None, "model")`` on a
``[in, out]`` kernel is the port's dim 0 of ``[out, in]``.

Execution.  XLA propagates JAX's placements through the program; the port
places each rule's weight as a DTensor and keeps the activations between
layers whole (replicated on every rank of ``model``), so every layer that
is not sharded runs as before:

* a column-parallel ``Dense`` goes through DTensor's ``ColwiseParallel``
  with its output gathered (``output_layouts=Replicate()``), a row-parallel
  one through ``RowwiseParallel`` taking the whole input
  (``input_layouts=Replicate()``; it keeps its slice and all-reduces the
  partial sums);
* a sharded conv is the port's own: ``F.conv2d`` on the rank's output
  channels (DTensor's conv rule does not take an output-channel-split
  weight with its split bias), the result wrapped as ``Shard(1)`` and
  gathered over the channels; the input's gradient is all-reduced over
  ``model`` (each rank's channels contribute to it).

So the port gathers after every sharded layer, before any GroupNorm,
residual or attention sees the activations: exact, with more traffic than
XLA's layout propagation.  Parameters that no rule shards stay plain
tensors; their gradients are equal on every rank of ``model``.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple, Union

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard, \
    distribute_tensor
from torch.distributed.tensor.parallel import (ColwiseParallel,
                                               RowwiseParallel,
                                               parallelize_module)
from torch.distributed.tensor.parallel.style import distribute_module

__all__ = ["COL_PARALLEL", "ROW_PARALLEL", "COL_PARALLEL_GEGLU",
           "MIN_SHARD_DIM", "tp_spec", "shard_params_tp", "count_sharded",
           "conv2d_tp"]

COL_PARALLEL = ("to_q", "to_k", "to_v", "q_proj", "k_proj", "v_proj", "fc1",
                # the ResBlock time projection (its output pairs with the
                # channel-split conv activations) and the UNet time MLP
                "emb_layers.1", "time_embed.0", "time_embed.2")
ROW_PARALLEL = ("to_out.0", "out_proj", "fc2",
                "net.2")  # the feed-forward output (GEGLU pair of net.0)
COL_PARALLEL_GEGLU = ("net.0.proj",)
MIN_SHARD_DIM = 256  # don't shard tiny tensors


def _has(path: Tuple[str, ...], rule: str) -> bool:
    """Whether the dotted ``rule`` names consecutive parts of ``path``."""
    parts = tuple(rule.split("."))
    n = len(parts)
    return any(path[i:i + n] == parts for i in range(len(path) - n + 1))


def tp_spec(path: Union[str, Tuple[str, ...]], shape: Tuple[int, ...],
            n_model: int, min_shard_dim: int = MIN_SHARD_DIM
            ) -> Optional[int]:
    """The dimension of the parameter at ``path`` (its state-dict name)
    split over ``model``, or None."""
    if isinstance(path, str):
        path = tuple(path.split("."))
    if n_model <= 1 or not shape or path[-1] != "weight":
        return None
    if len(shape) == 2:
        out_dim, in_dim = shape
        if any(_has(path, r) for r in COL_PARALLEL + COL_PARALLEL_GEGLU):
            if out_dim % n_model == 0 and out_dim >= min_shard_dim:
                return 0
        if any(_has(path, r) for r in ROW_PARALLEL):
            if in_dim % n_model == 0 and in_dim >= min_shard_dim:
                return 1
        return None
    if len(shape) == 4:  # conv OIHW: shard output channels
        out_ch = shape[0]
        if out_ch % n_model == 0 and out_ch >= min_shard_dim:
            return 0
    return None


def _n_model(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh["model"].size()


class _DenseColwise(ColwiseParallel):
    """``ColwiseParallel`` for the port's ``Dense`` (an ``nn.Linear`` in
    all but class), its output gathered whole."""

    def __init__(self):
        super().__init__(output_layouts=Replicate())

    def _apply(self, module, device_mesh):
        return distribute_module(
            module, device_mesh, self._partition_linear_fn,
            lambda mod, inputs, mesh: self._prepare_input_fn(
                self.input_layouts, self.desired_input_layouts, mod,
                inputs, mesh),
            lambda mod, outputs, mesh: self._prepare_output_fn(
                self.output_layouts, self.use_local_output, mod, outputs,
                mesh))


class _DenseRowwise(RowwiseParallel):
    """``RowwiseParallel`` for ``Dense``, taking the whole input."""

    def __init__(self):
        super().__init__(input_layouts=Replicate())

    def _apply(self, module, device_mesh):
        self.desired_input_layouts = (Shard(-1),)
        return distribute_module(
            module, device_mesh, self._partition_linear_fn,
            lambda mod, inputs, mesh: self._prepare_input_fn(
                self.input_layouts, self.desired_input_layouts, mod,
                inputs, mesh),
            lambda mod, outputs, mesh: self._prepare_output_fn(
                self.output_layouts, self.use_local_output, mod, outputs,
                mesh))


class _AllReduceGrad(torch.autograd.Function):
    """Identity forward; the backward sums the gradient over ``group``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def conv2d_tp(x: torch.Tensor, weight: DTensor, bias, stride, padding,
              dtype) -> torch.Tensor:
    """``Conv2d`` with an output-channel-split weight: the rank's channels,
    then the whole output gathered."""
    mesh = weight.device_mesh
    x = _AllReduceGrad.apply(x, mesh.get_group())
    b = None
    if bias is not None:
        b = (bias.to_local() if isinstance(bias, DTensor) else bias)
        b = b.to(dtype)
    y = F.conv2d(x.to(dtype), weight.to_local().to(dtype), b, stride,
                 padding)
    return DTensor.from_local(y, mesh, [Shard(1)]).full_tensor()


def shard_params_tp(mesh, module: nn.Module,
                    min_shard_dim: int = MIN_SHARD_DIM) -> nn.Module:
    """Shard ``module``'s rule-matching weights over ``mesh["model"]`` in
    place (replicated over ``data``); returns it.  Its sharded parameters
    are new objects: build the optimizer afterwards."""
    from fgdm_tpu_torch.nn.layers import Conv2d, Dense

    n = _n_model(mesh)
    sub = mesh["model"]
    for name, m in module.named_modules():
        if not isinstance(m, (Dense, Conv2d)) or isinstance(
                m.weight, DTensor):
            continue
        path = tuple(name.split(".")) + ("weight",) if name else ("weight",)
        dim = tp_spec(path, tuple(m.weight.shape), n, min_shard_dim)
        if dim is None:
            continue
        if isinstance(m, Dense):
            parallelize_module(m, sub, _DenseColwise() if dim == 0
                               else _DenseRowwise())
            continue
        for pname in ("weight", "bias"):
            p = getattr(m, pname)
            if p is not None:
                setattr(m, pname, nn.Parameter(
                    distribute_tensor(p.detach(), sub, [Shard(0)]),
                    requires_grad=p.requires_grad))
    return module


def count_sharded(mesh: Union[Any, int], params,
                  min_shard_dim: int = MIN_SHARD_DIM) -> Tuple[int, int]:
    """(sharded parameters, total parameters) under the rule table, for a
    module or a ``{name: tensor}`` dict (meta tensors do)."""
    n = _n_model(mesh)
    items = (params.named_parameters() if isinstance(params, nn.Module)
             else params.items())
    total = sharded = 0
    for name, v in items:
        total += 1
        sharded += tp_spec(name, tuple(v.shape), n, min_shard_dim) is not None
    return sharded, total
