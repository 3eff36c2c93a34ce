"""FSDP: parameters, gradients, optimizer state and EMA stored sharded over
the ``data`` dim, the compute data-parallel.

Counterpart of ``fgdm_tpu/parallel/fsdp.py``.  The storage rule is the
port's own copy of ``fsdp.py:40-67``: a leaf is split along its largest
dimension that divides by the data size (ties to the output features),
leaves under ``min_size`` elements (``FGDM_FSDP_MIN_SIZE``, default
``MIN_FSDP_SIZE``) and leaves with no divisible free dimension stay whole.
Where JAX's placement is a ``PartitionSpec`` that XLA's partitioner turns
into all-gathers and reduce-scatters, the port hands the same rule to
FSDP2's ``fully_shard`` (``shard_placement_fn`` returns ``Shard(dim)``;
the whole leaves are its ``ignored_params``).  FSDP2 all-gathers a
module's parameters before its forward and again for its backward, and
reduce-scatters (averages) their gradients over ``data``; the whole leaves'
gradients are averaged by the train step's ``average_gradients``, as every
gradient of a DP step is.

``fully_shard`` works on the modules that are *called*: a ``ModuleDict``
optimizer tree (``train/control.control_param_tree``) has each of its
entries sharded, since the step calls ``cldm.control``/``cldm.unet``, never
the dict.  ``shard_state_fsdp`` rebuilds the ``TrainState`` on the sharded
parameters and carries its values over (``state_to_pytree`` /
``state_from_pytree``, which gather and scatter DTensor leaves); the
optimizer's moments and the EMA shadow then live as DTensors of the same
placement.  ``count_fsdp`` and ``fsdp_spec`` take a mesh or its data size.

Composing with ``parallel.tp`` (a leaf already split over ``model``) keeps
JAX's rule in ``fsdp_spec`` (``taken`` dims are skipped); the port's
training CLI shards over ``data`` alone, as JAX's does.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple, Union

import numpy as np
from torch import nn

__all__ = ["MIN_FSDP_SIZE", "fsdp_spec", "shard_tree_fsdp",
           "shard_state_fsdp", "count_fsdp"]

# Leaves smaller than this stay whole: sharding a 1-KiB bias saves nothing
# and costs a gather.
MIN_FSDP_SIZE = 2 ** 15


def _n_data(mesh) -> int:
    return mesh if isinstance(mesh, int) else mesh["data"].size()


def fsdp_spec(shape: Tuple[int, ...], n_data: int,
              taken: Sequence[int] = (),
              min_size: int = MIN_FSDP_SIZE) -> Optional[int]:
    """The dimension one leaf of ``shape`` is split along over ``data``, or
    None when it stays whole (``fsdp.py:40-67``): scalars, leaves under
    ``min_size``, and shapes with no free dimension (not in ``taken``) that
    divides by ``n_data``.  Of equal sizes the earlier dimension wins: in
    the port's ``[out, in]``/OIHW layouts that is the one JAX's
    ``[in, out]``/HWIO rule picks (its later one), the output features."""
    if n_data <= 1 or not shape or int(np.prod(shape)) < min_size:
        return None
    cands = [(shape[i], -i) for i in range(len(shape))
             if i not in taken and shape[i] % n_data == 0]
    return -max(cands)[1] if cands else None


def _dim(shape: Tuple[int, ...], n: int, min_size: int) -> Optional[int]:
    """``fsdp_spec``, except on one rank, where JAX's rule splits nothing:
    FSDP2 then still manages each leaf of ``min_size`` or more along its
    largest dimension (its collectives copy), so one device runs the same
    machinery as many."""
    if n > 1:
        return fsdp_spec(shape, n, min_size=min_size)
    if not shape or int(np.prod(shape)) < min_size:
        return None
    return -max((shape[i], -i) for i in range(len(shape)))[1]


def _shapes(tree) -> List[Tuple[int, ...]]:
    """The shapes of a module's parameters or of a ``{name: tensor}``
    dict's values."""
    leaves = tree.parameters() if isinstance(tree, nn.Module) \
        else tree.values()
    return [tuple(v.shape) for v in leaves]


def _called_modules(module: nn.Module):
    return (list(module.values()) if isinstance(module, nn.ModuleDict)
            else [module])


def shard_tree_fsdp(mesh, module: nn.Module,
                    min_size: int = MIN_FSDP_SIZE) -> nn.Module:
    """Shard ``module``'s parameters in place with FSDP2 under the rule
    above; returns it.  Its parameters are new (DTensor) objects after
    this: build the optimizer afterwards, or use ``shard_state_fsdp``."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = _n_data(mesh)
    for m in _called_modules(module):
        dims = {p: _dim(tuple(p.shape), n, min_size) for p in m.parameters()}
        fully_shard(m, mesh=mesh["data"],
                    shard_placement_fn=lambda p: Shard(dims[p]),
                    ignored_params={p for p, d in dims.items() if d is None})
    return module


def shard_state_fsdp(mesh, state, min_size: int = MIN_FSDP_SIZE):
    """``state`` (``train/state.TrainState``) rebuilt on FSDP-sharded
    parameters, its step, parameters, optimizer state and EMA carried
    over."""
    from fgdm_tpu_torch.train.state import (TrainState, state_from_pytree,
                                            state_to_pytree)

    tree = state_to_pytree(state, include_frozen=False)
    shard_tree_fsdp(mesh, state.model, min_size)
    trainable = set(state.params)
    new = TrainState.create(
        state.model, state.optimizer.tx,
        trainable_filter=lambda name: name in trainable,
        use_ema=state.ema is not None,
        ema_decay=state.ema.decay if state.ema is not None else 0.9999)
    return state_from_pytree(new, tree)


def count_fsdp(mesh: Union[Any, int], tree,
               min_size: int = MIN_FSDP_SIZE) -> Tuple[int, int, float]:
    """(sharded leaves, total leaves, sharded fraction of the elements)
    under the rule, for a module's parameters or a ``{name: tensor}`` dict
    (meta tensors do)."""
    n = _n_data(mesh)
    shapes = _shapes(tree)
    tot_b = sh = sh_b = 0
    for s in shapes:
        b = int(np.prod(s, dtype=np.int64))
        tot_b += b
        if fsdp_spec(s, n, min_size=min_size) is not None:
            sh += 1
            sh_b += b
    return sh, len(shapes), (sh_b / tot_b if tot_b else 0.0)
