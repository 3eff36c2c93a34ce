"""Process groups and the device mesh: the port's parallelism layer.

Counterpart of ``fgdm_tpu/parallel/mesh.py``.  JAX drives every device from
one process and lets GSPMD place arrays on a ``Mesh``; torch runs one
process per device, each holding its own tensors, and the processes meet
in collectives.  So the JAX names map as follows:

* ``maybe_initialize_distributed`` -> ``torch.distributed`` with ``nccl``
  on CUDA (the rank's device set from ``LOCAL_RANK``) or ``gloo`` on the
  CPU (only when ``device_type="cpu"`` names it: with no device named a
  process without a card raises, as ``resolve_device`` does), when
  ``FGDM_DISTRIBUTED=1`` or torchrun's environment
  (``MASTER_ADDR``, ``WORLD_SIZE``, ``RANK``) declares a job; a no-op
  otherwise (``mesh.py:25-50``).
* ``create_mesh(n_data, n_model)`` -> an ``init_device_mesh`` with dims
  ``("data", "model")`` over the job's ranks (rank = data index * n_model +
  model index).  A process that never joined a job gets a one-rank group of
  its own on a free localhost port, so one device is a mesh of one.
* ``data_sharding``/``replicated`` -> the DTensor placements of a batch
  split over ``data`` / a replicated value on the 2-D mesh.
* ``shard_batch`` -> this rank's rows, on its device: in the port a rank's
  batch *is* its shard (the loader hands each process its contiguous rows,
  ``data/prefetch.py``), so nothing is assembled.
* ``local_batch_slice`` -> this rank's contiguous rows of a batch that is
  the same on every rank (a seed-deterministic validation batch).
* ``replicate`` -> a broadcast from the mesh's first rank, in place: JAX's
  "every process holds the same host values" contract, enforced.

The data-parallel steps (``train/*``) keep their tensors local and meet
once per step: ``average_gradients`` averages the trainable gradients over
the ``data`` dim in one bucketed ``all_reduce`` (a DDP wrapper would not
see the UNet calls made through ``LatentDiffusion``'s methods), and
``average_metrics`` the step's scalars.
"""

from __future__ import annotations

import os
import socket
from typing import Any, Dict, Iterable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from fgdm_tpu_torch import resolve_device

__all__ = ["maybe_initialize_distributed", "create_mesh", "data_sharding",
           "replicated", "shard_batch", "local_batch_slice", "replicate",
           "data_group", "data_rank", "data_size", "mesh_device",
           "average_gradients", "average_metrics", "all_gather_rows"]

_TORCHRUN_ENV = ("MASTER_ADDR", "WORLD_SIZE", "RANK")


def _backend(device_type: Optional[str]) -> str:
    """``nccl`` for CUDA (the default; raises without a card), ``gloo``
    for the CPU named."""
    return "nccl" if resolve_device(device_type).type == "cuda" else "gloo"


def maybe_initialize_distributed(device_type: Optional[str] = None) -> bool:
    """Join the job declared by the environment, before the first
    collective: ``FGDM_DISTRIBUTED=1`` forces it, torchrun's variables
    declare it.  NCCL on CUDA unless ``device_type="cpu"`` asks for gloo;
    a job with no card and no device named raises (``resolve_device``).
    Returns True when initialization ran (False when there is no job, or
    the process already joined one)."""
    want = (os.environ.get("FGDM_DISTRIBUTED", "0") == "1"
            or all(k in os.environ for k in _TORCHRUN_ENV))
    if not want or dist.is_initialized():
        return False
    backend = _backend(device_type)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(backend)
    return True


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def create_mesh(n_data: Optional[int] = None, n_model: int = 1,
                device_type: Optional[str] = None) -> DeviceMesh:
    """The ``("data", "model")`` mesh over every rank of the job, on CUDA
    unless ``device_type`` names another device (``resolve_device``: no
    card and no device named raises before any group is made)."""
    device_type = resolve_device(device_type).type
    if not dist.is_initialized():
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(
            _backend(device_type),
            init_method=f"tcp://127.0.0.1:{_free_port()}", rank=0,
            world_size=1)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"mesh {n_data}x{n_model} != {world} processes")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def data_sharding(mesh: DeviceMesh):
    """Placements of a batch split over ``data`` (dim 0)."""
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh):
    return (Replicate(), Replicate())


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_group(mesh: DeviceMesh):
    return mesh.get_group("data")


def data_rank(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank("data")


def data_size(mesh: DeviceMesh) -> int:
    return mesh["data"].size()


def shard_batch(mesh: DeviceMesh, batch: Dict[str, Any]) -> Dict[str, Any]:
    """This rank's batch (its rows of the global batch) on its device, the
    4-D images NCHW (``data/prefetch.to_device``)."""
    from fgdm_tpu_torch.data.prefetch import to_device

    return to_device(batch, mesh_device(mesh))


def local_batch_slice(batch: Dict[str, Any], mesh: DeviceMesh
                      ) -> Dict[str, Any]:
    """This rank's contiguous rows of a batch that every rank holds whole;
    the batch itself on a one-rank data dim."""
    n, i = data_size(mesh), data_rank(mesh)
    if n == 1:
        return batch

    def rows(x):
        if not hasattr(x, "shape") or len(x.shape) == 0:
            return x
        if x.shape[0] % n:
            raise ValueError(f"batch dim {x.shape[0]} must divide over "
                             f"{n} ranks")
        k = x.shape[0] // n
        return x[i * k:(i + 1) * k]

    return {key: rows(v) for key, v in batch.items()}


def _tensors(tree) -> Iterable[torch.Tensor]:
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@torch.no_grad()
def replicate(mesh: DeviceMesh, tree):
    """Broadcast every tensor of ``tree`` (a module, or a dict/list of
    tensors) from the mesh's first rank to the job, in place; returns
    ``tree``.  The mesh spans the job (``create_mesh``).  A DTensor is
    skipped: its shards were placed from values already equal."""
    if mesh.size() > 1:
        src = int(mesh.mesh.flatten()[0])
        for t in _tensors(tree):
            if not isinstance(t, DTensor):
                dist.broadcast(t, src=src)
    return tree


def _data_reduced(g: torch.Tensor) -> bool:
    """A DTensor gradient on a mesh with a ``data`` dim arrives averaged
    over it already (FSDP's reduce-scatter)."""
    return (isinstance(g, DTensor)
            and "data" in (g.device_mesh.mesh_dim_names or ()))


@torch.no_grad()
def average_gradients(params: Iterable[torch.Tensor], mesh: DeviceMesh
                      ) -> None:
    """Average the ``.grad`` of ``params`` over the ``data`` dim in one
    bucketed ``all_reduce`` per dtype (a TP-sharded gradient contributes its
    local shard; FSDP's arrive averaged and are skipped)."""
    n = data_size(mesh)
    if n == 1:
        return
    grads = [p.grad for p in params
             if p.grad is not None and not _data_reduced(p.grad)]
    local = [g.to_local() if isinstance(g, DTensor) else g for g in grads]
    by_dtype: Dict[torch.dtype, list] = {}
    for g in local:
        by_dtype.setdefault(g.dtype, []).append(g)
    for gs in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in gs])
        dist.all_reduce(flat, group=data_group(mesh))
        flat /= n
        off = 0
        for g in gs:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()


@torch.no_grad()
def average_metrics(metrics: Dict[str, torch.Tensor], mesh: DeviceMesh
                    ) -> Dict[str, torch.Tensor]:
    """The step's scalar metrics averaged over the ``data`` dim (one
    ``all_reduce``)."""
    n = data_size(mesh)
    if n == 1 or not metrics:
        return metrics
    flat = torch.stack([v.float().reshape(()) for v in metrics.values()])
    dist.all_reduce(flat, group=data_group(mesh))
    return dict(zip(metrics, (flat / n).unbind()))


def all_gather_rows(x: torch.Tensor, group=None, dim: int = 0
                    ) -> torch.Tensor:
    """The ranks' equal shards of ``x`` along ``dim``, concatenated in rank
    order, on every rank."""
    p = dist.get_world_size(group) if dist.is_initialized() else 1
    if p == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(p)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=dim)
