"""Context parallelism: one sample's rows (the H axis of every map) sharded
over a process group.

Counterpart of ``fgdm_tpu/parallel/context.py``.  JAX shards H over a
``seq`` mesh axis and lets GSPMD partition the convs and norms, with
``ring_attention`` as a ``shard_map`` island for the self-attention.  There
is no GSPMD here, so the port runs the H-sharded forward by hand: rank r of
p holds rows ``[r h / p, (r + 1) h / p)`` of every NCHW map, and

* a conv (``nn/layers.Conv2d``) first takes the rows its taps read from the
  neighbouring ranks (``halo_rows``: ``padding`` rows above, ``k - stride
  - padding`` below, zeros at the image's edges), then runs with no H
  padding: one row each way for a 3x3 stride-1 conv, one above for the
  UNet's and the hint pyramid's stride-2 pad-1 convs, one below for the
  VAE's ``(0, 1, 0, 1)``-padded stride-2 conv;
* ``GroupNorm32`` all-reduces its per-group sums in float32 (the mean, then
  the centred squares: the same two passes as the plain norm, in another
  reduction order, so not bit for bit);
* nearest upsampling, 2x2 pooling and the 1x1 convs stay local;
* self-attention goes around the ring (``parallel/ring_attention.py``);
  cross-attention over the 77 text tokens stays local.

A module built with ``seq_axis`` (``UNetModel``, ``ControlNet``, the VAE's
``Encoder``/``Decoder`` and ``AutoencoderKL``, and the attention modules)
opens the sharded scope in its forward (``sharded``); the layers inside
read it.  Where a deep UNet level's rows do not divide over the group
(latent H divisible by p but not by p times the deepest downsampling),
JAX's GSPMD pads and stays exact; the port gathers the rows before the
downsampling into that level (``enter_down``), runs it and everything
below it whole on every rank, and cuts the rank's rows again after the
upsampling out of it (``leave_up``): also exact.

``context_parallel_pipeline`` makes the clone: the modules are copied with
their parameters shared (no weight is copied), ``seq_axis`` set, the fused
GroupNorm+SiLU off (K4 sees one rank's rows; its statistics need the
all-reduce) and the conv-kernel flags ``FGDM_PALLAS_CONV(_VAE)`` cleared
with JAX's message (``context.py:55-78``).  The samplers return the whole
image (or latent) on every rank, all-gathered over H: what JAX's global
array reads.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import itertools
import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from fgdm_tpu_torch.parallel.ring_attention import (get_context_group,
                                                    set_context_group)

__all__ = ["AXIS", "context_group", "context_parallel_pipeline",
           "sample_context_parallel", "decode_context_parallel", "sharded",
           "sharded_group", "enter_down", "leave_up", "halo_rows",
           "group_norm_sharded", "gather_rows", "local_rows",
           "shared_clone"]

AXIS = "seq"


@dataclasses.dataclass
class _Scope:
    """The sharded forward under way: the group, this rank's place in it,
    the first level that runs whole, and whether the maps are sharded."""

    group: object
    rank: int
    size: int
    full_from: int
    sharded: bool = True


# the sharded forward under way in this thread (or task), if any
_SCOPE: contextvars.ContextVar = contextvars.ContextVar("fgdm_cp_scope",
                                                       default=None)


@contextlib.contextmanager
def sharded(seq_axis: Optional[str], local_rows: Optional[int] = None,
            n_levels: int = 0):
    """The H-sharded scope of one ``seq_axis`` module's forward (nothing
    when ``seq_axis`` is None).  ``local_rows`` at level 0 and ``n_levels``
    decide the first level whose rows do not divide (a UNet's or
    ControlNet's); a scope opened inside another reuses it and restores its
    state after."""
    if seq_axis is None:
        yield None
        return
    st = _SCOPE.get()
    if st is not None:
        saved = st.sharded
        try:
            yield st
        finally:
            st.sharded = saved
        return
    group = get_context_group()
    full_from = n_levels
    if local_rows is not None:
        full_from = next((lv for lv in range(1, n_levels)
                          if local_rows % 2 ** lv), n_levels)
    token = _SCOPE.set(_Scope(group, dist.get_rank(group),
                              dist.get_world_size(group), full_from))
    try:
        yield _SCOPE.get()
    finally:
        _SCOPE.reset(token)


def sharded_group():
    """The group the current maps are H-sharded over, or None."""
    st = _SCOPE.get()
    return st.group if st is not None and st.sharded else None


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The whole map from every rank's rows."""
    from fgdm_tpu_torch.parallel.mesh import all_gather_rows

    return all_gather_rows(x, _SCOPE.get().group, dim=2)


def local_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole map."""
    st = _SCOPE.get()
    k = x.shape[2] // st.size
    return x[:, :, st.rank * k:(st.rank + 1) * k].contiguous()


def enter_down(x: torch.Tensor, level: int) -> torch.Tensor:
    """``x`` ready for the downsampling into ``level``: gathered whole when
    that level's rows do not divide over the group."""
    st = _SCOPE.get()
    if st is not None and st.sharded and level >= st.full_from:
        x = gather_rows(x)
        st.sharded = False
    return x


def leave_up(x: torch.Tensor, level: int) -> torch.Tensor:
    """``x`` after the upsampling into ``level``: this rank's rows again
    when the level is a sharded one."""
    st = _SCOPE.get()
    if st is not None and not st.sharded and level < st.full_from:
        x = local_rows(x)
        st.sharded = True
    return x


def halo_rows(x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
    """``x`` with ``top`` rows of the rank above and ``bottom`` rows of the
    rank below added (zeros at the image's top and bottom edges).  Every
    rank posts its sends and receives in one ``batch_isend_irecv``: each
    pair of neighbours exchanges one message each way."""
    st = _SCOPE.get()
    r, p = st.rank, st.size
    b, c, _, w = x.shape
    above = x.new_zeros((b, c, top, w)) if top else None
    below = x.new_zeros((b, c, bottom, w)) if bottom else None
    ops = []
    g = st.group
    if p > 1:
        if top and r > 0:
            ops.append(dist.P2POp(dist.irecv, above,
                                  dist.get_global_rank(g, r - 1), g))
        if top and r < p - 1:
            ops.append(dist.P2POp(dist.isend, x[:, :, -top:].contiguous(),
                                  dist.get_global_rank(g, r + 1), g))
        if bottom and r < p - 1:
            ops.append(dist.P2POp(dist.irecv, below,
                                  dist.get_global_rank(g, r + 1), g))
        if bottom and r > 0:
            ops.append(dist.P2POp(dist.isend, x[:, :, :bottom].contiguous(),
                                  dist.get_global_rank(g, r - 1), g))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([t for t in (above, x, below) if t is not None], dim=2)


def group_norm_sharded(x, weight, bias, num_groups: int, eps: float,
                       apply_silu: bool):
    """``kernels.groupnorm.group_norm_silu_ref`` on H-sharded rows: each
    group's sum, then its centred squares, all-reduced in float32."""
    st = _SCOPE.get()
    b, c = x.shape[:2]
    xf = x.float().reshape(b, num_groups, -1)
    count = xf.shape[-1] * st.size
    s = xf.sum(dim=-1, keepdim=True)
    dist.all_reduce(s, group=st.group)
    mean = s / count
    d = xf - mean
    v = (d * d).sum(dim=-1, keepdim=True)
    dist.all_reduce(v, group=st.group)
    xf = d * torch.rsqrt(v / count + eps)
    bshape = (1, c) + (1,) * (x.dim() - 2)
    y = (xf.reshape(x.shape) * weight.float().reshape(bshape)
         + bias.float().reshape(bshape))
    if apply_silu:
        y = torch.nn.functional.silu(y)
    return y.to(x.dtype)


def context_group(n_devices: Optional[int] = None):
    """The group of the job's first ``n_devices`` ranks (all by default):
    the counterpart of ``context_mesh``.  Every rank of the job calls it."""
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n_devices)))


def shared_clone(module: torch.nn.Module, axis: Optional[str]
                 ) -> torch.nn.Module:
    """``module`` copied with its parameters and buffers shared, every
    ``seq_axis`` set to ``axis`` and the fused GroupNorm+SiLU off (with
    ``axis`` None: the unfused module a context-parallel run is held
    against)."""
    from fgdm_tpu_torch.nn.layers import FusedGroupNormSiLU, GroupNorm32

    memo = {id(t): t for t in itertools.chain(module.parameters(),
                                              module.buffers())}
    out = copy.deepcopy(module, memo)
    for m in out.modules():
        if hasattr(m, "seq_axis"):
            m.seq_axis = axis
        if getattr(m, "fused_norm", False):
            m.fused_norm = False
        if isinstance(m, FusedGroupNormSiLU):
            m.__class__ = GroupNorm32
    return out


def context_parallel_pipeline(ld, group=None, axis: str = AXIS):
    """A ``LatentDiffusion``/``ControlLDM`` clone for context-parallel
    execution over ``group`` (the job by default), which it registers."""
    import fgdm_tpu_torch.nn.layers as _nl

    set_context_group(group if group is not None else dist.group.WORLD)
    if _nl._PALLAS_CONV or _nl._PALLAS_CONV_VAE:
        print("[context_parallel] disabling FGDM_PALLAS_CONV(_VAE): Pallas "
              "conv custom calls cannot be GSPMD-partitioned")
        _nl._PALLAS_CONV = False
        _nl._PALLAS_CONV_VAE = False
    updates = {name: shared_clone(getattr(ld, name), axis)
               for name in ("unet", "vae", "control")
               if getattr(ld, name, None) is not None}
    return dataclasses.replace(ld, **updates)


def _size(group) -> Tuple[int, int]:
    group = group if group is not None else get_context_group()
    return dist.get_world_size(group), dist.get_rank(group)


def sample_context_parallel(ld, group, cond_ctx: torch.Tensor,
                            uncond_ctx: torch.Tensor,
                            image_hw: Tuple[int, int], num_steps: int = 50,
                            cfg_scale: float = 7.5, axis: str = AXIS,
                            decode: bool = True,
                            x_T: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None
                            ) -> torch.Tensor:
    """DDIM-sample one batch at ``image_hw`` with H sharded over ``group``.

    ``ld`` must be a ``context_parallel_pipeline`` clone.  The latent H
    (``image_hw[0] // 8``) must divide by the group size.  ``x_T`` (the
    whole ``[B, C, h, w]`` noise, the same on every rank) is injectable;
    else it is drawn from ``generator`` (seeded alike on every rank).
    Returns the decoded image ``[B, 3, H, W]`` (or the latent with
    ``decode=False``), whole on every rank."""
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.sampling.ddim import ddim_sample

    group = group if group is not None else get_context_group()
    n_dev, rank = _size(group)
    b = cond_ctx.shape[0]
    lat_hw = (image_hw[0] // 8, image_hw[1] // 8)
    unet = ld.unet
    # Hard requirement: the top-level H shard must be even.  Deeper levels
    # are gathered where their rows do not divide (exact); ring attention
    # needs each level's token count to divide over the group.
    if lat_hw[0] % n_dev != 0:
        raise AssertionError(
            f"latent H {lat_hw[0]} must divide over the {n_dev}-device seq "
            "axis")
    max_ds = 2 ** (len(unet.channel_mult) - 1)
    if lat_hw[0] % (n_dev * max_ds) != 0:
        for ds in sorted(set(unet.attention_resolutions) | {max_ds}):
            n_tok = (lat_hw[0] // ds) * (lat_hw[1] // ds)
            if n_tok % n_dev != 0:
                raise AssertionError(
                    f"ring attention at UNet level ds={ds} has {n_tok} "
                    f"tokens, not divisible over the {n_dev}-device seq axis"
                    f" — pick H a multiple of {n_dev * max_ds} (or adjust "
                    "W)")
        warnings.warn(
            f"latent H {lat_hw[0]} shards over {n_dev} devices but not at "
            f"every UNet level (deepest downsample {max_ds}×): sampling is "
            "exact, but the port gathers those levels to every rank and "
            "runs them unsharded; H a multiple of "
            f"{n_dev * max_ds} gives thrash-free layouts", stacklevel=2)
    shape = (b, unet.in_channels, lat_hw[0], lat_hw[1])
    dev = cond_ctx.device
    if x_T is None:
        x_T = torch.randn(shape, generator=generator, device=dev)
    k = lat_hw[0] // n_dev
    x_loc = x_T.to(dev, torch.float32)[:, :, rank * k:(rank + 1) * k]
    sched = DDIMSchedule.create(ld.schedule, num_steps)
    z = ddim_sample(ld.denoise_fn(), x_loc.shape, sched,
                    {"c_crossattn": cond_ctx}, {"c_crossattn": uncond_ctx},
                    cfg_scale=cfg_scale, x_T=x_loc)
    with torch.inference_mode():
        out = ld.decode_first_stage(z) if decode else z
    from fgdm_tpu_torch.parallel.mesh import all_gather_rows

    return all_gather_rows(out, group, dim=2)


@torch.inference_mode()
def decode_context_parallel(ld, group, z: torch.Tensor,
                            axis: str = AXIS) -> torch.Tensor:
    """VAE-decode a whole latent ``[B, 4, h, w]`` (the same on every rank)
    with H sharded over ``group``: a large-image decode without the tiling
    of ``sampling/tiled.py``.  Returns the whole image on every rank."""
    from fgdm_tpu_torch.parallel.mesh import all_gather_rows

    group = group if group is not None else get_context_group()
    n_dev, rank = _size(group)
    if z.shape[2] % n_dev:
        raise AssertionError(f"latent H {z.shape[2]} must divide over the "
                             f"{n_dev}-device seq axis")
    k = z.shape[2] // n_dev
    out = ld.decode_first_stage(z[:, :, rank * k:(rank + 1) * k])
    return all_gather_rows(out, group, dim=2)
