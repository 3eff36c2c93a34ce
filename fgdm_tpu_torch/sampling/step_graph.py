"""One CUDA graph a DDIM step: the sampler's loop replayed, not dispatched.

A step of ``ddim_sample`` is the CFG denoise call (``cfg_eps``: the
doubled batch, the model, the guidance combine) and the ``ddim_step``
update, some 2,000 kernel launches of the SD UNet from the host.  Where the
call allows it, ``sample`` captures one whole step into a CUDA graph the
first time it meets a key, and runs every later step as a write of the
step's index into a device tensor and one ``graph.replay()``: the host no
longer paces the device, and it runs ahead through the loop while the
device works.

The graph owns static buffers, which every call fills before its steps:
x (the graph writes x_prev back into it, so replays chain), each leaf of
the cond and uncond dicts, the schedule's vectors and the int64 step
index, from which ``t`` and the step's scalars are gathered inside the
graph.  The replayed kernels are those of the eager step, in its order and
on its inputs, so the numbers are the eager loop's.

**The key** holds everything a capture bakes in: the model (``model_key``:
weak references to its modules, each parameter's and buffer's address and
version, the Python values its forward multiplies in, such as the
ControlNet's ``control_scales``), the shape and dtype of x and of every
cond leaf, the CFG scale, the schedule's values, and what the forward
looks up in module attributes as it runs: the kernels' gates and dispatch
functions (``attention.use_flash``, ``groupnorm.use_fused_gn``,
``conv.conv3x3``, ...), the conv and flash switches, TF32 and autocast.
So a caller that routes a gate elsewhere (a plain-PyTorch comparison)
captures a graph of its own.  A new key captures anew.  ``MAX_GRAPHS``
graphs are kept, the least recently used dropped first; each holds one
step's activations in its own memory pool.
An entry goes when one of its modules dies, or when its modules come back
with parameters changed (a training step, a load).  While it lives it
holds the parameters it read and the conv weight packs
(``kernels/graphs.py``), so no address it baked in is reused under it.

**When it engages** depends only on what the call can observe: a CUDA
device not already capturing, ``eta == 0``, no ``guidance_fn``, ``mask``,
``log_every_t`` or ``ucg_schedule`` (``ddim_sample`` decides), and a
denoise function that declares itself capturable through a ``graph_parts``
attribute, a function giving ``(modules, values)``: the modules a
call runs and the Python values its forward reads
(``LatentDiffusion.denoise_fn``'s); ``model_key`` refuses modules off
CUDA or built with ``seq_axis``.  Everything else runs the eager loop.

The first step of a call that captures runs eagerly on a side stream (it
builds the kernels' plans, weight packs and library handles a capture must
find made); the capture follows it and runs nothing on the device, and the
remaining steps replay.  The kernels' launch counters stay true: a capture
leaves them as they were and each replay adds its launches
(``kernels/graphs.py``).  ``STATS`` counts captures, replays and eager
steps (those of the eager loop included); each step's ``sampler.step``
span carries ``graph``, True on a replay.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib
import itertools
import threading
import weakref
from typing import Any, Callable, NamedTuple, Optional, Sequence

import torch

from fgdm_tpu_torch.core.schedules import DDIMSchedule
from fgdm_tpu_torch.kernels import graphs
from fgdm_tpu_torch.utils.profiling import span

__all__ = ["MAX_GRAPHS", "STATS", "ModelKey", "model_key", "model_of", "key",
           "sample", "clear"]

MAX_GRAPHS = 4
STATS: collections.Counter = collections.Counter()

_SCHED = ("timesteps", "alphas", "alphas_prev", "sqrt_one_minus_alphas",
          "sigmas")
# the modules whose attributes a step looks up as it runs: the kernels'
# gates and dispatch functions, and the switches read at import
_READ = ("kernels.attention", "kernels.conv", "kernels.groupnorm",
         "kernels.winograd", "nn.layers", "nn.attention", "nn.blocks",
         "models.unet", "models.controlnet", "models.adapter",
         "sampling.ddim", "diffusion.latent_diffusion", "diffusion.control")


class _Cuda:
    """The CUDA calls of a capture and a replay (a test swaps in a
    stand-in that runs without a card)."""

    @staticmethod
    def usable(device: torch.device) -> bool:
        return (device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing())

    @staticmethod
    def warm(fn: Callable[[], None]) -> None:
        """``fn`` eagerly on a side stream, as a capture's warm-up."""
        main = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(main)
        with torch.cuda.stream(side):
            fn()
        main.wait_stream(side)

    @staticmethod
    def capture(fn: Callable[[], None]):
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, capture_error_mode="thread_local"):
            fn()
        return g

    @staticmethod
    def replay(g) -> None:
        g.replay()


_backend = _Cuda


def _version(t: torch.Tensor) -> int:
    # an inference tensor keeps no version counter
    return -1 if t.is_inference() else t._version


class ModelKey(NamedTuple):
    """What a capture bakes in about a model: weak references to its
    modules, each parameter's and buffer's ``(address, version)``, and the
    Python values its forward reads."""

    modules: tuple
    prints: tuple
    values: tuple


def model_key(modules: Sequence[Optional[torch.nn.Module]], values: tuple
              ) -> Optional[ModelKey]:
    """What a capture of a denoise call through ``modules`` (None entries
    skipped) bakes in about the model, with the Python ``values`` its
    forward reads; None where it cannot be captured: a module off CUDA or
    built with ``seq_axis`` (context parallelism runs collectives in the
    forward)."""
    mods = [m for m in modules if m is not None]
    for m in mods:
        p = next(m.parameters(), None)
        if (p is None or not _backend.usable(p.device)
                or getattr(m, "seq_axis", None) is not None):
            return None
    prints = tuple((t.data_ptr(), _version(t)) for m in mods
                   for t in itertools.chain(m.parameters(), m.buffers()))
    return ModelKey(tuple(weakref.ref(m) for m in mods), prints, values)


def model_of(denoise_fn) -> Optional[ModelKey]:
    """The ``ModelKey`` of a denoise function that declares
    ``graph_parts``, or None."""
    parts = getattr(denoise_fn, "graph_parts", None)
    return None if parts is None else model_key(*parts())


def _switches() -> tuple:
    """The module attributes and global settings the forward reads: each
    function, class and scalar of the ``_READ`` modules, by identity (a
    gate routed elsewhere is another key), and torch's matmul, cuDNN and
    autocast settings."""
    attrs = tuple(
        (name, v) for m in _READ
        for name, v in vars(importlib.import_module(
            "fgdm_tpu_torch." + m)).items()
        if not name.startswith("__")
        and (callable(v) or isinstance(v, (bool, int, float, str,
                                           torch.dtype))))
    b = torch.backends
    return (attrs, b.cuda.matmul.allow_tf32,
            b.cuda.matmul.allow_bf16_reduced_precision_reduction,
            b.cuda.matmul.allow_fp16_reduced_precision_reduction,
            b.cudnn.enabled, b.cudnn.allow_tf32, b.cudnn.benchmark,
            b.cudnn.deterministic, torch.get_float32_matmul_precision(),
            torch.is_autocast_enabled("cuda"),
            torch.get_autocast_dtype("cuda"))


def _spec(obj) -> Any:
    """The structure of a cond dict with each tensor leaf's shape, strides,
    dtype and device; other values as they are."""
    if isinstance(obj, torch.Tensor):
        return ("tensor", tuple(obj.shape), obj.stride(), obj.dtype,
                obj.device)
    if isinstance(obj, dict):
        return ("dict", tuple((k, _spec(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return (type(obj).__name__, tuple(_spec(v) for v in obj))
    return ("value", obj)


def key(denoise_fn, x: torch.Tensor, cond, uncond, scale,
        sched: DDIMSchedule) -> Optional[tuple]:
    """The graph key of a DDIM call, or None where it runs eagerly.  It
    holds the schedule's values (read where they are: a schedule on the
    device is read back once a call), which its graph keeps on the
    device."""
    if not _backend.usable(x.device):
        return None
    model = model_of(denoise_fn)
    if model is None:
        return None
    return (model, tuple(x.shape), x.dtype, x.device, _spec(cond),
            _spec(uncond), float(scale),
            tuple(tuple(getattr(sched, f).tolist()) for f in _SCHED),
            _switches())


def _static(obj):
    """A buffer for each tensor leaf of ``obj``, in its structure."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj)
    if isinstance(obj, dict):
        return {k: _static(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_static(v) for v in obj)
    return obj


def _fill(static, obj) -> None:
    if isinstance(obj, torch.Tensor):
        static.copy_(obj)
    elif isinstance(obj, dict):
        for k, v in obj.items():
            _fill(static[k], v)
    elif isinstance(obj, (list, tuple)):
        for s, v in zip(static, obj):
            _fill(s, v)


class _Entry:
    """One key's graph, its static buffers and what it keeps alive."""

    def __init__(self, k: tuple, x, sched: DDIMSchedule, cond, uncond):
        self.lock = threading.Lock()
        mods = ([r() for r in k[0].modules] if isinstance(k[0], ModelKey)
                else [])
        self.refs = [weakref.ref(m, _dead) for m in mods]
        self.params = [t for m in mods
                       for t in itertools.chain(m.parameters(), m.buffers())]
        self.x = torch.empty_like(x)
        self.idx = torch.zeros(1, dtype=torch.int64, device=x.device)
        self.cond, self.uncond = _static(cond), _static(uncond)
        self.sched = dataclasses.replace(sched, **{
            f: getattr(sched, f).to(x.device, copy=True) for f in _SCHED})
        self.graph = None
        self.delta: dict = {}
        self.kept: list = []

    def load(self, x, cond, uncond) -> None:
        """The call's inputs into the static buffers (the schedule's
        vectors are the key's, copied in when the entry was made)."""
        self.x.copy_(x)
        _fill(self.cond, cond)
        _fill(self.uncond, uncond)

    def advance(self, step) -> None:
        self.x.copy_(step(self.x, self.idx, self.sched, self.cond,
                          self.uncond))

    def capture(self, step) -> None:
        with graphs.Capture() as c:
            self.graph = _backend.capture(lambda: self.advance(step))
        self.delta, self.kept = c.delta, c.kept
        STATS["captures"] += 1


_cache: "collections.OrderedDict[tuple, _Entry]" = collections.OrderedDict()
_lock = threading.RLock()


def _dead(_ref=None) -> None:
    """Drop the entries one of whose modules died."""
    with _lock:
        for k, e in list(_cache.items()):
            if any(r() is None for r in e.refs):
                del _cache[k]


def _stale(old: tuple, new: tuple) -> bool:
    """Whether ``old`` keys the same modules as ``new`` with parameters
    changed since (a training step, a load): its graph is never met
    again."""
    a, b = old[0], new[0]
    return (isinstance(a, ModelKey) and isinstance(b, ModelKey)
            and a.modules == b.modules and a.prints != b.prints)


def _entry(k: tuple, x, sched, cond, uncond) -> _Entry:
    with _lock:
        e = _cache.get(k)
        if e is not None:
            _cache.move_to_end(k)
            return e
        for old in [o for o in _cache if _stale(o, k)]:
            del _cache[old]
        e = _cache[k] = _Entry(k, x, sched, cond, uncond)
        while len(_cache) > MAX_GRAPHS:
            _cache.popitem(last=False)
        return e


def clear() -> None:
    """Drop every graph."""
    with _lock:
        _cache.clear()


def sample(k: tuple, step, x: torch.Tensor, sched: DDIMSchedule, cond,
           uncond) -> torch.Tensor:
    """The DDIM loop from ``x`` (x_T on the device) with one replay a step;
    returns x_0.  ``step(x, idx, sched, cond, uncond)`` is one eager step
    at the index held in the int64 device tensor ``idx``, returning
    x_prev."""
    e = _entry(k, x, sched, cond, uncond)
    with e.lock:
        e.load(x, cond, uncond)
        n = sched.num_steps
        for i in range(n):
            index = n - 1 - i
            if e.graph is None:
                with span("sampler.step", graph=False):
                    e.idx.fill_(index)
                    _backend.warm(lambda: e.advance(step))
                STATS["eager_steps"] += 1
                e.capture(step)
                continue
            with span("sampler.step", graph=True):
                e.idx.fill_(index)
                _backend.replay(e.graph)
                graphs.add_launches(e.delta)
            STATS["replays"] += 1
        return e.x.clone()
