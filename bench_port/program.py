"""What every entry does to the program before its window: build the
cell's CUDA sources, and load drawn weights into the port's modules."""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict

__all__ = ["build_kernels", "load_modules"]


def build_kernels(names) -> None:
    """nvcc the cell's CUDA sources at once (each is kept, keyed by its
    source, under the checkout's ``build/``; a later run loads it)."""
    from fgdm_tpu_torch.kernels import _build

    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(_build.build, names))


def load_modules(defs: Dict[str, object], sds: Dict[str, dict]):
    """``{name: module}``: each of the port's ``ModuleDef``s built on the
    ``meta`` device and given its drawn state dict, strictly."""
    mods = {}
    for name, d in defs.items():
        m = d.build("meta")
        m.load_state_dict(sds[name], strict=True, assign=True)
        mods[name] = m
    return mods
