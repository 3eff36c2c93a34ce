"""ctypes bindings of the C++ data transforms, with numpy fallbacks.

Counterpart of ``fgdm_tpu/data/native.py``.  The JAX package loads the
committed ``native/libfgdm_transforms.so``, built with ``-march=native`` on
some other CPU; on another host that binary may not load, or may stop on an
illegal instruction.  So the port compiles ``native/transforms.cpp`` at first
use, with ``native/build.sh``'s flags, into
``build/fgdm_tpu_torch/native/libfgdm_transforms-<hash>.so`` (the hash covers
the source, the flags and the CPU that ``-march=native`` names, so a library
is never loaded on a CPU it was not built for), and loads that.  Without a
C++ compiler, or if the build fails, every function takes its numpy (or
Pillow) version, as the JAX package does without its library.

``HAS_NATIVE`` (read at first access, which builds) says which path runs;
``library_path()`` names the loaded library, or None.  The first access
builds under a lock: the loader's threads may all ask at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from fgdm_tpu_torch.kernels._build import BUILD_DIR

__all__ = ["HAS_NATIVE", "library_path", "colorize", "decolorize",
           "resize_u8", "normalize_f32", "label_to_tensor"]

SOURCE = Path(__file__).resolve().parents[2] / "native" / "transforms.cpp"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
             "-pthread")   # native/build.sh's


def _target(cxx: str) -> bytes:
    """What ``-march=native`` resolves to on this host."""
    res = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True)
    return res.stdout if res.returncode == 0 else b""


def _build() -> Optional[Path]:
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None or not SOURCE.exists():
        return None
    key = SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode() + _target(cxx)
    out = (BUILD_DIR / "native" /
           f"libfgdm_transforms-{hashlib.sha256(key).hexdigest()[:16]}.so")
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    res = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        print(f"[native] g++ failed, numpy transforms: {res.stderr[-500:]}")
        return None
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


_LOCK = threading.Lock()


def _load():
    """The loaded library, or None; built once, whichever thread asks first
    (the loader's worker threads reach it together)."""
    with _LOCK:
        return _load_once()


@functools.lru_cache(maxsize=None)
def _load_once():
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    sigs = {"fgdm_colorize_u8": [u8p, i64, u8p, i32, u8p],
            "fgdm_decolorize_u8": [u8p, i64, u8p, i32, i32p],
            "fgdm_resize_bilinear_u8": [u8p] + [i32] * 5 + [u8p],
            "fgdm_resize_nearest_u8": [u8p] + [i32] * 5 + [u8p],
            "fgdm_normalize_f32": [u8p, i64, f32p],
            "fgdm_label_to_tensor": [u8p, i32, i32, u8p, i32, i32, i32,
                                     f32p]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    lib.path = path
    return lib


def library_path() -> Optional[Path]:
    lib = _load()
    return None if lib is None else lib.path


def __getattr__(name):
    if name == "HAS_NATIVE":
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.uint8)


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def colorize(labels: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        from fgdm_tpu_torch.data.colorize import colorize as np_colorize

        return np_colorize(labels, cmap)
    labels, cmap = _u8(labels), _u8(cmap)
    out = np.empty(labels.shape + (3,), np.uint8)
    lib.fgdm_colorize_u8(_ptr(labels), labels.size, _ptr(cmap), len(cmap),
                         _ptr(out))
    return out


def decolorize(rgb: np.ndarray, cmap: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        from fgdm_tpu_torch.data.colorize import decolorize as np_decolorize

        return np_decolorize(rgb, cmap)
    rgb, cmap = _u8(rgb), _u8(cmap)
    if rgb.shape[-1] != 3:
        raise ValueError(f"decolorize wants [..., 3] RGB, got {rgb.shape}")
    out = np.empty(rgb.shape[:-1], np.int32)
    lib.fgdm_decolorize_u8(_ptr(rgb), out.size, _ptr(cmap), len(cmap),
                           _ptr(out, ctypes.c_int32))
    return out


def resize_u8(img: np.ndarray, out_hw, method: str = "bilinear"
              ) -> np.ndarray:
    """``[H, W(, C)]`` uint8 -> ``[oh, ow, C]``, bilinear or nearest."""
    lib = _load()
    img = _u8(img)
    h, w = img.shape[:2]
    c = img.shape[2] if img.ndim == 3 else 1
    oh, ow = out_hw
    if lib is None:
        from PIL import Image

        rs = Image.fromarray(img.squeeze()).resize(
            (ow, oh),
            Image.BILINEAR if method == "bilinear" else Image.NEAREST)
        return np.asarray(rs).reshape(oh, ow, c)
    out = np.empty((oh, ow, c), np.uint8)
    fn = (lib.fgdm_resize_bilinear_u8 if method == "bilinear"
          else lib.fgdm_resize_nearest_u8)
    fn(_ptr(img), h, w, c, oh, ow, _ptr(out))
    return out


def normalize_f32(img_u8: np.ndarray) -> np.ndarray:
    """uint8 -> float32 in [-1, 1]."""
    lib = _load()
    img_u8 = _u8(img_u8)
    if lib is None:
        return img_u8.astype(np.float32) / 127.5 - 1.0
    out = np.empty(img_u8.shape, np.float32)
    lib.fgdm_normalize_f32(_ptr(img_u8), img_u8.size,
                           _ptr(out, ctypes.c_float))
    return out


def label_to_tensor(labels: np.ndarray, cmap: np.ndarray,
                    out_hw) -> np.ndarray:
    """Colourise -> nearest resize -> normalise in one call (the
    per-sample hot path), ``[oh, ow, 3]`` float32."""
    lib = _load()
    if lib is None:
        return normalize_f32(resize_u8(colorize(labels, cmap), out_hw,
                                       "nearest"))
    labels, cmap = _u8(labels), _u8(cmap)
    oh, ow = out_hw
    out = np.empty((oh, ow, 3), np.float32)
    lib.fgdm_label_to_tensor(_ptr(labels), labels.shape[0], labels.shape[1],
                             _ptr(cmap), len(cmap), oh, ow,
                             _ptr(out, ctypes.c_float))
    return out
