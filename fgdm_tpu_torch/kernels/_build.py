"""Build and load the port's CUDA sources with ``nvcc`` and ``ctypes``.

Each ``csrc/<name>.cu`` is compiled at first use into a shared library with
a plain C interface, ``build/fgdm_tpu_torch/lib<name>-<hash>.so`` under the
repository root.  The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source builds anew and an
unchanged one loads from disk.  No ninja, no
PyTorch headers: the build takes seconds, not minutes.  ``nvcc``'s
``-Xptxas -v`` report (registers, shared memory, spills per kernel) is kept
beside the library as ``.log``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "fgdm_tpu_torch"
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str:
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin);"
        " the port's CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library already exists."""
    out = library_path(name)
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu``'s library (once)."""
    return ctypes.CDLL(str(build(name)))
