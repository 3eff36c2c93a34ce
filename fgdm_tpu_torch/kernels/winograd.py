"""Winograd F(2x2, 3x3) convolution as a reformulation in torch ops.

Counterpart of ``fgdm_tpu/kernels/winograd.py``, which JAX writes as XLA
ops (no Pallas): each 2x2 output tile costs 16 multiplies instead of 36,
reorganized as 16 independent ``[tiles, C] x [C, Co]`` contractions with the
tile transforms as elementwise passes around them (Lavin & Gray,
arXiv:1509.09308: ``Y = A^T [(G g G^T) * (B^T d B)] A``, the matrices of
``winograd.py:31-45``).  So the port's version is torch ops too: the 4x4
tiles are ``unfold`` views, the transforms ``einsum`` in float32, the 16
contractions one batched matmul.

Layouts are the port's: x ``[N, C, H, W]``, w ``[Co, C, 3, 3]`` (OIHW), b
``[Co]`` in float32; the output is ``[N, Co, H, W]`` in x's dtype, the bias
added to the float32 result before the one cast.  On a CUDA device the
contractions take operands in x's dtype (bf16 in the served models) and
accumulate and write float32 (``torch.bmm(..., out_dtype=float32)``), as
``winograd.py:99-105`` asks of the TPU; on the CPU they stay float32, as
JAX's do off the TPU.

``Conv2d`` (``nn/layers.py``) routes a stride-1, pad-1, 3x3 conv with a
bias here when ``FGDM_WINOGRAD_CONV=1`` and ``winograd_ok`` admits it,
after the K7 gates (``fgdm_tpu/nn/layers.py:158-181``).  The TPU tile
knobs have no counterpart; ``FGDM_WINOGRAD_MAX_HW`` (default 64) keeps
JAX's plane-size gate.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

__all__ = ["conv3x3_winograd", "winograd_ok"]

# F(2x2, 3x3) transform matrices (Lavin & Gray eq. 10-12)
_BT = ((1, 0, -1, 0),
       (0, 1, 1, 0),
       (0, -1, 1, 0),
       (0, 1, 0, -1))
_G = ((1, 0, 0),
      (0.5, 0.5, 0.5),
      (0.5, -0.5, 0.5),
      (0, 0, 1))
_AT = ((1, 1, 1, 0),
       (0, 1, -1, -1))

# JAX's gate on the plane size (winograd.py:48-55): the float32 tile
# intermediate is 4x the input plane
_MAX_HW = int(os.environ.get("FGDM_WINOGRAD_MAX_HW", "64"))


def winograd_ok(x_shape, w_shape) -> bool:
    """3x3 convs on planes with at least 64 channels in and out and H, W
    at most ``_MAX_HW`` (``winograd.py:58-66``, in NCHW/OIHW)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    co, c, kh, kw = w_shape
    return ((kh, kw) == (3, 3) and c >= 64 and co >= 64
            and x_shape[2] <= _MAX_HW and x_shape[3] <= _MAX_HW)


def _mat(rows, device):
    return torch.tensor(rows, dtype=torch.float32, device=device)


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv with bias, by Winograd F(2, 3)."""
    n, c, h, wl = x.shape
    co = w.shape[0]
    th, tw = (h + 1) // 2, (wl + 1) // 2
    # SAME halo, then up to the even tile grid: rows [0, 2 th + 2)
    xp = F.pad(x, (1, 1 + 2 * tw - wl, 1, 1 + 2 * th - h))
    d = xp.unfold(2, 4, 2).unfold(3, 4, 2)            # [N, C, th, tw, 4, 4]
    bt, g, at = (_mat(m, x.device) for m in (_BT, _G, _AT))
    # U = B^T d B on the tile dims, float32 (additions only)
    u = torch.einsum("ri,ncxyij,sj->rsnxyc", bt, d.float(), bt)
    wt = torch.einsum("ri,ocij,sj->rsco", g, w.float(), g)
    # 16 contractions [N th tw, C] x [C, Co]
    u = u.reshape(16, n * th * tw, c)
    wt = wt.reshape(16, c, co)
    if x.is_cuda:
        m = torch.bmm(u.to(x.dtype), wt.to(x.dtype), out_dtype=torch.float32)
    else:
        m = torch.bmm(u, wt)
    m = m.reshape(4, 4, n, th, tw, co)
    y = torch.einsum("pr,rsnxyo,qs->noxpyq", at, m, at)  # [N,Co,th,2,tw,2]
    y = y.reshape(n, co, 2 * th, 2 * tw)[:, :, :h, :wl]
    return (y + b.float()[:, None, None]).to(x.dtype)
