"""OpenCV's ``resize(INTER_AREA)`` and its 1-pixel ``line``, rebuilt in
numpy, pixel for pixel (the card has no OpenCV, and the port imports none).

Siblings of ``data/pose.py``'s LINE_8 raster, for the MLSD annotator
(``fgdm_tpu/annotators/mlsd.py:239,246``):

* ``resize_area``: ``cv2.resize(img, (w, h), interpolation=INTER_AREA)``
  on uint8, in the three branches OpenCV takes: a shrink by whole factors on
  both axes (``resizeAreaFast``: each cell's integer sum times ``1.f /
  area``, rounded), a fractional shrink on both axes (``resizeArea``: the
  float32 weights of ``computeResizeAreaTab``, summed in OpenCV's order, then
  ``saturate_cast``), and any axis that grows (the linear resize with
  INTER_AREA's coefficients, in 11-bit fixed point).
* ``line``: ``cv2.line(img, p0, p1, color, 1)`` (LINE_8, no shift):
  ``cv::clipLine`` to the image, then the 8-connected ``LineIterator``
  walked left to right.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from fgdm_tpu_torch.data.pose import _clip

__all__ = ["resize_area", "line"]

_DBL_EPSILON = np.finfo(np.float64).eps
_COEF_SCALE = 1 << 11       # INTER_RESIZE_COEF_SCALE


def _sat_u8(x) -> np.ndarray:
    """``saturate_cast<uchar>``: round half to even, clamp."""
    return np.clip(np.rint(x), 0, 255).astype(np.uint8)


def _area_fast(src: np.ndarray, ix: int, iy: int) -> np.ndarray:
    """``resizeAreaFast_``: whole-factor cells, ``cvRound(sum * (1.f /
    area))``; a 2x2 cell is ``(sum + 2) >> 2`` (its vector path)."""
    h, w = src.shape[0] // iy, src.shape[1] // ix
    cells = src[:h * iy, :w * ix].astype(np.int64).reshape(
        (h, iy, w, ix) + src.shape[2:])
    total = cells.sum(axis=(1, 3))
    if ix == 2 and iy == 2:
        return ((total + 2) >> 2).astype(np.uint8)
    scale = np.float32(1.0) / np.float32(ix * iy)
    return _sat_u8(total.astype(np.float32) * scale)


def _area_tab(ssize: int, dsize: int, scale: float):
    """``computeResizeAreaTab``: ``(di, si, alpha)`` in OpenCV's order."""
    tab = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        if sx1 - fsx1 > 1e-3:
            tab.append((dx, sx1 - 1, np.float32((sx1 - fsx1) / cell)))
        for sx in range(sx1, sx2):
            tab.append((dx, sx, np.float32(1.0 / cell)))
        if fsx2 - sx2 > 1e-3:
            tab.append((dx, sx2, np.float32(min(min(fsx2 - sx2, 1.0), cell)
                                            / cell)))
    return tab


def _slots(tab, dsize: int):
    """The table as per-slot arrays: slot l holds each output's l-th
    ``(si, alpha)`` (alpha 0 where an output has fewer), so a sum over
    slots in order is OpenCV's sequential sum."""
    per = [[] for _ in range(dsize)]
    for di, si, a in tab:
        per[di].append((si, a))
    n = max(len(p) for p in per)
    si = np.zeros((n, dsize), np.int64)
    alpha = np.zeros((n, dsize), np.float32)
    used = np.zeros((n, dsize), bool)
    for d, p in enumerate(per):
        for slot, (s, a) in enumerate(p):
            si[slot, d], alpha[slot, d], used[slot, d] = s, a, True
    return si, alpha, used


def _area(src: np.ndarray, dw: int, dh: int, scale_x: float,
          scale_y: float) -> np.ndarray:
    """``resizeArea_<uchar, float>``: float32 row sums, then column sums."""
    s = src.astype(np.float32)
    xs, xa, xu = _slots(_area_tab(src.shape[1], dw, scale_x), dw)
    buf = np.zeros((src.shape[0], dw) + src.shape[2:], np.float32)
    ext = (slice(None), slice(None)) + (None,) * (src.ndim - 2)
    for slot in range(xs.shape[0]):
        add = buf + s[:, xs[slot]] * xa[slot][ext[1:]]
        buf = np.where(xu[slot][ext[1:]], add, buf)
    ys, ya, yu = _slots(_area_tab(src.shape[0], dh, scale_y), dh)
    col = (slice(None),) + (None,) * (src.ndim - 1)
    out = ya[0][col] * buf[ys[0]]
    for slot in range(1, ys.shape[0]):
        add = out + ya[slot][col] * buf[ys[slot]]
        out = np.where(yu[slot][col], add, out)
    return _sat_u8(out)


def _linear_coeffs(ssize: int, dsize: int, scale: float, inv: float,
                   clamp: bool):
    """INTER_AREA's linear-like source index and the two 11-bit weights of
    each output (``resizeGeneric``'s ``area_mode``); ``clamp``: the x axis,
    whose last source index OpenCV pins with a zero weight."""
    d = np.arange(dsize)
    s0 = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s0 + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0),
                 f - np.floor(f).astype(np.float32)).astype(np.float32)
    if clamp:
        pin = s0 >= ssize - 1
        f = np.where(pin, np.float32(0), f)
        s0 = np.where(pin, ssize - 1, s0)
    w0 = np.rint((np.float32(1) - f) * np.float32(_COEF_SCALE))
    w1 = np.rint(f * np.float32(_COEF_SCALE))
    return s0, w0.astype(np.int64), w1.astype(np.int64)


def _linear(src: np.ndarray, dw: int, dh: int, scale_x: float,
            scale_y: float, inv_x: float, inv_y: float) -> np.ndarray:
    """The fixed-point linear resize: ``HResizeLinear`` (int sums of
    11-bit weights; ``S * 2048`` past ``xmax``), then ``VResizeLinear``'s
    ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2 >> 2``."""
    sh, sw = src.shape[:2]
    s = src.astype(np.int64)
    x0, a0, a1 = _linear_coeffs(sw, dw, scale_x, inv_x, clamp=True)
    ext = (slice(None),) + (None,) * (src.ndim - 2)
    x1 = np.minimum(x0 + 1, sw - 1)
    rows = s[:, x0] * a0[ext] + s[:, x1] * a1[ext]
    edge = x0 + 1 >= sw            # from xmax on: S * 2048, no weights
    xmax = int(np.argmax(edge)) if edge.any() else dw
    rows[:, xmax:] = s[:, x0[xmax:]] * _COEF_SCALE
    y0, b0, b1 = _linear_coeffs(sh, dh, scale_y, inv_y, clamp=False)
    r0 = rows[np.clip(y0, 0, sh - 1)]
    r1 = rows[np.clip(y0 + 1, 0, sh - 1)]
    col = (slice(None),) + (None,) * (src.ndim - 1)
    out = (((b0[col] * (r0 >> 4)) >> 16) + ((b1[col] * (r1 >> 4)) >> 16)
           + 2) >> 2
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_area(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``cv2.resize(img, size, interpolation=cv2.INTER_AREA)``: uint8
    ``[H, W]`` or ``[H, W, C]`` in, ``size = (width, height)``."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_area takes uint8, got {img.dtype}")
    dw, dh = int(size[0]), int(size[1])
    sh, sw = img.shape[:2]
    if (dw, dh) == (sw, sh):
        return img.copy()
    inv_x, inv_y = dw / sw, dh / sh
    scale_x, scale_y = 1.0 / inv_x, 1.0 / inv_y
    if scale_x >= 1 and scale_y >= 1:
        ix, iy = int(np.rint(scale_x)), int(np.rint(scale_y))
        if (abs(scale_x - ix) < _DBL_EPSILON
                and abs(scale_y - iy) < _DBL_EPSILON):
            return _area_fast(img, ix, iy)
        return _area(img, dw, dh, scale_x, scale_y)
    return _linear(img, dw, dh, scale_x, scale_y, inv_x, inv_y)


def line(img: np.ndarray, p0: Sequence[int], p1: Sequence[int],
         color) -> None:
    """``cv2.line(img, p0, p1, color, 1)`` in place: integer end points,
    clipped to the image, 8-connected, drawn from the left end."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip(w, h, (int(p0[0]), int(p0[1])),
                                       (int(p1[0]), int(p1[1])))
    if not inside:
        return
    if x2 < x1:
        x1, y1, x2, y2 = x2, y2, x1, y1
    dx, dy = x2 - x1, y2 - y1
    step_y = -1 if dy < 0 else 1
    dy = abs(dy)
    vert = dy > dx
    major, minor = (dy, dx) if vert else (dx, dy)
    # Bresenham: each point steps the major axis; err < 0 also steps the
    # minor axis
    steps = np.zeros(major + 1, np.int64)
    err, n = major - 2 * minor, 0
    for j in range(1, major + 1):
        if err < 0:
            n += 1
            err += 2 * major - 2 * minor
        else:
            err -= 2 * minor
        steps[j] = n
    k = np.arange(major + 1, dtype=np.int64)
    if vert:
        xs, ys = x1 + steps, y1 + step_y * k
    else:
        xs, ys = x1 + k, y1 + step_y * steps
    img[ys, xs] = color
