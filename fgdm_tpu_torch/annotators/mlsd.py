"""MLSD line-segment annotator (MobileNetV2 + TypeA/B/C head).

Counterpart of ``fgdm_tpu/annotators/mlsd.py``:

* ``MobileV2MLSDLarge`` (``:36-191``): a truncated MobileNetV2 on a
  4-channel input (stride-2 convs pad (0, 1, 0, 1), then run VALID;
  ``relu6``; frozen BatchNorms), FPN taps at features 1, 3, 6, 10 and 13,
  BlockTypeA (1x1 laterals, a 2x bilinear upsample) / B (residual 3x3) /
  C (a dilated head) decoding to 16 channels, of which the map is
  ``[..., 7:]``: ``[B, 9, H/2, W/2]``.  The module tree carries the
  reference's names (``backbone.features.N.conv.i``, ``block15.conv1.0``
  ...), so ``mlsd_large_512_fp32.pth`` loads by name
  (``checkpoint/annotator_ingest.load_mlsd``).
* ``decode_lines`` (``:194``): numpy and scipy on the host, exactly as
  JAX: the sigmoid centre map, a 3x3 ``maximum_filter(mode="constant")``
  non-max suppression, the top 200 by ``np.argsort(...)[::-1]``, strict
  ``>`` score and length thresholds, end points at the 2x grid.
* ``MLSDdetector`` (``:222``): ``data/imgproc.resize_area`` (OpenCV's
  INTER_AREA) to the input size, a ones plane as the 4th channel (so it is
  ``1/127.5 - 1`` after scaling, as in JAX), the net on its device, the
  decode, end points truncated by ``int(x * w / S)``, and 1-pixel lines
  through ``data/imgproc.line`` (LINE_8 with ``cv::clipLine``).

Convolutions are plain PyTorch ops, as JAX's are XLA's: no 3x3 conv here
has the shape the conv kernel's gate admits in float32.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import resolve_device
from fgdm_tpu_torch.annotators.uniformer import (FrozenBatchNorm,
                                                 resize_bilinear)
from fgdm_tpu_torch.data.imgproc import line, resize_area
from fgdm_tpu_torch.nn.layers import _init_weight

__all__ = ["MobileV2MLSDLarge", "decode_lines", "MLSDdetector"]


class _Conv(nn.Module):
    """A conv with float32 OIHW params computed in ``dtype``; stride 2 pads
    (0, 1, 0, 1) first and runs VALID (TFLite style)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, dilation: int = 1, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.stride, self.groups, self.dilation, self.dtype = (
            stride, groups, dilation, dtype)
        self.padding = 0 if stride == 2 else dilation * (k - 1) // 2
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        _init_weight(self.weight, False, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x):
        if self.stride == 2:
            x = F.pad(x, (0, 1, 0, 1))
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b,
                        self.stride, self.padding, self.dilation, self.groups)


class _ConvBN(nn.Module):
    """``Sequential(conv, BatchNorm, act)``: keys ``0.*`` and ``1.*``; the
    output is float32 (the frozen BatchNorm's)."""

    def __init__(self, conv: _Conv, act):
        super().__init__()
        self.act = act
        self.add_module("0", conv)
        self.add_module("1", FrozenBatchNorm(conv.weight.shape[0]))

    def forward(self, x):
        return self.act(self._modules["1"](self._modules["0"](x)))


def relu6(x):
    return x.clamp(0.0, 6.0)


def _cbr6(cin, cout, k, stride=1, groups=1, dtype=torch.float32):
    return _ConvBN(_Conv(cin, cout, k, stride, groups, bias=False,
                         dtype=dtype), relu6)


def _cbr(cin, cout, k, dilation=1, dtype=torch.float32):
    return _ConvBN(_Conv(cin, cout, k, dilation=dilation, dtype=dtype),
                   F.relu)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, expand_ratio: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = int(round(cin * expand_ratio))
        self.use_res = stride == 1 and cin == cout
        layers = [_cbr6(cin, hidden, 1, dtype=dtype)] if expand_ratio != 1 \
            else []
        layers += [_cbr6(hidden, hidden, 3, stride, groups=hidden,
                         dtype=dtype),
                   _Conv(hidden, cout, 1, bias=False, dtype=dtype),
                   FrozenBatchNorm(cout)]
        self.conv = nn.ModuleList(layers)

    def forward(self, x):
        h = x
        for m in self.conv:
            h = m(h)
        return x + h if self.use_res else h


class MLSDBackbone(nn.Module):
    """Truncated MobileNetV2 (settings [1,16,1,1], [6,24,2,2], [6,32,3,2],
    [6,64,4,2], [6,96,3,1]; taps at feature indices 1, 3, 6, 10, 13)."""

    TAPS = (1, 3, 6, 10, 13)

    def __init__(self, dtype: torch.dtype = torch.float32):
        super().__init__()
        feats = [_cbr6(4, 32, 3, stride=2, dtype=dtype)]
        cin = 32
        for t, c, n, s in ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
                           (6, 64, 4, 2), (6, 96, 3, 1)):
            for i in range(n):
                feats.append(InvertedResidual(cin, c, s if i == 0 else 1, t,
                                              dtype=dtype))
                cin = c
        self.features = nn.ModuleList(feats)

    def forward(self, x) -> Tuple[torch.Tensor, ...]:
        outs = []
        for i, f in enumerate(self.features):
            x = f(x)
            if i in self.TAPS:
                outs.append(x)
        return tuple(outs)


class BlockTypeA(nn.Module):
    def __init__(self, in_c1: int, in_c2: int, out_c1: int, out_c2: int,
                 upscale: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.upscale = upscale
        self.conv1 = _cbr(in_c2, out_c2, 1, dtype=dtype)
        self.conv2 = _cbr(in_c1, out_c1, 1, dtype=dtype)

    def forward(self, a, b):
        b = self.conv1(b)
        a = self.conv2(a)
        if self.upscale:
            b = resize_bilinear(b, (2 * b.shape[2], 2 * b.shape[3]))
        return torch.cat([a, b], dim=1)


class BlockTypeB(nn.Module):
    def __init__(self, in_c: int, out_c: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _cbr(in_c, in_c, 3, dtype=dtype)
        self.conv2 = _cbr(in_c, out_c, 3, dtype=dtype)

    def forward(self, x):
        return self.conv2(self.conv1(x) + x)


class BlockTypeC(nn.Module):
    def __init__(self, in_c: int, out_c: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = _cbr(in_c, in_c, 3, dilation=5, dtype=dtype)
        self.conv2 = _cbr(in_c, in_c, 3, dtype=dtype)
        self.conv3 = _Conv(in_c, out_c, 1, dtype=dtype)

    def forward(self, x):
        return self.conv3(self.conv2(self.conv1(x)))


class MobileV2MLSDLarge(nn.Module):
    """x ``[B, 4, H, W]`` -> tpMap ``[B, 9, H/2, W/2]``."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.backbone = MLSDBackbone(dtype)
            self.block15 = BlockTypeA(64, 96, 64, 64, upscale=False,
                                      dtype=dtype)
            self.block16 = BlockTypeB(128, 64, dtype)
            self.block17 = BlockTypeA(32, 64, 64, 64, dtype=dtype)
            self.block18 = BlockTypeB(128, 64, dtype)
            self.block19 = BlockTypeA(24, 64, 64, 64, dtype=dtype)
            self.block20 = BlockTypeB(128, 64, dtype)
            self.block21 = BlockTypeA(16, 64, 64, 64, dtype=dtype)
            self.block22 = BlockTypeB(128, 64, dtype)
            self.block23 = BlockTypeC(64, 16, dtype)

    def forward(self, x):
        c1, c2, c3, c4, c5 = self.backbone(x)
        h = self.block16(self.block15(c4, c5))
        h = self.block18(self.block17(c3, h))
        h = self.block20(self.block19(c2, h))
        h = self.block22(self.block21(c1, h))
        return self.block23(h)[:, 7:]


def decode_lines(tp_map: np.ndarray, score_thr: float = 0.10,
                 dist_thr: float = 20.0, topk: int = 200,
                 ksize: int = 3) -> np.ndarray:
    """tpMap ``[H, W, 9]`` -> ``[N, 4]`` float32 segments at the 2x grid
    (``utils.py:19-87``)."""
    from scipy.ndimage import maximum_filter

    center = tp_map[..., 0]
    disp = tp_map[..., 1:5]
    heat = 1.0 / (1.0 + np.exp(-center))
    hmax = maximum_filter(heat, size=ksize, mode="constant")
    heat = np.where(hmax == heat, heat, 0.0)
    flat = heat.ravel()
    idx = np.argsort(flat)[::-1][:topk]
    ys, xs = np.unravel_index(idx, heat.shape)
    scores = flat[idx]

    dist = np.sqrt(((disp[..., :2] - disp[..., 2:]) ** 2).sum(-1))
    segs = []
    for y, x, s in zip(ys, xs, scores):
        if s > score_thr and dist[y, x] > dist_thr:
            dx0, dy0, dx1, dy1 = disp[y, x]
            segs.append([x + dx0, y + dy0, x + dx1, y + dy1])
    if not segs:
        return np.zeros((0, 4), np.float32)
    return 2.0 * np.asarray(segs, np.float32)


class MLSDdetector:
    """uint8 ``[H, W, 3]`` image -> a white-on-black uint8 ``[H, W]`` line
    map (the reference's ``mlsd/__init__.py:21-44``)."""

    def __init__(self, model: MobileV2MLSDLarge, input_size: int = 512):
        self.model = model.requires_grad_(False).eval()
        self.input_size = input_size
        self.device = next(model.parameters()).device

    def net_input(self, img: np.ndarray) -> np.ndarray:
        """The scaled ``[S, S, 4]`` float32 input of ``img``."""
        s = self.input_size
        x = np.concatenate([resize_area(img, (s, s)), np.ones((s, s, 1))],
                           axis=-1)
        return x.astype(np.float32) / 127.5 - 1.0

    @torch.no_grad()
    def tp_map(self, x: np.ndarray) -> np.ndarray:
        """The net's ``[S/2, S/2, 9]`` float32 map of one input."""
        t = torch.from_numpy(x).permute(2, 0, 1)[None].to(self.device)
        return self.model(t)[0].float().permute(1, 2, 0).cpu().numpy()

    def draw(self, lines: np.ndarray, h: int, w: int) -> np.ndarray:
        s = self.input_size
        out = np.zeros((h, w), np.uint8)
        for x0, y0, x1, y1 in lines:
            line(out, (int(x0 * w / s), int(y0 * h / s)),
                 (int(x1 * w / s), int(y1 * h / s)), 255)
        return out

    def __call__(self, img: np.ndarray, thr_v: float = 0.1,
                 thr_d: float = 20.0) -> np.ndarray:
        tp = self.tp_map(self.net_input(img))
        return self.draw(decode_lines(tp, thr_v, thr_d), *img.shape[:2])
