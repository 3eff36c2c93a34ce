"""InceptionV3 pool3 features (2048-d), the standard FID backend.

Counterpart of ``fgdm_tpu/utils/inception.py``: the "FID variant" of
torchvision's InceptionV3 that clean-fid and pytorch-fid evaluate with
(``FIDInception*``): branch average pools with ``count_include_pad=False``
and a **max** pool (stride 1, pad 1) in the pool branch of the last block
(Mixed_7c); the stem's and the reduction blocks' max pools are unpadded.
Inference only: BatchNorm on running statistics (eps 1e-3), no aux head, no
fc.

The module carries torchvision's key names (``Conv2d_1a_3x3.conv.weight``,
``Mixed_7c.branch_pool.bn.running_var`` ...), so ``ingest_inception`` is a
key-filtered load of a released ``pt_inception-2015-12-21`` or torchvision
``inception_v3`` state dict: every key of ``expected_inception_keys`` must
be there, any other (``fc.*``, ``AuxLogits.*``, ``num_batches_tracked``) is
ignored, as in JAX.  Plain PyTorch ops in float32, as JAX's are XLA ops;
``inception_feature_fn`` resizes to 299^2 as ``jax.image.resize(...,
"bilinear")`` does (antialiased where it shrinks) and runs with TF32 off.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import full_f32, resolve_device
from fgdm_tpu_torch.annotators.uniformer import (FrozenBatchNorm,
                                                  resize_bilinear)

__all__ = ["InceptionV3", "inception_feature_fn", "ingest_inception",
           "expected_inception_keys", "init_inception_params"]

_BN_EPS = 1e-3


class BasicConv2d(nn.Module):
    """conv (no bias) -> BatchNorm (eps 1e-3, running statistics) -> ReLU."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int,
                 stride: int = 1, padding=(0, 0)):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, (kh, kw), stride=stride,
                              padding=padding, bias=False)
        self.bn = FrozenBatchNorm(cout, eps=_BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _avg_pool_fid(x):
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=False)


def _max_pool(x):
    return F.max_pool2d(x, 3, stride=2)


# (name, in_ch, out_ch, kh, kw) for every BasicConv2d in forward order
def _conv_specs() -> List[Tuple[str, int, int, int, int]]:
    specs: List[Tuple[str, int, int, int, int]] = [
        ("Conv2d_1a_3x3", 3, 32, 3, 3),
        ("Conv2d_2a_3x3", 32, 32, 3, 3),
        ("Conv2d_2b_3x3", 32, 64, 3, 3),
        ("Conv2d_3b_1x1", 64, 80, 1, 1),
        ("Conv2d_4a_3x3", 80, 192, 3, 3),
    ]

    def a(n, cin, pf):
        specs.extend([
            (f"{n}.branch1x1", cin, 64, 1, 1),
            (f"{n}.branch5x5_1", cin, 48, 1, 1),
            (f"{n}.branch5x5_2", 48, 64, 5, 5),
            (f"{n}.branch3x3dbl_1", cin, 64, 1, 1),
            (f"{n}.branch3x3dbl_2", 64, 96, 3, 3),
            (f"{n}.branch3x3dbl_3", 96, 96, 3, 3),
            (f"{n}.branch_pool", cin, pf, 1, 1),
        ])

    def b(n, cin):
        specs.extend([
            (f"{n}.branch3x3", cin, 384, 3, 3),
            (f"{n}.branch3x3dbl_1", cin, 64, 1, 1),
            (f"{n}.branch3x3dbl_2", 64, 96, 3, 3),
            (f"{n}.branch3x3dbl_3", 96, 96, 3, 3),
        ])

    def c(n, cin, c7):
        specs.extend([
            (f"{n}.branch1x1", cin, 192, 1, 1),
            (f"{n}.branch7x7_1", cin, c7, 1, 1),
            (f"{n}.branch7x7_2", c7, c7, 1, 7),
            (f"{n}.branch7x7_3", c7, 192, 7, 1),
            (f"{n}.branch7x7dbl_1", cin, c7, 1, 1),
            (f"{n}.branch7x7dbl_2", c7, c7, 7, 1),
            (f"{n}.branch7x7dbl_3", c7, c7, 1, 7),
            (f"{n}.branch7x7dbl_4", c7, c7, 7, 1),
            (f"{n}.branch7x7dbl_5", c7, 192, 1, 7),
            (f"{n}.branch_pool", cin, 192, 1, 1),
        ])

    def d(n, cin):
        specs.extend([
            (f"{n}.branch3x3_1", cin, 192, 1, 1),
            (f"{n}.branch3x3_2", 192, 320, 3, 3),
            (f"{n}.branch7x7x3_1", cin, 192, 1, 1),
            (f"{n}.branch7x7x3_2", 192, 192, 1, 7),
            (f"{n}.branch7x7x3_3", 192, 192, 7, 1),
            (f"{n}.branch7x7x3_4", 192, 192, 3, 3),
        ])

    def e(n, cin):
        specs.extend([
            (f"{n}.branch1x1", cin, 320, 1, 1),
            (f"{n}.branch3x3_1", cin, 384, 1, 1),
            (f"{n}.branch3x3_2a", 384, 384, 1, 3),
            (f"{n}.branch3x3_2b", 384, 384, 3, 1),
            (f"{n}.branch3x3dbl_1", cin, 448, 1, 1),
            (f"{n}.branch3x3dbl_2", 448, 384, 3, 3),
            (f"{n}.branch3x3dbl_3a", 384, 384, 1, 3),
            (f"{n}.branch3x3dbl_3b", 384, 384, 3, 1),
            (f"{n}.branch_pool", cin, 192, 1, 1),
        ])

    a("Mixed_5b", 192, 32)
    a("Mixed_5c", 256, 64)
    a("Mixed_5d", 288, 64)
    b("Mixed_6a", 288)
    c("Mixed_6b", 768, 128)
    c("Mixed_6c", 768, 160)
    c("Mixed_6d", 768, 160)
    c("Mixed_6e", 768, 192)
    d("Mixed_7a", 768)
    e("Mixed_7b", 1280)
    e("Mixed_7c", 2048)
    return specs


# the strided convs; they and the stem's two 3x3s pad nothing, every other
# conv pads to keep its plane ("same")
_STRIDE2 = ("Conv2d_1a_3x3", "Mixed_6a.branch3x3", "Mixed_6a.branch3x3dbl_3",
            "Mixed_7a.branch3x3_2", "Mixed_7a.branch7x7x3_4")
_VALID = _STRIDE2 + ("Conv2d_2a_3x3", "Conv2d_4a_3x3")


class InceptionV3(nn.Module):
    """The FID variant: ``[N, 3, 299, 299]`` in [-1, 1] -> ``[N, 2048]``
    pool3 features, float32."""

    def __init__(self, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            for name, cin, cout, kh, kw in _conv_specs():
                block, _, conv = name.rpartition(".")
                parent = self
                if block:
                    if not hasattr(self, block):
                        setattr(self, block, nn.Module())
                    parent = getattr(self, block)
                pad = (0, 0) if name in _VALID else ((kh - 1) // 2,
                                                     (kw - 1) // 2)
                setattr(parent, conv, BasicConv2d(
                    cin, cout, kh, kw, 2 if name in _STRIDE2 else 1, pad))

    def _a(self, m, x):
        b5 = m.branch5x5_2(m.branch5x5_1(x))
        b3 = m.branch3x3dbl_3(m.branch3x3dbl_2(m.branch3x3dbl_1(x)))
        return torch.cat([m.branch1x1(x), b5, b3,
                          m.branch_pool(_avg_pool_fid(x))], 1)

    def _b(self, m, x):
        bd = m.branch3x3dbl_3(m.branch3x3dbl_2(m.branch3x3dbl_1(x)))
        return torch.cat([m.branch3x3(x), bd, _max_pool(x)], 1)

    def _c(self, m, x):
        b7 = m.branch7x7_3(m.branch7x7_2(m.branch7x7_1(x)))
        bd = x
        for i in range(1, 6):
            bd = getattr(m, f"branch7x7dbl_{i}")(bd)
        return torch.cat([m.branch1x1(x), b7, bd,
                          m.branch_pool(_avg_pool_fid(x))], 1)

    def _d(self, m, x):
        b3 = m.branch3x3_2(m.branch3x3_1(x))
        b7 = x
        for i in range(1, 5):
            b7 = getattr(m, f"branch7x7x3_{i}")(b7)
        return torch.cat([b3, b7, _max_pool(x)], 1)

    def _e(self, m, x, pool_branch_max: bool):
        b3 = m.branch3x3_1(x)
        b3 = torch.cat([m.branch3x3_2a(b3), m.branch3x3_2b(b3)], 1)
        bd = m.branch3x3dbl_2(m.branch3x3dbl_1(x))
        bd = torch.cat([m.branch3x3dbl_3a(bd), m.branch3x3dbl_3b(bd)], 1)
        # FIDInceptionE_2 (Mixed_7c): max pool, stride 1, pad 1
        pool = (F.max_pool2d(x, 3, stride=1, padding=1) if pool_branch_max
                else _avg_pool_fid(x))
        return torch.cat([m.branch1x1(x), b3, bd, m.branch_pool(pool)], 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv2d_2b_3x3(self.Conv2d_2a_3x3(self.Conv2d_1a_3x3(x)))
        x = self.Conv2d_4a_3x3(self.Conv2d_3b_1x1(_max_pool(x)))
        x = _max_pool(x)
        for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._a(getattr(self, name), x)
        x = self._b(self.Mixed_6a, x)
        for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._c(getattr(self, name), x)
        x = self._d(self.Mixed_7a, x)
        x = self._e(self.Mixed_7b, x, pool_branch_max=False)
        x = self._e(self.Mixed_7c, x, pool_branch_max=True)
        return x.mean(dim=(2, 3))


def expected_inception_keys() -> List[str]:
    """The state-dict keys the ingest consumes (fc and aux excluded)."""
    keys = []
    for name, *_ in _conv_specs():
        keys.append(f"{name}.conv.weight")
        for s in ("weight", "bias", "running_mean", "running_var"):
            keys.append(f"{name}.bn.{s}")
    return keys


def ingest_inception(state_dict, device=None) -> InceptionV3:
    """torchvision / pytorch-fid InceptionV3 state dict -> a frozen
    ``InceptionV3``.  Raises ``KeyError`` (JAX's text) when an expected key
    is missing; every other key is ignored."""
    missing = [k for k in expected_inception_keys() if k not in state_dict]
    if missing:
        raise KeyError(f"inception ingest: {len(missing)} missing keys, "
                       f"first: {missing[:5]}")
    net = InceptionV3(device=device)
    net.load_state_dict({k: torch.as_tensor(np.asarray(state_dict[k],
                                                       np.float32))
                         for k in expected_inception_keys()})
    return net.requires_grad_(False).eval()


def init_inception_params(seed: int = 0) -> Dict[str, np.ndarray]:
    """Seeded parameters with the released shapes, in the state dict's
    OIHW layout: the draws of JAX's ``init_inception_params(seed)`` (He
    scaling, unit BatchNorms), so a seed gives both packages the same
    weights."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    for name, cin, cout, kh, kw in _conv_specs():
        # He scaling: anything smaller decays to a constant feature vector
        # over 94 ReLU layers
        w = (rng.standard_normal((kh, kw, cin, cout)).astype(np.float32)
             * np.sqrt(2.0 / (kh * kw * cin)))   # float64, as in JAX
        params[f"{name}.conv.weight"] = np.ascontiguousarray(
            w.transpose(3, 2, 0, 1), np.float32)
        params[f"{name}.bn.weight"] = np.ones((cout,), np.float32)
        params[f"{name}.bn.bias"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn.running_mean"] = np.zeros((cout,), np.float32)
        params[f"{name}.bn.running_var"] = np.ones((cout,), np.float32)
    return params


def inception_feature_fn(net: InceptionV3
                         ) -> Tuple[Callable[[np.ndarray], np.ndarray], int]:
    """FID feature backend: ``[N, H, W, 3]`` in [0, 1] (numpy) -> pool3
    ``[N, 2048]`` (numpy, float32), on the module's device."""
    dev = next(net.parameters()).device

    @torch.no_grad()
    def fn(img01: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(img01, np.float32)).to(dev)
        with full_f32():
            x = resize_bilinear(x.permute(0, 3, 1, 2), (299, 299))
            return net(x * 2.0 - 1.0).cpu().numpy()

    return fn, 2048
