"""The analytic operation counts against ``torch.utils.flop_counter`` over
the plain reference, at tiny widths on the CPU."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_port import flops, harness, weights
from bench_port.reference import models as ref_models
from bench_port.reference.train import Step
from tiny import tiny_chain, tiny_train


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _model(kind, cfg, seed=0):
    with torch.device("meta"):
        m = ref_models.build(kind, cfg)
    m.load_state_dict(weights.draw_model(kind, cfg, seed, 0, "cpu"),
                      assign=True)
    return m


@pytest.fixture(scope="module")
def cfg():
    c = tiny_chain()
    c["clip"] = dict(c["clip"], width=64, layers=2, heads=4)
    c["unet"]["context_dim"] = c["control"]["context_dim"] = 64
    return c


def _ctx(n, cfg):
    return torch.randn(n, 77, cfg["unet"]["context_dim"])


@pytest.mark.parametrize("adapter", [True, False])
def test_unet(cfg, adapter):
    m = _model("unet_adapter" if adapter else "unet", cfg)
    x, t = torch.randn(2, 4, 16, 16), torch.tensor([10, 500])
    got = _counted(lambda: m(x, t, _ctx(2, cfg)))
    assert flops.unet_ops(cfg, 2, 16, 16, adapter=adapter).fwd == got


def test_controlnet_and_hint(cfg):
    m = _model("control", cfg)
    hint = torch.rand(2, 3, 64, 64)
    assert _counted(lambda: m.encode_hint(hint)) == flops.hint_ops(
        cfg, 2, 64, 64)
    emb = m.encode_hint(hint)
    x, t = torch.randn(2, 4, 8, 8), torch.tensor([3, 900])
    got = _counted(lambda: m(x, emb, t, _ctx(2, cfg)))
    assert flops.controlnet_ops(cfg, 2, 8, 8).fwd == got


def test_vae(cfg):
    m = _model("vae", cfg)
    z = torch.randn(1, 4, 8, 8)
    assert _counted(lambda: m.decode(z)) == flops.vae_decode_ops(cfg, 1, 8, 8)
    img = torch.rand(2, 3, 64, 64)
    assert _counted(lambda: m.encode_moments(img)) == flops.vae_encode_ops(
        cfg, 2, 64, 64)


def test_clip(cfg):
    m = _model("clip", cfg)
    ids = torch.randint(0, 1000, (3, 77))
    assert _counted(lambda: m(ids)) == flops.clip_ops(cfg, 3)


@pytest.mark.parametrize("distill", [False, True])
def test_train_step(distill):
    """Forward, the input gradients the adapter needs and its weight
    gradients: exact for a plain step; a distillation step's cubic
    resizes of the maps (einsums the count leaves out) within 1 %."""
    c = tiny_train()
    c["clip"] = dict(c["clip"], width=64, layers=2, heads=4)
    c["unet"]["context_dim"] = 64
    unet, vae, clip = (_model(k, c, i) for i, k in enumerate(
        ("unet_adapter", "vae", "clip")))
    for n, p in unet.named_parameters():
        p.requires_grad_("adapter" in n)
    vae.requires_grad_(False)
    clip.requires_grad_(False)
    b = 10
    step = Step(unet, vae, clip, c, block=b)
    args = (torch.rand(b, 3, 64, 64) * 2 - 1, torch.randint(0, 1000, (b, 77)),
            torch.randint(0, 1000, (b,)), torch.randn(b, 4, 8, 8),
            torch.randn(b, 4, 8, 8))
    got = _counted(lambda: step(*args, distill=distill))
    want = flops.train_step_flops(c, b, (64, 64))
    if distill:
        assert want["distill"] == pytest.approx(got, rel=1e-2)
    else:
        assert want["plain"] == got


def test_chain_total_against_the_xla_count():
    """65.5 TFLOP an image at the published sizes; the JAX package's XLA
    cost analysis (BASELINE.md) counted 66.67, element-wise work included."""
    c = json.loads((harness.PKG / "configs" /
                    "sd14_fgdm_seg_chain.json").read_text())
    total = flops.chain_flops_per_image(c)["total"]
    assert total == pytest.approx(66.67e12, rel=0.03)
