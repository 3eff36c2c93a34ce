"""The port's conditioning encoders (``fgdm_tpu_torch/models/encoders.py``),
the light adapter (``models/adapter.py``), ``AttentionPool2d`` and the
ungated feed-forward (``nn/attention.py``), held against the JAX package on
the CPU.

Tiny widths, float32; parameter trees from ``jax.eval_shape`` filled with
numpy-seeded values (``test_torch_vq.seeded``), carried to the port by
``checkpoint/convert.py`` with ``strict=True``; the feed-forward options
through ``test_torch_layers.perturbed_pair``.

Tolerance: max|d| <= 1e-5 * max(1, max|ref|) (float32, sums in another
order; ``test_torch_vq.close``); ``pixel_unshuffle`` exactly.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from fgdm_tpu.models import adapter as jad  # noqa: E402
from fgdm_tpu.models import encoders as jenc  # noqa: E402
from fgdm_tpu.nn import attention as jat  # noqa: E402
from fgdm_tpu.utils.clip_score import CLIPVisionEncoder as JVision  # noqa
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.models import adapter as tad  # noqa: E402
from fgdm_tpu_torch.models import encoders as tenc  # noqa: E402
from fgdm_tpu_torch.nn import attention as tat  # noqa: E402
from test_torch_layers import TRANSFORMER, perturbed_pair  # noqa: E402
from test_torch_vq import close, load, nchw, nhwc, seeded  # noqa: E402

torch.set_num_threads(2)

VISION = dict(patch_size=8, hidden=32, layers=1, heads=4, proj_dim=16)


def test_class_embedder_matches_jax():
    jdef = jenc.ClassEmbedder(embed_dim=32, n_classes=10)
    y = np.array([1, 7, 0])
    p = seeded(jdef, (jnp.asarray(y),), 20)
    tm = load(tenc.ClassEmbedder(32, 10, device="cpu"),
              convert.class_embedder_state_dict(p))
    got = tm(torch.from_numpy(y))
    assert got.shape == (3, 1, 32)
    close(got, jdef.apply(p, jnp.asarray(y)))


@pytest.mark.parametrize("n", [77, 10])
def test_bert_embedder_matches_jax(n):
    kw = dict(n_embed=32, n_layer=2, vocab_size=100, num_heads=4)
    jdef = jenc.BERTEmbedder(**kw)
    ids = np.random.default_rng(21).integers(0, 100, (2, n))
    p = seeded(jdef, (jnp.zeros((1, 77), jnp.int32),), 22)
    sd = convert.bert_state_dict(p)
    assert {"token_emb.weight", "pos_emb", "norm.weight",
            "layers.1.mlp.fc2.weight", "layers.0.self_attn.q_proj.bias"} \
        <= set(sd)
    tm = load(tenc.BERTEmbedder(**kw, device="cpu"), sd)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids))
    assert got.dtype == torch.float32 and got.shape == (2, n, 32)
    close(got, jax.jit(jdef.apply)(p, jnp.asarray(ids)))


@pytest.mark.parametrize("method,mult,out", [
    ("bilinear", 0.5, 8), ("area", 0.5, None), ("bicubic", 0.5, 8),
    ("nearest", 0.5, None), ("bilinear", 1.5, None), ("bicubic", 0.75, None),
    ("area", 1.25, 8), ("nearest", 1.5, 8)])
def test_spatial_rescaler_matches_jax(method, mult, out):
    jdef = jenc.SpatialRescaler(n_stages=2, method=method, multiplier=mult,
                                out_channels=out)
    x = np.random.default_rng(23).uniform(-1, 1, (2, 20, 24, 3)).astype(
        np.float32)
    p = seeded(jdef, (jnp.asarray(x),), 24)
    tm = tenc.SpatialRescaler(n_stages=2, method=method, multiplier=mult,
                              out_channels=out, device="cpu")
    if out is not None:
        load(tm, convert.spatial_rescaler_state_dict(p))
    else:
        assert list(tm.state_dict()) == []
    ref = jdef.apply(p, jnp.asarray(x))
    with torch.no_grad():
        got = tm(nchw(x))
    close(nhwc(got), ref)


def test_clip_image_embedder_matches_jax():
    class Tiny(jenc.FrozenClipImageEmbedder):
        def setup(self):
            self.visual = JVision(image_size=32, **VISION)

    jdef = Tiny(image_size=32)
    img = np.random.default_rng(25).uniform(-1, 1, (2, 64, 48, 3)).astype(
        np.float32)
    p = seeded(jdef, (jnp.asarray(img),), 26)
    tm = load(tenc.FrozenClipImageEmbedder(32, device="cpu", **VISION),
              convert.clip_image_embedder_state_dict(p))
    with torch.no_grad():
        got = tm(nchw(img))
    assert got.shape == (2, 16)
    close(got, jax.jit(jdef.apply)(p, jnp.asarray(img)))


def test_trainable_clip_embedder_matches_jax():
    kw = dict(vocab_size=100, embed_dim=32, num_layers=1, num_heads=4)
    jdef = jenc.TrainableCLIPEmbedder(**kw)
    ids = np.random.default_rng(27).integers(0, 100, (2, 77))
    p = seeded(jdef, (jnp.zeros((1, 77), jnp.int32),), 28)
    tm = load(tenc.TrainableCLIPEmbedder(**kw, device="cpu"),
              convert.clip_state_dict(p))
    assert all(q.requires_grad for q in tm.parameters())
    out = tm(torch.from_numpy(ids))
    out.sum().backward()
    assert tm.text_model.final_layer_norm.weight.grad is not None
    close(out, jdef.apply(p, jnp.asarray(ids)))


def test_pixel_unshuffle_takes_jax_channel_order():
    x = np.random.default_rng(29).standard_normal((2, 16, 24, 3)).astype(
        np.float32)
    ref = np.asarray(jad.pixel_unshuffle(jnp.asarray(x), 8))
    got = nhwc(tad.pixel_unshuffle(nchw(x), 8))
    np.testing.assert_array_equal(got, ref)
    # channel (fy * 8 + fx) * C + c; torch's own op orders (c, fy, fx)
    assert got[0, 1, 2, (3 * 8 + 5) * 3 + 2] == x[0, 8 + 3, 16 + 5, 2]
    torch_order = nhwc(F.pixel_unshuffle(nchw(x), 8))
    assert not np.array_equal(torch_order, ref)


def test_adapter_light_matches_jax():
    chans = (16, 32, 64, 64)
    jdef = jad.AdapterLight(channels=chans, nums_rb=2)
    x = np.random.default_rng(30).uniform(-1, 1, (2, 64, 64, 3)).astype(
        np.float32)
    p = seeded(jdef, (jnp.asarray(x),), 31)
    sd = convert.adapter_light_state_dict(p)
    assert {"body.0.in_conv.weight", "body.3.body.1.block2.bias",
            "body.2.out_conv.weight"} <= set(sd)
    assert sd["body.0.in_conv.weight"].shape == (4, 192, 1, 1)
    tm = load(tad.AdapterLight(channels=chans, nums_rb=2), sd)
    refs = jax.jit(jdef.apply)(p, jnp.asarray(x))
    with torch.no_grad():
        outs = tm(nchw(x))
    assert [o.shape[2] for o in outs] == [8, 4, 2, 1]
    for got, ref in zip(outs, refs):
        close(nhwc(got), ref)


@pytest.mark.parametrize("out_dim", [None, 24])
def test_attention_pool_matches_jax(out_dim):
    jdef = jat.AttentionPool2d(spacial_dim=4, embed_dim=32,
                               num_heads_channels=8, output_dim=out_dim)
    x = np.random.default_rng(32).standard_normal((3, 4, 4, 32)).astype(
        np.float32)
    p = seeded(jdef, (jnp.asarray(x),), 33)
    sd = convert.attention_pool_state_dict(p)
    assert sd["positional_embedding"].shape == (32, 17)
    assert sd["qkv_proj.weight"].shape == (96, 32, 1)
    tm = load(tat.AttentionPool2d(4, 32, 8, output_dim=out_dim), sd)
    with torch.no_grad():
        got = tm(nchw(x))
    assert got.shape == (3, out_dim or 32)
    close(got, jdef.apply(p, jnp.asarray(x)))


GLU0 = [(r"\bnet_0$", "net.0.0")] + TRANSFORMER


@pytest.mark.parametrize("kind", ["feed_forward", "block"])
def test_ungated_feed_forward_matches_jax(kind):
    x = np.random.default_rng(34).standard_normal((2, 10, 32)).astype(
        np.float32)
    if kind == "feed_forward":
        jm, tm = jat.FeedForward(32, glu=False), tat.FeedForward(32,
                                                                 glu=False)
        args, kw = (jnp.zeros((1, 10, 32)),), {}
    else:
        ctx = np.random.default_rng(35).standard_normal((2, 7, 16)).astype(
            np.float32)
        jm = jat.BasicTransformerBlock(32, 4, 8, context_dim=16,
                                       gated_ff=False)
        tm = tat.BasicTransformerBlock(32, 4, 8, context_dim=16,
                                       gated_ff=False)
        args, kw = (jnp.zeros((1, 10, 32)), jnp.zeros((1, 7, 16))), {}
    p, tm = perturbed_pair(jm, tm, args, rename=GLU0, **kw)
    assert "net.0.0.weight" in "".join(tm.state_dict())
    with torch.no_grad():
        if kind == "feed_forward":
            ref, got = jm.apply(p, jnp.asarray(x)), tm(torch.from_numpy(x))
        else:
            ref = jm.apply(p, jnp.asarray(x), jnp.asarray(ctx))[0]
            got = tm(torch.from_numpy(x), torch.from_numpy(ctx))
    close(got, ref)
    if kind == "block":
        sd = convert.unet_state_dict(
            {"input_blocks_1_1": {"transformer_blocks_0": p["params"]}})
        assert "input_blocks.1.1.transformer_blocks.0.ff.net.0.0.weight" in sd
