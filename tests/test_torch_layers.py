"""The port's layers, blocks and transformer held against the JAX package.

Each flax module is initialised from a seed, its params perturbed by 0.02
N(0, 1) (so zero-init convs do work) and loaded into the port's module with
``strict=True``; inputs come from ``np.random.default_rng``.  Float32 on the
CPU on both sides.

Tolerance: max |port - jax| <= 1e-5 * max(1, max |jax|) (the same float32
arithmetic, summed in another order); 1e-2 relative where the compute dtype
is bf16 (one bf16 rounding per op, at other places in the two frameworks).
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.models.adapter as jad  # noqa: E402
import fgdm_tpu.models.autoencoder as jae  # noqa: E402
import fgdm_tpu.nn.attention as jat  # noqa: E402
import fgdm_tpu.nn.blocks as jbl  # noqa: E402
import fgdm_tpu.nn.layers as jla  # noqa: E402
from fgdm_tpu_torch.checkpoint.convert import flatten  # noqa: E402
from fgdm_tpu_torch.models import adapter as tad  # noqa: E402
from fgdm_tpu_torch.models import autoencoder as tae  # noqa: E402
from fgdm_tpu_torch.nn import attention as tat  # noqa: E402
from fgdm_tpu_torch.nn import blocks as tbl  # noqa: E402
from fgdm_tpu_torch.nn import layers as tla  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
# flax submodule names -> the reference's torch names
TRANSFORMER = [(r"\bto_out\b", "to_out.0"), (r"\bnet_(\d)\b", r"net.\1"),
               (r"\btransformer_blocks_(\d+)\b", r"transformer_blocks.\1"),
               (r"\bbody_(\d+)\b", r"body.\1")]
RESBLOCK = [(r"^in_norm\b", "in_layers.0"), (r"^in_conv\b", "in_layers.2"),
            (r"^emb_proj\b", "emb_layers.1"), (r"^out_norm\b", "out_layers.0"),
            (r"^out_conv\b", "out_layers.3")]


def perturbed_pair(jmodule, tmodule, init_args, rename=TRANSFORMER, seed=0,
                   **init_kw):
    """Init ``jmodule``, perturb, load the same numbers into ``tmodule``."""
    p = jmodule.init(jax.random.PRNGKey(seed), *init_args, **init_kw)
    rng = np.random.default_rng(seed)
    p = jax.tree.map(lambda a: np.asarray(a) + 0.02 * rng.standard_normal(
        a.shape).astype(np.float32), p)
    sd = {}
    for path, v in flatten(p).items():
        name = ".".join(path[:-1])
        for pat, repl in rename:
            name = re.sub(pat, repl, name)
        leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
        if path[-1] == "kernel":
            v = np.transpose(v, (3, 2, 0, 1)) if v.ndim == 4 else v.T
        sd[f"{name}.{leaf}" if name else leaf] = torch.from_numpy(
            np.ascontiguousarray(v, np.float32))
    tmodule.load_state_dict(sd, strict=True)
    return p, tmodule.eval()


def nchw(a):
    a = np.asarray(a, np.float32)
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def close(port, ref, tol=TOL):
    if isinstance(port, torch.Tensor):
        port = port.detach().float().numpy()
    port, ref = np.asarray(port, np.float32), np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def randn(*shape, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("dim", [32, 33, 320])
def test_timestep_embedding(dim):
    t = np.array([0, 1, 17, 500, 999], np.int32)
    ref = jla.timestep_embedding(jnp.asarray(t), dim)
    out = tla.timestep_embedding(torch.from_numpy(t), dim)
    # XLA's and torch's f32 exp differ by an ulp in the frequencies, and
    # t up to 999 scales that into the cos/sin arguments: 1e-4
    close(out, ref, 1e-4)


@pytest.mark.parametrize("cls,eps,dtype", [
    ("GroupNorm32", 1e-5, "float32"), ("GroupNorm32", 1e-6, "bfloat16"),
    ("FusedGroupNormSiLU", 1e-5, "float32"),
    ("FusedGroupNormSiLU", 1e-6, "bfloat16")])
def test_group_norms(cls, eps, dtype):
    x = randn(2, 6, 5, 128, scale=2.0) + 0.5
    jm = getattr(jla, cls)(eps=eps)
    p, tm = perturbed_pair(jm, getattr(tla, cls)(128, eps=eps),
                           (jnp.zeros((1, 6, 5, 128)),))
    ref = jm.apply(p, jnp.asarray(x, dtype))
    out = tm(nchw(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    close(nhwc(out), ref, TOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm(dtype):
    x = randn(2, 7, 64, scale=3.0)
    jm = jla.LayerNorm32()
    p, tm = perturbed_pair(jm, tla.LayerNorm32(64), (jnp.zeros((1, 7, 64)),))
    ref = jm.apply(p, jnp.asarray(x, dtype))
    out = tm(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert out.dtype == getattr(torch, dtype)
    close(out, ref, TOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("k,stride,pad,dtype", [
    (3, 1, "same", "float32"), (1, 1, 0, "float32"), (3, 2, 1, "float32"),
    (3, 1, "same", "bfloat16")])
def test_conv2d(k, stride, pad, dtype):
    x = randn(2, 9, 9, 16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jla.Conv2d(24, kernel_size=k, stride=stride,
                    padding="SAME" if pad == "same" else pad, dtype=jdt)
    p, tm = perturbed_pair(jm, tla.Conv2d(16, 24, k, stride, pad, dtype=tdt),
                           (jnp.zeros((1, 9, 9, 16)),))
    ref = jm.apply(p, jnp.asarray(x))
    out = tm(nchw(x))
    assert out.dtype == tdt and tm.weight.dtype == torch.float32
    close(nhwc(out), ref, TOL if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("bias,dtype", [(True, "float32"), (False, "float32"),
                                        (True, "bfloat16")])
def test_dense(bias, dtype):
    x = randn(3, 5, 48)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jm = jla.Dense(32, use_bias=bias, dtype=jdt)
    p, tm = perturbed_pair(jm, tla.Dense(48, 32, bias=bias, dtype=tdt),
                           (jnp.zeros((1, 5, 48)),))
    ref = jm.apply(p, jnp.asarray(x))
    out = tm(torch.from_numpy(x))
    assert out.dtype == tdt
    close(out, ref, TOL if dtype == "float32" else 1e-2)


def test_resampling_and_silu():
    x = randn(2, 6, 4, 8)
    close(nhwc(tla.nearest_upsample_2x(nchw(x))),
          jla.nearest_upsample_2x(jnp.asarray(x)), 0)
    close(nhwc(tla.avg_pool_2x2(nchw(x))), jla.avg_pool_2x2(jnp.asarray(x)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tbl.silu(xb).dtype == torch.bfloat16
    close(tbl.silu(xb).float().numpy(),
          jbl.silu(jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32), 0)


@pytest.mark.parametrize("cross", [False, True])
def test_cross_attention(cross):
    x = randn(2, 24, 32, seed=1)
    ctx = randn(2, 77, 48, seed=2) if cross else None
    jm = jat.CrossAttention(32, context_dim=48 if cross else None, heads=4,
                            dim_head=8)
    args = (jnp.zeros((1, 24, 32)),)
    kw = {"context": jnp.zeros((1, 77, 48))} if cross else {}
    p, tm = perturbed_pair(jm, tat.CrossAttention(
        32, context_dim=48 if cross else None, heads=4, dim_head=8), args,
        **kw)
    ref, _ = jm.apply(p, jnp.asarray(x),
                      context=None if ctx is None else jnp.asarray(ctx))
    out = tm(torch.from_numpy(x),
             context=None if ctx is None else torch.from_numpy(ctx))
    close(out, ref)


def test_geglu_uses_tanh_gelu():
    x = randn(2, 10, 32, scale=2.0)
    jm = jat.GEGLU(64)
    p, tm = perturbed_pair(jm, tat.GEGLU(32, 64), (jnp.zeros((1, 10, 32)),))
    ref = jm.apply(p, jnp.asarray(x))
    close(tm(torch.from_numpy(x)), ref)


def test_feed_forward():
    x = randn(2, 10, 32)
    jm = jat.FeedForward(32)
    p, tm = perturbed_pair(jm, tat.FeedForward(32), (jnp.zeros((1, 10, 32)),))
    close(tm(torch.from_numpy(x)), jm.apply(p, jnp.asarray(x)))


def test_basic_transformer_block():
    x, ctx = randn(2, 16, 32, seed=1), randn(2, 77, 24, seed=2)
    jm = jat.BasicTransformerBlock(32, 4, 8, context_dim=24)
    p, tm = perturbed_pair(
        jm, tat.BasicTransformerBlock(32, 4, 8, context_dim=24),
        (jnp.zeros((1, 16, 32)),), context=jnp.zeros((1, 77, 24)))
    ref, _ = jm.apply(p, jnp.asarray(x), context=jnp.asarray(ctx))
    out = tm(torch.from_numpy(x), context=torch.from_numpy(ctx))
    close(out, ref)


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer(depth):
    x, ctx = randn(2, 4, 6, 64, seed=1), randn(2, 77, 24, seed=2)
    jm = jat.SpatialTransformer(64, 4, 16, depth=depth, context_dim=24)
    p, tm = perturbed_pair(
        jm, tat.SpatialTransformer(64, 4, 16, depth=depth, context_dim=24),
        (jnp.zeros((1, 4, 6, 64)),), context=jnp.zeros((1, 77, 24)))
    ref, _ = jm.apply(p, jnp.asarray(x), context=jnp.asarray(ctx))
    out = tm(nchw(x), context=torch.from_numpy(ctx))
    close(nhwc(out), ref)


RES_CASES = {
    "plain": dict(),
    "fused": dict(fused_norm=True),
    "out_ch": dict(out_channels=64),
    "out_ch_conv": dict(out_channels=64, use_conv=True),
    "scale_shift": dict(use_scale_shift_norm=True),
    "fused_scale_shift": dict(use_scale_shift_norm=True, fused_norm=True),
    "up": dict(up=True, fused_norm=True),
    "down": dict(down=True),
}


@pytest.mark.parametrize("case", sorted(RES_CASES))
def test_resblock(case):
    kw = RES_CASES[case]
    x, emb = randn(2, 8, 8, 32, seed=1), randn(2, 48, seed=2)
    jm = jbl.ResBlock(32, 48, **kw)
    p, tm = perturbed_pair(jm, tbl.ResBlock(32, 48, **kw),
                           (jnp.zeros((1, 8, 8, 32)), jnp.zeros((1, 48))),
                           rename=RESBLOCK)
    ref = jm.apply(p, jnp.asarray(x), jnp.asarray(emb))
    out = tm(nchw(x), torch.from_numpy(emb))
    close(nhwc(out), ref)


@pytest.mark.parametrize("kind,use_conv", [("Upsample", True),
                                           ("Upsample", False),
                                           ("Downsample", True),
                                           ("Downsample", False)])
def test_resample_blocks(kind, use_conv):
    x = randn(2, 8, 8, 16)
    jm = getattr(jbl, kind)(16, use_conv=use_conv)
    p, tm = perturbed_pair(jm, getattr(tbl, kind)(16, use_conv=use_conv),
                           (jnp.zeros((1, 8, 8, 16)),))
    close(nhwc(tm(nchw(x))), jm.apply(p, jnp.asarray(x)))


@pytest.mark.parametrize("kw", [
    dict(in_c=16, out_c=32, down=True, ksize=1, sk=True, use_conv=False),
    dict(in_c=16, out_c=16, down=True, ksize=3, sk=False, use_conv=True),
    dict(in_c=16, out_c=16, ksize=1, sk=True)], ids=["sd", "skep", "ident"])
def test_adapter_resnet_block(kw):
    x = randn(2, 8, 8, 16)
    jm = jad.AdapterResnetBlock(**kw)
    p, tm = perturbed_pair(jm, tad.AdapterResnetBlock(**kw),
                           (jnp.zeros((1, 8, 8, 16)),))
    close(nhwc(tm(nchw(x))), jm.apply(p, jnp.asarray(x)))


def test_adapter():
    x = randn(2, 16, 16, 4)
    jm = jad.Adapter(channels=(16, 32, 64), nums_rb=2, cin=4)
    p, tm = perturbed_pair(jm, tad.Adapter(channels=(16, 32, 64), nums_rb=2,
                                           cin=4),
                           (jnp.zeros((1, 16, 16, 4)),))
    refs = jm.apply(p, jnp.asarray(x))
    outs = tm(nchw(x))
    assert len(outs) == len(refs) == 3
    for o, r in zip(outs, refs):
        close(nhwc(o), r)


@pytest.mark.parametrize("fused,out_ch", [(False, None), (True, None),
                                          (True, 64)])
def test_vae_resnet_block(fused, out_ch):
    x = randn(2, 8, 8, 32)
    jm = jae.VaeResnetBlock(32, out_ch, fused_norm=fused)
    p, tm = perturbed_pair(jm, tae.VaeResnetBlock(32, out_ch,
                                                  fused_norm=fused),
                           (jnp.zeros((1, 8, 8, 32)),))
    close(nhwc(tm(nchw(x))), jm.apply(p, jnp.asarray(x)))


def test_vae_attn_block():
    x = randn(2, 8, 6, 64)
    jm = jae.VaeAttnBlock(64)
    p, tm = perturbed_pair(jm, tae.VaeAttnBlock(64),
                           (jnp.zeros((1, 8, 6, 64)),))
    close(nhwc(tm(nchw(x))), jm.apply(p, jnp.asarray(x)))


def test_vae_upsample():
    x = randn(1, 4, 4, 32)
    jm = jae.VaeUpsample()
    p, tm = perturbed_pair(jm, tae.VaeUpsample(32),
                           (jnp.zeros((1, 4, 4, 32)),))
    close(nhwc(tm(nchw(x))), jm.apply(p, jnp.asarray(x)))
