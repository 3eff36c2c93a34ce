"""The UNet and LDM variants a config reaches, held against the JAX package
on the CPU: pixel attention (``use_spatial_transformer=False``) in both qkv
orders, ``resblock_updown``, ``num_classes`` with the labels ``y``, all of
them at once, and the ``concat``/``hybrid``/``adm`` routes of
``LatentDiffusion.apply_model``; then the reference's key schema of those
modules (conv1d ``qkv``/``proj_out``, ``label_emb``) through the port's
ingest and ``load_fgdm``.

Tiny geometries of ``tests/test_torch_chain.py`` (float32, 8^2 latents).
Flax params are seeded values on the tree of each model's init traced on
shapes alone; they go into the port through ``convert.unet_state_dict``
with ``load_state_dict(strict=True)``.

Tolerance: max |port - jax| <= 1e-4 * max(1, max |jax|) (a whole UNet,
float32 on both sides); activation checkpointing changes nothing (exact).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion as JLatentDiffusion)
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert, loader  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.core.schedules import DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion)
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.attention import PixelAttentionBlock  # noqa: E402
from fgdm_tpu_torch.nn.blocks import Downsample, Upsample  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402

torch.set_num_threads(2)

BASE = dict(model_channels=32, num_heads=4, channel_mult=(1, 2),
            attention_resolutions=(1, 2), num_res_blocks=1,
            use_adapter=False)
TOL = 1e-4
LAT = 8
N_CLASSES = 10
VARIANTS = {
    "pixel_legacy": dict(use_spatial_transformer=False, context_dim=None),
    "pixel_new_order": dict(use_spatial_transformer=False,
                            use_new_attention_order=True, context_dim=None),
    "resblock_updown": dict(resblock_updown=True, context_dim=64),
    "num_classes": dict(num_classes=N_CLASSES, context_dim=64),
    "all": dict(use_spatial_transformer=False, use_new_attention_order=True,
                resblock_updown=True, num_classes=N_CLASSES,
                context_dim=None),
}
# conditioning_key -> (UNet arguments, cond keys)
ROUTES = {
    "concat": dict(in_channels=8, context_dim=None),
    "hybrid": dict(in_channels=8, context_dim=64),
    "adm": dict(num_classes=N_CLASSES, context_dim=None),
}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(a, np.float32), (0, 3, 1, 2))))


def nhwc(t):
    return np.transpose(t.detach().numpy(), (0, 2, 3, 1))


def assert_close(port, ref, tol=TOL):
    port, ref = np.asarray(port), np.asarray(ref)
    assert port.shape == ref.shape
    err = np.abs(port - ref).max()
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def seeded_tree(jdef, seed, in_channels=4):
    """Seeded values on ``jdef``'s abstract init: kernels and embeddings
    N(0, 1/fan_in), norm scales 1 and biases 0, each plus 0.02 N(0, 1)."""
    ctx = (jnp.zeros((1, 77, jdef.context_dim))
           if jdef.context_dim else None)
    y = (jnp.zeros((1,), jnp.int32) if jdef.num_classes is not None
         else None)
    tree = jloader._abstract_init(jdef, jnp.zeros((1, LAT, LAT, in_channels)),
                                  jnp.zeros((1,), jnp.int32), ctx, y)
    rng = np.random.default_rng(seed)

    def fill(path, a):
        shape, leaf = a.shape, path[-1].key
        base = np.ones(shape) if leaf == "scale" else np.zeros(shape)
        if leaf in ("kernel", "embedding"):
            base = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


def pair(kw, seed):
    jdef = JUNetModel(**BASE, **kw, dtype=jnp.float32)
    params = seeded_tree(jdef, seed, kw.get("in_channels", 4))
    unet = UNetModel(**BASE, **kw, dtype=torch.float32, device="cpu")
    unet.load_state_dict(convert.unet_state_dict(params), strict=True)
    return jdef, params, unet.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(60)
    return dict(x=rng.standard_normal((2, LAT, LAT, 4)).astype(np.float32),
                cc=rng.standard_normal((2, LAT, LAT, 4)).astype(np.float32),
                t=np.array([27, 912]),
                ctx=(0.5 * rng.standard_normal((2, 77, 64))).astype(
                    np.float32),
                y=np.array([3, 7]))


@pytest.mark.parametrize("name", list(VARIANTS))
def test_variant_forward_matches_jax(name, inputs):
    kw = VARIANTS[name]
    jdef, params, unet = pair(kw, 61 + len(name))
    ctx = inputs["ctx"] if kw.get("context_dim") else None
    y = inputs["y"] if kw.get("num_classes") else None
    ref = jdef.apply(params, jnp.asarray(inputs["x"]),
                     jnp.asarray(inputs["t"]),
                     None if ctx is None else jnp.asarray(ctx),
                     None if y is None else jnp.asarray(y))
    with torch.no_grad():
        out = unet(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                   context=None if ctx is None else torch.from_numpy(ctx),
                   y=None if y is None else torch.from_numpy(y))
    assert_close(nhwc(out), ref)
    kinds = {type(m) for m in unet.modules()}
    assert (PixelAttentionBlock in kinds) == (
        kw.get("use_spatial_transformer") is False)
    assert (Downsample in kinds or Upsample in kinds) != kw.get(
        "resblock_updown", False)
    assert (unet.label_emb is not None) == ("num_classes" in kw)


@pytest.mark.parametrize("new_order", [False, True])
def test_pixel_attention_block_layouts(new_order):
    """The two qkv orders read the same fused projection differently: on the
    same weights they give different outputs (the layout is not a no-op)."""
    blocks = []
    for order in (new_order, not new_order):
        blk = PixelAttentionBlock(64, 4, use_new_attention_order=order)
        init_params_(blk, torch.Generator().manual_seed(62), 0.02)
        blocks.append(blk.eval())
    assert blocks[0].qkv.weight.shape == (192, 64, 1)
    assert blocks[0].proj_out.weight.shape == (64, 64, 1)
    x = torch.randn(2, 64, 4, 4, generator=torch.Generator().manual_seed(63))
    with torch.no_grad():
        a, b = (blk(x) for blk in blocks)
    assert a.shape == x.shape and not torch.allclose(a, b)


def test_num_classes_needs_labels(inputs):
    _, _, unet = pair(VARIANTS["num_classes"], 64)
    with pytest.raises(ValueError, match="labels"):
        unet(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
             context=torch.from_numpy(inputs["ctx"]))


def test_pixel_attention_refuses_capture(inputs):
    _, _, unet = pair(VARIANTS["pixel_legacy"], 65)
    with pytest.raises(ValueError, match="use_spatial_transformer"):
        unet(nchw(inputs["x"]), torch.from_numpy(inputs["t"]), capture=True)


def test_variant_remat_matches_plain(inputs):
    """``remat`` recomputes the pixel-attention blocks and the resampling
    ResBlocks in the backward: the gradients are the plain ones."""
    kw = VARIANTS["all"]
    _, params, plain = pair(kw, 66)
    rematted = UNetModel(**BASE, **kw, remat=True, dtype=torch.float32,
                         device="cpu")
    rematted.load_state_dict(plain.state_dict(), strict=True)
    grads = []
    for unet in (plain, rematted):
        out = unet(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                   y=torch.from_numpy(inputs["y"]))
        out.square().mean().backward()
        grads.append({k: p.grad.clone() for k, p in unet.named_parameters()})
    assert set(grads[0]) == set(grads[1])
    for k, g in grads[0].items():
        torch.testing.assert_close(grads[1][k], g, rtol=0, atol=0)


@pytest.mark.parametrize("key", list(ROUTES))
def test_conditioning_routes_match_jax(key, inputs):
    kw = ROUTES[key]
    jdef, params, unet = pair(kw, 67 + len(key))
    sched_kw = dict(linear_start=0.00085, linear_end=0.0120)
    jld = JLatentDiffusion(
        unet_def=jdef, vae_def=None, clip_def=None, conditioning_key=key,
        unet_params=params,
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **sched_kw))
    ld = LatentDiffusion(unet, None, DiffusionSchedule.create(
        1000, "linear", **sched_kw), conditioning_key=key)
    jcond, cond = {}, {}
    if key in ("concat", "hybrid"):
        jcond["c_concat"] = jnp.asarray(inputs["cc"])
        cond["c_concat"] = nchw(inputs["cc"])
    if key == "hybrid":
        jcond["c_crossattn"] = jnp.asarray(inputs["ctx"])
        cond["c_crossattn"] = torch.from_numpy(inputs["ctx"])
    if key == "adm":
        jcond["c_adm"] = jnp.asarray(inputs["y"])
        cond["c_adm"] = torch.from_numpy(inputs["y"])
    ref = jld.apply_model(jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"]),
                          jcond)
    with torch.no_grad():
        out = ld.apply_model(nchw(inputs["x"]),
                             torch.from_numpy(inputs["t"]), cond)
    assert_close(nhwc(out), ref)


def test_unknown_conditioning_key_raises():
    with pytest.raises(ValueError, match="conditioning_key"):
        LatentDiffusion(None, None, None, conditioning_key="hybrid-adm")


def reference_schema(unet):
    return {ti.UNET_PREFIX + k: v for k, v in unet.state_dict().items()}


def test_reference_schema_loads_with_no_missing_key():
    """A file in the reference's schema for the ``all`` variant (conv1d
    ``qkv``/``proj_out`` ``[out, in, 1]``, ``label_emb.weight``, resampling
    ResBlocks) loads into the port's module: 0 missing, 0 unexpected, every
    tensor equal."""
    kw = VARIANTS["all"]
    src = init_params_(UNetModel(**BASE, **kw, dtype=torch.float32,
                                 device="cpu"),
                       torch.Generator().manual_seed(68), 0.02)
    sd = reference_schema(src)
    qkv = [k for k in sd if k.endswith(".qkv.weight")]
    assert qkv and all(sd[k].dim() == 3 and sd[k].shape[2] == 1
                       for k in qkv)
    assert sd[ti.UNET_PREFIX + "label_emb.weight"].shape == (N_CLASSES, 128)
    dst = UNetModel(**BASE, **kw, dtype=torch.float32, device="cpu")
    missing, unexpected = ti.ingest_unet(sd, dst)
    assert missing == [] and unexpected == []
    for k, v in dst.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
    # the conv1d keys are JAX's too: its ingest reads every qkv/proj_out
    jdef = JUNetModel(**BASE, **kw, dtype=jnp.float32)
    expect = jloader._abstract_init(jdef, jnp.zeros((1, LAT, LAT, 4)),
                                    jnp.zeros((1,), jnp.int32), None,
                                    jnp.zeros((1,), jnp.int32))
    _, jmissing, junexpected = jti.ingest_unet(
        {k: v.numpy() for k, v in sd.items()}, expect=expect)
    assert junexpected == []
    # JAX maps label_emb.weight to a dense kernel its nn.Embed lacks, and
    # keeps the table at its init (ROADMAP Queue C): the one key it misses
    assert jmissing == ["params/label_emb/embedding"]


@pytest.mark.parametrize("key", ["concat", "adm"])
def test_load_fgdm_takes_the_conditioning_key(key, tmp_path):
    kw = ROUTES[key]
    src = init_params_(UNetModel(**BASE, **kw, dtype=torch.float32,
                                 device="cpu"),
                       torch.Generator().manual_seed(69), 0.02)
    path = str(tmp_path / "variant.pth")
    torch.save({"state_dict": reference_schema(src)}, path)
    vae = AutoencoderKL(ch=32, ch_mult=(1, 2), num_res_blocks=1,
                        resolution=64, z_channels=4, embed_dim=4,
                        dtype=torch.float32, device="cpu")
    ld = loader.load_fgdm(path, unet=UNetModel(**BASE, **kw,
                                               dtype=torch.float32,
                                               device="cpu"),
                          vae=vae, clip=CLIPTextEncoder(
                              vocab_size=128, embed_dim=64, num_layers=1,
                              num_heads=4, device="cpu"),
                          conditioning_key=key, device="cpu", verbose=False)
    assert ld.conditioning_key == key
    assert ld.load_report["missing"]["unet"] == []
    assert ld.load_report["unexpected"] == []
    for k, v in ld.unet.state_dict().items():
        assert torch.equal(v, src.state_dict()[k]), k
