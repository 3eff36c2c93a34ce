"""The port's checkpoint loading and config system held against the JAX
package.

Checkpoints are written in the reference's key schema from seeded flax
params (the tiny geometries of ``tests/test_torch_chain.py``, 0.02 N(0, 1)
on every weight), in two spellings of an ``Adapter`` block's conv: through
``fgdm_tpu.checkpoint.torch_export`` (``adapter.body.N.in_layers.2``) and
the reference's (``adapter.body.N.in_conv``).  Each holds ``model_ema.*``
keys, one key no model has and lacks one key the model has.  Both packages
load it; every weight the port loads must equal the JAX package's loaded
param (``convert.*_state_dict``) exactly, the missing and unexpected counts
must agree, and a key the file lacks keeps the port's seeded init.

The configs (``models/config.yaml`` and tiny YAMLs) go through both
``instantiate_from_config``s: module hyperparameters and ``scale_factor``
equal, schedule tables to 1e-7 relative (float32 of the same float64 math).
"""

import os
import pathlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import yaml  # noqa: E402

from fgdm_tpu import config as jconfig  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_export as jte  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.controlnet import ControlNet as JControlNet  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch import builders, config  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.checkpoint import loader  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from test_torch_chain import TINY, VAE_TINY  # noqa: E402

torch.set_num_threads(2)

REPO = pathlib.Path(__file__).resolve().parents[1]
CLIP_TINY = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
LATENT = 8
EMA = {"model_ema.decay": np.float32(0.9999),
       "model_ema.num_updates": np.int32(7),
       "model_ema.diffusion_modelout2weight": np.ones((4, 32, 3, 3),
                                                      np.float32)}
STRAY = "model.diffusion_model.not_a_block.weight"   # no model has it
# dropped from the files; a CLIP key, since filling it makes the JAX loader
# run its module's real init, which takes seconds for a UNet here
DROPPED = "text_model.encoder.layers.0.mlp.fc1.weight"


def jax_defs():
    f32 = dict(dtype=jnp.float32)
    return dict(unet=JUNetModel(**TINY, **f32),
                cn_unet=JUNetModel(**TINY, use_adapter=False, **f32),
                cn=JControlNet(**TINY, **f32),
                vae=JAutoencoderKL(**VAE_TINY, **f32),
                clip=JCLIPTextEncoder(**CLIP_TINY, **f32))


def port_modules(control=False):
    f32 = dict(dtype=torch.float32, device="cpu")
    mods = dict(unet=UNetModel(**TINY, use_adapter=not control, **f32),
                vae=AutoencoderKL(**VAE_TINY, **f32),
                clip=CLIPTextEncoder(**CLIP_TINY, **f32))
    if control:
        mods["cn"] = ControlNet(**TINY, **f32)
    return mods


def _init_args(kind):
    x, t = jnp.zeros((1, LATENT, LATENT, 4)), jnp.zeros((1,), jnp.int32)
    ctx = jnp.zeros((1, 77, 64))
    img = jnp.zeros((1, LATENT * 8, LATENT * 8, 3))
    return {"unet": (x, t, ctx), "cn_unet": (x, t, ctx),
            "cn": (x, img, t, ctx), "vae": (img,),
            "clip": (jnp.zeros((1, 77), jnp.int32),)}[kind]


@pytest.fixture(scope="module")
def jparams():
    """Seeded flax params of the five tiny models: the port's modules with
    their seeded init and 0.02 N(0, 1) on every weight, read through the
    JAX ingest (flax's own init takes a minute here)."""
    gen = torch.Generator().manual_seed(20)
    f32 = dict(dtype=torch.float32, device="cpu")
    mods = dict(unet=UNetModel(**TINY, **f32),
                cn_unet=UNetModel(**TINY, use_adapter=False, **f32),
                cn=ControlNet(**TINY, **f32),
                vae=AutoencoderKL(**VAE_TINY, **f32),
                clip=CLIPTextEncoder(**CLIP_TINY, **f32))
    ingest = dict(unet=(jti.ingest_unet, ti.UNET_PREFIX),
                  cn_unet=(jti.ingest_unet, ti.UNET_PREFIX),
                  cn=(jti.ingest_controlnet, ti.CONTROL_PREFIX),
                  vae=(jti.ingest_vae, ti.VAE_PREFIX),
                  clip=(jti.ingest_clip, ti.CLIP_PREFIX))
    defs, out = jax_defs(), {}
    for kind, module in mods.items():
        init_params_(module, gen, 0.02)
        fn, prefix = ingest[kind]
        expect = jloader._abstract_init(
            defs[kind], *_init_args(kind),
            **({"sample_posterior": False} if kind == "vae" else {}))
        tree, missing, unexpected = fn(
            {prefix + k: v.numpy() for k, v in module.state_dict().items()},
            expect=expect)
        assert missing == [] and unexpected == []
        out[kind] = jax.tree.map(np.asarray, tree)
    return out


def factor1_sd(p, spelling):
    """The factor-1 file's tensors as numpy, reference keys."""
    if spelling == "jax_export":
        unet = jte.export_unet(p["unet"])
    else:
        unet = {ti.UNET_PREFIX + k: v.numpy()
                for k, v in convert.unet_state_dict(p["unet"]).items()}
    return {**unet, **jte.export_vae(p["vae"]), **jte.export_clip(p["clip"])}


def control_sd(p):
    return {**jte.export_unet(p["cn_unet"]), **jte.export_controlnet(p["cn"]),
            **jte.export_vae(p["vae"]), **jte.export_clip(p["clip"])}


def save_pth(path, sd):
    torch.save({"state_dict": {k: torch.from_numpy(np.ascontiguousarray(v))
                               for k, v in sd.items()}}, path)
    return str(path)


def seeded(module, seed):
    return loader.seeded_init_(module, seed)


def assert_loaded(module, jax_tree, to_sd, skip=()):
    """Every key of ``module`` bit-equal to JAX's loaded param."""
    ref = to_sd(jax_tree)
    got = module.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        if k not in skip:
            assert torch.equal(got[k], ref[k]), k


# --- load_fgdm / load_controlnet ---------------------------------------------

@pytest.mark.parametrize("spelling", ["jax_export", "reference"])
def test_load_fgdm_matches_jax(jparams, tmp_path, spelling):
    sd = factor1_sd(jparams, spelling)
    in_layers = [k for k in sd if ".in_layers.2." in k and "adapter." in k]
    assert bool(in_layers) == (spelling == "jax_export")
    del sd[ti.CLIP_PREFIX + DROPPED]
    sd.update(EMA)
    sd[STRAY] = np.zeros((3,), np.float32)
    path = save_pth(tmp_path / "fgdm.pth", sd)

    defs = jax_defs()
    jld = jloader.load_fgdm(path, dtype=jnp.float32, latent_size=LATENT,
                            unet=defs["unet"], vae=defs["vae"],
                            clip=defs["clip"], verbose=False)
    ld = loader.load_fgdm(path, verbose=False, device="cpu",
                          **port_modules())
    missing = ld.load_report["missing"]
    assert missing == {"unet": [], "vae": [], "clip": [DROPPED]}
    assert ld.load_report["unexpected"] == ["not_a_block.weight"]
    assert_loaded(ld.unet, jld.unet_params, convert.unet_state_dict)
    assert_loaded(ld.vae, jld.vae_params, convert.vae_state_dict)
    assert_loaded(ld.clip, jld.clip_params, convert.clip_state_dict,
                  skip=[DROPPED])
    # the dropped key keeps the seeded init (not zeros, not JAX's init)
    fresh = seeded(CLIPTextEncoder(**CLIP_TINY, dtype=torch.float32,
                                   device="cpu"), 2)
    w = ld.clip.state_dict()[DROPPED]
    assert torch.equal(w, fresh.state_dict()[DROPPED])
    assert w.abs().sum() > 0
    assert ld.scale_factor == jld.scale_factor
    np.testing.assert_array_equal(ld.schedule.betas.numpy(),
                                  np.asarray(jld.schedule.betas))

    # the counts of the JAX ingest itself
    jsd = jti.apply_key_surgery(jti.load_torch_state_dict(path),
                                ignore_keys=("model_ema.",))
    tsd = ti.apply_key_surgery(ti.load_torch_state_dict(path),
                               ignore_keys=("model_ema.",))
    assert sorted(jsd) == sorted(tsd)
    for kind, jing, ting in (("unet", jti.ingest_unet, ti.ingest_unet),
                             ("vae", jti.ingest_vae, ti.ingest_vae),
                             ("clip", jti.ingest_clip, ti.ingest_clip)):
        expect = jloader._abstract_init(
            defs[kind], *_init_args(kind),
            **({"sample_posterior": False} if kind == "vae" else {}))
        _, jm, ju = jing(jsd, expect=expect)
        tm, tu = ting(tsd, port_modules()[kind])
        assert (len(tm), len(tu)) == (len(jm), len(ju)), kind


def test_load_controlnet_matches_jax(jparams, tmp_path):
    sd = control_sd(jparams)
    del sd[ti.CLIP_PREFIX + DROPPED]
    path = save_pth(tmp_path / "cn.pth", sd)
    defs = jax_defs()
    jcldm = jloader.load_controlnet(
        path, dtype=jnp.float32, latent_size=LATENT, unet=defs["cn_unet"],
        cn=defs["cn"], vae=defs["vae"], clip=defs["clip"], verbose=False)
    cldm = loader.load_controlnet(path, verbose=False, device="cpu",
                                  **port_modules(control=True))
    report = cldm.load_report
    assert report["missing"] == {"unet": [], "control": [], "vae": [],
                                 "clip": [DROPPED]}
    assert report["unexpected"] == []
    assert_loaded(cldm.unet, jcldm.unet_params, convert.unet_state_dict)
    assert_loaded(cldm.control, jcldm.control_params,
                  convert.controlnet_state_dict)
    assert_loaded(cldm.vae, jcldm.vae_params, convert.vae_state_dict)
    assert_loaded(cldm.clip, jcldm.clip_params, convert.clip_state_dict,
                  skip=[DROPPED])
    fresh = seeded(CLIPTextEncoder(**CLIP_TINY, dtype=torch.float32,
                                   device="cpu"), 2)
    assert torch.equal(cldm.clip.state_dict()[DROPPED],
                       fresh.state_dict()[DROPPED])


def test_load_controlnet_shares_the_first_stage(jparams, tmp_path):
    """``share_first_stage``: the same VAE and CLIP objects, no copy, and
    the file's VAE and CLIP keys are not read (JAX keeps the shared
    params too)."""
    f1 = save_pth(tmp_path / "fgdm.pth", factor1_sd(jparams, "reference"))
    sd = control_sd(jparams)
    sd = {k: (v + 1.0 if k.startswith(ti.VAE_PREFIX) else v)
          for k, v in sd.items()}
    cn = save_pth(tmp_path / "cn.pth", sd)
    ld = loader.load_fgdm(f1, verbose=False, device="cpu", **port_modules())
    mods = port_modules(control=True)
    cldm = loader.load_controlnet(cn, share_first_stage=ld, verbose=False,
                                  unet=mods["unet"], cn=mods["cn"])
    assert cldm.vae is ld.vae and cldm.clip is ld.clip
    assert set(cldm.load_report["missing"]) == {"unet", "control"}
    defs = jax_defs()
    jld = jloader.load_fgdm(f1, dtype=jnp.float32, latent_size=LATENT,
                            unet=defs["unet"], vae=defs["vae"],
                            clip=defs["clip"], verbose=False)
    jcldm = jloader.load_controlnet(
        cn, dtype=jnp.float32, latent_size=LATENT, share_first_stage=jld,
        unet=defs["cn_unet"], cn=defs["cn"], vae=defs["vae"],
        clip=defs["clip"], verbose=False)
    assert_loaded(cldm.vae, jcldm.vae_params, convert.vae_state_dict)
    assert_loaded(cldm.control, jcldm.control_params,
                  convert.controlnet_state_dict)


def test_missing_adapter_keeps_the_seeded_init(jparams, tmp_path):
    """A file without the adapter (an SD checkpoint) leaves the adapter at
    the seeded init, which is not all zeros; the other keys load, and the
    missing counts equal JAX's."""
    sd = {k: v for k, v in factor1_sd(jparams, "reference").items()
          if not k.startswith(ti.UNET_PREFIX + "adapter.")}
    path = save_pth(tmp_path / "sd.pth", sd)
    ld = loader.load_fgdm(path, verbose=False, device="cpu",
                          **port_modules())
    fresh = seeded(UNetModel(**TINY, dtype=torch.float32, device="cpu"), 0)
    adapter = {k: v for k, v in ld.unet.state_dict().items()
               if k.startswith("adapter.")}
    assert sorted(ld.load_report["missing"]["unet"]) == sorted(adapter)
    ref = fresh.state_dict()
    for k, v in adapter.items():
        assert torch.equal(v, ref[k]), k
    assert sum(float(v.abs().sum()) for v in adapter.values()) > 0
    defs = jax_defs()
    _, jm, _ = jti.ingest_unet(jti.load_torch_state_dict(path),
                               expect=jloader._abstract_init(
                                   defs["unet"], *_init_args("unet")))
    assert len(jm) == len(adapter)
    assert all(k.startswith("params/adapter/") for k in jm)


def test_load_without_a_path_is_the_seeded_init():
    ld = loader.load_fgdm(None, device="cpu", **port_modules())
    assert ld.load_report is None
    for seed, module in enumerate((ld.unet, ld.vae, ld.clip)):
        fresh = seeded(type(module)(**{
            UNetModel: TINY, AutoencoderKL: VAE_TINY,
            CLIPTextEncoder: CLIP_TINY}[type(module)], dtype=torch.float32,
            device="cpu"), seed)
        ref = fresh.state_dict()
        for k, v in module.state_dict().items():
            assert torch.equal(v, ref[k]), k


def test_shape_mismatch_raises_on_both_sides(jparams, tmp_path):
    sd = factor1_sd(jparams, "reference")
    key = ti.UNET_PREFIX + "out.2.bias"
    sd[key] = np.zeros((5,), np.float32)
    path = save_pth(tmp_path / "bad.pth", sd)
    defs = jax_defs()
    with pytest.raises(ValueError, match="shape mismatch"):
        jloader.load_fgdm(path, dtype=jnp.float32, latent_size=LATENT,
                          unet=defs["unet"], vae=defs["vae"],
                          clip=defs["clip"], verbose=False)
    mods = port_modules()
    with pytest.raises(ValueError, match="shape mismatch at out.2.bias"):
        loader.load_fgdm(path, verbose=False, device="cpu", **mods)
    # nothing was copied from the file before the check
    assert not torch.equal(mods["unet"].state_dict()["out.2.weight"],
                           torch.from_numpy(sd[ti.UNET_PREFIX
                                               + "out.2.weight"]))


def test_unexpected_keys_the_jax_schema_maps(jparams):
    """An adapter key meeting a UNet without one: JAX's schema maps it and
    drops it quietly; the port reports it, as the reference's
    ``load_state_dict(strict=False)`` does.  Keys no schema maps are
    unexpected on both sides."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jte.export_unet(jparams["unet"]).items()}
    unet = UNetModel(**TINY, use_adapter=False, dtype=torch.float32,
                     device="cpu")
    missing, unexpected = ti.ingest_unet(sd, unet)
    n_adapter = sum(k.startswith(ti.UNET_PREFIX + "adapter.") for k in sd)
    assert missing == [] and len(unexpected) == n_adapter > 0
    defs = jax_defs()
    _, jm, ju = jti.ingest_unet(
        {k: v.numpy() for k, v in sd.items()},
        expect=jloader._abstract_init(defs["cn_unet"], *_init_args("unet")))
    assert jm == [] and ju == []


def test_clip_keys_without_text_model_level(jparams):
    """Older HF CLIP checkpoints lack the ``text_model.`` level; JAX's
    mapper strips it, the port adds it."""
    sd = {k.replace("transformer.text_model.", "transformer."):
          torch.from_numpy(np.ascontiguousarray(v))
          for k, v in jte.export_clip(jparams["clip"]).items()}
    assert not any("text_model" in k for k in sd)
    clip = CLIPTextEncoder(**CLIP_TINY, dtype=torch.float32, device="cpu")
    assert ti.ingest_clip(sd, clip) == ([], [])
    assert_loaded(clip, jparams["clip"], convert.clip_state_dict)


def test_key_surgery_matches_jax():
    sd = {"model_ema.decay": np.ones(1), "a.old.b": np.zeros(2),
          "model.x": np.ones(3), "first_stage_model.old": np.zeros(1)}
    kw = dict(ignore_keys=("model_ema.",), replace_keys=(("old", "new"),))
    ref = jti.apply_key_surgery(sd, **kw)
    got = ti.apply_key_surgery({k: torch.from_numpy(v) for k, v in sd.items()},
                               **kw)
    assert list(got) == list(ref) == ["a.new.b", "model.x",
                                      "first_stage_model.new"]


# --- safetensors ---------------------------------------------------------------

def test_safetensors_reader_matches_the_package(tmp_path):
    """``load_torch_state_dict`` returns what ``safetensors.torch.save_file``
    wrote, every dtype bit for bit."""
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(0)
    tensors = {
        "f32": torch.randn(3, 5, generator=g),
        "f16": torch.randn(7, generator=g).half(),
        "bf16": torch.randn(2, 3, generator=g).bfloat16(),
        "f64": torch.randn(1, generator=g).double(),
        "i64": torch.arange(5),
        "i32": torch.arange(3, dtype=torch.int32),
        "u8": torch.arange(3, dtype=torch.uint8),
        "i8": torch.tensor([-1, 2], dtype=torch.int8),
        "b": torch.tensor([True, False, True]),
        "empty": torch.zeros(0, 4),
        "scalar": torch.tensor(2.5),
    }
    path = str(tmp_path / "m.safetensors")
    st.save_file(tensors, path, metadata={"format": "pt"})
    got = ti.load_torch_state_dict(path)
    ref = st.load_file(path)
    assert sorted(got) == sorted(ref)
    for k, v in ref.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        assert torch.equal(got[k], v), k


def test_safetensors_checkpoint_loads_as_jax_loads_it(jparams, tmp_path):
    st = pytest.importorskip("safetensors.torch")
    sd = factor1_sd(jparams, "jax_export")
    path = str(tmp_path / "fgdm.safetensors")
    st.save_file({k: torch.from_numpy(np.ascontiguousarray(v))
                  for k, v in sd.items()}, path)
    jsd = jti.load_torch_state_dict(path)
    tsd = ti.load_torch_state_dict(path)
    assert sorted(jsd) == sorted(tsd) == sorted(sd)
    for k in sd:
        np.testing.assert_array_equal(tsd[k].numpy(), jsd[k])
    defs = jax_defs()
    jld = jloader.load_fgdm(path, dtype=jnp.float32, latent_size=LATENT,
                            unet=defs["unet"], vae=defs["vae"],
                            clip=defs["clip"], verbose=False)
    ld = loader.load_fgdm(path, verbose=False, device="cpu",
                          **port_modules())
    assert ld.load_report["missing"] == {"unet": [], "vae": [], "clip": []}
    assert_loaded(ld.unet, jld.unet_params, convert.unet_state_dict)
    assert_loaded(ld.vae, jld.vae_params, convert.vae_state_dict)
    assert_loaded(ld.clip, jld.clip_params, convert.clip_state_dict)


def test_loaders_build_on_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (loader.load_fgdm, loader.load_controlnet):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(None)


# --- config --------------------------------------------------------------------

TINY_F1 = {"model": {
    "base_learning_rate": 5e-5,
    "target": "ldm.models.diffusion.ddpm.AdaptDiffusion",
    "params": {
        "image_size": LATENT, "scale_factor": 0.18215,
        "linear_start": 0.00085, "linear_end": 0.0120,
        "timesteps": 1000, "conditioning_key": "crossattn",
        "unet_config": {
            "target": "ldm.modules.diffusionmodules.openaimodel.UNetModel",
            "params": {**{k: list(v) if isinstance(v, tuple) else v
                          for k, v in TINY.items()},
                       "use_checkpoint": True, "legacy": False}},
        "first_stage_config": {
            "target": "ldm.models.autoencoder.AutoencoderKL",
            "params": {"embed_dim": 4, "ddconfig": {
                "ch": 32, "ch_mult": [1, 2, 4, 4], "num_res_blocks": 1,
                "resolution": 64, "z_channels": 4, "double_z": True,
                "in_channels": 3, "out_ch": 3, "attn_resolutions": []}}},
        "cond_stage_config": {
            "target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"},
    }}}
TINY_CLDM = {"model": {
    "target": "cldm.cldm.ControlLDM",
    "params": {
        "image_size": LATENT, "scale_factor": 0.18215,
        "linear_start": 0.00085, "linear_end": 0.0120,
        "only_mid_control": True,
        "unet_config": {"target": "cldm.cldm.ControlledUnetModel",
                        "params": dict(TINY_F1["model"]["params"]
                                       ["unet_config"]["params"])},
        "control_stage_config": {
            "target": "cldm.cldm.ControlNet",
            "params": {**TINY_F1["model"]["params"]["unet_config"]["params"],
                       "hint_channels": 3}},
        "first_stage_config": TINY_F1["model"]["params"]["first_stage_config"],
        "cond_stage_config": "__is_unconditional__",
    }}}


def _yaml(tmp_path, name, cfg):
    p = tmp_path / name
    p.write_text(yaml.safe_dump(cfg))
    return str(p)


def assert_same_def(tdef, jdef):
    for k, v in tdef.kwargs.items():
        if k == "dtype":
            continue
        assert getattr(jdef, k) == v, k


def assert_same_schedule(tsched, jsched):
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev",
                 "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod",
                 "lvlb_weights"):
        np.testing.assert_allclose(getattr(tsched, name).numpy(),
                                   np.asarray(getattr(jsched, name)),
                                   rtol=1e-7, err_msg=name)


@pytest.mark.parametrize("which", ["models/config.yaml", "tiny"])
def test_latent_diffusion_config_matches_jax(which, tmp_path):
    path = (str(REPO / which) if which != "tiny"
            else _yaml(tmp_path, "tiny.yaml", TINY_F1))
    cfg = config.load_config(path)
    assert cfg == jconfig.load_config(path)
    spec = config.instantiate_from_config(cfg["model"], dtype=torch.float32)
    jspec = jconfig.instantiate_from_config(cfg["model"], dtype=jnp.float32)
    assert isinstance(spec, builders.ModelSpec)
    assert spec.unet_def.cls is UNetModel
    assert_same_def(spec.unet_def, jspec.unet_def)
    assert_same_def(spec.vae_def, jspec.vae_def)
    assert spec.clip_def.kwargs["max_length"] == jspec.clip_def.max_length
    for field in ("scale_factor", "conditioning_key", "schedule_args",
                  "ckpt_path", "raw"):
        assert getattr(spec, field) == getattr(jspec, field), field
    assert_same_schedule(spec.schedule(), jspec.schedule())
    if which != "tiny":
        # the SD-1.4 geometry, schedule and scale factor of build_chain
        k = spec.unet_def.kwargs
        assert (k["model_channels"], k["channel_mult"], k["context_dim"],
                k["use_adapter"], k["fused_norm_silu"]) == (
            320, (1, 2, 4, 4), 768, True, True)
        assert spec.scale_factor == 0.18215
        assert_same_schedule(spec.schedule(), builders.sd14_schedule())
        sched = config.instantiate_from_config(
            cfg["model"]["params"]["scheduler_config"])
        jsched = jconfig.instantiate_from_config(
            cfg["model"]["params"]["scheduler_config"])
        for step in (0, 5000, 10000, 20000):
            assert sched(step) == pytest.approx(float(jsched(step)),
                                                rel=1e-6)


def test_control_ldm_config_matches_jax(tmp_path, monkeypatch):
    path = _yaml(tmp_path, "cldm.yaml", TINY_CLDM)
    cfg = config.load_config(path)
    spec = config.instantiate_from_config(cfg["model"], dtype=torch.float32)
    jspec = jconfig.instantiate_from_config(cfg["model"], dtype=jnp.float32)
    assert isinstance(spec, builders.ControlSpec)
    assert not spec.unet_def.kwargs["use_adapter"]
    assert_same_def(spec.unet_def, jspec.unet_def)
    assert_same_def(spec.cn_def, jspec.cn_def)
    assert_same_def(spec.vae_def, jspec.vae_def)
    assert spec.clip_def is None and jspec.clip_def is None
    for field in ("scale_factor", "only_mid_control", "schedule_args",
                  "ckpt_path", "raw"):
        assert getattr(spec, field) == getattr(jspec, field), field
    assert_same_schedule(spec.schedule(), jspec.schedule())
    # no cond stage: the loader's SD CLIP, made tiny here
    monkeypatch.setattr(loader, "sd_clip", lambda dtype, device: (
        CLIPTextEncoder(**CLIP_TINY, dtype=dtype, device=device)))
    cldm = spec.load(None, device="cpu")
    assert cldm.only_mid_control and cldm.control is not None


def test_config_reads_floats_and_overrides_as_jax():
    text = "lr: 5e-5\nb: 1E8\nc: 1.0e-05\nd: .5\ne: 3\nf: [1e-4]\n"
    assert config._yaml_load(text) == jconfig._yaml_load(text)
    assert isinstance(config._yaml_load(text)["lr"], float)
    base = {"model": {"params": {"a": 1, "b": {"c": 2}}}}
    over = {"model": {"params": {"b": {"d": 3}}}}
    assert config.merge_configs(base, over) == jconfig.merge_configs(base,
                                                                     over)
    dots = ["model.params.a=5e-5", "model.new.x=[1, 2]"]
    assert (config.apply_dot_overrides(base, dots)
            == jconfig.apply_dot_overrides(base, dots))
    with pytest.raises(ValueError, match="key=value"):
        config.apply_dot_overrides(base, ["novalue"])


@pytest.mark.parametrize("target,item", [
    ("ldm.data.semantic.load_data", 13),
    ("main.DataModuleFromConfig", 13),
    ("main.ImageLogger", 13)])
def test_unported_targets_raise(target, item, tmp_path):
    """The training targets of ROADMAP Queue A item ``item`` resolve as the
    JAX package's: the dataset (a missing directory raises in both), the
    data module's params dict and the image logger's factory."""
    params = {"ldm.data.semantic.load_data": {
                  "dataset_mode": "coco", "data_dir": str(tmp_path / "none"),
                  "image_size": 32},
              "main.DataModuleFromConfig": {"batch_size": 8, "wrap": True},
              "main.ImageLogger": {"batch_frequency": 7,
                                   "max_images": 3}}[target]
    spec = {"target": target, "params": params}
    if target == "ldm.data.semantic.load_data":
        for cfg in (config, jconfig):
            with pytest.raises(FileNotFoundError):
                cfg.instantiate_from_config(spec)
        return
    got = config.instantiate_from_config(spec)
    want = jconfig.instantiate_from_config(spec)
    if target == "main.ImageLogger":
        got, want = got(str(tmp_path / "a")), want(str(tmp_path / "b"))
        assert (got.freq, got.max_images) == (want.freq, want.max_images)
        assert os.path.relpath(got.dir, tmp_path / "a") == os.path.relpath(
            want.dir, tmp_path / "b")
    else:
        assert got == want == params


def test_targets_resolve_like_jax():
    assert set(config.TARGET_ALIASES) == set(jconfig.TARGET_ALIASES)
    assert config.instantiate_from_config("__is_unconditional__") is None
    ident = config.instantiate_from_config({"target": "torch.nn.Identity"})
    assert ident(3) == 3
    obj = config.instantiate_from_config(
        {"target": "fgdm_tpu_torch.builders.build_clip",
         "params": {"max_length": 16}})
    assert obj.kwargs["max_length"] == 16
    with pytest.raises(KeyError, match="target"):
        config.instantiate_from_config({"params": {}})
    with pytest.raises(NotImplementedError, match="num_classes"):
        builders.build_unet_from_config(num_classes=10)


def test_config_module_imports_yaml_only_when_called():
    import subprocess
    import sys

    code = ("import sys; import fgdm_tpu_torch.config; "
            "assert 'yaml' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.stdout.strip() == "ok", out.stderr
