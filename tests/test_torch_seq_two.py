"""The joint two-factor UNet (``SeqTwoUNet``) and its co-denoising sampler
held against the JAX package, on the CPU.

Tiny geometries of ``tests/test_seq_two.py`` (float32, 16^2 latents of
4 + 4 channels).  Flax params of each variant (concat input,
``image_adapter``, ``use_control``) are seeded values on the tree of its
init traced on shapes alone (``loader._abstract_init``); they go into the
port through ``convert.seq_two_state_dict`` with ``load_state_dict(
strict=True)``.  Torch cannot draw ``jax.random``'s bits, so the sampler
comparison injects the same numpy x_T into both packages' ``ddim_sample``.

Tolerances: a forward max |port - jax| <= 1e-4 * max(1, max |jax|)
(float32 on both sides, two UNets and sums in another order); the same for
4 DDIM steps of ``joint_denoise_fn`` at CFG 1.0 and 7.5.  The bypassed
eps of ``cond_map`` is exactly 0.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.core.schedules import DDIMSchedule as JDDIMSchedule  # noqa: E402
from fgdm_tpu.core.schedules import (  # noqa: E402
    DiffusionSchedule as JDiffusionSchedule)
from fgdm_tpu.models.seq_two_unet import SeqTwoUNet as JSeqTwoUNet  # noqa: E402
from fgdm_tpu.models.seq_two_unet import (  # noqa: E402
    joint_denoise_fn as j_joint_denoise_fn)
from fgdm_tpu.sampling.ddim import ddim_sample as j_ddim_sample  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.core.schedules import (DDIMSchedule,  # noqa: E402
                                           DiffusionSchedule)
from fgdm_tpu_torch.models.seq_two_unet import (SeqTwoUNet,  # noqa: E402
                                                joint_denoise_fn)
from fgdm_tpu_torch.sampling.ddim import ddim_sample  # noqa: E402

torch.set_num_threads(2)

TINY = dict(model_channels=32, num_heads=4, context_dim=64,
            channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_res_blocks=1)
TOL = 1e-4
HW = 16
VARIANTS = {"concat": {}, "image_adapter": {"image_adapter": True},
            "use_control": {"use_control": True}}


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


def seeded_tree(module, seed):
    """Flax params of ``module`` with seeded values: kernels N(0, 1/fan_in),
    norm scales 1 and biases 0, each plus 0.02 N(0, 1) (so zero-init heads
    work), on the shapes of its init."""
    tree = jloader._abstract_init(module, jnp.zeros((1, HW, HW, 8)),
                                  jnp.zeros((1,), jnp.int32),
                                  jnp.zeros((1, 77, 64)))
    rng = np.random.default_rng(seed)

    def fill(path, a):
        shape, leaf = a.shape, path[-1].key
        base = np.ones(shape) if leaf == "scale" else np.zeros(shape)
        if leaf == "kernel":
            base = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, tree)


@pytest.fixture(scope="module")
def pair(request):
    """``(name, flax def, flax params, port model)`` on the same weights."""
    kw = VARIANTS[request.param]
    jdef = JSeqTwoUNet(**TINY, factor_channels=4, mapped_channels=4,
                       dtype=jnp.float32, **kw)
    params = seeded_tree(jdef, 30 + len(request.param))
    model = SeqTwoUNet(**TINY, factor_channels=4, mapped_channels=4,
                       dtype=torch.float32, device="cpu", **kw)
    model.load_state_dict(convert.seq_two_state_dict(params), strict=True)
    return request.param, jdef, params, model.eval()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(31)
    return dict(x=rng.standard_normal((2, HW, HW, 8)).astype(np.float32),
                t=np.array([100, 733]),
                ctx=(0.5 * rng.standard_normal((2, 77, 64))).astype(
                    np.float32),
                cmap=rng.uniform(-1, 1, (2, HW, HW, 4)).astype(np.float32))


def control_residuals(seed):
    """The 5 ControlNet residuals the tiny UNet takes (4 input blocks and
    the middle), NHWC."""
    rng = np.random.default_rng(seed)
    shapes = [(HW, 32), (HW, 32), (HW // 2, 32), (HW // 2, 64),
              (HW // 2, 64)]
    return [(0.3 * rng.standard_normal((2, s, s, c))).astype(np.float32)
            for s, c in shapes]


@pytest.mark.parametrize("pair", list(VARIANTS), indirect=True)
def test_children_and_trainable_names(pair):
    name, _, params, model = pair
    assert [n for n, _ in model.named_children()] == [
        "unet2", "unet1", "channel_mapper"]
    assert model.channel_mapper.weight.shape == (4, 4, 1, 1)
    assert model.channel_mapper.bias is None
    assert (model.unet1.adapter is not None) == (name == "image_adapter")
    assert model.unet2.adapter is None
    assert model.unet1.in_channels == (4 if name == "image_adapter" else 8)
    # the JAX package builds both UNets without the fused GroupNorm+SiLU
    assert not any(m.fused_norm for m in model.modules()
                   if hasattr(m, "fused_norm"))
    assert set(convert.seq_two_state_dict(params)) == set(model.state_dict())


@pytest.mark.parametrize("pair", list(VARIANTS), indirect=True)
@pytest.mark.parametrize("bypass", [False, True])
def test_forward_matches_jax(pair, inputs, bypass):
    name, jdef, params, model = pair
    kw, tkw = {}, {}
    if bypass:
        kw["cond_map"] = jnp.asarray(inputs["cmap"])
        tkw["cond_map"] = nchw(inputs["cmap"])
    if name == "use_control":
        res = control_residuals(32)
        kw["control"] = [jnp.asarray(r) for r in res]
        tkw["control"] = [nchw(r) for r in res]
    ref = jdef.apply(params, jnp.asarray(inputs["x"]),
                     jnp.asarray(inputs["t"]), jnp.asarray(inputs["ctx"]),
                     **kw)
    with torch.no_grad():
        out = model(nchw(inputs["x"]), torch.from_numpy(inputs["t"]),
                    context=torch.from_numpy(inputs["ctx"]), **tkw)
    assert out.dtype == torch.float32
    assert_close(nhwc(out), ref)
    if bypass:
        assert torch.count_nonzero(out[:, 4:]) == 0
        assert np.count_nonzero(np.asarray(ref)[..., 4:]) == 0
    else:
        assert np.abs(np.asarray(ref)[..., 4:]).max() > 0


@pytest.mark.parametrize("pair", ["use_control"], indirect=True)
def test_control_reaches_unet2(pair, inputs):
    _, _, _, model = pair
    x, t = nchw(inputs["x"]), torch.from_numpy(inputs["t"])
    ctx = torch.from_numpy(inputs["ctx"])
    with torch.no_grad():
        plain = model(x, t, context=ctx)
        ctrl = model(x, t, context=ctx,
                     control=[nchw(r) for r in control_residuals(33)])
    assert (plain - ctrl)[:, 4:].abs().max() > 0


@pytest.mark.parametrize("pair", ["concat", "image_adapter"],
                         indirect=True)
@pytest.mark.parametrize("cfg", [1.0, 7.5])
def test_joint_denoise_fn_ddim_matches_jax(pair, inputs, cfg):
    """Both factors co-denoise under each package's DDIM scan: 4 steps on
    the same x_T and contexts."""
    _, jdef, params, model = pair
    rng = np.random.default_rng(34)
    x_T = rng.standard_normal((2, HW, HW, 8)).astype(np.float32)
    ctx, uc = inputs["ctx"], np.zeros_like(inputs["ctx"])
    sched_kw = dict(linear_start=0.00085, linear_end=0.0120)
    jd = JDDIMSchedule.create(
        JDiffusionSchedule.create(1000, "linear", **sched_kw), 4)
    td = DDIMSchedule.create(
        DiffusionSchedule.create(1000, "linear", **sched_kw), 4)
    ref, _ = j_ddim_sample(
        j_joint_denoise_fn(jdef, params), jax.random.PRNGKey(0),
        x_T.shape, jd, {"c_crossattn": jnp.asarray(ctx)},
        uncond={"c_crossattn": jnp.asarray(uc)}, cfg_scale=cfg,
        x_T=jnp.asarray(x_T))
    with torch.no_grad():
        out = ddim_sample(joint_denoise_fn(model), (2, 8, HW, HW), td,
                          {"c_crossattn": torch.from_numpy(ctx)},
                          uncond={"c_crossattn": torch.from_numpy(uc)},
                          cfg_scale=cfg, x_T=nchw(x_T), device="cpu")
    assert torch.isfinite(out).all()
    assert_close(nhwc(out), ref)
