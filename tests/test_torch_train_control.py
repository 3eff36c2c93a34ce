"""ControlNet fine-tuning (``train/control.py``) held against the JAX
package, on the CPU.

Tiny geometries of ``tests/test_train_control.py`` (float32, 64^2 images,
8^2 latents, a ControlNet with 5 residuals).  Flax params are seeded values
on the trees of each module's init traced on shapes alone; they go into the
port through ``checkpoint/convert.py`` with ``load_state_dict(strict=True)``.
The trainable sets of ``control_filter`` are held against JAX's
``partition_params`` mapped through ``convert``'s path rules.  One JAX
``make_control_train_step`` step runs under SGD(1.0), so its update is the
gradient; the port's step takes the t, noise and posterior eps that JAX
draws from its key splits (``tests/test_torch_train.py jax_draws``).

Tolerances (float32 on both sides): metrics 1e-4 relative (``LOSS_RTOL``);
trainable gradients max|d| <= 1e-3 * max|ref| (``GRAD_TOL``: a ControlNet
and a UNet forward and backward).  Frozen tensors hold bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.train.control as jcontrol  # noqa: E402
import fgdm_tpu.train.state as jstate  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.diffusion.control import ControlLDM as JControlLDM  # noqa: E402
from fgdm_tpu.models.autoencoder import (  # noqa: E402
    AutoencoderKL as JAutoencoderKL)
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu.models.controlnet import ControlNet as JControlNet  # noqa: E402
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.core.schedules import DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.diffusion.control import ControlLDM  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from fgdm_tpu_torch.train.control import (control_filter,  # noqa: E402
                                          control_param_tree,
                                          make_control_train_step)
from test_torch_train import _capture_grads, jax_draws, nchw  # noqa: E402

torch.set_num_threads(2)

UNET_TINY = dict(model_channels=32, num_heads=4, context_dim=64,
                 channel_mult=(1, 2), attention_resolutions=(1, 2),
                 num_res_blocks=1, use_adapter=False)
CN_TINY = dict(in_channels=4, model_channels=32, hint_channels=3,
               num_res_blocks=1, attention_resolutions=(1, 2),
               channel_mult=(1, 2), num_heads=4, context_dim=64)
VAE_TINY = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                resolution=64, z_channels=4, embed_dim=4)
CLIP_TINY = dict(vocab_size=128, embed_dim=64, num_layers=2, num_heads=4)
SCHED = dict(linear_start=0.00085, linear_end=0.0120)
SCALES = (1.0,) * 5
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3
F32 = dict(dtype=torch.float32, device="cpu")


def fill(tree, seed):
    """Seeded values on an abstract flax tree: kernels and embeddings
    N(0, 1/fan_in), norm scales 1 and biases 0, each plus 0.02 N(0, 1)
    (so the zero-init heads pass gradients)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        shape, name = a.shape, path[-1].key
        base = np.ones(shape) if name == "scale" else np.zeros(shape)
        if name in ("kernel", "embedding", "position_embedding"):
            base = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        return (base + 0.02 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, tree)


def loaded(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


@pytest.fixture(scope="module")
def tiny():
    """The tiny JAX ControlLDM and a builder of the port's on the same
    weights (a fresh copy each call: a step changes it in place)."""
    jdefs = dict(unet=JUNetModel(**UNET_TINY, dtype=jnp.float32),
                 control=JControlNet(**CN_TINY, dtype=jnp.float32),
                 vae=JAutoencoderKL(**VAE_TINY, dtype=jnp.float32),
                 clip=JCLIPTextEncoder(**CLIP_TINY))
    x, t = jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,), jnp.int32)
    ctx, img = jnp.zeros((1, 77, 64)), jnp.zeros((1, 64, 64, 3))
    p = dict(
        unet=fill(jloader._abstract_init(jdefs["unet"], x, t, ctx), 40),
        control=fill(jloader._abstract_init(jdefs["control"], x, img, t,
                                            ctx), 41),
        vae=fill(jloader._abstract_init(jdefs["vae"], img,
                                        sample_posterior=False), 42),
        clip=fill(jloader._abstract_init(jdefs["clip"],
                                         jnp.zeros((1, 77), jnp.int32)), 43))
    jcldm = JControlLDM(
        unet_def=jdefs["unet"], vae_def=jdefs["vae"], clip_def=jdefs["clip"],
        unet_params=p["unet"], vae_params=p["vae"], clip_params=p["clip"],
        schedule=jsch.DiffusionSchedule.create(1000, "linear", **SCHED),
        control_def=jdefs["control"], control_params=p["control"],
        control_scales=SCALES)

    def port():
        return ControlLDM(
            loaded(UNetModel(**UNET_TINY, **F32),
                   convert.unet_state_dict(p["unet"])),
            loaded(AutoencoderKL(**VAE_TINY, **F32),
                   convert.vae_state_dict(p["vae"])).requires_grad_(False),
            DiffusionSchedule.create(1000, "linear", **SCHED),
            clip=loaded(CLIPTextEncoder(**CLIP_TINY, device="cpu"),
                        convert.clip_state_dict(p["clip"])
                        ).requires_grad_(False),
            control=loaded(ControlNet(**CN_TINY, **F32),
                           convert.controlnet_state_dict(p["control"])),
            control_scales=SCALES)

    rng = np.random.default_rng(44)
    batch = dict(image=rng.uniform(-1, 1, (4, 64, 64, 3)).astype(np.float32),
                 hint=rng.uniform(0, 1, (4, 64, 64, 3)).astype(np.float32),
                 input_ids=rng.integers(0, 128, (4, 77)).astype(np.int32))
    return dict(jcldm=jcldm, port=port, batch=batch)


def torch_names(flat):
    """JAX ``partition_params`` keys (``control/params/...``,
    ``unet/params/...``) -> the port's names under ``control_param_tree``,
    through ``convert``'s path rules; values kept."""
    out = {}
    for head, fn in (("control", convert.controlnet_state_dict),
                     ("unet", convert.unet_state_dict)):
        part = {k[len(head) + 1:]: v for k, v in flat.items()
                if k.startswith(head + "/")}
        if part:
            sd = fn(traverse_util.unflatten_dict(part, sep="/"))
            out.update({f"{head}.{k}": v for k, v in sd.items()})
    return out


@pytest.mark.parametrize("sd_locked", [True, False])
def test_trainable_sets_match_jax(tiny, sd_locked):
    jcldm = tiny["jcldm"]
    jtrain, jfrozen = jstate.partition_params(
        jcontrol.control_param_tree(jcldm),
        jcontrol.control_filter(sd_locked=sd_locked))
    state = tstate.TrainState.create(control_param_tree(tiny["port"]()),
                                     tstate.make_adamw(1e-3),
                                     trainable_filter=control_filter(
                                         sd_locked))
    assert set(state.params) == set(torch_names(jtrain))
    assert set(state.frozen) == set(torch_names(jfrozen))
    assert any(k.startswith("unet.") for k in state.params) == (
        not sd_locked)
    # a ResBlock's own out_layers stay frozen: only the top-level head
    assert not any(".out_layers." in k for k in state.params
                   if k.startswith("unet.input_blocks."))


def test_param_tree_holds_control_and_unet_only(tiny):
    cldm = tiny["port"]()
    tree = control_param_tree(cldm)
    assert list(tree) == ["control", "unet"]
    assert tree["control"] is cldm.control and tree["unet"] is cldm.unet
    names = {k.split(".")[0] for k, _ in tree.named_parameters()}
    assert names == {"control", "unet"}


@pytest.fixture(scope="module", params=[True, False],
                ids=["sd_locked", "unlocked"])
def one_step(tiny, request):
    """One JAX step (SGD(1.0)) and the port's on the same weights, batch and
    draws."""
    sd_locked = request.param
    jcldm, batch = tiny["jcldm"], tiny["batch"]
    jst = jstate.TrainState.create(
        jcontrol.control_param_tree(jcldm), optax.sgd(1.0),
        trainable_filter=jcontrol.control_filter(sd_locked=sd_locked))
    before = jax.tree.map(np.asarray, jst)
    key = jax.random.PRNGKey(45)
    jst2, jmetrics = jcontrol.make_control_train_step(jcldm)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jgrads = torch_names({k: np.asarray(before.params[k])
                          - np.asarray(jst2.params[k])
                          for k in before.params})

    cldm = tiny["port"]()
    vae0 = {k: v.clone() for k, v in cldm.vae.state_dict().items()}
    clip0 = {k: v.clone() for k, v in cldm.clip.state_dict().items()}
    state = tstate.TrainState.create(
        control_param_tree(cldm), tstate.make_adamw(1e-3),
        trainable_filter=control_filter(sd_locked))
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    grads = _capture_grads(state)
    t, noise, eps = jax_draws(key, 4, (4, 8, 8, 4))
    tb = {"image": nchw(batch["image"]), "hint": nchw(batch["hint"]),
          "input_ids": torch.from_numpy(batch["input_ids"]).long()}
    state, metrics = make_control_train_step(cldm)(
        state, tb, torch.Generator().manual_seed(0),
        t=torch.from_numpy(t).long(), noise=nchw(noise),
        posterior_eps=nchw(eps))
    return dict(jmetrics=jmetrics, jgrads=jgrads, metrics=metrics,
                grads=grads, state=state, cldm=cldm, vae0=vae0, clip0=clip0,
                frozen0=frozen0, params0=params0)


@pytest.mark.parametrize("key", ["loss", "loss_simple", "loss_vlb",
                                 "grad_norm"])
def test_control_step_metrics_match_jax(one_step, key):
    assert set(one_step["metrics"]) == set(one_step["jmetrics"])
    np.testing.assert_allclose(float(one_step["metrics"][key]),
                               float(one_step["jmetrics"][key]),
                               rtol=LOSS_RTOL)


def test_control_step_grads_match_jax(one_step):
    grads, jgrads = one_step["grads"], one_step["jgrads"]
    assert set(grads) == set(jgrads) and grads
    scale = max(np.abs(g.numpy()).max() for g in jgrads.values())
    assert scale > 0
    err = max(np.abs(grads[k].numpy() - jgrads[k].numpy()).max()
              for k in grads)
    assert err <= GRAD_TOL * scale, (err, scale)


def test_control_step_keeps_the_frozen_parts(one_step):
    state, cldm = one_step["state"], one_step["cldm"]
    assert state.step == 1
    assert all(not p.requires_grad and p.grad is None
               for p in state.frozen.values())
    for k, p in state.frozen.items():
        assert torch.equal(p, one_step["frozen0"][k]), k
    for module, before in ((cldm.vae, one_step["vae0"]),
                           (cldm.clip, one_step["clip0"])):
        for k, v in module.state_dict().items():
            assert torch.equal(v, before[k]), k
    moved = max((p - one_step["params0"][k]).abs().max().item()
                for k, p in state.params.items())
    assert moved > 0


def test_zero_convs_take_the_first_gradient():
    """Seeded init with the UNet's zero-init heads randomized and the
    ControlNet's zero convs at true zero (the recipe's start): the frozen
    UNet passes gradients to the zero convs, and the ControlNet's interior
    gets exactly 0 at the first step (``tools/hw_validate_recipes.py:
    103-105``); once the zero convs moved, the interior gets gradients."""
    gen = torch.Generator().manual_seed(46)
    unet = init_params_(UNetModel(**UNET_TINY, **F32), gen)
    tstate.randomize_zero_heads(unet)
    cldm = ControlLDM(
        unet.eval(), init_params_(AutoencoderKL(**VAE_TINY, **F32), gen)
        .eval().requires_grad_(False),
        DiffusionSchedule.create(1000, "linear", **SCHED),
        clip=init_params_(CLIPTextEncoder(**CLIP_TINY, device="cpu"), gen)
        .eval().requires_grad_(False),
        control=init_params_(ControlNet(**CN_TINY, **F32), gen).eval(),
        control_scales=SCALES)
    zero = {k for k in control_param_tree(cldm).state_dict()
            if k.startswith(("control.zero_convs.",
                             "control.middle_block_out."))}
    assert len(zero) == 2 * len(SCALES)
    assert not any(cldm.control.state_dict()[k[8:]].any() for k in zero)
    state = tstate.TrainState.create(control_param_tree(cldm),
                                     tstate.make_adamw(1e-2),
                                     trainable_filter=control_filter(True))
    grads = _capture_grads(state)
    step = make_control_train_step(cldm)
    rng = np.random.default_rng(47)
    batch = {"image": torch.from_numpy(rng.uniform(
                 -1, 1, (2, 3, 64, 64)).astype(np.float32)),
             "hint": torch.from_numpy(rng.uniform(
                 0, 1, (2, 3, 64, 64)).astype(np.float32)),
             "input_ids": torch.from_numpy(rng.integers(0, 128, (2, 77)))}
    norms = []
    for _ in range(2):
        step(state, batch, gen)
        norms.append({k: g.abs().max().item() for k, g in grads.items()})
    interior = [k for k in norms[0] if k not in zero]
    assert max(norms[0][k] for k in zero) > 0
    assert max(norms[0][k] for k in interior) == 0
    assert max(norms[1][k] for k in interior) > 0
