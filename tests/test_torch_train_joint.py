"""Joint two-factor (AdaptDiffusion) training (``train/joint.py``) held
against the JAX package, on the CPU.

Tiny geometries of ``tests/test_train_joint.py`` (float32, 16^2 latents of
4 + 4 channels, ``SeqTwoUNet(image_adapter=True)``); seeded flax params go
into the port through ``convert.seq_two_state_dict`` with
``load_state_dict(strict=True)`` (``tests/test_torch_seq_two.py``).  The
trainable set of ``joint_image_adapter_filter`` is held against JAX's
``partition_params`` mapped through ``convert``'s path rules.  One JAX
``make_joint_train_step`` step runs under SGD(1.0), so its update is the
gradient; the port's step takes the t and noise JAX draws from its key
splits (``train/joint.py:62-65``).

Tolerances (float32): metrics 1e-4 relative; the adapter's and the channel
mapper's gradients max|d| <= 1e-3 * max|ref|.  The frozen backbones hold
bit for bit.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import traverse_util  # noqa: E402

import fgdm_tpu.core.schedules as jsch  # noqa: E402
import fgdm_tpu.train.state as jstate  # noqa: E402
from fgdm_tpu.models.seq_two_unet import SeqTwoUNet as JSeqTwoUNet  # noqa: E402
from fgdm_tpu.train.joint import (  # noqa: E402
    make_joint_train_step as j_make_joint_train_step)
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.core.schedules import DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.models.seq_two_unet import SeqTwoUNet  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from fgdm_tpu_torch.train.joint import make_joint_train_step  # noqa: E402
from test_torch_seq_two import HW, TINY, nchw, seeded_tree  # noqa: E402
from test_torch_train import _capture_grads  # noqa: E402

torch.set_num_threads(2)

SCHED = dict(linear_start=0.00085, linear_end=0.0120)
LOSS_RTOL = 1e-4
GRAD_TOL = 1e-3


@pytest.fixture(scope="module")
def joint():
    jdef = JSeqTwoUNet(**TINY, factor_channels=4, mapped_channels=4,
                       image_adapter=True, dtype=jnp.float32)
    params = seeded_tree(jdef, 50)

    def port():
        model = SeqTwoUNet(**TINY, factor_channels=4, mapped_channels=4,
                           image_adapter=True, dtype=torch.float32,
                           device="cpu")
        model.load_state_dict(convert.seq_two_state_dict(params),
                              strict=True)
        return model.eval()

    rng = np.random.default_rng(51)
    batch = dict(latent=rng.standard_normal((4, HW, HW, 8)).astype(
                     np.float32),
                 context=(0.02 * rng.standard_normal((4, 77, 64))).astype(
                     np.float32))
    return dict(jdef=jdef, params=params, port=port, batch=batch)


def torch_names(flat):
    """JAX ``partition_params`` keys (``params/unet1/...``) -> the port's
    ``SeqTwoUNet`` names, values kept."""
    tree = traverse_util.unflatten_dict(flat, sep="/")
    return convert.seq_two_state_dict(tree)


def test_filter_matches_jax(joint):
    jtrain, jfrozen = jstate.partition_params(
        joint["params"], jstate.joint_image_adapter_filter())
    state = tstate.TrainState.create(
        joint["port"](), tstate.make_adamw(1e-3),
        trainable_filter=tstate.joint_image_adapter_filter())
    assert set(state.params) == set(torch_names(jtrain))
    assert set(state.frozen) == set(torch_names(jfrozen))
    assert {k.split(".")[0] + "." + k.split(".")[1] if k.startswith("unet1")
            else k.split(".")[0] for k in state.params} == {
        "unet1.adapter", "channel_mapper"}
    n_train = sum(p.numel() for p in state.params.values())
    n_frozen = sum(p.numel() for p in state.frozen.values())
    assert 0 < n_train < n_frozen


@pytest.fixture(scope="module", params=[0.0, 0.3], ids=["simple", "elbo"])
def one_step(joint, request):
    elbo = request.param
    batch = joint["batch"]
    jsched = jsch.DiffusionSchedule.create(1000, "linear", **SCHED)
    jst = jstate.TrainState.create(
        joint["params"], optax.sgd(1.0),
        trainable_filter=jstate.joint_image_adapter_filter())
    before = jax.tree.map(np.asarray, jst)
    key = jax.random.PRNGKey(52)
    jst2, jmetrics = j_make_joint_train_step(
        joint["jdef"], jsched, l_simple_weight=0.9,
        original_elbo_weight=elbo)(
        jst, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    jgrads = torch_names({k: np.asarray(before.params[k])
                          - np.asarray(jst2.params[k])
                          for k in before.params})
    rng_t, rng_n = jax.random.split(key)
    t = np.array(jax.random.randint(rng_t, (4,), 0, 1000))
    noise = np.array(jax.random.normal(rng_n, (4, HW, HW, 4), jnp.float32))

    model = joint["port"]()
    state = tstate.TrainState.create(
        model, tstate.make_adamw(1e-3),
        trainable_filter=tstate.joint_image_adapter_filter())
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    grads = _capture_grads(state)
    state, metrics = make_joint_train_step(
        model, DiffusionSchedule.create(1000, "linear", **SCHED),
        l_simple_weight=0.9, original_elbo_weight=elbo)(
        state, {"latent": nchw(batch["latent"]),
                "context": torch.from_numpy(batch["context"])},
        torch.Generator().manual_seed(0), t=torch.from_numpy(t).long(),
        noise=nchw(noise))
    return dict(elbo=elbo, jmetrics=jmetrics, jgrads=jgrads, state=state,
                metrics=metrics, grads=grads, frozen0=frozen0,
                params0=params0)


def test_joint_step_metrics_match_jax(one_step):
    metrics, jmetrics = one_step["metrics"], one_step["jmetrics"]
    keys = {"train/loss_simple", "train/loss", "grad_norm"}
    if one_step["elbo"] > 0:
        keys.add("train/loss_vlb")
    assert set(metrics) == set(jmetrics) == keys
    for k in keys:
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_joint_step_grads_match_jax(one_step):
    grads, jgrads = one_step["grads"], one_step["jgrads"]
    assert set(grads) == set(jgrads) and grads
    assert any(k.startswith("channel_mapper.") for k in grads)
    scale = max(np.abs(g.numpy()).max() for g in jgrads.values())
    assert scale > 0
    err = max(np.abs(grads[k].numpy() - jgrads[k].numpy()).max()
              for k in grads)
    assert err <= GRAD_TOL * scale, (err, scale)


def test_joint_step_keeps_both_backbones(one_step):
    state = one_step["state"]
    assert state.step == 1
    for k, p in state.frozen.items():
        assert not p.requires_grad and p.grad is None
        assert torch.equal(p, one_step["frozen0"][k]), k
    assert any(k.startswith("unet2.") for k in state.frozen)
    moved = max((p - one_step["params0"][k]).abs().max().item()
                for k, p in state.params.items())
    assert moved > 0
