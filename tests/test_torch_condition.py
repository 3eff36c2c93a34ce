"""The port's condition-target training (``train/condition.py``,
``train_step._encode_target``, ``cli/train.py``'s annotator block) held
against the JAX package on the CPU.

Annotators: DPT-Hybrid at the tests' tiny width (embed 64, 2 layers),
PiDiNet and HED at full width, the port's seeded init read into flax by
JAX's ingest (``tests/test_torch_annotators.py``); the pipeline is
``tests/test_torch_distill.py``'s tiny one (64^2 images, batch 4, 8^2
latents).  JAX's t, noise and posterior eps are rebuilt from its key splits
(``sketch_to_normal``: one eps for each half, from ``split(rng_enc)``) and
injected into the port.

Tolerances: targets max|d| <= 1e-4 * max|ref| + 1e-5 (PiDiNet's binarized
edges may flip only where the sigmoid is within 1e-4 of 0.5); latents the
same; losses 1e-4 relative and adapter gradients max|d| <= 1e-3 * max|ref|
(``tests/test_torch_train.py``'s).
"""

import itertools
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import fgdm_tpu.train.state as jstate  # noqa: E402
from fgdm_tpu import builders as jbuilders  # noqa: E402
from fgdm_tpu.annotators import midas as jmidas  # noqa: E402
from fgdm_tpu.annotators import pidinet as jpidinet  # noqa: E402
from fgdm_tpu.cli import train as jtrain  # noqa: E402
from fgdm_tpu.train import condition as jcondition  # noqa: E402
from fgdm_tpu.train.train_step import _encode_target as j_encode_target  # noqa: E402
from fgdm_tpu.train.train_step import make_eval_step as j_make_eval_step  # noqa: E402
from fgdm_tpu.train.train_step import make_train_step as j_make_train_step  # noqa: E402
from fgdm_tpu_torch.annotators import hed, midas, pidinet  # noqa: E402
from fgdm_tpu_torch.cli import train as ttrain  # noqa: E402
from fgdm_tpu_torch.train import condition  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from fgdm_tpu_torch.train.train_step import (_encode_target,  # noqa: E402
                                             make_eval_step, make_train_step)
from test_torch_annotators import (DPT_TINY, _jax_ingest, _seeded,  # noqa: E402
                                   close, reference_file)
from test_torch_distill import tiny  # noqa: E402,F401
from test_torch_train import (GRAD_TOL, LOSS_RTOL, _capture_grads,  # noqa: E402
                              _jax_grads, jax_draws, nchw, port_batch)
from test_torch_train_run import run_cli, rows, tiny_clip, workspace  # noqa: E402,F401

torch.set_num_threads(2)

KINDS = ("depth", "normal", "sketch", "sketch_hed", "sketch_to_normal")


@pytest.fixture(scope="module")
def nets():
    """{net: (port module, flax def, flax params)} on the same weights."""
    out = {}
    for name, seed in (("midas", 80), ("pidinet", 81), ("hed", 82)):
        module, jdef = _seeded(name, seed)
        if name == "pidinet":   # the shipped, thresholding net
            shipped = pidinet.PiDiNet(device="cpu")
            shipped.load_state_dict(module.state_dict())
            module, jdef = shipped.eval(), jpidinet.PiDiNet()
        tree = _jax_ingest(name, jdef, {k: v.numpy() for k, v in
                                        module.state_dict().items()})
        out[name] = (module.requires_grad_(False), jdef, tree)
    return out


def synths(kind, nets):
    """The port's and JAX's ``ConditionSynth`` for ``kind``."""
    first = {"sketch": "pidinet", "sketch_hed": "hed"}.get(kind, "midas")
    m, jdef, tree = nets[first]
    m2, jdef2, tree2 = (nets["pidinet"] if kind == "sketch_to_normal"
                        else (None, None, None))
    return (condition.ConditionSynth(kind, m, m2),
            jcondition.ConditionSynth(kind=kind, model_def=jdef, params=tree,
                                      model_def2=jdef2, params2=tree2))


def _threshold_ok(got, ref, img, nets):
    """PiDiNet's edges agree but where its sigmoid sits within 1e-4 of the
    threshold (JAX's unthresholded map decides)."""
    _, _, tree = nets["pidinet"]
    soft = np.asarray(jax.jit(jpidinet.PiDiNet(binarize=False).apply)(
        tree, jnp.asarray(img)))
    flips = got != ref
    assert set(np.unique(got)) <= {-1.0, 1.0}
    assert np.all(np.abs(soft[flips]) / 2 < 1e-4)


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(83)
    return rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)


# --- the kinds and the targets ----------------------------------------------

@pytest.mark.parametrize("flags", list(itertools.product([False, True],
                                                         repeat=5)))
def test_condition_kind_matches_jax(flags):
    names = ("use_depth", "use_normal", "use_sketch", "use_hed",
             "sketch_to_normal")
    kw = dict(zip(names, flags))
    assert condition.condition_kind(**kw) == jcondition.condition_kind(**kw)


@pytest.mark.parametrize("kind", KINDS)
def test_target_matches_jax(kind, nets, image):
    port, jsynth = synths(kind, nets)
    got = port.target(torch.from_numpy(image.transpose(0, 3, 1, 2).copy()))
    assert not got.requires_grad
    got = got.numpy().transpose(0, 2, 3, 1)
    ref = np.asarray(jax.jit(lambda s, x: s.target(x))(jsynth,
                                                       jnp.asarray(image)))
    assert got.shape == ref.shape == (2, 64, 64,
                                      6 if kind == "sketch_to_normal" else 3)
    assert got.min() >= -1 - 1e-6 and got.max() <= 1 + 1e-6
    if kind in ("sketch", "sketch_to_normal"):
        _threshold_ok(got[..., -3:], ref[..., -3:], image, nets)
        got, ref = got[..., :-3], ref[..., :-3]
    if got.size:
        close(got, ref)
    if kind == "depth":
        np.testing.assert_array_equal(got[..., 0], got[..., 2])
        assert got.min() == pytest.approx(-1, abs=1e-5)
        assert got.max() == pytest.approx(1, abs=1e-5)
    if kind in ("normal", "sketch_to_normal"):
        np.testing.assert_allclose(np.linalg.norm(got[..., :3], axis=-1),
                                   1.0, atol=1e-5)


def test_build_condition_synth(nets, monkeypatch):
    tdpt = midas.DPTHybrid
    monkeypatch.setattr(midas, "DPTHybrid",
                        lambda **kw: tdpt(**DPT_TINY, **kw))
    gen = torch.Generator().manual_seed(84)
    synth = condition.build_condition_synth("sketch", generator=gen,
                                            device="cpu")
    assert isinstance(synth.model, pidinet.PiDiNet) and synth.model2 is None
    assert not synth.model.training
    assert not any(p.requires_grad for p in synth.model.parameters())
    tgt = synth.target(torch.rand(2, 3, 32, 32) * 2 - 1)
    assert tgt.shape == (2, 3, 32, 32)
    assert set(torch.unique(tgt).tolist()) <= {-1.0, 1.0}
    s2n = condition.build_condition_synth("sketch_to_normal", generator=gen,
                                          device="cpu")
    assert isinstance(s2n.model, tdpt)
    assert isinstance(s2n.model2, pidinet.PiDiNet)
    hed_synth = condition.build_condition_synth(
        "sketch_hed", state_dict=nets["hed"][0].state_dict(), device="cpu")
    assert isinstance(hed_synth.model, hed.ControlNetHED)
    assert hed_synth.load_report == {"model": ([], [])}
    with pytest.raises(ValueError, match="unknown condition kind"):
        condition.build_condition_synth("canny", generator=gen, device="cpu")
    with pytest.raises(ValueError, match="needs the weights"):
        condition.build_condition_synth("sketch", device="cpu")
    with pytest.raises(ValueError, match="sketch net"):
        condition.build_condition_synth(
            "sketch_to_normal", device="cpu",
            state_dict=midas.DPTHybrid(device="cpu").state_dict())


def test_encode_target_sketch_to_normal_matches_jax(tiny, nets):
    """The 6-channel target split into (normal, sketch), each encoded with
    its own eps, the latents concatenated to 8 channels."""
    port, jsynth = synths("sketch_to_normal", nets)
    img = tiny["batch"]["image"][:2]
    key = jax.random.PRNGKey(85)
    ref = np.asarray(jax.jit(j_encode_target)(
        tiny["jld"], {"image": jnp.asarray(img)}, jsynth, key))
    r1, r2 = jax.random.split(key)
    eps = tuple(nchw(np.asarray(jax.random.normal(r, (2, 8, 8, 4))))
                for r in (r1, r2))
    got = _encode_target(tiny["ld"], {"image": nchw(img)}, port,
                         posterior_eps=eps)
    assert got.shape == (2, 8, 8, 8) and ref.shape == (2, 8, 8, 8)
    close(got.numpy().transpose(0, 2, 3, 1), ref)
    # without a condition, and without eps: the posterior mode
    plain = _encode_target(tiny["ld"], {"image": nchw(img)}, None)
    torch.testing.assert_close(plain, tiny["ld"].encode_first_stage(
        nchw(img)))


@pytest.fixture(scope="module", params=["normal", "sketch"])
def cond_step(request, tiny, nets):
    """One JAX ``make_train_step(condition=...)`` step (SGD(1.0): the update
    is the gradient) and the port's on the same weights, batch and draws."""
    kind = request.param
    port, jsynth = synths(kind, nets)
    jld, batch = tiny["jld"], tiny["batch"]
    js = jstate.TrainState.create(jld.unet_params, optax.sgd(1.0),
                                  trainable_filter=jstate.adapter_filter())
    before = jax.tree.map(np.asarray, js)
    key = jax.random.PRNGKey(86)
    js2, jmetrics = j_make_train_step(jld, condition=jsynth)(
        js, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ld = tiny["ld"]
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(1e-3),
                                     trainable_filter=tstate.adapter_filter())
    grads = _capture_grads(state)
    params0 = {k: p.detach().clone() for k, p in state.params.items()}
    frozen0 = {k: p.detach().clone() for k, p in state.frozen.items()}
    ann0 = {k: v.clone() for k, v in port.model.state_dict().items()}
    t, noise, eps = jax_draws(key, 4, (4, 8, 8, 4))
    state, metrics = make_train_step(ld, condition=port)(
        state, port_batch(batch), torch.Generator().manual_seed(0),
        t=torch.from_numpy(t).long(), noise=nchw(noise),
        posterior_eps=nchw(eps))
    frozen_same = all(torch.equal(p, frozen0[k])
                      for k, p in state.frozen.items())
    ann_same = all(torch.equal(v, ann0[k])
                   for k, v in port.model.state_dict().items())
    with torch.no_grad():   # the module fixture's weights stay as they were
        for k, p in state.params.items():
            p.copy_(params0[k])
    return dict(jmetrics=jmetrics, jgrads=_jax_grads(before, js2),
                metrics=metrics, grads=grads, frozen_same=frozen_same,
                ann_same=ann_same)


@pytest.mark.parametrize("key", ["loss", "loss_simple", "loss_vlb",
                                 "grad_norm"])
def test_condition_train_step_metrics_match_jax(cond_step, key):
    np.testing.assert_allclose(float(cond_step["metrics"][key]),
                               float(cond_step["jmetrics"][key]),
                               rtol=LOSS_RTOL)


def test_condition_train_step_adapter_grads_match_jax(cond_step):
    grads, jgrads = cond_step["grads"], cond_step["jgrads"]
    assert set(grads) == set(jgrads) and grads
    scale = max(np.abs(g).max() for g in map(np.asarray, jgrads.values()))
    assert scale > 0
    err = max(np.abs(grads[k].numpy() - jgrads[k].numpy()).max()
              for k in grads)
    assert err <= GRAD_TOL * scale, (err, scale)
    assert cond_step["frozen_same"] and cond_step["ann_same"]


def test_condition_eval_step_matches_jax(tiny, nets):
    port, jsynth = synths("sketch_hed", nets)
    jld, batch = tiny["jld"], tiny["batch"]
    js = jstate.TrainState.create(jld.unet_params, optax.sgd(1.0),
                                  trainable_filter=jstate.adapter_filter())
    key = jax.random.PRNGKey(87)
    ref = j_make_eval_step(jld, condition=jsynth)(
        js, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ld = tiny["ld"]
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(1e-3),
                                     trainable_filter=tstate.adapter_filter())
    t, noise, eps = jax_draws(key, 4, (4, 8, 8, 4))
    got = make_eval_step(ld, condition=port)(
        state, port_batch(batch), torch.Generator().manual_seed(0),
        t=torch.from_numpy(t).long(), noise=nchw(noise),
        posterior_eps=nchw(eps))
    assert set(got) == {k for k in ref if not k.endswith("_ema")}
    for k, v in got.items():
        np.testing.assert_allclose(float(v), float(ref[k]), rtol=LOSS_RTOL)


def test_condition_distill_step_runs(tiny, nets):
    port, _ = synths("normal", nets)
    ld = tiny["ld"]
    state = tstate.TrainState.create(ld.unet, tstate.make_adamw(0.0),
                                     trainable_filter=tstate.adapter_filter())
    _, metrics = make_train_step(ld, distill=True, condition=port)(
        state, port_batch(tiny["batch"]), torch.Generator().manual_seed(1))
    assert np.isfinite(float(metrics["loss_distill"]))
    assert np.isfinite(float(metrics["loss"]))


# --- the training CLI -----------------------------------------------------------

def test_cli_trains_a_sketch_config_on_a_seeded_annotator(workspace,
                                                          monkeypatch,
                                                          capsys, tmp_path):
    root, cfg_path = workspace
    monkeypatch.setenv("FGDM_ANNOTATOR_DIR", str(tmp_path))
    monkeypatch.setenv("FGDM_ALLOW_RANDOM_ANNOTATORS", "1")
    run = run_cli(cfg_path, root / "sketch", "-t", "--max_steps", "2",
                  "--no-test", "model.params.use_sketch=true")
    out = capsys.readouterr().out
    assert "sketch annotator random-init" in out
    assert "condition synthesis: sketch" in out
    steps = [r for r in rows(run) if "train/loss" in r]
    assert [r["step"] for r in steps] == [0, 1]
    assert all(np.isfinite(r["train/loss"]) for r in steps)


def test_cli_reads_the_annotator_checkpoint(workspace, monkeypatch, capsys,
                                            tmp_path, nets):
    root, cfg_path = workspace
    path = reference_file("pidinet", nets["pidinet"][0],
                          tmp_path / "table5_pidinet.pth")
    monkeypatch.setenv("FGDM_ANNOTATOR_DIR", str(tmp_path))
    monkeypatch.delenv("FGDM_ALLOW_RANDOM_ANNOTATORS", raising=False)
    run_cli(cfg_path, root / "sketch_file", "-t", "--max_steps", "1",
            "--no-test", "model.params.use_sketch=true")
    out = capsys.readouterr().out
    assert f"annotator {path}: missing=0 unexpected=0" in out
    assert "random-init" not in out


def test_cli_without_an_annotator_exits_as_jax(workspace, monkeypatch,
                                               tmp_path):
    """No checkpoint and no FGDM_ALLOW_RANDOM_ANNOTATORS: both CLIs exit
    with the same text (JAX's stopped short of its flax init)."""
    root, cfg_path = workspace
    monkeypatch.setenv("FGDM_ANNOTATOR_DIR", str(tmp_path))
    monkeypatch.delenv("FGDM_ALLOW_RANDOM_ANNOTATORS", raising=False)
    monkeypatch.delenv("FGDM_RANDOMIZE_ZERO_HEADS")
    monkeypatch.setenv("FGDM_CACHE_DIR", "off")
    monkeypatch.setattr(jbuilders.ModelSpec, "create",
                        lambda self, rng, **kw: None)
    over = ["model.params.use_depth=true", "model.params.use_normal=true"]
    with pytest.raises(SystemExit) as ref:
        jtrain.main(["-b", str(cfg_path), "-l", str(root / "jexit"), "-t",
                     *over])
    with pytest.raises(SystemExit) as got:
        run_cli(cfg_path, root / "exit", "-t", *over)
    assert str(got.value) == str(ref.value)
    assert "'normal' annotator" in str(got.value)
    assert "FGDM_ALLOW_RANDOM_ANNOTATORS=1" in str(got.value)


def test_jax_cli_loader_keeps_the_released_pos_embed(nets, tmp_path,
                                                     monkeypatch):
    """ROADMAP Queue C (a JAX fault, recorded): JAX's ``cli/train.py
    _load_annotator_params`` calls ``ingest_midas(sd)`` without ``expect``,
    so a released file's 577-token table reaches a ``DPTHybrid`` built for
    256^2 (257 tokens) and flax refuses it.  The port resizes in the
    forward and runs (``build_condition_synth`` reads the same file).
    Widths are the tests' tiny ones (``DPTHybrid`` patched), the file is
    in the reference's schema."""
    from flax.errors import ScopeParamShapeError

    module = nets["midas"][0]
    reference_file("midas", module, tmp_path / "dpt_hybrid-midas-501f0c75.pt")
    params = jtrain._load_annotator_params("depth", str(tmp_path))
    assert params["params"]["pos_embed"].shape == (1, 577, 64)
    jdpt, tdpt = jmidas.DPTHybrid, midas.DPTHybrid
    monkeypatch.setattr(jmidas, "DPTHybrid",
                        lambda **kw: jdpt(**DPT_TINY, **kw))
    jsynth = jcondition.build_condition_synth(
        "depth", params=jax.tree.map(jnp.asarray, params), image_size=256)
    img = np.random.default_rng(88).uniform(-1, 1, (1, 256, 256, 3)).astype(
        np.float32)
    with pytest.raises(ScopeParamShapeError, match="pos_embed"):
        jsynth.target(jnp.asarray(img))
    found = ttrain._load_annotator_params("depth", str(tmp_path))
    monkeypatch.setattr(midas, "DPTHybrid",
                        lambda **kw: tdpt(**DPT_TINY, **kw))
    synth = condition.build_condition_synth("depth", state_dict=found[1],
                                            device="cpu")
    assert synth.load_report == {"model": ([], [])}
    tgt = synth.target(torch.from_numpy(img.transpose(0, 3, 1, 2).copy()))
    assert tgt.shape == (1, 3, 256, 256) and bool(torch.isfinite(tgt).all())
    assert os.path.basename(found[0]) == "dpt_hybrid-midas-501f0c75.pt"
