"""The port's training CLI end to end on the CPU, on the tiny config and
seeded COCO tree of ``tests/test_train_cli.py`` (one-layer CLIP, UNet 32
channels, 32^2 images, batch 4): the run directory of the JAX CLI, the
metric keys, ``-r`` resume (parameters, frozen parameters, optimizer, EMA
and step restored bit for bit), validation, the distillation cadence, the
SIGUSR1 and exception checkpoints, ``--fsdp`` in one process, and the
refusal of a config that synthesises its condition targets with no
annotator checkpoint.  The JAX CLI's own run of two steps
builds the model with flax's init and jit, minutes here, so the JAX CLI is
stopped once it has made its run directory, and that is compared.
"""

import copy
import json
import os
import signal

import numpy as np
import pytest
import yaml
from PIL import Image

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu import builders as jbuilders  # noqa: E402
from fgdm_tpu.models.clip import CLIPTextEncoder as JCLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch import builders  # noqa: E402
from fgdm_tpu_torch.cli import train  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402

torch.set_num_threads(2)

CLIP_TINY = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
STEP_KEYS = {"loss", "loss_simple", "loss_vlb", "grad_norm"}   # JAX's step's
EVAL_KEYS = {f"val/{k}{tag}" for k in ("loss", "loss_simple", "loss_vlb")
             for tag in ("", "_ema")}


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_run")
    data = root / "coco"
    rng = np.random.default_rng(0)
    for split, n in (("train2017", 8), ("val2017", 4)):
        (data / "images" / split).mkdir(parents=True)
        (data / "annotations" / split).mkdir(parents=True)
        anns = []
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (80, 70, 3)).astype(
                np.uint8)).save(data / "images" / split / f"{i:012d}.jpg")
            Image.fromarray(rng.integers(0, 20, (80, 70)).astype(
                np.uint8)).save(data / "annotations" / split
                                / f"{i:012d}.png")
            anns.append({"image_id": i, "caption": f"thing {i}"})
        with open(data / "annotations" / f"captions_{split}.json", "w") as f:
            json.dump({"annotations": anns}, f)

    def ds(split, is_train):
        return {"target": "ldm.data.semantic.load_data",
                "params": {"dataset_mode": "coco", "data_dir": str(data),
                           "image_size": 32, "is_train": is_train}}

    cfg = {
        "model": {
            "base_learning_rate": 1e-4,
            "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
            "params": {
                "image_size": 8, "scale_factor": 0.18215,
                "linear_start": 0.00085, "linear_end": 0.0120,
                "freeze_backbone": True, "use_ema": True,
                "apply_distill_loss": False,
                "scheduler_config": {
                    "target": "ldm.lr_scheduler.LambdaLinearScheduler",
                    "params": {"warm_up_steps": [3], "cycle_lengths": [1e13],
                               "f_start": [0.1], "f_max": [1.0],
                               "f_min": [1.0]}},
                "unet_config": {
                    "target":
                        "ldm.modules.diffusionmodules.openaimodel.UNetModel",
                    "params": {"model_channels": 32, "num_heads": 4,
                               "context_dim": 64, "channel_mult": [1, 2],
                               "attention_resolutions": [1, 2],
                               "num_res_blocks": 1, "use_checkpoint": True}},
                "first_stage_config": {
                    "target": "ldm.models.autoencoder.AutoencoderKL",
                    "params": {"embed_dim": 4, "ddconfig": {
                        "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1,
                        "resolution": 64, "z_channels": 4, "double_z": True,
                        "in_channels": 3, "out_ch": 3,
                        "attn_resolutions": []}}},
                "cond_stage_config": {
                    "target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"},
            },
        },
        "data": {"target": "main.DataModuleFromConfig",
                 "params": {"batch_size": 4, "train": ds("train2017", True),
                            "validation": ds("val2017", False)}},
    }
    cfg_path = root / "tiny.yaml"
    with open(cfg_path, "w") as f:
        yaml.safe_dump(cfg, f)
    return root, cfg_path


@pytest.fixture(autouse=True)
def tiny_clip(monkeypatch):
    monkeypatch.setattr(builders, "build_clip", lambda dtype=torch.bfloat16,
                        **p: builders.ModuleDef(CLIPTextEncoder,
                                                dict(**CLIP_TINY,
                                                     dtype=dtype)))
    monkeypatch.setattr(jbuilders, "build_clip", lambda dtype=jnp.bfloat16,
                        **p: JCLIPTextEncoder(**CLIP_TINY, dtype=dtype))
    monkeypatch.setenv("FGDM_RANDOMIZE_ZERO_HEADS", "1")


def run_cli(cfg_path, logdir, *args, name="run"):
    train.main(["-b", str(cfg_path), "-l", str(logdir), "-n", name,
                "--seed", "7", "--device", "cpu", "--num_workers", "2",
                *args])
    (run,) = list(logdir.iterdir())
    return run


def rows(run):
    return [json.loads(line)
            for line in (run / "metrics.jsonl").read_text().splitlines()]


class _Stop(Exception):
    pass


def test_two_steps_write_the_jax_run_dir_and_metric_keys(workspace,
                                                         monkeypatch):
    """The JAX CLI makes its run directory and config snapshot before it
    builds the model; it is stopped there (its flax init and jit take
    minutes on this CPU) and its metrics file is its ``MetricsWriter``'s."""
    from fgdm_tpu.cli import train as jtrain
    from fgdm_tpu.train.metrics import MetricsWriter as JMetricsWriter

    root, cfg_path = workspace
    over = "model.params.unet_config.params.model_channels=32"
    run = run_cli(cfg_path, root / "two", "-t", "--max_steps", "2",
                  "--no-test", over)

    def stop(*a, **k):
        raise _Stop

    monkeypatch.setattr(jbuilders.ModelSpec, "create", stop)
    with pytest.raises(_Stop):
        jtrain.main(["-b", str(cfg_path), "-t", "-l", str(root / "jax"),
                     "-n", "run", over])
    (jrun,) = list((root / "jax").iterdir())
    metrics = os.path.basename(JMetricsWriter(str(root / "jaxm")).path)
    assert run.name.endswith("_run") and jrun.name.endswith("_run")
    assert sorted(os.listdir(run)) == sorted(os.listdir(jrun) + [metrics])
    assert sorted(os.listdir(run)) == ["checkpoints", "configs", "images",
                                       "metrics.jsonl"]
    assert os.listdir(run / "configs") == [f"{run.name}-project.yaml"]
    assert os.listdir(jrun / "configs") == [f"{jrun.name}-project.yaml"]
    assert (yaml.safe_load((run / "configs" / f"{run.name}-project.yaml")
                           .read_text())
            == yaml.safe_load((jrun / "configs" / f"{jrun.name}-project.yaml")
                              .read_text()))
    got = rows(run)
    assert [r["step"] for r in got] == [0, 1]
    for r in got:
        assert set(r) == {"step", "time"} | {f"train/{k}" for k in STEP_KEYS}
        assert all(np.isfinite(v) for v in r.values())
    # the first save (orbax saves when none exists) and the final melk
    assert sorted(os.listdir(run / "checkpoints")) == ["0.pt", "1.pt"]


def _capture_restores(monkeypatch):
    restored = []
    real = tstate.state_from_pytree

    def spy(state, tree):
        out = real(state, tree)
        # a copy: the live tensors change with the steps that follow
        restored.append(copy.deepcopy(tstate.state_to_pytree(out)))
        return out

    monkeypatch.setattr(tstate, "state_from_pytree", spy)
    return restored


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_tensors(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        return _tensors(dict(enumerate(tree)), prefix)
    return {prefix: tree}


def test_resume_restores_the_whole_state_bit_exactly(workspace, monkeypatch,
                                                     capsys):
    root, cfg_path = workspace
    run = run_cli(cfg_path, root / "resume", "-t", "--max_steps", "2",
                  "--ckpt_every", "1", "--no-test")
    saved = torch.load(run / "checkpoints" / "1.pt", weights_only=True)
    assert saved["step"] == 2 and saved["ema"]["num_updates"] == 2
    assert set(saved) == {"step", "params", "frozen", "opt_state", "ema"}
    restored = _capture_restores(monkeypatch)
    capsys.readouterr()
    train.main(["-r", str(run), "-t", "--max_steps", "4", "--seed", "7",
                "--ckpt_every", "1", "--device", "cpu", "--no-test"])
    out = capsys.readouterr().out
    assert f"resumed from {run / 'checkpoints'} at step 2" in out
    assert "done at step 4" in out
    (live,) = restored
    want, got = _tensors(saved), _tensors(live)
    assert set(got) == set(want) and len(want) > 100
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k].cpu(), v), k
        else:
            assert got[k] == v, k
    assert [r["step"] for r in rows(run)] == [0, 1, 2, 3]
    final = torch.load(run / "checkpoints" / "3.pt", weights_only=True)
    assert final["step"] == 4 and final["ema"]["num_updates"] == 4
    assert final["opt_state"]["count"] == 4
    for k, v in final["frozen"].items():
        assert torch.equal(v, saved["frozen"][k]), k
    assert any(not torch.equal(v, saved["params"][k])
               for k, v in final["params"].items())


def test_validation_and_test_pass(workspace, capsys):
    root, cfg_path = workspace
    run = run_cli(cfg_path, root / "val", "-t", "--max_steps", "3",
                  "--val_every", "2")
    out = capsys.readouterr().out
    val = [r for r in rows(run) if any(k.startswith("val/") for k in r)]
    assert [r["step"] for r in val] == [2]
    assert set(val[0]) == {"step", "time"} | {f"val/{k}" for k in EVAL_KEYS}
    assert "[test] {" in out and "val/loss_simple_ema" in out


def test_validate_only_without_train(workspace, capsys):
    root, cfg_path = workspace
    run = run_cli(cfg_path, root / "validate")
    assert "config validated" in capsys.readouterr().out
    assert os.listdir(run / "checkpoints") == []
    assert rows(run) == []


def test_distill_cadence(workspace):
    root, cfg_path = workspace
    run = run_cli(cfg_path, root / "distill", "-t", "--max_steps", "5",
                  "--no-test", "model.params.apply_distill_loss=true",
                  "model.params.distill_every_n_step=2")
    got = rows(run)
    assert [r["step"] for r in got] == [0, 1, 2, 3, 4]
    assert [r["step"] for r in got if "train/loss_distill" in r] == [0, 2, 4]
    assert all(r["train/loss_distill"] > 0 for r in got
               if "train/loss_distill" in r)


def _failing_at(monkeypatch, step_to_fail, action):
    from fgdm_tpu_torch.train import train_step as ts

    real = ts.make_train_step

    def make(*a, **kw):
        fn = real(*a, **kw)
        calls = [0]

        def step(state, batch, gen):
            if calls[0] == step_to_fail:
                action()
            calls[0] += 1
            return fn(state, batch, gen)

        return step

    monkeypatch.setattr(ts, "make_train_step", make)


def test_sigusr1_saves_once_the_step_is_complete(workspace, monkeypatch,
                                                 capsys):
    root, cfg_path = workspace
    before = signal.getsignal(signal.SIGUSR1)
    _failing_at(monkeypatch, 1,
                lambda: os.kill(os.getpid(), signal.SIGUSR1))
    run = run_cli(cfg_path, root / "signal", "-t", "--max_steps", "3",
                  "--no-test", "--ckpt_every", "100")
    out = capsys.readouterr().out
    assert out.count("melk: saving checkpoint") == 2   # the signal, the end
    assert sorted(os.listdir(run / "checkpoints")) == ["0.pt", "1.pt", "2.pt"]
    assert torch.load(run / "checkpoints" / "1.pt",
                      weights_only=True)["step"] == 2
    assert signal.getsignal(signal.SIGUSR1) == before


def test_an_exception_saves_the_last_complete_step(workspace, monkeypatch):
    root, cfg_path = workspace

    def boom():
        raise RuntimeError("device lost")

    _failing_at(monkeypatch, 2, boom)
    with pytest.raises(RuntimeError, match="device lost"):
        run_cli(cfg_path, root / "crash", "-t", "--max_steps", "5",
                "--no-test", "--ckpt_every", "100")
    (run,) = list((root / "crash").iterdir())
    assert sorted(os.listdir(run / "checkpoints")) == ["0.pt", "1.pt"]
    assert torch.load(run / "checkpoints" / "1.pt",
                      weights_only=True)["step"] == 2
    assert [r["step"] for r in rows(run)] == [0, 1]


@pytest.mark.parametrize("args,item", [
    (["--fsdp"], 15),
    (["model.params.use_sketch=true"], 14),
    (["model.params.use_depth=true", "model.params.use_normal=true"], 14)])
def test_unported_options_raise(workspace, args, item, monkeypatch,
                                tmp_path):
    """``--fsdp`` (item 15, ported) trains in one process on a one-rank
    group (two ranks: ``tests/test_torch_parallel.py``); the condition
    configs (item 14, ported) exit as JAX's CLI does when no annotator
    checkpoint is found (``tests/test_torch_condition.py``)."""
    root, cfg_path = workspace
    argv = ["-b", str(cfg_path), "-l", str(root / f"no{item}"), "-t",
            "--device", "cpu", *args]
    if item == 14:
        monkeypatch.setenv("FGDM_ANNOTATOR_DIR", str(tmp_path))
        monkeypatch.delenv("FGDM_ALLOW_RANDOM_ANNOTATORS", raising=False)
        with pytest.raises(SystemExit, match="no checkpoint was found"):
            train.main(argv)
        return
    import torch.distributed as dist

    try:
        train.main([*argv, "--max_steps", "1", "--no-test"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    (run,) = list((root / f"no{item}").iterdir())
    tree = torch.load(run / "checkpoints" / "0.pt", weights_only=True)
    assert tree["step"] == 1 and tree["params"]


def test_gpus_flag_is_accepted():
    opt, _ = train.get_parser().parse_known_args(["--gpus", "0,1"])
    assert opt.gpus == "0,1" and opt.device == "cuda"
