"""The training recipes (``python -m fgdm_tpu_torch.cli.recipes control|
joint``, the counterpart of ``tools/hw_validate_recipes.py``) at a tiny
width on the CPU, fed by the COCO loader from a seeded COCO-layout tree
(the layout of ``tests/test_train_cli.py:13-29``).

Checks the summary line's keys (JAX's, plus the step times), the metrics
rows, that the checkpoint round trip saved and compared the state (and
refuses a restored tensor that differs), that the frozen backbones stay
bit for bit and the trainable partitions move, and that the loader scales
the 320x288 images of ``chip_smoke.py``'s tree up to the recipe's square.
"""

import json
import math
import os

import numpy as np
import pytest
import torch
from PIL import Image

from fgdm_tpu_torch.checkpoint.state_io import CheckpointManager
from fgdm_tpu_torch.cli import recipes
from fgdm_tpu_torch.data.dataset import load_data
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
from fgdm_tpu_torch.models.clip import CLIPTextEncoder
from fgdm_tpu_torch.models.controlnet import ControlNet
from fgdm_tpu_torch.models.seq_two_unet import SeqTwoUNet
from fgdm_tpu_torch.models.unet import UNetModel
from fgdm_tpu_torch.train.state import (TrainState, adapter_filter,
                                        make_adamw, state_to_pytree)

torch.set_num_threads(2)

UNET_TINY = dict(model_channels=32, num_heads=4, context_dim=64,
                 channel_mult=(1, 2), attention_resolutions=(1, 2),
                 num_res_blocks=1)
CN_TINY = dict(in_channels=4, model_channels=32, hint_channels=3,
               num_res_blocks=1, attention_resolutions=(1, 2),
               channel_mult=(1, 2), num_heads=4, context_dim=64)
VAE_TINY = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1,
                resolution=64, z_channels=4, embed_dim=4)
# the loader's tokenizer writes CLIP's ids (up to 49407)
CLIP_TINY = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
F32 = dict(dtype=torch.float32, device="cpu")
JAX_KEYS = {"recipe", "batch", "res", "steps", "losses", "wall_s"}


def write_coco(root, n=8, hw=(80, 70), seed=0):
    rng = np.random.default_rng(seed)
    for sub in ("images", "annotations"):
        os.makedirs(os.path.join(root, sub, "train2017"))
    anns = []
    for i in range(n):
        Image.fromarray(rng.integers(0, 255, hw + (3,)).astype(np.uint8)
                        ).save(os.path.join(root, "images", "train2017",
                                            f"{i:012d}.jpg"))
        Image.fromarray(rng.integers(0, 182, hw).astype(np.uint8)).save(
            os.path.join(root, "annotations", "train2017", f"{i:012d}.png"))
        anns.append({"image_id": i, "caption": f"thing {i}"})
    with open(os.path.join(root, "annotations", "captions_train2017.json"),
              "w") as f:
        json.dump({"annotations": anns}, f)
    return str(root)


@pytest.fixture(scope="module")
def coco(tmp_path_factory):
    return write_coco(tmp_path_factory.mktemp("recipes") / "coco")


@pytest.fixture
def env(coco, monkeypatch):
    monkeypatch.setenv("FGDM_COCO_DIR", coco)
    monkeypatch.setenv("FGDM_HW_STEPS", "2")
    monkeypatch.delenv("FGDM_HW_BATCH", raising=False)


def tiny_control():
    return dict(unet=UNetModel(**UNET_TINY, use_adapter=False, remat=True,
                               **F32),
                vae=AutoencoderKL(**VAE_TINY, **F32),
                clip=CLIPTextEncoder(**CLIP_TINY, device="cpu"),
                control=ControlNet(**CN_TINY, **F32))


def tiny_joint():
    return dict(model=SeqTwoUNet(**UNET_TINY, factor_channels=4,
                                 mapped_channels=4, image_adapter=True,
                                 remat=True, **F32),
                vae=AutoencoderKL(**VAE_TINY, **F32),
                clip=CLIPTextEncoder(**CLIP_TINY, device="cpu"))


def checksums(params):
    return {k: p.detach().clone() for k, p in params.items()}


def check_summary(out, recipe, batch, res, steps, logdir):
    assert JAX_KEYS <= set(out)
    assert (out["recipe"], out["batch"], out["res"], out["steps"]) == (
        recipe, batch, res, steps)
    assert len(out["losses"]) == len(out["step_ms"]) == steps
    assert all(math.isfinite(x) for x in out["losses"])
    assert "peak_gib" not in out          # the CPU has no device memory
    json.dumps(out)
    rows = [json.loads(line) for line in open(os.path.join(
        logdir, "metrics.jsonl"))]
    return rows


def test_control_recipe(env, tmp_path):
    cldm, state = recipes.build_control("cpu", **tiny_control())
    assert all(k.startswith("control.") for k in state.params)
    # the ControlNet's zero convs start at true zero; the UNet's heads not
    assert not cldm.control.zero_convs[0][0].weight.any()
    assert cldm.unet.out[2].weight.any()
    frozen0, params0 = checksums(state.frozen), checksums(state.params)
    vae0 = checksums(dict(cldm.vae.named_parameters()))
    logdir = str(tmp_path / "hw_control")
    out = recipes.train_control(cldm, state, logdir, res=64)
    rows = check_summary(out, "control", 2, 64, 4, logdir)
    assert [r["step"] for r in rows] == [0, 1]
    assert {"loss", "loss_simple", "loss_vlb", "grad_norm"} <= set(rows[0])
    assert state.step == 4
    assert CheckpointManager(os.path.join(logdir, "checkpoints")
                             ).all_steps() == [2]
    assert all(torch.equal(p, frozen0[k]) for k, p in state.frozen.items())
    assert all(torch.equal(p, vae0[k])
               for k, p in cldm.vae.named_parameters())
    assert any(not torch.equal(p, params0[k])
               for k, p in state.params.items())


def test_joint_recipe(env, tmp_path):
    model, state, vae, clip = recipes.build_joint("cpu", **tiny_joint())
    assert {k.split(".")[0] for k in state.params} == {"unet1",
                                                      "channel_mapper"}
    frozen0, params0 = checksums(state.frozen), checksums(state.params)
    logdir = str(tmp_path / "hw_joint")
    out = recipes.train_joint(model, state, vae, clip, logdir, res=64)
    rows = check_summary(out, "joint", 4, 64, 4, logdir)
    assert [r["step"] for r in rows] == [0, 1, 2, 3]
    assert {"train/loss", "train/loss_simple", "grad_norm"} <= set(rows[0])
    # the round trip after step FGDM_HW_STEPS - 1
    assert CheckpointManager(os.path.join(logdir, "checkpoints")
                             ).all_steps() == [1]
    assert all(torch.equal(p, frozen0[k]) for k, p in state.frozen.items())
    assert all(not torch.equal(p, params0[k])
               for k, p in state.params.items())


def test_roundtrip_refuses_a_changed_tensor(tmp_path, monkeypatch):
    model = UNetModel(**UNET_TINY, **F32)
    state = TrainState.create(model, make_adamw(1e-3),
                              trainable_filter=adapter_filter())
    mgr = CheckpointManager(str(tmp_path / "ck"))
    assert recipes.ckpt_roundtrip(mgr, state, 3) >= 12
    restore = mgr.restore

    def changed(step=None):
        tree = restore(step)
        first = next(iter(tree["params"]))
        tree["params"][first] = tree["params"][first] + 1.0
        return tree

    monkeypatch.setattr(mgr, "restore", changed)
    with pytest.raises(RuntimeError, match="mismatch"):
        recipes.ckpt_roundtrip(mgr, state, 4)
    with pytest.raises(RuntimeError, match="already saved"):
        recipes.ckpt_roundtrip(mgr, state, 3)
    assert set(torch.load(mgr.path(3), weights_only=True)) == set(
        state_to_pytree(state))


def test_cli_joint_prints_the_summary(env, tmp_path, monkeypatch, capsys):
    """``main(["joint", "--device", "cpu"])`` with the full-width builders
    swapped for tiny ones: the run at 256^2, the JSON line, the metrics
    under ``logs/hw_joint``."""
    mods = tiny_joint()
    monkeypatch.setenv("FGDM_HW_STEPS", "1")
    monkeypatch.setattr(recipes, "SeqTwoUNet",
                        lambda **kw: mods["model"])
    monkeypatch.setattr(recipes, "sd_vae", lambda *a, **kw: mods["vae"])
    monkeypatch.setattr(recipes, "sd_clip", lambda *a, **kw: mods["clip"])
    monkeypatch.chdir(tmp_path)
    out = recipes.main(["joint", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    check_summary(out, "joint", 4, 256, 3, "logs/hw_joint")


def test_loader_scales_the_smoke_tree_up(tmp_path):
    """``chip_smoke.py``'s tree holds 320x288 images: the loader's random
    crop scales the short side to at least the crop, so the control recipe
    gets 512^2 images and hints."""
    root = write_coco(tmp_path / "coco", n=2, hw=(288, 320))
    ds = load_data("coco", root, 512, use_rgb=True, use_ade_colormap=True)
    item = ds.sample(0)
    assert item["rgb"].shape == item["image"].shape == (512, 512, 3)
    assert -1.0 <= item["image"].min() and item["image"].max() <= 1.0


def test_native_library_builds_once_under_threads(tmp_path, monkeypatch):
    """The loader's worker threads reach the native transforms together at
    first use: one build, one library for all (a race here renamed one
    thread's temporary file from under another)."""
    from concurrent.futures import ThreadPoolExecutor

    from fgdm_tpu_torch.data import native

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    native._load_once.cache_clear()
    try:
        with ThreadPoolExecutor(4) as pool:
            libs = list(pool.map(lambda _: native._load(), range(4)))
        assert len({id(lib) for lib in libs}) == 1
        built = list((tmp_path / "native").glob("*.so"))
        assert len(built) == (0 if libs[0] is None else 1)
        assert not list((tmp_path / "native").glob("*.tmp.so"))
    finally:
        native._load_once.cache_clear()
