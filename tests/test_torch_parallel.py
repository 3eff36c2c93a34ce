"""The port's parallelism (``fgdm_tpu_torch/parallel/``) held against the
JAX package and against its own one-process steps, on the CPU.

* The rule tables: ``tp_spec``/``count_sharded`` and
  ``fsdp_spec``/``count_fsdp`` against JAX's on the same trees (the tiny
  UNet and SD-1.4's; JAX's by ``jax.eval_shape``, the port's on the meta
  device), leaf by leaf through ``checkpoint/convert.py``'s names, at 2, 4
  and 8 ranks.
* ``maybe_initialize_distributed`` with ``init_process_group`` patched.
* At world size 2 on gloo, in ONE ``mp.spawn`` for the module (the
  ``world`` fixture; rendezvous through a file under ``tmp_path``, one
  thread a child): ``ring_attention`` against JAX's on a 2-device mesh; the
  DP, FSDP and TP training steps (two steps, injected t / noise /
  posterior eps) against the port's one-process step on the global batch,
  which ``tests/test_torch_train.py`` holds against JAX's; the control and
  joint steps under DP; the ``mesh=`` engine against the plain engine;
  context-parallel sampling and decoding against JAX's single-device sample
  of the same tiny LD on JAX's x_T; the indivisible-H error and the
  uneven-deep-levels warning; the ``--fsdp`` training CLI for two steps.
  The parent writes the JAX side's weights and inputs as files, so the
  children import no JAX; each child check writes its result and each test
  asserts its own.  Then ``-r`` resumes the ``--fsdp`` run in one process.

Tolerances: DP/TP/FSDP against one process (each step's averaged
gradients and its metrics) and the ring against JAX within 1e-5 of max|ref|
(float32), the parameters after two AdamW steps within 2 lr (AdamW's early
updates are about lr in size whatever the gradient's, so float32 noise on a
near-zero gradient can flip one); context parallelism against JAX within
the samplers' 2e-3 of max|ref|; the engine's uint8 images within one step.
"""

import json
import os
import pathlib
import traceback
import warnings
from datetime import timedelta

import numpy as np
import pytest
import torch

TINY = dict(model_channels=32, num_heads=4, context_dim=64,
            channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_res_blocks=1)
VAE_TINY = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1, resolution=64,
                z_channels=4, embed_dim=4)
CLIP_TINY = dict(vocab_size=128, embed_dim=64, num_layers=1, num_heads=4)
STEP_TOL = 1e-5
CP_TOL = 2e-3
CP_HW = (128, 128)          # latent 16: every level of the tiny UNet divides
UNEVEN_HW = (144, 192)      # latent 18 x 24: level 1 has 9 rows, odd
BATCH = 2             # one row a rank
LR = 1e-3


# --------------------------------------------------------------------------
# the children (no JAX here: the parent wrote every JAX-side input)
# --------------------------------------------------------------------------

def _seeded_ld(seed=0, vocab=128):
    from fgdm_tpu_torch import builders
    from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
    from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder
    from fgdm_tpu_torch.models.unet import UNetModel
    from fgdm_tpu_torch.nn.layers import init_params_

    gen = torch.Generator().manual_seed(seed)
    f32 = dict(dtype=torch.float32, device="cpu")
    unet = init_params_(UNetModel(**TINY, **f32), gen, 0.02).eval()
    vae = init_params_(AutoencoderKL(**VAE_TINY, **f32), gen, 0.02).eval()
    enc = init_params_(CLIPTextEncoder(**{**CLIP_TINY, "vocab_size": vocab},
                                       **f32), gen).eval()
    for m in (vae, enc):
        if m is not None:
            m.requires_grad_(False)
    return LatentDiffusion(unet, vae, builders.sd14_schedule(), clip=enc)


def _draws(seed, b=BATCH, steps=2):
    g = torch.Generator().manual_seed(seed)
    return [dict(t=torch.randint(0, 1000, (b,), generator=g),
                 noise=torch.randn(b, 4, 8, 8, generator=g),
                 posterior_eps=torch.randn(b, 4, 8, 8, generator=g))
            for _ in range(steps)]


def _batch(seed, b=BATCH, hint=False):
    g = torch.Generator().manual_seed(seed)
    out = {"image": torch.rand(b, 3, 64, 64, generator=g) * 2 - 1,
           "input_ids": torch.randint(0, 128, (b, 77), generator=g)}
    if hint:
        out["hint"] = torch.rand(b, 3, 64, 64, generator=g)
    return out


def _rows(tree, rank, n):
    def cut(x):
        if not torch.is_tensor(x) or x.dim() == 0:
            return x
        k = x.shape[0] // n
        return x[rank * k:(rank + 1) * k]
    return {k: cut(v) for k, v in tree.items()}


def _err(got: dict, ref: dict) -> dict:
    """max |got - ref| and max |ref| over a dict of tensors."""
    return {"err": max(float((got[k].float() - ref[k].float()).abs().max())
                       for k in ref),
            "scale": max(float(ref[k].float().abs().max()) for k in ref)}


def _run_steps(make_step, state, batch, draws, rank=0, n=1):
    """Two steps: each step's averaged gradients (gathered whole), its
    metrics, and the trained parameters and EMA after the last."""
    from fgdm_tpu_torch.train.state import _full, state_to_pytree

    grads, metrics = {}, []
    apply = state.apply_gradients

    def capture():
        grads.update({f"g{len(metrics)}/{k}": _full(p.grad).clone()
                      for k, p in state.params.items()
                      if p.grad is not None})
        return apply()

    state.apply_gradients = capture
    for d in draws:
        state, m = make_step(state, _rows(batch, rank, n), None,
                             **_rows(d, rank, n))
        metrics.append({k: float(v) for k, v in m.items()})
    tree = state_to_pytree(state, include_frozen=False)
    params = {**{f"p/{k}": v for k, v in tree["params"].items()},
              **{f"ema/{k}": v for k, v in tree["ema"]["shadow"].items()}}
    return grads, metrics, params


def _compare_steps(got, ref):
    """Gradients and metrics: max error and max |ref|.  The parameters:
    max error alone (AdamW's first steps move a parameter by about lr
    whatever its gradient's size, so float32 noise on a near-zero gradient
    can move it by up to lr the other way)."""
    (gg, gm, gp), (rg, rm, rp) = got, ref
    assert set(gg) == set(rg) and gg
    out = _err(gg, rg)
    out["metric_err"] = max(abs(g[k] - r[k]) for g, r in zip(gm, rm)
                            for k in r)
    out["metric_scale"] = max(abs(r[k]) for r in rm for k in r)
    out["param_err"] = _err(gp, rp)["err"]
    out["keys"] = sorted(gm[0])
    return out


def _state(model, trainable=None):
    from fgdm_tpu_torch.train.state import (TrainState, adapter_filter,
                                            make_adamw)

    return TrainState.create(model, make_adamw(LR, grad_clip=1.0),
                             trainable_filter=trainable or adapter_filter(),
                             use_ema=True, ema_decay=0.9)


def check_ring(rank, d, mesh):
    from fgdm_tpu_torch.parallel.mesh import all_gather_rows
    from fgdm_tpu_torch.parallel.ring_attention import ring_attention

    q, k, v = (torch.from_numpy(np.load(d / "ring.npz")[n])
               for n in ("q", "k", "v"))
    n = q.shape[2] // 2
    part = [t[:, :, rank * n:(rank + 1) * n] for t in (q, k, v)]
    out = all_gather_rows(ring_attention(*part, None, 32 ** -0.5), None,
                          dim=2)
    return {"out": out.numpy()}


_ONE_PROCESS = {}


def _adapter_reference():
    """The one-process adapter steps DP and FSDP are held against."""
    from fgdm_tpu_torch.train.train_step import make_train_step

    if not _ONE_PROCESS:
        ld = _seeded_ld()
        _ONE_PROCESS["ref"] = _run_steps(make_train_step(ld), _state(ld.unet),
                                         _batch(1), _draws(2))
    return _ONE_PROCESS["ref"]


def check_dp_step(rank, d, mesh):
    from fgdm_tpu_torch.train.train_step import make_train_step

    batch, draws = _batch(1), _draws(2)
    ref = _adapter_reference()
    ld = _seeded_ld()
    got = _run_steps(make_train_step(ld, mesh=mesh["dp"]), _state(ld.unet),
                     batch, draws, rank, 2)
    return _compare_steps(got, ref)


def check_fsdp_step(rank, d, mesh):
    from torch.distributed.tensor import DTensor

    from fgdm_tpu_torch.parallel.fsdp import shard_state_fsdp
    from fgdm_tpu_torch.train.train_step import make_train_step

    batch, draws = _batch(1), _draws(2)
    ref = _adapter_reference()
    ld = _seeded_ld()
    state = shard_state_fsdp(mesh["dp"], _state(ld.unet), min_size=256)
    kinds = [isinstance(p, DTensor) for p in state.params.values()]
    frozen = [isinstance(p, DTensor) for p in state.frozen.values()]
    got = _run_steps(make_train_step(ld, mesh=mesh["dp"]), state, batch,
                     draws, rank, 2)
    out = _compare_steps(got, ref)
    out.update(sharded_trainable=sum(kinds), whole_trainable=len(kinds)
               - sum(kinds), sharded_frozen=sum(frozen))
    return out


def check_tp_step(rank, d, mesh):
    from torch.distributed.tensor import DTensor

    from fgdm_tpu_torch.parallel.tp import count_sharded, shard_params_tp
    from fgdm_tpu_torch.train.train_step import make_train_step

    batch, draws = _batch(5), _draws(6)
    every = lambda name: True  # noqa: E731
    ld = _seeded_ld()
    ref = _run_steps(make_train_step(ld), _state(ld.unet, every), batch,
                     draws)
    ld = _seeded_ld()
    n_rule, total = count_sharded(mesh["tp"], ld.unet, min_shard_dim=64)
    shard_params_tp(mesh["tp"], ld.unet, min_shard_dim=64)
    n_dt = sum(isinstance(p, DTensor) for p in ld.unet.parameters())
    got = _run_steps(make_train_step(ld, mesh=mesh["tp"]),
                     _state(ld.unet, every), batch, draws)
    out = _compare_steps(got, ref)
    out.update(rule_sharded=n_rule, total=total, dtensors=n_dt)
    return out


def _seeded_cldm(vocab=128):
    from fgdm_tpu_torch.diffusion.control import ControlLDM
    from fgdm_tpu_torch.models.controlnet import ControlNet
    from fgdm_tpu_torch.models.unet import UNetModel
    from fgdm_tpu_torch.nn.layers import init_params_

    ld = _seeded_ld(7, vocab)
    gen = torch.Generator().manual_seed(8)
    f32 = dict(dtype=torch.float32, device="cpu")
    return ControlLDM(
        init_params_(UNetModel(**TINY, use_adapter=False, **f32), gen,
                     0.02).eval(), ld.vae, ld.schedule, clip=ld.clip,
        control=init_params_(ControlNet(**TINY, **f32), gen, 0.02).eval(),
        control_scales=(1.0,) * 5)


def check_control_step(rank, d, mesh):
    from fgdm_tpu_torch.train.control import (control_filter,
                                              control_param_tree,
                                              make_control_train_step)

    batch, draws = _batch(9, hint=True), _draws(10)
    runs = []
    for m in (None, mesh["dp"]):
        cldm = _seeded_cldm()
        state = _state(control_param_tree(cldm), control_filter(False))
        runs.append(_run_steps(make_control_train_step(cldm, mesh=m), state,
                               batch, draws, *((rank, 2) if m else ())))
    return _compare_steps(runs[1], runs[0])


def check_joint_step(rank, d, mesh):
    from fgdm_tpu_torch.core.schedules import DiffusionSchedule
    from fgdm_tpu_torch.models.seq_two_unet import SeqTwoUNet
    from fgdm_tpu_torch.nn.layers import init_params_
    from fgdm_tpu_torch.train.joint import make_joint_train_step
    from fgdm_tpu_torch.train.state import joint_image_adapter_filter

    g = torch.Generator().manual_seed(11)
    batch = {"latent": torch.randn(BATCH, 8, 8, 8, generator=g),
             "context": torch.randn(BATCH, 77, 64, generator=g) * 0.02}
    draws = [dict(t=torch.randint(0, 1000, (BATCH,), generator=g),
                  noise=torch.randn(BATCH, 4, 8, 8, generator=g))
             for _ in range(2)]
    sched = DiffusionSchedule.create(1000, "linear", linear_start=0.00085,
                                     linear_end=0.0120)
    runs = []
    for m in (None, mesh["dp"]):
        model = SeqTwoUNet(**TINY, factor_channels=4, mapped_channels=4,
                           image_adapter=True, dtype=torch.float32,
                           device="cpu")
        init_params_(model, torch.Generator().manual_seed(12), 0.02).eval()
        runs.append(_run_steps(
            make_joint_train_step(model, sched, mesh=m),
            _state(model, joint_image_adapter_filter()), batch, draws,
            *((rank, 2) if m else ())))
    return _compare_steps(runs[1], runs[0])


def check_engine(rank, d, mesh):
    from fgdm_tpu_torch.serving import ChainEngine

    # the hash-fallback tokenizer writes ids up to CLIP's vocabulary
    ld = _seeded_ld(13, 49408)
    cldm = _seeded_cldm(49408)
    kw = dict(max_batch=2, cond_hw=(64, 64), image_hw=(64, 64), f1_steps=2,
              f2_steps=2, warmup=False)
    args = (["a cat", "a dog"],)
    plain = ChainEngine(ld, cldm, **kw).generate(*args, seeds=[3, -4])
    sharded = ChainEngine(ld, cldm, mesh=mesh["dp"], **kw).generate(
        *args, seeds=[3, -4])
    return {k: int(np.abs(sharded[k].astype(int)
                          - plain[k].astype(int)).max())
            for k in ("images", "conditions")} | {
        "shape": list(sharded["images"].shape)}


def _cp_ld(d):
    from fgdm_tpu_torch import builders
    from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion
    from fgdm_tpu_torch.models.autoencoder import AutoencoderKL
    from fgdm_tpu_torch.models.unet import UNetModel

    f32 = dict(dtype=torch.float32, device="cpu")
    unet = UNetModel(**TINY, **f32)
    unet.load_state_dict(torch.load(d / "unet.pt"), strict=True)
    vae = AutoencoderKL(**VAE_TINY, **f32)
    vae.load_state_dict(torch.load(d / "vae.pt"), strict=True)
    return LatentDiffusion(unet.eval(), vae.eval(), builders.sd14_schedule())


def check_context_parallel(rank, d, mesh):
    from fgdm_tpu_torch.core.schedules import DDIMSchedule
    from fgdm_tpu_torch.parallel import context as cp
    from fgdm_tpu_torch.sampling.ddim import ddim_sample

    inp = {k: torch.from_numpy(v) for k, v in np.load(d / "cp.npz").items()}
    ld = _cp_ld(d)
    ld_cp = cp.context_parallel_pipeline(ld, cp.context_group())
    out = {"shares_weights": all(
        a is b for a, b in zip(ld.unet.parameters(),
                               ld_cp.unet.parameters())),
        "seq_axis": ld_cp.unet.seq_axis}
    out["image"] = cp.sample_context_parallel(
        ld_cp, None, inp["ctx"], inp["uc"], CP_HW, num_steps=2,
        cfg_scale=3.0, x_T=inp["x_T"]).numpy()
    out["decoded"] = cp.decode_context_parallel(ld_cp, None,
                                                inp["z"]).numpy()
    # uneven deep levels: a warning, and the port's one-process sample
    xt = inp["x_T_uneven"]
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        got = cp.sample_context_parallel(
            ld_cp, None, inp["ctx"], inp["uc"], UNEVEN_HW, num_steps=2,
            cfg_scale=3.0, decode=False, x_T=xt)
    out["warnings"] = [str(r.message) for r in rec]
    ref = ddim_sample(ld.denoise_fn(), xt.shape,
                      DDIMSchedule.create(ld.schedule, 2),
                      {"c_crossattn": inp["ctx"]},
                      {"c_crossattn": inp["uc"]}, cfg_scale=3.0, x_T=xt)
    out.update(_err({"z": got}, {"z": ref}))
    try:
        cp.sample_context_parallel(ld_cp, None, inp["ctx"], inp["ctx"],
                                   (136, 136), num_steps=1)
        out["error"] = None
    except AssertionError as e:
        out["error"] = str(e)
    return out


def check_fsdp_cli(rank, d, mesh):
    from fgdm_tpu_torch import builders
    from fgdm_tpu_torch.cli import train
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder

    builders.build_clip = lambda dtype=torch.bfloat16, **p: \
        builders.ModuleDef(CLIPTextEncoder, dict(
            vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4,
            dtype=dtype))
    os.environ["FGDM_RANDOMIZE_ZERO_HEADS"] = "1"
    os.environ["FGDM_FSDP_MIN_SIZE"] = "1024"
    common = ["-t", "--fsdp", "--no-test", "--device", "cpu",
              "--num_workers", "1", "--seed", "7"]
    train.main(["-b", str(d / "ws" / "tiny.yaml"), "-l", str(d / "runs"),
                "-n", "fsdp", "--max_steps", "2", *common])
    # -r under --fsdp: the whole tensors of the file cut into the shards,
    # AdamW's moments too
    (run,) = list((d / "runs").iterdir())
    train.main(["-r", str(run), "--max_steps", "3", *common])
    return {"ok": True}


CHECKS = [check_ring, check_dp_step, check_fsdp_step, check_tp_step,
          check_control_step, check_joint_step, check_engine,
          check_context_parallel, check_fsdp_cli]


def _child(rank, world, init, d):
    import torch.distributed as dist

    from fgdm_tpu_torch.parallel.mesh import create_mesh

    torch.set_num_threads(1)
    d = pathlib.Path(d)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=180))
    mesh = {"dp": create_mesh(n_data=2, device_type="cpu"),
            "tp": create_mesh(n_data=1, n_model=2, device_type="cpu")}
    for check in CHECKS:
        try:
            res = check(rank, d, mesh)
        except Exception:
            res = {"exception": traceback.format_exc()}
        if rank == 0:
            torch.save(res, d / f"{check.__name__}.pt")
    dist.destroy_process_group()


# --------------------------------------------------------------------------
# the parent: JAX's side, the spawn, the assertions
# --------------------------------------------------------------------------

def _seeded_flax(shapes, seed):
    """Numpy-seeded values for a flax shape tree: kernels N(0, 1/fan_in),
    norm scales 1 + 0.02 N, biases 0.02 N (no flax init runs)."""
    import jax

    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        z = rng.standard_normal(s.shape).astype(np.float32)
        if name == "scale":
            return 1.0 + 0.02 * z
        if name == "bias":
            return 0.02 * z
        return z / np.sqrt(max(1, int(np.prod(s.shape[:-1]))))

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _write_workspace(root: pathlib.Path):
    """A seeded COCO tree and the tiny training config of
    ``tests/test_torch_train_run.py``."""
    import yaml
    from PIL import Image

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

    unet = {"model_channels": 32, "num_heads": 4, "context_dim": 64,
            "channel_mult": [1, 2], "attention_resolutions": [1, 2],
            "num_res_blocks": 1, "use_checkpoint": True}
    vae = {"embed_dim": 4, "ddconfig": {
        "ch": 32, "ch_mult": [1, 2], "num_res_blocks": 1, "resolution": 64,
        "z_channels": 4, "double_z": True, "in_channels": 3, "out_ch": 3,
        "attn_resolutions": []}}
    cfg = {"model": {
        "base_learning_rate": 1e-4,
        "target": "ldm.models.diffusion.ddpm.LatentDiffusion",
        "params": {
            "image_size": 8, "scale_factor": 0.18215,
            "linear_start": 0.00085, "linear_end": 0.0120,
            "freeze_backbone": True, "use_ema": True,
            "apply_distill_loss": False,
            "unet_config": {
                "target": "ldm.modules.diffusionmodules.openaimodel."
                          "UNetModel", "params": unet},
            "first_stage_config": {
                "target": "ldm.models.autoencoder.AutoencoderKL",
                "params": vae},
            "cond_stage_config": {
                "target": "ldm.modules.encoders.modules.FrozenCLIPEmbedder"},
        }},
        "data": {"target": "main.DataModuleFromConfig",
                 "params": {"batch_size": 4, "train": ds("train2017", True),
                            "validation": ds("val2017", False)}}}
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "tiny.yaml", "w") as f:
        yaml.safe_dump(cfg, f)


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    """The inputs the children read, and a function that computes JAX's
    references."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    import fgdm_tpu.core.schedules as jsch
    import fgdm_tpu.sampling.ddim as jddim
    from fgdm_tpu.diffusion.latent_diffusion import (
        LatentDiffusion as JLatentDiffusion)
    from fgdm_tpu.models.autoencoder import AutoencoderKL as JAutoencoderKL
    from fgdm_tpu.models.unet import UNetModel as JUNetModel
    from fgdm_tpu.parallel.mesh import create_mesh as jcreate_mesh
    from fgdm_tpu.parallel.ring_attention import ring_attention as jring
    from fgdm_tpu_torch.checkpoint import convert

    d = tmp_path_factory.mktemp("world")
    rng = np.random.default_rng(0)
    q, k, v = (rng.standard_normal((2, 4, 256, 32)).astype(np.float32)
               for _ in range(3))
    np.savez(d / "ring.npz", q=q, k=k, v=v)

    unet_def = JUNetModel(**TINY, dtype=jnp.float32)
    vae_def = JAutoencoderKL(**VAE_TINY, dtype=jnp.float32)
    unet_p = _seeded_flax(jax.eval_shape(lambda: unet_def.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)),
        jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 64)))), 20)
    vae_p = _seeded_flax(jax.eval_shape(lambda: vae_def.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
        sample_posterior=False)), 21)
    torch.save(convert.unet_state_dict(unet_p), d / "unet.pt")
    torch.save(convert.vae_state_dict(vae_p), d / "vae.pt")
    sched = jsch.DiffusionSchedule.create(1000, "linear",
                                          linear_start=0.00085,
                                          linear_end=0.0120)
    jld = JLatentDiffusion(unet_def=unet_def, vae_def=vae_def, clip_def=None,
                           unet_params=unet_p, vae_params=vae_p,
                           schedule=sched)
    lat = (CP_HW[0] // 8, CP_HW[1] // 8)
    x_T = rng.standard_normal((1,) + lat + (4,)).astype(np.float32)
    z = rng.standard_normal((1,) + lat + (4,)).astype(np.float32)
    ctx = (rng.standard_normal((1, 77, 64)) * 0.1).astype(np.float32)
    uc = np.zeros((1, 77, 64), np.float32)
    x_T_uneven = rng.standard_normal(
        (1, 4, UNEVEN_HW[0] // 8, UNEVEN_HW[1] // 8)).astype(np.float32)
    np.savez(d / "cp.npz", x_T=x_T.transpose(0, 3, 1, 2).copy(),
             z=z.transpose(0, 3, 1, 2).copy(), ctx=ctx, uc=uc,
             x_T_uneven=x_T_uneven)

    @jax.jit
    def sample_and_decode(x_T, ctx, uc, z):
        zz, _ = jddim.ddim_sample(
            jld.denoise_fn(), jax.random.PRNGKey(0), x_T.shape,
            jsch.DDIMSchedule.create(jld.schedule, 2), {"c_crossattn": ctx},
            {"c_crossattn": uc}, cfg_scale=3.0, x_T=x_T)
        return jld.decode_first_stage(zz), jld.decode_first_stage(z)

    def references():
        """JAX's outputs, computed while the children run."""
        mesh2 = jcreate_mesh(n_data=2, devices=jax.devices()[:2])
        with mesh2:
            ring = np.asarray(jring(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mesh2, axis="data"))
        img, dec = sample_and_decode(jnp.asarray(x_T), jnp.asarray(ctx),
                                     jnp.asarray(uc), jnp.asarray(z))
        return dict(ring=ring, image=np.asarray(img).transpose(0, 3, 1, 2),
                    decoded=np.asarray(dec).transpose(0, 3, 1, 2))

    _write_workspace(d / "ws")
    return d, references


@pytest.fixture(scope="module")
def world(jax_side):
    """Every distributed check, in one spawn of two gloo ranks; JAX's
    references are computed meanwhile."""
    import torch.multiprocessing as mp

    d, references = jax_side
    saved = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        procs = mp.start_processes(
            _child, args=(2, f"file://{d / 'rendezvous'}", str(d)),
            nprocs=2, join=False, start_method="spawn")
    finally:
        if saved is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = saved
    try:
        out = references()
    finally:
        while not procs.join():
            pass
    return dict(dir=d, **out)


def _result(world, check):
    res = torch.load(world["dir"] / f"{check.__name__}.pt",
                     weights_only=False)
    assert "exception" not in res, res.get("exception")
    return res


def _close(res, tol):
    assert res["err"] <= tol * res["scale"], res
    if "metric_err" in res:
        assert res["metric_err"] <= tol * res["metric_scale"], res
        assert res["param_err"] <= 2 * LR, res


def test_ring_attention_matches_jax(world):
    out = _result(world, check_ring)["out"]
    ref = world["ring"]
    assert out.shape == ref.shape == (2, 4, 256, 32)
    assert np.abs(out - ref).max() <= STEP_TOL * np.abs(ref).max()


@pytest.mark.parametrize("check", [check_dp_step, check_fsdp_step,
                                   check_tp_step, check_control_step,
                                   check_joint_step],
                         ids=["dp", "fsdp", "tp", "control_dp", "joint_dp"])
def test_parallel_step_matches_one_process(world, check):
    res = _result(world, check)
    _close(res, STEP_TOL)
    assert "grad_norm" in res["keys"]


def test_fsdp_and_tp_shard_what_the_rules_say(world):
    fsdp = _result(world, check_fsdp_step)
    assert fsdp["sharded_trainable"] and fsdp["whole_trainable"]
    assert fsdp["sharded_frozen"]
    tp = _result(world, check_tp_step)
    assert 0 < tp["rule_sharded"] < tp["total"]
    assert tp["dtensors"] >= tp["rule_sharded"]


def test_mesh_engine_matches_plain_engine(world):
    res = _result(world, check_engine)
    assert res["shape"] == [2, 64, 64, 3]
    assert res["images"] <= 1 and res["conditions"] <= 1


def test_context_parallel_sample_and_decode_match_jax(world):
    res = _result(world, check_context_parallel)
    assert res["shares_weights"] and res["seq_axis"] == "seq"
    for key in ("image", "decoded"):
        got, ref = res[key], world[key]
        assert got.shape == ref.shape
        assert np.abs(got - ref).max() <= CP_TOL * np.abs(ref).max(), key


def test_context_parallel_uneven_levels_warn_and_match(world):
    res = _result(world, check_context_parallel)
    assert any("thrash-free" in w for w in res["warnings"])
    _close(res, STEP_TOL)


def test_context_parallel_indivisible_height_fails(world):
    res = _result(world, check_context_parallel)
    assert res["error"] and "must divide over the 2-device seq axis" in \
        res["error"]


def test_fsdp_cli_then_resume_in_one_process(world, monkeypatch):
    """``--fsdp`` at world size 2 wrote whole-tensor checkpoints (rank 0)
    and resumed from them (``-r`` under ``--fsdp``: each rank cut its
    shards of the parameters, moments and EMA); ``-r`` then resumes the
    run in one process without ``--fsdp``, with the file's values."""
    from fgdm_tpu_torch import builders
    from fgdm_tpu_torch.cli import train
    from fgdm_tpu_torch.models.clip import CLIPTextEncoder
    from fgdm_tpu_torch.train import state as tstate

    assert _result(world, check_fsdp_cli)["ok"]
    (run,) = list((world["dir"] / "runs").iterdir())
    ckpts = run / "checkpoints"
    assert sorted(os.listdir(ckpts)) == ["0.pt", "1.pt", "2.pt"]
    tree = torch.load(ckpts / "2.pt", weights_only=True)
    assert tree["step"] == 3
    opt_state = tree["opt_state"]["inner"]["state"]
    assert opt_state and all(
        v["exp_avg"].shape == tree["params"][k].shape
        for v, k in zip(opt_state.values(), tree["params"]))
    monkeypatch.setattr(builders, "build_clip",
                        lambda dtype=torch.bfloat16, **p: builders.ModuleDef(
                            CLIPTextEncoder, dict(
                                vocab_size=49408, embed_dim=64, num_layers=1,
                                num_heads=4, dtype=dtype)))
    monkeypatch.setenv("FGDM_RANDOMIZE_ZERO_HEADS", "1")
    seen, restore = {}, tstate.state_from_pytree

    def spy(state, t):
        out = restore(state, t)
        seen["params"] = {k: p.detach().clone()
                          for k, p in state.params.items()}
        return out

    monkeypatch.setattr(tstate, "state_from_pytree", spy)
    train.main(["-r", str(run), "-t", "--max_steps", "4", "--no-test",
                "--device", "cpu", "--num_workers", "1"])
    for k, v in tree["params"].items():
        assert torch.equal(seen["params"][k], v), k
    assert torch.load(ckpts / "3.pt", weights_only=True)["step"] == 4


# --------------------------------------------------------------------------
# the rule tables against JAX's (no process group)
# --------------------------------------------------------------------------

_HWIO = {0: 2, 1: 3, 2: 1, 3: 0}     # a flax dim -> the port's OIHW dim


@pytest.fixture(scope="module")
def trees():
    """{geometry: (flax shape tree, port meta UNet)} for tiny and SD-1.4."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from fgdm_tpu.checkpoint.loader import sd_unet as jsd_unet
    from fgdm_tpu.models.unet import UNetModel as JUNetModel
    from fgdm_tpu_torch.checkpoint.loader import sd_unet
    from fgdm_tpu_torch.models.unet import UNetModel

    def shapes(m, latent):
        return jax.eval_shape(lambda: m.init(
            jax.random.PRNGKey(0), jnp.zeros((1, latent, latent, 4)),
            jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 77, m.context_dim))))["params"]

    meta = dict(dtype=torch.float32, device="meta")
    return {"tiny": (shapes(JUNetModel(**TINY, dtype=jnp.float32), 8),
                     UNetModel(**TINY, **meta)),
            "sd": (shapes(jsd_unet(dtype=jnp.float32), 8),
                   sd_unet(fused_norm_silu=False, **meta))}


def _by_torch_name(flax_tree):
    """{port state-dict name: (flax path, shape)}."""
    from flax import traverse_util

    from fgdm_tpu_torch.checkpoint import convert

    out = {}
    for path, s in traverse_util.flatten_dict(flax_tree).items():
        name, _ = convert._leaf(path[-1], np.empty((0,) * len(s.shape)))
        out[f"{convert._unet_path(path[:-1])}.{name}"] = (path, s.shape)
    return out


def _logical(dim, flax_leaf, ndim):
    """A flax dim of a leaf as the port's dim of the same tensor."""
    if dim is None or flax_leaf not in ("kernel",):
        return dim
    return _HWIO[dim] if ndim == 4 else (1 - dim if ndim == 2 else dim)


def _jax_dim(spec, axis):
    hits = [i for i, e in enumerate(tuple(spec)) if e == axis]
    return hits[0] if hits else None


@pytest.mark.parametrize("geometry", ["tiny", "sd"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_tp_rules_match_jax(trees, geometry, n):
    from fgdm_tpu.parallel import tp as jtp
    from fgdm_tpu_torch.parallel import tp

    jtree, module = trees[geometry]
    names = _by_torch_name(jtree)
    own = dict(module.named_parameters())
    assert set(names) == set(own)
    min_dim = 16 if geometry == "tiny" else tp.MIN_SHARD_DIM
    for name, (path, shape) in names.items():
        want = _logical(_jax_dim(jtp.tp_spec(path, shape, n, min_dim),
                                 "model"), path[-1], len(shape))
        assert tp.tp_spec(name, tuple(own[name].shape), n, min_dim) == \
            want, name

    class M:
        shape = {"model": n}

    assert tp.count_sharded(n, module, min_dim) == jtp.count_sharded(
        M, {"params": jtree}, min_dim)


@pytest.mark.parametrize("geometry", ["tiny", "sd"])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_fsdp_rules_match_jax(trees, geometry, n):
    import jax

    from fgdm_tpu.parallel import fsdp as jfsdp
    from fgdm_tpu.parallel.mesh import create_mesh as jcreate_mesh
    from fgdm_tpu_torch.parallel import fsdp

    jtree, module = trees[geometry]
    own = dict(module.named_parameters())
    min_size = 1024 if geometry == "tiny" else fsdp.MIN_FSDP_SIZE
    for name, (path, shape) in _by_torch_name(jtree).items():
        want = _logical(_jax_dim(jfsdp.fsdp_spec(shape, n,
                                                 min_size=min_size), "data"),
                        path[-1], len(shape))
        assert fsdp.fsdp_spec(tuple(own[name].shape), n,
                              min_size=min_size) == want, name
    mesh = jcreate_mesh(n_data=n, devices=jax.devices()[:n])
    js, jt, jf = jfsdp.count_fsdp(mesh, jtree, min_size=min_size)
    ts, tt, tf = fsdp.count_fsdp(n, module, min_size=min_size)
    assert (ts, tt) == (js, jt) and abs(tf - jf) < 1e-12


def test_maybe_initialize_distributed(monkeypatch):
    import torch.distributed as dist

    from fgdm_tpu_torch.parallel import mesh as tmesh

    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append(backend))
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k in ("FGDM_DISTRIBUTED", "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.maybe_initialize_distributed("cpu") is False and not calls
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    assert tmesh.maybe_initialize_distributed("cpu") is False   # no RANK
    monkeypatch.setenv("RANK", "1")
    assert tmesh.maybe_initialize_distributed("cpu") is True
    assert calls == ["gloo"]
    for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k)
    monkeypatch.setenv("FGDM_DISTRIBUTED", "1")
    assert tmesh.maybe_initialize_distributed("cpu") is True
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    assert tmesh.maybe_initialize_distributed("cpu") is False
    assert calls == ["gloo", "gloo"]


def test_mesh_without_a_card_raises(monkeypatch):
    """No card and no device named: ``create_mesh``, ``_backend`` and a
    declared job's ``maybe_initialize_distributed`` raise through
    ``resolve_device`` and leave no process group; the CPU named works."""
    import torch
    import torch.distributed as dist

    from fgdm_tpu_torch.parallel import mesh as tmesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh._backend(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.create_mesh()
    assert not dist.is_initialized()
    monkeypatch.setenv("FGDM_DISTRIBUTED", "1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.maybe_initialize_distributed()
    assert not dist.is_initialized()
    assert tmesh._backend("cpu") == "gloo"
    try:
        mesh = tmesh.create_mesh(device_type="cpu")
        assert mesh.device_type == "cpu" and dist.get_backend() == "gloo"
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
