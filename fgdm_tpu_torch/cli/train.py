"""Training CLI, flag for flag the JAX package's ``fgdm_tpu/cli/train.py``
(the reference's ``main.py:34-133``), on one device or data-parallel.

    python -m fgdm_tpu_torch.cli.train -b models/config.yaml -t \\
        data.params.train.params.data_dir=/data/coco \\
        data.params.validation.params.data_dir=/data/coco

* ``-b`` configs merged left to right, then ``nested.key=value``
  overrides; ``-t`` trains (without it the config is checked and the CLI
  exits); ``-r <run dir or checkpoint file>`` resumes that run.
* The run directory ``<logdir>/<timestamp>_<name>/`` holds ``configs/``
  (``<name>-project.yaml``, the merged config), ``checkpoints/``,
  ``images/`` and ``metrics.jsonl`` (``main.py:263-310``).
* The model is ``spec.load(ckpt)`` (the config's ``ckpt_path`` when the
  file exists, else the seeded init; ``FGDM_RANDOMIZE_ZERO_HEADS=1`` then
  makes the zero-init heads pass gradients).  AdamW at ``base_learning_rate``
  (``--scale_lr``: times batch and accumulation, ``main.py:712-732``) under
  the config's LR schedule trains the adapter when ``freeze_backbone``; the
  EMA, the distillation step every ``distill_every_n_step`` steps and the
  ``scale_by_std`` calibration follow the config.
* Batches come from ``data/prefetch.py`` (``--num_workers`` threads, two
  batches ahead on the device).  The step's metrics stay on the device,
  detached, until the every-50-steps print and the end: reading them every
  step would stall the host, which paces every path of this port.
* ``--val_every`` runs the validation step; the config's ``ImageLogger``
  callback (or ``--img_log_freq``) writes ``log_images`` grids (20 DDIM
  steps, inpainting, all rows), with the EMA weights when there is an EMA.
* Checkpoints (``checkpoint/state_io.py``: parameters, frozen ones too,
  optimizer, EMA, step) every ``--ckpt_every`` steps, the 3 latest kept.
  SIGUSR1 asks for one: the handler sets a flag and the loop saves once the
  step under way is complete (the state changes in place, so a save from
  inside the handler could catch half an optimizer step).  On an exception
  the last complete step is saved before the error propagates; a failure of
  that save is printed and does not hide the error.  After the loop the
  validation set is evaluated once unless ``--no-test``.

* A depth, normal or sketch config (``use_depth``, ``use_normal``,
  ``use_sketch``, ``use_hed``, ``sketch_to_normal``) synthesizes its target
  from each batch image with a frozen annotator (``train/condition.py``),
  read from ``$FGDM_ANNOTATOR_DIR`` (default ``models``):
  ``dpt_hybrid-midas-501f0c75.pt``, ``table5_pidinet.pth`` or
  ``ControlNetHED.pth``.  Without the file it exits, unless
  ``FGDM_ALLOW_RANDOM_ANNOTATORS=1`` asks for a seeded annotator (a smoke
  run: its targets mean nothing).

* Several devices (``cli/train.py:117-142,220-288,296-361``): under
  torchrun (or ``FGDM_DISTRIBUTED=1`` with torch's rendezvous variables)
  each process joins the job (``parallel.mesh.maybe_initialize_distributed``:
  NCCL on CUDA, the rank's ``LOCAL_RANK`` device; gloo with ``--device
  cpu``), the steps run data-parallel over a ``data`` mesh of every rank
  (``train_step.make_train_step(mesh=)``), the loader hands each rank its
  rows of the global ``batch_size``, the LR scales with the rank count
  under ``--scale_lr``, and rank r draws its noise from ``--seed`` + r.
  Rank 0 picks the run directory and is the one writer of the config,
  logs, images and checkpoints.
* ``--fsdp`` stores the training state sharded over ``data``
  (``parallel.fsdp.shard_state_fsdp``; leaves under ``FGDM_FSDP_MIN_SIZE``
  elements stay whole) and prints the sharded share; a checkpoint is
  gathered whole (every rank takes part) and written by rank 0 in the
  one-file format, so ``-r`` resumes with or without ``--fsdp``.

    torchrun --nproc_per_node 4 -m fgdm_tpu_torch.cli.train -b \
        models/config.yaml -t --fsdp data.params.train.params.data_dir=...

``--device`` (default ``cuda``) names where it runs.  ``--gpus`` is
accepted and ignored (the job's size is torchrun's).
"""

from __future__ import annotations

import argparse
import datetime
import glob
import os
import signal
import threading
import time


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="FG-DM training (PyTorch)")
    p.add_argument("-n", "--name", type=str, default="")
    p.add_argument("-r", "--resume", type=str, default="")
    p.add_argument("-b", "--base", nargs="*", metavar="base_config.yaml",
                   default=[])
    p.add_argument("-t", "--train", action="store_true", default=False)
    p.add_argument("--no-test", action="store_true", default=False)
    p.add_argument("-s", "--seed", type=int, default=23)
    p.add_argument("-l", "--logdir", type=str, default="logs")
    p.add_argument("--scale_lr", action="store_true", default=False)
    p.add_argument("--gpus", type=str, default="",
                   help="accepted for the reference's command lines; the "
                        "CLI trains on one device (--device)")
    p.add_argument("--max_steps", type=int, default=-1)
    p.add_argument("--val_every", type=int, default=0)
    p.add_argument("--ckpt_every", type=int, default=10_000)
    p.add_argument("--accumulate_grad_batches", type=int, default=1)
    p.add_argument("--img_log_freq", type=int, default=0,
                   help="log image diagnostics every N steps (0 = only when "
                        "the config's lightning callbacks request it)")
    p.add_argument("--num_workers", type=int, default=8,
                   help="batch-assembly threads")
    p.add_argument("--fsdp", action="store_true", default=False,
                   help="store the training state sharded over the data "
                        "dim (FSDP; FGDM_FSDP_MIN_SIZE: smallest sharded "
                        "leaf)")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="where the model trains (cpu for tests)")
    return p


# the reference's file names (``ddpm.py:146-150``, ``controlnet/annotator``)
_ANNOTATOR_FILES = {
    "depth": ("dpt_hybrid-midas-501f0c75.pt", "dpt_hybrid.pt"),
    "normal": ("dpt_hybrid-midas-501f0c75.pt", "dpt_hybrid.pt"),
    "sketch": ("table5_pidinet.pth", "pidinet.pth"),
    "sketch_hed": ("ControlNetHED.pth", "hed.pth"),
    "sketch_to_normal": ("dpt_hybrid-midas-501f0c75.pt",),
}


def _load_annotator_params(kind: str, ann_dir: str):
    """``(path, state dict)`` of the first annotator checkpoint for ``kind``
    under ``ann_dir`` (JAX ``cli/train.py:63-96``), or None.  For
    ``sketch_to_normal`` it is the depth net's; its sketch net is seeded,
    as in JAX."""
    from fgdm_tpu_torch.checkpoint.torch_ingest import load_torch_state_dict

    for name in _ANNOTATOR_FILES[kind]:
        path = os.path.join(ann_dir, name)
        if os.path.exists(path):
            return path, load_torch_state_dict(path)
    return None


def _run_dir(opt, distributed: bool = False):
    """``(logdir, nowname)``; ``-r`` prepends the run's saved configs to
    ``opt.base``.  In a job every rank takes rank 0's timestamp (one run
    directory, JAX's ``broadcast_one_to_all``)."""
    if opt.resume:
        if os.path.isfile(opt.resume):
            logdir = os.path.dirname(os.path.dirname(opt.resume))
        else:
            logdir = opt.resume.rstrip("/")
        opt.base = sorted(glob.glob(os.path.join(logdir,
                                                 "configs/*.yaml"))) + opt.base
        return logdir, os.path.basename(logdir)
    now = [datetime.datetime.now().strftime("%Y-%m-%dT%H-%M-%S")]
    if distributed:
        import torch.distributed as dist

        dist.broadcast_object_list(now, src=0)
    now = now[0]
    cfg_name = (os.path.splitext(os.path.basename(opt.base[0]))[0]
                if opt.base else "")
    name = opt.name or cfg_name
    nowname = now + ("_" + name if name else "")
    return os.path.join(opt.logdir, nowname), nowname


def main(argv=None):
    opt, unknown = get_parser().parse_known_args(argv)

    import torch
    import torch.distributed as dist
    import yaml

    from fgdm_tpu_torch import resolve_device
    from fgdm_tpu_torch.checkpoint.state_io import CheckpointManager
    from fgdm_tpu_torch.config import (apply_dot_overrides,
                                       instantiate_from_config, load_config,
                                       merge_configs)
    from fgdm_tpu_torch.data.dataset import batch_iterator
    from fgdm_tpu_torch.data.prefetch import (ParallelBatchLoader,
                                              device_prefetch, to_device)
    from fgdm_tpu_torch.models.clip import CLIPTokenizer
    from fgdm_tpu_torch.parallel.mesh import (create_mesh, data_rank,
                                              data_size, local_batch_slice,
                                              maybe_initialize_distributed,
                                              replicate)
    from fgdm_tpu_torch.train.condition import build_condition_synth
    from fgdm_tpu_torch.train.lr_schedules import scaled_lr
    from fgdm_tpu_torch.train.metrics import (ImageLogger, MetricsWriter,
                                              log_images)
    from fgdm_tpu_torch.train.state import (TrainState, adapter_filter,
                                            make_adamw, randomize_zero_heads,
                                            state_from_pytree,
                                            state_to_pytree)
    from fgdm_tpu_torch.train.train_step import (make_eval_step,
                                                 make_train_step)

    # the job's bring-up precedes the first collective
    if maybe_initialize_distributed(torch.device(opt.device).type):
        print(f"[train] torch.distributed up: rank {dist.get_rank()}/"
              f"{dist.get_world_size()}")
    distributed = dist.is_initialized() and dist.get_world_size() > 1
    dev = resolve_device(opt.device)
    mesh = (create_mesh(device_type=dev.type)
            if distributed or opt.fsdp else None)
    rank = dist.get_rank() if mesh is not None else 0
    n_dev = data_size(mesh) if mesh is not None else 1

    # -- config and run directory (main.py:492-557) -------------------------
    logdir, nowname = _run_dir(opt, distributed)
    config = merge_configs(*[load_config(c) for c in opt.base])
    config = apply_dot_overrides(config, [u for u in unknown if "=" in u])
    ckptdir = os.path.join(logdir, "checkpoints")
    cfgdir = os.path.join(logdir, "configs")
    for d in (ckptdir, cfgdir, os.path.join(logdir, "images")):
        os.makedirs(d, exist_ok=True)
    if rank == 0:   # one writer on a shared filesystem
        with open(os.path.join(cfgdir, f"{nowname}-project.yaml"), "w") as f:
            yaml.safe_dump(config, f)

    # -- model ----------------------------------------------------------------
    spec = instantiate_from_config(config["model"])
    ckpt_path = (spec.ckpt_path if spec.ckpt_path
                 and os.path.exists(spec.ckpt_path) else None)
    if spec.ckpt_path and not ckpt_path:
        print(f"[train] ckpt {spec.ckpt_path} missing — seeded init")
    t0 = time.perf_counter()
    ld = spec.load(ckpt_path, device=dev)
    for frozen in (ld.vae, ld.clip):
        if frozen is not None:
            frozen.requires_grad_(False)
    if not ckpt_path and os.environ.get("FGDM_RANDOMIZE_ZERO_HEADS") == "1":
        # a zero-init head blocks every adapter gradient under
        # freeze_backbone (train/state.py randomize_zero_heads)
        randomize_zero_heads(ld.unet)
        print("[train] zero-init heads randomized (smoke mode)")
    if mesh is not None:   # every rank starts from rank 0's values
        for part in (ld.unet, ld.vae, ld.clip):
            if part is not None:
                replicate(mesh, part)
    print(f"[train] model on {dev} in {time.perf_counter() - t0:.2f}s")

    # -- the condition's frozen annotator (ddpm.py:137-150) -------------------
    cond_kind = spec.condition_kind()
    condition = None
    if cond_kind is not None:
        ann_dir = os.environ.get("FGDM_ANNOTATOR_DIR", "models")
        found = _load_annotator_params(cond_kind, ann_dir)
        if found is None:
            if os.environ.get("FGDM_ALLOW_RANDOM_ANNOTATORS") != "1":
                raise SystemExit(
                    f"[train] config needs the frozen {cond_kind!r} annotator "
                    f"but no checkpoint was found under {ann_dir!r}. Set "
                    "FGDM_ANNOTATOR_DIR to the checkpoint directory, or "
                    "FGDM_ALLOW_RANDOM_ANNOTATORS=1 for a smoke run.")
            print(f"[train] WARNING: {cond_kind} annotator random-init "
                  "(smoke mode — targets are meaningless)")
        t0 = time.perf_counter()
        condition = build_condition_synth(
            cond_kind, generator=torch.Generator(device=dev).manual_seed(0),
            state_dict=None if found is None else found[1], device=dev)
        if found is not None:
            missing, unexpected = condition.load_report["model"]
            print(f"[train] annotator {found[0]}: missing={len(missing)} "
                  f"unexpected={len(unexpected)}")
        if cond_kind == "sketch_to_normal":
            print("[train] WARNING: the sketch net of sketch_to_normal is "
                  "random-init (the file table names the depth net only)")
        print(f"[train] condition synthesis: {cond_kind} "
              f"({time.perf_counter() - t0:.2f}s)")

    # -- data -----------------------------------------------------------------
    data_cfg = config["data"]["params"]
    batch_size = data_cfg.get("batch_size", 8)
    train_ds = instantiate_from_config(data_cfg["train"])
    val_ds = (instantiate_from_config(data_cfg["validation"])
              if "validation" in data_cfg else None)
    tokenizer = CLIPTokenizer()
    if ckpt_path:
        tokenizer.check_production("training")

    # -- optimizer and state --------------------------------------------------
    base_lr = config["model"].get("base_learning_rate", 1e-5)
    lr = scaled_lr(base_lr, batch_size, n_dev, opt.accumulate_grad_batches,
                   scale_lr=opt.scale_lr)
    print(f"[train] lr = {lr:.2e} ({'scaled' if opt.scale_lr else 'base'}),"
          f" device={dev}, devices={n_dev}")
    sched_fn = (instantiate_from_config(spec.scheduler_config)
                if spec.scheduler_config else None)
    tx = make_adamw(lr, schedule_fn=sched_fn,
                    accumulate_steps=opt.accumulate_grad_batches)
    state = TrainState.create(
        ld.unet, tx,
        trainable_filter=adapter_filter() if spec.freeze_backbone else None,
        use_ema=spec.use_ema)
    if opt.fsdp:
        from fgdm_tpu_torch.parallel.fsdp import (MIN_FSDP_SIZE, count_fsdp,
                                                  shard_state_fsdp)

        fsdp_min = int(os.environ.get("FGDM_FSDP_MIN_SIZE", MIN_FSDP_SIZE))
        ns, total, frac = count_fsdp(mesh, state.model, min_size=fsdp_min)
        state = shard_state_fsdp(mesh, state, min_size=fsdp_min)
        print(f"[train] fsdp: {ns}/{total} parameters sharded "
              f"({frac:.0%} of the elements over {n_dev} devices)")
    mgr = CheckpointManager(ckptdir, keep=3,
                            save_interval_steps=opt.ckpt_every)

    # -- resume: params, frozen params, optimizer, EMA and step, read to the
    # host and copied into the live tensors (no second copy on the device)
    start_step = 0
    if opt.resume and mgr.latest_step() is not None:
        t0 = time.perf_counter()
        state_from_pytree(state, mgr.restore())
        start_step = state.step
        print(f"[train] resumed from {ckptdir} at step {start_step} "
              f"({time.perf_counter() - t0:.2f}s)")
    elif opt.resume:
        print(f"[train] -r given but no checkpoints in {ckptdir} — "
              "starting fresh")

    # -- scale_by_std on the first batch (ddpm.py:580-597) --------------------
    if spec.scale_by_std and start_step == 0:
        probe = next(batch_iterator(train_ds, batch_size,
                                    tokenizer=tokenizer, seed=opt.seed))
        img = to_device(probe, dev)["image"]
        if condition is not None:
            img = condition.target(img)[:, :3]   # sketch_to_normal: normal
        ld = ld.calibrate_scale_by_std(
            img, generator=torch.Generator(device=dev).manual_seed(0))
        print(f"[train] scale_by_std: scale_factor={ld.scale_factor:.5f}")

    step_fn = make_train_step(ld, parameterization=spec.parameterization,
                              condition=condition, mesh=mesh)
    distill_fn = (make_train_step(ld, distill=True,
                                  parameterization=spec.parameterization,
                                  condition=condition, mesh=mesh)
                  if spec.apply_distill_loss else None)
    eval_fn = (make_eval_step(ld, parameterization=spec.parameterization,
                              condition=condition, mesh=mesh)
               if val_ds is not None else None)

    # -- loggers (main.py:313-417,566-590) ------------------------------------
    metrics_writer = MetricsWriter(logdir) if rank == 0 else None
    img_logger = None
    for cb in ((config.get("lightning") or {}).get("callbacks")
               or {}).values():
        if str(cb.get("target", "")).endswith("ImageLogger"):
            img_logger = instantiate_from_config(cb)(logdir)
    if opt.img_log_freq > 0:
        img_logger = ImageLogger(logdir, batch_frequency=opt.img_log_freq)

    def maybe_log_images(step, batch):
        # a sharded UNet's forward is a collective: every rank samples
        if img_logger is None or not img_logger.should_log(step) or (
                rank and not opt.fsdp):
            return
        t0 = time.perf_counter()
        imgs = log_images(
            ld, batch, torch.Generator(device=dev).manual_seed(step),
            ddim_steps=20, inpaint=True, plot_denoise_rows=True,
            plot_progressive_rows=True, plot_diffusion_rows=True,
            params=state.ema.shadow if state.ema is not None else None)
        if rank == 0:
            img_logger.log(step, imgs)
        print(f"[train] images logged at step {step} "
              f"({time.perf_counter() - t0:.2f}s)")

    def val_batch(vb):
        vb = {"image": vb["image"], "input_ids": vb["input_ids"]}
        return to_device(vb if mesh is None else local_batch_slice(vb, mesh),
                         dev)

    # -- melk: a checkpoint on SIGUSR1 and on an exception (main.py:736-761) --
    done_step = [start_step - 1]   # the last step whose update is complete
    melk_requested = threading.Event()

    def save(step, force=False):
        # rank 0 writes; a sharded state is gathered by every rank first,
        # so rank 0's decision goes to all of them
        want = [rank == 0 and step not in mgr.all_steps()
                and (force or mgr.should_save(step))]
        if opt.fsdp and distributed:
            dist.broadcast_object_list(want, src=0)
        if not want[0] or (rank and not opt.fsdp):
            return
        t0 = time.perf_counter()
        tree = state_to_pytree(state)
        if rank == 0 and mgr.save(step, tree, force=force):
            print(f"[train] saved step {step} "
                  f"({os.path.getsize(mgr.path(step))} bytes, "
                  f"{time.perf_counter() - t0:.2f}s)")

    def melk():
        print("[train] melk: saving checkpoint")
        save(max(done_step[0], 0), force=True)

    if not opt.train:
        print("[train] -t not given; config validated, exiting")
        if metrics_writer is not None:
            metrics_writer.close()
        return
    previous_handler = None
    if hasattr(signal, "SIGUSR1") and \
            threading.current_thread() is threading.main_thread():
        previous_handler = signal.signal(
            signal.SIGUSR1, lambda *_: melk_requested.set())

    # -- the loop -------------------------------------------------------------
    loader = ParallelBatchLoader(
        train_ds, batch_size, tokenizer=tokenizer, seed=opt.seed,
        num_workers=opt.num_workers, prefetch_batches=2 * opt.num_workers,
        process_index=data_rank(mesh) if mesh is not None else 0,
        process_count=n_dev)
    it = device_prefetch(
        ({"image": b["image"], "input_ids": b["input_ids"],
          "captions": b["captions"]} for b in loader), device=dev, size=2,
        mesh=mesh)
    # a resume draws from --seed anew, as JAX's key restarts from it; each
    # rank draws its own rows' noise
    gen = torch.Generator(device=dev).manual_seed(opt.seed + rank)
    step = start_step
    t0 = time.time()
    pending = []   # (step, metrics on the device), read on the print cadence

    def drain_metrics():
        last = None
        for s, dev_m in pending:
            last = {k: float(v) for k, v in dev_m.items()}
            if metrics_writer is not None:
                metrics_writer.log(s, last, prefix="train")
        pending.clear()
        return last

    try:
        for batch in it:
            if 0 < opt.max_steps <= step:
                break
            use_distill = (distill_fn is not None
                           and step % spec.distill_every_n_step == 0)
            state, metrics = (distill_fn if use_distill else step_fn)(
                state, batch, gen)
            done_step[0] = step
            maybe_log_images(step, batch)
            pending.append((step, metrics))
            if step % 50 == 0:
                m = drain_metrics()
                done = step - start_step + 1
                print(f"step {step} loss {m['loss']:.4f} "
                      f"simple {m['loss_simple']:.4f} "
                      f"({done * batch_size / max(time.time() - t0, 1e-9):.1f}"
                      f" img/s)", flush=True)
            if eval_fn is not None and opt.val_every and step \
                    and step % opt.val_every == 0:
                vb = next(batch_iterator(val_ds, batch_size,
                                         tokenizer=tokenizer, shuffle=False))
                vm = eval_fn(state, val_batch(vb),
                             torch.Generator(device=dev).manual_seed(0))
                vm = {k: float(v) for k, v in vm.items()}
                print("  val:", {k: round(v, 4) for k, v in vm.items()})
                if metrics_writer is not None:
                    metrics_writer.log(step, vm, prefix="val")
            if melk_requested.is_set():
                melk_requested.clear()
                melk()
            save(step)
            step += 1
    except (KeyboardInterrupt, Exception):
        # the rescue save must not hide the error (a device OOM, say)
        try:
            melk()
        except Exception as save_err:
            print(f"[train] melk failed during crash handling: "
                  f"{save_err!r}")
        raise
    finally:
        # a max_steps break leaves the loader's threads and the prefetched
        # batches alive; close them before the test pass
        it.close()
        drain_metrics()
        if metrics_writer is not None:
            metrics_writer.close()
        if previous_handler is not None:
            signal.signal(signal.SIGUSR1, previous_handler)
    melk()
    print(f"[train] done at step {step}")

    # -- the test pass after fitting (trainer.test unless --no-test) ----------
    if not opt.no_test and eval_fn is not None:
        agg: dict = {}
        nb = 0
        for vb in batch_iterator(val_ds, batch_size, tokenizer=tokenizer,
                                 shuffle=False, epochs=1):
            vm = eval_fn(state, val_batch(vb),
                         torch.Generator(device=dev).manual_seed(0))
            for k, v in vm.items():
                agg[k] = agg.get(k, 0.0) + float(v)
            nb += 1
        if nb:
            print("[test]", {k: round(v / nb, 4) for k, v in agg.items()})


if __name__ == "__main__":
    main()
