"""On-card smoke test of the fgdm_tpu_torch port (one NVIDIA GPU).

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, then:

1. prints the card's name and power limit;
2. holds every kernel against its plain PyTorch version on the card at the
   shapes the main path gives it, and times kernel, plain version and the
   PyTorch library call that computes the same function (the yardstick,
   never used by the port);
3. runs one full-width SD-1.4 UNet forward (with the FG-DM adapter) with the
   kernels on and with the plain versions, and compares;
4. drives the full-width text->seg->image chain (``builders.build_chain`` +
   ``fgdm_chain``: 50 + 20 DDIM steps, batch 1, seeded random weights and
   contexts) with every launch count set to 0 just before, checks the image
   and that each kernel launched, then profiles one more run for the
   device time by kernel;
5. prints ``{"kernels": [...]}`` and, last, the ``{"ok": true, ...}`` line.

Exits non-zero, printing no result, if there is no CUDA device or any phase
fails.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time

PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 tensor-core rate
PEAK_F32_FLOPS = 67e12     # H100 SXM f32 outside the tensor cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3 rate

ATTN_SRC = "fgdm_tpu_torch/kernels/csrc/flash_attn_fwd.cu"
GN_SRC = "fgdm_tpu_torch/kernels/groupnorm.py"
K1 = "fgdm_tpu/kernels/attention.py:157"   # _flash_kernel_t
K2 = "fgdm_tpu/kernels/attention.py:121"   # _flash_kernel
K3 = "fgdm_tpu/kernels/attention.py:516"   # _flash_kernel_kv
K4 = "fgdm_tpu/kernels/groupnorm.py:68"    # _kernel

# (label, TPU kernel, B*CFG, heads, N, d): the self-attention shapes of the
# chain at batch 1 (CFG doubles the UNet batch; the VAE decodes batch 1).
ATTN_CASES = [
    ("flash_attn_fwd d40 N1024", K1, 2, 8, 1024, 40),
    ("flash_attn_fwd d40 N4096", K1, 2, 8, 4096, 40),
    ("flash_attn_fwd d80 N1024", K1, 2, 8, 1024, 80),
    ("flash_attn_fwd d512 N1024", K2, 1, 1, 1024, 512),
    ("flash_attn_fwd d512 N4096", K3, 1, 1, 4096, 512),
]
# (label, shape, eps): GroupNorm+SiLU shapes of UNet/ControlNet ResBlocks
# (eps 1e-5) and VAE ResnetBlocks (eps 1e-6).
GN_CASES = [
    ("group_norm_silu [2,320,64,64]", (2, 320, 64, 64), 1e-5),
    ("group_norm_silu [2,2560,8,8]", (2, 2560, 8, 8), 1e-5),
    ("group_norm_silu [1,512,64,64]", (1, 512, 64, 64), 1e-6),
    ("group_norm_silu [1,128,512,512]", (1, 128, 512, 512), 1e-6),
]
ATTN_TOL = (1e-2, 1e-3)   # max|d| <= 1e-2 * max|ref| + 1e-3 (bf16 out, P)
GN_TOL = 1e-2             # max |d| / (1 + |ref|) (bf16 output rounding)
UNET_TOL = 5e-2           # max|d| / max|ref| of the UNet eps, bf16 chain


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels():
    """nvcc the CUDA source and compile the Triton programs once."""
    import torch
    from fgdm_tpu_torch.kernels import _build, attention, groupnorm

    t0 = time.perf_counter()
    lib_path = _build.build("flash_attn_fwd")
    attention._lib()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f}s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas: " + line.strip())
    x = torch.randn(1, 128, 8, 8, device="cuda", dtype=torch.bfloat16)
    w = torch.ones(128, device="cuda")
    t0 = time.perf_counter()
    for silu in (True, False):
        groupnorm.group_norm_silu_kernel(x, w, w, 32, 1e-5, silu)
    torch.cuda.synchronize()
    log(f"compiled Triton GroupNorm in {time.perf_counter() - t0:.1f}s")


def phase_kernels():
    """Each kernel against its plain version at the main path's shapes."""
    import torch
    import torch.nn.functional as F
    from fgdm_tpu_torch.kernels import attention, groupnorm

    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for label, tpu, b, h, n, d in ATTN_CASES:
        q, k, v = (torch.randn(b, h, n, d, device="cuda", generator=gen,
                               dtype=torch.bfloat16) for _ in range(3))
        scale = d ** -0.5
        out = attention.flash_attention(q, k, v, scale)
        ref = attention.attention_ref(q, k, v, scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        lim = ATTN_TOL[0] * ref.float().abs().max().item() + ATTN_TOL[1]
        ok = math.isfinite(err) and err <= lim
        reps = 20 if n >= 4096 else 50
        ms = cuda_ms(lambda: attention.flash_attention(q, k, v, scale), reps)
        plain_ms = cuda_ms(lambda: attention.attention_ref(q, k, v, scale),
                           reps)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, scale=scale), reps)
        flops = 4.0 * b * h * n * n * d
        nbytes = 4.0 * b * h * n * d * 2
        t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
        rows.append(dict(
            name=label, route="cuda", source=ATTN_SRC, replaces=tpu,
            key=("attn", d, n, n), max_abs_err=err, tol=lim, ok=ok, ms=ms,
            plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=lib_ms))
        log(f"{label}: max|d|={err:.3e} (tol {lim:.3e}) {'OK' if ok else 'FAIL'}"
            f"  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f}"
            f" ms  bound {rows[-1]['bound_ms']:.4f} ms")
    for label, shape, eps in GN_CASES:
        c = shape[1]
        x = torch.randn(shape, device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w = 1 + 0.1 * torch.randn(c, device="cuda", generator=gen)
        bias = 0.1 * torch.randn(c, device="cuda", generator=gen)
        out = groupnorm.group_norm_silu_kernel(x, w, bias, 32, eps, True)
        ref = groupnorm.group_norm_silu_ref(x, w, bias, 32, eps, True)
        torch.cuda.synchronize()
        rel = ((out.float() - ref.float()).abs()
               / (1 + ref.float().abs())).max().item()
        err = (out.float() - ref.float()).abs().max().item()
        ok = math.isfinite(rel) and rel <= GN_TOL
        reps = 20 if x.numel() > 1 << 24 else 100
        ms = cuda_ms(lambda: groupnorm.group_norm_silu_kernel(
            x, w, bias, 32, eps, True), reps)
        plain_ms = cuda_ms(lambda: groupnorm.group_norm_silu_ref(
            x, w, bias, 32, eps, True), reps)
        wb, bb = w.to(x.dtype), bias.to(x.dtype)
        lib_ms = cuda_ms(lambda: F.silu(F.group_norm(x, 32, wb, bb, eps)),
                         reps)
        nbytes = 2.0 * x.numel() * x.element_size() + 2 * c * 4
        flops = 8.0 * x.numel()   # sums, affine, SiLU: ~8 f32 ops/element
        t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
        rows.append(dict(
            name=label, route="triton", source=GN_SRC, replaces=K4,
            key=("gn", shape, eps), max_abs_err=err, tol=GN_TOL, ok=ok, ms=ms,
            plain_ms=plain_ms, bound_ms=1e3 * max(t_ops, t_bytes),
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            library_ms=lib_ms))
        log(f"{label} eps={eps}: max|d|={err:.3e} max|d|/(1+|ref|)={rel:.3e}"
            f" (tol {GN_TOL}) {'OK' if ok else 'FAIL'}  kernel {ms:.4f} ms"
            f"  plain {plain_ms:.4f} ms  F.group_norm+silu {lib_ms:.4f} ms"
            f"  bound {rows[-1]['bound_ms']:.4f} ms")
    return rows


@contextlib.contextmanager
def plain_path():
    """Route every gate to the plain versions (for the on/off comparison)."""
    from fgdm_tpu_torch.kernels import attention, groupnorm

    saved = attention.use_flash, groupnorm.use_fused_gn
    attention.use_flash = lambda *a, **k: False
    groupnorm.use_fused_gn = lambda *a, **k: False
    try:
        yield
    finally:
        attention.use_flash, groupnorm.use_fused_gn = saved


def reset_counts():
    from fgdm_tpu_torch.kernels import attention, groupnorm

    attention.flash_attention.launches.clear()
    groupnorm.group_norm_silu_kernel.launches.clear()


def phase_unet():
    """One full-width factor-1 UNet forward, kernels on vs plain."""
    import torch
    from fgdm_tpu_torch.builders import build_unet

    unet = build_unet(device="cuda", use_adapter=True, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn(2, 4, 32, 32, device="cuda", generator=gen)
    t = torch.tensor([981, 981], device="cuda")
    ctx = torch.randn(2, 77, 768, device="cuda", generator=gen)
    with torch.inference_mode():
        reset_counts()
        on = unet(x, t, context=ctx)
        torch.cuda.synchronize()
        from fgdm_tpu_torch.kernels import attention, groupnorm

        n_attn = sum(attention.flash_attention.launches.values())
        n_gn = sum(groupnorm.group_norm_silu_kernel.launches.values())
        with plain_path():
            off = unet(x, t, context=ctx)
        torch.cuda.synchronize()
    rel = ((on - off).abs().max() / off.abs().max()).item()
    ok = (math.isfinite(rel) and rel <= UNET_TOL and n_attn > 0 and n_gn > 0
          and bool(torch.isfinite(on).all()))
    log(f"UNet f1 forward [2,4,32,32]: kernels on vs plain max|d|/max|ref| = "
        f"{rel:.3e} (tol {UNET_TOL}); flash launches {n_attn}, groupnorm "
        f"launches {n_gn}; {'OK' if ok else 'FAIL'}")
    del unet
    torch.cuda.empty_cache()
    return ok


def phase_chain():
    """The full-width chain at batch 1, 50 + 20 steps.  The first run is the
    main path's run: every launch count is set to 0 just before it and read
    just after.  A second run on the same inputs gives the warm wall time
    and must reproduce the first."""
    import torch
    from fgdm_tpu_torch.builders import build_chain
    from fgdm_tpu_torch.kernels import attention, groupnorm
    from fgdm_tpu_torch.sampling.chain import fgdm_chain

    t0 = time.perf_counter()
    ld, cldm = build_chain(device="cuda", seed=0)
    torch.cuda.synchronize()
    log(f"built the chain's models in {time.perf_counter() - t0:.1f}s")
    gen = torch.Generator(device="cuda").manual_seed(3)
    ctxs = [torch.randn(1, 77, 768, device="cuda", generator=gen)
            for _ in range(4)]

    def run():
        t0 = time.perf_counter()
        out = fgdm_chain(ld, cldm, *ctxs, f1_steps=50, f2_steps=20,
                         slot_seeds=[1234])
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    reset_counts()
    out, cold = run()
    attn = dict(attention.flash_attention.launches)
    gn = dict(groupnorm.group_norm_silu_kernel.launches)
    torch.cuda.reset_peak_memory_stats()
    again, warm = run()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    img = out["image"].float()
    finite = bool(torch.isfinite(img).all())
    std = img.std().item()
    repeat = (again["image"].float() - img).abs().max().item()
    ok = (finite and std > 1e-4
          and tuple(img.shape) == (1, 3, 512, 512)
          and tuple(out["condition"].shape) == (1, 3, 256, 256))
    log(f"chain: image {tuple(img.shape)} finite={finite} std={std:.4e} "
        f"mean={img.mean().item():.4e} rerun max|d|={repeat:.3e}; wall "
        f"{cold:.3f}s first run (kernel compiles included), {warm:.3f}s "
        f"second run (host clock); peak memory {peak_gib:.2f} GiB; "
        f"{'OK' if ok else 'FAIL'}")
    log("chain flash launches by (d, nq, nk): "
        + json.dumps({str(k): v for k, v in sorted(attn.items())}))
    log("chain groupnorm launches by (shape, eps): "
        + json.dumps({str(k): v for k, v in sorted(gn.items())}))
    profile_chain(run, warm)
    return ok, attn, gn, warm


def profile_chain(run, warm_s):
    """Device time by kernel over one more chain run (torch.profiler), and
    the device's busy share: that kernel time over the unprofiled warm wall
    time.  Prints "not measured" if the trace holds no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            us = e.time_range.end - e.time_range.start
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + us)
    total_ms = sum(t for _, t in by_name.values()) / 1e3
    if total_ms == 0:
        log("chain device time by kernel: not measured (no device events)")
        return
    log(f"chain device kernel time {total_ms:.1f} ms over a warm wall of "
        f"{1e3 * warm_s:.1f} ms: device busy share "
        f"{total_ms / (1e3 * warm_s):.3f}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    for name, (n, t) in top:
        log(f"  {t / 1e3:9.2f} ms {100 * t / 1e3 / total_ms:5.1f}% "
            f"{n:6d}x  {name[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: no CUDA device")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    build_kernels()
    rows = phase_kernels()
    unet_ok = phase_unet()
    chain_ok, attn, gn, _ = phase_chain()

    failures = [r["name"] for r in rows if not r["ok"]]
    for r in rows:
        kind = r["key"][0]
        if kind == "attn":
            r["launches"] = attn.get(r["key"][1:], 0)
        else:
            r["launches"] = gn.get((r["key"][1], r["key"][2]), 0)
    for r in rows[:len(ATTN_CASES)]:
        if r["launches"] == 0:
            failures.append(f"{r['name']} not launched by the chain")
    if sum(gn.values()) == 0:
        failures.append("group_norm_silu not launched by the chain")
    if not unet_ok:
        failures.append("UNet kernels-on vs plain")
    if not chain_ok:
        failures.append("chain output")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("total launches in the chain: flash_attn_fwd "
        f"{sum(attn.values())}, group_norm_silu {sum(gn.values())}")
    if failures:
        log("FAILED: " + "; ".join(failures))
        return 1
    log(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
