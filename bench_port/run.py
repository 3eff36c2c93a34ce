"""Run one cell of the port's benchmark once.

    python3 -m bench_port.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The run loads, builds and warms up (all of
it ``setup_s``), collects and freezes the interpreter's garbage, then
measures for ``--seconds`` with no tracer on and reads the end-to-end
metrics from that window (``--trace 0``).  With ``--trace 1`` a traced
window follows the untraced one: the per-layer metrics of the device trace
are read from it, the others (host clock, the benchmark's spans) from the
untraced window, where the profiler does not slow the host.  Then the run
frees the program, checks a sample of what the windows produced against
the plain reference, checks that no module of the reference package or its
toolchain was loaded, and prints one JSON line: the last line of standard
output.  The numbers compared, each beside its limit, are the last lines
of standard error and the last key of that line.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def device_info(torch, chips: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(chips))}


# the traced window's length, as a share of ``--seconds``: its metrics are
# per image, per launch or shares, and reading the trace takes longer than
# the window
TRACED_SHARE = 0.5


def _spread(v) -> str:
    """min / median / max of a span's durations, and their count."""
    return (f"{min(v):.4f}/{statistics.median(v):.4f}/{max(v):.4f} s "
            f"x{len(v)}")


def layer_values(per_layer, plain, traced) -> dict:
    """The per-layer metrics that have something to read: those of the
    device trace from the traced window's record, the others from the
    untraced window's."""
    from bench_port import harness

    values = {}
    for m in per_layer:
        rec = traced if m["source"] == "device_trace" else plain
        v = harness.metric_reader(m["name"]).read(rec)
        if v is not None:
            values[m["name"]] = v
    return values


def run(args, device=None, chips_check=True, root=None) -> dict:
    """One run; returns the result line's object.  ``chips_check=False``
    and a ``device`` let the tests drive a run on the CPU (``root``: the
    directory holding the ``BENCHMARK.json`` to read)."""
    import torch

    from bench_port import harness, host, trace

    cell = harness.find_cell(args.workload, root=root or harness.ROOT)
    if chips_check:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < cell.chips:
            raise SystemExit(f"bench_port: {args.workload} needs {cell.chips} "
                             f"CUDA device(s), found {have}")
        device = torch.device("cuda", 0)
    entry, setup_rec = cell.entry, harness.Record()
    setup_rec.span("python_and_torch", T0, time.perf_counter())
    on_card = device.type == "cuda"
    if on_card:
        with setup_rec.timed("cuda_init"):
            torch.zeros(1, device=device)
            torch.cuda.synchronize()
    st = entry.setup(cell.config, cell.traffic, args.seed, device, setup_rec)
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    # what set-up made stays: later collections walk only the window's
    # objects
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - T0
    log(f"set-up {setup_s:.3f} s: " + ", ".join(
        f"{k} {sum(v):.3f} s" for k, v in setup_rec.spans.items()))
    rec = harness.Record()
    with host.Watch() as watch:
        entry.window(st, args.seconds, rec)
    hostinfo = watch.summary()
    log(f"window {rec.window_s:.3f} s, {rec.work} images; "
        + ", ".join(f"{k} {_spread(v)}" for k, v in rec.spans.items())
        + f"; host {hostinfo}")
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if on_card:
        dev = device_info(torch, cell.chips)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 1,
               "memory_peak_bytes": 0}
    if args.trace:
        traced = harness.Record()
        if on_card:
            trace.reset_counters()
        with trace.Tracer() as tr:
            entry.window(st, args.seconds * TRACED_SHARE, traced)
        traced.trace = tr.summary
        if on_card:
            traced.counters = trace.read_counters()
            dev = device_info(torch, cell.chips)
        log(f"traced window {traced.trace.window_s:.3f} s, busy "
            f"{traced.trace.busy_s:.3f} s, {traced.trace.launches} launches, "
            f"{traced.trace.lost} kernel records lost")
        values = layer_values(cell.per_layer, rec, traced)
        dev["busy_s"] = traced.trace.busy_s
        dev["window_s"] = traced.trace.window_s
    else:
        values = dict(entry.end_to_end(st, rec), setup_s=setup_s)
    attempted = entry.attempted(st)
    entry.release(st)
    checks = entry.check(st, rec)
    log(f"reference {sum(rec.spans['reference']):.3f} s")
    found = harness.forbidden_modules()
    if found:
        raise SystemExit("bench_port: the run loaded "
                         + ", ".join(found))
    correct = all(v <= lim for v, lim in checks.values())
    out = {"correct": correct, "attempted": attempted,
           "failed": 0,
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in values.items()},
           "device": dev, "host": hostinfo}
    if args.trace:
        out["breakdown"] = {
            "device_ops": trace.device_ops(traced.trace),
            "idle_gaps": [[n, s] for n, s in traced.trace.idle_gaps()]}
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in checks.items()}
    for k, (v, lim) in checks.items():
        log(f"check {k} {v!r} limit {lim!r} "
            f"{'ok' if v <= lim else 'FAILED'}")
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    torch.set_num_threads(1)   # one process, few threads: a steadier host
    try:
        out = run(args)
    except SystemExit as e:
        log(str(e))
        return 2
    except Exception:   # the run failed: no result line
        traceback.print_exc()
        return 1
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
