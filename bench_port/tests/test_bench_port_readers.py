"""The per-layer readers on synthetic traces, counters and spans."""

from __future__ import annotations

import pytest

from bench_port import flops, harness, trace
from bench_port.trace import Summary, summarize, union_ns


def test_union_counts_overlaps_once_and_clips():
    recs = [("a", 0, 10), ("b", 5, 15), ("c", 20, 30), ("d", 25, 26),
            ("e", 40, 60)]
    assert union_ns(recs, 0, 100) == 15 + 10 + 20
    assert union_ns(recs, 8, 45) == 7 + 10 + 5


def _events(run, lead=3, trail=4, lost=()):
    """Pads of ``lead`` and ``trail`` spin launches around ``run``'s
    (name, start, end) launches; correlation ids in launch order; the
    records of ``lost`` run indices dropped."""
    ev, c, t = [], 0, 0
    for _ in range(lead):
        c += 1
        ev += [("launch", "cudaLaunchKernel", c, 0, 0),
               ("device", "spin", c, t, t + 5)]
        t += 5
    for i, (name, s, e) in enumerate(run):
        c += 1
        ev.append(("launch", "cudaLaunchKernel", c, 0, 0))
        if i not in lost:
            ev.append(("device", name, c, t + s, t + e))
    end = t + max(e for _, _, e in run) + 100
    for j in range(trail):
        c += 1
        ev += [("launch", "cudaLaunchKernel", c, 0, 0),
               ("device", "spin", c, end + 5 * j, end + 5 * j + 5)]
    return ev


def test_summary_window_busy_launches_and_lost():
    run = [("k1", 10, 30), ("k2", 20, 40), ("copy", 60, 70)]
    s = summarize(_events(run), 3, 4)
    assert (s.launches, s.lost) == (3, 0)
    assert (s.start_ns, s.end_ns) == (15, 15 + 70 + 100)
    assert s.busy_s == pytest.approx(40e-9)
    assert s.by_name()["k1"] == (1, pytest.approx(20e-9))
    s = summarize(_events(run, lost=(1,)), 3, 4)
    assert (s.launches, s.lost) == (3, 1)
    assert s.matching("k")[0] == 1
    gaps = s.idle_gaps()
    assert gaps[0][1] == pytest.approx(100e-9)


def _rec(records, counters, work=8, window_s=2.0, flops_=0.0):
    rec = harness.Record()
    rec.trace = Summary(records, launches=1000, start_ns=0,
                        end_ns=2_000_000_000, lost=0)
    rec.counters, rec.work, rec.window_s, rec.flops = (counters, work,
                                                       window_s, flops_)
    return rec


def test_roofline_sums_bounds_over_kernel_time():
    key = (16, 8, 4096, 4096, 40, False, "bfloat16")
    least = flops.attn_fwd_bound(*key)
    # three launches at twice their least time, one combine pass
    recs = [("void flash_fwd_kernel<40>", 0, int(2 * least * 1e9))] * 3 + [
        ("flash_combine_kernel", 0, 1000)]
    rec = _rec(recs, {"flash_attention": {key: 3}, "flash_combine": {
        (1, 1, 1024, 8, "bfloat16"): 1}})
    got = harness.metric_reader("attn_fwd_roofline.offline").read(rec)
    assert got == pytest.approx(100 * 3 * least / (3 * 2 * least + 1e-6),
                                rel=1e-4)


def test_roofline_scales_a_family_whose_records_were_lost():
    key = (8, 320, 320, 64, 64, "bfloat16")
    least = flops.conv_bound(*key)
    ns = int(4 * least * 1e9)
    recs = [("conv3x3_wgmma_kernel<2>", 0, ns)] * 9 + [
        ("nchw_to_nhwc_kernel", 0, ns // 4)] * 10
    rec = _rec(recs, {"conv3x3_kernel": {key: 10},
                      "nchw_to_nhwc": {(8, 320, 64, 64, "bfloat16"): 10}})
    got = harness.metric_reader("conv_roofline.offline").read(rec)
    assert got == pytest.approx(100 * least / (ns / 1e9 * 1.25), rel=1e-3)


def test_roofline_is_silent_without_its_kernels():
    rec = _rec([("other", 0, 100)], {"group_norm_silu_kernel": {}})
    assert harness.metric_reader("gn_roofline.offline").read(rec) is None
    rec = _rec([("gn_silu_kernel<bf16>", 0, 100)],
               {"group_norm_silu_kernel": {((2, 320, 64, 64), 1e-5,
                                            "bfloat16"): 1}})
    assert harness.metric_reader("gn_roofline.offline").read(rec) > 0
    rec.trace = None
    assert harness.metric_reader("gn_roofline.offline").read(rec) is None


def test_bwd_roofline_reads_both_kernels():
    key = (8, 8, 1024, 1024, 40, "bfloat16")
    k5, k6 = flops.attn_bwd_bounds(*key)
    recs = [("flash_bwd_dq_kernel<40>", 0, int(3e9 * k5)),
            ("flash_bwd_dkv_kernel<40>", 0, int(3e9 * k6))]
    rec = _rec(recs, {"flash_attention_bwd_dq": {key: 1},
                      "flash_attention_bwd_dkv": {key: 1}})
    got = harness.metric_reader("attn_bwd_roofline.train").read(rec)
    assert got == pytest.approx(100 / 3, rel=1e-3)


def test_counts_shares_and_spans():
    recs = [("void at::native::direct_copy_kernel_cuda", 0, 4_000_000),
            ("nchwToNhwcKernel", 0, 2_000_000),
            ("nchw_to_nhwc_kernel", 0, 50_000_000),
            ("k", 0, 1_000_000_000)]
    rec = _rec(recs, {}, work=8, window_s=2.0, flops_=8 * 65e12)
    read = lambda n: harness.metric_reader(n).read(rec)  # noqa: E731
    assert read("launches_per_image.offline") == 125.0
    assert read("copy_cast_ms_per_image.offline") == pytest.approx(6 / 8)
    assert read("idle_share.offline") == pytest.approx(50.0)
    assert read("mfu.offline") == pytest.approx(100 * 4 * 65e12 / 989e12)
    rec.spans["generate"] += [3.0, 1.0, 2.0]
    rec.spans["next_batch"] += [0.001, 0.003]
    assert read("engine_batch_s.offline") == 2.0
    assert read("input_wait_ms.train") == pytest.approx(2.0)


def test_layer_values_read_host_metrics_from_the_untraced_window():
    """With ``--trace 1`` the host-clock and span metrics come from the
    untraced window, the device-trace ones from the traced window."""
    from bench_port import run

    plain = harness.Record()
    plain.work, plain.window_s, plain.flops = 16, 8.0, 16 * 65e12
    plain.spans["generate"] += [4.0, 4.0]
    traced = _rec([("k", 0, 1_500_000_000)], {}, work=8, window_s=6.0,
                  flops_=8 * 65e12)
    traced.spans["generate"] += [6.0]
    cell = harness.find_cell("chain_offline_b8")
    got = run.layer_values(cell.per_layer, plain, traced)
    assert got["engine_batch_s.offline"] == 4.0
    assert got["mfu.offline"] == pytest.approx(100 * 2 * 65e12 / 989e12)
    assert got["idle_share.offline"] == pytest.approx(25.0)
    assert got["launches_per_image.offline"] == 125.0


def test_trace_families_keep_kernel_names_apart():
    names = ["flash_fwd_kernel", "flash_fwd_d512_kernel",
             "flash_fwd_f32_kernel", "flash_fwd_d512_f32_kernel",
             "flash_bwd_dq_kernel", "flash_bwd_dq_f32_kernel",
             "nchw_to_nhwc_kernel", "nchw_to_nhwc_f32_kernel"]
    for a in names:
        assert [b for b in names if a in b] == [a]
    assert trace.PAD_LAUNCHES[0] > 0
