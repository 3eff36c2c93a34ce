"""The port's span recorder (``fgdm_tpu_torch/utils/profiling.py``): off
without a profiler, the stages of a tiny engine call and training step
under one, on the profiler's clock, per thread, and the idle-time
attribution ``idle_within``.

The tiny pipelines are the geometries of ``tests/test_torch_serving.py``
and ``tests/test_torch_train.py`` with seeded random weights, float32 on
the CPU.  The card test checks that the spans share the device trace's
clock; it skips without a CUDA card (decided inside the test) and runs on
the card with ``python -m pytest tests/test_torch_profiling.py -m chip
--noconftest``.
"""

import collections
import threading

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fgdm_tpu_torch import builders  # noqa: E402
from fgdm_tpu_torch.diffusion.control import ControlLDM  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.serving import ChainEngine  # noqa: E402
from fgdm_tpu_torch.train import state as tstate  # noqa: E402
from fgdm_tpu_torch.train.train_step import make_train_step  # noqa: E402
from fgdm_tpu_torch.utils import profiling  # noqa: E402

torch.set_num_threads(2)

UNET = dict(model_channels=32, num_heads=4, context_dim=64,
            channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_res_blocks=1)
VAE = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1, resolution=64,
           z_channels=4, embed_dim=4)
CLIP = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
F1_STEPS, F2_STEPS = 4, 2   # DDIM takes exactly these (1000 divides by both)
F32 = dict(dtype=torch.float32, device="cpu")
MS = 1_000_000   # ns


def _seeded(m, gen, perturb=0.02):
    return init_params_(m, gen, perturb)


@pytest.fixture(scope="module")
def engine():
    gen = torch.Generator().manual_seed(0)
    vae = _seeded(AutoencoderKL(**VAE, **F32), gen, 0.0).eval()
    clip = _seeded(CLIPTextEncoder(**CLIP, device="cpu"), gen).eval()
    sched = builders.sd14_schedule()
    ld = LatentDiffusion(_seeded(UNetModel(**UNET, **F32), gen).eval(), vae,
                         sched, clip=clip)
    cldm = ControlLDM(
        _seeded(UNetModel(**UNET, use_adapter=False, **F32), gen).eval(),
        vae, sched, clip=clip,
        control=_seeded(ControlNet(**UNET, **F32), gen).eval(),
        control_scales=(1.0,) * 5)
    return ChainEngine(ld, cldm, max_batch=2, cond_hw=(64, 64),
                       image_hw=(64, 64), f1_steps=F1_STEPS,
                       f2_steps=F2_STEPS, warmup=False)


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(scope="module")
def traced_call(engine):
    """The spans and the profiler's own events of one engine call."""
    profiling.clear()
    with _cpu_profile() as prof:
        engine.generate(["a cat", "a dog"], seeds=[1, 2])
    got = profiling.spans()
    profiling.clear()
    return got, prof


def _ancestors(s, by_id):
    out = []
    while s.parent is not None:
        s = by_id[s.parent]
        out.append(s.name)
    return out


def test_off_without_a_profiler_returns_one_object_and_keeps_nothing(
        engine):
    profiling.clear()
    a, b = profiling.span("x"), profiling.span("y", factor=1)
    assert a is b
    with a:
        pass
    engine.generate(["a cat"], seed=3)
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_engine_call_records_its_stages_under_one_root(traced_call):
    got, _ = traced_call
    by_id = {s.id: s for s in got}
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "engine.generate" and root.root == root.id
    assert all(s.root == root.id for s in got)
    parents = collections.Counter(
        (s.name, by_id[s.parent].name) for s in got if s.parent is not None)
    assert parents == {
        ("engine.contexts", "engine.generate"): 1,
        ("chain.condition", "engine.generate"): 1,
        ("vae.decode", "engine.generate"): 2,
        ("chain.hint", "engine.generate"): 1,
        ("chain.image", "engine.generate"): 1,
        ("engine.to_host", "engine.generate"): 1,
        ("sampler.step", "chain.condition"): F1_STEPS,
        ("sampler.step", "chain.image"): F2_STEPS}
    (cond,) = [s for s in got if s.name == "chain.condition"]
    assert cond.attrs == {"factor": 0}
    for s in got:   # a child lies inside its parent
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns <= s.end_ns <= up.end_ns
    steps = [s for s in got if s.name == "sampler.step"]
    assert all(_ancestors(s, by_id)[-1] == "engine.generate" for s in steps)


def test_spans_lie_on_their_record_function_events(traced_call):
    """Each span's start and end within 1 ms of its own ``record_function``
    event in the profiler's results: one clock."""
    got, prof = traced_call
    events = collections.defaultdict(list)
    cpu = torch.autograd.DeviceType.CPU
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cpu and e.is_user_annotation():
            events[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    names = {s.name for s in got}
    for name in names:
        mine = sorted((s.start_ns, s.end_ns) for s in got if s.name == name)
        theirs = sorted(events[name])
        assert len(mine) == len(theirs), name
        for (s, e), (rs, re_) in zip(mine, theirs):
            assert abs(s - rs) < MS and abs(e - re_) < MS, (name, s - rs,
                                                            e - re_)


@pytest.fixture(scope="module")
def trainer():
    gen = torch.Generator().manual_seed(5)
    unet = _seeded(UNetModel(**UNET, **F32), gen).train()
    vae = _seeded(AutoencoderKL(**VAE, **F32), gen).eval()
    clip = _seeded(CLIPTextEncoder(vocab_size=128, embed_dim=64,
                                   num_layers=1, num_heads=4, device="cpu"),
                   gen).eval()
    ld = LatentDiffusion(unet, vae.requires_grad_(False), builders
                         .sd14_schedule(), clip=clip.requires_grad_(False))
    state = tstate.TrainState.create(
        unet, tstate.make_adamw(1e-4), use_ema=True,
        trainable_filter=tstate.adapter_filter())
    batch = {"image": torch.rand((4, 3, 64, 64), generator=gen) * 2 - 1,
             "input_ids": torch.randint(0, 128, (4, 77), generator=gen)}
    return ld, state, batch


@pytest.mark.parametrize("distill", [False, True])
def test_train_step_records_encode_forward_backward_update(trainer,
                                                           distill):
    ld, state, batch = trainer
    step = make_train_step(ld, distill=distill)
    profiling.clear()
    with _cpu_profile():
        step(state, batch, torch.Generator().manual_seed(6))
    got = profiling.spans()
    profiling.clear()
    (root,) = [s for s in got if s.parent is None]
    assert root.name == "train.step" and root.attrs == {"distill": distill}
    kids = sorted((s for s in got if s.parent == root.id),
                  key=lambda s: s.start_ns)
    assert [s.name for s in kids] == ["train.encode", "train.forward",
                                      "train.backward", "train.update"]
    assert all(s.root == root.id for s in got)
    for a, b in zip(kids, kids[1:]):
        assert a.end_ns <= b.start_ns


def test_spans_in_two_threads_nest_within_their_own_thread():
    """Two threads open their spans interleaved: each inner span's parent
    is its own thread's outer span, never the other thread's."""
    profiling.clear()
    gate = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"{tag}.outer"):
            gate.wait()
            with profiling.span(f"{tag}.inner"):
                gate.wait()

    with _cpu_profile():
        with profiling.span("main"):
            threads = [threading.Thread(target=work, args=(t,))
                       for t in ("a", "b")]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
    got = {s.name: s for s in profiling.spans()}
    profiling.clear()
    for tag in ("a", "b"):
        outer, inner = got[f"{tag}.outer"], got[f"{tag}.inner"]
        assert outer.parent is None and outer.root == outer.id
        assert inner.parent == outer.id and inner.root == outer.id
    assert got["main"].parent is None


def test_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 3)
    profiling.clear()
    with _cpu_profile():
        for _ in range(5):
            with profiling.span("s"):
                pass
    assert len(profiling.spans()) == 3 and profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


# --- idle_within --------------------------------------------------------------

# device busy [100, 300] (two streams overlapping), [500, 600], [900, 950]
# of the window [0, 1000]: idle [0, 100], [300, 500], [600, 900], [950,
# 1000], 650 in all
RECORDS = [("k", 100, 200), ("copy", 150, 300), ("k", 500, 600),
           ("k", 900, 950)]


@pytest.mark.parametrize("intervals, want", [
    ([(0, 1000)], 650),
    ([(120, 550)], 200),
    ([(120, 550), (200, 520)], 200),          # overlapping spans count once
    ([(250, 350), (580, 620)], 50 + 20),
    ([(-50, 50), (980, 1200)], 50 + 20),      # clipped at the window's edges
    ([(100, 300)], 0),
    ([], 0),
])
def test_idle_within(intervals, want):
    assert profiling.idle_within(RECORDS, 0, 1000, intervals) == want


def test_disjoint_intervals_covering_the_window_partition_its_idle_time():
    cuts = [0, 130, 310, 505, 777, 940, 1000]
    parts = [profiling.idle_within(RECORDS, 0, 1000, [(a, b)])
             for a, b in zip(cuts, cuts[1:])]
    assert sum(parts) == profiling.idle_within(RECORDS, 0, 1000,
                                               [(0, 1000)]) == 650
    # a window narrower than the records: they are clipped too
    assert profiling.idle_within(RECORDS, 150, 550, [(0, 2000)]) == 200


# --- on the card ----------------------------------------------------------------

@pytest.mark.chip
def test_device_record_lies_in_its_span_on_the_card():
    """Under the benchmark's CUDA-only tracer, a spin kernel's device record
    lies inside the span around its launch and a ``synchronize()``, give or
    take 50 us: spans and device records share one clock."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the device trace's clock")
    from bench_port import trace

    torch.zeros(1, device="cuda")
    profiling.clear()
    with trace.Tracer() as tr:
        with profiling.span("probe.sleep"):
            torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize()
    (s,) = [x for x in profiling.spans() if x.name == "probe.sleep"]
    profiling.clear()
    assert len(tr.summary.records) == 1, tr.summary.records
    rec = tr.summary.records[0]
    slack = 50_000
    print({"span": [s.start_ns, s.end_ns], "record": rec[1:],
           "lead_ns": rec[1] - s.start_ns, "tail_ns": s.end_ns - rec[2]})
    assert s.start_ns - slack <= rec[1] <= rec[2] <= s.end_ns + slack
