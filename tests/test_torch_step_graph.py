"""CUDA graphs of the DDIM steps (``fgdm_tpu_torch/sampling/step_graph.py``).

On the CPU: which calls run the eager loop (and ``step_graph.STATS`` says
so), the cache key (a kernel gate routed elsewhere included) and the
cache's bounds, the kernels' launch counters over a capture and its
replays, and the ``graph`` attribute of ``sampler.step``.  A stand-in
takes the CUDA graph's place there: its capture runs the step's Python
once under ``graphs.Capture``, as a CUDA capture does, and its replay runs
it again with its counts discarded (a replay runs no Python); it checks
the bookkeeping, not the numbers.

On the card (``chip``; each test skips without one, decided inside it;
``python -m pytest tests/test_torch_step_graph.py -m chip --noconftest``,
since the tests' conftest imports JAX): the graphed loop against the eager
one bit for bit at the tiny geometry and at the chain benchmark's shapes
(batch 8, 32^2 and 64^2 latents, SD-1.4 widths, the conv kernel on), the
per-slot contract, the counters after several calls, every kernel of a
replayed step in the profiler's trace, and a second batch shape beside the
first.
"""

import collections
import dataclasses
import gc
import json
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from fgdm_tpu_torch import builders  # noqa: E402
from fgdm_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule  # noqa: E402
from fgdm_tpu_torch.diffusion.control import ControlLDM  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import LatentDiffusion  # noqa: E402
from fgdm_tpu_torch.kernels import attention, conv, graphs, groupnorm  # noqa: E402
from fgdm_tpu_torch.models.autoencoder import AutoencoderKL  # noqa: E402
from fgdm_tpu_torch.models.clip import CLIPTextEncoder  # noqa: E402
from fgdm_tpu_torch.models.controlnet import ControlNet  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn import layers  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.parallel.context import shared_clone  # noqa: E402
from fgdm_tpu_torch.sampling import chain as tchain  # noqa: E402
from fgdm_tpu_torch.sampling import ddim, step_graph  # noqa: E402
from fgdm_tpu_torch.serving import ChainEngine  # noqa: E402
from fgdm_tpu_torch.utils import profiling  # noqa: E402

UNET = dict(model_channels=32, num_heads=4, context_dim=64,
            channel_mult=(1, 2), attention_resolutions=(1, 2),
            num_res_blocks=1)
VAE = dict(ch=32, ch_mult=(1, 2, 4, 4), num_res_blocks=1, resolution=64,
           z_channels=4, embed_dim=4)
CLIP = dict(vocab_size=49408, embed_dim=64, num_layers=1, num_heads=4)
STEPS = 4                      # 1000 divides by it: DDIM takes exactly 4
SHAPE = (2, 4, 8, 8)
GN_KEY, FLASH_KEY = ("stand-in", "gn"), ("stand-in", "flash")


class StandIn:
    """The CUDA calls of ``step_graph`` without a card."""

    @staticmethod
    def usable(device):
        return True

    @staticmethod
    def warm(fn):
        fn()

    @staticmethod
    def capture(fn):
        fn()
        return fn

    @staticmethod
    def replay(fn):
        with graphs.Capture():
            fn()


class Eager(StandIn):
    @staticmethod
    def usable(device):
        return False


@pytest.fixture(autouse=True)
def fresh():
    step_graph.clear()
    step_graph.STATS.clear()
    for c in graphs.launch_counters().values():
        c.clear()
    yield
    step_graph.clear()


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(step_graph, "_backend", StandIn)


def _tiny_models(device="cpu", dtype=torch.float32, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    kw = dict(dtype=dtype, device=device)
    vae = init_params_(AutoencoderKL(**VAE, **kw), gen).eval()
    clip = init_params_(CLIPTextEncoder(**CLIP, device=device, dtype=dtype),
                        gen, 0.02).eval()
    sched = builders.sd14_schedule()
    ld = LatentDiffusion(init_params_(UNetModel(**UNET, **kw), gen,
                                      0.02).eval(), vae, sched, clip=clip)
    cldm = ControlLDM(
        init_params_(UNetModel(**UNET, use_adapter=False, **kw), gen,
                     0.02).eval(),
        vae, sched, clip=clip,
        control=init_params_(ControlNet(**UNET, **kw), gen, 0.02).eval(),
        control_scales=(1.0,) * 5)
    return ld, cldm


@pytest.fixture(scope="module")
def tiny():
    return _tiny_models()


def stand_in_fn(x, t, cond):
    """A denoise function that declares itself capturable and counts two
    kernels' launches as the port's wrappers do."""
    graphs.count(groupnorm.group_norm_silu_kernel, GN_KEY)
    graphs.count(groupnorm.group_norm_silu_kernel, GN_KEY)
    graphs.count(attention.flash_attention, FLASH_KEY)
    return 0.1 * x + cond["c"][:, :, None, None]


stand_in_fn.graph_parts = lambda: ((), ("stand-in",))


def _conds(b=SHAPE[0], c=SHAPE[1], seed=0):
    g = torch.Generator().manual_seed(seed)
    return ({"c": torch.randn(b, c, generator=g)},
            {"c": torch.randn(b, c, generator=g)})


def _sample(fn=stand_in_fn, shape=SHAPE, steps=STEPS, eta=0.0, scale=7.5,
            **kw):
    cond, uncond = _conds(shape[0], shape[1])
    sched = DDIMSchedule.create(builders.sd14_schedule(), steps, eta=eta)
    x_T = torch.randn(shape, generator=torch.Generator().manual_seed(1))
    return ddim.ddim_sample(fn, shape, sched, cond, uncond, cfg_scale=scale,
                            x_T=x_T, generator=torch.Generator(), **kw)


def _counts():
    return {k: dict(c) for k, c in graphs.launch_counters().items() if c}


# --- the CPU: when the loop stays eager ------------------------------------

def test_the_cpu_runs_the_eager_loop(tiny):
    ld, _ = tiny
    fn = ld.denoise_fn()
    assert step_graph.model_of(fn) is None
    ctx = torch.randn(2, 77, 64)
    sched = DDIMSchedule.create(ld.schedule, STEPS)
    ddim.ddim_sample(fn, SHAPE, sched, {"c_crossattn": ctx},
                     {"c_crossattn": ctx}, x_T=torch.randn(SHAPE))
    assert step_graph.STATS == {"eager_steps": STEPS}


def _guided(fn, x, t, cond, uncond, scale, i):
    return torch.zeros_like(x)


@pytest.mark.parametrize("case", ["guidance_fn", "mask", "log_every_t",
                                  "ucg_schedule", "eta", "undeclared"])
def test_falls_back_to_the_eager_loop(stand_in, monkeypatch, case):
    from fgdm_tpu_torch.sampling import guidance

    kw = {}
    fn = stand_in_fn
    if case == "guidance_fn":
        monkeypatch.setattr(guidance, "guided_cfg_eps", _guided)
        kw["guidance_fn"] = stand_in_fn
    elif case == "mask":
        kw.update(mask=torch.ones(SHAPE[0], 1, *SHAPE[2:]),
                  x0=torch.zeros(SHAPE), schedule=builders.sd14_schedule())
    elif case == "log_every_t":
        kw["log_every_t"] = 1
    elif case == "ucg_schedule":
        kw["ucg_schedule"] = [7.5] * STEPS
    elif case == "eta":
        kw["eta"] = 0.5
    else:
        def fn(x, t, cond):
            return stand_in_fn(x, t, cond)
    _sample(fn, **kw)
    assert step_graph.STATS == {"eager_steps": STEPS}


def test_the_stand_in_engages_where_those_are_unset(stand_in):
    _sample()
    assert step_graph.STATS == {"eager_steps": 1, "captures": 1,
                                "replays": STEPS - 1}
    _sample()
    assert step_graph.STATS == {"eager_steps": 1, "captures": 1,
                                "replays": 2 * STEPS - 1}


def test_a_model_is_capturable_exactly_without_seq_axis(stand_in, tiny):
    ld, cldm = tiny
    assert step_graph.model_of(ld.denoise_fn()) is not None
    assert step_graph.model_of(cldm.denoise_fn()) is not None
    for pipe, name in ((ld, "unet"), (cldm, "unet"), (cldm, "control")):
        cp = dataclasses.replace(
            pipe, **{name: shared_clone(getattr(pipe, name), "seq")})
        assert step_graph.model_of(cp.denoise_fn()) is None


def test_guess_mode_closure_is_not_declared(stand_in, tiny):
    _, cldm = tiny
    hint = torch.rand(2, 3, 64, 64)
    ctx = torch.randn(2, 77, 64)
    tchain.sample_image_factor(cldm, hint, ctx, ctx, num_steps=2,
                               guess_mode=True, x_T=torch.randn(2, 4, 8, 8))
    assert step_graph.STATS == {"eager_steps": 2}


# --- the cache key ---------------------------------------------------------

@pytest.mark.parametrize("change", ["scale", "shape", "cond_shape", "steps",
                                    "switch"])
def test_a_new_key_captures_anew_and_the_same_call_hits(stand_in,
                                                         monkeypatch,
                                                         change):
    _sample()
    _sample()
    assert step_graph.STATS["captures"] == 1
    if change == "scale":
        _sample(scale=9.0)
    elif change == "shape":
        _sample(shape=(1,) + SHAPE[1:])
    elif change == "cond_shape":
        cond, uncond = _conds()
        cond["c"] = cond["c"][:, :, None].expand(-1, -1, 8)
        uncond["c"] = uncond["c"][:, :, None].expand(-1, -1, 8)
        sched = DDIMSchedule.create(builders.sd14_schedule(), STEPS)

        def fn(x, t, c):
            return stand_in_fn(x, t, {"c": c["c"][..., 0]})

        fn.graph_parts = stand_in_fn.graph_parts
        ddim.ddim_sample(fn, SHAPE, sched, cond, uncond,
                         x_T=torch.randn(SHAPE))
    elif change == "steps":
        _sample(steps=5)
    else:
        monkeypatch.setattr(layers, "_PALLAS_CONV", not layers._PALLAS_CONV)
        _sample()
    assert step_graph.STATS["captures"] == 2
    assert len(step_graph._cache) == 2


def test_a_schedule_of_the_same_length_is_loaded_into_the_graph(stand_in):
    """A schedule's values are in the key: one of the same length but
    other values captures a graph that holds its vectors."""
    cond, uncond = _conds()
    x_T = torch.randn(SHAPE)
    got = {}
    for end in (0.012, 0.012, 0.02):
        sched = DDIMSchedule.create(
            DiffusionSchedule.create(linear_end=end), STEPS)
        got[end] = ddim.ddim_sample(stand_in_fn, SHAPE, sched, cond, uncond,
                                    x_T=x_T)
        e = next(reversed(step_graph._cache.values()))
        for f in ("timesteps", "alphas", "alphas_prev",
                  "sqrt_one_minus_alphas", "sigmas"):
            assert torch.equal(getattr(e.sched, f), getattr(sched, f))
    assert step_graph.STATS["captures"] == 2
    assert not torch.equal(got[0.012], got[0.02])


def test_control_scales_and_the_model_are_in_the_key(stand_in, tiny):
    ld, cldm = tiny
    hint = torch.rand(2, 3, 64, 64)
    ctx = torch.randn(2, 77, 64)
    x_T = torch.randn(2, 4, 8, 8)
    for strength in (1.0, 1.0, 0.5, 0.5):
        tchain.sample_image_factor(cldm, hint, ctx, ctx, num_steps=2,
                                   strength=strength, x_T=x_T)
    assert step_graph.STATS["captures"] == 2
    def model(pipe, **kw):
        return step_graph.model_of(pipe.denoise_fn(**kw))

    a = model(cldm)
    assert a == model(cldm)
    assert a != model(dataclasses.replace(cldm, control_scales=(0.5,) * 5))
    assert a != model(dataclasses.replace(cldm, only_mid_control=True))
    assert model(ld) != model(ld, adapter_on=False)


@pytest.mark.parametrize("gate", ["attention.use_flash",
                                  "groupnorm.use_fused_gn", "conv.conv3x3"])
def test_a_gate_routed_elsewhere_captures_its_own_graph(stand_in, monkeypatch,
                                                        tiny, gate):
    """As ``chip_smoke.plain_path`` routes the kernels' gates to plain
    PyTorch: the routed call captures a graph of its own, through the
    routed gate, and the call with the gate restored replays the first."""
    # the chain's UNets fuse GroupNorm and SiLU, through K4's gate
    ld = dataclasses.replace(tiny[0], unet=init_params_(
        UNetModel(**UNET, fused_norm_silu=True, dtype=torch.float32,
                  device="cpu"), torch.Generator().manual_seed(4),
        0.02).eval())
    if gate == "conv.conv3x3":
        # the tiny UNet's convs reach the conv kernel's dispatch
        monkeypatch.setattr(layers, "_PALLAS_CONV", True)
        monkeypatch.setattr(conv, "conv3x3_ok", lambda *a: True)
    mod, name = gate.split(".")
    mod = {"attention": attention, "groupnorm": groupnorm, "conv": conv}[mod]
    ctx = torch.randn(2, 77, 64)
    sched = DDIMSchedule.create(ld.schedule, 2)
    x_T = torch.randn(SHAPE)

    def run():
        return ddim.ddim_sample(ld.denoise_fn(), SHAPE, sched,
                                {"c_crossattn": ctx}, {"c_crossattn": ctx},
                                x_T=x_T)

    want = run()
    assert step_graph.STATS["captures"] == 1
    orig, calls = getattr(mod, name), []

    def routed(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    with monkeypatch.context() as m:
        m.setattr(mod, name, routed)
        got = run()
    assert step_graph.STATS["captures"] == 2 and calls
    assert torch.equal(got, want)
    run()
    assert step_graph.STATS["captures"] == 2
    assert len(step_graph._cache) == 2


def test_changed_parameters_capture_anew_and_drop_the_stale_graph(stand_in):
    ld, _ = _tiny_models(seed=1)
    ctx = torch.randn(2, 77, 64)
    sched = DDIMSchedule.create(ld.schedule, 2)
    fn = ld.denoise_fn()     # held across the change: keyed at each call

    def run():
        ddim.ddim_sample(fn, SHAPE, sched, {"c_crossattn": ctx},
                         {"c_crossattn": ctx}, x_T=torch.randn(SHAPE))

    run()
    run()
    assert step_graph.STATS["captures"] == 1
    with torch.no_grad():
        next(ld.unet.parameters()).add_(1.0)
    run()
    assert step_graph.STATS["captures"] == 2
    assert len(step_graph._cache) == 1


class Detached(StandIn):
    """A stand-in whose graph holds nothing of the model, as a CUDA graph
    holds nothing of Python's."""

    @staticmethod
    def capture(fn):
        fn()
        return object()

    @staticmethod
    def replay(g):
        pass


def test_a_dead_model_drops_its_graph(monkeypatch):
    monkeypatch.setattr(step_graph, "_backend", Detached)
    ld, _ = _tiny_models(seed=2)
    ctx = torch.randn(2, 77, 64)
    sched = DDIMSchedule.create(ld.schedule, 2)
    ddim.ddim_sample(ld.denoise_fn(), SHAPE, sched, {"c_crossattn": ctx},
                     {"c_crossattn": ctx}, x_T=torch.randn(SHAPE))
    assert len(step_graph._cache) == 1
    del ld
    gc.collect()
    assert len(step_graph._cache) == 0


def test_the_cache_keeps_at_most_max_graphs(stand_in):
    for b in range(1, step_graph.MAX_GRAPHS + 3):
        _sample(shape=(b,) + SHAPE[1:])
    assert len(step_graph._cache) == step_graph.MAX_GRAPHS
    assert step_graph.STATS["captures"] == step_graph.MAX_GRAPHS + 2
    _sample(shape=(step_graph.MAX_GRAPHS + 2,) + SHAPE[1:])
    assert step_graph.STATS["captures"] == step_graph.MAX_GRAPHS + 2


def test_threads_sharing_a_graph_take_turns(stand_in):
    """Calls of one key from several threads each get their own result:
    one call at a time fills the static buffers and replays."""
    _sample()                                   # captures
    want = _sample()
    errors, done = [], []

    def work():
        try:
            for _ in range(20):
                if not torch.equal(_sample(), want):
                    errors.append("mixed")
            done.append(1)
        except Exception as e:   # reported by the assertion below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == [] and len(done) == 8
    assert step_graph.STATS["captures"] == 1


# --- the launch counters ---------------------------------------------------

def test_a_capture_leaves_the_counters_and_records_its_delta():
    attention.flash_attention.launches[FLASH_KEY] = 3
    before = _counts()
    with graphs.Capture() as c:
        graphs.count(attention.flash_attention, FLASH_KEY)
        graphs.count(attention.flash_attention, FLASH_KEY)
        graphs.count(conv.conv3x3_kernel, ("new",))
    assert _counts() == before
    assert ("new",) not in conv.conv3x3_kernel.launches
    assert c.delta == {"flash_attention": {FLASH_KEY: 2},
                       "conv3x3_kernel": {("new",): 1}}
    graphs.add_launches(c.delta)
    graphs.add_launches(c.delta)
    assert _counts() == {"flash_attention": {FLASH_KEY: 7},
                         "conv3x3_kernel": {("new",): 2}}


def test_another_threads_launches_during_a_capture_count_as_they_run():
    """A capture takes only its own thread's launches and packs."""
    def eager():
        graphs.count(conv.conv3x3_kernel, ("eager",))
        graphs.keep(torch.ones(1))

    with graphs.Capture() as c:
        graphs.count(attention.flash_attention, FLASH_KEY)
        t = threading.Thread(target=eager)
        t.start()
        t.join()
    assert _counts() == {"conv3x3_kernel": {("eager",): 1}}
    assert c.delta == {"flash_attention": {FLASH_KEY: 1}}
    assert c.kept == []


def test_replays_count_what_the_eager_loop_counts(stand_in, monkeypatch):
    monkeypatch.setattr(step_graph, "_backend", Eager)
    _sample()
    eager = _counts()
    assert eager == {"group_norm_silu_kernel": {GN_KEY: 2 * STEPS},
                     "flash_attention": {FLASH_KEY: STEPS}}
    for c in graphs.launch_counters().values():
        c.clear()
    monkeypatch.setattr(step_graph, "_backend", StandIn)
    _sample()
    assert step_graph.STATS["captures"] == 1
    assert _counts() == eager
    _sample()
    assert _counts() == {k: {kk: 2 * n for kk, n in v.items()}
                         for k, v in eager.items()}


def test_a_capture_keeps_the_conv_packs_it_reads():
    w = torch.nn.Parameter(torch.randn(8, 4, 3, 3))
    b = torch.nn.Parameter(torch.randn(8))
    wk, bias = conv.packed_weight(w, b)
    with graphs.Capture() as c:
        conv.packed_weight(w, b)
    assert len(c.kept) == 2
    assert c.kept[0] is wk and c.kept[1] is bias
    conv.packed_weight(w, b)
    assert len(c.kept) == 2


# --- the spans -------------------------------------------------------------

def _step_spans(run):
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        run()
    got = [s.attrs for s in profiling.spans() if s.name == "sampler.step"]
    profiling.clear()
    return got


def test_sampler_step_carries_graph_false_on_the_cpu(tiny):
    ld, _ = tiny
    ctx = torch.randn(2, 77, 64)
    sched = DDIMSchedule.create(ld.schedule, STEPS)
    got = _step_spans(lambda: ddim.ddim_sample(
        ld.denoise_fn(), SHAPE, sched, {"c_crossattn": ctx},
        {"c_crossattn": ctx}, x_T=torch.randn(SHAPE)))
    assert got == [{"graph": False}] * STEPS


def test_sampler_step_carries_graph_true_on_a_replay(stand_in):
    assert _step_spans(_sample) == ([{"graph": False}]
                                    + [{"graph": True}] * (STEPS - 1))
    assert _step_spans(_sample) == [{"graph": True}] * STEPS


# --- the card ----------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and the port's kernels")
    return torch.device("cuda", 0)


def _eager(monkeypatch):
    monkeypatch.setattr(step_graph, "_backend", Eager)


def _graphed(monkeypatch):
    monkeypatch.setattr(step_graph, "_backend", step_graph._Cuda)


def _equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)


def _tiny_chain(ld, cldm, seeds, dev):
    ctx = torch.randn(len(seeds), 77, 64, device=dev,
                      generator=torch.Generator(dev).manual_seed(5))
    out = tchain.fgdm_chain(ld, cldm, ctx, ctx.flip(0), ctx * 0.5, ctx * 0.1,
                            cond_hw=(64, 64), image_hw=(64, 64), f1_steps=5,
                            f2_steps=4, slot_seeds=seeds)
    return {k: v.clone() for k, v in out.items()}


@pytest.mark.chip
def test_graphed_tiny_chain_is_bit_identical_and_keeps_two_shapes(
        monkeypatch):
    dev = _card()
    ld, cldm = _tiny_models(dev, torch.bfloat16)
    _eager(monkeypatch)
    want2 = _tiny_chain(ld, cldm, [3, 7], dev)
    want1 = _tiny_chain(ld, cldm, [9], dev)
    _graphed(monkeypatch)
    got2 = _tiny_chain(ld, cldm, [3, 7], dev)        # captures both factors
    assert step_graph.STATS["captures"] == 2
    got1 = _tiny_chain(ld, cldm, [9], dev)           # a second shape
    again2 = _tiny_chain(ld, cldm, [3, 7], dev)      # the first, replayed
    assert step_graph.STATS["captures"] == 4
    assert len(step_graph._cache) == 4
    assert _equal(got2, want2) and _equal(got1, want1)
    assert _equal(again2, want2)


@pytest.mark.chip
def test_graphed_engine_keeps_the_per_slot_contract():
    dev = _card()
    ld, cldm = _tiny_models(dev, torch.bfloat16, seed=3)
    engine = ChainEngine(ld, cldm, max_batch=2, cond_hw=(64, 64),
                         image_hw=(64, 64), f1_steps=5, f2_steps=4)
    assert step_graph.STATS["captures"] == 2
    solo = engine.generate(["a cat"], seed=7)
    pair = engine.generate(["a dog", "a cat"], seeds=[3, 7])
    assert step_graph.STATS["captures"] == 2
    np.testing.assert_array_equal(solo["images"][0], pair["images"][1])
    np.testing.assert_array_equal(solo["conditions"][0],
                                  pair["conditions"][1])
    assert not np.array_equal(pair["images"][0], pair["images"][1])


@pytest.fixture(scope="module")
def full():
    """The chain's two sampled models at SD-1.4 width with the conv kernel
    on, and the cell's inputs: batch 8 (16 with CFG)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the chain at its benchmark's shapes")
    dev = torch.device("cuda", 0)
    ld, cldm = builders.build_chain(dev)
    g = torch.Generator(dev).manual_seed(11)
    ctx = [torch.randn(8, 77, 768, device=dev, generator=g).bfloat16()
           for _ in range(4)]
    hint = torch.rand(8, 3, 512, 512, device=dev, generator=g)
    return ld, cldm, ctx, hint, list(range(100, 108))


def _factors(full):
    ld, cldm, ctx, hint, seeds = full
    z1 = tchain.sample_condition_factor(ld, ctx[0], ctx[1], num_steps=10,
                                        slot_seeds=seeds)
    z2 = tchain.sample_image_factor(cldm, hint, ctx[2], ctx[3], num_steps=5,
                                    slot_seeds=seeds)
    return {"z1": z1, "z2": z2}


@pytest.mark.chip
def test_graphed_factors_at_the_cell_shapes_are_bit_identical_and_count_true(
        full, monkeypatch):
    monkeypatch.setattr(layers, "_PALLAS_CONV", True)
    _eager(monkeypatch)
    want = _factors(full)
    eager = _counts()
    assert eager["conv3x3_kernel"] and eager["flash_attention"]
    for c in graphs.launch_counters().values():
        c.clear()
    _graphed(monkeypatch)
    got = [_factors(full) for _ in range(3)]
    assert step_graph.STATS["captures"] == 2
    assert step_graph.STATS["replays"] == 3 * (10 + 5) - 2
    for g in got:
        assert _equal(g, want)
    assert _counts() == {k: {kk: 3 * n for kk, n in v.items()}
                         for k, v in eager.items()}


@pytest.mark.chip
def test_the_tracer_sees_every_kernel_of_a_replayed_step(full, monkeypatch):
    from bench_port.trace import Tracer

    monkeypatch.setattr(layers, "_PALLAS_CONV", True)
    ld, _, ctx, _, seeds = full

    def run():
        return tchain.sample_condition_factor(ld, ctx[0], ctx[1],
                                              num_steps=10, slot_seeds=seeds)

    _graphed(monkeypatch)
    run()                                      # captures
    with Tracer() as tg:
        run()
    _eager(monkeypatch)
    with Tracer() as te:
        run()
    got = collections.Counter(n for n, _, _ in tg.summary.records)
    want = collections.Counter(n for n, _, _ in te.summary.records)
    assert tg.summary.lost == 0 and te.summary.lost == 0
    assert tg.summary.launches < te.summary.launches // 20
    hand = ("gn_silu_kernel", "conv3x3_wgmma_kernel", "nchw_to_nhwc_kernel",
            "flash_fwd_kernel")
    for name, n in want.items():
        if any(h in name for h in hand):
            assert got[name] == n, name
    print(json.dumps({"graph_records": sum(got.values()),
                      "eager_records": sum(want.values()),
                      "graph_only": dict(got - want),
                      "eager_only": dict(want - got)}))
    # kernels apart from copies and memsets (named otherwise inside a
    # graph): a replayed step adds the index's fill and five gathers at it,
    # t and the step's four scalars (the eager loop's are 0-d views; the
    # elementwise kernels over them are named by their shape but as many)
    def kernels(c):
        return sum(n for name, n in c.items()
                   if not name.lower().startswith("mem"))

    assert kernels(want) <= kernels(got) <= kernels(want) + 6 * 10
