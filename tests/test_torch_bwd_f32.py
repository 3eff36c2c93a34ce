"""The float32 flash backward (K5-f32 dQ, K6-f32 dK/dV) on the CPU: its
arithmetic, plans, host checks and the float32 training step's calls.

The kernels (``fgdm_tpu_torch/kernels/csrc/flash_attn_bwd_f32.cu``) run only
on the card, where ``chip_smoke.py`` holds them against the float32
``attention_bwd_ref``.  Here:

* ``k56_f32_arithmetic`` repeats their tile walk in plain torch float32 (K5:
  key tiles of the plan's streamed tile against a block's query rows, dQ
  summed in the key partitions of its lanes; K6: query tiles against a
  block's key rows, the ragged tail with lse +inf, dK and dV summed in the
  query partitions of its lanes; each kernel's partitions added at the end;
  exps in base 2 with scale * log2 e folded in; dQ and dK scaled once) and
  is held, at the planned tiles and at every tile each kernel
  instantiates, against the JAX package's Pallas backward
  ``_flash_backward_t`` in interpret mode in float32, within
  ``tests/test_attention.py``'s atol 5e-3, rtol 1e-3, and against
  ``jax.vjp`` of ``_xla_attention`` and the port's CPU route
  ``flash_attention_backward`` within 1e-5 * max|ref| + 1e-6 (float32 both
  sides, sums in another order);
* the float32 plan gives a valid tile for every shape the gate admits at
  d 40/80, fills the card at the path's shapes, refuses what the kernels do
  not take, and its constants are the source's;
* on the ``meta`` device, every gated attention that the float32 training
  step (plain and distillation) differentiates has a float32 plan, and
  ``chip_smoke.py`` holds the step's shape;
* the wrappers take float32 on a CUDA tensor to the float32 kernels, with
  the dtype in the launch key, and refuse float16 and mixed dtypes with the
  forward's messages.
"""

import collections
import importlib.util
import pathlib
import re
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.attention as ka  # noqa: E402
from fgdm_tpu_torch.builders import sd14_schedule  # noqa: E402
from fgdm_tpu_torch.checkpoint.loader import sd_unet  # noqa: E402
from fgdm_tpu_torch.diffusion.latent_diffusion import (  # noqa: E402
    LatentDiffusion)
from fgdm_tpu_torch.diffusion.losses import diffusion_loss  # noqa: E402
from fgdm_tpu_torch.kernels import _build  # noqa: E402
from fgdm_tpu_torch.kernels import attention as ta  # noqa: E402
from fgdm_tpu_torch.train.state import adapter_filter  # noqa: E402

torch.set_num_threads(2)
REPO = pathlib.Path(__file__).resolve().parents[1]
PALLAS_TOL = dict(atol=5e-3, rtol=1e-3)
EXACT_TOL = (1e-5, 1e-6)   # max|d| <= 1e-5 * max|ref| + 1e-6


def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# K5-f32's key partitions of dS K and K6-f32's query partitions of the
# dK/dV products (8 / DSplit<D>::LD)
K5_PARTS = {40: 2, 80: 1}
K6_PARTS = {40: 2, 80: 1}


def k56_f32_arithmetic(q, k, v, do, lse, delta, scale, plans):
    """K5-f32 and K6-f32's arithmetic in plain torch on float32 q/k/v/dO
    ``[B, H, N, d]`` and lse/delta ``[B, H, Nq]``: K5 walks key tiles of
    ``plans[0].bt``, its dQ summed in ``K5_PARTS[d]`` partitions of the
    keys (key = p mod parts); K6 query tiles of ``plans[1].bt`` (the last
    one padded with zero rows whose lse is +inf and delta 0, as the kernel
    loads them), its dK and dV summed in ``K6_PARTS[d]`` partitions of the
    queries (query = p mod parts); each kernel's partitions added at the
    end.  Returns ``(dq, dk, dv)`` in float32."""
    sl = scale * ta._LOG2E
    l2 = lse[..., None] * ta._LOG2E
    dl = delta[..., None]
    # K5: a block's query rows against streamed key tiles
    bk = plans[0].bt
    parts = K5_PARTS[q.shape[3]]
    dq = [torch.zeros_like(q) for _ in range(parts)]
    for j in range(0, k.shape[2], bk):
        kj, vj = k[:, :, j:j + bk], v[:, :, j:j + bk]
        p = torch.exp2(q @ kj.transpose(2, 3) * sl - l2)
        ds = p * (do @ vj.transpose(2, 3) - dl)
        for r in range(parts):
            dq[r] = dq[r] + ds[..., r::parts] @ kj[:, :, r::parts]
    # K6: a block's key rows against streamed query tiles, transposed scores
    bq = plans[1].bt
    pad = -q.shape[2] % bq
    qp, dop = (torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, do))
    l2p = torch.nn.functional.pad(l2[..., 0], (0, pad), value=float("inf"))
    dlp = torch.nn.functional.pad(dl[..., 0], (0, pad))
    parts = K6_PARTS[q.shape[3]]
    dk = [torch.zeros_like(k) for _ in range(parts)]
    dv = [torch.zeros_like(v) for _ in range(parts)]
    for i in range(0, qp.shape[2], bq):
        qi, doi = qp[:, :, i:i + bq], dop[:, :, i:i + bq]
        pt = torch.exp2(k @ qi.transpose(2, 3) * sl
                        - l2p[:, :, None, i:i + bq])
        dst = pt * (v @ doi.transpose(2, 3) - dlp[:, :, None, i:i + bq])
        for p in range(parts):
            dv[p] = dv[p] + pt[..., p::parts] @ doi[:, :, p::parts]
            dk[p] = dk[p] + dst[..., p::parts] @ qi[:, :, p::parts]
    return (sum(dq[1:], dq[0]) * scale, sum(dk[1:], dk[0]) * scale,
            sum(dv[1:], dv[0]))


# (d, Nq, Nk): an even and a ragged query length at each head dim
CASES = [(40, 256, 256), (40, 200, 256), (80, 256, 256), (80, 136, 384)]
CASE_IDS = ["d40", "d40-ragged", "d80", "d80-ragged"]


@pytest.fixture(scope="module")
def references():
    """{case: (inputs q/k/v/dO, the port's float32 forward and lse, JAX's
    Pallas backward on them, JAX's VJP)}: each JAX reference built once
    for the module.  The Pallas backward reads the forward's output and
    lse as inputs (``[B*H, 1, Nq]``; it pads the rows with +inf itself):
    it gets the port's, the ones the emulation reads."""
    out = {}
    for d, nq, nk in CASES:
        rng = np.random.default_rng(d + nq)
        shapes = ((1, 2, nq, d), (1, 2, nk, d), (1, 2, nk, d), (1, 2, nq, d))
        arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        q, k, v, g = (torch.from_numpy(a) for a in arrs)
        scale = d ** -0.5
        o, lse = ta.attention_ref(q, k, v, scale, return_lse=True)
        jq, jk, jv, jg = (jnp.asarray(a) for a in arrs)
        _, vjp = jax.vjp(lambda a, b, c: ka._xla_attention(a, b, c, scale),
                         jq, jk, jv)
        xla = [np.asarray(x) for x in vjp(jg)]
        ka._INTERPRET, saved = True, ka._INTERPRET
        try:
            pallas = [np.asarray(x) for x in ka._flash_backward_t(
                jq, jk, jv, jnp.asarray(o.numpy()),
                jnp.asarray(lse.reshape(2, 1, nq).numpy()), jg, scale,
                block_q=128, block_k=128)]
        finally:
            ka._INTERPRET = saved
        out[(d, nq, nk)] = ((q, k, v, g), (o, lse), pallas, xla)
    return out


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_k56_f32_arithmetic_matches_pallas_and_xla_vjp(case, references):
    """The kernels' float32 arithmetic, from the port's float32 forward and
    lse, against the Pallas backward (interpret mode) and the XLA VJP; the
    wrappers' CPU route is the plain version and agrees as closely."""
    d, nq, nk = case
    (q, k, v, g), (o, lse), pallas, xla = references[case]
    scale = d ** -0.5
    delta = (g * o).sum(dim=-1)
    emu = k56_f32_arithmetic(q, k, v, g, lse, delta, scale,
                             ta.flash_bwd_f32_plan(2, nq, nk, d))
    plain = ta.flash_attention_backward(q, k, v, o, lse, g, scale)
    for ours, cpu, x, p in zip(emu, plain, xla, pallas):
        assert ours.dtype == cpu.dtype == torch.float32
        assert ours.shape == cpu.shape
        np.testing.assert_allclose(ours.numpy(), p, **PALLAS_TOL)
        for got, ref in ((ours.numpy(), x), (ours.numpy(), cpu.numpy()),
                         (cpu.numpy(), x)):
            tol = EXACT_TOL[0] * np.abs(ref).max() + EXACT_TOL[1]
            np.testing.assert_allclose(got, ref, atol=tol, rtol=0)


@pytest.mark.parametrize("bq", sorted({t[1] for t in ta._K6_F32_TILES}))
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_k6_f32_tiles_match_pallas_and_xla_vjp(case, bq, references):
    """K6-f32's arithmetic at each streamed query tile it instantiates (the
    query partitions, the ragged tail) against the Pallas backward and the
    XLA VJP, as closely as at the planned tile."""
    d, nq, nk = case
    (q, k, v, g), (o, lse), pallas, xla = references[case]
    scale = d ** -0.5
    delta = (g * o).sum(dim=-1)
    plans = (ta.bwd_f32_tile("dq", 2, nq, nk, d),
             ta.bwd_f32_tile("dkv", 2, nq, nk, d, (64, bq, 2)))
    emu = k56_f32_arithmetic(q, k, v, g, lse, delta, scale, plans)
    for ours, x, p in zip(emu[1:], xla[1:], pallas[1:]):
        np.testing.assert_allclose(ours.numpy(), p, **PALLAS_TOL)
        tol = EXACT_TOL[0] * np.abs(x).max() + EXACT_TOL[1]
        np.testing.assert_allclose(ours.numpy(), x, atol=tol, rtol=0)


def _k5_smem(d, rows, bn, stages):
    """``dq_smem_bytes`` of ``flash_attn_bwd_f32.cu``: Q and dO, the K/V
    ring (rows of d + 4 floats), each warp's dS rows of bn + 8."""
    return 4 * (2 * rows * (d + 4) + stages * 2 * bn * (d + 4)
                + rows * (bn + 8))


# every K5-f32 tile at each case whose head dim has room for it
K5_TILE_CASES = [pytest.param(case, tile,
                              id=f"{cid}-{'x'.join(map(str, tile))}")
                 for case, cid in zip(CASES, CASE_IDS)
                 for tile in ta._K5_F32_TILES
                 if _k5_smem(case[0], *tile) <= ta._SMEM_LIMIT]


@pytest.mark.parametrize("case,tile", K5_TILE_CASES)
def test_k5_f32_tiles_match_pallas_and_xla_vjp(case, tile, references):
    """K5-f32's arithmetic at each tile it instantiates (the key tiles, the
    key partitions, the ragged query rows) against the Pallas backward and
    the XLA VJP, as closely as at the planned tile; the tile's grid covers
    the query rows once."""
    d, nq, nk = case
    (q, k, v, g), (o, lse), pallas, xla = references[case]
    scale = d ** -0.5
    delta = (g * o).sum(dim=-1)
    plans = (ta.bwd_f32_tile("dq", 2, nq, nk, d, tile),
             ta.bwd_f32_tile("dkv", 2, nq, nk, d))
    assert (plans[0].rows, plans[0].bt, plans[0].stages) == tile
    assert plans[0].grid == (-(-nq // tile[0]), 2)
    dq = k56_f32_arithmetic(q, k, v, g, lse, delta, scale, plans)[0]
    np.testing.assert_allclose(dq.numpy(), pallas[0], **PALLAS_TOL)
    tol = EXACT_TOL[0] * np.abs(xla[0]).max() + EXACT_TOL[1]
    np.testing.assert_allclose(dq.numpy(), xla[0], atol=tol, rtol=0)


# --- the float32 plan ------------------------------------------------------

@pytest.mark.parametrize("d", ta.BWD_HEAD_DIMS)
@pytest.mark.parametrize("nq,nk", [(512, 512), (520, 1024), (1000, 1536),
                                    (1024, 1024), (4096, 4096), (4097, 512),
                                    (600, 2048)])
def test_bwd_f32_plan_is_a_valid_tile(nq, nk, d):
    """Every shape the gate admits at d 40/80 gets a tile each float32
    kernel takes: K5's keys a tile divide Nk, each grid covers its rows
    (queries for K5, keys for K6) once, the block fits shared memory."""
    for bh in (1, 3, 16, 64):
        for plan, rows in zip(ta.flash_bwd_f32_plan(bh, nq, nk, d),
                              (nq, nk)):
            assert nk % (plan.bt if plan.kernel == "dq" else plan.rows) == 0
            assert plan.grid[1] == bh
            assert (plan.grid[0] - 1) * plan.rows < rows
            assert rows <= plan.grid[0] * plan.rows
            assert plan.smem <= ta._SMEM_LIMIT
            assert plan == ta.bwd_f32_tile(plan.kernel, bh, nq, nk, d,
                                           (plan.rows, plan.bt, plan.stages))


# (B*H, Nq, Nk, d) of the float32 training step's K5/K6 launches (the plain
# step at batch 8, the distillation step's capture rows 2 and the rest 6)
# and chip_smoke.py's other f32 backward shapes
F32_PATH_SHAPES = [(64, 1024, 1024, 40), (16, 1024, 1024, 40),
                   (48, 1024, 1024, 40), (16, 4096, 4096, 40),
                   (16, 1024, 1024, 80)]


def test_bwd_f32_plan_fills_the_card():
    """At least 132 blocks (one an SM) for each kernel at those shapes."""
    for shape in F32_PATH_SHAPES:
        for plan in ta.flash_bwd_f32_plan(*shape):
            assert plan.grid[0] * plan.grid[1] >= ta.SMS


@pytest.mark.parametrize("kernel,d,nk", [
    ("dq", 64, 1024),       # no float32 tile at this head dim
    ("dkv", 512, 1024),     # the VAE's head has no backward kernel
    ("dq", 40, 1000),       # Nk not a multiple of the planned key tile
    ("dkv", 80, 960 + 32),
    ("dqkv", 40, 1024),     # no such kernel
])
def test_bwd_f32_tile_refuses_what_the_kernels_do_not_take(kernel, d, nk):
    with pytest.raises(ValueError, match="no float32 tile"):
        ta.bwd_f32_tile(kernel, 16, 1024, nk, d)
    if kernel != "dqkv":
        with pytest.raises(ValueError, match="no float32 tile"):
            ta.flash_bwd_f32_plan(16, 1024, nk, d)


@pytest.mark.parametrize("kernel,d,nk,tile", [
    ("dkv", 80, 1024, (128, 64, 2)),   # more shared memory than a block has
    ("dkv", 40, 1024, (96, 64, 2)),    # a tile K6-f32 does not instantiate
    ("dkv", 40, 1024, (64, 64, 4)),
    ("dkv", 40, 960, (128, 32, 2)),    # Nk not a multiple of the key rows
    ("dq", 40, 1024, (64, 64, 4)),     # a tile K5-f32 does not instantiate
    ("dq", 40, 1024, (32, 64, 2)),
    ("dq", 80, 1024, (128, 64, 3)),    # more shared memory than a block has
    ("dq", 40, 1000, (64, 32, 2)),     # Nk not a multiple of the key tile
])
def test_bwd_f32_tile_refuses_a_forced_tile(kernel, d, nk, tile):
    with pytest.raises(ValueError, match="no float32 tile"):
        ta.bwd_f32_tile(kernel, 16, 1024, nk, d, tile)


def test_bwd_f32_constants_match_the_source():
    """The tiles, the shared-memory formulas, the lanes' partition split,
    the key multiple and the head dims the host assumes are
    ``flash_attn_bwd_f32.cu``'s; no atomics; chip_smoke.py builds the
    source."""
    src = (_build.CSRC / "flash_attn_bwd_f32.cu").read_text()

    def table(name):
        body = src[src.index(f"#define {name}(X)"):]
        body = body[:body.index("\n\n")]
        return tuple(tuple(map(int, t)) for t in re.findall(
            r"X\((\d+), (\d+), (\d+)\)", body))

    k5, k6 = table("FGDM_K5_F32_TILES"), table("FGDM_K6_F32_TILES")
    assert k5 == ta._K5_F32_TILES and len(set(k5)) == len(k5)
    assert k6 == ta._K6_F32_TILES and len(set(k6)) == len(k6)
    assert ("return 4 * (2 * 16 * WARPS * (D + 4) + STAGES * 2 * BN * (D + 4)"
            " +\n              16 * WARPS * (BN + 8));") in src
    assert ("return 4 * (2 * 16 * WARPS * (D + 4) + STAGES * (2 * BQ * (D + 4)"
            " + 2 * BQ) +\n              2 * 16 * WARPS * (BQ + 8));") in src
    split = {int(d): 8 // int(ld) for d, ld in re.findall(
        r"struct DSplit<(\d+)> \{\s*static constexpr int LD = (\d+);",
        src)}
    assert split == K5_PARTS == K6_PARTS
    assert src.count("constexpr int LD = DSplit<D>::LD, KP = 8 / LD;") == 2
    multiple = int(re.search(r"constexpr int KEY_MULTIPLE = (\d+);",
                             src).group(1))
    for d in ta.BWD_HEAD_DIMS:
        assert multiple % ta._K5_F32_PLAN[d][1] == 0
        assert multiple % ta._K6_F32_PLAN[d][0] == 0
        for bm, bn, stages in k5:
            smem = _k5_smem(d, bm, bn, stages)
            if smem <= ta._SMEM_LIMIT:
                assert ta.bwd_f32_tile("dq", 1, 1024, 1024, d,
                                       (bm, bn, stages)).smem == smem
        for bk, bq, stages in k6:
            smem = 4 * (2 * bk * (d + 4) + stages * (2 * bq * (d + 4) + 2 * bq)
                        + 2 * bk * (bq + 8))
            if smem <= ta._SMEM_LIMIT:
                assert ta.bwd_f32_tile("dkv", 1, 1024, 1024, d,
                                       (bk, bq, stages)).smem == smem
    for fn in ("fgdm_flash_attn_bwd_f32_dq(", "fgdm_flash_attn_bwd_f32_dkv("):
        body = src[src.index(f"int {fn}"):]
        body = body[:body.index("#undef")]
        dims = tuple(int(d) for d in re.findall(r"if \(d == (\d+)\)", body))
        assert dims == ta.BWD_HEAD_DIMS
    assert "atomic" not in src.replace("no atomics", "")
    assert '"flash_attn_bwd_f32"' in (REPO / "chip_smoke.py").read_text()


# --- the float32 training step's gated attention calls --------------------

@pytest.fixture(scope="module")
def train_f32_calls():
    """``{"plain": Counter, "distill": Counter}`` of (B, H, Nq, Nk, d) of
    the gated attention calls whose q needs a gradient in the float32
    training step's loss at SD-1.4 width (batch 8, 32^2 latents, the
    adapter trainable), enumerated on the meta device."""
    dev = "meta"
    unet = sd_unet(torch.float32, dev)
    trainable = adapter_filter()
    for name, p in unet.named_parameters():
        p.requires_grad_(trainable(name))
    ld = LatentDiffusion(unet, None, sd14_schedule().to(dev))
    calls = collections.Counter()
    gate = ta.use_flash

    def record(q, k):
        assert q.dtype == torch.float32
        if q.requires_grad and ta.flash_gate(q.shape[2], k.shape[2]):
            calls[(*q.shape[:3], k.shape[2], q.shape[3])] += 1
        return False

    x0 = torch.zeros(8, 4, 32, 32, device=dev)
    cond = {"c_crossattn": torch.zeros(8, 77, 768, device=dev)}
    t = torch.zeros(8, dtype=torch.long, device=dev)
    out = {}
    ta.use_flash = record
    try:
        for kind in ("plain", "distill"):
            calls.clear()
            diffusion_loss(ld, x0, cond, t=t, noise=torch.zeros_like(x0),
                           distill=kind == "distill")
            out[kind] = collections.Counter(calls)
    finally:
        ta.use_flash = gate
    return out


def test_every_f32_training_attention_has_a_backward_plan(train_f32_calls):
    """The float32 step differentiates level 0's self-attentions (K1-f32
    with lse, then K5-f32/K6-f32): each has a float32 plan that fills the
    card; chip_smoke.py holds the plain step's shape on the train_f32 path
    (the distillation step's shapes are held from its launch counts)."""
    plain, distill = train_f32_calls["plain"], train_f32_calls["distill"]
    assert set(plain) == {(8, 8, 1024, 1024, 40)}
    assert set(distill) == {(2, 8, 1024, 1024, 40), (6, 8, 1024, 1024, 40)}
    for b, h, nq, nk, d in set(plain) | set(distill):
        assert (b * h, nq, nk, d) in F32_PATH_SHAPES
        for plan in ta.flash_bwd_f32_plan(b * h, nq, nk, d):
            assert plan.grid[0] * plan.grid[1] >= ta.SMS
    cs = chip_smoke()
    held = {(b, h, nq, nk, d) for _, b, h, nq, nk, d, path
            in cs.BWD_F32_CASES if path == "train_f32"}
    assert held == set(plain)
    assert {c[1:6] for c in cs.BWD_F32_CASES} == {
        c[1:6] for c in cs.BWD_CASES}


# --- the wrappers: dtypes, dispatch, launch keys ---------------------------

class _Fake:
    """A contiguous, aligned tensor stand-in on the card (no card here)."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = torch.Size(shape), dtype
        self.device = torch.device("cuda", 0)

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return 256


def _bwd_operands(dtype, do_dtype=None, nq=1024, d=40):
    q, do = _Fake((1, 2, nq, d), dtype), _Fake((1, 2, nq, d),
                                               do_dtype or dtype)
    k, v = (_Fake((1, 2, 1024, d), dtype) for _ in range(2))
    lse, delta = (_Fake((1, 2, nq), torch.float32) for _ in range(2))
    return q, k, v, do, lse, delta


def _message(fn, *args):
    with pytest.raises(ValueError) as err:
        fn(*args)
    return str(err.value).split(": ", 1)[1]


@pytest.fixture
def fake_libs(monkeypatch):
    """The two backward libraries as stand-ins that report their key tile,
    and the four launchers as stand-ins that record their name and plan."""
    launched = []
    for name, block_n in (("_bwd_lib", "fgdm_flash_attn_bwd_block_n"),
                          ("_bwd_f32_lib", "fgdm_flash_attn_bwd_f32_block_n")):
        lib = types.SimpleNamespace(**{block_n: lambda d: 64})
        monkeypatch.setattr(ta, name, lambda lib=lib: lib)
    for name in ("_flash_k5", "_flash_k6", "_flash_k5_f32", "_flash_k6_f32"):
        def launch(*args, _name=name):
            launched.append((_name, args[-1]))   # the plan is the last
            return None if "k5" in _name else (None, None)
        monkeypatch.setattr(ta, name, launch)
    return launched


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_wrappers_take_the_dtype_kernel(dtype, fake_libs,
                                                 monkeypatch):
    """On a CUDA tensor a float32 backward reaches K5-f32/K6-f32 at the
    float32 plan, a bf16 one K5/K6 at theirs, each counted under a key that
    ends with the dtype's name; nothing takes the plain version."""
    monkeypatch.setattr(ta, "_bwd_ref", None)   # never the plain version
    monkeypatch.setattr(ta.flash_attention_bwd_dq, "launches",
                        collections.Counter())
    monkeypatch.setattr(ta.flash_attention_bwd_dkv, "launches",
                        collections.Counter())
    args = _bwd_operands(dtype)
    ta.flash_attention_bwd_dq(*args, 0.1)
    ta.flash_attention_bwd_dkv(*args, 0.1)
    f32 = dtype == torch.float32
    names = [n for n, _ in fake_libs]
    assert names == (["_flash_k5_f32", "_flash_k6_f32"] if f32
                     else ["_flash_k5", "_flash_k6"])
    plans = (ta.flash_bwd_f32_plan if f32 else ta.flash_bwd_plan)(
        2, 1024, 1024, 40)
    assert [p for _, p in fake_libs] == list(plans)
    key = (1, 2, 1024, 1024, 40, ta.dtype_name(dtype))
    assert dict(ta.flash_attention_bwd_dq.launches) == {key: 1}
    assert dict(ta.flash_attention_bwd_dkv.launches) == {key: 1}


@pytest.mark.parametrize("dtypes", [
    (torch.float16, None),             # float16 still raises
    (torch.float32, torch.bfloat16),   # dO of another dtype than q
    (torch.bfloat16, torch.float32),
], ids=["float16", "f32-q-bf16-do", "bf16-q-f32-do"])
def test_bwd_args_refuse_what_the_forward_refuses(dtypes, fake_libs):
    """float16, and q/k/v/dO of mixed dtypes, raise in the backward's checks
    with the forward's ``_check`` messages; float32 and bf16 pass."""
    q, k, v, do, lse, delta = _bwd_operands(*dtypes)
    got = _message(ta._bwd_args, "flash_attention_bwd_dq", q, k, v, do, lse,
                   delta)
    want = _message(ta._check, "flash_attention", q, k,
                    {"q": q, "k": k, "v": v, "do": do})
    assert got == want
    for dt in (torch.float32, torch.bfloat16):
        lib, dims = ta._bwd_args("flash_attention_bwd_dq",
                                 *_bwd_operands(dt))
        assert dims == (2, 1024, 1024, 40)


def test_bwd_args_refuse_a_head_dim_without_a_kernel(fake_libs,
                                                     monkeypatch):
    """A head dim neither library instantiates raises; it never falls
    back."""
    for name in ("_bwd_lib", "_bwd_f32_lib"):
        monkeypatch.setattr(ta, name, lambda: types.SimpleNamespace(
            fgdm_flash_attn_bwd_block_n=lambda d: 0,
            fgdm_flash_attn_bwd_f32_block_n=lambda d: 0))
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="head dim 64 not instantiated"):
            ta._bwd_args("flash_attention_bwd_dq",
                         *_bwd_operands(dt, d=64))
