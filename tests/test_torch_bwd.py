"""The flash backward's host logic and arithmetic (K5 dQ, K6 dK/dV), on the
CPU.

The kernels (``fgdm_tpu_torch/kernels/csrc/flash_attn_bwd.cu``) run only on
the card, where ``chip_smoke.py`` holds them against ``attention_bwd_ref``.
Here ``k56_arithmetic`` repeats their arithmetic in plain torch (the tiles
of ``flash_bwd_plan``, base-2 exps with scale * log2 e folded in, P^T and
dS^T rounded to bf16 before their products, B operands read with d padded
to whole 64-wide swizzle atoms, f32 accumulation, dK and dQ scaled once)
and is held against the JAX package's Pallas backward
``_flash_backward_t`` in interpret mode and ``jax.vjp`` of
``_xla_attention``, within 2e-2 * max|ref| + 2e-3 (``chip_smoke.py``'s
``BWD_TOL``: bf16 inputs, P and dS rounded to bf16).  The plan is checked
as K1's is (``tests/test_torch_kernels.py``): a tile the kernels take for
every shape the gate admits, at least 128 blocks at the paths' shapes,
refusal of what the kernels do not take, and the source's constants.
"""

import re

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.kernels.attention as ka  # noqa: E402
from fgdm_tpu_torch.kernels import _build  # noqa: E402
from fgdm_tpu_torch.kernels import attention as ta  # noqa: E402

torch.set_num_threads(2)

BWD_TOL = (2e-2, 2e-3)


def _padded(x, np_):
    """x ``[..., d]`` with zero columns up to ``np_`` (the zeros TMA writes
    past d in a 64-wide box)."""
    return torch.nn.functional.pad(x, (0, np_ - x.shape[-1]))


def k56_arithmetic(q, k, v, do, lse, delta, scale, plans):
    """The K5 and K6 kernels' arithmetic in plain torch on bf16 q/k/v/dO and
    f32 lse/delta ``[B, H, Nq]``: K5 walks key tiles of ``plans[0].bt``, K6
    query tiles of ``plans[1].bt`` (the last one ragged).  Returns
    ``(dq, dk, dv)`` in bf16."""
    sl = scale * ta._LOG2E
    d = q.shape[-1]
    np_ = -(-d // 64) * 64
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    l2 = lse.float()[..., None] * ta._LOG2E
    dl = delta.float()[..., None]
    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731

    # K5: a block's query rows against streamed key tiles
    dq = torch.zeros(*q.shape[:3], np_)
    bn = plans[0].bt
    for j in range(0, k.shape[2], bn):
        kj, vj = kf[:, :, j:j + bn], vf[:, :, j:j + bn]
        p = torch.exp2(qf @ kj.transpose(2, 3) * sl - l2)
        ds = p * (dof @ vj.transpose(2, 3) - dl)
        dq = dq + bf(ds) @ _padded(kj, np_)
    # K6: a block's key rows against streamed query tiles, transposed scores
    dk = torch.zeros(*k.shape[:3], np_)
    dv = torch.zeros(*k.shape[:3], np_)
    bq = plans[1].bt
    for i in range(0, q.shape[2], bq):
        qi, doi = qf[:, :, i:i + bq], dof[:, :, i:i + bq]
        pt = torch.exp2(kf @ qi.transpose(2, 3) * sl
                        - l2[:, :, i:i + bq].transpose(2, 3))
        dst = pt * (vf @ doi.transpose(2, 3)
                    - dl[:, :, i:i + bq].transpose(2, 3))
        dv = dv + bf(pt) @ _padded(doi, np_)
        dk = dk + bf(dst) @ _padded(qi, np_)
    return tuple((t[..., :d] * s).to(torch.bfloat16)
                 for t, s in ((dq, scale), (dk, scale), (dv, 1.0)))


@pytest.mark.parametrize("d,nq,nk", [(40, 256, 256), (40, 200, 256),
                                     (80, 256, 256), (80, 136, 384)],
                         ids=["d40", "d40-ragged", "d80", "d80-ragged"])
def test_k56_arithmetic_matches_pallas_and_xla_vjp(d, nq, nk, monkeypatch):
    """At an even and a ragged query length, the kernels' arithmetic on bf16
    inputs against the Pallas backward (interpret mode) and the XLA VJP on
    the same values in f32; the wrappers' CPU route is the plain version."""
    monkeypatch.setattr(ka, "_INTERPRET", True)
    rng = np.random.default_rng(d + nq)
    shapes = ((1, 2, nq, d), (1, 2, nk, d), (1, 2, nk, d), (1, 2, nq, d))
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
                  .to(torch.bfloat16) for s in shapes)
    scale = d ** -0.5
    jq, jk, jv, jg = (jnp.asarray(t.float().numpy()) for t in (q, k, v, g))
    _, vjp = jax.vjp(lambda a, b, c: ka._xla_attention(a, b, c, scale),
                     jq, jk, jv)
    xla = vjp(jg)
    o, lse = ka._flash_attention_t(jq, jk, jv, scale, block_q=128,
                                   block_k=128, return_lse=True)
    pallas = ka._flash_backward_t(jq, jk, jv, o, lse, jg, scale,
                                  block_q=128, block_k=128)
    # the port's forward (bf16 out, f32 lse) and delta, as on the card
    to, tlse = ta.attention_ref(q, k, v, scale, return_lse=True)
    to = to.to(torch.bfloat16)
    delta = (g.float() * to.float()).sum(dim=-1)
    plans = ta.flash_bwd_plan(2, nq, nk, d)
    emu = k56_arithmetic(q, k, v, g, tlse, delta, scale, plans)
    plain = ta.flash_attention_backward(q, k, v, to, tlse, g, scale)
    for ours, cpu, x, p in zip(emu, plain, xla, pallas):
        assert ours.dtype == torch.bfloat16 and ours.shape == cpu.shape
        for ref in (np.asarray(x), np.asarray(p)):
            tol = BWD_TOL[0] * np.abs(ref).max() + BWD_TOL[1]
            np.testing.assert_allclose(ours.float().numpy(), ref, atol=tol,
                                       rtol=0)
            np.testing.assert_allclose(cpu.float().numpy(), ref, atol=tol,
                                       rtol=0)


# (B*H, Nq, Nk, d) of K5/K6's launches: the training step at batch 8, and
# the 512^2 training shapes of chip_smoke.py's BWD_CASES
BWD_PATH_SHAPES = [(64, 1024, 1024, 40), (16, 4096, 4096, 40),
                   (16, 1024, 1024, 80)]


@pytest.mark.parametrize("d", [40, 80])
@pytest.mark.parametrize("nq,nk", [(512, 512), (520, 1024), (1000, 1536),
                                    (1024, 1024), (4096, 4096), (4097, 512),
                                    (600, 2048)])
@pytest.mark.parametrize("bh", [1, 3, 16, 64])
def test_bwd_plan_is_a_valid_tile(bh, nq, nk, d):
    """Every shape the gate admits gets a tile each kernel takes: K5's keys
    per tile divide Nk, each grid covers its rows (queries for K5, keys for
    K6) once, the ring fits the block's shared memory."""
    for plan, rows in zip(ta.flash_bwd_plan(bh, nq, nk, d), (nq, nk)):
        assert plan.bt in ta._BWD_TILES[plan.kernel]
        assert plan.kernel == "dkv" or nk % plan.bt == 0
        span = plan.wgs * ta._BWD_WG_ROWS
        assert plan.grid[1] == bh
        assert (plan.grid[0] - 1) * span < rows <= plan.grid[0] * span
        assert 2 <= plan.stages <= ta._BWD_MAX_STAGES
        assert plan.smem <= ta._SMEM_LIMIT
        assert plan == ta.bwd_tile(plan.kernel, bh, nq, nk, d, plan.bt,
                                   plan.stages, plan.wgs)


@pytest.mark.parametrize("shape", BWD_PATH_SHAPES,
                         ids=lambda s: f"bh{s[0]}-n{s[1]}-d{s[3]}")
def test_bwd_plan_fills_the_card(shape):
    """At least 128 blocks (of 132 SMs) for each kernel at the backward's
    shapes; at d = 80 K6 keeps one warpgroup and K5 64-key tiles (the
    register budget of d padded to 128)."""
    dq, dkv = ta.flash_bwd_plan(*shape)
    for plan in (dq, dkv):
        assert plan.grid[0] * plan.grid[1] >= 128
    if shape[3] > 64:
        assert dkv.wgs == 1 and dq.bt == 64
    else:
        assert dq.bt == 128 and dq.wgs == dkv.wgs == 2


@pytest.mark.parametrize("kernel,bt,stages,wgs,d,nk", [
    ("dq", 96, 2, 2, 40, 1024),      # no such key tile
    ("dq", 128, 2, 2, 40, 960),      # does not divide Nk
    ("dq", 64, 1, 2, 40, 1024),      # a ring of one
    ("dq", 64, 5, 2, 40, 1024),      # deeper than the header's barriers
    ("dq", 64, 2, 3, 40, 1024),      # three consumer warpgroups
    ("dq", 128, 3, 2, 80, 1024),     # 264,192 B of shared memory
    ("dkv", 128, 2, 2, 40, 1024),    # no such query tile
    ("dkv", 64, 2, 3, 40, 1024),
    ("dkv", 64, 5, 1, 40, 1024),
    ("dqkv", 64, 2, 2, 40, 1024),    # no such kernel
])
def test_bwd_tile_refuses_what_the_kernels_do_not_take(kernel, bt, stages,
                                                        wgs, d, nk):
    with pytest.raises(ValueError, match="no (tile|kernel)"):
        ta.bwd_tile(kernel, 16, 1024, nk, d, bt, stages, wgs)


def test_bwd_constants_match_the_source():
    """The tile constants and choices the host's plan assumes are
    ``flash_attn_bwd.cu``'s."""
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    assert f"constexpr int WG_ROWS = {ta._BWD_WG_ROWS};" in src
    assert f"constexpr int MAX_STAGES = {ta._BWD_MAX_STAGES};" in src
    assert f"constexpr int SMEM_LIMIT = {ta._SMEM_LIMIT};" in src
    assert "constexpr int HEADER = 1024;" in src  # bwd_tile's 2048 = 1024 + it
    for kernel, var in (("dq", "bn"), ("dkv", "bq")):
        tiles = set(re.findall(rf"if \({var} == (\d+) && wgs == (\d+)\)",
                               src))
        assert tiles == {(str(bt), str(w)) for bt in ta._BWD_TILES[kernel]
                         for w in ta._BWD_WGS}
    # no atomics: reruns are bit-identical
    assert "atomic" not in src.replace("no atomics", "")
