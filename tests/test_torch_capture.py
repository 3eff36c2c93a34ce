"""The port's attention-map capture held against the JAX package, on the CPU.

``attention_with_scores``, ``CrossAttention`` in each capture mode (a
filtering and pooling ``CaptureSpec`` and ``adapt_q`` too), the UNet's
capture dicts, and the map aggregation of ``utils/attention_maps.py``
(the cubic query-grid resize against ``jax.image.resize``).  Tiny
geometries of ``tests/test_torch_train.py`` (``UNET_TINY``, 8x8 latents),
float32 unless a case says bf16.  The UNet's weights are the port's seeded
init with 0.02 N(0, 1) on every parameter, read into flax through the JAX
ingest (flax's own init takes a minute here); inputs come from
``np.random.default_rng``.

Tolerances: maps, losses and outputs 1e-4 relative (``LOSS_RTOL``) plus an
absolute 1e-5 x max|ref| (the same float32 sums in another order); bf16
inputs 1e-2 x max|ref| on the output (bf16 roundings at other places), the
f32 scores as in f32 (both upcast the same bf16 values); the resize 1e-5
absolute on maps in [0, 1).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.nn.attention as jat  # noqa: E402
import fgdm_tpu.utils.attention_maps as jam  # noqa: E402
from fgdm_tpu.checkpoint import loader as jloader  # noqa: E402
from fgdm_tpu.checkpoint import torch_ingest as jti  # noqa: E402
from fgdm_tpu.kernels.attention import (  # noqa: E402
    attention_with_scores as j_attention_with_scores)
from fgdm_tpu.models.unet import UNetModel as JUNetModel  # noqa: E402
from fgdm_tpu_torch.checkpoint import torch_ingest as ti  # noqa: E402
from fgdm_tpu_torch.kernels.attention import attention_with_scores  # noqa: E402
from fgdm_tpu_torch.models.unet import UNetModel  # noqa: E402
from fgdm_tpu_torch.nn import attention as tat  # noqa: E402
from fgdm_tpu_torch.nn.layers import init_params_  # noqa: E402
from fgdm_tpu_torch.utils import attention_maps as tam  # noqa: E402
from test_torch_layers import perturbed_pair  # noqa: E402
from test_torch_train import LOSS_RTOL, UNET_TINY, nchw  # noqa: E402

torch.set_num_threads(2)

MODES = {"true": True, "sim": "sim", "probs": "probs",
         "spec": jat.CaptureSpec(self_n=64, self_pool=2)}


def close(port, ref, rtol=LOSS_RTOL):
    port = (port.detach().float().numpy() if isinstance(port, torch.Tensor)
            else np.asarray(port, np.float32))
    ref = np.asarray(ref, np.float32)
    assert port.shape == ref.shape, (port.shape, ref.shape)
    np.testing.assert_allclose(port, ref, rtol=rtol,
                               atol=1e-5 * max(1.0, np.abs(ref).max()))


def port_spec(spec):
    """The port's ``CaptureSpec`` for a JAX one (other modes as they are)."""
    if isinstance(spec, jat.CaptureSpec):
        return tat.CaptureSpec(spec.mode, spec.self_n, spec.self_pool)
    return spec


def tiny_unet(seed, use_adapter=True, geometry=UNET_TINY, qk_scale=1.0):
    """``(flax def, flax params, port UNet)`` on the same weights: the
    port's seeded init, 0.02 N(0, 1) on every parameter, read into flax by
    the JAX ingest.  ``qk_scale`` multiplies every q and k projection (a
    sharper attention, for tests that need the maps to differ)."""
    unet = UNetModel(**geometry, use_adapter=use_adapter, dtype=torch.float32,
                     device="cpu")
    init_params_(unet, torch.Generator().manual_seed(seed), 0.02)
    with torch.no_grad():
        for name, p in unet.named_parameters():
            if name.endswith(("to_q.weight", "to_k.weight")):
                p.mul_(qk_scale)
    jdef = JUNetModel(**geometry, use_adapter=use_adapter, dtype=jnp.float32)
    expect = jloader._abstract_init(jdef, jnp.zeros((1, 8, 8, 4)),
                                    jnp.zeros((1,), jnp.int32),
                                    jnp.zeros((1, 77, 64)))
    tree, missing, unexpected = jti.ingest_unet(
        {ti.UNET_PREFIX + k: v.numpy() for k, v in unet.state_dict().items()},
        expect=expect)
    assert missing == [] and unexpected == []
    return jdef, jax.tree.map(np.asarray, tree), unet.eval()


@pytest.fixture(scope="module")
def unet_pair():
    return tiny_unet(40)


@pytest.fixture(scope="module")
def unet_inputs():
    rng = np.random.default_rng(41)
    return dict(x=rng.standard_normal((2, 8, 8, 4)).astype(np.float32),
                t=np.array([17, 613]),
                ctx=rng.standard_normal((2, 77, 64)).astype(np.float32))


# --- attention_with_scores ---------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pool", [1, 2, 4])
def test_attention_with_scores_matches_jax(pool, dtype):
    rng = np.random.default_rng(42 + pool)
    q = rng.standard_normal((2, 4, 32, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 4, 48, 16)).astype(np.float32)
            for _ in range(2))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_out, ref = j_attention_with_scores(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), 0.25, pool_kq=pool)
    out, scores = attention_with_scores(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)), 0.25,
        pool_kq=pool)
    assert scores.dtype == torch.float32 and out.dtype == tdt
    assert tuple(scores.shape) == (2, 32 // pool, 48 // pool)
    close(scores, ref)
    close(out, np.asarray(ref_out, np.float32),
          LOSS_RTOL if dtype == "float32" else 1e-2)


def test_attention_with_scores_refuses_ragged_pool():
    q = torch.zeros(1, 2, 6, 8)
    with pytest.raises(ValueError, match="pool_kq=4"):
        attention_with_scores(q, q, q, 1.0, pool_kq=4)


# --- CrossAttention ----------------------------------------------------------

@pytest.mark.parametrize("adapt", [False, True], ids=["plain", "adapt_q"])
@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_cross_attention_capture_matches_jax(mode, cross, adapt):
    rng = np.random.default_rng(43)
    x = rng.standard_normal((2, 64, 32)).astype(np.float32)
    ctx = (rng.standard_normal((2, 77, 48)).astype(np.float32) if cross
           else None)
    aq = rng.standard_normal((2, 64, 32)).astype(np.float32) if adapt else None
    jm = jat.CrossAttention(32, context_dim=48 if cross else None, heads=4,
                            dim_head=8)
    kw = {"context": jnp.zeros((1, 77, 48))} if cross else {}
    p, tm = perturbed_pair(jm, tat.CrossAttention(
        32, context_dim=48 if cross else None, heads=4, dim_head=8),
        (jnp.zeros((1, 64, 32)),), **kw)
    cap = MODES[mode]
    ref, ref_maps = jm.apply(
        p, jnp.asarray(x), context=None if ctx is None else jnp.asarray(ctx),
        adapt_q=None if aq is None else jnp.asarray(aq), capture=cap)
    out, maps = tm(torch.from_numpy(x),
                   context=None if ctx is None else torch.from_numpy(ctx),
                   adapt_q=None if aq is None else torch.from_numpy(aq),
                   capture=port_spec(cap))
    close(out, ref)
    close(maps, ref_maps)
    want = {"probs": (2, 4, 64, 77 if cross else 64),
            "spec": (2, 64, 77) if cross else (2, 32, 32)}.get(
                mode, (2, 64, 77 if cross else 64))
    assert tuple(maps.shape) == want


def test_cross_attention_spec_filters_other_token_counts():
    """A self layer whose token count is not ``self_n`` emits no map and
    gives the no-capture output; a cross layer still emits its map."""
    rng = np.random.default_rng(44)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((2, 77, 32))
                           .astype(np.float32))
    spec = tat.CaptureSpec(self_n=64, self_pool=4)
    tm = tat.CrossAttention(32, heads=4, dim_head=8)
    out, maps = tm(x, capture=spec)
    assert maps is None and torch.equal(out, tm(x))
    out, maps = tm(x, context=ctx, capture=spec)
    assert tuple(maps.shape) == (2, 16, 77) and torch.equal(
        out, tm(x, context=ctx))


@pytest.mark.parametrize("depth", [1, 2])
def test_spatial_transformer_reports_last_block_maps(depth):
    rng = np.random.default_rng(45)
    x = rng.standard_normal((2, 4, 4, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 77, 24)).astype(np.float32)
    jm = jat.SpatialTransformer(64, 4, 16, depth=depth, context_dim=24)
    p, tm = perturbed_pair(
        jm, tat.SpatialTransformer(64, 4, 16, depth=depth, context_dim=24),
        (jnp.zeros((1, 4, 4, 64)),), context=jnp.zeros((1, 77, 24)))
    ref, (rs, rc) = jm.apply(p, jnp.asarray(x), context=jnp.asarray(ctx),
                             capture=True)
    out, (s, c) = tm(nchw(x), context=torch.from_numpy(ctx), capture=True)
    close(out.permute(0, 2, 3, 1), ref)
    close(s, rs)
    close(c, rc)


# --- the UNet ----------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_unet_capture_matches_jax(unet_pair, unet_inputs, mode):
    jdef, jp, unet = unet_pair
    cap = MODES[mode]
    ref_eps, ref_self, ref_cross = jdef.apply(
        jp, jnp.asarray(unet_inputs["x"]), jnp.asarray(unet_inputs["t"]),
        jnp.asarray(unet_inputs["ctx"]), capture=cap)
    args = (nchw(unet_inputs["x"]), torch.from_numpy(unet_inputs["t"]),
            torch.from_numpy(unet_inputs["ctx"]))
    with torch.no_grad():
        eps, selfattn, crossattn = unet(*args[:2], context=args[2],
                                        capture=port_spec(cap))
        plain = unet(*args[:2], context=args[2])
    assert list(selfattn) == list(ref_self)
    assert list(crossattn) == list(ref_cross)
    if mode == "spec":
        assert list(selfattn) == ["input_blocks.1.1", "output_blocks.2.1",
                                  "output_blocks.3.1"]
    else:
        assert list(selfattn) == list(crossattn) == [
            "input_blocks.1.1", "input_blocks.3.1", "middle_block.1",
            "output_blocks.0.1", "output_blocks.1.1", "output_blocks.2.1",
            "output_blocks.3.1"]
    for k in ref_self:
        close(selfattn[k], ref_self[k])
    for k in ref_cross:
        close(crossattn[k], ref_cross[k])
    close(eps.permute(0, 2, 3, 1), ref_eps)
    # the capture leaves eps as the plain forward gives it, bit for bit
    # (the explicit f32 softmax of "probs" is another computation)
    if mode != "probs":
        assert torch.equal(eps, plain)


# --- map aggregation ---------------------------------------------------------

@pytest.mark.parametrize("r,resn", [(2, 8), (4, 16), (8, 32), (16, 32),
                                    (16, 8), (8, 4), (4, 2)])
def test_resize_query_grid_matches_jax_cubic(r, resn):
    m = np.random.default_rng(46 + r).random((2, r * r, 5)).astype(np.float32)
    got = tam._resize_query_grid(torch.from_numpy(m), r, resn)
    ref = jam._resize_query_grid(jnp.asarray(m), r, resn)
    assert tuple(got.shape) == (2, resn * resn, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)


def test_resize_is_not_torch_bicubic():
    """The reason for ``_cubic_weights``: ``F.interpolate``'s bicubic
    (a = -0.75, clamped edges) is another resize."""
    m = np.random.default_rng(47).random((1, 16 * 16, 1)).astype(np.float32)
    ref = np.asarray(jam._resize_query_grid(jnp.asarray(m), 16, 32))
    bicubic = torch.nn.functional.interpolate(
        torch.from_numpy(m).reshape(1, 16, 16, 1).permute(0, 3, 1, 2),
        size=(32, 32), mode="bicubic", align_corners=False)
    assert np.abs(bicubic.reshape(1, -1).numpy()
                  - ref.reshape(1, -1)).max() > 1e-2


def test_get_token_maps_matches_jax():
    rng = np.random.default_rng(48)
    sa = {"a": rng.random((2, 64, 64)), "b": rng.random((2, 16, 16)),
          "c": rng.random((2, 64, 64))}
    ca = {"a": rng.random((2, 64, 77)), "b": rng.random((2, 16, 77)),
          "c": rng.random((2, 256, 77))}
    f32 = {k: {n: m.astype(np.float32) for n, m in d.items()}
           for k, d in (("s", sa), ("c", ca))}
    got = tam.get_token_maps(
        *({n: torch.from_numpy(m) for n, m in f32[k].items()}
          for k in "sc"), resn=8)
    ref = jam.get_token_maps(
        *({n: jnp.asarray(m) for n, m in f32[k].items()} for k in "sc"),
        resn=8)
    assert tuple(got[1].shape) == (2, 8, 8, 77)
    for g, r in zip(got, ref):
        close(g, r)
    with pytest.raises(ValueError, match="resolution 4"):
        tam.get_token_maps({"a": torch.from_numpy(f32["s"]["a"])}, {},
                           resn=4)


@pytest.mark.parametrize("times", [1, 2])
def test_avg_pool_map_2x_matches_jax(times):
    m = np.random.default_rng(49).standard_normal((2, 64, 32)).astype(
        np.float32)
    close(tam.avg_pool_map_2x(torch.from_numpy(m), times),
          jam.avg_pool_map_2x(jnp.asarray(m), times))


def test_kl_distill_loss_matches_jax():
    rng = np.random.default_rng(50)
    maps = [rng.standard_normal(s).astype(np.float32)
            for s in ((2, 64, 64), (2, 8, 8, 77), (2, 64, 64), (2, 8, 8, 77))]
    got = tam.kl_distill_loss(*(torch.from_numpy(m) for m in maps))
    ref = jam.kl_distill_loss(*(jnp.asarray(m) for m in maps))
    close(got, ref)
    assert float(got) > 0
    same = tam.kl_distill_loss(*(torch.from_numpy(m) for m in maps[:2] * 2))
    assert abs(float(same)) < 1e-6
