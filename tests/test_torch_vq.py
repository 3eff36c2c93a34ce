"""The port's VQ first stage (``fgdm_tpu_torch/models/vq.py``), the VAE's
constructor options and ``convert.vq_state_dict``, held against the JAX
package on the CPU.

JAX's parameter trees come from ``jax.eval_shape(model.init, ...)`` filled
with numpy-seeded values (``seeded``: flax's own init is slow here), and
reach the port through ``checkpoint/convert.py`` with ``strict=True``.
``VQModel`` runs at ``tests/test_model_zoo.py:37``'s tiny geometry (ch 32,
ch_mult (1, 2), one res block, 32^2, 32 codes), float32 on both sides.

Tolerances: outputs max|d| <= 1e-5 * max(1, max|ref|) (float32, sums in
another order); code indices equal, except that a differing index must be
a near-tie: its distance and JAX's choice's distance within 1e-5 *
max(1, max distance) of each other; the loss 1e-6 relative.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

import fgdm_tpu.models.autoencoder as jae  # noqa: E402
from fgdm_tpu.models import vq as jvq  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.models import autoencoder as tae  # noqa: E402
from fgdm_tpu_torch.models import vq as tvq  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
TINY = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=32,
            n_embed=32, embed_dim=4)


def seeded(jdef, args, seed, method=None):
    """``jdef``'s parameter tree from ``jax.eval_shape`` filled from a
    numpy seed: kernels N(0, 1/fan_in), norm scales near 1, biases and
    means small, variances in [0.5, 1.5], everything else N(0, 0.1^2)."""
    shapes = jax.eval_shape(lambda: jdef.init(jax.random.PRNGKey(0), *args,
                                              method=method))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        n = rng.standard_normal(s.shape)
        if name == "kernel" or name.endswith("_kernel"):
            v = n / np.sqrt(np.prod(s.shape[:-1]))
        elif name == "scale":
            v = 1.0 + 0.1 * n
        elif name == "var":
            v = rng.uniform(0.5, 1.5, s.shape)
        elif name == "embedding":
            v = n
        else:
            v = 0.1 * n
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def load(module, sd):
    module.load_state_dict(sd, strict=True)
    return module.eval()


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.moveaxis(np.asarray(a, np.float32), -1, 1)))


def nhwc(t):
    return np.moveaxis(t.detach().float().numpy(), 1, -1)


def close(got, ref, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach().float().numpy()
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = tol * max(1.0, float(np.abs(ref).max()))
    assert err <= lim, (err, lim)


def indices_agree(got, ref, z, codebook):
    """Equal, or a near-tie of the two codes' distances to z."""
    got, ref = np.asarray(got).ravel(), np.asarray(ref).ravel()
    flat = np.asarray(z, np.float64).reshape(got.size, -1)
    cb = np.asarray(codebook, np.float64)
    d = ((flat[:, None] - cb[None]) ** 2).sum(-1)
    rows = np.nonzero(got != ref)[0]
    gap = np.abs(d[rows, got[rows]] - d[rows, ref[rows]])
    assert np.all(gap <= 1e-5 * max(1.0, d.max())), (rows, gap)
    return len(rows)


@pytest.fixture(scope="module")
def quantizer():
    jdef = jvq.VectorQuantizer(n_embed=16, embed_dim=4)
    z = np.random.default_rng(1).standard_normal((2, 4, 4, 4)).astype(
        np.float32)
    p = seeded(jdef, (jnp.asarray(z),), 2)
    p = jax.tree.map(lambda a: 0.5 * a, p)      # codes inside z's spread
    tm = load(tvq.VectorQuantizer(n_embed=16, embed_dim=4),
              {"embedding.weight": torch.from_numpy(
                  np.asarray(p["params"]["embedding"]))})
    return jdef, p, tm, z


def test_vector_quantizer_matches_jax(quantizer):
    jdef, p, tm, z = quantizer
    zq_j, loss_j, idx_j = jax.jit(jdef.apply)(p, jnp.asarray(z))
    with torch.no_grad():
        zq_t, loss_t, idx_t = tm(nchw(z))
    assert idx_t.shape == (2, 4, 4) and idx_t.dtype == torch.int64
    indices_agree(idx_t.numpy(), idx_j, z, p["params"]["embedding"])
    close(nhwc(zq_t), zq_j)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-6)
    assert float(loss_t) > 0
    close(tm.lookup(idx_t), jdef.apply(p, idx_j,
                                       method=jvq.VectorQuantizer.lookup))


def test_vector_quantizer_straight_through_gradient_matches_jax(quantizer):
    jdef, p, tm, z = quantizer
    w = np.random.default_rng(3).standard_normal(z.shape).astype(np.float32)

    def jloss(zz, cb):
        zq, loss, _ = jdef.apply({"params": {"embedding": cb}}, zz)
        return jnp.sum(zq * w) + 3.0 * loss

    gz_j, gcb_j = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(z), p["params"]["embedding"])
    zt = nchw(z).requires_grad_(True)
    zq, loss, _ = tm(zt)
    ((zq * nchw(w)).sum() + 3.0 * loss).backward()
    close(nhwc(zt.grad), gz_j)
    close(tm.embedding.weight.grad.numpy(), gcb_j)


@pytest.fixture(scope="module")
def vq_pair():
    jdef = jvq.VQModel(**TINY)
    x = np.random.default_rng(4).uniform(-1, 1, (2, 32, 32, 3)).astype(
        np.float32)
    p = seeded(jdef, (jnp.zeros((1, 32, 32, 3)),), 5)
    tm = load(tvq.VQModel(**TINY, device="cpu"), convert.vq_state_dict(p))
    return jdef, p, tm, x


def test_vq_state_dict_is_taming_schema(vq_pair):
    _, p, tm, _ = vq_pair
    keys = set(convert.vq_state_dict(p))
    assert keys == set(tm.state_dict())
    assert {"quantize.embedding.weight", "quant_conv.weight",
            "post_quant_conv.bias", "encoder.conv_in.weight",
            "encoder.mid.attn_1.q.weight", "decoder.up.1.upsample.conv.weight",
            "encoder.down.0.downsample.conv.weight"} <= keys
    assert tm.quantize.embedding.weight.shape == (32, 4)
    assert not tm.encoder.mid.block_1.fused_norm       # JAX leaves it off


@pytest.mark.parametrize("method", ["call", "encode", "pre_quant"])
def test_vq_model_matches_jax(vq_pair, method):
    jdef, p, tm, x = vq_pair
    xt = nchw(x)
    with torch.no_grad():
        if method == "call":
            ref, ref_loss = jax.jit(jdef.apply)(p, jnp.asarray(x))
            got, loss = tm(xt)
            close(nhwc(got), ref)
            np.testing.assert_allclose(float(loss), float(ref_loss),
                                       rtol=1e-5)
        elif method == "encode":
            zq_j, loss_j, idx_j = jax.jit(lambda q, a: jdef.apply(
                q, a, method=jvq.VQModel.encode))(p, jnp.asarray(x))
            h = np.asarray(jdef.apply(p, jnp.asarray(x),
                                      method=jvq.VQModel.encode_pre_quant))
            zq, loss, idx = tm.encode(xt)
            close(nhwc(tm.encode_pre_quant(xt)), h)
            indices_agree(idx.numpy(), idx_j, h,
                          p["params"]["quantize"]["embedding"])
            close(nhwc(zq), zq_j)
            close(nhwc(tm.decode(zq)), jdef.apply(
                p, zq_j, method=jvq.VQModel.decode))
        else:
            h = np.random.default_rng(6).standard_normal(
                (2, 16, 16, 4)).astype(np.float32)
            for force in (False, True):
                ref = jdef.apply(p, jnp.asarray(h), force,
                                 method=jvq.VQModel.decode_pre_quant)
                got = tm.decode_pre_quant(nchw(h), force_not_quantize=force)
                close(nhwc(got), ref)


@pytest.mark.parametrize("kind", ["down", "up", "tanh"])
def test_vae_constructor_options_match_jax(kind):
    rng = np.random.default_rng(7)
    if kind == "tanh":
        kw = dict(ch=32, ch_mult=(1, 2), num_res_blocks=1, resolution=16,
                  z_channels=4)
        jdef = jae.Decoder(**kw, tanh_out=True)
        z = 3.0 * rng.standard_normal((1, 8, 8, 4)).astype(np.float32)
        p = seeded(jdef, (jnp.asarray(z),), 8)
        sd = {k[len("decoder."):]: v for k, v in
              convert.vae_state_dict({"decoder": p["params"]}).items()}
        tm = load(tae.Decoder(**kw, tanh_out=True), sd)
        ref = jdef.apply(p, jnp.asarray(z))
        with torch.no_grad():
            got = tm(nchw(z))
        assert np.abs(np.asarray(ref)).max() <= 1.0
        close(nhwc(got), ref)
        return
    x = rng.standard_normal((2, 7, 9, 8)).astype(np.float32)
    jdef = (jae.VaeDownsample(with_conv=False) if kind == "down"
            else jae.VaeUpsample(with_conv=False))
    tm = (tae.VaeDownsample(8, with_conv=False) if kind == "down"
          else tae.VaeUpsample(8, with_conv=False))
    assert list(tm.state_dict()) == []
    ref = jdef.apply({}, jnp.asarray(x))
    close(nhwc(tm(nchw(x))), ref)
