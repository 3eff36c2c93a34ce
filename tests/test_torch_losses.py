"""The port's first-stage training losses
(``fgdm_tpu_torch/diffusion/perceptual_losses.py``) and their ``convert``
maps, held against the JAX package on the CPU.

``LPIPS`` (full VGG16 widths) at 32^2 and a ``PatchDiscriminator`` with
ndf 16, float32, on parameter trees from ``jax.eval_shape`` filled with
numpy-seeded values (``test_torch_vq.seeded``).  ``generator_loss`` and its
gradient with respect to ``recon`` go through both packages' LPIPS and
discriminator; the discriminator losses on seeded logits.

Tolerances: distances, logits, losses and gradients max|d| <= 1e-5 *
max(1, max|ref|) (float32, sums in another order; ``test_torch_vq.close``).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.diffusion import perceptual_losses as jpl  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.diffusion import perceptual_losses as tpl  # noqa: E402
from test_torch_vq import close, load, nchw, nhwc, seeded  # noqa: E402

torch.set_num_threads(2)

HW = 32


@pytest.fixture(scope="module")
def nets():
    x = jnp.zeros((1, HW, HW, 3))
    jl, jd = jpl.LPIPS(), jpl.PatchDiscriminator(ndf=16)
    pl, pd = seeded(jl, (x, x), 10), seeded(jd, (x,), 11)
    tl = load(tpl.LPIPS(device="cpu"), convert.lpips_state_dict(pl))
    td = load(tpl.PatchDiscriminator(ndf=16, device="cpu"),
              convert.patch_discriminator_state_dict(pd))
    return dict(jl=jl, jd=jd, pl=pl, pd=pd, tl=tl, td=td,
                lpips=jax.jit(jl.apply), disc=jax.jit(jd.apply))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(12)
    x = rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)
    return x, np.clip(x + 0.3 * rng.standard_normal(x.shape), -1,
                      1).astype(np.float32)


def test_state_dicts_name_every_parameter(nets):
    lp = convert.lpips_state_dict(nets["pl"])
    assert set(lp) == set(nets["tl"].state_dict())
    assert lp["lin4.weight"].shape == (1, 512, 1, 1)
    assert lp["vgg.conv5_3.weight"].shape == (512, 512, 3, 3)
    dp = convert.patch_discriminator_state_dict(nets["pd"])
    assert set(dp) == set(nets["td"].state_dict())
    assert "conv3.bias" not in dp and dp["norm3.weight"].shape == (128,)


def test_lpips_matches_jax(nets, images):
    x, y = images
    ref = nets["lpips"](nets["pl"], jnp.asarray(x), jnp.asarray(y))
    with torch.no_grad():
        got = nets["tl"](nchw(x), nchw(y))
        same = nets["tl"](nchw(x), nchw(x))
    assert got.shape == (2,)
    close(got, ref)
    assert float(same.abs().max()) == 0.0


def test_vgg_taps_match_jax(nets, images):
    x = (images[0] + 1) / 2
    jv = jpl.VGG16Features()
    refs = jv.apply({"params": nets["pl"]["params"]["vgg"]}, jnp.asarray(x))
    with torch.no_grad():
        taps = nets["tl"].vgg(nchw(x))
    assert [t.shape[1] for t in taps] == [64, 128, 256, 512, 512]
    for got, ref in zip(taps, refs):
        close(nhwc(got), ref)


def test_patch_discriminator_matches_jax(nets, images):
    ref = nets["disc"](nets["pd"], jnp.asarray(images[0]))
    with torch.no_grad():
        got = nets["td"](nchw(images[0]))
    assert got.shape == (2, 1, 2, 2)
    close(nhwc(got), ref)


@pytest.mark.parametrize("kind", ["hinge", "vanilla"])
def test_discriminator_losses_match_jax(kind):
    rng = np.random.default_rng(13)
    real, fake = (rng.standard_normal((2, 1, 6, 6)).astype(np.float32)
                  for _ in range(2))
    jfn = getattr(jpl, f"{kind}_d_loss")
    tfn = getattr(tpl, f"{kind}_d_loss")
    ref = jfn(jnp.asarray(real), jnp.asarray(fake))
    close(tfn(torch.from_numpy(real), torch.from_numpy(fake)), ref)
    gr, gf = jax.grad(jfn, argnums=(0, 1))(jnp.asarray(real),
                                           jnp.asarray(fake))
    r, f = (torch.from_numpy(a).requires_grad_(True) for a in (real, fake))
    tfn(r, f).backward()
    close(r.grad, gr)
    close(f.grad, gf)


def test_generator_loss_and_its_gradient_match_jax(nets, images):
    """Every term on: reconstruction, LPIPS, KL, codebook, adversarial."""
    x, recon = images
    kw = {"kl": np.array([2.5, 4.0], np.float32),
          "codebook_loss": np.float32(0.7)}

    def jloss(r):
        return jpl.generator_loss(
            jnp.asarray(x), r, lambda a, b: nets["jl"].apply(nets["pl"], a, b),
            disc_fn=lambda a: nets["jd"].apply(nets["pd"], a),
            kl_weight=0.01, **{k: jnp.asarray(v) for k, v in kw.items()})

    (ref, ref_log), ref_grad = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(jnp.asarray(recon))
    rt = nchw(recon).requires_grad_(True)
    loss, log = tpl.generator_loss(
        nchw(x), rt, nets["tl"], disc_fn=nets["td"], kl_weight=0.01,
        **{k: torch.as_tensor(v) for k, v in kw.items()})
    loss.backward()
    assert set(log) == set(ref_log)
    for k in log:
        close(log[k], ref_log[k])
    close(loss, ref)
    assert float(rt.grad.abs().max()) > 0
    close(nhwc(rt.grad), ref_grad)
    # with the adversarial term off
    off, off_log = tpl.generator_loss(nchw(x), nchw(recon), nets["tl"],
                                      disc_fn=nets["td"], disc_active=False,
                                      perceptual_weight=0.0)
    assert set(off_log) == {"rec_loss", "total_loss"}
    close(off.detach(), np.abs(x - recon).mean())
