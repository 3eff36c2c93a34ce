"""The port's annotators (``fgdm_tpu_torch/annotators/``), their checkpoint
ingest and ``convert``'s annotator maps, held against the JAX package on
the CPU.

HED, PiDiNet and UniFormer at their full (fixed) widths, DPT-Hybrid at
embed 64, 2 layers, 4 heads, hooks (0, 1), fusion width 16 (its R50 stem is
fixed); inputs 64^2, float32.  Weights are the port's seeded init (the
UniFormer's BatchNorm statistics drawn too), written as the reference's
checkpoint files (PiDiNet's ``module.`` prefix under ``"state_dict"``,
MiDaS's final ViT norm, its deepest fusion block's ``resConfUnit1`` and a
577-token position table, UniFormer's ``num_batches_tracked`` and
``auxiliary_head``), read into the port by ``checkpoint/annotator_ingest``
and into flax by JAX's ``ingest_*`` (flax's own init of these nets is slow
here).

Tolerances (float32 both sides, sums in other orders): annotator outputs
max|d| <= 1e-4 * max|ref| + 1e-5 (``FWD_TOL``: DPT's 20 layers reach
~3e-5 of its max); PiDiNet's binarized map may flip only where its sigmoid
is within 1e-4 of the 0.5 threshold; PDC kernels, resizes, pools,
normals and the position-table resize 1e-6; UniFormer labels may differ
on at most 0.1 % of pixels (near-ties of the argmax); ``convert``'s round
trips are bit-exact.

``seg2image --detect`` runs both CLIs on ``tests/test_torch_cli.py``'s tiny
ControlNet files and compares the maps their detectors hand the render.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from PIL import Image  # noqa: E402

from fgdm_tpu.annotators import hed as jhed  # noqa: E402
from fgdm_tpu.annotators import midas as jmidas  # noqa: E402
from fgdm_tpu.annotators import pidinet as jpidinet  # noqa: E402
from fgdm_tpu.annotators import uniformer as juniformer  # noqa: E402
from fgdm_tpu.checkpoint import annotator_ingest as jai  # noqa: E402
from fgdm_tpu.checkpoint.torch_ingest import (  # noqa: E402
    load_torch_state_dict as j_load_sd)
from fgdm_tpu.cli import seg2image as jseg2image  # noqa: E402
from fgdm_tpu_torch.annotators import seed_  # noqa: E402
from fgdm_tpu_torch.annotators import midas, pidinet, uniformer  # noqa: E402
from fgdm_tpu_torch.annotators.hed import ControlNetHED  # noqa: E402
from fgdm_tpu_torch.checkpoint import annotator_ingest as ai  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.cli import seg2image  # noqa: E402
from test_torch_cli import _pngs, _seg_map, files  # noqa: E402,F401

torch.set_num_threads(2)

FWD_TOL = (1e-4, 1e-5)
DPT_TINY = dict(embed_dim=64, num_layers=2, num_heads=4, hooks=(0, 1),
                features=16)
HW = 64
NAMES = ("hed", "pidinet", "midas", "uniformer")


def nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def close(got, ref, tol=FWD_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = tol[0] * np.abs(ref).max() + tol[1]
    assert err <= lim, (err, lim)


def _port(name):
    """(port module, flax def) of ``name`` at the tests' widths."""
    return {
        "hed": lambda: (ControlNetHED(device="cpu"), jhed.ControlNetHED()),
        "pidinet": lambda: (pidinet.PiDiNet(binarize=False, device="cpu"),
                            jpidinet.PiDiNet(binarize=False)),
        "midas": lambda: (midas.DPTHybrid(**DPT_TINY, device="cpu"),
                          jmidas.DPTHybrid(**DPT_TINY)),
        "uniformer": lambda: (uniformer.UniFormerSeg(device="cpu"),
                              juniformer.UniFormerSeg()),
    }[name]()


def _seeded(name, seed):
    module, jdef = _port(name)
    gen = torch.Generator().manual_seed(seed)
    seed_(module, gen)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, uniformer.FrozenBatchNorm):
                m.weight.normal_(1.0, 0.1, generator=gen)
                m.bias.normal_(0.0, 0.1, generator=gen)
                m.running_mean.normal_(0.0, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return module.eval(), jdef


def reference_file(name, module, path):
    """``module``'s weights as the released checkpoint holds them."""
    sd = {k: v.clone() for k, v in module.state_dict().items()}
    gen = torch.Generator().manual_seed(5)
    if name == "pidinet":
        sd = {"state_dict": {"module." + k: v for k, v in sd.items()}}
    elif name == "midas":
        d = sd["pretrained.model.cls_token"].shape[-1]
        assert sd["pretrained.model.pos_embed"].shape == (1, 577, d)
        sd["pretrained.model.norm.weight"] = torch.ones(d)
        sd["pretrained.model.norm.bias"] = torch.zeros(d)
        for k, v in list(sd.items()):
            if k.startswith("scratch.refinenet3.resConfUnit1."):
                sd[k.replace("refinenet3", "refinenet4")] = torch.randn(
                    v.shape, generator=gen)
    elif name == "uniformer":
        for k in list(sd):
            if k.endswith("running_var"):
                sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                    torch.tensor(160000)
        sd = {"meta": {"iter": 160000}, "state_dict": {
            **sd, "auxiliary_head.conv_seg.weight": torch.randn(
                150, 256, 1, 1, generator=gen)}}
    torch.save(sd, path)
    return str(path)


def _jax_ingest(name, jdef, sd, hw=HW):
    fn = getattr(jai, f"ingest_{name}")
    expect = jax.eval_shape(lambda: jdef.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, hw, hw, 3))))
    tree, missing, unexpected = fn(sd, expect=expect)
    assert missing == [] and unexpected == [], (missing[:3], unexpected[:3])
    return tree


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(70)
    return rng.uniform(-1, 1, (2, HW, HW, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def nets():
    return {name: _seeded(name, 71 + i) for i, name in enumerate(NAMES)}


# --- the pieces -------------------------------------------------------------

@pytest.mark.parametrize("pdc", ["cv", "cd", "ad", "rd"])
def test_pdc_kernel_transform_matches_jax(pdc):
    rng = np.random.default_rng(72)
    w = rng.standard_normal((6, 5, 3, 3)).astype(np.float32)   # OIHW
    got = pidinet.transform_pdc_kernel(torch.from_numpy(w), pdc).numpy()
    ref = np.asarray(jpidinet.transform_pdc_kernel(
        jnp.asarray(w.transpose(2, 3, 1, 0)), pdc)).transpose(3, 2, 0, 1)
    assert got.shape == ref.shape == ((6, 5, 5, 5) if pdc == "rd"
                                      else (6, 5, 3, 3))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    # and the conv of the transformed kernel (a 5x5 one pads 2)
    x = rng.standard_normal((2, 5, 12, 12)).astype(np.float32)
    conv = pidinet.PDCConv(5, 6, pdc).eval()
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        y = conv(torch.from_numpy(x)).numpy()
    pad = ref.shape[-1] // 2
    yref = jax.lax.conv_general_dilated(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(ref.transpose(2, 3, 1, 0)), (1, 1),
        [(pad, pad), (pad, pad)],
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(y, np.asarray(yref).transpose(0, 3, 1, 2),
                               rtol=0, atol=1e-5)


def test_depth_to_normal_matches_jax():
    rng = np.random.default_rng(73)
    depth = rng.uniform(0, 1, (2, 24, 20)).astype(np.float32)
    depth[0, :6] = 0.0                       # background below bg_th
    got = midas.depth_to_normal(torch.from_numpy(depth)).numpy()
    ref = np.asarray(jmidas.depth_to_normal(jnp.asarray(depth)))
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, atol=1e-5)
    # the background's normal is (0, 0, 1)
    np.testing.assert_allclose(got[0, :, :5], np.broadcast_to(
        np.array([0.0, 0.0, 1.0])[:, None, None], (3, 5, 20)), atol=1e-6)


@pytest.mark.parametrize("out", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax_at_16(out):
    """The PPM of a 512^2 input pools a 16^2 stage: 1 and 2 divide it (bin
    means), 3 and 6 take JAX's antialiased bilinear resize, which is not
    ``F.adaptive_avg_pool2d`` (the reference's)."""
    rng = np.random.default_rng(74)
    x = rng.standard_normal((2, 16, 16, 8)).astype(np.float32)
    got = uniformer.adaptive_avg_pool(torch.from_numpy(
        x.transpose(0, 3, 1, 2)), out).numpy()
    ref = np.asarray(juniformer._adaptive_avg_pool(jnp.asarray(x), out))
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, rtol=0,
                               atol=1e-6)
    torch_pool = F.adaptive_avg_pool2d(torch.from_numpy(
        x.transpose(0, 3, 1, 2)), out).numpy()
    assert (np.abs(torch_pool - got).max() > 1e-3) == (16 % out != 0)


@pytest.mark.parametrize("size", [(5, 7), (16, 16), (64, 40), (3, 90)])
def test_resize_bilinear_matches_jax(size):
    rng = np.random.default_rng(75)
    x = rng.standard_normal((1, 3, 24, 30)).astype(np.float32)
    got = uniformer.resize_bilinear(torch.from_numpy(x), size).numpy()
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3) + size,
                                      "bilinear"))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("grid", [4, 16, 24, 32])
def test_pos_embed_resize_from_577_tokens_matches_jax_ingest(grid):
    module = midas.DPTHybrid(**DPT_TINY, device="cpu")
    vit = module.pretrained.model
    assert vit.pos_embed.shape == (1, 577, 64)
    got = vit.resized_pos_embed(grid, grid).detach().numpy()
    ref = jai._resize_pos_embed(vit.pos_embed.detach().numpy(),
                                grid * grid + 1)
    assert got.shape == ref.shape == (1, grid * grid + 1, 64)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)


# --- checkpoint files and forwards ------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_reference_schema_file_loads_and_runs_as_jax(name, nets, image,
                                                     tmp_path):
    """A seeded file in the reference's schema loads into the port with 0
    missing and 0 unexpected keys and into flax through JAX's ingest; the
    two forwards agree at 64^2."""
    module, jdef = nets[name]
    path = reference_file(name, module, tmp_path / f"{name}.pth")
    fresh, _ = _port(name)
    missing, unexpected = getattr(ai, f"ingest_{name}")(
        ai.load_torch_state_dict(path), fresh)
    assert missing == [] and unexpected == []
    tree = _jax_ingest(name, jdef, j_load_sd(path))
    x = torch.from_numpy(image.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = fresh.eval()(x)
    ref = np.asarray(jax.jit(jdef.apply)(tree, jnp.asarray(image)))
    close(nhwc(got) if got.dim() == 4 else got.numpy(), ref)
    if name == "pidinet":
        # the shipped net thresholds its map at 0.5
        binar = pidinet.PiDiNet(device="cpu")
        binar.load_state_dict(fresh.state_dict())
        with torch.no_grad():
            b = nhwc(binar.eval()(x))
        assert set(np.unique(b)) <= {-1.0, 1.0}
        flips = b != np.where(ref > 0.0, 1.0, -1.0)
        assert np.all(np.abs(ref[flips]) / 2 < 1e-4)


@pytest.mark.parametrize("name", NAMES)
def test_convert_round_trips_jax_ingest_bit_exactly(name, nets):
    module, _ = nets[name]
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    tree, missing, unexpected = getattr(jai, f"ingest_{name}")(sd)
    assert missing == [] and unexpected == []
    back = getattr(convert, f"{name}_state_dict")(
        jax.tree.map(np.asarray, tree))
    assert set(back) == set(sd)
    for k, v in back.items():
        assert v.dtype == torch.float32 and np.array_equal(v.numpy(), sd[k]), k
    fresh, _ = _port(name)
    fresh.load_state_dict(back, strict=True)


@pytest.mark.parametrize("hw", [256, 384])
def test_midas_file_with_577_tokens_runs_at_256_and_384(hw, nets, tmp_path,
                                                        monkeypatch):
    """``load_midas`` (the DPT at the tests' width) on the released schema:
    0 missing and 0 unexpected keys, frozen, then a forward at 256^2 (a
    16^2 token grid) and 384^2 (the table's own 24^2)."""
    module, _ = nets["midas"]
    path = reference_file("midas", module, tmp_path / "dpt.pt")
    dpt = midas.DPTHybrid
    monkeypatch.setattr(midas, "DPTHybrid",
                        lambda **kw: dpt(**DPT_TINY, **kw))
    det = ai.load_midas(path, device="cpu")
    assert not det.model.training
    assert not any(p.requires_grad for p in det.model.parameters())
    x = torch.from_numpy(np.random.default_rng(76).uniform(
        -1, 1, (1, 3, hw, hw)).astype(np.float32))
    depth01, normal = det(x)
    assert depth01.shape == (1, hw, hw) and normal.shape == (1, 3, hw, hw)
    assert float(depth01.min()) >= 0 and float(depth01.max()) <= 1
    assert bool(torch.isfinite(normal).all())


def test_a_position_table_of_another_grid_loads_and_is_resized(nets):
    """JAX's ingest resizes the table to its model's grid; the port loads
    any grid and resizes in the forward, with JAX's numbers."""
    module, jdef = nets["midas"]
    sd = {k: v.numpy() for k, v in module.state_dict().items()}
    tree = _jax_ingest("midas", jdef, sd)
    assert tree["params"]["pos_embed"].shape == (1, 17, 64)
    small = midas.DPTHybrid(**DPT_TINY, device="cpu")
    assert small.pretrained.model.pos_embed.shape == (1, 577, 64)
    assert ai.ingest_midas(convert.midas_state_dict(jax.tree.map(
        np.asarray, tree)), small) == ([], [])
    assert small.pretrained.model.pos_embed.shape == (1, 17, 64)
    x = torch.from_numpy(np.random.default_rng(77).uniform(
        -1, 1, (1, 3, HW, HW)).astype(np.float32))
    with torch.no_grad():
        close(small.eval()(x).numpy(), module(x).numpy())


def test_loaders_refuse_missing_and_unexpected_keys(nets, tmp_path):
    module, _ = nets["pidinet"]
    sd = dict(module.state_dict())
    torch.save({k: v for k, v in sd.items() if k != "classifier.bias"},
               tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="1 missing .*classifier.bias"):
        ai.load_pidinet(str(tmp_path / "missing.pth"), device="cpu")
    torch.save({**sd, "extra.weight": torch.zeros(1)},
               tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="1 unexpected .*extra.weight"):
        ai.load_pidinet(str(tmp_path / "extra.pth"), device="cpu")
    torch.save({**sd, "init_block.weight": torch.zeros(60, 3, 5, 5)},
               tmp_path / "shape.pth")
    with pytest.raises(ValueError, match="shape mismatch at init_block"):
        ai.load_pidinet(str(tmp_path / "shape.pth"), device="cpu")
    net = ai.load_pidinet(reference_file("pidinet", module,
                                         tmp_path / "ok.pth"), device="cpu")
    assert not net.training and not any(p.requires_grad
                                        for p in net.parameters())


def test_uniformer_detector_matches_jax(nets, tmp_path):
    """``UniformerDetector`` on a 48x40 uint8 photo at input size 64: the
    antialiased resize in, the argmax, the nearest resize back, the ADE
    colours."""
    module, jdef = nets["uniformer"]
    path = reference_file("uniformer", module, tmp_path / "upernet.pth")
    det = ai.load_uniformer(path, input_size=HW, device="cpu")
    tree = _jax_ingest("uniformer", jdef, j_load_sd(path))
    jdet = juniformer.UniformerDetector(tree, jdef, input_size=HW)
    img = np.random.default_rng(78).integers(0, 256, (2, 48, 40, 3),
                                             dtype=np.uint8)
    got, ref = det.labels(img), jdet.labels(img)
    assert got.shape == ref.shape == (2, 48, 40) and got.dtype == np.int32
    assert (got != ref).mean() <= 1e-3
    assert len(np.unique(ref)) > 1
    rgb = det(img[0])
    assert rgb.shape == (48, 40, 3) and rgb.dtype == np.uint8
    np.testing.assert_array_equal(rgb, jdet(img[0]))


def test_port_modules_carry_the_jax_dtypes_in_bf16(nets, image):
    """In bf16 the convs, attention and MLPs compute in bf16 and the
    norms and the PPM in float32, as JAX's; the output stays near the
    float32 one."""
    module, _ = nets["uniformer"]
    bf = uniformer.UniFormerSeg(dtype=torch.bfloat16, device="cpu")
    bf.load_state_dict(module.state_dict())
    x = torch.from_numpy(image.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        lo, hi = bf.eval()(x), module(x)
    assert lo.dtype == torch.float32
    assert float((lo - hi).abs().max() / hi.abs().max()) < 5e-2


# --- seg2image --detect ------------------------------------------------------

def _recording(monkeypatch, cls, seen):
    call = cls.__call__

    def record(self, img):
        out = call(self, img)
        seen.append(np.asarray(out))
        return out

    monkeypatch.setattr(cls, "__call__", record)


def test_seg2image_detect_matches_jax_cli(files, nets, tmp_path,
                                          monkeypatch, capsys):
    """``--detect --seg_ckpt`` at ``--detect_resolution 64`` for a 96^2
    render (PIL's BILINEAR down to the detector, NEAREST back): the hint
    maps both CLIs detect agree (labels on all but 0.1 % of pixels), and
    both write the same files; without ``--seg_ckpt`` the all-zero
    detector's map is JAX's and the NOTE is printed."""
    module, jdef = nets["uniformer"]
    seg = reference_file("uniformer", module, tmp_path / "upernet.pth")
    data = _seg_map(tmp_path)
    (tmp_path / "maps" / "sample2").rename(tmp_path / "maps" / "sample1")
    seen = {"jax": [], "port": []}
    _recording(monkeypatch, juniformer.UniformerDetector, seen["jax"])
    _recording(monkeypatch, uniformer.UniformerDetector, seen["port"])
    args = ["--data_dir", data, "--config", files["cldm.yaml"], "--cn_ckpt",
            files["cn.pth"], "--image_resolution", "96",
            "--detect_resolution", "64", "--ddim_steps", "2", "--detect",
            "--precision", "full", "--prompt", "a tiny test"]
    jseg2image.main(args + ["--seg_ckpt", seg, "--outdir",
                            str(tmp_path / "jax")])
    seg2image.main(args + ["--seg_ckpt", seg, "--outdir",
                           str(tmp_path / "port"), "--device", "cpu"])
    (ref,), (got,) = seen["jax"], seen["port"]
    assert got.shape == ref.shape == (64, 64, 3) and got.dtype == np.uint8
    assert (got != ref).any(axis=-1).mean() <= 1e-3
    assert len(np.unique(ref.reshape(-1, 3), axis=0)) > 1
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "jax") == {
        "m0_render.png": (96, 96, 3)}
    capsys.readouterr()
    seg2image.main(args + ["--outdir", str(tmp_path / "zero"), "--device",
                           "cpu"])
    assert "NOTE: UniFormer weights are random-init" in capsys.readouterr().out
    zeros = jax.tree.map(lambda a: np.zeros_like(a), _jax_ingest(
        "uniformer", jdef, j_load_sd(seg)))
    photo = np.asarray(Image.open(tmp_path / "maps" / "sample1" / "m0.png")
                       .convert("RGB").resize((96, 96), Image.NEAREST)
                       .resize((64, 64), Image.BILINEAR))
    want = juniformer.UniformerDetector(zeros, jdef, input_size=64)(photo)
    np.testing.assert_array_equal(seen["port"][-1], want)
