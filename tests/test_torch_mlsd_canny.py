"""The port's MLSD and Canny annotators (``fgdm_tpu_torch/annotators/mlsd.py``,
``canny.py``), its OpenCV rebuilds (``data/imgproc.py``), the MLSD ingest
and ``convert.mlsd_state_dict``, held against the JAX package and OpenCV
on the CPU.

``MobileV2MLSDLarge`` at a 64^2 input, float32, on a parameter tree from
``jax.eval_shape`` filled with numpy-seeded values (positive BatchNorm
variances; ``test_torch_vq.seeded``).  ``decode_lines`` and the detector's
host stages (the INTER_AREA resize, the input planes, the decode, the
1-pixel lines) run on injected tpMaps whose peaks make lines.  JAX's
``CannyDetector`` is ``cv2.Canny``; JAX's detector draws with ``cv2``.

Tolerances: the net's map max|d| <= 1e-4 * max|ref| + 1e-5 (float32, 20
layers, sums in another order); ``decode_lines``, the detector's maps,
Canny, INTER_AREA and the lines exactly; ``sobel_edges``'s binary map
exactly on the seeded scene (a magnitude within float32 rounding of the
threshold would be a flip; none is).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.annotators import canny as jcanny  # noqa: E402
from fgdm_tpu.annotators import mlsd as jmlsd  # noqa: E402
from fgdm_tpu.checkpoint import annotator_ingest as jai  # noqa: E402
from fgdm_tpu_torch.annotators import canny, mlsd  # noqa: E402
from fgdm_tpu_torch.checkpoint import annotator_ingest as ai  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402
from fgdm_tpu_torch.data import imgproc  # noqa: E402
from test_torch_vq import load, nchw, nhwc, seeded  # noqa: E402

torch.set_num_threads(2)

HW = 64


def _scene(rng, h, w, cn):
    """A uint8 image with edges: filled rectangles, discs and lines, plus
    noise."""
    img = np.zeros((h, w, 3), np.uint8)
    for _ in range(10):
        c = tuple(int(v) for v in rng.integers(0, 256, 3))
        p = tuple(int(v) for v in rng.integers(0, max(h, w), 2))
        q = tuple(int(v) for v in rng.integers(0, max(h, w), 2))
        kind = rng.integers(3)
        if kind == 0:
            cv2.rectangle(img, p, q, c, -1)
        elif kind == 1:
            cv2.circle(img, p, int(rng.integers(3, 30)), c, -1)
        else:
            cv2.line(img, p, q, c, int(rng.integers(1, 5)))
    img = np.clip(img.astype(int) + rng.integers(-20, 21, img.shape), 0,
                  255).astype(np.uint8)
    return img if cn == 3 else img[..., 0]


@pytest.fixture(scope="module")
def net():
    jdef = jmlsd.MobileV2MLSDLarge()
    p = seeded(jdef, (jnp.zeros((1, HW, HW, 4)),), 40)
    tm = load(mlsd.MobileV2MLSDLarge(device="cpu"),
              convert.mlsd_state_dict(p))
    return jdef, p, tm


def test_mlsd_net_matches_jax(net):
    jdef, p, tm = net
    x = np.random.default_rng(41).uniform(-1, 1, (2, HW, HW, 4)).astype(
        np.float32)
    ref = np.asarray(jax.jit(jdef.apply)(p, jnp.asarray(x)))
    with torch.no_grad():
        got = nhwc(tm(nchw(x)))
    assert got.shape == ref.shape == (2, HW // 2, HW // 2, 9)
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max() + 1e-5


def _reference_file(p, path):
    """The released file's form: the reference's names, BatchNorms with
    ``num_batches_tracked``."""
    sd = convert.mlsd_state_dict(p)
    for k in list(sd):
        if k.endswith("running_var"):
            sd[k[:-len("running_var")] + "num_batches_tracked"] = \
                torch.tensor(0)
    torch.save(sd, path)
    return str(path)


def test_mlsd_file_loads_strictly_in_both_packages(net, tmp_path):
    jdef, p, _ = net
    path = _reference_file(p, tmp_path / "mlsd_large_512_fp32.pth")
    det = ai.load_mlsd(path, input_size=HW, device="cpu")
    assert isinstance(det, mlsd.MLSDdetector) and det.input_size == HW
    sd = torch.load(path)
    missing, unexpected = ai.ingest_mlsd(sd, mlsd.MobileV2MLSDLarge(
        device="cpu"))
    assert missing == [] and unexpected == []
    # JAX's mapper reads the same file into the same tree
    expect = jax.eval_shape(lambda: jdef.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, HW, HW, 4))))
    tree, jm, ju = jai.ingest_mlsd({k: v.numpy() for k, v in sd.items()},
                                   expect=expect)
    assert jm == [] and ju == []
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(p)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # a wrong shape raises; a missing key refuses the load
    bad = dict(sd)
    bad["block23.conv3.weight"] = torch.zeros(16, 64, 3, 3)
    with pytest.raises(ValueError, match="shape mismatch"):
        ai.ingest_mlsd(bad, mlsd.MobileV2MLSDLarge(device="cpu"))
    short = {k: v for k, v in sd.items() if not k.startswith("block22.")}
    torch.save(short, tmp_path / "short.pth")
    with pytest.raises(ValueError, match="missing"):
        ai.load_mlsd(str(tmp_path / "short.pth"), device="cpu")


def _tp_map(seed, hw=32):
    """A tpMap with a few strong centres and long displacements, the rest
    below the score threshold."""
    rng = np.random.default_rng(seed)
    tp = rng.normal(-4.0, 1.0, (hw, hw, 9)).astype(np.float32)
    for _ in range(12):
        y, x = (int(v) for v in rng.integers(0, hw, 2))
        tp[y, x, 0] = rng.uniform(-1.0, 3.0)
        tp[y, x, 1:5] = rng.uniform(-25, 25, 4)
    tp[3, 5, 0] = tp[3, 6, 0] = 2.0          # a tie, kept by both maxima
    tp[3, 5, 1:5] = (-20, -20, 20, 20)
    return tp


@pytest.mark.parametrize("seed", [42, 43])
def test_decode_lines_is_bit_exact(seed):
    tp = _tp_map(seed)
    for thr in ((0.1, 20.0), (0.5, 10.0)):
        ref = jmlsd.decode_lines(tp, *thr)
        got = mlsd.decode_lines(tp, *thr)
        assert got.dtype == ref.dtype == np.float32 and len(ref) > 0
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shape", [(90, 70), (64, 64), (33, 131)])
def test_detector_host_stages_match_jax(net, shape):
    """Both detectors on one image, each net replaced by the same injected
    tpMap: the resize and input planes, the decode and the drawn lines
    pixel for pixel."""
    _, p, tm = net
    img = _scene(np.random.default_rng(44), *shape, 3)
    tp = _tp_map(45, HW // 2)
    seen = {}
    jdet = jmlsd.MLSDdetector(p, input_size=HW)
    jdet._jit = lambda params, x: (seen.setdefault("jax", np.asarray(x)),
                                   tp[None])[1]
    tdet = mlsd.MLSDdetector(tm, input_size=HW)
    tdet.tp_map = lambda x: (seen.setdefault("port", x), tp)[1]
    ref, got = jdet(img), tdet(img)
    np.testing.assert_array_equal(seen["port"][None], seen["jax"])
    np.testing.assert_array_equal(seen["port"][..., 3],
                                  np.float32(1.0) / 127.5 - 1.0)
    assert got.dtype == np.uint8 and got.shape == shape
    assert (ref > 0).sum() > 50
    np.testing.assert_array_equal(got, ref)


def test_detector_runs_its_net(net):
    _, _, tm = net
    img = _scene(np.random.default_rng(46), 80, 96, 3)
    det = mlsd.MLSDdetector(tm, input_size=HW)
    out = det(img)
    assert out.shape == (80, 96) and out.dtype == np.uint8
    with torch.no_grad():
        ref = nhwc(tm(nchw(det.net_input(img)[None])))[0]
    np.testing.assert_array_equal(det.tp_map(det.net_input(img)), ref)


@pytest.mark.parametrize("cn", [1, 3])
@pytest.mark.parametrize("shape", [(64, 64), (97, 131), (257, 255)])
@pytest.mark.parametrize("thr", [(100, 200), (50, 51)])
def test_canny_matches_opencv(cn, shape, thr):
    img = _scene(np.random.default_rng(cn + sum(shape) + sum(thr)),
                 *shape, cn)
    ref = jcanny.CannyDetector()(img, *thr)
    got = canny.CannyDetector()(img, *thr)
    assert got.dtype == np.uint8 and (ref > 0).sum() > 50
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("src,dst", [((1024, 1024), (512, 512)),
                                     ((700, 700), (512, 512)),
                                     ((300, 300), (512, 512)),
                                     ((300, 700), (512, 512)),
                                     ((96, 64), (40, 32))])
def test_inter_area_matches_opencv(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for img in (rng.integers(0, 256, src + (3,), dtype=np.uint8),
                _scene(rng, *src, 1)):
        ref = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_AREA)
        got = imgproc.resize_area(img, dst[::-1])
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, ref)


def test_one_pixel_line_matches_opencv():
    rng = np.random.default_rng(47)
    for _ in range(400):
        ref = np.zeros((37, 53), np.uint8)
        got = ref.copy()
        p0, p1 = ([int(v) for v in rng.integers(-40, 90, 2)]
                  for _ in range(2))
        cv2.line(ref, p0, p1, 255, 1)
        imgproc.line(got, p0, p1, 255)
        np.testing.assert_array_equal(got, ref, err_msg=f"{p0} {p1}")


def test_sobel_edges_match_jax():
    img = (_scene(np.random.default_rng(48), 48, 40, 3).astype(np.float32)
           / 127.5 - 1.0)[None].repeat(2, 0)
    img[1] = img[1, ::-1]
    ref = np.asarray(jcanny.sobel_edges(jnp.asarray(img)))
    got = canny.sobel_edges(nchw(img))
    assert got.shape == (2, 1, 48, 40) and got.dtype == torch.float32
    assert 0 < ref.mean() < 0.5
    np.testing.assert_array_equal(nhwc(got), ref)
