"""The port's OpenPose annotator (``fgdm_tpu_torch/annotators/openpose.py``),
its checkpoint ingest and ``convert``'s OpenPose maps, held against the JAX
package on the CPU.

``BodyPoseNet`` and ``HandPoseNet`` at their full (fixed) widths on 64^2
inputs, float32, with the port's seeded init (``seed_``, then a scale per
conv so the 18-conv paths keep their range); their weights reach flax
through JAX's ``ingest_openpose``/``ingest_handpose`` from a file in the
released schema (bare conv names).  The host pipeline (peaks, limbs,
persons, the render) is held bit for bit on the same maps: synthetic
skeletons whose peaks and part-affinity fields make persons, and JAX's own
network maps; JAX draws with OpenCV, the port with its numpy raster.

Tolerances: the networks' outputs and the resized maps max|d| <= 1e-4 *
max|ref| + 1e-5 (float32 both sides, sums in other orders); the renders,
``find_peaks``, ``score_limbs`` and ``assemble_persons`` on identical maps
exactly; ``convert``'s round trips bit-exactly; the hand estimator's
``cv2.resize(INTER_CUBIC)`` within 1e-4 * 255 on float planes and one
uint8 step on images.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp  # noqa: E402

from fgdm_tpu.annotators import openpose as jop  # noqa: E402
from fgdm_tpu.checkpoint import annotator_ingest as jai  # noqa: E402
from fgdm_tpu.checkpoint.torch_ingest import (  # noqa: E402
    load_torch_state_dict as j_load_sd)
from fgdm_tpu_torch.annotators import openpose, seed_  # noqa: E402
from fgdm_tpu_torch.checkpoint import annotator_ingest as ai  # noqa: E402
from fgdm_tpu_torch.checkpoint import convert  # noqa: E402

torch.set_num_threads(2)

FWD_TOL = (1e-4, 1e-5)
HW = 64


def close(got, ref, tol=FWD_TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = np.abs(got - ref).max()
    lim = tol[0] * np.abs(ref).max() + tol[1]
    assert err <= lim, (err, lim)


def nhwc(t):
    return np.ascontiguousarray(t.detach().numpy().transpose(0, 2, 3, 1))


def seeded_net(cls, seed):
    """The port's seeded init with each conv scaled to a gain of ~1.4 (a
    plain lecun init shrinks the maps ~0.7x a ReLU layer)."""
    net = seed_(cls(device="cpu"), torch.Generator().manual_seed(seed))
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("weight"):
                p.mul_(1.4)
            else:
                p.normal_(0.0, 0.05, generator=gen)
    return net.eval()


def bare_file(net, path):
    """``net``'s weights as the released ``body_pose_model.pth`` /
    ``hand_pose_model.pth`` hold them: bare conv names."""
    sd = {k.split(".", 1)[1]: v.clone() for k, v in net.state_dict().items()}
    torch.save(sd, path)
    return str(path)


def jax_params(kind, path):
    jdef = jop.BodyPoseNet() if kind == "body" else jop.HandPoseNet()
    expect = jax.eval_shape(lambda: jdef.init(jax.random.PRNGKey(0),
                                              jnp.zeros((1, HW, HW, 3))))
    fn = jai.ingest_openpose if kind == "body" else jai.ingest_handpose
    tree, missing, unexpected = fn(j_load_sd(path), expect=expect)
    assert missing == [] and unexpected == []
    return jdef, jax.tree.map(jnp.asarray, tree)


@pytest.fixture(scope="module")
def body(tmp_path_factory):
    net = seeded_net(openpose.BodyPoseNet, 90)
    path = bare_file(net, tmp_path_factory.mktemp("op") / "body.pth")
    jdef, tree = jax_params("body", path)
    return dict(net=net, path=path, jdef=jdef, tree=tree,
                apply=jax.jit(jdef.apply))


@pytest.fixture(scope="module")
def hand(tmp_path_factory):
    net = seeded_net(openpose.HandPoseNet, 91)
    path = bare_file(net, tmp_path_factory.mktemp("op") / "hand.pth")
    jdef, tree = jax_params("hand", path)
    return dict(net=net, path=path, jdef=jdef, tree=tree)


@pytest.fixture(scope="module")
def photo():
    return np.random.default_rng(92).integers(0, 256, (HW, HW, 3),
                                              dtype=np.uint8)


# --- the networks ---------------------------------------------------------

def test_body_net_matches_jax(body, photo):
    x = photo.astype(np.float32)[None] / 256.0 - 0.5
    with torch.no_grad():
        paf, heat = body["net"](torch.from_numpy(x.transpose(0, 3, 1, 2)))
    jpaf, jheat = body["apply"](body["tree"], jnp.asarray(x))
    assert paf.shape == (1, 38, HW // 8, HW // 8)
    assert heat.shape == (1, 19, HW // 8, HW // 8)
    assert np.asarray(jheat).std() > 1e-3 and heat.min() >= 0
    close(nhwc(paf), jpaf)
    close(nhwc(heat), jheat)


def test_hand_net_matches_jax(hand, photo):
    x = photo.astype(np.float32)[None] / 256.0 - 0.5
    with torch.no_grad():
        got = hand["net"](torch.from_numpy(x.transpose(0, 3, 1, 2)))
    ref = np.asarray(hand["jdef"].apply(hand["tree"], jnp.asarray(x)))
    assert got.shape == (1, 22, HW // 8, HW // 8) and ref.std() > 1e-3
    close(nhwc(got), ref)


def test_detector_maps_match_jax(body, photo):
    """``OpenposeDetector.maps``: the network and the bicubic resize to the
    image (JAX's ``"bicubic"``: antialiased, a = -0.5)."""
    det = openpose.OpenposeDetector(body["net"])
    paf, heat = det.maps(photo)
    jx = photo.astype(np.float32)[None] / 256.0 - 0.5
    jpaf, jheat = body["apply"](body["tree"], jnp.asarray(jx))
    close(paf, jax.image.resize(jpaf, (1, HW, HW, 38), "bicubic")[0])
    close(heat, jax.image.resize(jheat, (1, HW, HW, 19), "bicubic")[0])


# --- the host pipeline ----------------------------------------------------

def synthetic_maps(hw=128, seed=93):
    """Heat maps with a peak at every keypoint of two skeletons and unit
    part-affinity fields along their limbs: the maps a trained net gives
    two people."""
    rng = np.random.default_rng(seed)
    heat = np.zeros((hw, hw, 19), np.float32)
    paf = np.zeros((hw, hw, 38), np.float32)
    yy, xx = np.mgrid[:hw, :hw]
    for cx in (0.3 * hw, 0.7 * hw):
        pts = np.stack([cx + rng.uniform(-12, 12, 18),
                        rng.uniform(0.15, 0.85, 18) * hw], 1)
        for c, (x, y) in enumerate(pts):
            heat[..., c] += np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / 8.0)
        for (a, b), (m1, m2) in zip(jop.LIMB_SEQ, jop.MAP_IDX):
            pa, pb = pts[a - 1], pts[b - 1]
            v = (pb - pa) / (np.linalg.norm(pb - pa) + 1e-8)
            for s in np.linspace(0.0, 1.0, 64):
                px, py = np.round(pa + s * (pb - pa)).astype(int)
                paf[max(py - 1, 0):py + 2, max(px - 1, 0):px + 2,
                    m1 - 19] = v[0]
                paf[max(py - 1, 0):py + 2, max(px - 1, 0):px + 2,
                    m2 - 19] = v[1]
    return paf, heat


def _pipeline(mod, paf, heat):
    peaks = mod.find_peaks(heat)
    conns = mod.score_limbs(paf, peaks)
    persons = mod.assemble_persons(peaks, conns)
    canvas = mod.draw_bodypose(np.zeros(heat.shape[:2] + (3,), np.uint8),
                               persons)
    return peaks, conns, persons, canvas


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for p, q in zip(x, y):
            assert tuple(p) == tuple(q), (p, q)


def test_host_pipeline_on_synthetic_people_matches_jax():
    paf, heat = synthetic_maps()
    got, ref = _pipeline(openpose, paf, heat), _pipeline(jop, paf, heat)
    _same(got[0], ref[0])
    _same(got[1], ref[1])
    assert got[2] == ref[2] and len(ref[2]) == 2
    assert (ref[3] > 0).mean() > 0.01
    np.testing.assert_array_equal(got[3], ref[3])


def test_host_pipeline_on_jax_network_maps_matches_jax(body, photo):
    """JAX's own resized maps (the seeded net's, scaled so that peaks pass
    the thresholds) through both packages' grouping and render."""
    jx = photo.astype(np.float32)[None] / 256.0 - 0.5
    jpaf, jheat = body["apply"](body["tree"], jnp.asarray(jx))
    paf = np.asarray(jax.image.resize(jpaf, (1, HW, HW, 38), "bicubic"))[0]
    heat = np.asarray(jax.image.resize(jheat, (1, HW, HW, 19),
                                       "bicubic"))[0]
    heat = heat / heat.max()
    paf = paf / np.abs(paf).max()
    got, ref = _pipeline(openpose, paf, heat), _pipeline(jop, paf, heat)
    assert sum(len(p) for p in ref[0]) > 0
    _same(got[0], ref[0])
    _same(got[1], ref[1])
    assert got[2] == ref[2]
    np.testing.assert_array_equal(got[3], ref[3])


def test_draw_handpose_matches_jax():
    rng = np.random.default_rng(94)
    hands = [rng.integers(-4, 100, (21, 2)) for _ in range(3)]
    hands[1][[3, 7, 12]] = 0            # undetected parts: no edges to them
    got = openpose.draw_handpose(np.zeros((96, 96, 3), np.uint8), hands)
    ref = jop.draw_handpose(np.zeros((96, 96, 3), np.uint8), hands)
    assert (ref > 0).mean() > 0.05
    np.testing.assert_array_equal(got, ref)


def test_hand_detect_matches_jax():
    paf, heat = synthetic_maps()
    peaks = jop.find_peaks(heat)
    persons = jop.assemble_persons(peaks, jop.score_limbs(paf, peaks))
    for h, w in ((128, 128), (100, 90), (40, 200)):
        assert openpose.hand_detect(persons, h, w) == jop.hand_detect(
            persons, h, w)


@pytest.mark.parametrize("fx", [0.5, 1.37, 2.0, 8.0])
def test_cubic_resize_matches_cv2(fx):
    """``HandEstimator``'s resizes: ``cv2.resize(INTER_CUBIC)`` by a factor
    (uint8 images within one step, float planes within 1e-4 * 255) and to
    a size."""
    rng = np.random.default_rng(95)
    img = rng.integers(0, 256, (37, 29, 3), dtype=np.uint8)
    ref = cv2.resize(img, (0, 0), fx=fx, fy=fx, interpolation=cv2.INTER_CUBIC)
    size = (int(np.rint(37 * fx)), int(np.rint(29 * fx)))
    src = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
    got = openpose._resize_cubic(src, size, fx).round().clamp(0, 255)
    got = got[0].permute(1, 2, 0).numpy().astype(np.uint8)
    assert got.shape == ref.shape
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1
    plane = rng.uniform(-3, 3, (11, 9, 22)).astype(np.float32)
    ref = cv2.resize(plane, (0, 0), fx=fx, fy=fx,
                     interpolation=cv2.INTER_CUBIC)
    t = torch.from_numpy(plane).permute(2, 0, 1)[None]
    got = openpose._resize_cubic(t, ref.shape[:2], fx)[0].permute(1, 2, 0)
    close(got.numpy(), ref, (1e-4, 1e-4))
    ref = cv2.resize(plane, (13, 17), interpolation=cv2.INTER_CUBIC)
    got = openpose._resize_cubic(t, (17, 13))[0].permute(1, 2, 0)
    close(got.numpy(), ref, (1e-4, 1e-4))


def test_hand_estimator_matches_jax(hand):
    """The 4-scale hand estimator on a 40^2 crop: the same peaks as JAX's
    (cv2 resizes, the flax net) where JAX's averaged heat has a clear
    maximum."""
    jest = jop.HandEstimator(hand["tree"], hand["jdef"])
    est = openpose.HandEstimator(hand["net"])
    crop = np.random.default_rng(96).integers(0, 256, (40, 40, 3),
                                              dtype=np.uint8)
    got, ref = est(crop), jest(crop)
    assert got.shape == ref.shape == (21, 2)
    assert (ref != 0).any()
    np.testing.assert_array_equal(got, ref)


# --- checkpoints -----------------------------------------------------------

@pytest.mark.parametrize("kind", ["body", "hand"])
def test_released_schema_file_loads_with_no_missing_or_unexpected(
        kind, body, hand, tmp_path):
    net = (body if kind == "body" else hand)["net"]
    path = (body if kind == "body" else hand)["path"]
    cls = openpose.BodyPoseNet if kind == "body" else openpose.HandPoseNet
    fresh = cls(device="cpu")
    ingest = ai.ingest_openpose if kind == "body" else ai.ingest_handpose
    assert ingest(ai.load_torch_state_dict(path), fresh) == ([], [])
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, net.state_dict()[k]), k
    # a state_dict() export of the reference module (model* prefixes) too
    prefixed = {k: v for k, v in net.state_dict().items()}
    torch.save(prefixed, tmp_path / "prefixed.pth")
    assert ingest(ai.load_torch_state_dict(str(tmp_path / "prefixed.pth")),
                  cls(device="cpu")) == ([], [])


@pytest.mark.parametrize("kind", ["body", "hand"])
def test_convert_round_trips_jax_ingest_bit_exactly(kind, body, hand):
    net = (body if kind == "body" else hand)["net"]
    bare = {k.split(".", 1)[1]: v.numpy()
            for k, v in net.state_dict().items()}
    fn = jai.ingest_openpose if kind == "body" else jai.ingest_handpose
    tree, missing, unexpected = fn(bare)
    assert missing == [] and unexpected == []
    to_sd = (convert.openpose_state_dict if kind == "body"
             else convert.handpose_state_dict)
    back = to_sd(jax.tree.map(np.asarray, tree))
    want = net.state_dict()
    assert set(back) == set(want)
    for k, v in back.items():
        assert v.dtype == torch.float32 and torch.equal(v, want[k]), k


@pytest.mark.filterwarnings("ignore:.*to a meta parameter:UserWarning")
def test_load_openpose_refuses_missing_and_unexpected_keys(body, hand,
                                                            tmp_path):
    """The refusals read key sets alone, so the nets they build sit on the
    ``meta`` device (52M + 37M parameters a build on the CPU otherwise);
    the load that succeeds builds them on the CPU."""
    sd = ai.load_torch_state_dict(body["path"])
    torch.save({k: v for k, v in sd.items() if k != "conv1_1.bias"},
               tmp_path / "missing.pth")
    with pytest.raises(ValueError, match="OpenPose ingest from .*1 missing "
                                         ".*model0.conv1_1.bias"):
        ai.load_openpose(str(tmp_path / "missing.pth"), device="meta")
    torch.save({**sd, "conv9_9.kernel": torch.zeros(1)},
               tmp_path / "extra.pth")
    with pytest.raises(ValueError, match="1 unexpected .*conv9_9.kernel"):
        ai.load_openpose(str(tmp_path / "extra.pth"), device="meta")
    hsd = ai.load_torch_state_dict(hand["path"])
    torch.save({k: v for k, v in hsd.items() if k != "Mconv7_stage6.bias"},
               tmp_path / "hand_missing.pth")
    with pytest.raises(ValueError, match="OpenPose hand ingest from"):
        ai.load_openpose(body["path"], str(tmp_path / "hand_missing.pth"),
                         device="meta")
    det = ai.load_openpose(body["path"], hand["path"], device="cpu")
    assert det.hand_estimation is not None
    assert not any(p.requires_grad for p in det.model.parameters())


def test_detector_with_hands_runs_and_refuses_without_hand_weights(body,
                                                                   hand):
    img = np.random.default_rng(97).integers(0, 256, (HW, HW, 3),
                                             dtype=np.uint8)
    det = openpose.OpenposeDetector(body["net"], hand["net"])
    out = det(img, hand=True)
    assert out.shape == (HW, HW, 3) and out.dtype == np.uint8
    with pytest.raises(ValueError, match="hand=True needs hand weights"):
        openpose.OpenposeDetector(body["net"])(img, hand=True)


def _stem_planes(hw):
    """``(name, C, Co, H)`` of the body net's 3x3 convs at an ``hw^2``
    input."""
    net, out = openpose.BodyPoseNet(device="meta"), []
    for name in net.model0.names:
        co, c, k, _ = getattr(net.model0, name).weight.shape
        out.append((name, c, co, hw))
        if name in ("conv1_2", "conv2_2", "conv3_4"):
            hw //= 2
    out += [(f"conv5_{j}_CPM_L{L}", 128, 128, hw) for L in (1, 2)
            for j in (1, 2, 3)]
    return out


def test_jax_conv_gate_admits_f32_openpose_convs_the_port_leaves_to_cudnn(
        monkeypatch):
    """With ``FGDM_PALLAS_CONV=1`` on a TPU, JAX's K7 gate (no dtype test)
    takes 14 of the body net's float32 3x3 convs at the eval CLI's 256^2
    (interpret mode stands in for the TPU here); the port's gate takes the
    same 14 to K7's float32 kernel, where they stayed on cuDNN while K7 was
    bf16 only."""
    from fgdm_tpu.kernels import conv as jconv
    from fgdm_tpu_torch.kernels import conv as kconv

    monkeypatch.setattr(jconv, "_INTERPRET", True)
    jax_takes, port_takes = [], []
    for name, c, co, h in _stem_planes(256):
        if jconv.conv3x3_ok((1, h, h, c), (3, 3, c, co), jnp.float32):
            jax_takes.append(name)
        if kconv.conv3x3_ok((1, c, h, h), (co, c, 3, 3), torch.float32):
            port_takes.append(name)
    assert jax_takes == ["conv3_1", "conv3_2", "conv3_3", "conv3_4",
                         "conv4_1", "conv4_2", "conv4_3_CPM", "conv4_4_CPM",
                         "conv5_1_CPM_L1", "conv5_2_CPM_L1", "conv5_3_CPM_L1",
                         "conv5_1_CPM_L2", "conv5_2_CPM_L2", "conv5_3_CPM_L2"]
    assert port_takes == jax_takes


def test_port_and_chip_smoke_import_no_opencv():
    import ast
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    sources = sorted((repo / "fgdm_tpu_torch").rglob("*.py")) + [
        repo / "chip_smoke.py"]
    bad = []
    for path in sources:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            bad += [f"{path.name}: {n}" for n in names
                    if n.split(".")[0] in ("cv2", "jax", "fgdm_tpu")]
    assert len(sources) > 20 and not bad, bad


@pytest.mark.parametrize("module", [
    "annotators/mlsd.py", "annotators/canny.py", "models/vq.py",
    "models/encoders.py", "diffusion/perceptual_losses.py",
    "data/imgproc.py"])
def test_library_module_imports_no_opencv_or_jax(module):
    """Each module of the library slice imports neither OpenCV, nor JAX,
    nor the JAX package, directly or through the port's own modules."""
    import ast
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    banned = ("cv2", "jax", "jaxlib", "flax", "optax", "fgdm_tpu")
    seen, todo, bad = set(), [f"fgdm_tpu_torch/{module}"], []
    while todo:
        rel = todo.pop()
        if rel in seen:
            continue
        seen.add(rel)
        for node in ast.walk(ast.parse((repo / rel).read_text(), rel)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                top = n.split(".")[0]
                bad += [f"{rel}: {n}"] if top in banned else []
                if top == "fgdm_tpu_torch":
                    path = n.replace(".", "/")
                    todo += [p for p in (f"{path}.py", f"{path}/__init__.py")
                             if (repo / p).exists()]
    assert f"fgdm_tpu_torch/{module}" in seen and not bad, bad
