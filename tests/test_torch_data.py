"""The port's data pipeline held against the JAX package's, on the CPU.

Colour codecs, the ctypes transforms (the port's library built from
``native/transforms.cpp``, and both packages' numpy fallbacks), every
``load_data`` mode (``coco`` with and without the ADE palette, ``ade20k``,
``cityscapes``, ``celeba``, ``sample``, ``pose``) on seeded trees written
here, the pose maps' raster (numpy in the port, OpenCV in JAX),
``batch_iterator``, ``ParallelBatchLoader`` at 1 and 4 workers and over 2
processes, and ``device_prefetch``'s NCHW tensors on the CPU.  The same
calls on the same files: every array is compared bit for bit.
"""

import json

import numpy as np
import pytest
from PIL import Image

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

from fgdm_tpu.data import colorize as jcol  # noqa: E402
from fgdm_tpu.data import dataset as jds  # noqa: E402
from fgdm_tpu.data import native as jnat  # noqa: E402
from fgdm_tpu.data import pose as jpose  # noqa: E402
from fgdm_tpu.data import prefetch as jpre  # noqa: E402
from fgdm_tpu.models.clip import CLIPTokenizer as JTokenizer  # noqa: E402
from fgdm_tpu_torch.data import colorize as tcol  # noqa: E402
from fgdm_tpu_torch.data import dataset as tds  # noqa: E402
from fgdm_tpu_torch.data import native as tnat  # noqa: E402
from fgdm_tpu_torch.data import pose as tpose  # noqa: E402
from fgdm_tpu_torch.data import prefetch as tpre  # noqa: E402
from fgdm_tpu_torch.data.label_tables import (ADE_PALETTE,  # noqa: E402
                                              COCO_TO_ADE)
from fgdm_tpu_torch.models.clip import CLIPTokenizer  # noqa: E402


def same(port, ref):
    """Equal dicts of samples or batches: arrays bit for bit, the rest ==."""
    assert set(port) == set(ref), (sorted(port), sorted(ref))
    for k in ref:
        a, b = port[k], ref[k]
        if isinstance(b, (np.ndarray, jax.Array)) or hasattr(b, "shape"):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (k, a.shape, b.shape)
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            assert a == b, k


# --- codecs and native transforms --------------------------------------------

def test_label_tables_are_jax_copies():
    from fgdm_tpu.data import label_tables as jt

    assert ADE_PALETTE == jt.ADE_PALETTE and COCO_TO_ADE == jt.COCO_TO_ADE


@pytest.mark.parametrize("n", [1, 8, 151, 256])
def test_color_map_matches_jax(n):
    np.testing.assert_array_equal(tcol.color_map(n), jcol.color_map(n))
    np.testing.assert_array_equal(tcol.ade_cmap(), jcol.ade_cmap())


def _labels(seed, hi=150, shape=(2, 24, 20)):
    rng = np.random.default_rng(seed)
    lab = rng.integers(0, hi, shape)
    lab[..., 0, :5] = 255
    return lab


@pytest.mark.parametrize("cmap", ["none", "bits", "ade", "short"])
def test_colorize_decolorize_match_jax(cmap):
    lab = _labels(1)
    pal = {"none": None, "bits": jcol.color_map(256), "ade": jcol.ade_cmap(),
           "short": jcol.color_map(40)}[cmap]
    rgb = tcol.colorize(lab, pal)
    np.testing.assert_array_equal(rgb, jcol.colorize(lab, pal))
    rgb[0, 3, 3] = (1, 2, 3)   # a colour in no palette -> void
    np.testing.assert_array_equal(tcol.decolorize(rgb, pal),
                                  jcol.decolorize(rgb, pal))
    dec = jcol.color_map(256) if pal is None else pal
    np.testing.assert_array_equal(
        tcol.nearest_palette_decolorize(rgb[:, :6, :6], dec),
        jcol.nearest_palette_decolorize(rgb[:, :6, :6], dec))


def test_coco_to_ade_labels_match_jax():
    lab = _labels(2, hi=256)
    np.testing.assert_array_equal(tcol.coco_to_ade_labels(lab),
                                  jcol.coco_to_ade_labels(lab))


def test_native_library_is_built_from_the_source():
    path = tnat.library_path()
    assert tnat.HAS_NATIVE and path is not None
    assert path.parent.name == "native" and path.exists()
    assert path.parents[1].name == "fgdm_tpu_torch"


def _native_cases():
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 150, (37, 29)).astype(np.uint8)
    lab[0, :8] = 255
    img = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    gray = rng.integers(0, 256, (17, 23)).astype(np.uint8)
    cmap = jcol.color_map(150)
    return {
        "colorize": lambda m: m.colorize(lab, cmap),
        "decolorize": lambda m: m.decolorize(jcol.colorize(lab, cmap), cmap),
        "bilinear": lambda m: m.resize_u8(img, (64, 48), "bilinear"),
        "nearest": lambda m: m.resize_u8(img, (16, 40), "nearest"),
        "gray": lambda m: m.resize_u8(gray, (9, 31), "nearest"),
        "normalize": lambda m: m.normalize_f32(img),
        "label_to_tensor": lambda m: m.label_to_tensor(lab, cmap, (40, 24)),
    }


@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("case", sorted(_native_cases()))
def test_native_wrappers_match_jax(case, path, monkeypatch):
    """Both libraries come from ``native/transforms.cpp``; without one each
    package takes its numpy / Pillow version."""
    if path == "numpy":
        monkeypatch.setattr(tnat, "_load", lambda: None)
        monkeypatch.setattr(jnat, "_load", lambda: None)
    elif not jnat.HAS_NATIVE:
        pytest.skip("the JAX package's committed library does not load here")
    fn = _native_cases()[case]
    got, ref = fn(tnat), fn(jnat)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


# --- datasets -----------------------------------------------------------------

def _img(rng, h, w):
    return Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))


def _lab(rng, h, w, hi):
    lab = rng.integers(0, hi, (h, w), dtype=np.uint8)
    lab[: h // 5, : w // 4] = 255
    return Image.fromarray(lab)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """One seeded tree a mode, in the reference's directory layout."""
    root = tmp_path_factory.mktemp("data")
    rng = np.random.default_rng(4)
    out = {}

    def put(path, im):
        path.parent.mkdir(parents=True, exist_ok=True)
        im.save(path)

    coco = root / "coco"
    for split, n in (("train2017", 5), ("val2017", 3)):
        anns = []
        for i in range(n):
            put(coco / "images" / split / f"{i:012d}.jpg", _img(rng, 70, 90))
            put(coco / "annotations" / split / f"{i:012d}.png",
                _lab(rng, 70, 90, 182))
            anns += [{"image_id": i, "caption": f"a {split} thing {i}"},
                     {"image_id": i, "caption": f"another view {i}"}]
        (coco / "annotations" / f"captions_{split}.json").write_text(
            json.dumps({"annotations": anns}))
    out["coco"] = coco
    for mode in ("ade20k", "celeba"):
        d = root / mode
        for split in ("training", "validation"):
            for i in range(3):
                put(d / "images" / split / f"img_{i}.jpg", _img(rng, 60, 52))
                put(d / "annotations" / split / f"img_{i}.png",
                    _lab(rng, 60, 52, 151))
        out[mode] = d
    city = root / "cityscapes"
    for sub in ("train", "val"):
        for i in range(3):
            put(city / "leftImg8bit" / sub / "x" / f"c{i}_leftImg8bit.png",
                _img(rng, 40, 80))
            put(city / "gtFine" / sub / "x" / f"c{i}_gtFine_labelIds.png",
                _lab(rng, 40, 80, 34))
            put(city / "gtFine" / sub / "x" / f"c{i}_gtFine_color.png",
                _img(rng, 40, 80))
    out["cityscapes"] = city
    sample = root / "sample"
    for i in range(3):
        put(sample / "sample1" / f"s{i}.png", _img(rng, 48, 48))
        put(sample / "sample2" / f"s{i}.png",
            Image.fromarray(jcol.colorize(np.asarray(_lab(rng, 48, 48, 20)),
                                          jcol.color_map(256))))
    out["sample"] = sample
    out["pose"] = _pose_tree(root / "pose", rng)
    return out


def _person(cx, cy, conf=2.0):
    body = [(0, -30), (-3, -33), (3, -33), (-6, -31), (6, -31), (-10, -20),
            (10, -20), (-14, -8), (14, -8), (-15, 2), (15, 2), (-6, 5),
            (6, 5), (-7, 18), (7, 18), (-7, 30), (7, 30)]
    kp = []
    for dx, dy in body:
        kp += [float(cx + dx), float(cy + dy), conf]
    return {"keypoints": kp, "num_keypoints": 17, "iscrowd": 0,
            "foot_kpts": [float(cx), float(cy + 32), 1.0] * 6,
            "face_kpts": [float(cx + 1), float(cy - 32), 0.2] * 68}


def _pose_tree(root, rng):
    img_dir = root / "images" / "train2017"
    img_dir.mkdir(parents=True)
    (root / "annotations" / "train2017").mkdir(parents=True)
    for i in range(3):
        _img(rng, 96, 128).save(img_dir / f"{i:012d}.jpg")
        _lab(rng, 96, 128, 30).save(root / "annotations" / "train2017"
                                    / f"{i:012d}.png")
    payload = {"images": [{"id": i, "file_name": f"{i:012d}.jpg"}
                          for i in range(4)],   # the 4th has no file
               "annotations": [dict(_person(60, 48), image_id=0),
                               dict(_person(30, 50), image_id=1),
                               dict(_person(90, 44), image_id=1),
                               dict(_person(50, 50), image_id=2,
                                    iscrowd=1)]}
    (root / "annotations" / "person_keypoints_train2017.json").write_text(
        json.dumps(payload))
    (root / "annotations" / "captions_train2017.json").write_text(json.dumps(
        {"annotations": [{"image_id": i, "caption": f"people {i}"}
                         for i in range(3)]}))
    return root


MODES = {
    "coco": {},
    "coco-ade-rgb": {"use_ade_colormap": True, "use_rgb": True},
    "ade20k": {},
    "cityscapes": {},
    "celeba": {"use_rgb": True},
    "sample": {},
    "pose": {},
    "pose-only": {"pose_only": True},
}


def _datasets(trees, name, is_train):
    mode = name.split("-")[0]
    kw = dict(dataset_mode=mode, data_dir=str(trees[mode]), image_size=32,
              is_train=is_train, **MODES[name])
    if mode == "pose" and not is_train:
        kw["is_train"] = True          # the pose tree has no val split
        kw["random_crop"] = kw["random_flip"] = False
    kw["seed"] = 5
    return tds.load_data(**kw), jds.load_data(**kw)


@pytest.mark.parametrize("is_train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(MODES))
def test_load_data_samples_are_bit_equal(trees, name, is_train):
    port, ref = _datasets(trees, name, is_train)
    assert len(port) == len(ref) > 0
    assert port.images == ref.images
    for idx, salt in ((0, 0), (len(ref) - 1, 0), (1, 3), (2, 7)):
        same(port.sample(idx, salt), ref.sample(idx, salt))
    same(port[1], ref[1])


def test_load_data_refuses_unknown_mode(tmp_path):
    for mod in (tds, jds):
        with pytest.raises(NotImplementedError):
            mod.load_data("lsun", str(tmp_path), 32)


def test_pose_pieces_match_jax():
    for ann in (_person(40, 40), dict(_person(40, 40), iscrowd=1),
                {"keypoints": [0.0] * 51}):
        a, b = tpose.assemble_halpe136(ann), jpose.assemble_halpe136(ann)
        assert (a is None) == (b is None)
        if b is not None:
            np.testing.assert_array_equal(a, b)
    people = [tpose.assemble_halpe136(_person(40, 40)),
              tpose.assemble_halpe136(_person(70, 45))]
    np.testing.assert_array_equal(tpose.render_skeleton(people, 80, 100),
                                  jpose.render_skeleton(people, 80, 100))
    assert tpose.VIS_PAIRS == jpose.VIS_PAIRS
    np.testing.assert_array_equal(tpose.JOINT_COLORS, jpose.JOINT_COLORS)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_skeleton_raster_is_opencvs(seed):
    """The numpy raster against ``cv2.line`` (thickness 3) and
    ``cv2.circle`` (filled, radius 3) on random segments: inside the
    canvas, crossing it, far outside, and of length 0."""
    rng = np.random.default_rng(seed)
    for t in range(400):
        h, w = (int(x) for x in rng.integers(8, 140, 2))
        lo, hi = -int(rng.integers(0, 200)), int(rng.integers(10, 300))
        p0, p1 = (tuple(int(x) for x in rng.integers(lo, hi, 2))
                  for _ in range(2))
        if t % 4 == 0:
            p1 = p0
        color = rng.integers(0, 256, 3).astype(np.uint8)
        want = np.zeros((h, w, 3), np.uint8)
        got = want.copy()
        cv2.line(want, p0, p1, tuple(int(c) for c in color), 3)
        cv2.circle(want, p1, 3, tuple(int(c) for c in color), -1)
        tpose._thick_line(got, p0, p1, color, 3)
        tpose._disc(got, *p1, 3, color)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} {p1}")


def _batches(it, n):
    out = []
    for b in it:
        out.append(b)
        if len(out) == n:
            break
    return out


@pytest.mark.parametrize("shuffle", [True, False])
def test_batch_iterator_matches_jax(trees, shuffle):
    port, ref = _datasets(trees, "coco", True)
    kw = dict(shuffle=shuffle, seed=9, drop_last=False, epochs=2)
    got = _batches(tds.batch_iterator(port, 2, tokenizer=CLIPTokenizer(),
                                      **kw), 6)
    want = _batches(jds.batch_iterator(ref, 2, tokenizer=JTokenizer(), **kw),
                    6)
    assert len(got) == len(want) == 6   # 3 a 5-sample epoch, the last ragged
    for g, w in zip(got, want):
        same(g, w)


@pytest.mark.parametrize("workers,index,count", [(1, 0, 1), (4, 0, 1),
                                                 (4, 0, 2), (1, 1, 2)])
def test_parallel_loader_matches_jax(trees, workers, index, count):
    port, ref = _datasets(trees, "coco", True)
    kw = dict(batch_size=2, shuffle=True, seed=11, epochs=3,
              num_workers=workers, prefetch_batches=3,
              process_index=index, process_count=count)
    got = _batches(tpre.ParallelBatchLoader(port, tokenizer=CLIPTokenizer(),
                                            **kw), 6)
    want = _batches(jpre.ParallelBatchLoader(ref, tokenizer=JTokenizer(),
                                             **kw), 6)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        same(g, w)
        assert len(g["captions"]) == 2 // count


@pytest.mark.parametrize("kw", [dict(batch_size=3, process_count=2),
                                dict(batch_size=4, process_index=2,
                                     process_count=2)])
def test_parallel_loader_refusals_match_jax(kw):
    for mod in (tpre, jpre):
        with pytest.raises(ValueError):
            mod.ParallelBatchLoader(list(range(8)), **kw)


def test_device_prefetch_gives_nchw_tensors_on_the_cpu(trees):
    port, ref = _datasets(trees, "celeba", True)
    batches = _batches(jds.batch_iterator(ref, 2, tokenizer=JTokenizer(),
                                          seed=1), 2)
    out = list(tpre.device_prefetch(iter(batches), device="cpu", size=1))
    assert len(out) == 2
    for got, b in zip(out, batches):
        for k in ("image", "rgb"):
            assert got[k].device.type == "cpu" and got[k].is_contiguous()
            np.testing.assert_array_equal(
                got[k].numpy(), np.transpose(b[k], (0, 3, 1, 2)))
        np.testing.assert_array_equal(got["parts"].numpy(), b["parts"])
        np.testing.assert_array_equal(got["input_ids"].numpy(),
                                      np.asarray(b["input_ids"]))
        assert got["captions"] == b["captions"]
