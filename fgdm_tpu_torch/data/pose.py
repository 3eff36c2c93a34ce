"""Pose-factor dataset: COCO-WholeBody keypoints -> Halpe-136 skeleton maps.

Counterpart of ``fgdm_tpu/data/pose.py``, host numpy, sample for sample the
JAX package's (the reference's own pose dataset,
``ldm/data/halpe_coco_wholebody_136.py:93-614``, is dead code there: its
``custom.py:15`` imports a module the reference does not have):

- ``load_wholebody_keypoints``/``people_by_image`` parse person-keypoints
  JSON with the stdlib and ``assemble_halpe136`` builds the 136-joint Halpe
  layout: the 17 COCO body joints, three synthesised (head slot, neck = the
  shoulders' midpoint, hip = the hips' midpoint; reference ``:402-433``),
  then feet, face and hands from the whole-body fields.
- ``render_skeleton`` draws the ``VIS_PAIRS`` edges in the bit-pattern joint
  palette: thickness-3 lines and radius-3 discs, edges with a joint pinned
  at the origin skipped (reference ``:509-526``).  The JAX package draws
  with OpenCV; here OpenCV's LINE_8 raster is rebuilt in numpy, pixel for
  pixel (the raster is the behaviour the maps must match).
- ``PoseDataset`` has ``SemanticDataset``'s interface (per-sample RNG, one
  crop and flip over image, label and pose map) and emits ``pose``,
  ``label``/``parts``, a caption and ``image``: the pose map alone
  (``pose_only``) or the channel concat [rgb | seg | pose].
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
from PIL import Image

from fgdm_tpu_torch.data.colorize import color_map
from fgdm_tpu_torch.data.dataset import (choose_caption, colorize,
                                         load_coco_captions,
                                         random_crop_group, resize_group,
                                         sample_rng)

__all__ = ["NUM_JOINTS", "VIS_PAIRS", "JOINT_COLORS", "assemble_halpe136",
           "render_skeleton", "people_by_image", "load_wholebody_keypoints",
           "PoseDataset", "load_pose_data"]

NUM_JOINTS = 136
_VIS_THRESH = 0.35  # confidence → visible (halpe_coco_wholebody_136.py:435)

# Halpe-136 skeleton edge table (reference `vis_pairs`,
# halpe_coco_wholebody_136.py:122-138 — pure topology data; the drawing IS
# the behaviour, so the table must match for rendered hints to match).
_HEAD = [(0, 1), (0, 2), (1, 3), (2, 4)]
_BODY = [(5, 18), (6, 18), (5, 7), (7, 9), (6, 8), (8, 10),
         (17, 18), (18, 19), (19, 11), (19, 12),
         (11, 13), (12, 14), (13, 15), (14, 16)]
_FEET = [(20, 22), (25, 23), (21, 22), (24, 25), (15, 22), (16, 25)]
_FACE = ([(i, i + 1) for i in range(26, 42)]          # jawline
         + [(i, i + 1) for i in range(43, 47)]        # right brow
         + [(i, i + 1) for i in range(48, 52)]        # left brow
         + [(i, i + 1) for i in range(53, 56)]        # nose bridge
         + [(i, i + 1) for i in range(57, 61)]        # nostrils
         + [(i, i + 1) for i in range(62, 67)]        # right eye
         + [(i, i + 1) for i in range(68, 73)]        # left eye
         + [(i, i + 1) for i in range(74, 81)]        # outer lips
         + [(i, i + 1) for i in range(81, 93)])       # lips
def _hand(w):  # noqa: E306  (wrist + 4 joints per finger, 5 fingers)
    pairs = []
    for f in range(5):
        base = w + 1 + 4 * f
        pairs.append((w, base))
        pairs += [(base + i, base + i + 1) for i in range(3)]
    return pairs
VIS_PAIRS: List = _HEAD + _BODY + _FEET + _FACE + _hand(94) + _hand(115)

JOINT_COLORS = color_map(NUM_JOINTS + 1)[1:]  # skip background colour


def assemble_halpe136(ann: Dict[str, Any]) -> Optional[np.ndarray]:
    """One COCO-WholeBody person annotation → [136, 3] (x, y, vis) or None.

    vis is 1 where the source confidence ≥ 0.35.  Coordinates are kept
    even for low-confidence joints — the reference draws any joint whose
    coordinates are nonzero and uses visibility only for the
    no-visible-keypoint validity gate (`halpe_coco_wholebody_136.py:
    435-443,521`); COCO GT pins unlabeled joints (v=0) to the origin,
    which the renderer skips.  Returns None for crowd/empty annotations.
    """
    if ann.get("iscrowd", 0):
        return None
    body = list(ann.get("keypoints", []))
    if len(body) != 17 * 3 or max(body, default=0) == 0:
        return None
    if ann.get("num_keypoints", 1) == 0:
        return None
    flat = body + [0.0] * 9  # slots 17-19: head/neck/hip, synthesized below
    for key, n in (("foot_kpts", 6), ("face_kpts", 68),
                   ("lefthand_kpts", 21), ("righthand_kpts", 21)):
        ext = list(ann.get(key, []))
        flat += ext if len(ext) == n * 3 else [0.0] * (n * 3)
    kpts = np.asarray(flat, np.float32).reshape(NUM_JOINTS, 3)
    kpts[:, 2] = (kpts[:, 2] >= _VIS_THRESH).astype(np.float32)
    # neck = shoulder midpoint, hip = hip midpoint (reference :426-433);
    # the reference synthesizes from any nonzero shoulders/hips
    for mid, (a, b) in ((18, (5, 6)), (19, (11, 12))):
        if kpts[a, :2].any() and kpts[b, :2].any():
            kpts[mid, :2] = (kpts[a, :2] + kpts[b, :2]) / 2.0
            kpts[mid, 2] = max(kpts[a, 2], kpts[b, 2])
    if kpts[:, 2].sum() < 1:
        return None
    return kpts


# -- OpenCV's LINE_8 raster (``cv2.line``, ``cv2.circle`` filled) in numpy --
# Integer and 16-bit fixed-point arithmetic as OpenCV draws (drawing.cpp:
# ``line`` clips the segment to the image grown by the thickness, then
# ``ThickLine`` fills the segment's quad, edges and scanlines, and puts a disc
# of radius thickness/2 on each end), so the maps are the JAX package's,
# pixel for pixel, without OpenCV.

_XY_SHIFT = 16
_XY_ONE = 1 << _XY_SHIFT


def _tdiv(a: int, b: int) -> int:
    """C's integer division, truncating toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _hline(img, y, x1, x2, color):
    h, w = img.shape[:2]
    x1, x2 = max(x1, 0), min(x2, w - 1)
    if 0 <= y < h and x1 <= x2:
        img[y, x1:x2 + 1] = color


def _disc(img, cx, cy, radius, color):
    """``Circle(..., fill=1)``: the midpoint circle's rows filled."""
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for y, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                        (cy + dx, dy)):
            _hline(img, y, cx - half, cx + half, color)
        dy += 1
        err += plus
        plus += 2
        mask = (1 if err <= 0 else 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def _clip(w, h, p1, p2):
    """``cv::clipLine`` to [0, w) x [0, h): (inside?, p1, p2)."""
    right, bottom = w - 1, h - 1
    (x1, y1), (x2, y2) = p1, p2

    def code(x, y):
        return ((x < 0) + (x > right) * 2 + (y < 0) * 4 + (y > bottom) * 8)

    c1, c2 = code(x1, y1), code(x2, y2)
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += _tdiv((a - y1) * (x2 - x1), y2 - y1)
            y1, c1 = a, code(x1, 0) & 3
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += _tdiv((a - y2) * (x2 - x1), y2 - y1)
            y2, c2 = a, code(x2, 0) & 3
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += _tdiv((a - x1) * (y2 - y1), x2 - x1)
                x1, c1 = a, 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += _tdiv((a - x2) * (y2 - y1), x2 - x1)
                x2, c2 = a, 0
    return (c1 | c2) == 0, (x1, y1), (x2, y2)


def _edge(img, p1, p2, color):
    """``Line2``: a fixed-point segment, one pixel a step on the long
    axis."""
    h, w = img.shape[:2]
    inside, (x1, y1), (x2, y2) = _clip(w << _XY_SHIFT, h << _XY_SHIFT,
                                       p1, p2)
    if not inside:
        return
    dx, dy = x2 - x1, y2 - y1
    x_major = abs(dx) > abs(dy)
    if (dx < 0) if x_major else (dy < 0):
        x1, y1, x2, y2 = x2, y2, x1, y1
        dx, dy = -dx, -dy
    half = _XY_ONE >> 1
    pts = [((x2 + half) >> _XY_SHIFT, (y2 + half) >> _XY_SHIFT)]
    if x_major:
        k = np.arange(((x2 - x1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = ((x1 + half) >> _XY_SHIFT) + k
        ys = (y1 + half + k * _tdiv(dy << _XY_SHIFT, dx | 1)) >> _XY_SHIFT
    else:
        k = np.arange(((y2 - y1) >> _XY_SHIFT) + 1, dtype=np.int64)
        xs = (x1 + half + k * _tdiv(dx << _XY_SHIFT, dy | 1)) >> _XY_SHIFT
        ys = ((y1 + half) >> _XY_SHIFT) + k
    xs = np.concatenate([np.array([pts[0][0]]), xs])
    ys = np.concatenate([np.array([pts[0][1]]), ys])
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def _fill_quad(img, v, color):
    """``FillConvexPoly`` of fixed-point vertices: the outline by
    ``_edge``, then the scanlines between the left and right edges."""
    h, w = img.shape[:2]
    n, half = len(v), _XY_ONE >> 1
    for i in range(n):
        _edge(img, v[i - 1], v[i], color)
    ys = [(p[1] + half) >> _XY_SHIFT for p in v]
    xs = [(p[0] + half) >> _XY_SHIFT for p in v]
    imin = min(range(n), key=lambda i: (v[i][1], i))
    y, ymax = ys[imin], min(max(ys), h - 1)
    if max(xs) < 0 or max(ys) < 0 or min(xs) >= w or y >= h:
        return
    edges = n
    sides = [[imin, 1, -_XY_ONE, 0, y], [imin, n - 1, -_XY_ONE, 0, y]]
    while True:
        for side in sides:
            idx0, di = side[0], side[1]
            if y < side[4]:
                continue
            idx = (idx0 + di) % n
            while True:
                edges -= 1
                if edges < 0:
                    break
                ty = ys[idx]
                if ty > y:
                    xs0, xe = v[idx0][0], v[idx][0]
                    side[:] = [idx, di, xs0,
                               _tdiv((xe - xs0) * 2 + (ty - y),
                                     2 * (ty - y)), ty]
                    break
                idx0, idx = idx, (idx + di) % n
        if edges < 0:
            break
        if y >= 0:
            left, right = sorted((sides[0][2], sides[1][2]))
            _hline(img, y, (left + half) >> _XY_SHIFT,
                   (right + half) >> _XY_SHIFT, color)
        for side in sides:
            side[2] += side[3]
        y += 1
        if y > ymax:
            break


def _thick_line(img, p0, p1, color, thickness):
    """``cv2.line`` of integer points, thickness > 1."""
    h, w = img.shape[:2]
    t = thickness
    inside, (x0, y0), (x1, y1) = _clip(w + 2 * t, h + 2 * t,
                                       (p0[0] + t, p0[1] + t),
                                       (p1[0] + t, p1[1] + t))
    if not inside:
        return
    a = ((x0 - t) << _XY_SHIFT, (y0 - t) << _XY_SHIFT)
    b = ((x1 - t) << _XY_SHIFT, (y1 - t) << _XY_SHIFT)
    fx, fy = (a[0] - b[0]) / _XY_ONE, (b[1] - a[1]) / _XY_ONE
    r2 = fx * fx + fy * fy
    half_t = t << (_XY_SHIFT - 1)
    if r2 > 2.220446049250313e-16:
        r = (half_t + (t & 1) * _XY_ONE * 0.5) / math.sqrt(r2)
        dx, dy = round(fy * r), round(fx * r)   # cvRound: half to even
        _fill_quad(img, [(a[0] + dx, a[1] + dy), (a[0] - dx, a[1] - dy),
                         (b[0] - dx, b[1] - dy), (b[0] + dx, b[1] + dy)],
                   color)
    for p in (a, b):
        _disc(img, (p[0] + (_XY_ONE >> 1)) >> _XY_SHIFT,
              (p[1] + (_XY_ONE >> 1)) >> _XY_SHIFT,
              (half_t + (_XY_ONE >> 1)) >> _XY_SHIFT, color)


def render_skeleton(people: Sequence[np.ndarray], height: int, width: int,
                    thickness: int = 3, radius: int = 3) -> np.ndarray:
    """Rasterize Halpe-136 skeletons onto a black uint8 canvas.

    Matches the reference's draw loop (`halpe_coco_wholebody_136.py:
    509-526`): per-edge colour from the bit-pattern palette, line then two
    end discs, edges with an origin-pinned endpoint skipped.
    """
    canvas = np.zeros((height, width, 3), np.uint8)
    for kpts in people:
        pts = kpts[:, :2].round().astype(int)
        for (a, b), color in zip(VIS_PAIRS, JOINT_COLORS):
            j1, j2 = pts[a], pts[b]
            if max(j1) == 0 or max(j2) == 0:
                continue
            j1, j2 = (int(j1[0]), int(j1[1])), (int(j2[0]), int(j2[1]))
            _thick_line(canvas, j1, j2, color, thickness)
            _disc(canvas, *j1, radius, color)
            _disc(canvas, *j2, radius, color)
    return canvas


def people_by_image(payload: Dict[str, Any]) -> Dict[int, List[np.ndarray]]:
    """Parsed person_keypoints/coco_wholebody payload →
    {image_id: [[136,3]...]}."""
    people: Dict[int, List[np.ndarray]] = {}
    for ann in payload.get("annotations", []):
        kpts = assemble_halpe136(ann)
        if kpts is not None:
            people.setdefault(ann["image_id"], []).append(kpts)
    return people


def load_wholebody_keypoints(ann_file: str) -> Dict[int, List[np.ndarray]]:
    """person_keypoints/coco_wholebody JSON → {image_id: [[136,3]...]}."""
    with open(ann_file) as f:
        return people_by_image(json.load(f))


class PoseDataset:
    """Image + seg label + rendered pose skeleton → FG-DM training dicts.

    The working replacement for the reference's broken pose path; same
    emitted keys (`halpe_coco_wholebody_136.py:482-614`), this repo's
    per-sample-RNG determinism contract (SemanticDataset._sample_rng).
    """

    def __init__(
        self,
        image_size: int,
        image_files: Sequence[str],
        class_files: Sequence[str],
        keypoints: Dict[str, List[np.ndarray]],
        captions: Optional[Dict[str, List[str]]] = None,
        random_crop: bool = True,
        random_flip: bool = True,
        is_train: bool = True,
        pose_only: bool = False,
        use_pose: bool = True,
        seed: int = 0,
    ):
        assert len(image_files) == len(class_files)
        self.size = image_size
        self.images = list(image_files)
        self.classes = list(class_files)
        self.keypoints = keypoints  # image path → list of [136,3]
        self.captions = captions or {}
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.is_train = is_train
        self.pose_only = pose_only
        self.use_pose = use_pose
        self.seed = seed

    def __len__(self) -> int:
        return len(self.images)

    def _sample_rng(self, idx: int, salt: int) -> random.Random:
        return sample_rng(self.seed, idx, salt)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.sample(idx)

    def sample(self, idx: int, salt: int = 0) -> Dict[str, Any]:
        rng = self._sample_rng(idx, salt)
        path = self.images[idx]
        img = Image.open(path).convert("RGB")
        label_img = Image.open(self.classes[idx]).convert("L")
        w, h = img.size

        pose = render_skeleton(self.keypoints.get(path, []), h, w) \
            if self.use_pose else np.zeros((h, w, 3), np.uint8)
        pose_img = Image.fromarray(pose)

        group = [img, label_img, pose_img]
        # pose renders resample NEAREST: bicubic would smear the palette
        # colours that encode joint identity (same reason as the seg map).
        resamples = [Image.BICUBIC, Image.NEAREST, Image.NEAREST]
        if self.is_train and self.random_crop:
            ai, al, ap = random_crop_group(group, resamples, self.size, rng)
        else:
            ai, al, ap = resize_group(group, resamples, self.size)

        if self.random_flip and rng.random() < 0.5:
            ai = ai[:, ::-1].copy()
            al = al[:, ::-1].copy()
            ap = ap[:, ::-1].copy()

        rgb = ai.astype(np.float32) / 127.5 - 1.0
        pose_f = ap.astype(np.float32) / 127.5 - 1.0

        out: Dict[str, Any] = {"path": path, "label_ori": al.copy(),
                               "pose": pose_f}
        al = al.astype(np.int64)
        parts = al.copy()
        parts[parts == 255] = 182  # COCO-stuff unlabeled id (reference :562)
        out["parts"] = parts
        out["label"] = al

        n = max(int(al.max()) + 1, 1)
        seg_rgb = colorize(al, color_map(n)).astype(np.float32) / 127.5 - 1.0
        if self.pose_only:
            out["image"] = pose_f
        else:
            out["image"] = np.concatenate([rgb, seg_rgb, pose_f], axis=-1)

        out["caption"] = choose_caption(
            self.captions.get(path, [""]), rng, self.is_train)
        return out


def load_pose_data(
    data_dir: str,
    image_size: int,
    is_train: bool = True,
    ann_file: Optional[str] = None,
    **kwargs,
) -> PoseDataset:
    """Factory over the COCO directory layout the seg loader already uses.

    ``annotations/person_keypoints_{split}.json`` (or a coco_wholebody
    file via ``ann_file``) supplies keypoints; captions come from the
    standard captions JSON; label PNGs follow the reference's
    images/→annotations/ path convention (`halpe_coco_wholebody_136.py:
    498`).  Images with no valid person are kept with an empty skeleton —
    pose factors must learn blank hints for peopleless scenes.
    """
    split = "train2017" if is_train else "val2017"
    img_dir = os.path.join(data_dir, "images", split)
    ann_file = ann_file or os.path.join(
        data_dir, "annotations", f"person_keypoints_{split}.json")
    # one parse serves both the annotations and the image list (the real
    # COCO keypoints JSON is ~250MB)
    with open(ann_file) as f:
        payload = json.load(f)
    by_id = people_by_image(payload)
    images_meta = payload.get("images", [])
    images, classes = [], []
    keypoints: Dict[str, List[np.ndarray]] = {}
    for meta in images_meta:
        path = os.path.join(img_dir, meta["file_name"])
        if not os.path.exists(path):
            continue
        label = path.replace("/images/", "/annotations/")
        label = label.rsplit(".", 1)[0] + ".png"
        if not os.path.exists(label):
            continue
        images.append(path)
        classes.append(label)
        keypoints[path] = by_id.get(meta["id"], [])
    captions = None
    cap_file = os.path.join(data_dir, "annotations", f"captions_{split}.json")
    if os.path.exists(cap_file):
        captions = load_coco_captions(data_dir, is_train)
    return PoseDataset(
        image_size, images, classes, keypoints, captions=captions,
        is_train=is_train, **kwargs,
    )
