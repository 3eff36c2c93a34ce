"""OpenPose body-pose annotator (the CPM two-branch network and PAF
grouping), the pose adherence metric's re-annotator in ``cli/eval.py``.

Counterpart of ``fgdm_tpu/annotators/openpose.py:49-485`` (the reference's
``controlnet/annotator/openpose``): ``BodyPoseNet`` is a VGG stem
(conv1_1 .. conv4_4_CPM, max pools after conv1_2, conv2_2 and conv3_4) and
6 stages of two branches, part-affinity fields (38 channels) and keypoint
heat maps (19), each later stage reading ``concat(paf, heat, features)``;
the final heat map goes through a ReLU, the reference's quirk (its
``no_relu_layers`` never lists ``Mconv7_stage6_L2``).  ``HandPoseNet`` is
the hand CPM (stem to conv5_3_CPM, a 22-channel head, 5 refinement
stages).  The modules carry the reference torch module's names
(``model0.conv1_1``, ``model1_2.conv5_3_CPM_L2``,
``model6_1.Mconv7_stage6_L1``; the hand net's ``model1_0``, ``model1_1``,
``model{2..6}``);
``checkpoint/annotator_ingest.load_openpose`` reads the released files,
which store bare conv names.  Plain PyTorch ops in float32.

The detection flow is host-side numpy and scipy, as in JAX: the maps
resized to the image (``jax.image.resize(..., "bicubic")``), heat-map peaks
(``find_peaks``), PAF line integrals (``score_limbs``), union-find person
assembly with the reference's filter (``assemble_persons``) and the render.
No OpenCV: the skeleton is drawn with the numpy LINE_8 raster of
``data/pose.py`` (``_thick_line``, ``_disc``), which matches ``cv2.line``
and ``cv2.circle`` pixel for pixel, and ``HandEstimator``'s
``cv2.resize(INTER_CUBIC)`` is torch's bicubic (a = -0.75, no antialias),
within one uint8 step on the image and in float on the heat maps.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from fgdm_tpu_torch import full_f32, resolve_device
from fgdm_tpu_torch.data.pose import _disc, _thick_line
from fgdm_tpu_torch.nn.layers import Conv2d
from fgdm_tpu_torch.utils.clip_score import resize_bicubic

__all__ = ["LIMB_SEQ", "MAP_IDX", "COLORS", "HAND_EDGES", "ConvStage",
           "BodyPoseNet", "HandPoseNet", "find_peaks", "score_limbs",
           "assemble_persons", "hand_detect", "draw_bodypose",
           "draw_handpose", "HandEstimator", "OpenposeDetector"]

# COCO-18 limb sequence and the PAF channel pairs (public OpenPose tables)
LIMB_SEQ = [
    (2, 3), (2, 6), (3, 4), (4, 5), (6, 7), (7, 8), (2, 9), (9, 10),
    (10, 11), (2, 12), (12, 13), (13, 14), (2, 1), (1, 15), (15, 17),
    (1, 16), (16, 18), (3, 17), (6, 18),
]
MAP_IDX = [
    (31, 32), (39, 40), (33, 34), (35, 36), (41, 42), (43, 44), (19, 20),
    (21, 22), (23, 24), (25, 26), (27, 28), (29, 30), (47, 48), (49, 50),
    (53, 54), (51, 52), (55, 56), (37, 38), (45, 46),
]
COLORS = [
    [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0], [170, 255, 0],
    [85, 255, 0], [0, 255, 0], [0, 255, 85], [0, 255, 170], [0, 255, 255],
    [0, 170, 255], [0, 85, 255], [0, 0, 255], [85, 0, 255], [170, 0, 255],
    [255, 0, 255], [255, 0, 170], [255, 0, 85],
]
HAND_EDGES = [
    (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
    (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
    (15, 16), (0, 17), (17, 18), (18, 19), (19, 20),
]
_POOLS_AFTER = ("conv1_2", "conv2_2", "conv3_4")


class ConvStage(nn.Module):
    """Named convs (``(name, in, out, kernel)``, "same" padding) with a
    ReLU after each but the last (after the last too with ``final_relu``),
    a 2x2 max pool after the ones named in ``pools_after``."""

    def __init__(self, plan: Sequence[Tuple[str, int, int, int]],
                 pools_after: Sequence[str] = (), final_relu: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.names = [name for name, *_ in plan]
        self.pools_after, self.final_relu = tuple(pools_after), final_relu
        for name, cin, cout, k in plan:
            setattr(self, name, Conv2d(cin, cout, k, padding=k // 2,
                                       dtype=dtype))

    def forward(self, x):
        for i, name in enumerate(self.names):
            x = getattr(self, name)(x)
            if self.final_relu or i < len(self.names) - 1:
                x = F.relu(x)
            if name in self.pools_after:
                x = F.max_pool2d(x, 2, 2)
        return x


def _stem(plan, dtype):
    chans, out = [], 3
    for name, cout in plan:
        chans.append((name, out, cout, 3))
        out = cout
    return ConvStage(chans, _POOLS_AFTER, final_relu=True, dtype=dtype)


class BodyPoseNet(nn.Module):
    """``[B, 3, H, W]`` (``img / 256 - 0.5``) -> (paf ``[B, 38, H/8, W/8]``,
    heat ``[B, 19, H/8, W/8]``)."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.model0 = _stem([
                ("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
                ("conv2_2", 128), ("conv3_1", 256), ("conv3_2", 256),
                ("conv3_3", 256), ("conv3_4", 256), ("conv4_1", 512),
                ("conv4_2", 512), ("conv4_3_CPM", 256),
                ("conv4_4_CPM", 128)], dtype)
            for L, out in ((1, 38), (2, 19)):
                plan = [(f"conv5_{j}_CPM_L{L}", c, 128, 3)
                        for j, c in ((1, 128), (2, 128), (3, 128))]
                plan += [(f"conv5_4_CPM_L{L}", 128, 512, 1),
                         (f"conv5_5_CPM_L{L}", 512, out, 1)]
                setattr(self, f"model1_{L}", ConvStage(plan, dtype=dtype))
                for s in range(2, 7):
                    plan = [(f"Mconv{j}_stage{s}_L{L}",
                             185 if j == 1 else 128, 128, 7)
                            for j in range(1, 6)]
                    plan += [(f"Mconv6_stage{s}_L{L}", 128, 128, 1),
                             (f"Mconv7_stage{s}_L{L}", 128, out, 1)]
                    setattr(self, f"model{s}_{L}",
                            ConvStage(plan, dtype=dtype))

    def forward(self, x: torch.Tensor):
        feat = self.model0(x)
        paf, heat = self.model1_1(feat), self.model1_2(feat)
        for s in range(2, 7):
            inp = torch.cat([paf, heat, feat], dim=1)
            paf = getattr(self, f"model{s}_1")(inp)
            heat = getattr(self, f"model{s}_2")(inp)
        return paf, F.relu(heat)


class HandPoseNet(nn.Module):
    """``[B, 3, H, W]`` (``img / 256 - 0.5``) -> heat ``[B, 22, H/8,
    W/8]``; only conv6_2_CPM and the Mconv7s skip the ReLU."""

    def __init__(self, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        with torch.device(resolve_device(device)):
            self.model1_0 = _stem([
                ("conv1_1", 64), ("conv1_2", 64), ("conv2_1", 128),
                ("conv2_2", 128), ("conv3_1", 256), ("conv3_2", 256),
                ("conv3_3", 256), ("conv3_4", 256), ("conv4_1", 512),
                ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
                ("conv5_1", 512), ("conv5_2", 512), ("conv5_3_CPM", 128)],
                dtype)
            self.model1_1 = ConvStage([("conv6_1_CPM", 128, 512, 1),
                                       ("conv6_2_CPM", 512, 22, 1)],
                                      dtype=dtype)
            for s in range(2, 7):
                plan = [(f"Mconv{j}_stage{s}", 150 if j == 1 else 128, 128,
                         7) for j in range(1, 6)]
                plan += [(f"Mconv6_stage{s}", 128, 128, 1),
                         (f"Mconv7_stage{s}", 128, 22, 1)]
                setattr(self, f"model{s}", ConvStage(plan, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        feat = self.model1_0(x)
        out = self.model1_1(feat)
        for s in range(2, 7):
            out = getattr(self, f"model{s}")(torch.cat([out, feat], dim=1))
        return out


def find_peaks(heat: np.ndarray, thre1: float = 0.1) -> List[List[Tuple]]:
    """Per-channel local maxima ``(x, y, score, id)`` of the smoothed heat
    maps ``[H, W, 19]`` (the reference's ``body.py`` peak pass)."""
    from scipy.ndimage import gaussian_filter, maximum_filter

    all_peaks = []
    pid = 0
    for c in range(18):
        m = gaussian_filter(heat[..., c], sigma=3)
        mx = maximum_filter(m, size=3, mode="constant")
        lst = []
        for y, x in np.argwhere((m == mx) & (m > thre1)):
            lst.append((x, y, heat[y, x, c], pid))
            pid += 1
        all_peaks.append(lst)
    return all_peaks


def score_limbs(paf: np.ndarray, all_peaks, thre2: float = 0.05,
                n_sample: int = 10):
    """PAF line-integral scoring of the candidate limbs, greedily paired
    (the reference's connection pass)."""
    connections = []
    for (a, b), (m1, m2) in zip(LIMB_SEQ, MAP_IDX):
        cand_a, cand_b = all_peaks[a - 1], all_peaks[b - 1]
        pafx, pafy = paf[..., m1 - 19], paf[..., m2 - 19]
        conns = []
        for ia, pa in enumerate(cand_a):
            for ib, pb in enumerate(cand_b):
                vec = np.asarray([pb[0] - pa[0], pb[1] - pa[1]], np.float32)
                norm = np.linalg.norm(vec) + 1e-8
                vecn = vec / norm
                xs = np.linspace(pa[0], pb[0], n_sample).astype(int)
                ys = np.linspace(pa[1], pb[1], n_sample).astype(int)
                score = pafx[ys, xs] * vecn[0] + pafy[ys, xs] * vecn[1]
                mean_s = score.mean() + min(0.5 * paf.shape[0] / norm - 1, 0)
                if (score > thre2).sum() > 0.8 * n_sample and mean_s > 0:
                    conns.append((ia, ib, mean_s))
        conns.sort(key=lambda t: -t[2])
        used_a, used_b, kept = set(), set(), []
        for ia, ib, s in conns:
            if ia not in used_a and ib not in used_b:
                kept.append((ia, ib, s))
                used_a.add(ia)
                used_b.add(ib)
        connections.append(kept)
    return connections


def assemble_persons(all_peaks, connections, min_parts: int = 4,
                     min_score: float = 0.4) -> List[Dict[int, Tuple]]:
    """Peaks grouped into persons by union-find over the kept limbs, as
    ``{part channel: (x, y, score, id)}``; a person with fewer than
    ``min_parts`` parts, or whose part and limb scores average below
    ``min_score``, is dropped (the reference's filter, ``body.py:200-205``)."""
    parent: Dict[int, int] = {}

    def find(i):
        while parent.setdefault(i, i) != i:
            parent[i] = parent[parent[i]]
            i = parent[i]
        return i

    peak_of, part_of = {}, {}
    for c, peaks in enumerate(all_peaks):
        for p in peaks:
            peak_of[p[3]] = p
            part_of[p[3]] = c
    conn_scores: List[Tuple[int, float]] = []
    for (a, b), kept in zip(LIMB_SEQ, connections):
        for ia, ib, s in kept:
            pid_a = all_peaks[a - 1][ia][3]
            parent[find(pid_a)] = find(all_peaks[b - 1][ib][3])
            conn_scores.append((pid_a, float(s)))
    groups: Dict[int, Dict[int, Tuple]] = {}
    score: Dict[int, float] = {}
    for pid, p in peak_of.items():
        root = find(pid)
        groups.setdefault(root, {})[part_of[pid]] = p
        score[root] = score.get(root, 0.0) + float(p[2])
    for pid, s in conn_scores:
        score[find(pid)] += s
    return [g for root, g in groups.items()
            if len(g) >= min_parts and score[root] / len(g) >= min_score]


def hand_detect(persons, image_height: int, image_width: int,
                ratio_wrist_elbow: float = 0.33) -> List[Tuple]:
    """The reference's ``handDetect`` (``openpose/util.py:94-160``): square
    crops ``(x, y, w, is_left)`` from the shoulder, elbow and wrist (right
    2/3/4, left 5/6/7), clamped to the image, dropped under 20 px."""
    out = []
    for person in persons:
        hands = []
        if all(k in person for k in (5, 6, 7)):
            hands.append((person[5], person[6], person[7], True))
        if all(k in person for k in (2, 3, 4)):
            hands.append((person[2], person[3], person[4], False))
        for shoulder, elbow, wrist, is_left in hands:
            x1, y1 = float(shoulder[0]), float(shoulder[1])
            x2, y2 = float(elbow[0]), float(elbow[1])
            x3, y3 = float(wrist[0]), float(wrist[1])
            x = x3 + ratio_wrist_elbow * (x3 - x2)
            y = y3 + ratio_wrist_elbow * (y3 - y2)
            d_we = math.sqrt((x3 - x2) ** 2 + (y3 - y2) ** 2)
            d_es = math.sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2)
            width = 1.5 * max(d_we, 0.9 * d_es)
            x -= width / 2
            y -= width / 2
            x, y = max(x, 0.0), max(y, 0.0)
            width1 = width2 = width
            if x + width > image_width:
                width1 = image_width - x
            if y + width > image_height:
                width2 = image_height - y
            width = min(width1, width2)
            if width >= 20:
                out.append((int(x), int(y), int(width), is_left))
    return out


def draw_bodypose(canvas: np.ndarray, persons) -> np.ndarray:
    """The assembled skeletons: 17 limbs (thickness 4), then each part's
    filled disc of radius 4 (the reference's ``draw_bodypose``)."""
    for limb_i, (a, b) in enumerate(LIMB_SEQ[:17]):
        color = COLORS[limb_i % len(COLORS)]
        for person in persons:
            pa, pb = person.get(a - 1), person.get(b - 1)
            if pa is None or pb is None:
                continue
            _thick_line(canvas, (int(pa[0]), int(pa[1])),
                        (int(pb[0]), int(pb[1])), color, 4)
    for person in persons:
        for c, (x, y, _, _) in person.items():
            _disc(canvas, int(x), int(y), 4, COLORS[c % len(COLORS)])
    return canvas


def _hsv_rgb255(h: float) -> List[int]:
    """matplotlib's ``hsv_to_rgb([h, 1, 1]) * 255`` (its arithmetic, term
    for term), rounded to uint8 as OpenCV takes a float colour (half to
    even)."""
    s = v = 1.0
    i = int(h * 6.0)
    f = h * 6.0 - i
    p, q, t = v * (1.0 - s), v * (1.0 - s * f), v * (1.0 - s * (1.0 - f))
    rgb = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v),
           (v, p, q)][i % 6]
    return [int(np.clip(np.rint(c * 255), 0, 255)) for c in rgb]


def draw_handpose(canvas: np.ndarray, all_hand_peaks) -> np.ndarray:
    """The reference's ``draw_handpose`` (``util.py:74-90``): HSV-rainbow
    finger edges (thickness 2) where both ends were detected (nonzero),
    then red discs of radius 4 on every joint."""
    for peaks in all_hand_peaks:
        for ie, e in enumerate(HAND_EDGES):
            if np.all(peaks[list(e)] != 0):
                (x1, y1), (x2, y2) = peaks[e[0]], peaks[e[1]]
                _thick_line(canvas, (int(x1), int(y1)), (int(x2), int(y2)),
                            _hsv_rgb255(ie / float(len(HAND_EDGES))), 2)
        for x, y in peaks:
            _disc(canvas, int(x), int(y), 4, (0, 0, 255))
    return canvas


def _resize_cubic(x: torch.Tensor, size, scale=None) -> torch.Tensor:
    """``cv2.resize(..., INTER_CUBIC)`` on NCHW float to ``size``: a =
    -0.75, source indices clamped at the border; with ``scale`` (cv2's
    ``fx = fy``) the source is sampled at ``(i + 0.5) / scale - 0.5``."""
    if scale is None:
        return F.interpolate(x, size=tuple(size), mode="bicubic",
                             align_corners=False)
    return torch.ops.aten.upsample_bicubic2d.default(
        x, list(size), False, scale, scale)


class HandEstimator:
    """Hand keypoints of a crop (``openpose/hand.py:25-76``): 4 scales
    around boxsize 368, padded to the 8-px stride with 128, the upsampled
    heat maps averaged, then per part a gaussian blur (sigma 3), a 0.05
    threshold, the 8-connected component of largest mass and its argmax
    ``(x, y)``; an undetected part is (0, 0)."""

    def __init__(self, model: HandPoseNet):
        self.model = model.requires_grad_(False).eval()

    @torch.no_grad()
    def __call__(self, ori_img: np.ndarray, thre: float = 0.05,
                 boxsize: int = 368) -> np.ndarray:
        from scipy.ndimage import gaussian_filter
        from scipy.ndimage import label as cc_label

        dev = next(self.model.parameters()).device
        h, w = ori_img.shape[:2]
        stride, pad_value = 8, 128
        heat_avg = np.zeros((h, w, 22), np.float32)
        src = torch.from_numpy(ori_img.astype(np.float32)).permute(
            2, 0, 1)[None].to(dev)
        scales = [s * boxsize / h for s in (0.5, 1.0, 1.5, 2.0)]
        for scale in scales:
            # cv2's output size for fx = fy = scale: rounded half to even
            size = (int(np.rint(h * scale)), int(np.rint(w * scale)))
            img = _resize_cubic(src, size, scale).round().clamp(0, 255)
            pad_d = (stride - size[0] % stride) % stride
            pad_r = (stride - size[1] % stride) % stride
            img_p = F.pad(img, (0, pad_r, 0, pad_d), value=pad_value)
            with full_f32():
                heat = self.model(img_p / 256.0 - 0.5)
                heat = _resize_cubic(heat, [n * stride for n in
                                            heat.shape[-2:]], stride)
                heat = _resize_cubic(heat[..., :size[0], :size[1]], (h, w))
            heat_avg += heat[0].permute(1, 2, 0).cpu().numpy() / len(scales)

        peaks = []
        eight = np.ones((3, 3), np.int32)   # 8-connectivity (skimage's)
        for part in range(21):
            m = heat_avg[..., part].copy()
            binary = gaussian_filter(m, sigma=3) > thre
            if not binary.any():
                peaks.append([0, 0])
                continue
            lab, n = cc_label(binary, structure=eight)
            sums = [m[lab == i].sum() for i in range(1, n + 1)]
            m[lab != (int(np.argmax(sums)) + 1)] = 0
            yy, xx = np.unravel_index(np.argmax(m), m.shape)
            peaks.append([int(xx), int(yy)])
        return np.array(peaks)


class OpenposeDetector:
    """uint8 ``[H, W, 3]`` image -> the skeleton render (the reference
    contract, ``openpose/__init__.py:21-48``).  ``hand=True`` also runs the
    ``hand_detect`` crops through the hand net and draws the hands."""

    def __init__(self, model: BodyPoseNet, hand_model: HandPoseNet = None):
        self.model = model.requires_grad_(False).eval()
        self.hand_estimation = (HandEstimator(hand_model)
                                if hand_model is not None else None)

    @torch.no_grad()
    def maps(self, img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """The network's (paf ``[H, W, 38]``, heat ``[H, W, 19]``) resized
        to the image, float32 numpy."""
        h, w = img.shape[:2]
        dev = next(self.model.parameters()).device
        x = torch.from_numpy(img.astype(np.float32) / 256.0 - 0.5)
        with full_f32():
            paf, heat = self.model(x.permute(2, 0, 1)[None].to(dev))
            paf, heat = (resize_bicubic(t, (h, w))[0].permute(1, 2, 0)
                         for t in (paf, heat))
            return paf.cpu().numpy(), heat.cpu().numpy()

    def render(self, img: np.ndarray, paf: np.ndarray, heat: np.ndarray,
               hand: bool = False) -> np.ndarray:
        """The host half: peaks, limbs, persons and the canvas."""
        h, w = img.shape[:2]
        peaks = find_peaks(heat)
        persons = assemble_persons(peaks, score_limbs(paf, peaks))
        canvas = draw_bodypose(np.zeros((h, w, 3), np.uint8), persons)
        if hand:
            if self.hand_estimation is None:
                raise ValueError(
                    "hand=True needs hand weights — load via "
                    "load_openpose(..., hand_ckpt_path=...)")
            all_hand_peaks = []
            for hx, hy, hw_, _ in hand_detect(persons, h, w):
                hp = self.hand_estimation(img[hy:hy + hw_, hx:hx + hw_])
                # the detected (nonzero) peaks into image coordinates
                hp[:, 0] = np.where(hp[:, 0] == 0, 0, hp[:, 0] + hx)
                hp[:, 1] = np.where(hp[:, 1] == 0, 0, hp[:, 1] + hy)
                all_hand_peaks.append(hp)
            canvas = draw_handpose(canvas, all_hand_peaks)
        return canvas

    def __call__(self, img: np.ndarray, hand: bool = False) -> np.ndarray:
        return self.render(img, *self.maps(img), hand=hand)
