"""Semantic-segmentation datasets (COCO, ADE20K, Cityscapes, CelebA and the
``sample`` layout) and their batch iterator, host numpy and Pillow.

Counterpart of ``fgdm_tpu/data/dataset.py`` (reference
``ldm/data/semantic.py:86-800``), call for call, so every sample and batch
is bit-equal to the JAX package's: ``load_data`` resolves a mode's file
lists; ``SemanticDataset.sample(idx, salt)`` loads the RGB image and the
label PNG, applies the BOX prefilter + bicubic resize or random crop and the
flip, colourises the label map (the colourised map IS the ``image`` the
FG-DM-Seg factor trains on) and draws a COCO caption; ``batch_iterator``
yields NHWC numpy batches with token ids.  ``list_image_files`` also serves
the seg2image CLI.  NHWC becomes NCHW only on the way to the card
(``data/prefetch.device_prefetch``).
"""

from __future__ import annotations

import json
import math
import os
import random
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np
from PIL import Image

from fgdm_tpu_torch.data.colorize import ade_cmap, coco_to_ade_labels
from fgdm_tpu_torch.data.colorize import color_map
from fgdm_tpu_torch.data.colorize import colorize as _np_colorize

__all__ = ["IMG_EXTS", "list_image_files", "colorize", "load_coco_captions",
           "resize_group", "resize_pair", "center_crop_group",
           "center_crop_pair", "random_crop_group", "random_crop_pair",
           "sample_rng", "choose_caption", "SemanticDataset", "load_data",
           "batch_iterator", "stack_items"]

IMG_EXTS = ("jpg", "jpeg", "png", "gif")


def colorize(labels, cmap) -> np.ndarray:
    """The native codec where it is built and the labels fit a byte, else
    numpy's (the same colours)."""
    from fgdm_tpu_torch.data import native

    labels = np.asarray(labels)
    if native.HAS_NATIVE and labels.min() >= 0 and labels.max() < 256:
        return native.colorize(labels.astype(np.uint8), cmap)
    return _np_colorize(labels, cmap)


def list_image_files(data_dir: str) -> List[str]:
    """Image files under ``data_dir``, sorted by name at each level,
    subdirectories descended in place."""
    results: List[str] = []
    for entry in sorted(os.listdir(data_dir)):
        full = os.path.join(data_dir, entry)
        ext = entry.rsplit(".", 1)[-1].lower() if "." in entry else ""
        if ext in IMG_EXTS:
            results.append(full)
        elif os.path.isdir(full):
            results.extend(list_image_files(full))
    return results


def load_coco_captions(data_dir: str, is_train: bool) -> Dict[str, List[str]]:
    """image path -> its captions, from ``captions_{train,val}2017.json``
    (stdlib JSON, no pycocotools)."""
    split = "train2017" if is_train else "val2017"
    with open(os.path.join(data_dir, "annotations",
                           f"captions_{split}.json")) as f:
        payload = json.load(f)
    img_dir = os.path.join(data_dir, "images", split)
    caps: Dict[str, List[str]] = {}
    for a in payload["annotations"]:
        stem = f"{a['image_id']:012d}"
        path = os.path.join(img_dir, stem + ".jpg")
        if not os.path.exists(path):
            path = os.path.join(img_dir, stem + ".png")
        caps.setdefault(path, []).append(a["caption"])
    return caps


# -- resize and crop (reference semantic.py:698-800) --------------------------

def _box_prefilter(img, target: int):
    while min(img.size) >= 2 * target:
        img = img.resize(tuple(x // 2 for x in img.size), resample=Image.BOX)
    return img


def resize_group(imgs: Sequence, resamples: Sequence, size: int,
                 keep_aspect: bool = False) -> List[np.ndarray]:
    """Resize aligned PIL images; the first one's size sets the target."""
    lead = _box_prefilter(imgs[0], size)
    if keep_aspect:
        scale = size / min(lead.size)
        target = tuple(round(x * scale) for x in lead.size)
    else:
        target = (size, size)
    return [np.array(im.resize(target, resample=rs))
            for im, rs in zip(imgs, resamples)]


def resize_pair(img, label, size: int, keep_aspect: bool = False):
    return tuple(resize_group([img, label], [Image.BICUBIC, Image.NEAREST],
                              size, keep_aspect=keep_aspect))


def _crop_group(imgs, resamples, smaller: int) -> List[np.ndarray]:
    """Scale so the short side is ``smaller`` (the first image BOX-
    prefiltered), before the crop."""
    lead = _box_prefilter(imgs[0], smaller)
    scale = smaller / min(lead.size)
    target = tuple(round(x * scale) for x in lead.size)
    return [np.array(im.resize(target, resample=rs))
            for im, rs in zip(imgs, resamples)]


def center_crop_group(imgs: Sequence, resamples: Sequence,
                      size: int) -> List[np.ndarray]:
    arrs = _crop_group(imgs, resamples, size)
    cy = (arrs[0].shape[0] - size) // 2
    cx = (arrs[0].shape[1] - size) // 2
    return [a[cy:cy + size, cx:cx + size] for a in arrs]


def center_crop_pair(img, label, size: int):
    return tuple(center_crop_group([img, label],
                                   [Image.BICUBIC, Image.NEAREST], size))


def random_crop_group(imgs: Sequence, resamples: Sequence, size: int,
                      rng: random.Random, min_crop_frac: float = 0.8,
                      max_crop_frac: float = 1.0) -> List[np.ndarray]:
    lo = math.ceil(size / max_crop_frac)
    hi = math.ceil(size / min_crop_frac)
    arrs = _crop_group(imgs, resamples, rng.randrange(lo, hi + 1))
    cy = rng.randrange(arrs[0].shape[0] - size + 1)
    cx = rng.randrange(arrs[0].shape[1] - size + 1)
    return [a[cy:cy + size, cx:cx + size] for a in arrs]


def random_crop_pair(img, label, size: int, rng: random.Random,
                     min_crop_frac: float = 0.8, max_crop_frac: float = 1.0):
    return tuple(random_crop_group(
        [img, label], [Image.BICUBIC, Image.NEAREST], size, rng,
        min_crop_frac=min_crop_frac, max_crop_frac=max_crop_frac))


def sample_rng(seed: int, idx: int, salt: int) -> random.Random:
    """The per-sample augmentation RNG, a function of (seed, salt, idx)
    alone: loads reproduce whatever the worker count or thread order.  The
    parallel loader passes the epoch as ``salt``, so augmentations still
    change between epochs (reference ``worker_init_fn``, ``main.py:156-183``);
    the odd constants keep nearby pairs apart."""
    mixed = (seed * 0x9E3779B1 + salt) * 0x85EBCA77 + idx
    return random.Random(mixed & 0xFFFFFFFFFFFFFFFF)


def choose_caption(caps: List[str], rng: random.Random,
                   is_train: bool) -> str:
    """One of the captions when training, the first in evaluation
    (reference ``semantic.py:505-508``)."""
    return rng.choice(caps) if (is_train and len(caps) > 1) else caps[0]


class SemanticDataset:
    """Image + label map -> FG-DM training dicts (``image`` the colourised
    map in [-1, 1], ``parts``, ``label``, ``label_ori``, ``caption``,
    ``path`` and, with ``use_rgb``, ``rgb``)."""

    def __init__(self, dataset_mode: str, image_size: int,
                 image_files: Sequence[str], class_files: Sequence[str],
                 captions: Optional[Dict[str, List[str]]] = None,
                 random_crop: bool = True, random_flip: bool = True,
                 is_train: bool = True, use_rgb: bool = False,
                 use_ade_colormap: bool = False, max_class_allowed: int = -1,
                 seed: int = 0):
        if len(image_files) != len(class_files):
            raise ValueError(f"{len(image_files)} images but "
                             f"{len(class_files)} label maps")
        self.mode = dataset_mode
        self.size = image_size
        self.images = list(image_files)
        self.classes = list(class_files)
        self.captions = captions or {}
        self.random_crop = random_crop
        self.random_flip = random_flip
        self.is_train = is_train
        self.use_rgb = use_rgb
        self.use_ade_colormap = use_ade_colormap
        self.max_class_allowed = max_class_allowed
        self.seed = seed

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, idx: int) -> Dict[str, Any]:
        return self.sample(idx)

    def sample(self, idx: int, salt: int = 0) -> Dict[str, Any]:
        rng = sample_rng(self.seed, idx, salt)
        path = self.images[idx]
        img = Image.open(path).convert("RGB")
        label_img = Image.open(self.classes[idx])
        label_img = label_img.convert("RGB" if self.mode == "sample" else "L")

        if self.mode == "cityscapes":
            ai, al = resize_pair(img, label_img, self.size, keep_aspect=True)
        elif self.is_train and self.random_crop:
            ai, al = random_crop_pair(img, label_img, self.size, rng)
        else:
            ai, al = resize_pair(img, label_img, self.size)

        if self.random_flip and rng.random() < 0.5:
            ai = ai[:, ::-1].copy()
            al = al[:, ::-1].copy()

        out: Dict[str, Any] = {"path": path, "label_ori": al.copy()}
        al = al.astype(np.int64)
        if self.mode == "ade20k":
            al = al - 1
        parts = al.copy()
        if self.mode == "ade20k":
            parts[parts == 255] = 150
        if self.mode == "coco":
            parts[parts == 255] = 182
        out["parts"] = parts
        out["label"] = al

        if self.mode == "sample":
            seg_rgb = np.array(label_img)  # the input map is colourised
        elif self.use_ade_colormap:
            seg_rgb = colorize(coco_to_ade_labels(al), ade_cmap())
        else:
            seg_rgb = colorize(al, color_map(max(int(al.max()) + 1, 1)))
        out["image"] = seg_rgb.astype(np.float32) / 127.5 - 1.0
        if self.use_rgb:
            out["rgb"] = ai.astype(np.float32) / 127.5 - 1.0
        out["caption"] = choose_caption(self.captions.get(path, [""]), rng,
                                        self.is_train)
        return out


def load_data(dataset_mode: str, data_dir: str, image_size: int,
              random_crop: bool = True, random_flip: bool = True,
              is_train: bool = True, **kwargs):
    """The dataset of a mode, by the reference's directory layout
    (``semantic.py:86-193``); ``pose`` is ``data/pose.py``'s."""
    if dataset_mode == "pose":
        from fgdm_tpu_torch.data.pose import load_pose_data

        return load_pose_data(data_dir, image_size, is_train=is_train,
                              random_crop=random_crop,
                              random_flip=random_flip, **kwargs)
    split_tv = "training" if is_train else "validation"
    captions = None
    if dataset_mode == "cityscapes":
        sub = "train" if is_train else "val"
        images = list_image_files(os.path.join(data_dir, "leftImg8bit", sub))
        labels = [f for f in list_image_files(
            os.path.join(data_dir, "gtFine", sub))
            if f.endswith("_labelIds.png")]
    elif dataset_mode in ("ade20k", "celeba"):
        images = list_image_files(os.path.join(data_dir, "images", split_tv))
        labels = list_image_files(os.path.join(data_dir, "annotations",
                                               split_tv))
    elif dataset_mode == "coco":
        split = "train2017" if is_train else "val2017"
        images = list_image_files(os.path.join(data_dir, "images", split))
        labels = list_image_files(os.path.join(data_dir, "annotations",
                                               split))
        captions = load_coco_captions(data_dir, is_train)
    elif dataset_mode == "sample":
        images = list_image_files(os.path.join(data_dir, "sample1"))
        labels = list_image_files(os.path.join(data_dir, "sample2"))
    else:
        raise NotImplementedError(dataset_mode)
    return SemanticDataset(dataset_mode, image_size, images, labels,
                           captions=captions, random_crop=random_crop,
                           random_flip=random_flip, is_train=is_train,
                           **kwargs)


def stack_items(items: Sequence[Dict[str, Any]], tokenizer=None
                ) -> Dict[str, Any]:
    """Samples -> one NHWC batch: ``image`` (and ``rgb``) float32,
    ``parts``, ``captions`` and, with a tokenizer, ``input_ids`` as numpy."""
    batch: Dict[str, Any] = {
        "image": np.stack([it["image"] for it in items]).astype(np.float32),
        "parts": np.stack([it["parts"] for it in items]),
    }
    if "rgb" in items[0]:
        batch["rgb"] = np.stack([it["rgb"] for it in items]).astype(
            np.float32)
    captions = [it["caption"] for it in items]
    if tokenizer is not None:
        batch["input_ids"] = np.asarray(tokenizer(captions))
    batch["captions"] = captions
    return batch


def batch_iterator(dataset, batch_size: int, tokenizer=None,
                   shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, epochs: Optional[int] = None
                   ) -> Iterator[Dict[str, Any]]:
    """NHWC numpy batches in one thread, shuffled by ``seed`` each epoch."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = np.arange(len(dataset))
        if shuffle:
            rng.shuffle(order)
        for start in range(0, len(order) - (batch_size - 1 if drop_last
                                            else 0), batch_size):
            idxs = order[start:start + batch_size]
            yield stack_items([dataset[int(i)] for i in idxs], tokenizer)
        epoch += 1
