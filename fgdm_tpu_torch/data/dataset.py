"""``list_image_files`` of ``fgdm_tpu/data/dataset.py:48-57`` (the
seg2image CLI's map listing).  The datasets and loaders of that module are
not ported (ROADMAP Queue A item 13)."""

from __future__ import annotations

import os
from typing import List

__all__ = ["IMG_EXTS", "list_image_files"]

IMG_EXTS = ("jpg", "jpeg", "png", "gif")


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
