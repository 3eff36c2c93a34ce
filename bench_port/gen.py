"""The general traffic generator: reads a traffic file's parameters and the
run's seed, and makes every input a run hands the program.

Everything is a function of ``(traffic, seed)``: the same seed gives the
same prompts, slot seeds and batches, whatever the run's length.  The
program gets only what these functions return.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from bench_port.reference.chain import tokenize

__all__ = ["rng_for", "prompt_pool", "chain_calls", "train_pool"]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream ``stream`` of a run seeded with
    ``seed`` (any integer, negative ones too)."""
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def prompt_pool(traffic: dict, seed: int) -> List[str]:
    """``traffic["prompt_pool"]`` prompts, each the template filled with
    one seeded choice from each of its word lists."""
    spec = traffic["prompt"]
    keys = [k for k in spec if k != "template"]
    rng = rng_for(seed, 1)
    return [spec["template"].format(**{k: spec[k][rng.integers(len(spec[k]))]
                                       for k in keys})
            for _ in range(traffic["prompt_pool"])]


def chain_calls(traffic: dict, seed: int
                ) -> Iterator[Tuple[List[str], List[int]]]:
    """Endless ``(prompts, slot seeds)`` of full engine calls: ``batch``
    prompts drawn from the pool, each with its own seed in [0, 2**63)."""
    pool = prompt_pool(traffic, seed)
    rng = rng_for(seed, 2)
    b = traffic["batch"]
    while True:
        idx = rng.integers(len(pool), size=b)
        seeds = rng.integers(0, 1 << 63, size=b, dtype=np.int64)
        yield [pool[i] for i in idx], [int(s) for s in seeds]


def _segmaps(rng, n: int, hw, grid, classes: int) -> np.ndarray:
    """``n`` colour-coded segmentation maps ``[n, H, W, 3]`` float32 in
    [-1, 1]: a seeded ``grid`` of labels, nearest-upsampled, each label
    its own seeded colour."""
    palette = rng.integers(0, 256, size=(classes, 3)).astype(np.float32)
    labels = rng.integers(classes, size=(n, grid[0], grid[1]))
    lab = labels.repeat(hw[0] // grid[0], axis=1).repeat(hw[1] // grid[1],
                                                         axis=2)
    return palette[lab] / 127.5 - 1.0


def train_pool(traffic: dict, seed: int) -> List[Dict[str, np.ndarray]]:
    """``pool_batches`` host batches as the data pipeline makes them:
    ``image`` float32 NHWC in [-1, 1] and ``input_ids`` int64 [B, 77]."""
    pool = prompt_pool(traffic, seed)
    rng = rng_for(seed, 3)
    b, hw = traffic["batch"], traffic["image_hw"]
    seg = traffic["segmap"]
    out = []
    for _ in range(traffic["pool_batches"]):
        caps = [pool[i] for i in rng.integers(len(pool), size=b)]
        out.append({"image": _segmaps(rng, b, hw, seg["grid"],
                                      seg["classes"]),
                    "input_ids": tokenize(caps).numpy()})
    return out

