"""Tiny configurations and a tiny copy of the benchmark's registry, for
driving whole runs on the CPU."""

from __future__ import annotations

import copy
import json
from pathlib import Path

from bench_port import harness

CONFIGS = harness.PKG / "configs"
TRAFFIC = harness.PKG / "traffic"


def _load(path: Path) -> dict:
    return json.loads(path.read_text())


def tiny_chain() -> dict:
    c = copy.deepcopy(_load(CONFIGS / "sd14_fgdm_seg_chain.json"))
    small = dict(model_channels=32, channel_mult=[1, 2],
                 attention_resolutions=[1], num_heads=2, num_res_blocks=1)
    c["dtype"] = "float32"
    c["env"] = {}
    c["unet"] = dict(c["unet"], **small)
    c["control"] = dict(c["control"], **small)
    c["vae"] = {"embed_dim": 4, "ddconfig": dict(
        c["vae"]["ddconfig"], ch=32, ch_mult=[1, 1, 1, 1], num_res_blocks=1)}
    c["sampler"] = dict(c["sampler"], f1_steps=2, f2_steps=2,
                        cond_hw=[64, 64], image_hw=[64, 64])
    return c


def tiny_train() -> dict:
    c = copy.deepcopy(_load(CONFIGS / "sd14_fgdm_adapter_train.json"))
    c["dtype"] = "float32"
    c["unet"] = dict(c["unet"], model_channels=32, channel_mult=[1, 2],
                     attention_resolutions=[1, 2], num_heads=2,
                     num_res_blocks=1)
    c["vae"] = {"embed_dim": 4, "ddconfig": dict(
        c["vae"]["ddconfig"], ch=32, ch_mult=[1, 1, 1, 1], num_res_blocks=1)}
    return c


def tiny_root(tmp: Path) -> Path:
    """A directory with a ``BENCHMARK.json`` naming the real cells over
    tiny configurations and small traffic."""
    bench = harness.load_benchmark()
    (tmp / "bench_port" / "traffic").mkdir(parents=True)
    files = {"sd14_fgdm_seg_chain": tiny_chain(),
             "sd14_fgdm_adapter_train": tiny_train()}
    for c in bench["configs"]:
        c["file"] = f"tiny_{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(files[c["name"]]))
    t = _load(TRAFFIC / "offline_b8.json")
    t["batch"] = 2
    (tmp / "bench_port/traffic/offline_b8.json").write_text(json.dumps(t))
    t = _load(TRAFFIC / "train_b32.json")
    t.update(batch=4, image_hw=[64, 64])
    (tmp / "bench_port/traffic/train_b32.json").write_text(json.dumps(t))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp
