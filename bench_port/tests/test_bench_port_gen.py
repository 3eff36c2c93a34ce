"""The traffic generator and the seeded weights: the same seed gives the
same inputs, and the reference's tokenizer gives the program's ids."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_port import gen, harness, weights
from bench_port.reference import chain as ref_chain
from bench_port.reference import models as ref_models

SEEDS = [0, 7, 2 ** 31 + 5, 2 ** 40 + 3, -12]


def _traffic(name):
    return json.loads((harness.PKG / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("seed", SEEDS)
def test_prompts_and_calls_repeat_for_a_seed(seed):
    t = _traffic("offline_b8")
    a, b = gen.chain_calls(t, seed), gen.chain_calls(t, seed)
    for _ in range(3):
        pa, sa = next(a)
        pb, sb = next(b)
        assert pa == pb and sa == sb
        assert len(pa) == t["batch"] and len(set(sa)) == t["batch"]
        assert all(0 <= s < 2 ** 63 for s in sa)
    assert gen.prompt_pool(t, seed) != gen.prompt_pool(t, seed + 1)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_batches_repeat_for_a_seed(seed):
    t = dict(_traffic("train_b32"), batch=4, pool_batches=2)
    a, b = gen.train_pool(t, seed), gen.train_pool(t, seed)
    for x, y in zip(a, b):
        assert np.array_equal(x["image"], y["image"])
        assert np.array_equal(x["input_ids"], y["input_ids"])
        assert x["image"].dtype == np.float32
        assert x["image"].min() >= -1 and x["image"].max() <= 1
    assert not np.array_equal(a[0]["image"], a[1]["image"])
    c = gen.train_pool(t, seed + 1)
    assert not np.array_equal(a[0]["image"], c[0]["image"])


def test_tokenizer_matches_the_programs():
    from fgdm_tpu_torch.models.clip import CLIPTokenizer

    texts = (gen.prompt_pool(_traffic("offline_b8"), 3)
             + [ref_chain.A_PROMPT, ref_chain.N_PROMPT, "",
                "a dog, running on the beach, best quality"])
    texts += [t + ", " + ref_chain.A_PROMPT for t in texts[:4]]
    assert torch.equal(ref_chain.tokenize(texts), CLIPTokenizer()(texts))


def test_slot_noise_matches_the_programs():
    from fgdm_tpu_torch.sampling.chain import factor_slot_seeds
    from fgdm_tpu_torch.sampling.ddim import SLOT_INIT_TAG, slot_noise

    seeds = [5, 2 ** 62 + 11]
    for factor in (1, 2):
        want = slot_noise(factor_slot_seeds(seeds, factor), (2, 4, 8, 8),
                          SLOT_INIT_TAG, torch.device("cpu"))
        got = torch.stack([ref_chain.slot_noise(s, factor, (4, 8, 8), "cpu")
                           for s in seeds])
        assert torch.equal(got, want)


def test_ddim_table_matches_the_programs():
    from fgdm_tpu_torch.core.schedules import DDIMSchedule, DiffusionSchedule

    sched = DDIMSchedule.create(DiffusionSchedule.create(
        timesteps=1000, linear_start=0.00085, linear_end=0.012), 50)
    ts, alphas, prev = ref_chain.ddim_table(ref_chain.ddpm_alphas_cumprod(),
                                            50)
    assert np.array_equal(ts, sched.timesteps.numpy())
    assert np.allclose(alphas, sched.alphas.numpy(), rtol=1e-6)
    assert np.allclose(prev, sched.alphas_prev.numpy(), rtol=1e-6)


@pytest.mark.parametrize("kind", ["unet_adapter", "unet", "control", "vae",
                                  "clip"])
def test_reference_keys_are_the_programs(kind):
    """The reference's modules carry the program's checkpoint schema, at
    the published widths (both built on the meta device)."""
    from fgdm_tpu_torch import builders

    cfg = json.loads((harness.PKG / "configs" /
                      "sd14_fgdm_seg_chain.json").read_text())
    dt = torch.bfloat16
    prog = {"unet_adapter": lambda: builders.build_unet_from_config(
                dt, **cfg["unet"]),
            "unet": lambda: builders.build_unet_from_config(
                dt, no_prompting=True, **cfg["unet"]),
            "control": lambda: builders.build_controlnet(dt, **cfg["control"]),
            "vae": lambda: builders.build_autoencoder(dt, **cfg["vae"]),
            "clip": lambda: builders.build_clip(dt)}[kind]().build("meta")
    with torch.device("meta"):
        ref = ref_models.build(kind, cfg)
    a = {k: tuple(v.shape) for k, v in prog.state_dict().items()}
    b = {k: tuple(v.shape) for k, v in ref.state_dict().items()}
    assert a == b


def test_weights_repeat_for_a_seed_and_follow_the_scheme():
    from tiny import tiny_chain

    cfg = tiny_chain()
    a = weights.draw_model("unet_adapter", cfg, 2 ** 33 + 1, 1, "cpu")
    b = weights.draw_model("unet_adapter", cfg, 2 ** 33 + 1, 1, "cpu")
    c = weights.draw_model("unet_adapter", cfg, 2 ** 33 + 2, 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["input_blocks.0.0.weight"],
                           c["input_blocks.0.0.weight"])
    # a zero-initialised head holds the perturbation alone; a norm's scale
    # sits at 1
    assert 0.015 < float(a["out.2.weight"].std()) < 0.025
    assert abs(float(a["out.0.weight"].mean()) - 1) < 0.02
    v = weights.draw_model("vae", cfg, 3, 2, "cpu")
    assert float(v["decoder.norm_out.bias"].abs().max()) == 0.0
    assert float(v["decoder.norm_out.weight"].min()) == 1.0
