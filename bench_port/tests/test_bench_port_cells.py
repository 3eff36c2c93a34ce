"""Whole runs of each cell on the CPU at tiny sizes: the run's line, and
``correct`` coming out false with the timed path broken underneath (the
look for a card skipped)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from bench_port import run as brun
from tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(tmp_path_factory.mktemp("bench"))


def _run(root, workload, seed=2 ** 31 + 99):
    args = brun.parse(["--workload", workload, "--seed", str(seed),
                       "--seconds", "0.3", "--trace", "0"])
    return brun.run(args, device=torch.device("cpu"), chips_check=False,
                    root=root)


@pytest.mark.parametrize("workload,metric", [
    ("chain_offline_b8", "images_per_s"),
    ("train_adapter_b32", "train_images_per_s")])
def test_sound_run(root, workload, metric):
    out = _run(root, workload)
    assert out["correct"] is True
    assert set(out["metrics"]) == {metric, "setup_s"}
    assert out["metrics"][metric]["value"] > 0 and out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def _alter(monkeypatch, fault):
    from fgdm_tpu_torch.serving import ChainEngine

    real = ChainEngine.generate

    def generate(self, prompts, seed=0, seeds=None):
        if fault == "answer" or seeds is None:   # the warm-up call
            out = real(self, prompts, seed, seeds)
            if seeds is None:
                return out
            return {k: 255 - v for k, v in out.items()}
        out = real(self, prompts[::2], seed, seeds[::2])
        return {k: np.repeat(v, 2, axis=0)[:len(prompts)]
                for k, v in out.items()}

    monkeypatch.setattr(ChainEngine, "generate", generate)


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_chain_fault_is_not_correct(root, monkeypatch, fault):
    _alter(monkeypatch, fault)
    assert _run(root, "chain_offline_b8")["correct"] is False


def _break_step(monkeypatch, fault):
    from fgdm_tpu_torch.builders import Trainer

    real = Trainer.step_fn

    def step_fn(self, step):
        fn = real(self, step)

        def broken(state, batch, gen, t, noise, posterior_eps):
            if fault == "unchanged":
                keep = {k: p.detach().clone() for k, p in state.params.items()}
                state, m = fn(state, batch, gen, t=t, noise=noise,
                              posterior_eps=posterior_eps)
                with torch.no_grad():
                    for k, p in state.params.items():
                        p.copy_(keep[k])
                return state, m
            h = t.shape[0] // 2
            return fn(state, {k: v[:h] for k, v in batch.items()}, gen,
                      t=t[:h], noise=noise[:h], posterior_eps=posterior_eps[:h])

        return broken

    monkeypatch.setattr(Trainer, "step_fn", step_fn)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch"])
def test_train_fault_is_not_correct(root, monkeypatch, fault):
    _break_step(monkeypatch, fault)
    assert _run(root, "train_adapter_b32")["correct"] is False
