"""The checks' controls at the cells' own sizes, on the card: the float32
reference put in the program's place and computed in float8, and each
planted fault, must each fail at least one of the cell's numbers.  Skips
without a CUDA card (decided inside each test).  Each reading is printed
as a JSON line (``-s`` shows them): PERF.md's limits were set from them."""

from __future__ import annotations

import json

import pytest
import torch

from bench_port import control, harness

SEEDS = (3000000041, 3000000042, 3000000043)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the controls run at the cells' "
                    "published sizes")
    return torch.device("cuda", 0)


def _fails(readings, limits):
    return any(readings[k] > limits[k] for k in limits)


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_chain_control_and_faults_fail(seed):
    from bench_port.entries import chain

    dev = _card()
    cell = harness.find_cell("chain_offline_b8")
    readings = control.chain_readings(cell, seed, dev, True)
    print(json.dumps({"cell": cell.name, "seed": seed, **readings}))
    for name, r in readings.items():
        assert _fails(r, chain.LIMITS), (name, r)


@pytest.mark.chip
@pytest.mark.parametrize("seed", SEEDS)
def test_train_control_and_faults_fail(seed):
    from bench_port.entries import train

    dev = _card()
    cell = harness.find_cell("train_adapter_b32")
    readings = control.train_readings(cell, seed, dev, True)
    print(json.dumps({"cell": cell.name, "seed": seed, **readings}))
    for name, r in readings.items():
        assert _fails(r, train.LIMITS), (name, r)
