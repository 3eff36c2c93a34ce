"""The checks' controls and planted faults, at a cell's own size.

    python3 -m bench_port.control --workload <cell> --seeds 1,2,3 \\
        [--faults]

For each seed, the numbers a run of the cell compares, read with the plain
float32 reference in the program's place computed in float8 (the control:
the precision below the bf16 the configurations state), and with
``--faults`` each fault the cell can have, planted in the reference put in
the program's place:

* chain, over a whole call of the cell's batch: one slot's answer
  altered where it is produced (its image and map taken from another
  slot), and half of the batch left out (the odd slots' maps and images
  given the even slots').
* training: half of the batch left out, the loss's mean taken over the
  rest.  A step that returns its state unchanged reads 1 by the change's
  measure and needs no run.

Prints one JSON line a reading.  The benchmark's runs never run this; the
limits in the entries were set between these readings and the program's.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from bench_port import gen, harness, weights


def chain_readings(cell, seed, device, faults: bool):
    from bench_port.entries import chain

    prompts, seeds = next(gen.chain_calls(cell.traffic, seed))
    ref = chain.reference_outputs(cell.config, seed, device, prompts, seeds)
    out = {"fp8": chain.compare(chain.reference_outputs(
        cell.config, seed, device, prompts, seeds, fp8=True), ref)}
    if faults:
        altered = {k: v.copy() for k, v in ref.items()}
        for v in altered.values():
            v[0] = v[1]
        out["answer_altered"] = chain.compare(altered, ref)
        even = {k: np.repeat(v[::2], 2, axis=0)[:len(v)]
                for k, v in ref.items()}
        out["half_batch"] = chain.compare(even, ref)
    return out


def train_readings(cell, seed, device, faults: bool):
    from bench_port.entries import train

    traffic = cell.traffic
    b, hw = traffic["batch"], traffic["image_hw"]
    g = torch.Generator(device=device).manual_seed(
        weights.model_seed(seed, len(train.MODELS)))
    draws = [train._draws(g, b, (hw[0] // 8, hw[1] // 8), device)
             for _ in range(train.CHECKED_STEPS)]
    ref = train.reference_steps(cell.config, traffic, seed, device, draws)

    def as_program(r):
        losses, g0, p0, p3, vlb0 = r
        return {"losses": losses, "g0": g0, "p0": p0, "p3": p3,
                "vlb0": vlb0}

    out = {"fp8": train.compare(as_program(train.reference_steps(
        cell.config, traffic, seed, device, draws, fp8=True)), ref)}
    if faults:
        out["half_batch"] = train.compare(as_program(train.reference_steps(
            cell.config, traffic, seed, device, draws, rows=b // 2)), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--faults", action="store_true")
    args = p.parse_args(argv)
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    read = {"chain": chain_readings,
            "train": train_readings}[cell.traffic["entry"]]
    for s in (int(x) for x in args.seeds.split(",")):
        r = read(cell, s, device, args.faults)
        print(json.dumps({"workload": args.workload, "seed": s, **r}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
