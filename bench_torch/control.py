"""The control of a cell's comparison: the plain reference computed in the
precision below the configuration's (bfloat16 for its float32), put in the
program's place and compared with the float32 reference exactly as a run
compares the program. A sound comparison reads above its limit here.

On the card, at the cell's own sizes, the first item of each seed::

    python3 -m bench_torch.control --workload poisson-saturne.still --seeds 11 12 13

prints one JSON line a seed with the numbers, and the process exits 0 only
if every seed fails the comparison. The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

from bench_torch import harness

def control_numbers(cell, seed: int, device, dtype=torch.bfloat16) -> dict:
    """The control's numbers for the first item of a run with ``seed``."""
    driver = cell.driver()
    with tempfile.TemporaryDirectory(prefix="bench_torch_control_") as tmp:
        session = driver.plan(harness.Context(cell, torch.device(device), seed, Path(tmp)))
        return driver.control(session, 0, dtype)


def fails(cell, numbers: dict) -> bool:
    limits = cell.driver().LIMITS
    return any(numbers[k] > limits[k] for k in limits)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    cell = harness.find_cell(harness.load_bench(), args.workload)
    device = harness.require_cards(cell.chips)
    ok = True
    for seed in args.seeds:
        numbers = control_numbers(cell, seed, device)
        failed = fails(cell, numbers)
        ok &= failed
        print(json.dumps({"workload": cell.name, "seed": seed, "dtype": "bfloat16",
                          "numbers": numbers, "fails_comparison": failed}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
