"""The control at test size: the plain reference computed in bfloat16, put
in the program's place, fails every cell's comparison, which the float32
reference in the program's place passes."""

from __future__ import annotations

import pytest
import torch

from bench_torch import control, harness


@pytest.mark.parametrize("cell", ["poisson-saturne.still", "solar-sail.still",
                                  "poisson-saturne.rotation-png"])
@pytest.mark.parametrize("seed", [3, 2**31 + 5])
def test_control_fails_the_comparison(tiny, cell, seed):
    bench, root = tiny
    c = harness.find_cell(bench, cell, root / "bench_torch")
    numbers = control.control_numbers(c, seed, "cpu", torch.bfloat16)
    assert control.fails(c, numbers), numbers
    assert control.control_numbers(c, seed, "cpu", torch.float32) == dict.fromkeys(numbers, 0)
