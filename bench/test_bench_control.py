"""The control at each cell's own size on the card: the reference in fp8
put in the program's place (and, for a training cell, the step on half
the batch) must come out not correct, where the program on the same
seeds is. Needs the card; it runs ``bench/readings.py``'s loop, which
gives the same readings for more seeds."""

import json
from pathlib import Path

import pytest

from bench import checks, harness, readings

CELLS = [w["name"] for w in json.loads(
    (Path(__file__).resolve().parent.parent / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_where_the_program_passes(name):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control runs at the cell's own size")
    cell = harness.load_cell(name)

    def compared(numbers):  # the numbers the cell's limits hold
        return {k: v for k, v in numbers.items() if k in cell.limits}

    seeds = (2**31 + 101, 2**31 + 202, 2**31 + 303)
    for got in readings.readings(cell, seeds, set(seeds), torch.device("cuda", 0)):
        print(json.dumps(got), flush=True)
        assert checks.judge(compared(got["program"]), cell.limits)[0], got
        assert got["controls"]
        for what, numbers in got["controls"].items():
            assert not checks.judge(compared(numbers), cell.limits)[0], (got["seed"], what, numbers)
