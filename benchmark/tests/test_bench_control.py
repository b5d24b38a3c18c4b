"""The correctness check's control comes out not correct: the reference
with TF32 on (one precision step below the port's f32 with TF32 off), put
in the program's place, at each cell's own size, on three seeds
(harness/control.py). Needs a card:

    python -m pytest benchmark/tests/test_bench_control.py -q -s
"""
import json

import pytest

from harness import check, control, spec

pytestmark = pytest.mark.gpu

SEEDS = (2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell_name", ["sponza-4k-autotest",
                                       "stresstest-4k-autotest"])
def test_control_is_not_correct(cell_name, seed, card):
    cell = spec.cell(cell_name)
    worst = control.readings(cell, seed, card)
    ok, checks = check.verdict(worst, cell.limits)
    print(json.dumps({"cell": cell_name, "seed": seed, "control": checks}))
    assert not ok, checks
