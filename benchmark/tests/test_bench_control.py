"""The control on the card, at a size a test run holds: the plain
reference computed with TF32 matrix products, put in the program's place,
fails each cell's limits, and reads more than the program on every number
compared.  At the cells' own sizes the same readings come from
`benchmark/control.py` (PERF.md gives them)."""

import json

import pytest

from benchmark import compare, harness
from benchmark.drivers import live, replay
from benchmark.tests import small


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mid360.replay", "mid360.live10hz"])
def test_the_tf32_control_is_not_correct(card, workload):
    limits = json.loads((harness.HERE / "limits" / f"{workload}.json").read_text())
    traffic = workload.split(".", 1)[1]
    driver = replay if traffic == "replay" else live
    for seed in (2**31 + 101, 2**31 + 202, 2**31 + 303):
        rec = driver.run(small.cell(traffic=traffic, limits=limits), seed, 2.0, False,
                         device=card, control=True)
        sound, low = rec["info"]["readings"], rec["info"]["control_readings"]
        ok, checks = compare.judge(low, limits)
        assert not ok, checks
        assert all(low[k] > sound[k] for k in limits), (sound, low)
