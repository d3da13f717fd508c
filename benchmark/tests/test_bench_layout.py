"""The benchmark's layout: every cell, configuration, mix, limit and
metric of `BENCHMARK.json` has its file, found by name; nothing the
harness loads imports JAX or the JAX package; the reference imports
nothing of the port."""

import json
import re
import subprocess
import sys

from benchmark import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_name_has_its_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        conf = json.loads((harness.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        assert sorted(conf["reduced"]) == sorted(c["reduced"])
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] == 1
        cell = harness.load_cell(w["name"])
        assert cell.mix["driver"] in ("replay", "live") and cell.limits
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "ate_cm"}
        assert cell.per_layer
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and callable(harness.reader(m["name"]))
    assert all(m["moves"] in {e["name"] for e in BENCH["end_to_end"]} for m in BENCH["per_layer"])


_PROBE = r"""
import sys, torch
sys.path.insert(0, {root!r})
torch.set_num_threads(2)
from benchmark import harness, check, compare, control, stages, roofline
from benchmark.tests import small
for traffic in ("replay", "live10hz"):
    c = small.cell(traffic=traffic)
    harness.driver(c).run(c, 7, 0.5, False, device="cpu")
for name in [m["name"] for m in {metrics}]:
    harness.reader(name)
print(" ".join(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = _PROBE.format(root=str(harness.ROOT), metrics=BENCH["end_to_end"] + BENCH["per_layer"])
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, check=True)
    top = set(out.stdout.split())
    assert "eskf_lio_torch" in top and "benchmark" in top
    assert not top & set(harness.FORBIDDEN), top & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.check, benchmark.compare;"
            "import benchmark.reference.step, benchmark.reference.pack;"
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))" % str(harness.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    top = set(out.stdout.split())
    assert not top & {"eskf_lio_torch", *harness.FORBIDDEN}
