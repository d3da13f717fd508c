"""The benchmark's harness: finds a cell's configuration, mix, driver,
limits and metric readers by the names in `BENCHMARK.json`, runs the
driver, reads the metrics and prints the result.

Everything that belongs to one configuration, mix or metric sits in a file
of its own: `configs/<config>.json`, `mixes/<traffic>.json` (whose
`driver` names a module of `drivers/`), `limits/<workload>.json` and
`metrics/<metric name>.py`, whose `read(run)` takes the driver's record
of the run and returns the metric's value, or None where the run holds
nothing to read.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "eskf_lio_tpu")


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict  # the configuration file
    mix: dict  # the mix file
    limits: dict  # gap name -> limit
    end_to_end: list[dict]
    per_layer: list[dict]
    chips: int


def load_cell(name: str, bench_path: Path = ROOT / "BENCHMARK.json") -> Cell:
    bench = json.loads(Path(bench_path).read_text())
    workloads = {w["name"]: w for w in bench["workloads"]}
    if name not in workloads:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(workloads)}")
    w = workloads[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
    mix = json.loads((HERE / "mixes" / f"{w['traffic']}.json").read_text())

    def mine(metrics):
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(w, config, mix, json.loads((HERE / "limits" / f"{name}.json").read_text()),
                mine(bench["end_to_end"]), mine(bench["per_layer"]), int(w["chips"]))


def reader(metric: str):
    """The `read` function of `metrics/<metric>.py`."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(run: dict, metrics: list[dict]) -> dict:
    out = {}
    for m in metrics:
        value = reader(m["name"])(run)
        if value is not None and math.isfinite(value):
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def driver(cell: Cell):
    return importlib.import_module(f"benchmark.drivers.{cell.mix['driver']}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def result_line(run: dict, cell: Cell, trace: bool, device_info: dict) -> dict:
    """The result's JSON object; `checks`, the numbers compared beside
    their limits, comes last."""
    metrics = read_metrics(run, cell.per_layer if trace else cell.end_to_end)
    line = {
        "correct": run["correct"],
        "attempted": run["attempted"],
        "failed": run["failed"],
        "metrics": metrics,
        "device": device_info,
    }
    if trace and run.get("breakdown"):
        line["breakdown"] = run["breakdown"]
    line["info"] = run.get("info", {})
    line["checks"] = {k: {n: (v if isinstance(v, (int, float)) and math.isfinite(v) else str(v))
                          for n, v in c.items()} for k, c in run["checks"].items()}
    return line
