"""The port's bench (`eskf_lio_torch/bench.py`) against the JAX package's
`bench.py`, on the CPU at a small size.

* The workload definitions are the JAX bench's: `SCAN_RATE_HZ`, `HEAVY`,
  `LIGHT`, and the arguments `make_config` and `make_sequence` pass on,
  read from `bench.py` with `ast` (importing it would point JAX's
  persistent compilation cache at the repo for the whole worker).
* `run_series` against `bench.run_series` (run in a process of its own,
  JAX on the CPU) on a small config and a 65-scan sequence of the bench's
  kind: the same timed scans and convergence rate, trajectories within
  1e-2 m (`test_torch_replay.py`'s bound for the same f32 recursion
  compiled two ways), and ATEs within the RMS distance of the two
  trajectories plus the rounding of both to 0.01 cm: with a rigid
  alignment, |ATE(a) - ATE(b)| ≤ RMS(a - b).
* `main` on small series: four lines, each parsing and holding every key
  of the line before it, the last with every key of the JAX bench's last
  line and `device`; `--budget-s 0` stops after the light series with the
  JAX bench's note; `stage_breakdown` stops where the budget runs out and
  names the last stage it timed (`skipped_after`); without `--device cpu`
  on a host without CUDA `main` raises.
* `run_reference_filter` builds the filter under `build/native/` and
  writes nothing into `native/` (on a copy of the tree); a failed run of
  the filter is named as such in `baseline_source`, never as a missing
  toolchain; a native build's name changes with the compiler and the host.
"""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eskf_lio_torch import bench
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.pipeline import replay
from eskf_lio_tpu import config as j_config

torch.set_num_threads(2)
# the launches of every kernel of the port counted by a CPU run: none
NO_LAUNCHES = dict.fromkeys(
    ("gn_normal_eq", "gn_pass", "segscan", "preprocess", "imu_prefix"), 0)

ROOT = Path(__file__).resolve().parents[1]
JAX_BENCH = ROOT / "bench.py"
# tests/test_replay.py's capacities with the bench's filter noise; 6.6 s of
# the bench's sequence at 8,000 points a sweep: 65 scans, 64 rows
SMALL = dict(translation_noise=1e-3, rotation_noise=3e-4, max_raw_points=8192,
             max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=16)
SMALL_POINTS = 8000
SMALL_DURATION_S = 6.6
TRAJECTORY_TOL_M = 1e-2


def small_config() -> Config:
    return Config(imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), **SMALL)


@pytest.fixture(scope="module")
def small_seq():
    return bench.make_sequence(SMALL_POINTS, duration=SMALL_DURATION_S)


def jax_bench_namespace(names, **env) -> dict:
    """The module-level assignments and functions `names` of `bench.py`,
    executed from its syntax tree in a namespace holding `env`."""
    tree = ast.parse(JAX_BENCH.read_text())
    nodes = [
        n for n in tree.body
        if (isinstance(n, ast.FunctionDef) and n.name in names)
        or (isinstance(n, ast.Assign) and any(getattr(t, "id", None) in names for t in n.targets))
    ]
    ns = dict(env)
    exec(compile(ast.Module(body=nodes, type_ignores=[]), str(JAX_BENCH), "exec"), ns)
    missing = [n for n in names if n not in ns]
    assert not missing, f"bench.py has no {missing}"
    return ns


def test_workloads_are_the_jax_benchs():
    ns = jax_bench_namespace(["SCAN_RATE_HZ", "HEAVY", "LIGHT"])
    assert bench.SCAN_RATE_HZ == ns["SCAN_RATE_HZ"]
    assert bench.HEAVY == ns["HEAVY"]
    assert bench.LIGHT == ns["LIGHT"]


@pytest.mark.parametrize("spec", ["HEAVY", "LIGHT"])
@pytest.mark.parametrize("gn_backend", [None, "einsum"])
def test_make_config_is_the_jax_benchs(spec, gn_backend, monkeypatch):
    if gn_backend is None:
        monkeypatch.delenv("ESKF_GN_BACKEND", raising=False)
    else:
        monkeypatch.setenv("ESKF_GN_BACKEND", gn_backend)
    ns = jax_bench_namespace(["make_config"], Config=j_config.Config,
                             ImuConfig=j_config.ImuConfig, os=os)
    w = getattr(bench, spec)
    j = ns["make_config"](w["max_raw_points"], w["max_scan_points"])
    t = bench.make_config(w["max_raw_points"], w["max_scan_points"])
    # the port's own map setting, at its default, is the JAX package's layout
    own = {"map_key_bits": (10, 10, 10)}
    t_fields = dataclasses.asdict(t)
    assert {k: t_fields.pop(k) for k in own} == own
    assert t_fields == dataclasses.asdict(j)
    if spec == "HEAVY":
        # the other drivers of HEAVY keep the Config's own backend
        assert bench.heavy_config() == dataclasses.replace(t, gn_backend=Config.gn_backend)


class _Recorder:
    """Stands in for `dataset`: records the arguments of the sequence."""

    Sequence = object  # `bench.py`'s return annotation

    def __init__(self):
        self.calls = []

    def make_synthetic_sequence(self, **kw):
        self.calls.append({k: np.asarray(v).tolist() for k, v in kw.items()})


def test_make_sequence_is_the_jax_benchs(monkeypatch):
    rec_j, rec_t = _Recorder(), _Recorder()
    ns = jax_bench_namespace(["make_sequence"], dataset=rec_j, np=np)
    monkeypatch.setattr(bench, "dataset", rec_t)
    for points in (bench.HEAVY["points_per_scan"], bench.LIGHT["points_per_scan"]):
        ns["make_sequence"](points)
        bench.make_sequence(points)
    assert rec_t.calls == rec_j.calls and len(rec_t.calls) == 2
    # cut in duration only: n scans
    bench.bench_sequence(40)
    cut = dict(rec_t.calls[-1])
    assert round(cut.pop("duration") * 10) - 1 == 40
    assert cut == {k: v for k, v in rec_j.calls[0].items() if k != "duration"}


JAX_SERIES = """
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import bench
from eskf_lio_tpu.config import Config, ImuConfig
cfg = Config(imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), **json.loads(sys.argv[2]))
seq = bench.dataset.make_synthetic_sequence(**json.loads(sys.argv[3]))
res = bench.run_series(cfg, seq)
res.pop("_probe")
np.save(sys.argv[4], res.pop("_est_positions"))
print(json.dumps(res))
"""


def test_run_series_matches_the_jax_bench(small_seq, tmp_path, monkeypatch):
    # the arguments of the sequence, as the port's make_sequence passes them
    rec = _Recorder()
    with monkeypatch.context() as m:
        m.setattr(bench, "dataset", rec)
        bench.make_sequence(SMALL_POINTS, duration=SMALL_DURATION_S)
    est_path = tmp_path / "est.npy"
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", JAX_SERIES, str(ROOT), json.dumps(SMALL), json.dumps(rec.calls[0]),
         str(est_path)],
        capture_output=True, text=True, timeout=600, cwd=tmp_path, env=env,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    j = json.loads(proc.stdout.strip().splitlines()[-1])
    j_est = np.load(est_path)

    t = bench.run_series(small_config(), small_seq, device="cpu")
    t.pop("_probe")
    t_est = t.pop("_est_positions")
    assert t["timed_scans"] == j["timed_scans"] == 32
    assert t["icp_convergence_rate"] == j["icp_convergence_rate"]
    assert t_est.shape == j_est.shape == (65, 3)
    apart = np.linalg.norm(t_est - j_est, axis=1)
    assert apart.max() < TRAJECTORY_TOL_M, f"max {apart.max():.4f} m"
    rms_cm = 100.0 * float(np.sqrt(np.mean(apart ** 2)))
    assert abs(t["ate_rmse_cm"] - j["ate_rmse_cm"]) <= rms_cm + 0.01
    # the plain paths count no kernel launch; the timed half's own counts
    assert t["launches"] == NO_LAUNCHES
    assert t["update_rows"] == 32 and t["gn_iterations"] >= 32
    assert set(j) <= set(t)


def jax_last_line_keys() -> set:
    """Every key the JAX bench's last line holds (phase 4 with both
    reference runs): the keys of `result` and of its `update` calls and
    item assignments in `main`."""
    tree = ast.parse(JAX_BENCH.read_text())
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    keys = set()
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", None) == "result":
            keys |= {k.value for k in node.value.keys}
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "update"
              and getattr(node.func.value, "id", None) == "result"):
            keys |= {k.arg for k in node.keywords}
        elif isinstance(node, ast.Subscript) and getattr(node.value, "id", None) == "result":
            if isinstance(node.slice, ast.Constant) and isinstance(node.ctx, ast.Store):
                keys.add(node.slice.value)
    return keys - {"note"}


def lines_of(capsys) -> list[dict]:
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines() if line.startswith("{")]


def test_main_on_small_series(small_seq, capsys, monkeypatch):
    monkeypatch.delenv("ESKF_BENCH_ONLY", raising=False)
    small = bench.Series(small_config(), small_seq, SMALL_POINTS, 50.0)
    assert bench.main(["--device", "cpu", "--budget-s", "600"],
                      series={"light": small, "heavy": small}) == 0
    lines = lines_of(capsys)
    assert [line["series"] for line in lines] == ["light", "heavy", "heavy", "heavy"]
    for before, after in zip(lines, lines[1:]):
        assert set(before) <= set(after)
    last = lines[-1]
    assert jax_last_line_keys() | {"device"} <= set(last), jax_last_line_keys() - set(last)
    assert last["metric"] == "lio_scans_per_sec_per_chip" and last["device"] == "cpu"
    assert last["value"] == last["heavy"]["scans_per_sec"] > 0
    assert last["workload"]["note"] == "a caller's series"
    stages = last["stages_ms"]
    assert set(stages) == {"predict", "preprocess", "align", "align_iters", "insert", "evict",
                           "full_step"}
    assert all(stages[k] > 0 for k in stages)
    assert last["baseline_source"].startswith("measured at bench time")
    assert last["heavy_ref"]["ref_ate_rmse_cm"] < 5.0
    assert last["light"]["vs_baseline_measured"] > 0


def test_main_with_no_budget_stops_after_the_light_series(small_seq, capsys, monkeypatch):
    monkeypatch.delenv("ESKF_BENCH_ONLY", raising=False)
    small = bench.Series(small_config(), small_seq, SMALL_POINTS, 50.0)
    assert bench.main(["--device", "cpu", "--budget-s", "0"], series={"light": small}) == 0
    lines = lines_of(capsys)
    assert len(lines) == 2 and lines[1]["note"] == "budget exhausted before heavy series"
    assert set(lines[0]) | {"note"} == set(lines[1])
    assert lines[0]["series"] == "light" and lines[0]["light"]["timed_scans"] == 32


@pytest.mark.parametrize("stages_in_budget", [0, 1])
def test_stage_breakdown_stops_when_the_budget_runs_out(small_seq, stages_in_budget):
    """The budget is read between stages: the stages timed before it ran
    out, then `skipped_after` naming the last of them."""
    config = small_config()
    packed = replay.pack_sequence(config, small_seq, max_scans=3, device="cpu")
    step, carry = bench.start_replay(torch.device("cpu"), config, packed[0])
    carry, *_ = bench.run_rows(step, carry, packed, slice(0, 1))
    chunks, scans = packed[1], packed[2]
    probe = dict(zip(("state", "voxmap", "prev_R", "prev_t"), carry),
                 chunk=type(chunks)(*(x[1] for x in chunks)),
                 scan=type(scans)(*(x[1] for x in scans)))
    left = iter([1.0] * stages_in_budget + [0.0] * 5)
    out = bench.stage_breakdown(config, probe, lambda: next(left), device="cpu")
    timed = ["predict", "preprocess"][: stages_in_budget + 1]
    assert list(out) == timed + ["skipped_after"]
    assert out["skipped_after"] == timed[-1] and all(out[k] > 0 for k in timed)


def test_main_without_a_card_raises(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench.main([])


REF_FILTER = """
import json
from eskf_lio_torch import bench
seq = bench.make_sequence(6000, duration=1.5)
print(json.dumps(bench.run_reference_filter(seq, seq.gt_positions)))
"""


def test_reference_filter_builds_under_build_and_leaves_native_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "eskf_lio_torch", root / "eskf_lio_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "native").mkdir()
    for name in ("Makefile", "ref_filter.cpp", "eskf_runtime.cpp"):
        shutil.copy(ROOT / "native" / name, root / "native")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # a CXX that cannot build it (as one set for another toolchain may lack
    # OpenMP): the port builds with the Makefile's g++
    env["CXX"] = "false"
    proc = subprocess.run([sys.executable, "-c", REF_FILTER], cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res is not None, "the reference filter did not build or run"
    assert res["ref_scans_per_sec"] > 0 and res["ate_vs_ref_cm"] < 5.0
    assert sorted(p.name for p in (root / "native").iterdir()) == [
        "Makefile", "eskf_runtime.cpp", "ref_filter.cpp"]
    built = [p.name for p in (root / "build" / "native").iterdir() if p.is_file()]
    assert any(name.startswith("ref_filter-") for name in built), built


def test_bench_is_in_the_import_scan():
    from eskf_lio_torch import bench as module

    path = Path(module.__file__).resolve()
    assert path == ROOT / "eskf_lio_torch" / "bench.py"
    assert path in sorted((ROOT / "eskf_lio_torch").rglob("*.py"))  # test_torch_package's scan
    tree = ast.parse(path.read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {m for m in imported if m.split(".")[0] in ("jax", "jaxlib", "eskf_lio_tpu")}


def test_a_failed_reference_run_is_not_labelled_no_toolchain(tmp_path, monkeypatch):
    failing = tmp_path / "ref_filter"
    failing.write_text("#!/bin/sh\necho 'illegal instruction' >&2\nexit 132\n")
    failing.chmod(0o755)
    seq = bench.make_sequence(1000, duration=0.3)
    monkeypatch.setattr(bench.native_runtime, "ref_filter_path", lambda: str(failing))
    ref, why_not = bench.reference(seq, seq.gt_positions)
    assert ref is None and why_not == "reference filter failed: exit 132 illegal instruction"
    monkeypatch.setattr(bench.native_runtime, "ref_filter_path", lambda: None)
    assert bench.reference(seq, seq.gt_positions) == (None, "no toolchain")


def test_native_builds_are_keyed_by_compiler_and_host(tmp_path, monkeypatch):
    """`build/` travels with a copy of the tree, and the Makefile builds
    with -march=native: a build's name holds the compiler's version and
    the host's CPU, so another host's binary is never taken."""
    from eskf_lio_torch.io import native_runtime as nr

    compilers = []
    for version in ("1.0", "2.0"):
        cc = tmp_path / f"cc-{version}"
        cc.write_text(f"#!/bin/sh\necho 'cc {version}'\n")
        cc.chmod(0o755)
        compilers.append(str(cc))
    name = [nr._built_path("ref_filter", nr._REF_FILTER_SOURCES, cc) for cc in compilers]
    assert name[0] != name[1]
    assert name[0] == nr._built_path("ref_filter", nr._REF_FILTER_SOURCES, compilers[0])
    monkeypatch.setattr(nr.platform, "machine", lambda: "another-cpu")
    assert nr._built_path("ref_filter", nr._REF_FILTER_SOURCES, compilers[0]) != name[0]
    # the library keeps the environment's compiler; the filter takes g++
    monkeypatch.setenv("CXX", compilers[1])
    assert nr._compiler(None) == compilers[1] and nr._compiler("g++") == "g++"
