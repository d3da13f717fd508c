"""The port's tools (`eskf_lio_torch/tools/`, the JAX package's
`tools/*.py`) on the CPU at small sizes, against the JAX package.

* Schema: each module's `main` runs at a small size (a few scans, narrow
  capacities, k of 2) and prints the JAX script's lines in their schema,
  then `{"device": "cpu"}`; without `--device cpu` on a host without CUDA
  it raises (no fallback to the CPU).
* Parity, the same numpy inputs through both packages:
  - `profile_preprocess`'s pieces: the stable sort's permutation, the
    gathers, the one-hot product and the row gather, and the view probe's
    rows, lanes and hits exact; `segment_sum` against the port's
    `index_add_`, the plain `segsum_sorted` (head rows), `plane_regularize`
    and the three axis passes within 1e-5 relative to the sum of the
    terms' absolute values (f32 sums of a few terms in another order).
  - `probe_align_parts`: `chol6_unrolled` against `linalg_solve6`, and
    both against the JAX script's `chol6_solve` and `jnp.linalg.solve`,
    within 1e-4 relative (an f32 6x6 solve); the plain GN sums against
    `gn_pallas.normal_equations_pallas_rotated` in interpret mode within
    1e-4 relative to the sum of the terms' absolute values (kernel A's
    tolerance).
  - `probe_adaptive`: each variant's GN iterations equal JAX `align`'s on
    the same warm map, scan and guess.
  - `ate_check` and `ate_matrix`'s `exact`: the port's trajectory within
    1e-2 m of the JAX replay's (`tests/test_torch_bench.py`'s bound for the
    same f32 recursion compiled two ways).
  - `bench_scaling_mesh`: each shard's slice and map rows equal the JAX
    `slice_capacity` and `hash_capacity // D`, D = 1, 2, 4.
"""

import ast
import contextlib
import dataclasses
import importlib
import io
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eskf_lio_torch import bench
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_torch.ops import gn_normal_eq
from eskf_lio_torch.tools import (ate_check, ate_matrix, bench_compile, bench_scaling_mesh,
                                  bench_shard, compile_bisect, light_stages, probe_adaptive,
                                  probe_align_parts, profile_preprocess)
from eskf_lio_tpu.config import Config as JConfig, ImuConfig as JImuConfig
from eskf_lio_tpu.io import dataset as j_dataset
from eskf_lio_tpu.map import voxel_map as j_vm
from eskf_lio_tpu.models import registration as j_reg
from eskf_lio_tpu.ops import eig3 as j_eig3, gn_pallas, preprocess as j_pre, segscan as j_seg
from eskf_lio_tpu.parallel import sharded_map as j_sh
from eskf_lio_tpu.pipeline import replay as j_replay
from eskf_lio_tpu.types import Pose as JPose, ProcessedScan as JScan

torch.set_num_threads(2)
# the launches of every kernel of the port counted by a CPU run: none
NO_LAUNCHES = dict.fromkeys(
    ("gn_normal_eq", "gn_pass", "segscan", "preprocess", "imu_prefix"), 0)

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
TOOLS = ("light_stages", "profile_preprocess", "probe_align_parts", "probe_adaptive",
         "ate_check", "ate_matrix", "bench_scaling_mesh", "bench_shard", "bench_compile",
         "compile_bisect")
# the bench's filter noise at test_torch_bench.py's capacities; 64 IMU
# samples a chunk, as `ate_check`'s config has, so one config serves both
SMALL = dict(translation_noise=1e-3, rotation_noise=3e-4, max_raw_points=8192,
             max_scan_points=4096, max_imu_per_scan=64, hash_capacity_log2=16)
POINTS = 6000
# ate_check's sweeps at the small capacities: with fewer points the two
# filters take another GN iteration count at some scan and part by cm
CHECK_POINTS = 12000
SERIES_S = 6.6  # 65 scans: the bench's least timed window
TRAJECTORY_TOL_M = 1e-2
SUM_TOL = 1e-5
SOLVE_TOL = 1e-4


def small_config() -> Config:
    return Config(imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), **SMALL)


def j_small_config(**change) -> JConfig:
    return JConfig(imu=JImuConfig(gravity=(0.0, 0.0, -9.81)), **SMALL, **change)


def printed(main, *args, **kwargs) -> list[str]:
    """The lines `main` prints, less the last, which must name the CPU."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(*args, **kwargs) == 0
    lines = buf.getvalue().splitlines()
    assert lines[-1] == json.dumps({"device": "cpu"})
    return lines[:-1]


def rel_to_terms(a, b, terms) -> float:
    """max |a - b| relative to the sum of the absolute terms."""
    a, b, terms = (np.asarray(x, np.float64) for x in (a, b, terms))
    return float((np.abs(a - b) / np.maximum(terms, 1e-30)).max())


@pytest.fixture(scope="module")
def bench_seq():
    return bench.make_sequence(POINTS, duration=SERIES_S)


@pytest.fixture(scope="module")
def j_replay_small():
    """The JAX replay's positions at the small config (one compile for the
    module's sequences)."""
    cfg = j_small_config()
    return lambda seq: j_replay.run_replay(cfg, seq)[0]


# ---------------------------------------------------------------------------
# every tool: the card by default
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", TOOLS)
def test_tool_without_a_card_raises(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    module = importlib.import_module(f"eskf_lio_torch.tools.{name}")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        module.main([])


def test_every_jax_tool_has_its_module():
    """The package's table names each JAX script beside its module, and
    every module is there."""
    from eskf_lio_torch import tools

    for name in TOOLS:
        assert f"`tools/{name}.py`" in tools.__doc__ and f"`{name}`" in tools.__doc__
        assert (ROOT / "tools" / f"{name}.py").exists()
        assert (ROOT / "eskf_lio_torch" / "tools" / f"{name}.py").exists()


@pytest.mark.parametrize("name", TOOLS)
def test_tool_imports_nothing_of_jax_the_root_bench_or_tools(name):
    path = ROOT / "eskf_lio_torch" / "tools" / f"{name}.py"
    tree = ast.parse(path.read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    imported |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    top = {m.split(".")[0] for m in imported}
    assert not top & {"jax", "jaxlib", "eskf_lio_tpu", "bench", "tools"}, imported


# ---------------------------------------------------------------------------
# light_stages
# ---------------------------------------------------------------------------


def jax_series_keys() -> set:
    """The keys of the dict the JAX bench's `run_series` returns."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run_series")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys} - {"_probe", "_est_positions"}


def test_light_stages_prints_the_series_and_its_stages(bench_seq):
    lines = printed(light_stages.main, ["--device", "cpu"],
                    series=bench.Series(small_config(), bench_seq, POINTS, 50.0))
    series, stages = (json.loads(line) for line in lines)
    assert jax_series_keys() <= set(series)
    assert series["timed_scans"] == 32 and series["launches"] == NO_LAUNCHES
    assert set(stages) == {"light_stages_ms"}
    st = stages["light_stages_ms"]
    assert set(st) == {"predict", "preprocess", "align", "align_iters", "insert", "evict",
                       "full_step"}
    assert all(v > 0 for v in st.values())


# ---------------------------------------------------------------------------
# profile_preprocess
# ---------------------------------------------------------------------------

PP = dict(n_raw=4096, kcap=1024, c_log2=12)


@pytest.fixture(scope="module")
def pp_inputs():
    return profile_preprocess.make_inputs(PP["n_raw"], PP["kcap"], PP["c_log2"], CPU)


def test_profile_preprocess_lines():
    lines = printed(profile_preprocess.main, ["--device", "cpu"], **PP, k=2, k_full=2)
    names = []
    for line in lines:
        m = re.match(r"^(.{28}) +(\S+) ms  \(raw (\S+) ms\)(  port: .*)?$", line)
        assert m, line
        assert float(m.group(2)) >= 0 and float(m.group(3)) > 0
        names.append(m.group(1).rstrip())
    assert names == [
        "sort2 @4k", "gather q[perm] [4k,3]", "gather [4k,14]", "gather [4k->1k,14]",
        "segment_sum [4k,10]", "segscan kernel [4k,10]", "one-hot deskew matmul",
        "deskew row gather [4k]", "sort2 @1k", "gather [1k,10]", "plane_regularize [1k]",
        "axis_pass z [1k,10]", "axis_pass y [1k,10]", "axis_pass x [1k,10]",
        "view probe [1k] @C=2^12", "preprocess FULL", "downsample+cov FULL",
        "preprocess FULL plain", "downsample+cov FULL plain"]


def np_of(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def test_profile_preprocess_sorts_and_gathers_are_the_jax_ones(pp_inputs):
    inp = pp_inputs
    pieces = {p.name: p.fn for p in profile_preprocess.pieces(inp)}
    n, kcap = PP["n_raw"], PP["kcap"]
    for key, name in ((inp["packed"], "sort2 @4k"), (inp["packed_k"], "sort2 @1k")):
        s, perm = pieces[name]()
        js, jperm = jax.lax.sort((jnp.asarray(np_of(key)), jnp.arange(key.shape[0], dtype=jnp.int32)),
                                 num_keys=1, is_stable=True)
        np.testing.assert_array_equal(np_of(s), np.asarray(js))
        np.testing.assert_array_equal(np_of(perm), np.asarray(jperm))
    q, raw14, perm = (np_of(inp[k]) for k in ("q", "raw14", "perm"))
    jq, jraw, jperm = jnp.asarray(q), jnp.asarray(raw14), jnp.asarray(perm.astype(np.int32))
    np.testing.assert_array_equal(np_of(pieces["gather q[perm] [4k,3]"]()), np.asarray(jq[jperm]))
    np.testing.assert_array_equal(np_of(pieces["gather [4k,14]"]()), np.asarray(jraw[jperm]))
    np.testing.assert_array_equal(np_of(pieces["gather [4k->1k,14]"]()),
                                  np.asarray(jraw[jperm[:kcap]]))
    m10, permk = np_of(inp["m10"]), np_of(inp["permk"]).astype(np.int32)
    np.testing.assert_array_equal(np_of(pieces["gather [1k,10]"]()),
                                  np.asarray(jnp.asarray(m10)[jnp.asarray(permk)]))
    # the one-hot product (the JAX package's) and the row gather (the port's)
    idx = jnp.asarray(np_of(inp["state_idx"]).astype(np.int32))
    j_oh = jnp.einsum("nm,mk->nk", jax.nn.one_hot(idx, profile_preprocess.N_STATES,
                                                  dtype=jnp.float32),
                      jnp.asarray(np_of(inp["table"])))
    np.testing.assert_array_equal(np_of(pieces["one-hot deskew matmul"]()), np.asarray(j_oh))
    np.testing.assert_array_equal(np_of(pieces["deskew row gather [4k]"]()), np.asarray(j_oh))
    assert n == q.shape[0]


def test_profile_preprocess_sums_are_the_jax_ones(pp_inputs):
    inp = dict(pp_inputs)
    rng = np.random.default_rng(5)
    A = rng.normal(size=(PP["kcap"], 3, 3)) * [0.3, 0.2, 0.05]
    covs = (A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3)).astype(np.float32)
    inp["covs33"] = torch.as_tensor(covs)  # spread eigenvalues: one plane normal
    pieces = {p.name: p.fn for p in profile_preprocess.pieces(inp)}
    n = PP["n_raw"]
    vals, seg = np_of(inp["vals10"]), np_of(inp["seg"])
    j_sum = jax.ops.segment_sum(jnp.asarray(vals), jnp.asarray(seg.astype(np.int32)),
                                num_segments=n)
    terms = jax.ops.segment_sum(jnp.abs(jnp.asarray(vals)), jnp.asarray(seg.astype(np.int32)),
                                num_segments=n)
    assert rel_to_terms(np_of(pieces["segment_sum [4k,10]"]()), j_sum, terms) <= SUM_TOL

    keys = np_of(inp["skey_sorted"])
    j_keys, j_vals = jnp.asarray(keys), jnp.asarray(vals)
    head = np.ones(n, bool)
    head[1:] = keys[1:] != keys[:-1]
    out = np_of(pieces["segscan kernel [4k,10]"]())[head]
    j_out = np.asarray(j_seg.segsum_sorted(j_keys, j_vals, interpret=True))[head]
    j_terms = np.asarray(j_seg.segsum_sorted_ref(j_keys, jnp.abs(j_vals)))[head]
    assert rel_to_terms(out, j_out, j_terms) <= SUM_TOL

    # I - (1 - f) n nᵀ: terms of magnitude 1 and |n nᵀ|
    reg = np_of(pieces["plane_regularize [1k]"]())
    j_reg_ = np.asarray(j_eig3.plane_regularize(jnp.asarray(covs), 1e-2))
    assert rel_to_terms(reg, j_reg_, 1.0 + np.abs(j_reg_)) <= SUM_TOL

    for axis in ("z", "y", "x"):
        rkey, m, d = (np_of(x) for x in inp["axis_in"][axis])
        j_out = j_pre._axis_pass(jnp.asarray(rkey), jnp.asarray(m), jnp.asarray(d))
        # three rows of moments shifted and summed: their absolute values bound the terms
        terms = 3.0 * np.abs(np.asarray(j_out)) + np.abs(m).max() * (1 + np.abs(d).max()) ** 2
        out = np_of(pieces[f"axis_pass {axis} [1k,10]"]())
        assert rel_to_terms(out, j_out, terms) <= SUM_TOL


def test_profile_preprocess_view_probe_is_the_jax_one(pp_inputs):
    """On a map holding half the queried voxels (the script probes an empty
    one): the same view, and the same payload rows, lanes and hits."""
    inp = dict(pp_inputs)
    kcap = PP["kcap"]
    rng = np.random.default_rng(7)
    pts = np_of(inp["pts"])[: kcap // 2] + rng.normal(size=(kcap // 2, 3)).astype(np.float32) * 0.01
    covp = np.tile(np.array([0.01, 0, 0, 0.01, 0, 0.01], np.float32), (kcap // 2, 1))
    kw = dict(voxel_size=0.3, max_points_per_voxel=1000)
    c = 1 << PP["c_log2"]
    t_map, _ = t_vm.insert(t_vm.VoxelMap.create(c, device="cpu"), torch.as_tensor(pts),
                           torch.as_tensor(covp), torch.ones(kcap // 2, dtype=torch.bool), **kw)
    t_map, _ = t_vm.compact(t_map, max_points_per_voxel=1000)
    j_map, _ = j_vm.insert(j_vm.VoxelMap.create(c), jnp.asarray(pts), jnp.asarray(covp),
                           jnp.ones(kcap // 2, bool), **kw)
    j_map, _ = j_vm.compact(j_map, max_points_per_voxel=1000)
    np.testing.assert_array_equal(np_of(t_map.view), np.asarray(j_map.view))
    inp["view"] = t_map.view
    probe = next(p for p in profile_preprocess.pieces(inp) if p.name.startswith("view probe"))
    pay, row, lane, found = (np_of(x) for x in probe.fn())
    j_pay, j_row, j_lane, j_found = (np.asarray(x) for x in
                                     j_vm._view_probe(j_map.view, jnp.asarray(np_of(inp["skey_k"]))))
    np.testing.assert_array_equal(found, j_found)
    assert 0 < found.sum() < kcap
    np.testing.assert_array_equal(row[found], j_row[found])
    np.testing.assert_array_equal(lane[found], j_lane[found])
    np.testing.assert_array_equal(pay[found], j_pay[found])


# ---------------------------------------------------------------------------
# probe_align_parts
# ---------------------------------------------------------------------------


def jax_chol6_solve():
    """The JAX script's `chol6_solve`, executed from its syntax tree (the
    script imports the root bench, which would point JAX's compilation
    cache at the repo for the whole worker)."""
    path = ROOT / "tools" / "probe_align_parts.py"
    fn = next(n for n in ast.parse(path.read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "chol6_solve")
    ns = {"jnp": jnp}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["chol6_solve"]


def test_probe_align_parts_lines():
    lines = printed(probe_align_parts.main, ["--device", "cpu"], n=2048, k_solve=2,
                    k_transform=2, k_map=2, map_raw=8192, map_scan=4096)
    parts = [json.loads(line) for line in lines]
    assert [p["op"] for p in parts] == ["linalg_solve6", "chol6_unrolled", "se3_exp",
                                        "transform_points_2k", "lookup_two_tier_2k",
                                        "gn_pallas_2k"]
    for p in parts:
        assert {"op", "ms", "raw_ms", "k"} <= set(p) and p["k"] == 2
        assert p["ms"] >= 0 and p["raw_ms"] > 0


@pytest.mark.parametrize("seed", [None, 1, 2])
def test_probe_align_parts_solves_agree(seed):
    """The script's own system (`seed` None) and random SPD ones."""
    if seed is None:
        inp = probe_align_parts.make_inputs(256, CPU, 8192, 4096)
        A, b = inp["A0"], inp["b0"]
    else:
        rng = np.random.default_rng(seed)
        M = rng.standard_normal((6, 6)).astype(np.float32)
        A = torch.as_tensor(M @ M.T + np.eye(6, dtype=np.float32))
        b = torch.as_tensor(rng.standard_normal(6).astype(np.float32))
    x_lu, x_ch = probe_align_parts.linalg_solve6(A, b), probe_align_parts.chol6_solve(A, b)
    jA, jb = jnp.asarray(A.numpy()), jnp.asarray(b.numpy())
    j_lu, j_ch = np.asarray(jnp.linalg.solve(jA, jb)), np.asarray(jax_chol6_solve()(jA, jb))
    scale = np.abs(j_lu).max()
    for x in (x_ch.numpy(), x_lu.numpy(), j_ch):
        assert np.abs(x - j_lu).max() <= SOLVE_TOL * scale
    assert np.abs(x_ch.numpy() - j_ch).max() <= SOLVE_TOL * scale


def test_probe_align_parts_gn_sums_are_the_pallas_kernels():
    """Kernel A's plain version, which the `gn_pallas` part runs on CPU
    tensors, against the JAX package's Pallas kernel in interpret mode, on
    correspondences like the align loop's; and the part itself on the
    script's layout (each point its own map mean: JᵀWr is 0)."""
    rng = np.random.default_rng(3)
    n = 256

    def spd():
        A = rng.normal(size=(n, 3, 3)) * 0.3
        C = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(3)
        return C[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].astype(np.float32)

    pts = (rng.normal(size=(n, 3)) * 8).astype(np.float32)
    mu = (pts + rng.normal(size=(n, 3)) * 0.1).astype(np.float32)
    covs, covm = spd(), spd()
    mask = rng.random(n) < 0.7
    from eskf_lio_torch.ops import lie

    R = lie.so3_exp(torch.tensor([0.1, -0.2, 0.3]))
    for layout in ((pts, covs, mu, covm), (pts, covs, pts, covs)):
        p, cp, m, cm = layout
        targs = [torch.as_tensor(p), torch.as_tensor(cp), R, torch.as_tensor(m),
                 torch.as_tensor(cm), torch.as_tensor(mask)]
        if m is pts:  # the script's layout, through its part
            inp = probe_align_parts.make_inputs(n, CPU, 8192, 4096)
            inp.update(pts3=targs[0], cp=targs[1], R0=R, mask=targs[5])
            part = {op: fn for op, fn, _, _ in probe_align_parts.parts(inp)}
            JTJ, JTr, count = part[f"gn_pallas_{n // 1000}k"]()
        else:
            JTJ, JTr, count = gn_normal_eq.normal_equations_rotated(*targs)
        jJTJ, jJTr = gn_pallas.normal_equations_pallas_rotated(
            *(jnp.asarray(a) for a in (p, cp, R.numpy(), m, cm, mask)), interpret=True)
        terms = gn_normal_eq._closed_form_terms(*targs).abs().sum(0).numpy()
        full = np.asarray(gn_normal_eq._FULL)
        assert rel_to_terms(JTJ.numpy().reshape(-1), np.asarray(jJTJ).reshape(-1),
                            terms[full]) <= SOLVE_TOL
        assert rel_to_terms(JTr.numpy(), np.asarray(jJTr), terms[21:27]) <= SOLVE_TOL
        assert int(count) == int(mask.sum())


# ---------------------------------------------------------------------------
# probe_adaptive
# ---------------------------------------------------------------------------


def j_map_of(t_map) -> j_vm.VoxelMap:
    return j_vm.VoxelMap(**{f: jnp.asarray(np_of(getattr(t_map, f))) for f in t_vm.VoxelMap._fields})


def test_probe_adaptive_lines_and_iterations_are_jax_aligns():
    """Each variant's GN iterations on the port's warm map, scan and guess
    equal JAX `align`'s on the same arrays."""
    seq = bench.make_sequence(POINTS, duration=1.0)
    lines = printed(probe_adaptive.main, ["--device", "cpu"], config=small_config(), seq=seq, k=2)
    m = re.match(r"^warm map voxels: (\d+)$", lines[0])
    assert m and int(m.group(1)) > 0
    warm = json.loads(lines[1])["warm_up"]
    assert warm["launches"] == NO_LAUNCHES
    assert warm["update_rows"] == 8 and warm["gn_iterations"] >= 8
    variants = [json.loads(line) for line in lines[2:]]
    assert [v["variant"] for v in variants] == list(probe_adaptive.VARIANTS)
    assert all(set(v) == {"variant", "align_ms", "iterations"} and v["align_ms"] > 0
               for v in variants)

    probe = probe_adaptive.warm_probe(small_config(), seq, CPU)
    assert probe["voxels"] == int(m.group(1))
    j_map = j_map_of(probe["voxmap"])
    j_scan = JScan(*(jnp.asarray(np_of(x)) for x in probe["processed"]))
    j_guess = JPose(*(jnp.asarray(np_of(x)) for x in probe["guess"]))
    for v in variants:
        j_cfg = j_small_config(**probe_adaptive.VARIANTS[v["variant"]])
        res = j_reg.align(j_scan, j_map, j_guess, j_cfg)
        assert v["iterations"] == int(res.iterations), v


# ---------------------------------------------------------------------------
# ate_check and ate_matrix
# ---------------------------------------------------------------------------


def test_ate_check_lines_and_trajectory(j_replay_small):
    """At the bench's update noises: on the script's noiseless sequence the
    filter keeps the track (at its own, it loses it in both packages)."""
    argv = ["--device", "cpu", "--duration", "3", "--tn", "1e-3", "--rn", "3e-4"]
    caps = dict(max_raw_points=8192, max_scan_points=4096, hash_capacity_log2=16)
    lines = printed(ate_check.main, argv, points_per_scan=CHECK_POINTS, **caps)
    assert re.match(r"^ATE rmse: \S+ cm  max: \S+ cm  port: .*raw.* rmse \S+ cm$", lines[0])
    assert lines[1].startswith("per-scan |error| cm, scans 95..115:")
    assert lines[2].startswith("iters 95..115:")
    assert lines[3].startswith("gt speed at scans 20/60/100: [")

    # the config `main` made from the arguments is the small one
    config = ate_check.make_config(1e-3, 3e-4, **caps)
    assert config == small_config()
    kw = dict(duration=3.0, points_per_scan=CHECK_POINTS, seed=ate_check.SEED)
    out = ate_check.run(config, dataset.make_synthetic_sequence(**kw), CPU)
    j_pos = np.asarray(j_replay_small(j_dataset.make_synthetic_sequence(**kw)))
    assert out["positions"].shape == j_pos.shape
    assert np.linalg.norm(out["positions"] - j_pos, axis=1).max() < TRAJECTORY_TOL_M
    rmse = float(re.match(r"^ATE rmse: (\S+) cm", lines[0]).group(1))
    assert rmse == round(float(np.sqrt((out["err"] ** 2).mean())) * 100, 2)


def test_ate_matrix_lines_and_exact_trajectory(bench_seq, j_replay_small):
    lines = printed(ate_matrix.main, ["--device", "cpu", "exact"], heavy=small_config(),
                    light=small_config(), heavy_pps=POINTS, light_pps=POINTS,
                    duration=SERIES_S)
    (line,) = (json.loads(x) for x in lines)
    assert line["variant"] == "exact" and jax_series_keys() <= set(line)

    config, pps = ate_matrix.variants(small_config(), small_config(), POINTS, POINTS)["exact"]
    assert config.icp_rematch_threshold == 0.0 and pps == POINTS
    out, est = ate_matrix.series_line("exact", config, bench_seq, CPU)
    timing = ("scans_per_sec", "compile_s")
    assert {k: v for k, v in out.items() if k not in timing} == \
        {k: v for k, v in line.items() if k not in timing}
    # the JAX replay of the same sequence (the JAX bench's run_series
    # replays it in two halves)
    j_seq = j_dataset.make_synthetic_sequence(
        duration=SERIES_S, points_per_scan=POINTS, seed=11, imu_noise_gyro=4.9e-3,
        imu_noise_accel=0.0206, gyro_bias=np.array([0.002, -0.001, 0.0015]),
        accel_bias=np.array([0.02, -0.03, 0.01]))
    j_pos = np.asarray(j_replay_small(j_seq))[: len(est)]
    assert np.linalg.norm(est - j_pos, axis=1).max() < TRAJECTORY_TOL_M


def test_ate_matrix_variants_are_the_jax_scripts():
    heavy, light = small_config(), dataclasses.replace(small_config(), max_scan_points=2048)
    v = ate_matrix.variants(heavy, light, 100, 20)
    assert list(v) == list(ate_matrix.NAMES)
    assert v["base"] == (heavy, 100) and v["heavy20k"] == (heavy, 20)
    assert v["budget48k"] == (dataclasses.replace(heavy, max_scan_points=49152), 100)
    assert v["exact20k"] == (dataclasses.replace(heavy, icp_rematch_threshold=0.0), 20)
    assert v["light"] == (light, 20)
    with pytest.raises(SystemExit):
        ate_matrix.main(["--device", "cpu", "no-such-variant"])


# ---------------------------------------------------------------------------
# bench_scaling_mesh and bench_shard
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_dev", [1, 2, 4])
def test_bench_scaling_mesh_sizes_are_the_jax_ones(n_dev):
    t_cfg = bench_scaling_mesh.make_config()
    j_cfg = JConfig(imu=JImuConfig(gravity=(0.0, 0.0, -9.81)), max_raw_points=16384,
                    max_scan_points=8192, max_imu_per_scan=48, hash_capacity_log2=16)
    # the port's own map setting, at its default, is the JAX package's layout
    own = {"map_key_bits": (10, 10, 10)}
    t_fields = dataclasses.asdict(t_cfg)
    assert {k: t_fields.pop(k) for k in own} == own
    assert t_fields == dataclasses.asdict(j_cfg)
    assert bench_scaling_mesh.static_line(t_cfg, n_dev) == {
        "per_device_slice": j_sh.slice_capacity(j_cfg.max_scan_points, n_dev, j_cfg.shard_slack),
        "per_device_map_rows": j_cfg.hash_capacity // n_dev,
    }


def test_bench_scaling_mesh_lines():
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=POINTS, seed=3)
    lines = printed(bench_scaling_mesh.main, ["--device", "cpu", "2"], config=small_config(),
                    seq=seq, devices=(1, 2))
    for n_dev, line in zip((1, 2), (json.loads(x) for x in lines)):
        assert line["devices"] == n_dev and line["ms_per_scan"] > 0
        assert line["shards_on_one_device"] is True and line["scans"] == 2
        assert line["capture_s"] is None  # eager on the CPU
        assert {k: line[k] for k in ("per_device_slice", "per_device_map_rows")} == \
            bench_scaling_mesh.static_line(small_config(), n_dev)
        assert line["launches"] == NO_LAUNCHES
        assert line["gn_iterations"] >= 2
    assert len(lines) == 2


def test_bench_shard_lines():
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=POINTS, seed=11)
    lines = [json.loads(x) for x in printed(bench_shard.main, ["--device", "cpu", "2"],
                                            config=small_config(), seq=seq, n_warm=4)]
    assert [x["stage"] for x in lines] == ["plain_step", "sharded_step_mesh1", "sharding_overhead"]
    plain, mesh1 = lines[0]["ms_per_scan"], lines[1]["ms_per_scan"]
    assert plain > 0 and mesh1 > 0
    # from the unrounded times
    assert abs(lines[2]["overhead_pct"] - (mesh1 / plain - 1.0) * 100.0) < 0.2


# ---------------------------------------------------------------------------
# bench_compile and compile_bisect
# ---------------------------------------------------------------------------


def test_bench_compile_lines():
    cases = [(name, 1024, build) for name, _, build in bench_compile.CASES]
    lines = printed(bench_compile.main, ["--device", "cpu"], cases=cases, k_iters=2)
    assert lines[0].startswith("backend: cpu")
    names = []
    for line in lines[1:]:
        m = re.match(r"^(\S+) +N= *(\d+)  compile +(\S+)s   warm +(\S+) us/iter(  port: .*)?$", line)
        assert m, line
        assert int(m.group(2)) == 1024 and float(m.group(3)) >= 0 and float(m.group(4)) >= 0
        names.append(m.group(1))
    assert names == [name for name, _, _ in bench_compile.CASES]
    assert [n for _, n, _ in bench_compile.CASES][:4] == [32768] * 4


def test_bench_compile_cases_compute_the_jax_ops():
    """Each case's output against the JAX op of the JAX script's case."""
    n = 1024
    get = {name: build for name, _, (build, _) in bench_compile.CASES}
    s, perm, *cols = get["sort3"](n, CPU)()
    assert torch.equal(s, torch.arange(n, dtype=torch.int32))
    assert torch.equal(perm, torch.arange(n).flip(0)) and len(cols) == 2
    assert torch.equal(get["gather16"](n, CPU)(), torch.zeros((n, 16)))
    assert torch.equal(get["scatter_rows10"](n, CPU)(), torch.ones((n, 10)))
    view = get["scatter2d_slots"](n, CPU)().numpy()
    b = np.arange(n) % (n // 2)
    j_view = jnp.zeros((n // 2, 128), jnp.int32).at[
        jnp.asarray(b)[:, None], jnp.arange(12)[None, :]].set(1, mode="drop")
    np.testing.assert_array_equal(view, np.asarray(j_view))
    np.testing.assert_array_equal(get["cumsum"](n, CPU)().numpy(),
                                  np.asarray(jnp.cumsum(jnp.ones(n, jnp.int32))))
    # 32,768 queries, so a table twice as long
    big = 65536
    np.testing.assert_array_equal(
        get["searchsorted32k"](big, CPU)().numpy(),
        np.asarray(jnp.searchsorted(jnp.arange(big, dtype=jnp.int32),
                                    jnp.arange(32768, dtype=jnp.int32) * 2)))


def test_compile_bisect_lines():
    lines = printed(compile_bisect.main, ["--device", "cpu", "10", "11"], k=2)
    assert lines[0] == "backend: cpu"
    for c_log2, block in ((10, lines[1:7]), (11, lines[7:13])):
        c = 1 << c_log2
        assert block[0] == f"C = 2^{c_log2} = {c}  (delta {max(c // 8, 1024)})"
        names = []
        for line in block[1:]:
            m = re.match(r"^  (\S+) +first +(\S+)s  capture +(\S+)s  warm +(\S+) ms$", line)
            assert m, line
            assert all(float(m.group(i)) >= 0 for i in (2, 3, 4))
            names.append(m.group(1))
        assert names == ["scatter_slots[D]", "build_view[C]", "sort_perm[C+D]",
                         "fold_into_main", "insert"]
    assert len(lines) == 13
