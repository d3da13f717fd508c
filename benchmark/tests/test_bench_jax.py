"""The plain reference (`benchmark/reference/`, a frozen copy of the
port's step) held against the JAX package, the system the port was made
from, on the CPU at a small size: from the initial state and an empty map
through the init sweep and six update rows, one of which evicts voxels
(a threshold inside the room), the poses, GN iterations, velocity, error
covariance and map agree to float32 rounding grown over the rows.

The JAX side runs in a process of its own on the CPU (the benchmark's
processes never load JAX), and never where a card is present."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import harness

ROWS = 6  # update rows after the init sweep; row 5 evicts

_PROBE = r"""
import dataclasses, json, sys
sys.path.insert(0, {root!r})
import numpy as np, torch
import jax, jax.numpy as jnp
torch.set_num_threads(2)
from benchmark import check, compare
from benchmark.reference import pack, step
from benchmark.tests import small
from benchmark.traffic import generator
from eskf_lio_tpu import config as jc
from eskf_lio_tpu.map import voxel_map as j_vm
from eskf_lio_tpu.models import eskf as j_eskf
from eskf_lio_tpu.pipeline import odometry as j_odo
from eskf_lio_tpu.types import ImuChunk as JChunk, Scan as JScan

cell = small.cell(traffic="replay")
fields = cell.config["config"]
fields.update(remove_distance_threshold=8.0, remove_period=0.5)
cpu = torch.device("cpu")
ref_config = check.reference_config(fields)
stream = generator.generate(cell.config["sensor"], cell.mix, cell.mix["stream_seed"], cpu,
                            lidar_quat_xyzw=fields["lidar_quat_xyzw"],
                            lidar_translation=fields["lidar_translation"])
names = {{f.name for f in dataclasses.fields(jc.Config)}}
jf = {{k: tuple(v) if isinstance(v, list) else v for k, v in fields.items() if k in names and k != "imu"}}
jcfg = jc.Config(imu=jc.ImuConfig(**{{k: tuple(v) if isinstance(v, list) else v
                                      for k, v in fields["imu"].items()}}), **jf)

# the reference, from scratch
init = pack.init_scan(stream, ref_config, cpu)
carry = step.init_carry(ref_config, init, cpu)
ref_step = step.make_step(ref_config, cpu)
rows = [pack.row(stream, k, ref_config, cpu, shifted=False) for k in range(1, {rows} + 1)]
evicts = [k % 5 == 0 for k in range(1, {rows} + 1)]
ref = []
with torch.no_grad():
    for (chunk, scan), ev in zip(rows, evicts):
        carry, diag = ref_step(carry, (chunk, scan, ev))
        ref.append((carry[3].numpy().copy(), int(diag["icp_iterations"]), int(diag["removed_voxels"])))
ref_state, ref_map = carry[0], carry[1]

# the JAX package, on the same inputs
jn = lambda x: jnp.asarray(x.numpy())
voxmap = j_vm.VoxelMap.create(jcfg.hash_capacity, jcfg.map_delta_capacity)
voxmap, _ = j_odo.make_init_step(jcfg)(voxmap, JScan(*(jn(x) for x in init)))
state, R, t = j_eskf.init_state(jcfg), jnp.eye(3), jnp.zeros(3)
scan_step = j_odo.make_scan_step(jcfg)
jax_out = []
for (chunk, scan), ev in zip(rows, evicts):
    state, voxmap, R, t, diag = scan_step(state, voxmap, R, t, JChunk(*(jn(x) for x in chunk)),
                                          JScan(*(jn(x) for x in scan)), jnp.asarray(ev))
    jax_out.append((np.asarray(t), int(diag["icp_iterations"]), int(diag["removed_voxels"])))

class M:
    def __init__(self, m):
        for f in ("skey", "payload", "d_skey", "d_payload"):
            setattr(self, f, torch.as_tensor(np.array(getattr(m, f))))

gaps = compare.map_gaps(M(voxmap), ref_map)
print(json.dumps({{
    "pose_gap_m": max(float(np.linalg.norm(a[0] - b[0])) for a, b in zip(jax_out, ref)),
    "iterations": [[a[1], b[1]] for a, b in zip(jax_out, ref)],
    "removed": [[a[2], b[2]] for a, b in zip(jax_out, ref)],
    "vel_gap_mps": float(np.linalg.norm(np.asarray(state.v) - ref_state.v.numpy())),
    "cov_gap": float(np.linalg.norm(np.asarray(state.P, np.float64) - ref_state.P.double().numpy())
                     / np.linalg.norm(ref_state.P.double().numpy())),
    **{{k: gaps[k] for k in ("map_count_gap", "map_mean_gap_m", "map_cov_gap", "map_cov_gap_median")}},
}}))
"""


def test_the_reference_is_the_jax_systems_step():
    if importlib.util.find_spec("jax") is None or torch.cuda.is_available():
        pytest.skip("runs the JAX package on the CPU: needs jax, and no card in the machine")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _PROBE.format(root=str(harness.ROOT), rows=ROWS)],
                         capture_output=True, text=True, timeout=900, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    r = json.loads(out.stdout.strip().splitlines()[-1])
    # the evicting row removes voxels on both sides, and the same number
    assert all(a == b for a, b in r["removed"]) and r["removed"][4][0] > 0, r["removed"]
    assert all(a == b for a, b in r["iterations"]), r["iterations"]
    assert r["pose_gap_m"] < 1e-3 and r["vel_gap_mps"] < 1e-2, r
    assert r["cov_gap"] < 1e-3, r
    assert r["map_count_gap"] < 1e-2 and r["map_mean_gap_m"] < 1e-3, r
    # a few near-isotropic voxels turn on the sums' last bits (PERF.md);
    # the per-voxel median does not
    assert r["map_cov_gap"] < 5e-2 and r["map_cov_gap_median"] < 1e-5, r
