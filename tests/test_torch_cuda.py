"""The port on the card: both CUDA kernels against their plain versions,
the replay through the kernels against the replay on the CPU, the voxel
map's `insert` through kernel B (the same bits twice; the CPU's words), and
the streaming driver's launch counts, the sharded driver (both kernels
at a shard's slice shapes; four shards on the one card, twice, bit for bit),
and the captured step: conditional nodes against Python control flow, the
graphed replay and the graphed sharded driver against the eager step bit for
bit (also under a one-process `nccl` group, whose all-reduces the graph
holds), and short rounds of the graph stress test (`utils/graph_stress.py`);
both kernels over inputs that end a registered host range
(`utils/kernel_bounds.py`); the bench's LIGHT series (`eskf_lio_torch/bench.py`);
the tracer's stage stamps inside the captured step (`utils/profiling.py`):
the same bits with and without them, their nodes and nothing else, in order
with one GN stamp a pass; the preprocessor's kernels (`csrc/preprocess.cu`)
against its plain version on the card, eagerly and captured, their launches,
and the nodes they take out of the captured step, and against the JAX
package's outputs on the same inputs (stored by
`tests/test_torch_preprocess.py`, whose CPU cases check the file).

Every test here needs an NVIDIA GPU: it carries the `cuda` marker and
skips (from inside its fixture) where `torch.cuda.is_available()` is
False.  The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`tests/conftest.py` configures JAX.)  Tolerances are relative to the sum
of the absolute values of the terms summed, 1e-4: both versions sum f32
terms in different orders, and nvcc contracts a*b+c into one FMA where
torch rounds twice.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import gn_normal_eq as gn
from eskf_lio_torch.ops import gn_pass
from eskf_lio_torch.ops import lie
from eskf_lio_torch.ops import preprocess as pre
from eskf_lio_torch.ops import segscan
from eskf_lio_torch.models import eskf
from eskf_lio_torch.pipeline import odometry, replay
from eskf_lio_torch.pipeline.odometry import Odometry
from eskf_lio_torch.types import ImuChunk, Pose, Scan, StateHistory
from eskf_lio_torch.utils import graphs

torch.set_num_threads(2)

pytestmark = pytest.mark.cuda
TOL = 1e-4


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def gn_args(n, seed, dev, hit_rate=0.7):
    rng = np.random.default_rng(seed)

    def spd():
        A = rng.normal(size=(n, 3, 3)) * 0.3
        C = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(3)
        return C[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]

    pts = rng.normal(size=(n, 3)) * 8.0
    arrays = (pts, spd(), pts + rng.normal(size=(n, 3)) * 0.1, spd())
    pts, covs, mu, covm = (torch.as_tensor(a.astype(np.float32), device=dev) for a in arrays)
    R = lie.so3_exp(torch.tensor([0.3, -0.2, 0.5], device=dev))
    mask = torch.as_tensor(rng.random(n) < hit_rate, device=dev)
    return pts, covs, R, mu, covm, mask


def gn_rel_err(args, a, b):
    scale = gn._closed_form_terms(*args).abs().sum(0)
    full = torch.tensor(gn._FULL, device=scale.device)
    scale = torch.cat([scale[full], scale[21:27]])
    diff = torch.cat([(a[0] - b[0]).reshape(-1), a[1] - b[1]]).abs()
    return (diff / scale.clamp(min=1e-30)).max().item()


# 8,192 rows: a shard's GN slice at D = 4 (`slice_capacity(16384, 4, 2.0)`)
@pytest.mark.parametrize("n", [1, 127, 129, 255, 1000, 8192, 16384, 100000])
def test_gn_kernel_matches_plain(dev, n):
    args = gn_args(n, n, dev)
    before = gn.KERNEL.launch_count()
    out = gn.normal_equations_rotated(*args)
    assert gn.KERNEL.launch_count() == before + 1
    assert gn_rel_err(args, out, gn.normal_equations_rotated_ref(*args)) <= TOL
    assert out[2].shape == () and int(out[2]) == int(args[5].sum())


def test_gn_kernel_reuses_its_scratch(dev):
    """Two calls share the kernel's scratch buffer (partial sums, ticket):
    the first result, cloned, and the second are both right, and the first
    result's own tensor is untouched by the second call."""
    args_a, args_b = gn_args(16384, 11, dev), gn_args(5000, 12, dev)
    first = gn.normal_equations_rotated(*args_a)
    kept = tuple(x.clone() for x in first)
    second = gn.normal_equations_rotated(*args_b)
    assert gn_rel_err(args_a, kept, gn.normal_equations_rotated_ref(*args_a)) <= TOL
    assert gn_rel_err(args_b, second, gn.normal_equations_rotated_ref(*args_b)) <= TOL
    assert all(torch.equal(x, y) for x, y in zip(first, kept))
    assert int(kept[2]) == int(args_a[5].sum()) and int(second[2]) == int(args_b[5].sum())


def test_gn_kernel_reads_r_through_its_strides(dev):
    pts, covs, R, mu, covm, mask = gn_args(1000, 13, dev)
    Rt = R.T.contiguous().T  # the same matrix, column-major
    assert not Rt.is_contiguous()
    a = gn.normal_equations_rotated(pts, covs, R.contiguous(), mu, covm, mask)
    b = gn.normal_equations_rotated(pts, covs, Rt, mu, covm, mask)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_gn_kernel_masked_rows_exactly_zero(dev):
    pts, covs, R, mu, covm, mask = gn_args(4096, 7, dev)
    good = gn.normal_equations_rotated(pts, covs, R, mu, torch.where(mask[:, None], covm, 1.0), mask)
    bad = gn.normal_equations_rotated(
        pts, covs, R, mu, torch.where(mask[:, None], covm, float("nan")), mask
    )
    assert all(torch.equal(g, b) for g, b in zip(good, bad))
    none = gn.normal_equations_rotated(pts, covs, R, mu, covm, torch.zeros_like(mask))
    assert (none[0] == 0).all() and (none[1] == 0).all() and none[2] == 0


def test_gn_kernel_is_deterministic(dev):
    args = gn_args(16384, 8, dev)
    a, b = gn.normal_equations_rotated(*args), gn.normal_equations_rotated(*args)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def seg_inputs(n, n_keys, dev, seed=3, w=10):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n_keys, size=n)).astype(np.int32)
    vals = rng.normal(size=(n, w)).astype(np.float32)
    return torch.as_tensor(keys, device=dev), torch.as_tensor(vals, device=dev)


@pytest.mark.parametrize(
    # (16384, 2500): a shard's insert slice at D = 4, W = 10
    "n,n_keys", [(131072, 12000), (131072, 1), (131072, 131072 * 8), (16384, 2500), (1000, 90),
                 (257, 3), (1, 1)]
)
def test_segscan_kernel_matches_plain(dev, n, n_keys):
    keys, vals = seg_inputs(n, n_keys, dev)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    before = segscan.KERNEL.launch_count()
    out = segscan.segsum_sorted(keys, vals)
    assert segscan.KERNEL.launch_count() == before + 1
    ref = segscan.segsum_sorted_ref(keys, vals)
    scale = segscan.segsum_sorted_ref(keys, vals.abs())
    assert ((out[head] - ref[head]).abs() <= TOL * scale[head]).all()
    assert torch.equal(segscan.segsum_sorted(keys, vals), out)  # deterministic


def straddling_keys(n, tail):
    """Sorted keys in runs of 300, 700 and 5,000 rows, so that segments
    straddle many 256-row tiles, ending like a real scan's padded rows: the
    last `tail` rows share the largest key."""
    lengths = np.resize(np.array([300, 700, 5000]), n // 300 + 1)
    keys = np.repeat(np.arange(len(lengths)), lengths)[:n].astype(np.int32)
    keys[n - tail:] = np.iinfo(np.int32).max
    return keys


@pytest.mark.parametrize("w", [1, 10, 16])
@pytest.mark.parametrize("n,tail", [(131072, 11072), (131072 - 37, 3000), (6001, 0)])
def test_segscan_kernel_runs_straddling_tiles(dev, n, tail, w):
    keys = torch.as_tensor(straddling_keys(n, tail), device=dev)
    vals = seg_inputs(n, 1, dev, seed=w, w=w)[1]
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    out = segscan.segsum_sorted(keys, vals)
    ref = segscan.segsum_sorted_ref(keys, vals)
    scale = segscan.segsum_sorted_ref(keys, vals.abs())
    assert ((out[head] - ref[head]).abs() <= TOL * scale[head]).all()
    assert torch.equal(segscan.segsum_sorted(keys, vals), out)  # deterministic


def test_segscan_kernel_every_row_is_the_suffix_sum(dev):
    """Beyond the head-row contract: every row holds the sum from itself to
    the end of its segment, across tile borders."""
    n = 4000
    keys = torch.as_tensor(straddling_keys(n, 0), device=dev)
    vals = torch.ones((n, 10), device=dev)
    out = segscan.segsum_sorted(keys, vals)
    k = keys.cpu().numpy()
    ends = np.searchsorted(k, k, side="right")
    expect = (ends - np.arange(n)).astype(np.float32)
    assert torch.equal(out.cpu(), torch.as_tensor(expect)[:, None].expand(n, 10))


def test_segscan_kernel_takes_an_unaligned_view(dev):
    """Rows that do not start on a 16-byte border take the scalar path."""
    keys, vals = seg_inputs(3001, 40, dev)
    out = segscan.segsum_sorted(keys[1:], vals[1:])
    assert vals[1:].data_ptr() % 16 != 0
    assert torch.equal(out, segscan.segsum_sorted(keys[1:].clone(), vals[1:].clone()))


@pytest.fixture(scope="module")
def kernel_bounds_run():
    """`python -m eskf_lio_torch.utils.kernel_bounds` once, in a process of
    its own (a fault ends its CUDA context): its exit code, its last line's
    JSON and its error output."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-m", "eskf_lio_torch.utils.kernel_bounds"],
                          cwd=Path(__file__).resolve().parents[1],
                          capture_output=True, text=True, timeout=300)
    lines = [l for l in proc.stdout.splitlines() if l.startswith("kernel_bounds ")]
    return proc.returncode, json.loads(lines[-1].split(" ", 1)[1]) if lines else None, proc.stderr


def test_segscan_kernel_reads_nothing_past_the_end_of_its_values(kernel_bounds_run):
    """`python -m eskf_lio_torch.utils.kernel_bounds`: kernel B over values
    in host memory registered for the device up to their last byte, at N a
    multiple of the tile rows.  The last tile of such an N has no row after
    it, and its halo warp loaded 32 (its 16-byte path): an illegal address
    there, and in device memory where the values end a mapped range, the
    eager sharded step's fault after long runs (ROADMAP.md, queue 3)."""
    rc, res, err = kernel_bounds_run
    assert rc == 0, err[-2000:]
    shapes = res["shapes"]
    assert [(s["n"], s["w"]) for s in shapes] == [
        (8192, 10), (16384, 10), (131072, 10), (24576, 10), (12288, 10), (49152, 10),
        (1024, 16), (16384, 1)]
    # tolerance: relative to the sum of absolute values, which is at most the
    # longest run's length (values in [0, 1), a key run over 40 % of the rows)
    assert all(s["max_abs_err"] <= TOL * 0.4 * s["n"] for s in shapes)


def test_gn_kernel_reads_nothing_past_the_end_of_its_rows(kernel_bounds_run):
    """The same module's kernel-A case: the four row arrays and the mask,
    each in host memory registered up to its last byte, at the main path's
    N = 16,384, LIGHT's 12,288, a shard's 8,192 and the 32,768 of
    `tools.probe_align_parts` (16-byte loads) and at two ragged N (the
    last chunk's 4-byte loads): no fault, and the sums within `TOL` of the
    plain version, relative to the sum of the terms' absolute values (the
    tolerance of `test_gn_kernel_matches_plain`)."""
    rc, res, err = kernel_bounds_run
    assert rc == 0, err[-2000:]
    assert [s["n"] for s in res["gn_shapes"]] == [16384, 12288, 8192, 32768, 8191, 1000]
    assert all(s["rel_err"] <= TOL for s in res["gn_shapes"])


def test_preprocess_kernels_read_nothing_past_the_end_of_their_inputs(kernel_bounds_run):
    """The same module's preprocessor case: every input of each of the six
    kernels (the raw scan, the state history, each sort's keys and
    permutation) in host memory registered up to its last byte, at N raw
    points and K scan points that are multiples of the 256-row blocks, with
    the deskew, without it (the init step) and with a budget that cannot
    overflow: no fault, and the outputs equal, bit for bit, those of the
    same call on device-resident inputs."""
    rc, res, err = kernel_bounds_run
    assert rc == 0, err[-2000:]
    assert [(s["n"], s["k"], s["path"]) for s in res["pre_shapes"]] == [
        (24576, 12288, "deskew"), (131072, 32768, "deskew"), (24576, 12288, "init"),
        (8192, 8192, "deskew")]
    assert all(s["equal"] for s in res["pre_shapes"])


def test_segscan_kernel_all_unique_is_identity(dev):
    vals = seg_inputs(5000, 1, dev)[1]
    keys = torch.arange(5000, dtype=torch.int32, device=dev)
    assert torch.equal(segscan.segsum_sorted(keys, vals), vals)


def test_replay_through_kernels_matches_cpu(dev):
    """A few scans of test_replay.py's config: the card (both kernels)
    and the CPU (plain versions) agree to 1e-2 m, the bound of that test
    for the same recursion computed two ways."""
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=16,
    )
    seq = dataset.make_synthetic_sequence(duration=1.5, points_per_scan=8000, seed=7)
    a0, b0 = gn.KERNEL.launch_count(), segscan.KERNEL.launch_count()
    pos_gpu, _, diags, _ = replay.run_replay(cfg, seq, device=dev)
    assert gn.KERNEL.launch_count() - a0 == int(diags["icp_iterations"].sum())
    # the downsampler and `insert`, on every update scan and on the init scan
    assert segscan.KERNEL.launch_count() - b0 == 2 * len(pos_gpu)
    pos_cpu, _, _, _ = replay.run_replay(cfg, seq, device="cpu")
    np.testing.assert_allclose(pos_gpu, pos_cpu, atol=1e-2)


def insert_batches(seed=0):
    """Three clouds as `insert` takes them: points, packed covariances and a
    validity mask with an invalid tail; the third overflows a 2,048-row delta."""
    rng = np.random.default_rng(seed)
    out = []
    for n, center in ((1500, (0, 0, 0)), (1500, (1, 0, 0)), (3000, (6, 2, 0))):
        pts = (rng.uniform(-5, 5, size=(n, 3)) + center).astype(np.float32)
        covs = np.tile(np.eye(3, dtype=np.float32) * 0.01, (n, 1, 1))
        covs += rng.uniform(0, 0.001, size=(n, 1, 1)).astype(np.float32)
        valid = np.ones(n, bool)
        valid[-50:] = False
        out.append((pts, covs[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]], valid))
    return out


def insert_all(device):
    m = vm.VoxelMap.create(1 << 12, device=device)
    for pts, covs, valid in insert_batches():
        m, _ = vm.insert(
            m, torch.as_tensor(pts, device=device), torch.as_tensor(covs, device=device),
            torch.as_tensor(valid, device=device), voxel_size=0.3, max_points_per_voxel=1000,
        )
    return m


def test_insert_on_the_card_is_deterministic(dev):
    """Per-voxel sums come from kernel B, not from float atomics: the same
    batches give the same map bit for bit."""
    b0 = segscan.KERNEL.launch_count()
    first, again = insert_all(dev), insert_all(dev)
    assert segscan.KERNEL.launch_count() - b0 == 6  # one launch per insert
    for name, x, y in zip(first._fields, first, again):
        assert torch.equal(x, y), name


def test_insert_on_the_card_matches_the_cpu(dev):
    """Integer words equal; payloads to 1e-5 relative (the kernel and the
    plain version group their f32 sums differently)."""
    gpu, cpu = insert_all(dev), insert_all("cpu")
    for name in ("origin", "skey", "d_skey"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    for name in ("payload", "d_payload"):
        np.testing.assert_allclose(
            getattr(gpu, name).cpu().numpy(), getattr(cpu, name).numpy(), rtol=1e-5, atol=1e-6
        )
    for name in ("view", "d_view"):
        a = getattr(gpu, name).cpu().numpy().reshape(-1, vm.VIEW_SLOT)
        b = getattr(cpu, name).numpy().reshape(-1, vm.VIEW_SLOT)
        words = np.r_[0:2, vm._SLOT_PAY:vm.VIEW_SLOT]
        np.testing.assert_array_equal(a[:, words], b[:, words])
        np.testing.assert_allclose(
            a[:, 2:vm._SLOT_PAY].view(np.float32), b[:, 2:vm._SLOT_PAY].view(np.float32),
            rtol=1e-5, atol=1e-6,
        )


def test_two_scan_odometry_launch_counts(dev):
    """The streaming driver on the card: init scan + one update scan launch
    kernel B four times (downsampler and insert, twice) and kernel A once per
    GN iteration."""
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), max_raw_points=8192,
        max_scan_points=4096, max_imu_per_scan=48, hash_capacity_log2=16,
    )
    seq = dataset.make_synthetic_sequence(duration=0.5, points_per_scan=8000, seed=7)
    odo = Odometry(cfg)  # the default device is the card
    assert odo.device.type == "cuda"
    a0, b0 = gn.KERNEL.launch_count(), segscan.KERNEL.launch_count()
    summary = odo.run(seq, max_scans=2)
    assert summary["num_scans"] == 2 and not summary["diverged"]
    assert segscan.KERNEL.launch_count() - b0 == 4
    assert gn.KERNEL.launch_count() - a0 == int(odo.diags[0]["icp_iterations"]) > 0
    assert odo.device_reads == 1 and np.isfinite(odo.positions).all()


def test_gn_kernel_takes_the_slices_of_a_stacked_scan(dev):
    """`align` hands kernel A row blocks of [L, S, ...] tensors: views at a
    non-zero offset give the bits of their own copies."""
    n_local, s = 4, 8192
    pts, covs, R, mu, covm, mask = gn_args(n_local * s, 21, dev)
    stacked = [x.reshape(n_local, s, *x.shape[1:]) for x in (pts, covs, mu, covm, mask)]
    for i in range(n_local):
        p, c, m, cm, k = (x[i] for x in stacked)
        a = gn.normal_equations_rotated(p, c, R, m, cm, k)
        b = gn.normal_equations_rotated(p.clone(), c.clone(), R, m.clone(), cm.clone(), k.clone())
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert gn_rel_err((p, c, R, m, cm, k), a,
                          gn.normal_equations_rotated_ref(p, c, R, m, cm, k)) <= TOL


def test_sharded_run_on_the_card_twice_equal_bits(dev):
    """Four shards on the one card: kernel A and the lookup kernel once per
    shard per GN iteration and the increment kernel once, kernel B once in
    the downsampler and once per shard in `insert`, every scan; two runs
    equal bit for bit; 2e-2 m from the single-device driver (the same sums
    in another order)."""
    from eskf_lio_torch.parallel.sharded_map import ShardedOdometry

    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=16,
    )
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=8000, seed=7)
    runs = []
    for _ in range(2):
        odo = ShardedOdometry(cfg, n_devices=4)  # the default device is the card
        assert odo.device.type == "cuda" and len(odo.voxmap.blocks) == 4
        a0, b0 = gn.KERNEL.launch_count(), segscan.KERNEL.launch_count()
        p0 = gn_pass.KERNEL.launch_count()
        summary = odo.run(seq, max_scans=6)
        assert summary["num_scans"] == 6 and not summary["diverged"]
        iters = sum(int(d["icp_iterations"]) for d in odo.diags)
        assert gn.KERNEL.launch_count() - a0 == 4 * iters > 0
        # L + 1 a GN pass: a lookup per local shard and one increment
        assert gn_pass.KERNEL.launch_count() - p0 == (4 + 1) * iters
        assert segscan.KERNEL.launch_count() - b0 == (1 + 4) * 6
        assert sum(int(d["gn_slice_overflow"]) + int(d["insert_slice_overflow"])
                   for d in odo.diags) == 0
        runs.append(odo)
    first, again = runs
    assert np.array_equal(first.positions, again.positions)
    assert np.array_equal(np.stack(first.trajectory_R), np.stack(again.trajectory_R))
    for name, x, y in zip(vm.VoxelMap._fields, first.voxmap, again.voxmap):
        assert torch.equal(x, y), name
    single = Odometry(cfg)
    single.run(seq, max_scans=6)
    np.testing.assert_allclose(first.positions, single.positions, atol=2e-2)


# ---------------------------------------------------------------------------
# the captured step (utils/graphs.py)
# ---------------------------------------------------------------------------


def test_captured_branches_and_loop_on_the_card(dev):
    """IF and WHILE nodes in a captured graph give the eager values, for
    both values of the predicate, replay after replay."""
    x = torch.zeros(1000, device=dev)
    flag = torch.zeros((), dtype=torch.bool, device=dev)
    stop = torch.zeros((), dtype=torch.int64, device=dev)
    out = (torch.zeros(1000, device=dev), torch.zeros((), dtype=torch.int64, device=dev))

    def step():
        y, n = graphs.device_if(flag, lambda: (torch.sort(x, descending=True)[0], stop * 2),
                                out, otherwise=lambda: (x + 1, stop))
        carry = (stop > 0, torch.zeros((), dtype=torch.int64, device=dev), y)
        _, k, z = graphs.device_while(
            lambda c: (c[1] + 1 < stop, c[1] + 1, c[2] * 1.01 + 1), carry, 100)
        out[0].copy_(z)
        out[1].copy_(k)

    graph = graphs.StepGraph(step, dev, segscan_rows=1024)
    for f, s in ((True, 3), (False, 0), (True, 17), (False, 5)):
        x.copy_(torch.randn(1000, device=dev))
        flag.fill_(f)
        stop.fill_(s)
        y = torch.sort(x, descending=True)[0] if f else x + 1
        for _ in range(s):
            y = y * 1.01 + 1
        graph()
        torch.cuda.synchronize()
        assert torch.equal(out[0], y) and int(out[1]) == s
    assert graph.nodes > 0 and graph.capture_s > 0


def test_graphed_scan_step_equals_the_eager_step_on_the_card(dev):
    """A few scans through `GraphedScanStep` and through `make_step_core`
    eagerly on the card: the same bits, and the kernels' launches counted on
    the device."""
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=14,
    )
    seq = dataset.make_synthetic_sequence(duration=1.5, points_per_scan=8000, seed=7)
    init_scan, chunks, scans, evicts, updates, _ = replay.pack_sequence(cfg, seq, device=dev)
    voxmap, _ = odometry.make_init_step(cfg, dev)(
        vm.VoxelMap.create(cfg.hash_capacity, cfg.map_delta_capacity, device=dev), init_scan)
    start = (eskf.init_state(cfg, dev), voxmap, torch.eye(3, device=dev),
             torch.zeros(3, device=dev))
    step = replay.make_replay_step(cfg, dev)
    for k in (gn.KERNEL, segscan.KERNEL):
        k.reset_launches()
    *g_carry, g_Rs, g_ts, g_diags = step(*start, chunks, scans, evicts, updates)
    torch.cuda.synchronize()
    n_upd = int(updates.sum())
    assert gn.KERNEL.launch_count() == int(g_diags["icp_iterations"].sum())
    assert segscan.KERNEL.launch_count() == 2 * n_upd
    core = odometry.make_step_core(cfg, dev)
    carry = start
    for b in range(chunks.dt.shape[0]):
        assert bool(updates[b])
        carry, diag = core(carry, (ImuChunk(*(x[b] for x in chunks)),
                                   type(init_scan)(*(x[b] for x in scans)), bool(evicts[b])))
        assert torch.equal(carry[2], g_Rs[b]) and torch.equal(carry[3], g_ts[b])
        assert int(diag["icp_iterations"]) == int(g_diags["icp_iterations"][b])
    for x, y in zip(carry[1], g_carry[1]):
        assert torch.equal(x, y)


def test_graphed_sharded_step_equals_the_eager_step_on_the_card(dev):
    """`ShardedOdometry(n_devices=4)` without a process group runs the
    captured sharded step: over 6 scans the same bits as the same driver on
    the eager sharded step, kernel A launched 4 x Σ GN iterations, the GN
    pass's kernels (4 + 1) x Σ GN iterations and kernel B 5 x scans, counted
    on the device inside the graphs; the map read after scan k is the map of
    scan k."""
    from eskf_lio_torch.parallel import sharded_map as smod

    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=16, remove_period=0.2,
        remove_distance_threshold=8.0,
    )
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=8000, seed=7)
    runs, maps = {}, {}
    for mode in ("graph", "eager"):
        odo = smod.ShardedOdometry(cfg, n_devices=4)
        assert odo.graphed and odo.step_reason.startswith("graph")
        assert isinstance(odo.scan_step, smod.GraphedShardedScanStep)
        if mode == "eager":
            odo.scan_step = smod.make_sharded_scan_step(cfg, odo.mesh)
        maps[mode] = []
        for k in (gn.KERNEL, gn_pass.KERNEL, segscan.KERNEL):
            k.reset_launches()
        summary = odo.run(seq, max_scans=6, on_scan=lambda o, m=maps[mode]: m.append(
            [x.clone() for x in o.voxmap.gather()]))
        assert summary["num_scans"] == 6 and not summary["diverged"]
        iters = sum(int(d["icp_iterations"]) for d in odo.diags)
        assert gn.KERNEL.launch_count() == 4 * iters > 0
        assert gn_pass.KERNEL.launch_count() == (4 + 1) * iters
        assert segscan.KERNEL.launch_count() == (1 + 4) * 6
        assert any(int(d["removed_voxels"]) > 0 for d in odo.diags)
        runs[mode] = odo
    graph, eager = runs["graph"], runs["eager"]
    assert np.array_equal(graph.positions, eager.positions)
    assert np.array_equal(np.stack(graph.trajectory_R), np.stack(eager.trajectory_R))
    for a, b in zip(graph.diags, eager.diags):
        assert {k: int(v) for k, v in a.items()} == {k: int(v) for k, v in b.items()}
    for k, (a, b) in enumerate(zip(maps["graph"], maps["eager"])):
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"the map after scan {k + 1}"
    assert not all(torch.equal(x, y) for x, y in zip(maps["graph"][-2], maps["graph"][-1]))


def test_a_capture_leaves_other_threads_free_to_read_values(dev):
    """A graph captured on one thread, held at its top level, while this
    thread launches a kernel, reads a value back and allocates a new
    segment.  In the global capture mode the read and the allocation failed
    ("operation not permitted when stream is capturing") and broke the other
    thread's capture; captures are thread-local now, so all three go on, and
    the graph then replays the eager values."""
    import threading

    x = torch.arange(1000.0, device=dev)
    out = torch.zeros(1000, device=dev)
    inside, release, failed = threading.Event(), threading.Event(), []

    def step():
        inside.set()
        release.wait(60)
        out.copy_(x * 2 + 1)

    graph = graphs.StepGraph(step, dev, segscan_rows=1024)

    def capture():
        try:
            graph.capture()
        except BaseException as exc:  # raised below, on the test's thread
            failed.append(exc)
        finally:
            inside.set()

    thread = threading.Thread(target=capture)
    thread.start()
    inside.wait(60)
    try:
        y = torch.arange(10.0, device=dev) * 3
        read = float(y.sum())
        fresh_sum = float(torch.ones(1 << 26, device=dev).sum())
    finally:
        release.set()
        thread.join(60)
    if failed:
        raise failed[0]
    assert read == 135.0 and fresh_sum == float(1 << 26)
    graph()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 2 + 1)


def test_a_graph_collected_inside_another_capture_outlives_it(dev):
    """A captured `StepGraph` left in a reference cycle whose last outside
    reference goes, and is collected, inside another graph's capture.
    Destroying a CUDA graph there was refused ("operation not permitted when
    stream is capturing", after its pool was released) and broke that
    capture (`utils/graph_stress.py`'s gc_in_capture mechanism, on the card);
    now it is kept until the capture ends and destroyed then."""
    import gc

    x = torch.arange(1000.0, device=dev)
    out = torch.zeros(1000, device=dev)
    old = graphs.StepGraph(lambda: out.copy_(x + 1), dev, segscan_rows=1024)
    old()
    loop = [old]
    loop.append(loop)
    held = [loop]
    del old, loop
    parked = graphs._CAPTURES["parked"]

    def step():
        held.clear()
        gc.collect()
        out.copy_(x * 3)

    new = graphs.StepGraph(step, dev, segscan_rows=1024)
    new()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 3)
    assert graphs._CAPTURES["parked"] == parked + 1 and not graphs._PARKED
    out.zero_()
    new()
    torch.cuda.synchronize()
    assert torch.equal(out, x * 3)


def test_graph_stress_rounds_on_the_card(dev):
    """Three short rounds of `python -m eskf_lio_torch.utils.graph_stress` at
    the small config, in a process of its own (as `chip_smoke.py` runs it):
    every mechanism of the default set, graph = eager bit for bit."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run(
        [sys.executable, "-m", "eskf_lio_torch.utils.graph_stress", "--config", "small",
         "--rounds", "3", "--scans", "4"],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("graph_stress ")][-1]
    res = json.loads(line.split(" ", 1)[1])["results"][0]
    assert res["rounds"] == 3 and res["scans_compared"] == 3 * 2 * 4
    # round 1 grows the capture scratch once for each of its two steps
    assert res["retired_scratch_buffers"] == 2


def _nccl_group_of_one():
    """A process group of this process alone on the card (`nccl`)."""
    import socket

    from eskf_lio_torch.parallel import distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    assert dist.initialize(f"127.0.0.1:{port}", 1, 0, timeout_s=60.0) == (1, 0)
    assert torch.distributed.get_backend() == "nccl"


def test_graphed_sharded_step_under_a_one_process_nccl_group(dev):
    """Under a process group of one process on the card (`nccl`),
    `ShardedOdometry(n_devices=4)` runs the captured sharded step, its
    all-reduces inside the graph (the 43 floats inside the GN loop's WHILE
    node): over 6 scans the same bits as the eager sharded step under the
    same group and as the captured step without a group (a one-process sum
    is the identity), kernel A launched 4 x Σ GN iterations and kernel B
    5 x scans, counted on the device."""
    from eskf_lio_torch.parallel import distributed as dist
    from eskf_lio_torch.parallel import sharded_map as smod

    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=16, remove_period=0.2,
        remove_distance_threshold=8.0,
    )
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=8000, seed=7)

    def run(eager=False):
        odo = smod.ShardedOdometry(cfg, n_devices=4)
        assert odo.graphed and isinstance(odo.scan_step, smod.GraphedShardedScanStep)
        if eager:
            odo.scan_step = smod.make_sharded_scan_step(cfg, odo.mesh)
        for k in (gn.KERNEL, segscan.KERNEL):
            k.reset_launches()
        odo.run(seq, max_scans=6)
        iters = sum(int(d["icp_iterations"]) for d in odo.diags)
        assert gn.KERNEL.launch_count() == 4 * iters > 0
        assert segscan.KERNEL.launch_count() == (1 + 4) * 6
        return (odo.positions, np.stack(odo.trajectory_R),
                [x.clone() for b in odo.voxmap.blocks for x in b], odo.step_reason)

    alone = run()
    _nccl_group_of_one()
    try:
        graph, eager = run(), run(eager=True)
    finally:
        dist.shutdown(wait=False)
    assert graph[3].startswith("graph: under the nccl process group")
    for other in (eager, alone):
        assert np.array_equal(graph[0], other[0]) and np.array_equal(graph[1], other[1])
        assert all(torch.equal(x, y) for x, y in zip(graph[2], other[2]))


def test_prepare_under_a_group_warms_its_all_reduce_before_the_first_capture(dev, monkeypatch):
    """`graphs.prepare` under an `nccl` group runs one all-reduce on the
    capture stream and on each body stream (ProcessGroupNCCL makes its
    communicator, stream and events at the first collective, which a
    capture cannot hold), before the first capture of that group and never
    again under it; a new group is warmed anew."""
    from eskf_lio_torch.parallel import distributed as dist

    calls = []
    warm_up = dist.warm_up
    monkeypatch.setattr(dist, "warm_up", lambda d: (
        calls.append(("warm_up", torch.cuda.current_stream(d).cuda_stream)), warm_up(d)))
    x = torch.arange(43.0, device=dev)
    out = torch.zeros(43, device=dev)

    def step():
        calls.append(("capture", None))
        out.copy_(dist.all_reduce_sum(x * 1.0))

    for _ in range(2):
        _nccl_group_of_one()
        try:
            calls.clear()
            graph = graphs.StepGraph(step, dev, segscan_rows=1024)
            graph()
            graphs.StepGraph(step, dev, segscan_rows=1024)()
            torch.cuda.synchronize()
            assert torch.equal(out, x)
            streams = {graphs._CAPTURE_STREAMS[dev.index or 0].cuda_stream} | {
                graphs._BODIES[(dev.index or 0, d)][0].cuda_stream
                for d in range(graphs.MAX_DEPTH)}
            assert [c[0] for c in calls] == ["warm_up"] * len(streams) + ["capture"] * 2
            assert {c[1] for c in calls[:len(streams)]} == streams
            del graph
        finally:
            dist.shutdown(wait=False)


def test_cli_scan_step_under_an_nccl_group_is_the_graph(dev, tmp_path):
    """`python -m eskf_lio_torch.cli --devices 4 --coordinator ...
    --num-processes 1`: a group of one process on the card takes `nccl`, and
    the CLI's `scan step:` line reads the captured step."""
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    proc = subprocess.run(
        [sys.executable, "-m", "eskf_lio_torch.cli", "--synthetic", "1.0",
         "--points-per-scan", "3000", "--devices", "4", "--coordinator", f"127.0.0.1:{port}",
         "--num-processes", "1", "--process-id", "0",
         "--traj-out", str(tmp_path / "t.json")],
        cwd=Path(__file__).resolve().parents[1], capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("scan step:")]
    assert line and line[0].startswith("scan step: graph: under the nccl process group"), line


def test_bench_light_series_on_the_card(dev, capsys, monkeypatch):
    """`eskf_lio_torch.bench.main` with ESKF_BENCH_ONLY=light: the LIGHT
    series on the full 13 s sequence through the captured step, one line
    naming the card; 64 timed scans, convergence >= 0.9, ATE <= 1.0 cm (the
    JAX bench: 0.45), and the timed half's launches counted on the device:
    kernel A once per GN iteration, kernel B twice and the preprocessor's
    kernels six times per update row."""
    import json

    from eskf_lio_torch import bench

    monkeypatch.setenv("ESKF_BENCH_ONLY", "light")
    monkeypatch.delenv("ESKF_GN_BACKEND", raising=False)
    assert bench.main(["--budget-s", "600"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    assert len(lines) == 1 and lines[0]["series"] == "light"
    assert lines[0]["device"] == bench.nvidia_smi_line()
    light = lines[0]["light"]
    assert light["timed_scans"] == 64 and light["update_rows"] == 64
    assert light["icp_convergence_rate"] >= 0.9 and light["ate_rmse_cm"] <= 1.0
    assert light["launches"] == {"gn_normal_eq": light["gn_iterations"],
                                 "gn_pass": 2 * light["gn_iterations"], "segscan": 128,
                                 "preprocess": 6 * 64, "imu_prefix": 64}
    assert lines[0]["value"] == light["scans_per_sec"] > 0


# ---------------------------------------------------------------------------
# the tracer's stamps inside the captured step (utils/profiling.py)
# ---------------------------------------------------------------------------

# the stage marks of `make_step_core` and the GN tick, as captured: the tick
# once at the top level (the first pass) and once in the WHILE node's body;
# and in the insert's fold branch its `fold` stamp and its `map_folds` count
STAMPS_CAPTURED = {False: 10, True: 11}


@pytest.fixture(scope="module")
def stamped_replays():
    """The same rows, with an eviction, through `make_replay_step` without a
    tracer and with one: (rows, outputs and runner of each, the tracer, the
    stamp launches the untraced runner made)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from eskf_lio_torch.utils import profiling

    dev = torch.device("cuda")
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=14, remove_period=0.5,
        remove_distance_threshold=8.0,
    )
    seq = dataset.make_synthetic_sequence(duration=1.5, points_per_scan=8000, seed=7)
    init_scan, chunks, scans, evicts, updates, _ = replay.pack_sequence(cfg, seq, device=dev)
    assert bool(evicts.any()) and bool(updates.all())

    def run(tracer):
        voxmap, _ = odometry.make_init_step(cfg, dev)(
            vm.VoxelMap.create(cfg.hash_capacity, cfg.map_delta_capacity, device=dev), init_scan)
        start = (eskf.init_state(cfg, dev), voxmap, torch.eye(3, device=dev),
                 torch.zeros(3, device=dev))
        step = replay.make_replay_step(cfg, dev, tracer)
        *carry, Rs, ts, diags = step(*start, chunks, scans, evicts, updates)
        torch.cuda.synchronize()
        return (carry, Rs.clone(), ts.clone(), {k: v.clone() for k, v in diags.items()}), step

    stamp_calls = []
    call = graphs.GRAPH_COND.call

    def counting(fn, *args):
        stamp_calls.append(fn)
        return call(fn, *args)

    graphs.GRAPH_COND.call = counting
    try:
        plain = run(None)
        untraced_stamps = stamp_calls.count("graph_cond_stamp")
    finally:
        graphs.GRAPH_COND.call = call
    tracer = profiling.Tracer()
    stamped = run(tracer)
    return chunks.dt.shape[0], evicts, plain, stamped, tracer, untraced_stamps


def test_a_stamped_step_gives_the_bits_of_an_unstamped_one(stamped_replays):
    _, _, ((p_carry, p_Rs, p_ts, p_diags), _), ((s_carry, s_Rs, s_ts, s_diags), _), _, _ = \
        stamped_replays
    assert torch.equal(p_Rs, s_Rs) and torch.equal(p_ts, s_ts)
    assert all(torch.equal(p_diags[k], s_diags[k]) for k in p_diags)
    for x, y in zip((*p_carry[0], *p_carry[1]), (*s_carry[0], *s_carry[1])):
        assert torch.equal(x, y)


def test_the_stamps_add_their_nodes_and_nothing_else(stamped_replays):
    """Each captured graph with stamps holds exactly its stamp marks (and
    the fold's count) more nodes than the same graph without (one of them in
    the WHILE body, two in the fold's IF body), and the untraced capture
    launched no stamp."""
    _, _, (_, plain_step), (_, stamped_step), tracer, untraced_stamps = stamped_replays
    assert untraced_stamps == 0
    for evict, marks in STAMPS_CAPTURED.items():
        plain, stamped = plain_step.scan_step.graphs[evict], stamped_step.scan_step.graphs[evict]
        assert plain.stamp_nodes == 0 and stamped.stamp_nodes == marks
        assert stamped.nodes == plain.nodes + marks
        name = "scan_step.evict" if evict else "scan_step"
        assert tracer.counters[f"graph_nodes.{name}"] == stamped.nodes
        assert tracer.counters[f"stamp_nodes.{name}"] == marks
        loops = [(p, s) for p, s in zip(plain.bodies, stamped.bodies) if p["kind"] == "while"]
        assert len(loops) == 1 and loops[0][1]["nodes"] == loops[0][0]["nodes"] + 1
        ifs = [s["nodes"] - p["nodes"] for p, s in zip(plain.bodies, stamped.bodies) if p["kind"] == "if"]
        assert sorted(ifs)[-1] == 2 and sum(ifs) == 2  # the fold branch: a stamp and a count
    assert tracer.summary()["spans"]["graph_capture"]["count"] == 2


def test_stamps_rise_within_a_row_with_one_gn_stamp_a_pass(stamped_replays):
    n_rows, evicts, _, ((_, _, _, diags), _), tracer, _ = stamped_replays
    rows = tracer.stage_rows()
    assert len(rows) == n_rows
    for b, row in enumerate(rows):
        names = [n for n, _ in row]
        times = [t for _, t in row]
        assert all(a <= c for a, c in zip(times, times[1:]))
        assert names.count("gn") == int(diags["icp_iterations"][b])
        stages = [n for n in names if n != "gn"]
        expect = ["predict", "preprocess", "align", "pose_update", "map_insert"]
        fold = ["fold"] if "fold" in stages else []  # the insert's fold branch ran
        assert stages == expect + fold + (["evict"] if bool(evicts[b]) else []) + ["end"]
    folds = sum("fold" in [n for n, _ in row] for row in rows)
    assert tracer.device_counters().get("map_folds", 0) == folds
    # the rows' stamps lie inside the rows' device spans, both on the host clock
    spans = tracer.device_spans("row")
    assert len(spans) == n_rows
    slack_ns = 50e3
    for row, (_, _, a, b) in zip(rows, spans):
        assert a - slack_ns <= row[0][1] <= row[-1][1] <= b + slack_ns
    clock = tracer.clock()
    assert clock["anchors"] >= 2 and max(clock["wait_us"]) < 1e4


# ---------------------------------------------------------------------------
# the preprocessor's kernels (csrc/preprocess.cu) against its plain version
# ---------------------------------------------------------------------------

# (raw points N, scan budget K): mid360's cells; HEAVY's and the Hilti
# rig's; a budget that cannot overflow; raw clouds that the budget pads; a
# ragged N with an overflow that drops voxels
PRE_CASES = {"mid360": (24576, 12288), "heavy": (131072, 32768), "no_overflow": (8192, 8192),
             "padding": (6000, 8192), "ragged": (10001, 4096)}
# covariances: the kernels take the plain version's float32 operations in
# its order, with the cuBLAS products, reductions and cross products
# rounded as torch rounds them on the card, so they agree to a few ulps of
# their entries (at most 1 in absolute value)
COV_TOL = 4 * 2.0**-23


def pre_inputs(case, dev):
    from eskf_lio_torch.utils import kernel_bounds

    n, k = PRE_CASES[case]
    scan, hist, T_il = kernel_bounds.room_scan(n, n + k, dev)
    return scan, hist, T_il, Config(max_raw_points=n, max_scan_points=k)


def assert_same_scan(got, want):
    assert torch.equal(got.valid, want.valid)
    assert torch.equal(got.points, want.points)  # so the voxel keys and the row order too
    err = float((got.covs - want.covs).abs().max())
    assert err <= COV_TOL, err


@pytest.mark.parametrize("path", ["deskew", "init"])
@pytest.mark.parametrize("case", sorted(PRE_CASES))
def test_preprocess_kernels_match_the_plain_version(dev, case, path):
    """`preprocess` (extrinsics and deskew in the first kernel) and the init
    step's `downsample_and_covariances` against `preprocess_ref` /
    `downsample_and_covariances_ref` on the same card: the same mask,
    points bit for bit, covariances within `COV_TOL`; six launches of the
    new source a call and kernel B's one, as before."""
    scan, hist, T_il, cfg = pre_inputs(case, dev)
    if path == "init":
        pts = T_il.apply(scan.points)
        run = lambda: pre.downsample_and_covariances(pts, scan.valid, cfg)
        want = pre.downsample_and_covariances_ref(pts, scan.valid, cfg)
    else:
        run = lambda: pre.preprocess(scan, hist, T_il, cfg)
        want = pre.preprocess_ref(scan, hist, T_il, cfg)
    a0, b0 = pre.KERNEL.launch_count(), segscan.KERNEL.launch_count()
    got = run()
    assert pre.KERNEL.launch_count() - a0 == pre.LAUNCHES == 6
    assert segscan.KERNEL.launch_count() - b0 == 1
    assert got.points.shape == (cfg.max_scan_points, 3) and got.valid.sum() > 100
    assert_same_scan(got, want)
    again = run()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("case", ["mid360", "no_overflow"])
def test_preprocess_kernels_in_a_captured_graph(dev, case):
    """Captured into a graph (`utils.graphs.StepGraph`) and replayed twice:
    the eager call's bits, and six launches a replay counted on the device."""
    scan, hist, T_il, cfg = pre_inputs(case, dev)
    eager = pre.preprocess(scan, hist, T_il, cfg)
    static = [torch.empty_like(x) for x in eager]

    def step():
        for s_, x in zip(static, pre.preprocess(scan, hist, T_il, cfg)):
            s_.copy_(x)

    graph = graphs.StepGraph(step, dev, segscan_rows=cfg.max_raw_points)
    a0, b0 = pre.KERNEL.launch_count(), segscan.KERNEL.launch_count()
    graph()
    graph()
    torch.cuda.synchronize()
    assert pre.KERNEL.launch_count() - a0 == 2 * pre.LAUNCHES
    assert segscan.KERNEL.launch_count() - b0 == 2
    assert all(torch.equal(a, b) for a, b in zip(static, eager))


# the JAX package's inputs and outputs of `tests/test_torch_preprocess.py`'s
# downsample and preprocess cases, which those cases keep current
JAX_OUTPUTS = Path(__file__).parent / "data" / "preprocess_jax.npz"
JAX_CASES = ("downsample.no_overflow", "downsample.overflow", "downsample.padding",
             "preprocess.no_overflow", "preprocess.overflow")


# a plane normal is well posed where the neighbourhood's two smallest
# eigenvalues stand this share of its trace apart
WELL_POSED_GAP = 1e-2


@pytest.mark.parametrize("case", JAX_CASES)
def test_preprocess_kernels_match_jax(dev, case):
    """The kernels against the JAX package on the same inputs: the same
    mask and row order, points at atol 1e-5 m, six launches a call, and the
    covariances at the tolerances of `tests/test_torch_preprocess.py`'s CPU
    cases (the downsample's at atol 1e-4; the preprocessor's at 1e-4 on
    99 % of rows and within 0.05 on all) on every row whose plane normal
    is well posed by the JAX package's own neighbourhood covariance.  Where
    the two smallest eigenvalues nearly meet (a line-like neighbourhood),
    the closed-form solver's arccos turns the last bits of the card's
    arccos and cos (the plain version's on the card too) into a turn of the
    normal inside that eigenspace, so there the row must only be what the
    regularisation makes: the identity where the JAX package's is (fewer
    than 3 neighbours), else I - (1 - eps) n n^T with a unit normal n."""
    with np.load(JAX_OUTPUTS) as f:
        a = {key[len(case) + 1:]: f[key] for key in f.files if key.startswith(case + ".")}
    T = lambda *keys: (torch.as_tensor(a[k], device=dev) for k in keys)
    n_raw, n_scan = (int(x) for x in a["sizes"])
    cfg = Config(max_raw_points=n_raw, max_scan_points=n_scan)
    a0 = pre.KERNEL.launch_count()
    if case.startswith("downsample."):
        got = pre.downsample_and_covariances(*T("points", "valid"), cfg)
    else:
        got = pre.preprocess(Scan(*T("points", "t_rel", "valid")),
                             StateHistory(*T("hist_t", "hist_p", "hist_q", "hist_valid")),
                             Pose(*T("R", "t")), cfg)
    assert pre.KERNEL.launch_count() - a0 == 6
    np.testing.assert_array_equal(got.valid.cpu().numpy(), a["out_valid"])
    assert got.valid.sum() > 100
    np.testing.assert_allclose(got.points.cpu().numpy(), a["out_points"], atol=1e-5)

    covs, want = got.covs.cpu().numpy(), a["out_covs"]
    lam = np.linalg.eigvalsh(a["out_raw_cov"].astype(np.float64))  # the K rows before padding
    posed = np.ones(len(want), bool)
    posed[: len(lam)] = lam[:, 1] - lam[:, 0] >= WELL_POSED_GAP * np.abs(lam).sum(1)
    err = np.abs(covs - want).reshape(-1, 9).max(1)[posed]
    if case.startswith("downsample."):
        assert err.max() <= 1e-4
    else:
        assert np.mean(err <= 1e-4) >= 0.99
        assert err.max() <= 0.05
    eye = np.eye(3, dtype=np.float32)
    few = (want == eye).all((1, 2))
    assert (covs[few] == eye).all()
    P = (eye - covs[~posed & ~few].astype(np.float64)) / (1.0 - cfg.covariance_plane_factor)
    assert np.abs(P - P.transpose(0, 2, 1)).max() <= 1e-5
    assert np.abs(np.trace(P, axis1=1, axis2=2) - 1.0).max() <= 1e-5
    assert np.abs(P @ P - P).max() <= 1e-5


def test_the_kernels_take_600_nodes_out_of_the_captured_step(dev, monkeypatch):
    """The replay of `stamped_replays`' rows through the captured step with
    the preprocessor's kernels and with its plain version: the kernels'
    capture holds at least 600 nodes fewer, and the two runs give the same
    poses bit for bit (the kernels' points are the plain version's)."""
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=14,
    )
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=8000, seed=7)
    init_scan, chunks, scans, evicts, updates, _ = replay.pack_sequence(cfg, seq, device=dev)

    def run():
        voxmap, _ = odometry.make_init_step(cfg, dev)(
            vm.VoxelMap.create(cfg.hash_capacity, cfg.map_delta_capacity, device=dev), init_scan)
        start = (eskf.init_state(cfg, dev), voxmap, torch.eye(3, device=dev),
                 torch.zeros(3, device=dev))
        step = replay.make_replay_step(cfg, dev)
        *_, Rs, ts, _ = step(*start, chunks, scans, evicts, updates)
        torch.cuda.synchronize()
        return Rs.clone(), ts.clone(), step.scan_step.graphs[False].nodes

    Rs_k, ts_k, nodes_k = run()
    with monkeypatch.context() as m:
        m.setattr(pre, "preprocess", pre.preprocess_ref)
        m.setattr(pre, "downsample_and_covariances", pre.downsample_and_covariances_ref)
        Rs_p, ts_p, nodes_p = run()
    assert nodes_k <= nodes_p - 600, (nodes_k, nodes_p)
    assert torch.equal(Rs_k, Rs_p) and torch.equal(ts_k, ts_p)
