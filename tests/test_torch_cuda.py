"""The port on the card: both CUDA kernels against their plain versions,
and the replay through the kernels against the replay on the CPU.

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

import numpy as np
import pytest
import torch

from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.ops import gn_normal_eq as gn
from eskf_lio_torch.ops import lie
from eskf_lio_torch.ops import segscan
from eskf_lio_torch.pipeline import replay

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


@pytest.mark.parametrize("n", [1, 127, 129, 255, 1000, 16384, 100000])
def test_gn_kernel_matches_plain(dev, n):
    args = gn_args(n, n, dev)
    before = gn.KERNEL.launches
    out = gn.normal_equations_rotated(*args)
    assert gn.KERNEL.launches == before + 1
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
    "n,n_keys", [(131072, 12000), (131072, 1), (131072, 131072 * 8), (1000, 90), (257, 3), (1, 1)]
)
def test_segscan_kernel_matches_plain(dev, n, n_keys):
    keys, vals = seg_inputs(n, n_keys, dev)
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    before = segscan.KERNEL.launches
    out = segscan.segsum_sorted(keys, vals)
    assert segscan.KERNEL.launches == before + 1
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
    a0, b0 = gn.KERNEL.launches, segscan.KERNEL.launches
    pos_gpu, _, diags, _ = replay.run_replay(cfg, seq, device=dev)
    assert gn.KERNEL.launches - a0 == int(diags["icp_iterations"].sum())
    assert segscan.KERNEL.launches - b0 == len(pos_gpu)  # update scans + init
    pos_cpu, _, _, _ = replay.run_replay(cfg, seq, device="cpu")
    np.testing.assert_allclose(pos_gpu, pos_cpu, atol=1e-2)
