"""One Gauss-Newton pass around kernel A (`eskf_lio_torch/ops/gn_pass.py`,
`csrc/gn_pass.cu`): the lookup kernel and the increment kernel.

On the CPU (tier 1): both wrappers check shapes, dtypes, devices and the
contiguity of the buffers they write; for CPU tensors they run their plain
versions, which equal the torch chain they replace (`lie.transform_points`
+ `voxel_map.lookup`; `solve_increment` + the compose + `converged_check`)
and leave the launch counts alone; `align`'s path through the wrappers
(`registration._align_on_kernels`) gives the torch chain's bits on the
CPU, with the default lookup, with `icp_relookup_every` 2 and with the
adaptive re-match; the two kernels share one library.

On the card (`cuda` marker, skipped without one): the lookup kernel equals
`voxel_map.lookup` on the kernel's own pts_w bit for bit (both tiers holding
the same voxels, full buckets, voxels at the point cap, points out of the
key span, an empty map; key splits (10, 10, 10) and (11, 11, 9); N =
12,288, 24,576 and ragged), and pts_w equals `lie.transform_points`'; the
increment kernel against its plain version on real rows' systems; one
captured `align` on the card against the eager CPU `align` on a real row;
the captured `align` against the JAX package's, stored by
`tests/test_torch_registration.py` in `tests/data/align_jax.npz`, under each
re-match setting.

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gn_pass.py
"""

import dataclasses
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import registration
from eskf_lio_torch.ops import _cuda, gn_normal_eq, gn_pass, lie
from eskf_lio_torch.ops import sortmerge as sm
from eskf_lio_torch.pipeline import replay

torch.set_num_threads(2)

# the JAX package's `align` on the three-plane world (tests/test_torch_registration.py)
JAX_ALIGN = Path(__file__).parent / "data" / "align_jax.npz"
with np.load(JAX_ALIGN) as _f:
    JAX_ALIGN_CASES = sorted(k[:-len(".out_R")] for k in _f.files if k.endswith(".out_R"))

VS = 0.3
SPLITS = {"10-10-10": (10, 10, 10), "11-11-9": (11, 11, 9)}
CASES = ("both_tiers", "full_bucket", "cap", "out_of_span", "empty")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda")


def _covs(n, rng):
    c = np.tile(np.eye(3, dtype=np.float32) * 0.01, (n, 1, 1))
    c += rng.uniform(0, 0.001, size=(n, 1, 1)).astype(np.float32)
    return c[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]


def _insert(m, pts, rng, bits, cap):
    pts = np.asarray(pts, np.float32)
    m, _ = vm.insert(m, torch.as_tensor(pts), torch.as_tensor(_covs(len(pts), rng)),
                     torch.ones(len(pts), dtype=torch.bool), voxel_size=VS,
                     max_points_per_voxel=cap, key_bits=bits)
    return m


def _one_bucket_voxels(m, bits, n_buckets, count):
    """`count` voxel coordinates whose keys fall in one bucket of a view of
    `n_buckets` buckets."""
    g = torch.arange(-12, 12, dtype=torch.int32)
    keys = torch.cartesian_prod(g, g, g)
    packed, ok = sm.pack_keys(keys, m.origin, bits)
    b = sm.bucket_of(sm.skey_of(packed), n_buckets)
    b = torch.where(ok, b, -1)
    top = torch.bincount(b[b >= 0]).argmax()
    return keys[b == top][:count]


@functools.lru_cache(maxsize=None)
def case_map(case: str, split: str):
    """(map on the CPU, query points [4096, 3], max_points_per_voxel)."""
    bits = SPLITS[split]
    rng = np.random.default_rng(7)
    cap = 1000
    m = vm.VoxelMap.create(1 << 12, device="cpu", key_bits=bits)
    near = rng.uniform(-1.5, 1.5, size=(3000, 3))
    if case == "both_tiers":
        m = _insert(m, near, rng, bits, cap)
        m, _ = vm.compact(m, max_points_per_voxel=cap)
        m = _insert(m, near + rng.normal(size=near.shape) * 0.05, rng, bits, cap)
        q = near
    elif case == "full_bucket":
        # 10 voxels of one bucket of the main view (8 fit, 2 are left out of
        # it), folded into main; 8 of one bucket of the delta view after them
        main = _one_bucket_voxels(m, bits, m.view.shape[0], 10)
        centres = (main.numpy() + 0.5) * VS
        m = _insert(m, np.concatenate([np.repeat(centres, 3, axis=0), near]), rng, bits, cap)
        m, _ = vm.compact(m, max_points_per_voxel=cap)
        delta = _one_bucket_voxels(m, bits, m.d_view.shape[0], 8)
        d_centres = (delta.numpy() + 0.5) * VS
        m = _insert(m, np.repeat(d_centres, 2, axis=0), rng, bits, cap)
        q = np.concatenate([centres, d_centres, near[:200]]) + rng.uniform(-0.1, 0.1, (218, 3))
    elif case == "cap":
        # 4 points a voxel at most: main at the cap, the delta adds more
        cap = 4
        centres = (np.floor(near[:200] / VS) + 0.5) * VS
        m = _insert(m, np.repeat(centres, 6, axis=0) + rng.normal(size=(1200, 3)) * 0.02,
                    rng, bits, cap)
        m, _ = vm.compact(m, max_points_per_voxel=cap)
        m = _insert(m, np.repeat(centres[:100], 3, axis=0), rng, bits, cap)
        m = _insert(m, np.repeat(centres[100:], 2, axis=0), rng, bits, cap)
        q = np.concatenate([centres, near[:200]])
    elif case == "out_of_span":
        m = _insert(m, near, rng, bits, cap)
        far = rng.uniform(-2000, 2000, size=(1000, 3))
        q = np.concatenate([near, far])
    else:
        q = near
    q = np.resize(np.asarray(q, np.float32), (4096, 3))
    return m, torch.as_tensor(q), cap


def rows(q: torch.Tensor, n: int, seed: int = 0):
    """n query rows drawn from the case's points, jittered, with a random
    valid mask."""
    g = torch.Generator().manual_seed(seed)
    idx = torch.randint(0, q.shape[0], (n,), generator=g)
    pts = q[idx] + (torch.rand((n, 3), generator=g) - 0.5) * 0.2
    valid = torch.rand(n, generator=g) < 0.9
    return pts.contiguous(), valid


def small_pose():
    return lie.so3_exp(torch.tensor([0.01, -0.02, 0.015])), torch.tensor([0.05, -0.03, 0.02])


def lookup_kw(split, cap):
    return dict(voxel_size=VS, max_points_per_voxel=cap, key_bits=SPLITS[split])


# ---- CPU: the wrappers ------------------------------------------------------


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("case", CASES)
def test_lookup_on_cpu_is_the_plain_chain(case, split):
    """CPU tensors take the plain version: transform_points, then the map's
    lookup; the kernel's launch count does not move."""
    m, q, cap = case_map(case, split)
    pts, valid = rows(q, 1000)
    R, t = small_pose()
    before = gn_pass.KERNEL.launch_count()
    pts_w, mu, cov, mask = gn_pass.lookup(pts, valid, R, t, m, **lookup_kw(split, cap))
    assert gn_pass.KERNEL.launch_count() == before
    want_w = lie.transform_points(R, t, pts)
    want_mu, want_cov, hit = vm.lookup(m, want_w, **lookup_kw(split, cap))
    assert torch.equal(pts_w, want_w)
    assert torch.equal(mu, want_mu) and torch.equal(cov, want_cov)
    assert torch.equal(mask, valid & hit)
    assert (mu.shape, cov.shape, mask.dtype) == ((1000, 3), (1000, 6), torch.bool)
    if case == "empty":
        assert not mask.any()
    elif case != "out_of_span":
        assert mask.float().mean() > 0.3


def test_the_cases_hold_what_they_claim():
    """The full-bucket map has a full bucket in both views, the cap map
    voxels at the cap in the main tier, the both-tiers map the same voxels
    in both."""
    m, _, _ = case_map("full_bucket", "10-10-10")
    for view in (m.view, m.d_view):
        filled = (view.view(view.shape[0], 8, 16)[:, :, 0] != sm.INT32_MAX).sum(1)
        assert int(filled.max()) == 8
    m, _, cap = case_map("cap", "10-10-10")
    assert int((m.payload[:, 0] == cap).sum()) >= 100
    m, _, _ = case_map("both_tiers", "11-11-9")
    live = m.d_skey[m.d_skey != sm.INT32_MAX]
    assert bool(torch.isin(live, m.skey).float().mean() > 0.5)


@pytest.mark.parametrize("bad", ["points_shape", "points_dtype", "valid_dtype", "R_shape",
                                 "t_dtype", "view_shape", "it_dtype", "need_shape", "relook"])
def test_lookup_checks_its_inputs(bad):
    m, q, cap = case_map("both_tiers", "10-10-10")
    pts, valid = rows(q, 64)
    R, t = small_pose()
    args = dict(points=pts, valid=valid, R=R, t=t, vmap=m)
    kw = lookup_kw("10-10-10", cap)
    out = (torch.zeros(64, 3), torch.zeros(64, 6), torch.zeros(64, dtype=torch.bool))
    if bad == "points_shape":
        args["points"] = pts[:, :2]
    elif bad == "points_dtype":
        args["points"] = pts.double()
    elif bad == "valid_dtype":
        args["valid"] = valid.to(torch.uint8)
    elif bad == "R_shape":
        args["R"] = R[:2]
    elif bad == "t_dtype":
        args["t"] = t.double()
    elif bad == "view_shape":
        args["vmap"] = m._replace(view=m.view.reshape(-1, 64))
    elif bad == "it_dtype":
        kw.update(out=out, it=torch.zeros((), dtype=torch.int32), relook=2)
    elif bad == "need_shape":
        kw.update(out=out, need=torch.ones(2, dtype=torch.bool))
    else:
        kw.update(relook=0)
    with pytest.raises(ValueError):
        gn_pass.lookup(*args.values(), **kw)


def test_lookup_writes_only_contiguous_out_buffers():
    m, q, cap = case_map("both_tiers", "10-10-10")
    pts, valid = rows(q, 64)
    R, t = small_pose()
    bad = (torch.zeros(3, 64).T, torch.zeros(64, 6), torch.zeros(64, dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        gn_pass.lookup(pts, valid, R, t, m, out=bad, **lookup_kw("10-10-10", cap))
    with pytest.raises(ValueError, match="out buffers"):
        gn_pass.lookup(pts, valid, R, t, m, need=torch.ones(1, dtype=torch.bool),
                       **lookup_kw("10-10-10", cap))


# the lookup's re-match guards -> whether it looks up
SKIP_MODES = {"need_false": False, "need_true": True, "off_turn": False, "on_turn": True,
              "need_true+off_turn": True, "need_false+on_turn": False}


def skip_kw(mode: str, device) -> dict:
    kw = {}
    if "need" in mode:
        kw["need"] = torch.tensor(["need_true" in mode], device=device)
    if "turn" in mode:
        kw.update(it=torch.tensor(3 if "off_turn" in mode else 4, device=device), relook=2)
    return kw


@pytest.mark.parametrize("mode", SKIP_MODES)
def test_a_skipped_lookup_keeps_its_buffers(mode):
    """With `need` unset, or without `need` an iteration off `relook`'s
    turn, only pts_w is new; otherwise the buffers take the new lookup, in
    place.  Given both, `need` decides, as `align`'s re-match guards do."""
    m, q, cap = case_map("both_tiers", "10-10-10")
    pts, valid = rows(q, 500)
    R, t = small_pose()
    old = (torch.full((500, 3), 7.0), torch.full((500, 6), 8.0), torch.zeros(500, dtype=torch.bool))
    out = tuple(x.clone() for x in old)
    kw = {**lookup_kw("10-10-10", cap), **skip_kw(mode, "cpu")}
    pts_w, mu, cov, mask = gn_pass.lookup(pts, valid, R, t, m, out=out, **kw)
    assert mu is out[0] and cov is out[1] and mask is out[2]
    assert torch.equal(pts_w, lie.transform_points(R, t, pts))
    fresh = gn_pass.lookup(pts, valid, R, t, m, **lookup_kw("10-10-10", cap))
    want = fresh[1:] if SKIP_MODES[mode] else old
    for got, w in zip(out, want):
        assert torch.equal(got, w)


def system(seed=0, n_corr=5000):
    """A real normal-equation system: kernel A's plain version over a
    three-plane world seen from a perturbed pose."""
    rng = np.random.default_rng(seed)
    n3 = 1000
    floor = np.column_stack([rng.uniform(-8, 8, n3), rng.uniform(-8, 8, n3), np.zeros(n3)])
    wall1 = np.column_stack([rng.uniform(-8, 8, n3), np.full(n3, -8.0), rng.uniform(0, 4, n3)])
    wall2 = np.column_stack([np.full(n3, 8.0), rng.uniform(-8, 8, n3), rng.uniform(0, 4, n3)])
    pts = torch.as_tensor(np.vstack([floor, wall1, wall2]).astype(np.float32))
    normals = torch.tensor([[0, 0, 1.0], [0, 1.0, 0], [1.0, 0, 0]]).repeat_interleave(n3, 0)
    covs = torch.eye(3) - 0.99 * normals[:, :, None] * normals[:, None, :]
    packed = vm.pack_cov(covs)
    R, t = lie.so3_exp(torch.tensor([0.02, -0.01, 0.03])), torch.tensor([0.1, -0.05, 0.02])
    pts_w = lie.transform_points(R, t, pts)
    mask = torch.arange(3 * n3) < n_corr
    JTJ, JTr, num = gn_normal_eq.normal_equations_rotated_ref(pts_w, packed, R, pts, packed, mask)
    return JTJ, JTr, num, R, t


THRESH = dict(max_iterations=8, cosine_threshold=0.9999, translation_sq_threshold=1e-6)


@pytest.mark.parametrize("it", [None, 3, 7])
def test_increment_on_cpu_is_solve_compose_and_check(it):
    JTJ, JTr, num, R, t = system()
    it_t = None if it is None else torch.tensor(it)
    before = gn_pass.KERNEL.launch_count()
    active, it1, conv, R1, t1, num1, R_d, t_d = gn_pass.increment(
        JTJ, JTr, num, R, t, it_t, deltas=True, **THRESH)
    assert gn_pass.KERNEL.launch_count() == before
    want_Rd, want_td = registration.solve_increment(JTJ, JTr, num)
    assert torch.equal(R_d, want_Rd) and torch.equal(t_d, want_td)
    assert torch.equal(R1, want_Rd @ R) and torch.equal(t1, want_Rd @ t + want_td)
    cfg = Config(icp_cosine_threshold=0.9999, icp_translation_sq_threshold=1e-6)
    assert torch.equal(conv, registration.converged_check(want_Rd, want_td, cfg))
    assert int(it1) == (0 if it is None else it) + 1
    assert bool(active) == (int(it1) < 8 and not bool(conv))
    assert float(num1) == float(num) and it1.dtype == torch.int64 and active.dtype == torch.bool


def test_increment_below_six_correspondences_is_the_identity():
    JTJ, JTr, num, R, t = system(n_corr=5)
    assert float(num) == 5.0
    *_, R1, t1, _, R_d, t_d = gn_pass.increment(JTJ, JTr, num, R, t, deltas=True, **THRESH)
    assert torch.equal(R_d, torch.eye(3)) and torch.equal(t_d, torch.zeros(3))
    assert torch.equal(R1, R) and torch.equal(t1, t)


def test_increment_writes_its_out_buffers_in_place():
    JTJ, JTr, num, R, t = system()
    want = gn_pass.increment(JTJ, JTr, num, R, t, torch.tensor(2), **THRESH)
    out = (torch.ones((), dtype=torch.bool), torch.tensor(2), torch.zeros((), dtype=torch.bool),
           R.clone(), t.clone(), torch.zeros(()))
    got = gn_pass.increment(JTJ, JTr, num, out[3], out[4], out[1], out=out, **THRESH)
    assert all(g is o for g, o in zip(got, out))
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("bad", ["JTJ_shape", "JTr_dtype", "num_shape", "it_dtype", "out_strides",
                                 "out_dtype"])
def test_increment_checks_its_inputs(bad):
    JTJ, JTr, num, R, t = system()
    args = [JTJ, JTr, num, R, t, None]
    kw = dict(THRESH)
    out = [torch.ones((), dtype=torch.bool), torch.tensor(0), torch.zeros((), dtype=torch.bool),
           R.clone(), t.clone(), torch.zeros(())]
    if bad == "JTJ_shape":
        args[0] = JTJ[:5]
    elif bad == "JTr_dtype":
        args[1] = JTr.double()
    elif bad == "num_shape":
        args[2] = num.reshape(1)
    elif bad == "it_dtype":
        args[5] = torch.tensor(1, dtype=torch.int32)
    elif bad == "out_strides":
        out[3] = torch.zeros(3, 3).T
        kw["out"] = out
    else:
        out[1] = torch.tensor(0.0)
        kw["out"] = out
    with pytest.raises(ValueError):
        gn_pass.increment(*args, **kw)


def test_the_two_kernels_share_one_library(tmp_path, monkeypatch):
    """One source, one nvcc run with `-fmad=false`, one library holding
    both entry points, one launch count for both."""
    assert set(gn_pass.KERNEL.functions) == {"gn_lookup_launch", "gn_increment_launch"}
    assert gn_pass.KERNEL.source.name == "gn_pass.cu" and gn_pass.LAUNCHES == 2
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_cuda, "nvcc_path", lambda: "nvcc")
    started = []

    class FakeNvcc:
        def __init__(self, cmd, **kw):
            started.append(cmd)
            open(cmd[cmd.index("-o") + 1], "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(_cuda.subprocess, "Popen", FakeNvcc)
    kernel = _cuda.CudaKernel("gn_pass", "gn_pass.cu", gn_pass.KERNEL.functions,
                              flags=("-fmad=false",))
    assert kernel.library_path().name == gn_pass.KERNEL.library_path().name
    _cuda.build([kernel])
    assert len(started) == 1 and "-fmad=false" in started[0]
    assert started[0][-1].endswith("gn_pass.cu") and kernel.library_path().exists()
    _cuda.build([kernel])  # built: no second nvcc
    assert len(started) == 1


# ---- CPU: align through the wrappers ----------------------------------------


@functools.lru_cache(maxsize=None)
def real_rows(device: str = "cpu", n_keep: int = 3):
    """`align`'s arguments on a few rows of a short synthetic replay (the
    map, scan and guess of each, cloned), and the config."""
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=16,
    )
    seq = dataset.make_synthetic_sequence(duration=1.0, points_per_scan=8000, seed=7)
    kept = []
    original = registration.align

    def keep(scan, voxmap, guess, config, *a, **k):
        if len(kept) < n_keep + 2:
            kept.append(tuple(type(x)(*(y.clone() for y in x)) for x in (scan, voxmap, guess)))
        return original(scan, voxmap, guess, config, *a, **k)

    registration.align = keep
    try:
        replay.run_replay(cfg, seq, device=device)
    finally:
        registration.align = original
    return cfg, kept[2:]  # rows past the first, on a map that has some history


@pytest.mark.parametrize("variant", ["default", "relook2", "adaptive", "relook2+adaptive"])
def test_align_through_the_wrappers_gives_the_chain_bits_on_the_cpu(variant):
    """`_align_on_kernels`, the card's path, with the wrappers' plain
    versions: the torch chain's pose, iterations, convergence and count,
    bit for bit."""
    cfg, kept = real_rows()
    cfg = {
        "default": cfg,
        "relook2": dataclasses.replace(cfg, icp_relookup_every=2),
        "adaptive": dataclasses.replace(cfg, icp_rematch_threshold=0.05),
        # both set: the adaptive test decides, as in the chain and the JAX package
        "relook2+adaptive": dataclasses.replace(cfg, icp_relookup_every=2,
                                                icp_rematch_threshold=0.05),
    }[variant]
    for scan, voxmap, guess in kept:
        chain = registration.align(scan, voxmap, guess, cfg)
        R0, t0 = guess.R.clone(), guess.t.clone()
        via = registration._align_on_kernels(scan, voxmap, guess, cfg, None)
        assert torch.equal(guess.R, R0) and torch.equal(guess.t, t0)  # the guess is not written
        assert int(via.iterations) == int(chain.iterations) >= 1
        assert torch.equal(via.pose.R, chain.pose.R) and torch.equal(via.pose.t, chain.pose.t)
        assert bool(via.converged) == bool(chain.converged)
        assert int(via.num_correspondences) == int(chain.num_correspondences) > 100


# ---- the card ---------------------------------------------------------------


def _to(x, dev):
    return type(x)(*(y.to(dev) for y in x))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [12288, 24576, 1001])
@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("case", CASES)
def test_lookup_kernel_equals_the_map_lookup_bit_for_bit(dev, case, split, n):
    m, q, cap = case_map(case, split)
    m = _to(m, dev)
    pts, valid = rows(q, n, seed=n)
    pts, valid = pts.to(dev), valid.to(dev)
    R, t = (x.to(dev) for x in small_pose())
    before = gn_pass.KERNEL.launch_count()
    pts_w, mu, cov, mask = gn_pass.lookup(pts, valid, R, t, m, **lookup_kw(split, cap))
    assert gn_pass.KERNEL.launch_count() == before + 1
    assert torch.equal(pts_w, lie.transform_points(R, t, pts))
    want_mu, want_cov, hit = vm.lookup(m, pts_w, **lookup_kw(split, cap))
    assert torch.equal(mu.view(torch.int32), want_mu.contiguous().view(torch.int32))
    assert torch.equal(cov.view(torch.int32), want_cov.contiguous().view(torch.int32))
    assert torch.equal(mask, valid & hit)
    ones = torch.ones_like(valid)
    assert torch.equal(gn_pass.lookup(pts, ones, R, t, m, **lookup_kw(split, cap))[3], hit)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", SKIP_MODES)
def test_lookup_kernel_skips_as_the_plain_version(dev, mode):
    m, q, cap = case_map("both_tiers", "10-10-10")
    pts, valid = rows(q, 3000)
    R, t = small_pose()
    kw = lookup_kw("10-10-10", cap)
    results = []
    for d in ("cpu", dev):
        out = (torch.full((3000, 3), 7.0, device=d), torch.full((3000, 6), 8.0, device=d),
               torch.zeros(3000, dtype=torch.bool, device=d))
        args = (x.to(d) for x in (pts, valid, R, t))
        got = gn_pass.lookup(*args, _to(m, d), out=out, **kw, **skip_kw(mode, d))
        results.append([x.cpu() for x in got])
    for c, g in zip(*results):
        assert torch.allclose(c, g, atol=1e-5) if c.dtype == torch.float32 else torch.equal(c, g)


@pytest.mark.cuda
def test_increment_kernel_against_the_plain_version_on_real_systems(dev):
    """Kernel A's systems on every GN pass of real rows, on the card: the
    increment kernel against `solve_increment` + the compose +
    `converged_check` run by torch on the card, bit for bit (the kernel
    takes torch's order of operations there), and the identity below six
    correspondences."""
    cfg, kept = real_rows()
    systems = []
    original = gn_normal_eq.normal_equations_rotated

    def keep(*args):
        out = original(*args)
        systems.append((*(x.clone() for x in out), args[2].clone()))
        return out

    gn_normal_eq.normal_equations_rotated = keep
    try:
        for scan, voxmap, guess in kept:
            registration.align(scan, voxmap, guess, cfg)
    finally:
        gn_normal_eq.normal_equations_rotated = original
    assert len(systems) >= 3
    t0 = torch.tensor([0.3, -0.2, 0.1], device=dev)
    for JTJ, JTr, num, R in systems:
        args = [x.to(dev) for x in (JTJ, JTr, num, R)]
        for it in (torch.tensor(0, device=dev), torch.tensor(7, device=dev)):
            k = gn_pass.increment(*args, t0, it, deltas=True, **THRESH)
            p = gn_pass.increment_ref(*args, t0, it, deltas=True, **THRESH)
            for a, b in zip(k, p):
                assert a.dtype == b.dtype and a.shape == b.shape
                assert torch.equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                   b.view(torch.int32) if b.dtype == torch.float32 else b)
    few = systems[0]
    JTJ, JTr, R = (x.to(dev) for x in (few[0], few[1], few[3]))
    k = gn_pass.increment(JTJ, JTr, torch.tensor(5.0, device=dev), R, t0, deltas=True, **THRESH)
    assert torch.equal(k[6], torch.eye(3, device=dev)) and torch.equal(k[7], torch.zeros(3, device=dev))
    assert torch.equal(k[3], R) and torch.equal(k[4], t0)


@pytest.mark.cuda
def test_captured_align_on_the_card_against_the_eager_cpu_align(dev):
    """`align` captured on the card (three launches a pass inside the WHILE
    node, each counted) against the eager CPU `align` on the
    same real rows: the same GN passes and the pose within 1e-4; and
    against the torch chain run eagerly on the card (a `lookup_fn` takes
    it), bit for bit."""
    from eskf_lio_torch.utils.graphs import StepGraph

    cfg, kept = real_rows()
    for scan, voxmap, guess in kept:
        want = registration.align(scan, voxmap, guess, cfg)
        s, m, g = _to(scan, dev), _to(voxmap, dev), _to(guess, dev)
        res = {}

        def step():
            res["r"] = registration.align(s, m, g, cfg)

        graph = StepGraph(step, dev, cfg.max_raw_points)
        counts = [k.launch_count() for k in (gn_pass.KERNEL, gn_normal_eq.KERNEL)]
        graph()  # the capture, then one replay
        graph()
        got = res["r"]
        passes = int(got.iterations)
        assert passes == int(want.iterations)
        after = [k.launch_count() for k in (gn_pass.KERNEL, gn_normal_eq.KERNEL)]
        assert [a - b for a, b in zip(after, counts)] == [2 * passes * gn_pass.LAUNCHES, 2 * passes]
        body = [b for b in graph.bodies if b["kind"] == "while"]
        # three launches a pass, each with its counter node
        assert len(body) == 1 and body[0]["nodes"] <= 7, graph.bodies
        assert float((got.pose.t.cpu() - want.pose.t).abs().max()) < 1e-4
        assert float((got.pose.R.cpu() - want.pose.R).abs().max()) < 1e-4
        kw = dict(voxel_size=cfg.map_voxel_size, max_points_per_voxel=cfg.max_points_per_voxel,
                  key_bits=cfg.map_key_bits)
        chain = registration.align(s, m, g, cfg, lookup_fn=lambda p: vm.lookup(m, p, **kw))
        assert int(chain.iterations) == passes
        assert torch.equal(chain.pose.R, got.pose.R) and torch.equal(chain.pose.t, got.pose.t)
        assert int(chain.num_correspondences) == int(got.num_correspondences)


def stored_align_case(case: str) -> dict:
    """Case `case` of the stored file, the world's arrays as world_*."""
    with np.load(JAX_ALIGN) as f:
        world = {"world_" + k[len("world."):]: f[k] for k in f.files if k.startswith("world.")}
        return {**world, **{k[len(case) + 1:]: f[k] for k in f.files if k.startswith(case + ".")}}


@pytest.mark.cuda
@pytest.mark.parametrize("case", JAX_ALIGN_CASES)
def test_captured_align_matches_the_stored_jax_outputs(dev, case):
    """`align` captured on the card, through the three kernels, against the
    JAX package's `align` on the same map, scan and re-match setting (the
    default, relook 2, adaptive, both): the same iterations and count, the
    pose within 1e-4, as the CPU's `align` meets it."""
    from eskf_lio_torch.types import Pose, ProcessedScan
    from eskf_lio_torch.utils.graphs import StepGraph

    a = stored_align_case(case)
    m, _ = vm.insert(vm.VoxelMap.create(1 << 14, device="cpu"),
                     torch.as_tensor(a["world_points"]), torch.as_tensor(a["world_covs"]),
                     torch.ones(len(a["world_points"]), dtype=torch.bool),
                     voxel_size=0.3, max_points_per_voxel=1000)
    cfg = Config(max_scan_points=2048, icp_max_iterations=30,
                 icp_relookup_every=int(a["relookup_every"]),
                 icp_rematch_threshold=float(a["rematch_threshold"]))
    s = ProcessedScan(*(torch.as_tensor(a[k]).to(dev) for k in ("points", "covs", "valid")))
    m, g = _to(m, dev), Pose.identity(dev)
    res = {}

    def step():
        res["r"] = registration.align(s, m, g, cfg)

    graph = StepGraph(step, dev, cfg.max_raw_points)
    before = gn_pass.KERNEL.launch_count()
    graph()  # the capture, then one replay
    graph()
    got = res["r"]
    assert int(got.iterations) == int(a["out_iterations"]), case
    assert gn_pass.KERNEL.launch_count() - before == 2 * int(got.iterations) * gn_pass.LAUNCHES
    assert bool(got.converged) == bool(a["out_converged"])
    assert int(got.num_correspondences) == int(a["out_num_correspondences"])
    np.testing.assert_allclose(got.pose.t.cpu().numpy(), a["out_t"], atol=1e-4)
    np.testing.assert_allclose(got.pose.R.cpu().numpy(), a["out_R"], atol=1e-4)
