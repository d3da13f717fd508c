"""The port's voxel map (`eskf_lio_torch/map/voxel_map.py`) vs the JAX
package, driven in lockstep from the same numpy clouds: several inserts
(appends and merges into the delta tier), a fold forced by delta
overflow, a compaction and an eviction with re-centring.

The layout is the JAX package's, so the integer words — skey, d_skey and
the key / row / pad words of every view slot — must be equal.  Payloads
(and the payload words of the view slots, read as f32) compare at rtol
1e-5 / atol 1e-6: f32 running means of O(1-10) values summed by
`index_add_` here and `segment_sum` there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from eskf_lio_torch.map import voxel_map as t_vm
from eskf_lio_tpu.map import voxel_map as j_vm

torch.set_num_threads(2)

VS = 0.3
CAP = 1 << 12  # small main tier; the delta tier is 2048 rows (its floor)


def rand_cloud(rng, n, center=(0, 0, 0), scale=5.0):
    pts = (rng.uniform(-scale, scale, size=(n, 3)) + center).astype(np.float32)
    covs = np.tile(np.eye(3, dtype=np.float32) * 0.01, (n, 1, 1))
    covs += rng.uniform(0, 0.001, size=(n, 1, 1)).astype(np.float32)
    return pts, covs[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]]


def assert_maps_equal(t, j):
    for name in ("origin", "skey", "d_skey"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)))
    for name in ("payload", "d_payload"):
        np.testing.assert_allclose(
            getattr(t, name).numpy(), np.asarray(getattr(j, name)), rtol=1e-5, atol=1e-6
        )
    for name in ("view", "d_view"):
        a = getattr(t, name).numpy().reshape(-1, t_vm.VIEW_SLOT)
        b = np.asarray(getattr(j, name)).reshape(-1, t_vm.VIEW_SLOT)
        words = np.r_[0:2, t_vm._SLOT_PAY:t_vm.VIEW_SLOT]
        np.testing.assert_array_equal(a[:, words], b[:, words])
        np.testing.assert_allclose(
            a[:, 2:t_vm._SLOT_PAY].view(np.float32), b[:, 2:t_vm._SLOT_PAY].view(np.float32),
            rtol=1e-5, atol=1e-6,
        )


def insert_both(t_map, j_map, pts, covs, valid, max_points=1000):
    kw = dict(voxel_size=VS, max_points_per_voxel=max_points)
    t_map, t_drop = t_vm.insert(
        t_map, torch.as_tensor(pts), torch.as_tensor(covs), torch.as_tensor(valid), **kw
    )
    j_map, j_drop = j_vm.insert(
        j_map, jnp.asarray(pts), jnp.asarray(covs), jnp.asarray(valid), **kw
    )
    assert int(t_drop) == int(j_drop)
    return t_map, j_map


@pytest.fixture(scope="module")
def maps_after_inserts():
    """Four inserts: fresh delta, merges + appends, an overflow fold, and a
    capped voxel (max_points 20) with an invalid tail."""
    rng = np.random.default_rng(0)
    t_map = t_vm.VoxelMap.create(CAP, device="cpu")
    j_map = j_vm.VoxelMap.create(CAP)
    history, clouds = [], []
    for step, (n, center) in enumerate([(1500, (0, 0, 0)), (1500, (1, 0, 0)),
                                       (3000, (6, 2, 0)), (800, (0, 0, 0))]):
        pts, covs = rand_cloud(rng, n, center)
        valid = np.ones(n, bool)
        valid[-50:] = False
        clouds.append(pts)
        d_fill_before = int(t_map.d_fill())
        t_map, j_map = insert_both(t_map, j_map, pts, covs, valid,
                                   max_points=20 if step == 3 else 1000)
        history.append((d_fill_before, int(t_map.d_fill()), int(t_map.live().sum())))
        assert_maps_equal(t_map, j_map)
    return t_map, j_map, history, np.concatenate(clouds)


def test_inserts_fold_and_match(maps_after_inserts):
    t_map, j_map, history, _ = maps_after_inserts
    # the third insert overflowed the 2048-row delta and folded into MAIN
    assert any(after == 0 and live > 0 for _, after, live in history)
    assert int(t_map.num_voxels()) == int(j_map.num_voxels())


def test_lookup_matches(maps_after_inserts):
    t_map, j_map, _, inserted = maps_after_inserts
    # inserted points (hits, in either tier) and random ones (mostly misses)
    q = np.concatenate([inserted[::3], rand_cloud(np.random.default_rng(1), 1000, (2, 1, 0), 8.0)[0]])
    tm, tc, th = t_vm.lookup(t_map, torch.as_tensor(q), voxel_size=VS)
    jm, jc, jh = j_vm.lookup(j_map, jnp.asarray(q), voxel_size=VS)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert th.sum() > 500
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)


def test_compact_matches(maps_after_inserts):
    t_map, j_map, _, _ = maps_after_inserts
    t_c, t_over = t_vm.compact(t_map, max_points_per_voxel=1000)
    j_c, j_over = j_vm.compact(j_map, max_points_per_voxel=1000)
    assert int(t_over) == int(j_over)
    assert_maps_equal(t_c, j_c)
    assert int(t_c.d_fill()) == 0


def test_evict_matches(maps_after_inserts):
    t_map, j_map, _, _ = maps_after_inserts
    center = np.asarray([4.0, 1.0, 0.5], np.float32)
    kw = dict(voxel_size=VS, distance_threshold=4.0, max_points_per_voxel=1000)
    t_e, t_rm = t_vm.evict_beyond(t_map, torch.as_tensor(center), **kw)
    j_e, j_rm = j_vm.evict_beyond(j_map, jnp.asarray(center), **kw)
    assert int(t_rm) == int(j_rm) > 0
    assert_maps_equal(t_e, j_e)


def test_empty_view_and_cov_packing():
    v = t_vm._empty_view(64, "cpu")
    np.testing.assert_array_equal(v.numpy(), np.asarray(j_vm._empty_view(64)))
    c = np.random.default_rng(2).normal(size=(7, 3, 3)).astype(np.float32)
    c = c + np.swapaxes(c, -1, -2)
    back = t_vm.unpack_cov(t_vm.pack_cov(torch.as_tensor(c))).numpy()
    np.testing.assert_array_equal(back, c)
