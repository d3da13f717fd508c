"""The voxel map's key split (`Config.map_key_bits`, the port's own): the
packing of a voxel key into bits per axis around the map's origin.

The default split, (10, 10, 10), is the JAX package's layout bit for bit;
(11, 11, 9), the urban car's, packs and unpacks its whole span, refuses the
all-ones key (the empty key INT32_MAX itself at 31 bits), centres the
origin of a new map and of every eviction's re-centring on the sensor's
voxel, and keeps a point that (10, 10, 10) drops for its span.  A
checkpoint records the split, and a map saved under one split does not
load under another.  A growing map keeps the voxels that a full
delta-view bucket would drop: the delta folds instead.
"""

import dataclasses

import numpy as np
import pytest
import torch
import yaml

import jax.numpy as jnp

from eskf_lio_torch import config as t_config
from eskf_lio_torch.io import dataset as t_dataset
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import sortmerge as sm
from eskf_lio_torch.pipeline.odometry import Odometry
from eskf_lio_torch.utils import checkpoint
from eskf_lio_torch.utils.profiling import Tracer, stage
from eskf_lio_tpu.ops import sortmerge as j_sm

torch.set_num_threads(2)

URBAN = (11, 11, 9)
VS = 0.3


def _span_keys(bits, rng, n=4096):
    """Random keys over the whole span of `bits` around `origin`, and
    the span's corners but the all-ones one."""
    origin = torch.tensor([-(1 << (b - 1)) for b in bits], dtype=torch.int32)
    hi = np.array([(1 << b) - 1 for b in bits])
    rel = rng.integers(0, hi + 1, size=(n, 3))
    corners = np.array([[x, y, z] for x in (0, hi[0]) for y in (0, hi[1]) for z in (0, hi[2])])[:-1]
    rel = np.concatenate([rel[~(rel == hi).all(1)], corners])
    return torch.as_tensor(rel, dtype=torch.int32) + origin, origin


@pytest.mark.parametrize("bits", [(10, 10, 10), URBAN, (12, 12, 7)])
def test_pack_unpack_round_trip_over_the_span(bits, rng):
    keys, origin = _span_keys(bits, rng)
    packed, ok = sm.pack_keys(keys, origin, bits)
    assert bool(ok.all()) and bool((packed != sm.INT32_MAX).all()) and bool((packed >= 0).all())
    assert torch.equal(sm.unpack_keys(packed, origin, bits), keys)
    # distinct keys, distinct packed keys, and the hash order inverts
    assert torch.unique(packed).numel() == torch.unique(keys, dim=0).shape[0]
    assert torch.equal(sm.packed_of_skey(sm.skey_of(packed)), packed)


@pytest.mark.parametrize("bits", [(10, 10, 10), URBAN])
def test_keys_outside_the_span_are_refused(bits):
    origin = torch.tensor([-(1 << (b - 1)) for b in bits], dtype=torch.int32)
    span = torch.tensor([1 << b for b in bits], dtype=torch.int32)
    out = torch.stack([origin - 1, origin + span, origin + span - 1 + torch.tensor([1, 0, 0]),
                       origin + torch.tensor([0, 0, -1])]).to(torch.int32)
    packed, ok = sm.pack_keys(out, origin, bits)
    assert not bool(ok.any()) and bool((packed == sm.INT32_MAX).all())


def test_the_all_ones_key_is_the_empty_key_and_refused():
    origin = torch.zeros(3, dtype=torch.int32)
    ones = torch.tensor([[(1 << 11) - 1, (1 << 11) - 1, (1 << 9) - 1]], dtype=torch.int32)
    raw = (ones[0, 0].item() << 20) | (ones[0, 1].item() << 9) | ones[0, 2].item()
    assert raw == sm.INT32_MAX
    packed, ok = sm.pack_keys(ones, origin, URBAN)
    assert not bool(ok[0]) and int(packed[0]) == sm.INT32_MAX
    # one voxel short of it on any axis is a key
    for axis in range(3):
        k = ones.clone()
        k[0, axis] -= 1
        packed, ok = sm.pack_keys(k, origin, URBAN)
        assert bool(ok[0]) and int(packed[0]) != sm.INT32_MAX


def test_the_default_split_is_the_jax_packages_layout(rng):
    keys = torch.as_tensor(rng.integers(-700, 700, size=(5000, 3)), dtype=torch.int32)
    origin = torch.tensor([-512, -400, -600], dtype=torch.int32)
    t_packed, t_ok = sm.pack_keys(keys, origin)
    j_packed, j_ok = j_sm.pack_keys(jnp.asarray(keys.numpy()), jnp.asarray(origin.numpy()))
    assert np.array_equal(t_packed.numpy(), np.asarray(j_packed))
    assert np.array_equal(t_ok.numpy(), np.asarray(j_ok))
    live = t_ok
    assert np.array_equal(sm.unpack_keys(t_packed, origin, sm.DEFAULT_KEY_BITS)[live].numpy(),
                          np.asarray(j_sm.unpack_keys(j_packed, jnp.asarray(origin.numpy())))[live.numpy()])
    assert torch.equal(vm.VoxelMap.create(1 << 10, device="cpu").origin,
                       torch.full((3,), -512, dtype=torch.int32))


def _cloud(rng, center, n=3000, scale=4.0):
    pts = (rng.uniform(-scale, scale, size=(n, 3)) + center).astype(np.float32)
    covs = np.tile(np.array([0.01, 0, 0, 0.01, 0, 0.01], np.float32), (n, 1))
    return torch.as_tensor(pts), torch.as_tensor(covs), torch.ones(n, dtype=torch.bool)


@pytest.mark.parametrize("bits", [(10, 10, 10), URBAN])
def test_eviction_recentres_the_origin_on_the_sensor(bits, rng):
    kw = dict(voxel_size=VS, max_points_per_voxel=1000, key_bits=bits)
    m = vm.VoxelMap.create(1 << 14, device="cpu", key_bits=bits)
    assert m.origin.tolist() == [-(1 << (b - 1)) for b in bits]
    m, dropped = vm.insert(m, *_cloud(rng, (20.0, -10.0, 1.0)), **kw)
    assert int(dropped) == 0
    d_live = m.d_skey[m.d_skey != vm.INT32_MAX]
    before = {tuple(k) for k in sm.unpack_keys(m.packed, m.origin, bits)[m.live()].tolist()}
    before |= {tuple(k) for k in sm.unpack_keys(sm.packed_of_skey(d_live), m.origin, bits).tolist()}
    center = torch.tensor([30.0, -20.0, 2.0])
    m2, removed = vm.evict_beyond(m, center, distance_threshold=100.0, **kw)
    c = torch.floor(center / VS).to(torch.int32)
    assert m2.origin.tolist() == [int(c[i]) - (1 << (b - 1)) for i, b in enumerate(bits)]
    assert int(removed) == 0
    after = {tuple(k) for k in sm.unpack_keys(m2.packed, m2.origin, bits)[m2.live()].tolist()}
    assert after == before  # every voxel kept, under the new origin
    # the lookup finds the same voxels after the re-centring
    pts = _cloud(rng, (20.0, -10.0, 1.0), n=500)[0]
    a, b = (vm.lookup(x, pts, voxel_size=VS, key_bits=bits) for x in (m, m2))
    assert torch.equal(a[2], b[2]) and torch.allclose(a[0], b[0])


def test_a_point_past_the_default_span_is_kept_by_the_wider_split(rng):
    """200 m from the origin along x: outside +-153.6 m, inside +-307.2 m."""
    pts, covs, valid = _cloud(rng, (200.0, 0.0, 0.0), n=400, scale=2.0)
    kw = dict(voxel_size=VS, max_points_per_voxel=1000)
    narrow, span_n, cap_n = vm.insert_split(vm.VoxelMap.create(1 << 12, device="cpu"), pts, covs,
                                            valid, **kw)
    wide, span_w, cap_w = vm.insert_split(vm.VoxelMap.create(1 << 12, device="cpu", key_bits=URBAN),
                                          pts, covs, valid, key_bits=URBAN, **kw)
    assert int(span_n) == 400 and int(cap_n) == 0 and int(narrow.num_voxels()) == 0
    assert int(span_w) == 0 and int(cap_w) == 0 and int(wide.num_voxels()) > 0
    assert bool(vm.lookup(wide, pts, key_bits=URBAN, **kw)[2].all())
    assert not bool(vm.lookup(narrow, pts, **kw)[2].any())


def test_a_fold_is_stamped_and_counted(rng):
    """Eagerly, the fold branch records a `fold` span and one `map_folds`
    count; the append branch neither."""
    tracer = Tracer()
    kw = dict(voxel_size=VS, max_points_per_voxel=1000, tracer=tracer)
    m = vm.VoxelMap.create(1 << 14, device="cpu")  # a delta tier of 2,048 rows
    m, *_ = vm.insert_split(m, *_cloud(rng, (0.0, 0.0, 0.0), n=500), **kw)
    assert tracer.counters.get("map_folds", 0) == 0
    m, span, cap = vm.insert_split(m, *_cloud(rng, (30.0, 0.0, 0.0), n=4000, scale=10.0), **kw)
    assert tracer.counters["map_folds"] == 1 and int(span) == 0 and int(cap) == 0
    stage(tracer, "end")  # closes the open stage, as the step's last mark does
    assert [s[0] for s in tracer.spans()].count("fold") == 1
    assert int((m.d_skey != vm.INT32_MAX).sum()) == 0


def test_config_reads_the_split_from_yaml(tmp_path):
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump({"tpu": {"map_key_bits": [11, 11, 9]}}))
    assert t_config.load_config(str(path)).map_key_bits == URBAN
    assert t_config.Config().map_key_bits == (10, 10, 10)


def test_checkpoint_records_the_split_and_refuses_another(tmp_path):
    seq = t_dataset.make_synthetic_sequence(duration=0.6, points_per_scan=3000, seed=3)
    kw = dict(max_raw_points=4096, max_scan_points=2048, max_imu_per_scan=48, hash_capacity_log2=12,
              translation_noise=1e-4, rotation_noise=3e-5)
    wide = t_config.Config(map_key_bits=URBAN, **kw)
    odo = Odometry(wide, device="cpu")
    odo.run(seq, max_scans=3)
    assert odo.voxmap.origin.tolist() != [-512, -512, -512]
    checkpoint.save_checkpoint(str(tmp_path / "c"), odo)
    same = checkpoint.load_checkpoint(str(tmp_path / "c"), Odometry(wide, device="cpu"))
    assert torch.equal(same.voxmap.skey, odo.voxmap.skey)
    with pytest.raises(ValueError, match="key split"):
        checkpoint.load_checkpoint(str(tmp_path / "c"),
                                   Odometry(dataclasses.replace(wide, map_key_bits=(10, 10, 10)),
                                            device="cpu"))


@pytest.mark.parametrize("bits", [(10, 10, 10), (11, 11, 9)])
def test_a_full_delta_bucket_folds_and_drops_no_voxel(bits, rng):
    """A map that grows by 400 random voxels a batch: a new voxel that
    finds its delta-view bucket full folds the delta into the main tier
    (the JAX package drops it), so every voxel is kept, and some of the
    folds come before the delta's rows run out."""
    m = vm.VoxelMap.create(1 << 16, device="cpu", key_bits=bits)  # a delta tier of 4,096 rows
    dropped, keys, early_folds = 0, set(), 0
    for _ in range(110):
        pts, covs, valid = _cloud(rng, (0.0, 0.0, 0.0), n=400, scale=30.0)
        fill = int(m.d_fill())
        m, span, cap = vm.insert_split(m, pts, covs, valid, voxel_size=VS, max_points_per_voxel=1000,
                                       key_bits=bits)
        new = {tuple(k) for k in torch.floor(pts / VS).to(torch.int32).tolist()} - keys
        early_folds += int(int(m.d_fill()) == 0 and fill + len(new) <= m.delta_capacity)
        dropped += int(span) + int(cap)
        keys |= new
    assert dropped == 0 and early_folds > 0
    assert int(m.num_voxels()) == len(keys)
