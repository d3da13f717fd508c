"""The kernels' shares are timed on the kernels' own arguments: one eager
step of the port on a real row, with each kernel's first call kept."""

import torch

from benchmark import check, stages
from benchmark.drivers import common
from benchmark.reference import pack
from benchmark.tests import small


def test_kernel_inputs_are_the_first_calls_of_a_real_step():
    from eskf_lio_torch.map import voxel_map as vm
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.pipeline import odometry as odo
    from eskf_lio_torch.types import ImuChunk, Scan

    torch.set_num_threads(2)
    cpu = torch.device("cpu")
    cell = small.cell(traffic="replay")
    config = common.program_config(cell.config["config"])
    stream, _ = common.generate(cell, cpu)
    ref_config = check.reference_config(cell.config["config"])
    voxmap = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=cpu)
    voxmap, _ = odo.make_init_step(config, cpu)(voxmap, Scan(*pack.init_scan(stream, ref_config, cpu)))
    chunk, scan = pack.row(stream, 1, ref_config, cpu, shifted=False)
    probe = {"state": eskf.init_state(config, cpu), "voxmap": voxmap, "R": torch.eye(3),
             "t": torch.zeros(3), "chunk": ImuChunk(*chunk), "scan": Scan(*scan)}
    kept = stages.kernel_inputs(config, probe, cpu)

    keys, vals = kept["segscan"]
    assert vals.shape == (config.max_raw_points, 10) and keys.shape == (config.max_raw_points,)
    assert bool((keys[1:] >= keys[:-1]).all())  # sorted, as the kernel takes them
    assert int((vals[:, 0] > 0).sum()) == int(scan.valid.sum())  # one weight a point
    pts_w, covs, R, mu, cov_map, mask = kept["gn_normal_eq"]
    assert pts_w.shape == (config.align_capacity, 3) and R.shape == (3, 3)
    assert 0 < int(mask.sum()) <= config.align_capacity
    # the probe's map is left as it was
    assert torch.equal(probe["voxmap"].skey, voxmap.skey)
