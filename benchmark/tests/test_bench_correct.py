"""`correct` on the CPU at a small size: the plain reference agrees with
the port's CPU path, and a run whose timed path is broken underneath comes
out not correct, for each fault a cell can have: a step that returns its
state unchanged, half of a scan's points left out, a pose altered where it
is produced, and, where eviction removes voxels (a threshold inside the
room), an eviction that removes none.  The drivers are called directly,
past the harness's look for a card."""

import pytest
import torch

from benchmark.drivers import live, replay
from benchmark.tests import small

SEED = 2**31 + 12345


def _replay_fault(kind):
    def wrap(step):
        def broken(state, voxmap, prev_R, prev_t, chunks, scans, evicts, updates):
            if kind == "half":
                n = scans.valid.shape[1]
                valid = scans.valid.clone()
                valid[:, n // 2:] = False
                scans = scans._replace(valid=valid)
            if kind == "no_evict":
                evicts = torch.zeros_like(evicts)
            out = step(state, voxmap, prev_R, prev_t, chunks, scans, evicts, updates)
            if kind == "unchanged":
                return (state, voxmap, prev_R, prev_t, *out[4:])
            if kind == "pose":
                return (*out[:5], out[5] + 0.01, out[6])
            return out
        return broken
    return wrap


def _live_fault(kind):
    def wrap(odo):
        step = odo.scan_step

        def broken(state, voxmap, prev_R, prev_t, chunk, scan, do_evict):
            if kind == "half":
                n = scan.valid.shape[0]
                valid = scan.valid.clone()
                valid[n // 2:] = False
                scan = scan._replace(valid=valid)
            if kind == "no_evict":
                do_evict = False
            out = step(state, voxmap, prev_R, prev_t, chunk, scan, do_evict)
            if kind == "unchanged":
                return (state, voxmap, prev_R, prev_t, out[4])
            if kind == "pose":
                return (*out[:3], out[3] + 0.01, out[4])
            return out
        odo.scan_step = broken
    return wrap


@pytest.fixture(scope="module")
def threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_the_reference_agrees_with_the_port_on_the_cpu(threads):
    rec = replay.run(small.cell(traffic="replay"), SEED, 1.5, False, device="cpu")
    assert rec["correct"], rec["checks"]
    # the same arithmetic on the same inputs: equal to the last bit
    assert max(rec["info"]["readings"].values()) == 0.0
    assert len(rec["info"]["blocks"]) >= 1 and rec["ate_m"] < 0.02


@pytest.mark.parametrize("fault", ["unchanged", "half", "pose"])
def test_a_broken_replay_is_not_correct(threads, fault):
    rec = replay.run(small.cell(traffic="replay"), SEED, 1.0, False, device="cpu",
                     fault=_replay_fault(fault))
    assert not rec["correct"]
    assert any(c["value"] > c["limit"] for c in rec["checks"].values())


@pytest.mark.parametrize("fault", [None, "unchanged", "half", "pose"])
def test_the_live_stream_is_correct_only_unbroken(threads, fault):
    rec = live.run(small.cell(traffic="live10hz"), SEED + 1, 1.0, False, device="cpu",
                   fault=None if fault is None else _live_fault(fault))
    assert rec["correct"] == (fault is None), rec["checks"]
    assert rec["attempted"] == 10 and rec["failed"] == 0


def _evicting(traffic):
    """A small cell whose eviction removes voxels in the block drawn around
    it: a threshold of 8 m inside the 20 m room, every half second."""
    c = small.cell(traffic=traffic)
    c.config["config"].update(remove_distance_threshold=8.0, remove_period=0.5)
    return c


@pytest.mark.parametrize("fault", [None, "no_evict"])
@pytest.mark.parametrize("traffic", ["replay", "live10hz"])
def test_an_eviction_that_removes_voxels_is_compared(threads, traffic, fault):
    driver = replay if traffic == "replay" else live
    wrap = _replay_fault if traffic == "replay" else _live_fault
    rec = driver.run(_evicting(traffic), SEED + 2, 1.0, False, device="cpu",
                     fault=None if fault is None else wrap(fault))
    assert rec["correct"] == (fault is None), rec["checks"]
    if fault is not None:
        assert rec["checks"]["map_count_gap"]["value"] > rec["checks"]["map_count_gap"]["limit"]


def test_a_row_one_gn_iteration_apart_is_run_to_the_judged_count(threads):
    """Where the judged side took one GN iteration more on a row, the
    reference runs that row again to the same count: the pose then comes
    from as many iterations; a row two apart is left as it ran."""
    from benchmark import check
    from benchmark.drivers import common

    cpu = torch.device("cpu")
    cell = small.cell(traffic="replay")
    config = check.reference_config(cell.config["config"])
    stream, _ = common.generate(cell, cpu)
    block = check.Block(ks=[1, 2, 3], evicts=[False] * 3)
    own = check.run_reference(block, stream, config, cpu, shifted=False)
    same = check.run_reference(block, stream, config, cpu, shifted=False, follow=own["iterations"])
    assert same["forced_rows"] == 0
    assert all(torch.equal(a[1], b[1]) for a, b in zip(own["poses"], same["poses"]))
    more = list(own["iterations"])
    more[1] += 1
    one = check.run_reference(block, stream, config, cpu, shifted=False, follow=more)
    assert one["forced_rows"] == 1 and one["iterations"] == own["iterations"]
    assert torch.equal(one["poses"][0][1], own["poses"][0][1])
    assert not torch.equal(one["poses"][1][1], own["poses"][1][1])
    more[1] += 1
    two = check.run_reference(block, stream, config, cpu, shifted=False, follow=more)
    assert two["forced_rows"] == 0
