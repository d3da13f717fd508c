"""The port's threaded streaming pipeline (`eskf_lio_torch/pipeline/
stream.py`) vs its synchronous driver, as `tests/test_stream.py` holds the
JAX package's.

The property the two-thread pipeline must guarantee is that the filter sees
identical inputs — every scan once, in order, with the same IMU chunk and
evict schedule as the synchronous driver.  Those inputs are a pure function
of the record stream, so their digests compare BITWISE whatever the host
load.  The output is held against ground truth (ATE < 0.1 m, that test's
bound) and, since the CPU path of the port is deterministic, against the
synchronous trajectory to 1e-2 m (the overhang sample may or may not have
arrived when a chunk is cut, which changes nothing the step reads).
"""

import threading

import numpy as np
import pytest
import torch

from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset, native_runtime
from eskf_lio_torch.io.dataset import ImuRecord
from eskf_lio_torch.pipeline import stream
from eskf_lio_torch.pipeline.odometry import Odometry
from eskf_lio_torch.pipeline.stream import StreamingRunner, merged_stream
from eskf_lio_torch.utils.metrics import ate_rmse
from test_torch_odometry import record_step_inputs

torch.set_num_threads(2)

# tests/test_stream.py's CFG
CFG = Config(
    imu=ImuConfig(gravity=(0.0, 0.0, -9.81)),
    max_raw_points=8192,
    max_scan_points=4096,
    max_imu_per_scan=48,
    hash_capacity_log2=16,
)


@pytest.fixture(scope="module")
def seq():
    return dataset.make_synthetic_sequence(duration=2.0, points_per_scan=8000, seed=7)


def test_streaming_matches_synchronous(seq):
    sync = Odometry(CFG, device="cpu")
    sync_inputs: list = []
    record_step_inputs(sync, sync_inputs)
    sync.run(seq)

    runner = StreamingRunner(CFG, device="cpu")
    stream_inputs: list = []
    record_step_inputs(runner.odo, stream_inputs)
    summary = runner.run(merged_stream(seq))

    assert summary["num_scans"] == len(sync.trajectory_t)
    assert stream_inputs == sync_inputs
    assert not summary["diverged"]
    assert runner.ingest == ("native" if native_runtime.native_available() else "python")

    gt = seq.gt_positions[: len(runner.odo.positions)]
    assert ate_rmse(runner.odo.positions, gt, align=True) < 0.1
    np.testing.assert_allclose(runner.odo.positions, sync.positions, atol=1e-2)


def test_streaming_max_scans(seq):
    runner = StreamingRunner(CFG, device="cpu")
    summary = runner.run(merged_stream(seq), max_scans=5)
    assert summary["num_scans"] == 5
    # the ingest thread ends with the run, though its source was not exhausted
    assert not any(t.name == "ingest" for t in threading.enumerate())


def test_streaming_on_scan_hook_and_ingest_error(seq):
    seen = []
    runner = StreamingRunner(CFG, device="cpu")
    runner.run(merged_stream(seq), max_scans=3, on_scan=lambda odo: seen.append(len(odo.trajectory_t)))
    assert seen == [1, 2, 3]

    def broken():
        yield seq.imu[0]
        raise OSError("sensor unplugged")

    with pytest.raises(OSError, match="sensor unplugged"):
        StreamingRunner(CFG, device="cpu").run(broken())


def test_merged_stream_is_time_ordered(seq):
    recs = list(merged_stream(seq))
    assert len(recs) == len(seq.imu) + len(seq.scans)
    times = [r.t if isinstance(r, ImuRecord) else r.end_time for r in recs]
    assert times == sorted(times)


def imu_records(n):
    rng = np.random.default_rng(4)
    return [
        ImuRecord(t=100.0 + 0.0025 * i, gyro=rng.normal(size=3), accel=rng.normal(size=3))
        for i in range(n)
    ]


@pytest.mark.parametrize("native", [True, False])
def test_imu_channel_round_trip(native, monkeypatch):
    if native and not native_runtime.native_available():
        pytest.skip("native runtime not built")
    if not native:
        monkeypatch.setattr(native_runtime, "load", lambda build_if_missing=True: None)
    ch = stream._ImuChannel(64)
    assert ch.native is native
    recs = imu_records(20)
    for r in recs:
        ch.push(r)
    out = ch.pop_all()
    assert [r.t for r in out] == [r.t for r in recs]
    # the ring carries gyro / accel as f32
    np.testing.assert_allclose(out[7].gyro, recs[7].gyro, rtol=1e-6)
    np.testing.assert_allclose(out[7].accel, recs[7].accel, rtol=1e-6)
    assert ch.pop_all() == []


def test_imu_channel_hides_no_other_error(monkeypatch):
    """Only "native runtime unavailable" selects the deque; anything else
    from the native queue surfaces."""

    def refuse(*a, **k):
        raise MemoryError("spsc_create failed")

    monkeypatch.setattr(native_runtime, "NativeSpscQueue", refuse)
    with pytest.raises(MemoryError):
        stream._ImuChannel()


def test_streaming_runner_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingRunner(CFG)
