"""`benchmark/trace_cell.py`: a cell's driver run with the program built
with the port's tracer.  On the CPU at a small size, both drivers: every
window sweep tiled from its due time to its pose, the proposed metrics
finite, the drivers' runner restored afterwards.  On the card, both cells
at full size for a few seconds: every proposed metric finite, the stamps
covering the row, the driver's ten gaps named in its order."""

import math

import pytest
import torch

from benchmark import harness, trace_cell
from benchmark.tests import small

LIVE = ("queue_wait_ms.live", "gate_wait_ms.live", "gate_polls_per_scan.live",
        "imu_push_lag_ms.live", "host_prep_ms.live", "readback_wait_ms.live", "graph_capture_s")
REPLAY = ("host_ms_per_row.replay", "graph_nodes.replay", "graph_capture_s", "predict_ms.window",
          "preprocess_ms.window", "align_ms.window", "insert_ms.window", "evict_ms.window")


def finite(metrics: dict, names) -> bool:
    return all(metrics.get(n) is not None and math.isfinite(metrics[n]) and metrics[n] >= 0
               for n in names)


def test_live_sweeps_tile_from_due_to_pose_on_the_cpu():
    from eskf_lio_torch.pipeline import replay, stream

    runner, make_step = stream.StreamingRunner, replay.make_replay_step
    torch.set_num_threads(2)
    out = trace_cell.trace(small.cell(traffic="live10hz"), 2718281829, 1.0, device="cpu")
    assert stream.StreamingRunner is runner and replay.make_replay_step is make_step
    assert out["correct"] and out["tiled_sweeps"] == out["window_sweeps"] == 10
    assert finite(out["metrics"], LIVE[:-1])
    for tile in (out["tile_median"], out["tile_p95"]):
        # the spans add up to the driver's latency but for the loop's own lines
        assert tile["spans_sum_less_latency"] == pytest.approx(-tile["untraced"], abs=1e-3)
        assert 0 <= tile["untraced"] < 0.05 * tile["latency_ms"] + 2.0
        assert tile["imu_push_lag"] > 0  # pushed after its due time on the paced clock
    assert out["window_counters"]["gate_polls"] == pytest.approx(
        out["metrics"]["gate_polls_per_scan.live"] * 10)


def test_replay_rows_are_traced_on_the_cpu():
    torch.set_num_threads(2)
    out = trace_cell.trace(small.cell(traffic="replay"), 1414213562, 0.5, device="cpu")
    assert out["correct"] and out["run"]["rows"] > 0
    assert out["metrics"]["host_ms_per_row.replay"] > 0
    assert out["host_ms"]["copy_out"] > 0


@pytest.mark.parametrize("workload,names", [("mid360.live10hz", LIVE), ("mid360.replay", REPLAY)])
def test_the_traced_cell_on_the_card(card, workload, names):
    out = trace_cell.trace(harness.load_cell(workload), 1732050808, 4.0, device="cuda")
    assert out["correct"] and finite(out["metrics"], names)
    assert out["graph_captures"] >= 2 and out["clock"]["anchors"] >= 2
    gaps = out["gaps_named"]
    assert len(gaps) == 10 and [g[0] for g in gaps] == sorted((g[0] for g in gaps), reverse=True)
    assert all(g[2] and g[2][-1][0] == "outside the program" for g in gaps)
    if workload == "mid360.replay":
        assert 0.9 <= out["stamps_cover"] <= 1.0
        assert out["gn_stamps_per_row"] == pytest.approx(out["gn_iterations_per_row"])
    else:
        assert out["tiled_sweeps"] == out["window_sweeps"]
        assert abs(out["tile_median"]["spans_sum_less_latency"]) < 0.3
