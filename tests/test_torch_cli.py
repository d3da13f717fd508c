"""The port's command line (`python -m eskf_lio_torch.cli`): the JAX CLI's
flags, modes and report lines, plus `--device`.

The subprocess cases run with `--device cpu` (there is no card here) at the
sizes of `tests/test_cli_config.py`; without the flag the CLI must refuse to
start rather than run on the CPU.  The multi-device flags are served by
`parallel/`: `--devices D` runs the sharded
driver with the JAX CLI's report, and half a multi-process layout exits with
an error that names what is missing, never as one process in silence.  (The
two-process CLI run is in `tests/test_torch_distributed.py`.)
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from eskf_lio_torch import cli as t_cli
from eskf_lio_torch.io import export

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_YAML = (
    "imu:\n  frequency: 400.0\n"
    "local_map:\n  map_resolution: 0.3\n"
    "tpu:\n"
    "  max_raw_points: 8192\n"
    "  max_scan_points: 4096\n"
    "  max_imu_per_scan: 48\n"
    "  hash_capacity_log2: 15\n"
)
SYNTH = ["--synthetic", "1.5", "--points-per-scan", "3000"]


def run_cli(*args):
    env = dict(os.environ, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "eskf_lio_torch.cli", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600,
    )


def pcd_points(path) -> int:
    with open(path) as f:
        for line in f:
            if line.startswith("POINTS"):
                return int(line.split()[1])
    raise AssertionError("no POINTS line")


def test_cli_synthetic_replay(tmp_path):
    pytest.importorskip("matplotlib")
    out_pcd, out_traj, out_png = (str(tmp_path / n) for n in ("m.pcd", "t.json", "v.png"))
    proc = run_cli(*SYNTH, "--replay", "--device", "cpu", "--cloud-out", out_pcd,
                   "--traj-out", out_traj, "--viz", out_png)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "scans/s, replay mode)" in proc.stdout
    assert "icp convergence rate:" in proc.stdout
    assert f"saved {out_pcd}" in proc.stdout and f"rendered {out_png}" in proc.stdout
    assert os.path.getsize(out_pcd) > 1000
    assert os.path.getsize(out_png) > 10000
    assert len(export.read_trajectory_json(out_traj)[0]) == 14


def test_cli_stream_vizlive_densecloud(tmp_path):
    pytest.importorskip("matplotlib")
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL_YAML)
    out_pcd, out_traj, live_png = (str(tmp_path / n) for n in ("m.pcd", "t.json", "live.png"))
    proc = run_cli("--config", str(cfg), *SYNTH, "--stream", "--device", "cpu",
                   "--viz-live", live_png, "--viz-every", "4", "--dense-cloud", "4",
                   "--cloud-out", out_pcd, "--traj-out", out_traj)
    assert proc.returncode == 0, proc.stderr[-2000:]
    # the JAX CLI's report, word for word
    assert "step average elapsed time = " in proc.stdout
    assert "scans/s (streaming, threaded ingest)" in proc.stdout
    assert "map voxels = " in proc.stdout
    assert "live view rendered" in proc.stdout
    assert os.path.getsize(live_png) > 10000
    assert os.path.getsize(out_pcd) > 1000


def test_cli_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device works")
    proc = run_cli(*SYNTH, "--stream")
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and "throughput" not in proc.stdout


@pytest.mark.parametrize(
    "flags", [["--devices", "2"], ["--coordinator", "localhost:1234"], ["--num-processes", "2"]],
    ids=lambda f: f[0],
)
def test_cli_multi_device_flags_name_the_roadmap_item(flags, capsys, monkeypatch):
    """Item 15 is ported: no flag is refused as "not ported" any more.
    `--devices 2` runs (sharded, one process); a coordinator without the
    process count, or a count without a coordinator, is an error that names
    the missing flags."""
    from eskf_lio_torch.parallel import distributed as dist

    for name in (dist.ENV_COORDINATOR, dist.ENV_NUM_PROCESSES, dist.ENV_PROCESS_ID):
        monkeypatch.delenv(name, raising=False)
    argv = [*SYNTH, "--device", "cpu", "--max-scans", "4", *flags]
    if flags[0] == "--devices":
        assert t_cli.main(argv) == 0
        out = capsys.readouterr().out
        for line in ("step average elapsed time = ", "step max elapsed time = ",
                     "throughput = ", "map voxels = "):
            assert line in out
        assert "distributed:" not in out
        return
    with pytest.raises(SystemExit) as exc:
        t_cli.main(argv)
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert "--coordinator" in err and "--num-processes" in err and "--process-id" in err
    assert "not ported" not in err and "ROADMAP" not in err
    assert not dist.is_initialized()


def test_cli_sharded_run_reports_as_the_jax_cli(tmp_path):
    """`--devices 2 --device cpu` in a process of its own: the JAX CLI's
    report lines, a PCD with one point per distinct voxel, one pose a scan;
    `--stream` ignores `--devices`, as the JAX CLI does."""
    out_pcd, out_traj = str(tmp_path / "m.pcd"), str(tmp_path / "t.json")
    proc = run_cli(*SYNTH, "--devices", "2", "--device", "cpu", "--cloud-out", out_pcd,
                   "--traj-out", out_traj)
    assert proc.returncode == 0, proc.stderr[-2000:]
    for line in ("step average elapsed time = ", "step max elapsed time = ",
                 "throughput = ", "map voxels = ", f"saved {out_pcd}", f"saved {out_traj}",
                 "scan step: eager: the step runs on the cpu"):
        assert line in proc.stdout
    assert len(export.read_trajectory_json(out_traj)[0]) == 14
    assert pcd_points(out_pcd) == len(export.read_pcd(out_pcd)) > 1000

    proc = run_cli(*SYNTH, "--devices", "2", "--device", "cpu", "--stream")
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "scans/s (streaming, threaded ingest)" in proc.stdout

    help_text = run_cli("--help").stdout
    assert "not ported" not in help_text and "--stream and --replay" in help_text


def test_cli_sharded_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device works")
    proc = run_cli(*SYNTH, "--devices", "2")
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr and "throughput" not in proc.stdout


def test_cli_sync_checkpoint_and_resume_in_process(tmp_path, capsys):
    """The default (synchronous) mode in process: report lines, a PCD with
    one point per map voxel, one pose per scan, and a checkpoint that the
    next invocation resumes from."""
    cfg = tmp_path / "small.yaml"
    cfg.write_text(SMALL_YAML)
    out_pcd, out_traj, ckpt = (str(tmp_path / n) for n in ("m.pcd", "t.json", "ckpt"))
    common = ["--config", str(cfg), *SYNTH, "--device", "cpu"]
    assert t_cli.main([*common, "--max-scans", "6", "--checkpoint-out", ckpt]) == 0
    first = capsys.readouterr().out
    for line in ("step average elapsed time = ", "step max elapsed time = ",
                 "throughput = ", "map voxels = "):
        assert line in first
    assert sorted(os.listdir(ckpt)) == ["arrays.npz", "meta.pkl"]

    assert t_cli.main([*common, "--resume-from", ckpt, "--cloud-out", out_pcd,
                       "--traj-out", out_traj]) == 0
    out = capsys.readouterr().out
    voxels = int(out.split("map voxels = ")[1].split()[0])
    assert pcd_points(out_pcd) == voxels == len(export.read_pcd(out_pcd))
    times, _, ps = export.read_trajectory_json(out_traj)
    # 6 poses from the checkpoint; the resumed run starts the sequence over,
    # so scans at or before the filter clock are not covered and it stops
    assert len(times) >= 6 and np.isfinite(np.asarray(ps)).all()


def test_cli_has_the_jax_clis_flags():
    """Every option of the JAX CLI, with the same default, plus --device and
    --trace-out (off by default)."""
    import eskf_lio_tpu.cli as j_cli

    def options(main_fn):
        found = {}

        class Stop(Exception):
            pass

        def grab(self, argv=None):
            for a in self._actions:
                if a.option_strings and a.dest != "help":
                    found[a.option_strings[0]] = a.default
            raise Stop

        orig = argparse.ArgumentParser.parse_args
        argparse.ArgumentParser.parse_args = grab
        try:
            with pytest.raises(Stop):
                main_fn([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return found

    t_opts, j_opts = options(t_cli.main), options(j_cli.main)
    assert t_opts.pop("--device") == "cuda"
    assert t_opts.pop("--trace-out") is None
    assert t_opts == j_opts


def test_cli_reads_an_npz_sequence(tmp_path, capsys):
    from eskf_lio_torch.io import dataset

    seq = dataset.make_synthetic_sequence(duration=0.6, points_per_scan=3000)
    path = str(tmp_path / "seq.npz")
    dataset.save_npz(path, seq)
    traj = str(tmp_path / "t.json")
    assert t_cli.main(["--input", path, "--device", "cpu", "--traj-out", traj]) == 0
    assert "throughput = " in capsys.readouterr().out
    with open(traj) as f:
        assert len(json.load(f)["parameters"]) == len(seq.scans)
