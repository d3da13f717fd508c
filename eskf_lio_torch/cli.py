"""Command-line entrypoint of the PyTorch/CUDA port.

Counterpart of the reference's node `main` (`main.cpp:46-83`) and port of
`eskf_lio_tpu/cli.py`, flag for flag: load config, build the odometry
driver, consume the measurement stream, and on exit save the map + the
trajectory and print the per-stage timing summary (`Odometry.cpp:99-109`).
Instead of ROS topics the stream comes from an npz sequence file, a rosbag2
file or directory, or the built-in synthetic simulator.

The run is on the card (`--device cuda`, the default) and refuses to start
without one; `--device cpu` runs the plain PyTorch path on the CPU.

`--devices D` shards the map D ways (`parallel/sharded_map.py`): in one
process all D shards lie on the one device; with `--coordinator HOST:PORT
--num-processes P --process-id I` the same command runs as P processes (one
per GPU; D / P shards each), every process reads the same input, and process
0 writes the artifacts.  As in the JAX CLI, `--stream` and `--replay` run
single-device and ignore `--devices`.  The report says whether the scan
step ran as a captured CUDA graph or eagerly, and why (`scan step: ...`).

Usage:
    python -m eskf_lio_torch.cli --config config/hilti.yaml \
        --input seq.npz --cloud-out map.pcd --traj-out traj.json
    python -m eskf_lio_torch.cli --synthetic 20 --stream \
        --cloud-out map.pcd --traj-out traj.json --viz out.png
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", help="YAML config (reference schema)")
    ap.add_argument(
        "--input",
        help="npz sequence file, rosbag2 .db3 file, or rosbag2 directory",
    )
    ap.add_argument("--imu-topic", default="/alphasense/imu")
    ap.add_argument("--lidar-topic", default="/hesai/pandar")
    ap.add_argument(
        "--synthetic", type=float, metavar="SECONDS",
        help="run the synthetic simulator for SECONDS instead of --input",
    )
    ap.add_argument("--points-per-scan", type=int, default=20000)
    ap.add_argument("--max-scans", type=int, default=None)
    ap.add_argument(
        "--replay", action="store_true",
        help="offline replay mode (the whole sequence packed onto the device)",
    )
    ap.add_argument(
        "--stream", action="store_true",
        help="threaded streaming mode: ingest thread + native SPSC queues "
        "(the reference's two-thread architecture, main.cpp:58-70)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="'cuda' (default; raises without a GPU) or 'cpu'",
    )
    ap.add_argument(
        "--devices", type=int, default=1,
        help="shard the map this many ways (the default scan-at-a-time mode; "
        "--stream and --replay run single-device and ignore it); the shards "
        "are dealt to the processes, all of a process's on its one device",
    )
    ap.add_argument(
        "--coordinator", default=None, metavar="HOST:PORT",
        help="multi-process: address of process 0 for torch.distributed (also "
        "via ESKF_LIO_COORDINATOR); every process runs this same command",
    )
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cloud-out", default=None)
    ap.add_argument(
        "--dense-cloud", type=int, default=None, metavar="K",
        help="export up to K sampled points per voxel instead of one mean "
        "point (parity with the reference's dense PCD dump, "
        "LocalMap.cpp:156-167)",
    )
    ap.add_argument("--traj-out", default=None)
    ap.add_argument("--viz", default=None, help="render a PNG of the result")
    ap.add_argument(
        "--viz-live", default=None, metavar="PNG",
        help="re-render a live map+trajectory PNG during the run "
        "(the reference's per-loop visualizeLocalMap role)",
    )
    ap.add_argument(
        "--viz-every", type=int, default=20,
        help="live-render period in scans (with --viz-live)",
    )
    ap.add_argument("--checkpoint-out", default=None)
    ap.add_argument("--resume-from", default=None)
    ap.add_argument(
        "--trace-out", default=None, metavar="JSON",
        help="trace the run (host spans, counters, the step's device spans and stage "
        "stamps) and write it as a Chrome-trace file that Perfetto opens; off without it",
    )
    args = ap.parse_args(argv)

    # multi-process: form the process group BEFORE any device use (it
    # also makes this process's card the current device)
    from eskf_lio_torch.parallel import distributed as dist

    try:
        n_procs, proc_id = dist.initialize(
            coordinator=args.coordinator,
            num_processes=args.num_processes,
            process_id=args.process_id,
            device=args.device,
        )
    except ValueError as exc:
        ap.error(str(exc))
    if n_procs > 1:
        print(f"distributed: process {proc_id}/{n_procs}")
    try:
        rc = _run(ap, args, n_procs, proc_id)
    except BaseException:
        dist.shutdown(wait=False)  # a failed process does not wait for its peers
        raise
    dist.shutdown()
    return rc


def _run(ap, args, n_procs: int, proc_id: int) -> int:
    from eskf_lio_torch import device as device_policy
    from eskf_lio_torch.config import Config, ImuConfig, load_config
    from eskf_lio_torch.io import dataset, export
    from eskf_lio_torch.utils.profiling import Tracer

    device = device_policy.resolve(args.device)
    tracer = Tracer() if args.trace_out else None

    if args.config:
        config = load_config(args.config)
    else:
        config = Config(imu=ImuConfig(gravity=(0.0, 0.0, -9.81)))

    if args.synthetic:
        seq = dataset.make_synthetic_sequence(
            duration=args.synthetic, points_per_scan=args.points_per_scan
        )
    elif args.input:
        if args.input.endswith(".db3") or os.path.isdir(args.input):
            # rosbag2 directly — the reference's `ros2 bag play` path
            # (`launch/eskf_lio.launch.py:11-13`) without needing ROS
            from eskf_lio_torch.io import rosbag2

            seq = rosbag2.load_rosbag2(
                args.input,
                imu_topic=args.imu_topic,
                lidar_topic=args.lidar_topic,
                max_scans=args.max_scans,
            )
        else:
            seq = dataset.load_npz(args.input)
    else:
        ap.error("one of --input / --synthetic is required")

    viewer = None
    if args.viz_live:
        if args.replay:
            ap.error("--viz-live needs a scan-at-a-time mode (not --replay: "
                     "the whole sequence runs before anything is read back)")
        from eskf_lio_torch.viz.live import LiveViewer

        viewer = LiveViewer(args.viz_live, every=args.viz_every)

    t0 = time.perf_counter()
    if args.replay:
        from eskf_lio_torch.pipeline import replay as rp

        positions, rotations, diags, voxmap = rp.run_replay(
            config, seq, max_scans=args.max_scans, device=device, tracer=tracer
        )
        n = len(positions)
        elapsed = time.perf_counter() - t0
        print(f"processed {n} scans in {elapsed:.2f} s "
              f"({n / elapsed:.1f} scans/s, replay mode)")
        print(f"icp convergence rate: {diags['icp_converged'].mean():.2%}")

        class _Shim:  # adapt replay outputs to the export interface
            pass

        odo = _Shim()
        odo.voxmap = voxmap
        odo.trajectory_t = list(range(n))
        odo.trajectory_R = list(rotations)
        odo.trajectory_p = list(positions)
    elif args.stream:
        from eskf_lio_torch.pipeline.stream import StreamingRunner, merged_stream

        runner = StreamingRunner(config, device=device, tracer=tracer)
        odo = runner.odo
        if args.resume_from:
            from eskf_lio_torch.utils import checkpoint

            checkpoint.load_checkpoint(args.resume_from, odo)
        summary = runner.run(
            merged_stream(seq), max_scans=args.max_scans,
            on_scan=viewer.on_scan if viewer else None,
        )
        print(
            f"step average elapsed time = {summary['avg_step_ms']:.2f} ms"
        )
        print(f"throughput = {summary['scans_per_sec']:.1f} scans/s "
              f"(streaming, threaded ingest)")
        print(f"map voxels = {summary['map_voxels']}")
        print(f"scan step: {odo.step_reason}")
        if args.checkpoint_out:
            from eskf_lio_torch.utils import checkpoint

            checkpoint.save_checkpoint(args.checkpoint_out, odo)
    else:
        if args.devices > 1:
            from eskf_lio_torch.parallel.sharded_map import ShardedOdometry

            odo = ShardedOdometry(config, n_devices=args.devices, device=device,
                                  tracer=tracer)
        else:
            from eskf_lio_torch.pipeline.odometry import Odometry

            odo = Odometry(config, device=device, tracer=tracer)
        if args.resume_from:
            from eskf_lio_torch.utils import checkpoint

            checkpoint.load_checkpoint(args.resume_from, odo)
        summary = odo.run(
            seq, max_scans=args.max_scans,
            on_scan=viewer.on_scan if viewer else None,
        )
        # the reference's exit report (`Odometry.cpp:99-109`)
        print(
            f"step average elapsed time = {summary['avg_step_ms']:.2f} ms"
        )
        print(f"step max elapsed time = {summary['max_step_ms']:.2f} ms")
        print(f"throughput = {summary['scans_per_sec']:.1f} scans/s")
        print(f"map voxels = {summary['map_voxels']}")
        print(f"scan step: {odo.step_reason}")
        if n_procs > 1:
            from eskf_lio_torch.parallel.distributed import ALL_REDUCE

            per_call = 1e3 / max(ALL_REDUCE.calls, 1)
            print(f"all-reduce: {ALL_REDUCE.calls} calls, "
                  f"{ALL_REDUCE.seconds * per_call:.3f} ms per call on the host "
                  f"({ALL_REDUCE.backend_seconds * per_call:.3f} ms in the backend)")
        if args.checkpoint_out:
            from eskf_lio_torch.utils import checkpoint

            checkpoint.save_checkpoint(args.checkpoint_out, odo)

    if viewer is not None:
        viewer.close()
        print(f"live view rendered {viewer.renders}x to {args.viz_live}")

    if args.cloud_out:
        # the map extraction below is a collective under a process group
        # (the shards are gathered) — run it on every process, write on
        # process 0
        if args.dense_cloud:
            pts = export.map_to_dense_cloud(
                odo.voxmap, samples_per_voxel=args.dense_cloud
            )
        else:
            pts, _ = export.map_to_cloud(odo.voxmap)
        if proc_id == 0:
            export.write_pcd(args.cloud_out, pts)
            print(f"saved {args.cloud_out}")

    if n_procs > 1 and proc_id != 0:
        return 0  # only process 0 writes the remaining artifacts
    if tracer is not None:
        tracer.export(args.trace_out)
        print(f"saved {args.trace_out} ({tracer.n} spans)")
    if args.traj_out:
        export.write_trajectory_json(
            args.traj_out, odo.trajectory_t, odo.trajectory_R,
            odo.trajectory_p,
        )
        print(f"saved {args.traj_out}")
    if args.viz:
        if not (args.cloud_out and args.traj_out):
            ap.error("--viz requires --cloud-out and --traj-out")
        from eskf_lio_torch.viz.visualize import render

        render(args.cloud_out, args.traj_out, args.viz)
        print(f"rendered {args.viz}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
