"""Live map visualization during a run.

The reference redraws its Open3D window with the current cloud, pose frame,
and trajectory every loop iteration (`LocalMap.cpp:120-130`).  Headless GPU hosts have no window, so the equivalent is a PNG
(re-)rendered every N scans — point a browser/image viewer at it for the
same at-a-glance health check.

Never stalls the device feed: the driver thread only snapshots the map
(one device fetch); matplotlib rendering runs on a daemon worker thread
that always consumes the LATEST snapshot and drops frames when it falls
behind.
"""

from __future__ import annotations

import threading

import numpy as np


class LiveViewer:
    """Callback object for `Odometry.run(on_scan=...)` /
    `StreamingRunner.run(on_scan=...)`.

    Usage:
        viewer = LiveViewer("live.png", every=20)
        odo.run(seq, on_scan=viewer.on_scan)
        viewer.close()
    """

    def __init__(
        self,
        out_path: str,
        every: int = 20,
        frame_stride: int = 50,
        max_points: int = 200_000,
    ):
        self.out_path = out_path
        self.every = max(1, every)
        self.frame_stride = frame_stride
        self.max_points = max_points
        self.renders = 0  # completed renders (for tests/observability)

        self._count = 0
        self._latest = None  # newest pending snapshot
        self._cv = threading.Condition()
        self._stop = False
        self._worker = threading.Thread(
            target=self._render_loop, name="live-viewer", daemon=True
        )
        self._worker.start()

    # -- driver-thread side --------------------------------------------------

    def on_scan(self, odo) -> None:
        """Call after every processed scan; snapshots the map every
        `self.every` scans and hands it to the render worker."""
        self._count += 1
        if self._count % self.every:
            return
        from eskf_lio_torch.io import export

        pts, _ = export.map_to_cloud(odo.voxmap)  # one device fetch
        Rs = [np.asarray(R) for R in odo.trajectory_R]
        ps = [np.asarray(p) for p in odo.trajectory_p]
        with self._cv:
            self._latest = (pts, Rs, ps)  # overwrite: latest wins
            self._cv.notify()

    def close(self, render_final: bool = True) -> None:
        """Stop the worker; by default waits for one final render of the
        last snapshot so the PNG reflects the end state."""
        with self._cv:
            if not render_final:
                self._latest = None
            self._stop = True
            self._cv.notify()
        self._worker.join(timeout=60)

    # -- worker side -----------------------------------------------------

    def _render_loop(self) -> None:
        from eskf_lio_torch.viz.visualize import render_arrays

        while True:
            with self._cv:
                while self._latest is None and not self._stop:
                    self._cv.wait()
                snap, self._latest = self._latest, None
                if snap is None and self._stop:
                    return
                stop_after = self._stop
            pts, Rs, ps = snap
            try:
                render_arrays(
                    pts, Rs, ps, self.out_path,
                    frame_stride=self.frame_stride,
                    max_points=self.max_points,
                )
                self.renders += 1
            except Exception as e:  # viz must never kill the run
                print(f"live viewer render failed: {e}")
            if stop_after:
                return
