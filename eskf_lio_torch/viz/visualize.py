"""Offline map + trajectory viewer.

Counterpart of the reference's `visualize.cpp` (`:3-47`): loads the saved
PCD + trajectory JSON and renders a z-coloured cloud, the trajectory
polyline (green, like the reference's LineSet), and pose frames every `frame_stride` poses (the reference draws a
coordinate frame every 50, `visualize.cpp:27-32`).  Matplotlib instead of an
Open3D window — headless-friendly, writes a PNG.

Usage:
    python -m eskf_lio_torch.viz.visualize map.pcd trajectory.json out.png
"""

from __future__ import annotations

import sys

import numpy as np


def render(
    cloud_path: str,
    trajectory_path: str,
    out_path: str,
    frame_stride: int = 50,
    max_points: int = 200_000,
) -> None:
    from eskf_lio_torch.io.export import read_pcd, read_trajectory_json

    pts = read_pcd(cloud_path)
    _, Rs, ps = read_trajectory_json(trajectory_path)
    render_arrays(pts, Rs, ps, out_path, frame_stride, max_points)


def render_arrays(
    pts: np.ndarray,
    Rs,
    ps,
    out_path: str,
    frame_stride: int = 50,
    max_points: int = 200_000,
) -> None:
    """Render a (cloud, trajectory) snapshot directly from arrays — the
    in-memory path used by the live viewer (`viz.live`)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
    ps = np.asarray(ps)

    fig = plt.figure(figsize=(14, 7))
    # top view
    ax1 = fig.add_subplot(1, 2, 1)
    ax1.scatter(pts[:, 0], pts[:, 1], s=0.2, c=pts[:, 2], cmap="viridis")
    if len(ps):
        ax1.plot(ps[:, 0], ps[:, 1], "g-", lw=1.5, label="trajectory")
        for k in range(0, len(ps), frame_stride):
            R = np.asarray(Rs[k])
            for axis_idx, color in ((0, "r"), (1, "g")):
                d = R[:, axis_idx] * 0.8
                ax1.arrow(ps[k, 0], ps[k, 1], d[0], d[1], color=color,
                          width=0.02, head_width=0.1)
    ax1.set_aspect("equal")
    ax1.set_title("top view (z-coloured)")
    ax1.legend(loc="upper right")

    # side view
    ax2 = fig.add_subplot(1, 2, 2)
    ax2.scatter(pts[:, 0], pts[:, 2], s=0.2, c=pts[:, 2], cmap="viridis")
    if len(ps):
        ax2.plot(ps[:, 0], ps[:, 2], "g-", lw=1.5)
    ax2.set_aspect("equal")
    ax2.set_title("side view")

    fig.tight_layout()
    fig.savefig(out_path, dpi=130)
    plt.close(fig)


def main(argv: list[str] | None = None) -> None:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 3:
        print(__doc__)
        raise SystemExit(2)
    render(*argv)
    print(f"wrote {argv[2]}")


if __name__ == "__main__":
    main()
