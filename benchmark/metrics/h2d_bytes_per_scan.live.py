"""`Odometry.h2d_bytes` counted over the window's update scans, per scan."""


def read(run):
    return run.get("h2d_bytes_per_scan")
