"""The mean of `Odometry.timer` over the window's sweeps: the host
driver's own clock from chunk building to the pose's read-back."""


def read(run):
    return run.get("driver_step_ms")
