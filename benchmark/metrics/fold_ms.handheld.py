"""The insert's fold of the delta tier into the main tier in the handheld
replay's window: from the `fold` stamp inside the fold branch to the next
stamp, the mean over the rows that fold, in ms of device time."""


def read(run):
    return run.get("handheld", {}).get("stage_ms", {}).get("fold")
