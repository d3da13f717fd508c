"""The eviction in the handheld replay's window: from the `evict` stamp to
the end of the step, the mean over the evicting rows, in ms of device time."""


def read(run):
    return run.get("handheld", {}).get("stage_ms", {}).get("evict")
