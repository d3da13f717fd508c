"""The eviction in the urban replay's window: from the `evict` stamp to the
end of the step, the mean over the evicting rows, in ms of device time."""


def read(run):
    return run.get("urban", {}).get("stage_ms", {}).get("evict")
