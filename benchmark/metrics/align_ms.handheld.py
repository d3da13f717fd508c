"""The `align` stage of the handheld replay's window rows: from its stamp
to the next stamp inside the captured step (`utils.profiling.Tracer`),
the mean over the rows that hold it, in ms of device time."""


def read(run):
    return run.get("handheld", {}).get("stage_ms", {}).get("align")
