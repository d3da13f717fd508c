"""The `align` stage of the urban replay's window rows: from its stamp to
the next stamp inside the captured step (`utils.profiling.Tracer`), the
mean over the rows, in ms of device time."""


def read(run):
    return run.get("urban", {}).get("stage_ms", {}).get("align")
