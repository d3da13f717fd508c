"""The mean device span of a row of the urban replay: CUDA events recorded
before and after every row of the window, never synchronised inside it."""


def read(run):
    ms = run.get("row_spans_ms")
    return None if not ms else sum(ms) / len(ms)
