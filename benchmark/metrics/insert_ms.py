"""The insert stage's device ms on the warm map after the window, on the
window's next row (`benchmark/stages.py`: one captured graph replayed
between CUDA events, less an empty graph's replay)."""


def read(run):
    return run.get("stage_ms", {}).get("insert")
