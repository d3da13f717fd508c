"""The insert's folds a row in the urban replay's window: the device
counter `map_folds`, one count in each fold branch run, over the window's
rows."""


def read(run):
    return run.get("urban", {}).get("folds_per_row")
