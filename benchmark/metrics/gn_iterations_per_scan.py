"""GN iterations over the window's update rows (the step's diagnostics)."""


def read(run):
    if not run.get("update_rows"):
        return None
    return run["gn_iterations"] / run["update_rows"]
