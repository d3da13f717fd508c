"""The align slice's overflow a row of the handheld replay's window: the
step's counter `align_slice_overflow`, the scan's live voxels past
`max_align_points` that Gauss-Newton never sees, summed over the window's
rows over the rows."""


def read(run):
    return run.get("handheld", {}).get("align_slice_overflow_per_row")
