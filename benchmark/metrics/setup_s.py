"""Seconds from the process's start to the window's start: CUDA start-up,
the kernels' build (from the checkout's cache after the first run), the
stream's generation, packing and upload, the init scan, every graph's
capture and the warm-up rows (host clock)."""


def read(run):
    return run.get("setup_s")
