"""Kernel segscan's bound (`benchmark/roofline.py`: its bytes over 3.35 TB/s
or its operations over 67 TFLOP/s) over its device time a launch on a real
row of the window (`benchmark/stages.py::kernel_ms`), in %."""


def read(run):
    return run.get("kernels", {}).get("segscan", {}).get("share_percent")
