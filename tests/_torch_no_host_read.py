"""`NoHostRead`, the dispatch mode under which the port's CPU tests run a
captured step's function: it fails on every read of a device value.  Used by
`tests/test_torch_graphs.py`, `tests/test_torch_sharding.py` and the worker
processes of `tests/test_torch_distributed.py`; imports torch only."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode


class NoHostRead(TorchDispatchMode):
    """Raises on every op that makes the host wait for a value on the
    device: a scalar read (`item`, `bool`, `int`, indexing with a 0-dim
    tensor), `nonzero`, or an index by a bool mask (which runs one)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten._local_scalar_dense.default, torch.ops.aten.nonzero.default):
            raise AssertionError(f"host read: {func}")
        if func.__name__.startswith(("index.", "index_put")):
            indices = args[1] if len(args) > 1 else ()
            if any(isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in indices):
                raise AssertionError(f"host read: {func} with a bool mask")
        return func(*args, **(kwargs or {}))
