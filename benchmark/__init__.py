"""The benchmark of the PyTorch and CUDA port, `eskf_lio_torch` (see
`run.py`)."""
