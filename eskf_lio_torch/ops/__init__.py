"""ops of the PyTorch port (mirrors `eskf_lio_tpu/ops/`)."""
