"""utils of the PyTorch port (mirrors `eskf_lio_tpu/utils/`)."""
