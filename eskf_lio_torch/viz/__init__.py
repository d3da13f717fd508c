"""viz of the PyTorch port (mirrors `eskf_lio_tpu/viz/`): numpy + lazy matplotlib."""
