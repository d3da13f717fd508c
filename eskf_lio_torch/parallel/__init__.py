"""Scaling over map shards and processes: the voxel map partitioned by owner
hash, with the VGICP normal equations summed over the shards (mirrors
`eskf_lio_tpu/parallel/`)."""
