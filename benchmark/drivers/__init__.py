"""The drivers of the benchmark, one per kind of traffic (`replay`,
`live`); a mix names its driver."""
