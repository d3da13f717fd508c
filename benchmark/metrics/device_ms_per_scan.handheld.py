"""The mean device span of a row of the handheld replay: CUDA events
recorded before and after every row of the window, never synchronised
inside it, read as `device_ms_per_scan.urban` reads them."""

from benchmark.harness import reader

read = reader("device_ms_per_scan.urban")
