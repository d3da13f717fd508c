"""GN iterations over the urban replay's window rows (the step's
diagnostics), read as `gn_iterations_per_scan` reads them."""

from benchmark.harness import reader

read = reader("gn_iterations_per_scan")
