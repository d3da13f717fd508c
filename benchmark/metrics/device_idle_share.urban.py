"""The share of the urban replay window's device timeline in which no row
ran, read as `device_idle_share.replay` reads it."""

from benchmark.harness import reader

read = reader("device_idle_share.replay")
