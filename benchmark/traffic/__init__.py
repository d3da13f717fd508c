"""The traffic generator (see `generator.py`)."""
