"""The plain reference of the filter step (see `step.py`)."""
