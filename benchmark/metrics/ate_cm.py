"""RMSE of the window's trajectory against the generator's ground truth
after the rigid (Umeyama) alignment, in cm (`benchmark/stats.py`)."""


def read(run):
    return None if "ate_m" not in run else run["ate_m"] * 100.0
