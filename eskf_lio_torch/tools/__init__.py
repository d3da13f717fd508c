"""The JAX package's diagnostic scripts (`tools/*.py`), ported.  Each runs as
`python -m eskf_lio_torch.tools.<name>`, on the card by default and on the
CPU only when asked (`--device cpu`, or `device="cpu"` from Python), and
prints the JAX script's own lines, in its schema and under its names, then
one `{"device": "<nvidia-smi name, power limit>"}` line (`"cpu"` on the
CPU).  Where the port computes a piece another way than the JAX package, the
line says so (`"port": ...`, or `port: ...` after a text line).

| JAX script                          | module                |
| ----------------------------------- | --------------------- |
| `tools/light_stages.py`             | `light_stages`        |
| `tools/profile_preprocess.py`       | `profile_preprocess`  |
| `tools/probe_align_parts.py`        | `probe_align_parts`   |
| `tools/probe_adaptive.py`           | `probe_adaptive`      |
| `tools/ate_check.py`                | `ate_check`           |
| `tools/ate_matrix.py`               | `ate_matrix`          |
| `tools/bench_scaling_mesh.py`       | `bench_scaling_mesh`  |
| `tools/bench_shard.py`              | `bench_shard`         |
| `tools/bench_compile.py`            | `bench_compile`       |
| `tools/compile_bisect.py`           | `compile_bisect`      |

Timing is `eskf_lio_torch.bench.StageTimer`'s: a piece is captured once as
a CUDA graph, replayed k times between CUDA events, less k replays of a
one-kernel graph (the JAX scripts' K iterations inside one dispatch less an
empty scan of the same K).  The port has no XLA compile: where a JAX script
reports compile seconds, its module reports the first eager call and the
capture.
"""

from __future__ import annotations

import argparse
import json

import torch

from eskf_lio_torch import device as device_policy
from eskf_lio_torch.bench import nvidia_smi_line


def parser(description: str) -> argparse.ArgumentParser:
    """A tool's argument parser with the port's `--device`."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=device_policy.DEFAULT_DEVICE,
                    help="'cuda' (default) or 'cpu' (the plain paths, for tests)")
    return ap


def emit(line: dict) -> None:
    print(json.dumps(line), flush=True)


def report_device(dev: torch.device) -> None:
    """The last line of every tool: the hardware its numbers came from."""
    emit({"device": nvidia_smi_line() if dev.type == "cuda" else "cpu"})
