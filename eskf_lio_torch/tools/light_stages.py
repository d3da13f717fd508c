"""Per-stage breakdown at the LIGHT series' shapes (port of
`tools/light_stages.py`): the bench's LIGHT series (`run_series`), then the
same stage timing the bench runs at HEAVY (`stage_breakdown`) on LIGHT's
warm map, with no budget.

    python -m eskf_lio_torch.tools.light_stages [--device cpu]

Prints the series line (the JAX line's keys, plus the timed half's kernel
launches counted on the device), `{"light_stages_ms": {...}}` and the
device line.
"""

from __future__ import annotations

import sys

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy


def main(argv: list[str] | None = None, series: bench.Series | None = None) -> int:
    """`series` replaces LIGHT (a test's small series)."""
    args = tools.parser("Per-stage breakdown at the LIGHT series' shapes.").parse_args(argv)
    dev = device_policy.resolve(args.device)
    s = series or bench.make_series(bench.LIGHT)
    out = bench.run_series(s.config, s.seq, dev)
    probe = out.pop("_probe")
    out.pop("_est_positions")
    tools.emit(out)
    tools.emit({"light_stages_ms": bench.stage_breakdown(s.config, probe, lambda: 1e9, dev)})
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
