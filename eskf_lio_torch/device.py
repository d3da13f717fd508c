"""Device policy of the port (no JAX counterpart: JAX picks its backend).

Entry points take an explicit `device=` that defaults to the card.  They
run on the CPU only when the caller asks for it (`device="cpu"`, as the
tests do); on a host without CUDA the default raises here instead of
falling back silently.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device: str | torch.device | None = DEFAULT_DEVICE) -> torch.device:
    """Turn a device argument into a `torch.device`, refusing CUDA when no
    card is present."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "eskf_lio_torch runs on an NVIDIA GPU by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!r}: use 'cuda' or 'cpu'")
    return dev
