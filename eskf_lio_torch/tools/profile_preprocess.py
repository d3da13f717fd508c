"""Sub-stage profile of preprocessing (port of `tools/profile_preprocess.py`):
each piece of the downsampler, the deskew and the map probe, at the JAX
script's sizes and on its input (`default_rng(0)`: 131,072 points uniform in
[-40, 40]^3, a 32,768-row budget, a 2^19-row map), and the whole stages.

    python -m eskf_lio_torch.tools.profile_preprocess [--device cpu]

Prints one text line per piece, `{name:28s} {ms:8.3f} ms`, in the JAX
script's order, then the device line.  After the time: `(raw ...)`, the
time before the empty graph's is taken off (the JAX script's own number has
no such subtraction), and, for a piece the port computes another way, how
(`  port: ...`).  Beside the JAX pieces: the row
gather the port's deskew runs in place of the one-hot product, and the
three separable neighbourhood passes of the downsampler
(`ops/preprocess.py::_axis_pass`), and the whole stages' plain versions
(on a card the whole stages run the kernels of `csrc/preprocess.cu`).  Each piece is one captured graph
replayed k times less an empty graph's k replays (`bench.StageTimer`).
"""

from __future__ import annotations

import sys
from typing import Callable, NamedTuple

import numpy as np
import torch

from eskf_lio_torch import bench, tools
from eskf_lio_torch import device as device_policy
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.ops import eig3, preprocess, segscan
from eskf_lio_torch.ops import sortmerge as sm
from eskf_lio_torch.ops import voxel as vx
from eskf_lio_torch.types import Pose, Scan, StateHistory

N_RAW = 131072
KCAP = 32768
C_LOG2 = 19
K = 50
K_FULL = 30
VOXEL = 0.3
N_STATES = 65  # the deskew's pose table: 64 IMU states and the base


class Piece(NamedTuple):
    name: str
    fn: Callable[[], object]  # returns the piece's outputs
    k: int
    note: str | None = None


def make_inputs(n_raw: int, kcap: int, c_log2: int, dev: torch.device) -> dict:
    """The JAX script's inputs, drawn from `default_rng(0)` in its order."""
    rng = np.random.default_rng(0)
    pts = torch.as_tensor(rng.uniform(-40, 40, size=(n_raw, 3)).astype(np.float32), device=dev)
    config = Config(imu=ImuConfig(), max_raw_points=n_raw, max_scan_points=kcap,
                    hash_capacity_log2=c_log2, map_delta_log2=14)
    keys = vx.voxel_key(pts, VOXEL)
    origin = torch.full((3,), -512, dtype=torch.int32, device=dev)
    packed, _ = sm.pack_keys(keys, origin)
    q = pts - (keys.to(torch.float32) + 0.5) * VOXEL
    # the port indexes with int64 (torch.sort's permutation), JAX with int32
    perm = torch.as_tensor(rng.permutation(n_raw), device=dev)
    raw14 = torch.cat([q, q.repeat(1, 3), q[:, :2]], dim=1)
    permk = torch.as_tensor(rng.permutation(kcap), device=dev)
    m10 = raw14[:kcap, :10].contiguous()

    # the separable passes' inputs as the downsampler makes them: ascending
    # live keys (dead tail INT32_MAX), then each pass's output re-sorted by
    # the next axis's key
    live = torch.unique(packed)[:kcap]
    t_packed = torch.full((kcap,), sm.INT32_MAX, dtype=torch.int32, device=dev)
    t_packed[: live.shape[0]] = live
    axis_vec = torch.eye(3, device=dev) * config.downsample_voxel_size
    z_in = (t_packed, m10, axis_vec[2])
    ky_s, _, packed_y, m_zs = sm.sort_perm(preprocess._rotate_key(t_packed, 1), t_packed,
                                           preprocess._axis_pass(*z_in))
    y_in = (ky_s, m_zs, axis_vec[1])
    kx_s, _, m_ys = sm.sort_perm(preprocess._rotate_key(packed_y, 0),
                                 preprocess._axis_pass(*y_in))
    x_in = (kx_s, m_ys, axis_vec[0])

    hist = StateHistory(
        t_rel=torch.cat([torch.full((1,), -torch.inf, device=dev),
                         torch.linspace(-0.1, 0.003, N_STATES - 1, device=dev)]),
        p=torch.zeros((N_STATES, 3), device=dev),
        q=torch.tensor([1.0, 0.0, 0.0, 0.0], device=dev).repeat(N_STATES, 1),
        valid=torch.ones(N_STATES, dtype=torch.bool, device=dev),
    )
    scan = Scan(points=pts, t_rel=torch.linspace(-0.1, 0.0, n_raw, device=dev),
                valid=torch.ones(n_raw, dtype=torch.bool, device=dev))
    return dict(
        config=config, pts=pts, packed=packed, q=q, perm=perm, raw14=raw14,
        seg=torch.clamp(perm, max=n_raw - 1), vals10=raw14[:, :10].contiguous(),
        skey_sorted=torch.sort(sm.skey_of(packed)).values,
        # the JAX script's deskew table (ones) and state index (one state)
        table=torch.ones((N_STATES, 12), device=dev),
        state_idx=torch.zeros(n_raw, dtype=torch.int64, device=dev),
        classes=torch.arange(N_STATES, device=dev),
        packed_k=packed[:kcap].contiguous(), permk=permk, m10=m10,
        covs33=(torch.eye(3, device=dev) * 0.01).expand(kcap, 3, 3).contiguous(),
        axis_in={"z": z_in, "y": y_in, "x": x_in},
        view=vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity,
                                device=dev).view,
        skey_k=sm.skey_of(packed[:kcap]),
        scan=scan, hist=hist, T_il=Pose.identity(dev),
        valid=torch.ones(n_raw, dtype=torch.bool, device=dev),
    )


def one_hot_deskew(state_idx, classes, table):
    """The JAX package's pose fetch: a one-hot [N, M+1] product."""
    return (state_idx[:, None] == classes[None, :]).to(table.dtype) @ table


def pieces(inp: dict, k: int = K, k_full: int = K_FULL) -> list[Piece]:
    n = inp["pts"].shape[0]
    kcap = inp["m10"].shape[0]
    nk, kk = f"{n // 1000}k", f"{kcap // 1000}k"
    config = inp["config"]
    axis = [
        Piece(f"axis_pass {a} [{kk},10]", lambda a=a: preprocess._axis_pass(*inp["axis_in"][a]), k,
              "not a JAX line: the downsampler's separable pass along " + a)
        for a in ("z", "y", "x")
    ]
    return [
        Piece(f"sort2 @{nk}", lambda: sm.sort_perm(inp["packed"]), k,
              "stable torch.sort of the key; int64 perm"),
        Piece(f"gather q[perm] [{nk},3]", lambda: inp["q"][inp["perm"]], k),
        Piece(f"gather [{nk},14]", lambda: inp["raw14"][inp["perm"]], k),
        Piece(f"gather [{nk}->{kk},14]", lambda: inp["raw14"][inp["perm"][:kcap]], k),
        Piece(f"segment_sum [{nk},10]",
              lambda: torch.zeros_like(inp["vals10"]).index_add_(0, inp["seg"], inp["vals10"]),
              k, "zeros + index_add_ (jax.ops.segment_sum)"),
        Piece(f"segscan kernel [{nk},10]",
              lambda: segscan.segsum_sorted(inp["skey_sorted"], inp["vals10"]), k,
              "kernel B, csrc/segscan.cu"),
        Piece("one-hot deskew matmul",
              lambda: one_hot_deskew(inp["state_idx"], inp["classes"], inp["table"]), k,
              "not on the port's path"),
        Piece(f"deskew row gather [{nk}]", lambda: inp["table"][inp["state_idx"]], k,
              "not a JAX line: the port's deskew fetch (ops/preprocess.py::deskew)"),
        Piece(f"sort2 @{kk}", lambda: sm.sort_perm(inp["packed_k"]), k,
              "stable torch.sort of the key; int64 perm"),
        Piece(f"gather [{kk},10]", lambda: inp["m10"][inp["permk"]], k),
        Piece(f"plane_regularize [{kk}]",
              lambda: eig3.plane_regularize(inp["covs33"], 1e-2), k),
        *axis,
        Piece(f"view probe [{kk}] @C=2^{config.hash_capacity.bit_length() - 1}",
              lambda: vm._view_probe(inp["view"], inp["skey_k"]), k),
        Piece("preprocess FULL",
              lambda: preprocess.preprocess(inp["scan"], inp["hist"], inp["T_il"], config),
              k_full, "on a card the kernels of csrc/preprocess.cu"),
        Piece("downsample+cov FULL",
              lambda: preprocess.downsample_and_covariances(inp["pts"], inp["valid"], config),
              k_full, "on a card the kernels of csrc/preprocess.cu"),
        Piece("preprocess FULL plain",
              lambda: preprocess.preprocess_ref(inp["scan"], inp["hist"], inp["T_il"], config),
              k_full, "not a JAX line: the plain version (ops/preprocess.py::preprocess_ref)"),
        Piece("downsample+cov FULL plain",
              lambda: preprocess.downsample_and_covariances_ref(inp["pts"], inp["valid"], config),
              k_full, "not a JAX line: the plain version"),
    ]


def text_line(name: str, ms: float, raw_ms: float, note: str | None = None) -> str:
    return (f"{name:28s} {ms:8.3f} ms  (raw {raw_ms:.4f} ms)"
            + (f"  port: {note}" if note else ""))


def main(argv: list[str] | None = None, n_raw: int = N_RAW, kcap: int = KCAP,
         c_log2: int = C_LOG2, k: int = K, k_full: int = K_FULL) -> int:
    args = tools.parser("Sub-stage profile of preprocessing.").parse_args(argv)
    dev = device_policy.resolve(args.device)
    inp = make_inputs(n_raw, kcap, c_log2, dev)
    timer = bench.StageTimer(dev, n_raw)
    for piece in pieces(inp, k, k_full):
        ms, raw_ms, _ = timer.measure(piece.fn, lambda: None, piece.k)
        print(text_line(piece.name, ms, raw_ms, piece.note), flush=True)
    tools.report_device(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
