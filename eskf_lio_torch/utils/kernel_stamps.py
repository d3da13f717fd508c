"""Where the time goes INSIDE the port's two CUDA kernels, by clock stamps
(no JAX counterpart: a measuring tool of the port).

    python -m eskf_lio_torch.utils.kernel_stamps     # from a checkout, on the card

`torch.profiler` gives a kernel's duration, not its phases.  This tool
builds a stamped copy of each `csrc/` source — thread 0 of every block
writes `clock64()` into a tensor at the points named in `GN_STAMPS` and
`SEG_STAMPS` — runs it at the main path's shapes (kernel A at N = 16,384,
kernel B at N = 131,072, W = 10 on keys shaped like a padded scan) and
prints the cycles between consecutive stamps: for kernel A of the block
that drew the last ticket, for kernel B the median, 90th percentile and
maximum over the tiles.  The SM clock printed beside them converts cycles
to time.  A stamp costs a few instructions, so the stamped kernel's own
duration is printed too, to hold against the unstamped one's.

The stamped copies are written and built under `build/kernels/stamped/`;
the package never loads them.  The stamps are placed by text anchors in
the sources: `apply_stamps` raises when an anchor no longer matches, and
`tests/test_torch_package.py` runs it on the CPU.
"""

from __future__ import annotations

import subprocess

from eskf_lio_torch.ops import _cuda
from eskf_lio_torch.ops._cuda import INT, PTR, CudaKernel

SLOTS = 16  # stamps a block

MACRO = """
#define STAMP(i) if (threadIdx.x == 0) stamps[blockIdx.x * 16 + (i)] = clock64();
"""

# (phase that ends here, anchor text, stamp goes before the anchor?)
GN_STAMPS = [
    ("start", "  float c[kSums];\n", True),
    ("loads staged", "    __syncthreads();\n    if (!live) continue;", True),
    ("arithmetic", "  // block reduction: [28, 128] terms", True),
    ("block reduction", "  // the block that draws the last ticket finishes the sums.", True),
    ("fence", "    const unsigned drawn = atomicAdd(ticket, 1u);\n", True),
    ("ticket + fence", "  if (!s_last) return;\n", True),
    ("partials loaded + summed", "  __syncthreads();\n  if (tid < 36) {", True),
    ("outputs written", "  } else if (tid == 43) {\n    *ticket = 0u;\n  }\n", False),
]
SEG_STAMPS = [
    ("start", "  if (tid == 0) {\n    s_tile = T - 1 - atomicAdd(&counters[0], 1);", True),
    ("ticket", "  const int t = s_tile;\n", False),
    ("tile loaded", "  float x[R][WMAX];", True),
    ("rows to registers", "    // the thread's own rows\n", True),
    ("thread rows", "    // warp scan over (sum of the thread's leading run, open)\n", True),
    ("warp scan", "    // the pair of the threads after this one in the warp\n", True),
    ("aggregates + barrier", "    // (every lane computes a column; lanes past W repeat the last one)\n", True),
    ("warp chain", "    if (warp == 0 && lane < W) {\n      // the tile's lead-run sum", True),
    ("publish + carries", "    if (chain && !s_halo_closed) {", True),
    ("look-ahead + barrier", "  if (scan_thread) {\n    // every row:", True),
    ("final adds + store", "  // the last tile to finish resets the ticket", True),
]
# (old, new) edits that hand the stamps tensor down to the kernel
GN_PLUMBING = [
    ("unsigned* ticket, float* __restrict__ out) {",
     "unsigned* ticket, float* __restrict__ out, long long* stamps) {"),
    ("float* scratch, float* out, void* stream) {",
     "float* scratch, float* out, void* stream, long long* stamps) {"),
    ("scratch,\n      ticket, out);", "scratch,\n      ticket, out, stamps);"),
]
SEG_PLUMBING = [
    ("int* counters,\n                float* __restrict__ out) {",
     "int* counters,\n                float* __restrict__ out, long long* stamps) {"),
    ("float* out, void* stream) {", "float* out, void* stream, long long* stamps) {"),
    ("pub, cap, counters, out);", "pub, cap, counters, out, stamps);"),
]


def apply_stamps(source: str, stamps: list, plumbing: list) -> str:
    """The source with a STAMP at every anchor and the stamps pointer handed
    down.  Raises ValueError when an anchor or an edit no longer matches."""
    for old, new in plumbing:
        if old not in source:
            raise ValueError(f"kernel_stamps: the source no longer holds {old!r}")
        source = source.replace(old, new)
    for i, (phase, anchor, before) in enumerate(stamps):
        if source.count(anchor) != 1:
            raise ValueError(f"kernel_stamps: anchor of {phase!r} matches "
                             f"{source.count(anchor)} times, expected once")
        at = source.index(anchor) + (0 if before else len(anchor))
        source = source[:at] + f"  STAMP({i})\n" + source[at:]
    return source.replace("namespace {\n", "namespace {\n" + MACRO, 1)


def stamped_kernel(name: str, stamps: list, plumbing: list, functions: dict) -> CudaKernel:
    out_dir = _cuda.BUILD_DIR / "stamped"
    out_dir.mkdir(parents=True, exist_ok=True)
    path = out_dir / f"{name}.cu"
    path.write_text(apply_stamps((_cuda.CSRC_DIR / f"{name}.cu").read_text(), stamps, plumbing))
    return CudaKernel(name, path, functions)  # an absolute path stands for itself


def report(label: str, stamps: list, cycles) -> None:
    """`cycles` [blocks, SLOTS] of one launch; prints each phase's median /
    p90 / max over the blocks that reached it."""
    import numpy as np

    print(f"{label}: cycles per phase, median / p90 / max over {len(cycles)} blocks")
    for i in range(1, len(stamps)):
        d = (cycles[:, i] - cycles[:, i - 1])[cycles[:, i] > 0]
        print(f"  {stamps[i][0]:28s} {np.median(d):8.0f} {np.percentile(d, 90):8.0f} {d.max():8d}")
    total = cycles[:, len(stamps) - 1] - cycles[:, 0]
    total = total[total > 0]
    print(f"  {'start to last stamp':28s} {np.median(total):8.0f} "
          f"{np.percentile(total, 90):8.0f} {total.max():8d}")


def device_ms(fn, iters: int = 50) -> float:
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import numpy as np
    import torch

    from eskf_lio_torch.ops import gn_normal_eq, segscan

    if not torch.cuda.is_available():
        print("kernel_stamps needs an NVIDIA GPU")
        return 2
    dev = torch.device("cuda", 0)
    stream = _cuda.stream_handle(dev)
    rng = np.random.default_rng(0)
    def smi(fields: str) -> str:
        return subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip()

    print(f"card: {smi('name,power.limit')}")

    kernel_a = stamped_kernel("gn_normal_eq", GN_STAMPS, GN_PLUMBING, {
        "gn_normal_eq_launch": [PTR, PTR, PTR, INT, INT, PTR, PTR, PTR, INT, PTR, PTR, PTR, PTR],
        "gn_normal_eq_scratch_bytes": [],
    })
    kernel_b = stamped_kernel("segscan", SEG_STAMPS, SEG_PLUMBING, {
        "segscan_launch": [PTR, PTR, INT, INT, PTR, INT, PTR, PTR, PTR],
        "segscan_scratch_bytes": [INT],
    })
    _cuda.build([kernel_a, kernel_b])

    # kernel A at the align budget: 70 % of the rows live
    n = 16384

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32), device=dev)

    def spd_packed():
        a = f32(n, 3, 3) * 0.3
        cov = a @ a.mT + 0.05 * torch.eye(3, device=dev)
        return cov[:, [0, 0, 0, 1, 1, 2], [0, 1, 2, 1, 2, 2]].contiguous()

    pts = f32(n, 3) * 8.0
    args = (pts, spd_packed(), torch.eye(3, device=dev), pts + f32(n, 3) * 0.1, spd_packed(),
            torch.as_tensor(rng.random(n) < 0.7, device=dev))
    plain = gn_normal_eq.normal_equations_rotated_ref(*args)
    scratch = torch.zeros(kernel_a.query("gn_normal_eq_scratch_bytes") // 4, device=dev)
    out = torch.empty(43, device=dev)
    stamps = torch.zeros(1024 * SLOTS, dtype=torch.int64, device=dev)

    def run_a():
        p, c, R, m, q, k = args
        kernel_a.launch("gn_normal_eq_launch", p.data_ptr(), c.data_ptr(), R.data_ptr(), 3, 1,
                        m.data_ptr(), q.data_ptr(), k.data_ptr(), n, scratch.data_ptr(),
                        out.data_ptr(), stream, stamps.data_ptr())

    print(f"kernel A, stamped: {device_ms(run_a):.5f} ms per back-to-back launch")
    stamps.zero_()
    run_a()
    torch.cuda.synchronize()
    if not torch.allclose(out[:36].view(6, 6), plain[0], rtol=1e-3, atol=1e-2):
        print("kernel A, stamped: disagrees with the plain version")
        return 1
    cycles = stamps.view(-1, SLOTS).cpu().numpy()
    last = cycles[cycles[:, len(GN_STAMPS) - 1] > 0]  # only the last block gets that far
    report("kernel A, the block with the last ticket", GN_STAMPS, last)
    report("kernel A, every block up to its ticket", GN_STAMPS[:6], cycles[cycles[:, 0] > 0])

    # kernel B on keys shaped like a padded scan: ~10 rows a voxel over
    # 120,000 rows, then 11,072 padding rows of one key and zero values
    n, w, live = 131072, 10, 120000
    keys = np.full(n, np.iinfo(np.int32).max, np.int32)
    keys[:live] = np.sort(rng.integers(0, live // 10, live))
    vals = rng.normal(size=(n, w)).astype(np.float32)
    vals[live:] = 0.0
    keys, vals = torch.as_tensor(keys, device=dev), torch.as_tensor(vals, device=dev)
    cap = 1024
    scratch_b = torch.zeros(kernel_b.lib().segscan_scratch_bytes(cap) // 8, dtype=torch.int64, device=dev)
    out_b = torch.empty_like(vals)

    def run_b():
        kernel_b.launch("segscan_launch", keys.data_ptr(), vals.data_ptr(), n, w,
                        scratch_b.data_ptr(), cap, out_b.data_ptr(), stream, stamps.data_ptr())

    print(f"kernel B, stamped: {device_ms(run_b):.5f} ms per back-to-back launch")
    stamps.zero_()
    run_b()
    torch.cuda.synchronize()
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = keys[1:] != keys[:-1]
    if not torch.allclose(out_b[head], segscan.segsum_sorted_ref(keys, vals)[head], rtol=1e-3, atol=1e-3):
        print("kernel B, stamped: disagrees with the plain version")
        return 1
    cycles = stamps.view(-1, SLOTS).cpu().numpy()
    report("kernel B", SEG_STAMPS, cycles[cycles[:, 0] > 0])
    print(f"SM clock right after the runs: {smi('clocks.sm')}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
