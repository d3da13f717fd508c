"""Multi-process wiring over `torch.distributed` (port of
`eskf_lio_tpu/parallel/distributed.py`).

The JAX package spreads one program over the devices of every host
(`jax.distributed` + a `Mesh`).  PyTorch's idiom is one process per GPU, so
here a run of D map shards over P processes gives each process L = D / P
local shards on its one device (`ShardMesh`); every process is fed the same
sensor stream in lockstep and holds the same filter state, bit for bit.

* `initialize()` forms the process group once per process, before any
  device use (the CLI's `--coordinator / --num-processes / --process-id`),
  and makes the process's card the current CUDA device.  Without arguments
  and environment it does nothing and the run is single-process.
* The backend is chosen from the layout, never by trial: `nccl` when every
  process of a host has a card of its own, `gloo` for CPU tensors and for
  processes that share a card (NCCL refuses two ranks on one GPU).
* `all_reduce_sum` is the GN loop's sum over processes.  Under `nccl` it
  runs on the current stream's turn, so a capture records it: the captured
  sharded step holds it inside the GN loop's WHILE node.  Under `gloo` a
  CUDA tensor is staged through the host, which no graph can hold
  (`staged`).  `gather_blocks` and
  `local_blocks` replace `replicate_to_mesh` / `shard_to_mesh`: per-process
  blocks to every process (or to one), and a full array cut to the caller's
  blocks.  Under `gloo` both stage CUDA tensors through the host (stock
  builds of gloo do not all-gather CUDA tensors).
* Every collective runs under the group's timeout and names itself when it
  fails: ranks that fall out of step (one leaves the GN loop an iteration
  early) end with an error, not with a stuck run.

Tested by `tests/test_torch_distributed.py`: two localhost processes of two
local shards each against the one-process four-shard run.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import torch
import torch.distributed as dist

from eskf_lio_torch import device as device_policy

ENV_COORDINATOR = "ESKF_LIO_COORDINATOR"  # host:port of process 0
ENV_NUM_PROCESSES = "ESKF_LIO_NUM_PROCESSES"
ENV_PROCESS_ID = "ESKF_LIO_PROCESS_ID"
ENV_PROCESSES_PER_HOST = "ESKF_LIO_PROCESSES_PER_HOST"
COLLECTIVE_TIMEOUT_S = 300.0
# a new number for every group this process forms: what a capture warmed
# under one group (`warm_up`) is not warm under the next
GROUP = {"generation": 0}


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return int(value) if value else None


def choose_backend(device: torch.device, processes_per_host: int, n_cards: int) -> str:
    """`nccl` when each process of a host has a card of its own; `gloo`
    for CPU tensors and for processes that share a card."""
    if device.type == "cuda" and processes_per_host <= n_cards:
        return "nccl"
    return "gloo"


def initialize(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
    processes_per_host: int | None = None,
    timeout_s: float = COLLECTIVE_TIMEOUT_S,
) -> tuple[int, int]:
    """Form the process group for a multi-process run.  Returns
    (num_processes, process_id).

    Arguments fall back to the environment — `ESKF_LIO_COORDINATOR`
    (host:port of process 0), `ESKF_LIO_NUM_PROCESSES`, `ESKF_LIO_PROCESS_ID`,
    `ESKF_LIO_PROCESSES_PER_HOST` (default: all on this host) — and to a
    single process when no coordinator and at most one process is given:
    then nothing is initialised and (1, 0) comes back.  Every process runs
    the same command with its own id.

    With `device="cuda"` process i of a host takes card `i mod cards` as its
    current device; the backend follows `choose_backend`.  Must run before
    the process creates its first tensor on the device."""
    coordinator = coordinator or os.environ.get(ENV_COORDINATOR)
    if num_processes is None:
        num_processes = _env_int(ENV_NUM_PROCESSES)
    if process_id is None:
        process_id = _env_int(ENV_PROCESS_ID)
    if processes_per_host is None:
        processes_per_host = _env_int(ENV_PROCESSES_PER_HOST)

    if coordinator is None and (num_processes or 1) <= 1:
        return 1, 0  # single-process: nothing to do
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs the coordinator's host:port, the number "
            "of processes and this process's id (--coordinator, --num-processes, "
            f"--process-id, or {ENV_COORDINATOR}, {ENV_NUM_PROCESSES}, {ENV_PROCESS_ID})"
        )
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} is not in [0, {num_processes})")

    dev = device_policy.resolve(device)
    per_host = processes_per_host or num_processes
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = choose_backend(dev, per_host, n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device((process_id % per_host) % n_cards)
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    GROUP["generation"] += 1
    return dist.get_world_size(), dist.get_rank()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def backend() -> str | None:
    """The process group's backend (`nccl`, `gloo`), None without a group."""
    return dist.get_backend() if is_initialized() else None


def staged(device: torch.device) -> bool:
    """Whether a collective on tensors of `device` goes through a host copy:
    under `gloo` with CUDA tensors.  Such a collective cannot be captured."""
    return torch.device(device).type == "cuda" and backend() == "gloo"


def warm_up(device: torch.device) -> None:
    """One all-reduce of one word on the current stream of `device` (a
    collective: every process calls it).  ProcessGroupNCCL makes its
    communicator, and its stream and events for this device, at the first
    collective; none of that may happen inside a capture, so
    `utils.graphs.prepare` calls this on each stream that captures."""
    if is_initialized():
        _collective("all_reduce", dist.all_reduce, torch.zeros(1, device=device))


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def shutdown(wait: bool = True) -> None:
    """Leave the process group, after a last barrier so that no process
    tears its sockets down under a peer's collective (`wait=False`: at once,
    for a process that failed)."""
    if is_initialized():
        if wait:
            barrier()
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """The layout of a sharded run: `n_shards` map shards dealt to the
    processes of the group in rank order, L = n_shards / processes to each,
    all L on the process's `device`.  The counterpart of the JAX package's
    one-axis `Mesh`."""

    n_shards: int
    device: torch.device
    num_processes: int = 1
    process_id: int = 0

    @staticmethod
    def create(n_shards: int, device="cuda") -> "ShardMesh":
        """The mesh of this process under the current process group (one
        process without a group)."""
        n, i = process_count(), process_index()
        if n_shards < 1 or n_shards % n:
            raise ValueError(
                f"{n_shards} map shards do not divide over {n} processes"
            )
        return ShardMesh(n_shards, device_policy.resolve(device), n, i)

    @property
    def shards_per_process(self) -> int:
        return self.n_shards // self.num_processes

    @property
    def local_shards(self) -> range:
        """Global indices of this process's shards."""
        per = self.shards_per_process
        return range(self.process_id * per, (self.process_id + 1) * per)


@dataclasses.dataclass
class AllReduceStats:
    """What `all_reduce_sum` cost this process on the host's clock: its
    calls, the seconds inside them (for a staged CUDA tensor that includes
    the wait for the device to reach the tensor and both copies) and, of
    those, the seconds inside the backend's own all-reduce.

    Only Python calls are seen: a captured step's all-reduces are counted
    once, when the graph is captured, and never when it is replayed (nor is
    the device time they take there)."""

    calls: int = 0
    seconds: float = 0.0
    backend_seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.seconds, self.backend_seconds = 0, 0.0, 0.0


ALL_REDUCE = AllReduceStats()


def _collective(name: str, fn, *args, **kwargs):
    try:
        return fn(*args, **kwargs)
    except RuntimeError as exc:
        raise RuntimeError(
            f"collective {name} failed on process {process_index()} of "
            f"{process_count()} (a timeout means the processes fell out of step "
            f"or one of them died): {exc}"
        ) from exc


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of `x` over the processes, the same bits on every one.  `x`
    itself without a process group; a group of one process still calls its
    backend.  Not staged (`nccl`, or `gloo` on CPU tensors), `x` is summed
    in place; under `nccl` the sum is ordered on the current stream, which
    a capture of that stream records."""
    if not is_initialized():
        return x
    t0 = time.perf_counter()
    host = x.cpu() if staged(x.device) else x
    t1 = time.perf_counter()
    _collective("all_reduce", dist.all_reduce, host)
    ALL_REDUCE.backend_seconds += time.perf_counter() - t1
    out = host if host is x else host.to(x.device)
    ALL_REDUCE.calls += 1
    ALL_REDUCE.seconds += time.perf_counter() - t0
    return out


def gather_blocks(x: torch.Tensor, root: int | None = None) -> torch.Tensor | None:
    """Concatenate every process's `x` (equal shapes) along axis 0 in rank
    order: on every process, or with `root` on that one only (None on the
    others).  A collective: every process must call it."""
    if not is_initialized():
        return x
    n = process_count()
    src = x.cpu() if staged(x.device) else x.contiguous()
    if root is None:
        parts = [torch.empty_like(src) for _ in range(n)]
        _collective("all_gather", dist.all_gather, parts, src)
    else:
        mine = process_index() == root
        parts = [torch.empty_like(src) for _ in range(n)] if mine else None
        _collective("gather", dist.gather, src, parts, dst=root)
        if not mine:
            return None
    return torch.cat(parts).to(x.device)


def local_blocks(full: torch.Tensor, mesh: ShardMesh) -> list[torch.Tensor]:
    """Cut a full array (every process holds the same one) into `n_shards`
    blocks along axis 0 and keep this process's, each as a tensor of its
    own on the mesh's device."""
    rows = full.shape[0]
    if rows % mesh.n_shards:
        raise ValueError(f"{rows} rows do not divide into {mesh.n_shards} blocks")
    per = rows // mesh.n_shards
    return [
        full[s * per:(s + 1) * per].to(mesh.device, copy=True) for s in mesh.local_shards
    ]


def barrier() -> None:
    """Wait for every process (no-op without a process group)."""
    if is_initialized():
        # an all-reduce of one word on the backend's own kind of tensor
        # (`dist.barrier` under NCCL picks a device by rank, not the current one)
        on = "cuda" if dist.get_backend() == "nccl" else "cpu"
        _collective("barrier", dist.all_reduce, torch.zeros(1, device=on))
