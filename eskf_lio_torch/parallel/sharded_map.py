"""Sharded voxel map + compute-sharded odometry step (port of
`eskf_lio_tpu/parallel/sharded_map.py`).

This is the distributed backend — the component the reference does not
have (its only parallelism is OpenMP fork/join and a two-thread
producer/consumer split).  The design is the JAX package's:

* The sorted voxel dictionary becomes D independent sub-dictionaries of
  `hash_capacity / D` slots each.  A voxel key belongs to exactly ONE shard
  — `ops.voxel.owner_hash(key, D)` — and each shard keeps its own sorted
  order, so lookups and merges never cross shard boundaries.
* **Compute sharding by owner compaction**: before the GN loop the points
  whose (guess-pose) voxels a shard owns are compacted into a static
  `ceil(N/D · slack)` slice — one stable sort — and the lookup and the
  normal equations (kernel A) run on the slice only.  A sum over the shards
  gives the global 6×6 / 6 normal equations per iteration: per-point work
  stays local and 43 floats cross the wire.  The shard-local lookup is the
  exact ownership filter (an off-shard voxel key can never hit), so
  over-claiming near voxel boundaries — the ±`shard_halo` box — only costs
  slice slots, never double counting.
* Insert is owner-compacted the same way (ownership exact — the post-update
  pose is fixed), so a shard's insert sorts over S + Δ rows, not N + Δ.
  Eviction is purely local per shard.

Where JAX runs one `shard_map` program over a device mesh, PyTorch runs one
process per GPU, so the same thing takes this shape: D shards over P
processes (`torch.distributed`, `parallel/distributed.py`), each process
holding L = D / P local shards on its one device, global shard index
`rank * L + l`.  The replicated stages (predict, preprocess, the pose
update, the motion gate, the 6×6 solve) run once per process; the per-shard
stages (owner candidates, slice compaction, lookup, kernel A, insert,
eviction) loop over the local shards in index order.  The sum over shards
adds the L local partials pairwise in index order and then, across
processes, all-reduces ONE packed f32 [43] buffer per GN iteration; the four
per-scan counters cross in one further all-reduce per scan.  Every process
is fed the same sensor stream and holds the same filter state bit for bit,
which is what keeps the GN loops in step.  The pairwise order makes the sum
over D shards the same f32 expression in one process and in two, so those
two layouts give the same trajectory bit for bit on the same device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from eskf_lio_torch.config import Config
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf, registration
from eskf_lio_torch.ops import preprocess, sortmerge as sm, voxel as vx
from eskf_lio_torch.parallel import distributed as dist
from eskf_lio_torch.parallel.distributed import ShardMesh
from eskf_lio_torch.pipeline import odometry as odo
from eskf_lio_torch.types import FilterState, ImuChunk, ProcessedScan, Scan
from eskf_lio_torch.utils.graphs import assign
from eskf_lio_torch.utils.profiling import stage

# VoxelMap fields that are replicated (not sharded): only the packing origin
_REPL_FIELDS = ("origin",)


def slice_capacity(n_points: int, n_devices: int, slack: float) -> int:
    """Static per-shard owner-slice capacity: ceil(N/D·slack) rounded up to
    a multiple of 128, capped at N (one shard degrades to the unsharded
    shapes)."""
    s = int(math.ceil(n_points / n_devices * slack))
    s = ((s + 127) // 128) * 128
    return min(s, n_points)


def _halo_corners(halo: float, dtype, device) -> torch.Tensor:
    """[8, 3] offsets to the corners of the ±halo box, ([1, 3] zeros for
    halo = 0).  Made once, when the step is made: a tensor made from Python
    numbers is a blocking upload."""
    if halo == 0.0:
        return torch.zeros((1, 3), dtype=dtype, device=device)
    signs = [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
    return torch.tensor(signs, dtype=dtype, device=device) * halo


def _corner_owners(pts: torch.Tensor, corners: torch.Tensor, voxel_size: float, n_dev: int):
    """[K, N] owners of the voxels at the K corners of the halo box around
    each point (`_halo_corners`)."""
    return vx.owner_hash(vx.voxel_key(pts[None] + corners[:, None, :], voxel_size), n_dev)


def _owner_candidates(pts: torch.Tensor, halo: float, voxel_size: float, n_dev, my):
    """True where shard `my` owns ANY voxel within the ±halo box around the
    point.  halo=0 reduces to exact single-voxel ownership."""
    corners = _halo_corners(halo, pts.dtype, pts.device)
    return (_corner_owners(pts, corners, voxel_size, n_dev) == my).any(0)


def _compact_slice(cand: torch.Tensor, arrays, s_cap: int):
    """Stable-sort rows so cand=True rows lead (in scan order), then take
    the first `s_cap`.  Returns (sliced_arrays, valid [s_cap] bool, overflow)
    where overflow counts candidates that did not fit the slice."""
    key = torch.where(cand, 0, 1).to(torch.int32)
    out = sm.sort_perm(key, *arrays, take=s_cap)
    valid = out[0] == 0
    overflow = torch.clamp(cand.sum() - s_cap, min=0)
    return list(out[2:]), valid, overflow


class ShardedVoxelMap:
    """This process's blocks of an owner-sharded map, presented in the JAX
    package's global layout: reading a `VoxelMap` field (`skey`, `payload`,
    `view`, `d_skey`, ..., and what derives from them: `keys`, `live()`,
    `num_voxels()`) gives the concatenation of the D blocks along axis 0 in
    shard order, `origin` as it is.  With more than one process that read is
    a collective: every process must make it.  The map is immutable (a step
    builds a new one), so the gathered arrays are kept after the first read.

    `num_voxels()` assumes one globally sorted main tier and is off on
    concatenated blocks, as in the JAX package; count distinct live keys on
    the host where the number matters."""

    def __init__(self, blocks: list[vm.VoxelMap], mesh: ShardMesh):
        if len(blocks) != mesh.shards_per_process:
            raise ValueError(
                f"{len(blocks)} blocks for {mesh.shards_per_process} local shards"
            )
        self.blocks = list(blocks)
        self.mesh = mesh
        self._whole: vm.VoxelMap | None = None

    @staticmethod
    def from_whole(whole: vm.VoxelMap, mesh: ShardMesh) -> "ShardedVoxelMap":
        """Cut a map in the global layout (the same on every process) into
        D blocks and keep this process's.  An empty map cut this way has
        the block sizes of the JAX package: `capacity / D` slots,
        `delta_capacity / D` delta rows and as many view buckets as go
        with them."""
        per_field = {
            f: [getattr(whole, f).to(mesh.device, copy=True)] * mesh.shards_per_process
            if f in _REPL_FIELDS else dist.local_blocks(getattr(whole, f), mesh)
            for f in vm.VoxelMap._fields
        }
        return ShardedVoxelMap(
            [
                vm.VoxelMap(**{f: per_field[f][i] for f in vm.VoxelMap._fields})
                for i in range(mesh.shards_per_process)
            ],
            mesh,
        )

    def gather(self, root: int | None = None) -> vm.VoxelMap | None:
        """The whole map in the global layout, on every process or (with
        `root`) on that one only.  A collective under a process group."""
        if self._whole is not None:
            return self._whole
        fields = {
            f: self.blocks[0].origin if f in _REPL_FIELDS
            else dist.gather_blocks(torch.cat([getattr(b, f) for b in self.blocks]), root)
            for f in vm.VoxelMap._fields
        }
        if root is not None and dist.process_index() != root:
            return None
        whole = vm.VoxelMap(**fields)
        if root is None:
            self._whole = whole
        return whole

    def __getattr__(self, name):
        if name.startswith("__") or name in ("blocks", "mesh", "_whole"):
            raise AttributeError(name)
        return getattr(self.gather(), name)

    def __iter__(self):
        return iter(self.gather())


def whole_map(voxmap) -> vm.VoxelMap:
    """A map in the global layout on every process: a `VoxelMap` as it is,
    a `ShardedVoxelMap` gathered (a collective)."""
    return voxmap.gather() if isinstance(voxmap, ShardedVoxelMap) else voxmap


def _pairwise_sum(rows: list[torch.Tensor]) -> torch.Tensor:
    """(r0 + r1) + (r2 + r3) ...: neighbours first, in index order.  Two
    processes that hold half of the rows each and then add their results
    compute the same expression as one process that holds them all."""
    while len(rows) > 1:
        rows = [
            rows[i] + rows[i + 1] if i + 1 < len(rows) else rows[i]
            for i in range(0, len(rows), 2)
        ]
    return rows[0]


def _shard_sum_fn(n_local: int):
    """`align`'s `reduce_fn` over the shards: the local partials [L, 6, 6],
    [L, 6], [L] packed as f32 [L, 43] (36 + 6 + 1; the count is exact below
    2^24), added pairwise in index order, then summed over the processes in
    ONE all-reduce of 43 floats.

    In the captured step under `nccl` this all-reduce lies inside the GN
    loop's WHILE node, once per pass after the first (which runs before the
    node), and each process runs the loop on its own device.  Every process must make the same number of passes, or a
    collective would wait for a peer that left the loop.  They do: the
    loop's condition is computed from the summed normal equations and the
    replicated pose, which are the same bits on every process."""

    def reduce_fn(JTJ, JTr, num_corr):
        packed = torch.cat(
            [JTJ.reshape(n_local, 36), JTr, num_corr.reshape(n_local, 1).to(JTJ.dtype)],
            dim=1,
        )
        total = dist.all_reduce_sum(_pairwise_sum(list(packed.unbind(0))))
        return total[:36].reshape(6, 6), total[36:42], total[42]

    return reduce_fn


def make_sharded_scan_step(config: Config, mesh: ShardMesh, tracer=None):
    """Build the sharded per-scan step.

    Signature matches `pipeline.odometry.make_scan_step`'s step, but the map
    is a `ShardedVoxelMap` (each block its own sub-table) and the GN and
    insert work of each shard runs on owner-compacted N/D-scaled slices.
    With a tracer, its stage boundaries are marked as the single-device
    step's (`profiling.stage`)."""
    dev = mesh.device
    n_dev = mesh.n_shards
    n_local = mesh.shards_per_process
    noise = eskf.make_noise_params(config, dev)
    T_il = odo.lidar_extrinsics(config, dev)
    if config.hash_capacity % n_dev:
        raise ValueError(f"hash_capacity {config.hash_capacity} does not divide by {n_dev}")
    if not config.shard_halo < config.map_voxel_size:
        raise ValueError(
            "shard_halo must stay below one voxel so the ±halo box spans at "
            "most the 8 corner voxels"
        )
    # GN slice capped by the correspondence budget (config.align_capacity);
    # the insert slice keeps the full scan budget so no map data is lost
    s_cap_gn = slice_capacity(config.align_capacity, n_dev, config.shard_slack)
    s_cap = slice_capacity(config.max_scan_points, n_dev, config.shard_slack)
    reduce_fn = _shard_sum_fn(n_local)
    corners = _halo_corners(config.shard_halo, torch.float32, dev)
    map_kw = dict(
        voxel_size=config.map_voxel_size,
        max_points_per_voxel=config.max_points_per_voxel,
        key_bits=config.map_key_bits,
    )

    def scan_step(
        state: FilterState, voxmap: ShardedVoxelMap, prev_R, prev_t,
        chunk: ImuChunk, scan: Scan, do_evict,
    ):
        blocks = voxmap.blocks

        # 1-3. predict + rollback + preprocess: once per process
        stage(tracer, "predict")
        base, hist = eskf.predict_chunk_prefix(
            state, chunk, noise, base_mask=chunk.t_rel <= 0.0
        )
        stage(tracer, "preprocess")
        processed = preprocess.preprocess(scan, hist, T_il, config)
        covp = vm.pack_cov(processed.covs)

        stage(tracer, "align")
        # 4. owner-compact each shard's GN work to a static N/D·slack slice
        guess = eskf.pose_of(base)
        owners = _corner_owners(
            guess.apply(processed.points), corners, config.map_voxel_size, n_dev
        )
        slices, gn_overflow = [], 0
        for my in mesh.local_shards:
            cand = (owners == my).any(0) & processed.valid
            (s_pts, s_covp), s_valid, overflow = _compact_slice(
                cand, (processed.points, covp), s_cap_gn
            )
            slices.append((s_pts, s_covp, s_valid))
            gn_overflow = gn_overflow + overflow
        s_pts, s_covp, s_valid = (torch.stack(x) for x in zip(*slices))
        sliced = ProcessedScan(points=s_pts, covs=vm.unpack_cov(s_covp), valid=s_valid)

        # 5. sharded VGICP: per-shard slice lookup + summed normal
        # equations.  A block only stores owned voxels, so `hit` is the
        # exact ownership filter — a point over-claimed by two shards
        # hits on exactly one of them.
        def lookup_fn(pts):
            return tuple(
                torch.stack(x) for x in zip(*(
                    vm.lookup(block, pts[i], **map_kw)
                    for i, block in enumerate(blocks)
                ))
            )

        res = registration.align(
            sliced, None, guess, config, lookup_fn=lookup_fn, reduce_fn=reduce_fn,
            tracer=tracer,
        )

        # 6. measurement update: once per process
        stage(tracer, "pose_update")
        corrected = eskf.pose_update(base, res.pose, noise)
        T = eskf.pose_of(corrected)

        # 7. owner-compacted insert into each local block (ownership exact:
        # the post-update pose is fixed)
        stage(tracer, "map_insert")
        moved_R = prev_R.T @ T.R
        moved_t = prev_R.T @ (T.t - prev_t)
        cosine = 0.5 * (torch.trace(moved_R) - 1.0)
        should_insert = (cosine < config.map_update_cosine_threshold) | (
            torch.sum(moved_t * moved_t) > config.map_update_translation_sq_threshold
        )
        pts_world = T.apply(processed.points)
        owner_w = vx.owner_hash(vx.voxel_key(pts_world, config.map_voxel_size), n_dev)
        new_blocks, dropped, ins_overflow = [], 0, 0
        for block, my in zip(blocks, mesh.local_shards):
            (i_pts_w, i_covp), i_valid, overflow = _compact_slice(
                processed.valid & (owner_w == my), (pts_world, covp), s_cap
            )
            # rotate only the sliced covariances into world frame: R Σ Rᵀ
            covs_w = T.R @ vm.unpack_cov(i_covp) @ T.R.T
            block, lost = vm.insert(
                block, i_pts_w, vm.pack_cov(covs_w), i_valid & should_insert, **map_kw,
            )
            new_blocks.append(block)
            dropped = dropped + lost
            ins_overflow = ins_overflow + overflow

        # 8. eviction: purely local per shard (host-known schedule)
        removed = torch.zeros((), dtype=torch.int64, device=dev)
        if bool(do_evict) and config.remove_distant_points:
            stage(tracer, "evict")
            for i, block in enumerate(new_blocks):
                new_blocks[i], gone = vm.evict_beyond(
                    block, T.t,
                    voxel_size=config.map_voxel_size,
                    distance_threshold=config.remove_distance_threshold,
                    max_points_per_voxel=config.max_points_per_voxel,
                    key_bits=config.map_key_bits,
                )
                removed = removed + gone

        # the four per-shard counters, summed over the processes in one
        # all-reduce (slice overflows are 0 in healthy operation; raise
        # shard_slack if they fire)
        counters = dist.all_reduce_sum(torch.stack([
            dropped, removed, gn_overflow, ins_overflow * should_insert.to(torch.int64),
        ]))
        diag = {
            "icp_iterations": res.iterations,
            "icp_converged": res.converged,
            "num_correspondences": res.num_correspondences,
            "inserted": should_insert,
            "dropped_points": counters[0],
            "removed_voxels": counters[1],
            "num_scan_points": processed.valid.sum(),
            "pose_finite": torch.isfinite(T.t).all() & torch.isfinite(T.R).all(),
            "gn_slice_overflow": counters[2],
            "insert_slice_overflow": counters[3],
        }
        stage(tracer, "end")
        return corrected, ShardedVoxelMap(new_blocks, mesh), T.R, T.t, diag

    return scan_step


def make_sharded_init_step(config: Config, mesh: ShardMesh):
    """First-scan path, owner-compacted per shard."""
    n_dev = mesh.n_shards
    T_il = odo.lidar_extrinsics(config, mesh.device)
    s_cap = slice_capacity(config.max_scan_points, n_dev, config.shard_slack)

    def init_step(voxmap: ShardedVoxelMap, scan: Scan):
        processed = preprocess.downsample_and_covariances(
            T_il.apply(scan.points), scan.valid, config
        )
        owner = vx.owner_hash(vx.voxel_key(processed.points, config.map_voxel_size), n_dev)
        covp = vm.pack_cov(processed.covs)
        new_blocks, lost = [], 0
        for block, my in zip(voxmap.blocks, mesh.local_shards):
            (i_pts, i_covp), i_valid, overflow = _compact_slice(
                processed.valid & (owner == my), (processed.points, covp), s_cap
            )
            block, dropped = vm.insert(
                block, i_pts, i_covp, i_valid,
                voxel_size=config.map_voxel_size,
                max_points_per_voxel=config.max_points_per_voxel,
                key_bits=config.map_key_bits,
            )
            new_blocks.append(block)
            lost = lost + dropped + overflow
        return ShardedVoxelMap(new_blocks, mesh), dist.all_reduce_sum(lost)

    return init_step


# the sharded step's diagnostics, in the order of its captured vector
SHARDED_DIAG_KEYS = (
    "icp_iterations", "icp_converged", "num_correspondences", "inserted",
    "dropped_points", "removed_voxels", "num_scan_points", "pose_finite",
    "gn_slice_overflow", "insert_slice_overflow",
)


class GraphedShardedScanStep(odo.GraphedScanStep):
    """The sharded step of one process on a CUDA device, captured: the
    counterpart of the JAX package's `jax.jit(shard_map(body))`
    (`eskf_lio_tpu/parallel/sharded_map.py:312-321`).  `make_sharded_scan_step`
    over static buffers — the inputs, the filter state, `prev_R` / `prev_t`,
    the diagnostics and each of the process's map blocks — in one graph with
    the eviction and one without, sharing a pool, chosen by the host-known
    `do_evict`.  Inside a graph the GN loop over every shard's slice is ONE
    WHILE node (the shard sum is the local pairwise `reduce_fn`) and each
    shard's `insert` fold its pair of IF nodes.

    Without a process group `all_reduce_sum` is the identity.  Under `nccl`
    the graph holds both of the step's all-reduces: the 43 floats of the
    first GN pass at its top level and of every later pass inside the WHILE
    node, the four counters once at the top level.
    Under `gloo` a CUDA tensor's all-reduce is staged through the host,
    which no graph can hold, so that case is refused; `gloo` on the CPU
    (where the graph is only ever a stand-in that calls the function) is
    not.  `ShardedOdometry` decides by `graph_choice`.

    A call returns a NEW `ShardedVoxelMap` over the static blocks: a map
    caches its gathered arrays, and the blocks change under it with every
    call, so a map returned earlier must not be read after a later call
    (clone its blocks to keep it)."""

    diag_keys = SHARDED_DIAG_KEYS

    def __init__(self, config: Config, mesh: ShardMesh, tracer=None):
        if dist.staged(mesh.device):
            raise RuntimeError(
                "the sharded step is not captured under a gloo process group on a "
                "CUDA device (graph_choice): its all-reduce is staged through the host"
            )
        self.mesh = mesh
        super().__init__(config, mesh.device, tracer)

    def _make_core(self, config: Config, dev):
        return make_sharded_scan_step(config, self.mesh, self.tracer)

    def _make_map(self, config: Config, dev) -> None:
        whole = vm.VoxelMap.create(config.hash_capacity, config.map_delta_capacity, device=dev,
                                   key_bits=config.map_key_bits)
        self.blocks = ShardedVoxelMap.from_whole(whole, self.mesh).blocks

    def _run(self, do_evict: bool):
        return self.core(
            self.state, ShardedVoxelMap(self.blocks, self.mesh), self.prev_R, self.prev_t,
            self.chunk, self.scan, do_evict,
        )

    def _assign_map(self, voxmap: ShardedVoxelMap) -> None:
        for mine, theirs in zip(self.blocks, voxmap.blocks, strict=True):
            assign(mine, theirs)

    def _map(self) -> ShardedVoxelMap:
        return ShardedVoxelMap(self.blocks, self.mesh)


def graph_choice(device: torch.device) -> tuple[bool, str]:
    """Whether `ShardedOdometry`'s scan step on `device` is a captured graph,
    and one line that says why.  The rule reads the device and the process
    group's backend, nothing else: on the CPU the step is eager; on a card
    it is captured without a group and under `nccl` (whose all-reduce the
    capture records, inside the GN loop), and eager under `gloo` (which
    stages it through the host, where a graph cannot follow)."""
    if device.type != "cuda":
        return False, f"eager: the step runs on the {device.type}"
    backend = dist.backend()
    if backend is None:
        return True, ("graph: one process holds every shard on its card, so the shard sum "
                      "is local and the step is captured")
    if dist.staged(device):
        return False, (f"eager: a {backend} process group is initialised and its all-reduce "
                       "is staged through the host, which a graph cannot hold")
    return True, (f"graph: under the {backend} process group the all-reduce of the shard "
                  "sums is captured inside the GN loop's WHILE node")


class ShardedOdometry(odo.Odometry):
    """Drop-in sharded variant of the host driver: same interface, the map
    in `n_devices` owner-hashed shards.

    In one process all shards lie on the one device (the JAX package
    spreads them over its local devices).  After
    `parallel.distributed.initialize()` the shards are dealt to the
    processes in rank order (`n_devices` defaults to one each) and the same
    step runs with its sums crossing the process group.  Each process feeds
    the identical sensor stream (lockstep ingestion), so poses and
    diagnostics are the same on every process.

    `voxmap` reads as a `ShardedVoxelMap` (the JAX package's global layout,
    gathered on demand) and takes either one of those or a whole `VoxelMap`,
    of which it keeps this process's blocks — which is how the base class's
    empty map and a loaded checkpoint get cut."""

    def __init__(
        self,
        config: Config,
        n_devices: int | None = None,
        init_state: FilterState | None = None,
        device="cuda",
        tracer=None,
    ):
        self.mesh = ShardMesh.create(n_devices or dist.process_count(), device)
        super().__init__(config, init_state=init_state, device=self.mesh.device, tracer=tracer)

    def _make_steps(self):
        """The sharded steps: the scan step a `GraphedShardedScanStep` or
        eager, by `graph_choice` (`graphed`, `step_reason`); the init step
        eager, as the single-device one is."""
        self.graphed, self.step_reason = graph_choice(self.device)
        scan_step = (GraphedShardedScanStep(self.config, self.mesh, self.tracer) if self.graphed
                     else make_sharded_scan_step(self.config, self.mesh, self.tracer))
        return (scan_step,
                make_sharded_init_step(self.config, self.mesh),
                odo.make_predict_only(self.config, self.device, self.tracer))

    @property
    def voxmap(self) -> ShardedVoxelMap:
        return self._voxmap

    @voxmap.setter
    def voxmap(self, value) -> None:
        if isinstance(value, vm.VoxelMap):
            value = ShardedVoxelMap.from_whole(value, self.mesh)
        self._voxmap = value


class ShardedOdometryRunner:
    """Minimal driver for a dry run: builds the sharded driver and runs one
    init + one scan step on random points."""

    def __init__(self, config: Config, n_devices: int, device="cuda"):
        self.config = config
        self.odo = ShardedOdometry(config, n_devices=n_devices, device=device)

    def dryrun(self) -> None:
        from eskf_lio_torch.io.dataset import ImuRecord, LidarRecord

        cfg = self.config
        rng = np.random.default_rng(0)
        t0 = 1000.0
        # scan 0 (init) + scan 1 (full sharded step)
        for k in (1, 2):
            t_end = t0 + 0.1 * k
            n = cfg.max_raw_points // 2
            pts = rng.uniform(-5, 5, size=(n, 3)).astype(np.float32)
            ts = np.sort(rng.uniform(t_end - 0.1, t_end, n))
            rec = LidarRecord(points=pts, t=ts, start_time=float(ts[0]), end_time=t_end)
            # feed IMU covering the sweep
            for i in range(12):
                self.odo.feed_imu(
                    ImuRecord(
                        t=t_end - 0.11 + 0.01 * (i + 1),
                        gyro=0.01 * rng.standard_normal(3),
                        accel=np.array([0.0, 0.0, 9.81]) + 0.01 * rng.standard_normal(3),
                    )
                )
            if self.odo.process_scan(rec) is None:
                raise RuntimeError("sharded step did not run")
        if self.odo.device.type == "cuda":
            torch.cuda.synchronize(self.odo.device)
