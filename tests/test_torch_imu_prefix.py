"""The IMU prefix in one launch (`eskf_lio_torch/ops/imu_prefix.py`,
`csrc/imu_prefix.cu`) behind `models/eskf.py::predict_chunk_prefix`.

On the CPU (tier 1): `predict_chunk_prefix` on CPU tensors gives what the
plain chain gave before the kernel, bit for bit (the benchmark's frozen
copy of it, `benchmark/reference/eskf.py`), on chunks recorded from the
three replay cells' generators (`tests/data/imu_prefix_chunks.npz`: mid360
at M = 64, hdl64-urban at M = 32, hilti2022-xt32's handheld walk at M = 64:
41 samples, rates on three axes, tilted gravity, biases), on random chunks
of 1 to 64 samples and on the edge cases below; the wrapper raises on more
than 64 samples (and on none), on a wrong shape or dtype and on tensors on
more than one device, and on CPU tensors counts no launch.

`tests/data/imu_prefix_jax.npz` keeps the JAX package's
`predict_chunk_prefix` on the recorded chunks, at M = 48 and on the edge
cases, with their inputs; `tests/test_torch_eskf.py` checks it against the
live JAX package, the CPU path here meets it at that file's tolerances
(position 1e-4 m, quaternion 1e-5, covariance rtol 1e-3 / atol 2e-6, the
history 1e-4), and so does the kernel on the card (which has no JAX).

On the card (`cuda` marker, skipped without one): the kernel equals
`eskf.imu_prefix_ref` on the card bit for bit (base P, p, v, q; the
history's p, q, t_rel, valid) on the recorded chunks, at M = 48, on an
all-invalid chunk, a sample with dt < 0 (and one with dt = -0), the base
mask cut at the first and at the last valid sample and no base mask; on
inputs that are not finite its base P is not finite either, the rest
still the chain's bits; it meets the stored JAX outputs; one captured
launch replayed equals the eager call and counts a launch a replay; a
short replay through the captured step launches it once a row.

The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_imu_prefix.py

Its data files are written by this file.  On the card, the recorded chunks
(the replay cells' drivers for 3 s each, a state and chunk at fixed calls
of the replay step):

    PYTHONPATH=. python tests/test_torch_imu_prefix.py chunks [OUT.npz]

and then on the CPU, from the recorded chunks, the JAX package's outputs:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_imu_prefix.py jax
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import eskf as frozen
from eskf_lio_torch.config import Config, ImuConfig
from eskf_lio_torch.io import dataset
from eskf_lio_torch.map import voxel_map as vm
from eskf_lio_torch.models import eskf
from eskf_lio_torch.ops import imu_prefix
from eskf_lio_torch.pipeline import odometry, replay
from eskf_lio_torch.types import FilterState, ImuChunk

torch.set_num_threads(2)

RECORDED = Path(__file__).parent / "data" / "imu_prefix_chunks.npz"
JAX_OUTPUTS = Path(__file__).parent / "data" / "imu_prefix_jax.npz"
# the recorded rows: each cell's replay step at calls `every` x RECORD_AT of
# a run of RECORD_SECONDS at RECORD_SEED (`record_chunks`)
RECORD_CELLS = (("mid360.replay", "mid360", 97), ("hdl64-urban.replay", "urban", 41),
                ("hilti2022-xt32.replay", "handheld", 43))
RECORD_AT = (3, 7, 11, 13)
RECORD_SEED = 20260101
RECORD_SECONDS = 3.0
with np.load(RECORDED) as _f:
    _DATA = {k: _f[k] for k in _f.files}
RECORDED_CASES = sorted({k.rsplit(".state.", 1)[0] for k in _DATA if ".state." in k})
RANDOM_CASES = [(64, True), (64, False), (48, True), (32, False), (17, True), (1, True)]
EDGE_CASES = ["none_valid", "negative_dt", "minus_zero_dt", "base_at_first", "base_at_last_valid",
              "no_base_mask"]
ODD_CASES = ["nan_gyro", "inf_accel", "overflow", "nan_P"]
Q_DIAG = np.array([1e-4] * 3 + [2e-5] * 3 + [1e-8] * 3 + [1e-9] * 3, np.float32)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    return torch.device("cuda", 0)


def recorded(case: str):
    """(state, chunk, q_diag, base_mask) of a recorded row, as numpy."""
    tag = case.split(".")[0]
    st = {f: _DATA[f"{case}.state.{f}"] for f in FilterState._fields}
    ch = {f: _DATA[f"{case}.chunk.{f}"] for f in ImuChunk._fields}
    return st, ch, _DATA[f"{tag}.q_diag"], "t_rel"


def random_case(m: int, all_valid: bool, seed: int = 0):
    rng = np.random.default_rng(1000 * m + seed + all_valid)
    A = rng.normal(size=(18, 18)) * 0.03
    q = rng.normal(size=4)
    st = dict(p=rng.normal(size=3), v=rng.normal(size=3), q=q / np.linalg.norm(q),
              ba=rng.normal(size=3) * 0.05, bg=rng.normal(size=3) * 0.01,
              g=np.array([0.0, 0.0, -9.81]) + rng.normal(size=3) * 0.01,
              P=A @ A.T + 1e-4 * np.eye(18))
    dt = 0.005 + 0.001 * rng.uniform(size=m)
    ch = dict(dt=dt, t_rel=np.cumsum(dt) - 0.9 * dt.sum(), gyro=rng.normal(size=(m, 3)) * 0.6,
              accel=np.array([0.0, 0.0, 9.81]) + rng.normal(size=(m, 3)),
              valid=np.ones(m, bool) if all_valid else rng.uniform(size=m) < 0.7)
    st = {k: v.astype(np.float32) for k, v in st.items()}
    ch = {k: v if k == "valid" else v.astype(np.float32) for k, v in ch.items()}
    return st, ch, Q_DIAG, "t_rel"


def edge_case(name: str):
    st, ch, q_diag, _ = random_case(64, True, seed=7)
    base = "t_rel"
    if name == "none_valid":
        ch["valid"] = np.zeros(64, bool)
    elif name == "negative_dt":
        ch["dt"][5] = -0.004
    elif name == "minus_zero_dt":
        ch["dt"][9] = -0.0
    elif name == "base_at_first":
        base = np.zeros(64, bool)
        base[0] = True
    elif name == "base_at_last_valid":
        ch["valid"][40:] = False
        base = np.zeros(64, bool)
        base[:40] = True
    elif name == "no_base_mask":
        base = None
    elif name == "nan_gyro":
        ch["gyro"][10, 1] = np.nan
    elif name == "inf_accel":
        ch["accel"][3, 0] = np.inf
    elif name == "overflow":
        ch["accel"][:, 2] = 3e37
    elif name == "nan_P":
        st["P"][4, 4] = np.nan
    return st, ch, q_diag, base


def case_arrays(kind: str, case):
    """(state, chunk, q_diag, base_mask) as numpy; base_mask bool or None."""
    if kind == "recorded":
        st, ch, q_diag, base = recorded(case)
    elif kind == "random":
        st, ch, q_diag, base = random_case(*case)
    else:
        st, ch, q_diag, base = edge_case(case)
    if isinstance(base, str):
        base = ch["t_rel"] <= 0.0
    return st, ch, q_diag, base


def as_tensors(st, ch, q_diag, base, device):
    """(state, chunk, q_diag, base_mask) tensors on `device`."""
    state = FilterState(**{k: torch.as_tensor(v, device=device) for k, v in st.items()})
    chunk = ImuChunk(**{k: torch.as_tensor(v, device=device) for k, v in ch.items()})
    base_mask = None if base is None else torch.as_tensor(base, device=device)
    return state, chunk, torch.as_tensor(q_diag, device=device), base_mask


def case_inputs(kind: str, case, device):
    """(state, chunk, q_diag, base_mask) tensors on `device`."""
    return as_tensors(*case_arrays(kind, case), device)


ALL_CASES = ([("recorded", c) for c in RECORDED_CASES] + [("random", c) for c in RANDOM_CASES]
             + [("edge", c) for c in EDGE_CASES])
# the cases stored with the JAX package's outputs
JAX_CASES = ([f"recorded.{c}" for c in RECORDED_CASES] + ["random.48"]
             + [f"edge.{c}" for c in EDGE_CASES])


def jax_case_arrays(label: str):
    """A `JAX_CASES` case's inputs as numpy, from the case generators."""
    kind, case = label.split(".", 1)
    return case_arrays(kind, (48, True) if kind == "random" else case)


def flat_inputs(st, ch, q_diag, base) -> dict:
    arrays = {**{f"state.{k}": v for k, v in st.items()},
              **{f"chunk.{k}": v for k, v in ch.items()}, "q_diag": q_diag}
    if base is not None:
        arrays["base_mask"] = base
    return arrays


def stored_jax_case(label: str):
    """A `JAX_CASES` case as stored: its inputs (state, chunk, q_diag,
    base_mask) as numpy, and the JAX outputs by name (`base.P`, `hist.p`)."""
    with np.load(JAX_OUTPUTS) as f:
        got = {k[len(label) + 1:]: f[k] for k in f.files if k.startswith(label + ".")}
    st = {k: got[f"state.{k}"] for k in FilterState._fields}
    ch = {k: got[f"chunk.{k}"] for k in ImuChunk._fields}
    out = {k[4:]: v for k, v in got.items() if k.startswith("out.")}
    return (st, ch, got["q_diag"], got.get("base_mask")), out


def jax_prefix(st, ch, q_diag, base) -> dict:
    """The JAX package's `predict_chunk_prefix` on numpy inputs: its base
    p, v, q, P and its history, by name (`base.P`, `hist.p`)."""
    import jax.numpy as jnp

    from eskf_lio_tpu.models import eskf as j_eskf
    from eskf_lio_tpu.types import FilterState as JState, ImuChunk as JChunk

    noise = j_eskf.NoiseParams(q_diag=jnp.asarray(q_diag), v_diag=jnp.ones(6, jnp.float32))
    j_base, j_hist = j_eskf.predict_chunk_prefix(
        JState(**{k: jnp.asarray(v) for k, v in st.items()}),
        JChunk(**{k: jnp.asarray(v) for k, v in ch.items()}), noise,
        base_mask=None if base is None else jnp.asarray(base))
    return {**{f"base.{k}": np.asarray(getattr(j_base, k)) for k in ("p", "v", "q", "P")},
            **{f"hist.{k}": np.asarray(v) for k, v in j_hist._asdict().items()}}


def assert_meets_jax(base, hist, want: dict) -> None:
    """`tests/test_torch_eskf.py`'s tolerances: the log-step scans group the
    float32 products differently from `jax.lax.associative_scan`."""
    got = {**{f"base.{k}": getattr(base, k) for k in ("p", "v", "q", "P")},
           **{f"hist.{k}": v for k, v in hist._asdict().items()}}
    got = {k: v.detach().cpu().numpy() for k, v in got.items()}
    for k in ("base.p", "base.v"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    q, wq = got["base.q"], want["base.q"]
    assert min(np.abs(q - wq).max(), np.abs(q + wq).max()) < 1e-5
    np.testing.assert_allclose(got["base.P"], want["base.P"], rtol=1e-3, atol=2e-6)
    for k in ("hist.t_rel", "hist.p", "hist.q"):
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, err_msg=k)
    np.testing.assert_array_equal(got["hist.valid"], want["hist.valid"])


def bits(x: torch.Tensor) -> np.ndarray:
    x = x.detach().cpu()
    return x.numpy() if x.dtype == torch.bool else x.view(torch.int32).numpy()


def assert_same_bits(got, want):
    """base P, p, v, q and the history's fields equal bit for bit."""
    (g_base, g_hist), (w_base, w_hist) = got, want
    for name in ("P", "p", "v", "q", "ba", "bg", "g"):
        assert np.array_equal(bits(getattr(g_base, name)), bits(getattr(w_base, name))), name
    for name in ("p", "q", "t_rel", "valid"):
        assert np.array_equal(bits(getattr(g_hist, name)), bits(getattr(w_hist, name))), name


def test_the_recorded_chunks_hold_both_cells_shapes():
    shapes = {c.split(".")[0]: _DATA[f"{c}.chunk.dt"].shape for c in RECORDED_CASES}
    assert shapes == {"mid360": (64,), "urban": (32,), "handheld": (64,)}
    for c in RECORDED_CASES:
        valid = _DATA[f"{c}.chunk.valid"]
        # a real chunk: some valid samples, padding after them
        assert 0 < valid.sum() < len(valid) and not valid[-1]


@pytest.mark.parametrize("label", JAX_CASES)
def test_stored_jax_inputs_are_the_cases(label):
    """The stored inputs are those the case generators give (the outputs
    are checked against the live JAX package in tests/test_torch_eskf.py)."""
    stored, out = stored_jax_case(label)
    want = flat_inputs(*jax_case_arrays(label))
    assert set(flat_inputs(*stored)) == set(want)
    for key, value in flat_inputs(*stored).items():
        np.testing.assert_array_equal(
            value, want[key],
            err_msg=f"{JAX_OUTPUTS.name}: {label}.{key} is stale; write it again "
                    "(JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_imu_prefix.py jax)")
    assert set(out) == {"base.p", "base.v", "base.q", "base.P", "hist.t_rel", "hist.p", "hist.q",
                        "hist.valid"}


@pytest.mark.parametrize("label", JAX_CASES)
def test_cpu_path_meets_the_stored_jax_outputs(label):
    inputs, want = stored_jax_case(label)
    state, chunk, q_diag, base_mask = as_tensors(*inputs, "cpu")
    noise = eskf.NoiseParams(q_diag=q_diag, v_diag=torch.ones(6))
    assert_meets_jax(*eskf.predict_chunk_prefix(state, chunk, noise, base_mask=base_mask), want)


@pytest.mark.parametrize("kind,case", ALL_CASES)
def test_cpu_path_is_the_chain_before_the_kernel_bit_for_bit(kind, case):
    state, chunk, q_diag, base_mask = case_inputs(kind, case, "cpu")
    noise = eskf.NoiseParams(q_diag=q_diag, v_diag=torch.ones(6))
    got = eskf.predict_chunk_prefix(state, chunk, noise, base_mask=base_mask)
    want = frozen.predict_chunk_prefix(state, chunk, noise, base_mask=base_mask)
    assert_same_bits(got, want)
    # the plain version is the chain too, and passes the biases and gravity through
    assert_same_bits(eskf.imu_prefix_ref(state, chunk, q_diag, base_mask), want)
    assert got[0].ba is state.ba and got[0].g is state.g


def test_cpu_path_counts_no_launch():
    before = imu_prefix.KERNEL.launches
    state, chunk, q_diag, base_mask = case_inputs("random", (64, True), "cpu")
    imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)
    assert imu_prefix.KERNEL.launches == before
    assert imu_prefix.LAUNCHES == 1 and imu_prefix.MAX_SAMPLES == 64


@pytest.mark.parametrize("m", [65, 128, 0])
def test_wrapper_raises_outside_1_to_64_samples(m):
    st, ch, q_diag, _ = random_case(max(m, 1), True)
    state = FilterState(**{k: torch.as_tensor(v) for k, v in st.items()})
    chunk = ImuChunk(**{k: torch.as_tensor(v)[:m] for k, v in ch.items()})
    with pytest.raises(ValueError, match="1 to 64 samples"):
        imu_prefix.imu_prefix(state, chunk, torch.as_tensor(q_diag))
    noise = eskf.NoiseParams(q_diag=torch.as_tensor(q_diag), v_diag=torch.ones(6))
    with pytest.raises(ValueError, match="1 to 64 samples"):
        eskf.predict_chunk_prefix(state, chunk, noise)


@pytest.mark.parametrize("bad", ["P_float64", "dt_float64", "valid_uint8", "base_mask_float",
                                 "q_diag_float64", "P_shape", "gyro_shape", "q_diag_shape"])
def test_wrapper_raises_on_a_wrong_dtype_or_shape(bad):
    state, chunk, q_diag, base_mask = case_inputs("random", (32, True), "cpu")
    if bad == "P_float64":
        state = state._replace(P=state.P.double())
    elif bad == "dt_float64":
        chunk = chunk._replace(dt=chunk.dt.double())
    elif bad == "valid_uint8":
        chunk = chunk._replace(valid=chunk.valid.to(torch.uint8))
    elif bad == "base_mask_float":
        base_mask = base_mask.float()
    elif bad == "q_diag_float64":
        q_diag = q_diag.double()
    elif bad == "P_shape":
        state = state._replace(P=state.P[:, :17])
    elif bad == "gyro_shape":
        chunk = chunk._replace(gyro=chunk.gyro[:-1])
    elif bad == "q_diag_shape":
        q_diag = q_diag[:6]
    with pytest.raises(ValueError, match="must be"):
        imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)


@pytest.mark.parametrize("where", ["chunk.gyro", "state.P", "q_diag", "base_mask"])
def test_wrapper_raises_on_tensors_on_mixed_devices(where):
    state, chunk, q_diag, base_mask = case_inputs("random", (32, True), "cpu")
    meta = torch.device("meta")
    if where == "chunk.gyro":
        chunk = chunk._replace(gyro=chunk.gyro.to(meta))
    elif where == "state.P":
        state = state._replace(P=state.P.to(meta))
    elif where == "q_diag":
        q_diag = q_diag.to(meta)
    else:
        base_mask = base_mask.to(meta)
    with pytest.raises(ValueError, match="one device"):
        imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)


# ---- on the card ------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind,case", ALL_CASES)
def test_kernel_equals_the_plain_chain_on_the_card_bit_for_bit(dev, kind, case):
    state, chunk, q_diag, base_mask = case_inputs(kind, case, dev)
    before = imu_prefix.KERNEL.launch_count()
    got = imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)
    assert imu_prefix.KERNEL.launch_count() == before + 1
    want = eskf.imu_prefix_ref(state, chunk, q_diag, base_mask)
    assert_same_bits(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ODD_CASES)
def test_kernel_on_inputs_that_are_not_finite_gives_a_base_p_that_is_not(dev, case):
    """The products skip the transitions' known zeros, which is exact only
    for finite factors: a NaN or Inf input leaves the base P not finite, as
    the chain's is, and every other output the chain's bits."""
    state, chunk, q_diag, base_mask = case_inputs("edge", case, dev)
    (g_base, g_hist) = imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)
    (w_base, w_hist) = eskf.imu_prefix_ref(state, chunk, q_diag, base_mask)
    assert not bool(torch.isfinite(w_base.P).all())
    assert not bool(torch.isfinite(g_base.P).all())
    for name in ("p", "v", "q"):
        assert np.array_equal(bits(getattr(g_base, name)), bits(getattr(w_base, name))), name
    for name in ("p", "q", "t_rel", "valid"):
        assert np.array_equal(bits(getattr(g_hist, name)), bits(getattr(w_hist, name))), name


@pytest.mark.cuda
@pytest.mark.parametrize("label", JAX_CASES)
def test_kernel_meets_the_stored_jax_outputs(dev, label):
    inputs, want = stored_jax_case(label)
    state, chunk, q_diag, base_mask = as_tensors(*inputs, dev)
    assert_meets_jax(*imu_prefix.imu_prefix(state, chunk, q_diag, base_mask), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("recorded", "mid360.0"), ("recorded", "urban.0"),
                                  ("random", (48, False))])
def test_captured_kernel_equals_the_eager_call(dev, case):
    state, chunk, q_diag, base_mask = case_inputs(*case, dev)
    eager = imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)
    imu_prefix.reserve_capture(dev)
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        captured = imu_prefix.imu_prefix(state, chunk, q_diag, base_mask)
    before = imu_prefix.KERNEL.launch_count()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert imu_prefix.KERNEL.launch_count() == before + 3
    assert_same_bits(captured, eager)


@pytest.mark.cuda
def test_a_short_replay_launches_the_kernel_once_a_row(dev):
    """The captured scan step and the predict-only graph each launch the
    kernel once a row, counted on the device."""
    cfg = Config(
        imu=ImuConfig(gravity=(0.0, 0.0, -9.81)), translation_noise=1e-4,
        rotation_noise=3e-5, max_raw_points=8192, max_scan_points=4096,
        max_imu_per_scan=48, hash_capacity_log2=14,
    )
    seq = dataset.make_synthetic_sequence(duration=1.5, points_per_scan=8000, seed=7)
    init_scan, chunks, scans, evicts, updates, _ = replay.pack_sequence(cfg, seq, device=dev)
    voxmap, _ = odometry.make_init_step(cfg, dev)(
        vm.VoxelMap.create(cfg.hash_capacity, cfg.map_delta_capacity, device=dev), init_scan)
    start = (eskf.init_state(cfg, dev), voxmap, torch.eye(3, device=dev),
             torch.zeros(3, device=dev))
    step = replay.make_replay_step(cfg, dev)
    imu_prefix.KERNEL.reset_launches()
    step(*start, chunks, scans, evicts, updates)
    torch.cuda.synchronize()
    assert imu_prefix.KERNEL.launch_count() == chunks.dt.shape[0]
    # the predict-only graph of an overflow row
    predict = odometry.make_predict_only(cfg, dev)
    one = ImuChunk(*(x[0] for x in chunks))
    imu_prefix.KERNEL.reset_launches()
    for _ in range(2):
        predict(start[0], one)
    torch.cuda.synchronize()
    assert imu_prefix.KERNEL.launch_count() == 2


def record_chunks(out: Path) -> None:
    """On the card: run each of `RECORD_CELLS`' drivers for RECORD_SECONDS
    at RECORD_SEED and store the state and the first row's chunk that the
    replay step gets at calls `every` x RECORD_AT (the warm-up's included),
    with the cell's process noise diagonal."""
    from benchmark import harness
    from benchmark.drivers import common

    dev = torch.device("cuda")
    arrays = {}
    for name, tag, every in RECORD_CELLS:
        cell, calls = harness.load_cell(name), [0]

        def fault(step, tag=tag, every=every, calls=calls):
            def recording(*args):
                n, calls[0] = calls[0], calls[0] + 1
                if n % every == 0 and n // every in RECORD_AT:
                    i = RECORD_AT.index(n // every)
                    state, chunk = args[0], args[4]
                    for k in FilterState._fields:
                        arrays[f"{tag}.{i}.state.{k}"] = getattr(state, k).cpu().numpy()
                    for k in ImuChunk._fields:
                        arrays[f"{tag}.{i}.chunk.{k}"] = getattr(chunk, k)[0].cpu().numpy()
                return step(*args)

            return recording

        harness.driver(cell).run(cell, RECORD_SEED, RECORD_SECONDS, False, fault=fault)
        missing = [i for i in range(len(RECORD_AT)) if f"{tag}.{i}.state.P" not in arrays]
        if missing:
            raise RuntimeError(f"{name}: {calls[0]} calls, too few for the rows {missing}")
        config = common.program_config(cell.config["config"])
        arrays[f"{tag}.q_diag"] = eskf.make_noise_params(config, dev).q_diag.cpu().numpy()
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes, {len(arrays)} arrays)")


def write_jax_outputs() -> None:
    """On the CPU: store each `JAX_CASES` case's inputs and the JAX
    package's outputs on them."""
    arrays = {}
    for label in JAX_CASES:
        inputs = jax_case_arrays(label)
        for key, value in flat_inputs(*inputs).items():
            arrays[f"{label}.{key}"] = value
        for key, value in jax_prefix(*inputs).items():
            arrays[f"{label}.out.{key}"] = value
    JAX_OUTPUTS.parent.mkdir(exist_ok=True)
    np.savez_compressed(JAX_OUTPUTS, **arrays)
    print(f"wrote {JAX_OUTPUTS} ({JAX_OUTPUTS.stat().st_size} bytes, {len(arrays)} arrays)")


if __name__ == "__main__":
    if sys.argv[1:2] == ["chunks"]:
        record_chunks(Path(sys.argv[2]) if len(sys.argv) > 2 else RECORDED)
    elif sys.argv[1:] == ["jax"]:
        write_jax_outputs()
    else:
        sys.exit(f"usage: {sys.argv[0]} chunks [OUT.npz] | jax")
