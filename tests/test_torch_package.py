"""Guards of the PyTorch port's rules.

* The port (`eskf_lio_torch/**`, `parallel/` included), `chip_smoke.py` and
  the two-process tests' worker script import neither JAX nor the JAX
  package (an AST scan of every import).
* The port's copy of the config has the JAX `Config`'s fields and
  defaults, and loads the shipped YAML the same way.
* Without CUDA an entry point called without `device="cpu"` raises; it
  never falls back to the CPU (the CLI's `--device` is held in
  `test_torch_cli.py`).
* The live path's host modules (CLI, stream, checkpoint, export, rosbag2,
  native runtime, profiling) import without matplotlib.
* The kernel modules import without nvcc or triton, and a kernel that
  cannot be built raises instead of falling back.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from eskf_lio_torch import config as t_config
from eskf_lio_torch.ops import _cuda
from eskf_lio_tpu import config as j_config

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "eskf_lio_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "_torch_dist_worker.py",
    ROOT / "tests" / "_torch_no_host_read.py",
]
FORBIDDEN = ("jax", "jaxlib", "eskf_lio_tpu")


def imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            yield from (a.value for a in node.args if isinstance(a, ast.Constant))


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_scan_covers_the_parallel_package_and_it_ships():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    assert {"eskf_lio_torch/parallel/__init__.py", "eskf_lio_torch/parallel/sharded_map.py",
            "eskf_lio_torch/parallel/distributed.py", "tests/_torch_dist_worker.py"} <= names
    # every directory of the package is a package, and the build takes them all
    for path in (ROOT / "eskf_lio_torch").rglob("*.py"):
        assert (path.parent / "__init__.py").exists(), path
    assert 'include = ["eskf_lio_tpu*", "eskf_lio_torch*"]' in (ROOT / "pyproject.toml").read_text()


def test_port_has_both_kernel_sources():
    """Kernels A and B, and the conditional graph nodes of the captured step."""
    names = {p.name for p in (ROOT / "eskf_lio_torch" / "csrc").glob("*.cu")}
    assert names == {"gn_normal_eq.cu", "segscan.cu", "graph_cond.cu"}


@pytest.mark.parametrize("cls", ["Config", "ImuConfig"])
def test_config_copy_has_same_fields_and_defaults(cls):
    t_cls, j_cls = getattr(t_config, cls), getattr(j_config, cls)
    t_fields = [(f.name, f.type) for f in dataclasses.fields(t_cls)]
    j_fields = [(f.name, f.type) for f in dataclasses.fields(j_cls)]
    assert t_fields == j_fields
    assert dataclasses.asdict(t_cls()) == dataclasses.asdict(j_cls())


def test_config_copy_loads_yaml_the_same():
    path = ROOT / "config" / "hilti.yaml"
    t, j = t_config.load_config(str(path)), j_config.load_config(str(path))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.align_capacity == j.align_capacity and t.hash_capacity == j.hash_capacity
    for key, val in t.imu.noise_sigmas().items():
        assert (val == j.imu.noise_sigmas()[key]).all()


def _entry_points():
    from eskf_lio_torch.io import dataset
    from eskf_lio_torch.map import voxel_map
    from eskf_lio_torch.models import eskf
    from eskf_lio_torch.parallel import distributed, sharded_map
    from eskf_lio_torch.pipeline import odometry, replay, stream

    cfg = t_config.Config(max_raw_points=256, max_scan_points=128, hash_capacity_log2=10)
    seq = dataset.make_synthetic_sequence(duration=0.5, points_per_scan=200)
    return {
        "run_replay": lambda **kw: replay.run_replay(cfg, seq, **kw),
        "make_replay_step": lambda **kw: replay.make_replay_step(cfg, **kw),
        "make_init_step": lambda **kw: odometry.make_init_step(cfg, **kw),
        "VoxelMap.create": lambda **kw: voxel_map.VoxelMap.create(1024, **kw),
        "init_state": lambda **kw: eskf.init_state(cfg, **kw),
        "Odometry": lambda **kw: odometry.Odometry(cfg, **kw),
        "StreamingRunner": lambda **kw: stream.StreamingRunner(cfg, **kw),
        "ShardedOdometry": lambda **kw: sharded_map.ShardedOdometry(cfg, n_devices=2, **kw),
        "ShardMesh.create": lambda **kw: distributed.ShardMesh.create(2, **kw),
        "make_sharded_scan_step": lambda **kw: sharded_map.make_sharded_scan_step(
            cfg, distributed.ShardMesh.create(2, **kw)),
    }


@pytest.mark.parametrize(
    "name",
    ["run_replay", "make_replay_step", "make_init_step", "VoxelMap.create", "init_state",
     "Odometry", "StreamingRunner", "ShardedOdometry", "ShardMesh.create",
     "make_sharded_scan_step"],
)
def test_entry_points_default_to_cuda_and_refuse_without_it(name):
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device works")
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fn()
    fn(device="cpu")  # asking for the CPU works


def test_kernel_modules_import_without_toolchain(tmp_path):
    """A fresh interpreter with no nvcc on PATH imports the kernel modules,
    loads no library and no triton, and runs the plain versions on CPU
    tensors."""
    code = (
        "import sys, torch\n"
        "from eskf_lio_torch.ops import segscan, gn_normal_eq\n"
        "import eskf_lio_torch.pipeline.replay\n"
        "k = torch.tensor([0, 0, 1], dtype=torch.int32)\n"
        "v = torch.ones(3, 2)\n"
        "assert segscan.segsum_sorted(k, v)[0].tolist() == [2.0, 2.0]\n"
        "assert segscan.KERNEL._lib is None and gn_normal_eq.KERNEL._lib is None\n"
        "assert segscan.KERNEL.launches == 0\n"
        "assert 'triton' not in sys.modules and 'jax' not in sys.modules\n"
    )
    env = dict(os.environ, PATH=str(tmp_path), CUDA_HOME=str(tmp_path / "none"),
               PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_live_path_imports_no_matplotlib():
    """`viz/` is imported lazily: a run without --viz needs no matplotlib."""
    code = (
        "import sys\n"
        "import eskf_lio_torch.cli, eskf_lio_torch.pipeline.stream\n"
        "import eskf_lio_torch.parallel.sharded_map, eskf_lio_torch.parallel.distributed\n"
        "import eskf_lio_torch.utils.checkpoint, eskf_lio_torch.utils.profiling\n"
        "import eskf_lio_torch.io.export, eskf_lio_torch.io.rosbag2\n"
        "import eskf_lio_torch.viz.live, eskf_lio_torch.viz.visualize\n"
        "assert 'matplotlib' not in sys.modules and 'jax' not in sys.modules\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_missing_nvcc_raises_instead_of_falling_back(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "build")
    kernel = _cuda.CudaKernel("segscan", "segscan.cu", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel.lib()
    assert kernel.launches == 0


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    """The build cache is keyed by the source bytes and flags."""
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_cuda, "CSRC_DIR", tmp_path)
    a = _cuda.CudaKernel("k", "k.cu", {}).library_path()
    src.write_text("// two")
    b = _cuda.CudaKernel("k", "k.cu", {}).library_path()
    assert a != b and a.parent == b.parent == _cuda.BUILD_DIR


def test_kernel_stamp_anchors_match_the_sources():
    """The phase-timing tool places its clock stamps by text anchors in the
    kernel sources: every anchor still matches exactly once."""
    from eskf_lio_torch.utils import kernel_stamps as ks

    for name, stamps, plumbing in (("gn_normal_eq", ks.GN_STAMPS, ks.GN_PLUMBING),
                                   ("segscan", ks.SEG_STAMPS, ks.SEG_PLUMBING)):
        src = (_cuda.CSRC_DIR / f"{name}.cu").read_text()
        stamped = ks.apply_stamps(src, stamps, plumbing)
        assert stamped.count("  STAMP(") == len(stamps) <= ks.SLOTS
        assert "long long* stamps" in stamped
    with pytest.raises(ValueError, match="anchor"):
        ks.apply_stamps("namespace {\n", [("x", "not there", True)], [])


def test_chip_smoke_refuses_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
