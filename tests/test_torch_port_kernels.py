"""Each CUDA kernel's plain PyTorch version against the JAX package's
Pallas kernel in interpret mode (tolerance 0: the law is integer-exact),
the CPU routing of the wrappers, the named refusals of the CUDA path on a
machine without a GPU, and the port's import isolation.  The kernels
themselves are tested on the card by ``tests/test_torch_port_gpu.py``.
"""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops import cpu as jcpu
from partiallyshuffledistributedsampler_tpu.ops import xla
from partiallyshuffledistributedsampler_tpu.ops.pallas_kernel import (
    epoch_indices_pallas,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda,
    cuda_kernel as ck,
    ensure_index_backend,
    epoch_indices_host,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler.shard_mode import (
    expand_shard_indices_cuda,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "partiallyshuffledistributedsampler_tpu_torch"

#: the configs of tests/test_pallas.py::test_pallas_bit_identical
PALLAS_CONFIGS = [
    dict(n=5000, window=512, world=2),
    dict(n=1024, window=64, world=8),
    dict(n=12_345, window=512, world=8),
    dict(n=100, window=7, world=3),
    dict(n=4096, window=4096, world=4),
    dict(n=2000, window=128, world=4, partition="blocked"),
    dict(n=2000, window=128, world=4, order_windows=False),
    dict(n=999, window=50, world=2, shuffle=False),
    dict(n=640, window=64, world=8, drop_last=True),
]
#: the amortized-kernel shapes of tests/test_pallas.py (n <= 70k)
AMORTIZED_SHAPES = [
    (4096, 256, 8),
    (8200, 128, 8),
    (4096, 256, 2),
    (4100, 512, 2),
    (70_000, 32768, 2),
    (50_000, 16384, 2),
]


def _cfg_id(c):
    return "-".join(f"{k}{v}" for k, v in c.items())


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the CPU-only refusals do not apply")


# ------------------------------------------- plain versions vs Pallas
@pytest.mark.parametrize("cfg", PALLAS_CONFIGS, ids=_cfg_id)
def test_index_general_ref_matches_pallas_interpret(cfg):
    cfg = dict(cfg)
    n, w, world = cfg.pop("n"), cfg.pop("window"), cfg.pop("world")
    for rank in (0, world - 1):
        want = np.asarray(epoch_indices_pallas(n, w, 42, 3, rank, world,
                                               interpret=True, **cfg))
        got = ck.index_general_ref(n, w, 42, 3, rank, world, **cfg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        # the wrapper routes a CPU device to the plain version
        np.testing.assert_array_equal(
            ck.index_general(n, w, 42, 3, rank, world, device="cpu",
                             **cfg).numpy(), want)


def test_index_general_ref_big_seed_matches_pallas_interpret():
    want = np.asarray(epoch_indices_pallas(3000, 100, (1 << 40) + 9, 77, 1,
                                           2, interpret=True))
    got = ck.index_general_ref(3000, 100, (1 << 40) + 9, 77, 1, 2)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,window,world", AMORTIZED_SHAPES)
def test_index_amortized_ref_matches_pallas_amortized_kernel(n, window,
                                                             world):
    """``epoch_indices_jax(use_pallas=True)`` serves these shapes with the
    amortized Pallas kernel (interpreted on the CPU)."""
    assert cuda._amortized_applicable(n, window, world, True, "strided")
    for rank in (0, world - 1):
        for epoch in (0, 9):
            want = np.asarray(xla.epoch_indices_jax(
                n, window, 5, epoch, rank, world, use_pallas=True))
            ku = ck.window_order_ids_ref(n, window, 5, epoch)
            ns, _ = core.shard_sizes(n, world, False)
            got = ck.index_amortized_ref(ku, n, window, 5, epoch, rank,
                                         world, ns)
            np.testing.assert_array_equal(got.numpy(), want)
            # the wrapper of the one-launch kernel routes a CPU device to
            # the whole plain evaluation
            np.testing.assert_array_equal(
                ck.index_amortized(n, window, 5, epoch, rank, world,
                                   device="cpu").numpy(), want)


#: the fused amortized kernel's tile edges (csrc/index_kernels.cu): m = 1,
#: m above any tile, slots cut by tile edges, one window, no window order,
#: drop_last, tail and wrap-padding lanes
TILE_EDGE_SHAPES = [
    (200_000, 64, 64, {}),                         # m = 1
    (100_000, 8192, 1, {}),                        # m = 8192
    (1_000_003, 600, 8, {}),                       # m = 75
    (5000, 4096, 4, {}),                           # nw = 1
    (50_000, 512, 8, dict(order_windows=False)),
    (50_003, 512, 8, dict(drop_last=True)),
    (50_003, 512, 8, dict(rounds=5)),              # 37 tail/padding lanes
]


@pytest.mark.parametrize("n,window,world,kw", TILE_EDGE_SHAPES)
def test_index_amortized_wrapper_on_cpu_matches_numpy(n, window, world, kw):
    """The CPU route of the one-launch wrapper (its plain version) at the
    shapes the card tests hold the kernel at, against the JAX package's
    numpy reference."""
    assert cuda._amortized_applicable(n, window, world, True, "strided")
    for rank in (0, world - 1):
        got = ck.index_amortized(n, window, 3, 4, rank, world, device="cpu",
                                 **kw)
        np.testing.assert_array_equal(
            got.numpy(), jcpu.epoch_indices_np(n, window, 3, 4, rank, world,
                                               **kw))


@pytest.mark.parametrize("n,window,order_windows", [
    (10**9, 8192, True),       # nw = 122,070: the headline window count
    (70_000, 32768, True),     # nw = 2
    (4096, 4096, True),        # nw = 1: the identity
    (12_345, 512, False),
])
def test_window_order_ids_ref_matches_xla(n, window, order_windows):
    sv = np.array([7, 0, 3, 0], dtype=np.uint32)
    want, _ = xla._window_order_ids(sv, n, window, order_windows, 24)
    got = ck.window_order_ids_ref(n, window, 7, 3,
                                  order_windows=order_windows)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,window,world,kw", [
    (4096, 256, 8, {}),
    (12_345, 512, 8, {}),
    (900, 1024, 2, {}),                      # nw = 0: general route
    (2000, 128, 4, dict(partition="blocked")),
    (999, 50, 2, dict(shuffle=False)),
    (1000, 64, 64, {}),                      # m = window // world = 1
    (1000, 100, 8, {}),                      # window % world != 0
])
def test_epoch_entry_on_cpu_matches_xla_entry(n, window, world, kw):
    """The slice's entry point, both routes, against the JAX package's
    entry point (XLA evaluator on the CPU)."""
    for rank in (0, world - 1):
        want = np.asarray(xla.epoch_indices_jax(
            n, window, 11, 2, rank, world, use_pallas=False, **kw))
        for amortize in (True, False):
            got = cuda.epoch_indices_cuda(n, window, 11, 2, rank, world,
                                          amortize=amortize, device="cpu",
                                          **kw)
            np.testing.assert_array_equal(got.numpy(), want)
        fn = cuda.build_evaluator(n, window, world, device="cpu", **kw)
        np.testing.assert_array_equal(fn(11, 2, rank).numpy(), want)


def test_stream_and_elastic_entries_on_cpu_match_jax():
    rng = np.random.default_rng(3)
    pos = rng.integers(0, 10**7, size=3000)
    want = np.asarray(xla.stream_indices_at_jax(pos, 10**6, 1000, 4, 1))
    got = cuda.stream_indices_at_cuda(torch.from_numpy(pos), 10**6, 1000, 4,
                                      1, device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    chain, _remaining, ns = core.elastic_chain(5000, [(4, 100), (3, 7)], 2)
    want = np.asarray(xla.elastic_indices_jax(5000, 128, 4, 1, 1, 2, ns,
                                              chain))
    got = cuda.elastic_indices_cuda(5000, 128, 4, 1, 1, 2, ns, chain,
                                    device="cpu")
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        jcpu.elastic_indices_np(5000, 128, 4, 1, 1, 2, [(4, 100), (3, 7)]))


def test_epoch_indices_host_cpu_matches_numpy_reference():
    got = epoch_indices_host("cpu", 12_345, 512, 3, 1, 2, 8,
                             partition="blocked")
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(
        got, jcpu.epoch_indices_np(12_345, 512, 3, 1, 2, 8,
                                   partition="blocked"))


def test_cpu_routing_launches_no_kernel():
    ck.reset_launches()
    cuda.epoch_indices_cuda(4096, 256, 0, 0, 0, 8, device="cpu")
    cuda.epoch_indices_cuda(4096, 256, 0, 0, 0, 8, device="cpu",
                            amortize=False)
    expand_shard_indices_cuda([2, 0, 3], [5, 0, 7, 3, 4], device="cpu")
    assert ck.launches == {"index_general": 0,
                           "index_amortized": 0, "index_general_wide": 0,
                           "index_amortized_wide": 0,
                           "index_positions": 0, "index_positions_wide": 0,
                           "mixture_source_keys": 0, "mixture_fused": 0,
                           "shard_row_keys": 0, "shard_expand": 0,
                           "weighted_stream": 0, "weighted_stream_wide": 0}


# ------------------------------------------------------------- refusals
def test_cuda_path_raises_named_error_without_gpu(no_gpu):
    with pytest.raises(ck.CudaUnavailableError):
        cuda.epoch_indices_cuda(1000, 64, 42, 3, 1, 4)
    with pytest.raises(ck.CudaUnavailableError):
        cuda.epoch_indices_cuda(1000, 64, 42, 3, 1, 4, amortize=False)
    with pytest.raises(ck.CudaUnavailableError):
        ck.index_amortized(1000, 64, 0, 0, 0, 2)
    with pytest.raises(ck.CudaUnavailableError):
        ck.index_amortized_wide(2**31 + 5000, 8192, 0, 0, 0, 8)
    with pytest.raises(ck.CudaUnavailableError):
        ensure_index_backend("cuda")
    with pytest.raises(ck.CudaUnavailableError):
        epoch_indices_host("cuda", 1000, 64, 0, 0, 0, 2)
    with pytest.raises(ck.CudaUnavailableError):
        cuda.elastic_indices_cuda(1000, 64, 0, 0, 0, 2, 10, ((2, 500, 490),))
    with pytest.raises(ck.CudaUnavailableError):
        cuda.stream_indices_at_cuda(np.arange(10), 1000, 64, 0, 0)
    assert issubclass(ck.CudaUnavailableError, RuntimeError)


def test_refusals_on_every_machine():
    # what the law refuses, before anything is allocated
    with pytest.raises(ValueError, match="n // window"):
        cuda.epoch_indices_cuda(2**33, 1, 0, 0, 0, 2**20, device="cpu")
    with pytest.raises(ValueError, match="window"):
        cuda.epoch_indices_cuda(100, 0, 0, 0, 0, 1, device="cpu")
    with pytest.raises(ValueError, match="world"):
        cuda.epoch_indices_cuda(100, 10, 0, 0, 0, 0, device="cpu")
    with pytest.raises(ValueError, match="rank"):
        cuda.epoch_indices_cuda(100, 10, 0, 0, 2, 2, device="cpu")
    with pytest.raises(ValueError, match="partition"):
        cuda.epoch_indices_cuda(100, 10, 0, 0, 0, 2, partition="x",
                                device="cpu")
    with pytest.raises(ValueError, match="device"):
        ck.index_general(100, 10, 0, 0, 0, 2, device="meta")
    with pytest.raises(ValueError, match="window % world"):
        ck.index_amortized(100, 100, 0, 0, 0, 3, device="cpu")
    with pytest.raises(ValueError, match="n >= window"):
        ck.index_amortized(100, 200, 0, 0, 0, 2, device="cpu")
    with pytest.raises(ValueError,
                       match="partiallyshuffledistributedsampler_tpu"):
        ensure_index_backend("xla")
    # 'native' loads the port's own C++ build (g++ is here); 'auto' is
    # resolved by each surface before it reaches the check
    ensure_index_backend("native")
    with pytest.raises(ValueError, match="'cpu', 'native' or 'cuda'"):
        ensure_index_backend("auto")


# ------------------------------------------------------ import isolation
def _port_sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


#: top-level modules of the JAX side: JAX itself, flax and optax (the JAX
#: package's model and optimizer libraries) and the JAX package
_JAX_SIDE = ("jax", "flax", "optax", "partiallyshuffledistributedsampler_tpu")


def _imports_jax_side(name: str) -> bool:
    return name.split(".")[0] in _JAX_SIDE


def test_port_sources_import_no_jax():
    """AST scan: no module of the port, and not chip_smoke.py, imports jax,
    flax, optax or the JAX package (not even its numpy-only modules)."""
    offenders = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            offenders += [f"{path.name}: {n}" for n in names
                          if _imports_jax_side(n)]
    assert not offenders, offenders
    assert len(_port_sources()) >= 12


def test_importing_the_port_loads_no_jax():
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {_JAX_SIDE!r}]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr


def test_importing_the_port_has_no_side_effects():
    """Importing every module of the port (the examples and
    ``ops/native.py`` included) starts no process (no build, no training
    run) and makes no process group."""
    mods = [".".join(p.relative_to(ROOT).with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m[: -len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    assert any(".examples." in m for m in mods)
    code = (
        "import importlib, subprocess, sys\n"
        "def refuse(*a, **k):\n"
        "    raise AssertionError(f'a process was started: {a!r}')\n"
        "subprocess.Popen = subprocess.run = refuse\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "import torch.distributed as dist\n"
        "from partiallyshuffledistributedsampler_tpu_torch.ops import native\n"
        "assert not dist.is_initialized()\n"
        "assert native._lib is None\n"
        "print('IMPORT_OK')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "IMPORT_OK" in res.stdout
