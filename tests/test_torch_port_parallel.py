"""The port's ``parallel/`` over real process groups on the CPU: 2 and 4
gloo processes, each importing only the port, against the JAX package's
mesh-sharded rows on the conftest's virtual CPU devices (tolerance 0: the
law is integer-exact), with divergent local seeds where rank 0's must win.
"""

import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from partiallyshuffledistributedsampler_tpu.ops.cpu import epoch_indices_np
from partiallyshuffledistributedsampler_tpu.ops.mixture import (
    MixtureSpec as JaxMixtureSpec,
    mixture_epoch_indices_np,
)
from partiallyshuffledistributedsampler_tpu.parallel import (
    data_mesh as jax_data_mesh,
    sharded_elastic_indices as jax_sharded_elastic_indices,
    sharded_epoch_indices as jax_sharded_epoch_indices,
    sharded_mixture_elastic_indices as jax_sharded_mixture_elastic_indices,
    sharded_mixture_indices as jax_sharded_mixture_indices,
)
from partiallyshuffledistributedsampler_tpu_torch import MixtureSpec, parallel
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    CudaUnavailableError,
    cuda,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEED, EPOCH = (1 << 40) + 17, 6
#: (n, window, law kwargs): the amortized route, the general route
#: (blocked, window % world != 0) and an unshuffled config
EPOCH_CONFIGS = [
    (5000, 512, {}),
    (12_345, 100, {"partition": "blocked"}),
    (999, 50, {"shuffle": False}),
]
#: (n, window, layers): one reshard, a cascade, blocked, and a fully
#: consumed epoch (empty remainder)
ELASTIC_CONFIGS = [
    (5000, 128, [(3, 400)], {}),
    (5000, 128, [(4, 100), (3, 7)], {}),
    (4000, 64, [(2, 900)], {"partition": "blocked"}),
    (1000, 64, [(2, 500)], {}),
]
#: mixtures (SPEC.md §8): (sources, weights, spec kwargs, law kwargs): the
#: v2 rotated stream, a v1 blocked one with epoch_samples, an unshuffled one
MIXTURE_SPEC = ([1000, 500, 2500], [5, 1, 4], {"windows": 64, "block": 100})
MIXTURE_CONFIGS = [
    (*MIXTURE_SPEC, {}),
    ([1000, 500, 2500], [5, 1, 4],
     {"windows": 64, "block": 100, "pattern_version": 1},
     {"partition": "blocked", "epoch_samples": 3000}),
    ([700, 37, 300, 64], [7, 1, 3, 2],
     {"windows": [64, 8, 100, 64], "block": 64}, {"shuffle": False}),
]
#: (layers, law kwargs) of the mixture remainders over MIXTURE_SPEC: one
#: reshard, a blocked cascade, a fully consumed epoch
MIXTURE_ELASTIC = [
    ([(3, 400)], {}),
    ([(4, 100), (3, 7)], {"partition": "blocked"}),
    ([(2, 2000)], {}),
]

_WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist

    rank, world, port, out = (int(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), sys.argv[4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    from partiallyshuffledistributedsampler_tpu_torch import (
        MixtureSpec,
        parallel,
    )

    EPOCH_CONFIGS, ELASTIC_CONFIGS, SEED, EPOCH, LOCAL = (
        eval(sys.argv[5]), eval(sys.argv[6]), int(sys.argv[7]),
        int(sys.argv[8]), eval(sys.argv[9]))
    MIXTURE_SPEC, MIXTURE_CONFIGS, MIXTURE_ELASTIC = (
        eval(sys.argv[10]), eval(sys.argv[11]), eval(sys.argv[12]))
    parallel.ensure_distributed()  # a group exists: a no-op
    mesh = parallel.data_mesh(device="cpu")
    assert parallel.identity_from_mesh(mesh) == (world, rank)
    assert parallel.local_ranks_from_mesh(mesh) == [rank]
    rows = {}
    for i, (n, w, kw) in enumerate(EPOCH_CONFIGS):
        rows[f"epoch{i}"] = parallel.sharded_epoch_indices(
            n, w, SEED, EPOCH, mesh=mesh, **kw).numpy()
        rows[f"epoch{i}_local"] = parallel.sharded_epoch_indices(
            n, w, None, None, mesh=mesh, local_seeds=LOCAL[rank],
            **kw).numpy()
    fn, ns = parallel.make_regen_fn(5000, 512, mesh=mesh)
    for e in (0, 1):
        row = fn(parallel.make_seed_triple(SEED, e, mesh=mesh))
        assert row.shape == (ns,)
        rows[f"regen{e}"] = row.numpy()
    for i, (n, w, layers, kw) in enumerate(ELASTIC_CONFIGS):
        rows[f"elastic{i}"] = parallel.sharded_elastic_indices(
            n, w, None, None, layers, mesh=mesh, local_seeds=LOCAL[rank],
            **kw).numpy()
    for i, (sizes, weights, skw, kw) in enumerate(MIXTURE_CONFIGS):
        spec = MixtureSpec(sizes, weights, **skw)
        rows[f"mix{i}"] = parallel.sharded_mixture_indices(
            spec, SEED, EPOCH, mesh=mesh, **kw).numpy()
        rows[f"mix{i}_local"] = parallel.sharded_mixture_indices(
            spec, None, None, mesh=mesh, local_seeds=LOCAL[rank],
            **kw).numpy()
    spec = MixtureSpec(MIXTURE_SPEC[0], MIXTURE_SPEC[1], **MIXTURE_SPEC[2])
    fn, ns = parallel.make_mixture_regen_fn(spec, mesh=mesh)
    row = fn(parallel.make_seed_triple(SEED, 1, mesh=mesh))
    assert row.shape == (ns,)
    rows["mixregen"] = row.numpy()
    for i, (layers, kw) in enumerate(MIXTURE_ELASTIC):
        rows[f"mixel{i}"] = parallel.sharded_mixture_elastic_indices(
            spec, None, None, layers, mesh=mesh, local_seeds=LOCAL[rank],
            **kw).numpy()
    np.savez(f"{out}/rank{rank}.npz", **rows)
    dist.destroy_process_group()
    print(f"PARALLEL_OK rank={rank}")
""")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _local_seeds(world: int) -> np.ndarray:
    """Rank 0 holds the real triple; every other rank a divergent one."""
    lo, hi = SEED & 0xFFFFFFFF, SEED >> 32
    return np.array([[lo, hi, EPOCH]]
                    + [[5000 + r, r, 90 + r] for r in range(1, world)],
                    dtype=np.uint32)


def _run_workers(world: int, out: pathlib.Path, timeout: float) -> dict:
    port = _free_port()
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    local = _local_seeds(world).tolist()
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(r), str(world), str(port),
             str(out), repr(EPOCH_CONFIGS), repr(ELASTIC_CONFIGS), str(SEED),
             str(EPOCH), repr(local), repr(MIXTURE_SPEC),
             repr(MIXTURE_CONFIGS), repr(MIXTURE_ELASTIC)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=str(ROOT), env=env,
        )
        for r in range(world)
    ]
    results = []
    try:
        for p in procs:
            results.append(p.communicate(timeout=timeout))
    except subprocess.TimeoutExpired:
        pytest.fail(f"{world} gloo workers did not finish in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (stdout, stderr) in zip(procs, results):
        assert p.returncode == 0, stderr[-3000:]
        assert "PARALLEL_OK" in stdout
    return {r: dict(np.load(out / f"rank{r}.npz")) for r in range(world)}


@pytest.mark.timeout(240)
@pytest.mark.parametrize("world", [2, 4])
def test_gloo_rows_match_the_jax_mesh(world, tmp_path):
    rows = _run_workers(world, tmp_path, timeout=180)
    mesh = jax_data_mesh(n_devices=world)
    local = _local_seeds(world)
    for i, (n, w, kw) in enumerate(EPOCH_CONFIGS):
        want = np.asarray(jax_sharded_epoch_indices(mesh, n, w, SEED, EPOCH,
                                                    **kw))
        for r in range(world):
            np.testing.assert_array_equal(rows[r][f"epoch{i}"], want[r])
            # divergent local seeds: rank 0's triple wins on every rank
            np.testing.assert_array_equal(rows[r][f"epoch{i}_local"],
                                          want[r])
    for e in (0, 1):
        for r in range(world):
            np.testing.assert_array_equal(
                rows[r][f"regen{e}"],
                epoch_indices_np(5000, 512, SEED, e, r, world))
    for i, (n, w, layers, kw) in enumerate(ELASTIC_CONFIGS):
        want = np.asarray(jax_sharded_elastic_indices(
            mesh, n, w, None, None, layers, local_seeds=local, **kw))
        for r in range(world):
            got = rows[r][f"elastic{i}"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want[r])
    # the mixture rows (SPEC.md §8), rank 0's seed winning as above
    for i, (sizes, weights, skw, kw) in enumerate(MIXTURE_CONFIGS):
        spec = JaxMixtureSpec(sizes, weights, **skw)
        want = np.asarray(jax_sharded_mixture_indices(mesh, spec, SEED,
                                                      EPOCH, **kw))
        for r in range(world):
            np.testing.assert_array_equal(rows[r][f"mix{i}"], want[r])
            np.testing.assert_array_equal(rows[r][f"mix{i}_local"], want[r])
    spec = JaxMixtureSpec(MIXTURE_SPEC[0], MIXTURE_SPEC[1], **MIXTURE_SPEC[2])
    for r in range(world):
        np.testing.assert_array_equal(
            rows[r]["mixregen"],
            mixture_epoch_indices_np(spec, SEED, 1, r, world))
    for i, (layers, kw) in enumerate(MIXTURE_ELASTIC):
        want = np.asarray(jax_sharded_mixture_elastic_indices(
            mesh, spec, None, None, layers, local_seeds=local, **kw))
        for r in range(world):
            got = rows[r][f"mixel{i}"]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want[r])


def test_parallel_entries_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present: the CPU-only refusals do not apply")
    with pytest.raises(CudaUnavailableError):
        parallel.make_seed_triple(0, 0)
    with pytest.raises(CudaUnavailableError):
        parallel.data_mesh()
    with pytest.raises(CudaUnavailableError):
        parallel.sharded_epoch_indices(1000, 64, 0, 0)
    with pytest.raises(CudaUnavailableError):
        parallel.make_regen_fn(1000, 64)
    with pytest.raises(CudaUnavailableError):
        parallel.sharded_elastic_indices(1000, 64, 0, 0, [(2, 10)])
    spec = MixtureSpec(*MIXTURE_SPEC[:2], **MIXTURE_SPEC[2])
    with pytest.raises(CudaUnavailableError):
        parallel.sharded_mixture_indices(spec, 0, 0)
    with pytest.raises(CudaUnavailableError):
        parallel.make_mixture_regen_fn(spec)
    with pytest.raises(CudaUnavailableError):
        parallel.sharded_mixture_elastic_indices(spec, 0, 0, [(2, 10)])
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    parallel.ensure_distributed()  # no environment: a no-op
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="not initialized"):
        parallel.data_mesh(device="cpu")


def test_seed_triple_layout():
    t = parallel.make_seed_triple((1 << 63) | 5, 2**32 + 3, device="cpu")
    assert t.dtype == torch.int32 and t.shape == (3,)
    assert t.numpy().view(np.uint32).tolist() == [5, 1 << 31, 3]
    t = parallel.make_seed_triple(None, None, local_seeds=(7, 0xFFFFFFFF, 1),
                                  device="cpu")
    assert t.numpy().view(np.uint32).tolist() == [7, 0xFFFFFFFF, 1]
    with pytest.raises(ValueError, match="local_seeds"):
        parallel.make_seed_triple(None, None, local_seeds=(1, 2),
                                  device="cpu")
    with pytest.raises(ValueError, match="local_seeds"):
        parallel.make_seed_triple(None, None, local_seeds=(1, 2, 2**32),
                                  device="cpu")
    # the triple drives the law as the scalars do (here on the CPU)
    got = cuda.epoch_indices_cuda(5000, 512, None, None, 1, 2, device="cpu",
                                  triple=parallel.make_seed_triple(
                                      SEED, EPOCH, device="cpu"))
    want = cuda.epoch_indices_cuda(5000, 512, SEED, EPOCH, 1, 2,
                                   device="cpu")
    assert torch.equal(got, want)
