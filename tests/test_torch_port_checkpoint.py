"""Sampler state rides a ``torch.save`` of the train state: the port's
counterpart of the JAX package's orbax integration suite.

A train state from ``models/train.py``'s ``create_state`` (a small GPT and
its AdamW, on a gloo group of one on the CPU) is saved with the sampler's
``state_dict()`` in one ``torch.save`` file and restored: a mid-epoch
resume, the config validation on load, plain restored types, and a world
change on restore whose §6 remainder equals the JAX package's.  The
``utils/checkpoint.py`` helpers write files byte-equal to the JAX
package's for the same state, and each package resumes from the other's.
Tolerance 0.
"""

import json
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from partiallyshuffledistributedsampler_tpu import (
    PartiallyShuffleDistributedSampler as JSampler,
)
from partiallyshuffledistributedsampler_tpu.ops.cpu import epoch_indices_np
from partiallyshuffledistributedsampler_tpu.utils import checkpoint as JCk
from partiallyshuffledistributedsampler_tpu_torch import (
    PartiallyShuffleDistributedSampler,
    parallel,
)
from partiallyshuffledistributedsampler_tpu_torch.models import GPTConfig
from partiallyshuffledistributedsampler_tpu_torch.models.train import (
    create_state,
)
from partiallyshuffledistributedsampler_tpu_torch.utils import checkpoint as PCk

N, WINDOW, WORLD = 1000, 64, 4
TINY = GPTConfig(vocab_size=64, seq_len=16, d_model=32, n_layers=1,
                 n_heads=2, d_ff=64, dtype=torch.float32)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A gloo group of one process on the CPU (destroyed afterwards, so no
    other test file sees a group)."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield parallel.data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def make(rank=0, **kw):
    return PartiallyShuffleDistributedSampler(
        N, num_replicas=WORLD, rank=rank, window=WINDOW, backend="cpu", **kw)


def roundtrip(tmp_path, mesh, sampler_state, step=0):
    """One ``torch.save`` file holding the model, its optimizer, the step
    and the sampler's state — the pattern a training job uses — loaded
    back with ``weights_only=True`` (the sampler state is plain data)."""
    model, opt = create_state(TINY, mesh, 5)
    x = torch.randint(0, TINY.vocab_size, (2, TINY.seq_len))
    model(x).float().sum().backward()
    opt.step()
    path = tmp_path / "ckpt.pt"
    torch.save({"model": model.state_dict(), "opt": opt.state_dict(),
                "step": step, "sampler": sampler_state}, path)
    restored = torch.load(path, weights_only=True)
    model2, opt2 = create_state(TINY, mesh, 0)
    model2.load_state_dict(restored["model"])
    opt2.load_state_dict(restored["opt"])
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)
    assert restored["step"] == step
    return restored


def test_sampler_state_roundtrips_with_train_state(tmp_path, mesh):
    s = make()
    s.set_epoch(5)
    it = iter(s)
    for _ in range(37):
        next(it)
    restored = roundtrip(tmp_path, mesh, s.state_dict(), step=37)
    s2 = make()
    s2.load_state_dict(restored["sampler"])
    resumed = list(s2)
    ref = epoch_indices_np(N, WINDOW, 0, 5, 0, WORLD).tolist()
    assert resumed == ref[37:], "the restored sampler diverged mid-epoch"
    # the JAX package's sampler resumes from the same restored state
    j = JSampler(N, num_replicas=WORLD, rank=0, window=WINDOW,
                 backend="cpu")
    j.load_state_dict(restored["sampler"])
    assert list(j) == resumed


def test_config_validation_survives_roundtrip(tmp_path, mesh):
    s = make()
    s.set_epoch(1)
    restored = roundtrip(tmp_path, mesh, s.state_dict())
    wrong = PartiallyShuffleDistributedSampler(
        N, num_replicas=WORLD, rank=0, window=128, backend="cpu")
    with pytest.raises(ValueError, match="window"):
        wrong.load_state_dict(restored["sampler"])


def test_restored_types_are_plain(tmp_path, mesh):
    s = make()
    s.set_epoch(2)
    state = roundtrip(tmp_path, mesh, s.state_dict(consumed=10))["sampler"]
    assert all(isinstance(v, (bool, int, str)) for v in state.values()), \
        {k: type(v) for k, v in state.items()}
    s2 = make()
    s2.load_state_dict(state)
    want = epoch_indices_np(N, WINDOW, 0, 2, 0, WORLD).tolist()[10:]
    assert list(s2) == want
    # numpy scalars (what other checkpointers restore) load as well
    s3 = make()
    s3.load_state_dict({k: (np.int64(v) if type(v) is int else v)
                        for k, v in state.items()})
    assert list(s3) == want


@pytest.mark.parametrize("new_world", [2, 3, 8])
def test_world_change_on_restore_equals_the_jax_remainder(tmp_path, mesh,
                                                          new_world):
    """Preemption: checkpoint at world 4, restore at another world through
    ``reshard_from_state_dict``; each new rank's §6 remainder equals the
    JAX package's, and together they serve every unconsumed sample."""
    consumed = 40
    s = make()
    s.set_epoch(3)
    state = roundtrip(tmp_path, mesh, s.state_dict(consumed=consumed))[
        "sampler"]
    served = []
    for r in range(new_world):
        p = PartiallyShuffleDistributedSampler.reshard_from_state_dict(
            state, num_replicas=new_world, rank=r, backend="cpu")
        j = JSampler.reshard_from_state_dict(
            state, num_replicas=new_world, rank=r, backend="cpu")
        got = list(p)
        assert got == list(j), r
        served.extend(got)
        assert p.state_dict()["elastic"] == j.state_dict()["elastic"]
    rest = [x for r in range(WORLD)
            for x in epoch_indices_np(N, WINDOW, 0, 3, r, WORLD)[consumed:]]
    assert set(served) >= set(rest)


def test_sampler_state_files_cross_packages(tmp_path):
    s = make(rank=1)
    s.set_epoch(7)
    it = iter(s)
    for _ in range(13):
        next(it)
    state = s.state_dict()
    pp, jp = tmp_path / "port.json", tmp_path / "jax.json"
    PCk.save_sampler_state(str(pp), state, durable=True)
    JCk.save_sampler_state(str(jp), state)
    assert pp.read_bytes() == jp.read_bytes()
    assert JCk.load_sampler_state(str(pp)) == state
    assert PCk.load_sampler_state(str(jp)) == state
    # the JAX package's sampler resumes from the port's file, and the
    # port's from the JAX package's
    j = JSampler(N, num_replicas=WORLD, rank=1, window=WINDOW, backend="cpu")
    j.load_state_dict(JCk.load_sampler_state(str(pp)))
    p = make(rank=1)
    p.load_state_dict(PCk.load_sampler_state(str(jp)))
    want = epoch_indices_np(N, WINDOW, 0, 7, 1, WORLD).tolist()[13:]
    assert list(j) == list(p) == want
    # the JAX sampler's own state file loads into the port's sampler
    j2 = JSampler(N, num_replicas=WORLD, rank=1, window=WINDOW,
                  backend="cpu")
    j2.set_epoch(7)
    JCk.save_sampler_state(str(jp), j2.state_dict(consumed=13))
    p2 = make(rank=1)
    p2.load_state_dict(PCk.load_sampler_state(str(jp)))
    assert list(p2) == want


def test_durable_write_is_atomic_and_tenant_paths(tmp_path):
    path = tmp_path / "snap.json"
    PCk.durable_write_text(str(path), json.dumps({"a": 1}))
    assert json.loads(path.read_text()) == {"a": 1}
    assert [p.name for p in tmp_path.iterdir()] == ["snap.json"]
    assert PCk.tenant_snapshot_path(str(path), "t0a1") \
        == JCk.tenant_snapshot_path(str(path), "t0a1")
    for tid in ("t0a1", "t9"):
        PCk.durable_write_text(PCk.tenant_snapshot_path(str(path), tid), "{}")
    assert PCk.list_tenant_snapshots(str(path)) \
        == JCk.list_tenant_snapshots(str(path))
    assert sorted(PCk.list_tenant_snapshots(str(path))) == ["t0a1", "t9"]
    assert PCk.list_tenant_snapshots(str(tmp_path / "no" / "x.json")) == {}

    with pytest.raises(TypeError):
        PCk.durable_write_text(str(path), 123)
    assert json.loads(path.read_text()) == {"a": 1}
    assert sorted(p.name for p in tmp_path.iterdir()
                  if p.suffix == ".tmp") == []
