"""The port's spans at its layer boundaries, on the profiler's clock.

* A span's ``[start_ns, start_ns + ms]`` encloses, on the clock of
  ``torch.profiler``'s events, the Kineto event of a torch op run inside
  it.
* With tracing and the profiler both off, the regen, loader and step
  paths enter no ``record_function`` and record no CUDA event; with only
  a profiler on, the profiler ranges appear under the names they had.
* Traced on the CPU: a shard-mode regen is ``psds_shard_regen`` over its
  children, ``HostDataLoader`` gives ``loader.gather`` / ``loader.copy``
  / ``loader.wait`` and its counters, ``make_step`` the phase spans, with
  ``device_ms`` None.  A device interval is resolved when the ring or the
  sink is read, never inside the span, and a flight dump never waits for
  it (fake CUDA events).
* On the card (marker ``cuda``): a regen span encloses its kernel's
  ``cudaLaunchKernel`` on the shared clock, and the spans carry their
  device time.

This file imports no jax.
"""

import json
import os
import socket
import threading
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile

from partiallyshuffledistributedsampler_tpu_torch import (
    HostDataLoader,
    MixtureSpec,
    PartialShuffleShardSampler,
    elastic_indices_cuda,
    epoch_indices_cuda,
    mixture_elastic_indices_cuda,
    mixture_epoch_indices_cuda,
    mixture_stream_at_cuda,
    parallel,
)
from partiallyshuffledistributedsampler_tpu_torch import telemetry as T
from partiallyshuffledistributedsampler_tpu_torch.models.train import (
    make_step,
)
from partiallyshuffledistributedsampler_tpu_torch.ops import (
    core,
    cuda,
    cuda_kernel as ck,
)
from partiallyshuffledistributedsampler_tpu_torch.sampler import shard_mode
from partiallyshuffledistributedsampler_tpu_torch.sampling import (
    alias as PA,
)

#: the profiler ranges the port entered before they went through the
#: tracer: the regen spans' names and the range-only sites'
OLD_RANGES = {"psds_epoch_regen", "psds_elastic_regen", "psds_stream_at",
              "psds_mixture_regen", "psds_mixture_stream_at",
              "psds_mixture_elastic_regen", "psds_weighted_regen",
              "psds_weighted_elastic_regen", "psds_weighted_at"}
STEP_PHASES = ["step.forward", "step.backward", "step.optimizer"]


@pytest.fixture(autouse=True)
def _reset():
    T.reset()
    yield
    T.reset()


def spans(name=None):
    out = [e for e in T.snapshot() if e.get("kind") == "span"]
    return out if name is None else [e for e in out if e["name"] == name]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A gloo group of one process on the CPU (destroyed afterwards)."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield parallel.data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _tiny_step(mesh, device="cpu"):
    """``make_step`` over a linear model: ``(step, model, idx, x)``."""
    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(4, 1).to(device)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    x = torch.randn(64, 4, generator=gen).to(device)
    idx = torch.arange(64, device=device)

    def loss_of(m, win, table):
        return m(table.index_select(0, win)).pow(2).mean()

    return make_step(opt, mesh, 8, loss_of), model, idx, x


def _loader(**kw):
    return HostDataLoader({"y": np.arange(64)}, window=16, batch=8, world=1,
                          index_backend="cpu", device="cpu", **kw)


def _shard_regen(epoch=1, backend="cpu"):
    sampler = PartialShuffleShardSampler(40, num_replicas=2, rank=1,
                                         window=8, seed=3, backend=backend)
    return sampler.device_epoch_indices([7] * 40, epoch=epoch)


def _every_path(mesh):
    """The regen, loader and step paths, once each, on the CPU."""
    epoch_indices_cuda(1000, 64, 3, 2, 1, 4, device="cpu")
    chain, _, ns = core.elastic_chain(1000, [(2, 100)], 4)
    elastic_indices_cuda(1000, 64, 3, 2, 1, 4, ns, chain, device="cpu")
    _shard_regen()
    for _ in _loader().epoch(0):
        pass
    step, model, idx, x = _tiny_step(mesh)
    step(model, idx, 1, x)


# ------------------------------------------------------------- the clock
def test_span_start_encloses_the_profiler_event():
    T.configure(enabled=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with T.span("outer"):
            time.sleep(0.002)
            torch.ones(64).add_(1)
            time.sleep(0.002)
    start = prof.profiler.kineto_results.trace_start_ns()
    evs = list(prof.events())
    (add,) = [e for e in evs if e.name == "aten::add_"]
    (s,) = spans("outer")
    lo, hi = s["start_ns"], s["start_ns"] + s["ms"] * 1e6
    assert lo <= start + add.time_range.start * 1e3
    assert start + add.time_range.end * 1e3 <= hi
    # traced with a profiler on, the span is also a range of its name
    (rng,) = [e for e in evs if e.name == "outer"]
    assert rng.is_user_annotation
    assert s["device_ms"] is None


# ------------------------------------------------------- off costs nothing
def test_nothing_entered_while_tracing_and_profiler_are_off(mesh,
                                                            monkeypatch):
    entered = []

    class Counting:
        def __init__(self, name, *a, **k):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    def event(*a, **k):
        entered.append("cuda.Event")
        raise AssertionError("a CUDA event was made")

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    monkeypatch.setattr(torch.cuda, "Event", event)
    assert not T.enabled() and not torch.autograd._profiler_enabled()
    _every_path(mesh)
    assert entered == []
    assert T.snapshot() == []


def test_a_profiler_alone_enters_the_old_ranges(mesh, monkeypatch):
    spec = MixtureSpec((900, 600, 500), (5, 1, 2))
    table, sizes = PA.build_alias_table((5, 1, 2), "per_source",
                                        (900, 600, 500)), (900, 600, 500)
    law = dict(epoch_samples=1001, window=64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _every_path(mesh)
        cuda.stream_indices_at_cuda(torch.arange(10), 1000, 64, 0, 0,
                                    device="cpu")
        mixture_epoch_indices_cuda(spec, 11, 2, 1, 3, device="cpu")
        mixture_stream_at_cuda(torch.arange(10), spec, 11, 2, device="cpu")
        mixture_elastic_indices_cuda(spec, 11, 2, 1, 3, [(2, 300)],
                                     device="cpu")
        PA.weighted_epoch_indices_cuda(table, sizes, 11, 2, 1, 3,
                                       device="cpu", **law)
        PA.weighted_elastic_indices_cuda(table, sizes, 11, 2, 1, 3,
                                         [(2, 300)], device="cpu", **law)
        # the weighted random access is card-only: its wrapper stands in
        with monkeypatch.context() as m:
            m.setattr(ck, "device_kind", lambda device: "cuda")
            m.setattr(ck, "weighted_stream_wide",
                      lambda *a, **k: torch.empty(0))
            PA.weighted_stream_at_cuda(torch.arange(10), table, sizes, 5, 1,
                                       window=64, device="cpu")
    ranges = {e.name for e in prof.events() if e.is_user_annotation}
    assert OLD_RANGES <= ranges
    # and the new spans' ranges, without a tracer (the profiler records
    # the threads it started on, not the loader's prefetch thread)
    assert {"psds_shard_regen", "shard.tables", "shard.expand",
            "loader.wait", "step", *STEP_PHASES} <= ranges
    assert T.snapshot() == []


# ----------------------------------------------------- the spans, traced
def _children(parent):
    return {e["name"] for e in spans() if e["parent"] == parent["span"]}


def test_shard_regen_spans(tmp_path):
    T.configure(enabled=True)
    got = _shard_regen()
    (top,) = spans("psds_shard_regen")
    assert top["attrs"] == {"n": 40, "world": 2}
    assert _children(top) == {"shard.tables", "shard.row_keys",
                              "shard.expand"}
    (exp,) = spans("shard.expand")
    assert exp["attrs"] == {"lanes": got.numel()}
    for e in spans():
        assert e["device_ms"] is None and e["status"] == "ok"
        assert top["start_ns"] <= e["start_ns"]
        assert e["thread"] == threading.current_thread().name
    # the host ids path of the expansion has the same two children
    T.reset()
    T.configure(enabled=True)
    shard_mode.expand_shard_indices_cuda([3, 1, 2], [7] * 40, device="cpu")
    assert {e["name"] for e in spans()} == {"shard.row_keys", "shard.expand"}


def test_loader_spans_and_counters():
    T.configure(enabled=True)
    loader = _loader()
    batches = [b for b in loader.epoch(0)]
    assert len(batches) == 8
    gather, copy, wait = (spans(n) for n in ("loader.gather", "loader.copy",
                                             "loader.wait"))
    assert [e["attrs"]["step"] for e in gather] == list(range(8))
    assert [e["attrs"]["step"] for e in copy] == list(range(8))
    assert {e["thread"] for e in gather + copy} == {"psds-host-prefetch"}
    # one wait a batch, and one for the end of the epoch
    assert len(wait) == 9
    assert {e["thread"] for e in wait} == {threading.current_thread().name}
    c = loader.metrics.report()["counters"]
    assert c["batches_served"] == 8
    assert c["bytes_gathered"] == 64 * np.arange(1).itemsize
    assert 0 <= c.get("batches_ready", 0) <= 8


def test_loader_ready_counts_what_the_consumer_found():
    class SlowGather(HostDataLoader):
        def _gather(self, sl):
            time.sleep(0.05)
            return super()._gather(sl)

    slow = SlowGather({"y": np.arange(32)}, window=16, batch=8, world=1,
                      index_backend="cpu", device="cpu")
    for _ in slow.epoch(0):
        pass
    assert slow.metrics.get("batches_served") == 4
    assert slow.metrics.get("batches_ready") == 0
    fast = _loader()
    for _ in fast.epoch(0):
        time.sleep(0.05)
    # the first request may come before the first gather is done
    assert fast.metrics.get("batches_ready") >= 7
    assert T.snapshot() == []  # the counters count with tracing off


def test_step_phase_spans(mesh):
    T.configure(enabled=True)
    step, model, idx, x = _tiny_step(mesh)
    loss = step(model, idx, 2, x)
    assert loss.dim() == 0
    (top,) = spans("step")
    assert [e["name"] for e in spans() if e["parent"] == top["span"]] \
        == STEP_PHASES  # no all-reduce at world 1
    for e in spans():
        assert e["device_ms"] is None


# ------------------------------------------------- device intervals, read
class FakeEvent:
    """A CUDA event stand-in: ``record`` stamps the next tick, ``query``
    is False until the test lets the device reach it."""

    reached = False
    synced = 0
    tick = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.at = None

    def record(self, stream=None):
        FakeEvent.tick += 1
        self.at = FakeEvent.tick

    def query(self):
        return FakeEvent.reached

    def synchronize(self):
        FakeEvent.synced += 1

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_events(monkeypatch):
    monkeypatch.setattr(FakeEvent, "reached", False)
    monkeypatch.setattr(FakeEvent, "synced", 0)
    monkeypatch.setattr(FakeEvent, "tick", 0)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace())
    return FakeEvent


def test_device_interval_is_resolved_when_the_ring_is_read(fake_events):
    T.configure(enabled=True)
    with T.span("outer", device_ms="cuda"):
        with T.span("inner", device_ms="cuda:0"):
            pass
        with T.span("host_only", device_ms="cpu"):
            pass
    assert fake_events.synced == 0  # nothing waited inside the spans
    ring = T.recorder()._ring
    assert all(not isinstance(e["device_ms"], (float, type(None)))
               for e in ring if e["name"] != "host_only")
    got = {e["name"]: e["device_ms"] for e in spans()}
    # outer: ticks 1 (enter) and 4 (exit); inner: ticks 2 and 3
    assert got == {"outer": 3.0, "inner": 1.0, "host_only": None}
    assert fake_events.synced == 2
    json.dumps(T.snapshot())
    assert fake_events.synced == 2  # resolved once: the ring keeps it


def test_a_dump_never_waits_for_the_device(fake_events, tmp_path):
    T.configure(enabled=True)
    with T.span("regen", device_ms="cuda"):
        pass
    path = T.dump(os.path.join(str(tmp_path), "d.jsonl"))
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[1]["name"] == "regen" and lines[1]["device_ms"] is None
    assert fake_events.synced == 0
    # read once the device has reached it, the entry keeps its number
    fake_events.reached = True
    path = T.dump(os.path.join(str(tmp_path), "e.jsonl"))
    with open(path) as f:
        assert [json.loads(ln) for ln in f][1]["device_ms"] == 1.0


def test_sink_holds_an_entry_until_its_interval_is_reached(fake_events,
                                                           tmp_path):
    path = os.path.join(str(tmp_path), "live.jsonl")
    sink = T.JsonlSink(path, interval_s=0.0, batch=1)
    T.configure(enabled=True, sink=sink)
    with T.span("regen", device_ms="cuda"):
        pass
    T.event("after")
    assert sink.written == 0 and fake_events.synced == 0
    fake_events.reached = True
    T.event("later")
    assert sink.written == 3
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert [e["name"] for e in lines] == ["regen", "after", "later"]
    assert lines[0]["device_ms"] == 1.0
    # an explicit flush waits for what is pending
    fake_events.reached = False
    with T.span("tail", device_ms="cuda"):
        pass
    sink.flush()
    assert sink.written == 4


# -------------------------------------------------------------- the card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernels have no interpret mode)")


@pytest.mark.cuda
def test_regen_span_encloses_its_launch_on_the_card(card):
    T.configure(enabled=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for e in range(5):
            epoch_indices_cuda(10**7, 8192, 0, e, 3, 8)
            _shard_regen(e, backend="cuda")
        torch.cuda.synchronize()
    start = prof.profiler.kineto_results.trace_start_ns()
    launches = [(start + e.time_range.start * 1e3,
                 start + e.time_range.end * 1e3) for e in prof.events()
                if "LaunchKernel" in e.name]
    regens = spans("psds_epoch_regen")
    assert len(regens) == 10
    for s in regens:
        lo, hi = s["start_ns"], s["start_ns"] + s["ms"] * 1e6
        assert any(lo <= a and b <= hi for a, b in launches), s
        assert s["device_ms"] > 0
    for s in spans("psds_shard_regen"):
        assert s["device_ms"] > 0
        assert _children(s) == {"shard.tables", "psds_epoch_regen",
                                "shard.row_keys", "shard.expand"}


@pytest.mark.cuda
def test_step_phases_carry_device_time_on_the_card(card, mesh):
    T.configure(enabled=True)
    step, model, idx, x = _tiny_step(mesh, "cuda")
    for s in range(3):
        step(model, idx, s, x)
    phases = {n: [e["device_ms"] for e in spans(n)]
              for n in ["step", *STEP_PHASES]}
    for n, ms in phases.items():
        assert len(ms) == 3 and all(v > 0 for v in ms), (n, ms)
    for i in range(3):
        assert phases["step"][i] >= max(phases[n][i] for n in STEP_PHASES)
