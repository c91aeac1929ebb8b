"""The port's counterpart of the JAX package's ``tests/test_telemetry.py``:
its served cases (the tracer, histograms, sinks and stall dumps are held
in test_torch_port_telemetry.py).

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs and loaders on ``backend="cpu"`` (no card), under the port's
lock-order sanitizer; the JAX file's text follows.

Telemetry: span tracer, trace-ID propagation, flight recorder, exporters.

Laws under test (docs/OBSERVABILITY.md):

* zero-cost-when-off — a disabled tracer hands out one shared no-op
  span, records nothing, and adds NO bytes to the protocol (no ``trace``
  header field);
* one trace ID per logical request — the ``client.rpc`` span covers
  every retry of one operation, so a GET_BATCH refused with ``reshard``
  and retried produces two server dispatch spans under ONE trace;
* failure timelines — a fault injected inside server dispatch dumps the
  flight ring with the faulted (still-open) span in it; a degraded
  fallback's regen span links to the exact RPC span that failed;
* bounded state — ``RegenTimer.samples_ms`` caps at its ring size with
  exact running totals, and ``ServiceMetrics`` prunes per-client entries
  at eviction and reshard commit.
"""

import glob
import json
import os
import socket
import threading
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch import faults as F
from partiallyshuffledistributedsampler_tpu_torch import telemetry as T
from partiallyshuffledistributedsampler_tpu_torch.sampler.host_loader import (
    HostDataLoader,
)
from partiallyshuffledistributedsampler_tpu_torch.service import (
    IndexServer,
    PartialShuffleSpec,
    ServiceIndexClient,
    ServiceMetrics,
)
from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P
from partiallyshuffledistributedsampler_tpu_torch.utils.metrics import (
    Histogram,
    MetricsRegistry,
    RegenTimer,
)
from partiallyshuffledistributedsampler_tpu_torch.utils.watchdog import StallError

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder

#: every port spec and loader of this file regenerates on the host
BACKEND = "cpu"


@pytest.fixture(autouse=True)
def _port_sanitizer():
    """The port's lock-order graph over every lock a case creates: a
    recorded cycle, or a non-daemon thread left running, fails it."""
    prior = lockorder.is_enabled()
    lockorder.reset()
    lockorder.enable()
    baseline = lockorder.thread_snapshot()
    yield
    found = lockorder.violations()
    lockorder.reset()
    if not prior:
        lockorder.disable()
    assert not found, lockorder.render_violations(found)
    leaked = lockorder.leaked_threads(baseline)
    assert not leaked, lockorder.thread_stacks(leaked)

pytestmark = pytest.mark.telemetry


def plain_spec(world=1, n=512, window=64):
    return PartialShuffleSpec.plain(n, window=window, world=world, seed=7, backend=BACKEND)


@pytest.fixture
def traced(tmp_path):
    """Global tracer ON with a flight dir; reset to off-by-default after."""
    T.reset()
    T.configure(enabled=True, dump_dir=str(tmp_path))
    yield tmp_path
    T.reset()


def spans(name=None):
    out = [e for e in T.snapshot() if e.get("kind") == "span"]
    return out if name is None else [e for e in out if e["name"] == name]


# ------------------------------------------------- protocol: trace on wire
def test_disabled_tracer_adds_no_protocol_field():
    """Off by default ⇒ request headers carry no ``trace`` key (zero
    extra wire bytes); enabled ⇒ the key appears.  Old servers ignore
    unknown header fields, so this is the whole interop surface."""
    T.reset()
    with IndexServer(plain_spec()) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64)
        try:
            hdr = {}
            c._rpc(P.MSG_METRICS, hdr)
            assert "trace" not in hdr
            T.configure(enabled=True)
            hdr = {}
            c._rpc(P.MSG_METRICS, hdr)
            assert isinstance(hdr.get("trace"), list) and len(hdr["trace"]) == 2
        finally:
            c.close()
            T.reset()


def test_old_client_without_trace_field_still_served():
    """A pre-telemetry peer (never sends ``trace``) interoperates with a
    tracing-enabled server — raw-socket HELLO + GET_BATCH."""
    spec = plain_spec()
    T.reset()
    T.configure(enabled=True)
    try:
        with IndexServer(spec) as srv:
            s = socket.create_connection(srv.address, timeout=5.0)
            try:
                P.send_msg(s, P.MSG_HELLO,
                           {"rank": 0, "batch": 64,
                            "proto": P.PROTOCOL_VERSION})
                msg, h, _ = P.recv_msg(s)
                assert msg == P.MSG_WELCOME
                P.send_msg(s, P.MSG_GET_BATCH,
                           {"rank": 0, "epoch": 0, "seq": 0, "gen": 0})
                msg, h, payload = P.recv_msg(s)
                assert msg == P.MSG_BATCH
                got = P.decode_indices(h, payload)
                ref = np.asarray(spec.rank_indices(0, 0))[:64]
                assert np.array_equal(got, ref)
            finally:
                s.close()
        # the server still traced the untraced peer's dispatch (new root)
        assert spans("server.GET_BATCH")
    finally:
        T.reset()


def test_trace_id_threads_client_to_server(traced):
    spec = plain_spec()
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64)
        try:
            got = np.concatenate(list(c.epoch_batches(0)))
        finally:
            c.close()
    assert np.array_equal(got, np.asarray(spec.rank_indices(0, 0)))
    rpc, srv_spans = spans("client.rpc"), spans("server.GET_BATCH")
    assert rpc and srv_spans
    by_span = {e["span"]: e for e in rpc}
    for s in srv_spans:
        parent = by_span.get(s["parent"])
        assert parent is not None, "server span not parented under an rpc"
        assert parent["trace"] == s["trace"]


def test_reshard_refusal_then_retry_keeps_one_trace(traced):
    """A GET_BATCH refused with ``reshard`` and retried is ONE logical
    request: both server dispatch spans carry the same trace id, and the
    refused one is annotated with the error code."""
    spec = plain_spec(n=512, window=64)
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64,
                               backoff_base=0.01, reconnect_timeout=5.0)
        try:
            it = c.epoch_batches(0)
            first = next(it)  # connected and streaming before the stub
            with srv._lock:
                srv._reshard = {"phase": "freeze"}

            def release():
                # wait until the freeze refused at least one request
                deadline = time.monotonic() + 5.0
                while time.monotonic() < deadline:
                    if c.metrics.registry.get("reshard_waits") >= 1:
                        break
                    time.sleep(0.005)
                with srv._lock:
                    srv._reshard = None

            rel = threading.Thread(target=release)
            rel.start()
            rest = list(it)
            rel.join()
        finally:
            c.close()
    assert c.metrics.registry.get("reshard_waits") >= 1
    refused = [s for s in spans("server.GET_BATCH")
               if s["attrs"].get("error_code") == "reshard"]
    assert refused, "no dispatch span recorded the reshard refusal"
    served = [s for s in spans("server.GET_BATCH")
              if s["trace"] == refused[0]["trace"]
              and "error_code" not in s["attrs"]]
    assert served, "the retried attempt did not keep the refused trace id"
    # and the stream itself was unharmed
    got = np.concatenate([first] + rest)
    assert np.array_equal(got, np.asarray(spec.rank_indices(0, 0)))


def test_degraded_fallback_regen_links_failed_rpc(traced):
    """The degraded-mode regen span carries ``failed_rpc`` = the ids of
    the exact client.rpc span whose failure forced the fallback."""
    X = np.arange(530, dtype=np.int64)
    # nothing listens here: reserve a port and close it
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    addr = probe.getsockname()
    probe.close()
    c = ServiceIndexClient(addr, rank=0, batch=64, backoff_base=0.01,
                           reconnect_timeout=0.2)
    loader = HostDataLoader(X, window=32, batch=64, seed=7, rank=0, world=1,
                            index_client=c, index_backend=BACKEND, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        got = loader.epoch_indices(0)
    assert loader.degraded
    assert np.array_equal(
        got, HostDataLoader(X, window=32, batch=64, seed=7, index_backend=BACKEND, device="cpu").epoch_indices(0))
    regen = spans("loader.degraded_regen")
    assert regen, "degraded regen span missing"
    link = regen[0]["attrs"].get("failed_rpc")
    assert link is not None, "degraded regen span carries no rpc link"
    failed = [s for s in spans("client.rpc")
              if [s["trace"], s["span"]] == link]
    assert failed and failed[0]["status"] == "error"
    # both live in the same trace, under the serve_epoch span
    serve = spans("loader.serve_epoch")
    assert serve and serve[0]["trace"] == regen[0]["trace"]


def test_dispatch_fault_dumps_flight_with_faulted_span(traced):
    """Acceptance: an injected server.dispatch fault produces a
    JSONL flight dump whose spans reconstruct client rpc → server
    dispatch → fault → retry."""
    spec = plain_spec()
    with IndexServer(spec) as srv:
        plan = F.FaultPlan([F.FaultRule(site="server.dispatch",
                                        kind="error", nth=3)])
        c = ServiceIndexClient(srv.address, rank=0, batch=64,
                               backoff_base=0.01, reconnect_timeout=5.0)
        try:
            with plan:
                got = np.concatenate(list(c.epoch_batches(0)))
        finally:
            c.close()
    assert plan.fired("server.dispatch") == 1
    # the retry rode through: delivered stream still exact
    assert np.array_equal(got, np.asarray(spec.rank_indices(0, 0)))
    dumps = glob.glob(os.path.join(str(traced), "flight-*.jsonl"))
    assert len(dumps) == 1, f"expected one flight dump, got {dumps}"
    with open(dumps[0]) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["kind"] == "flight_dump"
    assert lines[0]["reason"] == "fault.server.dispatch"
    entries = lines[1:]
    open_srv = [e for e in entries
                if e.get("open") and e["name"] == "server.GET_BATCH"]
    assert open_srv, "faulted dispatch span missing from the dump"
    faulted = open_srv[0]
    # the fault event is stamped with the faulted dispatch span's ids
    ev = [e for e in entries if e.get("kind") == "event"
          and e["name"] == "fault_injected"]
    assert ev and ev[0]["span"] == faulted["span"]
    assert ev[0]["attrs"] == {"site": "server.dispatch", "kind": "error"}
    # the client rpc span the dispatch was serving is open in the dump too
    open_rpc = [e for e in entries
                if e.get("open") and e["name"] == "client.rpc"]
    assert open_rpc and open_rpc[0]["trace"] == faulted["trace"]
    assert faulted["parent"] == open_rpc[0]["span"]
    # ...and the RETRY of that same trace later succeeded: a finished
    # server dispatch span with the same trace id, no error
    retried = [e for e in spans("server.GET_BATCH")
               if e["trace"] == faulted["trace"] and not e.get("open")
               and e["status"] == "ok"]
    assert retried, "no successful retry recorded under the faulted trace"


def test_trace_dump_rpc_and_api(traced):
    spec = plain_spec()
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64)
        try:
            list(c.epoch_batches(0))
            rep = c.trace_dump(limit=64)
        finally:
            c.close()
    assert rep["enabled"] is True
    names = {e.get("name") for e in rep["entries"]}
    assert "server.GET_BATCH" in names
    assert len(rep["entries"]) <= 64
    # the local dump() API writes the same entries as JSONL
    path = os.path.join(str(traced), "manual.jsonl")
    assert T.dump(path, reason="test") == path
    with open(path) as f:
        meta = json.loads(f.readline())
    assert meta["kind"] == "flight_dump" and meta["reason"] == "test"


def test_reshard_abort_triggers_flight_dump(traced, monkeypatch):
    """A failure between the barrier freeze and the drain flip must
    unfreeze the server AND dump the flight ring (reason
    ``reshard_abort``).  The ``reshard_drain`` event sits inside that
    window, so making it raise exercises the abort path exactly."""
    def boom(*_a, **_k):
        raise RuntimeError("drain-flip failure")

    with IndexServer(plain_spec(world=2)) as srv:
        monkeypatch.setattr(T, "event", boom)
        with pytest.raises(RuntimeError, match="drain-flip"):
            srv._trigger_reshard(1)
        monkeypatch.undo()
        assert srv._reshard is None, "abort left the barrier frozen"
        assert srv.spec.world == 2  # membership unchanged
    dumps = glob.glob(os.path.join(str(traced),
                                   "flight-*reshard_abort*.jsonl"))
    assert len(dumps) == 1


# --------------------------------------------------------------- histogram


def test_server_adopts_latency_histograms():
    T.reset()  # histograms are metrics: they populate with tracing OFF
    spec = plain_spec()
    with IndexServer(spec) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64)
        try:
            list(c.epoch_batches(0))
        finally:
            c.close()
        hs = srv.metrics.report()["histograms"]
    assert hs["batch_service_ms"]["count"] >= 1
    assert hs["epoch_regen_ms"]["count"] >= 1
    assert c.metrics.report()["histograms"]["rpc_ms"]["count"] >= 1


# ---------------------------------------------------------- bounded state


def test_service_metrics_pruned_at_lease_eviction():
    now = [0.0]
    with IndexServer(plain_spec(world=2), heartbeat_timeout=10.0,
                     clock=lambda: now[0]) as srv:
        c = ServiceIndexClient(srv.address, rank=0, batch=64)
        try:
            next(c.epoch_batches(0))
            assert "0" in srv.metrics.report()["clients"]
            served = srv.metrics.report()["clients"]["0"]["batches_served"]
            # the lease must still be OWNED when the sweep runs — a
            # closed connection releases it and nothing gets evicted
            now[0] = 11.0
            srv._sweep_leases()
            rep = srv.metrics.report()
        finally:
            c.close()
    assert "0" not in rep["clients"], "evicted rank still in the report"
    assert rep["departed"]["clients"] == 1
    assert rep["departed"]["batches_served"] == served
    assert rep["departed"]["evictions"] == 1  # archived AFTER the count
    # totals were never touched
    assert rep["counters"]["batches_served"] == served


def test_service_metrics_pruned_at_reshard_commit():
    with IndexServer(plain_spec(world=2)) as srv:
        c1 = ServiceIndexClient(srv.address, rank=1, batch=64)
        try:
            rep = c1.leave(None)  # idle world: barrier commits immediately
        finally:
            c1.close()
        out = srv.metrics.report()
    assert srv.spec.world == 1 and srv.generation == 1
    assert "1" not in out["clients"], "departed rank still in the report"
    assert out["departed"]["leaves"] == 1
    assert out["counters"]["leaves"] == 1
    assert out["histograms"]["barrier_freeze_ms"]["count"] == 1
    assert out["histograms"]["barrier_drain_ms"]["count"] == 1
