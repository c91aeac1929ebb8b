"""The port's ``telemetry/``, ``utils/metrics.py``, ``utils/retry.py`` and
``analysis/lockorder.py`` on the CPU against the JAX package's.

* Metrics: ``Histogram`` reports and percentiles, ``histogram_delta`` /
  ``registry_delta`` and the Prometheus text of ``render_prometheus`` are
  string-equal for the same observations (drawn from numpy seeds).
* Telemetry: span nesting, attributes and events, the innermost-span tag
  on an exception, the disabled tracer as one shared no-op, the
  ``JsonlSink``, flight dumps (manual, on a stall, the budget), and the
  regen spans of ``ops/cuda.py`` with the JAX package's attributes.
* Retry: the same jittered backoff, deadline, budget and breaker with
  injected clocks and seeded generators.
* Lock order: an inversion reported with both stacks, a consistent order,
  a tracked lock under a condition, a raw lock when disabled, and the
  thread-leak detector (the JAX package's analysis suite, lock-order part).

The tracers and the sanitizer are process-global: a fixture resets them
around every test, and ``PSDS_TELEMETRY`` is never set here.
"""

import glob
import json
import math
import os
import random
import threading
import time

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu import telemetry as JT
from partiallyshuffledistributedsampler_tpu.utils import metrics as JMet
from partiallyshuffledistributedsampler_tpu.utils import retry as JR
from partiallyshuffledistributedsampler_tpu_torch import (
    HostDataLoader,
    epoch_indices_cuda,
    elastic_indices_cuda,
)
from partiallyshuffledistributedsampler_tpu_torch import telemetry as T
from partiallyshuffledistributedsampler_tpu_torch import utils as PU
from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu_torch.ops import core
from partiallyshuffledistributedsampler_tpu_torch.utils import metrics as PMet
from partiallyshuffledistributedsampler_tpu_torch.utils import retry as PR
from partiallyshuffledistributedsampler_tpu_torch.utils.watchdog import (
    StallError,
)


@pytest.fixture(autouse=True)
def _reset():
    T.reset()
    JT.reset()
    yield
    T.reset()
    JT.reset()


@pytest.fixture
def traced(tmp_path):
    T.configure(enabled=True, dump_dir=str(tmp_path))
    yield tmp_path


def spans(name=None):
    out = [e for e in T.snapshot() if e.get("kind") == "span"]
    return out if name is None else [e for e in out if e["name"] == name]


# ---------------------------------------------------------------- metrics
def _observations(seed: int) -> list:
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.lognormal(0.0, 2.0, 300),
                        rng.uniform(0.0, 5.0, 50), [0.0, 1e-4, 7e6]])
    return [float(x) for x in v]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_histogram_reports_and_percentiles_equal(seed):
    obs = _observations(seed)
    jh, ph = JMet.Histogram(), PMet.Histogram()
    for x in obs:
        jh.observe(x)
        ph.observe(x)
    assert repr(ph.report()) == repr(jh.report())
    for q in (0.0, 0.01, 0.5, 0.9, 0.95, 0.99, 1.0):
        assert repr(ph.percentile(q)) == repr(jh.percentile(q))
    assert ph.state() == jh.state()
    assert ph.snapshot() == jh.snapshot()
    # an interval: the delta against a snapshot part-way through
    jmid, pmid = JMet.Histogram(), PMet.Histogram()
    for x in obs[:100]:
        jmid.observe(x)
        pmid.observe(x)
    jprev, pprev = jmid.snapshot(), pmid.snapshot()
    for x in obs[100:]:
        jmid.observe(x)
        pmid.observe(x)
    assert repr(pmid.delta(pprev)) == repr(jmid.delta(jprev))
    assert repr(PMet.histogram_delta(pmid.snapshot())) \
        == repr(JMet.histogram_delta(jmid.snapshot()))
    bounds = (0.5, 1.0, 2.5, 10.0)
    jb, pb = JMet.Histogram(bounds), PMet.Histogram(bounds)
    for x in obs:
        jb.observe(x)
        pb.observe(x)
    assert repr(pb.report()) == repr(jb.report())


def test_histogram_refusals_and_empty():
    assert PMet.Histogram().report() == JMet.Histogram().report()
    assert PMet.Histogram().report()["count"] == 0
    with pytest.raises(ValueError):
        PMet.Histogram(bounds=[2.0, 1.0])
    assert PMet._percentile_from((1.0,), [0, 0], 0, math.inf, -math.inf,
                                 0.5) == 0.0


def _registries(seed: int):
    rng = np.random.default_rng(seed)
    regs = (JMet.MetricsRegistry(), PMet.MetricsRegistry())
    for step in range(60):
        name = f"c{int(rng.integers(0, 4))}"
        by = int(rng.integers(1, 10))
        h = f"h{int(rng.integers(0, 3))}_ms"
        x = float(rng.lognormal(0.0, 1.5))
        for reg in regs:
            reg.inc(name, by)
            reg.histogram(h).observe(x)
            reg.timer("epoch_regen_ms").samples_ms.append(x)
    return regs, rng


@pytest.mark.parametrize("seed", [3, 4])
def test_prometheus_text_and_registry_deltas_equal(seed):
    (jr, pr), _ = _registries(seed)
    jtext = JT.render_prometheus(jr)
    ptext = T.render_prometheus(pr)
    assert ptext == jtext
    assert "# TYPE psds_epoch_regen_ms_ms summary" in ptext
    assert 'le="+Inf"' in ptext
    assert T.render_prometheus(pr, prefix="x") \
        == JT.render_prometheus(jr, prefix="x")
    assert repr(pr.report()) == repr(jr.report())
    jprev, pprev = jr.snapshot(), pr.snapshot()
    for reg in (jr, pr):
        reg.inc("c0", 5)
        reg.inc("fresh")
        reg.histogram("h0_ms").observe(3.25)
    assert repr(pr.delta(pprev)) == repr(jr.delta(jprev))
    assert repr(PMet.registry_delta(pr.snapshot())) \
        == repr(JMet.registry_delta(jr.snapshot()))
    assert pr.histogram_states() == jr.histogram_states()
    pr.reset()
    assert T.render_prometheus(pr) == "" and pr.get("c0") == 0


def test_prometheus_renders_an_object_with_a_registry():
    class Holder:
        registry = PMet.MetricsRegistry()

    Holder.registry.inc("batches_served", 3)
    assert "psds_batches_served 3" in T.render_prometheus(Holder())


def test_utils_exports_the_jax_packages_names():
    from partiallyshuffledistributedsampler_tpu import utils as JU

    for name in ("load_sampler_state", "save_sampler_state", "Histogram",
                 "MetricsRegistry", "RegenTimer", "RetryPolicy",
                 "RetryState", "StallProbe", "StallError", "thread_stack"):
        assert hasattr(PU, name) and hasattr(JU, name), name


# ---------------------------------------------------------------- tracer
def test_span_nesting_attrs_events(traced):
    with T.span("outer", a=1) as so:
        so.set("b", "two")
        with T.span("inner") as si:
            assert si.trace_id == so.trace_id
            assert si.parent_id == so.span_id
            assert T.current() is si
            si.event("tick", x=3)
            T.annotate(note="in")
        with T.span("remote_child", trace=so.ids) as sr:
            assert sr.trace_id == so.trace_id
            assert sr.parent_id == so.span_id
    inner, outer = spans("inner")[0], spans("outer")[0]
    assert outer["attrs"] == {"a": 1, "b": "two"}
    assert outer["status"] == "ok" and outer["ms"] >= 0
    assert inner["events"][0]["name"] == "tick"
    assert inner["events"][0]["attrs"] == {"x": 3}
    assert inner["attrs"] == {"note": "in"}
    T.event("standalone", k="v")
    ev = T.snapshot()[-1]
    assert ev["kind"] == "event" and ev["span"] is None


def test_exception_marks_span_and_tags_innermost(traced):
    with pytest.raises(ValueError):
        with T.span("outer"):
            with T.span("inner"):
                raise ValueError("boom")
    try:
        with T.span("a") as sa:
            raise ValueError("tagged")
    except ValueError as exc:
        assert exc._psds_span == sa.ids
    inner = spans("inner")[0]
    assert inner["status"] == "error" and "boom" in inner["error"]


def test_disabled_tracer_is_shared_noop():
    assert not T.enabled()
    s1, s2 = T.span("x", a=1), T.span("y")
    assert s1 is s2 is T.NULL_SPAN
    assert s1.ids is None
    with s1 as s:
        assert s.set("k", "v") is s
        assert T.current() is None
    T.event("dropped")
    assert T.snapshot() == []
    assert T.dump() is None
    assert T.auto_dump("x") is None
    # the packages keep their own tracers
    T.configure(enabled=True)
    assert not JT.enabled()


def test_attributes_are_scrubbed_like_the_jax_tracer(traced):
    big = {"s": "x" * 600, "l": list(range(40)), "o": object(),
           "d": {str(i): i for i in range(30)}}
    JT.configure(enabled=True)
    with T.span("p", **big), JT.span("p", **big):
        pass
    p, j = T.snapshot()[-1]["attrs"], JT.snapshot()[-1]["attrs"]
    assert p.keys() == j.keys()
    for k in ("s", "l", "d"):
        assert p[k] == j[k]
    assert len(p["s"]) == 259 and len(p["l"]) == 16


def test_jsonl_sink_receives_recorded_entries(tmp_path):
    path = os.path.join(str(tmp_path), "live.jsonl")
    sink = T.JsonlSink(path, interval_s=0.0, batch=1, durable=True)
    T.configure(enabled=True, sink=sink)
    with T.span("op", a=1):
        pass
    T.event("standalone")
    sink.flush()
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert {e.get("name") for e in lines} == {"op", "standalone"}
    assert sink.written == 2
    T.reset()  # closes the sink
    assert sink._f.closed
    with T.JsonlSink(path, interval_s=60.0, batch=100) as s2:
        s2.write({"kind": "event", "name": "late"})
        assert s2.written == 0  # buffered
    with open(path) as f:
        assert json.loads(f.readlines()[-1])["name"] == "late"


def test_dump_api_and_budget(traced):
    with T.span("open_one"):
        path = T.dump(os.path.join(str(traced), "manual.jsonl"),
                      reason="test")
    with open(path) as f:
        lines = [json.loads(ln) for ln in f]
    assert lines[0]["kind"] == "flight_dump" and lines[0]["reason"] == "test"
    assert lines[0]["open_spans"] == 1 and lines[-1]["open"] is True
    T.configure(max_dumps=3)
    paths = [T.auto_dump(f"r{i}") for i in range(5)]
    assert sum(p is not None for p in paths) == 2  # 1 manual + 2 automatic
    capacity = T.recorder()._ring.maxlen
    rec = T.configure(capacity=4).recorder
    try:
        assert rec is T.recorder() and len(T.snapshot()) <= 4
    finally:
        # reset() keeps a configured ring size: leave the ring this case
        # found for the next case this process runs, of any file
        T.configure(capacity=capacity)


def test_stall_error_triggers_flight_dump(traced):
    err = StallError("no progress", thread=None)
    assert isinstance(err, RuntimeError)
    dumps = glob.glob(os.path.join(str(traced), "flight-*stall*.jsonl"))
    assert len(dumps) == 1
    with open(dumps[0]) as f:
        f.readline()
        ev = json.loads(f.readline())
    assert ev["name"] == "flight_dump:stall"


def test_stall_dump_never_breaks_the_error(traced, monkeypatch):
    def boom(*_a, **_k):
        raise OSError("disk gone")

    monkeypatch.setattr(T, "auto_dump", boom)
    err = StallError("no progress", thread=None)
    assert "no progress" in str(err)


def test_loader_stall_dumps_with_the_stuck_frame(traced):
    release = threading.Event()

    class Stuck(HostDataLoader):
        def _gather(self, sl):
            release.wait(10.0)
            return super()._gather(sl)

    loader = Stuck({"y": np.arange(64)}, window=16, batch=8, world=1,
                   index_backend="cpu", device="cpu", stall_timeout=0.3)
    try:
        with pytest.raises(StallError):
            for _ in loader.epoch(0):
                pass
    finally:
        release.set()
    assert len(glob.glob(os.path.join(str(traced),
                                      "flight-*stall*.jsonl"))) == 1


def test_regen_spans_carry_the_jax_attributes(traced):
    epoch_indices_cuda(1000, 64, 3, 2, 1, 4, device="cpu")
    chain, _, ns = core.elastic_chain(1000, [(2, 100)], 4)
    elastic_indices_cuda(1000, 64, 3, 2, 1, 4, ns, chain, device="cpu")
    assert [s["attrs"] for s in spans("psds_epoch_regen")] \
        == [{"n": 1000, "world": 4}]
    assert [s["attrs"] for s in spans("psds_elastic_regen")] \
        == [{"epoch": 2, "rank": 1}]
    # tracing off: no span recorded, the same indices
    T.configure(enabled=False)
    before = len(T.snapshot())
    epoch_indices_cuda(1000, 64, 3, 2, 1, 4, device="cpu")
    assert len(T.snapshot()) == before


def test_regen_span_names_a_device_triple_without_reading_it(traced):
    import torch

    triple = torch.tensor(core.seed_triple(3, 2), dtype=torch.int32)
    chain, _, ns = core.elastic_chain(1000, [(2, 100)], 4)
    elastic_indices_cuda(1000, 64, None, None, 1, 4, ns, chain,
                         device="cpu", triple=triple)
    assert spans("psds_elastic_regen")[-1]["attrs"] == {"epoch": None,
                                                        "rank": 1}


# ------------------------------------------------------------------ retry
def _policies(**kw):
    clocks = {}
    out = []
    for R in (JR, PR):
        box = {"t": 0.0, "slept": []}

        def clock(box=box):
            return box["t"]

        def sleep(d, box=box):
            box["slept"].append(d)
            box["t"] += d

        out.append(R.RetryPolicy(clock=clock, sleep=sleep,
                                 rng=random.Random(42), **kw))
        clocks[R] = box
    return out, clocks[JR], clocks[PR]


@pytest.mark.parametrize("kw", [
    dict(base=0.05, max_delay=2.0, deadline=30.0),
    dict(base=0.5, max_delay=1.0, deadline=3.0),
    dict(base=0.01, budget=4, deadline=None),
    dict(base=0.2, breaker_threshold=3, breaker_reset=1.0),
])
def test_retry_policy_matches_the_jax_policy(kw):
    (jp, pp), jbox, pbox = _policies(**kw)
    seq = {}
    for tag, pol, box in (("j", jp, jbox), ("p", pp, pbox)):
        op = pol.begin()
        trace = []
        for i in range(12):
            if i % 4 == 3:
                pol.record_success()
            else:
                pol.record_failure()
            trace.append((pol.allow(), op.remaining()))
            if not op.pause():
                trace.append("stop")
                break
        seq[tag] = (trace, box["slept"], op.attempts)
    assert seq["p"] == seq["j"]


def test_retry_refusals_and_span_event(traced):
    for bad in (dict(base=-1), dict(deadline=-1), dict(budget=0),
                dict(breaker_threshold=0)):
        with pytest.raises(ValueError):
            PR.RetryPolicy(**bad)
    pol = PR.RetryPolicy(base=0.0, sleep=lambda d: None)
    with T.span("op"):
        assert pol.begin().pause()
    assert spans("op")[0]["events"][0]["name"] == "retry_pause"


# ------------------------------------------------------------- lock order
@pytest.fixture
def sanitizer():
    prior = lockorder.is_enabled()
    lockorder.reset()
    lockorder.enable()
    yield lockorder
    lockorder.reset()
    if not prior:
        lockorder.disable()


def test_lock_inversion_reports_both_stacks(sanitizer):
    a = lockorder.TrackedLock("test.A")
    b = lockorder.TrackedLock("test.B")

    def order_ab():
        with a:
            with b:
                pass

    def order_ba():
        with b:
            with a:
                pass

    for fn in (order_ab, order_ba):  # sequential: no real deadlock risk
        t = threading.Thread(target=fn)
        t.start()
        t.join()

    reports = lockorder.violations()
    assert len(reports) == 1
    rep = reports[0]
    assert set(rep["this_edge"]) == {"test.A", "test.B"}
    assert set(rep["other_edge"]) == {"test.A", "test.B"}
    assert rep["this_edge"] != rep["other_edge"]
    assert "order_ba" in rep["this_stack"]
    assert "order_ab" in rep["other_stack"]
    rendered = lockorder.render_violations(reports)
    assert "test.A" in rendered and "test.B" in rendered
    assert "order_ab" in rendered and "order_ba" in rendered


def test_consistent_order_records_no_violation(sanitizer):
    a = lockorder.TrackedLock("test.outer")
    b = lockorder.TrackedLock("test.inner")
    for _ in range(3):
        with a:
            with b:
                pass
    assert lockorder.violations() == []
    assert lockorder.stats()["edges"] >= 1


def test_tracked_lock_works_under_condition(sanitizer):
    lk = lockorder.TrackedLock("test.cond")
    cond = threading.Condition(lk)
    box = []

    def waiter():
        with cond:
            while not box:
                cond.wait(1.0)

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.05)
    with cond:
        box.append(1)
        cond.notify_all()
    t.join(2.0)
    assert not t.is_alive()
    assert not lk.locked()
    assert getattr(lockorder._STATE.tls, "held", []) == []
    assert lockorder.violations() == []


def test_new_lock_is_raw_when_disabled():
    prior = lockorder.is_enabled()
    lockorder.disable()
    try:
        raw = lockorder.new_lock("test.off")
        assert type(raw) is type(threading.Lock())
    finally:
        if prior:
            lockorder.enable()
    if prior:
        assert isinstance(lockorder.new_lock("test.on"),
                          lockorder.TrackedLock)


def test_thread_leak_detector_names_the_stuck_frame():
    base = lockorder.thread_snapshot()
    release = threading.Event()
    t = threading.Thread(target=release.wait, name="deliberate-leak",
                         daemon=False)
    t.start()
    try:
        leaked = lockorder.leaked_threads(base, grace_s=0.2)
        assert [x.name for x in leaked] == ["deliberate-leak"]
        stacks = lockorder.thread_stacks(leaked)
        assert "wait" in stacks["deliberate-leak"]
    finally:
        release.set()
        t.join()
    assert lockorder.leaked_threads(base, grace_s=1.0) == []


def test_port_locks_are_tracked_under_the_sanitizer(sanitizer):
    """The loader's boundary lock and the sampling spec's dedup lock come
    from ``new_lock``: with the sanitizer on they join the order graph,
    and serving an epoch with its boundary prefetch records no cycle."""
    from partiallyshuffledistributedsampler_tpu_torch import SamplingSpec

    loader = HostDataLoader({"y": np.arange(256)}, window=16, batch=32,
                            world=2, index_backend="cpu", device="cpu")
    assert isinstance(loader._boundary_lock, lockorder.TrackedLock)
    assert loader._boundary_lock.name == "loader.boundary"
    for e in range(3):
        list(loader.epoch(e))
    loader.close()
    spec = SamplingSpec.deduped((64,), epoch_samples=32, seed=1, window=8,
                                backend="cpu")
    assert spec._dedup_lock.name == "sampling.spec"
    spec.rank_indices(1, 0)
    assert lockorder.violations() == []
