"""The port's ``faults/`` on the CPU against the JAX package's: the site
and kind registries, rule validation, plan JSON, and the firing points of
the same ``FaultPlan`` (``nth``, ``every``, ``count`` and a seeded ``p``)
hit for hit; the sites wired into the port — ``loader.prefetch``,
``loader.regen`` and ``loader.boundary`` through both ``HostDataLoader`` s,
``sampling.alias_build`` (the uniform fallback) and
``sampling.dedup_check`` (the fail-safe "seen") through both
``SamplingSpec`` s — fire at the same hits and leave the same streams.

Each package arms its own plans; every plan here is armed as a context
manager and disarmed on exit, and ``PSDS_FAULT_PLAN`` is never set in the
test process (both packages read it).  Tolerance 0.
"""

import errno
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu import faults as JF
from partiallyshuffledistributedsampler_tpu import telemetry as JT
from partiallyshuffledistributedsampler_tpu.sampler import (
    HostDataLoader as JLoader,
)
from partiallyshuffledistributedsampler_tpu.sampling.spec import (
    SamplingSpec as JSampling,
)
from partiallyshuffledistributedsampler_tpu_torch import (
    HostDataLoader,
    SamplingSpec,
)
from partiallyshuffledistributedsampler_tpu_torch import faults as PF
from partiallyshuffledistributedsampler_tpu_torch import telemetry as PT
from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder

N, WINDOW, BATCH, WORLD = 530, 32, 64, 2
SIZES, WEIGHTS = (200, 100, 300), (3, 1, 2)


@pytest.fixture(autouse=True)
def _clean_globals():
    """The fault stacks and tracers are process-global: start and end
    every test with no plan armed and both tracers off."""
    assert PF.active() is None and JF.active() is None
    JT.reset()
    PT.reset()
    yield
    JT.reset()
    PT.reset()
    assert PF.active() is None and JF.active() is None


def _both(rules, seed=0):
    """The same plan in both packages: (jax, port)."""
    return (JF.FaultPlan([dict(r) for r in rules], seed=seed),
            PF.FaultPlan([dict(r) for r in rules], seed=seed))


# ------------------------------------------------------------ the registry
def test_sites_and_kinds_are_the_jax_packages():
    assert PF.SITES == JF.SITES and PF.KINDS == JF.KINDS
    assert len(PF.SITES) == 33
    for site in ("loader.prefetch", "loader.regen", "loader.boundary",
                 "sampling.alias_build", "sampling.dedup_check",
                 "capability.issue", "capability.verify"):
        assert site in PF.SITES


@pytest.mark.parametrize("bad", [
    dict(site="no.such.site", kind="error"),
    dict(site="loader.regen", kind="explode"),
    dict(site="loader.regen", kind="error", nth=0),
    dict(site="loader.regen", kind="error", every=0),
])
def test_rule_refusals_match(bad):
    with pytest.raises(ValueError) as je:
        JF.FaultRule(**bad)
    with pytest.raises(ValueError) as pe:
        PF.FaultRule(**bad)
    assert str(pe.value) == str(je.value)


def test_plan_json_and_env_across_packages():
    rules = [dict(site="loader.prefetch", kind="delay", nth=2, count=3,
                  every=2, delay_s=0.01),
             dict(site="sampling.dedup_check", kind="error", p=0.25,
                  count=0)]
    j, p = _both(rules, seed=11)
    assert p.to_json() == j.to_json()
    back = PF.FaultPlan.from_json(j.to_json())
    assert back.rules == p.rules and back.seed == 11
    assert JF.FaultPlan.from_json(p.to_json()).to_json() == j.to_json()
    # a bare rule list, and the environment read from a given mapping
    env = {"PSDS_FAULT_PLAN": PF.FaultPlan(rules[:1]).to_json()}
    assert PF.FaultPlan.from_env(env).to_json() \
        == JF.FaultPlan.from_env(env).to_json()
    assert PF.FaultPlan.from_env({}) is None
    assert PF.FaultPlan.from_json('[{"site": "loader.regen", '
                                  '"kind": "error"}]').rules[0].kind == "error"


# ------------------------------------------------------------ firing points
PLANS = [
    [dict(site="loader.prefetch", kind="error", nth=3)],
    [dict(site="loader.prefetch", kind="error", nth=2, every=3, count=4)],
    [dict(site="loader.prefetch", kind="error", nth=5, count=0, every=1)],
    [dict(site="loader.prefetch", kind="delay", p=0.3, count=0),
     dict(site="loader.regen", kind="error", p=0.5, count=2)],
    [dict(site="loader.regen", kind="reset", nth=1, count=1),
     dict(site="loader.regen", kind="error", nth=1, count=2)],
]


@pytest.mark.parametrize("rules", PLANS, ids=range(len(PLANS)))
@pytest.mark.parametrize("seed", [0, 123456789])
def test_same_plan_fires_at_the_same_hits(rules, seed):
    rng = np.random.default_rng(seed)
    sites = rng.choice(["loader.prefetch", "loader.regen"], 200)
    j, p = _both(rules, seed=seed)
    fired = {"j": [], "p": []}
    for tag, plan in (("j", j), ("p", p)):
        for i, site in enumerate(sites):
            rule = plan.draw(str(site))
            if rule is not None:
                fired[tag].append((i, rule.site, rule.kind))
    assert fired["p"] == fired["j"] and fired["p"]
    for site in ("loader.prefetch", "loader.regen", None):
        assert p.hits(site) == j.hits(site)
        assert p.fired(site) == j.fired(site)


def test_arming_nests_and_the_packages_are_apart():
    outer = PF.FaultPlan([dict(site="loader.regen", kind="error")])
    inner = PF.FaultPlan([dict(site="loader.regen", kind="delay")])
    with outer:
        assert PF.active() is outer and JF.active() is None
        with inner:
            assert PF.active() is inner
        assert PF.active() is outer
    assert PF.active() is None
    PF.fire("loader.regen")  # no plan: nothing happens, nothing counted
    assert outer.hits() == 0


def test_perform_kinds_and_wire_helpers():
    def rule(kind):
        return PF.FaultRule("service.send", kind, delay_s=0.0)

    PF.perform(rule("delay"))
    with pytest.raises(ConnectionResetError):
        PF.perform(rule("reset"))
    with pytest.raises(PF.InjectedThreadDeath):
        PF.perform(rule("thread_death"))
    with pytest.raises(OSError) as ei:
        PF.perform(rule("disk_full"))
    assert ei.value.errno == errno.ENOSPC
    for kind in ("error", "corrupt", "torn_frame"):
        with pytest.raises(PF.InjectedFault) as ei:
            PF.perform(rule(kind))
        assert (ei.value.site, ei.value.kind) == ("service.send", kind)
    assert not issubclass(PF.InjectedThreadDeath, Exception)
    assert PF.InjectedFault is not JF.InjectedFault
    frame = bytes(range(10))
    assert PF.flip_byte(frame) == JF.flip_byte(frame) != frame
    assert PF.flip_byte(b"") == b""

    class Sock:
        sent = b""

        def sendall(self, data):
            Sock.sent += data

    assert PF.apply_to_frame(rule("corrupt"), Sock(), frame) \
        == JF.flip_byte(frame)
    with pytest.raises(ConnectionResetError):
        PF.apply_to_frame(rule("torn_frame"), Sock(), frame)
    assert Sock.sent == frame[:5]


def test_firing_records_an_event_and_dumps(tmp_path):
    PT.configure(enabled=True, dump_dir=str(tmp_path))
    with PF.FaultPlan([dict(site="loader.regen", kind="error")]):
        with pytest.raises(PF.InjectedFault):
            PF.fire("loader.regen")
    ev = [e for e in PT.snapshot() if e.get("name") == "fault_injected"]
    assert ev and ev[0]["attrs"] == {"site": "loader.regen",
                                     "kind": "error"}
    assert len(list(tmp_path.glob("flight-*fault.loader.regen*.jsonl"))) == 1


# ------------------------------------------------- through both loaders
def _loaders(**kw):
    data = {"x": np.arange(N * 3).reshape(N, 3), "y": np.arange(N)}
    kw = dict(window=WINDOW, batch=BATCH, world=WORLD, **kw)
    return (JLoader(data, index_backend="cpu", **kw),
            HostDataLoader(data, index_backend="cpu", device="cpu", **kw))


def _steps_until_fault(loader, epoch, fault_type):
    served = 0
    with pytest.raises(fault_type) as ei:
        for _ in loader.epoch(epoch):
            served += 1
    return served, ei.value


@pytest.mark.parametrize("nth", [1, 3, 4])
def test_prefetch_fault_raises_at_the_same_step(nth):
    j, p = _loaders(depth=2)
    jplan, pplan = _both([dict(site="loader.prefetch", kind="error",
                               nth=nth)])
    base = lockorder.thread_snapshot()
    with jplan:
        jserved, _ = _steps_until_fault(j, 0, JF.InjectedFault)
    with pplan:
        pserved, exc = _steps_until_fault(p, 0, PF.InjectedFault)
    assert pserved == jserved == nth - 1
    assert pplan.hits("loader.prefetch") == jplan.hits("loader.prefetch")
    assert pplan.fired() == jplan.fired() == 1
    assert exc.site == "loader.prefetch"
    assert lockorder.leaked_threads(base, include_daemon=True) == []


def test_prefetch_fault_keeps_its_traceback_under_full_queue():
    """The counterpart of the JAX loader's regression: the producer hits
    the injected error at step 3 while the queue is full (depth 1); the
    consumer gets it with the producer's frames."""
    _, p = _loaders(depth=1)
    plan = PF.FaultPlan([PF.FaultRule(site="loader.prefetch", kind="error",
                                      nth=3)])
    with plan:
        it = p.epoch(0)
        next(it)
        time.sleep(0.3)
        with pytest.raises(PF.InjectedFault) as ei:
            for _ in it:
                pass
    assert plan.fired("loader.prefetch") == 1
    names = []
    tb = ei.value.__traceback__
    while tb is not None:
        names.append(tb.tb_frame.f_code.co_name)
        tb = tb.tb_next
    assert "produce" in names and "perform" in names, names


def test_prefetch_thread_death_is_a_stall_in_both():
    j, p = _loaders(depth=1, stall_timeout=1.0)
    jplan, pplan = _both([dict(site="loader.prefetch", kind="thread_death",
                               nth=2)])
    from partiallyshuffledistributedsampler_tpu.utils.watchdog import (
        StallError as JStall,
    )
    from partiallyshuffledistributedsampler_tpu_torch import StallError
    with jplan:
        jserved, _ = _steps_until_fault(j, 1, JStall)
    with pplan:
        pserved, exc = _steps_until_fault(p, 1, StallError)
    assert pserved == jserved == 1
    assert "died" in str(exc)


def test_regen_fault_raises_at_the_epoch_call():
    j, p = _loaders(boundary_prefetch=False)
    jplan, pplan = _both([dict(site="loader.regen", kind="error", nth=2)])
    with jplan, pplan:
        j.epoch_indices(0), p.epoch_indices(0)
        with pytest.raises(JF.InjectedFault):
            j.epoch(1)
        with pytest.raises(PF.InjectedFault):
            p.epoch(1)
        np.testing.assert_array_equal(p.epoch_indices(1),
                                      j.epoch_indices(1))
    assert pplan.hits("loader.regen") == jplan.hits("loader.regen") == 3


@pytest.mark.parametrize("kind", ["error", "thread_death", "delay"])
def test_boundary_fault_only_loses_the_prefetch(kind):
    """Under an armed plan the boundary site draws in the caller's thread
    and a fault loses only the overlap: the next epoch is the plain law,
    regenerated in the foreground (one more ``loader.regen`` hit)."""
    j, p = _loaders()
    jplan, pplan = _both([dict(site="loader.boundary", kind=kind,
                               delay_s=0.0)])
    with jplan, pplan:
        jb = [b["y"] for b in j.epoch(0)]
        pb = [b["y"] for b in p.epoch(0)]
        assert p._boundary_thread is None  # the worker was suppressed
        jn = [np.asarray(b["y"]) for b in j.epoch(1)]
        pn = [b["y"].numpy() for b in p.epoch(1)]
    for a, b in zip(jb, pb):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert len(pn) == len(jn)
    for a, b in zip(jn, pn):
        np.testing.assert_array_equal(b, a)
    plain = HostDataLoader({"y": np.arange(N)}, window=WINDOW, batch=BATCH,
                           world=WORLD, index_backend="cpu", device="cpu",
                           boundary_prefetch=False)
    np.testing.assert_array_equal(np.concatenate(pn),
                                  plain.epoch_indices(1)[:len(
                                      np.concatenate(pn))])
    for site in ("loader.boundary", "loader.regen"):
        assert pplan.hits(site) == jplan.hits(site), site
    assert pplan.fired("loader.boundary") == 1
    assert pplan.hits("loader.regen") == 2


def test_boundary_worker_runs_without_a_plan():
    _, p = _loaders()
    list(p.epoch(0))
    t = p._boundary_thread
    assert t is not None
    t.join(5.0)
    with PF.FaultPlan([dict(site="loader.regen", kind="error")]) as plan:
        # an armed plan refuses the pre-plan prefetch: the foreground
        # regen draws (and here fails) as the plan expects
        with pytest.raises(PF.InjectedFault):
            p.epoch(1)
    assert plan.hits("loader.regen") == 1
    p.close()


# --------------------------------------------------------------- sampling
def _weighted(pkg, mode="weighted", **kw):
    kw = dict(epoch_samples=600, seed=7, window=8, **kw)
    if pkg == "jax":
        return getattr(JSampling, mode)(SIZES, WEIGHTS, **kw)
    return getattr(SamplingSpec, mode)(SIZES, WEIGHTS, backend="cpu", **kw)


@pytest.mark.parametrize("kind", ["error", "reset", "disk_full"])
def test_alias_build_fault_serves_the_uniform_table(kind):
    """The counterpart of the JAX sampling suite's fallback test: a build
    fault serves the uniform table with a RuntimeWarning and the
    ``sampling_alias_fallback`` event, in both packages alike."""
    JT.configure(enabled=True)
    PT.configure(enabled=True)
    jspec, pspec = _weighted("jax"), _weighted("port")
    jplan, pplan = _both([dict(site="sampling.alias_build", kind=kind)])
    with jplan, pplan, warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        jgot = jspec.rank_indices(0, 0)
        pgot = pspec.rank_indices(0, 0)
        # the rule fired once: the next build is the weighted table again
        pnext = pspec.rank_indices(1, 0)
        jnext = jspec.rank_indices(1, 0)
    assert pplan.fired("sampling.alias_build") == 1
    assert sum("UNIFORM" in str(x.message) for x in w) == 2
    np.testing.assert_array_equal(pgot, jgot)
    uniform = SamplingSpec.weighted(SIZES, (1, 1, 1), epoch_samples=600,
                                    seed=7, window=8, backend="cpu")
    np.testing.assert_array_equal(pgot, uniform.rank_indices(0, 0))
    np.testing.assert_array_equal(pnext, jnext)
    np.testing.assert_array_equal(pnext, _weighted("port").rank_indices(1, 0))
    pev = [e for e in PT.snapshot() if e.get("name")
           == "sampling_alias_fallback"]
    jev = [e for e in JT.snapshot() if e.get("name")
           == "sampling_alias_fallback"]
    assert len(pev) == len(jev) == 1
    assert pev[0]["attrs"] == jev[0]["attrs"]


def test_alias_build_thread_death_propagates():
    with PF.FaultPlan([dict(site="sampling.alias_build",
                            kind="thread_death")]):
        with pytest.raises(PF.InjectedThreadDeath):
            _weighted("port").rank_indices(0, 0)


def test_adopted_bad_weights_fall_back_with_the_event():
    PT.configure(enabled=True)
    spec = _weighted("port", "prioritized").with_stream_weights(
        {1: (0, 0, 0)})
    with pytest.warns(RuntimeWarning, match="UNIFORM"):
        spec.rank_indices(1, 0)
    assert [e["attrs"]["epoch"] for e in PT.snapshot()
            if e.get("name") == "sampling_alias_fallback"] == [1]


@pytest.mark.parametrize("rule", [
    dict(site="sampling.dedup_check", kind="error", nth=5, every=7,
         count=0),
    dict(site="sampling.dedup_check", kind="error", p=0.05, count=0),
])
def test_dedup_check_fault_fails_safe_as_in_jax(rule):
    """A firing ``sampling.dedup_check`` treats the candidate as seen: the
    draw is re-drawn, never double-served.  The same plan leaves the same
    stream, hit counts and events in both packages."""
    JT.configure(enabled=True, capacity=100_000)
    PT.configure(enabled=True, capacity=100_000)
    kw = dict(epoch_samples=250, seed=5, window=8)
    jspec = JSampling.deduped(SIZES, **kw)
    pspec = SamplingSpec.deduped(SIZES, backend="cpu", **kw)
    jplan, pplan = _both([rule], seed=9)
    with jplan, pplan:
        jgot = [jspec.rank_indices(e, 0) for e in (0, 1)]
        pgot = [pspec.rank_indices(e, 0) for e in (0, 1)]
    for a, b in zip(jgot, pgot):
        np.testing.assert_array_equal(b, a)
    assert pplan.hits() == jplan.hits() > 500
    assert pplan.fired() == jplan.fired() > 0
    # fail-safe: within an epoch no id is served twice
    for e in (0, 1):
        stream = pspec._dedup_streams[e]
        assert len(np.unique(stream)) == len(stream)
    count = {pkg: sum(e.get("name") == "sampling_dedup_failsafe"
                      for e in T.snapshot())
             for pkg, T in (("j", JT), ("p", PT))}
    assert count["p"] == count["j"] == pplan.fired()
    clean = SamplingSpec.deduped(SIZES, backend="cpu", **kw)
    assert not np.array_equal(clean.rank_indices(0, 0), pgot[0])


def test_dedup_saturation_event():
    PT.configure(enabled=True)
    spec = SamplingSpec.deduped((40,), epoch_samples=40, seed=1, window=8,
                                backend="cpu")
    spec.rank_indices(0, 0)
    with pytest.warns(RuntimeWarning, match="saturated"):
        spec.rank_indices(1, 0)
    ev = [e for e in PT.snapshot() if e.get("name")
          == "sampling_dedup_saturated"]
    assert [e["attrs"] for e in ev] == [{"epoch": 1, "draws": 40}]

