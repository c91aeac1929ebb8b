"""The program pass (spans.py): its reduction on hand-made profiler events
and span entries (idle gaps named by the innermost program span, the
device idle inside the driving thread's spans, enclosed launches), each
reader of program_metrics.json on a hand-made context and with nothing to
read, the first traced pass's summary unchanged when the program pass
follows it, the pass on a small regen cell on the CPU, and the proposed
manifest entries against the manifest's contract."""

import os
import re
from types import SimpleNamespace

import pytest
import torch

from bench_port import harness, spans, trace

T0 = 10**18  # the trace's start, ns on the Unix-epoch clock


def ev(name, start, end, device="CPU"):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def entry(name, start_us, end_us, thread="MainThread", device_ms=None):
    return dict(kind="span", name=name, start_ns=T0 + start_us * 1000,
                ms=(end_us - start_us) / 1e3, thread=thread,
                device_ms=device_ms)


EVENTS = [ev("k1", 10, 30, "CUDA"), ev("k2", 50, 60, "CUDA"),
          ev("k3", 100, 110, "CUDA"), ev("k4", 200, 210, "CUDA"),
          ev("cudaLaunchKernel", 25, 27)]
ENTRIES = [entry("psds_epoch_regen", 20, 55, device_ms=0.04),
           entry("shard.expand", 35, 45),
           entry("loader.gather", 70, 90, thread="psds-host-prefetch"),
           {"kind": "event", "name": "ignored"}]


def test_gaps_named_by_the_innermost_program_span():
    out = spans.reduce(EVENTS, ENTRIES, T0, 2, "MainThread", {"a": 3})
    # idle gaps [30, 50], [60, 100], [110, 200] µs, longest first
    assert out["gaps"] == [
        [spans.OUTSIDE, pytest.approx(90e-6)],
        ["loader.gather (psds-host-prefetch)", pytest.approx(40e-6)],
        ["shard.expand", pytest.approx(20e-6)]]
    # only the driving thread's spans hold program idle: [30, 50]
    assert out["idle_in_spans_s"] == pytest.approx(20e-6)
    assert out["launches_enclosed"] == [1, 1]
    assert out["host_ms"] == {"psds_epoch_regen": [0.035],
                              "shard.expand": [0.01],
                              "loader.gather": [0.02]}
    assert out["device_ms"] == {"psds_epoch_regen": [0.04]}
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx(50e-6)
    assert out["units"] == 2 and out["counters"] == {"a": 3}


def test_spans_without_a_start_give_durations_alone():
    """A program whose spans carry no ``start_ns`` (before it had one)."""
    bare = [dict(e, start_ns=None) for e in ENTRIES[:3]]
    out = spans.reduce(EVENTS, bare, T0, 2, "MainThread", {})
    assert out["host_ms"]["psds_epoch_regen"] == [0.035]
    assert out["gaps"] == [] and out["idle_in_spans_s"] is None
    assert out["launches_enclosed"] is None


def reader(name):
    return harness.load_file(os.path.join(harness.HERE, "metrics",
                                          f"{name}.py"),
                             "r_" + name.replace(".", "_"))


NAMES = [m["name"] for m in spans.load_metrics()]


def ctx(**program):
    base = dict(units=4, window_s=1.0, busy_s=0.5, idle_in_spans_s=0.002,
                gaps=[], launches_enclosed=None,
                host_ms={"psds_shard_regen": [0.3, 0.5, 0.4],
                         "psds_epoch_regen": [0.1, 0.2, 0.1],
                         "shard.tables": [0.2, 0.1, 0.3],
                         "loader.gather": [2.0, 1.0, 3.0],
                         "loader.wait": [0.5, 0.25, 0.25, 1.0]},
                device_ms={"psds_shard_regen": [0.36, 0.38, 0.37],
                           "step.forward": [40.0, 42.0, 41.0],
                           "step.backward": [80.0, 81.0, 82.0],
                           "step.optimizer": [20.0, 21.0, 22.0]},
                counters={"batches_served": 8, "batches_ready": 6})
    base.update(program)
    return {"trace": {"program": base}}


def test_readers_on_a_program_pass():
    c = ctx()
    got = {n: reader(n).read(c) for n in NAMES}
    assert got == pytest.approx({
        "entry_span_ms.regen": 0.4,  # shard mode's outermost span
        "shard_tables_ms.regen": 0.2,
        "regen_device_span_ms.regen": 0.37,
        "program_idle_ms.regen": 0.5, "program_idle_ms.train": 0.5,
        "loader_gather_ms.train": 2.0,
        "loader_wait_span_ms.train": 0.5,
        "loader_ready_pct.train": 75.0,
        "step_forward_ms.train": 41.0, "step_backward_ms.train": 81.0,
        "step_optimizer_ms.train": 21.0})
    # on the index path the outermost regen span is psds_epoch_regen
    index = ctx(host_ms={"psds_epoch_regen": [0.1, 0.2, 0.1]})
    assert reader("entry_span_ms.regen").read(index) == pytest.approx(0.1)


@pytest.mark.parametrize("name", NAMES)
def test_readers_read_nothing_without_the_spans(name):
    assert reader(name).read({"trace": {"units": 3}}) is None
    empty = ctx(host_ms={}, device_ms={}, counters={},
                idle_in_spans_s=None)
    assert reader(name).read(empty) is None


class Mark:
    def __init__(self, t):
        self.t = t

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


class FakeDriver:
    """A driver whose steps take 0.1 s in its first traced pass and 0.2 s
    in its second, each pass opening one program span."""

    def __init__(self):
        self.passes = 0

    def sync(self):
        pass

    def traced(self):
        from partiallyshuffledistributedsampler_tpu_torch import telemetry

        self.passes += 1
        self.step_marks = [Mark(0.1 * self.passes * i) for i in range(4)]
        with telemetry.span("step"):
            torch.ones(8).sum()
        return 3


@pytest.fixture
def cpu_profiler(monkeypatch):
    """The profiler of the CPU in place of the card's."""
    from torch.profiler import ProfilerActivity

    real = torch.profiler.profile
    monkeypatch.setattr(torch.profiler, "profile",
                        lambda activities, **kw: real(
                            activities=[ProfilerActivity.CPU], **kw))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)


def test_the_first_pass_is_unchanged_by_the_program_pass(cpu_profiler):
    alone = trace.traced(FakeDriver())
    driver = FakeDriver()
    both = spans.with_program_pass(trace.traced)(driver)
    program = both.pop("program")
    assert both == alone
    assert both["steps"] == {"step_s": pytest.approx(0.1)}
    assert driver.passes == 2 and program["units"] == 3
    assert program["host_ms"].keys() == {"step"}
    from partiallyshuffledistributedsampler_tpu_torch import telemetry

    assert not telemetry.enabled() and telemetry.snapshot() == []


def test_program_pass_on_a_small_shard_regen_cell(cpu_profiler):
    cell = harness.load_cell("wds_s1_vitl16.regen")
    # no training state beside the regens here
    cell["config"] = dict(cell["config"], num_shards=2_000, shard_size=40,
                          window=4, model=None)
    cell["params"] = dict(cell["params"], traced_regens=3)
    driver = harness.make_driver(cell, 2**31 + 5, "cpu")
    driver.setup()
    driver.window(0.05)
    driver.traced()  # the first traced pass
    kept = dict(driver.kept)
    p = spans.program_pass(driver)
    assert p["units"] == 3
    # on the CPU backend the shard order is the host's: no index span
    assert {n: len(v) for n, v in p["host_ms"].items()} == {
        "psds_shard_regen": 3, "shard.tables": 3, "shard.row_keys": 3,
        "shard.expand": 3}
    assert p["device_ms"] == {} and p["counters"] == {}
    assert driver.kept.keys() == kept.keys()


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_proposed_entries_meet_the_manifest_contract():
    """program_metrics.json holds BENCHMARK.json entries as the manifest
    would take them: new names, the contract's keys and characters, a
    reader each, cells that report the end-to-end metric each moves."""
    manifest = harness._json(os.path.join(harness.ROOT, "BENCHMARK.json"))
    moves = {m["name"]: m for m in manifest["end_to_end"]}
    layers = {m["layer"] for m in manifest["per_layer"]}
    taken = {m["name"] for m in manifest["end_to_end"]
             + manifest["per_layer"]}
    entries = spans.load_metrics()
    assert len(entries) == 11 and not taken & set(NAMES)
    for m in entries:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("program_span", "program_counter")
        assert m["layer"] in layers
        assert set(m["workloads"]) <= set(moves[m["moves"]]["workloads"])
        assert os.path.exists(os.path.join(harness.HERE, "metrics",
                                           f"{m['name']}.py"))
