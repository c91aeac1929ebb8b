"""The trace reduction on hand-made profiler events: the window from the
first device operation to the last, the union of device operations,
kernel time by name, the idle gaps with the host event under each, and a
train step's device time from the periods between step ends."""

from types import SimpleNamespace

import pytest

from bench_port import trace


def ev(name, start, end, device="CPU"):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{device}",
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def test_busy_gaps_and_kernels():
    evs = [ev("cudaStreamSynchronize", 40, 60),
           ev("k1", 10, 30, "CUDA"), ev("k1", 25, 40, "CUDA"),
           ev("k2", 70, 90, "CUDA"), ev("k2", 95, 100, "CUDA")]
    out = trace.summarize(evs)
    assert out["window_s"] == pytest.approx(90e-6)  # [10, 100]
    assert out["busy_s"] == pytest.approx(55e-6)
    assert out["kernel_s"] == pytest.approx({"k1": 35e-6, "k2": 25e-6})
    assert out["device_ops"][0][0] == "k1"
    gaps = dict((round(s * 1e6), n) for n, s in out["idle_gaps"])
    assert gaps == {30: "cudaStreamSynchronize", 5: "host outside CUDA calls"}


def test_a_trace_without_device_operations_reads_nothing():
    out = trace.summarize([ev("cudaStreamSynchronize", 0, 5)])
    assert out["window_s"] is None and out["busy_s"] is None
    assert out["kernel_s"] == {} and out["idle_gaps"] == []


def test_step_times():
    assert trace.step_times([0.1, 0.3, 0.12, 0.11]) == {
        "step_s": pytest.approx(0.115)}
    assert trace.step_times([0.1]) == {}
    assert trace.step_times([]) == {}
