"""Each per-layer reader on a hand-made context: its arithmetic, and
nothing (None) where there is nothing to read."""

import os

import pytest

from bench_port import harness
from bench_port.counts import peaks


def reader(name):
    return harness.load_file(os.path.join(harness.HERE, "metrics",
                                          f"{name}.py"), "r_" + name.replace(
                                              ".", "_"))


def ctx(**over):
    base = dict(
        cell=dict(entry=dict(chips=1)), sms=132, max_sm_mhz=1980.0,
        counts={"index_amortized": (int(1e9), 4e6),
                "shard_kernels": (int(2e9), 5e7), "regen": (int(3e9), 6e7),
                "train_step_flops": 1e13},
        host=dict(metrics=dict(regen_ms=0.5), steps=10, wall_s=2.0,
                  wait_s=0.01, compute_s=0.99),
        trace=dict(units=100, busy_s=0.02, window_s=0.05,
                   kernel_s={"void index_amortized_kernel<int>(int*)": 0.01,
                             "shard_row_keys_kernel(x)": 0.001,
                             "shard_expand_kernel<int>(y)": 0.009},
                   steps=dict(step_s=0.15)))
    base.update(over)
    return base


def test_rooflines():
    rate = peaks.int32_ops_per_s(132, 1980.0)
    got = reader("index_amortized_roofline").read(ctx())
    assert got == pytest.approx(100 * (1e9 / rate) / (0.01 / 100))
    got = reader("shard_kernels_roofline").read(ctx())
    assert got == pytest.approx(100 * (2e9 / rate) / (0.01 / 100))
    got = reader("mfu_pct.regen").read(ctx())
    assert got == pytest.approx(100 * (3e9 / rate) / (0.02 / 100))
    empty = ctx(trace=dict(units=100, busy_s=0.0, window_s=0.05,
                           kernel_s={}, steps={}))
    assert reader("index_amortized_roofline").read(empty) is None
    assert reader("model_step_ms.train").read(empty) is None


def test_host_and_device_readers():
    c = ctx()
    assert reader("entry_host_ms.regen").read(c) == pytest.approx(
        0.5 - 1e3 * 0.02 / 100)
    assert reader("device_idle_pct.regen").read(c) == pytest.approx(60.0)
    assert reader("device_idle_pct.train").read(c) == pytest.approx(60.0)
    assert reader("mfu_pct.train").read(c) == pytest.approx(
        100 * 1e13 * 10 / 2.0 / 989e12)
    assert reader("model_step_ms.train").read(c) == pytest.approx(150.0)
    assert reader("loader_wait_ms.train").read(c) == pytest.approx(1.0)
    assert reader("loader_stall_pct.train").read(c) == pytest.approx(1.0)


def test_a_cell_on_four_cards_divides_by_their_peak():
    c = ctx(cell=dict(entry=dict(chips=4)))
    assert reader("mfu_pct.train").read(c) == pytest.approx(
        100 * 1e13 * 10 / 2.0 / (4 * 989e12))


def test_allreduce_readers(monkeypatch):
    from bench_port.counts import link

    monkeypatch.setattr(link, "link_peak_bytes_per_s", lambda card=0: 450e9)
    kernels = {"ncclDevKernel_AllReduce_Sum_f32_RING_LL(x)": 0.02,
               "void ncclDevKernel_AllReduce_Sum_f32_RING_SIMPLE(y)": 0.01,
               "ampere_sgemm(z)": 0.5}
    c = ctx(counts={"allreduce_bytes": 652e6, "world": 4},
            trace=dict(units=10, busy_s=1.0, window_s=1.1,
                       kernel_s=kernels))
    assert reader("allreduce_ms.train").read(c) == pytest.approx(3.0)
    assert reader("allreduce_roofline").read(c) == pytest.approx(
        100 * (1.5 * 652e6 / 0.003) / 450e9)
    nvls = dict(c["trace"], kernel_s={
        "ncclDevKernel_AllReduce_Sum_f32_NVLS_SIMPLE(x)": 0.03})
    assert reader("allreduce_roofline").read(dict(c, trace=nvls)) is None
    one_card = ctx()
    assert reader("allreduce_ms.train").read(one_card) is None
    assert reader("allreduce_roofline").read(one_card) is None
    monkeypatch.setattr(link, "link_peak_bytes_per_s", lambda card=0: None)
    assert reader("allreduce_roofline").read(c) is None
