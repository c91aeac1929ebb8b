"""The data-parallel driver (``traffic/train_dp.py``) on the CPU routes:
four ranks, rank 0 in this process and three children, in one gloo group,
at the tests' small size, held to the cell's committed limits.  Sound, a
run comes out correct; with each fault the cell can have, or with the
control, not; and no child is left behind, after a run or after rank 0
raises."""

import os
import subprocess
import sys

import pytest

from bench_port import control, harness
from bench_port.tests.test_bench_port_faults import small_cell

CELL = "c4_1b_gpt2s.train.dp4"
FAULTS = ["half_batch", "frozen", "late_frozen", "no_allreduce",
          "peer_rank0_ids", "peer_perturbed", "peer_altered_row"]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(harness, "load_cell", small_cell)


def children() -> list:
    """This process's child processes, zombies included (from /proc)."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid():
            out.append(int(pid))
    return out


def test_the_cell_asks_for_four_ranks_on_four_cards():
    cell = harness.load_cell(CELL)
    assert cell["entry"]["chips"] == 4 == cell["params"]["world"]
    assert cell["params"]["kind"] == "train_dp"
    assert cell["params"]["limits"]["rank_param_gap"] == 0
    names = {m["name"] for m in cell["per_layer"]}
    assert {"allreduce_ms.train", "allreduce_roofline",
            "mfu_pct.train"} <= names


@pytest.mark.parametrize("fault", [None] + FAULTS)
def test_sound_is_correct_and_each_fault_is_not(small, fault):
    line, checks = harness.measure(CELL, 2**31 + 11, 0.3, False,
                                   device="cpu", fault=fault)
    assert line["correct"] is (fault is None), line["checks"]
    assert line["device"]["count"] == 4
    assert "rank_param_gap" in line["checks"]
    if fault is None:
        assert line["checks"]["rank_param_gap"]["value"] == 0
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
    assert children() == []


def test_the_control_fails(small):
    r = control.train_readings(harness.load_cell(CELL), 9, 0.2, "cpu",
                               "control")
    assert r["correct"] is False, r
    assert children() == []


def test_no_child_is_left_when_rank_0_raises(small, monkeypatch):
    driver = harness.traffic("train_dp").Driver

    def broken(self, seconds):
        raise RuntimeError("rank 0 fails in its window")

    monkeypatch.setattr(driver, "window", broken)
    with pytest.raises(RuntimeError, match="rank 0 fails"):
        harness.measure(CELL, 5, 0.3, False, device="cpu")
    assert children() == []


def test_without_four_cards_a_run_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", CELL, "--seed",
         "3", "--seconds", "1", "--trace", "0"], cwd=harness.ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "bench_port:" in out.stderr


def test_a_child_holding_a_forbidden_module_gives_no_result(small):
    with pytest.raises(harness.BenchError, match="rank 1: jax"):
        harness.measure(CELL, 2**31 + 13, 0.3, False, device="cpu",
                        fault="peer_forbidden_import")
    assert children() == []
