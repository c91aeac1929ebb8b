"""A whole run of each cell on the CPU routes at a small size, the look
for a card skipped, held to the cell's committed limits: sound, it comes
out correct; with each fault the cell can have planted underneath the
timed path, it comes out not correct; and so does the control (the
reference in the program's place at the lower precision), through the
same comparison."""

import json

import pytest

from bench_port import control, harness

LOAD_CELL = harness.load_cell


def small_cell(name):
    cell = LOAD_CELL(name)
    cfg = dict(cell["config"])
    if cfg["model"]["kind"] == "gpt":
        cfg.update(num_samples=1_000_003, host_rows=4096, window=256,
                   model=dict(cfg["model"], seq_len=32, d_model=64,
                              n_layers=2, n_heads=4, d_ff=128))
    else:
        cfg.update(num_shards=2_000, shard_size=40, host_shards=16, window=4,
                   model=dict(cfg["model"], image_size=32, d_model=64,
                              n_layers=2, n_heads=4, d_ff=128))
    cell["config"] = cfg
    if "batch" in cell["params"]:
        cell["params"] = dict(cell["params"], batch=4)
    return cell


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(harness, "load_cell", small_cell)


REGEN = ["c4_1b_gpt2s.regen", "wds_s1_vitl16.regen"]
TRAIN = ["c4_1b_gpt2s.train", "wds_s1_vitl16.train"]
CASES = ([(c, None) for c in REGEN + TRAIN]
         + [(c, "altered_answer") for c in REGEN]
         + [(c, f) for c in TRAIN for f in ("frozen", "late_frozen",
                                            "half_batch", "altered_row")])


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_fault_makes_the_run_incorrect(small, cell, fault):
    line, checks = harness.measure(cell, 2**31 + 5, 0.3, False,
                                   device="cpu", fault=fault)
    json.dumps(line)
    assert line["correct"] is (fault is None), line["checks"]
    assert list(line)[-1] == "checks"
    assert set(line["checks"]) == set(checks)
    if fault is None:
        assert set(line["metrics"]) == {
            m["name"] for m in LOAD_CELL(cell)["end_to_end"]}


@pytest.mark.parametrize("cell", REGEN)
def test_the_regen_control_fails(small, cell):
    r = control.regen_readings(harness.load_cell(cell), 9, 0.2, "cpu",
                               "control")
    assert r["mismatched_lanes"] > 0 and r["correct"] is False


@pytest.mark.parametrize("cell", TRAIN)
def test_the_train_control_and_faults_fail_the_limits(small, cell):
    c = harness.load_cell(cell)
    sound = control.train_readings(c, 9, 0.2, "cpu", "sound")
    assert sound["correct"] is True, sound
    for mode in ("control", "half_batch", "frozen"):
        r = control.train_readings(c, 9, 0.2, "cpu", mode, sound["rows"])
        assert r["correct"] is False, (mode, r)
    assert sound["steady_step"][1] >= 0
