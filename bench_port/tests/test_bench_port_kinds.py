"""Model kinds as files of their own: each ``kinds/<kind>.py`` is found by
the configuration's ``model.kind``, an unknown one is a ``BenchError``, and
the two train cells read on the CPU routes, at the tests' small size, as
they read before their model code moved into ``kinds/``
(``train_readings_cpu.json``, recorded then)."""

import json
import os

import pytest

from bench_port import harness, kinds
from bench_port.tests.test_bench_port_faults import small_cell

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "train_readings_cpu.json")
TRAIN = ["c4_1b_gpt2s.train", "wds_s1_vitl16.train"]
#: what a kind module gives the drivers, the weights, the reference and
#: the counts
CONTRACT = ("host_rows", "row_check", "widen", "alter", "step_inputs",
            "program", "reference_batch", "leaves", "reference_loss",
            "train_step_flops")


def cpu_readings(name: str, seed: int = 2**31 + 7) -> dict:
    """One step in the window (``window(0)``), then the steady step and the
    checks, sound and with the control (the reference at float8)."""
    cell = small_cell(name)
    out = {}
    for mode in ("sound", "control"):
        driver = harness.make_driver(cell, seed, "cpu")
        driver.setup()
        driver.window(0.0)
        driver.release()
        driver.checks(fp8=mode == "control")
        out[mode] = json.loads(json.dumps(driver.last_readings))
    return out


@pytest.mark.parametrize("kind", ["gpt", "vit"])
def test_a_kind_is_found_by_name(kind):
    mod = kinds.load(kind)
    assert all(callable(getattr(mod, f)) for f in CONTRACT)
    assert kinds.load(kind) is mod


def test_an_unknown_kind_is_a_bench_error():
    with pytest.raises(harness.BenchError, match="kinds/mla_moe.py"):
        kinds.load("mla_moe")
    with pytest.raises(harness.BenchError):
        kinds.load("../harness")


@pytest.mark.parametrize("name", TRAIN)
def test_train_readings_are_those_before_the_move(name):
    with open(GOLDEN) as f:
        want = json.load(f)[name]
    assert cpu_readings(name) == want
