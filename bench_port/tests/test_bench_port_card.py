"""A whole run of each cell on the card (marker ``cuda``): skipped on a
machine without one.  Run on the card with
``python -m pytest -m cuda bench_port/tests``."""

import json
import subprocess
import sys

import pytest

from bench_port import harness

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the port's kernels have no CPU "
                    "interpret mode)")


@pytest.mark.parametrize("cell", ["c4_1b_gpt2s.regen",
                                  "wds_s1_vitl16.regen"])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card(cell, trace):
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload", cell, "--seed",
         "2147483659", "--seconds", "1", "--trace", str(trace)],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert line["metrics"]


@pytest.mark.parametrize("cell,faults", [
    ("c4_1b_gpt2s.regen", "altered_answer"),
    ("wds_s1_vitl16.regen", "altered_answer"),
    ("c4_1b_gpt2s.train", "half_batch,frozen"),
    ("wds_s1_vitl16.train", "half_batch,frozen"),
    ("c4_1b_gpt2s.train.dp4",
     "half_batch,no_allreduce,peer_rank0_ids,peer_perturbed")])
def test_the_control_and_faults_fail_the_committed_limits(cell, faults):
    """At the cell's own size, one seed: the sound run comes out correct,
    the control and each fault not, by the run's own comparison."""
    import torch

    chips = harness.load_cell(cell)["entry"]["chips"]
    if torch.cuda.device_count() < chips:
        pytest.skip(f"needs {chips} CUDA GPUs")
    out = subprocess.run(
        [sys.executable, "bench_port/control.py", "--workload", cell,
         "--seeds", "2147483661", "--faults", faults, "--seconds", "1"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()
             if x.startswith("{")]
    modes = {x["mode"]: x["correct"] for x in lines}
    assert modes.pop("sound") is True, lines
    assert set(modes) == {"control", *faults.split(",")}
    assert not any(modes.values()), lines
