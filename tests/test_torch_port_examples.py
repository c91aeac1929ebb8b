"""The port's examples (``partiallyshuffledistributedsampler_tpu_torch/
examples/``) run end to end with ``--cpu``, each in a subprocess under its
own timeout, and print their ``ok:`` lines; without ``--cpu`` and with no
card they refuse with ``CudaUnavailableError``."""

import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "partiallyshuffledistributedsampler_tpu_torch.examples"


def run_example(name: str, *args: str, timeout: float = 240):
    # two threads a process: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, "-m", f"{PKG}.{name}", *args],
                          capture_output=True, text=True, timeout=timeout,
                          cwd=str(ROOT), env=env)


@pytest.mark.parametrize("name,oks", [
    ("torch_ddp", ["2 ranks, 2 epochs"]),
    ("training", ["run runner trained 3 x 8 steps", "run_epoch ran 64",
                  "HostDataLoader served 64", "mixture run runner"]),
    ("imagenet_resnet", ["tier 1", "tier 2", "tier 3",
                         "config-2 shape end to end"]),
])
def test_example_runs_on_the_host(name, oks):
    res = run_example(name, "--cpu")
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("ok: ")]
    for ok in oks:
        assert any(ok in ln for ln in lines), (ok, res.stdout)
    assert "backend=native" in res.stdout or name == "training"


def test_example_needs_the_card_unless_asked():
    res = run_example("training", timeout=120)
    assert res.returncode != 0
    assert "CudaUnavailableError" in res.stderr
