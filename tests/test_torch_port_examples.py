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


def run_example(name: str, *args: str, timeout: float = 240,
                env_extra=None):
    # two threads a process: the suite's other workers share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="2",
               **(env_extra or {}))
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


@pytest.mark.parametrize("name,oks", [
    ("llama3_10b_index", ["tier 1", "tier 2", "tier 3", "tier 4",
                          "config-5 shape end to end"]),
    ("webdataset_shards", ["tier 1, epoch 0", "tier 1, epoch 1", "tier 2",
                           "tier 3", "config-4 shape end to end"]),
])
def test_ported_config_examples_run_on_the_host(name, oks):
    """The repo-root examples of configs 5 and 4, ported, in their fast
    mode (``PSDS_EXAMPLE_FAST=1``, as the JAX originals take it)."""
    res = run_example(name, "--cpu", env_extra={"PSDS_EXAMPLE_FAST": "1"})
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("ok: ")]
    for ok in oks:
        assert any(ok in ln for ln in lines), (ok, res.stdout)


@pytest.mark.parametrize("name", ["llama3_10b_index", "webdataset_shards"])
def test_ported_config_examples_need_the_card_unless_asked(name):
    res = run_example(name, timeout=120)
    assert res.returncode != 0
    assert "CudaUnavailableError" in res.stderr


@pytest.mark.parametrize("name,oks", [
    ("index_service", ["phase 1, 4 ranks", "phase 2, 3000 indices",
                       "index service end to end"]),
    ("multi_tenant", ["phase 1, 2 jobs", "phase 2, the rank over quota",
                      "phase 3", "multi-tenant service end to end"]),
])
def test_service_examples_run_on_the_host(name, oks):
    """The JAX package's index-service and multi-tenant examples, ported:
    a daemon on loopback, its regens on the host with ``--cpu``."""
    res = run_example(name, "--cpu", timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [ln for ln in res.stdout.splitlines() if ln.startswith("ok: ")]
    for ok in oks:
        assert any(ok in ln for ln in lines), (ok, res.stdout)


@pytest.mark.parametrize("name", ["index_service", "multi_tenant"])
def test_service_examples_need_the_card_unless_asked(name):
    res = run_example(name, timeout=120)
    assert res.returncode != 0
    assert "CudaUnavailableError" in res.stderr
