"""The import guard: JAX and the JAX package, compared by whole top-level
name, never in a process that runs the benchmark."""

import subprocess
import sys

from bench_port import harness


def test_names_are_compared_whole():
    assert harness.forbidden_modules(
        ["partiallyshuffledistributedsampler_tpu_torch.ops",
         "numpy", "jaxtyping"]) == []
    assert harness.forbidden_modules(
        ["partiallyshuffledistributedsampler_tpu.ops", "jax.numpy",
         "flax"]) == ["flax", "jax", "partiallyshuffledistributedsampler_tpu"]


def test_the_benchmark_loads_neither_jax_nor_the_jax_package():
    """Everything a run imports (the harness, every driver and reader, the
    port's entry points and models), in a fresh interpreter."""
    code = """
import glob, os, sys
sys.path.insert(0, os.getcwd())
from bench_port import harness, trace, control
for path in sorted(glob.glob('bench_port/traffic/*.py')
                   + glob.glob('bench_port/metrics/*.py')):
    harness.load_file(path, 'm_' + os.path.basename(path).replace('.', '_'))
import partiallyshuffledistributedsampler_tpu_torch as pt
from partiallyshuffledistributedsampler_tpu_torch.models import gpt, vit, train
from partiallyshuffledistributedsampler_tpu_torch import parallel
from partiallyshuffledistributedsampler_tpu_torch import HostDataLoader
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run(
        [sys.executable, "bench_port/run.py", "--workload",
         "c4_1b_gpt2s.regen", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=harness.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert "torch.cuda.is_available() is false" in out.stderr
