"""The benchmark's runner: one cell, one run.

Everything that belongs to one cell is found by name: the manifest
(``BENCHMARK.json`` at the repository's root) names the cell's
configuration and its metrics; ``workloads/<cell>.json`` holds the
traffic's parameters and the limits of its correctness checks;
``configs/<config>.json`` the configuration as it is run;
``traffic/<kind>.py`` the one driver of that kind of traffic;
``kinds/<kind>.py`` the model kind a configuration's ``model.kind`` names;
and ``metrics/<metric>.py`` the one reader of each per-layer metric.  A
later change adds a cell, a configuration, a model kind or a metric by
adding files.

A driver has the methods ``setup()``, ``window(seconds)`` (the untraced
measured window: a dict of end-to-end values and host statistics),
``traced()`` (a bounded steady sub-window, run under the profiler),
``counts()`` (the work of one unit, for the readers), ``release()`` (frees
the program's state once the peak memory is read) and ``checks()``
(``[(name, value, limit)]`` after the reference has run).  A driver that
runs ranks in processes of its own on further cards also has ``close()``,
which stops and waits for them after a run or a failure, and gives their
peak memory (``peer_peak_bytes``) and traced device times
(``peer_times``: ``[busy_s, window_s]`` a card).
"""

from __future__ import annotations

import functools
import importlib.util
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that the process must never hold: JAX and the
#: JAX package, compared whole (the port's name begins with the latter's)
FORBIDDEN = ("jax", "jaxlib", "flax", "partiallyshuffledistributedsampler_tpu")


class BenchError(Exception):
    """A run that cannot give a result (no card, a missing file, a module
    that must not be loaded); it prints no result and exits non-zero."""


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among ``names`` (default: every
    module this process has loaded)."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None
                                         else names)}
    return sorted(tops.intersection(FORBIDDEN))


def process_age_s() -> float:
    """Seconds since this process started, by the kernel's clock of the
    start (``/proc/self/stat``) against ``/proc/uptime``: interpreter
    start-up and imports included."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        return float(f.read().split()[0]) - start


def load_file(path: str, name: str):
    """A module from a file of this folder, whatever its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise BenchError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _json(path: str):
    if not os.path.exists(path):
        raise BenchError(f"missing {os.path.relpath(path, ROOT)}")
    with open(path) as f:
        return json.load(f)


def load_cell(name: str) -> dict:
    """The cell ``name``: its manifest entry, configuration, traffic
    parameters, and the end-to-end and per-layer metrics it reports."""
    manifest = _json(os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise BenchError(f"no workload {name!r} in BENCHMARK.json")
    entry = cells[name]
    cfg_entry = {c["name"]: c for c in manifest["configs"]}[entry["config"]]
    config = _json(os.path.join(ROOT, cfg_entry["file"]))
    params = _json(os.path.join(HERE, "workloads", f"{name}.json"))

    def reports(metric):
        return name in metric.get("workloads", [name])

    e2e = [m for m in manifest["end_to_end"] if reports(m)]
    moved = {m["name"] for m in e2e}
    layer = [m for m in manifest["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in moved
                              else [])]
    return dict(name=name, entry=entry, config=config, params=params,
                end_to_end=e2e, per_layer=layer)


@functools.lru_cache(maxsize=None)
def traffic(kind: str):
    """The driver module of a kind of traffic, loaded once a process."""
    return load_file(os.path.join(HERE, "traffic", f"{kind}.py"),
                     f"bench_port_traffic_{kind}")


def make_driver(cell: dict, seed: int, device: str, **kw):
    return traffic(cell["params"]["kind"]).Driver(
        cell["config"], cell["params"], seed, device, **kw)


def read_layer_metrics(cell: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell by its own reader; a reader that
    finds nothing to read returns None and its metric is left out."""
    out = {}
    for m in cell["per_layer"]:
        path = os.path.join(HERE, "metrics", f"{m['name']}.py")
        reader = load_file(path, "bench_port_metric_"
                           + m["name"].replace(".", "_").replace("-", "_"))
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def nvidia_smi(query: str) -> str:
    import subprocess

    res = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise BenchError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def card(chips: int) -> dict:
    """The card this run uses, or a ``BenchError`` where there is none or
    fewer than ``chips``."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("no CUDA device: torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} present")
    props = torch.cuda.get_device_properties(0)
    return dict(kind=torch.cuda.get_device_name(0),
                sms=props.multi_processor_count)


def run(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        line, checks = measure(args.workload, args.seed, args.seconds,
                               bool(args.trace))
    except BenchError as exc:
        print(f"bench_port: {exc}", file=sys.stderr)
        return 2
    for name, (value, limit) in checks.items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(line))
    return 0


def measure(workload: str, seed: int, seconds: float, trace: bool, *,
            device: str = "cuda", fault=None):
    """One run of a cell: ``(result line, checks)``.  ``device="cpu"``
    skips the look for a card and drives the rest of the run on the
    port's CPU routes (tests; no trace, no card readings); ``fault`` plants
    one of the faults the checks must catch (``traffic/``)."""
    import torch

    cell = load_cell(workload)
    if seed < 0:
        raise BenchError(f"--seed must be a whole number >= 0, got {seed}")
    on_card = device != "cpu"
    if on_card:
        dev = card(cell["entry"]["chips"])
        torch.cuda.reset_peak_memory_stats()
    driver = make_driver(cell, seed, device, fault=fault)
    try:
        driver.setup()
        setup_s = process_age_s()
        for name, secs in getattr(driver, "setup_phases", ()):
            print(f"setup {name}: {secs} s", file=sys.stderr)
        host = driver.window(seconds)
        summary = None
        if trace:
            from bench_port import trace as tr

            summary = tr.traced(driver)
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        found = forbidden_modules()
        if found:
            raise BenchError("the window ran with forbidden modules loaded: "
                             + ", ".join(found))
        t0 = time.perf_counter()
        driver.release()
        # the fullest card: a driver that runs ranks of its own reads theirs
        peak = max(peak, getattr(driver, "peer_peak_bytes", 0))
        t1 = time.perf_counter()
        checks = driver.checks()
        print(f"after the window: release {t1 - t0:.3f} s, reference and "
              f"checks {time.perf_counter() - t1:.3f} s", file=sys.stderr)
        correct = all(v <= lim for _, v, lim in checks)
        device_line = dict(platform="gpu" if on_card else "cpu",
                           kind=dev["kind"] if on_card else "cpu",
                           count=cell["entry"]["chips"],
                           memory_peak_bytes=int(peak))
        line = dict(correct=correct, attempted=int(host["attempted"]),
                    failed=int(driver.failed), device=device_line)
        if trace:
            ctx = dict(cell=cell, host=host, trace=summary,
                       counts=driver.counts(), sms=dev["sms"],
                       max_sm_mhz=float(nvidia_smi("clocks.max.sm")))
            line["metrics"] = read_layer_metrics(cell, ctx)
            # averaged over the cards: this process's, then its ranks'
            cards = ([(summary["busy_s"], summary["window_s"])]
                     + [tuple(t) for t in getattr(driver, "peer_times", ())])
            device_line.update(busy_s=sum(b for b, _ in cards) / len(cards),
                               window_s=sum(w for _, w in cards) / len(cards))
            line["breakdown"] = dict(device_ops=summary["device_ops"],
                                     idle_gaps=summary["idle_gaps"])
        else:
            values = dict(host["metrics"], setup_s=setup_s)
            line["metrics"] = {m["name"]: {"value": float(values[m["name"]]),
                                           "unit": m["unit"]}
                               for m in cell["end_to_end"]}
        if on_card:
            device_line["power_limit_w"] = nvidia_smi("power.limit")
        found = forbidden_modules()
        if found:
            raise BenchError("forbidden modules loaded: " + ", ".join(found))
        checked = {name: (value, limit) for name, value, limit in checks}
        line["checks"] = {name: {"value": v, "limit": lim}
                          for name, (v, lim) in checked.items()}
        return line, checked
    finally:
        close = getattr(driver, "close", None)
        if close is not None:  # a driver with processes of its own
            close()
