"""Model kinds, one module each: ``kinds/<kind>.py`` serves a configuration
whose ``model.kind`` is ``<kind>``, loaded by name as the harness loads its
readers, so that a new kind comes in as a file of its own.  A kind module
gives:

- ``host_rows(config, alloc)``: the host rows the loader serves, made in
  arrays from ``alloc(shape, dtype)``, as ``HostDataLoader`` takes them;
  each row holds its own id and a pattern drawn from it;
- ``widen(batch)``: a served batch as the row check reads it, widened on
  the card; ``alter(served)`` changes one value of it in place (the
  ``altered_row`` fault);
- ``row_check(config, device)``: ``check(served, want)``, the rows of a
  widened batch that break their pattern or hold another id than ``want``
  (a device scalar);
- ``step_inputs(served, fed)``: the step's arguments that come before
  ``epoch_idx, step``, from the batch's first ``fed`` rows;
- ``program(model, device)``: ``(module, make_step)``: the port's model at
  the configuration's widths and its step, ``make_step(opt, mesh, batch)``;
- ``reference_batch(data, ids, device)``: the plain reference's batch of
  the host rows ``ids``;
- ``leaves(model)``: ``(name, shape, init)`` of every weight leaf, in the
  order ``weights.make`` draws them (``init``: a fan-in, "one" or "zero");
- ``reference_loss(w, model, batch, fp8)``: the plain float32 loss;
- ``train_step_flops(model, batch)``: the model FLOPs of one rank's step.
"""

from __future__ import annotations

import functools
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from bench_port.harness import BenchError, load_file

HERE = os.path.dirname(os.path.abspath(__file__))
CHUNK_BYTES = 64 << 20


@functools.lru_cache(maxsize=None)
def load(kind: str):
    """The module of model kind ``kind`` (``kinds/<kind>.py``)."""
    path = os.path.join(HERE, f"{kind}.py")
    if not re.match(r"^[A-Za-z0-9_]+$", kind) or not os.path.exists(path):
        raise BenchError(f"no model kind {kind!r}: bench_port/kinds/"
                         f"{kind}.py")
    return load_file(path, f"bench_port_kind_{kind}")


def fill(out: np.ndarray, tmpl: np.ndarray, key) -> None:
    """``out[r] = tmpl[key(r):key(r) + width]`` for every row: the
    template's windows laid out once, then taken in chunks on threads."""
    win = np.ascontiguousarray(np.lib.stride_tricks.sliding_window_view(
        tmpl, out.shape[1]))
    chunk = max(1, CHUNK_BYTES // out[0].nbytes)

    def part(c):
        r = np.arange(c, min(len(out), c + chunk), dtype=np.int64)
        np.take(win, key(r), axis=0, out=out[c:c + r.size], mode="clip")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(part, range(0, len(out), chunk)))
