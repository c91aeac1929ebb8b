"""Sampler checkpoint helpers (SURVEY.md §5 checkpoint/resume).

The sampler's whole state is the `(spec_version, seed, epoch, offset)` dict
from ``state_dict()`` — a plain dict of scalars, so it drops directly into
any checkpointing system (a ``torch.save`` of the training state, or these
json helpers for standalone use).  A copy of the JAX package's
``utils/checkpoint.py``: the files these helpers write are byte-equal to
the JAX package's for the same state, and each package loads the other's.

:func:`durable_write_text` / :func:`fsync_fileobj` are the shared
write+fsync primitives — the snapshot path, the flight recorder's crash
dumps, and the telemetry JSONL sink all persist through them, so "what
survives a host dying right after the write returned" has exactly one
answer in this codebase.
"""

from __future__ import annotations

import json
import os
import tempfile


def fsync_fileobj(f) -> None:
    """Flush ``f``'s userspace buffer and fsync its descriptor: after
    this returns, the bytes written so far survive a power loss (the
    plain ``flush()`` alone only hands them to the OS page cache)."""
    f.flush()
    os.fsync(f.fileno())


def durable_write_text(path: str, text: str, *, durable: bool = True) -> None:
    """Atomic whole-file write (temp file, rename over), safe against
    mid-write crashes.  ``durable=True`` additionally fsyncs the temp
    file before the rename and the directory after it, so the rename
    itself survives a power loss — without it the atomic rename only
    protects against *process* crashes (the OS may reorder the data and
    rename writes on disk)."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
            if durable:
                fsync_fileobj(f)
        os.replace(tmp, path)
        if durable:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def save_sampler_state(path: str, state: dict, *, durable: bool = False) -> None:
    """Atomic json write (rename over) via :func:`durable_write_text`;
    ``durable=True`` makes the write power-loss safe, not just
    process-crash safe."""
    durable_write_text(path, json.dumps(state), durable=durable)


def load_sampler_state(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def tenant_snapshot_path(path: str, tenant_id: str) -> str:
    """Per-tenant sibling of a daemon snapshot path.

    ``/var/psds/snap.json`` + tenant ``t0a1b2c3d4`` →
    ``/var/psds/snap.tenant-t0a1b2c3d4.json`` — the multi-tenant daemon
    (docs/SERVICE.md "Tenancy") writes one snapshot per tenant next to
    its own, and rediscovers them with :func:`list_tenant_snapshots` on
    restart."""
    root, ext = os.path.splitext(path)
    return f"{root}.tenant-{tenant_id}{ext or '.json'}"


def list_tenant_snapshots(path: str) -> dict:
    """Map of ``tenant_id -> snapshot path`` for tenants saved next to
    the base snapshot ``path`` (inverse of :func:`tenant_snapshot_path`)."""
    root, ext = os.path.splitext(path)
    ext = ext or ".json"
    d = os.path.dirname(os.path.abspath(path)) or "."
    if not os.path.isdir(d):
        return {}
    prefix = os.path.basename(root) + ".tenant-"
    out = {}
    for name in sorted(os.listdir(d)):
        if not (name.startswith(prefix) and name.endswith(ext)):
            continue
        tid = name[len(prefix):len(name) - len(ext)]
        if tid and "." not in tid:
            out[tid] = os.path.join(d, name)
    return out
