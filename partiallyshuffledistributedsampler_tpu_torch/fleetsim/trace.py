"""Decision traces: the simulator's WAL-shaped, replayable output.

A copy of the JAX package's ``fleetsim/trace.py``.

A :class:`DecisionTrace` records one entry per policy tick:

    {"tick": k, "now": t, "obs": {...}, "decisions": [...],
     "pstate": {...}, "map_fingerprint": "..."}

``obs`` is the exact metric snapshot handed to
``AutopilotPolicy.decide`` (the same shape ``Autopilot._observe``
builds), ``decisions`` the actuated decisions as plain dicts, and
``pstate`` the policy's post-tick ``state_dict()``.  Three laws
(docs/SIMULATOR.md):

* **determinism** — same scenario + same seed → ``to_jsonl()`` is
  byte-identical across runs, machines, and Python versions (canonical
  JSON: sorted keys, no whitespace);
* **replayability** — :meth:`replay` feeds the recorded observations
  into a FRESH policy and must reproduce the recorded decision stream
  exactly (the policy is pure state → this is a real invariant, tested
  in tests/test_fleetsim.py);
* **WAL parity** — :meth:`wal_records` renders the actuated decisions
  in the exact field shape ``Autopilot._log`` appends to a live WAL
  (op/seq/kind/target/args/reason/knobs/pstate), so a simulated trace
  and a live plane's ``durability.read_autopilot_records`` output are
  directly comparable.
"""

from __future__ import annotations

import json
from typing import Iterable, Optional

from ..autopilot.policy import Decision


def _canon(obj) -> str:
    """Canonical JSON: the byte-identity law rides this encoding."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def decision_to_dict(d: Decision) -> dict:
    return {"seq": int(d.seq), "kind": d.kind,
            "target": None if d.target is None else int(d.target),
            "args": dict(d.args), "reason": d.reason}


def decision_to_wal(d: Decision, pstate: dict,
                    workload=None) -> dict:
    """The additive ``autopilot`` WAL record shape (minus ``lsn``,
    which the live replication log assigns)."""
    rec = decision_to_dict(d)
    rec["op"] = "autopilot"
    rec["knobs"] = dict(d.args) if d.kind == "tune" else None
    rec["workload"] = workload
    rec["pstate"] = dict(pstate)
    return rec


class DecisionTrace:
    """Append-only per-tick record of a simulated (or live) run."""

    def __init__(self, entries: Optional[Iterable[dict]] = None) -> None:
        self.entries: list = [dict(e) for e in (entries or [])]

    def append(self, *, tick: int, now: float, obs: dict,
               decisions: Iterable[Decision], pstate: dict,
               map_fingerprint: str = "",
               extra: Optional[dict] = None) -> dict:
        e = {
            "tick": int(tick),
            "now": float(now),
            "obs": obs,
            "decisions": [decision_to_dict(d) for d in decisions],
            "pstate": dict(pstate),
            "map_fingerprint": str(map_fingerprint),
        }
        if extra:
            # additive overlay keys (e.g. the federation's per-tick cell
            # + directory version, docs/FEDERATION.md); callers must not
            # shadow the core keys above — entry shape without an
            # overlay is unchanged, so existing traces stay byte-stable
            e.update(extra)
        self.entries.append(e)
        return e

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------- export
    def to_jsonl(self) -> str:
        """One canonical-JSON line per tick — the byte-identity law's
        subject: same scenario + seed → identical bytes."""
        return "".join(_canon(e) + "\n" for e in self.entries)

    @classmethod
    def from_jsonl(cls, text: str) -> "DecisionTrace":
        return cls(json.loads(line) for line in text.splitlines() if line)

    def decisions(self) -> list:
        """The flat decision stream (dicts, across all ticks)."""
        return [d for e in self.entries for d in e["decisions"]]

    def wal_records(self) -> list:
        """Every actuated decision as the live WAL would log it: one
        record per decision, ``pstate`` snapshotted at its tick's end
        (the controller logs post-decision state the same way)."""
        out = []
        for e in self.entries:
            for d in e["decisions"]:
                rec = dict(d)
                rec["op"] = "autopilot"
                rec["knobs"] = dict(d["args"]) \
                    if d["kind"] == "tune" else None
                rec["workload"] = (e.get("obs") or {}).get("workload")
                rec["pstate"] = dict(e["pstate"])
                out.append(rec)
        return out

    def decision_log(self) -> str:
        """Canonical JSONL of :meth:`wal_records` — the exact artifact
        the acceptance law quantifies over ("same trace + seed →
        byte-identical decision log")."""
        return "".join(_canon(r) + "\n" for r in self.wal_records())

    # ------------------------------------------------------------- replay
    def replay(self, policy) -> list:
        """Feed the recorded observations through ``policy`` (a fresh
        ``AutopilotPolicy``); returns the per-tick decision-dict lists
        it produced.  Equality with the recorded stream is the replay
        law — asserted by :meth:`verify_replay`."""
        out = []
        for e in self.entries:
            ds = policy.decide(e["obs"])
            out.append([decision_to_dict(d) for d in ds])
        return out

    def verify_replay(self, policy_factory) -> None:
        """Assert the replay law: ``policy_factory()`` must build a
        fresh policy (same config/seed/clock discipline as the run);
        raises AssertionError on the first divergent tick."""
        replayed = self.replay(policy_factory())
        for e, got in zip(self.entries, replayed):
            want = e["decisions"]
            assert got == want, (
                f"replay diverged at tick {e['tick']}: "
                f"recorded {want} but replayed {got}")
