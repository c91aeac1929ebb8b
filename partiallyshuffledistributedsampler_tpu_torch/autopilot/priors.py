"""Per-workload knob priors: warm restarts from WAL-logged history.

A copy of the JAX package's ``autopilot/priors.py``.

A converged autopilot knows things a fresh one has to re-learn: the
transport batch that lands the RPC rate in the target band, the
in-flight window the workload actually needs.  The policy records those
knobs as a *prior* under a stable workload key once they have survived
``prior_confirm_ticks`` quiet ticks (policy.py "prior learning"); the
prior rides every ``autopilot`` WAL record's ``pstate``, so a promoted
standby inherits it live.

This module closes the *cold restart* loop: :func:`learn_priors`
rebuilds the prior table from a recorded decision history (the live
WAL via ``durability.read_autopilot_records``, or a simulated trace via
``DecisionTrace.wal_records()`` — same record shape), and
:func:`warm_state` wraps it as the ``pstate`` fragment a fresh policy
loads before its first tick.  A deployment restarted from its WAL
therefore tunes to the converged knobs in ONE warm-start decision
(tests/test_fleetsim.py proves knob-for-knob reproduction).
"""

from __future__ import annotations

from typing import Iterable, Optional


def workload_key(spec) -> str:
    """The stable identity priors are indexed by: the per-rank work
    shape, deliberately ignoring everything elastic (epoch, seed,
    addresses).  Two deployments of the same dataset at the same world
    share a key — and therefore share warm starts."""
    n = int(getattr(spec, "n", 0) or 0)
    world = max(1, int(getattr(spec, "world", 1) or 1))
    mode = getattr(spec, "sampling_mode", None)
    if mode is not None:
        # non-uniform sampling kernels have their own regen/serve cost
        # shapes (docs/SAMPLING.md): a dedup fold's knobs must never
        # warm-start a uniform deployment of the same n/world, and vice
        # versa.  Uniform keys keep their historical form — every
        # recorded prior table stays valid.
        return f"n{n}:w{world}:s{mode}"
    return f"n{n}:w{world}"


def learn_priors(records: Iterable[dict],
                 fallback_last_tune: bool = True) -> dict:
    """Rebuild the prior table from ``autopilot`` WAL records (lsn
    order).  Two sources, newest wins:

    * every record's ``pstate["priors"]`` — priors the policy itself
      confirmed (the authoritative source);
    * when ``fallback_last_tune`` and a workload never confirmed a
      prior (e.g. the run crashed inside the confirmation window), the
      knobs of its LAST logged tune — the best estimate of where the
      run converged.  Warm-start tunes are decisions like any other,
      so a restart chain keeps converging instead of resetting.
    """
    priors: dict = {}
    last_tune: dict = {}
    for rec in records:
        if rec.get("op", "autopilot") != "autopilot":
            continue
        ps = rec.get("pstate") or {}
        for wl, knobs in (ps.get("priors") or {}).items():
            priors[str(wl)] = dict(knobs)
        wl = rec.get("workload")
        if rec.get("kind") == "tune" and wl is not None:
            args = {k: int(v) for k, v in (rec.get("args") or {}).items()
                    if v is not None}
            if args.get("batch_hint") is not None:
                last_tune[str(wl)] = args
            elif str(wl) in last_tune:
                last_tune[str(wl)].update(args)
    if fallback_last_tune:
        for wl, knobs in last_tune.items():
            if wl not in priors:
                priors[wl] = knobs
    return priors


def warm_state(priors: dict,
               base: Optional[dict] = None) -> dict:
    """The ``pstate`` fragment that seeds a fresh policy with
    ``priors``: ``policy.load_state_dict(warm_state(p))`` before the
    first tick makes that tick emit the warm-start tune."""
    out = dict(base or {})
    out["priors"] = {str(k): dict(v) for k, v in (priors or {}).items()}
    return out
