"""Closed-loop self-tuning for a serving deployment (docs/AUTOPILOT.md).

A copy of the JAX package's ``autopilot/``: the same decisions, WAL
records and metric names.  The backend arm's probe is the port's
``utils/autotune.pick_backend``, which measures the card and answers
``"cuda"`` or the host backend.

The autopilot is a per-deployment controller that samples windowed
metric deltas (``MetricsRegistry.delta``), feeds them to a deterministic
policy engine, and actuates three arms:

* **knobs** — transport batch + advertised ``max_inflight`` ride the
  existing WELCOME/heartbeat fields; load shedding scales every typed
  ``retry_ms`` hint through :class:`~..service.backpressure
  .BackpressurePolicy`.
* **shard map** — split a hot shard, merge cold neighbors, migrate
  rank slices via the router's two-phase ``remap`` handoff; clients
  re-route on the existing ``wrong_shard`` path and folded streams stay
  bit-identical (no generation bump).
* **drills** — self-driven standby promotions while ``repl_lag_ms`` is
  clean, recording real ``failover_ms``.

Every decision is WAL-logged as an additive ``autopilot`` record, so a
promoted standby's controller resumes the old primary's trajectory.
With no controller attached the serving plane is bit- and
byte-identical to the pre-autopilot build: zero protocol bytes, one
boolean check per heartbeat.
"""

from .controller import Autopilot
from .policy import AutopilotPolicy, Decision, PolicyConfig
from .priors import learn_priors, warm_state, workload_key

__all__ = ["Autopilot", "AutopilotPolicy", "Decision", "PolicyConfig",
           "learn_priors", "warm_state", "workload_key"]
