"""fleetsim — deterministic discrete-event fleet simulator.

A copy of the JAX package's ``fleetsim/``: one seed and one
``Calibration`` give the same ``DecisionTrace`` in both packages, with
``"cuda"`` where the JAX package says ``"xla"``.  The port's latency
defaults are the H100's own (``latency.py``), never the JAX package's
numbers.

A seeded, wall-clock-free harness that drives the *real* autopilot
policy engine, backpressure table, and shard-map transforms at
thousands of simulated ranks (docs/SIMULATOR.md).  The policy under
simulation is the exact object a live deployment runs — the simulator
only fabricates the world around it: a priority-queue event loop over
an injected :class:`SimClock`, latency models calibrated on the
card (``latency.py``), and closed-form workload demand profiles.

    from partiallyshuffledistributedsampler_tpu_torch import fleetsim as fs

    sim = fs.FleetSim(world=5000, n_shards=4, n=5000 << 20, seed=7,
                      workload=fs.workload.hotspot(
                          10.0, hot_lo=0, hot_hi=1250, factor=6.0,
                          at_s=5.0, ramp_s=10.0))
    sim.run(ticks=40)
    sim.trace.decision_log()   # byte-identical per (scenario, seed)
"""

from . import workload
from .clock import SimClock
from .events import EventLoop
from .fleet import FleetSim
from .latency import Calibration, LatencyModel, RegenCostModel
from .trace import DecisionTrace, decision_to_dict, decision_to_wal
from .workload import Workload

__all__ = [
    "Calibration",
    "DecisionTrace",
    "EventLoop",
    "FleetSim",
    "LatencyModel",
    "RegenCostModel",
    "SimClock",
    "Workload",
    "decision_to_dict",
    "decision_to_wal",
    "workload",
]
