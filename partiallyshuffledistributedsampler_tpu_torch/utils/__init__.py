"""Observability + resilience utilities: stall probe, regen-latency
metrics, the unified retry policy, and the prefetch watchdog."""

from .checkpoint import load_sampler_state, save_sampler_state  # noqa: F401
from .metrics import Histogram, MetricsRegistry, RegenTimer  # noqa: F401
from .retry import RetryPolicy, RetryState  # noqa: F401
from .stall_probe import StallProbe  # noqa: F401
from .watchdog import StallError, thread_stack  # noqa: F401
