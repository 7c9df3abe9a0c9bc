"""Self-telemetry: the registry every self-metric reader shares, its
Prometheus exposition, and device runtime telemetry (runtime.py)."""

from veneur_tpu_torch.observability.registry import (  # noqa: F401
    Counter, Gauge, TelemetryRegistry, Timer, TIMER_QUANTILES)
from veneur_tpu_torch.observability.export import (  # noqa: F401
    render_prometheus)
