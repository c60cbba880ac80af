"""Host utilities: tracing spans, logging, metrics registry."""

from leann_tpu_torch.utils.trace import span, trace_log, configure_logging
from leann_tpu_torch.utils.metrics import METRICS, Metrics

__all__ = ["span", "trace_log", "configure_logging", "METRICS", "Metrics"]
