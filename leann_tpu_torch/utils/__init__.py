"""Host utilities: tracing spans, logging, metrics registry."""

from leann_tpu_torch.utils.trace import (configure_logging, device_span,
                                         span, tracing)
from leann_tpu_torch.utils.metrics import METRICS, Metrics

__all__ = ["span", "device_span", "tracing", "configure_logging", "METRICS",
           "Metrics"]
