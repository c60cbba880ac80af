"""Host utilities: tracing spans, metrics registry."""

from leann_tpu_torch.utils.trace import span
from leann_tpu_torch.utils.metrics import METRICS, Metrics

__all__ = ["span", "METRICS", "Metrics"]
