"""Tracing: timed spans (the port's copy of `leann_tpu/utils/trace.py`).

`span` is a context manager that records wall time into the metrics
registry and logs at debug level, so the build and search paths have
consistent, queryable timings. The CLI's log configuration waits for the
CLI's slice.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

logger = logging.getLogger("leann_tpu_torch")


@contextmanager
def span(name: str, **attrs):
    """Timed span: records a histogram sample `span.<name>` and emits a
    debug log line with attributes."""
    from leann_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - t0
        METRICS.observe(f"span.{name}.seconds", elapsed)
        if logger.isEnabledFor(logging.DEBUG):
            extra = " ".join(f"{k}={v}" for k, v in attrs.items())
            logger.debug("span %s took %.3fs %s", name, elapsed, extra)
