"""Tracing: timed spans and env-filtered logging (the port's copy of
`leann_tpu/utils/trace.py`).

`span` is a context manager that records wall time into the metrics
registry and logs at debug level, so the build and search paths have
consistent, queryable timings. `configure_logging` sets the level the
CLI's -v / -q ask for; LEANN_LOG (e.g. LEANN_LOG=debug) overrides both.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

logger = logging.getLogger("leann_tpu_torch")


def configure_logging(verbose: bool = False, quiet: bool = False) -> None:
    env = os.environ.get("LEANN_LOG", "").lower()
    if env in ("debug", "trace"):
        level = logging.DEBUG
    elif env == "info":
        level = logging.INFO
    elif env in ("warn", "warning"):
        level = logging.WARNING
    elif env == "error":
        level = logging.ERROR
    elif verbose:
        level = logging.DEBUG
    elif quiet:
        level = logging.ERROR
    else:
        level = logging.WARNING
    logging.basicConfig(
        level=level, format="%(asctime)s %(levelname)s %(name)s: %(message)s"
    )
    logger.setLevel(level)


def trace_log(msg: str, *args) -> None:
    logger.debug(msg, *args)


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
