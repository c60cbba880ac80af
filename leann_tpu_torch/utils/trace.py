"""Tracing: timed spans, profiler ranges and env-filtered logging (the
port's copy of `leann_tpu/utils/trace.py`).

Tracing is on exactly while a `torch.profiler` session records in the
process (`tracing()`). Two kinds of span:

- `span(name)` always records its host seconds into the metrics
  registry (`span.<name>.seconds`, read by `/metrics` and
  `evals/hybrid_latency.py`) and logs at debug level; while tracing is
  on it also opens a `torch.profiler.record_function` range of the same
  name.
- `device_span(name)` marks a stretch of asynchronous device work: only
  the profiler range, while tracing is on, so the range lands on the
  kernels' timeline (host side `user_annotation`, device side
  `gpu_user_annotation`; nesting on one thread gives the parent). It
  records nothing into the registry, whose host time would be enqueue
  time. While tracing is off it costs one flag check.

`configure_logging` sets the level the CLI's -v / -q ask for; LEANN_LOG
(e.g. LEANN_LOG=debug) overrides both.
"""

from __future__ import annotations

import logging
import os
import sys
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


_profiler = None  # torch.autograd.profiler, bound once torch is loaded


def tracing() -> bool:
    """Whether a torch.profiler session is recording in this process:
    `torch.autograd.profiler._is_profiler_enabled`, which every session
    sets while it records. (The C++ flag,
    `torch._C._autograd._profiler_enabled()`, is per thread and stays
    false in a session that profiles all threads.) False while torch is
    not imported: no session can be open then."""
    global _profiler
    if _profiler is None:
        if "torch" not in sys.modules:
            return False
        import torch.autograd.profiler as _profiler_module

        _profiler = _profiler_module
    return _profiler._is_profiler_enabled


class _NoSpan:
    """The span of an untraced call: enters and exits doing nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def device_span(name: str):
    """A profiler range named `name` around asynchronous device work,
    while tracing is on; otherwise a shared context that does nothing."""
    if not tracing():
        return _NO_SPAN
    from torch.profiler import record_function

    return record_function(name)


@contextmanager
def span(name: str, **attrs):
    """Timed span: records a histogram sample `span.<name>` and emits a
    debug log line with attributes; while tracing is on, also a profiler
    range of the same name."""
    from leann_tpu_torch.utils.metrics import METRICS

    with device_span(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - t0
            METRICS.observe(f"span.{name}.seconds", elapsed)
            if logger.isEnabledFor(logging.DEBUG):
                extra = " ".join(f"{k}={v}" for k, v in attrs.items())
                logger.debug("span %s took %.3fs %s", name, elapsed, extra)
