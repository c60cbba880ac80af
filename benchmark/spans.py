"""The program's own spans in a traced run's sub-window.

While a profiler records, the program opens a `record_function` range at
each of its layer boundaries (`leann_tpu_torch/utils/trace.py`), which
the sub-window's Chrome trace (exported by `benchmark/profiling.py` into
`benchmark/_out/`) holds as `user_annotation` events. `load` finds the
file whose `benchmark.subwindow` mark has the start and end of
`ctx["profile"]`, and charges each device operation of the sub-window
(kernel, copy, set) to the innermost span that holds its launch: the
`cuda_runtime` or `cuda_driver` event with the operation's
`correlation`, and the annotations of that event's thread whose
interval holds it.

For an outer span (a whole `search_many_device` call), the charged share
is the device time launched inside it over that time plus the device
time whose launch the trace lacks; a reader returns nothing below
`CHARGED_MIN`. Device time launched outside every span is the caller's
(the copies in and out). The program's idle time is the part of the
sub-window in which no device operation ran while the sub-window's own
thread was inside the outer span; the rest of the idle time is the
caller's.
"""

from __future__ import annotations

import glob
import json
import os
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from benchmark.profiling import DEVICE_CATS, HOST_CATS, MARK

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_out")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
ANNOTATION = "user_annotation"
CHARGED_MIN = 0.95

_CACHE: Dict[tuple, "Spans"] = {}


@dataclass
class Spans:
    """Device seconds of the sub-window by the span that launched them."""

    # innermost span -> device seconds launched directly inside it
    self_s: Dict[str, float] = field(default_factory=dict)
    # span -> device seconds launched anywhere inside it
    under_s: Dict[str, float] = field(default_factory=dict)
    # device seconds launched outside every span (the caller's)
    caller_s: float = 0.0
    # device seconds whose launch the trace does not hold
    unmatched_s: float = 0.0
    # span -> its intervals (s) on the thread of the sub-window's mark
    intervals: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)
    names: frozenset = frozenset()

    def charged_share(self, outer: str) -> float:
        under = self.under_s.get(outer, 0.0)
        total = under + self.unmatched_s
        return under / total if total > 0 else 0.0


def charge(events, start: float, end: float) -> Spans:
    """`Spans` of the Chrome trace `events` between `start` and `end`
    (seconds; the sub-window's mark)."""
    launches: Dict[object, Tuple[tuple, float]] = {}
    annotations = defaultdict(list)
    mark_thread = None
    ops = []
    for e in events:
        if "ts" not in e:
            continue
        cat = e.get("cat")
        s = e["ts"] / 1e6
        if cat in DEVICE_CATS and "dur" in e:
            t = min(s + e["dur"] / 1e6, end)
            s = max(s, start)
            if t > s:
                ops.append(((e.get("args") or {}).get("correlation"), t - s))
        elif cat in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launches.setdefault(corr, ((e.get("pid"), e.get("tid")), s))
        elif cat == ANNOTATION and "dur" in e:
            thread = (e.get("pid"), e.get("tid"))
            if e.get("name") == MARK:
                mark_thread = thread
            else:
                annotations[thread].append(
                    (s, s + e["dur"] / 1e6, e.get("name", "?")))

    # the spans holding each launch, innermost last (one thread's
    # annotations nest, so a stack swept in time order holds them)
    held: Dict[object, List[str]] = {}
    by_thread = defaultdict(list)
    for corr, (thread, t) in launches.items():
        by_thread[thread].append((t, corr))
    for thread, items in by_thread.items():
        ann = sorted(annotations.get(thread, ()), key=lambda a: (a[0], -a[1]))
        stack, i = [], 0
        for t, corr in sorted(items, key=lambda x: x[0]):
            while i < len(ann) and ann[i][0] <= t:
                while stack and stack[-1][1] < ann[i][0]:
                    stack.pop()
                stack.append(ann[i])
                i += 1
            while stack and stack[-1][1] < t:
                stack.pop()
            held[corr] = [a[2] for a in stack]

    out = Spans()
    self_s: Dict[str, float] = defaultdict(float)
    under_s: Dict[str, float] = defaultdict(float)
    for corr, dur in ops:
        names = held.get(corr)
        if names is None:
            out.unmatched_s += dur
        elif not names:
            out.caller_s += dur
        else:
            self_s[names[-1]] += dur
            for name in set(names):
                under_s[name] += dur
    out.self_s, out.under_s = dict(self_s), dict(under_s)
    spans = defaultdict(list)
    for s, t, name in annotations.get(mark_thread, ()):
        spans[name].append((s, t))
    out.intervals = {k: sorted(v) for k, v in spans.items()}
    out.names = frozenset(a[2] for v in annotations.values() for a in v)
    return out


def _mark(events) -> Optional[Tuple[float, float]]:
    """(start, end) of the sub-window's mark, in seconds, computed as
    `benchmark.profiling.reduce_trace` computes them."""
    for e in events:
        if e.get("name") == MARK and "dur" in e and e.get("cat") in HOST_CATS:
            start = e["ts"] / 1e6
            return start, start + e["dur"] / 1e6
    return None


def load(ctx, log, out_dir: Optional[str] = None) -> Optional[Spans]:
    """The `Spans` of this run's sub-window, or None (logged why)."""
    out_dir = out_dir or OUT
    prof = ctx.get("profile")
    if prof is None:
        log("spans: no profiled sub-window")
        return None
    paths = sorted(glob.glob(os.path.join(out_dir, "*.trace.json")),
                   key=os.path.getmtime, reverse=True)
    for path in paths:
        st = os.stat(path)
        key = (path, st.st_mtime_ns, st.st_size, prof.start, prof.end)
        if key in _CACHE:
            return _CACHE[key]
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        events = trace["traceEvents"] if isinstance(trace, dict) else trace
        if _mark(events) != (prof.start, prof.end):
            continue
        sp = _CACHE[key] = charge(events, prof.start, prof.end)
        del trace, events
        batches = ctx.get("batches") or 0
        per = (1e3 / batches) if batches else 0.0
        log("spans: device ms a batch by innermost span "
            + json.dumps({k: round(v * per, 4)
                          for k, v in sorted(sp.self_s.items())})
            + f"; the caller's {sp.caller_s * per:.4f}, unmatched "
            f"{sp.unmatched_s * per:.4f} ({os.path.basename(path)})")
        return sp
    log(f"spans: no trace in {out_dir} with this sub-window's mark")
    return None


def _outer(sp: Spans, outer: str, log) -> bool:
    if outer not in sp.names:
        log(f"spans: no span {outer} was recorded")
        return False
    share = sp.charged_share(outer)
    log(f"spans: {100 * share:.2f}% of the device time under {outer} "
        "charged to a span")
    if share < CHARGED_MIN:
        log(f"spans: below {100 * CHARGED_MIN:.0f}%: nothing read")
        return False
    return True


def ms_per_batch(ctx, log, name: str, outer: str) -> Optional[float]:
    """Device ms a batch launched inside span `name` (nested spans
    included), where the device time under `outer` is charged."""
    sp = load(ctx, log)
    if sp is None or not ctx.get("batches") or not _outer(sp, outer, log):
        return None
    if name not in sp.names:
        log(f"spans: no span {name} was recorded")
        return None
    return sp.under_s.get(name, 0.0) * 1e3 / ctx["batches"]


def idle_program_pct(ctx, log, outer: str) -> Optional[float]:
    """Share of the sub-window, %, in which no device operation ran while
    the sub-window's thread was inside span `outer`."""
    sp = load(ctx, log)
    prof = ctx.get("profile")
    if sp is None or prof.window_s <= 0 or not _outer(sp, outer, log):
        return None
    spans = sp.intervals.get(outer, [])
    idle, j = 0.0, 0
    for g0, g1 in prof.gaps():
        while j < len(spans) and spans[j][1] <= g0:
            j += 1
        k = j
        while k < len(spans) and spans[k][0] < g1:
            idle += max(0.0, min(g1, spans[k][1]) - max(g0, spans[k][0]))
            k += 1
    return 100.0 * idle / prof.window_s
