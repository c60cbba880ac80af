"""A profiled sub-window of a traced run, read from torch.profiler's trace.

`SubWindow.start()` / `.stop()` bracket a few steady seconds of the
measured window (late in a long window the profiler drops kernels). The
trace is exported as Chrome JSON into `benchmark/_out/` and reduced to a
`Profile`: the device operations (kernels, copies, sets) clipped to the
sub-window, the seconds in which one ran (`busy_s`), the sub-window's
length (`window_s`), and the host operations for naming idle gaps.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")
MARK = "benchmark.subwindow"


@dataclass
class Profile:
    window_s: float
    device: List[Tuple[str, float, float, str]]   # name, start, end, cat
    host: List[Tuple[str, float, float]]          # name, start, end (s)
    start: float
    end: float

    def busy_s(self) -> float:
        """Seconds of the sub-window in which some device op ran."""
        total, reach = 0.0, self.start
        for _, s, e, _ in sorted(self.device, key=lambda x: x[1]):
            s = max(s, reach)
            if e > s:
                total += e - s
                reach = e
        return total

    def seconds_by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, s, e, _ in self.device:
            out[name] = out.get(name, 0.0) + (e - s)
        return out

    def kernels(self) -> List[Tuple[str, float]]:
        """(name, seconds) of every kernel of the sub-window."""
        return [(n, e - s) for n, s, e, c in self.device if c == "kernel"]

    def gaps(self) -> List[Tuple[float, float]]:
        out, reach = [], self.start
        for _, s, e, _ in sorted(self.device, key=lambda x: x[1]):
            if s > reach:
                out.append((reach, s))
            reach = max(reach, e)
        if self.end > reach:
            out.append((reach, self.end))
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.seconds_by_name().items(), key=lambda kv: -kv[1])
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        named = []
        for s, e in gaps:
            best, best_key = "no host op on record", (0.0, 0.0)
            for name, hs, he in self.host:
                over = min(e, he) - max(s, hs)
                key = (over, -(he - hs))
                if over > 0 and key > best_key:
                    best, best_key = name, key
            named.append(["host: " + best[:150], e - s])
        return {"device_ops": [[n[:150], v] for n, v in ops[:top]],
                "idle_gaps": named}


class SubWindow:
    """torch.profiler around part of a window, on every thread's device
    work (CUPTI records the whole process)."""

    def __init__(self, out_dir: str, tag: str):
        self.path = os.path.join(out_dir, f"{tag}.trace.json")
        self._prof = None
        self._mark = None

    @staticmethod
    def _profile():
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        try:
            cfg = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
        except TypeError:        # a PyTorch without the option
            return profile(activities=acts)
        return profile(activities=acts, experimental_config=cfg)

    def warm(self) -> None:
        """A first, empty profiling session: the profiler's first start
        in a process takes seconds (CUPTI's set-up), which must not fall
        inside the sub-window. Part of a traced run's set-up."""
        import torch

        prof = self._profile()
        prof.__enter__()
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)

    def start(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._prof = self._profile()
        self._prof.__enter__()
        self._mark = torch.profiler.record_function(MARK)
        self._mark.__enter__()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    @property
    def active(self) -> bool:
        return self._prof is not None and self._mark is not None

    def read(self) -> Optional[Profile]:
        if self._prof is None:
            return None
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        self._prof.export_chrome_trace(self.path)
        with open(self.path, encoding="utf-8") as f:
            trace = json.load(f)
        return reduce_trace(trace)


def reduce_trace(trace) -> Optional[Profile]:
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    mark = [e for e in events if e.get("name") == MARK and "dur" in e
            and e.get("cat") in HOST_CATS]
    if not mark:
        return None
    start = mark[0]["ts"] / 1e6
    end = start + mark[0]["dur"] / 1e6
    device, host = [], []
    for e in events:
        if "dur" not in e or "ts" not in e:
            continue
        s = e["ts"] / 1e6
        t = s + e["dur"] / 1e6
        if e.get("cat") in DEVICE_CATS:
            s, t = max(s, start), min(t, end)
            if t > s:
                device.append((e.get("name", "?"), s, t, e["cat"]))
        elif e.get("cat") in HOST_CATS and e.get("name") != MARK:
            if t > start and s < end:
                host.append((e.get("name", "?"), s, t))
    return Profile(end - start, device, host, start, end)


def idle_pct(ctx, log) -> Optional[float]:
    """Share of the profiled sub-window in which no device operation ran,
    %; the readers `idle_pct.<cell kind>` report it."""
    prof = ctx.get("profile")
    if prof is None or prof.window_s <= 0:
        return None
    return 100.0 * (1.0 - prof.busy_s() / prof.window_s)
