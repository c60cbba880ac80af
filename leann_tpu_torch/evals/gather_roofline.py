"""Random row-gather roofline: PyTorch's gather + product against the
CUDA kernel `gather_score` (port of `evals/gather_roofline.py`).

The decision this measures: a pointer-gather graph traversal (one shared
int8 corpus plus adjacency, no inline neighbour records) fetches B*R
random corpus rows per hop. Its ceiling is the random-row-gather
throughput measured here; the inline-record engines (`ops/fused_beam.py`,
`ops/pq_beam.py`) avoid those gathers at the price of duplicated
payloads.

Both engines run the identical op, scores[b, j] = <q_b, corpus[ids[b, j]]>,
over an [N, 128] int8 corpus resident in device memory, with uniform
random ids: the access pattern of a traversal past its first hops.

Upper-bound caveat: ids are known before each call, so calls overlap on
the device; a traversal pointer-chases (hop i+1 depends on hop i) and
hides less. Read the kernel's number as the optimistic bound and its
ratio to the plain gather as the signal.

    python -m leann_tpu_torch.evals.gather_roofline --n 10000000 --b 2048 --r 48
    python -m leann_tpu_torch.evals.gather_roofline --n 1000000 --m-scan 100

One JSON line per engine (`torch` = the plain gather + product, `cuda` =
the kernel): rows/s, effective GB/s, and the derived traversal-QPS
ceiling at R x hops rows per query, by two timers over `--m-scan` calls
per window on distinct ids. `per_call_ms` (`window_ms`): CUDA events
around the window's calls queued behind other device work, so that the
host's launch latency stays outside it; the device's own gap between
back-to-back launches stays inside. `per_call_graph_ms`
(`graph_window_ms`): the window's calls captured once in a CUDA graph
and its replays timed by CUDA events, the counterpart of the
reference's one dispatch of a `lax.scan` over the calls
(`evals/gather_roofline.py:97-107`). On the CPU only the host clock
runs (`timer` says `host_clock`), which says nothing of a card.
`window_trace` profiles one queued window and splits its time into
the kernels' own durations and the idle gaps between them.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import List, Sequence

import numpy as np
import torch

from leann_tpu_torch.device import DeviceLike, resolve_device
from leann_tpu_torch.ops.gather_score import gather_score, gather_score_plain

ENGINES = {"torch": gather_score_plain, "cuda": gather_score}


def log(m):
    print(m, file=sys.stderr, flush=True)


def make_corpus(n: int, d: int, gen: torch.Generator, device,
                chunk: int = 1 << 22) -> torch.Tensor:
    """[n, d] int8 uniform in [-128, 127], drawn on `device` in row
    chunks (no host copy, no 64-bit temporary of the whole corpus)."""
    out = torch.empty((n, d), dtype=torch.int8, device=device)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        out[s:e] = torch.randint(-128, 128, (e - s, d), generator=gen,
                                 device=device, dtype=torch.int8)
    return out


def window_ms(fn, ids_window, dev) -> float:
    """Milliseconds of fn over every [B, R] id block of one window. On
    the card the window is queued behind ~40 ms of other device work (two
    large float32 products), so the host has queued every call before the
    first one starts: the CUDA events then bracket the calls' device time
    back to back, without the host's launch latency in between (what the
    reference's `lax.scan` over the calls is for)."""
    if dev.type == "cuda":
        stall = torch.empty((8192, 8192), device=dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.mm(torch.mm(stall, stall), stall)
        start.record()
        for ids in ids_window:
            fn(ids)
        end.record()
        torch.cuda.synchronize(dev)
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    for ids in ids_window:
        fn(ids)
    return (time.perf_counter() - t0) * 1e3


def graph_window_ms(fn, ids_windows, dev, reps: int) -> List[float]:
    """Milliseconds of fn over every [B, R] id block of a window, each
    window's calls captured once in a CUDA graph; `reps` replays, the
    windows in turn, each timed by CUDA events. A replay launches the
    calls back to back from the device's own queue, with no host launch
    between them (fn must have run once before, outside the capture)."""
    graphs = []
    for ids_window in ids_windows:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for ids in ids_window:
                fn(ids)
        graphs.append(g)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for g in graphs:                                           # warm
        g.replay()
    times = []
    for i in range(reps):
        start.record()
        graphs[i % len(graphs)].replay()
        end.record()
        torch.cuda.synchronize(dev)
        times.append(start.elapsed_time(end))
    return times


def window_trace(fn, ids_window, dev, name: str) -> dict:
    """One queued window (`window_ms`) under torch.profiler: from the
    trace's kernel events, the mean, least and largest duration of the
    kernels whose name holds `name`, the mean idle gap between two of
    them, their span per call, and the gap between the stall's last
    kernel and the first call. Per call, `span_per_call_us` =
    `kernel_us` + `gap_us`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        ms = window_ms(fn, ids_window, dev)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    finally:
        os.remove(path)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    kernels = sorted((e for e in events if e.get("cat") == "kernel"),
                     key=lambda e: e["ts"])
    mine = [e for e in kernels if name in e["name"]]
    if not mine:
        raise AssertionError(f"no {name} kernel in the window's trace")
    dur = [e["dur"] for e in mine]
    gaps = [b["ts"] - (a["ts"] + a["dur"]) for a, b in zip(mine, mine[1:])]
    before = [e["ts"] + e["dur"] for e in kernels
              if name not in e["name"] and e["ts"] < mine[0]["ts"]]
    span = mine[-1]["ts"] + mine[-1]["dur"] - mine[0]["ts"]
    return {"calls": len(mine), "window_ms": ms,
            "kernel_us": sum(dur) / len(dur), "kernel_min_us": min(dur),
            "kernel_max_us": max(dur),
            "gap_us": sum(gaps) / max(1, len(gaps)),
            "gap_max_us": max(gaps, default=0.0),
            "span_per_call_us": span / len(mine),
            "first_after_stall_us": (mine[0]["ts"] - max(before)
                                     if before else None)}


def run(
    n: int = 10_000_000,
    b: int = 2048,
    r: int = 48,
    m_scan: int = 50,
    reps: int = 30,
    hops: int = 120,
    engines: Sequence[str] = ("torch", "cuda"),
    d: int = 128,
    seed: int = 0,
    device: DeviceLike = None,
    corpus: torch.Tensor = None,
) -> List[dict]:
    """One row per engine (the reference's keys: per_call_ms,
    per_call_std_ms, rows_per_s, eff_gb_s, traversal_qps_ceiling; on a
    card also the graph timer's per_call_graph_ms, per_call_graph_std_ms,
    rows_per_s_graph, eff_gb_s_graph and traversal_qps_ceiling_graph).
    Each engine's first call of the first window is held against the
    plain version within 1e-5 x |q| x (largest gathered row norm); a
    disagreement raises. `corpus` reuses an [n, d] int8 tensor already on
    the device."""
    dev = resolve_device(device)
    for e in engines:
        if e not in ENGINES:
            raise ValueError(f"unknown engine {e!r}; expected one of "
                             f"{sorted(ENGINES)}")
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    if corpus is None:
        corpus = make_corpus(n, d, gen, dev)
    elif corpus.shape != (n, d) or corpus.device.type != dev.type:
        raise ValueError(f"corpus must be [{n}, {d}] on {dev}")
    queries = torch.randn((b, d), generator=gen, device=dev)
    # distinct ids per call and per timed window
    windows = [torch.randint(0, n, (m_scan, b, r), generator=gen, device=dev,
                             dtype=torch.int32)
               for _ in range(min(4, reps))]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    log(f"corpus [{n}, {d}] int8 on {dev} in {time.perf_counter() - t0:.1f}s "
        f"({n * d / 1e9:.2f} GB)")

    first = windows[0][0]
    want = gather_score_plain(corpus, first, queries)
    row_norm = float(corpus[first.long()].float().norm(dim=2).max())
    tol = 1e-5 * float(queries.norm(dim=1).max()) * row_norm
    device_name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu")
    rows = []
    for engine in engines:
        fn = ENGINES[engine]
        call = lambda ids: fn(corpus, ids, queries)
        got = call(first)
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(
                f"gather-{engine} disagrees with the plain version: max "
                f"|err| {err} > {tol}")
        window_ms(call, windows[0], dev)                       # warm
        times = [window_ms(call, windows[i % len(windows)], dev)
                 for i in range(reps)]
        row = {"engine": f"gather-{engine}", "n": n, "d": d, "b": b,
               "r": r, "m_scan": m_scan, "reps": reps,
               **_rates(times, "", m_scan, b, r, d, hops)}
        if dev.type == "cuda":
            row.update(_rates(graph_window_ms(call, windows, dev, reps),
                              "_graph", m_scan, b, r, d, hops))
        rows.append({
            **row, "max_abs_err": err, "tol": tol,
            "bit_equal": bool(torch.equal(got, want)),
            "device": device_name,
            "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        })
    return rows


def _rates(times_ms, suffix, m_scan, b, r, d, hops) -> dict:
    """per_call_ms / per_call_std_ms / rows_per_s / eff_gb_s /
    traversal_qps_ceiling from window times (each key + `suffix`)."""
    per_call = float(np.mean(times_ms)) / m_scan / 1e3
    std_call = float(np.std(times_ms)) / m_scan / 1e3
    rows_s = b * r / per_call
    return {
        f"per_call{suffix}_ms": per_call * 1e3,
        f"per_call{suffix}_std_ms": std_call * 1e3,
        f"rows_per_s{suffix}": round(rows_s),
        f"eff_gb_s{suffix}": round(rows_s * d / 1e9, 2),
        # a traversal batch needs `hops` sequential gathers of B*R
        f"traversal_qps_ceiling{suffix}": round(rows_s / (r * hops)),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--b", type=int, default=2048)
    ap.add_argument("--r", type=int, default=48)
    ap.add_argument("--m-scan", type=int, default=50,
                    help="calls per timed CUDA-event window")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--hops", type=int, default=120,
                    help="hops assumed for the traversal-QPS ceiling")
    ap.add_argument("--engines", default="torch,cuda")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for row in run(n=args.n, b=args.b, r=args.r, m_scan=args.m_scan,
                   reps=args.reps, hops=args.hops,
                   engines=args.engines.split(","), device=args.device):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
