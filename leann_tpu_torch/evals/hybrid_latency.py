"""BASELINE config 4: hybrid (vector + BM25 alpha fusion + metadata
filter) end-to-end p50/p95/p99 latency on 1M chunks, measured through the
port's HTTP server and micro-batcher (port of `evals/hybrid_latency.py`).

What is measured: wall-clock per request at the client, across
concurrent client threads firing a production-shaped mix (60% plain
vector / 30% hybrid / 10% hybrid + filter `source$py`), for each batcher
window setting. The server is the port's `server/http.py` stack
(ThreadingHTTPServer + MicroBatcher + IndexSearcher) over a flat index,
so every flush runs `FlatSearcher` -> `ExactEngine`'s two-stage scan on
`--device`, then BM25 fusion, the post-filter and hydration on the host.
The clients are threads of the same process, as in the reference.

The corpus is synthetic text with a zipf word distribution (realistic
BM25 df/tf spread), embedded by the deterministic fake embedder:
embedding cost is not the object here; vector search + BM25 + fusion +
HTTP + batching is. The index is built once and cached under
`leann_tpu_torch/_artifacts/hybrid_idx_n{N}_d{D}/`; its files are the
reference's, so an index built by either package serves in the other.

    python -m leann_tpu_torch.evals.hybrid_latency --n 1000000 \\
        --clients 32 --windows 0,2,8 --duration 20
    python -m leann_tpu_torch.evals.hybrid_latency --device cpu \\
        --n 2000 --d 32 --clients 4 --duration 1 --windows 0

stdout: one JSON row per (window, mix) with p50/p95/p99/mean ms, then one
`hybrid_latency_total` row per window with QPS and errors (the
reference's keys; on the CPU each row also says `"device": "cpu"`).
stderr: build seconds by step, the card's name and power limit, and per
window the flushes, mean flush size, embed / group / ANN ms and peak
memory. Without CUDA and without `--device cpu` it prints one JSON error
line and exits 2.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

ADIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_artifacts")

MIXES = ("plain", "hybrid", "hybrid_filter")
FILTER = "source$py"


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def make_texts(n: int, seed: int = 0) -> List[str]:
    """Zipf-distributed word soup: ~20k vocab, 8-20 words per chunk."""
    rng = np.random.default_rng(seed)
    vocab_n = 20000
    vocab = np.array([f"w{i:05d}" for i in range(vocab_n)])
    # zipf ranks: p(r) ~ 1/(r+10)
    p = 1.0 / (np.arange(vocab_n) + 10.0)
    p /= p.sum()
    lens = rng.integers(8, 21, n)
    total = int(lens.sum())
    words = vocab[rng.choice(vocab_n, total, p=p)]
    texts = []
    pos = 0
    for ln in lens:
        texts.append(" ".join(words[pos : pos + ln]))
        pos += ln
    return texts


def build_index(base: str, n: int, d: int, device=None) -> Dict[str, float]:
    """The flat ip index of `n` zipf texts, fake-embedded at `d`, built
    through `StreamingIndexBuilder` in batches of 8192. Returns (and logs)
    the seconds of each step."""
    from leann_tpu_torch.embed.fake import FakeEmbedding
    from leann_tpu_torch.index.builder import StreamingIndexBuilder
    from leann_tpu_torch.store.passages import Passage
    from leann_tpu_torch.utils import METRICS

    steps: Dict[str, float] = {}
    t0 = time.perf_counter()
    texts = make_texts(n)
    steps["texts_s"] = time.perf_counter() - t0
    log(f"texts generated in {steps['texts_s']:.2f}s")
    fake = FakeEmbedding(dimensions=d)
    builder = StreamingIndexBuilder(
        base, dim=d, backend="flat", metric="ip",
        embedding_model="fake", embedding_mode="fake", device=device,
    )
    t0 = time.perf_counter()
    exts = ["py", "md", "rs", "txt"]
    batch = 8192
    for s in range(0, n, batch):
        chunk = texts[s : s + batch]
        embs = fake.embed(chunk)
        for j, (t, e) in enumerate(zip(chunk, embs)):
            i = s + j
            builder.add_passage(
                Passage(
                    id=f"c{i}",
                    text=t,
                    metadata={"source": f"src/m{i % 997}.{exts[i % 4]}"},
                ),
                e,
            )
        if s % (batch * 16) == 0:
            log(f"  embedded {s}/{n} ({time.perf_counter() - t0:.0f}s)")
    steps["embed_add_s"] = time.perf_counter() - t0
    bm25_before = len(METRICS.samples("span.build.bm25.seconds"))
    native_before = METRICS.snapshot().get(
        "bm25.build.native", {}).get("value", 0)
    t0 = time.perf_counter()
    builder.build()
    steps["build_s"] = time.perf_counter() - t0
    bm25 = METRICS.samples("span.build.bm25.seconds")[bm25_before:]
    steps["bm25_s"] = bm25[-1] if bm25 else 0.0
    steps["bm25_native"] = METRICS.snapshot().get(
        "bm25.build.native", {}).get("value", 0) > native_before
    log(json.dumps({"build": steps, "n": n, "d": d}))
    return steps


def percentile_row(lat_ms, name, window_ms, clients, extra=None):
    a = np.asarray(lat_ms)
    row = {
        "metric": "hybrid_latency",
        "mix": name,
        "window_ms": window_ms,
        "clients": clients,
        "requests": int(a.size),
        "p50_ms": round(float(np.percentile(a, 50)), 1),
        "p95_ms": round(float(np.percentile(a, 95)), 1),
        "p99_ms": round(float(np.percentile(a, 99)), 1),
        "mean_ms": round(float(a.mean()), 1),
    }
    if extra:
        row.update(extra)
    return row


def client_requests(seed: int, cid: int) -> Iterator[Tuple[str, dict]]:
    """Client `cid`'s endless request stream, (mix, POST /search body):
    2-5 query words from the zipf head and torso (w00000-w02999), the
    60 / 30 / 10 mix, drawn from `default_rng(seed * 1000 + cid)`."""
    r = np.random.default_rng(seed * 1000 + cid)
    while True:
        nw = int(r.integers(2, 6))
        q = " ".join(f"w{int(r.integers(0, 3000)):05d}" for _ in range(nw))
        roll = r.random()
        if roll < 0.6:
            yield "plain", {"query": q, "top_k": 10}
        elif roll < 0.9:
            yield "hybrid", {"query": q, "top_k": 10, "hybrid": True}
        else:
            yield "hybrid_filter", {
                "query": q, "top_k": 10, "hybrid": True, "filter": FILTER,
            }


def options_of(body: dict):
    """The `SearchOptions` the HTTP handler builds from one of these
    request bodies (`server/http.py`'s defaults for the rest)."""
    from leann_tpu_torch.index.filter import MetadataFilter
    from leann_tpu_torch.index.searcher import SearchOptions

    return SearchOptions(
        top_k=int(body.get("top_k", 5)),
        complexity=int(body.get("complexity", 64)),
        filter=(MetadataFilter.parse(str(body["filter"]))
                if body.get("filter") else None),
        hybrid=bool(body.get("hybrid", False)),
        hybrid_alpha=float(body.get("hybrid_alpha", 0.7)),
        query_text=body["query"],
    )


def filter_holds(mix: str, data: bytes) -> bool:
    """A filtered reply's hits all satisfy `source$py`; other mixes pass."""
    if mix != "hybrid_filter":
        return True
    hits = json.loads(data)["results"]
    return all(h["metadata"]["source"].endswith(".py") for h in hits)


def drive(port, clients, duration, seed=0,
          check: Optional[Callable[[str, bytes], bool]] = None):
    """Concurrent client threads; returns ({mix: [latency_ms]}, errors).
    A reply that fails `check` counts as an error, as a failed request
    does."""
    import http.client

    lats: Dict[str, List[float]] = {m: [] for m in MIXES}
    errors = [0]
    lock = threading.Lock()
    stop = time.time() + duration

    def one_client(cid):
        stream = client_requests(seed, cid)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        local: Dict[str, List[float]] = {m: [] for m in MIXES}
        while time.time() < stop:
            mix, body = next(stream)
            t0 = time.perf_counter()
            try:
                conn.request(
                    "POST", "/search", json.dumps(body),
                    {"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                if resp.status != 200:
                    raise RuntimeError(data[:200])
            except Exception as e:  # noqa: BLE001 — count and reconnect
                log(f"client {cid}: {e}")
                with lock:
                    errors[0] += 1
                conn = http.client.HTTPConnection(
                    "127.0.0.1", port, timeout=30)
                continue
            local[mix].append((time.perf_counter() - t0) * 1e3)
            if check is not None and not check(mix, data):
                log(f"client {cid}: {mix} reply fails its check")
                with lock:
                    errors[0] += 1
        conn.close()
        with lock:
            for k in lats:
                lats[k].extend(local[k])

    threads = [
        threading.Thread(target=one_client, args=(c,), daemon=True)
        for c in range(clients)
    ]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return lats, errors[0]


def flush_stats(window_ms: float, device) -> dict:
    """What the micro-batcher counted (`METRICS` `batch.*`, reset before
    the timed drive) and the peak memory, for one window."""
    import torch

    from leann_tpu_torch.utils import METRICS

    snap = METRICS.snapshot()

    def avg(name, scale=1.0):
        return snap[name]["avg"] * scale if name in snap else 0.0

    out = {
        "window_ms": window_ms,
        "flushes": int(snap.get("batch.flushes", {}).get("value", 0)),
        "flush_size_mean": avg("batch.flush_size"),
        "groups_per_flush_mean": avg("batch.groups_per_flush"),
        "embed_ms_mean": avg("batch.embed_ms"),
        "group_ms_mean": avg("batch.group_ms"),
        "ann_ms_mean": avg("span.search.ann.seconds", 1e3),
        "flush_ms_mean": avg("batch.flush_ms"),
        "host_peak_rss_mb": resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0,
    }
    if device.type == "cuda":
        out["device_peak_mb"] = torch.cuda.max_memory_allocated(device) / 2**20
    return out


def serve_windows(searcher, provider, windows: Sequence[float], port: int,
                  clients: int, duration: float, n: int, device,
                  warm_s: float = 3.0):
    """For each batcher window: a `ServerState` over `searcher`, `warm()`,
    a `warm_s` drive, the timed drive. Returns (rows, per-window flush
    stats). `port` 0 takes a free port per window."""
    import torch

    from leann_tpu_torch.server.http import ServerState, serve
    from leann_tpu_torch.utils import METRICS

    extra = {"device": "cpu"} if device.type == "cpu" else None
    rows, stats = [], []
    for window_ms in windows:
        state = ServerState(
            searcher, provider, query_template=None,
            index_name="hybrid_bench", max_batch=64,
            batch_window_ms=window_ms,
        )
        server = serve(state, port=port)
        st = threading.Thread(target=server.serve_forever, daemon=True)
        st.start()
        try:
            bound = server.server_address[1]
            # every pow-2 batch bucket searched once before timing, as
            # the reference warms its program lattice
            state.warm()
            # then a short drive to warm the host path (BM25, hydrate)
            drive(bound, clients=clients, duration=warm_s, seed=7)
            METRICS.reset()
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            lats, errs = drive(bound, clients, duration, check=filter_holds)
            for mix, vals in lats.items():
                if vals:
                    rows.append(percentile_row(vals, mix, window_ms,
                                               clients, extra))
                    print(json.dumps(rows[-1]), flush=True)
            rows.append({
                "metric": "hybrid_latency_total",
                "window_ms": window_ms,
                "clients": clients,
                "qps": round(sum(len(v) for v in lats.values()) / duration,
                             1),
                "errors": errs,
                "n": n,
                **(extra or {}),
            })
            print(json.dumps(rows[-1]), flush=True)
            stats.append(flush_stats(window_ms, device))
            log(json.dumps({"flush_stats": stats[-1]}))
        finally:
            server.shutdown()
            st.join()
            server.server_close()
            state.batcher.close()
        if port:
            port += 1
    return rows, stats


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m leann_tpu_torch.evals.hybrid_latency")
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--d", type=int, default=128)
    ap.add_argument("--clients", type=int, default=32)
    ap.add_argument("--duration", type=float, default=20.0)
    ap.add_argument("--windows", default="0,2,8")
    ap.add_argument("--port", type=int, default=8931)
    ap.add_argument("--build-only", action="store_true")
    ap.add_argument("--device",
                    default=os.environ.get("LEANN_TORCH_DEVICE") or "cuda")
    args = ap.parse_args(argv)

    from leann_tpu_torch.device import resolve_device

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(json.dumps({"metric": "hybrid_latency",
                          "error": f"CUDA unavailable ({e})"}), flush=True)
        return 2
    from leann_tpu_torch.bench import card

    log(f"device: {dev} ({card() if dev.type == 'cuda' else 'host CPU'})")

    idx_dir = os.path.join(ADIR, f"hybrid_idx_n{args.n}_d{args.d}")
    base = os.path.join(idx_dir, "documents.leann")
    if not os.path.exists(base + ".meta.json"):
        os.makedirs(idx_dir, exist_ok=True)
        build_index(base, args.n, args.d, device=dev)
    if args.build_only:
        return 0

    from leann_tpu_torch.embed import EmbeddingProvider
    from leann_tpu_torch.index.searcher import IndexSearcher

    t0 = time.perf_counter()
    provider = EmbeddingProvider(mode="fake", dimensions=args.d)
    searcher = IndexSearcher(base, device=dev)
    # first use of the engine before timing
    qv = provider.embed(["w00001 w00002"])
    searcher.search(qv[0])
    log(f"index loaded and searched once in {time.perf_counter() - t0:.2f}s")

    windows = [float(w) for w in args.windows.split(",")]
    serve_windows(searcher, provider, windows, args.port, args.clients,
                  args.duration, args.n, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
