"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives `leann_tpu_torch`'s main paths through the entry points a user
calls (Vamana build -> fused graph search at D % 128 == 0; Vamana build
-> PQ graph search at 96-d; IVF build -> bf16 bucket search; the
residual-int8 IVF serving tier and the IVF-PQ tier at 10M x 96; the
row-gather roofline; the BERT encoder at bert-base widths and `entry()`),
builds the CUDA kernels from
`leann_tpu_torch/csrc/` (one nvcc per source, all started together), and
holds each against its plain PyTorch version. Phases, one JSON line each
on stdout:

  env      torch / CUDA / nvcc versions, the card's name and power limit
  build    nvcc build of the kernel libraries (seconds)
  kernels  fused_beam_search (CUDA) vs fused_beam_search_plain on the
           card, exactly (ids, scores, visited log, and the counts of
           hops merged by the bitonic network because scores tied):
           N=4096, D=128, R=48, L=64, E in {1, 2}, l2 and ip, an odd
           batch with `exclude`, track_visited in {0, 160}; each row
           with the slow-merge share, CTAs per SM and the time of the
           earlier design (`ms_pr4`);
           pq_beam_search vs pq_beam_search_plain: N=4096, R=48, L=64,
           B=1023 with `exclude`, ksub 16 and 256, l2 and ip, E 1 and
           2, visited log 0 and 256, m=16 at D=96, m=64 at D=768, and a
           residual case (coarse_m=2, m=12, l2 norm columns); each row
           with CTAs per SM, the settle pass's queries and empty merges,
           and the earlier design's time (`ms_pr6`: its source
           `csrc/pq_beam_scan.cu`, built beside, timed in turns);
           ivf_bucket_dots and ivf8_bucket_scores vs their plain versions
           on small grids: D of 96, 128, 768 (16-byte copies) and 24 / 20
           (single elements), caps not multiples of 32, odd batches,
           empty (-1) slots, a probe list that repeats one bucket; l2
           and ip for ivf8; each row with a repeat (equal bits), the
           earlier design (one CTA per (query, probe): its sources
           `csrc/ivf_bucket_dots_pairs.cu` / `ivf8_scan_pairs.cu`, built
           beside) held to the same tolerance and timed in turns
           (`ms_pr3`), the reuse (distinct buckets, queries per bucket),
           the work items and CTAs per SM;
           gather_score vs gather_score_plain: D of 96, 128, 64 (16-byte
           loads), 100 (4-byte) and 50 (single bytes), R of 48, 128, 7
           and 200, odd batches, duplicate ids and the rows 0 and N-1
  rag      StreamingIndexBuilder over 20,000 fake-embedded 768-d
           passages (backend hnsw, R=32, L=64, ip), then
           IndexSearcher.search on 256 passage texts at complexity 64
           and 1024: self-hit@1 and recall@10 against the exact engine
  sift     a 128-d l2 mixture corpus (1024 clusters, seed 0), Vamana
           R=48 L=80 alpha 1.2 wave 8192, graph saved and reloaded,
           FusedBeamEngine at beam 64: recall@10 on 1024 queries and
           device QPS at batch 2048 timed with CUDA events
  deep     BASELINE config 2 (DEEP, 96-d l2) cut to 1M: a corpus of 16-d
           latent clusters plus 0.05 ambient noise (1024 clusters, seed
           0), Vamana R=48 L=80 alpha 1.2 wave 8192, graph saved and
           reloaded; GraphSearcher must pick PqBeamEngine by itself
           (m=16, ksub=256, bf16 rescore) and save the `.pq.npz`
           sidecar, which a second GraphSearcher loads without
           retraining; recall@10 on 1024 queries at beam 64 and
           DEEP_BEAM, beside the same graph's recall on exact f32
           scores; device QPS at batch 2048 and a torch.profiler
           breakdown of one batch at both beams
  ivf      BASELINE config 1 / bench.py's IVF config: the sift mixture
           at 1M x 128 l2, IvfEngine(n_clusters=2000), nprobe 8:
           recall@10 on 1024 queries of `search` (torch scan) and
           `search_pallas` (kernel ivf_bucket_dots), device QPS of both
           at batch 2048 by CUDA events, a profile of one window each
  ivf8     BASELINE config 2 at its full scale: the same mixture at
           10M x 96 l2, k-means (two runs of its first iteration on a 1M
           slice must give the same bits), IvfInt8Engine(n_clusters=6324),
           nprobe 8, with
           LEANN_IVF8_PALLAS=1 (kernel ivf8_bucket_scores) and without
           (torch scan): recall@10 on 1024 queries, device QPS at batches
           512 and 2048, calibrate_nprobe(0.95), a profile of each path
  gather   `evals.gather_roofline.run` at the reference's default shape:
           a 10M x 128 int8 corpus made on the card, B=2048, R=48, 50
           calls per CUDA-event window on distinct ids; the plain gather
           + product and kernel gather_score: rows/s, effective GB/s, the
           traversal-QPS ceiling; each held against the plain version on
           the window's first call
  ivfpq    `evals/ivfpq_device_check.py`'s configuration on the ivf8
           phase's corpus, centers and assignment: IvfPqEngine(m=16,
           ksub=256, rescore="int8") at 10M x 96 l2, nprobe 16,
           rescore_factor 16: build seconds by step, bytes of codes, norms
           and the int8 corpus, recall@10 on 1024 queries, device QPS at
           batch 2048, a profile of one window, calibrate_nprobe(0.95);
           then IvfSearcher under LEANN_IVF_ENGINE=pq over the ivf phase's
           1M x 128 corpus and centers (it must pick IvfPqEngine with the
           f32 rescore): recall@10 at nprobe 8 beside the ivf phase's. No
           kernel may launch (the scan is plain PyTorch, as the
           reference's is XLA)
  rag_ivf  the rag phase's 20,000 passages built with backend "ivf" (ip)
           through StreamingIndexBuilder: the meta's calibrated nprobe,
           then IndexSearcher.search on 256 passage texts: self-hit@1 and
           recall@10 against exact at that nprobe; no kernel may launch
           (IvfSearcher serves the torch scan, as the reference's serves
           XLA's)
  encode   BertEncoder(BertConfig()) at the published bert-base widths
           (768 hidden, 12 layers, 12 heads, 3072, vocab 30522) with
           seeded random weights and the hash tokenizer: the rag phase's
           20,000 texts through LocalEmbedding at batch 128 (texts/s, ms
           per batch by CUDA events), the bf16 run against the float32
           run on 256 texts, the bf16 product with a float32 result
           against the widened float32 product; the rag index built from
           these vectors (backend hnsw) and searched with 256 encoded
           passage texts: self-hit@1 and recall@10 beside the fake
           embedder's; then `entry()` on the card against its CPU run
  kernels_main
           each kernel vs its plain version at every shape the main
           paths launched it with: fused_beam_search at rag build (D=768,
           R=32, ip, L=64, visited log 128), rag search at L=64 and
           L=1024, sift build (1M, L=80, visited log 160) and sift search
           (1M, B=2048); pq_beam_search at deep search (1M, B=2048, beam
           64 and DEEP_BEAM); ivf_bucket_dots at the ivf phase's search
           (B=2048, nprobe 8) and ivf8_bucket_scores at the ivf8 phase's
           (B=512 and 2048, and a hot case: B=2048 with every query
           probing the 8 most-probed buckets); gather_score at the
           gather phase's (10M x 128, B=2048, R=48, distinct ids per
           call); each timed beside
           its bound, the bucket kernels also beside torch.bmm over
           buckets gathered beforehand, gather_score beside `corpus[ids]`
           + torch.bmm in bf16, both inside the timed window

The counts of kernel launches are set to 0 just before each main-path
phase (rag, sift, deep, ivf, ivf8, gather, ivfpq, rag_ivf, encode) and
read just after it. Any failure exits
non-zero with no `ok` line. The last lines are the kernel table, the
card's `nvidia-smi` name and power limit, and {"ok": true, "device": ...}.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores

# Fake embeddings are i.i.d. uniform on the 768-d sphere: no text is
# nearer any other than chance, the hardest case for a graph index. At
# the CLI's default complexity 64 recall@10 is ~0.68 (the JAX reference
# reaches the same on this corpus); the phase holds that operating point
# to 0.66 and searches again at 1024, the smallest power of two that
# clears 0.95 on this corpus.
RAG_COMPLEXITY = 1024
RAG_MIN_RECALL_64 = 0.66
RAG_N = 20_000        # BASELINE config 0: a 20k-chunk 768-d corpus
SIFT_N = 1_000_000    # bench.py / BASELINE config 1: SIFT-1M scale
# BASELINE config 2 is DEEP-10M (96-d); cut to 1M for the build's time
DEEP_N = 1_000_000
# No beam of 96 / 128 / 192 / 256 cleared recall@10 0.95 on the deep
# corpus on the first card run (0.6918 / 0.7482 / 0.8450 / 0.8899; 0.5636
# at 64). The phase searches at the largest and holds both beams to the
# measured values less 0.02 (PERF.md, ROADMAP Queue C).
DEEP_BEAM = 256
DEEP_MIN_RECALL = 0.87
DEEP_MIN_RECALL_64 = 0.54
IVF_N = 1_000_000     # BASELINE config 1 / bench.py's IVF config
IVF_CLUSTERS = 2000
IVF8_N = 10_000_000   # BASELINE config 2 at full scale: DEEP-10M, 96-d
IVF8_CLUSTERS = 6324  # 2 * sqrt(N), the engine's default
NPROBE = 8
IVF_MIN_RECALL = 0.95
IVF8_MIN_RECALL = 0.924  # the first card run (0.9444) less 0.02
RAG_IVF_MIN_RECALL = 0.9
GATHER_N = 10_000_000  # the roofline's default corpus: 10M x 128 int8
IVFPQ_NPROBE = 16      # evals/ivfpq_device_check.py's defaults
IVFPQ_RESCORE_FACTOR = 16
# the first card run's recall@10 less 0.02: 0.8720 at 10M x 96 (nprobe 16,
# the ADC top-160 is the loss) and 0.8810 through IvfSearcher at 1M x 128
IVFPQ_MIN_RECALL = 0.852
IVFPQ_1M_MIN_RECALL = 0.861
# the rag index on the encoder's vectors: the first card run gave self-hit@1
# 1.0 and recall@10 0.9992 at complexity 1024
ENCODE_MIN_HIT1 = 0.99
ENCODE_MIN_RECALL = 0.979

FUSED = dict(
    name="fused_beam_search",
    route="cuda",
    source="leann_tpu_torch/csrc/fused_beam.cu",
    replaces="leann_tpu/ops/fused_beam.py:269",
)
PQ = dict(
    name="pq_beam_search",
    route="cuda",
    source="leann_tpu_torch/csrc/pq_beam.cu",
    replaces="leann_tpu/ops/pq_beam.py:180",
)
DOTS = dict(
    name="ivf_bucket_dots",
    route="cuda",
    source="leann_tpu_torch/csrc/ivf_bucket_dots.cu",
    replaces="leann_tpu/ops/pallas_kernels.py:92",
)
IVF8 = dict(
    name="ivf8_bucket_scores",
    route="cuda",
    source="leann_tpu_torch/csrc/ivf8_scan.cu",
    replaces="leann_tpu/ops/pallas_kernels.py:167",
)
GATHER = dict(
    name="gather_score",
    route="cuda",
    source="leann_tpu_torch/csrc/gather_score.cu",
    replaces="leann_tpu/ops/gather_score.py:48",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_lowdim(rng, rows, d, k, clusters, ambient=0.05):
    """Clusters + unit within-cluster noise confined to a random K-dim
    subspace of R^d, plus small full-rank ambient noise (the generator of
    evals/pq_lowdim_sim.py: descriptor corpora such as DEEP sit near
    low-dimensional manifolds, which is what lets 8-bit PQ navigate)."""
    basis, _ = np.linalg.qr(rng.standard_normal((d, k)))
    centers = 4.0 * rng.standard_normal((clusters, k))
    assign = rng.integers(0, clusters, rows)
    lat = centers[assign] + rng.standard_normal((rows, k))
    x = lat @ basis.T + ambient * rng.standard_normal((rows, d))
    return np.ascontiguousarray(x, dtype=np.float32)


def make_corpus(rng, n, d, clusters=1024, chunk=1 << 20):
    """bench.py's mixture: `clusters` centers at 4x unit normal plus unit
    noise. The noise is drawn in row chunks: the same stream as one draw,
    without a float64 temporary of the whole corpus (7.7 GB at 10M x 96)."""
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, n)
    out = np.empty((n, d), np.float32)
    for s in range(0, n, chunk):
        e = min(n, s + chunk)
        out[s:e] = centers[assign[s:e]] + rng.standard_normal(
            (e - s, d)).astype(np.float32)
    return out


def noisy_rows(corpus, shape, seed):
    """[*shape, D] device-ready queries: corpus rows plus unit noise."""
    g = np.random.default_rng(seed)
    m = int(np.prod(shape))
    x = corpus[g.integers(0, len(corpus), m)] + g.standard_normal(
        (m, corpus.shape[1])).astype(np.float32)
    return x.reshape(*shape, corpus.shape[1])


class env_var:
    """Set one environment variable inside a with-block (None unsets)."""

    def __init__(self, name, value):
        self.name, self.value = name, value

    def __enter__(self):
        self.old = os.environ.pop(self.name, None)
        if self.value is not None:
            os.environ[self.name] = self.value

    def __exit__(self, *exc):
        os.environ.pop(self.name, None)
        if self.old is not None:
            os.environ[self.name] = self.old


def recall_at(idx, oracle, k=10):
    return float(np.mean([
        len(set(a[:k].tolist()) & set(b[:k].tolist())) / k
        for a, b in zip(np.asarray(idx), np.asarray(oracle))
    ]))


def cuda_ms(fn, reps):
    """(mean device milliseconds of fn() over reps by CUDA events, the
    last call's result)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps, out


def profile(torch, fn, top=6):
    """Device time of one fn() by torch.profiler: busy ms (the sum of
    the kernels' own device time), wall ms of the profiled call ending in
    a synchronize (profiling adds host overhead, so the idle share is an
    upper bound), and the `top` kernels by device ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ms = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:   # kernels and copies
            key = ev.key[:60]
            ms[key] = ms.get(key, 0.0) + ev.device_time_total / 1e3
    busy = sum(ms.values())
    return {"busy_ms": busy, "wall_ms": wall_ms,
            "idle_share": max(0.0, 1.0 - busy / wall_ms),
            "kernels_ms": dict(sorted(ms.items(), key=lambda kv: -kv[1])[:top])}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


# ------------------------------------------------- kernel vs plain version


def kernel_bound(kw):
    """(bound ms, "bytes" or "operations", active expansions) of one
    fused_beam_search call. Counts what this call's data needs: each
    expanded record's R live lanes read once (R*D int8 + ids, scales and
    |v|^2, 3*R*4 bytes), queries, seeds and exclude read once, beam ids +
    scores and the visited log written once; 2*R*D fp32 operations per
    expansion. The expansions are counted by rerunning the kernel with a
    visited log long enough for every hop."""
    from leann_tpu_torch.ops import fused_beam as fb

    e = kw["expansions"]
    vlog = fb.fused_beam_search(
        **dict(kw, track_visited=kw["max_iters"] * e))[2]
    expansions = int((vlog != kw["blocks_i8"].shape[0] - 1).sum())
    b, d = kw["queries"].shape
    r, s = kw["r"], kw["seed_ids"].shape[1]
    vt = -(-kw["track_visited"] // 128) * 128
    bytes_ = (expansions * (r * d + 3 * r * 4) + b * (d * 4 + s * 8 + 4)
              + b * (kw["beam_width"] * 8 + vt * 4))
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * expansions * r * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", expansions)


# B1's device ms per case in its earlier design (a bitonic merge on every
# hop, admission by scans), one NVIDIA H100 80GB HBM3 at 700 W (PERF.md
# section 6): the main-path cases from that design's proof run, the
# N=4096 grid from its source timed beside the current kernel
B1_MS_BEFORE = {
    "l2/E2/tv160": 2.367, "l2/E1/tv0": 3.004, "ip/E2/tv0": 2.424,
    "ip/E1/tv160": 3.046, "l2/E2/tv0": 2.358, "ip/E2/tv160": 2.424,
    "rag build": 2.014, "rag search L64": 1.343, "rag search L1024": 51.45,
    "sift build": 10.673, "sift search": 5.365,
}


def check_case(torch, label, kw, reps):
    """One kernel-vs-plain comparison on the card, with the kernel's and
    the plain version's device ms (the plain version counting its slow
    merges), the bound and the earlier design's time. Raises unless ids, scores and the visited log are equal exactly
    and the kernel's slow merges (hops merged by the bitonic network
    because scores tied) and active hops equal the plain version's
    counts."""
    from leann_tpu_torch.ops import fused_beam as fb

    got = fb.fused_beam_search(**kw, merge_stats=True)
    plain_ms, ref = cuda_ms(
        lambda: fb.fused_beam_search_plain(**kw, merge_stats=True), 1)
    equal = len(got) == len(ref) and all(
        bool(torch.equal(a, r)) for a, r in zip(got, ref))
    same = got[0] == ref[0]
    both = same & torch.isfinite(ref[1])
    err = float((got[1] - ref[1]).abs()[both].max()) if bool(both.any()) else 0.0
    vlog_eq = (float((got[2] == ref[2]).float().mean())
               if kw["track_visited"] else 1.0)
    slow, hops = (int(t.sum()) for t in got[-2:])
    ms, _ = cuda_ms(lambda: fb.fused_beam_search(**kw), reps)
    bound_ms, bound_by, expansions = kernel_bound(kw)
    b, d = kw["queries"].shape
    row = {"case": label, "b": b, "d": d, "r": kw["r"],
           "l": kw["beam_width"], "e": kw["expansions"],
           "metric": kw["metric"], "track_visited": kw["track_visited"],
           "n": kw["blocks_i8"].shape[0] - 1,
           "ids_equal": float(same.float().mean()), "all_equal": equal,
           "max_abs_err": err, "vlog_equal": vlog_eq, "ms": ms,
           "ms_pr4": B1_MS_BEFORE[label], "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "expansions": expansions, "hops": hops, "slow_merges": slow,
           "slow_merge_share": slow / max(1, hops),
           "ctas_per_sm": fb.ctas_per_sm(
               d, kw["r"], kw["beam_width"], kw["expansions"],
               kw.get("ring_size", 1024), kw["track_visited"])}
    if not equal:
        raise AssertionError(f"fused_beam_search disagrees with its plain "
                             f"version: {json.dumps(row)}")
    return row


def pq_bound(kw):
    """(bound ms, "bytes" or "operations", expansions, active hops per
    query) of one pq_beam_search call. Counts what this call's data
    needs: each expanded record's R id lanes and its m*lps code words read
    once (4 bytes each), the LUTs, seeds and exclude read once, beam ids +
    scores and the visited log written once; R*m fp32 adds per expansion.
    The expansions are counted by rerunning the kernel with a visited log
    long enough for every hop (it then never wraps); a hop is active when
    its first slot holds a node."""
    from leann_tpu_torch.ops import pq_beam as pb

    e = kw["expansions"]
    vlog = pb.pq_beam_search(
        **dict(kw, track_visited=kw["max_iters"] * e))[2]
    expansions = int((vlog != kw["records"].shape[0] - 1).sum())
    hops = (vlog[:, : kw["max_iters"] * e : e]
            != kw["records"].shape[0] - 1).sum(1)
    b, mk = kw["luts"].shape
    r, m, s = kw["r"], kw["m"], kw["seed_ids"].shape[1]
    lps = r // (32 // kw["bits"])
    vt = -(-kw["track_visited"] // 128) * 128
    bytes_ = (expansions * (r + m * lps) * 4 + b * (mk * 4 + s * 8 + 4)
              + b * (kw["beam_width"] * 8 + vt * 4))
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = expansions * r * m / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations", expansions, hops)


def pq_scan_search(torch, kw):
    """pq_beam_search's arguments through B3's earlier design
    (`csrc/pq_beam_scan.cu`, the same C interface): the yardstick the
    current kernel is timed against."""
    import ctypes

    from leann_tpu_torch.ops import _cuda
    from leann_tpu_torch.ops import pq_beam as pb

    lib = _cuda.load("pq_beam_scan")
    luts, rec = kw["luts"], kw["records"]
    b, e, l = luts.shape[0], kw["expansions"], kw["beam_width"]
    _, p2, v, vt = pb._sizes(l, e, kw["ring_size"], kw["track_visited"])
    slots = pb.pq_layout(kw["r"], kw["m"], kw["bits"])[2]
    out = [torch.empty((b, l), dtype=dt, device=luts.device)
           for dt in (torch.int32, torch.float32)]
    vlog = torch.empty((b, max(vt, 1)), dtype=torch.int32, device=luts.device)
    hops = torch.empty((b,), dtype=torch.int32, device=luts.device)
    err = lib.leann_pq_beam_search(
        *(kw[k].data_ptr() for k in ("luts", "records", "seed_ids",
                                     "seed_scores", "exclude")),
        out[0].data_ptr(), out[1].data_ptr(), vlog.data_ptr() if vt else None,
        hops.data_ptr(), (ctypes.c_int * kw["m"])(
            *(pj * pb.LANES + off for pj, off in slots)),
        b, kw["r"], kw["m"], kw["ksub"], kw["bits"], rec.shape[1],
        kw["seed_ids"].shape[1], l, e, p2, v, vt, kw["max_iters"], kw["qb"],
        rec.shape[0] - 1, torch.cuda.current_stream(luts.device).cuda_stream)
    _cuda.check(lib, err, "pq_beam_scan")
    return (*out, vlog) if vt else tuple(out)


def check_case_pq(torch, label, kw, reps):
    """pq_beam_search vs pq_beam_search_plain on the card: ids, scores
    and visited log equal exactly (the plain version reproduces the
    kernel's roundings and query groups), with both device ms, the bound,
    CTAs per SM, the settle pass's work (queries whose group stayed active
    after they converged and whose beam holds a tie, and the empty merges
    they take), and the earlier design's ms, timed in turns with the
    kernel (earlier, current, current, earlier). Raises on any difference
    of the kernel."""
    from leann_tpu_torch.ops import pq_beam as pb

    got = pb.pq_beam_search(**kw)
    plain_ms, ref = cuda_ms(lambda: pb.pq_beam_search_plain(**kw), 1)
    equal = [bool(torch.equal(a, b)) for a, b in zip(got, ref)]
    same = got[0] == ref[0]
    both = same & torch.isfinite(ref[1])
    err = float((got[1] - ref[1]).abs()[both].max()) if bool(both.any()) else 0.0
    before = pq_scan_search(torch, kw)
    equal_before = all(bool(torch.equal(a, b)) for a, b in zip(before, ref))
    turns = {"current": [], "earlier": []}
    for which in ("earlier", "current", "current", "earlier"):
        fn = ((lambda: pb.pq_beam_search(**kw)) if which == "current"
              else (lambda: pq_scan_search(torch, kw)))
        turns[which].append(cuda_ms(fn, reps)[0])
    ms = float(np.mean(turns["current"]))
    bound_ms, bound_by, expansions, hops = pq_bound(kw)
    b, mk = kw["luts"].shape
    sc = got[1]
    live = torch.isfinite(sc[:, 1:]) & torch.isfinite(sc[:, :-1])
    ties = (sc[:, 1:] == sc[:, :-1]) & live
    tie_share = float(ties.sum() / max(1, int(live.sum())))
    qb = kw["qb"]
    group = torch.cat([hops, hops.new_zeros(-b % qb)]).reshape(-1, qb)
    idle = group.amax(1).repeat_interleave(qb)[:b] - hops
    settled = (idle > 0) & ties.any(1)
    row = {"case": label, "b": b, "r": kw["r"], "m": kw["m"],
           "ksub": kw["ksub"], "l": kw["beam_width"], "e": kw["expansions"],
           "track_visited": kw["track_visited"], "qb": kw["qb"],
           "n": kw["records"].shape[0] - 1,
           "ids_equal": float(same.float().mean()), "all_equal": all(equal),
           "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "expansions": expansions, "beam_tie_share": tie_share,
           "ms_turns": turns["current"],
           "ms_pr6": float(np.mean(turns["earlier"])),
           "earlier_turns": turns["earlier"], "earlier_equal": equal_before,
           "settle_queries": int(settled.sum()),
           "settle_empty_merges": int(idle[settled].sum()),
           "ctas_per_sm": pb.ctas_per_sm(
               kw["m"], kw["ksub"], kw["records"].shape[1],
               kw["beam_width"], kw["expansions"], kw["ring_size"],
               kw["track_visited"])}
    if not all(equal) or len(got) != len(ref):
        raise AssertionError(f"pq_beam_search disagrees with its plain "
                             f"version: {json.dumps(row)}")
    return row


def max_row_norm(kind, tables, chunk=256):
    """Largest row norm of a bucket table, in bucket chunks: the bf16 row
    (dots) or |centroid| + scale * |r8| (ivf8), the magnitude each
    score's float32 sum is taken over."""
    out = 0.0
    if kind == "dots":
        (vecs,) = tables
        for s in range(0, vecs.shape[0], chunk):
            out = max(out, float(vecs[s : s + chunk].float().norm(dim=2).max()))
        return out
    pay, scale, cent = tables
    for s in range(0, pay.shape[0], chunk):
        r = (cent[s : s + chunk].norm(dim=1)[:, None]
             + scale[s : s + chunk] * pay[s : s + chunk].float().norm(dim=2))
        out = max(out, float(r.max()))
    return out


def bucket_bound(kind, probe, cap, d):
    """(bound ms, "bytes" or "operations") of one bucket-kernel call on
    this call's probes: each probed bucket read once (dots: cap*D bf16;
    ivf8: cap*D int8 + scale, nsq and ids, 12*cap, + the centroid, 4*D),
    queries and probes read once, the [B, P, cap] f32 output written
    once; 2*cap*D fp32 operations per (query, probe)."""
    import torch

    b, p = probe.shape
    uniq = int(torch.unique(probe).numel())
    per = cap * d * 2 if kind == "dots" else cap * d + 12 * cap + 4 * d
    bytes_ = uniq * per + b * d * 4 + b * p * 4 + b * p * cap * 4
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * b * p * cap * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def bucket_reuse(torch, probe, n_buckets, d):
    """How the probes share buckets: distinct buckets, pairs per probed
    bucket (mean, max), and the work items the bucket-major kernels run
    (items with pairs)."""
    from leann_tpu_torch.ops import bucket_kernels as bk

    flat = probe.reshape(-1).long()
    counts = torch.bincount(flat[(flat >= 0) & (flat < n_buckets)],
                            minlength=n_buckets)
    distinct = int((counts > 0).sum())
    items = bk.bucket_worklist(probe, n_buckets, bk._qmax(d))[1]
    return {"distinct_buckets": distinct,
            "queries_per_bucket_mean": int(counts.sum()) / max(1, distinct),
            "queries_per_bucket_max": int(counts.max()),
            "work_items": int((items[:, 2] > 0).sum()),
            "grid": items.shape[0]}


def check_case_bucket(torch, label, kind, args, metric, reps, library=False):
    """A bucket kernel vs its plain version on the card: -inf positions
    equal exactly, no NaN, finite scores within 1e-5 x |q| x (largest row
    norm), l2 twice that (the plain version adds the same exact products
    in another order); a repeat gives the same bits; the earlier design
    (one CTA per (query, probe), `csrc/*_pairs.cu`, launched by
    `evals.bucket_scan_cycles.earlier`) within the same tolerance, timed
    in turns with the kernel (earlier, current, current, earlier:
    `ms_pr3`). With
    `library`, also torch.bmm in bf16 over the probed buckets gathered
    beforehand (the gather not timed), a yardstick the port never calls.
    Raises on disagreement."""
    from leann_tpu_torch.evals.bucket_scan_cycles import earlier
    from leann_tpu_torch.ops import bucket_kernels as bk

    q, probe, table = args[:3]
    cap, d = table.shape[1:]
    if kind == "dots":
        fn = lambda: bk.ivf_bucket_dots(*args)
        plain = lambda: bk.ivf_bucket_dots_plain(*args)
        row = max_row_norm(kind, (table,))
    else:
        fn = lambda: bk.ivf8_bucket_scores(*args, metric)
        plain = lambda: bk.ivf8_bucket_scores_plain(*args, metric)
        row = max_row_norm(kind, (table, args[3], args[6]))
    got = fn()
    repeat_equal = bool(torch.equal(got, fn()))
    plain_ms, ref = cuda_ms(plain, 1)
    live = torch.isfinite(ref)
    tol = 1e-5 * float(q.norm(dim=1).max()) * row * (
        2 if metric == "l2" else 1)

    def agree(out):
        """(-inf positions equal, any NaN, max error on live scores)"""
        return (bool(torch.equal(torch.isneginf(out), torch.isneginf(ref))),
                bool(torch.isnan(out).any()),
                float((out - ref).abs()[live].max()) if bool(live.any())
                else 0.0)

    neg_equal, nan, err = agree(got)
    before = lambda: earlier(torch, kind, args, metric)
    e_neg, e_nan, e_err = agree(before())
    turns = {"current": [], "earlier": []}
    for which in ("earlier", "current", "current", "earlier"):
        turns[which].append(cuda_ms(fn if which == "current" else before,
                                    reps)[0])
    ms = float(np.mean(turns["current"]))
    bound_ms, bound_by = bucket_bound(kind, probe, cap, d)
    lib_ms = None
    if library:
        b, p = probe.shape
        gathered = table[probe.long()].to(torch.bfloat16).reshape(
            b, p * cap, d)
        qb = q.to(torch.bfloat16)[:, :, None]
        lib_ms, _ = cuda_ms(lambda: torch.bmm(gathered, qb), reps)
        del gathered
    ctas = (bk.ivf_bucket_dots_ctas_per_sm if kind == "dots"
            else bk.ivf8_bucket_scores_ctas_per_sm)(d)
    out = {"case": label, "b": q.shape[0], "p": probe.shape[1], "cap": cap,
           "d": d, "metric": metric, "buckets": table.shape[0],
           "neg_inf_equal": neg_equal, "exact": bool(torch.equal(got, ref)),
           "repeat_equal": repeat_equal, "max_abs_err": err, "tol": tol,
           "ms": ms, "ms_turns": turns["current"],
           "ms_pr3": float(np.mean(turns["earlier"])),
           "earlier_turns": turns["earlier"], "earlier_max_abs_err": e_err,
           "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": lib_ms, "ctas_per_sm": ctas,
           **bucket_reuse(torch, probe, table.shape[0], d)}
    if (not neg_equal or nan or err > tol or not repeat_equal
            or not e_neg or e_nan or e_err > tol):
        raise AssertionError(f"{kind} kernel disagrees with its plain "
                             f"version: {json.dumps(out)}")
    return out


def gather_bound(b, r, d):
    """(bound ms, "bytes" or "operations") of one gather_score call: the
    B*R gathered rows (D bytes each), the ids, the queries and the output,
    each once; 2*D fp32 operations per row."""
    bytes_ = b * r * d + b * r * 4 + b * d * 4 + b * r * 4
    t_bytes = bytes_ / H100_BYTES_PER_S
    t_ops = 2 * b * r * d / H100_FP32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def check_case_gather(torch, label, corpus, ids, q, library=False):
    """gather_score vs gather_score_plain on the card, on the first
    [B, R] block of the id window `ids` [M, B, R]: within 1e-5 x |q| x
    (largest gathered row norm), since both add the same exact products
    in another order. Times are per call over three passes of the M
    blocks of the window after a warm pass, by the roofline's
    `window_ms` (distinct ids per call, so a call does not find its rows
    in L2 from the call before; each pass queued behind other device
    work, since a launch costs the host more than the card at these
    sizes); `kernel_device_ms` is the kernel's own time by torch.profiler
    over one pass. With `library`, also `corpus[ids]` widened to bf16
    then torch.bmm, both inside the timed window, a yardstick the port
    never calls. Raises on disagreement."""
    from leann_tpu_torch.evals.gather_roofline import window_ms
    from leann_tpu_torch.ops import gather_score as gs

    m, b, r = ids.shape
    d = corpus.shape[1]
    got = gs.gather_score(corpus, ids[0], q)
    ref = gs.gather_score_plain(corpus, ids[0], q)
    err = float((got - ref).abs().max())
    nan = bool(torch.isnan(got).any())
    tol = 1e-5 * float(q.norm(dim=1).max()) * float(
        corpus[ids[0].long()].float().norm(dim=2).max())

    def per_call(fn):
        window_ms(fn, ids, q.device)                            # warm
        return float(np.mean([window_ms(fn, ids, q.device)
                              for _ in range(3)])) / m

    ms = per_call(lambda i: gs.gather_score(corpus, i, q))
    plain_ms = per_call(lambda i: gs.gather_score_plain(corpus, i, q))
    bound_ms, bound_by = gather_bound(b, r, d)
    lib_ms = device_ms = None
    if library:
        qb = q.to(torch.bfloat16)[:, :, None]
        lib_ms = per_call(lambda i: torch.bmm(
            corpus[i.long()].to(torch.bfloat16), qb))
        prof = profile(torch, lambda: [gs.gather_score(corpus, i, q)
                                       for i in ids])
        device_ms = sum(v for k, v in prof["kernels_ms"].items()
                        if "gather_score" in k) / m
    out = {"case": label, "n": corpus.shape[0], "b": b, "r": r, "d": d,
           "calls": m, "exact": bool(torch.equal(got, ref)),
           "max_abs_err": err, "tol": tol, "ms": ms,
           "kernel_device_ms": device_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
    if nan or not err <= tol:
        raise AssertionError(f"gather_score disagrees with its plain "
                             f"version: {json.dumps(out)}")
    return out


# ------------------------------------------------------------------ phases


def phase_env(torch):
    nvcc = subprocess.run(
        [shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc", "--version"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[-1]
    # the rescore paths must be full fp32
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmul is on; the fp32 rescore needs it off")
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "gpu": smi(),
          "device_count": torch.cuda.device_count()})


def phase_build():
    from leann_tpu_torch.ops import _cuda

    libs = ("fused_beam", "pq_beam", "ivf_bucket_dots", "ivf8_scan",
            "gather_score", "pq_beam_scan", "ivf_bucket_dots_pairs",
            "ivf8_scan_pairs")
    t0 = time.perf_counter()
    _cuda.build(libs)
    for name in libs:
        _cuda.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources": [k["source"] for k in (FUSED, PQ, DOTS, IVF8, GATHER)]})


def phase_kernels(torch, dev):
    from leann_tpu_torch.ops import fused_beam as fb
    from leann_tpu_torch.ops.beam import _seed_entries
    from leann_tpu_torch.ops.vamana import build_vamana

    n, d, r, b = 4096, 128, 48, 1023
    rng = np.random.default_rng(7)
    x = make_corpus(rng, n, d, clusters=64)
    adj, medoid = build_vamana(x, graph_degree=r, complexity=64,
                               metric="l2", wave_size=4096, device=dev)
    eng = fb.FusedBeamEngine(x, adj, medoid, metric="l2", device=dev)
    q = torch.from_numpy(
        x[rng.integers(0, n, b)]
        + rng.standard_normal((b, d)).astype(np.float32) * 0.5).to(dev)
    exclude = torch.from_numpy(
        np.where(rng.random(b) < 0.5, rng.integers(0, n, b), -1)
        .astype(np.int32)).to(dev)
    rows = []
    for metric, e, tv in (("l2", 2, 160), ("l2", 1, 0), ("ip", 2, 0),
                          ("ip", 1, 160), ("l2", 2, 0), ("ip", 2, 160)):
        sc, ids = _seed_entries(q.to(torch.bfloat16).float(), eng.seed_vecs,
                                eng.seed_ids, eng.sq_norms, metric, 16)
        kw = dict(queries=q, blocks_i8=eng.blocks, meta_i32=eng.meta,
                  seed_ids=ids.to(torch.int32), seed_scores=sc.contiguous(),
                  exclude=exclude, r=eng.r, beam_width=64,
                  max_iters=(4 * 64) // e + 32, metric=metric,
                  expansions=e, qb=16, ring_size=1024, track_visited=tv)
        rows.append(check_case(torch, f"{metric}/E{e}/tv{tv}", kw, 10))
    emit({"phase": "kernels", "kernel": FUSED["name"], "cases": rows,
          "library_ms": None})
    return rows


def phase_kernels_pq(torch, dev):
    """pq_beam_search vs its plain version on N=4096 graphs built here,
    with the engine's own LUTs and ADC seeds at beam 64 and B=1023 (a
    short last query group), half the queries excluding a node."""
    from leann_tpu_torch.ops.pq_beam import PqBeamEngine
    from leann_tpu_torch.ops.vamana import build_vamana

    n, r, b = 4096, 48, 1023
    rows = []
    for d, cases in (
            (96, [("l2", 256, 2, 256, 0), ("ip", 256, 1, 0, 0),
                  ("l2", 16, 1, 256, 0), ("ip", 16, 2, 256, 0),
                  ("l2", 16, 2, 0, 0), ("ip", 256, 2, 256, 0),
                  ("l2", 256, 2, 256, 2)]),
            (768, [("l2", 256, 2, 256, 0)])):
        rng = np.random.default_rng(d)
        x = make_lowdim(rng, n, d, 16, 64)
        adj, medoid = build_vamana(x, graph_degree=r, complexity=64,
                                   metric="l2", wave_size=4096, device=dev)
        q = torch.from_numpy(x[rng.integers(0, n, b)] + 0.05 * rng.standard_normal(
            (b, d)).astype(np.float32)).to(dev)
        exclude = torch.from_numpy(
            np.where(rng.random(b) < 0.5, rng.integers(0, n, b), -1)
            .astype(np.int32)).to(dev)
        for metric, ksub, e, vt, coarse in cases:
            m = 64 if d == 768 else (12 if coarse else 16)
            eng = PqBeamEngine(x, adj, medoid, metric=metric, m=m, ksub=ksub,
                               coarse_m=coarse, kmeans_iters=6, device=dev)
            kw = dict(eng.kernel_args(q, exclude, 64), expansions=e,
                      track_visited=vt, max_iters=(4 * 64) // e + 32)
            label = (f"D{d}/m{eng.mt}/ksub{ksub}/{metric}/E{e}/tv{vt}"
                     + (f"/residual{coarse}" if coarse else ""))
            rows.append(check_case_pq(torch, label, kw, 10))
    emit({"phase": "kernels", "kernel": PQ["name"], "cases": rows,
          "library_ms": None})
    return rows


def phase_kernels_ivf(torch, dev):
    """ivf_bucket_dots and ivf8_bucket_scores vs their plain versions on
    random tables: caps that are not multiples of 32, D with 16-byte loads
    (96, 128, 768) and without (24, 20), odd batches whose first query
    probes one bucket P times, ~20% empty (-1) slots plus three at each
    bucket's end."""
    g = torch.Generator().manual_seed(5)
    dots, ivf8 = [], []
    for k, cap, d, b, p in ((12, 50, 96, 13, 8), (9, 77, 128, 31, 5),
                            (5, 40, 768, 7, 4), (6, 33, 24, 9, 3),
                            (4, 20, 20, 5, 2)):
        pay = torch.randint(-127, 128, (k, cap, d), generator=g,
                            dtype=torch.int8)
        scale = torch.rand((k, cap), generator=g) * 0.05
        cent = torch.randn((k, d), generator=g) * 3
        nsq = torch.rand((k, cap), generator=g) * 100
        ids = torch.arange(k * cap, dtype=torch.int32).reshape(k, cap)
        ids[torch.rand((k, cap), generator=g) < 0.2] = -1
        ids[:, cap - 3:] = -1
        vecs = (torch.randn((k, cap, d), generator=g) * 2).to(torch.bfloat16)
        q = torch.randn((b, d), generator=g) * 2
        probe = torch.randint(0, k, (b, p), generator=g, dtype=torch.int32)
        probe[0] = probe[0, 0]
        q, probe, pay, scale, cent, nsq, ids, vecs = (
            t.to(dev) for t in (q, probe, pay, scale, cent, nsq, ids, vecs))
        label = f"K{k}/cap{cap}/D{d}/B{b}/P{p}"
        dots.append(check_case_bucket(torch, label, "dots",
                                      (q, probe, vecs), "ip", 10))
        for metric in ("l2", "ip"):
            ivf8.append(check_case_bucket(
                torch, f"{label}/{metric}", "ivf8",
                (q, probe, pay, scale, nsq, ids, cent), metric, 10))
    for info, rows in ((DOTS, dots), (IVF8, ivf8)):
        emit({"phase": "kernels", "kernel": info["name"], "cases": rows,
              "library_ms": None})
    return dots, ivf8


def phase_kernels_gather(torch, dev):
    """gather_score vs its plain version on random corpora: D with
    16-byte loads (96, 128, 64), 4-byte loads (100) and single bytes
    (50), R from 7 to 200, odd batches; every query's first two ids are
    the rows N-1 and 0 and one query's ids are all the same row."""
    g = torch.Generator().manual_seed(9)
    rows = []
    for n, b, d, r in ((5000, 17, 96, 48), (5000, 31, 128, 128),
                       (3000, 9, 64, 7), (2000, 5, 50, 200),
                       (4000, 33, 100, 48), (4000, 1, 128, 48)):
        corpus = torch.randint(-128, 128, (n, d), generator=g,
                               dtype=torch.int8)
        ids = torch.randint(0, n, (4, b, r), generator=g, dtype=torch.int32)
        ids[:, :, 0], ids[:, :, 1] = n - 1, 0
        ids[:, b // 2, :] = 7
        q = torch.randn((b, d), generator=g) * 2
        rows.append(check_case_gather(
            torch, f"N{n}/B{b}/D{d}/R{r}", corpus.to(dev), ids.to(dev),
            q.to(dev)))
    emit({"phase": "kernels", "kernel": GATHER["name"], "cases": rows,
          "bit_equal_cases": sum(c["exact"] for c in rows),
          "library_ms": None})
    return rows


def rag_texts(n_docs):
    rng = np.random.default_rng(11)
    words = [f"w{i}" for i in range(5000)]
    return rng, [f"passage {i}: " + " ".join(rng.choice(words, 24))
                 for i in range(n_docs)]


def rag_build_search(torch, dev, name, texts, vecs, q, pick, counter):
    """The rag path on given embeddings: StreamingIndexBuilder (backend
    hnsw, R=32, L=64, ip) over `texts` / `vecs`, then IndexSearcher.search
    of the query vectors `q` (the embeddings of texts[pick]) at
    complexity 64 and RAG_COMPLEXITY. Returns (engine, metrics)."""
    from leann_tpu_torch.index import (
        IndexSearcher, SearchOptions, StreamingIndexBuilder,
    )
    from leann_tpu_torch.ops.distance import ExactEngine
    from leann_tpu_torch.store.passages import Passage

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "indexes", name, "documents.leann")
        index = StreamingIndexBuilder(base, dim=vecs.shape[1],
                                      backend="hnsw", metric="ip",
                                      device=dev)
        for i, (t, v) in enumerate(zip(texts, vecs)):
            index.add_passage(Passage(id=f"p{i}", text=t,
                                      metadata={"n": i}), v)
        c0 = counter()
        t0 = time.perf_counter()
        index.build(graph_degree=32, complexity=64, alpha=1.2)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        build_launches = counter() - c0

        searcher = IndexSearcher.load(base, device=dev)
        oracle = ExactEngine(vecs, metric="ip", device=dev).search(
            q, k=10, exact_scan=True)[0]
        c0 = counter()
        out = {}
        for complexity in (64, RAG_COMPLEXITY):
            t0 = time.perf_counter()
            res = searcher.search(q, SearchOptions(top_k=10,
                                                   complexity=complexity))
            secs = time.perf_counter() - t0
            got = [[int(h.id[1:]) for h in r] for r in res]
            out[complexity] = (res, secs, recall_at(
                [g + [-1] * (10 - len(g)) for g in got], oracle))
        search_launches = counter() - c0
        engine = searcher.backend.engine

    res, search_s, rec = out[RAG_COMPLEXITY]
    hit1 = float(np.mean([bool(r) and r[0].id == f"p{i}"
                          for r, i in zip(res, pick)]))
    return engine, {
        "n": len(texts), "dim": vecs.shape[1], "build_s": build_s,
        "queries": len(pick), "engine": type(engine).__name__,
        "complexity": RAG_COMPLEXITY, "search_s": search_s,
        "self_hit1": hit1, "recall10": rec,
        "recall10_at_complexity_64": out[64][2],
        "search_s_at_complexity_64": out[64][1],
        "launches_build": build_launches,
        "launches_search": search_launches}


def phase_rag(torch, dev, n_docs, counter):
    from leann_tpu_torch.embed.fake import FakeEmbedding

    rng, texts = rag_texts(n_docs)
    emb = FakeEmbedding(768)
    t0 = time.perf_counter()
    vecs = emb.embed(texts)
    embed_s = time.perf_counter() - t0
    pick = rng.choice(n_docs, 256, replace=False)
    q = emb.embed([texts[i] for i in pick])
    engine, row = rag_build_search(torch, dev, "rag", texts, vecs, q, pick,
                                   counter)
    emit({"phase": "rag", "embed_s": embed_s, **row})
    hit1, rec, rec64 = (row["self_hit1"], row["recall10"],
                        row["recall10_at_complexity_64"])
    if hit1 < 0.99 or rec < 0.95 or rec64 < RAG_MIN_RECALL_64:
        raise AssertionError(f"rag: self-hit@1 {hit1}, recall@10 {rec} at "
                             f"complexity {RAG_COMPLEXITY}, {rec64} at 64")
    if row["launches_build"] <= 0 or row["launches_search"] <= 0:
        raise AssertionError("rag: the fused kernel was not launched "
                             f"(build {row['launches_build']}, search "
                             f"{row['launches_search']})")
    return (engine, torch.from_numpy(np.asarray(q, np.float32)).to(dev),
            pick, row)


def phase_sift(torch, dev, n, counter):
    from leann_tpu_torch.ops import fused_beam as fb
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.vamana import build_vamana
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path

    d, r, build_l, beam, batch, nq = 128, 48, 80, 64, 2048, 1024
    t0 = time.perf_counter()
    pool = make_corpus(np.random.default_rng(0), n + 1024 + 2048, d, 1024)
    corpus, queries = pool[:n], pool[n : n + nq]
    gen_s = time.perf_counter() - t0

    c0 = counter()
    t0 = time.perf_counter()
    adj, medoid = build_vamana(corpus, graph_degree=r, complexity=build_l,
                               alpha=1.2, metric="l2", wave_size=8192,
                               device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    build_launches = counter() - c0
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "sift.leann")
        GraphFile(adj, medoid, "l2").save(graph_path(base))
        graph = GraphFile.load(graph_path(base))

    t0 = time.perf_counter()
    eng = fb.FusedBeamEngine(corpus, graph.adjacency, graph.medoid,
                             metric="l2", expansions=2, qb=16, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    c1 = counter()
    idx, _ = eng.search(queries, k=10, beam_width=beam)
    search_launches = counter() - c1
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)
    rec = recall_at(idx, oracle)

    # device QPS: M batches of 2048 per window, CUDA events, 3 windows
    def draw(m, seed):
        g = np.random.default_rng(seed)
        base_ = corpus[g.integers(0, n, m * batch)]
        noise = g.standard_normal((m * batch, d)).astype(np.float32)
        return torch.from_numpy((base_ + noise).reshape(m, batch, d)).to(dev)

    m = 4
    windows = [draw(m, 1000 + w) for w in range(3)]
    eng.search_many_device(windows[0], k=10, beam_width=beam)   # warm
    torch.cuda.synchronize()
    per_batch = [cuda_ms(lambda w=w: eng.search_many_device(
        w, k=10, beam_width=beam), 1)[0] / m for w in windows]
    qps = [batch / (t / 1e3) for t in per_batch]

    emit({"phase": "sift", "n": n, "d": d, "r": r, "build_l": build_l,
          "beam": beam, "gen_s": gen_s, "build_s": build_s,
          "pack_s": pack_s, "recall10": rec, "queries": nq,
          "qps_windows": qps, "qps_mean": float(np.mean(qps)),
          "ms_per_batch": per_batch, "batch": batch,
          "launches_build": build_launches,
          "launches_search": search_launches})
    if rec < 0.95:
        raise AssertionError(f"sift: recall@10 {rec} < 0.95")
    if build_launches <= 0 or search_launches <= 0:
        raise AssertionError("sift: the fused kernel was not launched")
    return eng, windows[0][0], build_l


def phase_deep(torch, dev, n, counter, beams=(64, DEEP_BEAM)):
    """BASELINE config 2 through the user's entry points: Vamana build,
    graph file round trip, GraphSearcher's own engine choice (it must be
    PqBeamEngine at D=96), the `.pq.npz` sidecar reloaded without
    retraining, recall@10 and device QPS at each beam of `beams`."""
    from leann_tpu_torch.backend import GraphSearcher
    from leann_tpu_torch.ops import pq_beam as pb
    from leann_tpu_torch.ops.beam import BeamSearchEngine
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.vamana import build_vamana
    from leann_tpu_torch.store.graphfile import GraphFile, graph_path

    d, r, build_l, batch, nq, m = 96, 48, 80, 2048, 1024, 4
    if os.environ.get("LEANN_GRAPH_ENGINE"):
        raise AssertionError("deep: LEANN_GRAPH_ENGINE must be unset")
    t0 = time.perf_counter()
    pool = make_lowdim(np.random.default_rng(0), n + nq + 3 * m * batch, d,
                       16, 1024)
    corpus, queries = pool[:n], pool[n : n + nq]
    windows = [torch.from_numpy(w).to(dev) for w in
               pool[n + nq :].reshape(3, m, batch, d)]
    gen_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    adj, medoid = build_vamana(corpus, graph_degree=r, complexity=build_l,
                               alpha=1.2, metric="l2", wave_size=8192,
                               device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "deep.leann")
        GraphFile(adj, medoid, "l2").save(graph_path(base))
        graph = GraphFile.load(graph_path(base))
        t0 = time.perf_counter()
        searcher = GraphSearcher(corpus, graph, metric="l2", base=base,
                                 device=dev)
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        eng = searcher.engine
        if type(eng).__name__ != "PqBeamEngine":
            raise AssertionError(f"deep: GraphSearcher chose "
                                 f"{type(eng).__name__}, not PqBeamEngine")

        # the sidecar: a second searcher must load it, not train again
        def no_training(*a, **k):
            raise AssertionError("deep: PQ retrained despite the sidecar")

        trained = pb.train_pq
        pb.train_pq = no_training
        try:
            t0 = time.perf_counter()
            again = GraphSearcher(corpus, graph, metric="l2", base=base,
                                  device=dev)
            torch.cuda.synchronize()
            reload_s = time.perf_counter() - t0
        finally:
            pb.train_pq = trained
        if not np.array_equal(again.engine.codes, eng.codes):
            raise AssertionError("deep: the sidecar's codes differ")
        del again

    t0 = time.perf_counter()
    pb.pack_pq_records(np.concatenate([graph.adjacency, np.full(
        (1, r), n, np.int32)]), np.concatenate(
            [eng.codes, np.zeros((1, eng.mt), np.uint8)]), eng.bits,
        device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0

    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)
    # the graph's own ceiling: the same graph traversed on exact f32
    # scores (row-gather engine), against which the PQ navigation reads
    exact_eng = BeamSearchEngine(corpus, graph.adjacency, graph.medoid,
                                 metric="l2", block_mode="none", device=dev)
    ceiling = {beam: recall_at(exact_eng.search(queries, k=10,
                                                beam_width=beam)[0], oracle)
               for beam in beams}
    del exact_eng
    out = {}
    for beam in beams:
        c0 = counter()
        t0 = time.perf_counter()
        idx, _ = searcher.search(queries, k=10, complexity=beam)
        search_s = time.perf_counter() - t0
        if counter() <= c0:
            raise AssertionError("deep: the PQ kernel was not launched")
        eng.search_many_device(windows[0], k=10, beam_width=beam)   # warm
        torch.cuda.synchronize()
        per_batch = [cuda_ms(lambda w=w: eng.search_many_device(
            w, k=10, beam_width=beam), 1)[0] / m for w in windows]
        qps = [batch / (t / 1e3) for t in per_batch]
        out[beam] = {"recall10": recall_at(idx, oracle),
                     "exact_graph_recall10": ceiling[beam],
                     "search_s": search_s, "qps_windows": qps,
                     "qps_mean": float(np.mean(qps)),
                     "ms_per_batch": per_batch,
                     "profile": profile(torch, lambda: eng.search_many_device(
                         windows[1], k=10, beam_width=beam))}

    emit({"phase": "deep", "n": n, "d": d, "r": r, "build_l": build_l,
          "gen_s": gen_s, "build_s": build_s, "engine": type(eng).__name__,
          "pq_m": eng.mt, "pq_ksub": eng.ksub,
          "engine_s": engine_s, "engine_from_sidecar_s": reload_s,
          "pack_s": pack_s, "queries": nq, "batch": batch,
          "beams": {str(k): v for k, v in out.items()}})
    rec64, rec = out[beams[0]]["recall10"], out[beams[-1]]["recall10"]
    if rec < DEEP_MIN_RECALL or rec64 < DEEP_MIN_RECALL_64:
        raise AssertionError(f"deep: recall@10 {rec} at beam {beams[-1]}, "
                             f"{rec64} at {beams[0]}")
    return eng, windows[0][0]


def qps_windows(torch, fn, windows):
    """(per-batch device ms of fn(batch) over each [M, B, D] window, by
    CUDA events, after one warm window; the QPS of each)."""
    m, b = windows[0].shape[:2]
    for q in windows[0]:
        fn(q)
    torch.cuda.synchronize()
    per_batch = [cuda_ms(lambda w=w: [fn(q) for q in w], 1)[0] / m
                 for w in windows]
    return per_batch, [b / (t / 1e3) for t in per_batch]


def phase_ivf(torch, dev, n, counter):
    """BASELINE config 1 / bench.py's IVF config through IvfEngine: the
    torch scan (`search`, what IvfSearcher serves) and the kernel path
    (`search_pallas`, kernel ivf_bucket_dots) at nprobe 8."""
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.ivf import IvfEngine

    d, batch, nq, m = 128, 2048, 1024, 4
    t0 = time.perf_counter()
    pool = make_corpus(np.random.default_rng(0), n + nq, d, 1024)
    corpus, queries = pool[:n], pool[n:]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng = IvfEngine(corpus, n_clusters=IVF_CLUSTERS, metric="l2", device=dev)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)

    c0 = counter()
    rec_torch = recall_at(eng.search(queries, k=10, nprobe=NPROBE)[0], oracle)
    torch_launches = counter() - c0
    rec_kernel = recall_at(eng.search_pallas(queries, k=10, nprobe=NPROBE)[0],
                           oracle)
    kernel_launches = counter() - c0 - torch_launches

    windows = [torch.from_numpy(noisy_rows(corpus, (m, batch), 2000 + w)).to(dev)
               for w in range(3)]
    out = {}
    for name, fn in (
            ("torch", lambda q: eng.search_device(q, k=10, nprobe=NPROBE)),
            ("kernel", lambda q: eng.search_pallas_device(
                q, k=10, nprobe=NPROBE))):
        per_batch, qps = qps_windows(torch, fn, windows)
        out[name] = {"ms_per_batch": per_batch, "qps_windows": qps,
                     "qps_mean": float(np.mean(qps)),
                     "profile": profile(torch, lambda: [fn(q) for q in windows[1]])}
    emit({"phase": "ivf", "n": n, "d": d, "n_clusters": IVF_CLUSTERS,
          "buckets": eng.bucket_cent.shape[0], "cap": eng.cap,
          "nprobe": NPROBE, "gen_s": gen_s, "engine_s": engine_s,
          "queries": nq, "batch": batch, "recall10_torch": rec_torch,
          "recall10_kernel": rec_kernel, "launches_torch": torch_launches,
          "launches_kernel": kernel_launches, **out})
    if min(rec_torch, rec_kernel) < IVF_MIN_RECALL or \
            abs(rec_torch - rec_kernel) > 0.002:
        raise AssertionError(f"ivf: recall@10 {rec_torch} (torch) vs "
                             f"{rec_kernel} (kernel)")
    if torch_launches or kernel_launches <= 0:
        raise AssertionError("ivf: the kernel path must launch "
                             "ivf_bucket_dots and the torch scan must not")
    data = {"corpus": corpus, "queries": queries, "oracle": oracle,
            "centers": eng.centers, "assign": eng.assign,
            "recall10": rec_torch}
    return eng, windows[0][0], data


def phase_ivf8(torch, dev, n, counter):
    """BASELINE config 2 at full scale through IvfInt8Engine: the kernel
    path (LEANN_IVF8_PALLAS=1, kernel ivf8_bucket_scores) and the torch
    scan at nprobe 8, device QPS at the reference's A/B batch (512) and
    at 2048, and the calibrated nprobe for recall 0.95."""
    from leann_tpu_torch.ops.distance import exact_topk
    from leann_tpu_torch.ops.ivf import kmeans
    from leann_tpu_torch.ops.ivf_int8 import IvfInt8Engine

    d, nq, m = 96, 1024, 4
    t0 = time.perf_counter()
    pool = make_corpus(np.random.default_rng(0), n + nq, d, 1024)
    corpus, queries = pool[:n], pool[n:]
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    centers, assign = kmeans(corpus, IVF8_CLUSTERS, metric="l2", device=dev)
    kmeans_s = time.perf_counter() - t0
    # k-means sums in a fixed order: two runs of its first iteration on a
    # 1M slice must give the same bits
    runs = [kmeans(corpus[:1_000_000], IVF8_CLUSTERS, iters=1, metric="l2",
                   device=dev) for _ in range(2)]
    kmeans_repeat_equal = all(
        a.tobytes() == b.tobytes() for a, b in zip(*runs))
    del runs
    t0 = time.perf_counter()
    eng = IvfInt8Engine(corpus, metric="l2", centers=centers, assign=assign,
                        device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    _, oracle = exact_topk(queries, corpus, 10, metric="l2", device=dev)

    paths = {"kernel": "1", "torch": None}
    rec, launches = {}, {}
    for name, flag in paths.items():
        c0 = counter()
        with env_var("LEANN_IVF8_PALLAS", flag):
            rec[name] = recall_at(eng.search(queries, k=10, nprobe=NPROBE)[0],
                                  oracle)
        launches[name] = counter() - c0
    timing = {}
    batches = {}
    for batch in (512, 2048):
        windows = [torch.from_numpy(noisy_rows(
            corpus, (m, batch), 3000 + 10 * batch + w)).to(dev)
            for w in range(3)]
        batches[batch] = windows[0][0]
        for name, flag in paths.items():
            with env_var("LEANN_IVF8_PALLAS", flag):
                fn = lambda q: eng.search_device(q, k=10, nprobe=NPROBE)
                per_batch, qps = qps_windows(torch, fn, windows)
                row = {"ms_per_batch": per_batch, "qps_windows": qps,
                       "qps_mean": float(np.mean(qps))}
                if batch == 2048:
                    row["profile"] = profile(
                        torch, lambda: [fn(q) for q in windows[1]])
            timing[f"{name}_b{batch}"] = row
    t0 = time.perf_counter()
    with env_var("LEANN_IVF8_PALLAS", None):
        cal_nprobe, cal_rec = eng.calibrate_nprobe(0.95)
    calibrate_s = time.perf_counter() - t0
    emit({"phase": "ivf8", "n": n, "d": d, "n_clusters": IVF8_CLUSTERS,
          "buckets": eng.bucket_cent.shape[0], "cap": eng.cap,
          "payload_gb": eng.payload.numel() / 1e9, "nprobe": NPROBE,
          "gen_s": gen_s, "kmeans_s": kmeans_s,
          "kmeans_repeat_equal": kmeans_repeat_equal, "pack_s": pack_s,
          "queries": nq, "recall10_kernel": rec["kernel"],
          "recall10_torch": rec["torch"], "launches_kernel": launches["kernel"],
          "launches_torch": launches["torch"],
          "calibrated_nprobe": cal_nprobe, "calibrated_recall10": cal_rec,
          "calibrate_s": calibrate_s, **timing})
    if rec["kernel"] < IVF8_MIN_RECALL or \
            abs(rec["kernel"] - rec["torch"]) > 0.002:
        raise AssertionError(f"ivf8: recall@10 {rec['kernel']} (kernel) vs "
                             f"{rec['torch']} (torch)")
    if launches["torch"] or launches["kernel"] <= 0:
        raise AssertionError("ivf8: LEANN_IVF8_PALLAS=1 must launch "
                             "ivf8_bucket_scores and the torch scan must not")
    if not kmeans_repeat_equal:
        raise AssertionError("ivf8: two k-means runs gave different bits")
    data = {"corpus": corpus, "queries": queries, "oracle": oracle,
            "centers": centers, "assign": assign, "recall10": rec["kernel"]}
    return eng, batches, data


def phase_rag_ivf(torch, dev, n_docs, counter):
    """The rag corpus through the `ivf` backend's entry points: build
    (k-means + the calibrated nprobe in the meta), IndexSearcher.search
    on 256 passage texts. IvfSearcher serves the torch scan, so no kernel
    may launch."""
    from leann_tpu_torch.embed.fake import FakeEmbedding
    from leann_tpu_torch.index import (
        IndexSearcher, SearchOptions, StreamingIndexBuilder,
    )
    from leann_tpu_torch.ops.distance import ExactEngine
    from leann_tpu_torch.store.passages import Passage

    rng, texts = rag_texts(n_docs)
    emb = FakeEmbedding(768)
    vecs = emb.embed(texts)
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "indexes", "rag_ivf", "documents.leann")
        builder = StreamingIndexBuilder(base, dim=768, backend="ivf",
                                        metric="ip", device=dev)
        for i, (t, v) in enumerate(zip(texts, vecs)):
            builder.add_passage(Passage(id=f"p{i}", text=t,
                                        metadata={"n": i}), v)
        t0 = time.perf_counter()
        meta = builder.build()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        kw = meta.backend_kwargs or {}
        if "nprobe" not in kw:
            raise AssertionError(f"rag_ivf: no calibrated nprobe in {kw}")
        nprobe = int(kw["nprobe"])
        searcher = IndexSearcher.load(base, device=dev)
        pick = rng.choice(n_docs, 256, replace=False)
        q = emb.embed([texts[i] for i in pick])
        oracle = ExactEngine(vecs, metric="ip", device=dev).search(
            q, k=10, exact_scan=True)[0]
        out = {}
        for complexity in (2 * nprobe, 64):
            t0 = time.perf_counter()
            res = searcher.search(q, SearchOptions(top_k=10,
                                                   complexity=complexity))
            secs = time.perf_counter() - t0
            got = [[int(h.id[1:]) for h in r] for r in res]
            hit1 = float(np.mean([bool(r) and r[0].id == f"p{i}"
                                  for r, i in zip(res, pick)]))
            out[complexity] = {"search_s": secs, "self_hit1": hit1,
                               "recall10": recall_at(
                                   [g + [-1] * (10 - len(g)) for g in got],
                                   oracle)}
    cal = out[2 * nprobe]
    emit({"phase": "rag_ivf", "n": n_docs, "dim": 768, "build_s": build_s,
          "backend_kwargs": kw, "queries": 256,
          "engine": type(searcher.backend.engine).__name__,
          "at_calibrated_nprobe": cal, "at_complexity_64": out[64]})
    if cal["self_hit1"] < 0.99 or cal["recall10"] < RAG_IVF_MIN_RECALL:
        raise AssertionError(f"rag_ivf: {cal} at nprobe {nprobe}")
    if counter():
        raise AssertionError("rag_ivf: a kernel launched; IvfSearcher must "
                             "serve the torch scan")


def phase_gather(torch, dev, n, counter):
    """The row-gather roofline through its entry point
    (`leann_tpu_torch.evals.gather_roofline.run`) at the reference's
    default shape: both engines, rows/s and effective GB/s; `run` holds
    each engine against the plain version on the window's first call."""
    from leann_tpu_torch.evals import gather_roofline

    b, r, d = 2048, 48, 128
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = gather_roofline.make_corpus(n, d, gen, dev)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    rows = gather_roofline.run(n=n, b=b, r=r, m_scan=50, reps=10, d=d,
                               device=dev, corpus=corpus)
    by = {row["engine"]: row for row in rows}
    emit({"phase": "gather", "n": n, "d": d, "b": b, "r": r,
          "corpus_gb": n * d / 1e9, "gen_s": gen_s, "rows": rows,
          "kernel_over_torch": (by["gather-cuda"]["rows_per_s"]
                                / by["gather-torch"]["rows_per_s"]),
          "launches": counter()})
    ids = torch.randint(0, n, (20, b, r), generator=gen, device=dev,
                        dtype=torch.int32)
    q = torch.randn((b, d), generator=gen, device=dev)
    return corpus, ids, q


def phase_ivfpq(torch, dev, n, counter, big, small):
    """IVF-PQ at `evals/ivfpq_device_check.py`'s configuration on the ivf8
    phase's corpus, centers and assignment (`big`), then IvfSearcher
    under LEANN_IVF_ENGINE=pq over the ivf phase's (`small`). The scan is
    plain PyTorch: no kernel may launch."""
    from types import SimpleNamespace

    from leann_tpu_torch.backend import IvfSearcher
    from leann_tpu_torch.ops.ivf_pq import IvfPqEngine

    corpus, queries, oracle = big["corpus"], big["queries"], big["oracle"]
    d, batch, m = corpus.shape[1], 2048, 4
    pq_m = next(mm for mm in (16, 12, 8) if d % mm == 0)
    t0 = time.perf_counter()
    eng = IvfPqEngine(corpus, metric="l2", m=pq_m, rescore="int8",
                      centers=big["centers"], assign=big["assign"],
                      device=dev)
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    kw = dict(k=10, nprobe=IVFPQ_NPROBE, rescore_factor=IVFPQ_RESCORE_FACTOR)
    t0 = time.perf_counter()
    rec = recall_at(eng.search(queries, **kw)[0], oracle)
    search_s = time.perf_counter() - t0
    windows = [torch.from_numpy(noisy_rows(corpus, (m, batch), 4000 + w)).to(dev)
               for w in range(3)]
    fn = lambda q: eng.search_device(q, **kw)
    per_batch, qps = qps_windows(torch, fn, windows)
    prof = profile(torch, lambda: [fn(q) for q in windows[1]])
    many = eng.search_many_device(windows[0][:1], **kw)
    one = eng.search_device(windows[0][0], **kw)
    if not (torch.equal(many[0][0], one[0]) and torch.equal(many[1][0], one[1])):
        raise AssertionError("ivfpq: search_many_device differs from "
                             "search_device on the same batch")
    t0 = time.perf_counter()
    cal_nprobe, cal_rec = eng.calibrate_nprobe(0.95)
    calibrate_s = time.perf_counter() - t0

    with env_var("LEANN_IVF_ENGINE", "pq"):
        t0 = time.perf_counter()
        searcher = IvfSearcher(
            small["corpus"], SimpleNamespace(centers=small["centers"],
                                             assign=small["assign"]),
            metric="l2", device=dev)
        torch.cuda.synchronize()
        searcher_s = time.perf_counter() - t0
    small_eng = searcher.engine
    rec_1m = recall_at(searcher.search(small["queries"], k=10,
                                       complexity=2 * NPROBE)[0],
                       small["oracle"])
    emit({"phase": "ivfpq", "n": n, "d": d, "m": pq_m, "ksub": eng.ksub,
          "rescore": eng.rescore, "nprobe": IVFPQ_NPROBE,
          "rescore_factor": IVFPQ_RESCORE_FACTOR,
          "buckets": eng.bucket_cent.shape[0], "cap": eng.cap,
          "engine_s": engine_s, "engine_steps_s": eng.build_seconds,
          "codes_bytes": eng.bucket_codes.numel(),
          "norms_bytes": eng.bucket_nsq.numel() * 4,
          "ids_bytes": eng.bucket_ids.numel() * 4,
          "rescore_corpus_bytes": eng.corpus.numel(),
          "bf16_engine_bytes": n * d * 6,
          "queries": len(queries), "recall10": rec,
          "recall10_ivf8_nprobe8": big["recall10"], "search_s": search_s,
          "batch": batch, "ms_per_batch": per_batch, "qps_windows": qps,
          "qps_mean": float(np.mean(qps)), "profile": prof,
          "calibrated_nprobe": cal_nprobe, "calibrated_recall10": cal_rec,
          "calibrate_s": calibrate_s,
          "searcher_1m": {
              "n": small_eng.n, "d": small_eng.d,
              "engine": type(small_eng).__name__,
              "rescore": getattr(small_eng, "rescore", None),
              "m": getattr(small_eng, "m", None), "engine_s": searcher_s,
              "nprobe": NPROBE, "recall10": rec_1m,
              "recall10_ivf_engine": small["recall10"]}})
    if type(small_eng).__name__ != "IvfPqEngine" or small_eng.rescore != "f32":
        raise AssertionError(
            f"ivfpq: IvfSearcher chose {type(small_eng).__name__} with "
            f"rescore {getattr(small_eng, 'rescore', None)}, not "
            "IvfPqEngine with f32")
    if rec < IVFPQ_MIN_RECALL or rec_1m < IVFPQ_1M_MIN_RECALL:
        raise AssertionError(f"ivfpq: recall@10 {rec} at 10M, {rec_1m} "
                             "through IvfSearcher at 1M")
    if counter():
        raise AssertionError("ivfpq: a kernel launched; the IVF-PQ scan is "
                             "plain PyTorch")


def phase_encode(torch, dev, n_docs, counter, fake_row):
    """The BERT encoder at the published bert-base widths (seeded random
    weights, hash tokenizer) through LocalEmbedding, the rag index built
    and searched on its vectors, and `entry()` on the card against its
    CPU run."""
    from leann_tpu_torch.embed import LocalEmbedding
    from leann_tpu_torch.entry import entry
    from leann_tpu_torch.models import bert

    rng, texts = rag_texts(n_docs)
    t0 = time.perf_counter()
    enc = bert.BertEncoder(bert.BertConfig(), device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    cfg = enc.config
    emb = LocalEmbedding(encoder=enc, batch_size=128)
    emb.embed(texts[:256])                                      # warm
    t0 = time.perf_counter()
    embed_ms, vecs = cuda_ms(lambda: emb.embed(texts), 1)
    embed_s = time.perf_counter() - t0
    batches = -(-n_docs // 128)
    tok, mask = enc.tokenizer.encode_batch(texts[:128])
    tlen = bert._bucket_len(tok.shape[1], cap=enc.max_length)
    ids_pad = np.zeros((128, tlen), np.int32)
    mask_pad = np.zeros((128, tlen), np.int32)
    ids_pad[:, :tok.shape[1]], mask_pad[:, :tok.shape[1]] = tok, mask
    ids_dev = torch.from_numpy(ids_pad).to(dev)
    mask_dev = torch.from_numpy(mask_pad).to(dev)

    def forward(config):
        with torch.no_grad():
            return bert.bert_forward(enc.params, ids_dev, mask_dev, config)

    import dataclasses

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    forward(cfg), forward(cfg32)
    forward_ms = cuda_ms(lambda: forward(cfg), 10)[0]
    forward_f32_ms = cuda_ms(lambda: forward(cfg32), 3)[0]
    forward_profile = profile(torch, lambda: forward(cfg))

    # the bf16 product with a float32 result against the widened product
    g = torch.Generator(device=dev).manual_seed(3)
    a = torch.randn((1, 128 * tlen, cfg.hidden_size), generator=g, device=dev)
    w = torch.randn((1, cfg.hidden_size, cfg.intermediate_size), generator=g,
                    device=dev) / np.sqrt(cfg.hidden_size)
    widened = lambda: torch.bmm(a.to(torch.bfloat16).float(),
                                w.to(torch.bfloat16).float())
    want = widened()
    got = bert._mm(a, w, True)
    product = {"bf16_operands": bert._bf16_operands(dev),
               "max_abs_err": float((got - want).abs().max()),
               "ms": cuda_ms(lambda: bert._mm(a, w, True), 10)[0],
               "widened_f32_ms": cuda_ms(widened, 3)[0]}

    # bf16 against float32 through the encoder on 256 texts
    pick = rng.choice(n_docs, 256, replace=False)
    picked = [texts[i] for i in pick]
    q = emb.embed(picked)
    enc32 = bert.BertEncoder(cfg, compute_dtype="float32", device=dev)
    q32 = enc32.embed(picked, batch_size=128)
    del enc32
    cos = (q * q32).sum(1)
    self_err = float(np.abs(q - vecs[pick]).max())

    engine, row = rag_build_search(torch, dev, "rag_bert", texts, vecs, q,
                                   pick, counter)
    # how close the corpus vectors sit: random weights pool every text
    # near one direction, which is what the search has to separate
    sample = vecs[rng.choice(n_docs, 512, replace=False)]
    off = (sample @ sample.T)[~np.eye(512, dtype=bool)]

    # entry() on the card against its run on the CPU
    fn, args = entry(device=dev)
    ids, sc = fn(*args)
    torch.cuda.synchronize()
    cfn, cargs = entry(device="cpu")
    cids, csc = cfn(*cargs)
    with torch.no_grad():
        cq = bert.bert_forward(cargs[0], cargs[1], cargs[2],
                               bert.BertConfig.tiny())
    top = torch.sort(cq @ cargs[3][:-1].T, dim=1, descending=True)[0][:, :11]
    clear = ((top[:, 9] - top[:, 10]) > 1e-3).numpy()
    ids_np, cids_np = ids.cpu().numpy(), cids.numpy()
    same_sets = np.array([set(a.tolist()) == set(b.tolist())
                          for a, b in zip(ids_np, cids_np)])
    entry_row = {"shape": list(ids.shape), "rows_clear": int(clear.sum()),
                 "rows_equal_as_sets": int(same_sets.sum()),
                 "positions_equal": float((ids_np == cids_np).mean()),
                 "max_score_diff": float((sc.cpu() - csc).abs().max()),
                 "finite": bool(torch.isfinite(sc).all())}

    emit({"phase": "encode", "config": dataclasses.asdict(cfg),
          "tokens_per_text": int(mask.sum(1).max()), "padded_length": tlen,
          "init_s": init_s, "embed_s": embed_s,
          "texts_per_s": n_docs / (embed_ms / 1e3),
          "ms_per_batch": embed_ms / batches, "batch": 128,
          "forward_ms": forward_ms, "forward_f32_ms": forward_f32_ms,
          "forward_profile": forward_profile,
          "bf16_product": product,
          "bf16_vs_f32_cos_min": float(cos.min()),
          "query_vs_corpus_max_abs": self_err,
          "corpus_cos_mean": float(off.mean()),
          "corpus_cos_max": float(off.max()),
          "rag": row, "rag_fake": {k: fake_row[k] for k in (
              "self_hit1", "recall10", "recall10_at_complexity_64")},
          "entry": entry_row})
    if not np.isfinite(vecs).all() or vecs.shape != (n_docs, cfg.hidden_size):
        raise AssertionError("encode: embeddings not finite or misshapen")
    if float(cos.min()) < 0.999:
        raise AssertionError(f"encode: bf16 vs float32 cosine {cos.min()}")
    if product["max_abs_err"] > 1e-3:
        raise AssertionError(f"encode: bf16 product {product}")
    if row["self_hit1"] < ENCODE_MIN_HIT1 or row["recall10"] < ENCODE_MIN_RECALL:
        raise AssertionError(f"encode: rag on encoder vectors {row}")
    if row["launches_build"] <= 0 or row["launches_search"] <= 0:
        raise AssertionError("encode: the fused kernel was not launched")
    if (list(ids.shape) != [16, 10] or not entry_row["finite"]
            or not same_sets[clear].all() or clear.sum() < 4):
        raise AssertionError(f"encode: entry() {entry_row}")


def phase_kernels_main(torch, rag, sift, deep, ivf, ivf8, gather):
    """Each kernel against its plain version at the shapes the main paths
    launched it with. The build cases take the builder's final-pass
    arguments (L = complexity, max_iters 2L+16, visited log 2L, medoid
    seed, the point itself excluded) on the finished graph; the search
    cases take the engines' own arguments; the bucket kernels take the
    engines' tables and the probes of their centroid top-8; gather_score
    takes the roofline's corpus and a window of distinct ids."""
    from leann_tpu_torch.ops.distance import pairwise_scores, topk_stable
    from leann_tpu_torch.ops.fused_beam import wave_kernel_args

    def build_args(eng, q, ids, beam):
        return wave_kernel_args(
            q, eng.vectors, eng.sq_norms, eng.blocks, eng.meta, eng.medoid,
            ids, eng.r, beam, 2 * beam + 16, eng.metric, expansions=2,
            track_visited=2 * beam)

    rag_eng, rag_q, pick = rag[:3]
    sift_eng, sift_q, sift_l = sift
    dev = rag_q.device

    def none(q):
        return torch.full((q.shape[0],), -1, dtype=torch.int32, device=dev)

    wave = torch.from_numpy(np.random.default_rng(5).choice(
        sift_eng.n, sift_q.shape[0], replace=False)).to(dev)
    cases = [
        ("rag build", build_args(
            rag_eng, rag_q, torch.from_numpy(pick).to(dev), 64), 10),
        ("rag search L64", rag_eng.kernel_args(rag_q, none(rag_q), 64), 10),
        ("rag search L1024", rag_eng.kernel_args(
            rag_q, none(rag_q), RAG_COMPLEXITY), 3),
        ("sift build", build_args(
            sift_eng, sift_eng.vectors[wave], wave, sift_l), 5),
        ("sift search", sift_eng.kernel_args(sift_q, none(sift_q), 64), 5),
    ]
    rows = [check_case(torch, label, kw, reps) for label, kw, reps in cases]
    emit({"phase": "kernels_main", "kernel": FUSED["name"], "cases": rows,
          "library_ms": None})

    deep_eng, deep_q = deep
    pq_rows = [check_case_pq(torch, f"deep search L{beam}", deep_eng.kernel_args(
        deep_q, none(deep_q), beam), 5) for beam in (64, DEEP_BEAM)]
    emit({"phase": "kernels_main", "kernel": PQ["name"], "cases": pq_rows,
          "library_ms": None})

    def probes(eng, q):
        sc = pairwise_scores(q, eng.bucket_cent, eng.metric)
        return topk_stable(sc, NPROBE)[1].to(torch.int32)

    ivf_eng, ivf_q = ivf
    dots_rows = [check_case_bucket(
        torch, "ivf search", "dots",
        (ivf_q, probes(ivf_eng, ivf_q), ivf_eng.bucket_vecs_bf16), "l2", 10,
        library=True)]
    emit({"phase": "kernels_main", "kernel": DOTS["name"], "cases": dots_rows,
          "library_ms": dots_rows[-1]["library_ms"]})
    ivf8_eng, ivf8_q = ivf8
    pay, sc, ns, ids, cent, _, _ = ivf8_eng._pallas_tables()
    ivf8_rows = [check_case_bucket(
        torch, f"ivf8 search B{b}", "ivf8",
        (q, probes(ivf8_eng, q), pay, sc, ns, ids, cent), "l2", 10,
        library=True) for b, q in sorted(ivf8_q.items())]
    # the hot case: all 2048 queries probe the 8 buckets that the batch's
    # own probes hit most
    q = ivf8_q[2048]
    hits = torch.bincount(probes(ivf8_eng, q).reshape(-1).long(),
                          minlength=pay.shape[0])
    hot = torch.topk(hits, NPROBE).indices.to(torch.int32)
    ivf8_rows.append(check_case_bucket(
        torch, "ivf8 hot B2048", "ivf8",
        (q, hot.expand(q.shape[0], NPROBE), pay, sc, ns, ids, cent), "l2",
        10))
    emit({"phase": "kernels_main", "kernel": IVF8["name"], "cases": ivf8_rows,
          "library_ms": ivf8_rows[-2]["library_ms"]})
    g_corpus, g_ids, g_q = gather
    gather_rows = [check_case_gather(torch, "gather roofline", g_corpus,
                                     g_ids, g_q, library=True)]
    emit({"phase": "kernels_main", "kernel": GATHER["name"],
          "cases": gather_rows,
          "library_ms": gather_rows[-1]["library_ms"]})
    return rows, pq_rows, dots_rows, ivf8_rows, gather_rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False; no GPU here")
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from leann_tpu_torch.ops.bucket_kernels import (
        ivf8_bucket_scores, ivf_bucket_dots,
    )
    from leann_tpu_torch.ops.fused_beam import fused_beam_search
    from leann_tpu_torch.ops.gather_score import gather_score
    from leann_tpu_torch.ops.pq_beam import pq_beam_search

    wrappers = {FUSED["name"]: fused_beam_search, PQ["name"]: pq_beam_search,
                DOTS["name"]: ivf_bucket_dots, IVF8["name"]: ivf8_bucket_scores,
                GATHER["name"]: gather_score}
    launches = dict.fromkeys(wrappers, 0)

    def drive(phase, kernel, n, *extra):
        """One main-path phase, every count set to 0 just before it and
        read just after; the phase's kernel must have launched (with
        kernel None, no kernel may launch). `extra` goes to the phase."""
        for w in wrappers.values():
            w.launches = 0
        count = ((lambda: sum(w.launches for w in wrappers.values()))
                 if kernel is None else (lambda: wrappers[kernel].launches))
        out = phase(torch, dev, n, count, *extra)
        got = {k: w.launches for k, w in wrappers.items()}
        emit({"phase": phase.__name__[len("phase_"):], "launches": got})
        if kernel is None and any(got.values()):
            raise AssertionError(f"{phase.__name__}: a kernel launched")
        if kernel is not None and got[kernel] <= 0:
            raise AssertionError(f"{phase.__name__}: {kernel} never launched")
        for k in got:
            launches[k] += got[k]
        return out

    dev = torch.device("cuda:0")
    t_all = time.perf_counter()
    phase_env(torch)
    phase_build()
    rows = phase_kernels(torch, dev)
    pq_grid = phase_kernels_pq(torch, dev)
    dots_grid, ivf8_grid = phase_kernels_ivf(torch, dev)
    gather_grid = phase_kernels_gather(torch, dev)

    rag = drive(phase_rag, FUSED["name"], RAG_N)
    sift = drive(phase_sift, FUSED["name"], SIFT_N)
    deep = drive(phase_deep, PQ["name"], DEEP_N)
    *ivf, ivf_data = drive(phase_ivf, DOTS["name"], IVF_N)
    *ivf8, ivf8_data = drive(phase_ivf8, IVF8["name"], IVF8_N)
    gather = drive(phase_gather, GATHER["name"], GATHER_N)
    drive(phase_ivfpq, None, IVF8_N, ivf8_data, ivf_data)
    del ivf_data, ivf8_data
    drive(phase_rag_ivf, None, RAG_N)
    drive(phase_encode, FUSED["name"], RAG_N, rag[3])
    main_rows, pq_main, dots_main, ivf8_main, gather_main = phase_kernels_main(
        torch, rag, sift, deep, ivf, ivf8, gather)

    # the table rows: times at each kernel's serving shape (sift search,
    # 1M, B=2048; deep search, 1M, B=2048, beam DEEP_BEAM; ivf search,
    # 1M, B=2048; ivf8 search, 10M, B=2048; the gather roofline, 10M x
    # 128, B=2048, R=48), the worst error over every comparison
    kernels = []
    for info, serve, all_rows in (
            (FUSED, main_rows[-1], rows + main_rows),
            (PQ, pq_main[-1], pq_grid + pq_main),
            (DOTS, dots_main[-1], dots_grid + dots_main),
            (IVF8, next(c for c in ivf8_main
                        if c["case"] == "ivf8 search B2048"),
             ivf8_grid + ivf8_main),
            (GATHER, gather_main[-1], gather_grid + gather_main)):
        kernels.append({
            **info, "launches": launches[info["name"]],
            "max_abs_err": max(c["max_abs_err"] for c in all_rows),
            "ms": serve["ms"], "plain_ms": serve["plain_ms"],
            "bound_ms": serve["bound_ms"], "bound_by": serve["bound_by"],
            "library_ms": serve.get("library_ms")})
    log(f"chip_smoke: {time.perf_counter() - t_all:.1f}s")
    emit({"kernels": kernels})
    print(smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
