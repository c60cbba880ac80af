"""Where a call of kernel B5 (`csrc/gather_score.cu`) spends its time.

    python -m leann_tpu_torch.evals.gather_phases [--n 10000000]
        [--b 2048] [--r 48] [--calls 20]

At the roofline's shape (an [n, 128] int8 corpus made on the card,
uniform ids), it prints one JSON line each for:

- `floor`: a graph of `--calls` one-element additions replayed, per call
  (the card's cost of one kernel node in a CUDA graph);
- `timers`: `gather_score` and the first design (`csrc/
  gather_score_rowwise.cu`) per call by the graph timer (`evals.
  gather_roofline.graph_window_ms`) on distinct uniform ids, on a corpus
  of 100,000 rows (12.8 MB, held by the 50 MB L2), and with every call of
  the window on the same ids (their rows stay in L2);
- `bulk_copy`: the staged kernel against a copy of it in which each
  live row is one Hopper 1-D bulk copy (`cp.async.bulk`, D bytes, all of
  a stage's copies completing on one mbarrier with the bytes expected) in
  place of D / 16 `cp.async` copies of 16 bytes, by the graph timer in
  turns (current, bulk, bulk, current);
- `phases`: a copy of `csrc/gather_score.cu` built into
  `leann_tpu_torch/_build/phases/` in which thread 0 of every CTA reads
  %globaltimer at the staged kernel's phase boundaries (entry; the first
  two tiles' ids and queries stored and their rows requested; then per
  tile: rows landed, scored, next tile requested) and lane 0 of every warp reads
  clock64 around its first tile's scoring; one call on the launch plan of
  `ops/gather_score.launch_plan`, after the window's warm-up. Times are
  microseconds from the first CTA's entry, as percentiles (0, 50, 100)
  over the CTAs; `d_*` are per-CTA durations of one phase.

Run from the repository's root on a machine with a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

from leann_tpu_torch.ops import _cuda

BUILD = os.path.join(_cuda.BUILD_DIR, "phases")
SLOTS = 16          # globaltimer slots per CTA
HEADER = """__device__ unsigned long long g_stamps[8192 * %(slots)d];
__device__ long long g_wclk[8192 * 8 * 2];
__device__ __forceinline__ void stamp(int i) {
  if (threadIdx.x == 0 && i < %(slots)d) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
    g_stamps[blockIdx.x * %(slots)d + i] = t;
  }
}
__device__ __forceinline__ void wclk(int i, int it) {
  if ((threadIdx.x & 31) == 0 && it == 0)
    g_wclk[(blockIdx.x * 8 + (threadIdx.x >> 5)) * 2 + i] = clock64();
}

struct Div {""" % {"slots": SLOTS}
FOOTER = """
extern "C" int leann_stamps(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_stamps, (size_t)n * 8);
}
extern "C" int leann_wclk(void* dst, int n) {
  return (int)cudaMemcpyFromSymbol(dst, g_wclk, (size_t)n * 8);
}
"""
# (anchor, replacement): slot 0 entry, 1 first two tiles requested, then
# per tile i (< 3): 2+4i landed, 3+4i scored, 4+4i next tile requested;
# 15 end
ANCHORS = [
    ("struct Div {", HEADER),
    ("  int t = blockIdx.x;\n  if (t >= p.tiles) return;",
     "  int t = blockIdx.x;\n  stamp(0);\n  if (t >= p.tiles) return;\n"
     "  int it = 0;"),
    ("  if (t + 2 * stride < p.tiles) load_tile(p, t + 2 * stride, x);\n",
     "  stamp(1);\n"
     "  if (t + 2 * stride < p.tiles) load_tile(p, t + 2 * stride, x);\n"),
    ("    __syncthreads();\n    score<G, RG>(p, st, t);\n    __syncthreads();",
     "    __syncthreads();\n    stamp(2 + 4 * it);\n    wclk(0, it);\n"
     "    score<G, RG>(p, st, t);\n    wclk(1, it);\n    __syncthreads();\n"
     "    stamp(3 + 4 * it);"),
    ("    if (refill + stride < p.tiles) load_tile(p, refill + stride, x);\n"
     "  }",
     "    if (refill + stride < p.tiles) load_tile(p, refill + stride, x);\n"
     "    stamp(4 + 4 * it);\n    ++it;\n  }\n  stamp(15);"),
]
BULK_HEADER = """__shared__ __align__(8) unsigned long long g_bars[2];
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_wait(unsigned long long* b, unsigned ph) {
  asm volatile("{\\n.reg .pred P1;\\nLAB_WAIT:\\n"
               "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\\n"
               "@P1 bra DONE;\\nbra LAB_WAIT;\\nDONE:\\n}"
               :: "r"(smem_u32(b)), "r"(ph) : "memory");
}

struct Div {"""
BULK_COPY_ROWS = """__device__ __forceinline__ void copy_rows(const Tile p, unsigned char* st,
                                          int t) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* bar = &g_bars[(st - smem) / p.stage_bytes];
  const int* sid = reinterpret_cast<const int*>(st + p.id_off());
  unsigned mine = 0;
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  for (int row = threadIdx.x; row < p.rows(); row += kThreads) {
    const int qi = row / p.by_rps;
    const int id = sid[row];
    if (p.live(t, qi, row - qi * p.rps) && p.inside(id)) {
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];"
          :: "r"(smem_u32(st + (size_t)row * p.d)),
             "l"(p.corpus + (long long)id * p.d), "r"(p.d), "r"(smem_u32(bar))
          : "memory");
      mine += p.d;
    }
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(mine) : "memory");
}
"""
BULK_ANCHORS = [
    ("struct Div {", BULK_HEADER),
    ("  int t = blockIdx.x;\n  if (t >= p.tiles) return;",
     "  int t = blockIdx.x;\n  if (t >= p.tiles) return;\n"
     "  if (threadIdx.x == 0) {\n"
     "    for (int i = 0; i < 2; ++i)\n"
     "      asm volatile(\"mbarrier.init.shared::cta.b64 [%0], %1;\"\n"
     "                   :: \"r\"(smem_u32(&g_bars[i])), \"r\"(kThreads)"
     " : \"memory\");\n"
     "    asm volatile(\"fence.mbarrier_init.release.cluster;\" ::: \"memory\");\n"
     "  }\n  unsigned parity = 0;"),
    ("    cp_wait_all_but_one();           // tile t's copies have landed",
     "    bar_wait(&g_bars[s], (parity >> s) & 1);\n    parity ^= 1u << s;"),
    # the barriers' static shared memory comes off the dynamic cap
    ("cudaFuncAttributeMaxDynamicSharedMemorySize,\n                               *limit);",
     "cudaFuncAttributeMaxDynamicSharedMemorySize,\n                               *limit - 1024);"),
]
PHASES = {"requested": (0, 1), "landed": (1, 2), "scored": (2, 3),
          "next_requested": (3, 4), "landed_2": (4, 6), "scored_2": (6, 7)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def instrument(src: str) -> str:
    for old, new in ANCHORS:
        if src.count(old) != 1:
            raise ValueError(f"instrumentation anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src + FOOTER


def bulk(src: str) -> str:
    """The source with each row fetched by one 1-D bulk copy."""
    start = src.index("__device__ __forceinline__ void copy_rows(")
    end = src.index("\n}\n", start) + 3
    src = src[:start] + BULK_COPY_ROWS + src[end:]
    for old, new in BULK_ANCHORS:
        if src.count(old) != 1:
            raise ValueError(f"bulk-copy anchor not found once: {old!r}")
        src = src.replace(old, new)
    return src


def build():
    """(the phase-stamped library, the bulk-copy library), one nvcc each,
    started together."""
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(_cuda.CSRC_DIR, "gather_score.cu")) as f:
        src = f.read()
    jobs = []
    for name, text in (("gather_score_phases", instrument(src)),
                       ("gather_score_bulk", bulk(src))):
        path = os.path.join(BUILD, name + ".cu")
        with open(path, "w") as f:
            f.write(text)
        so = path[:-3] + ".so"
        jobs.append((so, subprocess.Popen(
            [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", so,
             path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for so, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {so}:\n{log}")
        lib = ctypes.CDLL(so)
        lib.leann_gather_score.argtypes, lib.leann_gather_score.restype = (
            _cuda.SIGNATURES["gather_score"]["leann_gather_score"])
        libs.append(lib)
    for fn in (libs[0].leann_stamps, libs[0].leann_wclk):
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    return libs


def rowwise_score(corpus, ids, q):
    """`gather_score`'s arguments through B5's first design
    (`csrc/gather_score_rowwise.cu`: one CTA per query, rows read straight
    from global memory, the same C interface as its per-row kernel): the
    yardstick the staged kernel is timed against. Nothing on a path of the
    port calls it."""
    import torch

    from leann_tpu_torch.ops.bucket_kernels import _lanes

    lib = _cuda.load("gather_score_rowwise")
    b, r = ids.shape
    w, g = _lanes(corpus, 1, loads=(16, 4))
    out = torch.empty((b, r), dtype=torch.float32, device=q.device)
    err = lib.leann_gather_score(
        corpus.data_ptr(), ids.data_ptr(), q.data_ptr(), out.data_ptr(),
        corpus.shape[0], b, r, corpus.shape[1], w, g,
        torch.cuda.current_stream(q.device).cuda_stream)
    _cuda.check(lib, err, "gather_score_rowwise")
    return out


def pct(x) -> list:
    x = np.asarray(x, dtype=np.float64)
    return [float(np.percentile(x, p)) for p in (0, 50, 100)] if x.size else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--b", type=int, default=2048)
    ap.add_argument("--r", type=int, default=48)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args(argv)

    import torch

    from leann_tpu_torch.evals.gather_roofline import (
        graph_window_ms, make_corpus,
    )
    from leann_tpu_torch.ops import gather_score as gs

    dev = torch.device("cuda:0")
    b, r, d, m = args.b, args.r, 128, args.calls
    gen = torch.Generator(device=dev).manual_seed(0)
    corpus = make_corpus(args.n, d, gen, dev)
    q = torch.randn((b, d), generator=gen, device=dev)
    ids = torch.randint(0, args.n, (m, b, r), generator=gen, device=dev,
                        dtype=torch.int32)
    small = corpus[:100_000].clone()
    ids_small = torch.randint(0, 100_000, (m, b, r), generator=gen,
                              device=dev, dtype=torch.int32)
    same = ids[:1].expand(m, b, r).contiguous()

    def per_call_us(fn, window):
        fn(window[0])
        torch.cuda.synchronize()
        return float(np.mean(graph_window_ms(fn, [window], dev, 5))) / m * 1e3

    one = torch.zeros(1, device=dev)
    emit({"floor": {"tiny_kernel_us": per_call_us(lambda i: one.add_(1), ids)}})
    timers = {}
    for name, fn in (("gather_score", gs.gather_score),
                     ("rowwise_pr4", rowwise_score)):
        timers[name] = {
            "uniform_us": per_call_us(lambda i: fn(corpus, i, q), ids),
            "corpus_100k_us": per_call_us(lambda i: fn(small, i, q),
                                          ids_small),
            "same_ids_us": per_call_us(lambda i: fn(corpus, i, q), same)}
    emit({"timers": timers})

    lib, lib_bulk = build()
    plan = gs.launch_plan(b, r, d, gs._sm_count(0))

    def launcher(library):
        def launch(i):
            out = torch.empty((b, r), dtype=torch.float32, device=dev)
            err = library.leann_gather_score(
                corpus.data_ptr(), i.data_ptr(), q.data_ptr(),
                out.data_ptr(), args.n, b, r, d, plan["qpc"], plan["rps"],
                plan["chunks"], plan["grid"], plan["stage_bytes"],
                torch.cuda.current_stream(dev).cuda_stream)
            if err:
                raise RuntimeError(f"gather_score variant: CUDA error {err}")
            return out
        return launch

    launch, launch_bulk = launcher(lib), launcher(lib_bulk)
    want = gs.gather_score_plain(corpus, ids[1], q)
    got = launch_bulk(ids[1])
    turns = {"current": [], "bulk": []}
    for which in ("current", "bulk", "bulk", "current"):
        fn = (lambda i: gs.gather_score(corpus, i, q)) if which == "current" \
            else launch_bulk
        turns[which].append(per_call_us(fn, ids))
    emit({"bulk_copy": {**turns,
                        "max_abs_err": float((got - want).abs().max()),
                        "nan": bool(torch.isnan(got).any())}})
    instrumented_us = per_call_us(launch, ids)
    torch.cuda.synchronize()
    got = launch(ids[1])
    torch.cuda.synchronize()
    g = plan["grid"]
    st = np.zeros(8192 * SLOTS, np.uint64)
    wc = np.zeros(8192 * 16, np.int64)
    lib.leann_stamps(st.ctypes.data, st.size)
    lib.leann_wclk(wc.ctypes.data, wc.size)
    st = st[: g * SLOTS].reshape(g, SLOTS).astype(np.int64)
    t0 = st[:, 0].min()
    row = {"plan": plan, "instrumented_us": instrumented_us,
           "max_abs_err": float((got - want).abs().max()),
           "span_us": float((st[:, 15].max() - t0) / 1e3),
           "end_us": pct((st[:, 15] - t0) / 1e3)}
    for name, (a, z) in PHASES.items():
        ok = (st[:, a] > 0) & (st[:, z] > 0)
        row[f"d_{name}_us"] = pct((st[ok, z] - st[ok, a]) / 1e3)
    cyc = wc[: g * 16].reshape(g, 8, 2)
    cyc = (cyc[:, :, 1] - cyc[:, :, 0]).astype(np.float64)
    row["warp_score_cycles"] = pct(cyc)
    row["cta_slowest_warp_score_cycles"] = pct(cyc.max(1))
    emit({"phases": row})
    return 0


if __name__ == "__main__":
    sys.exit(main())
