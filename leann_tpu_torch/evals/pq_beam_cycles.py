"""Per-step cycle split and device times of the PQ traversal kernel (B3).

    python -m leann_tpu_torch.evals.pq_beam_cycles \\
        [--cases grid,deep] [--deep-beams 64,256] [--plain] \\
        [--source LABEL=PATH ...]

Each source (by default `csrc/pq_beam.cu` as "current" and
`csrc/pq_beam_scan.cu`, the kernel's earlier design, as "earlier"; a
variant of either may be given as another `--source`) is compiled by
nvcc for sm_90a twice, into `leann_tpu_torch/_build/cycles/`: as it is,
for times, and as a copy in which thread 0 reads clock64 at the step
boundaries of every hop (summed per CTA, then divided by the active
hops of all queries) and whose traversal and settle kernels launch
apart, for the cycle split and the settle pass's device ms by CUDA
events. ptxas reports registers and spills of both.

Cases: the N=4096 D=96 graph of `chip_smoke.phase_kernels_pq` at beam
64 (ksub 256 l2 and ksub 16 ip, E=2, visited log 256, B=1023), and the
`deep` corpus of `chip_smoke.phase_deep` (1M x 96 l2, the engine
`GraphSearcher` picks, B=2048) at each beam of `--deep-beams`, with the
engines' own kernel arguments. Every source must equal `pq_beam_search`
exactly on every case (`--plain`: also `pq_beam_search_plain`). Times:
the uninstrumented builds in turns, forward then backward. One JSON line
per case. Run from the repository's root on a machine with a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

from leann_tpu_torch.ops import _cuda

BUILD = os.path.join(_cuda.BUILD_DIR, "cycles")
STEPS_CURRENT = ("select", "stage", "admit", "score", "merge")
STEPS_EARLIER = ("select", "stage", "score", "admit", "merge")


def _mark(k):
    return (f"    if (tid == 0) {{ const long long t1_ = clock64(); "
            f"acc_[{k}] += t1_ - t0_; t0_ = t1_; }}\n")


def _rep(src, old, new):
    if src.count(old) != 1:
        raise ValueError(f"instrumentation anchor not found once: {old!r}")
    return src.replace(old, new)


def instrument(src):
    """(the source with clock64 reads and a launch mode, its step names).
    The anchors are the step comments of the current kernel or, when it
    has a `6. bitonic` step, of the earlier one."""
    earlier = "// ---- 6. bitonic" in src
    hops = "  int32_t* hops;           // [B] active hops per query\n"
    src = _rep(src, hops, hops + "  unsigned long long* prof;\n")
    src = _rep(src, "int qb, int n_sentinel, void* stream) {",
               "int qb, int n_sentinel, void* stream, unsigned long long* "
               "prof, int mode) {")
    src = _rep(src, "  p.n_sentinel = n_sentinel;\n",
               "  p.n_sentinel = n_sentinel;\n  p.prof = prof;\n")
    decl = ("  long long t0_ = 0;\n"
            "  unsigned long long acc_[5] = {0, 0, 0, 0, 0};\n")
    loop = "  for (int it = 0; it < p.max_iters; ++it) {\n"
    src = _rep(src, loop, loop + "    if (tid == 0) t0_ = clock64();\n")
    store = ("  if (tid == 0 && p.prof) for (int k = 0; k < 5; ++k) "
             "p.prof[(size_t)b * 8 + k] = acc_[k];\n")
    src = _rep(src, "  if (tid == 0) p.hops[b] = hops;\n",
               "  if (tid == 0) p.hops[b] = hops;\n" + store)
    if earlier:
        head = ("  int head = 0;  // ring[t][(head + j) % V] holds "
                "logical position j\n")
        src = _rep(src, head, head + decl)
        anchors = ("    // ---- 2. stage", "    // ---- 3. ADC",
                   "    // ---- 4. admission", "    // ---- 6. bitonic")
        end = "      st_exp[i] = 1;\n    }\n    __syncthreads();\n"
        src = _rep(src, end + "  }\n", end + _mark(4) + "  }\n")
        src = _rep(src, "  pq_beam_kernel<<<",
                   "  if (mode & 1) pq_beam_kernel<<<")
        src = _rep(src, "  pq_settle_kernel<<<",
                   "  if (mode & 2) pq_settle_kernel<<<")
        src += """
extern "C" int leann_cycles_ctas(int smem) {
  cudaFuncSetAttribute(pq_beam_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, pq_beam_kernel,
                                                kThreads, smem);
  return n;
}
"""
    else:
        lane = "  const bool has_lane = tid < C && c < R;\n"
        src = _rep(src, lane, lane + decl)
        anchors = ("    // ---- 2. the records", "    // ---- 3. probe",
                   "    // ---- 5. ADC", "    // ---- 6. merge")
        end = "    cur ^= 1;\n    __syncthreads();\n"
        src = _rep(src, end, end + _mark(4))
        src = _rep(src, "  err = cudaLaunchKernel(trav,",
                   "  if (mode & 1) err = cudaLaunchKernel(trav,")
        src = _rep(src, "  err = cudaLaunchKernel(settle,",
                   "  if (mode & 2) err = cudaLaunchKernel(settle,")
    for k, anchor in enumerate(anchors):
        src = _rep(src, anchor, _mark(k) + anchor)
    return src, STEPS_EARLIER if earlier else STEPS_CURRENT


def build(jobs):
    """[(name, source text)] -> {name: (CDLL, ptxas lines)}, one nvcc per
    source, all started together."""
    os.makedirs(BUILD, exist_ok=True)
    procs = []
    for name, text in jobs:
        cu, so = (os.path.join(BUILD, name + ext) for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(text)
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        out[name] = (ctypes.CDLL(so), ptxas)
    return out


def _sizes(kw):
    from leann_tpu_torch.ops import pq_beam as pb

    _, p2, v, vt = pb._sizes(kw["beam_width"], kw["expansions"],
                             kw["ring_size"], kw["track_visited"])
    return p2, v, (v + 3) & ~3, vt


def launch(torch, lib, kw, outs, mode=None, prof=None):
    """One launch of a built source on kw (pq_beam_search's arguments)
    into outs = (ids, scores, vlog, hops); `mode` (1 traversal, 2 settle,
    3 both) only for instrumented builds."""
    from leann_tpu_torch.ops import pq_beam as pb

    luts, rec = kw["luts"], kw["records"]
    p2, v, _, vt = _sizes(kw)
    slots = pb.pq_layout(kw["r"], kw["m"], kw["bits"])[2]
    args = [*(kw[k].data_ptr() for k in ("luts", "records", "seed_ids",
                                         "seed_scores", "exclude")),
            outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if vt else None, outs[3].data_ptr(),
            (ctypes.c_int * kw["m"])(
                *(pj * pb.LANES + off for pj, off in slots)),
            luts.shape[0], kw["r"], kw["m"], kw["ksub"], kw["bits"],
            rec.shape[1], kw["seed_ids"].shape[1], kw["beam_width"],
            kw["expansions"], p2, v, vt, kw["max_iters"], kw["qb"],
            rec.shape[0] - 1, torch.cuda.current_stream().cuda_stream]
    types = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    if mode is not None:
        args += [prof.data_ptr() if prof is not None else None, mode]
        types += [ctypes.c_void_p, ctypes.c_int]
    fn = lib.leann_pq_beam_search
    fn.argtypes, fn.restype = types, ctypes.c_int
    _cuda.check(lib, fn(*args), "pq_beam_cycles")
    return outs


def new_outs(torch, kw):
    b, l = kw["luts"].shape[0], kw["beam_width"]
    vt = max(_sizes(kw)[3], 1)
    dev = kw["luts"].device
    return (torch.empty((b, l), dtype=torch.int32, device=dev),
            torch.empty((b, l), dtype=torch.float32, device=dev),
            torch.empty((b, vt), dtype=torch.int32, device=dev),
            torch.empty((b,), dtype=torch.int32, device=dev))


def ctas_per_sm(lib, kw, earlier):
    p2, _, vs, vt = _sizes(kw)
    mk, cp, e, l = kw["m"] * kw["ksub"], kw["records"].shape[1], \
        kw["expansions"], kw["beam_width"]
    if earlier:
        smem = lib.leann_pq_beam_smem_bytes
        smem.argtypes, smem.restype = [ctypes.c_int] * 6, ctypes.c_size_t
        return int(lib.leann_cycles_ctas(int(smem(mk, cp, e, p2, vs, vt))))
    fn = lib.leann_pq_beam_ctas_per_sm
    fn.argtypes, fn.restype = [ctypes.c_int] * 7, ctypes.c_int
    return int(fn(mk, cp, e, l, p2, vs, vt))


def settle_work(torch, hops, qb, scores):
    """Active hops per query, and the queries whose group stayed active
    after they converged and whose beam holds a tie (the settle pass's
    work) with their idle hops."""
    b = hops.shape[0]
    h = hops.long()
    group = torch.cat([h, h.new_zeros(-b % qb)]).reshape(-1, qb)
    idle = group.amax(1).repeat_interleave(qb)[:b] - h
    live = torch.isfinite(scores[:, 1:]) & torch.isfinite(scores[:, :-1])
    take = (idle > 0) & ((scores[:, 1:] == scores[:, :-1]) & live).any(1)
    return {"hops_mean": float(h.float().mean()), "hops_max": int(h.max()),
            "settled_queries": int(take.sum()),
            "idle_mean": float(idle[take].float().mean())
            if bool(take.any()) else 0.0,
            "idle_max": int(idle.max())}


def cases(torch, dev, which, deep_beams):
    import chip_smoke as cs
    from leann_tpu_torch.ops.pq_beam import PqBeamEngine
    from leann_tpu_torch.ops.vamana import build_vamana

    if "grid" in which:
        n, d, r, b = 4096, 96, 48, 1023
        rng = np.random.default_rng(d)
        x = cs.make_lowdim(rng, n, d, 16, 64)
        adj, medoid = build_vamana(x, graph_degree=r, complexity=64,
                                   metric="l2", wave_size=4096, device=dev)
        q = torch.from_numpy(x[rng.integers(0, n, b)] + 0.05
                             * rng.standard_normal((b, d)).astype(
                                 np.float32)).to(dev)
        exclude = torch.from_numpy(
            np.where(rng.random(b) < 0.5, rng.integers(0, n, b), -1)
            .astype(np.int32)).to(dev)
        for metric, ksub in (("l2", 256), ("ip", 16)):
            eng = PqBeamEngine(x, adj, medoid, metric=metric, m=16,
                               ksub=ksub, kmeans_iters=6, device=dev)
            yield (f"N=4096 ksub{ksub}/{metric}/E2/tv256", dict(
                eng.kernel_args(q, exclude, 64), expansions=2,
                track_visited=256, max_iters=(4 * 64) // 2 + 32), 10)
    if "deep" in which:
        from leann_tpu_torch.backend import GraphSearcher
        from leann_tpu_torch.store.graphfile import GraphFile

        n, d, batch, nq, m = cs.DEEP_N, 96, 2048, 1024, 4
        pool = cs.make_lowdim(np.random.default_rng(0),
                              n + nq + 3 * m * batch, d, 16, 1024)
        q = torch.from_numpy(np.ascontiguousarray(
            pool[n + nq : n + nq + batch])).to(dev)
        adj, medoid = build_vamana(pool[:n], graph_degree=48, complexity=80,
                                   alpha=1.2, metric="l2", wave_size=8192,
                                   device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            eng = GraphSearcher(pool[:n], GraphFile(adj, medoid, "l2"),
                                metric="l2", base=os.path.join(tmp, "d"),
                                device=dev).engine
        none = torch.full((batch,), -1, dtype=torch.int32, device=dev)
        for beam in deep_beams:
            yield f"deep search L{beam}", eng.kernel_args(q, none, beam), 5


def main(argv=None) -> int:
    import torch

    import chip_smoke as cs
    from leann_tpu_torch.ops import pq_beam as pb

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="grid,deep")
    ap.add_argument("--deep-beams", default="64,256")
    ap.add_argument("--plain", action="store_true")
    ap.add_argument("--source", action="append", default=[],
                    help="LABEL=PATH of a kernel source (repeatable)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("pq_beam_cycles: needs a CUDA device", file=sys.stderr)
        return 2
    sources = [s.split("=", 1) for s in a.source] or [
        ("current", os.path.join(_cuda.CSRC_DIR, "pq_beam.cu")),
        ("earlier", os.path.join(_cuda.CSRC_DIR, "pq_beam_scan.cu"))]
    jobs, steps = [], {}
    for label, path in sources:
        with open(path) as f:
            text = f.read()
        inst, steps[label] = instrument(text)
        earlier = steps[label] is STEPS_EARLIER
        # the timed build of the earlier source gains only the occupancy
        # query the instrumented copy appends
        plain_text = (text + inst[inst.index('extern "C" int leann_cycles')
                                  :] if earlier else text)
        jobs += [("cycles_" + label, inst), ("time_" + label, plain_text)]
    libs = build(jobs)
    dev = torch.device("cuda:0")
    print(json.dumps({"gpu": cs.smi(), "ptxas": {k: v[1] for k, v in
                                                 libs.items()}}), flush=True)
    for label, kw, reps in cases(torch, dev, a.cases.split(","),
                                 [int(x) for x in a.deep_beams.split(",")]):
        ref = pb.pq_beam_search(**kw)
        torch.cuda.synchronize()
        row = {"case": label, "b": kw["luts"].shape[0],
               "l": kw["beam_width"], "ksub": kw["ksub"],
               "e": kw["expansions"], "max_iters": kw["max_iters"]}
        if a.plain:
            plain = pb.pq_beam_search_plain(**kw)
            row["kernel_equals_plain"] = all(
                bool(torch.equal(x, y)) for x, y in zip(ref, plain))
        timed = []
        for src_label, _ in sources:
            earlier = steps[src_label] is STEPS_EARLIER
            lib = libs["cycles_" + src_label][0]
            b = kw["luts"].shape[0]
            prof = torch.zeros((b, 8), dtype=torch.int64, device=dev)
            outs = launch(torch, lib, kw, new_outs(torch, kw), 1, prof)
            torch.cuda.synchronize()
            hops = outs[3].clone()
            launch(torch, lib, kw, outs, 2)
            total = prof.sum(0).double() / float(hops.sum())
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            settle = []
            for _ in range(reps):
                launch(torch, lib, kw, outs, 1)
                start.record()
                launch(torch, lib, kw, outs, 2)
                end.record()
                torch.cuda.synchronize()
                settle.append(start.elapsed_time(end))
            timed_lib = libs["time_" + src_label][0]
            got = launch(torch, timed_lib, kw, new_outs(torch, kw))
            torch.cuda.synchronize()
            row[src_label] = {
                "equal": all(bool(torch.equal(x[:, : y.shape[1]], y))
                             for x, y in zip(got, ref)),
                "cycles_per_hop": {s: float(total[i]) for i, s in
                                   enumerate(steps[src_label])},
                "cycles_total": float(total[:5].sum()),
                "settle_ms": float(np.mean(settle)),
                "ctas_per_sm": ctas_per_sm(timed_lib, kw, earlier),
                **settle_work(torch, hops, kw["qb"], ref[1])}
            timed.append((src_label, timed_lib))
        for src_label, lib in timed + timed[::-1]:
            outs = new_outs(torch, kw)
            ms = cs.cuda_ms(lambda: launch(torch, lib, kw, outs), reps)[0]
            row[src_label].setdefault("ms", []).append(ms)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
