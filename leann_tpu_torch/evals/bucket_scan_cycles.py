"""Device times, variants and a per-step cycle split of the bucket-major
IVF scan kernels, B2 (`csrc/ivf8_scan.cu`) and B4
(`csrc/ivf_bucket_dots.cu`), both on `csrc/bucket_scan.cuh`.

    python -m leann_tpu_torch.evals.bucket_scan_cycles \\
        [--variant LABEL=NAME=VALUE[,NAME=VALUE...] ...] [--split] \\
        [--reps N] [--cases ivf8_b512,ivf8_b2048,ivf8_hot,ivf_b2048]

Each kernel is compiled by nvcc for sm_90a into
`leann_tpu_torch/_build/bucket_cycles/` as it is ("current"), once per
`--variant` with the given -D definitions (the header's
LEANN_BUCKET_ROWS_I8, LEANN_BUCKET_ROWS_BF16, LEANN_BUCKET_STAGES,
LEANN_BUCKET_MIN_CTAS), and with
`--split` as a copy in which thread 0 of every CTA reads clock64 at the
step boundaries, summed over CTAs: consumer warp 0 (prologue: output
rows, barriers, queries staged; then per tile step: the wait for the
slot, the products, the epilogue and the slot's release) and the
producer warp (per step: the wait for a free slot, the copies). ptxas
reports registers and spills of each build.

Cases: random tables at the shapes of the smoke's main paths, made on
the card from a seed: ivf8 (7479 buckets x cap 2056 x D 96 int8, ~35%
empty slots, l2) at B = 512 and 2048 with uniform probes (P = 8), and a
hot case (all 2048 queries on the same 8 buckets); ivf (2554 x 650 x 128
bf16) at B = 2048. Every build must agree with the plain version within
chip_smoke's tolerance; the work list's items built on the card must
equal `bucket_worklist`'s. Times by CUDA events over `--reps` launches of
each build's C function (the probes' sort done beforehand), all builds
and the earlier design (`csrc/*_pairs.cu`) in turns, forward then
backward; the wrapper's own time over back-to-back calls (sort and
launch included) and its device time by kernel (torch.profiler) for the
current build; a call under torch.cuda.set_sync_debug_mode("error").
One JSON line per case. Run from the repository's root on a machine with
a card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np

from leann_tpu_torch.ops import _cuda

BUILD = os.path.join(_cuda.BUILD_DIR, "bucket_cycles")
STEPS = ("prologue", "wait", "mma", "epilogue", "producer_wait",
         "producer_copy")
SOURCES = {"ivf8": "ivf8_scan", "dots": "ivf_bucket_dots"}


def _rep(src, old, new):
    if src.count(old) != 1:
        raise ValueError(f"instrumentation anchor not found once: {old!r}")
    return src.replace(old, new)


def _mark(k, who="0"):
    return (f"    if (tid == {who}) {{ const long long t1_ = clock64(); "
            f"acc_[{k}] += t1_ - t0_; t0_ = t1_; }}\n")


def _flush(first, last, extra):
    return (f"    if (tid == {first[0]}) {{\n"
            f"      for (int k = {first[1]}; k < {last}; ++k) "
            f"atomicAdd(&g_prof[k], acc_[k]);\n{extra}    }}\n")


def instrument(header):
    """The header with clock64 reads at the scan kernel's step boundaries,
    summed into the device array `g_prof` [8]: consumer warp 0's lane 0
    (prologue, wait for the slot, products, epilogue and release), the
    producer's lane 0 (wait for a free slot, the copies), then the tile
    steps and the items."""
    h = _rep(header, "namespace bucket_scan {\n",
             "namespace bucket_scan {\n__device__ unsigned long long "
             "g_prof[8];\n")
    h = _rep(h, "  if (qn <= 0) return;\n",
             "  if (qn <= 0) return;\n  long long t0_ = clock64();\n"
             "  unsigned long long acc_[6] = {0, 0, 0, 0, 0, 0};\n")
    h = _rep(h, "  const int m = warp % MT",
             _mark(0) + "  const int m = warp % MT")
    wait = ("    mbar_wait(smem_u32(smem + L.bar_off + 8 * slot), "
            "(s / kStages) & 1);\n")
    h = _rep(h, wait, wait + _mark(1))
    h = _rep(h, "    if (kc == L.nkc - 1) epilogue<",
             _mark(2) + "    if (kc == L.nkc - 1) epilogue<")
    tail = ("      mbar_arrive(smem_u32(smem + L.bar_off + 8 * "
            "(kStages + slot)));\n  }\n}\n")
    h = _rep(h, tail, tail[: -len("  }\n}\n")] + _mark(3) + "  }\n"
             + _flush(("0", 0), 4,
                      "      atomicAdd(&g_prof[6], (unsigned long long)"
                      "steps);\n      atomicAdd(&g_prof[7], 1ull);\n")
             + "}\n")
    prod = ("  if (warp == kConsumers / 32) {  // the producer warp: the "
            "ring's copies\n")
    h = _rep(h, prod, prod + "    t0_ = clock64();\n")
    copy = "      produce<kI8>(a, smem, slot0, s);\n    }\n    return;\n"
    h = _rep(h, copy, _mark(4, "kConsumers") + "      produce<kI8>(a, smem, "
             "slot0, s);\n" + _mark(5, "kConsumers") + "    }\n"
             + _flush(("kConsumers", 4), 6, "") + "    return;\n")
    return h


PROF_API = """
extern "C" int leann_cycles_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, bucket_scan::g_prof,
                                   sizeof(bucket_scan::g_prof));
}
extern "C" int leann_cycles_reset() {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return (int)cudaMemcpyToSymbol(bucket_scan::g_prof, z, sizeof z);
}
"""


def build(jobs):
    """[(name, source text, header text, defines)] -> {name: (CDLL,
    ptxas lines)}; one nvcc per build, all started together."""
    procs = []
    for name, src, header, defs in jobs:
        d = os.path.join(BUILD, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "bucket_scan.cuh"), "w") as f:
            f.write(header)
        cu, so = os.path.join(d, "k.cu"), os.path.join(d, "k.so")
        with open(cu, "w") as f:
            f.write(src)
        procs.append((name, so, subprocess.Popen(
            [_cuda._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", *(f"-D{x}" for x in defs), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        ptxas = [ln.split(":", 1)[-1].strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
        lib = ctypes.CDLL(so)
        lib_name = SOURCES[name.split("/")[0]]
        for fn, (argtypes, restype) in _cuda.SIGNATURES[lib_name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.leann_cuda_error_string.argtypes = [ctypes.c_int]
        lib.leann_cuda_error_string.restype = ctypes.c_char_p
        if hasattr(lib, "leann_cycles_read"):
            lib.leann_cycles_read.argtypes = [ctypes.c_void_p]
        out[name] = (lib, ptxas)
    return out


def make_cases(torch, dev, names):
    """{name: (kind, args, metric)} of random tables at the main paths'
    shapes."""
    g = torch.Generator(device=dev).manual_seed(8)
    cases = {}
    if any(n.startswith("ivf8") for n in names):
        k, cap, d = 7479, 2056, 96
        pay = torch.randint(-127, 128, (k, cap, d), generator=g, device=dev,
                            dtype=torch.int8)
        scale = torch.rand((k, cap), generator=g, device=dev) * 0.05
        nsq = torch.rand((k, cap), generator=g, device=dev) * 100
        ids = torch.arange(k * cap, dtype=torch.int32,
                           device=dev).reshape(k, cap)
        ids[torch.rand((k, cap), generator=g, device=dev) < 0.35] = -1
        cent = torch.randn((k, d), generator=g, device=dev) * 3
        tables = (pay, scale, nsq, ids, cent)
        for b in (512, 2048):
            q = torch.randn((b, d), generator=g, device=dev) * 3
            probe = torch.randint(0, k, (b, 8), generator=g, device=dev,
                                  dtype=torch.int32)
            cases[f"ivf8_b{b}"] = ("ivf8", (q, probe, *tables), "l2")
        hot = torch.randint(0, k, (8,), generator=g, device=dev,
                            dtype=torch.int32)
        cases["ivf8_hot"] = ("ivf8", (q, hot.expand(2048, 8).contiguous(),
                                      *tables), "l2")
    if "ivf_b2048" in names:
        k, cap, d = 2554, 650, 128
        vecs = (torch.randn((k, cap, d), generator=g, device=dev) * 2).to(
            torch.bfloat16)
        q = torch.randn((2048, d), generator=g, device=dev) * 2
        probe = torch.randint(0, k, (2048, 8), generator=g, device=dev,
                              dtype=torch.int32)
        cases["ivf_b2048"] = ("dots", (q, probe, vecs), "ip")
    return {n: cases[n] for n in names}


def launcher(torch, kind, args, metric):
    """fn(lib) -> out: one launch of a build's C function on the case,
    the probes sorted once beforehand, as the wrapper sorts them."""
    from leann_tpu_torch.ops import bucket_kernels as bk

    q, probe, table = args[:3]
    (b, d), p, (k, cap) = q.shape, probe.shape[1], table.shape[:2]
    qmax = bk._qmax(d)
    g = bk._n_items(b * p, k, qmax)
    skey, pairs = bk._sorted_keys(probe, k)
    scratch = torch.empty(k + 2 + 3 * g, dtype=torch.int32, device=q.device)
    vec = bk._vec(table, 2 if kind == "dots" else 1)
    stream = torch.cuda.current_stream().cuda_stream

    def run(lib):
        # the pointers are taken here, so the closure keeps the tensors
        head = (q.data_ptr(), skey.data_ptr(), pairs.data_ptr(),
                scratch.data_ptr(), scratch[k + 2:].data_ptr())
        if kind == "dots":
            out = torch.empty((p, b, cap), dtype=torch.float32,
                              device=q.device)
            err = lib.leann_ivf_bucket_dots(
                *head, table.data_ptr(), out.data_ptr(), b, p, k, cap, d, g,
                qmax, vec, stream)
        else:
            out = torch.empty((b, p, cap), dtype=torch.float32,
                              device=q.device)
            err = lib.leann_ivf8_bucket_scores(
                *head, *(t.data_ptr() for t in args[2:]), out.data_ptr(),
                b, p, k, cap, d, g, qmax, vec, int(metric == "l2"), stream)
        _cuda.check(lib, err, "bucket_scan_cycles")
        return out

    def items(lib):
        lib.leann_bucket_items(skey.data_ptr(), b * p, k, qmax, g,
                               scratch.data_ptr(),
                               scratch[k + 2:].data_ptr(), stream)
        return scratch[k + 2:].view(g, 3).clone()

    return run, items


def earlier(torch, kind, args, metric):
    """The earlier design (one CTA per (query, probe)) on the case."""
    from leann_tpu_torch.ops import bucket_kernels as bk

    ts = [t.contiguous() for t in args]
    q, probe, table = ts[:3]
    (b, d), p, (k, cap) = q.shape, probe.shape[1], table.shape[:2]
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "dots":
        lib = _cuda.load("ivf_bucket_dots_pairs")
        out = torch.empty((p, b, cap), dtype=torch.float32, device=q.device)
        err = lib.leann_ivf_bucket_dots(
            *(t.data_ptr() for t in ts), out.data_ptr(), b, p, k, cap, d,
            *bk._lanes(table, 2), stream)
    else:
        lib = _cuda.load("ivf8_scan_pairs")
        out = torch.empty((b, p, cap), dtype=torch.float32, device=q.device)
        err = lib.leann_ivf8_bucket_scores(
            *(t.data_ptr() for t in ts), out.data_ptr(), b, p, k, cap, d,
            *bk._lanes(table, 1), int(metric == "l2"), stream)
    _cuda.check(lib, err, "earlier design")
    return out


def tolerance(torch, kind, args, metric):
    q, table = args[0], args[2]
    if kind == "dots":
        row = float(table.float().norm(dim=2).max())
    else:
        row = 0.0
        for s in range(0, table.shape[0], 256):
            r = (args[6][s : s + 256].norm(dim=1)[:, None]
                 + args[3][s : s + 256]
                 * table[s : s + 256].float().norm(dim=2))
            row = max(row, float(r.max()))
    return 1e-5 * float(q.norm(dim=1).max()) * row * (
        2 if metric == "l2" else 1)


def agree(torch, got, ref, tol):
    live = torch.isfinite(ref)
    err = float((got - ref).abs()[live].max()) if bool(live.any()) else 0.0
    ok = (bool(torch.equal(torch.isneginf(got), torch.isneginf(ref)))
          and not bool(torch.isnan(got).any()) and err <= tol)
    return ok, err


def fingerprint(torch, t):
    """A checksum of a tensor's bytes."""
    v = t.contiguous().view(-1).view(torch.uint8)
    return int(v.to(torch.int64).sum()), int(
        (v.to(torch.int64) * torch.arange(1, v.numel() + 1, device=v.device)
         % 1000003).sum())


def events_ms(torch, fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms_by_kernel(torch, fn):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ms = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CUDA:
            key = ev.key[:50]
            ms[key] = ms.get(key, 0.0) + ev.device_time_total / 1e3
    return dict(sorted(ms.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    import torch

    from leann_tpu_torch.ops import bucket_kernels as bk

    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--cases", default="ivf8_b512,ivf8_b2048,ivf8_hot,"
                                       "ivf_b2048")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bucket_scan_cycles: needs a CUDA device")
    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    variants = {"current": []}
    for v in a.variant:
        label, defs = v.split("=", 1)
        variants[label] = defs.split(",")
    with open(os.path.join(_cuda.CSRC_DIR, "bucket_scan.cuh")) as f:
        header = f.read()
    jobs = []
    for kind, src_name in SOURCES.items():
        with open(os.path.join(_cuda.CSRC_DIR, src_name + ".cu")) as f:
            src = f.read()
        for label, defs in variants.items():
            jobs.append((f"{kind}/{label}", src, header, defs))
        if a.split:
            jobs.append((f"{kind}/split", src + PROF_API,
                         instrument(header), []))
    _cuda.build(["ivf8_scan_pairs", "ivf_bucket_dots_pairs"])
    libs = build(jobs)
    print(json.dumps({"gpu": smi, "ptxas": {k: v[1] for k, v in
                                            libs.items()}}), flush=True)

    cases = make_cases(torch, dev, a.cases.split(","))
    sums = {name: [fingerprint(torch, t) for t in args]
            for name, (_, args, _) in cases.items()}
    for name, (kind, args, metric) in cases.items():
        # every case's inputs as they were made: no launch before wrote
        # outside its output
        if [fingerprint(torch, t) for t in args] != sums[name]:
            raise AssertionError(f"{name}: inputs changed before the case")
        q, probe, table = args[:3]
        (b, d), p, k = q.shape, probe.shape[1], table.shape[0]
        run, items = launcher(torch, kind, args, metric)
        wrapper = ((lambda: bk.ivf_bucket_dots(*args)) if kind == "dots"
                   else (lambda: bk.ivf8_bucket_scores(*args, metric)))
        plain = ((lambda: bk.ivf_bucket_dots_plain(*args)) if kind == "dots"
                 else (lambda: bk.ivf8_bucket_scores_plain(*args, metric)))
        ref = plain()
        tol = tolerance(torch, kind, args, metric)
        _, want = bk.bucket_worklist(probe, k, bk._qmax(d))
        row = {"case": name, "b": b, "p": p, "k": k, "cap": table.shape[1],
               "d": d, "tol": tol,
               "distinct_buckets": int(torch.unique(probe).numel()),
               "work_items": int((want[:, 2] > 0).sum()), "builds": {}}
        labels = [f"{kind}/{label}" for label in variants]
        for label in labels:
            lib = libs[label][0]
            got = run(lib)
            ok, err = agree(torch, got, ref, tol)
            row["builds"][label] = {
                "ok": ok, "max_abs_err": err,
                "repeat_equal": bool(torch.equal(got, run(lib))),
                "items_equal": bool(torch.equal(items(lib), want)),
                "ctas_per_sm": (lib.leann_ivf_bucket_dots_ctas_per_sm(d)
                                if kind == "dots" else
                                lib.leann_ivf8_bucket_scores_ctas_per_sm(d)),
                "ms_turns": []}
        e_ok, e_err = agree(torch, earlier(torch, kind, args, metric), ref,
                            tol)
        row["earlier"] = {"ok": e_ok, "max_abs_err": e_err, "ms_turns": []}
        order = labels + ["earlier"]
        for label in order + order[::-1]:
            fn = ((lambda: earlier(torch, kind, args, metric))
                  if label == "earlier" else
                  (lambda lib=libs[label][0]: run(lib)))
            (row["earlier"] if label == "earlier" else row["builds"][label])[
                "ms_turns"].append(events_ms(torch, fn, a.reps))
        for r in list(row["builds"].values()) + [row["earlier"]]:
            r["ms"] = float(np.mean(r["ms_turns"]))
        row["wrapper_ms"] = events_ms(torch, wrapper, a.reps)
        row["wrapper_device_ms"] = device_ms_by_kernel(torch, wrapper)
        try:
            torch.cuda.set_sync_debug_mode("error")
            wrapper()
            row["wrapper_syncs"] = False
        except RuntimeError as exc:
            row["wrapper_syncs"] = str(exc)[:200]
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if a.split:
            lib = libs[f"{kind}/split"][0]
            lib.leann_cycles_reset()
            run(lib)
            torch.cuda.synchronize()
            buf = (ctypes.c_ulonglong * 8)()
            lib.leann_cycles_read(buf)
            steps, items_n = max(1, buf[6]), max(1, buf[7])
            row["split"] = {
                "prologue_cycles_per_item": buf[0] / items_n,
                **{f"{s}_cycles_per_step": buf[i] / steps
                   for i, s in enumerate(STEPS) if i},
                "steps_per_item": buf[6] / items_n, "items": buf[7]}
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
