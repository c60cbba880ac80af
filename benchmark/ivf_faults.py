"""Faults planted in the IVF path, to read what the IVF cell's comparison
gives for them (`benchmark/faults.py`'s kind: each a context manager
that plants its fault in the program and takes it out again on exit).

  ivf_last_probe_dropped      every query's last probe is left out: the
                              bucket scan reads nprobe - 1 buckets
  kmeans_last_assign_skipped  k-means moves its centres once more after
                              its last assignment and keeps that
                              assignment: the rows are not assigned to
                              the centres the index is built on

    python3 -m benchmark.ivf_faults --workload <cell> --fault <name> \\
        --seeds 11,12 [--seconds <window>]

One JSON line a seed on stdout (`seed`, `fault`, `numbers`, `correct`),
as `python3 -m benchmark.control --fault` prints them; on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import sys


@contextlib.contextmanager
def ivf_last_probe_dropped():
    from leann_tpu_torch.ops import ivf

    orig = ivf.ivf_search

    @functools.wraps(orig)      # the wrapper carries the program's counter
    def broken(*args, **kw):
        kw["nprobe"] = max(1, kw["nprobe"] - 1)
        return orig(*args, **kw)

    ivf.ivf_search = broken
    try:
        yield
    finally:
        ivf.ivf_search = orig


@contextlib.contextmanager
def kmeans_last_assign_skipped():
    import torch

    from leann_tpu_torch.ops import ivf

    orig = ivf.kmeans

    def broken(vectors, k, *args, device=None, **kw):
        centers, assign = orig(vectors, k, *args, device=device, **kw)
        dev = ivf.resolve_device(device)
        moved = ivf._kmeans_update(
            torch.as_tensor(vectors, dtype=torch.float32).to(dev),
            torch.from_numpy(assign).long().to(dev),
            torch.from_numpy(centers).to(dev), k)
        return moved.cpu().numpy(), assign

    ivf.kmeans = broken
    try:
        yield
    finally:
        ivf.kmeans = orig


FAULTS = {"ivf_last_probe_dropped": ivf_last_probe_dropped,
          "kmeans_last_assign_skipped": kmeans_last_assign_skipped}


def main(argv=None) -> int:
    import torch

    from benchmark import run

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.ivf_faults")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    if not torch.cuda.is_available():
        run.log("the faults run on a CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        with FAULTS[args.fault]():
            line = run.run_cell(args.workload, seed,
                                args.seconds or bench["run_seconds"], False,
                                dev, bench=bench)
        for s in line.pop("_lines"):
            run.log(s)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "numbers": {k: v["value"] for k, v in
                                      line["limits"].items()},
                          "correct": line["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
