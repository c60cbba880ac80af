"""Faults planted in the recompute path, to read what the recompute
cell's comparison gives for them (`benchmark/faults.py`'s kind: each a
context manager that plants its fault in the program and takes it out
again on exit).

  encoder_last_layer_skipped  the passages the traversal re-embeds skip
                              the encoder's last layer (the query
                              embeddings and the engine's seed pool keep
                              it)
  dedup_marks_unencoded       the last chunk of each hop's cache misses
                              is marked cached without being encoded

    python3 -m benchmark.recompute_faults --workload <cell> \\
        --fault <name> --seeds 11,12 [--seconds <window>]

One JSON line a seed on stdout (`seed`, `fault`, `numbers`, `correct`),
as `python3 -m benchmark.control --fault` prints them; on a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
import types


@contextlib.contextmanager
def encoder_last_layer_skipped():
    from leann_tpu_torch.ops import beam

    orig = beam.bert_forward

    def broken(params, token_ids, attention_mask, config):
        short = types.SimpleNamespace(embeddings=params.embeddings,
                                      layers=params.layers[:-1],
                                      rounded_kernel=params.rounded_kernel)
        return orig(short, token_ids, attention_mask, config)

    beam.bert_forward = broken
    try:
        yield
    finally:
        beam.bert_forward = orig


@contextlib.contextmanager
def dedup_marks_unencoded():
    from leann_tpu_torch.ops import beam

    orig = beam._encode_chunks

    def broken(cache_vecs, cache_valid, buf, chunks, *args):
        orig(cache_vecs, cache_valid, buf, chunks[:-1], *args)
        if chunks:
            start, size = chunks[-1]
            cache_valid[buf[start:start + size]] = True

    beam._encode_chunks = broken
    try:
        yield
    finally:
        beam._encode_chunks = orig


FAULTS = {"encoder_last_layer_skipped": encoder_last_layer_skipped,
          "dedup_marks_unencoded": dedup_marks_unencoded}


def main(argv=None) -> int:
    import torch

    from benchmark import run

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.recompute_faults")
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
            # each seed's set-up from its own start, not the process's
            line = run.run_cell(args.workload, seed,
                                args.seconds or bench["run_seconds"], False,
                                dev, bench=bench, t0=time.perf_counter())
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
