"""The control of a cell's comparison: the plain reference put in the
program's place, computed one precision lower (bfloat16 for the
configurations' float32), judged by the cell's own numbers and limits.
It has to come out not correct. With `--fault`, a run of the cell with
a fault of `benchmark/faults.py` planted underneath its timed path
instead, judged as a run is.

    python3 -m benchmark.control --workload <cell> --seeds 11,12,13 \\
        [--seconds <window>] [--fault <name>]

One JSON line a seed on stdout (`seed`, `numbers`, `correct`). On a card
at the cell's own size; the benchmark's own runs never run it. The
control: exact search of the run's query groups at the cell's batch,
the products in bfloat16. A fault: set-up as a run's, a window of
`--seconds` (by default `run_seconds`), the run's comparison.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

from benchmark import run


def control(name: str, seed: int, seconds: float, device, root=run.ROOT,
            bench=None, dtype=None) -> dict:
    import torch

    from benchmark.reference import judge

    bench = bench or run.load_bench(root)
    _, config, traffic = run.find_cell(bench, name, root)
    driver = importlib.import_module("benchmark.drivers." + traffic["driver"])
    cell = driver.Cell(config, traffic, seed, device, run.log,
                       os.path.join(root, "benchmark", "_out"), name)
    cell.inputs()
    numbers = cell.control(dtype or torch.bfloat16, seconds)
    with open(os.path.join(root, "benchmark", "limits", name + ".json"),
              encoding="utf-8") as f:
        limits = json.load(f)["limits"]
    correct, lines = judge.verdict(numbers, limits)
    for s in lines:
        run.log(s)
    return {"workload": name, "seed": seed, "numbers": numbers,
            "correct": correct}


def fault(name: str, seed: int, seconds: float, device, fault_name: str,
          root=run.ROOT, bench=None) -> dict:
    from benchmark.faults import FAULTS

    with FAULTS[fault_name]():
        line = run.run_cell(name, seed, seconds, False, device, root=root,
                            bench=bench)
    for s in line.pop("_lines"):
        run.log(s)
    return {"workload": name, "seed": seed, "fault": fault_name,
            "numbers": {k: v["value"] for k, v in line["limits"].items()},
            "correct": line["correct"]}


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    seconds = args.seconds or bench["run_seconds"]
    if not torch.cuda.is_available():
        run.log("the control runs on a CUDA card")
        return 2
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.fault:
            out = fault(args.workload, seed, seconds, dev, args.fault,
                        bench=bench)
        else:
            out = control(args.workload, seed, seconds, dev, bench=bench)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
