"""The benchmark of `leann_tpu_torch`, one cell a run.

    python3 -m benchmark.run --workload <cell> --seed <n> \\
        --seconds <run_seconds> --trace <0|1>

From the root of a checkout. The cell is looked up in `BENCHMARK.json`;
its configuration file, its traffic file (`benchmark/traffic/<mix>.json`,
whose `driver` names a module of `benchmark/drivers/`), its limits
(`benchmark/limits/<cell>.json`) and its per-layer readers
(`benchmark/metrics/<metric>.py`) are found by name. In order: the
inputs from the seed and the program's set-up (`setup_s`, from process
start), the window of `--seconds`, with `--trace 1` a profiled
sub-window and the readers, then the plain reference's comparison.

stderr: progress, the card and its power limit, each compared number
beside its limit (last). stdout: one JSON line, last: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or
with `--trace 1` its per-layer ones), `device`, with `--trace 1`
`breakdown`, and `limits` last. Exits non-zero with no result line
without a CUDA card, when the program is missing, and when `jax`,
`jaxlib`, `flax` or `leann_tpu` is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, Optional  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "leann_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def load_bench(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json"), encoding="utf-8") as f:
        return json.load(f)


def find_cell(bench: dict, name: str, root: str = ROOT):
    """(cell, configuration, traffic) of the workload `name`, the two
    files read from disk (the traffic's path kept as `_path`)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; one of {sorted(cells)}")
    cell = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, conf["file"]), encoding="utf-8") as f:
        config = json.load(f)
    path = os.path.join(root, "benchmark", "traffic",
                        cell["traffic"] + ".json")
    with open(path, encoding="utf-8") as f:
        traffic = json.load(f)
    traffic["_path"] = path
    return cell, config, traffic


def metrics_of(bench: dict, kind: str, cell: str):
    """The `end_to_end` or `per_layer` entries the cell reports."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


def load_reader(name: str, root: str = ROOT):
    """`benchmark/metrics/<name>.py`, loaded by file (names may hold
    dots)."""
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             root: str = ROOT, bench: Optional[dict] = None,
             t0: float = T0) -> dict:
    """One run of cell `name` on `device`; returns the result line (a
    dict, `limits` last) and logs each compared number."""
    import torch

    from benchmark.profiling import SubWindow
    from benchmark.reference import judge

    bench = bench or load_bench(root)
    cell, config, traffic = find_cell(bench, name, root)
    driver = importlib.import_module("benchmark.drivers." + traffic["driver"])
    out_dir = os.path.join(root, "benchmark", "_out")
    run = driver.Cell(config, traffic, seed, device, log, out_dir, name)
    run.inputs()
    log(f"inputs made at {time.perf_counter() - t0:.2f} s")
    run.setup()
    # set-up's objects are promoted once, here: the full collection that
    # follows a set-up of millions of objects is not the window's
    gc.collect()
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.2f} s")

    sub = SubWindow(out_dir, name) if trace else None
    if sub is not None:
        sub.warm()
    res = run.window(seconds, sub)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    profile = sub.read() if sub is not None else None

    layer: Dict[str, dict] = {}
    if trace:
        ctx = run.context(profile)
        for m in metrics_of(bench, "per_layer", name):
            value = load_reader(m["name"], root).read(ctx, log)
            if value is None:
                log(f"{m['name']}: nothing to read in this run")
                continue
            layer[m["name"]] = {"value": value, "unit": m["unit"]}
    run.release()

    extra, numbers = run.judge()
    with open(os.path.join(root, "benchmark", "limits", name + ".json"),
              encoding="utf-8") as f:
        limits = json.load(f)["limits"]
    correct, lines = judge.verdict(numbers, limits)
    others = {k: v for k, v in numbers.items() if k not in limits}
    if others:
        log(f"numbers not held to a limit: {json.dumps(others)}")

    e2e = dict(res["metrics"], **extra, setup_s=setup_s)
    if trace:
        metrics = layer
    else:
        metrics = {}
        for m in metrics_of(bench, "end_to_end", name):
            if m["name"] not in e2e:
                raise RuntimeError(f"{name} does not report {m['name']}")
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else "cpu"),
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": peak,
    }
    line = {"correct": correct, "attempted": int(res["attempted"]),
            "failed": int(res["failed"]), "metrics": metrics,
            "device": dev_info}
    if trace:
        if profile is not None:
            dev_info["busy_s"] = profile.busy_s()
            dev_info["window_s"] = profile.window_s
            line["breakdown"] = profile.breakdown()
            log("breakdown: " + json.dumps(line["breakdown"]))
        else:
            dev_info["busy_s"] = 0.0
            dev_info["window_s"] = 0.0
    log(f"end to end (this run): {json.dumps(e2e)}")
    line["limits"] = {k: {"value": numbers.get(k), "limit": v}
                      for k, v in sorted(limits.items())}
    line["_lines"] = lines
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    bench = load_bench()
    cell, _, _ = find_cell(bench, args.workload)
    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds,
                    bool(args.trace), torch.device("cuda", 0), bench=bench)
    # after the window: nvidia-smi's start-up is no part of set-up
    log(f"card: {card()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}")
    found = forbidden_modules()
    if found:
        log(f"modules that must not load here are loaded: {found}")
        return 3
    lines = line.pop("_lines")
    for s in lines:
        log(s)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
