"""Run one cell of ``BENCHMARK.json`` once:

    python3 -m cotr_bench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

In order: the card is looked for (none, or fewer than the cell asks for,
ends the run with code 2 and no result); the configuration and the weights
are loaded; the cell's inputs are made from the seed; its shapes are warmed
up; the window runs for ``--seconds`` and closes at the end of a whole
request; the answers are compared with the plain reference; the last line
of standard output is the result as one JSON object. With ``--trace 1`` the
window runs under ``torch.profiler`` and the result holds the per-layer
metrics, the device's busy time and the trace's breakdown.

A cell is found by name: its configuration in ``configs/<config>.json``,
its traffic in ``traffic/<traffic>.json``, the entry and the loop that the
traffic names in ``entries/<entry>.py`` and ``loops/<loop>.py``, its
comparison limits in ``limits/<workload>.json`` and each metric's reader
in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "cotr_tpu")


class MetricContext:
    """What a metric's reader sees of a run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def load_bench(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reader(root: Path, metric: str):
    from cotr_bench.drivers import load_code

    return load_code(root, "metrics", metric).read


def metrics_of(bench: dict, cell: str, section: str) -> list:
    """The metrics of ``section`` that this cell reports."""
    names = []
    for m in bench[section]:
        if "workloads" in m:
            if cell in m["workloads"]:
                names.append(m)
        elif section == "end_to_end" or any(
                e["name"] == m["moves"] and cell in e.get("workloads", [cell])
                for e in bench["end_to_end"]):
            names.append(m)
    return names


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def set_caches(root: Path) -> None:
    """Kernel caches inside the checkout, at fixed paths."""
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_ext"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def run_cell(root: Path, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda") -> tuple:
    """Set-up, window, readings and comparison of one cell; returns
    (result dict, compared {name: (value, limit)})."""
    import torch

    from cotr_bench import drivers
    from cotr_bench.trace import WINDOW_SPAN, Trace

    bench = load_bench(root)
    cell = find_cell(bench, workload)
    config = load_json(root / "cotr_bench" / "configs"
                       / f"{cell['config']}.json")
    traffic = load_json(root / "cotr_bench" / "traffic"
                        / f"{cell['traffic']}.json")
    limits = load_json(root / "cotr_bench" / "limits" / f"{workload}.json")
    on_card = device != "cpu"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    ctx = drivers.Context(root, config, traffic, seed, device, traced=trace)
    driver = drivers.make(ctx)
    window = drivers.window_of(ctx)
    driver.build()

    from cotr_tpu_torch.ops import attention

    warm = driver.warm_up(sync)
    sync()
    setup_s = time.perf_counter() - T0

    attention.launches = 0
    attention.shape_counts.clear()
    counters0 = driver.counters()
    driver.spans.seconds.clear()
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    with torch.profiler.record_function(WINDOW_SPAN):
        took = window(driver, seconds, sync)
    if prof is not None:
        prof.__exit__(None, None, None)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0

    shape_counts = dict(attention.shape_counts)
    counters = {k: v - counters0.get(k, 0)
                for k, v in driver.counters().items()}
    counters["steps"] = took["attempted"]
    after = driver.after_window()

    mctx = MetricContext(window_s=took["window_s"], answers=took["answers"],
                         setup_s=setup_s, pool_errors=after["pool_errors"],
                         spans=driver.spans.seconds,
                         shape_counts=shape_counts, counters=counters,
                         sizes=ctx.sizes, traffic=traffic,
                         trace=Trace(prof) if prof is not None else None)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in metrics_of(bench, workload, section):
        value = reader(root, m["name"])(mctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    driver.free()
    if on_card:
        torch.cuda.empty_cache()
    numbers = driver.numbers()
    compared = {k: (float(numbers[k]), float(limits[k])) for k in limits}
    failed = after["failed"]
    correct = all(np.isfinite(v) and v <= lim
                  for v, lim in compared.values()) and failed == 0

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {"correct": bool(correct), "attempted": took["attempted"],
              "failed": failed, "metrics": metrics, "device": dev}
    if mctx.trace is not None:
        dev["busy_s"] = mctx.trace.busy_s()
        dev["window_s"] = mctx.trace.window_s
        result["breakdown"] = mctx.trace.breakdown()
    result["setup"] = {"warm_passes": warm, "setup_s": setup_s,
                       "window_s": took["window_s"]}
    if on_card:
        result["card"] = power_limit()
    result["readings"] = {k: float(v) for k, v in numbers.items()}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, (v, lim) in compared.items()}
    return result, compared


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = find_cell(load_bench(ROOT), args.workload)
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"cotr_bench: the cell needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    set_caches(ROOT)
    result, compared = run_cell(ROOT, args.workload, args.seed,
                                args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"cotr_bench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, (value, limit) in compared.items():
        print(f"compared {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
