"""Run one cell of the benchmark of ``etts_torch`` once, on the card:

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``. It sets up the
cell (weights and inputs from the seed, the kernels built, every shape of
the cell warmed up), measures for ``--seconds`` seconds (with ``--trace 1``
a shorter window under ``torch.profiler``: the cell's ``trace_units``),
checks what the timed path produced against the plain reference, and
prints the compared numbers with their limits on standard error and one
JSON line as the last line of standard output. Without a CUDA card, with
fewer cards than the cell asks for, or with JAX or the JAX package loaded,
it exits with 2 and prints no result."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def fail(msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr)
    sys.exit(2)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout;
    JAX kept out of libraries that would load it by themselves."""
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = parse(argv)
    if not (ROOT / "BENCHMARK.json").exists() or not (ROOT / "etts_torch").is_dir():
        fail("run from the root of a checkout that holds BENCHMARK.json and "
             "etts_torch")
    set_cache_dirs(ROOT)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import torch
    from pb import guard, spec
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell["chips"]:
        fail(f"{cell['name']} needs {cell['chips']} cards, "
             f"{torch.cuda.device_count()} found")
    result = run_cell(bench, cell, args.seed, args.seconds, args.trace,
                      "cuda", T_START)
    found = guard.forbidden_loaded()
    if found:
        fail(f"loaded in the measuring process: {', '.join(found)}")
    for name, (value, limit) in result["compared"].items():
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))


def run_cell(bench, cell, seed, seconds, trace, device, t_start,
             prepare=None, traffic=None, config=None):
    """One run of ``cell``; ``prepare(driver)`` may change the driver
    before its set-up (the tests plant faults so, and shrink the traffic
    and the configuration through ``traffic`` and ``config``)."""
    import torch
    from pb import spec, trace as tr
    from pb.drivers.base import compare
    traffic = traffic or spec.traffic(cell["traffic"])
    config = config or spec.config(spec.config_entry(bench, cell["config"]),
                                   ROOT)
    driver = spec.driver(traffic["driver"])(
        traffic, config, seed, device,
        ROOT / "build" / "perfbench" / cell["config"])
    if prepare is not None:
        prepare(driver)
    cuda = torch.device(device).type == "cuda"
    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    metrics, breakdown = {}, None
    device_info = device_of(device, cell["chips"])
    if trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        with profile(activities=acts) as prof:
            driver.run(seconds, traffic["trace_units"])
        t = tr.read(prof)
        ctx = {**driver.layer_context(), "trace": t}
        for m in spec.metrics_of(bench, cell["name"], "per_layer"):
            v = spec.reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=t["busy_s"], window_s=t["window_s"])
        breakdown = tr.breakdown(t)
        del prof
    else:
        driver.run(seconds)
        e2e = driver.end_to_end()
        for m in spec.metrics_of(bench, cell["name"], "end_to_end"):
            v = setup_s if m["name"] == "setup_s" else e2e.get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    print(driver.describe(), file=sys.stderr)
    if cuda:
        device_info["memory_peak_bytes"] = max(
            torch.cuda.max_memory_allocated(i) for i in range(cell["chips"]))
    driver.free_program()
    numbers = driver.check()
    correct, compared = compare(numbers, traffic["check"]["limits"])
    for k, v in numbers.items():
        if k not in compared:
            print(f"read {k}: {v!r}", file=sys.stderr)
    out = {"correct": correct, "attempted": driver.attempted(),
           "failed": driver.failed(), "metrics": metrics,
           "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = compared
    return out


def device_of(device, chips: int) -> dict:
    import torch
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}


if __name__ == "__main__":
    main()
