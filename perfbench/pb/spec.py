"""The benchmark as data: ``BENCHMARK.json`` at the checkout's root names
the cells, configurations and metrics; each is a file of its own under
``perfbench/``, found by its name:

- ``perfbench/traffic/<traffic>.json``: a traffic mix (the ``traffic`` of
  a workload), the driver that runs it (``pb/drivers/<driver>.py``) and
  the limits of its correctness check;
- ``perfbench/configs/<config>.json``: a configuration (the path is the
  config's ``file`` in ``BENCHMARK.json``);
- ``perfbench/metrics/<quantity>.py``: the reader of the per-layer
  metrics ``<quantity>`` and ``<quantity>.<anything>`` (one reader serves
  a quantity in every cell), a function ``read(ctx)`` that returns the
  value or None where it finds nothing to read."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent          # perfbench/


def load_benchmark(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def config(entry: dict, root: Path) -> dict:
    return json.loads((root / entry["file"]).read_text())


def metrics_of(bench: dict, workload: str, kind: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics a cell reports:
    those listing it, and those without a list that move an end-to-end
    metric it reports (a per-layer metric) or list no cells (an end-to-end
    one)."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (workload in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(metric: str, base: Path = HERE):
    """The ``read`` function of ``perfbench/metrics/<quantity>.py``, the
    quantity being the metric's name up to its first dot."""
    quantity = metric.split(".", 1)[0]
    path = base / "metrics" / f"{quantity}.py"
    spec = importlib.util.spec_from_file_location("pb_metric_" + quantity,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The driver class ``Driver`` of ``pb/drivers/<kind>.py``."""
    mod = importlib.import_module(f"pb.drivers.{kind}")
    return mod.Driver
