"""Read a cell's compared numbers over many seeds in one process, to set
the limits of its check: for the program as it runs (``sound``), for the
control (``control``: the int8 sample loop and the TF32 reference for the
synthesis cells, the train step in TF32), for the synthesis cells' models
in TF32 (``tf32_decode``), or with half of each train batch left out
(``half_batch``):

    python3 perfbench/calibrate.py --workload ar_bulk_b64 --mode sound \
        --seeds 11 12 13

Each seed is one run of the cell through ``run.run_cell`` with a window of
no length (one batch, one stream, or the three train steps the check
reads); one JSON line a seed with every number the check reads. The
benchmark's runs never run this."""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = Path.cwd()


def planted(mode: str, numbers: dict):
    """``prepare(driver)`` for ``run.run_cell``: plants ``mode`` and keeps
    every number the check reads in ``numbers``."""
    import torch

    def prepare(d):
        if mode == "control":
            d.control = True
        elif mode == "half_batch":
            d.fault = "half_batch"
        elif mode == "tf32_decode":
            build, free = d.build, d.free_program

            def tf32_build():
                build()             # the synthesizers pin float32 first
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True

            def pinned_free():
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
                free()
            d.build, d.free_program = tf32_build, pinned_free
        check = d.check

        def kept():
            numbers.update(check())
            return numbers
        d.check = kept
    return prepare


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--mode", default="sound",
                    choices=("sound", "control", "tf32_decode", "half_batch"))
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    import run
    run.set_cache_dirs(ROOT)
    import torch
    from pb import spec
    bench = spec.load_benchmark(ROOT)
    cell = spec.cell(bench, args.workload)
    for seed in args.seeds:
        numbers = {}
        t0 = time.perf_counter()
        out = run.run_cell(bench, cell, seed, 0.0, 0, "cuda", t0,
                           prepare=planted(args.mode, numbers))
        print(json.dumps({"workload": args.workload, "mode": args.mode,
                          "seed": seed, "correct": out["correct"],
                          "seconds": time.perf_counter() - t0, **numbers}),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
