"""Time the plain batched decode on the card: ``TTSSynthesizer.predict_many``
on the eight serving texts of ``chip_smoke.py`` (b = 8, the 14k-step export,
its seeded reference and speaker vector, ``max_length`` 1000), as phase 6
of ``chip_smoke.py`` runs it. With ``--other DIR``, the port of another
checkout (``DIR/etts_torch``, imported under another name) is timed on the
same inputs in the same process, the two interleaved (this, other, other,
this, ...), so that both read the same host. Each reading is one call,
warm, between CUDA events, printed beside the card's name and power limit.

    python3 -m etts_torch.time_decode [--other DIR] [--rounds 3]
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _load_other(path: Path):
    """``path/etts_torch`` as the package ``etts_torch_other``."""
    pkg = path / "etts_torch"
    spec = importlib.util.spec_from_file_location(
        "etts_torch_other", pkg / "__init__.py",
        submodule_search_locations=[str(pkg)])
    module = importlib.util.module_from_spec(spec)
    sys.modules["etts_torch_other"] = module
    spec.loader.exec_module(module)
    return importlib.import_module("etts_torch_other.api")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--other", type=Path, default=None,
                   help="a checkout whose etts_torch is timed beside this one")
    p.add_argument("--rounds", type=int, default=3)
    a = p.parse_args(argv)

    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from etts_torch import api
    from etts_torch.utils.precision import pin_float32
    pin_float32()
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 2
    cl = cs.card()
    print(cl, flush=True)
    apis = {"this": api}
    if a.other is not None:
        apis["other"] = _load_other(a.other.resolve())
    spk = np.random.default_rng(0).standard_normal(256).astype(np.float32)
    spk /= np.linalg.norm(spk)
    runs, ref_mel = {}, None
    for name, mod in apis.items():
        tts = mod.TTSSynthesizer(cs.CONFIG, cs.TTS_W, "cuda", step=14000,
                                 phonemizer_backend="grapheme")
        if ref_mel is None:
            ref_mel = tts.mel_from_wav(cs.ref_wav())
        runs[name] = (lambda t=tts: t.predict_many(
            cs.SERVING_TEXTS, ref_mel, spk, max_length=1000, seed=0))
        runs[name]()                                        # warm-up
    order = list(runs) + list(runs)[::-1]
    times = {name: [] for name in runs}
    mels = {}
    for _ in range(a.rounds):
        for name in order:
            ms, mels[name] = cs.cuda_ms(runs[name], 1, warm=False)
            times[name].append(ms)
            cs.say(cl, f"{name}: predict_many of {len(mels[name])} texts "
                       f"({[m.shape[0] for m in mels[name]]} frames) "
                       f"{ms:.1f} ms")
    if "other" in mels:
        same = [x.shape == y.shape for x, y in zip(mels["this"],
                                                    mels["other"])]
        d = max(float(np.abs(x - y).max()) if s else float("inf")
                for x, y, s in zip(mels["this"], mels["other"], same))
        cs.say(cl, f"this vs other: max |dmel| {d:.3e}")
    for name, ts in times.items():
        cs.say(cl, f"{name}: median {float(np.median(ts)):.1f} ms, min "
                   f"{min(ts):.1f}, max {max(ts):.1f} over {len(ts)} calls")
    return 0


if __name__ == "__main__":
    sys.exit(main())
