"""Reading the device trace of ``torch.profiler``: the device's busy time
in the traced window, kernel time by name, and the idle gaps labelled by
the benchmark's own spans (``record_function`` ranges named ``pb.*``)."""
from __future__ import annotations

from collections import defaultdict


def _annotation(e) -> bool:
    """A ``record_function`` range (on the host, or its mirror on the
    device's timeline), not an operation."""
    try:
        return bool(e.is_user_annotation())
    except AttributeError:          # an older kineto binding
        return "annotation" in str(getattr(e, "activity_type", str)())


def read(prof, window_span: str = "pb.window") -> dict:
    """{"window_s", "busy_s", "kernels": {name: (seconds, launches)},
    "spans": [(name, start_s, end_s)], "idle": {span: seconds}} of the
    traced window, the ``pb.window`` span: the device busy while any
    kernel, copy or set runs on it, each idle gap charged to the innermost
    of the benchmark's spans around its middle. Span times are seconds
    from the window's start."""
    events = prof.profiler.kineto_results.events()
    spans, ops, ranges = [], [], set()
    for e in events:
        if str(e.device_type()).endswith("CPU") and (
                _annotation(e) or e.name().startswith("pb.")):
            ranges.add(e.name())
    for e in events:
        name = e.name()
        if str(e.device_type()).endswith("CPU"):
            if name.startswith("pb."):
                spans.append((name, e.start_ns(), e.start_ns()
                              + e.duration_ns()))
        elif not _annotation(e) and name not in ranges:
            ops.append((name, e.start_ns(), e.duration_ns()))
    win = [s for s in spans if s[0] == window_span]
    if not win:
        raise RuntimeError(f"no {window_span} span in the trace")
    t0, t1 = win[0][1], win[0][2]
    ops = sorted(((n, s, d) for n, s, d in ops if s < t1 and s + d > t0),
                 key=lambda o: o[1])
    kernels = defaultdict(lambda: [0.0, 0])
    busy, cur_s, cur_e = 0.0, None, None
    gaps = []
    for name, s, d in ops:
        s, e = max(s, t0), min(s + d, t1)
        kernels[name][0] += (e - s) * 1e-9
        kernels[name][1] += 1
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
            else:
                gaps.append((t0, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
        gaps.append((cur_e, t1))
    else:
        gaps.append((t0, t1))
    inner = sorted((s for s in spans if s[0] != window_span),
                   key=lambda s: s[2] - s[1])
    idle = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        label = next((n for n, s, e in inner if s <= mid <= e), "pb.between")
        idle[label] += (b - a) * 1e-9
    return {"window_s": (t1 - t0) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "spans": [(n, (s - t0) * 1e-9, (e - t0) * 1e-9)
                      for n, s, e in spans if n != window_span],
            "idle": dict(idle)}


def breakdown(tr: dict, top: int = 10) -> dict:
    ops = sorted(((k, v[0]) for k, v in tr["kernels"].items()),
                 key=lambda kv: -kv[1])[:top]
    idle = sorted(tr["idle"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def kernel_time(tr: dict, needle: str):
    """(seconds, launches) of the kernels whose name holds ``needle``."""
    s = n = 0
    for k, (t, c) in tr["kernels"].items():
        if needle in k:
            s, n = s + t, n + c
    return s, n
