"""Reading a torch.profiler trace of a stretch of the window: the device's
busy seconds (the union of its operations' intervals), its operations by
name, and its idle gaps named by what the host had open.

Adapted from ``bench_torch.py``'s ``breakdown`` and ``traced`` (the
port's first bench; frozen here). The profiler's per-kernel sums have read
below CUDA-event times on this card before, so kernel times come from CUDA
events (``harness.time_ms``); the trace gives the idle share, the event
count and the breakdown.
"""

from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(prof) -> list:
    """The chrome-trace events of a finished profiler (exported into a
    temporary file under TMPDIR and read back)."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def summarize(events: list, top: int = 10) -> dict:
    """busy_s, the count of device operations, the ``top`` operations by
    time and the ``top`` longest idle gaps between the first and the last
    device operation, each gap named by the innermost benchmark span and
    host operation open at its middle."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                  e["name"]) for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
             e["name"], e.get("cat")) for e in events
            if e.get("ph") == "X"
            and e.get("cat") in ("user_annotation", "cpu_op")]
    by_name: dict = {}
    for t0, t1, name in dev:
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    idle, end, busy = [], None, 0.0
    for t0, t1, _ in dev:
        if end is not None and t0 > end:
            idle.append((end, t0))
        busy += max(0.0, t1 - (t0 if end is None else max(t0, end)))
        end = t1 if end is None else max(end, t1)

    def open_at(t, cat):
        spans = [h for h in host if h[3] == cat and h[0] <= t <= h[1]]
        return min(spans, key=lambda h: h[1] - h[0])[2] if spans else "none"

    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy / 1e6,
        "n_device_ops": len(dev),
        "device_ops": [[name, us / 1e6] for name, us in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[f"{open_at((a + b) / 2, 'user_annotation')}|"
                       f"{open_at((a + b) / 2, 'cpu_op')}", (b - a) / 1e6]
                      for a, b in gaps],
    }
