"""The device's idle time put down to the program's spans.

The program (``bayesnmf_tpu_torch.utils.tracing``) names its phases with
spans ``<layer>.<part>``; while a profiler records, each span is also a
``user_annotation`` event of the chrome trace, on the clock of the
device's operations. Here each idle interval of a profiled stretch (between
its first and its last device operation, as ``profiling.summarize`` takes
them) is split by the program spans open on the host and each piece put
down to the innermost one. The shares are over the stretch's host-clock
wall (``window_s``), the denominator of ``device_idle_share``, so each is
at most that share.
"""

from __future__ import annotations

import re
import statistics

from .profiling import DEVICE_CATS

# the program's span names; the benchmark's own are ``ensemble/<label>``
PROGRAM_SPAN = re.compile(r"[a-z_]+(\.[A-Za-z_]+)*")
STEP = "chains.step"


def in_step(name) -> bool:
    """The step's own span or one of its parts."""
    return name is not None and (name == STEP or name.startswith("step."))


def idle_intervals(events: list) -> list:
    """[(t0_us, t1_us)] where no device operation ran, between the first
    and the last."""
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)))
                 for e in events
                 if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS)
    idle, end = [], None
    for t0, t1 in dev:
        if end is not None and t0 > end:
            idle.append((end, t0))
        end = t1 if end is None else max(end, t1)
    return idle


def _segments(events: list) -> list:
    """[(t0_us, t1_us, name)]: the host's time line cut where a program
    span opens or closes, each piece with its innermost open span."""
    spans = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                     e["name"]) for e in events
                    if e.get("ph") == "X"
                    and e.get("cat") == "user_annotation"
                    and PROGRAM_SPAN.fullmatch(e["name"])),
                   key=lambda s: (s[0], -s[1]))
    out, stack, t = [], [], float("-inf")

    def close(until):
        nonlocal t
        while stack and stack[-1][1] <= until:
            t0, t1, name = stack.pop()
            if t1 > t:
                out.append((t, t1, name))
                t = t1

    for t0, t1, name in spans:
        close(t0)
        if stack and t0 > t:
            out.append((t, t0, stack[-1][2]))
        t = max(t, t0)
        stack.append((t0, t1, name))
    close(float("inf"))
    return out


def idle_by_span(events: list) -> dict:
    """{span name, or None outside every program span: idle seconds}."""
    segs = _segments(events)
    out: dict = {}
    j = 0
    for a, b in idle_intervals(events):
        covered = 0.0
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            s0, s1, name = segs[k]
            piece = min(b, s1) - max(a, s0)
            if piece > 0:
                out[name] = out.get(name, 0.0) + piece / 1e6
                covered += piece
            k += 1
        if b - a > covered:
            out[None] = out.get(None, 0.0) + (b - a - covered) / 1e6
    return out


def _share(events, window_s, keep) -> float | None:
    if window_s <= 0 or not any(e.get("cat") in DEVICE_CATS
                                for e in events):
        return None
    idle = idle_by_span(events)
    return 100.0 * sum(s for name, s in idle.items() if keep(name)) \
        / window_s


def step_idle_share(events: list, window_s: float) -> float | None:
    """The stretch's device-idle time while a step was open on the host
    (%, of the stretch's wall); None without device operations."""
    return _share(events, window_s, in_step)


def prior_update_idle_share(events: list, window_s: float) -> float | None:
    """The same with ``step.prior_update`` innermost; None where no step
    of the stretch had a prior-update span (the update in the kernel)."""
    if not any(e.get("name") == "step.prior_update" for e in events):
        return None
    return _share(events, window_s, lambda n: n == "step.prior_update")


def step_host_ms(spans: list, exclude_ns=None) -> float | None:
    """The median host-clock length (ms) of the ``chains.step`` spans
    (``tracing.take()``'s records), leaving out those that overlap
    ``exclude_ns`` = (t0_ns, t1_ns), the profiled stretch."""
    ms = [(s.t1_ns - s.t0_ns) / 1e6 for s in spans
          if s is not None and s.name == STEP
          and not (exclude_ns and s.t0_ns < exclude_ns[1]
                   and s.t1_ns > exclude_ns[0])]
    return statistics.median(ms) if ms else None
