"""Reduce a ``torch.profiler`` run to what the per-layer metrics read.

Device events are the profiler's kernels, copies and fills on the card.
Busy time is the length of the union of their intervals (events that
overlap are counted once), taken inside the traced window: from the start
of the first traced request's span to the end of the last one's.  The
harness's own spans (``rb.request`` around a request, and inside it
``rb.traffic``, ``rb.entry``, ``rb.readback``) come from
``torch.profiler.record_function`` on the same clock.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

SPAN_PREFIX = "rb."


def _ns(e, which: str) -> int:
    f = getattr(e, f"{which}_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(e, f"{which}_us")() * 1000)


@dataclass
class Trace:
    window: Tuple[int, int]                   # ns, profiler clock
    device: List[Tuple[int, int, str]]        # (start, end, name) in the window
    spans: List[Tuple[int, int, str]]         # the harness's spans
    requests: int
    busy_ns: int = 0
    gaps: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return self.busy_ns * 1e-9


def reduce(prof) -> Trace | None:
    """The traced window's device events, busy time and idle gaps; None
    where the trace holds no request span."""
    events = prof.profiler.kineto_results.events()
    spans, device = [], []
    for e in events:
        name = e.name()
        if e.device_type().name == "CPU":
            if name.startswith(SPAN_PREFIX):
                spans.append((_ns(e, "start"), _ns(e, "end"), name))
        elif not name.startswith(SPAN_PREFIX):   # not a span's mirror on the card
            device.append((_ns(e, "start"), _ns(e, "end"), name))
    req = [s for s in spans if s[2] == SPAN_PREFIX + "request"]
    if not req:
        return None
    w0, w1 = min(s[0] for s in req), max(s[1] for s in req)
    device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                    if b > w0 and a < w1)
    busy, gaps, cur = 0, [], w0
    for a, b, _ in device:
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    return Trace((w0, w1), device, sorted(spans), len(req), busy, gaps)


def short_name(name: str) -> str:
    """A kernel's name without ``void``, anonymous namespaces, its argument
    list and whatever passes 160 characters."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(", 1)[0][:160] or name[:160]


def device_ops(tr: Trace, top: int = 10):
    """[name, seconds] of the device operations that took the most time."""
    tot = {}
    for a, b, n in tr.device:
        n = short_name(n)
        tot[n] = tot.get(n, 0) + (b - a)
    return [[n, t * 1e-9] for n, t in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(tr: Trace, top: int = 10):
    """[name, seconds] of the longest idle gaps, each named by the
    innermost harness span the host was in when the gap began (``between
    requests`` where it was in none)."""
    out = []
    for a, b in sorted(tr.gaps, key=lambda g: g[0] - g[1])[:top]:
        inside = [s for s in tr.spans if s[0] <= a < s[1]]
        name = (min(inside, key=lambda s: s[1] - s[0])[2][len(SPAN_PREFIX):]
                if inside else "between requests")
        out.append([name, (b - a) * 1e-9])
    return out
