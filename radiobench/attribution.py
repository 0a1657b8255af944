"""Put a traced window's device time down to the program's blocks, its
executor and the harness, from the program's own spans and node maps.

What it reads, besides the profiler's device events:

- the program's spans (``grtpu.`` names, on the profiler's host clock):
  ``grtpu.piece:<piece>`` around each call or replay of a ``device_loop``
  piece, ``grtpu.block:<block>`` around a block's ``apply`` where it runs
  eagerly, and the executor's own (``grtpu.run``, ``grtpu.copy_in``,
  ``grtpu.push_read:<block>``, ``grtpu.outputs``, ...);
- the CUDA runtime's launch events, whose correlation id the device events
  they started carry (a graph launch's id is on every node it ran);
- ``StreamExecutor.loop_node_map()``: for each captured piece, its kernel,
  memcpy and memset nodes in capture order as (owner, nodes) runs;
- ``StreamExecutor.loop_stats()`` read at two moments, for the host-clock
  counters a chunk.

A graph launch's device events, in start order, are matched one for one
against its piece's node map; a launch whose event count differs from the
map's goes to ``unmatched`` whole.  Other device work goes to the innermost
``grtpu.block:`` span its launch was made in, else to ``executor`` inside
any ``grtpu.`` span, else to the innermost harness span (``readback``).
None of this is read by ``bench.py`` yet: the result line's metrics and
``breakdown`` come from ``radiobench/trace.py`` alone.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from radiobench.trace import SPAN_PREFIX, _ns, short_name

PROGRAM_PREFIX = "grtpu."
PIECE = PROGRAM_PREFIX + "piece:"
BLOCK = PROGRAM_PREFIX + "block:"
UNMATCHED = "unmatched"
EXECUTOR = "executor"


@dataclass
class Events:
    """What a profiler run holds, reduced to what the attribution reads."""
    spans: List[Tuple[int, int, str]]         # harness and program
    launches: Dict[int, Tuple[int, str]]      # correlation: (t, name)
    device: List[Tuple[int, int, str, int]]   # (start, end, name, corr)


@dataclass
class Attribution:
    window: Tuple[int, int]
    requests: int
    busy_ns: int
    owner_ns: Dict[str, int]            # union of each owner's device time
    ops_ns: Dict[Tuple[str, str], int]  # summed time of (owner, operation)
    mismatches: List[dict] = field(default_factory=list)
    gaps: List[list] = field(default_factory=list)

    def device_blocks(self) -> List[list]:
        """[owner, device ms a request], the most first."""
        return [[k, v * 1e-6 / self.requests] for k, v in
                sorted(self.owner_ns.items(), key=lambda kv: -kv[1])]

    def owner_ops(self, top: int = 5) -> Dict[str, List[list]]:
        """For each owner, [operation, device ms a request] of the ``top``
        operations that took it most time."""
        out: Dict[str, List[list]] = {}
        for (o, n), t in sorted(self.ops_ns.items(), key=lambda kv: -kv[1]):
            if len(out.setdefault(o, [])) < top:
                out[o].append([n, t * 1e-6 / self.requests])
        return out

    def named_share(self) -> float:
        """The share of the window's device-busy time given to an owner
        other than ``unmatched``."""
        return (1.0 - self.owner_ns.get(UNMATCHED, 0) / self.busy_ns
                if self.busy_ns else 0.0)


def _is_span(name: str) -> bool:
    return name.startswith((SPAN_PREFIX, PROGRAM_PREFIX))


def collect(prof) -> Events:
    """The spans, runtime launches and device events of a
    ``torch.profiler`` run (its in-memory results)."""
    spans, launches, device = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type().name == "CPU":
            if _is_span(name):
                spans.append((_ns(e, "start"), _ns(e, "end"), name))
            elif name.startswith("cu") and e.correlation_id():
                launches[int(e.correlation_id())] = (_ns(e, "start"), name)
        elif not _is_span(name):          # not a span's mirror on the card
            device.append((_ns(e, "start"), _ns(e, "end"), name,
                           int(e.correlation_id())))
    return Events(sorted(spans, key=lambda s: (s[0], -s[1])), launches,
                  device)


def open_spans(spans, times) -> List[tuple]:
    """For each time of ``times`` (sorted), the names of the spans open at
    it, outermost first.  ``spans`` are sorted by (start, -end) and nest."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][0] <= t:
            s = spans[i]
            while stack and stack[-1][1] <= s[0]:
                stack.pop()
            stack.append(s)
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(tuple(s[2] for s in stack))
    return out


def _innermost(names, prefix) -> Optional[str]:
    for n in reversed(names):
        if n.startswith(prefix):
            return n
    return None


def owner_of(names) -> str:
    """The owner of eager device work launched inside ``names``."""
    block = _innermost(names, BLOCK)
    if block is not None:
        return block[len(BLOCK):]
    if _innermost(names, PROGRAM_PREFIX) is not None:
        return EXECUTOR
    harness = _innermost(names, SPAN_PREFIX)
    return harness[len(SPAN_PREFIX):] if harness is not None else UNMATCHED


def gap_label(names) -> str:
    """An idle gap's name: the innermost harness span the host was in when
    it began, and the innermost program span under it."""
    harness = _innermost(names, SPAN_PREFIX)
    if harness is None:
        return "between requests"
    program = _innermost(names, PROGRAM_PREFIX)
    h = harness[len(SPAN_PREFIX):]
    return h if program is None else f"{h}/{program}"


def _union(intervals) -> int:
    total, cur = 0, None
    for a, b in sorted(intervals):
        if cur is None or a > cur:
            total += b - a
            cur = b
        elif b > cur:
            total += b - cur
            cur = b
    return total


def attribute(ev: Events, node_map: Dict[str, list],
              top_gaps: int = 10) -> Optional[Attribution]:
    """Each device event of the traced window put down to an owner; None
    where the trace holds no request span."""
    req = [s for s in ev.spans if s[2] == SPAN_PREFIX + "request"]
    if not req:
        return None
    w0, w1 = min(s[0] for s in req), max(s[1] for s in req)
    by_corr: Dict[int, list] = {}
    for d in ev.device:
        by_corr.setdefault(d[3], []).append(d)
    corrs = sorted((ev.launches[c][0], c) for c in by_corr if c in ev.launches)
    where = dict(zip((c for _, c in corrs),
                     open_spans(ev.spans, [t for t, _ in corrs])))
    owned: Dict[str, list] = {}
    ops: Dict[Tuple[str, str], int] = {}
    mismatches = []
    for corr, events in by_corr.items():
        names = where.get(corr)
        if names is None:
            owners = [UNMATCHED] * len(events)
        elif "GraphLaunch" in ev.launches[corr][1]:
            piece = _innermost(names, PIECE)
            runs = node_map.get(piece[len(PIECE):], []) if piece else []
            events.sort()
            owners = [o for o, n in runs for _ in range(n)]
            if len(owners) != len(events):
                mismatches.append({
                    "piece": piece, "events": len(events),
                    "nodes": len(owners),
                    "kinds": _kinds(events)})
                owners = [UNMATCHED] * len(events)
        else:
            owners = [owner_of(names)] * len(events)
        for (a, b, name, _), o in zip(events, owners):
            if b > w0 and a < w1:
                a, b = max(a, w0), min(b, w1)
                owned.setdefault(o, []).append((a, b))
                key = (o, short_name(name))
                ops[key] = ops.get(key, 0) + b - a
    inside = [iv for ivs in owned.values() for iv in ivs]
    att = Attribution((w0, w1), len(req), _union(inside),
                      {o: _union(ivs) for o, ivs in owned.items()}, ops,
                      mismatches)
    gaps, cur = [], w0
    for a, b in sorted(inside):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if w1 > cur:
        gaps.append((cur, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    gaps = sorted(gaps[:top_gaps])
    labels = open_spans(ev.spans, [a for a, _ in gaps])
    att.gaps = sorted(([gap_label(n), (b - a) * 1e-9]
                       for (a, b), n in zip(gaps, labels)),
                      key=lambda g: -g[1])
    return att


def _kinds(events) -> Dict[str, int]:
    """Device events by kind: memcpy, memset or kernel."""
    out: Dict[str, int] = {}
    for _, _, name, _ in events:
        k = ("memcpy" if name.startswith("Memcpy") else
             "memset" if name.startswith("Memset") else "kernel")
        out[k] = out.get(k, 0) + 1
    return out


def executor_device_ms_req(att: Optional[Attribution]) -> Optional[float]:
    """Device-busy ms a request of what the attribution gives the
    executor."""
    if att is None or not att.requests or EXECUTOR not in att.owner_ns:
        return None
    return att.owner_ns[EXECUTOR] * 1e-6 / att.requests


def per_chunk_us(before: Optional[dict], after: Optional[dict],
                 key: str) -> Optional[float]:
    """Host microseconds of counter ``key`` a chunk between two
    ``loop_stats()`` readings; None where either is missing or no chunk
    was stepped between them."""
    if not before or not after:
        return None
    chunks = after["chunks"] - before["chunks"]
    if chunks <= 0:
        return None
    return (after[key] - before[key]) * 1e6 / chunks
