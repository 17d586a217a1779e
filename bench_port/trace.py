"""What a ``torch.profiler`` Chrome trace of the window says of the card.

The window is the span from the start of the first ``bench.pass`` to the
end of the last (the harness's own spans, recorded with
``torch.profiler.record_function``).  Busy time is the union of kernel,
copy and set intervals over all streams inside it; the idle rest is
split by the innermost ``bench.*`` span the host was in.  The interval
arithmetic is ``chip_smoke.merged_intervals`` / ``trace_summary``'s,
over this window instead of the profiler's own span.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "bench."
PASS_SPAN = "bench.pass"


def merged_intervals(spans) -> List[List[float]]:
    """The union of (start, end) spans as sorted disjoint [start, end]."""
    merged: List[List[float]] = []
    for start, end in sorted(spans):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def covered(spans) -> float:
    return sum(b - a for a, b in merged_intervals(spans))


@dataclass
class TraceSummary:
    """Times in seconds."""

    window_s: float
    busy_s: float
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]   # idle seconds of the window by host span
    # (start, end) of every device event in the window, by kernel name.
    kernels: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    passes: int = 0


def idle_by_span(spans, gaps) -> Dict[str, float]:
    """Idle time by what the host was doing: each piece of every idle
    gap goes to the innermost (shortest) ``bench.*`` span covering it."""
    owned: Dict[str, float] = {}
    for start, end in gaps:
        inside = [(max(a, start), min(b, end), b - a, name) for a, b, name in spans
                  if b > start and a < end]
        cuts = sorted({start, end, *(x for a, b, _, _ in inside for x in (a, b))})
        for lo, hi in zip(cuts, cuts[1:]):
            covering = [(length, name) for a, b, length, name in inside if a <= lo and b >= hi]
            name = min(covering)[1] if covering else "outside bench spans"
            owned[name] = owned.get(name, 0.0) + hi - lo
    return owned


def summarize(events: Sequence[dict], top: int = 10) -> TraceSummary:
    """The window's busy time, its ``top`` device operations by summed
    time and its idle time by host span, the ``top`` largest."""
    device, spans = [], []
    for event in events:
        if event.get("ph") != "X":
            continue
        start = float(event["ts"])
        end = start + float(event.get("dur", 0.0))
        cat = event.get("cat", "")
        if cat in DEVICE_CATEGORIES:
            device.append((start, end, event["name"]))
        elif cat == "user_annotation" and event["name"].startswith(SPAN_PREFIX):
            spans.append((start, end, event["name"]))
    passes = [(a, b) for a, b, name in spans if name == PASS_SPAN]
    if not passes:
        raise ValueError("the trace holds no bench.pass span")
    lo, hi = min(a for a, _ in passes), max(b for _, b in passes)
    inside = [(max(a, lo), min(b, hi), name) for a, b, name in device if b > lo and a < hi]
    busy = merged_intervals((a, b) for a, b, _ in inside)
    by_name: Dict[str, float] = {}
    kernels: Dict[str, List[Tuple[float, float]]] = {}
    for a, b, name in inside:
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        kernels.setdefault(name, []).append((a * 1e-6, b * 1e-6))
    edges = [lo] + [x for span in busy for x in span] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2) if edges[i + 1] > edges[i]]
    idle = sorted(idle_by_span(spans, gaps).items(), key=lambda item: -item[1])[:top]
    ranked = sorted(by_name.items(), key=lambda item: -item[1])[:top]
    return TraceSummary(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_ops=[(name, seconds * 1e-6) for name, seconds in ranked],
        idle_gaps=[(name, seconds * 1e-6) for name, seconds in idle],
        kernels=kernels,
        passes=len(passes),
    )


def read_trace(path: str) -> List[dict]:
    with open(path) as handle:
        return json.load(handle)["traceEvents"]
