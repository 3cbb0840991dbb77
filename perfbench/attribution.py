"""What the program's own spans say about a run: the share of the card's
idle time in a traced window that no program span covers, and a program
counter's items a call.

The program opens a `torch.profiler` range "jpegtpu.<name>" around each of
its host layers when `collect_metrics` is on (the harness turns it on in a
`--trace 1` run), on the clock of the card's events. Time in which the card
ran nothing and the host was inside such a range is put down to that layer;
the rest is the harness's own time or host code no span names. Each
function returns None where its run has nothing to read.
"""

from __future__ import annotations

#: The prefix of the program's ranges (its utils/metrics.span).
PROGRAM_PREFIX = "jpegtpu."


def union(intervals) -> list:
    """Half-open [start, end) intervals merged: sorted, disjoint, each
    overlap and nesting counted once."""
    out: list = []
    for s, t in sorted(intervals):
        if t <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def length(intervals) -> int:
    return sum(t - s for s, t in intervals)


def intersection(a: list, b: list) -> list:
    """The overlap of two merged interval lists (union's output)."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, t = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < t:
            out.append([s, t])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _clipped(events, lo: int, hi: int) -> list:
    return union((max(e.start, lo), min(e.end, hi)) for e in events)


def idle_intervals(trace) -> list:
    """The window's stretches in which no kernel, copy or memset ran."""
    lo, hi = trace.window.start, trace.window.end
    idle, at = [], lo
    for s, t in _clipped(trace.device, lo, hi):
        if s > at:
            idle.append([at, s])
        at = t
    if hi > at:
        idle.append([at, hi])
    return idle


def unattributed_idle_pct(run):
    """The share of the traced window's device-idle time that no program
    range ("jpegtpu.*", on any thread the trace recorded) covers, %."""
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    idle = idle_intervals(tr)
    total = length(idle)
    if not total:
        return None
    spans = _clipped([e for e in tr.host if e.name.startswith(PROGRAM_PREFIX)],
                     tr.window.start, tr.window.end)
    return 100.0 * (total - length(intersection(idle, spans))) / total


def items_per_call(run, counter: str):
    """A program counter's (GLOBAL_METRICS) items over the window, per
    call."""
    st = run.stages.get(counter)
    if st is None or not st[0]:
        return None
    calls, _seconds, items = st
    return items / calls
