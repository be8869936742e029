"""The program's own spans and counters (`amv_tpu_torch.utils.profiling`,
kept in memory while the window is profiled) on the traced window's clock.

The program times its spans with `time.perf_counter_ns()`; the harness's
`pb.*` spans come from the Chrome trace, in seconds from the window's
start.  Each program request (a root span: its outermost) is paired, in
order, with the harness span that wraps the program's entry:

    transcode_bytes  with pb.transcode_bytes   (amv.films)
    cli.main         with pb.cli_main          (act.one_file)
    act.demux        with pb.demux             (act.library_decode: a
                                                pass's first act.demux;
                                                the pass's others take
                                                its offset)

and every span of the request is shifted by its own pair's offset, the
harness span's start less the program span's, so the drift between the
two clocks over a window does not count.  `aligned` gives None (and each
reader with it None) when the program keeps no spans (a program without
them), spans were dropped past the program's cap, the pairs disagree in
number, or a program request starts more than TOL after its harness span
(measured against the least delayed pair nearby: `_offsets`) or ends
after it.  Root spans of no request (a build, say) are left out.
"""

from __future__ import annotations

import bisect
from typing import NamedTuple

TOL = 1e-3          # seconds
NEAR = 5.0          # seconds

# program request -> (harness span, several requests to a harness span)
PAIRS = {"transcode_bytes": ("transcode_bytes", False),
         "cli.main": ("cli_main", False),
         "act.demux": ("demux", True)}


class Rec(NamedTuple):
    """A program span on the window's clock (seconds from its start)."""
    name: str
    a: float
    b: float
    thread: int
    id: int
    request: int


class Aligned(NamedTuple):
    spans: list         # Rec, of the paired requests only
    counters: dict      # the program's counters over the window
    self_s: dict        # span id -> self time in seconds


def _passes(reqs, harness):
    """act.demux requests grouped in order into the harness spans (the
    passes), a pass opening at the first request that reaches the next
    harness span on the previous pass's offset; None unless every pass
    gets its group."""
    groups, off = [], None
    for s in reqs:
        t0 = s.start_ns * 1e-9
        if len(groups) < len(harness) and (
                off is None or t0 + off + TOL >= harness[len(groups)][0]):
            groups.append([])
            off = harness[len(groups) - 1][0] - t0
        groups[-1].append(s)
    return groups if len(groups) == len(harness) else None


def _offsets(groups, harness):
    """{request id: its pair's offset}, or None when a pair's program
    request starts more than TOL after its harness span, or ends past it.
    A pair's offset o = harness start - program start is the clocks'
    difference less the request's start delay, so the delay is the
    largest offset of the pairs within NEAR seconds (the least delayed;
    the clocks drift by far less over NEAR) less o."""
    starts = [a for a, _ in harness]
    offs = [a - g[0].start_ns * 1e-9 for a, g in zip(starts, groups)]
    out = {}
    for (a, b), g, o in zip(harness, groups, offs):
        ref = max(offs[bisect.bisect_left(starts, a - NEAR):
                       bisect.bisect_right(starts, a + NEAR)])
        if ref - o > TOL or max(s.end_ns for s in g) * 1e-9 + ref > b + TOL:
            return None
        out.update((s.id, o) for s in g)
    return out


def aligned(view) -> Aligned | None:
    """The program's spans of the traced window on its clock, or None."""
    try:
        from amv_tpu_torch.utils.profiling import DROPPED, recorded, self_ns
    except ImportError:
        return None
    spans, counters = recorded()
    if counters.get(DROPPED):
        return None
    roots = [s for s in spans if s.parent is None and s.name in PAIRS]
    if not roots or len({s.name for s in roots}) != 1:
        return None
    hname, many = PAIRS[roots[0].name]
    reqs = sorted(roots, key=lambda s: s.start_ns)
    harness = sorted((a, b) for n, a, b in view.spans if n == hname)
    if not harness:
        return None
    if many:
        groups = _passes(reqs, harness)
    else:
        groups = [[s] for s in reqs] if len(reqs) == len(harness) else None
    offs = groups and _offsets(groups, harness)
    if not offs:
        return None
    self_s = self_ns(spans)
    recs = [Rec(s.name, s.start_ns * 1e-9 + offs[s.request],
                s.end_ns * 1e-9 + offs[s.request], s.thread, s.id,
                s.request)
            for s in spans if s.request in offs]
    return Aligned(recs, counters,
                   {r.id: self_s[r.id] * 1e-9 for r in recs})


def seconds(al: Aligned, *names) -> float:
    """Seconds spent in the spans with these names (summed over threads)."""
    return sum(r.b - r.a for r in al.spans if r.name in names)


def merged(intervals) -> list:
    """(a, b) intervals -> their union as sorted disjoint (a, b)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        elif b > a:
            out.append((a, b))
    return out


def overlap_s(xs, ys) -> float:
    """Seconds common to two sorted disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(0.0, b - a)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_share_in(view, intervals) -> float | None:
    """The share (%) of the device's idle time in the window (no kernel,
    copy or memset) that these (a, b) intervals cover, or None when the
    device was never idle."""
    w = view.window_s
    busy = merged((a, b) for _, a, b in view.device())
    idle = w - sum(b - a for a, b in busy)
    if idle <= 0:
        return None
    cover = merged((max(a, 0.0), min(b, w)) for a, b in intervals)
    return 100.0 * (sum(b - a for a, b in cover)
                    - overlap_s(cover, busy)) / idle
