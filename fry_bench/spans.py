"""The program's spans, placed on the profiler's clock.

The port records one span tree a CLI stage (``alevin_fry_tpu_torch/
spans.py``: a ``stage`` root named by the subcommand, and ``codec``,
``resolution`` and ``wait`` spans inside it), stamped with
``time.perf_counter_ns()``.  The harness runs each stage as one
``cli.main`` call in its own process, so after the window the spans are
in this process's ``SPANS``; they are read from there.  Only the trees
of roots inside the window's jobs count: the set-up and the warm-up job
are left out.  A program without the module, or without spans in the
window (an older commit), reads as nothing: every reader returns
``None``.

Each harness stage is stamped on two clocks: ``run.jobs[i][stage]`` in
``perf_counter`` seconds, and in a traced run ``run.trace.stages`` on
the profiler's clock.  The offset between the two stamps of a stage
places every span inside it beside the card's operations
(``idle_by_span``)."""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from .trace import STAGE_PREFIX, merged


def program_spans() -> Optional[list]:
    """The program's closed spans, or None where it records none."""
    try:
        from alevin_fry_tpu_torch import spans
    except ImportError:
        return None
    return spans.SPANS


@dataclass
class Tree:
    """One stage of one job: the program's root span, the spans under
    it, and the offset that places them on the profiler's clock (None
    in an untraced run)."""

    job: int
    stage: str
    root: object
    spans: list = field(default_factory=list)
    offset_s: Optional[float] = None

    @property
    def main(self) -> list:
        """The spans under the root on its thread."""
        return [sp for sp in self.spans if sp.thread == self.root.thread]


def _stamps(run) -> List[Tuple[int, str, float, float, float, float]]:
    """Each stage's (job, stage, start and end on the perf_counter clock,
    start and end on the profiler's), in the order the stages ran; empty
    in an untraced run."""
    if run.trace is None:
        return []
    host = sorted((t0, t1, i, name) for i, job in enumerate(run.jobs)
                  for name, (t0, t1) in job.items() if name != "_job")
    prof = sorted((s0, s1, name[len(STAGE_PREFIX):]) for name, s0, s1 in run.trace.stages)
    out = []
    for (t0, t1, i, name), (s0, s1, pname) in zip(host, prof):
        if name != pname:
            break
        out.append((i, name, t0, t1, s0, s1))
    return out


def offsets(run) -> List[Tuple[int, str, float]]:
    """Each stage's (job, stage, profiler clock minus perf_counter clock,
    in seconds) from its end's two stamps.  The harness stamps a stage's
    start after the profiler's annotation opens and its end before it
    closes, so the start's two stamps give a lower bound of the offset
    and the end's an upper one; the end's lie microseconds apart, the
    start's up to a millisecond in a window's first stage."""
    return [(i, name, s1 - t1) for i, name, _t0, t1, _s0, s1 in _stamps(run)]


def trees(run, spans: Optional[list] = None) -> List[Tree]:
    """The span trees of the window's jobs, each with its offset, in the
    order they ran."""
    spans = program_spans() if spans is None else spans
    if not spans or not run.jobs:
        return []
    lo, hi = run.jobs[0]["_job"][0] * 1e9, run.jobs[-1]["_job"][1] * 1e9
    inside = [sp for sp in spans if lo <= sp.start_ns and sp.end_ns <= hi]
    found: Dict[int, Tree] = {}
    for sp in inside:
        if sp.parent is not None or sp.layer != "stage":
            continue
        for i, job in enumerate(run.jobs):
            stage = next((n for n, (t0, t1) in job.items() if n != "_job"
                          and t0 * 1e9 <= sp.start_ns and sp.end_ns <= t1 * 1e9), None)
            if stage is not None:
                found[id(sp)] = Tree(i, stage, sp)
                break
    for sp in inside:
        top = sp
        while top.parent is not None:
            top = top.parent
        if top is not sp and id(top) in found:
            found[id(top)].spans.append(sp)
    placed = {(i, name): off for i, name, off in offsets(run)}
    out = sorted(found.values(), key=lambda t: t.root.start_ns)
    for t in out:
        t.offset_s = placed.get((t.job, t.stage))
    return out


def _traced_trees(run, spans=None) -> Optional[List[Tree]]:
    if run.trace is None:
        return None
    return trees(run, spans) or None


def layer_seconds(run, layer: str, spans=None) -> Optional[float]:
    """Self seconds a job of the main thread's spans of ``layer`` in a
    traced run."""
    ts = _traced_trees(run, spans)
    if ts is None:
        return None
    return sum(sp.self_ns for t in ts for sp in t.main if sp.layer == layer) / 1e9 / len(run.jobs)


def named_seconds(run, name: str, spans=None) -> Optional[float]:
    """Seconds a job of the main thread's spans named ``name`` in a
    traced run."""
    ts = _traced_trees(run, spans)
    if ts is None:
        return None
    return sum(sp.end_ns - sp.start_ns for t in ts for sp in t.main
               if sp.name == name) / 1e9 / len(run.jobs)


class _Busy:
    """The card's busy time inside any interval: the union of its
    operations' intervals, with prefix sums."""

    def __init__(self, ops):
        spans = merged([(a, b) for _, a, b in ops])
        self.starts = [a for a, _ in spans]
        self.ends = [b for _, b in spans]
        self.cum = [0.0]
        for a, b in spans:
            self.cum.append(self.cum[-1] + b - a)

    def inside(self, a: float, b: float) -> float:
        i = bisect.bisect_right(self.ends, a)
        j = bisect.bisect_left(self.starts, b)
        if i >= j:
            return 0.0
        return (self.cum[j] - self.cum[i] - max(0.0, a - self.starts[i])
                - max(0.0, self.ends[j - 1] - b))


def _self_intervals(sp, children) -> List[Tuple[int, int]]:
    """The parts of ``sp``'s interval that none of ``children`` covers."""
    out, cur = [], sp.start_ns
    for c in sorted(children, key=lambda c: c.start_ns):
        if c.start_ns > cur:
            out.append((cur, c.start_ns))
        cur = max(cur, c.end_ns)
    if sp.end_ns > cur:
        out.append((cur, sp.end_ns))
    return out


def idle_by_span(run, spans=None) -> Optional[Dict[str, float]]:
    """The card's idle seconds, over the window, inside each span of the
    main thread's trees, by ``<root>/<span>`` name: each moment counts
    in the innermost span open then (``<root>/unspanned`` where only the
    root is).  None in an untraced run."""
    ts = _traced_trees(run, spans)
    if ts is None:
        return None
    busy = _Busy(run.trace.ops)
    out: Dict[str, float] = {}
    for t in ts:
        if t.offset_s is None:
            continue
        main = [t.root] + t.main
        kids: Dict[int, list] = {}
        for sp in t.main:
            kids.setdefault(id(sp.parent), []).append(sp)
        for sp in main:
            key = f"{t.root.name}/{'unspanned' if sp is t.root else sp.name}"
            for a, b in _self_intervals(sp, kids.get(id(sp), [])):
                a_s, b_s = a / 1e9 + t.offset_s, b / 1e9 + t.offset_s
                out[key] = out.get(key, 0.0) + (b_s - a_s) - busy.inside(a_s, b_s)
    return out


def report(run, spans=None) -> Optional[dict]:
    """What a traced run's spans say, for the record: the spread of the
    stages' clock offsets and whether one offset fits them all, the spans
    a job, each stage's least coverage by its main thread's spans, the
    card's idle time inside the jobs and the share of it inside a named
    span, the idle seconds a job by span, and the layers' sum against the
    harness's stage seconds."""
    ts = _traced_trees(run, spans)
    if ts is None:
        return None
    n = len(run.jobs)
    offs = [t.offset_s for t in ts if t.offset_s is not None]
    lows = [s0 - t0 for _i, _n, t0, _t1, s0, _s1 in _stamps(run)]
    highs = [s1 - t1 for _i, _n, _t0, t1, _s0, s1 in _stamps(run)]
    busy = _Busy(run.trace.ops)
    by_job = {t.job: t.offset_s for t in reversed(ts) if t.offset_s is not None}
    idle_jobs = sum((j["_job"][1] - j["_job"][0]) - busy.inside(j["_job"][0] + by_job[i],
                                                                 j["_job"][1] + by_job[i])
                    for i, j in enumerate(run.jobs) if i in by_job)
    idle = idle_by_span(run, spans) or {}
    named = sum(v for k, v in idle.items() if not k.endswith("/unspanned"))
    cover: Dict[str, float] = {}
    for t in ts:
        c = 1 - t.root.self_ns / (t.root.end_ns - t.root.start_ns)
        cover[t.root.name] = min(cover.get(t.root.name, 1.0), c)
    layers = {layer: layer_seconds(run, layer, spans) for layer in ("codec", "resolution", "wait")}
    roots_self = sum(t.root.self_ns for t in ts) / 1e9 / n
    stage_sum = sum(run.stage_s(s) or 0.0 for s in {t.stage for t in ts})
    return {
        "jobs": n,
        "offset_spread_ms": 1e3 * (max(offs) - min(offs)) if offs else None,
        # the largest lower bound of the offset less the least upper one:
        # at most 0 where one offset fits every stage of the window
        "offset_bracket_ms": 1e3 * (max(lows) - min(highs)) if lows else None,
        "spans_a_job": (len(ts) + sum(len(t.spans) for t in ts)) / n,
        "main_thread_cover_min": cover,
        "idle_in_jobs_s": idle_jobs,
        "idle_in_named_spans_share": named / idle_jobs if idle_jobs else None,
        "idle_a_job_by_span": dict(sorted(((k, v / n) for k, v in idle.items()),
                                          key=lambda kv: -kv[1])),
        "layer_s": layers,
        "roots_self_s": roots_self,
        "stage_s_sum": stage_sum,
        "layers_over_stages": (sum(layers.values()) + roots_self) / stage_sum
        if stage_sum else None,
    }
