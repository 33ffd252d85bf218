"""What the benchmark reads from a ``torch.profiler`` trace of its
window: the card's operations, the union of their intervals (the busy
time), the harness's ``stage:<name>`` spans, and the breakdown of the
result line.  The interval union and the H100 peak are frozen copies of
``chip_smoke.py``'s ``device_busy`` and ``HBM_BYTES_PER_S`` (commit
37c8559); ``card_line`` is its copy too."""

from __future__ import annotations

import subprocess
from dataclasses import dataclass, field
from typing import List, Tuple

# H100 SXM device memory rate (NVIDIA's data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
STAGE_PREFIX = "stage:"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def merged(spans: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint intervals, in
    order: overlapping events count once."""
    out: List[List[float]] = []
    for start, end in sorted(spans):
        if out and start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], end)
        else:
            out.append([start, end])
    return [(a, b) for a, b in out]


@dataclass
class Trace:
    """Device operations ``(name, start_s, end_s)`` and stage spans
    ``(stage, start_s, end_s)``, both on the profiler's clock, and the
    traced window's length."""

    ops: List[Tuple[str, float, float]] = field(default_factory=list)
    stages: List[Tuple[str, float, float]] = field(default_factory=list)
    window_s: float = 0.0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in merged([(a, b) for _, a, b in self.ops]))

    def op_seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.ops if match(n))

    def claimed(self, kernels, stages=None) -> List[int]:
        """Indices of the operations whose name holds one of ``kernels``
        and, given ``stages``, that fall in a span of one of them."""
        spans = [(a, b) for n, a, b in self.stages
                 if stages is None or n[len(STAGE_PREFIX):] in stages]
        return [i for i, (n, a, b) in enumerate(self.ops)
                if any(k in n for k in kernels)
                and (stages is None or any(a < s1 and b > s0 for s0, s1 in spans))]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, and the longest
        idle gaps inside the stages, each named by its stage."""
        by_name: dict = {}
        for n, a, b in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        busy = merged([(a, b) for _, a, b in self.ops])
        for name, s0, s1 in self.stages:
            cur = s0
            for a, b in busy:
                if b <= s0 or a >= s1:
                    continue
                if a > cur:
                    gaps.append((name, a - cur))
                cur = max(cur, b)
            if s1 > cur:
                gaps.append((name, s1 - cur))
        gaps.sort(key=lambda g: -g[1])
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def from_profiler(prof, window_s: float) -> Trace:
    """The card's operations and the stage spans of a finished
    ``torch.profiler.profile``.  CUPTI's own buffer events and the
    stages' annotations mirrored onto the device are not operations."""
    import torch

    tr = Trace(window_s=window_s)
    for e in prof.events():
        name = e.name
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if name == "Activity Buffer Request" or name.startswith(STAGE_PREFIX):
                continue
            tr.ops.append((name, start, end))
        elif name.startswith(STAGE_PREFIX):
            tr.stages.append((name, start, end))
    return tr
