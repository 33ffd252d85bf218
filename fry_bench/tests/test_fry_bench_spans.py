"""The readers of the program's spans (``fry_bench/spans.py``) on a
hand-built run: two jobs whose stage stamps on the profiler's clock lie
a known offset from the harness's, program spans inside them and a
warm-up tree before them, and device operations at known places."""

import sys

import pytest

import alevin_fry_tpu_torch
from alevin_fry_tpu_torch.spans import Span
from fry_bench import harness
from fry_bench import spans as fspans
from fry_bench.trace import Trace

MAIN, PRODUCER = 1, 2
# profiler clock minus perf_counter clock, a job
OFFSETS = (100.0, 100.0005)
READERS = ("codec_s", "resolve_s", "wait_s", "list_parse_s")


def _span(name, layer, parent, a, b, thread=MAIN):
    sp = Span(name, layer, parent, thread)
    sp.start_ns, sp.end_ns = round(a * 1e9), round(b * 1e9)
    if parent is not None and parent.thread == thread:
        parent.child_ns += sp.end_ns - sp.start_ns
    return sp


def _tree(b):
    """A gpl stage at perf_counter second ``b``: 0.98 s of root, list
    parse 0.5, histogram 0.4 holding decode 0.1 and wait 0.05, write
    0.07, the producer's read on another thread."""
    root = _span("generate-permit-list", "stage", None, b + 0.01, b + 0.99)
    hist = _span("histogram", "resolution", root, b + 0.51, b + 0.91)
    return [_span("list_parse", "codec", root, b + 0.01, b + 0.51),
            _span("read", "codec", root, b + 0.02, b + 0.5, PRODUCER),
            _span("decode", "codec", hist, b + 0.6, b + 0.7),
            _span("wait", "wait", hist, b + 0.7, b + 0.75),
            hist,
            _span("write", "codec", root, b + 0.91, b + 0.98),
            root]


# the warm-up job's tree (before the window) and the window's two jobs
SPANS = _tree(5.0) + _tree(10.0) + _tree(20.0)


def _run(traced=True):
    jobs = [{"gpl": (b, b + 1.0), "_job": (b, b + 1.0)} for b in (10.0, 20.0)]
    trace = None
    if traced:
        trace = Trace(
            stages=[("stage:gpl", b + off, b + 1.0 + off) for b, off in zip((10.0, 20.0), OFFSETS)],
            # in job 0's histogram; across job 0's write, root end and past
            # it; in job 1's decode
            ops=[("k", 110.8, 110.85), ("k", 110.97, 110.995), ("k", 120.61, 120.62)],
            window_s=11.0)
    return harness.Run(records=100, jobs=jobs, trace=trace)


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(fspans, "program_spans", lambda: SPANS)


def test_trees_keep_the_window_and_place_each_stage(program):
    ts = fspans.trees(_run())
    assert [(t.job, t.stage, t.root.name) for t in ts] == [
        (0, "gpl", "generate-permit-list"), (1, "gpl", "generate-permit-list")]
    assert all(len(t.spans) == 6 and len(t.main) == 5 for t in ts)
    assert [t.offset_s for t in ts] == pytest.approx(list(OFFSETS))
    rep = fspans.report(_run())
    assert rep["offset_spread_ms"] == pytest.approx(0.5)
    # job 0's stamps bound the offset to 100.0 at most, job 1's to 100.0005
    # at least: no one offset fits both
    assert rep["offset_bracket_ms"] == pytest.approx(0.5)


def test_idle_by_span_puts_each_gap_in_its_innermost_span(program):
    idle = fspans.idle_by_span(_run())
    want = {"list_parse": 1.0, "histogram": 0.2 + 0.25, "decode": 0.1 + 0.09, "wait": 0.1,
            "write": 0.06 + 0.07, "unspanned": 0.0 + 0.01}
    assert idle == pytest.approx({f"generate-permit-list/{k}": v for k, v in want.items()})
    rep = fspans.report(_run())
    idle_jobs = (1.0 - 0.05 - 0.025) + (1.0 - 0.01)
    assert rep["idle_in_jobs_s"] == pytest.approx(idle_jobs)
    assert rep["idle_in_named_spans_share"] == pytest.approx((sum(want.values()) - 0.01) / idle_jobs)
    assert rep["main_thread_cover_min"] == pytest.approx({"generate-permit-list": 1 - 0.01 / 0.98})
    assert rep["layers_over_stages"] == pytest.approx(0.98)
    assert rep["spans_a_job"] == 7


def test_readers_read_main_thread_seconds_a_job(program):
    want = {"codec_s": 0.5 + 0.1 + 0.07, "resolve_s": 0.4 - 0.15, "wait_s": 0.05,
            "list_parse_s": 0.5}
    for name, value in want.items():
        for metric in (name, f"{name}.rna"):
            assert harness.metric_reader(metric)(_run()) == pytest.approx(value), metric


def test_spans_outside_the_jobs_are_left_out(program, monkeypatch):
    """Only the warm-up tree: nothing in the window to read."""
    monkeypatch.setattr(fspans, "program_spans", lambda: SPANS[:7])
    assert fspans.trees(_run()) == []
    assert fspans.idle_by_span(_run()) is None
    assert all(harness.metric_reader(n)(_run()) is None for n in READERS)


@pytest.mark.parametrize("name", [n + s for n in READERS for s in ("", ".rna")])
def test_readers_return_none_untraced_or_without_the_program_spans(name, program, monkeypatch):
    read = harness.metric_reader(name)
    assert read(_run(traced=False)) is None
    # a program without the span module: the parent commit of the spans
    monkeypatch.undo()
    monkeypatch.delattr(alevin_fry_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "alevin_fry_tpu_torch.spans", None)
    assert fspans.program_spans() is None
    assert read(_run()) is None
