"""One run of one cell: make the cell's data from the seed, warm up with
one whole job, run jobs back to back for the window (a closed loop, one
job at a time, each stage one ``alevin_fry_tpu_torch.cli.main`` call
with the argv a user types; each job deletes the outputs of the one
before it but for the first and one sample drawn from the seed), then
work out the expected artifacts with the plain reference and compare
the kept jobs' outputs: the first's, the sample's and the last's.

Everything a cell is made of is found by name: ``configs/<config>.json``
(the deployment and its generator), ``traffic/<traffic>.json`` (the
job's stages and their reference modules), ``metrics/<metric>.py`` (one
reader a metric) and ``kernels/<operation>.json`` (a hand kernel
operation's names and bytes)."""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import os
import random
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from . import check
from .trace import Trace, from_profiler

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level module names that must not be loaded in a run: JAX and the
# JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "alevin_fry_tpu")


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    metrics_e2e: List[dict]
    metrics_layer: List[dict]

    @property
    def params(self) -> dict:
        return {**self.config["sizes"], **self.traffic.get("params", {})}


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: Optional[dict] = None) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` with its files."""
    spec = spec or bench()
    wl = next((w for w in spec["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == wl["config"])
    return Cell(
        name=name, config=json.loads((ROOT / cfg["file"]).read_text()),
        traffic=json.loads((HERE / "traffic" / f"{wl['traffic']}.json").read_text()),
        metrics_e2e=[m for m in spec["end_to_end"] if _reports(m, name)],
        metrics_layer=[m for m in spec["per_layer"] if _reports(m, name)],
    )


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(ctx)``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fry_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_ops() -> List[dict]:
    """Every ``kernels/<operation>.json``: the kernel names an operation's
    device time is matched by, optionally the stages its launches fall
    in, and its bytes per unit of the cell's work."""
    return [dict(json.loads(p.read_text()), name=p.stem)
            for p in sorted((HERE / "kernels").glob("*.json"))]


@dataclass
class Run:
    """What a run measured; the metric readers read it."""

    records: int = 0
    setup_s: float = 0.0
    jobs: List[Dict[str, Tuple[float, float]]] = field(default_factory=list)
    peaks: List[int] = field(default_factory=list)
    written: List[int] = field(default_factory=list)
    trace: Optional[Trace] = None
    counts: Dict[str, int] = field(default_factory=dict)
    failed: int = 0

    @property
    def window_s(self) -> float:
        return self.jobs[-1]["_job"][1] - self.jobs[0]["_job"][0] if self.jobs else 0.0

    def stage_s(self, stage: str) -> Optional[float]:
        spans = [j[stage] for j in self.jobs if stage in j]
        return sum(b - a for a, b in spans) / len(spans) if spans else None


def _io(field: str = "wchar") -> int:
    """A counter of ``/proc/self/io``: by default the bytes this process
    has written through system calls so far; ``write_bytes`` those sent
    to storage, ``cancelled_write_bytes`` those deleted before they were."""
    try:
        for line in Path("/proc/self/io").read_text().splitlines():
            if line.startswith(field + ":"):
                return int(line.split()[1])
    except OSError:
        pass
    return 0


def _cpu() -> Tuple[float, float]:
    """The process's user and system CPU seconds so far."""
    t = os.times()
    return t.user, t.system


def _argv(template: List[str], fmt: dict) -> List[str]:
    return [a.format(**fmt) for a in template]


class Runner:
    """Runs a traffic's stages through the port's CLI on ``device``."""

    def __init__(self, cell: Cell, work: Path, device: str):
        import torch

        from alevin_fry_tpu_torch.cli import main

        self.cell, self.work, self.device = cell, work, device
        self.torch, self.main = torch, main
        self.cuda = device == "cuda"
        self.cpu: List[Dict[str, Tuple[float, float]]] = []

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def stages(self, stages: List[dict], job: Path, trace: bool) -> Dict[str, tuple]:
        """Run ``stages`` into ``job``; returns each stage's span and the
        job's.  A stage that fails raises."""
        fmt = dict(self.cell.params, data=self.work / "data", setup=self.work / "setup",
                   job=job, device=self.device)
        spans, cpu = {}, {}
        self.sync()
        t_job = time.perf_counter()
        for st in stages:
            ctx = (self.torch.profiler.record_function(f"stage:{st['name']}") if trace
                   else contextlib.nullcontext())
            with ctx:
                c0, t0 = _cpu(), time.perf_counter()
                rc = self.main(_argv(st["argv"], fmt))
                self.sync()
                t1, c1 = time.perf_counter(), _cpu()
            cpu[st["name"]] = (c1[0] - c0[0], c1[1] - c0[1])
            if rc != 0:
                raise RuntimeError(f"stage {st['name']} exited with {rc}")
            spans[st["name"]] = (t0, t1)
        spans["_job"] = (t_job, time.perf_counter())
        self.cpu.append(cpu)
        return spans


def _drop_previous(work: Path, last: int, sample: Optional[int], rng) -> Optional[int]:
    """Delete the outputs of the job before ``last`` unless it is the
    first job, or is drawn from ``rng`` as the one sample of the jobs
    between the first and the last (a reservoir of one, so each is drawn
    alike).  Returns the sample's index."""
    prev = last - 1
    if prev < 1:
        return sample
    if rng.random() * prev < 1:
        if sample is not None:
            shutil.rmtree(work / f"job{sample}")
        return prev
    shutil.rmtree(work / f"job{prev}")
    return sample


def expected_artifacts(cell: Cell, data: dict, counts: dict, control: str = "",
                       log=None) -> dict:
    """``{stage: {artifact: (kind, value)}}`` from the reference modules,
    set-up stages first; ``control`` breaks the named guarantee."""
    state = {"counts": counts, "control": control}
    out = {}
    for st in cell.traffic.get("setup", []) + cell.traffic["stages"]:
        mod = importlib.import_module(f"fry_bench.reference.{st['reference']}")
        t0 = time.perf_counter()
        out[st["name"]] = mod.expect(data, cell.params, state)
        if log is not None:
            print(f"reference {st['name']}: {time.perf_counter() - t0:.3f} s", file=log)
    return out


def compare_job(cell: Cell, expected: dict, fmt: dict, stages: List[dict]) -> Dict[str, int]:
    found = {}
    for st in stages:
        out_dir = Path(st["out"].format(**fmt))
        for art, n in check.compare(out_dir, expected[st["name"]]).items():
            found[f"{st['name']}:{art}"] = n
    return found


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None, log=sys.stderr) -> dict:
    """One run; returns the result line's object.  ``t_start``: when the
    process started (set-up counts from there)."""
    t_start = time.perf_counter() if t_start is None else t_start
    base = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    work = Path(tempfile.mkdtemp(prefix="fry_bench_", dir=base))
    try:
        return _run(cell, seed, seconds, trace, device, t_start, work, log)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(cell, seed, seconds, trace, device, t_start, work, log) -> dict:
    run = Run()
    runner = Runner(cell, work, device)
    torch = runner.torch
    gen = importlib.import_module(f"fry_bench.gen.{cell.config['generator']}")
    w0, t0 = _io(), time.perf_counter()
    data = gen.make(work / "data", seed, **cell.config["sizes"])
    run.records = int(data["n_records"])
    print(f"data: {run.records} records in {time.perf_counter() - t0:.3f} s, "
          f"{_io() - w0} B written; process start to here {t0 - t_start:.3f} s", file=log)
    setup_stages = cell.traffic.get("setup", [])
    if setup_stages:
        runner.stages(setup_stages, work / "setup", False)
    w0, t0 = _io(), time.perf_counter()
    runner.stages(cell.traffic["stages"], work / "warmup", False)
    print(f"warm-up job: {time.perf_counter() - t0:.3f} s, {_io() - w0} B written",
          file=log)
    shutil.rmtree(work / "warmup")
    run.setup_s = time.perf_counter() - t_start

    acts = [torch.profiler.ProfilerActivity.CPU]
    if runner.cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    error = None
    rng, sample = random.Random(seed), None
    with (torch.profiler.profile(activities=acts) if trace else contextlib.nullcontext()) as prof:
        t_window = time.perf_counter()
        while not run.jobs or time.perf_counter() - t_window < seconds:
            if runner.cuda:
                torch.cuda.reset_peak_memory_stats()
            w0 = _io()
            try:
                run.jobs.append(runner.stages(cell.traffic["stages"],
                                              work / f"job{len(run.jobs)}", trace))
            except Exception as exc:  # the port failed: the run is not correct
                run.failed += 1
                error = exc
                break
            run.written.append(_io() - w0)
            run.peaks.append(torch.cuda.max_memory_allocated() if runner.cuda else 0)
            sample = _drop_previous(work, len(run.jobs) - 1, sample, rng)
        t_close = time.perf_counter()
    if trace:
        run.trace = from_profiler(prof, t_close - t_window)
    del prof
    if error is not None:
        print(f"job {len(run.jobs)} failed: {error!r}", file=log)
    print(f"window: {len(run.jobs)} jobs in {run.window_s:.3f} s, "
          f"{t_close - t_window - seconds:.3f} s past the window; bytes written a job "
          f"{run.written}; outputs kept of jobs 0, {sample} and the last", file=log)
    print("stage seconds a job (the process's user, system CPU seconds): " + "; ".join(
        ", ".join(f"{k} {b - a:.3f} ({cpu[k][0]:.2f}, {cpu[k][1]:.2f})"
                  for k, (a, b) in j.items() if k != "_job")
        for j, cpu in zip(run.jobs, runner.cpu[-len(run.jobs):])), file=log)
    gc.collect()
    if runner.cuda:
        torch.cuda.empty_cache()

    # the reference, once the window has closed and the peak is read
    t_ref = time.perf_counter()
    expected = expected_artifacts(cell, data, run.counts, log=log)
    worst: Dict[str, int] = {}
    bad_jobs = 0
    for j in sorted({0, len(run.jobs) - 1} | ({sample} if sample is not None else set())):
        fmt = dict(cell.params, data=work / "data", setup=work / "setup", job=work / f"job{j}",
                   device=device)
        found = compare_job(cell, expected, fmt, setup_stages + cell.traffic["stages"])
        bad_jobs += any(found.values())
        for name, n in found.items():
            worst[name] = max(worst.get(name, 0), n)
    print(f"reference and comparison: {time.perf_counter() - t_ref:.3f} s; the run's bytes "
          f"to storage {_io('write_bytes')}, deleted before they got there "
          f"{_io('cancelled_write_bytes')}", file=log)
    checks = {"jobs_failed": {"value": run.failed, "limit": 0}}
    checks.update({n: {"value": v, "limit": 0} for n, v in worst.items()})
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and bool(run.jobs)

    metrics = {}
    for m in (cell.metrics_layer if trace else cell.metrics_e2e):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if runner.cuda else device,
           "kind": torch.cuda.get_device_name(0) if runner.cuda else device,
           "count": 1, "memory_peak_bytes": max(run.peaks, default=0)}
    result = {"correct": correct, "attempted": len(run.jobs) + run.failed,
              "failed": run.failed + bad_jobs, "metrics": metrics, "device": dev}
    if run.trace is not None:
        for op in kernel_ops():
            launches = run.trace.claimed(op["kernels"], op.get("stages"))
            print(f"kernel operation {op['name']}: {len(launches)} launches, "
                  f"{sum(run.trace.ops[i][2] - run.trace.ops[i][1] for i in launches)} s; "
                  f"work {[(k, run.counts.get(k)) for k in op['bytes']]} a job", file=log)
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result
