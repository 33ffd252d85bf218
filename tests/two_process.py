"""Two-process runs of the port's CLI on the CPU, for the multi-process
tests: each rank is a ``tools/stage_worker.py`` subprocess over the gloo
backend, every stage with a coordinator on a free local port of its own.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
WORKER = REPO / "tools" / "stage_worker.py"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def clean_env(**extra) -> dict:
    """This process's environment without the multi-process and device
    policy variables (``AFT_*``, the JAX coordinator), plus ``extra``."""
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("AFT_") and k != "JAX_COORDINATOR_ADDRESS"}
    env["PYTHONPATH"] = os.pathsep.join([str(REPO), env.get("PYTHONPATH", "")])
    env.update(extra)
    return env


def spawn(argvs: list, logs: Path, env: dict, timeout: float) -> list:
    """Start one process per argv (rank r gets ``AFT_PROCESS_ID=r``),
    their output to ``logs``; wait for all within ``timeout`` seconds,
    killing every one at expiry.  Returns (exit code, stdout, stderr)
    per process."""
    logs.mkdir(parents=True, exist_ok=True)
    procs = []
    for r, argv in enumerate(argvs):
        with open(logs / f"r{r}.out", "w") as out, open(logs / f"r{r}.err", "w") as err:
            procs.append(subprocess.Popen(
                argv, stdout=out, stderr=err,
                env={**env, "AFT_NUM_PROCESSES": str(len(argvs)), "AFT_PROCESS_ID": str(r)},
            ))
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.wait()
        raise AssertionError(f"a rank outlived {timeout} s: {(logs / 'r0.err').read_text()[-3000:]}")
    return [(p.returncode, (logs / f"r{r}.out").read_text(), (logs / f"r{r}.err").read_text())
            for r, p in enumerate(procs)]


def run_two(stages: list, logs: Path, set_=(), timeout: float = 100, **env) -> tuple:
    """Run ``stages`` (``[name, argv]`` or ``[name, argv, moves]``, argv
    as the CLI takes it) as two ranks; raises unless both exit 0.
    Returns (each rank's summary from its last line, each rank's log)."""
    spec = {"stages": [[name, f"127.0.0.1:{free_port()}", argv, *rest]
                       for name, argv, *rest in stages],
            "set": [list(x) for x in set_]}
    argv = [sys.executable, str(WORKER), json.dumps(spec)]
    results = spawn([argv, argv], logs, clean_env(**env), timeout)
    for r, (rc, _out, err) in enumerate(results):
        if rc != 0:
            raise AssertionError(f"rank {r} exited {rc}:\n{err[-4000:]}")
    return ([json.loads(out.strip().splitlines()[-1]) for _rc, out, _err in results],
            [err for _rc, _out, err in results])


def cmdline(argv: list) -> str:
    """The command line a stage JSON records for ``argv``."""
    return "alevin-fry-tpu " + " ".join(argv)
