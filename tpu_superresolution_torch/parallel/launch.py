"""Start a world of CPU ranks on this host: one ``python -m MODULE``
process a rank, joined by a ``file://`` store (no port to pick, nothing
shared between two such worlds).  ``entry.dryrun_multichip`` and the
tests use it; a GPU run is started by ``torchrun`` instead."""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional, Sequence

# the directory that holds the package, so that `python -m` finds it
# from any working directory
_ROOT = str(Path(__file__).resolve().parents[2])


def rank_args(argv: Optional[Sequence[str]] = None):
    """(rank, world, init_method, the remaining arguments) of a process
    that ``run_ranks`` started."""
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init_method", type=str, required=True)
    args, rest = ap.parse_known_args(argv)
    return args.rank, args.world, args.init_method, rest


def run_ranks(module: str, world: int, argv: Sequence[str] = (),
              timeout_s: float = 300.0) -> List[str]:
    """Run ``python -m module --rank r --world world --init_method
    file://... *argv`` for every rank r and return their standard
    outputs.  Each process gets one CPU thread.  If a rank fails, or the
    world does not finish within `timeout_s`, every rank is killed and
    RuntimeError carries each rank's exit code and the end of its
    standard error."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONUNBUFFERED="1",
               PYTHONPATH=os.pathsep.join([_ROOT] + [p for p in os.environ.get(
                   "PYTHONPATH", "").split(os.pathsep) if p]))
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        init = f"file://{tmp}/store"
        procs, logs = [], []
        try:
            for r in range(world):
                out = open(Path(tmp) / f"rank{r}.out", "w+")
                err = open(Path(tmp) / f"rank{r}.err", "w+")
                logs.append((out, err))
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", module, "--rank", str(r), "--world", str(world),
                     "--init_method", init, *argv],
                    stdout=out, stderr=err, env=env))
            deadline = time.monotonic() + timeout_s
            codes = [None] * world
            while any(c is None for c in codes):
                for r, p in enumerate(procs):
                    if codes[r] is None:
                        codes[r] = p.poll()
                if any(c not in (None, 0) for c in codes):
                    break  # one rank failed: the others would wait on it forever
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=30)
            codes = [p.returncode for p in procs]
            texts = []
            for out, err in logs:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
            if any(codes):
                tails = "\n".join(f"--- rank {r}: exit {c}\n{e[-3000:]}"
                                  for r, (c, (_, e)) in enumerate(zip(codes, texts)))
                raise RuntimeError(f"{module} at world {world} failed or timed out after "
                                   f"{timeout_s} s:\n{tails}")
            return [o for o, _ in texts]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=30)
            for out, err in logs:
                out.close()
                err.close()
