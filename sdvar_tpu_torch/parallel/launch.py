"""Start the ranks of one ``torch.distributed`` group on this host, one
process each, and wait for them: what ``torchrun --nproc_per_node N`` does,
for a program that must check every rank's exit (the mesh checks of
``chip_smoke.py`` and of the CPU tests).

Each process gets torchrun's variables (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT`` on a
free local port), which ``parallel.distributed.initialize`` reads. The
join has a deadline: a rank that exits non-zero stops the others at once,
and at the deadline every rank still running is killed; either raises.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Dict, List, Optional, Sequence


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], world: int, timeout: float,
           env: Optional[Dict[str, str]] = None,
           cwd: Optional[str] = None) -> List[str]:
    """Run ``argv`` as ``world`` ranks and return each rank's output
    (stdout and stderr together), in rank order. Raises ``RuntimeError``
    with the tail of the output of every rank that failed or was killed."""
    base = dict(os.environ if env is None else env)
    base.update(MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
                WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    with tempfile.TemporaryDirectory() as tmp:
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(world)]
        procs = [subprocess.Popen(
            list(argv), cwd=cwd, stdout=log, stderr=subprocess.STDOUT,
            env=dict(base, RANK=str(r), LOCAL_RANK=str(r)))
            for r, log in enumerate(logs)]
        deadline = time.time() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if any(p.returncode not in (None, 0) for p in procs):
                    break  # one rank failed: its peers would wait forever
                if time.time() > deadline:
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        out = []
        for log in logs:
            log.seek(0)
            out.append(log.read())
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        timed_out = time.time() > deadline
        raise RuntimeError(
            f"rank(s) {bad} of {world} failed (exit codes "
            f"{[procs[r].returncode for r in bad]}"
            f"{f', killed at the {timeout:.0f} s deadline' if timed_out else ''})"
            + "".join(f"\n--- rank {r} ---\n{out[r][-3000:]}" for r in bad))
    return out
