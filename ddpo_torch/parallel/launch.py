"""Start N ranks of a command on this machine, as torchrun would.

``launch(cmd, world)`` runs ``cmd`` (a list, or a function of the rank
giving one) once per rank with RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
(127.0.0.1) and MASTER_PORT (a free port) set, each rank's output going to
its own file, and waits for every rank within ``timeout`` seconds; a rank
still running then is killed with the others, and the call raises. When a
rank fails, the others get ``FAILED_GRACE_S`` seconds to end (they would
wait in a collective for it) and are then killed. It returns each rank's
(exit code, output). ``local_rank`` maps a rank to its
LOCAL_RANK: the rank by default (a card each), or ``lambda r: 0`` for ranks
that share one card (which torchrun cannot set up). The tests and
chip_smoke.py phase 13 start their ranks with it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import tempfile
import time
from typing import Callable, List, NamedTuple, Optional, Sequence, Union


FAILED_GRACE_S = 30.0


class RankResult(NamedTuple):
    returncode: int
    output: str


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, world: int, port: int, local_rank: int,
             base: Optional[dict] = None) -> dict:
    env = dict(os.environ if base is None else base)
    env.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(local_rank),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    return env


def launch(cmd: Union[Sequence[str], Callable[[int], Sequence[str]]], world: int, *,
           timeout: float, env: Optional[dict] = None, cwd: Optional[str] = None,
           local_rank: Callable[[int], int] = lambda r: r) -> List[RankResult]:
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks_") as logs:
        files = [open(os.path.join(logs, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [
            subprocess.Popen(list(cmd(r) if callable(cmd) else cmd), cwd=cwd,
                             env=rank_env(r, world, port, local_rank(r), env),
                             stdout=files[r], stderr=subprocess.STDOUT, text=True)
            for r in range(world)
        ]
        deadline = time.monotonic() + timeout
        failed_at = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.returncode not in (None, 0) for p in procs):
                failed_at = now  # the others would wait in a collective for it
            if now > deadline or (failed_at is not None and now > failed_at + FAILED_GRACE_S):
                for p in procs:
                    p.kill()
                    p.communicate()
                if now > deadline:
                    raise subprocess.TimeoutExpired(list(procs[0].args), timeout)
                break
            time.sleep(0.1)
        for p in procs:
            p.communicate(timeout=timeout)
        results = []
        for p, f in zip(procs, files):
            f.seek(0)
            results.append(RankResult(p.returncode, f.read()))
            f.close()
    return results

