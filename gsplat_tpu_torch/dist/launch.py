"""Run the ranks of a mesh as subprocesses of one host, and stop them all.

`run_ranks(cmd_of_rank, world, timeout)` starts one process a rank (the
environment plus `env`, plus `env_of_rank(rank)`), each with its output
in a file of its own, and polls them: when one exits
nonzero, or the time runs out, every rank still running is killed (a rank
blocked in a collective would otherwise wait for the dead one forever).
-> [(exit code, output)] in rank order; a killed rank's code is negative.
`free_port()` picks a localhost port for the tcp:// rendezvous.

A port is free only until someone binds it, and the ranks bind theirs
seconds after free_port returns. `bind(("localhost", 0))` draws from the
kernel's ephemeral range (ip_local_port_range), where every other
process's bind(0) (another program picking its own rendezvous port the
same way) and every outgoing connection's local port draw too: eight gloo
ranks open dozens. So free_port draws below that range, where nothing
takes a port unless it names it.
"""

from __future__ import annotations

import os
import random
import socket
import subprocess
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

_PORT_RANGE = "/proc/sys/net/ipv4/ip_local_port_range"


def _ephemeral_low() -> int:
    try:
        with open(_PORT_RANGE) as f:
            return int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return 32768    # Linux's default


def free_port() -> int:
    """A localhost port free now, drawn from the half of the ports below the
    ephemeral range (bind(0) where that leaves fewer than 1024)."""
    low = _ephemeral_low()
    if low - max(1024, low // 2) >= 1024:
        draw = random.Random(os.urandom(8))
        for _ in range(64):
            port = draw.randrange(max(1024, low // 2), low)
            with socket.socket() as s:
                try:
                    s.bind(("localhost", port))
                except OSError:
                    continue
                return port
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(cmd_of_rank: Callable[[int], List[str]], world: int, timeout: float,
              env: Optional[Dict[str, str]] = None, cwd: Optional[str] = None,
              env_of_rank: Optional[Callable[[int], Dict[str, str]]] = None
              ) -> List[Tuple[int, str]]:
    base = dict(os.environ, **(env or {}))
    with tempfile.TemporaryDirectory() as td:
        logs = [open(os.path.join(td, f"rank{r}.log"), "w+") for r in range(world)]
        procs = [subprocess.Popen(cmd_of_rank(r), stdout=logs[r], stderr=subprocess.STDOUT,
                                  env=dict(base, **(env_of_rank(r) if env_of_rank else {})),
                                  cwd=cwd) for r in range(world)]
        deadline = time.monotonic() + timeout
        try:
            while True:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes):
                    break
                if any(c not in (None, 0) for c in codes) or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        timed_out = time.monotonic() > deadline
        out = []
        for r, (p, f) in enumerate(zip(procs, logs)):
            f.seek(0)
            text = f.read()
            f.close()
            if timed_out and p.returncode < 0:
                text += f"\n[rank {r} killed: the ranks ran past {timeout:.0f} s]"
            out.append((p.returncode, text))
        return out
