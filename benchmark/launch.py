"""One process a card: runs a command in ``world`` processes on this host
with ``torch.distributed.run``'s environment (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on
localhost, and, as ``torchrun`` sets it for several processes a node,
``OMP_NUM_THREADS=1`` unless the caller set it) and
``BENCHMARK_STORE_PORT``, the port of the store over which the ranks agree
on the window's end (``harness.Ranks``).

Rank 0's standard output is held and written out only once every rank
has exited with 0, so a run with a rank that failed prints no result
line; the other ranks' standard output goes to standard error. A rank
that exits with another code, or the launcher's own timeout, ends every
rank at once (each in a session of its own, so whatever it started ends
with it), and the launcher returns non-zero. Nothing is left running.
"""

from __future__ import annotations

import os
import signal
import socket
import subprocess
import sys
import threading
import time

# Within the first run of a cell's allowance (it builds the kernels), so a
# rank that hangs is ended by the launcher itself.
TIMEOUT_S = 1140.0


def free_ports(n):
    """``n`` distinct TCP ports free on localhost now."""
    socks = []
    try:
        for _ in range(n):
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def _stop(procs):
    """End every rank's session and wait for each."""
    for p in procs:
        if p.poll() is None:
            try:
                os.killpg(p.pid, signal.SIGTERM)
            except ProcessLookupError:
                pass
    deadline = time.monotonic() + 10.0
    for p in procs:
        try:
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
    for p in procs:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()


def launch(cmd, world, timeout_s=TIMEOUT_S, out=None, env=None):
    """Run ``cmd`` (an argv list) as ranks 0 … ``world − 1``; returns 0
    when every rank exited with 0, else the first failing rank's code (1
    for a rank ended by a signal) or 124 at the timeout. Rank 0's standard
    output goes to ``out`` (default ``sys.stdout``) on success, to
    standard error otherwise."""
    out = sys.stdout if out is None else out
    master, store = free_ports(2)
    base = dict(os.environ if env is None else env)
    base.setdefault("OMP_NUM_THREADS", "1")
    procs, held = [], []
    ended = threading.Event()

    def on_term(signum, frame):
        ended.set()

    old = signal.signal(signal.SIGTERM, on_term) \
        if threading.current_thread() is threading.main_thread() else None
    reader = None
    code = None
    try:
        for r in range(world):
            e = dict(base, RANK=str(r), LOCAL_RANK=str(r),
                     WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=str(master),
                     BENCHMARK_STORE_PORT=str(store))
            procs.append(subprocess.Popen(
                cmd, env=e, stdout=subprocess.PIPE if r == 0 else 2,
                start_new_session=True, text=True))
        reader = threading.Thread(
            target=lambda: held.extend(procs[0].stdout), daemon=True)
        reader.start()
        deadline = time.monotonic() + float(timeout_s)
        while code is None:
            codes = [p.poll() for p in procs]
            bad = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if bad:
                r, c = bad[0]
                print(f"launch: rank {r} exited with {c}; the other ranks "
                      "were ended", file=sys.stderr, flush=True)
                code = c if c > 0 else 1
            elif all(c == 0 for c in codes):
                code = 0
            elif ended.is_set():
                print("launch: ended by SIGTERM", file=sys.stderr,
                      flush=True)
                code = 143
            elif time.monotonic() > deadline:
                print(f"launch: no end after {timeout_s:.0f} s; every rank "
                      "was ended", file=sys.stderr, flush=True)
                code = 124
            else:
                time.sleep(0.05)
    finally:
        _stop(procs)
        if reader is not None:
            reader.join(timeout=10.0)
        if old is not None:
            signal.signal(signal.SIGTERM, old)
    text = "".join(held)
    if code == 0:
        out.write(text)
        out.flush()
    elif text:
        sys.stderr.write(text)
        sys.stderr.flush()
    return code
