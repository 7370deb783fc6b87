"""The ranks of a cell over several cards: the launcher that rank 0 (the
harness's own process) runs, and the first steps of a started rank.

Rank 0 starts ranks 1..N-1 as its children (``run.py --rank k``), each
with torchrun's environment (``torchrun_env``), the run's description on
its standard input, and its card (harness/trace.py ``Card``) handed back
as one JSON object on its standard output once its window has closed;
whatever the rank prints goes to its standard error, of which rank 0
keeps the end.  Rank 0 takes the same environment itself.  The harness
starts no process group: the program starts its own, and the cards
travel over the pipes.

Fail, never hang.  A rank that exits with another code than 0, or
without handing over its card, ends the run at once: rank 0 names it,
prints the end of its standard error, kills every rank it started and
exits 1.  So does a rank, rank 0 included, that is not done GRACE_S
after the window's ``--seconds`` (SETUP_S after the start, before the
window): the port's process groups time out at 120 s.  A started rank
is killed with rank 0, whatever ends rank 0 (PR_SET_PDEATHSIG), the
driver's SIGTERM included.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

from harness.program import ProgramSpan
from harness.trace import Card, event_kind

RUN = Path(__file__).resolve().parents[1] / "run.py"
TORCHRUN = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
            "LOCAL_RANK", "LOCAL_WORLD_SIZE")
GRACE_S = 180.0       # past the window: the port's groups time out at 120 s
SETUP_S = 1200.0      # before the window: a checkout's first run compiles
POLL_S = 0.1
TAIL_BYTES = 4000     # of a failed rank's standard error
PR_SET_PDEATHSIG = 1


def torchrun_env(rank: int, world: int, port: int) -> dict:
    return {"MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
            "WORLD_SIZE": str(world), "RANK": str(rank),
            "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)}


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _plain(x):
    return x if x is None or isinstance(x, (str, int, float, bool)) \
        else repr(x)


def encode_card(c: Card) -> dict:
    """A card as JSON, its events' names listed once."""
    names: dict = {}
    events = [[names.setdefault(n, len(names)), a, b]
              for n, _k, a, b in c.events]
    return {"rank": c.rank, "memory_peak_bytes": c.memory_peak_bytes,
            "names": list(names), "events": events, "slice": c.slice,
            "spans": c.spans, "counters": c.counters,
            "program_spans": [[s.name, s.start_ns, s.end_ns, s.parent,
                               _plain(s.request), s.counts, s.id]
                              for s in c.program_spans],
            "program_counters": c.program_counters,
            "forbidden": c.forbidden}


def decode_card(d: dict) -> Card:
    names = d["names"]
    return Card(d["rank"], d["memory_peak_bytes"],
                [(names[i], event_kind(names[i]), a, b)
                 for i, a, b in d["events"]],
                tuple(d["slice"]) if d["slice"] else None,
                [tuple(s) for s in d["spans"]], d["counters"],
                [ProgramSpan(*s) for s in d["program_spans"]],
                d["program_counters"], d["forbidden"])


# -- a started rank ----------------------------------------------------------
def die_with_parent(parent: int) -> None:
    """SIGKILL this process when the process that started it ends; end
    now where that has happened already."""
    libc = ctypes.CDLL(None, use_errno=True)
    libc.prctl.argtypes = [ctypes.c_int] + [ctypes.c_ulong] * 4
    libc.prctl.restype = ctypes.c_int
    if libc.prctl(PR_SET_PDEATHSIG, signal.SIGKILL, 0, 0, 0) != 0:
        raise OSError(ctypes.get_errno(), "prctl(PR_SET_PDEATHSIG)")
    if os.getppid() != parent:
        os._exit(1)


def start_rank():
    """A started rank's first steps: its run read from standard input,
    its life tied to rank 0's, and its standard output kept for its card
    while file descriptor 1 (whatever it prints) goes to standard error.
    Returns (the run's description, the stream for the card)."""
    spec = json.load(sys.stdin)
    die_with_parent(spec["parent"])
    sys.stdout.flush()
    out = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)
    return spec, out


def hand_over(out, c: Card) -> None:
    json.dump(encode_card(c), out, default=float)
    out.close()


# -- rank 0 ------------------------------------------------------------------
class Group:
    """Ranks 1..N-1 of a cell over N cards, started and watched by rank
    0 (module docstring)."""

    def __init__(self, cell, seed, seconds, trace, mode, device):
        self.world = int(cell.entry["chips"])
        self.seconds = float(seconds)
        self.procs: list = []
        self.cards: dict = {}
        self._tails: dict = {}
        self._readers: list = []
        self._lock = threading.Lock()
        self._done = False            # the run's end is claimed
        self._failing = False         # ... by a failure
        self._window = False          # rank 0's window has begun
        self._closed = False          # ... and closed
        self._deadline = time.monotonic() + SETUP_S
        port = free_port()
        self._saved = {k: os.environ.get(k) for k in TORCHRUN}
        os.environ.update(torchrun_env(0, self.world, port))
        spec = json.dumps({"parent": os.getpid(),
                           "cell": dataclasses.asdict(cell), "seed": seed,
                           "seconds": seconds, "trace": trace,
                           "mode": mode, "device": device}).encode()
        try:
            for k in range(1, self.world):
                self.procs.append(subprocess.Popen(
                    [sys.executable, str(RUN), "--rank", str(k)],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=subprocess.PIPE, start_new_session=True,
                    env={**os.environ, **torchrun_env(k, self.world, port)}))
            print(f"benchmark: ranks 1-{self.world - 1} started, pids "
                  f"{[p.pid for p in self.procs]}", file=sys.stderr,
                  flush=True)
            for k, p in enumerate(self.procs, 1):
                self._readers.append(self._thread(self._read_card, k,
                                                  p.stdout))
                self._thread(self._read_tail, k, p.stderr)
                try:
                    p.stdin.write(spec)
                    p.stdin.close()
                except OSError:
                    pass                # it died: the watch names it
        except BaseException:
            self.abort()
            raise
        self._thread(self._watch)

    @staticmethod
    def _thread(target, *args) -> threading.Thread:
        t = threading.Thread(target=target, args=args, daemon=True)
        t.start()
        return t

    def _read_card(self, k, stream):
        with stream:
            data = stream.read()
        try:
            self.cards[k] = decode_card(json.loads(data))
        except (ValueError, KeyError, IndexError, TypeError):
            self.cards[k] = None

    def _read_tail(self, k, stream):
        with stream:
            tail = b""
            while True:
                chunk = stream.read1(65536)
                if not chunk:
                    break
                tail = (tail + chunk)[-TAIL_BYTES:]
                self._tails[k] = tail

    # -- verdicts ------------------------------------------------------------
    def _late(self) -> str:
        if not self._window:
            return f"did not finish set-up within {SETUP_S:.0f} s"
        return (f"not done {GRACE_S:.0f} s after the window's "
                f"{self.seconds:g} s")

    def _verdict(self):
        """(ranks, why) of the first failure found, or None."""
        for k, p in enumerate(self.procs, 1):
            rc = p.poll()
            if rc not in (None, 0):
                return [k], f"exited with code {rc}"
            if rc == 0 and not self._readers[k - 1].is_alive() and \
                    self.cards.get(k) is None:
                return [k], "exited without handing over its card"
        if time.monotonic() > self._deadline:
            late = [0] if not self._closed else []
            late += [k for k, p in enumerate(self.procs, 1)
                     if p.poll() is None]
            if late:
                return late, self._late()
        return None

    def _watch(self):
        while True:
            time.sleep(POLL_S)
            with self._lock:
                if self._done:
                    return
            found = self._verdict()
            if found:
                self.fail(*found)

    def _claim(self, failing: bool = False) -> bool:
        """Whether the caller is the one to end the run.  One that finds
        another thread ending it in failure waits: that thread exits the
        process."""
        with self._lock:
            if not self._done:
                self._done, self._failing = True, failing
                return True
            other = self._failing
        if other:
            threading.Event().wait()
        return False

    def fail(self, ranks, why: str) -> None:
        """End the run: name ``ranks`` (a started rank's with the end of
        its standard error), kill every started rank, exit 1."""
        if not self._claim(failing=True):
            return
        self._report(ranks, why)
        self._kill()
        sys.stdout.flush()
        os._exit(1)

    def _report(self, ranks, why: str) -> None:
        names = f"rank {ranks[0]}" if len(ranks) == 1 else f"ranks {ranks}"
        print(f"benchmark: {names}: {why}", file=sys.stderr, flush=True)
        for k in ranks:
            if k:
                tail = self._tails.get(k, b"").decode(errors="replace")
                print(f"benchmark: the end of rank {k}'s standard error:\n"
                      f"{tail}", file=sys.stderr, flush=True)

    # -- rank 0's steps ------------------------------------------------------
    def window_started(self) -> None:
        with self._lock:
            self._window = True
            self._deadline = time.monotonic() + self.seconds + GRACE_S

    def gather(self) -> list:
        """Ranks 1..N-1's cards, each once its window has closed."""
        self._closed = True
        for k, t in enumerate(self._readers, 1):
            t.join()
            if self.cards.get(k) is None:
                rc = self._exit_code(k)
                self.fail([k], f"exited with code {rc}" if rc else
                          "exited without handing over its card")
        return [self.cards[k] for k in range(1, self.world)]

    def close(self) -> None:
        """After rank 0's run: every rank has ended with code 0."""
        for k in range(1, self.world):
            rc = self._exit_code(k)
            if rc:
                self.fail([k], f"exited with code {rc}")
        self._claim()
        self._restore()

    def _exit_code(self, k: int) -> int:
        """Rank k's exit code once it has ended; the run fails where it
        has not by the deadline."""
        try:
            return self.procs[k - 1].wait(
                max(0.0, self._deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            self.fail([k], self._late())

    def abort(self) -> None:
        """Rank 0 raised: name a rank that failed first (its exit brings
        rank 0's collectives down), then end every rank."""
        if not self._claim():
            return
        t_end = time.monotonic() + 2.0
        codes = [p.poll() for p in self.procs]
        while None in codes and not any(codes) and time.monotonic() < t_end:
            time.sleep(POLL_S)
            codes = [p.poll() for p in self.procs]
        for k, rc in enumerate(codes, 1):
            if rc:
                self._report([k], f"exited with code {rc}")
                break
        self._kill()
        self._restore()

    def _kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
        for p in self.procs:
            try:
                p.wait(30)
            except subprocess.TimeoutExpired:
                pass

    def _restore(self) -> None:
        for k, v in self._saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
