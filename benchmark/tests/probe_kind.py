"""probe: a traffic kind over ranks for the launcher's tests; no cell's
traffic.

Every rank joins the program's process group the program's way
(``lsdtpu_torch.runtime.distributed.initialize()``: gloo on the CPU,
NCCL with a card a rank) and, a tick, all-gathers a small tensor inside
a span ``probe.gather``; rank 0 says in the gather when the window is
over, so every rank runs the same ticks.  The program records a span
``probe.tick`` around each tick.  Rank k holds (k + 1) x ``mib`` MiB
more than the others, so the fullest card is the last.  On one card
there is no group and the gather is the tensor itself.

Its judge, on rank 0, holds the cards that reached it to each other:
as many cards as ranks, every card's ticks and ``probe.tick`` spans as
many as rank 0's ticks, and the ranks' spans around one gather ending
within ``limits.gather_end_skew_ms`` of each other on the one clock (the
median over the ticks; a rank the host leaves waiting for its core now
and then widens the widest, a reading).

A workload's ``fault`` plants one failure on rank ``fault_rank``:
``"raise"`` in set-up, ``"hang"`` in the window's second tick, ``"jax"``
(a module named jax left in ``sys.modules`` after the window).
"""

from __future__ import annotations

import sys
import time
import types

from harness import kind
from reference import judge as rj


class Run(kind.Base):
    ranks = True
    serving = ("probe.gather",)

    def setup(self):
        import torch
        from lsdtpu_torch.runtime import distributed
        self.fault = self.wl.get("fault") \
            if self.rank == self.wl.get("fault_rank") else None
        if self.fault == "raise":
            raise RuntimeError(f"probe: planted failure in rank "
                               f"{self.rank}'s set-up")
        self.backend = distributed.initialize(device=self.device)
        self.dev = torch.device("cpu") if self.device == "cpu" else \
            torch.device("cuda", torch.cuda.current_device())
        self.held = torch.ones((self.rank + 1) * self.wl["mib"] << 18,
                               device=self.dev)
        self.ticks = 0
        self._tick(stop=False)              # warm-up: one gather

    def _tick(self, stop: bool) -> bool:
        import torch
        import torch.distributed as dist
        x = torch.tensor([self.rank, self.ticks, int(stop)],
                         dtype=torch.float32, device=self.dev)
        out = [torch.empty_like(x) for _ in range(self.world)]
        with self.spans.span("probe.gather"):
            if self.world > 1:
                dist.all_gather(out, x)
            else:
                out = [x]
            return bool(out[0][2].item())

    def window(self, seconds, trace=None):
        from lsdtpu_torch.runtime import trace as ptrace
        self.t0 = kind.now()
        if trace is not None:
            trace.start()
        with ptrace.recording():
            stop = False
            while not stop:
                if self.fault == "hang" and self.ticks == 1:
                    while True:
                        time.sleep(60)
                with ptrace.span("probe.tick"):
                    stop = self._tick(self.rank == 0 and
                                      kind.now() - self.t0 >= seconds)
                self.ticks += 1
        if trace is not None:
            trace.stop()
        self.attempted = self.ticks
        self.spans.counters.update(ticks=self.ticks, rank=self.rank)
        if self.fault == "jax":
            sys.modules["jax"] = types.ModuleType("jax")

    def end_to_end(self):
        return {"gather_ms": (kind.now() - self.t0) * 1e3 / self.ticks}

    def slice_counts(self):
        return {"ticks": self.ticks}

    def notes(self):
        return [f"probe backend={self.backend} ticks={self.ticks}"]

    def release(self):
        import torch.distributed as dist
        self.held = None
        if dist.is_initialized():
            dist.destroy_process_group()

    def failed(self):
        return 0

    def judge(self):
        cards = self.cards
        ends = [[b for n, _a, b in c.spans if n == "probe.gather"][1:]
                for c in cards]
        skews = sorted((max(e) - min(e)) / 1e6 for e in zip(*ends)) \
            if all(ends) else [float("inf")]
        numbers = {
            "cards_missing": self.world - len(cards),
            "ticks_apart": max(abs(c.counters.get("ticks", -1) - self.ticks)
                               for c in cards),
            "tick_spans_apart": max(
                abs(sum(1 for s in c.program_spans
                        if s.name == "probe.tick") - self.ticks)
                for c in cards[1:]) if len(cards) > 1 else 0,
            "gather_end_skew_ms": skews[len(skews) // 2],
            "gather_end_skew_max_ms": skews[-1],
            "ticks": self.ticks,
        }
        checks, self.readings = rj.compare(numbers, self.wl["limits"])
        return checks
