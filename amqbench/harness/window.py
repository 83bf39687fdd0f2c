"""What every measured window shares: its clock, its record of calls, and
the helpers of a window that probes.  Each kind's loop is its own
(``kinds/<kind>.py``).

A call is timed from its issue on the host to the completion of a CUDA
event recorded after it, on one clock: the events' times are taken
from an event recorded and waited for when the window opens, at the
host time ``t0``.  At most ``in_flight`` calls are outstanding: before
it issues a call, the loop waits for the completion of the call that
many before it (``wait_turn``).  A loop issues calls until ``seconds``
have passed, then waits for the device; the window ends there.
"""

from __future__ import annotations

import random
import time
from typing import NamedTuple

import torch


class Call(NamedTuple):
    issue_s: float  # host time of issue, from the window's start
    host_s: float  # host time from the call's entry to its return
    keys: int
    mark: object  # its completion: a CUDA event, or a host time on the CPU


class Clock:
    """Window time on the host, completions by CUDA events (on the CPU,
    where a call completes when it returns, by the host clock)."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e0.record()
            self.e0.synchronize()
        self.t0 = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def mark(self):
        if not self.cuda:
            return self.now()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def finish(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return self.now()

    def done_s(self, mark) -> float:
        return self.e0.elapsed_time(mark) / 1e3 if self.cuda else mark


class Record(NamedTuple):
    op: str
    calls: list
    window_s: float
    done_s: list  # each call's completion, from the window's start


def wait_turn(calls, in_flight, clock) -> None:
    """Wait until fewer than ``in_flight`` of ``calls`` are outstanding."""
    if len(calls) >= in_flight:
        clock.wait(calls[-in_flight].mark)


def record(op, calls, clock, window_s) -> Record:
    return Record(op, calls, window_s, [clock.done_s(c.mark) for c in calls])


ONES = 0x0101010101010101


def count(hits: torch.Tensor) -> torch.Tensor:
    """The number of True answers, on the device: eight answers a word,
    summed by one multiply (each byte is 0 or 1, so the top byte of the
    product is the word's count), which reads the answers once and
    casts nothing to int64."""
    if hits.numel() % 8:
        return hits.sum()
    return ((hits.view(torch.uint8).view(torch.int64) * ONES) >> 56).sum()


class Sample:
    """A uniform sample of ``k`` calls' answers, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.kept: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.kept[j] = item
