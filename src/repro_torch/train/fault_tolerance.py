"""Fault-tolerant training supervision (a verbatim copy of
``repro.train.fault_tolerance``, which imports no JAX: the port keeps its
own copy, as it does of ``core/cost_model.py``).

On a real multi-pod deployment the failure plane is: chips die, hosts
drop heartbeats, steps straggle.  This module implements the control
logic — heartbeat tracking, straggler deadlines, restart-with-rescale —
against an abstract ClusterMonitor, plus a simulator backend so the
policies are testable on one CPU.  The integration points with the
training loop are:

  * every step runs under a deadline; a straggling step marks the
    offending hosts suspect (on TPU: the step itself is synchronous, so
    the *next* heartbeat round localizes the slow host),
  * a failed heartbeat triggers restore-from-checkpoint; if spare hosts
    are unavailable the supervisor re-meshes to fewer data-parallel
    replicas (elastic restore path in checkpoint.py — global arrays are
    re-sharded onto the surviving mesh),
  * all decisions are logged as structured events for the fleet layer.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from enum import Enum
from typing import Callable, Optional


class HostState(Enum):
    HEALTHY = "healthy"
    SUSPECT = "suspect"
    DEAD = "dead"


@dataclass
class FTConfig:
    heartbeat_interval_s: float = 10.0
    heartbeat_timeout_s: float = 30.0
    step_deadline_s: float = 120.0
    suspect_strikes: int = 2  # suspects after N missed deadlines
    min_data_parallel: int = 2  # refuse to shrink below this


@dataclass
class ClusterEvent:
    t: float
    kind: str
    detail: dict


class ClusterMonitor:
    """Tracks host health from heartbeats + step timing."""

    def __init__(
        self,
        hosts: list[str],
        cfg: FTConfig,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.cfg = cfg
        self.clock = clock
        self.state = {h: HostState.HEALTHY for h in hosts}
        self.last_beat = {h: clock() for h in hosts}
        self.strikes = {h: 0 for h in hosts}
        self.events: list[ClusterEvent] = []

    def _log(self, kind: str, **detail):
        self.events.append(ClusterEvent(self.clock(), kind, detail))

    def heartbeat(self, host: str) -> None:
        self.last_beat[host] = self.clock()
        if self.state[host] is HostState.SUSPECT:
            self.state[host] = HostState.HEALTHY
            self.strikes[host] = 0
            self._log("host_recovered", host=host)

    def step_completed(self, duration_s: float, slow_hosts: Optional[list[str]] = None):
        if duration_s <= self.cfg.step_deadline_s:
            return
        self._log("step_straggled", duration=duration_s, hosts=slow_hosts or [])
        for h in slow_hosts or []:
            self.strikes[h] += 1
            if self.strikes[h] >= self.cfg.suspect_strikes:
                self.state[h] = HostState.SUSPECT
                self._log("host_suspect", host=h)

    def sweep(self) -> list[str]:
        """Mark hosts that missed the heartbeat timeout dead; return them."""
        now = self.clock()
        died = []
        for h, t in self.last_beat.items():
            if (
                self.state[h] is not HostState.DEAD
                and now - t > self.cfg.heartbeat_timeout_s
            ):
                self.state[h] = HostState.DEAD
                died.append(h)
                self._log("host_dead", host=h)
        return died

    def healthy_hosts(self) -> list[str]:
        return [h for h, s in self.state.items() if s is not HostState.DEAD]


@dataclass
class RescalePlan:
    data_parallel: int
    dropped_hosts: list[str]
    action: str  # "continue" | "restore_rescale" | "halt"


def plan_rescale(monitor: ClusterMonitor, current_dp: int, hosts_per_replica: int,
                 cfg: FTConfig) -> RescalePlan:
    """Decide the post-failure topology.

    Replicas are groups of hosts along the data axis; losing any host in
    a replica drops the whole replica (its shards are gone), so the new
    dp = floor(healthy_hosts / hosts_per_replica), clamped by config."""
    healthy = len(monitor.healthy_hosts())
    dead = [h for h, s in monitor.state.items() if s is HostState.DEAD]
    new_dp = healthy // hosts_per_replica
    if not dead:
        return RescalePlan(current_dp, [], "continue")
    if new_dp >= current_dp:
        return RescalePlan(current_dp, dead, "restore_rescale")
    if new_dp < cfg.min_data_parallel:
        return RescalePlan(current_dp, dead, "halt")
    return RescalePlan(new_dp, dead, "restore_rescale")


class TrainSupervisor:
    """Wraps a step function with deadline timing + recovery policy.

    ``on_restore(new_dp)`` is the caller-provided path that rebuilds the
    mesh at the new data-parallel width and restores the latest
    checkpoint onto it (see launch/train.py)."""

    def __init__(self, monitor: ClusterMonitor, cfg: FTConfig, hosts_per_replica: int,
                 current_dp: int, on_restore: Callable[[int], None]):
        self.monitor = monitor
        self.cfg = cfg
        self.hosts_per_replica = hosts_per_replica
        self.dp = current_dp
        self.on_restore = on_restore
        self.restarts = 0

    def run_step(self, step_fn: Callable[[], dict]) -> Optional[dict]:
        t0 = self.monitor.clock()
        metrics = step_fn()
        self.monitor.step_completed(self.monitor.clock() - t0)
        died = self.monitor.sweep()
        if died:
            plan = plan_rescale(self.monitor, self.dp, self.hosts_per_replica, self.cfg)
            if plan.action == "halt":
                raise RuntimeError(
                    f"cluster below min_data_parallel; dead={plan.dropped_hosts}"
                )
            self.restarts += 1
            self.dp = plan.data_parallel
            self.on_restore(plan.data_parallel)
            return None  # step result discarded; caller resumes from ckpt
        return metrics
