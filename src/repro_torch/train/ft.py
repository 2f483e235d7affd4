"""Fault-tolerance policies: heartbeats, straggler detection, elastic
re-mesh planning. The port's own copy of ``repro.train.ft`` (pure
Python, no framework).

  * HeartbeatMonitor: a host is FAILED if no beat within ``timeout``.
  * StragglerMonitor: per-host step-time EWMA; a host is a straggler when
    its EWMA exceeds ``ratio`` x the fleet median for ``patience``
    consecutive checks. Stragglers are excluded at the next re-mesh, not
    killed mid-step.
  * plan_remesh: given the surviving host count, the largest (data,
    model) mesh that fits, keeping the model (tensor-parallel) degree and
    shrinking the data axis.
  * rescale_microbatches: the gradient accumulation that keeps the global
    batch after the data axis shrinks.

Recovery = restore the newest checkpoint (``train/checkpoint.py``) under
the new mesh and rescale ``num_microbatches``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass
class HostState:
    last_beat: float
    ewma_step_time: Optional[float] = None
    slow_streak: int = 0
    failed: bool = False


class HeartbeatMonitor:
    def __init__(self, hosts: Sequence[int], timeout: float = 30.0):
        self.timeout = timeout
        now = time.time()
        self.hosts: Dict[int, HostState] = {h: HostState(now) for h in hosts}

    def beat(self, host: int, t: Optional[float] = None) -> None:
        self.hosts[host].last_beat = t if t is not None else time.time()

    def failed_hosts(self, now: Optional[float] = None) -> List[int]:
        """Hosts silent for longer than ``timeout`` (once failed, a host
        stays failed)."""
        now = now if now is not None else time.time()
        out = []
        for h, st in self.hosts.items():
            if now - st.last_beat > self.timeout:
                st.failed = True
            if st.failed:
                out.append(h)
        return out

    def surviving(self, now: Optional[float] = None) -> List[int]:
        bad = set(self.failed_hosts(now))
        return [h for h in self.hosts if h not in bad]


class StragglerMonitor:
    def __init__(self, hosts: Sequence[int], *, alpha: float = 0.2,
                 ratio: float = 1.5, patience: int = 5):
        self.alpha, self.ratio, self.patience = alpha, ratio, patience
        self.state: Dict[int, HostState] = {
            h: HostState(time.time()) for h in hosts}

    def record(self, host: int, step_time: float) -> None:
        st = self.state[host]
        st.ewma_step_time = (step_time if st.ewma_step_time is None else
                             (1 - self.alpha) * st.ewma_step_time
                             + self.alpha * step_time)

    def stragglers(self) -> List[int]:
        """Hosts whose EWMA has exceeded ``ratio`` x the median (the upper
        median) for ``patience`` checks in a row."""
        ew = {h: s.ewma_step_time for h, s in self.state.items()
              if s.ewma_step_time is not None}
        if len(ew) < 2:
            return []
        med = sorted(ew.values())[len(ew) // 2]
        out = []
        for h, v in ew.items():
            st = self.state[h]
            if v > self.ratio * med:
                st.slow_streak += 1
            else:
                st.slow_streak = 0
            if st.slow_streak >= self.patience:
                out.append(h)
        return out


def plan_remesh(survivors: int, *, model: int = 16,
                chips_per_host: int = 4) -> Tuple[int, int]:
    """(data, model) for the largest mesh fitting ``survivors`` hosts: the
    model axis is kept and the data axis shrinks to the largest power of
    two with data * model <= survivors * chips_per_host."""
    chips = survivors * chips_per_host
    if chips < model:
        raise ValueError(f"{chips} chips cannot hold the model degree "
                         f"{model}")
    data = chips // model
    while data > 1 and (data & (data - 1)) != 0:
        data -= 1
    return data, model


def rescale_microbatches(global_batch: int, old_data: int, new_data: int,
                         old_mb: int) -> int:
    """Keep the global batch constant: lost data parallelism becomes more
    gradient accumulation."""
    per_dev_old = global_batch // old_data // old_mb
    return max(1, global_batch // new_data // per_dev_old)
