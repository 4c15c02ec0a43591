"""Fault tolerance & elasticity runtime (1000+-node posture).

What runs here is the control-plane logic, driven by the training driver
(`repro_torch.train_lm`) and exercised by tests with simulated failures;
the data plane (actual re-slicing) is the checkpoint layer's logical,
unsharded layout:

  * ``HeartbeatMonitor`` — per-host liveness with deadline-based failure
    detection; on failure the driver triggers restore-from-checkpoint with
    the surviving mesh (elastic re-mesh), because checkpoints are saved in
    logical layout (see `repro_torch.checkpoint`).
  * ``StragglerPolicy`` — per-step wall-time tracker; hosts slower than
    ``threshold x`` rolling median for ``patience`` consecutive steps are
    reported for eviction/replacement (the standard large-fleet mitigation;
    synchronous SPMD cannot skip a straggler's shard, so the action is
    evict-and-resize, not skip).
  * ``ElasticPlan`` — given the surviving device count, choose the largest
    feasible (data, model) mesh consistent with the arch's divisibility
    constraints, and recompute per-host batch shards.
  * ``RetryPolicy`` — bounded exponential backoff for transient infra
    errors (preemptions, DCN timeouts).
"""

from __future__ import annotations

import dataclasses
import time


@dataclasses.dataclass
class HeartbeatMonitor:
    n_hosts: int
    deadline_s: float = 60.0
    _last: dict[int, float] = dataclasses.field(default_factory=dict)

    def beat(self, host: int, now: float | None = None) -> None:
        self._last[host] = time.monotonic() if now is None else now

    def dead_hosts(self, now: float | None = None) -> list[int]:
        t = time.monotonic() if now is None else now
        return [h for h in range(self.n_hosts)
                if t - self._last.get(h, t) > self.deadline_s]

    def all_alive(self, now: float | None = None) -> bool:
        return not self.dead_hosts(now)


@dataclasses.dataclass
class StragglerPolicy:
    threshold: float = 1.5        # x rolling median
    patience: int = 3
    window: int = 32
    _times: dict[int, list[float]] = dataclasses.field(default_factory=dict)
    _strikes: dict[int, int] = dataclasses.field(default_factory=dict)

    def record(self, host: int, step_seconds: float) -> None:
        self._times.setdefault(host, []).append(step_seconds)
        self._times[host] = self._times[host][-self.window:]

    def _median_all(self) -> float:
        xs = sorted(t for ts in self._times.values() for t in ts)
        return xs[len(xs) // 2] if xs else 0.0

    def evictions(self) -> list[int]:
        """Hosts whose last ``patience`` recorded steps all exceed
        threshold x fleet median."""
        med = self._median_all()
        if med <= 0:
            return []
        out = []
        for host, ts in sorted(self._times.items()):
            if len(ts) >= self.patience and \
                    all(t > self.threshold * med
                        for t in ts[-self.patience:]):
                out.append(host)
        return out


@dataclasses.dataclass(frozen=True)
class ElasticPlan:
    data: int
    model: int
    pod: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model * self.pod


def plan_elastic_mesh(devices_alive: int, *, model_axis: int = 16,
                      min_data: int = 1) -> ElasticPlan:
    """Largest (data, model) mesh that fits the surviving devices, keeping
    the model axis intact (TP degree is baked into layer shapes; shrinking
    it requires a re-shard, which the checkpoint layer supports but costs a
    full re-layout — prefer shrinking data)."""
    if devices_alive < model_axis * min_data:
        # degrade TP as a last resort, by powers of two
        m = model_axis
        while m > 1 and devices_alive < m:
            m //= 2
        return ElasticPlan(data=max(devices_alive // m, 1), model=m)
    return ElasticPlan(data=devices_alive // model_axis, model=model_axis)


@dataclasses.dataclass
class RetryPolicy:
    max_retries: int = 6
    base_s: float = 2.0
    cap_s: float = 120.0

    def delays(self):
        d = self.base_s
        for _ in range(self.max_retries):
            yield min(d, self.cap_s)
            d *= 2
