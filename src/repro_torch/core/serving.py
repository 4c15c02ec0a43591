"""Request-level serving simulator: continuous batching over the MIP stack.

The rest of the repo scores ONE iteration (a prefill pass or a single
decode step) for one static configuration.  This module models *traffic*:
a stream of requests with mixed prompt/output lengths arrives over time
(`RequestStream`), a continuous-batching engine (`simulate_serving`)
interleaves whole-prompt prefills with single-token decode steps, and the
KV cache is a hard token capacity that gates admission and — under the
"optimistic" policy — triggers preemption/requeue.

The engine is a discrete-event simulator at *iteration* granularity: each
iteration batches `m` tokens (sum of prefill prompts + one token per
decoding sequence) and advances the clock by `cost.cycles(m)`, where the
cost model maps iteration token counts to end-to-end scheduled cycles of
the full model.  `NetworkCostModel` derives those cycles from the real
stack — `frontend.extract_workload` lowers a per-iteration
`ShapeSpec.serving_iteration` batch composition to its weight GEMMs
(M = m via `m_tokens`), and `network.optimize_network(schedule=True)`
charges the multi-core schedule's weight-resident-segment makespan
(DESIGN.md §Network scheduler) — so the serving numbers inherit the
segment packing and the item-stream pipelining for free.

Guarantees (enforced by `tests/test_serving.py`):

* token conservation — every admitted request's tokens are emitted
  exactly once, nobody starves;
* KV occupancy never exceeds ``kv_capacity_tokens``;
* the same seed produces a bit-identical event log;
* with the default "reserve" admission policy, the continuous-batching
  makespan is never worse than the serial one-request-at-a-time baseline
  (`serial_baseline`), and strictly better whenever two requests overlap
  — the serving-level analogue of the scheduler's `scheduled <= serial`
  gate.  This holds because the cost model is forced *monotone and
  subadditive* (`_SubadditiveClosure`): merging two iterations never
  costs more than running them back to back.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Callable, Iterable, Sequence

__all__ = [
    "Request", "RequestStream", "ServeConfig", "ServeReport",
    "AffineCostModel", "NetworkCostModel", "simulate_serving",
    "serial_baseline", "ServeScenario", "arch_goodput", "percentile",
]


# --------------------------------------------------------------------------
# Requests and arrival streams
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request: arrives, prefills its prompt, decodes tokens.

    ``output_len`` counts generated tokens *including* the one produced by
    the prefill pass (every request emits >= 1 token)."""
    rid: int
    arrival_cycles: float
    prompt_len: int
    output_len: int

    def __post_init__(self) -> None:
        if self.prompt_len < 1 or self.output_len < 1:
            raise ValueError(f"request {self.rid}: prompt/output must be >=1")


@dataclasses.dataclass(frozen=True)
class RequestStream:
    """A deterministic, sorted request arrival sequence."""
    requests: tuple[Request, ...]
    source: str = "trace"

    def __post_init__(self) -> None:
        arr = [r.arrival_cycles for r in self.requests]
        if any(b < a for a, b in zip(arr, arr[1:])):
            raise ValueError("requests must be sorted by arrival time")

    @staticmethod
    def poisson(n: int, *, seed: int,
                mean_interarrival_cycles: float,
                prompt_lens: Sequence[int] = (8, 16, 32),
                output_lens: Sequence[int] = (4, 8, 16)) -> "RequestStream":
        """Poisson arrivals with prompt/output lengths drawn uniformly from
        the given choice sets.  Uses ``random.Random(seed)`` (stdlib, whose
        sequences are stable across versions) so the same seed is
        bit-identical everywhere."""
        rng = random.Random(seed)
        t = 0.0
        reqs = []
        for i in range(n):
            t += rng.expovariate(1.0 / float(mean_interarrival_cycles))
            reqs.append(Request(i, t, int(rng.choice(list(prompt_lens))),
                                int(rng.choice(list(output_lens)))))
        return RequestStream(tuple(reqs),
                             source=f"poisson(n={n},seed={seed})")

    @staticmethod
    def from_trace(trace: str | Iterable[tuple[float, int, int]]
                   ) -> "RequestStream":
        """Trace arrivals: a path to a whitespace/comma-separated file with
        ``arrival_cycles prompt_len output_len`` per line (``#`` comments),
        or an iterable of such triples."""
        if isinstance(trace, str):
            rows = []
            with open(trace) as fh:
                for line in fh:
                    line = line.split("#", 1)[0].strip().replace(",", " ")
                    if line:
                        a, p, o = line.split()
                        rows.append((float(a), int(p), int(o)))
            source = f"trace({trace})"
        else:
            rows = [(float(a), int(p), int(o)) for a, p, o in trace]
            source = f"trace(rows={len(rows)})"
        rows.sort(key=lambda r: r[0])
        reqs = tuple(Request(i, a, p, o) for i, (a, p, o) in enumerate(rows))
        return RequestStream(reqs, source=source)


# --------------------------------------------------------------------------
# Iteration cost models
# --------------------------------------------------------------------------

class _SubadditiveClosure:
    """Monotone + subadditive closure of a raw per-iteration cost.

    Given raw scheduled cycles at power-of-two anchor token counts, define

        env(m) = min over anchors a >= m of raw(a)        (monotone)
        f(m)   = min(env(m), min over 1<=j<m of f(j) + f(m-j))

    By induction f is non-decreasing and subadditive
    (``f(a+b) <= f(a) + f(b)``): a batched iteration is never charged more
    than the iterations it merged, which is what makes the continuous-
    batching makespan provably <= the serial baseline (both are charged
    through the same f).  The closure is exact at the anchors up to the
    envelope, and conservative in between."""

    def __init__(self, raw_at_anchor: Callable[[int], float], max_m: int):
        if max_m < 1:
            raise ValueError("max_m must be >= 1")
        anchors = []
        a = 1
        while a < max_m:
            anchors.append(a)
            a *= 2
        anchors.append(a)
        raw = [float(raw_at_anchor(a)) for a in anchors]
        # Monotone envelope over anchors: env at anchor i = min raw[i:].
        env = list(raw)
        for i in range(len(env) - 2, -1, -1):
            env[i] = min(env[i], env[i + 1])
        self._anchors = anchors
        self._env_at_anchor = env
        self._f = [0.0]  # f[0] = 0; extended lazily

    def _env(self, m: int) -> float:
        for a, e in zip(self._anchors, self._env_at_anchor):
            if a >= m:
                return e
        raise ValueError(f"m={m} beyond largest anchor {self._anchors[-1]}")

    def cycles(self, m: int) -> float:
        m = int(m)
        if m < 0:
            raise ValueError("m must be >= 0")
        f = self._f
        while len(f) <= m:
            i = len(f)
            best = self._env(i)
            for j in range(1, i // 2 + 1):
                best = min(best, f[j] + f[i - j])
            f.append(best)
        return f[m]


class AffineCostModel:
    """``cycles(m) = base + per_token * m`` (0 at m=0).

    Subadditive for ``base >= 0`` (strictly for ``base > 0``) and monotone
    for ``per_token >= 0`` — the fast, exactly-analyzable model the
    property/differential tests fuzz the engine with."""

    def __init__(self, base: float = 100.0, per_token: float = 10.0,
                 freq_ghz: float = 1.0):
        if base < 0 or per_token < 0:
            raise ValueError("base/per_token must be >= 0")
        self.base, self.per_token = float(base), float(per_token)
        self.freq_ghz = float(freq_ghz)

    def cycles(self, m: int) -> float:
        return 0.0 if m <= 0 else self.base + self.per_token * m

    def seconds(self, m: int) -> float:
        return self.cycles(m) / (self.freq_ghz * 1e9)


class NetworkCostModel:
    """Iteration cost from the real MIREDO stack.

    Each power-of-two anchor token count ``m`` is lowered through
    ``ShapeSpec.serving_iteration`` -> ``frontend.extract_workload`` ->
    ``network.optimize_network(schedule=True)`` and charged the multi-core
    *scheduled* cycles (weight-resident segments + item-stream makespan;
    serial sum when scheduling finds nothing to pack).  Arbitrary m is
    served through the monotone+subadditive closure over those anchors
    (`_SubadditiveClosure`), which keeps the batched-vs-serial guarantee
    while bounding the number of solves to O(log max_m)."""

    def __init__(self, cfg, arch, *, max_m: int = 1024,
                 context_len: int = 4096, mode: str = "greedy",
                 per_layer_cap_s: float = 2.0, use_cache: bool = False,
                 cache=None, workers: int = 1,
                 schedule_boundaries: bool = True, verbose: bool = False):
        from repro_torch.core.frontend import extract_workload
        from repro_torch.core.network import optimize_network
        from repro_torch.configs.base import ShapeSpec

        self.cfg, self.arch = cfg, arch
        self.freq_ghz = float(getattr(arch, "freq_ghz", 1.0))
        self.n_solves = 0
        self.anchor_cycles: dict[int, float] = {}

        def raw(m: int) -> float:
            spec = ShapeSpec.serving_iteration((), m,
                                               context_len=context_len)
            work = extract_workload(cfg, spec)
            net = optimize_network(
                list(work.layers), arch, mode,
                counts=list(work.counts),
                per_layer_cap_s=per_layer_cap_s,
                workers=workers, cache=cache, use_cache=use_cache,
                schedule=True, verbose=verbose)
            self.n_solves += 1
            self.anchor_cycles[m] = float(net.scheduled_cycles)
            return self.anchor_cycles[m]

        self._closure = _SubadditiveClosure(raw, max_m)

    def cycles(self, m: int) -> float:
        return self._closure.cycles(m)

    def seconds(self, m: int) -> float:
        return self.cycles(m) / (self.freq_ghz * 1e9)


# --------------------------------------------------------------------------
# The continuous-batching engine
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs.  ``admission``:

    * ``"reserve"`` (default): admit a request only when its *worst-case*
      KV need (prompt + output tokens) fits inside the unreserved
      capacity.  No preemption can ever be needed, so the batched-vs-
      serial guarantee holds.
    * ``"optimistic"``: admit as soon as the (re)prefill itself fits; when
      KV growth would overflow capacity, the latest-admitted participant
      is preempted — its KV freed, generated-so-far kept — and requeued at
      the *front* of the waiting queue (recompute-style requeue).

    SLO thresholds are in cycles (convert seconds via the arch's
    ``freq_ghz``); ``None`` disables that bound, so with no SLOs goodput
    equals throughput."""
    kv_capacity_tokens: int = 4096
    max_batch_requests: int = 64
    max_batch_tokens: int = 1024
    admission: str = "reserve"
    slo_ttft_cycles: float | None = None
    slo_itl_cycles: float | None = None

    def __post_init__(self) -> None:
        if self.admission not in ("reserve", "optimistic"):
            raise ValueError(f"unknown admission policy {self.admission!r}")
        if min(self.kv_capacity_tokens, self.max_batch_requests,
               self.max_batch_tokens) < 1:
            raise ValueError("capacities must be >= 1")


@dataclasses.dataclass
class RequestMetrics:
    rid: int
    arrival_cycles: float
    prompt_len: int
    output_len: int
    first_token_cycles: float = 0.0
    finish_cycles: float = 0.0
    itls: tuple[float, ...] = ()
    n_preemptions: int = 0

    @property
    def ttft_cycles(self) -> float:
        return self.first_token_cycles - self.arrival_cycles

    def meets_slo(self, cfg: ServeConfig) -> bool:
        if cfg.slo_ttft_cycles is not None and \
                self.ttft_cycles > cfg.slo_ttft_cycles:
            return False
        if cfg.slo_itl_cycles is not None and self.itls and \
                max(self.itls) > cfg.slo_itl_cycles:
            return False
        return True


def percentile(values: Sequence[float], q: float) -> float:
    """Deterministic nearest-rank percentile (q in [0, 100])."""
    if not values:
        return 0.0
    s = sorted(values)
    idx = max(0, -(-int(q) * len(s) // 100) - 1) if q > 0 else 0
    return s[min(idx, len(s) - 1)]


@dataclasses.dataclass
class ServeReport:
    """Everything one simulation produced.  ``events`` is the bit-identical
    determinism surface: tuples ``(t_cycles, kind, rid, aux)`` with kinds
    arrive / reject / admit / preempt / token / finish / iter (for iter,
    rid = iteration tokens m, aux = KV occupancy after the iteration)."""
    cfg: ServeConfig
    finished: list[RequestMetrics]
    rejected: list[int]
    events: list[tuple[float, str, int, int]]
    makespan_cycles: float
    n_iterations: int
    n_merged_iterations: int
    n_preemptions: int
    max_kv_occupancy: int
    max_concurrency: int

    @property
    def ttfts(self) -> list[float]:
        return [m.ttft_cycles for m in self.finished]

    @property
    def itls(self) -> list[float]:
        return [v for m in self.finished for v in m.itls]

    @property
    def total_output_tokens(self) -> int:
        return sum(m.output_len for m in self.finished)

    def tokens_per_sec(self, freq_ghz: float = 1.0) -> float:
        if self.makespan_cycles <= 0:
            return 0.0
        return self.total_output_tokens / (self.makespan_cycles /
                                           (freq_ghz * 1e9))

    def goodput_tokens_per_sec(self, freq_ghz: float = 1.0) -> float:
        """Sustained tokens/sec counting only requests that met the SLO."""
        if self.makespan_cycles <= 0:
            return 0.0
        good = sum(m.output_len for m in self.finished
                   if m.meets_slo(self.cfg))
        return good / (self.makespan_cycles / (freq_ghz * 1e9))

    def summary(self, freq_ghz: float = 1.0) -> dict[str, float]:
        return {
            "n_finished": len(self.finished),
            "n_rejected": len(self.rejected),
            "ttft_p50_cycles": percentile(self.ttfts, 50),
            "ttft_p99_cycles": percentile(self.ttfts, 99),
            "itl_p50_cycles": percentile(self.itls, 50),
            "itl_p99_cycles": percentile(self.itls, 99),
            "makespan_cycles": self.makespan_cycles,
            "tokens_per_sec": self.tokens_per_sec(freq_ghz),
            "goodput_tokens_per_sec": self.goodput_tokens_per_sec(freq_ghz),
            "n_iterations": self.n_iterations,
            "n_merged_iterations": self.n_merged_iterations,
            "n_preemptions": self.n_preemptions,
            "max_kv_occupancy": self.max_kv_occupancy,
            "max_concurrency": self.max_concurrency,
        }


@dataclasses.dataclass
class _Run:
    """Mutable per-request engine state.  ``kv_held`` counts KV slots the
    request occupies right now: ``prompt + generated`` once (re)prefilled
    (the emitted token's KV is appended the moment it is generated)."""
    req: Request
    generated: int = 0
    kv_held: int = 0
    prefilled: bool = False
    last_emit_cycles: float = 0.0
    metrics: RequestMetrics | None = None
    _itls: list[float] = dataclasses.field(default_factory=list)


def simulate_serving(stream: RequestStream, cost,
                     cfg: ServeConfig = ServeConfig()) -> ServeReport:
    """Run the continuous-batching engine over a request stream.

    ``cost`` is any object with ``cycles(m) -> float`` (monotone and
    subadditive for the batched-vs-serial guarantee; `AffineCostModel` and
    `NetworkCostModel` both qualify by construction).

    Event loop (iteration granularity):

    1. pull arrivals with ``arrival <= t``; requests that can never
       complete (worst-case KV need > capacity, or whose largest possible
       prefill > ``max_batch_tokens``) are *rejected* up front;
    2. admit from the FIFO waiting queue (FIFO-blocking: stop at the first
       request that does not fit, so nobody is overtaken forever);
    3. compose the iteration: one token per decoding sequence, plus
       whole-prompt prefills for admitted-but-unprefilled requests in
       admission order while the token total fits ``max_batch_tokens``
       (also FIFO-blocking; a lone oversize prefill runs by itself);
    4. under "optimistic" admission, preempt latest-admitted participants
       until the iteration's KV growth fits capacity (never the last one
       — a lone feasible request always fits, see `ServeConfig`);
    5. advance the clock by ``cost.cycles(m)`` and emit one token per
       participant; finished requests free their KV immediately.
    """
    reqs = sorted(stream.requests, key=lambda r: (r.arrival_cycles, r.rid))
    arrivals = collections.deque(reqs)
    waiting: collections.deque[_Run] = collections.deque()
    running: list[_Run] = []        # admission order (LIFO preemption)
    finished: list[RequestMetrics] = []
    rejected: list[int] = []
    events: list[tuple[float, str, int, int]] = []
    t = 0.0
    occupied = 0                    # KV slots held, all running requests
    reserved = 0                    # worst-case KV reserved ("reserve")
    n_iter = n_merged = n_preempt = max_occ = max_conc = 0
    kv_cap = cfg.kv_capacity_tokens
    optimistic = cfg.admission == "optimistic"

    def feasible(r: Request) -> bool:
        if r.prompt_len + r.output_len > kv_cap:
            return False
        # Largest (re)prefill the request can ever need in one iteration:
        # preemption-recompute covers prompt + generated-so-far tokens.
        worst_prefill = r.prompt_len + \
            (r.output_len - 1 if optimistic else 0)
        return worst_prefill <= cfg.max_batch_tokens

    def pull_arrivals() -> None:
        while arrivals and arrivals[0].arrival_cycles <= t:
            r = arrivals.popleft()
            events.append((r.arrival_cycles, "arrive", r.rid, 0))
            if feasible(r):
                waiting.append(_Run(r, metrics=RequestMetrics(
                    r.rid, r.arrival_cycles, r.prompt_len, r.output_len)))
            else:
                rejected.append(r.rid)
                events.append((r.arrival_cycles, "reject", r.rid, 0))

    def admit() -> None:
        nonlocal reserved
        while waiting and len(running) < cfg.max_batch_requests:
            run = waiting[0]
            need = run.req.prompt_len + run.req.output_len
            if optimistic:
                # (re)prefill appends prompt+generated+1 KV slots.
                if occupied + run.req.prompt_len + run.generated + 1 > \
                        kv_cap:
                    break
            else:
                if reserved + need > kv_cap:
                    break
                reserved += need
            waiting.popleft()
            run.prefilled = False
            running.append(run)
            events.append((t, "admit", run.req.rid, run.generated))

    def emit(run: _Run) -> None:
        nonlocal occupied, reserved, max_occ
        new_held = run.req.prompt_len + run.generated + 1
        occupied += new_held - run.kv_held
        run.kv_held = new_held
        run.generated += 1
        m = run.metrics
        events.append((t, "token", run.req.rid, run.generated))
        if run.generated == 1:
            m.first_token_cycles = t
        else:
            run._itls.append(t - run.last_emit_cycles)
        run.last_emit_cycles = t
        if run.generated >= run.req.output_len:
            running.remove(run)
            occupied -= run.kv_held
            run.kv_held = 0
            if not optimistic:
                reserved -= run.req.prompt_len + run.req.output_len
            m.finish_cycles = t
            m.itls = tuple(run._itls)
            finished.append(m)
            events.append((t, "finish", run.req.rid, run.generated))

    while arrivals or waiting or running:
        pull_arrivals()
        admit()
        if not running:
            # Idle: nothing admitted; jump to the next arrival.  (An empty
            # engine always admits any feasible waiting request, so
            # waiting is empty here.)  If this pull rejected the tail of
            # the stream there is nothing left at all: we are done.
            if not arrivals:
                break
            t = max(t, arrivals[0].arrival_cycles)
            continue

        # -- compose the iteration ---------------------------------------
        decodes = [r for r in running if r.prefilled]
        prefills: list[_Run] = []
        tok = len(decodes)
        for r in running:
            if r.prefilled:
                continue
            p = r.req.prompt_len + r.generated
            if (decodes or prefills) and tok + p > cfg.max_batch_tokens:
                break               # FIFO-blocking: wait for space
            prefills.append(r)
            tok += p

        # -- optimistic KV gate: preempt latest-admitted participants ----
        if optimistic:
            def growth() -> int:
                return sum(r.req.prompt_len + r.generated + 1 - r.kv_held
                           for r in prefills) + len(decodes)
            while occupied + growth() > kv_cap and \
                    len(decodes) + len(prefills) > 1:
                victim = next(r for r in reversed(running)
                              if r in decodes or r in prefills)
                running.remove(victim)
                (decodes if victim in decodes else prefills).remove(victim)
                tok -= 1 if victim.prefilled else \
                    victim.req.prompt_len + victim.generated
                occupied -= victim.kv_held
                victim.kv_held = 0
                victim.prefilled = False
                victim.metrics.n_preemptions += 1
                n_preempt += 1
                waiting.appendleft(victim)
                events.append((t, "preempt", victim.req.rid,
                               victim.generated))

        # -- execute ------------------------------------------------------
        participants = len(decodes) + len(prefills)
        n_iter += 1
        n_merged += participants >= 2
        max_conc = max(max_conc, participants)
        t += float(cost.cycles(tok))
        for r in prefills:
            r.prefilled = True
            emit(r)
        for r in decodes:
            emit(r)
        assert occupied <= kv_cap, "KV capacity invariant violated"
        max_occ = max(max_occ, occupied)
        events.append((t, "iter", tok, occupied))

    return ServeReport(cfg=cfg, finished=finished, rejected=rejected,
                       events=events, makespan_cycles=t,
                       n_iterations=n_iter, n_merged_iterations=n_merged,
                       n_preemptions=n_preempt, max_kv_occupancy=max_occ,
                       max_concurrency=max_conc)


def serial_baseline(stream: RequestStream, cost,
                    cfg: ServeConfig = ServeConfig()) -> ServeReport:
    """One request at a time, FIFO, charged through the SAME cost model:
    the differential baseline.  Implemented as the engine itself with
    ``max_batch_requests=1`` under "reserve" admission (no batching, no
    preemption), so any divergence is continuous batching, not modeling."""
    serial_cfg = dataclasses.replace(cfg, max_batch_requests=1,
                                     admission="reserve")
    return simulate_serving(stream, cost, serial_cfg)


# --------------------------------------------------------------------------
# DSE integration: rank architectures by goodput under SLO
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServeScenario:
    """The traffic scenario `dse.run_dse(rank_by="slo_goodput")` ranks
    architectures under: models x one seeded Poisson stream x SLOs."""
    model_ids: tuple[str, ...] = ("minicpm-2b",)
    reduced: bool = True
    n_requests: int = 32
    seed: int = 0
    mean_interarrival_cycles: float = 50_000.0
    prompt_lens: tuple[int, ...] = (8, 16, 32)
    output_lens: tuple[int, ...] = (4, 8, 16)
    serve: ServeConfig = dataclasses.field(default_factory=ServeConfig)
    context_len: int = 4096
    cost_mode: str = "greedy"
    per_layer_cap_s: float = 1.0

    def stream(self) -> RequestStream:
        return RequestStream.poisson(
            self.n_requests, seed=self.seed,
            mean_interarrival_cycles=self.mean_interarrival_cycles,
            prompt_lens=self.prompt_lens, output_lens=self.output_lens)


def arch_goodput(scenario: ServeScenario, arch, *, cache=None,
                 use_cache: bool = False) -> dict[str, float]:
    """Mean SLO goodput (tokens/sec) of one architecture under a traffic
    scenario; per-model values under their model id, the mean under
    ``"mean"``."""
    from repro_torch.configs import get_config

    out: dict[str, float] = {}
    for mid in scenario.model_ids:
        cfg = get_config(mid)
        if scenario.reduced:
            cfg = cfg.reduced()
        cost = NetworkCostModel(
            cfg, arch, max_m=scenario.serve.max_batch_tokens,
            context_len=scenario.context_len, mode=scenario.cost_mode,
            per_layer_cap_s=scenario.per_layer_cap_s,
            cache=cache, use_cache=use_cache)
        rep = simulate_serving(scenario.stream(), cost, scenario.serve)
        out[mid] = rep.goodput_tokens_per_sec(cost.freq_ghz)
    out["mean"] = sum(out.values()) / max(len(scenario.model_ids), 1)
    return out
