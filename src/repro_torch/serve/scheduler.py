"""Streaming serve runtime: latency-budget micro-batching per link group.

Production traffic arrives one request at a time, not as pre-formed
B=4096 batches -- and at small B the linked launch is slower per doc
than the sequential engine (``BENCH_registry.json``).  The scheduler
turns the synchronous :class:`~repro.serve.engine.ServeEngine` admission
path into a stream runtime (DESIGN.md §14):

- :meth:`StreamScheduler.offer` parses/guards one request immediately
  (a guard reject is terminal at offer time, billed its true wall) and
  queues the survivor on its **link group's lane** (sequential-only
  endpoints get per-endpoint ``seq:`` lanes, so a degraded or
  unbatchable endpoint never holds up anyone else's drains).
- a lane fires when its oldest request has waited ``max_delay_s`` (the
  admission deadline) or the lane holds ``max_batch`` requests;
  :meth:`StreamScheduler.drain` serves the ready lane with the oldest
  head -- earliest-deadline-first over lanes, FIFO within a lane, which
  is starvation-free by construction.
- each drain routes through a measured **cost model**: predicted
  batched cost (one pow2-bucketed group launch, amortizing its fixed
  cost over the riders) versus predicted sequential cost (per-doc
  bounded oracle).  Small or cold bursts go sequential, hot bursts ride
  the group's linked tape.  Priors are seeded from committed ``BENCH_*``
  measurements and updated online with per-(lane, bucket) EMAs; sampled
  drains arm the §13 phase profiler so the update reads *attributed*
  encode+launch (or fallback) time rather than drain bookkeeping.

Both routes produce verdicts through the registry's containment ladder
and finish through ``ServeEngine._finish`` -- a request's
:class:`~repro.serve.engine.SubmitResult` is identical to what
``submit_batch`` would have produced, and per-request outcomes are
independent of drain timing (isolation keys are per-request serials, so
batch composition never changes a verdict; differentially tested).

Latency accounting closes the §13 under-count: ``serve_request_seconds``
observes **admission -> verdict wall including queue delay**
(``completion - arrival``), and ``serve_queue_delay_seconds`` tracks the
queueing component alone.  ``serve_queue_depth`` and
``serve_group_occupancy`` gauges expose the instantaneous backlog.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Deque, Dict, List, Optional, Tuple

from ..core.outcomes import ValidationOutcome
from ..obs.metrics import DEFAULT_LATENCY_BUCKETS
from ..obs.profile import Profiler, profiler_armed, set_profiler
from ..obs.trace import span as _span
from .engine import SubmitResult

__all__ = [
    "SchedulerConfig",
    "CostModel",
    "Ticket",
    "DrainReport",
    "StreamScheduler",
    "seed_priors_from_bench",
]

_ROUTES = ("auto", "batched", "sequential")


@dataclass
class SchedulerConfig:
    """Micro-batcher knobs (DESIGN.md §14)."""

    max_delay_s: float = 0.002  # admission deadline per request
    max_batch: int = 256  # lane drain cap (pow2-bucketed downstream)
    route: str = "auto"  # "auto" | "batched" | "sequential" (pinned)
    explain: bool = False  # first-failure attribution on INVALID
    # cost-model priors (µs); overridden by seed_priors_from_bench and
    # then by online EMA measurement
    launch_fixed_us: float = 2500.0  # per-launch fixed cost (encode+dispatch)
    launch_us_per_doc: float = 100.0  # marginal batched cost per rider
    seq_us_per_doc: float = 25.0  # bounded sequential oracle per doc
    ema_alpha: float = 0.25  # online update weight
    profile_every: int = 16  # arm the §13 profiler every Nth drain (0=off)
    # "auto" = seed priors from results/BENCH_registry_torch.json (the
    # port's own measurements, never the JAX package's) when present;
    # a path seeds from that file; None/"" keeps the config priors
    bench_priors: Optional[str] = "auto"
    # pow2 batch shapes to pre-trace per group at attach time, so
    # deadline-bounded drains never pay a jit trace (empty = skip)
    warm_shapes: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.route not in _ROUTES:
            raise ValueError(f"route {self.route!r} not in {_ROUTES}")


def _bucket(n: int) -> int:
    """Power-of-two launch bucket (matches admission padding)."""
    return 1 << (n - 1).bit_length() if n > 1 else 1


def seed_priors_from_bench(path: Any) -> Optional[Dict[str, float]]:
    """Derive cost-model priors from a committed ``BENCH_registry.json``.

    Fits ``launch(B) = fixed + slope*B`` through the two smallest-B
    throughput rows of the *end-to-end* batched cost (linked launch +
    encode, both paid by a drain), and takes the most conservative
    (slowest) measured sequential per-doc cost.  Returns None when the
    file is missing or shaped unexpectedly -- callers keep their
    defaults.
    """
    try:
        data = json.loads(Path(path).read_text())
        rows = sorted(data["throughput"], key=lambda r: r["batch"])[:2]
        (b1, b2) = (rows[0]["batch"], rows[1]["batch"])
        if b1 == b2:
            return None
        total = [
            r["batch"] * (r["linked_us_per_doc"] + r["encode_us_per_doc"])
            for r in rows
        ]
        slope = (total[1] - total[0]) / (b2 - b1)
        fixed = total[0] - slope * b1
        seq = max(float(r["sequential_us_per_doc"]) for r in data["throughput"])
        if slope <= 0 or seq <= 0:
            return None
        return {
            "launch_fixed_us": max(fixed, 0.0),
            "launch_us_per_doc": slope,
            "seq_us_per_doc": seq,
        }
    except Exception:
        return None


class CostModel:
    """Measured batched-vs-sequential router (per lane).

    Prediction: ``batched_us(lane, n)`` is the EMA of measured wall for
    this lane's pow2 bucket when one exists, else the linear prior
    ``fixed + slope * bucket(n)`` (the launch pays the padded bucket, not
    n).  ``sequential_us(lane, n)`` is ``n`` times the lane's measured
    per-doc EMA (prior until measured).  Update rule (per drain):
    ``ema <- (1-alpha)*ema + alpha*observation``, keyed per (lane,
    bucket) for batched drains and per lane for sequential drains, so a
    fat group's launch cost never pollutes a lean group's routing.
    """

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.launch_fixed_us = cfg.launch_fixed_us
        self.launch_us_per_doc = cfg.launch_us_per_doc
        self.seq_us_per_doc = cfg.seq_us_per_doc
        self._launch_ema: Dict[Tuple[str, int], float] = {}
        self._seq_ema: Dict[str, float] = {}

    def seed(self, priors: Optional[Dict[str, float]]) -> None:
        if priors:
            self.launch_fixed_us = priors["launch_fixed_us"]
            self.launch_us_per_doc = priors["launch_us_per_doc"]
            self.seq_us_per_doc = priors["seq_us_per_doc"]

    def batched_us(self, lane: str, n: int) -> float:
        b = _bucket(n)
        ema = self._launch_ema.get((lane, b))
        if ema is not None:
            return ema
        return self.launch_fixed_us + self.launch_us_per_doc * b

    def sequential_us(self, lane: str, n: int) -> float:
        return n * self._seq_ema.get(lane, self.seq_us_per_doc)

    def prefer_batched(self, lane: str, n: int) -> bool:
        return self.batched_us(lane, n) < self.sequential_us(lane, n)

    def observe(self, lane: str, route: str, n: int, wall_us: float) -> None:
        a = self.cfg.ema_alpha
        if route == "batched":
            key = (lane, _bucket(n))
            prev = self._launch_ema.get(key)
            self._launch_ema[key] = (
                wall_us if prev is None else (1 - a) * prev + a * wall_us
            )
        else:
            per_doc = wall_us / max(n, 1)
            prev = self._seq_ema.get(lane)
            self._seq_ema[lane] = (
                per_doc if prev is None else (1 - a) * prev + a * per_doc
            )

    def snapshot(self) -> Dict[str, Any]:
        return {
            "priors": {
                "launch_fixed_us": self.launch_fixed_us,
                "launch_us_per_doc": self.launch_us_per_doc,
                "seq_us_per_doc": self.seq_us_per_doc,
            },
            "launch_ema_us": {
                f"{lane}@{b}": round(v, 3)
                for (lane, b), v in sorted(self._launch_ema.items())
            },
            "seq_ema_us_per_doc": {
                lane: round(v, 3) for lane, v in sorted(self._seq_ema.items())
            },
        }


@dataclass
class Ticket:
    """One offered request's handle; terminal after its drain."""

    endpoint: str
    serial: int
    arrival: float
    label: str = ""
    result: Optional[SubmitResult] = None
    latency_s: float = 0.0  # admission -> verdict, queue delay included
    queue_delay_s: float = 0.0

    @property
    def done(self) -> bool:
        return self.result is not None


@dataclass
class DrainReport:
    """What one :meth:`StreamScheduler.drain` did."""

    lane: str
    route: str  # "batched" | "sequential"
    n: int
    wall_s: float
    predicted_batched_us: float
    predicted_sequential_us: float


@dataclass
class _Queued:
    ticket: Ticket
    request: Any  # parsed document


@dataclass
class SchedulerStats:
    offered: int = 0
    rejected_at_offer: int = 0
    drains: int = 0
    drained: int = 0
    routed: Dict[str, int] = field(default_factory=lambda: {"batched": 0, "sequential": 0})


class StreamScheduler:
    """Micro-batching front end over one :class:`ServeEngine`.

    Synchronous by design (the repo's engines are synchronous): callers
    drive time with :meth:`drain`/:meth:`pump`/:meth:`flush`, and may
    inject ``now`` everywhere -- the open-loop load harness runs the
    scheduler on a virtual clock, tests on a hand-cranked one.  Wall
    time *inside* a drain is always measured on the real clock and added
    to the caller's ``now``, so latency billing stays honest in both
    modes.
    """

    def __init__(self, engine, cfg: Optional[SchedulerConfig] = None):
        from .engine import ServeEngine  # circular-import guard

        assert isinstance(engine, ServeEngine)
        self.engine = engine
        self.cfg = cfg if cfg is not None else SchedulerConfig()
        self.clock = engine.registry.clock
        self.cost = CostModel(self.cfg)
        if self.cfg.bench_priors:
            path = self.cfg.bench_priors
            if path == "auto":
                path = (
                    Path(__file__).resolve().parents[3]
                    / "results"
                    / "BENCH_registry_torch.json"
                )
            self.cost.seed(seed_priors_from_bench(path))
        self.stats = SchedulerStats()
        self._lanes: Dict[str, Deque[_Queued]] = {}
        m = engine.registry.metrics
        self._g_depth = m.gauge(
            "serve_queue_depth", "arrived-but-unserved requests at launch time"
        )
        self._h_qdelay: Dict[str, Any] = {}
        self._m_drains = {
            route: m.counter(
                "serve_drains_total",
                "scheduler drains by route",
                route=route,
            )
            for route in ("batched", "sequential")
        }
        self.last_profile: Optional[Dict[str, Any]] = None
        if self.cfg.warm_shapes:
            engine.registry.warm_groups(
                self.cfg.warm_shapes,
                max_nodes=engine.scfg.admission_max_nodes,
            )

    # -- admission -------------------------------------------------------------

    def offer(
        self, endpoint: str, request_json: str, *, now: Optional[float] = None
    ) -> Ticket:
        """Accept one request into the stream.

        Parse + pre-validation guards run immediately (their rejects are
        terminal here, billed the true offer wall); everything else
        queues on its link group's lane until :meth:`drain`.
        """
        now = self.clock() if now is None else now
        eng = self.engine
        t0 = time.perf_counter()
        eng.stats.received += 1
        serial = eng.stats.received
        ticket = Ticket(endpoint=endpoint, serial=serial, arrival=now)
        request, err = eng._parse(request_json, endpoint)
        ticket.label = endpoint if endpoint in eng.registry else "__unknown__"
        self.stats.offered += 1
        if err:
            self.stats.rejected_at_offer += 1
            result = SubmitResult(None, err, ValidationOutcome.REJECTED_GUARD)
            self._complete(
                ticket,
                result,
                latency_s=time.perf_counter() - t0,
                queue_delay_s=0.0,
                stages={"route": "offer"},
            )
            return ticket
        group = eng.registry.group_of(endpoint)
        lane = group.label if group is not None else f"seq:{endpoint}"
        q = self._lanes.get(lane)
        if q is None:
            q = self._lanes[lane] = deque()
        q.append(_Queued(ticket=ticket, request=request))
        self._g_depth.set(self.depth())
        self._occupancy(lane, len(q))
        return ticket

    def depth(self) -> int:
        """Total queued (offered, not yet drained) requests."""
        return sum(len(q) for q in self._lanes.values())

    def next_fire_s(self, now: Optional[float] = None) -> Optional[float]:
        """When the earliest lane becomes drainable (None = all empty).

        Returns ``now`` when some lane is already past its deadline or
        full -- the open-loop harness uses this to decide whether the
        server sleeps or launches.
        """
        now = self.clock() if now is None else now
        deadline: Optional[float] = None
        for q in self._lanes.values():
            if not q:
                continue
            if len(q) >= self.cfg.max_batch:
                return now
            d = q[0].ticket.arrival + self.cfg.max_delay_s
            deadline = d if deadline is None else min(deadline, d)
        if deadline is None:
            return None
        return max(deadline, now) if deadline > now else now

    # -- draining --------------------------------------------------------------

    def drain(
        self, *, now: Optional[float] = None, force: bool = False
    ) -> Optional[DrainReport]:
        """Serve ONE ready lane (earliest-deadline head first).

        A lane is ready when its head has aged past ``max_delay_s`` or
        the lane is full; ``force=True`` also drains a not-yet-due lane
        (used by :meth:`flush` and end-of-stream).  Returns None when
        nothing drained.
        """
        now = self.clock() if now is None else now
        candidates = []
        for lane, q in self._lanes.items():
            if not q:
                continue
            ready = (
                len(q) >= self.cfg.max_batch
                or now >= q[0].ticket.arrival + self.cfg.max_delay_s
            )
            if ready or force:
                candidates.append((q[0].ticket.arrival, lane))
        if not candidates:
            return None
        _, lane = min(candidates)
        q = self._lanes[lane]
        items = [q.popleft() for _ in range(min(len(q), self.cfg.max_batch))]
        report = self._serve(lane, items, now)
        self._g_depth.set(self.depth())
        self._occupancy(lane, len(q))
        return report

    def pump(self, now: Optional[float] = None) -> List[DrainReport]:
        """Drain every lane that is due at ``now``."""
        reports = []
        while True:
            r = self.drain(now=now)
            if r is None:
                return reports
            reports.append(r)

    def flush(self, now: Optional[float] = None) -> List[DrainReport]:
        """Force-drain everything (end of stream / shutdown)."""
        reports = []
        while self.depth():
            r = self.drain(now=now, force=True)
            if r is None:  # pragma: no cover -- depth>0 implies a lane
                break
            reports.append(r)
        return reports

    def _route(self, lane: str, n: int) -> str:
        if lane.startswith("seq:"):
            return "sequential"
        if self.cfg.route != "auto":
            return self.cfg.route
        return "batched" if self.cost.prefer_batched(lane, n) else "sequential"

    def _serve(self, lane: str, items: List[_Queued], now: float) -> DrainReport:
        eng = self.engine
        n = len(items)
        route = self._route(lane, n)
        pred_b = self.cost.batched_us(lane, n)
        pred_s = self.cost.sequential_us(lane, n)
        docs = [it.request for it in items]
        endpoints = [it.ticket.endpoint for it in items]
        keys = [("stream", it.ticket.serial) for it in items]
        # sampled §13 attribution: every Nth drain arms the phase
        # profiler (unless someone else is measuring) so the cost-model
        # update reads attributed encode+launch / fallback time
        prof: Optional[Profiler] = None
        sample = (
            self.cfg.profile_every > 0
            and self.stats.drains % self.cfg.profile_every == 0
            and not profiler_armed()
        )
        if sample:
            prof = Profiler()
            set_profiler(prof)
        t0 = time.perf_counter()
        try:
            with _span("serve.drain", lane=lane, route=route, batch=n):
                if route == "batched":
                    verdicts, counts = eng.registry.admit_mixed_ex(
                        docs,
                        endpoints,
                        max_nodes=eng.scfg.admission_max_nodes,
                        keys=keys,
                        explain=self.cfg.explain,
                    )
                    eng.stats.batch_validated += counts.batch_validated
                    eng.stats.fallback_validated += counts.fallback_validated
                    eng.stats.undecided += counts.undecided
                    eng.stats.oversize += counts.oversize
                    eng.stats.unroll_overflow += counts.unroll_overflow
                else:
                    verdicts = []
                    for doc, endpoint, key in zip(docs, endpoints, keys):
                        v = eng.registry.validate_one(
                            endpoint, doc, key=key, explain=self.cfg.explain
                        )
                        if v.outcome in (
                            ValidationOutcome.ADMITTED,
                            ValidationOutcome.INVALID,
                        ):
                            eng.stats.fallback_validated += 1
                        verdicts.append(v)
        finally:
            wall = time.perf_counter() - t0
            if sample:
                set_profiler(None)
        eng.stats.validation_seconds += wall
        self._observe_cost(lane, route, n, wall, prof)
        self.stats.drains += 1
        self.stats.drained += n
        self.stats.routed[route] += 1
        self._m_drains[route].inc()
        completion = now + wall
        for it, verdict in zip(items, verdicts):
            result = eng._finish(it.ticket.endpoint, it.request, verdict)
            self._complete(
                it.ticket,
                result,
                latency_s=completion - it.ticket.arrival,
                queue_delay_s=now - it.ticket.arrival,
                stages={
                    "route": route,
                    "drain_rows": n,
                    "drain_wall_s": wall,
                },
            )
        return DrainReport(
            lane=lane,
            route=route,
            n=n,
            wall_s=wall,
            predicted_batched_us=pred_b,
            predicted_sequential_us=pred_s,
        )

    def _observe_cost(
        self,
        lane: str,
        route: str,
        n: int,
        wall_s: float,
        prof: Optional[Profiler],
    ) -> None:
        """Online cost-model update; attributed phase time when sampled.

        On sampled drains the observation is the profiler's
        encode+launch(+explain) total for batched routes, or the
        ``fallback.sequential`` total for sequential routes -- the part
        of the drain a *bigger batch would amortize* -- falling back to
        raw wall when the phases did not fire (e.g. everything
        guard-rejected).
        """
        us = wall_s * 1e6
        if prof is not None:
            stats = prof.stats()
            names = (
                ("admit.encode", "admit.launch", "admit.explain")
                if route == "batched"
                else ("fallback.sequential",)
            )
            attributed = sum(
                stats[p].total_ns for p in names if p in stats
            ) / 1e3
            if attributed > 0:
                us = attributed
            self.last_profile = {
                "lane": lane,
                "route": route,
                "n": n,
                "wall_us": round(wall_s * 1e6, 3),
                "attributed_us": round(attributed, 3),
                "phases": {k: v.as_dict() for k, v in stats.items()},
            }
        self.cost.observe(lane, route, n, us)

    # -- completion ------------------------------------------------------------

    def _complete(
        self,
        ticket: Ticket,
        result: SubmitResult,
        *,
        latency_s: float,
        queue_delay_s: float,
        stages: Dict[str, Any],
    ) -> None:
        ticket.result = result
        ticket.latency_s = latency_s
        ticket.queue_delay_s = queue_delay_s
        eng = self.engine
        # admission -> verdict including queue delay: the stream runtime
        # never observes a flat 0.0 (§14 satellite of the §13 SLO layer)
        eng._latency(ticket.label).observe(max(latency_s, 0.0))
        self._qdelay(ticket.label).observe(max(queue_delay_s, 0.0))
        ev = eng.events
        if ev is not None and ev.want():
            ev.emit(
                kind="stream",
                endpoint=ticket.label,
                request_id=result.request_id,
                outcome=result.outcome.value,
                latency_s=latency_s,
                stages={**stages, "queue_delay_s": queue_delay_s},
            )

    def _qdelay(self, endpoint: str):
        h = self._h_qdelay.get(endpoint)
        if h is None:
            h = self._h_qdelay[endpoint] = self.engine.registry.metrics.histogram(
                "serve_queue_delay_seconds",
                "scheduler queue wait (offer -> drain start)",
                buckets=DEFAULT_LATENCY_BUCKETS,
                endpoint=endpoint,
            )
        return h

    def _occupancy(self, lane: str, depth: int) -> None:
        self.engine.registry.metrics.gauge(
            "serve_group_occupancy",
            "queued requests per link-group lane",
            group=lane,
        ).set(depth)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-ready scheduler view (cost model included)."""
        return {
            "offered": self.stats.offered,
            "rejected_at_offer": self.stats.rejected_at_offer,
            "drains": self.stats.drains,
            "drained": self.stats.drained,
            "routed": dict(self.stats.routed),
            "depth": self.depth(),
            "lanes": {lane: len(q) for lane, q in self._lanes.items()},
            "cost_model": self.cost.snapshot(),
        }
