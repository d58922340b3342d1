"""Serving engine: Blaze admission on the request path + batched decode.

The paper's motivating deployment is an API gateway validating every
request before the expensive work.  Here the expensive work is LM
inference: ``submit`` validates the JSON request against its endpoint's
schema (compiled Blaze validator -- the latency-critical path the paper
measures), tokenizes the prompt, and assigns a batch slot; ``step``
prefills newly admitted requests and decodes one token for every active
slot.  Slot bookkeeping is a miniature continuous-batching scheduler.

Multi-tenant routing: the engine owns a
:class:`~repro.registry.SchemaRegistry` of per-endpoint request schemas
(endpoint ``"default"`` always exists).  ``submit`` validates one
request sequentially; ``submit_batch`` admits a mixed-endpoint burst in
one batched launch per link group (DESIGN.md §14), falling back to each
endpoint's sequential validator only for undecided rows and endpoints
outside the structural subset.

Streaming traffic goes through :meth:`ServeEngine.scheduler`
(``serve/scheduler.py``): a latency-budget micro-batcher that queues
individual requests per link group and drains them through the same
admission path, routing each drain batched-vs-sequential by a measured
cost model.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.batch_executor import resolve_device
from ..core.outcomes import ValidationOutcome
from ..data import tokenizer
from ..models.config import ArchConfig
from ..models.model import Model
from ..obs.events import EventLog
from ..obs.metrics import DEFAULT_LATENCY_BUCKETS, Histogram, MetricRegistry
from ..obs.profile import phase as _phase
from ..obs.slo import SLObjective, slo_status
from ..obs.stats import RegistryBackedStats
from ..obs.trace import span as _span
from ..registry import SchemaRegistry
from ..registry.registry import RegistrationError

REQUEST_SCHEMA: Dict[str, Any] = {
    "$schema": "https://json-schema.org/draft/2020-12/schema",
    "type": "object",
    "required": ["prompt"],
    "additionalProperties": False,
    "properties": {
        "prompt": {"type": "string", "minLength": 1, "maxLength": 65536},
        "max_tokens": {"type": "integer", "minimum": 1, "maximum": 4096},
        "temperature": {"type": "number", "minimum": 0, "maximum": 2},
        "top_k": {"type": "integer", "minimum": 1, "maximum": 1000},
        "stop": {"type": "array", "items": {"type": "string"}, "maxItems": 4},
        "stream": {"type": "boolean"},
        "metadata": {
            "type": "object",
            "propertyNames": {"maxLength": 64},
            "additionalProperties": {"type": "string"},
        },
    },
}


@dataclass
class ServeConfig:
    batch_slots: int = 4
    max_len: int = 512
    default_max_tokens: int = 32
    greedy: bool = True
    admission_max_nodes: int = 128  # token-table budget for submit_batch


# default latency objective: 99% of requests within 100ms (a bucket edge
# is deliberately NOT required -- obs/slo.py interpolates; see §13)
DEFAULT_SLO = SLObjective(objective_s=0.1, target=0.99)


@dataclass
class _Slot:
    request_id: int
    tokens: List[int]
    generated: List[int] = field(default_factory=list)
    max_tokens: int = 32
    length: int = 0
    done: bool = False


class SubmitResult(tuple):
    """A ``(request_id, error)`` pair that also carries the structured
    :class:`ValidationOutcome`.

    Subclassing ``tuple`` keeps every existing call site working
    (``rid, err = engine.submit(...)``) while new code reads
    ``result.outcome`` instead of string-matching the error."""

    outcome: ValidationOutcome

    def __new__(
        cls, request_id: Optional[int], error: str, outcome: ValidationOutcome
    ) -> "SubmitResult":
        self = super().__new__(cls, (request_id, error))
        self.outcome = outcome
        return self

    @property
    def request_id(self) -> Optional[int]:
        return self[0]

    @property
    def error(self) -> str:
        return self[1]


class ServeStats(RegistryBackedStats):
    """Serving counters, registry-backed (DESIGN.md §12).

    The attribute API is unchanged (``stats.received``,
    ``stats.by_endpoint`` ...) but every field is now a live child of a
    :class:`~repro.obs.metrics.MetricRegistry` -- one
    ``render_prometheus()`` exports the whole serving surface.
    ``outcomes`` pre-populates every :class:`ValidationOutcome` key with
    0, so reconciliation (``received == sum(outcomes.values())``) reads
    the same whether or not an outcome has occurred yet.
    """

    PREFIX = "serve_"
    INT_FIELDS = (
        "received",
        "rejected",
        "admitted",
        "completed",
        "decode_steps",
        "batch_validated",  # verdicts from the linked-tape launch
        "fallback_validated",  # sequential (unbatchable or undecided)
        "validated_only",  # admitted without a decodable text field
        # why batchable rows fell back (distinct causes, never conflated):
        "undecided",  # executor depth budget
        "oversize",  # encoder node budget
        "unroll_overflow",  # $ref-unroll frontier reached
    )
    FLOAT_FIELDS = ("validation_seconds",)
    HELP = {
        "received": "requests received (exactly one outcome each)",
        "validation_seconds": "wall seconds inside admission validation",
    }

    def __init__(self, metrics: Optional[MetricRegistry] = None):
        super().__init__(metrics)
        # endpoint -> real try_build_tape failure reason (registration-
        # time info, not traffic): a plain dict that survives reset()
        self.fallback_reasons: Dict[str, str] = {}
        # terminal disposition per received document (DESIGN.md §11):
        # one ValidationOutcome value each -- pre-created so the view
        # always carries every key
        self._outcome_c = {
            o.value: self._track(
                self.metrics.counter(
                    "serve_outcomes_total",
                    "terminal dispositions by outcome",
                    outcome=o.value,
                )
            )
            for o in ValidationOutcome
        }
        self._ep_c: Dict[str, Dict[str, Any]] = {}

    @property
    def outcomes(self) -> Dict[str, int]:
        """outcome value -> count; all ValidationOutcome keys present."""
        return {k: int(c.value) for k, c in self._outcome_c.items()}

    @property
    def by_endpoint(self) -> Dict[str, Dict[str, int]]:
        return {
            e: {r: int(c.value) for r, c in per.items()}
            for e, per in self._ep_c.items()
        }

    def _ep(self, endpoint: str) -> Dict[str, Any]:
        per = self._ep_c.get(endpoint)
        if per is None:
            # both result labels exist from first touch, so the view
            # always shows {"admitted": n, "rejected": m}
            per = self._ep_c[endpoint] = {
                r: self._track(
                    self.metrics.counter(
                        "serve_endpoint_requests_total",
                        "per-endpoint admission results",
                        endpoint=endpoint,
                        result=r,
                    )
                )
                for r in ("admitted", "rejected")
            }
        return per

    def count(self, endpoint: str, key: str) -> None:
        self._ep(endpoint)[key].inc()

    def record_outcome(self, outcome: ValidationOutcome) -> None:
        self._outcome_c[outcome.value].inc()

    def snapshot(self) -> Dict[str, Any]:
        snap = super().snapshot()
        snap["outcomes"] = self.outcomes
        snap["by_endpoint"] = self.by_endpoint
        snap["fallback_reasons"] = dict(self.fallback_reasons)
        return snap


class ServeEngine:
    def __init__(
        self,
        cfg: ArchConfig,
        params: Any,
        serve_cfg: ServeConfig = ServeConfig(),
        request_schema: Optional[Dict[str, Any]] = None,
        endpoint_schemas: Optional[Dict[str, Any]] = None,
        registry: Optional[SchemaRegistry] = None,
        events: Optional[EventLog] = None,
        slo: Optional[SLObjective] = None,
        device=None,
    ):
        self.cfg = cfg
        # the LM's and the registry's device: cuda unless told otherwise
        self.device = resolve_device(device)
        self.model = Model(cfg)
        self.params = params
        self.scfg = serve_cfg
        # sampled request-event ring (obs/events.py); None = detached,
        # and the hot path pays exactly one None check per request
        self.events = events
        self._batch_seq = 0  # submit_batch launch counter -> batch ids
        # per-endpoint latency objectives (obs/slo.py); endpoints without
        # an override share the engine default
        self.slo_default = slo if slo is not None else DEFAULT_SLO
        self._slo: Dict[str, SLObjective] = {}
        # compiled ONCE per endpoint; validated per request -- the paper's
        # AOT bet (codegen engine on the request-critical path).  The
        # registry also links all batchable endpoint tapes for
        # submit_batch's single-launch mixed admission.
        self.registry = registry if registry is not None else SchemaRegistry(device=self.device)
        # one shared MetricRegistry across engine + registry + executor:
        # a single render_prometheus() exports the whole serving surface
        self.stats = ServeStats(self.registry.metrics)
        self._lat: Dict[str, Histogram] = {}
        if request_schema is not None or "default" not in self.registry:
            self.register_endpoint("default", request_schema or REQUEST_SCHEMA)
        for name, schema in (endpoint_schemas or {}).items():
            self.register_endpoint(name, schema)
        # endpoints already present on a caller-provided registry get
        # their fallback reasons surfaced too
        self.stats.fallback_reasons.update(self.registry.fallback_reasons())
        self.slots: List[Optional[_Slot]] = [None] * serve_cfg.batch_slots
        self.queue: List[_Slot] = []
        self._next_id = 0
        self.results: Dict[int, str] = {}
        self._decode = self.model.decode_step  # eager: one launch per op
        self._cache = None

    # -- admission ------------------------------------------------------------

    def register_endpoint(self, endpoint: str, schema: Any):
        """Register (or hot-swap) an endpoint schema, surfacing the real
        tape-build outcome in the engine's stats: endpoints outside the
        structural subset record their ``try_build_tape`` reason string
        instead of a generic fallback flag.

        Hot-swap safety: the registry builds, smoke-verifies, and
        trial-links the new version *before* swapping.  A failed swap on
        an already-serving endpoint keeps the prior version serving and
        surfaces the failure in :meth:`endpoint_stats` (``last_swap_error``)
        rather than raising into the control plane; a failed *first*
        registration has no prior version to fall back to and re-raises.
        """
        try:
            entry = self.registry.register(endpoint, schema)
        except RegistrationError:
            if endpoint in self.registry:
                return self.registry.get(endpoint)  # prior version serves on
            raise
        if entry.stats.batchable:
            self.stats.fallback_reasons.pop(endpoint, None)
        else:
            self.stats.fallback_reasons[endpoint] = entry.stats.fallback_reason
        return entry

    def endpoint_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-endpoint serving view: admission counters merged with the
        registry's compile-time facts (batchable, fallback reason, tape
        shape, unroll budget/frontiers)."""
        out: Dict[str, Dict[str, Any]] = {}
        swap_failures = self.registry.swap_failures()
        swap_verdicts = self.registry.swap_verdicts()
        for endpoint in self.registry.endpoints():
            entry = self.registry.get(endpoint)
            per: Dict[str, Any] = dict(
                self.stats.by_endpoint.get(endpoint, {"admitted": 0, "rejected": 0})
            )
            per["version"] = entry.version
            per["batchable"] = entry.stats.batchable
            per["fallback_reason"] = entry.stats.fallback_reason
            # compiled tape shape (SchemaStats): the batched-cost model's
            # inputs -- window bound A-hat, hash-run bound K, location
            # horizon, circuit count, unroll budget, frontier count
            per["a_hat"] = entry.stats.a_hat
            per["k"] = entry.stats.k
            per["horizon"] = entry.stats.horizon
            per["n_circuits"] = entry.stats.n_circuits
            per["unroll_depth"] = entry.stats.unroll_depth
            per["n_frontier"] = entry.stats.n_frontier
            # link-group placement (DESIGN.md §14): the group-local
            # linked windows are what this endpoint actually pays per
            # launch -- compare with the solo a_hat/horizon above to
            # read the residual member-max inflation
            group = self.registry.group_of(endpoint)
            per["link_group"] = "" if group is None else group.label
            per["group_members"] = 0 if group is None else len(group.members)
            per["group_a_hat"] = (
                0 if group is None else int(group.tape.max_rows_per_loc)
            )
            per["group_m_hat"] = (
                0 if group is None else int(group.tape.max_member_props)
            )
            per["group_horizon"] = (
                0 if group is None else int(group.tape.max_loc_depth) + 1
            )
            per["last_swap_error"] = swap_failures.get(endpoint, "")
            # schema-algebra posture (DESIGN.md §15): what register()-time
            # analysis proved/rewrote for the serving version, plus the
            # subsumption verdict of the most recent hot-swap attempt
            per["analysis_normalized"] = entry.stats.normalized
            per["pruned_branches"] = entry.stats.pruned_branches
            per["folded_assertions"] = entry.stats.folded_assertions
            per["dedup_subgraphs"] = entry.stats.dedup_subgraphs
            per["analysis_failure"] = entry.stats.analysis_failure
            per["last_swap_subsumption"] = swap_verdicts.get(endpoint, "")
            breaker = self.registry.breaker(endpoint)
            per["breaker_state"] = breaker.state
            per["breaker_trips"] = breaker.trips
            per["slo"] = self.slo_status(endpoint)
            out[endpoint] = per
        return out

    def _latency(self, endpoint: str) -> Histogram:
        """Per-endpoint request-latency histogram (one observation per
        received request; unknown endpoints share ``__unknown__``)."""
        h = self._lat.get(endpoint)
        if h is None:
            h = self._lat[endpoint] = self.registry.metrics.histogram(
                "serve_request_seconds",
                "request wall time through submit/submit_batch",
                buckets=DEFAULT_LATENCY_BUCKETS,
                endpoint=endpoint,
            )
        return h

    # -- SLO tracking (obs/slo.py, DESIGN.md §13) -----------------------------

    def set_slo(self, endpoint: str, objective: SLObjective) -> None:
        """Override the latency objective for one endpoint."""
        self._slo[endpoint] = objective

    def slo_status(self, endpoint: str) -> Dict[str, Any]:
        """Cumulative SLO view of one endpoint, computed straight from
        its ``serve_request_seconds`` histogram -- no second measurement
        path.  Also refreshes the exported SLO gauges, so calling this
        (or :meth:`endpoint_stats`/:meth:`render_metrics`) keeps the
        Prometheus surface current."""
        objective = self._slo.get(endpoint, self.slo_default)
        st = slo_status(self._latency(endpoint), objective)
        m = self.registry.metrics
        m.gauge(
            "serve_slo_good_ratio",
            "fraction of requests within the endpoint's latency objective",
            endpoint=endpoint,
        ).set(st["good_ratio"])
        m.gauge(
            "serve_slo_burn_rate",
            "error-budget burn rate (1.0 = budget consumed exactly on time)",
            endpoint=endpoint,
        ).set(st["burn_rate"])
        return st

    # -- event log (obs/events.py, DESIGN.md §13) -----------------------------

    def attach_event_log(self, events: Optional[EventLog]) -> None:
        """Attach (or detach with None) the sampled request-event ring."""
        self.events = events

    def flush_events(self, dest) -> int:
        """Flush the attached event ring to ``dest`` (path or file
        object) as JSONL; returns the record count (0 when detached)."""
        if self.events is None:
            return 0
        return self.events.flush(dest)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """JSON-ready snapshot of the shared metric registry."""
        return self.registry.metrics.snapshot()

    def render_metrics(self) -> str:
        """Prometheus exposition of the shared metric registry
        (SLO gauges refreshed first so they are never stale)."""
        for endpoint in self.registry.endpoints():
            self.slo_status(endpoint)
        return self.registry.metrics.render_prometheus()

    @property
    def validator(self):
        """The default endpoint's serving validator (hot-swap aware)."""
        return self.registry.get("default").validator

    def submit(
        self,
        request_json: str,
        endpoint: str = "default",
        *,
        explain: bool = False,
    ) -> SubmitResult:
        """Validate + enqueue one request.

        Returns a :class:`SubmitResult` -- unpackable as the historical
        ``(request_id, error)`` pair, with the structured
        ``ValidationOutcome`` on ``.outcome``.  Validation runs through
        the registry's containment ladder: resource guard, then the
        breaker-gated deadline-bounded sequential oracle.

        ``explain=True`` opts into first-failure attribution: INVALID
        rejects carry the attributed site in the error string instead of
        the generic message.  The default path is unchanged.
        """
        t_start = time.perf_counter()
        # per-stage timings flow into the sampled event record only when
        # a log is attached (stages=None keeps the hot path timer-free)
        stages: Optional[Dict[str, float]] = {} if self.events is not None else None
        result: Optional[SubmitResult] = None
        try:
            with _span("serve.submit", endpoint=endpoint):
                result = self._submit_one(request_json, endpoint, explain, stages)
                return result
        finally:
            label = endpoint if endpoint in self.registry else "__unknown__"
            latency = time.perf_counter() - t_start
            self._latency(label).observe(latency)
            ev = self.events
            if ev is not None and ev.want():
                ev.emit(
                    kind="submit",
                    endpoint=label,
                    request_id=None if result is None else result.request_id,
                    outcome="error" if result is None else result.outcome.value,
                    latency_s=latency,
                    stages=stages or {},
                )

    def _submit_one(
        self,
        request_json: str,
        endpoint: str,
        explain: bool,
        stages: Optional[Dict[str, float]] = None,
    ) -> SubmitResult:
        self.stats.received += 1
        serial = self.stats.received
        t0 = time.perf_counter()
        request, err = self._parse(request_json, endpoint)
        if stages is not None:
            stages["parse_s"] = time.perf_counter() - t0
        if err:
            return SubmitResult(None, err, ValidationOutcome.REJECTED_GUARD)
        t0 = time.perf_counter()
        with _span("serve.validate", endpoint=endpoint):
            verdict = self.registry.validate_one(
                endpoint, request, key=("submit", serial), explain=explain
            )
        dt = time.perf_counter() - t0
        if stages is not None:
            stages["validate_s"] = dt
        self.stats.validation_seconds += dt
        if verdict.outcome in (
            ValidationOutcome.ADMITTED,
            ValidationOutcome.INVALID,
        ):
            self.stats.fallback_validated += 1  # the sequential oracle ran
        return self._finish(endpoint, request, verdict)

    def _finish(self, endpoint: str, request: Any, verdict) -> SubmitResult:
        """One verdict -> one terminal :class:`SubmitResult`: outcome
        accounting, enqueue on admit, canonical error string on reject.
        Shared by ``submit``, ``submit_batch``, and the streaming
        scheduler so all three produce identical results for identical
        verdicts."""
        self.stats.record_outcome(verdict.outcome)
        if verdict.admitted:
            return SubmitResult(
                self._enqueue(request, endpoint), "", verdict.outcome
            )
        self.stats.rejected += 1
        self.stats.count(endpoint, "rejected")
        if verdict.outcome is ValidationOutcome.INVALID:
            err = verdict.reason if verdict.site is not None else (
                "schema validation failed"
            )
        else:
            err = f"{verdict.outcome.value}: {verdict.reason}"
        return SubmitResult(None, err, verdict.outcome)

    def submit_batch(
        self,
        requests: Sequence[Tuple[str, str]],
        *,
        explain: bool = False,
    ) -> List[SubmitResult]:
        """Admit a mixed-endpoint burst of (endpoint, request_json) pairs.

        All parseable requests are validated in one batched launch per
        link group (DESIGN.md §14); only undecided rows and endpoints
        outside the structural subset take the (bounded) sequential
        fallback.  Per-document faults are isolated: a poison row gets an
        ERROR_ISOLATED result while every other row's verdict is
        bit-identical to a fault-free batch.  Returns a
        :class:`SubmitResult` per input, in order.

        ``explain=True`` opts into batched first-failure attribution
        (one extra explain launch over the already-encoded table);
        INVALID results carry the attributed site in their error string.
        Latency accounting: exactly one ``serve_request_seconds``
        observation per received request -- the burst's validation wall
        time amortized evenly over its validated rows, and the *true*
        admission->verdict wall (batch entry to the parse/guard reject)
        for rows rejected before validation, so SLO burn rates never
        under-count rejected traffic.
        """
        batch_id = self._batch_seq
        self._batch_seq += 1
        t_batch = time.perf_counter()
        with _span("serve.submit_batch", batch=len(requests)):
            out: List[Optional[SubmitResult]] = [None] * len(requests)
            parsed: List[Tuple[int, str, Any, int]] = []
            guard_rejected: List[Tuple[int, str, float]] = []
            with _phase("serve.parse"):
                for i, (endpoint, request_json) in enumerate(requests):
                    self.stats.received += 1
                    serial = self.stats.received
                    request, err = self._parse(request_json, endpoint)
                    if err:
                        out[i] = SubmitResult(
                            None, err, ValidationOutcome.REJECTED_GUARD
                        )
                        guard_rejected.append(
                            (
                                i,
                                endpoint
                                if endpoint in self.registry
                                else "__unknown__",
                                time.perf_counter() - t_batch,
                            )
                        )
                    else:
                        parsed.append((i, endpoint, request, serial))
            if parsed:
                docs = [r for _, _, r, _ in parsed]
                endpoints = [e for _, e, _, _ in parsed]
                keys = [("batch", s) for _, _, _, s in parsed]
                t0 = time.perf_counter()
                with _phase("serve.validate"), _span(
                    "serve.validate", batch=len(parsed)
                ):
                    verdicts, counts = self.registry.admit_mixed_ex(
                        docs,
                        endpoints,
                        max_nodes=self.scfg.admission_max_nodes,
                        keys=keys,
                        explain=explain,
                    )
                dt = time.perf_counter() - t0
                self.stats.batch_validated += counts.batch_validated
                self.stats.fallback_validated += counts.fallback_validated
                self.stats.undecided += counts.undecided
                self.stats.oversize += counts.oversize
                self.stats.unroll_overflow += counts.unroll_overflow
                self.stats.validation_seconds += dt
                # amortized latency: dt/n per validated row, grouped per
                # endpoint so each histogram takes one observe_many call
                per_row = dt / len(parsed)
                ep_rows: Dict[str, int] = {}
                for _, endpoint, _, _ in parsed:
                    ep_rows[endpoint] = ep_rows.get(endpoint, 0) + 1
                for endpoint, n in ep_rows.items():
                    self._latency(endpoint).observe_many(per_row, n)
                ev = self.events
                with _phase("serve.dispatch"):
                    for (i, endpoint, request, serial), verdict in zip(
                        parsed, verdicts
                    ):
                        out[i] = self._finish(endpoint, request, verdict)
                        if ev is not None and ev.want():
                            ev.emit(
                                kind="batch",
                                batch_id=batch_id,
                                endpoint=endpoint,
                                request_id=out[i].request_id,
                                outcome=verdict.outcome.value,
                                latency_s=per_row,
                                stages={
                                    "validate_s": dt,
                                    "batch_rows": len(parsed),
                                },
                            )
            ev = self.events
            for i, label, lat in guard_rejected:
                # true wall from batch entry to the parse/guard verdict
                # (was a flat 0.0 observation before §14)
                self._latency(label).observe(lat)
                if ev is not None and ev.want():
                    ev.emit(
                        kind="batch",
                        batch_id=batch_id,
                        endpoint=label,
                        request_id=None,
                        outcome=ValidationOutcome.REJECTED_GUARD.value,
                        latency_s=lat,
                        stages={},
                    )
            return out  # type: ignore[return-value]

    def _parse(self, request_json: str, endpoint: str):
        """Pre-validation gate: endpoint membership, payload byte guard,
        JSON decode.  Every reject here is a REJECTED_GUARD outcome; any
        decodable JSON value (including non-object top-levels like
        ``"5"`` or ``"[]"``) flows through to the normal validator
        verdict and never raises."""
        # endpoint membership first: by_endpoint buckets exist only for
        # registered endpoints (unknown names are client-controlled and
        # must not grow the stats dict without bound)
        if endpoint not in self.registry:
            self.stats.rejected += 1
            self.stats.record_outcome(ValidationOutcome.REJECTED_GUARD)
            return None, f"unknown endpoint {endpoint!r}"
        limit = self.registry.guard.max_bytes
        if len(request_json) > limit:
            self.stats.rejected += 1
            self.stats.count(endpoint, "rejected")
            self.stats.record_outcome(ValidationOutcome.REJECTED_GUARD)
            return None, f"payload {len(request_json)} bytes > guard cap {limit}"
        try:
            with _span("serve.parse", bytes=len(request_json)):
                request = json.loads(request_json)
        except json.JSONDecodeError as exc:
            self.stats.rejected += 1
            self.stats.count(endpoint, "rejected")
            self.stats.record_outcome(ValidationOutcome.REJECTED_GUARD)
            return None, f"malformed JSON: {exc}"
        except RecursionError:
            # hostile nesting can exhaust json.loads's recursive decoder
            # before any schema ever sees the document
            self.stats.rejected += 1
            self.stats.count(endpoint, "rejected")
            self.stats.record_outcome(ValidationOutcome.REJECTED_GUARD)
            return None, "malformed JSON: nesting exceeds the decode limit"
        return request, ""

    def _enqueue(self, request: Any, endpoint: str) -> int:
        rid = self._next_id
        self._next_id += 1
        self.stats.admitted += 1
        self.stats.count(endpoint, "admitted")
        prompt = _extract_prompt(request)
        if prompt is None:
            # validation-only request (no decodable text field): ack
            # immediately, and count it so silently-dropped decodes are
            # observable rather than indistinguishable from completions
            self.results[rid] = ""
            self.stats.completed += 1
            self.stats.validated_only += 1
            return rid
        # endpoint schemas are tenant-supplied: an open schema may admit a
        # non-integer or absurd max_tokens, which must not poison the
        # shared decode loop -- sanitize and clamp to the slot budget
        max_tokens = request.get("max_tokens", self.scfg.default_max_tokens)
        if isinstance(max_tokens, bool) or not isinstance(max_tokens, int):
            max_tokens = self.scfg.default_max_tokens
        max_tokens = max(1, min(max_tokens, self.scfg.max_len))
        slot = _Slot(
            request_id=rid,
            tokens=tokenizer.encode(prompt, eos=False),
            max_tokens=max_tokens,
        )
        self.queue.append(slot)
        return rid

    # -- execution ------------------------------------------------------------

    def _admit_to_slots(self) -> None:
        for i, s in enumerate(self.slots):
            if s is None and self.queue:
                slot = self.queue.pop(0)
                logits, cache = self.model.prefill(
                    self.params,
                    torch.as_tensor([slot.tokens], dtype=torch.int32, device=self.device),
                    max_len=self.scfg.max_len,
                )
                slot.length = len(slot.tokens)
                next_tok = int(torch.argmax(logits[0, -1]))
                slot.generated.append(next_tok)
                if self._cache is None:
                    self._cache = self.model.init_cache(
                        self.scfg.batch_slots, self.scfg.max_len, device=self.device
                    )
                self._cache = _write_slot_cache(self._cache, cache, i)
                self.slots[i] = slot

    def step(self) -> int:
        """One engine tick: admit, decode one token for all active slots."""
        self._admit_to_slots()
        active = [(i, s) for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        max_len_now = max(s.length + len(s.generated) for _, s in active)
        tokens = np.full((self.scfg.batch_slots, 1), tokenizer.PAD, np.int32)
        for i, s in active:
            tokens[i, 0] = s.generated[-1] if s.generated else s.tokens[-1]
        logits, self._cache = self._decode(
            self.params, torch.as_tensor(tokens, device=self.device), self._cache,
            max_len_now,
        )
        self.stats.decode_steps += 1
        for i, s in active:
            nxt = int(torch.argmax(logits[i, 0]))
            s.generated.append(nxt)
            if nxt == tokenizer.EOS or len(s.generated) >= s.max_tokens:
                s.done = True
                self.results[s.request_id] = tokenizer.decode(s.generated)
                self.stats.completed += 1
                self.slots[i] = None
        return len(active)

    def run_until_drained(self, max_steps: int = 10_000) -> Dict[int, str]:
        steps = 0
        while (any(self.slots) or self.queue) and steps < max_steps:
            self.step()
            steps += 1
        return dict(self.results)

    # -- streaming runtime (serve/scheduler.py, DESIGN.md §14) ----------------

    def scheduler(self, scheduler_cfg=None, **kw) -> "StreamScheduler":
        """A streaming micro-batcher over this engine.

        Requests :meth:`~repro.serve.scheduler.StreamScheduler.offer`-ed
        to the scheduler queue per link group and drain through the same
        admission/verdict path as :meth:`submit_batch` (identical
        :class:`SubmitResult` per request), with queue delay included in
        ``serve_request_seconds``.  Keyword arguments build a
        :class:`~repro.serve.scheduler.SchedulerConfig`.
        """
        from .scheduler import SchedulerConfig, StreamScheduler

        cfg = scheduler_cfg if scheduler_cfg is not None else SchedulerConfig(**kw)
        return StreamScheduler(self, cfg)


def _extract_prompt(request: Any) -> Optional[str]:
    """Decode text for a request: prompt / input / chat messages."""
    if isinstance(request, dict):
        for key in ("prompt", "input"):
            value = request.get(key)
            if isinstance(value, str):
                return value
        messages = request.get("messages")
        if isinstance(messages, list):
            parts = [
                m["content"]
                for m in messages
                if isinstance(m, dict) and isinstance(m.get("content"), str)
            ]
            if parts:
                return "\n".join(parts)
    return None


def _write_slot_cache(batch_cache, slot_cache, slot_idx: int):
    """Copy a prefilled single-request cache into batch slot ``slot_idx``
    (in place)."""
    for name, dst in batch_cache.items():
        src = slot_cache[name]
        if isinstance(dst, dict):
            _write_slot_cache(dst, src, slot_idx)
        elif dst.ndim >= 2 and src.shape[0] == dst.shape[0]:  # (periods, B, ...)
            if src.shape[1] == 1 and dst.shape[1] > 1:
                dst[:, slot_idx] = src[:, 0].to(dst.dtype)
    return batch_cache
