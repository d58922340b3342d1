"""Schema registry: compile-once, multi-tenant validation state.

The paper's deployment premise is that schemas change rarely while
traffic is huge, so compilation cost amortizes to zero (PAPER.md §1).  A
gateway hosts *many* endpoint schemas and versions; the registry owns
that estate:

- :meth:`SchemaRegistry.register` compiles a schema for an endpoint id,
  caching the ``(CompiledSchema, Validator, LocationTape)`` triple plus
  compile-time stats (:class:`SchemaStats`).  Repeated registration on
  one endpoint creates monotonically increasing *versions*; the latest
  version serves.
- the **linked tape** over all batchable active versions is built by
  ``registry/linker.py``, eagerly at registration/eviction time so the
  serving path never re-links, and *incrementally*: per-version
  :class:`~repro.registry.linker.TapeSegment` preparations are cached,
  so a hot-swap re-links N members as pure concatenation with N-1
  segments coming from cache.  The linked state is keyed by the tuple
  of batchable (endpoint, serving-version) members: no-op changes
  (re-registering an identical schema, evicting a non-serving version,
  touching sequential-only endpoints) keep the jitted serving validator
  alive.
- :meth:`validate_mixed` validates a heterogeneous batch (per-document
  endpoint ids) in **one** batched-executor launch over the linked
  tape; documents of unbatchable endpoints (or undecided rows) are
  reported ``decided=False`` for the caller to route to that endpoint's
  sequential validator (per-schema modern-spec semantics stay pinned to
  the sequential oracle).
"""

from __future__ import annotations

import copy
import os
import time
import warnings
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..analysis.normalize import AnalysisReport, analyze_schema
from ..analysis.subsume import compare as subsume_compare
from ..analysis.unroll import recommend_unroll_depth

from ..core import CompiledSchema, NaiveValidator, Validator, compile_schema
from ..core.batch_executor import BatchValidator, resolve_device
from ..core.outcomes import (
    BreakerConfig,
    CircuitBreaker,
    DocumentDepthError,
    GuardLimits,
    ValidationBudget,
    ValidationOutcome,
    ValidationTimeout,
    Verdict,
    fault_point,
    resource_guard,
)
from ..core.explain import FailureSite, keyword_of
from ..core.tape import DEFAULT_UNROLL_DEPTH, LocationTape, try_build_tape
from ..obs.metrics import MetricRegistry
from ..obs.profile import phase as _phase
from ..obs.trace import span as _span
from .linker import (
    LinkedTape,
    TapeSegment,
    group_signature,
    link_tapes,
    segment_tape,
    signature_label,
)

__all__ = [
    "SchemaStats",
    "SchemaEntry",
    "SchemaRegistry",
    "AdmitCounts",
    "LinkGroup",
    "RegistrationError",
    "WidenedSwapWarning",
]


class RegistrationError(RuntimeError):
    """A registration failed build/verify/link; the prior version serves."""


class WidenedSwapWarning(UserWarning):
    """A hot-swap candidate was *proven* to accept strictly more
    instances than the serving version (DESIGN.md §15): traffic the old
    schema rejected will start passing.  The swap proceeds -- widening
    is often intentional -- but the posture is surfaced here, in
    ``registry_swap_widened_total`` and in ``endpoint_stats()``."""


@dataclass
class AdmitCounts:
    """How a mixed stream's verdicts were produced (admit_mixed)."""

    batch_validated: int = 0  # decided by a linked-tape (group) launch
    undecided: int = 0  # batchable but past the depth budget -> fallback
    oversize: int = 0  # batchable but past the encoder node budget -> fallback
    unroll_overflow: int = 0  # recursion outran the $ref-unroll budget -> fallback
    fallback_validated: int = 0  # sequential verdicts (incl. all of the above)
    # fault-containment dispositions (DESIGN.md §11)
    rejected_guard: int = 0  # admission resource guard said no (pre-encode)
    error_isolated: int = 0  # per-document encode/launch/fallback error trapped
    timed_out: int = 0  # bounded fallback ran out of budget/deadline
    breaker_open: int = 0  # fallback suspended: endpoint degraded (guard-only)
    # per-link-group attribution (DESIGN.md §14): the same launch-path
    # counters above, keyed by the group whose launch produced them, so
    # a group-routed fallback is not misattributed to "the" linked tape
    per_group: Dict[str, Dict[str, int]] = field(default_factory=dict)

    _GROUP_KEYS = (
        "batch_validated",
        "undecided",
        "oversize",
        "unroll_overflow",
        "error_isolated",
    )

    def group(self, label: str) -> Dict[str, int]:
        g = self.per_group.get(label)
        if g is None:
            g = self.per_group[label] = {k: 0 for k in self._GROUP_KEYS}
        return g


@dataclass(frozen=True)
class LinkGroup:
    """One Â/M̂/horizon-compatible partition of the batchable members.

    Each group owns its own :class:`LinkedTape` and jitted
    :class:`BatchValidator`; the member-max window inflation (§8) is
    confined to members sharing the group's signature class instead of
    taxing the whole estate.
    """

    label: str  # e.g. "a4.m4.h4" -- stable, metrics-safe
    key: Tuple[int, int, int]  # pow2 classes of (Â, M̂, horizon)
    members: Tuple[str, ...]  # endpoints, registration order
    signature: Tuple[Tuple[str, int], ...]  # (endpoint, version) identity
    tape: LinkedTape
    validator: BatchValidator
    member_index: Dict[str, int]  # endpoint -> group-local schema id
    # endpoints whose segments are physically present in the linked tape.
    # With ``dedup_links`` structurally identical members (equal canonical
    # hash) share one representative segment, so this can be shorter than
    # ``members``; ``member_index`` maps every endpoint to its (possibly
    # shared) schema id.
    linked_members: Tuple[str, ...] = ()


@dataclass
class SchemaStats:
    """Compile-time facts recorded at registration (the amortized cost)."""

    compile_seconds: float
    tape_seconds: float
    instruction_count: int
    batchable: bool
    fallback_reason: str = ""
    n_locations: int = 0
    n_props: int = 0
    n_assertions: int = 0
    a_hat: int = 0
    k: int = 0
    horizon: int = 0
    # $ref-unroll facts: the depth budget the tape was built with and
    # how many frontier locations it carries (0 = fully flat schema)
    unroll_depth: int = 0
    n_frontier: int = 0
    # logical-applicator circuit facts (DESIGN.md §10)
    n_circuits: int = 0
    circ_depth: int = 0
    # ahead-of-time schema-algebra facts (DESIGN.md §15): what the
    # register()-time analysis pipeline proved and rewrote
    analysis_seconds: float = 0.0
    normalized: bool = False  # analysis changed the lowered schema
    pruned_branches: int = 0  # proven-unsat branches removed pre-tape
    folded_assertions: int = 0  # constants folded / bounds tightened / noops
    dedup_subgraphs: int = 0  # subgraphs shared with other serving members
    analysis_failure: str = ""  # analyzer bailed (original schema lowered)
    subsumption: str = ""  # last swap verdict vs prior serving version


@dataclass
class SchemaEntry:
    """One registered (endpoint, version) with its compiled artifacts."""

    endpoint: str
    version: int
    schema: Any
    compiled: CompiledSchema
    validator: Validator  # sequential oracle (modern-spec semantics)
    tape: Optional[LocationTape]  # None outside the structural subset
    stats: SchemaStats
    # schema-algebra artifacts (DESIGN.md §15).  ``schema`` above keeps
    # the schema exactly as submitted (the verbatim no-op check and the
    # sequential oracle pin to it); ``canonical`` is the normalized form
    # the tape was actually lowered from.
    canonical: Any = None
    canonical_hash: str = ""
    analysis: Optional[AnalysisReport] = None


class SchemaRegistry:
    """Register/version/evict compiled schemas; link them for batching."""

    def __init__(
        self,
        *,
        engine: str = "codegen",
        device=None,
        layout: str = "csr",
        max_depth: int = 16,
        unroll_depth: Optional[int] = None,
        guard: GuardLimits = GuardLimits(),
        breaker: BreakerConfig = BreakerConfig(),
        fallback_max_steps: int = 500_000,
        fallback_deadline_s: Optional[float] = 0.25,
        clock: Callable[[], float] = time.monotonic,
        metrics: Optional[MetricRegistry] = None,
        link_grouping: bool = True,
        analysis: bool = True,
        dedup_links: bool = True,
    ):
        self.engine = engine
        # the batched executors' device: cuda unless told otherwise
        self.device = resolve_device(device)
        self.layout = layout
        self.max_depth = max_depth
        # $ref-unroll sizing (DESIGN.md §15): None = auto -- honor the
        # REPRO_UNROLL_DEPTH env override, else size per schema from the
        # analyzer's recursion-cycle bound; an explicit int pins every
        # registration to that depth (legacy behavior).
        self.unroll_depth = unroll_depth
        # ahead-of-time schema algebra (DESIGN.md §15): normalize/prune
        # before lowering, prove swap subsumption, dedup linked segments
        self.analysis = analysis
        self.dedup_links = dedup_links
        # fault-containment knobs (DESIGN.md §11): admission guards,
        # bounded-fallback budget, and per-endpoint breaker config.  The
        # clock is injectable so breaker trips/recoveries test
        # deterministically.
        self.guard = guard
        self.breaker_cfg = breaker
        self.fallback_max_steps = fallback_max_steps
        self.fallback_deadline_s = fallback_deadline_s
        self.clock = clock
        # control-plane + executor telemetry (DESIGN.md §12): one registry
        # shared with the serving layers; callers may pass theirs in
        self.metrics = metrics if metrics is not None else MetricRegistry()
        self._m_register_seconds = self.metrics.counter(
            "registry_register_seconds_total",
            "wall seconds inside register() (compile + tape + verify + link)",
        )
        self._m_relink_seconds = self.metrics.counter(
            "registry_relink_seconds_total",
            "wall seconds re-cutting the linked tape (control plane)",
        )
        self._m_relinks = self.metrics.counter(
            "registry_relinks_total", "linked-tape re-cuts (membership changes)"
        )
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._swap_failures: Dict[str, str] = {}
        # endpoint -> subsumption verdict of its most recent hot-swap
        # (equivalent / widened / narrowed / incomparable / unknown)
        self._swap_verdicts: Dict[str, str] = {}
        self._entries: Dict[str, Dict[int, SchemaEntry]] = {}
        self._active: Dict[str, int] = {}  # endpoint -> serving version
        self._order: List[str] = []  # registration order = member order
        # version numbers are monotonic per endpoint FOREVER (they survive
        # full eviction): the linked-state signature relies on
        # (endpoint, version) pairs never being reused
        self._next_version: Dict[str, int] = {}
        self._segments: Dict[Tuple[str, int], TapeSegment] = {}
        self._generation = 0
        # lazily (re)built linked state, keyed by the tuple of batchable
        # (endpoint, serving-version) members so no-op generation bumps
        # (evicting a non-serving version, registering a sequential-only
        # schema) never discard the jitted serving validator
        self._linked_generation = -1
        self._linked_signature: Optional[Tuple[Tuple[str, int], ...]] = None
        self._linked: Optional[LinkedTape] = None
        self._linked_validator: Optional[BatchValidator] = None
        self._member_index: Dict[str, int] = {}
        # link groups (DESIGN.md §14): the serving partition.  Eagerly
        # re-cut at registration/eviction (the serving path never links);
        # cached per (endpoint, version) membership tuple so no-op
        # generation bumps keep every group's jitted validator alive.
        # ``link_grouping=False`` pins the legacy single-group layout
        # (one global tape) -- the differential-identity reference.
        self.link_grouping = link_grouping
        self._groups: List[LinkGroup] = []
        self._group_cache: Dict[Tuple[Tuple[str, int], ...], LinkGroup] = {}
        self._member_group: Dict[str, int] = {}
        self._groups_generation = -1
        # cumulative per-group launch-fallback causes (mirrors the
        # registry_group_fallbacks_total counter family)
        self._group_fallbacks: Dict[str, Dict[str, int]] = {}

    # -- registration ---------------------------------------------------------

    def register(
        self, endpoint: str, schema: Any, *, verify: str = "fast"
    ) -> SchemaEntry:
        """Compile + cache ``schema`` as the next version of ``endpoint``.

        All control-plane cost lands here, at registration time: schema
        compilation AND the linked-tape re-cut (pure numpy concatenation
        over cached per-version segments).  The serving path never
        re-links; the only residual first-call cost there is the jit
        trace per new batch shape, which any executor (single-tape
        included) pays.  Re-registering the currently-serving schema
        verbatim is a no-op returning the existing entry (no version
        bump, no re-link, no jit discard).

        Hot-swap safety: the new version is built, smoke-verified
        (``verify="fast"``: differential spot-check of the compiled
        validator against the naive interpreter on a synthetic probe
        corpus), and trial-segmented *before* any registry state
        mutates.  Any failure raises :class:`RegistrationError`, records
        the reason (:meth:`swap_failures`), and leaves the prior version
        serving -- a bad schema version never reaches traffic.
        ``verify="off"`` skips the differential probes.

        With ``analysis=True`` (default) the schema-algebra pipeline
        (DESIGN.md §15) runs first: the schema is normalized and proven-
        unsat branches are pruned before lowering, and the candidate is
        compared against the serving version.  A swap *proven*
        equivalent is a metadata-only no-op -- the serving entry, its
        linked segments and every jitted validator stay untouched
        (generation does not move); a swap proven to widen the accepted
        set proceeds but emits :class:`WidenedSwapWarning` and bumps
        ``registry_swap_widened_total``.
        """
        if endpoint in self._active:
            current = self.get(endpoint)
            if current.schema == schema:
                return current
        # snapshot: entries own their schema by value, so callers mutating
        # the dict they registered cannot corrupt (or no-op-skip) later
        # registrations against the served version
        schema = copy.deepcopy(schema)
        t_reg = time.perf_counter()
        # -- ahead-of-time schema algebra (DESIGN.md §15) ---------------------
        report: Optional[AnalysisReport] = None
        lowered = schema
        if self.analysis:
            with _phase("analyze"):
                report = analyze_schema(schema, verify=(verify != "off"))
            lowered = report.normalized
        # -- subsumption proof vs the serving version -------------------------
        verdict = ""
        if report is not None and endpoint in self._active:
            prev = self.get(endpoint)
            result = subsume_compare(
                prev.canonical if prev.canonical is not None else prev.schema,
                lowered,
                old_hash=prev.canonical_hash or None,
                new_hash=report.canonical_hash or None,
            )
            verdict = result.verdict
            self._swap_verdicts[endpoint] = verdict
            if verdict == "equivalent":
                # metadata-only no-op: the candidate is proven to accept
                # exactly the serving version's instance set, so the
                # serving entry, its cached segments, every link group
                # and every jit trace stay alive.  No version bump, no
                # generation move, no relink.
                prev.stats.subsumption = verdict
                self.metrics.counter(
                    "registry_swap_total",
                    "registration swaps by result",
                    result="equivalent_noop",
                ).inc()
                self._m_register_seconds.inc(time.perf_counter() - t_reg)
                return prev
            if verdict == "widened":
                self.metrics.counter(
                    "registry_swap_widened_total",
                    "hot-swaps proven to accept strictly more instances",
                    endpoint=endpoint,
                ).inc()
                warnings.warn(
                    f"endpoint {endpoint!r}: replacement schema is proven "
                    f"to accept strictly more instances than serving "
                    f"version {prev.version} (witness: "
                    f"{result.witnesses[:1]!r}); swap proceeds",
                    WidenedSwapWarning,
                    stacklevel=2,
                )
        # -- build (no state mutated on failure) ------------------------------
        try:
            t0 = time.perf_counter()
            compiled = compile_schema(lowered)
            validator = Validator(compiled, engine=self.engine)
            t_compile = time.perf_counter() - t0
            t0 = time.perf_counter()
            unroll = self._resolve_unroll_depth(compiled)
            tape, reason = try_build_tape(compiled, unroll_depth=unroll)
            t_tape = time.perf_counter() - t0
        except Exception as exc:
            raise self._swap_failed(endpoint, f"build: {type(exc).__name__}: {exc}")
        # -- smoke-verify before swap (Type Safety w/ JSON Subschema spirit) --
        if verify != "off":
            mismatch = self._smoke_verify(schema, validator)
            if mismatch:
                raise self._swap_failed(endpoint, f"verify: {mismatch}")
        # -- trial link: segment the tape before committing membership --------
        segment: Optional[TapeSegment] = None
        if tape is not None:
            try:
                fault_point("link", endpoint)
                segment = segment_tape(tape)
            except Exception as exc:
                raise self._swap_failed(endpoint, f"link: {type(exc).__name__}: {exc}")
        # -- commit: atomically swap the serving version ----------------------
        stats = SchemaStats(
            compile_seconds=t_compile,
            tape_seconds=t_tape,
            instruction_count=compiled.instruction_count(),
            batchable=tape is not None,
            fallback_reason=reason,
        )
        if tape is not None:
            stats.n_locations = tape.n_locations
            stats.n_props = tape.n_props
            stats.n_assertions = tape.n_assertions
            stats.a_hat = tape.max_rows_per_loc
            stats.k = tape.max_hash_run
            stats.horizon = tape.max_loc_depth + 1
            stats.unroll_depth = tape.unroll_depth
            stats.n_frontier = tape.n_frontier
            stats.n_circuits = tape.n_circuits
            stats.circ_depth = tape.max_circ_depth
        if report is not None:
            stats.analysis_seconds = report.seconds
            stats.normalized = report.changed
            stats.pruned_branches = report.pruned_branches
            stats.folded_assertions = (
                report.folded_assertions
                + report.tightened_bounds
                + report.removed_noops
            )
            stats.analysis_failure = report.failure or ""
            # structural dedup posture: how many of this schema's
            # canonical subgraphs already occur in another serving member
            if report.subgraph_hashes:
                mine = set(report.subgraph_hashes)
                others: set = set()
                for ep in self._order:
                    if ep == endpoint:
                        continue
                    other = self.get(ep)
                    if other.analysis is not None:
                        others.update(other.analysis.subgraph_hashes)
                report.dedup_subgraphs = len(mine & others)
                stats.dedup_subgraphs = report.dedup_subgraphs
        stats.subsumption = verdict
        versions = self._entries.setdefault(endpoint, {})
        version = self._next_version.get(endpoint, 0) + 1
        self._next_version[endpoint] = version
        entry = SchemaEntry(
            endpoint=endpoint,
            version=version,
            schema=schema,
            compiled=compiled,
            validator=validator,
            tape=tape,
            stats=stats,
            canonical=lowered,
            canonical_hash=report.canonical_hash if report is not None else "",
            analysis=report,
        )
        versions[version] = entry
        self._active[endpoint] = version
        if endpoint not in self._order:
            self._order.append(endpoint)
        if segment is not None:
            self._segments[(endpoint, version)] = segment
        self._swap_failures.pop(endpoint, None)
        self._generation += 1
        self._relink_groups()  # eager: keep re-link cost off the serving path
        self._m_register_seconds.inc(time.perf_counter() - t_reg)
        self.metrics.counter(
            "registry_swap_total", "registration swaps by result", result="ok"
        ).inc()
        return entry

    def _swap_failed(self, endpoint: str, reason: str) -> RegistrationError:
        self.metrics.counter(
            "registry_swap_total", "registration swaps by result", result="failed"
        ).inc()
        self._swap_failures[endpoint] = reason
        serving = ""
        if endpoint in self._active:
            serving = f"; version {self._active[endpoint]} keeps serving"
        return RegistrationError(f"endpoint {endpoint!r}: {reason}{serving}")

    def swap_failures(self) -> Dict[str, str]:
        """endpoint -> reason of its most recent *failed* registration
        (cleared by the next successful swap)."""
        return dict(self._swap_failures)

    def swap_verdicts(self) -> Dict[str, str]:
        """endpoint -> subsumption verdict of the most recent hot-swap
        attempt against its then-serving version (``equivalent`` /
        ``widened`` / ``narrowed`` / ``incomparable`` / ``unknown``).
        First registrations have no verdict."""
        return dict(self._swap_verdicts)

    def _resolve_unroll_depth(self, compiled: CompiledSchema) -> int:
        """Per-schema $ref-unroll budget (DESIGN.md §15).

        Explicit constructor ``unroll_depth`` pins every registration;
        otherwise the ``REPRO_UNROLL_DEPTH`` env var wins, and failing
        that the analyzer sizes the depth from the schema's recursion
        cycle shape under the unroll node budget.
        """
        if self.unroll_depth is not None:
            return self.unroll_depth
        env = os.environ.get("REPRO_UNROLL_DEPTH", "")
        if env:
            try:
                return max(1, int(env))
            except ValueError:
                pass
        return recommend_unroll_depth(compiled)

    @staticmethod
    def _synth_probes(schema: Any) -> List[Any]:
        """Small synthetic corpus for differential smoke-verification."""
        probes: List[Any] = [None, True, 0, 1.5, "x", [], {}]
        if isinstance(schema, dict):
            doc: Dict[str, Any] = {}
            props = schema.get("properties")
            props = props if isinstance(props, dict) else {}
            required = schema.get("required")
            required = required if isinstance(required, list) else []
            by_type = {
                "string": "x",
                "number": 1,
                "integer": 1,
                "boolean": True,
                "array": [],
                "object": {},
                "null": None,
            }
            for name in list(props)[:8] + [k for k in required if isinstance(k, str)]:
                sub = props.get(name)
                t = sub.get("type") if isinstance(sub, dict) else None
                if isinstance(t, list) and t:
                    t = t[0]
                doc[name] = by_type.get(t, "x")
            probes.append(doc)
            probes.append({**doc, "unknown_member_xx": 1})
        return probes

    def _smoke_verify(self, schema: Any, validator: Validator) -> str:
        """Differential spot-check vs the naive interpreter; '' = agree.

        A probe that raises in *both* engines is skipped (outside the
        supported envelope either way); raising in exactly one, or a
        verdict mismatch, fails the swap.
        """
        try:
            naive = NaiveValidator(schema)
        except Exception:
            return ""  # naive oracle unavailable: nothing to differ against
        for probe in self._synth_probes(schema):
            got = want = None
            got_exc = want_exc = None
            try:
                got = validator.is_valid(probe)
            except Exception as exc:
                got_exc = exc
            try:
                want = naive.is_valid(probe)
            except Exception as exc:
                want_exc = exc
            if got_exc is not None and want_exc is not None:
                continue
            if got_exc is not None or want_exc is not None:
                exc = got_exc if got_exc is not None else want_exc
                which = "compiled" if got_exc is not None else "naive"
                return (
                    f"probe {probe!r}: {which} engine raised "
                    f"{type(exc).__name__}: {exc}"
                )
            if bool(got) != bool(want):
                return f"probe {probe!r}: compiled={got} naive={want}"
        return ""

    def get(self, endpoint: str, version: Optional[int] = None) -> SchemaEntry:
        """The serving (or a pinned historical) entry for ``endpoint``."""
        if endpoint not in self._active:
            raise KeyError(f"endpoint {endpoint!r} not registered")
        v = self._active[endpoint] if version is None else version
        try:
            return self._entries[endpoint][v]
        except KeyError:
            raise KeyError(f"endpoint {endpoint!r} has no version {v}") from None

    def evict(self, endpoint: str, version: Optional[int] = None) -> None:
        """Drop one version (or the whole endpoint when ``version=None``).

        Evicting the serving version rolls the endpoint back to its
        newest remaining version.
        """
        if endpoint not in self._entries:
            raise KeyError(f"endpoint {endpoint!r} not registered")
        versions = self._entries[endpoint]
        doomed = list(versions) if version is None else [version]
        for v in doomed:
            if v not in versions:
                raise KeyError(f"endpoint {endpoint!r} has no version {v}")
            del versions[v]
            self._segments.pop((endpoint, v), None)
        if versions:
            if self._active[endpoint] not in versions:
                self._active[endpoint] = max(versions)
        else:
            del self._entries[endpoint]
            del self._active[endpoint]
            self._order.remove(endpoint)
        self._generation += 1
        self._relink_groups()  # eager, and a no-op unless membership changed

    def endpoints(self) -> List[str]:
        return list(self._order)

    def __contains__(self, endpoint: str) -> bool:
        """O(1) membership test (request-critical path friendly)."""
        return endpoint in self._active

    def versions(self, endpoint: str) -> List[int]:
        return sorted(self._entries.get(endpoint, ()))

    def fallback_reasons(self) -> Dict[str, str]:
        """endpoint -> ``try_build_tape`` failure reason, for every
        serving entry outside the structural subset.

        This is the *real* per-endpoint reason string (e.g. ``"instruction
        LOOP_KEYS not batchable"``), previously recorded in
        :class:`SchemaStats` but dropped on the serving/stats path --
        ``ServeEngine`` and ``AdmissionController`` surface it.

        Compile-time reasons are endpoint-scoped by construction.
        *Runtime* launch fallbacks (oversize / unroll_overflow /
        undecided) are attributed to the link group whose launch
        produced them -- see :meth:`group_fallbacks` and
        ``AdmitCounts.per_group`` -- not to a single global tape.
        """
        return {
            endpoint: self.get(endpoint).stats.fallback_reason
            for endpoint in self._order
            if not self.get(endpoint).stats.batchable
        }

    @property
    def generation(self) -> int:
        return self._generation

    # -- link groups (DESIGN.md §14) ------------------------------------------

    def _ensure_groups(self) -> None:
        if self._groups_generation != self._generation:
            self._relink_groups()

    def _relink_groups(self) -> None:
        """Partition batchable serving members into link groups and
        (re)cut one linked tape per group.

        The partition keys on :func:`~repro.registry.linker
        .group_signature` -- power-of-two classes of (Â, M̂, horizon) --
        an equivalence relation, so the result is deterministic and
        independent of registration order.  Group state is cached by the
        group's (endpoint, serving-version) tuple: membership-preserving
        generation bumps keep every untouched group's jitted validator
        alive, and a hot-swap re-links only the swapped member's group.
        """
        grouped: Dict[Tuple, List[str]] = {}
        for endpoint in self._order:
            entry = self.get(endpoint)
            if entry.tape is None:
                continue
            key = (endpoint, entry.version)
            if key not in self._segments:
                self._segments[key] = segment_tape(entry.tape)
            gk = group_signature(entry.tape) if self.link_grouping else ("all",)
            grouped.setdefault(gk, []).append(endpoint)
        new_groups: List[LinkGroup] = []
        new_cache: Dict[Tuple[Tuple[str, int], ...], LinkGroup] = {}
        for gk, members in grouped.items():
            label = signature_label(gk) if self.link_grouping else "all"
            signature = tuple((m, self._active[m]) for m in members)
            g = self._group_cache.get(signature)
            if g is None:
                # structural dedup (DESIGN.md §15): a member whose
                # canonical hash matches an earlier member in the group
                # shares that member's linked segment instead of adding
                # a bit-identical copy -- the group tape carries one
                # physical segment per distinct canonical schema and
                # ``member_index`` routes every endpoint to its slot
                reps: List[str] = []
                rep_slot: Dict[str, int] = {}
                member_index: Dict[str, int] = {}
                for m in members:
                    h = self.get(m).canonical_hash if self.dedup_links else ""
                    if h and h in rep_slot:
                        member_index[m] = rep_slot[h]
                        continue
                    slot = len(reps)
                    reps.append(m)
                    if h:
                        rep_slot[h] = slot
                    member_index[m] = slot
                t0 = time.perf_counter()
                with _span(
                    "registry.relink", members=len(reps), group=label
                ):
                    tape = link_tapes(
                        segments=[
                            self._segments[(m, self._active[m])]
                            for m in reps
                        ],
                        names=reps,
                    )
                    validator = BatchValidator(
                        tape,
                        max_depth=self.max_depth,
                        device=self.device,
                        layout=self.layout,
                        metrics=self.metrics,
                    )
                g = LinkGroup(
                    label=label,
                    key=gk,
                    members=tuple(members),
                    signature=signature,
                    tape=tape,
                    validator=validator,
                    member_index=member_index,
                    linked_members=tuple(reps),
                )
                self._m_relinks.inc()
                self._m_relink_seconds.inc(time.perf_counter() - t0)
            new_cache[signature] = g
            new_groups.append(g)
        self._groups = new_groups
        self._group_cache = new_cache
        self._member_group = {
            m: gi for gi, g in enumerate(new_groups) for m in g.members
        }
        self._groups_generation = self._generation
        for g in new_groups:
            self.metrics.gauge(
                "registry_group_members",
                "batchable members per link group",
                group=g.label,
            ).set(len(g.members))

    def groups(self) -> List[LinkGroup]:
        """The current link-group partition (registration order)."""
        self._ensure_groups()
        return list(self._groups)

    def group_of(self, endpoint: str) -> Optional[LinkGroup]:
        """The link group serving ``endpoint`` (None = sequential-only)."""
        self._ensure_groups()
        gi = self._member_group.get(endpoint)
        return None if gi is None else self._groups[gi]

    def group_stats(self) -> Dict[str, Dict[str, Any]]:
        """Per-group window facts: the §8 inflation ledger.

        ``a_hat``/``m_hat``/``horizon`` are the *group-local* linked
        maxima -- what every member in the group actually pays per
        launch -- next to the pow2 ``signature_class`` ceilings the
        partition keyed on.
        """
        self._ensure_groups()
        out: Dict[str, Dict[str, Any]] = {}
        for g in self._groups:
            out[g.label] = {
                "members": list(g.members),
                "n_members": len(g.members),
                "linked_members": list(g.linked_members),
                "n_linked": len(g.linked_members),
                "a_hat": int(g.tape.max_rows_per_loc),
                "m_hat": int(g.tape.max_member_props),
                "k": int(g.tape.max_hash_run),
                "horizon": int(g.tape.max_loc_depth) + 1,
                "signature_class": (
                    {"a_hat": g.key[0], "m_hat": g.key[1], "horizon": g.key[2]}
                    if self.link_grouping
                    else {}
                ),
                "fallbacks": dict(self._group_fallbacks.get(g.label, {})),
            }
        return out

    def warm_groups(
        self, batches: Sequence[int], *, max_nodes: int = 256
    ) -> int:
        """Pre-trace every link group's launch at the given batch sizes
        (power-of-two bucketed, matching admission padding); returns the
        number of new jit traces.  Streaming schedulers call this at
        attach time so deadline-bounded drains never pay a trace."""
        from ..data.doc_table import encode_batch

        self._ensure_groups()
        traced = 0
        for g in self._groups:
            for b in batches:
                bucket = 1 << (int(b) - 1).bit_length() if b > 1 else 1
                keys = [("__warm__", j) for j in range(bucket)]
                table = encode_batch(
                    [None] * bucket,
                    max_nodes=max_nodes,
                    isolate=True,
                    keys=keys,
                )
                traced += int(
                    g.validator.warm(table, np.zeros(bucket, np.int32))
                )
        return traced

    def group_fallbacks(self) -> Dict[str, Dict[str, int]]:
        """group label -> cumulative launch-fallback causes
        (oversize / unroll_overflow / undecided / error_isolated),
        attributed to the group whose launch produced them."""
        return {k: dict(v) for k, v in self._group_fallbacks.items()}

    def _count_group_fallback(self, label: str, reason: str) -> None:
        per = self._group_fallbacks.setdefault(label, {})
        per[reason] = per.get(reason, 0) + 1
        self.metrics.counter(
            "registry_group_fallbacks_total",
            "linked-launch fallback causes per link group",
            group=label,
            reason=reason,
        ).inc()

    # -- linked-tape state (global, legacy single-tape view) ------------------

    def _relink(self) -> None:
        """Re-cut the *global* linked tape from cached per-version segments.

        The serving path launches per link group; this all-members tape
        is kept for the mixed-batch compatibility API
        (:meth:`validate_mixed` / :meth:`schema_ids` /
        :meth:`batch_validator`) and is (re)built lazily on access --
        callers that never touch it never pay for it.
        """
        members: List[str] = []
        segments: List[TapeSegment] = []
        for endpoint in self._order:
            entry = self.get(endpoint)
            if entry.tape is None:
                continue
            key = (endpoint, entry.version)
            seg = self._segments.get(key)
            if seg is None:
                seg = self._segments[key] = segment_tape(entry.tape)
            members.append(endpoint)
            segments.append(seg)
        signature = tuple(
            (m, self._active[m]) for m in members
        )
        if signature == self._linked_signature:
            # membership unchanged: keep the jitted validator alive
            self._linked_generation = self._generation
            return
        t0 = time.perf_counter()
        with _span("registry.relink", members=len(members)):
            if members:
                self._linked = link_tapes(segments=segments, names=members)
                self._linked_validator = BatchValidator(
                    self._linked,
                    max_depth=self.max_depth,
                    device=self.device,
                    layout=self.layout,
                    metrics=self.metrics,
                )
            else:
                self._linked = None
                self._linked_validator = None
        self._member_index = {m: i for i, m in enumerate(members)}
        self._linked_signature = signature
        self._linked_generation = self._generation
        self._m_relinks.inc()
        self._m_relink_seconds.inc(time.perf_counter() - t0)

    def linked_tape(self) -> Optional[LinkedTape]:
        """The linked tape over all batchable serving versions (or None)."""
        if self._linked_generation != self._generation:
            self._relink()
        return self._linked

    def batch_validator(self) -> Optional[BatchValidator]:
        """Batched executor over the current linked tape (or None)."""
        if self._linked_generation != self._generation:
            self._relink()
        return self._linked_validator

    def schema_ids(self, endpoints: Sequence[str]) -> np.ndarray:
        """Member indices into the linked tape; -1 = sequential-only."""
        if self._linked_generation != self._generation:
            self._relink()
        return np.array(
            [self._member_index.get(e, -1) for e in endpoints], np.int32
        )

    # -- multi-tenant validation ---------------------------------------------

    def validate_mixed(
        self,
        table,
        endpoints: Sequence[str],
        *,
        schema_ids: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One batched launch over a heterogeneous (mixed-schema) batch.

        ``table`` is an encoded :class:`~repro.data.doc_table.TokenTable`
        whose row b belongs to ``endpoints[b]``.  Returns ``(valid,
        decided)``; rows of unbatchable endpoints come back
        ``decided=False`` and must be routed to that endpoint's
        sequential validator (``self.get(endpoint).validator``).
        """
        B = table.batch
        if len(endpoints) != B:
            raise ValueError(f"{len(endpoints)} endpoints for batch of {B}")
        for e in set(endpoints):
            self.get(e)  # raises KeyError on unknown endpoints
        bv = self.batch_validator()
        if bv is None:
            return np.zeros(B, bool), np.zeros(B, bool)
        ids = self.schema_ids(endpoints) if schema_ids is None else schema_ids
        batchable = ids >= 0
        valid, decided = bv.validate(table, np.where(batchable, ids, 0))
        return valid, decided & batchable

    def admit_mixed(
        self, docs: Sequence[Any], endpoints: Sequence[str], *, max_nodes: int = 256
    ) -> Tuple[List[bool], "AdmitCounts"]:
        """Boolean-verdict compatibility wrapper over :meth:`admit_mixed_ex`.

        Every non-ADMITTED containment disposition (guard reject,
        isolated error, timeout, suspended fallback) maps to ``False``.
        """
        verdicts, counts = self.admit_mixed_ex(docs, endpoints, max_nodes=max_nodes)
        return [v.valid for v in verdicts], counts

    def admit_mixed_ex(
        self,
        docs: Sequence[Any],
        endpoints: Sequence[str],
        *,
        max_nodes: int = 256,
        keys: Optional[Sequence[Any]] = None,
        explain: bool = False,
    ) -> Tuple[List[Verdict], "AdmitCounts"]:
        """Full mixed-stream admission: one linked launch + routed fallback.

        The fault-contained serving path (DESIGN.md §11).  Per row:
        admission resource guards run *before* any encode work
        (REJECTED_GUARD); linked-tape-member rows encode with
        per-document isolation and launch through the bisecting isolator
        (poison rows -> ERROR_ISOLATED, everything else bit-identical to
        a fault-free run); undecided/unbatchable rows route to that
        endpoint's *bounded* sequential fallback behind its circuit
        breaker (TIMED_OUT past the budget; UNDECIDED_FALLBACK while the
        breaker is open).  Exactly one outcome per row, so
        ``len(docs) == sum of all outcome counters``.

        ``keys`` names each row at the fault-injection seams (defaults
        to the row index).  Returns per-row :class:`Verdict`s plus
        counters; the serving engine and the pipeline admission
        controller share this path.

        ``explain=True`` opts into first-failure attribution (DESIGN.md
        §12): INVALID verdicts carry a ``FailureSite`` on ``.site`` and
        a rendered reason.  Batched rows pay one extra (separate) explain
        launch over the already-encoded table; sequential rows re-run
        the diagnostic interpreter.  ``explain=False`` traffic pays
        nothing -- the fast path is unchanged.
        """
        if explain:
            # batched first-failure attribution is not ported yet: fail
            # loudly instead of returning verdicts without their sites
            raise NotImplementedError("explain_batch is not ported yet")
        if len(endpoints) != len(docs):
            raise ValueError(f"{len(endpoints)} endpoints for {len(docs)} docs")
        for e in set(endpoints):
            self.get(e)
        row_keys = list(keys) if keys is not None else list(range(len(docs)))
        if len(row_keys) != len(docs):
            raise ValueError(f"{len(row_keys)} keys for {len(docs)} docs")
        verdicts: List[Optional[Verdict]] = [None] * len(docs)
        counts = AdmitCounts()
        with _phase("admit.guard"), _span("registry.guard", batch=len(docs)):
            for i, doc in enumerate(docs):
                why = resource_guard(doc, self.guard)
                if why:
                    verdicts[i] = Verdict(
                        ValidationOutcome.REJECTED_GUARD, False, why
                    )
                    counts.rejected_guard += 1
        self._ensure_groups()
        # one launch per link group with members aboard (DESIGN.md §14):
        # each group pays its own group-local Â/M̂/horizon windows
        by_group: Dict[int, List[int]] = {}
        for i in range(len(docs)):
            if verdicts[i] is None:
                gi = self._member_group.get(endpoints[i])
                if gi is not None:
                    by_group.setdefault(gi, []).append(i)
        for gi in sorted(by_group):
            self._admit_group(
                self._groups[gi],
                by_group[gi],
                docs,
                endpoints,
                row_keys,
                verdicts,
                counts,
                max_nodes=max_nodes,
                explain=explain,
            )
        with _phase("admit.verdicts"):
            for i in range(len(docs)):
                if verdicts[i] is None:
                    v = self._bounded_fallback(
                        endpoints[i], docs[i], row_keys[i], explain=explain
                    )
                    verdicts[i] = v
                    if v.outcome in (
                        ValidationOutcome.ADMITTED,
                        ValidationOutcome.INVALID,
                    ):
                        counts.fallback_validated += 1
                    elif v.outcome is ValidationOutcome.TIMED_OUT:
                        counts.timed_out += 1
                    elif v.outcome is ValidationOutcome.UNDECIDED_FALLBACK:
                        counts.breaker_open += 1
                    else:
                        counts.error_isolated += 1
        return verdicts, counts  # type: ignore[return-value]

    def _admit_group(
        self,
        g: LinkGroup,
        rows: List[int],
        docs: Sequence[Any],
        endpoints: Sequence[str],
        row_keys: List[Any],
        verdicts: List[Optional[Verdict]],
        counts: "AdmitCounts",
        *,
        max_nodes: int,
        explain: bool,
    ) -> None:
        """One isolated launch of ``rows`` over ``g``'s linked tape.

        Verdict semantics are identical to the legacy single-tape fast
        path (differentially pinned bit-identical by the tests); the only
        change is *which* linked tape the rows ride, plus per-group
        attribution of launch-fallback causes.
        """
        from ..data.doc_table import encode_batch

        per = counts.group(g.label)
        # pad the batch dimension to a power-of-two bucket: the
        # executor re-traces per batch shape, and len(rows) is
        # traffic-controlled -- bucketing caps compilations at
        # log2(max burst) instead of one per distinct size
        bucket = 1 << (len(rows) - 1).bit_length() if len(rows) > 1 else 1
        pad = bucket - len(rows)
        fast_keys = [row_keys[i] for i in rows] + [
            ("__pad__", j) for j in range(pad)
        ]
        with _phase("admit.encode"), _span(
            "registry.encode", batch=bucket, group=g.label
        ):
            table = encode_batch(
                [docs[i] for i in rows] + [None] * pad,
                max_nodes=max_nodes,
                isolate=True,
                keys=fast_keys,
            )
        ids = np.array(
            [g.member_index[endpoints[i]] for i in rows] + [0] * pad,
            np.int32,
        )
        # admit.launch's exclusive time is the bisect/bookkeeping
        # overhead around the executor.compile/execute children
        with _phase("admit.launch"):
            valid, decided, frontier, errors = g.validator.validate_isolated(
                table, ids, keys=fast_keys
            )
        sites: List[Optional[FailureSite]] = []
        if explain and any(
            decided[j] and not valid[j] and j not in errors
            for j in range(len(rows))
        ):
            # opt-in second launch over the same encoded table: the
            # argmax over per-row failures (core/explain.py); rows we
            # don't attribute below are simply ignored
            try:
                with _phase("admit.explain"):
                    sites = g.validator.explain_batch(
                        table,
                        ids,
                        docs=[docs[i] for i in rows] + [None] * pad,
                    )
            except Exception:
                sites = []  # attribution is best-effort diagnostics
        with _phase("admit.verdicts"):
            for j, i in enumerate(rows):
                if j in errors:
                    verdicts[i] = Verdict(
                        ValidationOutcome.ERROR_ISOLATED,
                        False,
                        errors[j],
                        "batched",
                    )
                    counts.error_isolated += 1
                    per["error_isolated"] += 1
                    self._count_group_fallback(g.label, "error_isolated")
                elif decided[j]:
                    ok = bool(valid[j])
                    site = None if ok or j >= len(sites) else sites[j]
                    verdicts[i] = Verdict(
                        ValidationOutcome.ADMITTED
                        if ok
                        else ValidationOutcome.INVALID,
                        ok,
                        ""
                        if ok
                        else (
                            site.render()
                            if site is not None
                            else "schema validation failed"
                        ),
                        "batched",
                        site,
                    )
                    counts.batch_validated += 1
                    per["batch_validated"] += 1
                elif not table.ok[j]:
                    counts.oversize += 1  # encoder node/depth budget
                    per["oversize"] += 1
                    self._count_group_fallback(g.label, "oversize")
                elif frontier[j]:
                    counts.unroll_overflow += 1  # $ref-unroll budget
                    per["unroll_overflow"] += 1
                    self._count_group_fallback(g.label, "unroll_overflow")
                else:
                    counts.undecided += 1  # executor depth budget
                    per["undecided"] += 1
                    self._count_group_fallback(g.label, "undecided")

    # -- bounded sequential fallback (the second degradation rung) -----------

    _BREAKER_STATES = {"closed": 0, "half_open": 1, "open": 2}

    def breaker(self, endpoint: str) -> CircuitBreaker:
        """The endpoint's fallback circuit breaker (created on first use)."""
        b = self._breakers.get(endpoint)
        if b is None:
            b = self._breakers[endpoint] = CircuitBreaker(
                self.breaker_cfg, clock=self.clock
            )
        return b

    def _breaker_gauge(self, endpoint: str, breaker: CircuitBreaker) -> None:
        self.metrics.gauge(
            "breaker_state",
            "fallback breaker per endpoint (0=closed 1=half_open 2=open)",
            endpoint=endpoint,
        ).set(self._BREAKER_STATES.get(breaker.state, -1))

    def _explain_sequential(self, endpoint: str, doc: Any) -> Optional[FailureSite]:
        """Innermost sequential trace entry as a FailureSite (best-effort)."""
        try:
            ok, trace = self.get(endpoint).validator.explain(doc)
        except Exception:
            return None
        if ok or not trace:
            return None
        path, _instr = trace[0]  # innermost failure first
        return FailureSite(path, keyword_of(path))

    def _bounded_fallback(
        self, endpoint: str, doc: Any, key: Any, *, explain: bool = False
    ) -> Verdict:
        breaker = self.breaker(endpoint)
        if not breaker.allow():
            self._breaker_gauge(endpoint, breaker)
            return Verdict(
                ValidationOutcome.UNDECIDED_FALLBACK,
                False,
                "fallback suspended: circuit open (endpoint degraded)",
            )
        try:
            fault_point("fallback", key)
            budget = ValidationBudget(
                max_steps=self.fallback_max_steps,
                deadline_s=self.fallback_deadline_s,
                clock=self.clock,
            )
            with _phase("fallback.sequential"), _span(
                "registry.fallback", endpoint=endpoint
            ):
                ok = self.get(endpoint).validator.is_valid_bounded(
                    doc, budget=budget
                )
        except (ValidationTimeout, DocumentDepthError) as exc:
            breaker.record_timeout()
            self._breaker_gauge(endpoint, breaker)
            return Verdict(
                ValidationOutcome.TIMED_OUT, False, str(exc), "sequential"
            )
        except Exception as exc:
            # a per-document error, not an endpoint-health signal: the
            # breaker only counts timeouts
            return Verdict(
                ValidationOutcome.ERROR_ISOLATED,
                False,
                f"{type(exc).__name__}: {exc}",
                "sequential",
            )
        breaker.record_success()
        self._breaker_gauge(endpoint, breaker)
        site = None
        if not ok and explain:
            # opt-in diagnostics: re-run the (unbounded) trace interpreter
            # on a document the bounded oracle already completed once
            site = self._explain_sequential(endpoint, doc)
        return Verdict(
            ValidationOutcome.ADMITTED if ok else ValidationOutcome.INVALID,
            ok,
            ""
            if ok
            else (site.render() if site is not None else "schema validation failed"),
            "sequential",
            site,
        )

    def validate_one(
        self, endpoint: str, doc: Any, *, key: Any = None, explain: bool = False
    ) -> Verdict:
        """Single-document admission through the same containment ladder:
        resource guard, then the breaker-gated bounded fallback."""
        self.get(endpoint)  # KeyError on unknown endpoints
        why = resource_guard(doc, self.guard)
        if why:
            return Verdict(ValidationOutcome.REJECTED_GUARD, False, why)
        return self._bounded_fallback(
            endpoint, doc, key if key is not None else endpoint, explain=explain
        )
