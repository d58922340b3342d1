"""Sharded training-data pipeline with Blaze admission control.

The paper's deployment story made concrete: every JSON training record is
validated against the dataset schema *before* tokenization.  Validation
uses the compiled fast path -- the batched tensor executor when the schema
is in the structural subset, the sequential compiled executor otherwise --
and rejected records are counted, never trained on.

Sharding is deterministic by (host_id, num_hosts): host h takes records
where ``record_index % num_hosts == host_id``, so restarts and elastic
re-meshes replay identical shards from a step-indexed cursor (no
coordination service required -- the 1000-node-friendly choice).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core import Validator
from ..core.outcomes import Verdict
from ..obs.profile import phase as _phase
from ..obs.stats import RegistryBackedStats
from ..registry import SchemaRegistry
from . import tokenizer
from .doc_table import encode_batch


class PipelineStats(RegistryBackedStats):
    """Admission counters, registry-backed (DESIGN.md §12).

    Attribute API unchanged; every field is a live counter child of a
    shared :class:`~repro.obs.metrics.MetricRegistry`, with
    ``snapshot()``/``reset()`` from the base.
    """

    PREFIX = "pipeline_"
    INT_FIELDS = (
        "seen",
        "admitted",
        "rejected",
        "batch_validated",
        "fallback_validated",
        # batchable records the depth-budgeted executor could not decide
        # (routed to the sequential oracle) -- observable, never silent.
        # ``oversize`` separately counts encoder-budget
        # (max_nodes/max_depth) overflows and ``unroll_overflow`` counts
        # documents whose recursion outran the tape's $ref-unroll
        # budget, so the three fallback causes are distinguishable
        "undecided",
        "oversize",
        "unroll_overflow",
        # fault-containment dispositions (DESIGN.md §11); all are rejects
        "rejected_guard",
        "error_isolated",
        "timed_out",
        "breaker_open",
    )
    HELP = {"seen": "records seen by the admission controller"}


class AdmissionController:
    """Compiled-schema admission: batch fast path + sequential fallback.

    Single-tenant by default (one ``schema`` on the ``endpoint`` id);
    pass a shared :class:`~repro.registry.SchemaRegistry` plus
    per-record endpoint ids to :meth:`admit` for multi-tenant admission
    over the registry's linked tape -- one batched launch for the whole
    mixed stream.  ``device``/``layout``/``max_depth`` configure the
    batched executor when the controller owns its registry (a caller-
    provided registry keeps its own settings).
    """

    def __init__(
        self,
        schema: Any = None,
        *,
        registry: Optional[SchemaRegistry] = None,
        endpoint: str = "default",
        use_batch: bool = True,
        batch_max_nodes: int = 256,
        device=None,
        layout: str = "csr",
        max_depth: int = 16,
    ):
        if registry is None:
            registry = SchemaRegistry(
                device=device, layout=layout, max_depth=max_depth
            )
        self.registry = registry
        self.endpoint = endpoint
        self.use_batch = use_batch
        self.batch_max_nodes = batch_max_nodes
        if schema is not None:
            registry.register(endpoint, schema)
        elif endpoint not in registry.endpoints():
            raise ValueError(
                f"no schema given and endpoint {endpoint!r} not in the registry"
            )
        self.stats = PipelineStats(registry.metrics)

    # -- back-compat accessors (single-tenant view of the registry) ----------

    @property
    def _entry(self):
        return self.registry.get(self.endpoint)

    @property
    def compiled(self):
        return self._entry.compiled

    @property
    def sequential(self) -> Validator:
        return self._entry.validator

    @property
    def fallback_reason(self) -> str:
        return self._entry.stats.fallback_reason

    @property
    def fallback_reasons(self) -> Dict[str, str]:
        """Per-endpoint ``try_build_tape`` failure reasons (the real
        strings, not a generic "fallback" flag) for every registered
        endpoint outside the structural subset."""
        return self.registry.fallback_reasons()

    @property
    def batch_validator(self):
        """The linked-tape executor, or None when the default endpoint
        is outside the structural subset (or batching is disabled).

        NOTE: on a multi-member registry the returned executor spans all
        members -- calling ``.validate`` directly needs per-document
        ``schema_ids`` (it refuses to guess); :meth:`admit` handles that.
        """
        if not self.use_batch or self._entry.tape is None:
            return None
        return self.registry.batch_validator()

    def admit(
        self, records: List[Any], endpoints: Optional[List[str]] = None
    ) -> List[bool]:
        """Boolean-verdict admission (back-compat view of :meth:`admit_ex`)."""
        if self.use_batch:
            return [v.valid for v in self.admit_ex(records, endpoints)]
        if endpoints is None:
            endpoints = [self.endpoint] * len(records)
        if len(endpoints) != len(records):
            raise ValueError(
                f"{len(endpoints)} endpoints for {len(records)} records"
            )
        self.stats.seen += len(records)
        results = [
            self.registry.get(e).validator.is_valid(r)
            for e, r in zip(endpoints, records)
        ]
        self.stats.fallback_validated += len(records)
        self.stats.admitted += sum(results)
        self.stats.rejected += len(results) - sum(results)
        return results

    def admit_ex(
        self,
        records: List[Any],
        endpoints: Optional[List[str]] = None,
        *,
        keys: Optional[List[Any]] = None,
        explain: bool = False,
    ) -> List[Verdict]:
        """Fault-contained admission through the registry's containment
        ladder (guards -> isolated batched launch -> bounded fallback);
        one structured :class:`Verdict` per record, and ``seen`` always
        equals the sum of all disposition counters.  ``explain=True``
        opts INVALID verdicts into first-failure attribution."""
        if endpoints is None:
            endpoints = [self.endpoint] * len(records)
        self.stats.seen += len(records)
        # top-level attribution root: admit.* / encode.* / executor.* /
        # fallback.* phases nest under it, so its exclusive time is the
        # controller's own bookkeeping
        with _phase("pipeline.admit"):
            verdicts, counts = self.registry.admit_mixed_ex(
                records,
                endpoints,
                max_nodes=self.batch_max_nodes,
                keys=keys,
                explain=explain,
            )
        self.stats.batch_validated += counts.batch_validated
        self.stats.undecided += counts.undecided
        self.stats.oversize += counts.oversize
        self.stats.unroll_overflow += counts.unroll_overflow
        self.stats.fallback_validated += counts.fallback_validated
        self.stats.rejected_guard += counts.rejected_guard
        self.stats.error_isolated += counts.error_isolated
        self.stats.timed_out += counts.timed_out
        self.stats.breaker_open += counts.breaker_open
        admitted = sum(1 for v in verdicts if v.admitted)
        self.stats.admitted += admitted
        self.stats.rejected += len(verdicts) - admitted
        return verdicts


@dataclass
class ShardedPipeline:
    """Deterministic host-sharded record -> token-batch pipeline."""

    schema: Any
    records: List[Any]  # in-memory source; production: sharded files
    host_id: int = 0
    num_hosts: int = 1
    seq_len: int = 128
    batch_size: int = 8
    admission_batch: int = 64
    device: Any = None  # admission's device: cuda unless told otherwise

    def __post_init__(self):
        self.admission = AdmissionController(self.schema, device=self.device)
        self.cursor = 0

    def _shard_records(self) -> Iterator[Tuple[int, Any]]:
        for i, rec in enumerate(self.records):
            if i % self.num_hosts == self.host_id:
                yield i, rec

    def batches(self) -> Iterator[Dict[str, np.ndarray]]:
        """Yield {tokens, labels} batches of admitted, tokenized records."""
        buffer: List[str] = []
        pending: List[Any] = []

        def flush_pending():
            nonlocal pending
            if not pending:
                return
            oks = self.admission.admit(pending)
            for rec, ok in zip(pending, oks):
                if ok:
                    buffer.append(json.dumps(rec, sort_keys=True))
            pending = []

        for _, rec in self._shard_records():
            pending.append(rec)
            if len(pending) >= self.admission_batch:
                flush_pending()
            while True:
                packed = self._drain(buffer)
                if packed is None:
                    break
                yield packed
        flush_pending()
        while True:
            packed = self._drain(buffer, final=True)
            if packed is None:
                break
            yield packed

    def _drain(self, buffer: List[str], final: bool = False):
        need_tokens = self.seq_len * self.batch_size
        have = sum(len(t) + 2 for t in buffer)
        if have < need_tokens and not (final and buffer):
            return None
        text, rest = buffer[:], []
        packed = tokenizer.pack(text, self.seq_len)
        buffer.clear()
        if packed.shape[0] < self.batch_size:
            if not final:
                # not enough rows yet: put the text back and wait
                buffer.extend(text)
                return None
            reps = -(-self.batch_size // packed.shape[0])
            packed = np.tile(packed, (reps, 1))
        tokens = packed[: self.batch_size]
        labels = np.roll(tokens, -1, axis=1).astype(np.int32)
        labels[:, -1] = -1  # masked
        return {"tokens": tokens.astype(np.int32), "labels": labels}
