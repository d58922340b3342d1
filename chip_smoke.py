#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. card: the torch device and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` compiles every kernel source of ``src/repro_torch/csrc``
   in parallel, with its time and ``ptxas`` register/shared-memory use;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   first on small adversarial cases, then on the inputs the main path gives
   it, with CUDA-event times of device work only, each kernel's own
   duration under the profiler, what both timers read for an empty kernel,
   the plain version's time and the bound (``hash_match`` also at the dense
   admission's largest call); the window kernel reads each node's window
   from the tape, with the rows staged in shared memory and, on the same
   tape padded past the staging capacity, read in place, and beside it
   stands the time of the (N, W[, 8]) operand gathers it replaced;
4. main path: batched CSR validation of the five-endpoint gateway mix
   (B=4096 documents, max_nodes=64, linked tape) through
   ``BatchValidator.validate_ex``: docs/s, launch and encode times, launch
   counts, and verdicts against the port's CPU run and the sequential
   ``Validator``;
5. isolation: one row's launch fault injected through ``set_fault_hook`` is
   cornered by ``validate_isolated`` while every other row stays bit-equal;
6. profile: host milliseconds per launch in each executor phase, then one
   launch under ``torch.profiler``: device-busy share and the heaviest
   device kernels;
7. registry: ``AdmissionController.admit_ex`` over a ``SchemaRegistry`` of
   the five gateway endpoints (three link groups), once per executor layout
   (``csr``, ``dense``), on the same B=4096 requests at
   ``batch_max_nodes=64``: median ``admit_ex`` time and requests/s, kernel
   launches per call, the ``AdmitCounts``, host ms by phase and the
   device-busy share of one profiled call; the verdicts are equal between
   the layouts, to a ``device="cpu"`` registry and, where decided on the
   batched path, to the sequential ``Validator``.  Every kernel call of one
   admission is held against its plain version: in the csr layout the 3
   ``hash_match`` and 3 ``assertion_eval_window`` calls, in the dense
   layout the 48 ``hash_match`` calls (16 depth iterations x 3 groups) and
   the 3 ``assertion_eval`` calls; the window kernel, ``hash_match`` (dense)
   and ``assertion_eval`` are timed at their largest call;
8. serve: the gateway in front of the dense LM.  (a) ``ServeEngine`` with
   granite-3-8b at its published widths and depth (bf16 weights drawn on
   the card from a seeded generator, ``batch_slots=4``, ``max_len=512``,
   the five gateway endpoints) admits one ``submit_batch`` of the first 128
   requests of phase 7's mix, every ``hash_match`` and
   ``assertion_eval_window`` call held against its plain version and the
   ``SubmitResult``s against a CPU registry's, then takes 32 ``step()``s:
   admission ms, each prefill's ms, the longest admitted prompt's prefill
   alone by CUDA events, the median decode step, tokens/s, peak memory and
   the step's byte bound; (b) at full width in float32 (TF32 off), a
   prefill of a prompt's first L-1 tokens then ``decode_step`` of its last
   equals the prefill of all L (max |dlogit| <= 1e-3 max |logit|, argmax
   equal); (c) a reduced float32 engine serves the same four prompts on the
   card and on the CPU from one set of CPU-made parameters: ids equal,
   every LM call's logits within 1e-4 max |logit|;
9. explain: phase 7's csr registry admission with ``explain=True``: every
   ``hash_match`` and ``assertion_eval_window`` call (validate and explain
   launches) held against its plain version; every batched INVALID verdict
   must carry a site, equal to a ``device="cpu"`` registry's and blamed by
   the sequential ``Validator``'s trace; one direct
   ``BatchValidator.explain_batch`` on the largest link group's table
   against the CPU's; the dense layout's empty sites; the median
   ``admit_ex`` with and without explain (10 calls each, alternated, the
   first of each pair swapped from pair to pair) and
   the ``executor.explain`` host ms;
10. families: (a) ``ServeEngine`` with moonshot-v1-16b-a3b (64 experts,
   top-6) at its published widths and depth in bf16 admits the first 128
   requests with ``explain=True`` (kernel calls and results held as in 8
   (a)) and takes 16 steps; (b) rwkv6-3b at full width and depth in bf16:
   ``Model.prefill`` of 17, 64, 128 and 64 tokens into a 4-slot cache and
   16 decode steps; (c) the cache path against the full path in float32 at
   L=64 for rwkv6-3b (full depth) and moonshot (12 of 48 layers), gated
   where the reference's decode is consistent with its full path (RWKV's
   channel mix without its token shift, moonshot routed to one expert with
   room for every token; the published forms are measured beside them);
   (d) reduced moonshot, arctic, jamba and rwkv6 in float32 on the card
   against the CPU: ids equal, logits within 1e-4;
11. train: (a) rwkv6-3b at its published widths and depth (bf16 parameters,
   float32 Adam moments) trained by the driver's components: the driver's
   corpus through ``ShardedPipeline`` admission on the card, the one-device step
   (remat on, ``donate=False``) under ``TrainSupervisor``, batch 4 x seq 512,
   one warm-up and 8 timed steps: step ms, tokens/s, peak memory, each step's
   loss and grad norm (finite), the FLOP bound (6 N T at 989 TFLOP/s) and the
   update's byte bound, the update alone by CUDA events, the device-busy
   share of one more step under the profiler; every
   ``hash_match`` and ``assertion_eval_window`` call of the admissions held
   against its plain version and every batch the pipeline yielded against a
   ``device="cpu"`` pipeline's; (b) reduced granite, moonshot, jamba and
   rwkv6 in float32: 3 train steps on the card and on the CPU from one set
   of CPU-made parameters, loss and grad norm within 1e-4 relative a step,
   parameters within 2 * sum lr; (c) a checkpoint of reduced granite (bf16
   parameters, float32 moments) restored onto the card bit for bit, the
   supervisor's NaN rollback and resume, and ``python -m
   repro_torch.launch.train --arch granite-3-8b --steps 4 --device cuda``
   (the driver trains on its host mesh);
12. mesh: (a) rwkv6-3b at its published widths and depth trained on the
   (1, 1) mesh of ``make_host_mesh`` (NCCL) by ``make_train_step(model,
   ocfg, mesh, batch=4)`` with ``donate=True``, its state placed by the
   returned shardings, behind ``ShardedPipeline`` admission on the card
   (every kernel call held against its plain version, the batches against
   a CPU pipeline's), one warm-up, two timed and one profiled step; then
   the same seed, state and batches through the one-device step: loss and
   grad norm bit-equal each step, every parameter and moment leaf bit-equal
   after the last; both medians, the device kernels of the profiled step
   and peak memory; (b) reduced granite in float32: ``make_prefill_step``
   and four ``make_decode_step`` calls bit-equal to ``Model.prefill`` and
   ``Model.decode_step``; (c) phase 11 (c)'s checkpoint restored onto the
   mesh with ``restore(shardings=...)``: every leaf a DTensor on the mesh,
   bit-equal; (d) ``compressed_psum`` over each mesh axis on NCCL bit-equal
   to ``int8_dequantize(*int8_quantize(x))``;
13. conformance (run right after phase 7: it needs no LM memory): (a)
   ``python -m pytest -q -m cuda tests/test_torch_cuda.py
   tests/test_torch_cuda_suites.py`` in a subprocess (no xdist, the
   Hypothesis store in a temporary directory): the kernel tests and the JAX
   package's executor and registry suites adapted to the card, exit 0,
   every collected test passed, none skipped; (b) the port's conformance
   runner (``repro_torch.launch.conformance.run_corpus``) with the batched
   engine on the card in both layouts: no failure, totals and per-file
   stats equal to a ``device="cpu"`` run, launches one a batched case
   (dense: ``hash_match`` once a depth iteration); (c) the corpus's 26
   groups as the endpoints of one registry (``<file stem>.<group index>``),
   4096 requests drawn with ``random.Random(0)`` (a uniform group, then a
   uniform test of it), admitted by ``admit_ex`` at ``batch_max_nodes=64``
   in both layouts, one warm-up and 10 timed calls: every verdict equal to
   the corpus's, to a CPU registry's (``AdmitCounts`` too) and across
   layouts, every kernel call of one admission equal to its plain version;
   median ``admit_ex``, host ms by phase and the sequential fallback's
   share of them.

Any mismatch or exception exits non-zero.  The last lines are the serve,
explain, family, train, mesh and conformance JSON lines, the kernels JSON line (``launches`` counts the
path each kernel serves: the CSR main
path for the first two, the dense admission for ``assertion_eval``;
``launches_by_path`` has every path's count: the serve burst's under
``serve``, phase 9's 10 timed explain admissions under ``explain``, the
moonshot burst under ``serve_moe``, phase 11's training run under
``train``, phase 12's mesh run under ``mesh``, phase 13's card runs of the
runner and timed deployment admissions under ``conformance``;
``hash_match``'s ``dense``
holds its time, bound and launches in the dense admission,
``assertion_eval_window``'s ``admission`` the same in the csr admission),
the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Needs a CUDA device: without one, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import itertools
import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BF16_TENSOR_OPS_PER_S = 989e12  # H100 SXM dense bf16 tensor-core rate
BATCH = 4096
MAX_NODES = 64
TIMED_LAUNCHES = 10
# the AdmitCounts fields that PipelineStats also counts (all but per_group)
ADMIT_COUNT_FIELDS = ("batch_validated", "undecided", "oversize", "unroll_overflow",
                      "fallback_validated", "rejected_guard", "error_isolated",
                      "timed_out", "breaker_open")
SEED = 0
# phase 8: the dense LM behind admission, its burst and its tolerances
SERVE_ARCH = "granite-3-8b"
SERVE_BURST = 128
SERVE_SLOTS = 4
SERVE_MAX_LEN = 512
SERVE_STEPS = 32
CACHE_REL = 1e-3  # cache path against full path, float32 at full width
CARD_CPU_REL = 1e-4  # card against CPU, reduced, float32
# phase 10: the MoE and SSM families
FAMILY_SERVE_ARCH = "moonshot-v1-16b-a3b"
FAMILY_STEPS = 16
RWKV_ARCH = "rwkv6-3b"
RWKV_PROMPTS = (17, 64, 128)  # lengths the reference's 64-token chunk rule accepts
CACHE_L = 64
CACHE_CUT_LAYERS = 12  # moonshot's depth in float32 for the cache check
FAMILY_CPU_ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b", "jamba-1.5-large-398b", "rwkv6-3b")
# phase 11: the training path
TRAIN_ARCH = "rwkv6-3b"
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_WARMUP = 1  # steps before the timed ones
TRAIN_TIMED = 8
TRAIN_DRIVER_STEPS = 3  # launch/train.py itself at full width
TRAIN_CPU_ARCHS = ("granite-3-8b", "moonshot-v1-16b-a3b", "jamba-1.5-large-398b", "rwkv6-3b")
TRAIN_CPU_STEPS = 3
TRAIN_REL = 1e-4  # card against CPU, reduced, float32: loss and grad norm a step
TRAIN_PARAM_ABS = 1e-4  # card against CPU: parameters after the steps
TRAIN_PARAM_FLIPS = 1e-5  # the share of elements that may exceed it (sign flips)
# phase 12: the mesh
MESH_STEPS = 4  # one warm-up, two timed, one profiled
MESH_SERVE_MAX_LEN = 64
MESH_DECODE_STEPS = 4

# the gateway's endpoint mix (benchmarks/registry.py): completions dominate,
# moderation is the tail; charge is the tagged-union endpoint with circuits
MIX = [("complete", 60), ("chat", 15), ("embed", 10), ("charge", 10), ("moderate", 5)]


def mk_request(endpoint: str, i: int, rng: random.Random):
    """One request body for ``endpoint``; every ninth is invalid (~11%)."""
    bad = i % 9 == 0
    if endpoint == "complete":
        req = {
            "prompt": "hello world " * rng.randint(1, 12),
            "max_tokens": rng.randint(1, 512),
            "temperature": round(rng.random(), 2),
        }
        if bad:
            req["max_tokens"] = -1
    elif endpoint == "chat":
        req = {
            "messages": [
                {"role": rng.choice(["system", "user"]), "content": "hi " * rng.randint(1, 6)}
                for _ in range(rng.randint(1, 3))
            ],
            "max_tokens": rng.randint(1, 256),
        }
        if bad:
            req["messages"][0]["role"] = "robot"
    elif endpoint == "embed":
        req = {"input": "text " * rng.randint(1, 16), "dimensions": rng.choice([64, 256, 1024])}
        if bad:
            req["dimensions"] = 2
    elif endpoint == "charge":
        kind = rng.choice(["card", "bank", "wallet"])
        if kind == "card":
            method = {"kind": kind, "number": "4111111111111111", "cvv": "123"}
        elif kind == "bank":
            method = {"kind": kind, "iban": "DE89370400440532013000"}
        else:
            method = {"kind": kind, "wallet_id": f"w-{rng.randint(0, 999)}"}
        req = {
            "amount": rng.randint(1, 500_000),
            "currency": rng.choice(["usd", "eur", "gbp"]),
            "method": method,
        }
        if bad:
            req["method"] = dict(method, kind=rng.choice(
                [k for k in ("card", "bank", "wallet") if k != kind]
            ))
    else:
        req = {"input": "msg " * rng.randint(1, 8), "category": rng.choice(["toxicity", "spam"])}
        if bad:
            req["category"] = "other"
    return req


def mixed_stream(batch: int, rng: random.Random) -> Tuple[list, List[str]]:
    lanes = [ep for ep, weight in MIX for _ in range(weight)]
    endpoints = [lanes[rng.randrange(len(lanes))] for _ in range(batch)]
    return [mk_request(ep, i, rng) for i, ep in enumerate(endpoints)], endpoints


def gateway(batch: int, seed: int = SEED):
    """(linked tape, member names, docs, schema ids) of the gateway mix,
    built through the port's own front end."""
    from repro_torch.core import compile_schema
    from repro_torch.core.tape import try_build_tape
    from repro_torch.registry import link_tapes
    from repro_torch.registry.presets import GATEWAY_SCHEMAS

    names = list(GATEWAY_SCHEMAS)
    tapes = []
    for name in names:
        tape, reason = try_build_tape(compile_schema(GATEWAY_SCHEMAS[name]))
        if tape is None:
            raise RuntimeError(f"{name}: not batchable: {reason}")
        tapes.append(tape)
    docs, endpoints = mixed_stream(batch, random.Random(seed))
    ids = np.asarray([names.index(e) for e in endpoints], np.int32)
    return link_tapes(tapes, names=names), names, docs, ids


def oracle_verdicts(names, docs, ids) -> np.ndarray:
    """The port's sequential ``Validator`` on every document."""
    from repro_torch.core import Validator, compile_schema
    from repro_torch.registry.presets import GATEWAY_SCHEMAS

    validators = [Validator(compile_schema(GATEWAY_SCHEMAS[n])) for n in names]
    return np.asarray([validators[int(i)].is_valid(d) for i, d in zip(ids, docs)])


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def spin_cycles_per_ms() -> float:
    """The rate of ``torch.cuda._sleep``'s spin, read with CUDA events."""
    cycles = 10_000_000
    torch.cuda._sleep(cycles)  # first call: module load
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    torch.cuda.synchronize()
    return cycles / start.elapsed_time(end)


def device_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    """Median CUDA-event time of ``fn``'s device work with the 50 MB L2
    flushed before each call (a cold cache, as after the executor's other
    passes).

    A spin kernel (``torch.cuda._sleep``) keeps the device busy for at
    least 1 ms and four times the host time of one call, so the host has
    enqueued all of ``fn`` before the start event runs and the events
    bracket device work only, not the device waiting on the Python wrapper.
    """
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    spin = int(max(1.0, 4 * host_ms) * spin_cycles_per_ms())
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def profiled_ms(fn: Callable[[], Any], kernel: str, reps: int = 20):
    """Mean duration of the device kernel whose name contains ``kernel``
    over ``reps`` calls of ``fn``, each after an L2 flush, as the profiler
    (CUPTI) records it: the kernel alone, without the CUDA events' own cost
    that ``device_ms`` includes.  None if the profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    events = [ev for ev in prof.key_averages() if kernel in ev.key]
    count = sum(ev.count for ev in events)
    total_us = sum(ev.self_device_time_total for ev in events)
    return total_us / count / 1e3 if count and total_us > 0 else None


def kernel_times(kernel: Callable[[], Any], plain: Callable[[], Any],
                 symbol: str) -> Dict[str, Any]:
    """Device-only times of a kernel and its plain version, and the kernel's
    own duration under the profiler (``symbol``: its CUDA function name)."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "profiler_ms": profiled_ms(kernel, symbol)}


def timing_floor() -> Dict[str, Any]:
    """What the two timers read for a one-cycle spin kernel: the fixed cost
    inside every ``ms`` (CUDA events) and ``profiler_ms`` of this run."""
    def spin():
        torch.cuda._sleep(1)

    return {"ms": device_ms(spin), "profiler_ms": profiled_ms(spin, "spin_kernel")}


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def card() -> Tuple[str, str]:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"[card] torch device: {name}; torch {torch.__version__}, CUDA {torch.version.cuda}; "
          f"devices: {torch.cuda.device_count()}")
    print(f"[card] nvidia-smi: {smi}")
    return name, smi


def build() -> None:
    from repro_torch.kernels.build import NVCC_FLAGS, build as build_kernels

    t0 = time.perf_counter()
    results = build_kernels(["hash_match", "assertion_eval_window", "assertion_eval"])
    for r in results:
        print(f"[build] {r.name}.cu: {r.seconds:.2f} s -> {r.path.name}")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build]   {line.strip()}")
    print(f"[build] total {time.perf_counter() - t0:.2f} s (flags: {' '.join(NVCC_FLAGS)})")


def _lanes(rng: np.random.Generator, n: int, pool: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(pool[rng.integers(0, len(pool), n)].view(np.int32).copy()).cuda()


def _key_pool() -> np.ndarray:
    from repro_torch.data.doc_table import key_lanes

    keys = ["a", "b", "name", "kind", "value", "x" * 40, "y" * 40, "nested", "tags", ""]
    return np.stack([key_lanes(k) for k in keys])


def _check_equal(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item() if got.numel() else 0
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain version (max abs err {err})")
    return float(err)


def _node_cols(rng: np.random.Generator, pool: np.ndarray, n: int, num=None, ntype=None):
    return {
        "type": ntype if ntype is not None else rng.integers(0, 7, n),
        "is_int": rng.integers(0, 2, n),
        "num": num if num is not None else rng.normal(0, 10, n),
        "size": rng.integers(0, 12, n),
        "acquired": rng.integers(-(2**31), 2**31, n),
        "str_hash": pool[rng.integers(0, len(pool), n)],
        "str_prefix": rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32),
    }


def _to_cuda(cols: dict, floats=("num", "f0")) -> Dict[str, torch.Tensor]:
    """numpy columns -> CUDA tensors: floats as float32, uint32 words as
    int32 views, other integers as int32."""
    out = {}
    for k, v in cols.items():
        v = np.asarray(v)
        if k in floats:
            v = v.astype(np.float32)
        elif v.dtype == np.uint32:
            v = v.view(np.int32)
        else:
            v = v.astype(np.int64).astype(np.int32)
        out[k] = torch.from_numpy(np.ascontiguousarray(v)).cuda()
    return out


def window_tape_case(rng: np.random.Generator, pool: np.ndarray, n: int, n_loc: int, a: int,
                     w: int):
    """(node columns, loc, tape columns) on the card for the tape-form
    window kernel: A random rows (every op code and op -1, half copying some
    node's prefix word and string hash), L windows of up to W rows (a
    quarter ending at row A-1, the last one overrunning it), and node
    locations drawn from -1..-4 and 0..L-1."""
    nodes = _node_cols(rng, pool, n, ntype=rng.integers(-1, 8, n))
    src = rng.integers(0, n, a)
    same = rng.random(a) < 0.5
    tape = {
        "op": rng.integers(-1, 19, a),
        "f0": rng.choice([0.0, 0.01, 0.5, 2.0, -3.0], a),
        "i0": rng.integers(-3, 40, a),
        "i1": rng.integers(0, 2, a),
        "u0": np.where(same, nodes["str_prefix"][src, 0], rng.integers(
            0, 2**32, a, dtype=np.uint64).astype(np.uint32)).astype(np.uint32),
        "u1": rng.integers(0, 2**32, a, dtype=np.uint64).astype(np.uint32),
        "hash": np.where(same[:, None], nodes["str_hash"][src],
                         pool[rng.integers(0, len(pool), a)]),
    }
    length = np.minimum(rng.integers(0, w + 1, n_loc), a)
    start = rng.integers(0, a - length + 1)
    start[: n_loc // 4] = a - length[: n_loc // 4]
    start[-1], length[-1] = a - 1, min(w, 3)
    tape["start"], tape["len"] = start, length
    loc = rng.choice(np.r_[[-1, -2, -3, -4], np.arange(n_loc)], n)
    return _to_cuda(nodes), _to_cuda({"loc": loc})["loc"], _to_cuda(tape)


def pad_tape(tape: Dict[str, torch.Tensor], rows: int) -> Dict[str, torch.Tensor]:
    """The tape with ``rows`` op -1 rows appended: no window reads them."""
    out = {}
    for k, v in tape.items():
        if k in ("start", "len"):
            out[k] = v
        else:
            pad = torch.full((rows,) + tuple(v.shape[1:]), -1 if k == "op" else 0,
                             dtype=v.dtype, device=v.device)
            out[k] = torch.cat([v, pad])
    return out


def adversarial_cases() -> int:
    """Small edge cases for the three kernels; returns the number checked."""
    from repro_torch.core.tape import AOP
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval import assertion_eval_cuda
    from repro_torch.kernels.assertion_eval_window import (
        assertion_eval_window_cuda,
        assertion_eval_window_tape_cuda,
    )
    from repro_torch.kernels.hash_match import hash_match_cuda

    rng = np.random.default_rng(SEED)
    pool = _key_pool()
    count = 0
    # hash_match: N not a multiple of a block's 256 queries, M above the
    # kernel's 1024 rows in shared memory, table owners drawn from
    # {-1, -9, 0..3} (owner -1 matches owner -1), query owners from {-1, 0..3}
    for n, m in [(1, 1), (7, 5), (300, 130), (1000, 600), (4097, 257), (1023, 1024),
                 (1025, 1025), (3, 1100), (5000, 2500), (70_001, 20)]:
        q = _lanes(rng, n, pool)
        t = _lanes(rng, m, pool)
        q_owner = torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32)).cuda()
        t_owner = torch.from_numpy(rng.choice([-1, -9, 0, 1, 2, 3], m).astype(np.int32)).cuda()
        _check_equal(f"hash_match n={n} m={m}", hash_match_cuda(q, q_owner, t, t_owner),
                     ref.hash_match_ref(q, q_owner, t, t_owner))
        count += 1
    # first match wins among duplicate rows
    q = _lanes(rng, 1, pool)
    t = q.repeat(3, 1).contiguous()
    zero1, zero3 = torch.zeros(1, dtype=torch.int32).cuda(), torch.zeros(3, dtype=torch.int32).cuda()
    got = hash_match_cuda(q, zero1, t, zero3)
    _check_equal("hash_match first match", got, ref.hash_match_ref(q, zero1, t, zero3))
    if got.item() != 0:
        raise AssertionError("hash_match: duplicate rows must give the least row")
    count += 1
    # duplicate lanes under interleaved owners, with copies on both sides
    # of a 1024-row staging chunk: each query's answer is its least row
    # that carries its owner
    q = _lanes(rng, 4, pool)
    t = _lanes(rng, 2100, pool)
    t_owner = torch.from_numpy(rng.choice([-1, -9, 0, 1], 2100).astype(np.int32)).cuda()
    q_owner = torch.tensor([-1, 0, 1, 2], dtype=torch.int32).cuda()
    for row in (5, 6, 700, 1023, 1024, 2099):
        t[row] = q[row % 4]
    got = hash_match_cuda(q, q_owner, t, t_owner)
    _check_equal("hash_match duplicate rows, owners interleaved", got,
                 ref.hash_match_ref(q, q_owner, t, t_owner))
    count += 1

    # assertion_eval_window: all 19 ops plus op -1, with the edges of
    # NUM_MULTIPLE (quotients at the 0.25 / 1e-6 tolerance), STR_PREFIX
    # (i0 from -2 to 12) and OBJ_HAS_SLOT (shifts outside 0..31)
    def case(n: int, w: int, ops, f0=None, i0=None, num=None, ntype=None):
        nodes = _node_cols(rng, pool, n, num=num, ntype=ntype)
        win = {
            "op": rng.choice(np.asarray(ops), (n, w)),
            "f0": f0 if f0 is not None else rng.normal(0, 5, (n, w)),
            "i0": i0 if i0 is not None else rng.integers(-2, 40, (n, w)),
            "i1": rng.integers(0, 2, (n, w)),
            "u0": rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
            "u1": rng.integers(0, 2**32, (n, w), dtype=np.uint64).astype(np.uint32),
            "hash": pool[rng.integers(0, len(pool), (n, w))],
        }
        # half the prefixes / hashes copied from the node so equality paths fire
        same = rng.random((n, w)) < 0.5
        win["u0"] = np.where(same, nodes["str_prefix"][:, :1], win["u0"])
        win["hash"] = np.where(same[..., None], nodes["str_hash"][:, None, :], win["hash"])
        nd, wd = _to_cuda(nodes), _to_cuda(win)
        _check_equal(f"assertion_eval_window n={n} w={w} ops={list(ops)[:3]}...",
                     assertion_eval_window_cuda(nd, wd), ref.assertion_eval_window_ref(nd, wd))

    all_ops = list(range(-1, 19))
    for n, w in [(1, 1), (37, 3), (1000, 7), (4099, 8), (300, 70)]:
        case(n, w, all_ops)
        count += 1
    # NUM_MULTIPLE at the tolerance edges: num = (k + eps) * f0
    n, w = 4096, 4
    f0 = rng.choice([0.01, 0.1, 0.5, 1.0, 2.0, 3.0, 0.0, 1e-3, 7.5], (n, w))
    k = rng.integers(-600000, 600000, (n, 1)).astype(np.float64)
    eps = rng.choice([0.0, 1e-7, 5e-7, 1e-6, 2e-6, 0.25, 0.2499, 0.2501, 0.5], (n, 1))
    case(n, w, [AOP.NUM_MULTIPLE], f0=f0, num=(k * f0[:, :1] + eps * f0[:, :1])[:, 0],
         ntype=np.full(n, 3))
    count += 1
    # STR_PREFIX with i0 from -2 to 12 on string nodes
    case(n, w, [AOP.STR_PREFIX], i0=rng.integers(-2, 13, (n, w)), ntype=np.full(n, 4))
    count += 1
    # OBJ_HAS_SLOT and TYPE_MASK with shifts outside 0..31
    case(n, w, [AOP.OBJ_HAS_SLOT, AOP.TYPE_MASK], i0=rng.integers(-40, 80, (n, w)),
         ntype=rng.integers(-2, 40, n))
    count += 1

    # assertion_eval_window on the tape itself (the executor's form), both
    # ways the kernel reads rows: staged in shared memory (A <= 512) and in
    # place.  Locations -1..-4 (no window), windows of length 0, windows
    # ending at row A-1 and one overrunning it (clamped), W = 1, 6, 8, 33 and
    # 70 (two passes of 64 slots), N not a multiple of a block's 256 nodes;
    # each tape also padded with op -1 rows past 512, which moves it to the
    # in-place path (only the overrunning window then reads other rows)
    for n, n_loc, a, w in [(1, 1, 1, 1), (257, 5, 1, 6), (4099, 27, 68, 6),
                           (1000, 60, 511, 8), (1001, 60, 512, 8), (999, 60, 513, 33),
                           (255, 9, 100, 70), (70_001, 200, 50_000, 6), (300, 40, 3000, 70)]:
        nd, loc, tape = window_tape_case(rng, pool, n, n_loc, a, w)
        want = ref.assertion_eval_window_tape_ref(loc, nd, tape, w)
        _check_equal(f"assertion_eval_window (tape) n={n} L={n_loc} A={a} w={w}",
                     assertion_eval_window_tape_cuda(loc, nd, tape, w), want)
        if a <= 512:
            padded = pad_tape(tape, 600)
            _check_equal(f"assertion_eval_window (tape padded past 512 rows) n={n} A={a} w={w}",
                         assertion_eval_window_tape_cuda(loc, nd, padded, w),
                         ref.assertion_eval_window_tape_ref(loc, nd, padded, w))
        count += 1 + (a <= 512)

    # assertion_eval (dense): N and A around the 256-node tile and the
    # 128-row staging capacity, N * A leaving unaligned 16-byte ends, every
    # op code and op -1 rows, op sets that load some node columns and not
    # others (per row tile), f0 = 0, prefix lengths and shifts outside 0..31
    def dense_case(n: int, a: int, ops, f0=None, i0=None, num=None, ntype=None, op=None):
        nodes = _node_cols(rng, pool, n, num=num, ntype=ntype)
        src = rng.integers(0, n, a)  # half the rows copy a node's prefix / hash
        same = rng.random(a) < 0.5
        rows = {
            "op": op if op is not None else rng.choice(np.asarray(ops), a),
            "f0": f0 if f0 is not None else rng.choice([0.0, 0.01, 0.5, 2.0, -3.0], a),
            "i0": i0 if i0 is not None else rng.integers(-2, 40, a),
            "i1": rng.integers(0, 2, a),
            "u0": np.where(same, nodes["str_prefix"][src, 0], rng.integers(
                0, 2**32, a, dtype=np.uint64).astype(np.uint32)).astype(np.uint32),
            "u1": rng.integers(0, 2**32, a, dtype=np.uint64).astype(np.uint32),
            "hash": np.where(same[:, None], nodes["str_hash"][src],
                             pool[rng.integers(0, len(pool), a)]),
        }
        nd, rd = _to_cuda(nodes), _to_cuda(rows)
        _check_equal(f"assertion_eval n={n} a={a} ops={list(ops)[:3]}...",
                     assertion_eval_cuda(nd, rd), ref.assertion_eval_ref(nd, rd))

    for n, a in [(1, 1), (257, 1), (255, 15), (1001, 16), (3, 17), (4099, 26), (513, 129),
                 (33, 4099), (1, 255), (255, 257), (257, 255), (4099, 1), (65, 129), (3, 300),
                 (70_001, 29)]:
        dense_case(n, a, all_ops)
        count += 1
    dense_case(1001, 26, [-1])  # no live row: nothing but the zeros
    dense_case(1001, 26, [AOP.STR_EQ, AOP.STR_EQ_PRE, -1])  # hash lanes only
    # two row tiles reading different node columns
    num_ops = [AOP.NUM_GE, AOP.NUM_MULTIPLE, AOP.CONST_NUM]
    str_ops = [AOP.STR_EQ, AOP.STR_PREFIX, AOP.OBJ_HAS_SLOT]
    dense_case(517, 200, num_ops + str_ops, op=np.where(
        np.arange(200) < 128, rng.choice(num_ops, 200), rng.choice(str_ops, 200)))
    count += 3
    n = 4096
    f0 = rng.choice([0.01, 0.1, 0.5, 1.0, 2.0, 3.0, 0.0, 1e-3, 7.5], 64)
    k = rng.integers(-600000, 600000, n).astype(np.float64)
    eps = rng.choice([0.0, 1e-7, 5e-7, 1e-6, 2e-6, 0.25, 0.2499, 0.2501, 0.5], n)
    dense_case(n, 64, [AOP.NUM_MULTIPLE], f0=f0, num=(k + eps) * rng.choice(f0[f0 != 0], n),
               ntype=np.full(n, 3))
    dense_case(n, 64, [AOP.STR_PREFIX], i0=rng.integers(-2, 13, 64), ntype=np.full(n, 4))
    dense_case(n, 64, [AOP.OBJ_HAS_SLOT, AOP.TYPE_MASK], i0=rng.integers(-40, 80, 64),
               ntype=rng.integers(-2, 40, n))
    count += 3
    return count


# each kernel's entry point in kernels/ops.py on the executor's paths, and
# the position of its node columns among the entry's arguments
ENTRIES = {"hash_match": ("hash_match", None),
           "assertion_eval_window": ("assertion_eval_window_tape", 1),
           "assertion_eval": ("assertion_eval", 0)}
KERNELS = tuple(ENTRIES)


def capture_kernel_inputs(run: Callable[[], Any]) -> Dict[str, List[tuple]]:
    """The exact inputs ``run()`` gives each kernel entry point, per call."""
    from repro_torch.kernels import ops

    captured: Dict[str, List[tuple]] = {name: [] for name in KERNELS}
    originals = {name: getattr(ops, entry) for name, (entry, _) in ENTRIES.items()}

    def recorder(name):
        node_arg = ENTRIES[name][1]

        def record(*args):
            if node_arg is not None:
                args = list(args)
                args[node_arg] = ops._with_acquired(args[node_arg])
                args = tuple(args)
            captured[name].append(args)
            return originals[name](*args)
        return record

    for name, (entry, _) in ENTRIES.items():
        setattr(ops, entry, recorder(name))
    try:
        run()
    finally:
        for name, (entry, _) in ENTRIES.items():
            setattr(ops, entry, originals[name])
    return captured


def capture_main_inputs(bv, table, ids) -> Dict[str, tuple]:
    """The exact inputs one main-path launch gives each kernel."""
    captured = capture_kernel_inputs(lambda: bv.validate_ex(table, ids))
    return {name: calls[-1] for name, calls in captured.items() if calls}


def hold_captured(captured: Dict[str, List[tuple]], where: str) -> Dict[str, int]:
    """Every captured kernel call against its plain version; the calls
    checked, by kernel."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval import assertion_eval_cuda
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda
    from repro_torch.kernels.hash_match import hash_match_cuda

    pairs = {"hash_match": (hash_match_cuda, ref.hash_match_ref),
             "assertion_eval_window": (assertion_eval_window_tape_cuda,
                                       ref.assertion_eval_window_tape_ref),
             "assertion_eval": (assertion_eval_cuda, ref.assertion_eval_ref)}
    for name, calls in captured.items():
        kernel, plain = pairs[name]
        for args in calls:
            _check_equal(f"{name} in {where}", kernel(*args), plain(*args))
    return {name: len(calls) for name, calls in captured.items()}


def launch_counts() -> Dict[str, int]:
    from repro_torch.kernels import assertion_eval, assertion_eval_window, hash_match

    return {"hash_match": hash_match.launches,
            "assertion_eval_window": assertion_eval_window.launches,
            "assertion_eval": assertion_eval.launches}


def zero_launch_counts() -> None:
    from repro_torch.kernels import assertion_eval, assertion_eval_window, hash_match

    hash_match.launches = assertion_eval_window.launches = assertion_eval.launches = 0


def column_readers() -> Tuple[Tuple[int, set], ...]:
    """(bytes a node, the ops that read the column), as both assertion
    kernels load them (``load_node`` in csrc/eval_row.cuh): type, is_int,
    num, size, acquired, prefix, hash."""
    from repro_torch.core.tape import AOP

    return (
        (4, set(range(19))),
        (4, {AOP.TYPE_MASK}),
        (4, {AOP.NUM_GE, AOP.NUM_GT, AOP.NUM_LE, AOP.NUM_LT, AOP.NUM_MULTIPLE,
             AOP.CONST_BOOL, AOP.CONST_NUM}),
        (4, {AOP.STR_MINLEN, AOP.STR_MAXLEN, AOP.ARR_MINLEN, AOP.ARR_MAXLEN,
             AOP.OBJ_MINPROPS, AOP.OBJ_MAXPROPS, AOP.STR_PREFIX}),
        (4, {AOP.OBJ_HAS_SLOT}),
        (8, {AOP.STR_PREFIX}),
        (32, {AOP.STR_EQ, AOP.STR_EQ_PRE}),
    )


def _hash_match_work(args, got) -> Tuple[int, int]:
    """(bytes, operations) that hash_match needs on these inputs."""
    q_lanes, q_owner, t_lanes, t_owner = args
    n, m = q_lanes.shape[0], t_lanes.shape[0]
    # bytes: every owner and output word and the table once; the 32 lane
    # bytes of a query only where its owner occurs among the table's owners
    occurs = int(torch.isin(q_owner, t_owner).sum().item())
    nbytes = 4 * n + 32 * occurs + 36 * m + 4 * n
    # operations: one owner compare per row scanned (up to the first full
    # match, row `got`, or over all M rows) and eight lane compares for each
    # scanned row with the query's owner
    stop = torch.where(got >= 0, got + 1, m)
    scanned = torch.arange(m, device=got.device)[None, :] < stop[:, None]
    owner_eq = q_owner[:, None] == t_owner[None, :]
    nops = int(stop.sum().item()) + 8 * int((scanned & owner_eq).sum().item())
    return nbytes, nops


def hash_match_at_main(args) -> Dict[str, Any]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.hash_match import hash_match_cuda

    n, m = args[0].shape[0], args[2].shape[0]
    got = hash_match_cuda(*args)
    err = _check_equal("hash_match at the main path's inputs", got, ref.hash_match_ref(*args))
    nbytes, nops = _hash_match_work(args, got)
    times = kernel_times(lambda: hash_match_cuda(*args), lambda: ref.hash_match_ref(*args),
                         "hash_match_kernel")
    return _kernel_row("hash_match", "src/repro/kernels/hash_match.py:78",
                       "src/repro_torch/csrc/hash_match.cu", err, times,
                       nbytes, nops, f"N={n} M={m}")


def hash_match_at_dense(calls) -> Dict[str, Any]:
    """hash_match timed at one dense admission's largest call: among the
    calls (one per depth iteration and link group, each already held
    against the plain version in ``registry_phase``) of the largest shape
    N x M, the one whose queries load the most lanes."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.hash_match import hash_match_cuda

    def size(args):
        return (args[0].shape[0] * args[2].shape[0],
                int(torch.isin(args[1], args[3]).sum().item()))

    args = max(calls, key=size)
    n, m = args[0].shape[0], args[2].shape[0]
    got = hash_match_cuda(*args)
    err = _check_equal("hash_match at the dense admission's largest call", got,
                       ref.hash_match_ref(*args))
    nbytes, nops = _hash_match_work(args, got)
    times = kernel_times(lambda: hash_match_cuda(*args), lambda: ref.hash_match_ref(*args),
                         "hash_match_kernel")
    row = _kernel_row("hash_match", "src/repro/kernels/hash_match.py:78",
                      "src/repro_torch/csrc/hash_match.cu", err, times, nbytes, nops,
                      f"N={n} M={m}, {size(args)[1]} queries with a table owner, "
                      f"{len(calls)} calls checked", where="the dense admission's largest call")
    return {k: row[k] for k in ("shape", "ms", "plain_ms", "profiler_ms", "bound_ms",
                                "bound_by", "max_abs_err", "bytes", "ops")}


def _window_work(args) -> Tuple[int, int]:
    """(bytes, operations) that the tape-form window kernel needs on these
    inputs: 4 B of loc a node, each location's start and length (8 B) and
    each tape row's 56 B once, the node columns that each node's live
    window ops read (as csrc/assertion_eval_window.cu loads them), one
    output byte a slot; about ten operations a live slot."""
    from repro_torch.kernels import ref

    loc, node_cols, tape_cols, w = args
    n, n_loc, a = loc.shape[0], tape_cols["start"].shape[0], tape_cols["op"].shape[0]
    ops = ref.gather_windows(loc, tape_cols, w)["op"]  # -1 outside live windows
    live = (ops >= 0) & (ops <= 18)
    node_bytes = 0
    for width, readers in column_readers():
        reads = torch.isin(ops, torch.tensor(sorted(readers), device=ops.device)) & live
        node_bytes += width * int(reads.any(dim=1).sum().item())
    nbytes = 4 * n + 8 * n_loc + 56 * a + node_bytes + n * w
    return nbytes, 10 * int(live.sum().item())


def assertion_eval_window_at_main(args) -> Dict[str, Any]:
    """The tape-form window kernel at one main-path launch's inputs: held
    against its plain version with its rows staged (A <= 512) and read in
    place (the same tape padded past 512 rows), both timed, and the parent
    design's stage beside it: the (N, W[, 8]) operand gathers that the
    kernel replaced."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda

    loc, node_cols, tape_cols, w = args
    n, a = loc.shape[0], tape_cols["op"].shape[0]
    want = ref.assertion_eval_window_tape_ref(*args)
    err = _check_equal("assertion_eval_window at the main path's inputs",
                       assertion_eval_window_tape_cuda(*args), want)
    padded = pad_tape(tape_cols, 600)
    _check_equal("assertion_eval_window at the main path's inputs, rows read in place",
                 assertion_eval_window_tape_cuda(loc, node_cols, padded, w), want)
    nbytes, nops = _window_work(args)
    times = kernel_times(lambda: assertion_eval_window_tape_cuda(*args),
                         lambda: ref.assertion_eval_window_tape_ref(*args),
                         "assertion_eval_window_kernel")
    row = _kernel_row("assertion_eval_window", "src/repro/kernels/assertion_eval.py:350",
                      "src/repro_torch/csrc/assertion_eval_window.cu", err, times,
                      nbytes, nops, f"N={n} W={w} A={a} L={tape_cols['start'].shape[0]}")
    row["in_place_ms"] = device_ms(
        lambda: assertion_eval_window_tape_cuda(loc, node_cols, padded, w))
    row["gather_ms"] = device_ms(lambda: ref.gather_windows(loc, tape_cols, w))
    print(f"[kernels] assertion_eval_window with the tape's {a + 600} rows read in place: "
          f"{row['in_place_ms']:.4f} ms; the gathers the kernel replaced "
          f"(ref.gather_windows): {row['gather_ms']:.4f} ms")
    return row


def assertion_eval_window_at_admission(calls) -> Dict[str, Any]:
    """Every window call of one csr registry admission against the plain
    version; the largest call (by N x W) is timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda

    err = 0.0
    for args in calls:
        err = max(err, _check_equal("assertion_eval_window in csr admission",
                                    assertion_eval_window_tape_cuda(*args),
                                    ref.assertion_eval_window_tape_ref(*args)))
    args = max(calls, key=lambda c: c[0].shape[0] * c[3])
    nbytes, nops = _window_work(args)
    times = kernel_times(lambda: assertion_eval_window_tape_cuda(*args),
                         lambda: ref.assertion_eval_window_tape_ref(*args),
                         "assertion_eval_window_kernel")
    row = _kernel_row("assertion_eval_window", "src/repro/kernels/assertion_eval.py:350",
                      "src/repro_torch/csrc/assertion_eval_window.cu", err, times, nbytes, nops,
                      f"N={args[0].shape[0]} W={args[3]} A={args[2]['op'].shape[0]}, "
                      f"{len(calls)} calls checked", where="the csr admission's largest call")
    return {k: row[k] for k in ("shape", "ms", "plain_ms", "profiler_ms", "bound_ms",
                                "bound_by", "max_abs_err", "bytes", "ops")}


def assertion_eval_at_main(calls) -> Dict[str, Any]:
    """Every dense call of one registry admission against the plain version;
    the largest call (by N x A) is timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval import assertion_eval_cuda

    err = 0.0
    for node_cols, asrt_cols in calls:
        err = max(err, _check_equal(
            "assertion_eval at the dense admission's inputs",
            assertion_eval_cuda(node_cols, asrt_cols), ref.assertion_eval_ref(node_cols, asrt_cols)))
    node_cols, asrt_cols = max(
        calls, key=lambda c: c[0]["type"].shape[0] * c[1]["op"].shape[0])
    n, a = node_cols["type"].shape[0], asrt_cols["op"].shape[0]
    # bytes: each output byte written once, each row's 56 operand bytes and
    # each node column that some row's op reads, once
    ops = set(asrt_cols["op"].tolist())
    node_bytes = sum(width for width, readers in column_readers() if ops & readers)
    nbytes = n * a + node_bytes * n + 56 * a
    # operations: about ten per element of a live row (op >= 0)
    nops = 10 * n * int((asrt_cols["op"] >= 0).sum().item())
    times = kernel_times(lambda: assertion_eval_cuda(node_cols, asrt_cols),
                         lambda: ref.assertion_eval_ref(node_cols, asrt_cols),
                         "assertion_eval_kernel")
    return _kernel_row("assertion_eval", "src/repro/kernels/assertion_eval.py:227",
                       "src/repro_torch/csrc/assertion_eval.cu", err, times,
                       nbytes, nops, f"N={n} A={a}, {len(calls)} calls checked",
                       where="the dense admission's largest call")


def _kernel_row(name, replaces, source, err, times, nbytes, nops, shape,
                where="the main path's inputs"):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / CUDA_CORE_OPS_PER_S * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    prof = times["profiler_ms"]
    print(f"[kernels] {name} at {where} ({shape}): equal; kernel "
          f"{times['ms']:.4f} ms (profiler: "
          f"{'not measured' if prof is None else f'{prof:.4f} ms'}), plain "
          f"{times['plain_ms']:.4f} ms, bound "
          f"{bound_ms:.5f} ms by {bound_by} ({nbytes} B at 3.35 TB/s, {nops} ops at 67 T/s)")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, **times,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": shape, "bytes": nbytes, "ops": nops,
    }


def main_path(linked, names, docs, ids, table) -> Dict[str, Any]:
    from repro_torch.core.batch_executor import BatchValidator

    bv = BatchValidator(linked)  # the default device: cuda
    bv.validate_ex(table, ids)  # first launch under this shape (allocator growth)
    torch.cuda.synchronize()

    zero_launch_counts()
    times = []
    results = []
    for _ in range(TIMED_LAUNCHES):
        t0 = time.perf_counter()
        results.append(bv.validate_ex(table, ids))
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    want = {"hash_match": TIMED_LAUNCHES, "assertion_eval_window": TIMED_LAUNCHES,
            "assertion_eval": 0}
    if launches != want:
        raise AssertionError(f"launches in {TIMED_LAUNCHES} batches: {launches}, want {want}")
    valid, decided, frontier = results[0]
    for v, d, f in results[1:]:
        if not (np.array_equal(v, valid) and np.array_equal(d, decided)
                and np.array_equal(f, frontier)):
            raise AssertionError("repeated launches disagree")

    cpu = BatchValidator(linked, device="cpu").validate_ex(table, ids)
    for what, a, b in zip(("valid", "decided", "frontier"), (valid, decided, frontier), cpu):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: GPU run differs from the CPU run in "
                                 f"{int((a != b).sum())} rows")
    oracle = oracle_verdicts(names, docs, ids)
    wrong = int((oracle[decided] != valid[decided]).sum())
    if wrong:
        raise AssertionError(f"{wrong} decided verdicts differ from the sequential Validator")
    if not decided.any():
        raise AssertionError("no document was decided on the batched path")

    launch_ms = statistics.median(times) * 1e3
    return {
        "bv": bv,
        "oracle": oracle,
        "valid": valid, "decided": decided, "frontier": frontier,
        "launches": launches,
        "launch_ms": launch_ms,
        "docs_per_s": len(docs) / (launch_ms / 1e3),
        "decided_share": float(decided.mean()),
        "valid_share_of_decided": float(valid[decided].mean()),
    }


def isolation(bv, table, ids, clean) -> int:
    """Inject a launch fault for one row; returns the poisoned row."""
    from repro_torch.core import InjectedFault, set_fault_hook

    poison = len(ids) // 3

    def hook(point, key):
        if point == "launch" and poison in key:
            raise InjectedFault(f"poisoned row {poison}")

    prev = set_fault_hook(hook)
    try:
        valid, decided, frontier, errors = bv.validate_isolated(table, ids)
    finally:
        set_fault_hook(prev)
    if set(errors) != {poison}:
        raise AssertionError(f"fault not cornered: errors at rows {sorted(errors)}")
    keep = np.ones(len(ids), bool)
    keep[poison] = False
    for what, a, b in zip(("valid", "decided", "frontier"), (valid, decided, frontier), clean):
        if not np.array_equal(a[keep], b[keep]):
            raise AssertionError(f"isolation changed {what} of unpoisoned rows")
    if decided[poison]:
        raise AssertionError("the poisoned row must not be decided")
    return poison


def host_phases(run: Callable[[], Any], tag: str, reps: int = 5) -> Dict[str, float]:
    """Host milliseconds per call of ``run`` in each profiled phase
    (``obs.profile``, exclusive times).  For an executor launch the phases
    are the dispatch cost of the eager launch, stage by stage, and
    ``executor.sync`` is the wait for the device at the end."""
    from repro_torch.obs.profile import Profiler

    with Profiler() as prof:
        for _ in range(reps):
            run()
    out = {name: st.self_ns / reps / 1e6 for name, st in prof.stats().items()}
    print(f"[{tag}] per call, host ms by phase: " + ", ".join(
        f"{name} {ms:.3f}" for name, ms in sorted(out.items(), key=lambda kv: -kv[1])))
    return out


def profile(run: Callable[[], Any], tag: str, warm: bool = True) -> Dict[str, Any]:
    """One call of ``run`` under torch.profiler (after one unprofiled call
    unless ``warm`` is false): device-busy time and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    if warm:
        run()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels and copies): the CPU-side aten ops
    # carry their children's device time too and would count it twice
    rows = [
        (ev.self_device_time_total / 1e3, ev.count, ev.key)
        for ev in prof.key_averages()
        if ev.device_type != DeviceType.CPU and ev.self_device_time_total > 0
    ]
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    calls = sum(r[1] for r in rows)
    copy_ms = sum(r[0] for r in rows if "Memcpy" in r[2])
    if busy_ms <= 0:
        print(f"[{tag}] the profiler recorded no device time: device busy share not measured")
    else:
        print(f"[{tag}] one call under the profiler: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of the wall), {calls} device "
              f"kernels and copies, of which copies {copy_ms:.3f} ms")
        for ms, count, key in rows[:10]:
            print(f"[{tag}]   {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    # the port's own kernels, by their CUDA function names
    ours = {}
    for name in KERNELS:
        hits = [r for r in rows if re.search(rf"\b{name}_kernel\b", r[2])]
        ours[name] = {"ms": sum(r[0] for r in hits), "calls": sum(r[1] for r in hits)}
    if busy_ms > 0:
        print(f"[{tag}] the port's kernels: " + ", ".join(
            f"{name} {v['ms']:.4f} ms in {v['calls']} calls "
            f"({100 * v['ms'] / busy_ms:.1f}% of device busy)" for name, v in ours.items()))
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_calls": calls,
            "copy_ms": copy_ms, "kernels": ours}


def admission_controller(layout: str, device=None, schemas=None):
    """An ``AdmissionController`` over a registry of ``schemas`` by endpoint
    (the five gateway endpoints unless given; analysis and link grouping
    on, as a user builds it)."""
    from repro_torch.data.pipeline import AdmissionController
    from repro_torch.registry import SchemaRegistry
    from repro_torch.registry.presets import GATEWAY_SCHEMAS

    schemas = GATEWAY_SCHEMAS if schemas is None else schemas
    registry = SchemaRegistry(layout=layout, device=device)
    for name, schema in schemas.items():
        registry.register(name, schema)
    return AdmissionController(registry=registry, endpoint=next(iter(schemas)),
                               batch_max_nodes=MAX_NODES)


def _verdict_rows(verdicts) -> List[tuple]:
    return [(v.outcome.name, v.valid, v.engine) for v in verdicts]


def registry_phase(layout: str, docs, endpoints, oracle, schemas=None,
                   tag: str = "registry") -> Dict[str, Any]:
    """Registry admission of a mix in one executor layout, over a registry of
    ``schemas`` (the gateway's unless given); returns (besides the numbers)
    every kernel input of its first call."""
    ctrl = admission_controller(layout, schemas=schemas)  # the default device: cuda
    reg = ctrl.registry
    # first call per batch shape (allocator growth), with every kernel call
    # held against its plain version
    captured = capture_kernel_inputs(lambda: ctrl.admit_ex(docs, endpoints))
    checked = hold_captured(captured, f"{tag} {layout} admission")
    torch.cuda.synchronize()

    before = ctrl.stats.snapshot()
    zero_launch_counts()
    times, results = [], []
    for _ in range(TIMED_LAUNCHES):
        t0 = time.perf_counter()
        results.append(ctrl.admit_ex(docs, endpoints))
        times.append(time.perf_counter() - t0)
    launches = launch_counts()
    after = ctrl.stats.snapshot()
    # the AdmitCounts of one call, from the controller's counters over the
    # timed calls (PipelineStats sums every AdmitCounts field it receives)
    counts = {f: int(after[f] - before[f]) // TIMED_LAUNCHES for f in ADMIT_COUNT_FIELDS}
    # the link groups launched (an endpoint outside the batched subset has
    # none: its rows go to the sequential fallback)
    n_groups = len({g.label for g in map(reg.group_of, set(endpoints)) if g is not None})
    per_call = {
        "hash_match": n_groups * (reg.max_depth if layout == "dense" else 1),
        "assertion_eval_window": n_groups if layout == "csr" else 0,
        "assertion_eval": n_groups if layout == "dense" else 0,
    }
    if launches != {k: v * TIMED_LAUNCHES for k, v in per_call.items()}:
        raise AssertionError(f"{tag} {layout} admission: launches {launches} in "
                             f"{TIMED_LAUNCHES} calls, want {per_call} per call")
    verdicts = _verdict_rows(results[0])
    if any(_verdict_rows(r) != verdicts for r in results[1:]):
        raise AssertionError(f"{tag} {layout} admission: repeated calls disagree")
    cpu_ctrl = admission_controller(layout, device="cpu", schemas=schemas)
    cpu = _verdict_rows(cpu_ctrl.admit_ex(docs, endpoints))
    if cpu != verdicts:
        diff = sum(a != b for a, b in zip(cpu, verdicts))
        raise AssertionError(f"{tag} {layout} admission: {diff} verdicts differ from the "
                             "CPU registry")
    cpu_counts = {f: int(cpu_ctrl.stats.snapshot()[f]) for f in ADMIT_COUNT_FIELDS}
    if cpu_counts != counts:
        raise AssertionError(f"{tag} {layout} admission: AdmitCounts {counts}, the CPU "
                             f"registry's {cpu_counts}")
    batched = [i for i, v in enumerate(results[0]) if v.engine == "batched"]
    if not batched:
        raise AssertionError(f"{tag} {layout} admission: no request was decided on the "
                             "batched path")
    wrong = sum(results[0][i].valid != bool(oracle[i]) for i in batched)
    if wrong:
        raise AssertionError(f"{tag} {layout} admission: {wrong} batched verdicts differ "
                             "from the sequential Validator")
    admit_ms = statistics.median(times) * 1e3
    host = host_phases(lambda: ctrl.admit_ex(docs, endpoints), f"{tag} {layout}", reps=3)
    prof = profile(lambda: ctrl.admit_ex(docs, endpoints), f"{tag} {layout}")
    by_group = collections.Counter(getattr(reg.group_of(e), "label", "sequential")
                                   for e in endpoints)
    print(f"[{tag}] layout={layout}: requests by group {dict(sorted(by_group.items()))}; "
          f"median admit_ex {admit_ms:.3f} ms over {TIMED_LAUNCHES} calls of {len(docs)} "
          f"requests, {len(docs) / (admit_ms / 1e3):.0f} requests/s; launches per call "
          f"{ {k: v // TIMED_LAUNCHES for k, v in launches.items()} }; AdmitCounts "
          f"{counts}; verdicts and AdmitCounts equal to the CPU registry and, for the "
          f"{len(batched)} batched verdicts, to the sequential Validator")
    return {"admit_ms": admit_ms, "requests_per_s": len(docs) / (admit_ms / 1e3),
            "launches": launches, "launches_per_call": per_call, "counts": counts,
            "host_ms_by_phase": host, "profile": prof, "kernel_calls_checked": checked,
            "verdicts": verdicts, "captured": captured}


# ---------------------------------------------------------------------------
# phase 13: conformance on the card
# ---------------------------------------------------------------------------

CONFORMANCE_DIR = ROOT / "tests" / "conformance"
# the card's own tests: the cuda-marked kernel and executor tests, and the
# JAX package's executor and registry suites adapted to the card
CUDA_TESTS = ("tests/test_torch_cuda.py", "tests/test_torch_cuda_suites.py")
CUDA_TESTS_TIMEOUT = 480
RUNNER_MAX_DEPTH = 16  # the runner's BatchValidator keeps the default max_depth
LAYOUTS = ("csr", "dense")


def corpus_endpoints() -> Dict[str, dict]:
    """The conformance corpus's groups (schema and tests) by endpoint name
    ``<file stem>.<group index>``, in the runner's file order."""
    groups = {}
    for path in sorted(CONFORMANCE_DIR.glob("*.json")):
        for i, group in enumerate(json.loads(path.read_text())):
            groups[f"{path.stem}.{i}"] = group
    return groups


def corpus_requests(groups, batch: int, seed: int = SEED) -> Tuple[list, List[str], List[bool]]:
    """``batch`` requests, each a uniformly drawn group and then a uniformly
    drawn test of it: (documents, endpoints, the corpus's verdicts)."""
    rng = random.Random(seed)
    names = list(groups)
    docs, endpoints, expected = [], [], []
    for _ in range(batch):
        name = rng.choice(names)
        test = rng.choice(groups[name]["tests"])
        docs.append(test["data"])
        endpoints.append(name)
        expected.append(test["valid"])
    return docs, endpoints, expected


def card_tests() -> Dict[str, Any]:
    """(a) The card's tests as a user runs them: ``pytest -m cuda`` on
    ``CUDA_TESTS`` in one process, the Hypothesis store in a temporary
    directory.  Every test the files collect must run and pass."""
    import xml.etree.ElementTree as ET

    with tempfile.TemporaryDirectory() as tmp:
        xml = Path(tmp) / "cuda.xml"
        argv = [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p", "no:cacheprovider",
                "-p", "no:randomly", f"--junitxml={xml}", *CUDA_TESTS]
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
               "HYPOTHESIS_STORAGE_DIRECTORY": str(Path(tmp) / "hypothesis")}
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True,
                              timeout=CUDA_TESTS_TIMEOUT)
        seconds = time.perf_counter() - t0
        if not xml.exists():
            raise AssertionError(f"pytest -m cuda exited {proc.returncode} without a report: "
                                 f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
        suite = next(ET.parse(xml).getroot().iter("testsuite"))
    n = {k: int(suite.get(k)) for k in ("tests", "skipped", "failures", "errors")}
    passed = n["tests"] - n["skipped"] - n["failures"] - n["errors"]
    summary = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
    if (proc.returncode != 0 or n["tests"] == 0 or passed != n["tests"]
            or "deselected" in summary):
        raise AssertionError(f"pytest -m cuda: exit {proc.returncode}, {n}, '{summary}': "
                             f"{proc.stdout[-3000:]}{proc.stderr[-2000:]}")
    print(f"[conformance] (a) pytest -m cuda {' '.join(CUDA_TESTS)}: exit 0, {passed} passed "
          f"of {n['tests']} collected, 0 skipped, in {seconds:.1f} s")
    return {"argv": argv[1:], "rc": proc.returncode, "passed": passed, "collected": n["tests"],
            "skipped": n["skipped"], "seconds": seconds}


def corpus_runner() -> Dict[str, Any]:
    """(b) The port's conformance runner with its batched engine on the card,
    in both layouts, against the same runner with it on the CPU."""
    from repro_torch.launch.conformance import run_corpus

    out = {}
    for layout in LAYOUTS:
        cpu = run_corpus(device="cpu", layout=layout)
        zero_launch_counts()
        t0 = time.perf_counter()
        got = run_corpus(device="cuda", layout=layout)
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        if got["failures"] or cpu["failures"]:
            raise AssertionError(f"conformance runner, {layout}: failures on the card "
                                 f"{got['failures'][:5]}, on the CPU {cpu['failures'][:5]}")
        if got["totals"] != cpu["totals"] or got["files"] != cpu["files"]:
            raise AssertionError(f"conformance runner, {layout}: the card's totals "
                                 f"{got['totals']} differ from the CPU's {cpu['totals']}")
        batched = got["totals"]["batched"]
        calls = batched["passed"] + batched["failed"]  # one validate call a batched case
        want = {"hash_match": calls * (RUNNER_MAX_DEPTH if layout == "dense" else 1),
                "assertion_eval_window": calls if layout == "csr" else 0,
                "assertion_eval": calls if layout == "dense" else 0}
        if launches != want or not calls:
            raise AssertionError(f"conformance runner, {layout}: launches {launches}, "
                                 f"want {want}")
        print(f"[conformance] (b) runner, {layout}: batched on the card {batched}, equal to "
              f"the CPU run in every file; naive/interpreter/codegen "
              f"{[got['totals'][e]['passed'] for e in ('naive', 'interpreter', 'codegen')]} "
              f"passed; launches {launches}; {seconds:.2f} s")
        out[layout] = {"totals": got["totals"], "launches": launches, "seconds": seconds}
    return out


def corpus_deployment() -> Dict[str, Any]:
    """(c) The corpus's 26 groups as the endpoints of one registry, B
    requests drawn from them admitted in both layouts: every verdict the
    corpus's, the CPU registry's and the other layout's; every kernel call
    of one admission equal to its plain version."""
    groups = corpus_endpoints()
    schemas = {name: group["schema"] for name, group in groups.items()}
    docs, endpoints, expected = corpus_requests(groups, BATCH)
    out, verdicts = {}, {}
    for layout in LAYOUTS:
        row = registry_phase(layout, docs, endpoints, expected, schemas=schemas,
                             tag="conformance")
        verdicts[layout] = row.pop("verdicts")
        wrong = sum(v[1] != want for v, want in zip(verdicts[layout], expected))
        if wrong:
            raise AssertionError(f"conformance deployment, {layout}: {wrong} verdicts differ "
                                 "from the corpus")
        row.pop("captured")
        host = row["host_ms_by_phase"]
        row["fallback_share_of_host"] = host.get("fallback.sequential", 0.0) / sum(host.values())
        print(f"[conformance] (c) {len(schemas)} endpoints, {layout}: median admit_ex "
              f"{row['admit_ms']:.3f} ms for {len(docs)} requests; batched "
              f"{row['counts']['batch_validated']}, fallback "
              f"{row['counts']['fallback_validated']}; the sequential fallback "
              f"{host.get('fallback.sequential', 0.0):.3f} ms, "
              f"{100 * row['fallback_share_of_host']:.1f}% of host ms; every verdict the "
              f"corpus's; kernel calls equal to the plain versions {row['kernel_calls_checked']}")
        out[layout] = row
    if verdicts["csr"] != verdicts["dense"]:
        raise AssertionError("conformance deployment: the csr and dense layouts disagree")
    print("[conformance] (c) the csr and dense layouts give equal verdicts")
    return {"endpoints": len(schemas), "batch": len(docs), "seed": SEED,
            "max_nodes": MAX_NODES, **out}


def conformance_phase(smi: str) -> Dict[str, Any]:
    """Phase 13: (a) the card's pytest run, (b) the conformance runner on the
    card against the CPU, (c) the corpus as a 26-endpoint deployment."""
    t0 = time.perf_counter()
    tests = card_tests()
    runner = corpus_runner()
    deployment = corpus_deployment()
    # the path's launches: the runner's card runs and the deployment's timed
    # admissions, each counted from zero
    launches = {name: sum(runner[lay]["launches"][name] + deployment[lay]["launches"][name]
                          for lay in LAYOUTS) for name in KERNELS}
    seconds = time.perf_counter() - t0
    print(f"[conformance] phase 13: {seconds:.1f} s; launches {launches}")
    return {"card": smi, "tests": tests, "runner": runner, "deployment": deployment,
            "launches": launches, "seconds": seconds}


# ---------------------------------------------------------------------------
# phase 8: serve admission in front of the dense LM
# ---------------------------------------------------------------------------


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _leaves(tree) -> List[torch.Tensor]:
    out = []
    for value in tree.values():
        out += _leaves(value) if isinstance(value, dict) else [value]
    return out


def lm_ops(cfg, params, tokens: int) -> int:
    """Operations of a prefill of ``tokens`` tokens: two a weight a token
    for every matmul weight but the experts, the token table and the head
    (the head and the final norm run on the last position only); each
    expert's weights twice a capacity slot, since the reference's dispatch
    einsums run every expert over its whole capacity."""
    from repro_torch.models import moe as M

    expert = sum(t.numel() for layer in params["stack"].values() if "moe" in layer
                 for name, t in layer["moe"].items() if name in ("w_gate", "w_up", "w_down"))
    emb = params["embedding"]
    untied = emb["head"].numel() if "head" in emb else 0
    head = untied or emb["tokens"].numel()  # a tied head is the token table
    rest = sum(t.numel() for t in _leaves(params)) - expert - emb["tokens"].numel() - untied
    slots = M._capacity(cfg.moe, tokens) if cfg.moe is not None else 0
    return 2 * tokens * rest + 2 * head + 2 * expert * slots


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


class _Timed:
    """Wraps an LM call: host ms of each call, synchronised on both sides,
    and its logits (first element of the result) kept on the host."""

    def __init__(self, fn, device, keep_logits=False):
        self.fn, self.device, self.keep = fn, device, keep_logits
        self.ms: List[float] = []
        self.logits: List[torch.Tensor] = []
        self.cache_len: List[int] = []  # decode_step's index argument
        self.finite = True

    def __call__(self, *args, **kwargs):
        if len(args) > 3:
            self.cache_len.append(int(args[3]))
        _sync(self.device)
        t0 = time.perf_counter()
        out = self.fn(*args, **kwargs)
        _sync(self.device)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        self.finite &= bool(torch.isfinite(out[0]).all())
        if self.keep:
            self.logits.append(out[0].float().cpu())
        return out


def _attach_timers(engine, keep_logits=False) -> Tuple[_Timed, _Timed]:
    prefill = _Timed(engine.model.prefill, engine.device, keep_logits)
    decode = _Timed(engine._decode, engine.device, keep_logits)
    engine.model.prefill = prefill  # the instance attribute shadows the method
    engine._decode = decode
    return prefill, decode


def _submit_rows(results) -> List[tuple]:
    return [(r.request_id, r.error, r.outcome.name) for r in results]


def serve_full_width(cfg, requests, device, steps: int = SERVE_STEPS,
                     explain: bool = False) -> Dict[str, Any]:
    """(a) ``ServeEngine`` with ``cfg`` at its published widths on the card:
    one ``submit_batch`` of ``requests`` (``explain``: with first-failure
    sites) with every kernel call held against its plain version and the
    results against a CPU registry's, then ``steps`` engine steps."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda
    from repro_torch.kernels.hash_match import hash_match_cuda
    from repro_torch.models import Model
    from repro_torch.registry.presets import GATEWAY_SCHEMAS
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.serve.engine import _extract_prompt

    scfg = ServeConfig(batch_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = Model(cfg).init(torch.Generator(device).manual_seed(SEED))
    _sync(device)
    init_s = time.perf_counter() - t0
    leaves = _leaves(params)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    engine = ServeEngine(cfg, params, scfg, endpoint_schemas=GATEWAY_SCHEMAS, device=device)
    prefill, decode = _attach_timers(engine)

    # the burst, with every kernel call captured; the counts are read before
    # the calls are held against their plain versions
    zero_launch_counts()
    results = []
    t0 = time.perf_counter()
    captured = capture_kernel_inputs(
        lambda: results.extend(engine.submit_batch(requests, explain=explain)))
    _sync(device)
    admission_ms = (time.perf_counter() - t0) * 1e3
    launches = launch_counts()
    if launches["hash_match"] < 1 or launches["assertion_eval_window"] < 1:
        raise AssertionError(f"serve admission launched no CSR kernel: {launches}")
    for args in captured["hash_match"]:
        _check_equal("hash_match in serve admission", hash_match_cuda(*args),
                     ref.hash_match_ref(*args))
    for args in captured["assertion_eval_window"]:
        _check_equal("assertion_eval_window in serve admission",
                     assertion_eval_window_tape_cuda(*args),
                     ref.assertion_eval_window_tape_ref(*args))
    # the same burst through a registry on the CPU; admission never runs
    # that engine's LM, so it holds no parameters
    cpu = ServeEngine(cfg, None, scfg, endpoint_schemas=GATEWAY_SCHEMAS, device="cpu")
    want = _submit_rows(cpu.submit_batch(requests, explain=explain))
    got = _submit_rows(results)
    if got != want:
        diff = sum(a != b for a, b in zip(got, want))
        raise AssertionError(f"serve admission: {diff} SubmitResults differ from the CPU registry")
    outcomes = collections.Counter(r[2] for r in got)

    queued = [len(s.tokens) for s in engine.queue]
    longest = max(engine.queue, key=lambda s: len(s.tokens)).tokens
    active = [engine.step() for _ in range(steps)]
    if not (prefill.finite and decode.finite):
        raise AssertionError("serve: non-finite logits")
    if not all(active) or len(decode.ms) != steps:
        raise AssertionError(f"serve: decode steps with active slots {active}")
    # the keys each step's active rows attend to (its index + 1 each), read once
    kv_row = cfg.n_layers * 2 * cfg.n_kv_heads * cfg.head_dim * cfg.dtype().itemsize
    kv_bytes = [kv_row * n * (i + 1) for n, i in zip(active, decode.cache_len)]
    prefill_ms, decode_ms = list(prefill.ms), list(decode.ms)  # before the profiled step

    # the longest admitted prompt's prefill alone, by CUDA events
    tokens = torch.as_tensor([longest], dtype=torch.int32, device=device)
    prefill_alone_ms = device_ms(lambda: Model(cfg).prefill(params, tokens, SERVE_MAX_LEN), reps=5)
    # the decode step's bound: every weight byte but the embedding table's
    # (a step reads only its rows), plus the cache rows the step attends
    emb = params["embedding"]["tokens"]
    weight_bytes = param_bytes - emb.numel() * emb.element_size() + \
        SERVE_SLOTS * emb.shape[1] * emb.element_size()
    # the prefill's bound: the same weight bytes, or its operations on the
    # tensor cores
    prefill_bound_ms = max(weight_bytes / HBM_BYTES_PER_S,
                           lm_ops(cfg, params, len(longest)) / BF16_TENSOR_OPS_PER_S) * 1e3
    step_ms = statistics.median(decode_ms)
    median_kv = statistics.median(kv_bytes)
    bound_ms = (weight_bytes + median_kv) / HBM_BYTES_PER_S * 1e3
    tokens_per_s = sum(active) / (sum(decode_ms) / 1e3)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    # one more step under the profiler: the device's share of an eager step
    step_profile = profile(engine.step, "serve decode step") if device.type == "cuda" else None
    print(f"[serve] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} "
          f"padded to {cfg.padded_vocab}; {cfg.param_count()} parameters by param_count, "
          f"{sum(t.numel() for t in leaves)} tensor elements, {param_bytes} B in "
          f"{cfg.param_dtype}; init {init_s:.2f} s")
    print(f"[serve] submit_batch of {len(requests)} requests"
          f"{' with explain=True' if explain else ''}: {admission_ms:.3f} ms; outcomes "
          f"{dict(sorted(outcomes.items()))}; kernel launches {launches}, every call equal to "
          f"its plain version; SubmitResults equal to the CPU registry's")
    print(f"[serve] {len(queued)} prompts queued ({min(queued)}-{max(queued)} tokens); "
          f"{steps} steps at batch_slots={SERVE_SLOTS}, max_len={SERVE_MAX_LEN}: "
          f"{len(prefill_ms)} prefills {', '.join(f'{ms:.3f}' for ms in prefill_ms)} ms; the "
          f"longest prompt ({len(longest)} tokens) alone {prefill_alone_ms:.3f} ms by CUDA events"
          f" (bound {prefill_bound_ms:.3f} ms)")
    print(f"[serve] decode step median {step_ms:.3f} ms over {len(decode_ms)} steps "
          f"(min {min(decode_ms):.3f}, max {max(decode_ms):.3f}), {tokens_per_s:.1f} tokens/s; "
          f"bound {bound_ms:.3f} ms ({weight_bytes} weight B + {median_kv:.0f} KV-cache B at "
          f"3.35 TB/s), step/bound {step_ms / bound_ms:.2f}; peak memory {peak} B")
    out = {
        "arch": cfg.name, "param_count": cfg.param_count(), "param_bytes": param_bytes,
        "param_dtype": cfg.param_dtype, "init_s": init_s, "burst": len(requests),
        "admission_ms": admission_ms, "outcomes": dict(outcomes), "launches": launches,
        "queued": len(queued), "steps": steps, "batch_slots": SERVE_SLOTS,
        "max_len": SERVE_MAX_LEN, "prefill_ms": prefill_ms,
        "prefill_alone_ms": prefill_alone_ms, "prefill_alone_tokens": len(longest),
        "prefill_bound_ms": prefill_bound_ms,
        "decode_ms": decode_ms, "decode_step_ms": step_ms, "tokens_per_s": tokens_per_s,
        "active_slots": active, "decode_bound_ms": bound_ms, "weight_bytes": weight_bytes,
        "kv_bytes_median": median_kv, "max_memory_allocated": peak,
        "step_profile": step_profile,
        "admitted_prompts": [_extract_prompt(json.loads(body)) for (_, body), r
                             in zip(requests, results) if r.request_id is not None],
    }
    del engine, params, leaves, cpu
    return out


def _cache_check(model, params, tokens: torch.Tensor, vocab: int) -> Tuple[float, bool]:
    """(max |dlogit| / max |logit|, argmax equal) of prefill of L-1 tokens
    then ``decode_step`` of the last at index L-1 against prefill of all L,
    over the real vocabulary (the padded ids are -1e30 in both)."""
    n = tokens.shape[1]
    full, _ = model.prefill(params, tokens, max_len=n)
    _, cache = model.prefill(params, tokens[:, :-1], max_len=n)
    step, _ = model.decode_step(params, tokens[:, -1:], cache, n - 1)
    full, step = full[0, -1, :vocab].double(), step[0, -1, :vocab].double()
    return float((step - full).abs().max() / full.abs().max()), int(full.argmax()) == int(
        step.argmax())


def cache_vs_full(cfg, prompt: List[int], device) -> Dict[str, Any]:
    """(b) Full width in float32: prefill of L-1 tokens then ``decode_step``
    of the last at index L-1 against ``prefill`` of all L tokens."""
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(cfg, param_dtype="float32", activation_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(SEED))
    tokens = torch.as_tensor([prompt], dtype=torch.int32, device=device)
    n = len(prompt)
    ratio, same = _cache_check(model, params, tokens, cfg.vocab_size)
    print(f"[serve] cache path against the full path, {cfg.name} in float32 (TF32 off), "
          f"L={n}: max |dlogit| / max |logit| = {ratio:.3e} (limit {CACHE_REL:.0e}); argmax "
          f"{'equal' if same else 'DIFFERS'}")
    if not (ratio <= CACHE_REL and same):
        raise AssertionError("serve: the cache path disagrees with the full path")
    del params
    return {"L": n, "max_rel_err": ratio, "limit": CACHE_REL, "argmax_equal": same}


def card_vs_cpu(cfg, prompts: List[str], device) -> Dict[str, Any]:
    """(c) A reduced engine in float32 serves the same prompts (without
    max_tokens, so ``default_max_tokens`` holds) on the card and on the CPU,
    from one set of parameters made on the CPU."""
    from repro_torch.models import Model
    from repro_torch.registry.presets import GATEWAY_SCHEMAS
    from repro_torch.serve import ServeConfig, ServeEngine

    cfg = cfg.reduced(param_dtype="float32", activation_dtype="float32")
    params = Model(cfg).init(torch.Generator("cpu").manual_seed(SEED))
    scfg = ServeConfig(batch_slots=2, max_len=256, default_max_tokens=8)
    runs = {}
    for where, p in ((device, _tree_to(params, device)), (torch.device("cpu"), params)):
        engine = ServeEngine(cfg, p, scfg, endpoint_schemas=GATEWAY_SCHEMAS, device=where)
        prefill, decode = _attach_timers(engine, keep_logits=True)
        for prompt in prompts:
            rid, err = engine.submit(json.dumps({"prompt": prompt}))
            if rid is None:
                raise AssertionError(f"serve: card-vs-CPU request rejected: {err}")
        held = list(engine.queue)
        engine.run_until_drained(max_steps=256)
        runs[where.type] = ([s.generated for s in held], prefill.logits + decode.logits)
    (ids, logits), (cpu_ids, cpu_logits) = runs[device.type], runs["cpu"]
    if len(logits) != len(cpu_logits):
        raise AssertionError("serve: card and CPU ran different numbers of LM calls")
    worst = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(logits, cpu_logits))  # the reduced vocab has no padding
    print(f"[serve] card against CPU, reduced {cfg.name} in float32: {len(prompts)} prompts "
          f"({', '.join(str(len(s)) for s in ids)} tokens generated), {len(logits)} LM calls, "
          f"max |dlogit| / max |logit| = {worst:.3e} (limit {CARD_CPU_REL:.0e}); ids "
          f"{'equal' if ids == cpu_ids else 'DIFFER'}")
    if worst > CARD_CPU_REL or ids != cpu_ids:
        raise AssertionError("serve: the card's engine disagrees with the CPU's")
    return {"prompts": len(prompts), "lm_calls": len(logits), "max_rel_err": worst,
            "limit": CARD_CPU_REL, "ids": ids}


def serve_phase(docs, endpoints, smi: str) -> Dict[str, Any]:
    """Phase 8 on the card: (a) the full-width engine, (b) its cache path in
    float32, (c) a reduced engine on the card against the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data import tokenizer

    device = torch.device("cuda")
    cfg = get_config(SERVE_ARCH)
    # the gateway mix as clients send it: (endpoint, request_json) pairs
    requests = [(e, json.dumps(d)) for d, e in zip(docs[:SERVE_BURST], endpoints)]
    full = serve_full_width(cfg, requests, device)
    admitted = [p for p in full.pop("admitted_prompts") if p]
    gc.collect()
    torch.cuda.empty_cache()
    longest = max(admitted, key=len)
    check = cache_vs_full(cfg, tokenizer.encode(longest, eos=False), device)
    gc.collect()
    torch.cuda.empty_cache()
    # the first four admitted prompts of different lengths
    picked: List[str] = []
    for prompt in admitted:
        if len(picked) < 4 and all(len(prompt) != len(q) for q in picked):
            picked.append(prompt)
    cross = card_vs_cpu(cfg, picked, device)
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": smi, **full, "cache_vs_full": check, "card_vs_cpu": cross,
            "longest_prompt": tokenizer.encode(longest, eos=False)}


# ---------------------------------------------------------------------------
# phase 9: batched explain on the CSR path
# ---------------------------------------------------------------------------


def _site(v) -> Any:
    return None if v.site is None else dataclasses.astuple(v.site)


def _explain_rows(verdicts) -> List[tuple]:
    return [(v.outcome.name, v.valid, v.engine, v.reason, _site(v)) for v in verdicts]


def explain_phase(docs, endpoints) -> Dict[str, Any]:
    """Registry admission with ``explain=True`` in the csr layout: every
    kernel call held against its plain version, the sites against a CPU
    registry's and the sequential ``Validator``'s trace, one direct
    ``explain_batch`` call, the dense layout's empty sites, and the cost of
    explain beside the same admission without it."""
    from repro_torch.core.batch_executor import BatchValidator
    from repro_torch.data.doc_table import encode_batch
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda
    from repro_torch.kernels.hash_match import hash_match_cuda

    ctrl = admission_controller("csr")  # the default device: cuda
    reg = ctrl.registry
    results: List[Any] = []
    captured = capture_kernel_inputs(
        lambda: results.extend(ctrl.admit_ex(docs, endpoints, explain=True)))
    for args in captured["hash_match"]:
        _check_equal("hash_match in explain admission", hash_match_cuda(*args),
                     ref.hash_match_ref(*args))
    for args in captured["assertion_eval_window"]:
        _check_equal("assertion_eval_window in explain admission",
                     assertion_eval_window_tape_cuda(*args),
                     ref.assertion_eval_window_tape_ref(*args))
    rows = _explain_rows(results)
    invalid = [i for i, v in enumerate(results) if v.engine == "batched"
               and v.outcome.name == "INVALID"]
    if not invalid:
        raise AssertionError("explain: no batched INVALID verdict in the gateway mix")
    missing = [i for i in invalid if results[i].site is None]
    if missing:
        raise AssertionError(f"explain: {len(missing)} batched INVALID verdicts carry no site "
                             "(the registry swallows an explain_batch failure into empty sites)")
    cpu = _explain_rows(admission_controller("csr", device="cpu").admit_ex(
        docs, endpoints, explain=True))
    if cpu != rows:
        diff = sum(a != b for a, b in zip(cpu, rows))
        raise AssertionError(f"explain: {diff} verdicts or sites differ from the CPU registry")
    unblamed = []
    for i in invalid:
        ok, trace = reg.get(endpoints[i]).validator.explain(docs[i])
        if ok or results[i].site.schema_path not in {path for path, _ in trace}:
            unblamed.append(i)
    if unblamed:
        raise AssertionError(f"explain: {len(unblamed)} sites are not blamed by the sequential "
                             f"trace (first: request {unblamed[0]}, {results[unblamed[0]].site})")
    # one validate launch per link group, one explain launch per group with
    # a batched INVALID row
    n_groups = len({reg.group_of(e).label for e in set(endpoints)})
    groups = {reg.group_of(endpoints[i]).label for i in invalid}
    per_call = {"hash_match": n_groups + len(groups),
                "assertion_eval_window": n_groups + len(groups), "assertion_eval": 0}
    if {k: len(v) for k, v in captured.items()} != per_call:
        raise AssertionError(f"explain admission: kernel calls "
                             f"{ {k: len(v) for k, v in captured.items()} }, want {per_call}")

    # the largest link group's table through explain_batch itself, with no
    # except around it, against the CPU registry's group
    by_group = collections.Counter(reg.group_of(e).label for e in endpoints)
    label = by_group.most_common(1)[0][0]
    group = next(g for g in reg.groups() if g.label == label)
    picked = [i for i, e in enumerate(endpoints) if reg.group_of(e).label == label]
    pad = (1 << (len(picked) - 1).bit_length()) - len(picked)
    group_docs = [docs[i] for i in picked] + [None] * pad
    table = encode_batch(group_docs, max_nodes=MAX_NODES, isolate=True)
    ids = np.asarray([group.member_index[endpoints[i]] for i in picked] + [0] * pad, np.int32)
    zero_launch_counts()
    direct = group.validator.explain_batch(table, ids, docs=group_docs)
    direct_launches = launch_counts()
    cpu_group = BatchValidator(group.tape, device="cpu")
    want = cpu_group.explain_batch(table, ids, docs=group_docs)
    direct_rows = [None if s is None else dataclasses.astuple(s) for s in direct]
    if direct_rows != [None if s is None else dataclasses.astuple(s) for s in want]:
        raise AssertionError("explain_batch on the card differs from the CPU's")
    for j, i in enumerate(picked):
        if i in invalid and direct_rows[j] != rows[i][4]:
            raise AssertionError(f"explain_batch differs from the registry's site of request {i}")
    if direct_launches != {"hash_match": 1, "assertion_eval_window": 1, "assertion_eval": 0}:
        raise AssertionError(f"explain_batch launches {direct_launches}")

    # the dense layout: explain_batch raises there and the registry swallows
    # it, as the reference does -- empty sites, verdicts otherwise unchanged
    dense = admission_controller("dense")
    dense_explained = dense.admit_ex(docs, endpoints, explain=True)
    dense_plain = dense.admit_ex(docs, endpoints)
    if any(v.site is not None for v in dense_explained if v.engine == "batched"):
        raise AssertionError("explain: the dense layout gave a batched site")
    if [r[:4] for r, v in zip(_explain_rows(dense_explained), dense_explained)
            if v.engine == "batched"] != [r[:4] for r, v in zip(
            _explain_rows(dense_plain), dense_plain) if v.engine == "batched"]:
        raise AssertionError("explain: dense verdicts changed under explain=True")

    # cost: explain=True and explain=False alternated, 10 calls each, the
    # flag that goes first swapped from pair to pair so that neither gains
    # from warm host caches; the explain path's launches are counted from 0
    # around each explain call
    times: Dict[bool, List[float]] = {True: [], False: []}
    launches = {k: 0 for k in KERNELS}
    for i in range(TIMED_LAUNCHES):
        for flag in ((True, False) if i % 2 == 0 else (False, True)):
            zero_launch_counts()
            t0 = time.perf_counter()
            ctrl.admit_ex(docs, endpoints, explain=flag)
            times[flag].append((time.perf_counter() - t0) * 1e3)
            if flag:
                launches = {k: launches[k] + v for k, v in launch_counts().items()}
    if launches != {k: v * TIMED_LAUNCHES for k, v in per_call.items()}:
        raise AssertionError(f"explain admission: launches {launches} in {TIMED_LAUNCHES} calls, "
                             f"want {per_call} per call")
    host = host_phases(lambda: ctrl.admit_ex(docs, endpoints, explain=True), "explain", reps=3)
    with_ms, without_ms = statistics.median(times[True]), statistics.median(times[False])
    keywords = collections.Counter(results[i].site.keyword for i in invalid)
    print(f"[explain] csr admission of {len(docs)} requests with explain=True: "
          f"{len(invalid)} batched INVALID verdicts, every one with a site, equal to the CPU "
          f"registry's and blamed by the sequential trace; sites by keyword "
          f"{dict(keywords.most_common())}; kernel calls per call {per_call} (explain launches "
          f"in {len(groups)} groups), every call equal to its plain version")
    print(f"[explain] median admit_ex {with_ms:.3f} ms with explain, {without_ms:.3f} ms without "
          f"({TIMED_LAUNCHES} calls each, alternated): explain adds "
          f"{with_ms - without_ms:.3f} ms; executor.explain {host.get('executor.explain', 0):.3f} "
          f"host ms a call, admit.explain {host.get('admit.explain', 0):.3f}")
    print(f"[explain] explain_batch on group {label} ({len(picked)} requests padded to "
          f"{len(group_docs)}): sites equal to the CPU's and the registry's, launches "
          f"{direct_launches}; dense layout: no batched site, verdicts unchanged")
    return {"invalid": len(invalid), "explain_groups": len(groups), "per_call": per_call,
            "launches": launches, "admit_ms_explain": with_ms, "admit_ms_plain": without_ms,
            "host_ms_by_phase": host, "direct_group": label, "direct_rows": len(group_docs),
            "keywords": dict(keywords)}


# ---------------------------------------------------------------------------
# phase 10: the MoE and SSM families
# ---------------------------------------------------------------------------


def rwkv_full_width(cfg, prompt: List[int], device) -> Dict[str, Any]:
    """(b) rwkv6-3b at its published widths and depth in bf16: prefill of
    each slot's prompt (17, 64, 128 and 64 tokens: lengths the reference's
    chunk rule accepts) through ``Model.prefill``, written into a 4-slot
    cache, then ``FAMILY_STEPS`` greedy ``decode_step``s."""
    from repro_torch.models import Model
    from repro_torch.serve.engine import _write_slot_cache

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(SEED))
    _sync(device)
    init_s = time.perf_counter() - t0
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    cache = model.init_cache(SERVE_SLOTS, SERVE_MAX_LEN, device)
    lengths = RWKV_PROMPTS + RWKV_PROMPTS[1:2]
    prefill_ms, tokens = [], []
    for slot, n in enumerate(lengths):
        ids = torch.as_tensor([prompt[:n]], dtype=torch.int32, device=device)
        _sync(device)
        t0 = time.perf_counter()
        logits, one = model.prefill(params, ids, SERVE_MAX_LEN)
        _sync(device)
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        _write_slot_cache(cache, one, slot)
        tokens.append(int(torch.argmax(logits[0, -1])))
    step_ms, finite = [], True
    for i in range(FAMILY_STEPS):
        tok = torch.as_tensor(tokens, dtype=torch.int32, device=device)[:, None]
        _sync(device)
        t0 = time.perf_counter()
        logits, cache = model.decode_step(params, tok, cache, max(lengths) + i)
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(torch.isfinite(logits).all())
        tokens = [int(t) for t in torch.argmax(logits[:, -1], dim=-1)]
    if not finite:
        raise AssertionError("rwkv6: non-finite logits")
    longest = torch.as_tensor([prompt[: max(lengths)]], dtype=torch.int32, device=device)
    prefill_alone_ms = device_ms(lambda: model.prefill(params, longest, SERVE_MAX_LEN), reps=5)
    emb = params["embedding"]["tokens"]
    weight_bytes = param_bytes - emb.numel() * emb.element_size() + \
        SERVE_SLOTS * emb.shape[1] * emb.element_size()
    state_bytes = 2 * sum(t.numel() * t.element_size() for t in _leaves(cache))  # read, write
    bound_ms = (weight_bytes + state_bytes) / HBM_BYTES_PER_S * 1e3
    prefill_bound_ms = max(weight_bytes / HBM_BYTES_PER_S,
                           lm_ops(cfg, params, max(lengths)) / BF16_TENSOR_OPS_PER_S) * 1e3
    step = statistics.median(step_ms)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    print(f"[family] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_count()} parameters by "
          f"param_count, {param_bytes} B in {cfg.param_dtype}; init {init_s:.2f} s")
    print(f"[family] {cfg.name} prefill of {list(lengths)} tokens: "
          f"{', '.join(f'{ms:.3f}' for ms in prefill_ms)} ms; {max(lengths)} tokens alone "
          f"{prefill_alone_ms:.3f} ms by CUDA events (bound {prefill_bound_ms:.3f} ms); decode "
          f"step median {step:.3f} ms over {FAMILY_STEPS} steps at {SERVE_SLOTS} slots (min "
          f"{min(step_ms):.3f}, max {max(step_ms):.3f}), "
          f"{SERVE_SLOTS * FAMILY_STEPS / (sum(step_ms) / 1e3):.1f} tokens/s; bound "
          f"{bound_ms:.3f} ms ({weight_bytes} weight B + {state_bytes} state B read and "
          f"written at 3.35 TB/s), step/bound {step / bound_ms:.2f}; peak memory {peak} B")
    out = {"arch": cfg.name, "param_count": cfg.param_count(), "param_bytes": param_bytes,
           "init_s": init_s, "prompt_lengths": list(lengths), "prefill_ms": prefill_ms,
           "prefill_alone_ms": prefill_alone_ms, "prefill_bound_ms": prefill_bound_ms,
           "decode_ms": step_ms, "decode_step_ms": step,
           "tokens_per_s": SERVE_SLOTS * FAMILY_STEPS / (sum(step_ms) / 1e3),
           "decode_bound_ms": bound_ms, "weight_bytes": weight_bytes,
           "state_bytes": state_bytes, "max_memory_allocated": peak}
    del params, cache
    return out


def family_cache_checks(prompt: List[int], device) -> Dict[str, Any]:
    """(c) The cache path against the full path in float32 (TF32 off), L=64:
    rwkv6-3b at full width and depth, moonshot at full width with 12 of its
    48 layers.  Each is gated where the reference's decode is consistent
    with its full path (ROADMAP.md sections 3.8 and 3.9): RWKV's channel mix
    without its token shift (``shift_mix`` 0), moonshot routed to one expert
    with room for every token.  The published form is measured beside it."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = torch.as_tensor([prompt[:CACHE_L]], dtype=torch.int32, device=device)
    out = {}
    f32 = dict(param_dtype="float32", activation_dtype="float32")
    for name in (RWKV_ARCH, FAMILY_SERVE_ARCH):
        cfg = dataclasses.replace(get_config(name), **f32)
        if cfg.moe is not None:
            cfg = dataclasses.replace(cfg, n_layers=CACHE_CUT_LAYERS)
        params = Model(cfg).init(torch.Generator(device).manual_seed(SEED))
        published = _cache_check(Model(cfg), params, tokens, cfg.vocab_size)
        if cfg.moe is not None:
            gated_cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, top_k=1, capacity_factor=float(cfg.moe.num_experts)))
            what = "top-1 routing with room for every token"
        else:
            gated_cfg = cfg
            for layer in params["stack"].values():
                layer["cmix"]["shift_mix"].zero_()
            what = "channel-mix shift_mix 0"
        ratio, same = _cache_check(Model(gated_cfg), params, tokens, cfg.vocab_size)
        print(f"[family] cache path against the full path, {name} in float32 (TF32 off), "
              f"{cfg.n_layers} layers, L={CACHE_L}: {what}: max |dlogit| / max |logit| = "
              f"{ratio:.3e} (limit {CACHE_REL:.0e}), argmax {'equal' if same else 'DIFFERS'}; as "
              f"published: {published[0]:.3e}, argmax {'equal' if published[1] else 'differs'} "
              "(not a limit: the reference's decode differs from its full path there)")
        if not (ratio <= CACHE_REL and same):
            raise AssertionError(f"family: {name}'s cache path disagrees with its full path")
        out[name] = {"layers": cfg.n_layers, "L": CACHE_L, "gated": what, "max_rel_err": ratio,
                     "argmax_equal": same, "published_max_rel_err": published[0],
                     "published_argmax_equal": published[1], "limit": CACHE_REL}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return out


def family_card_vs_cpu(name: str, prompt: List[int], device) -> Dict[str, Any]:
    """(d) ``get_config(name).reduced()`` in float32 from one set of
    CPU-made parameters: prefill of two prompts then four greedy decode
    steps on the card and on the CPU; ids equal, logits within
    ``CARD_CPU_REL`` of max |logit|."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model

    cfg = get_config(name).reduced(param_dtype="float32", activation_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(SEED))
    ids = torch.as_tensor([prompt[:17], prompt[17:34]], dtype=torch.int32) % cfg.vocab_size
    runs = {}
    for where in (device, torch.device("cpu")):
        p = _tree_to(params, where)
        logits, cache = model.prefill(p, ids.to(where), max_len=32)
        calls, steps = [logits.cpu()], []
        for i in range(4):
            tok = torch.argmax(logits[:, -1], dim=-1)
            steps.append(tok.cpu().tolist())
            logits, cache = model.decode_step(p, tok[:, None].to(torch.int32), cache, 17 + i)
            calls.append(logits.cpu())
        runs[where.type] = (steps, calls)
    (got_ids, got), (want_ids, want) = runs[device.type], runs["cpu"]
    worst = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
    print(f"[family] card against CPU, reduced {name} in float32 ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, period {[f'{s.mixer}/{s.ffn}' for s in cfg.period]}): "
          f"max |dlogit| / max |logit| = {worst:.3e} (limit {CARD_CPU_REL:.0e}); ids "
          f"{'equal' if got_ids == want_ids else 'DIFFER'}")
    if worst > CARD_CPU_REL or got_ids != want_ids:
        raise AssertionError(f"family: reduced {name} on the card disagrees with the CPU")
    return {"max_rel_err": worst, "ids_equal": True, "limit": CARD_CPU_REL}


def family_phase(docs, endpoints, prompt: List[int]) -> Dict[str, Any]:
    """Phase 10: (a) moonshot served behind the gateway, (b) rwkv6-3b's
    prefill and decode, (c) their cache paths in float32, (d) four reduced
    families on the card against the CPU."""
    from repro_torch.configs import get_config

    device = torch.device("cuda")
    requests = [(e, json.dumps(d)) for d, e in zip(docs[:SERVE_BURST], endpoints)]
    moe = serve_full_width(get_config(FAMILY_SERVE_ARCH), requests, device,
                           steps=FAMILY_STEPS, explain=True)
    moe.pop("admitted_prompts")
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = rwkv_full_width(get_config(RWKV_ARCH), prompt, device)
    gc.collect()
    torch.cuda.empty_cache()
    cache = family_cache_checks(prompt, device)
    cross = {name: family_card_vs_cpu(name, prompt, device) for name in FAMILY_CPU_ARCHS}
    return {"serve_moe": moe, "rwkv": rwkv, "cache_vs_full": cache, "card_vs_cpu": cross}


# ---------------------------------------------------------------------------
# phase 11: the training path
# ---------------------------------------------------------------------------


def driver_corpus():
    """The training driver's records and dataset schema
    (src/repro_torch/launch/train.py): JSON documents of the synthetic
    corpus, each wrapped as a {"text": ...} record."""
    from repro_torch.data.corpus import make_dataset

    ds = make_dataset("driver-corpus", 2000, 6.0, 350, seed=11)
    records = [{"text": json.dumps(d)} for d in ds.documents]
    schema = {"type": "object", "required": ["text"],
              "properties": {"text": {"type": "string", "minLength": 4}}}
    return schema, records


def _driver_data(cfg, b, device) -> Dict[str, torch.Tensor]:
    """A pipeline batch as the driver hands it to the step."""
    return {"tokens": torch.as_tensor(b["tokens"] % cfg.vocab_size, device=device),
            "labels": torch.as_tensor(b["labels"] % cfg.vocab_size, device=device)}


def train_full_width(cfg, device, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                     steps: int = TRAIN_WARMUP + TRAIN_TIMED) -> Dict[str, Any]:
    """(a) The driver's components at ``cfg``'s published widths and depth:
    ``ShardedPipeline`` admission on ``device``, the one-device step
    (remat on, ``donate=False``) and ``TrainSupervisor`` with
    ``checkpoint_every=0``, for ``steps`` steps (the first a warm-up).
    Every admission kernel call is held against its plain version and every
    batch the pipeline yielded against a CPU pipeline's."""
    from repro_torch.data.pipeline import ShardedPipeline
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda
    from repro_torch.kernels.hash_match import hash_match_cuda
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.supervisor import SupervisorConfig, TrainSupervisor
    from repro_torch.train.train_step import _make_device_step

    schema, records = driver_corpus()
    model = Model(cfg)
    ocfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=5, total_steps=steps,
                               state_dtype=cfg.optimizer_state_dtype)
    step = _make_device_step(model, ocfg, batch=batch, device=device, donate=False)
    pipe = ShardedPipeline(schema, records, seq_len=seq, batch_size=batch, device=device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device).manual_seed(SEED))
    opt_state = opt.init(ocfg, params)
    _sync(device)
    init_s = time.perf_counter() - t0
    leaves, moments = _leaves(params), _leaves(opt_state.m)
    n_params = sum(t.numel() for t in leaves)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves)
    state_bytes = 2 * sum(t.numel() * t.element_size() for t in moments)
    # the update reads each parameter, its gradient and both moments and
    # writes the parameter and both moments
    update_bytes = sum(p.numel() * (3 * p.element_size() + 4 * m.element_size())
                       for p, m in zip(leaves, moments))
    del leaves, moments

    pulled, metrics = [], []

    def wrapped(p, s, b):
        out = step(p, s, _driver_data(cfg, b, device))
        metrics.append(out[2])
        return out

    def pipeline_batches():
        for b in itertools.cycle(pipe.batches()):
            pulled.append(b)
            yield b

    with tempfile.TemporaryDirectory() as tmp:
        sup = TrainSupervisor(wrapped, CheckpointManager(tmp, keep=2, device=device),
                              SupervisorConfig(checkpoint_every=0))
        # as the driver does: no reference to the first state is kept, so
        # run() frees it after the first step (30.6 GB at full width, which
        # beside the step's own trees would not fit on the card)
        result, first = {}, {"params": params, "opt_state": opt_state}
        del params, opt_state
        zero_launch_counts()
        captured = capture_kernel_inputs(lambda: result.update(zip(
            ("params", "opt_state", "history"),
            sup.run(first.pop("params"), first.pop("opt_state"), pipeline_batches(),
                    num_steps=steps))))
        launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    if launches["hash_match"] < 1 or launches["assertion_eval_window"] < 1:
        raise AssertionError(f"train admission launched no CSR kernel: {launches}")
    for args in captured["hash_match"]:
        _check_equal("hash_match in train admission", hash_match_cuda(*args),
                     ref.hash_match_ref(*args))
    for args in captured["assertion_eval_window"]:
        _check_equal("assertion_eval_window in train admission",
                     assertion_eval_window_tape_cuda(*args),
                     ref.assertion_eval_window_tape_ref(*args))

    # the same records through a pipeline on the CPU
    cpu_pipe = ShardedPipeline(schema, records, seq_len=seq, batch_size=batch, device="cpu")
    want = list(itertools.islice(cpu_pipe.batches(), len(pulled)))
    for i, (got, exp) in enumerate(zip(pulled, want)):
        for key in ("tokens", "labels"):
            if got[key].dtype != exp[key].dtype or not np.array_equal(got[key], exp[key]):
                raise AssertionError(f"train: batch {i}'s {key} differ from the CPU pipeline's")
    stats = {k: getattr(pipe.admission.stats, k) for k in ("admitted", "rejected")}
    cpu_stats = {k: getattr(cpu_pipe.admission.stats, k) for k in ("admitted", "rejected")}
    if len(want) != len(pulled) or stats != cpu_stats:
        raise AssertionError(f"train: admission {stats} against the CPU's {cpu_stats}")

    hist = result["history"]
    losses = [float(m["loss"]) for m in metrics]
    norms = [float(m["grad_norm"]) for m in metrics]
    lrs = [float(m["lr"]) for m in metrics]
    if len(hist) != steps or any(r.rolled_back or r.retried for r in hist):
        raise AssertionError(f"train: {len(hist)} steps, rolled back or retried: {hist}")
    if not all(np.isfinite(losses + norms)):
        raise AssertionError(f"train: non-finite loss or grad norm: {losses} {norms}")
    step_ms = [r.seconds * 1e3 for r in hist]
    timed = step_ms[TRAIN_WARMUP:]
    median = statistics.median(timed)
    tokens = batch * seq

    # the update alone by CUDA events (the parameters stand in for gradients
    # of their shapes and dtypes), and one more step under the profiler:
    # the device's share of an eager step
    new_params, new_state = result.pop("params"), result.pop("opt_state")
    update_ms, step_profile = None, None
    if device.type == "cuda":
        update_ms = device_ms(lambda: opt.update(ocfg, new_params, new_state, new_params), reps=3)
        data = _driver_data(cfg, pulled[-1], device)
        step_profile = profile(lambda: step(new_params, new_state, data), "train step")
    del new_params, new_state, result
    flops_ms = 6 * cfg.param_count() * tokens / BF16_TENSOR_OPS_PER_S * 1e3
    update_bound_ms = update_bytes / HBM_BYTES_PER_S * 1e3
    print(f"[train] {cfg.name} at full width: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}; {cfg.param_count()} parameters by "
          f"param_count, {n_params} tensor elements, {param_bytes} B in {cfg.param_dtype}, "
          f"Adam moments {state_bytes} B in {cfg.optimizer_state_dtype}; init {init_s:.2f} s")
    print(f"[train] batch {batch} x seq {seq} = {tokens} tokens a step, remat on, "
          f"donate=False: {len(pulled)} pipeline batches ({stats['admitted']} records "
          f"admitted, {stats['rejected']} rejected), equal to a CPU pipeline's; kernel "
          f"launches {launches}, every call equal to its plain version")
    print(f"[train] step ms: {', '.join(f'{ms:.1f}' for ms in step_ms)} (first a warm-up); "
          f"median {median:.1f} ms over {len(timed)} steps, {tokens / (median / 1e3):.1f} "
          f"tokens/s; peak memory {peak} B")
    print(f"[train] loss {', '.join(f'{x:.4f}' for x in losses)}; grad norm "
          f"{', '.join(f'{x:.4f}' for x in norms)}")
    print(f"[train] bounds: model FLOPs 6*N*T = {6 * cfg.param_count() * tokens:.4e} at "
          f"989 TFLOP/s = {flops_ms:.3f} ms; the update's {update_bytes} B at 3.35 TB/s = "
          f"{update_bound_ms:.3f} ms; the update alone "
          f"{'not measured' if update_ms is None else f'{update_ms:.3f} ms'} by CUDA events; "
          f"step / FLOP bound {median / flops_ms:.2f}")
    return {"arch": cfg.name, "param_count": cfg.param_count(), "param_bytes": param_bytes,
            "moment_bytes": state_bytes, "param_dtype": cfg.param_dtype,
            "state_dtype": cfg.optimizer_state_dtype, "init_s": init_s, "batch": batch,
            "seq": seq, "tokens_per_step": tokens, "remat": True, "donate": False,
            "steps": steps, "warmup_steps": TRAIN_WARMUP, "step_ms": step_ms,
            "median_step_ms": median, "tokens_per_s": tokens / (median / 1e3),
            "loss": losses, "grad_norm": norms, "lr": lrs, "max_memory_allocated": peak,
            "flops_bound_ms": flops_ms, "update_bytes": update_bytes,
            "update_bound_ms": update_bound_ms, "update_ms": update_ms,
            "step_profile": step_profile,
            "pipeline_batches": len(pulled), "admission": stats, "launches": launches}


def train_card_vs_cpu(name: str, device) -> Dict[str, Any]:
    """(b) ``get_config(name).reduced()`` in float32 (TF32 off) from one set
    of CPU-made parameters: ``TRAIN_CPU_STEPS`` steps of the one-device step
    on the card and on the CPU.  Per step the loss and the grad norm agree
    within ``TRAIN_REL``.  The parameters after the steps agree within
    ``TRAIN_PARAM_ABS``, about a third of the last step's lr, so that a
    last update with its lr halved or dropped fails (the builders' runs read
    at most 8.8e-6).  Only a near-zero gradient whose sign differs between
    the devices may exceed it: Adam's first steps move an element by
    lr * |m_hat / sqrt(v_hat)|, at most 1 in the first three steps at beta1
    0.9, beta2 0.95, so such an element moves by up to 2 * lr more on one
    device.  At most ``TRAIN_PARAM_FLIPS`` of the elements may do so, each
    within 2 * sum of the steps' lr."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _make_device_step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(name).reduced(param_dtype="float32", activation_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator("cpu").manual_seed(SEED))
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=10,
                               state_dtype=cfg.optimizer_state_dtype)
    rng = np.random.default_rng(SEED)
    tokens = [rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
              for _ in range(TRAIN_CPU_STEPS)]
    runs = {}
    for where in (device, torch.device("cpu")):
        p = _tree_to(params, where)
        s = opt.init(ocfg, p)
        step = _make_device_step(model, ocfg, batch=2, device=where, donate=False)
        seen = []
        for t in tokens:
            labels = np.roll(t, -1, axis=1)
            p, s, m = step(p, s, {"tokens": t, "labels": labels})
            seen.append({k: float(v) for k, v in m.items()})
        runs[where.type] = (seen, [leaf.cpu() for leaf in _leaves(p)])
    (got, got_p), (want, want_p) = runs[device.type], runs["cpu"]
    worst = max(abs(a[k] - b[k]) / abs(b[k]) for a, b in zip(got, want)
                for k in ("loss", "grad_norm"))
    flip_tol = 2 * sum(m["lr"] for m in want)
    diffs = [(a - b).abs() for a, b in zip(got_p, want_p)]
    n_elems = sum(d.numel() for d in diffs)
    n_over = sum(int((d > TRAIN_PARAM_ABS).sum()) for d in diffs)
    param_err = max(float(d.max()) for d in diffs)
    # the largest difference apart from the sign flips the limit allows
    within = max(float(torch.where(d > TRAIN_PARAM_ABS, 0.0, d).max()) for d in diffs)
    print(f"[train] card against CPU, reduced {name} in float32 ({cfg.n_layers} layers, "
          f"period {[f'{s.mixer}/{s.ffn}' for s in cfg.period]}, moments in "
          f"{cfg.optimizer_state_dtype}), {TRAIN_CPU_STEPS} steps: loss "
          f"{[round(m['loss'], 6) for m in got]}; max relative loss / grad-norm difference "
          f"{worst:.3e} (limit {TRAIN_REL:.0e}); max |dparam| {within:.3e} (limit "
          f"{TRAIN_PARAM_ABS:.0e}) on all but {n_over} of {n_elems} elements (at most "
          f"{TRAIN_PARAM_FLIPS:.0e} of them, each within 2 * sum lr = {flip_tol:.3e}: "
          f"max {param_err:.3e})")
    if (worst > TRAIN_REL or n_over > TRAIN_PARAM_FLIPS * n_elems
            or param_err > flip_tol):
        raise AssertionError(f"train: reduced {name} on the card disagrees with the CPU")
    return {"max_rel_err": worst, "limit": TRAIN_REL, "max_param_err": param_err,
            "param_limit": TRAIN_PARAM_ABS, "params_over_limit": n_over,
            "param_elements": n_elems, "flip_limit": flip_tol,
            "loss": [m["loss"] for m in got]}


def train_drills(device, keep: Path) -> Dict[str, Any]:
    """(c) On the card, reduced granite-3-8b (bf16 parameters, float32
    moments): a checkpoint saved (into ``keep``, for phase 12 (c)) and
    restored onto the card bit for bit; the supervisor's NaN rollback and
    its resume from a checkpoint; the step with ``donate=True`` against
    ``donate=False``; the driver ``python -m repro_torch.launch.train`` as a
    subprocess."""
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tree_util
    from repro_torch.train.supervisor import SupervisorConfig, TrainSupervisor
    from repro_torch.train.train_step import _make_device_step

    cfg = get_config(SERVE_ARCH).reduced()
    model = Model(cfg)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=50)
    step = _make_device_step(model, ocfg, batch=2, device=device, donate=False, remat=False)
    params = model.init(torch.Generator(device).manual_seed(SEED))
    state = opt.init(ocfg, params)

    def batch(i):
        t = np.random.default_rng(i).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
        return {"tokens": torch.as_tensor(t, device=device),
                "labels": torch.as_tensor(t, device=device)}

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # save -> restore onto the card, bit for bit (moments after one step)
        params, state, _ = step(params, state, batch(0))
        bundle = {"params": params, "opt_state": state}
        mgr = ckpt.CheckpointManager(keep / "roundtrip", device=device)  # async save
        mgr.save(1, bundle)
        mgr.wait()
        restored_step, restored = mgr.restore(bundle)  # new tensors, read from disk
        got = _leaves(restored["params"]) + [restored["opt_state"].step] + \
            _leaves(restored["opt_state"].m) + _leaves(restored["opt_state"].v)
        want = _leaves(params) + [state.step] + _leaves(state.m) + _leaves(state.v)
        if restored_step != 1 or not all(
                a.device.type == device.type and a.dtype == b.dtype and torch.equal(a, b)
                for a, b in zip(got, want)):
            raise AssertionError("train: the checkpoint did not restore bit for bit onto the card")
        files = sorted(p.name for p in (keep / "roundtrip" / "step_0000000001").iterdir())
        out["checkpoint"] = {"leaves": len(got), "bytes": sum(
            (keep / "roundtrip" / "step_0000000001" / f).stat().st_size for f in files),
            "compressed": any(f.endswith(".zst") for f in files)}
        print(f"[train] checkpoint of reduced {SERVE_ARCH} ({cfg.param_dtype} parameters, "
              f"{cfg.optimizer_state_dtype} moments): {len(got)} leaves, "
              f"{out['checkpoint']['bytes']} B on disk "
              f"({'zstd' if out['checkpoint']['compressed'] else 'uncompressed'}), restored onto "
              "the card bit for bit")

        # NaN rollback: the second step's loss is poisoned; the supervisor
        # reloads the step-0 checkpoint and skips that batch
        mgr = ckpt.CheckpointManager(tmp / "nan", async_save=False, device=device)
        mgr.save(0, bundle)
        calls = {"n": 0}

        def poisoned(p, s, b):
            calls["n"] += 1
            new_p, new_s, m = step(p, s, b)
            if calls["n"] == 2:
                m = dict(m, loss=torch.tensor(float("nan"), device=device))
            return new_p, new_s, m

        sup = TrainSupervisor(poisoned, mgr, SupervisorConfig(checkpoint_every=0))
        p, s, hist = sup.run(params, state, iter([batch(i) for i in range(4)]), num_steps=4)
        rolled = [r.rolled_back for r in hist]
        if rolled != [False, True, False, False] or not all(
                bool(torch.isfinite(t).all()) for t in _leaves(p)):
            raise AssertionError(f"train: NaN rollback went wrong: {rolled}")
        # resume: a run that checkpoints every 2 steps, then a new supervisor
        mgr = ckpt.CheckpointManager(tmp / "resume", async_save=False, device=device)
        sup = TrainSupervisor(step, mgr, SupervisorConfig(checkpoint_every=2))
        p, s, _ = sup.run(params, state, iter([batch(i) for i in range(4)]), num_steps=4)
        start, p2, s2 = TrainSupervisor(step, mgr, SupervisorConfig()).resume_or_init(
            params, state)
        if start != 4 or int(s2.step) != int(s.step) or not all(
                torch.equal(a, b) for a, b in zip(_leaves(p2), _leaves(p))):
            raise AssertionError(f"train: resume from step {start} differs from the run")
        out["rollback"] = {"rolled_back": rolled, "resumed_step": start}
        print(f"[train] supervisor on the card: NaN at the second step rolled back "
              f"({rolled}); a new supervisor resumed at step {start}, equal to the run")

        # donate=True, the reference's default: the step writes into the
        # tensors it is given, bit for bit what donate=False returns fresh
        donated = _make_device_step(model, ocfg, batch=2, device=device, donate=True,
                                    remat=False)
        kept_p, kept_s, kept_m = step(params, state, batch(1))
        given_p, given_s = tree_util.tree_map(torch.clone, (params, state))
        given = tree_util.leaves((given_p, given_s))
        don_p, don_s, don_m = donated(given_p, given_s, batch(1))
        got, want = tree_util.leaves((don_p, don_s)), tree_util.leaves((kept_p, kept_s))
        if not (all(a is b for a, b in zip(got, given))
                and all(torch.equal(a, b) for a, b in zip(got, want))
                and all(torch.equal(don_m[k], kept_m[k]) for k in kept_m)):
            raise AssertionError("train: donate=True differs from donate=False on the card")
        out["donate"] = {"leaves": len(got), "bit_equal": True}
        print(f"[train] donate=True on the card: {len(got)} leaves written in place, bit for "
              "bit equal to donate=False's")

        # the driver as a user runs it
        out["driver"] = run_driver(["--arch", SERVE_ARCH, "--steps", "4"], device,
                                   tmp / "driver")
    return out


def run_driver(args: List[str], device, ckpt_dir: Path) -> Dict[str, Any]:
    """``python -m repro_torch.launch.train`` with ``args`` on ``device``, as
    a user runs it; it must exit 0 and print its loss line, finite."""
    argv = [sys.executable, "-m", "repro_torch.launch.train", *args,
            "--device", device.type, "--ckpt-dir", str(ckpt_dir)]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                          capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t0
    steps = args[args.index("--steps") + 1]
    lines = [ln for ln in proc.stdout.splitlines()
             if ln.startswith(f"[train] steps={steps} loss ")]
    losses = [float(x) for x in lines[0].split(" | ")[0].split("loss ")[1].split(" -> ")] \
        if lines else []
    if proc.returncode != 0 or not lines or not all(np.isfinite(losses)):
        raise AssertionError(f"train driver exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    print(f"[train] {' '.join(argv[3:])}: exit 0 in {seconds:.1f} s: {lines[0]}")
    return {"argv": argv[1:], "rc": proc.returncode, "seconds": seconds, "line": lines[0]}


def train_phase(smi: str, keep: Path) -> Dict[str, Any]:
    """Phase 11: (a) rwkv6-3b trained at full width and depth behind the
    driver's admission pipeline by the one-device step, then by the driver
    itself (on its host mesh), (b) four reduced families on the card against
    the CPU, (c) the checkpoint, supervisor, donation and driver drills."""
    from repro_torch.configs import get_config

    device = torch.device("cuda")
    full = train_full_width(get_config(TRAIN_ARCH), device)
    gc.collect()
    torch.cuda.empty_cache()
    # the driver itself at (a)'s width, batch and length; no checkpoint, as
    # in (a): a full-width save writes 36.7 GB and keeps a second state
    with tempfile.TemporaryDirectory() as tmp:
        driver = run_driver(["--arch", TRAIN_ARCH, "--full", "--batch", str(TRAIN_BATCH),
                             "--seq-len", str(TRAIN_SEQ), "--steps", str(TRAIN_DRIVER_STEPS),
                             "--checkpoint-every", "0"], device, Path(tmp))
    cross = {name: train_card_vs_cpu(name, device) for name in TRAIN_CPU_ARCHS}
    drills = train_drills(device, keep)
    return {"card": smi, **full, "driver_full_width": driver, "card_vs_cpu": cross,
            "drills": drills}


# ---------------------------------------------------------------------------
# phase 12: the mesh
# ---------------------------------------------------------------------------


def _host_copy(tree) -> List[torch.Tensor]:
    """Every leaf of ``tree`` (params and ``OptState``), in JAX's order, as a
    host tensor (a DTensor's local shard: the whole leaf on one device)."""
    from repro_torch.train import tree as tree_util

    return [(x.to_local() if hasattr(x, "to_local") else x).detach().cpu()
            for x in tree_util.leaves(tree)]


def _train_run(step, params, opt_state, datas, device, tag) -> Dict[str, Any]:
    """``step`` over ``datas`` (donated trees): the first a warm-up, then the
    timed steps, the last under the profiler.  Host ms a step, synchronised
    on the loss's device-to-host copy as the supervisor's clock is."""
    ms, losses, norms = [], [], []
    state = [params, opt_state]
    del params, opt_state

    def one(data):
        t0 = time.perf_counter()
        state[0], state[1], m = step(state[0], state[1], data)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(m["grad_norm"]))

    for data in datas[:-1]:
        one(data)
    prof = profile(lambda: one(datas[-1]), tag, warm=False)
    _sync(device)
    return {"params": state[0], "opt_state": state[1], "step_ms": ms[:-1],
            "median_step_ms": statistics.median(ms[TRAIN_WARMUP:-1]), "loss": losses,
            "grad_norm": norms, "profile": prof}


def mesh_full_width(cfg, device, batch: int = TRAIN_BATCH, seq: int = TRAIN_SEQ,
                    steps: int = MESH_STEPS) -> Dict[str, Any]:
    """(a) ``cfg`` at its published widths and depth trained on the (1, 1)
    mesh of ``make_host_mesh`` by ``make_train_step(model, ocfg, mesh)``
    (remat on, ``donate=True``), its state placed by the returned
    shardings, behind ``ShardedPipeline`` admission on the card; then the
    same seed, state and batches through the one-device step.  Loss and
    grad norm bit-equal each step, every parameter and moment leaf bit-equal
    after the last (each leaf of the mesh run kept on the host)."""
    from repro_torch.data.pipeline import ShardedPipeline
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval_window import assertion_eval_window_tape_cuda
    from repro_torch.kernels.hash_match import hash_match_cuda
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.sharding.rules import device_put
    from repro_torch.train import optimizer as opt
    from repro_torch.train.train_step import _make_device_step, make_train_step

    import torch.distributed as dist

    mesh = make_host_mesh(device)
    if dist.get_backend() != "nccl":
        raise AssertionError(f"the card's mesh runs on {dist.get_backend()}, not NCCL")
    schema, records = driver_corpus()
    model = Model(cfg)
    ocfg = opt.OptimizerConfig(learning_rate=1e-3, warmup_steps=5, total_steps=steps,
                               state_dtype=cfg.optimizer_state_dtype)
    mesh_step, (psh, osh, _), _ = make_train_step(model, ocfg, mesh, batch=batch, donate=True)
    pipe = ShardedPipeline(schema, records, seq_len=seq, batch_size=batch, device=device)
    pulled: List[dict] = []

    def batches():
        for b in itertools.islice(pipe.batches(), steps):
            pulled.append(b)
            yield _driver_data(cfg, b, device)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = device_put(model.init(torch.Generator(device).manual_seed(SEED)), psh)
    opt_state = device_put(opt.init(ocfg, params), osh)
    placements = sorted({str(x.placements) for x in _leaves(params)})
    zero_launch_counts()
    runs = {}
    captured = capture_kernel_inputs(lambda: runs.update(mesh=_train_run(
        mesh_step, params, opt_state, list(batches()), device, "mesh step")))
    launches = launch_counts()
    del params, opt_state
    mesh_peak = torch.cuda.max_memory_allocated()
    if launches["hash_match"] < 1 or launches["assertion_eval_window"] < 1:
        raise AssertionError(f"mesh: the admissions launched no CSR kernel: {launches}")
    for args in captured["hash_match"]:
        _check_equal("hash_match in mesh admission", hash_match_cuda(*args),
                     ref.hash_match_ref(*args))
    for args in captured["assertion_eval_window"]:
        _check_equal("assertion_eval_window in mesh admission",
                     assertion_eval_window_tape_cuda(*args),
                     ref.assertion_eval_window_tape_ref(*args))
    cpu_pipe = ShardedPipeline(schema, records, seq_len=seq, batch_size=batch, device="cpu")
    for i, (got, exp) in enumerate(zip(pulled, itertools.islice(cpu_pipe.batches(), steps))):
        if not all(np.array_equal(got[k], exp[k]) for k in ("tokens", "labels")):
            raise AssertionError(f"mesh: batch {i} differs from the CPU pipeline's")
    mesh_run = runs["mesh"]
    t0 = time.perf_counter()
    kept = _host_copy((mesh_run.pop("params"), mesh_run.pop("opt_state")))
    host_copy_s = time.perf_counter() - t0
    del runs
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats()
    one_step = _make_device_step(model, ocfg, batch=batch, device=device, donate=True)
    params = model.init(torch.Generator(device).manual_seed(SEED))
    opt_state = opt.init(ocfg, params)
    one_run = _train_run(one_step, params, opt_state,
                         [_driver_data(cfg, b, device) for b in pulled], device, "one-device step")
    del params, opt_state
    one_peak = torch.cuda.max_memory_allocated()
    for key in ("loss", "grad_norm"):
        if mesh_run[key] != one_run[key]:
            raise AssertionError(f"mesh: {key} {mesh_run[key]} against the one-device "
                                 f"step's {one_run[key]}")
    from repro_torch.train import tree as tree_util

    got = tree_util.leaves((one_run.pop("params"), one_run.pop("opt_state")))
    if len(got) != len(kept) or not all(
            a.dtype == b.dtype and torch.equal(a.cpu(), b) for a, b in zip(got, kept)):
        raise AssertionError("mesh: the state after the last step differs from the "
                             "one-device step's")
    n_state = len(kept)
    del got, kept
    gc.collect()
    torch.cuda.empty_cache()
    tokens = batch * seq
    m_med, o_med = mesh_run["median_step_ms"], one_run["median_step_ms"]
    m_k, o_k = mesh_run["profile"]["device_calls"], one_run["profile"]["device_calls"]
    print(f"[mesh] {cfg.name} at full width on the (1, 1) mesh {tuple(mesh.mesh_dim_names)} "
          f"over {dist.get_backend()}: placements {placements}; batch {batch} x seq {seq}, "
          f"remat on, donate=True, {steps} steps (1 warm-up, {steps - 2} timed, 1 profiled) "
          f"behind {len(pulled)} pipeline batches equal to a CPU pipeline's; kernel launches "
          f"{launches}, every call equal to its plain version")
    print(f"[mesh] loss {mesh_run['loss']}; grad norm {mesh_run['grad_norm']}: bit-equal to "
          f"the one-device step's each step; all {n_state} parameter and moment leaves "
          f"bit-equal after the last (host copy {host_copy_s:.1f} s)")
    print(f"[mesh] step ms mesh {', '.join(f'{x:.1f}' for x in mesh_run['step_ms'])} (median "
          f"{m_med:.1f}, {tokens / (m_med / 1e3):.1f} tokens/s); one-device "
          f"{', '.join(f'{x:.1f}' for x in one_run['step_ms'])} (median {o_med:.1f}); device "
          f"kernels a profiled step {m_k} on the mesh, {o_k} on one device; peak memory "
          f"{mesh_peak} B on the mesh, {one_peak} B on one device")
    return {"arch": cfg.name, "mesh": list(mesh.shape), "axes": list(mesh.mesh_dim_names),
            "backend": dist.get_backend(), "placements": placements, "batch": batch,
            "seq": seq, "steps": steps, "remat": True, "donate": True,
            "loss": mesh_run["loss"], "grad_norm": mesh_run["grad_norm"],
            "state_leaves": n_state, "bit_equal": True,
            "mesh_step_ms": mesh_run["step_ms"], "mesh_median_step_ms": m_med,
            "one_device_step_ms": one_run["step_ms"], "one_device_median_step_ms": o_med,
            "mesh_profile": mesh_run["profile"], "one_device_profile": one_run["profile"],
            "mesh_peak_bytes": mesh_peak, "one_device_peak_bytes": one_peak,
            "pipeline_batches": len(pulled), "launches": launches}


def mesh_serving(device) -> Dict[str, Any]:
    """(b) Reduced granite in float32 on the (1, 1) mesh: ``make_prefill_step``
    and ``make_decode_step`` against ``Model.prefill`` and
    ``Model.decode_step`` on the same parameters: logits and cache bit-equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.sharding.rules import device_put
    from repro_torch.train import tree as tree_util
    from repro_torch.train.train_step import make_decode_step, make_prefill_step

    mesh = make_host_mesh(device)
    cfg = get_config(SERVE_ARCH).reduced(param_dtype="float32", activation_dtype="float32")
    model = Model(cfg)
    params = model.init(torch.Generator(device).manual_seed(SEED))
    batch, length, max_len = 4, 48, MESH_SERVE_MAX_LEN
    tokens = torch.as_tensor(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (batch, length + MESH_DECODE_STEPS)).astype(np.int32), device=device)
    prefill, (psh, _), _ = make_prefill_step(model, mesh, batch=batch, max_len=max_len)
    decode, _, _ = make_decode_step(model, mesh, batch=batch, max_len=max_len)
    placed = device_put(params, psh)

    def check(what, got, want):
        (got_logits, got_cache), (want_logits, want_cache) = got, want
        if not torch.equal(got_logits.to_local(), want_logits) or not all(
                torch.equal(a.to_local(), b)
                for a, b in zip(tree_util.leaves(got_cache), tree_util.leaves(want_cache))):
            raise AssertionError(f"mesh: the {what} step differs from the model's")
        return got_cache, want_cache

    got_cache, want_cache = check("prefill", prefill(placed, tokens[:, :length]),
                                  model.prefill(params, tokens[:, :length], max_len))
    for i in range(MESH_DECODE_STEPS):
        token = tokens[:, length + i:length + i + 1]
        got_cache, want_cache = check(
            f"decode {i}", decode(placed, token, got_cache, length + i),
            model.decode_step(params, token, want_cache, length + i))
    n_cache = len(tree_util.leaves(got_cache))
    print(f"[mesh] reduced {SERVE_ARCH} in float32 on the mesh: make_prefill_step of {batch} x "
          f"{length} tokens and {MESH_DECODE_STEPS} make_decode_step calls, logits and all "
          f"{n_cache} cache leaves bit-equal to Model.prefill and Model.decode_step")
    return {"arch": cfg.name, "batch": batch, "prompt": length, "max_len": max_len,
            "decode_steps": MESH_DECODE_STEPS, "cache_leaves": n_cache, "bit_equal": True}


def mesh_restore(device, keep: Path) -> Dict[str, Any]:
    """(c) Phase 11 (c)'s reduced granite checkpoint restored onto the
    (1, 1) mesh with ``restore(shardings=...)``: every leaf a DTensor on the
    mesh, laid out by its sharding, and bit-equal to a plain restore."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import Model
    from repro_torch.train import optimizer as opt
    from repro_torch.train import tree as tree_util
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.train_step import make_train_step
    from torch.distributed.tensor import DTensor

    mesh = make_host_mesh(device)
    cfg = get_config(SERVE_ARCH).reduced()
    model = Model(cfg)
    ocfg = opt.OptimizerConfig(warmup_steps=2, total_steps=50)
    _, (psh, osh, _), _ = make_train_step(model, ocfg, mesh, batch=2)
    params = model.init(torch.Generator(device).manual_seed(SEED))
    like = {"params": params, "opt_state": opt.init(ocfg, params)}
    mgr = CheckpointManager(keep / "roundtrip", device=device)
    step, plain = mgr.restore(like)
    step_m, placed = mgr.restore(like, shardings={"params": psh, "opt_state": osh})
    shardings = tree_util.leaves({"params": psh, "opt_state": osh})
    got, want = tree_util.leaves(placed), tree_util.leaves(plain)
    if step_m != step or len(got) != len(want) or not all(
            isinstance(a, DTensor) and a.device_mesh == mesh and a.placements == s.placements
            and a.dtype == b.dtype and torch.equal(a.to_local(), b)
            for a, b, s in zip(got, want, shardings)):
        raise AssertionError("mesh: the checkpoint did not restore onto the mesh bit for bit")
    print(f"[mesh] phase 11 (c)'s checkpoint (step {step}) restored onto the mesh: all "
          f"{len(got)} leaves DTensors laid out by their shardings, bit-equal")
    return {"step": step, "leaves": len(got), "bit_equal": True}


def mesh_psum(device) -> Dict[str, Any]:
    """(d) ``compressed_psum`` over each axis of the (1, 1) mesh on NCCL
    (one rank): bit-equal to ``int8_dequantize(*int8_quantize(x))``."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_step import compressed_psum, int8_dequantize, int8_quantize

    mesh = make_host_mesh(device)
    gen = torch.Generator(device).manual_seed(SEED)
    x = {"a": torch.randn((4096, 257), generator=gen, device=device),
         "b": 1e-3 * torch.randn((3, 5, 7), generator=gen, device=device)}
    for axis in mesh.mesh_dim_names:
        got = compressed_psum(x, axis, mesh)
        for k, v in x.items():
            if not torch.equal(got[k], int8_dequantize(*int8_quantize(v))):
                raise AssertionError(f"mesh: compressed_psum over {axis} differs for {k}")
    print(f"[mesh] compressed_psum over each axis of the mesh on NCCL: bit-equal to "
          f"int8_dequantize(*int8_quantize(x)) for {[tuple(v.shape) for v in x.values()]}")
    return {"axes": list(mesh.mesh_dim_names), "shapes": [list(v.shape) for v in x.values()],
            "bit_equal": True}


def mesh_phase(smi: str, keep: Path) -> Dict[str, Any]:
    """Phase 12: (a) rwkv6-3b trained at full width on the (1, 1) mesh
    against the one-device step, (b) the serving steps, (c) the restore onto
    the mesh, (d) ``compressed_psum`` over NCCL."""
    from repro_torch.configs import get_config

    device = torch.device("cuda")
    full = mesh_full_width(get_config(TRAIN_ARCH), device)
    gc.collect()
    torch.cuda.empty_cache()
    return {"card": smi, **full, "serving": mesh_serving(device),
            "restore": mesh_restore(device, keep), "compressed_psum": mesh_psum(device)}


def run() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port (src/repro_torch) is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    from repro_torch.data.doc_table import encode_batch

    name, smi = card()
    build()
    print(f"[kernels] {adversarial_cases()} adversarial cases equal to the plain versions "
          "(all 19 ops + op -1, NUM_MULTIPLE / STR_PREFIX / shift edges, -1/-9 owners)")

    floor = timing_floor()
    print(f"[kernels] timing floor, a one-cycle spin kernel: {floor['ms']:.4f} ms by CUDA "
          f"events (the kernel 'ms'), {floor['profiler_ms']} ms by the profiler")

    linked, names, docs, ids = gateway(BATCH)
    t0 = time.perf_counter()
    table = encode_batch(docs, max_nodes=MAX_NODES)
    encode_us = (time.perf_counter() - t0) / BATCH * 1e6
    print(f"[main] gateway tape: members={linked.n_members} circuits={linked.n_circuits} "
          f"A_hat={linked.max_rows_per_loc} K={linked.max_hash_run} M={linked.n_props} "
          f"L={linked.n_locations} horizon={linked.max_loc_depth + 1}")

    from repro_torch.core.batch_executor import BatchValidator

    probe = BatchValidator(linked)
    captured = capture_main_inputs(probe, table, ids)
    kernels = [
        hash_match_at_main(captured["hash_match"]),
        assertion_eval_window_at_main(captured["assertion_eval_window"]),
    ]

    main = main_path(linked, names, docs, ids, table)
    for row in kernels:
        row["launches"] = main["launches"][row["name"]]
    print(f"[main] B={BATCH} max_nodes={MAX_NODES}: docs/s {main['docs_per_s']:.0f}, median "
          f"launch {main['launch_ms']:.3f} ms over {TIMED_LAUNCHES}, encode {encode_us:.1f} "
          f"us/doc, decided {main['decided_share']:.4f}, valid|decided "
          f"{main['valid_share_of_decided']:.4f}; equal to the CPU run and the sequential "
          f"Validator; launches {main['launches']}")

    poison = isolation(main["bv"], table, ids,
                       (main["valid"], main["decided"], main["frontier"]))
    print(f"[isolation] launch fault at row {poison} cornered by validate_isolated; "
          f"the other {BATCH - 1} rows bit-equal")

    host = host_phases(lambda: main["bv"].validate_ex(table, ids), "host")
    prof = profile(lambda: main["bv"].validate_ex(table, ids), "profile")
    if prof["device_busy_ms"] > 0:
        print(f"[profile] device busy {prof['device_busy_ms']:.3f} ms is "
              f"{100 * prof['device_busy_ms'] / main['launch_ms']:.1f}% of the unprofiled "
              f"median launch ({main['launch_ms']:.3f} ms)")

    endpoints = [names[i] for i in ids]
    registry = {layout: registry_phase(layout, docs, endpoints, main["oracle"])
                for layout in ("csr", "dense")}
    if registry["csr"].pop("verdicts") != registry["dense"].pop("verdicts"):
        raise AssertionError("registry admission: the csr and dense layouts disagree")
    print("[registry] the csr and dense layouts give equal verdicts")
    csr_calls = registry["csr"].pop("captured")
    dense_calls = registry["dense"].pop("captured")
    kernels[1]["admission"] = assertion_eval_window_at_admission(
        csr_calls["assertion_eval_window"])
    kernels[0]["dense"] = hash_match_at_dense(dense_calls["hash_match"])
    kernels.append(assertion_eval_at_main(dense_calls["assertion_eval"]))
    # phase 13 needs no LM memory: it runs beside phase 7
    conformance = conformance_phase(smi)
    serve = serve_phase(docs, endpoints, smi)
    prompt = serve.pop("longest_prompt")
    if len(prompt) < max(RWKV_PROMPTS):
        raise AssertionError(f"the longest admitted prompt has {len(prompt)} tokens, "
                             f"fewer than {max(RWKV_PROMPTS)}")
    explain = explain_phase(docs, endpoints)
    family = family_phase(docs, endpoints, prompt)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as keep:
        train = train_phase(smi, Path(keep))
        gc.collect()
        torch.cuda.empty_cache()
        mesh = mesh_phase(smi, Path(keep))
    for row in kernels:
        row["launches_by_path"] = {
            "main": main["launches"][row["name"]],
            **{f"registry_{k}": v["launches"][row["name"]] for k, v in registry.items()},
            "serve": serve["launches"][row["name"]],
            "explain": explain["launches"][row["name"]],
            "serve_moe": family["serve_moe"]["launches"][row["name"]],
            "train": train["launches"][row["name"]],
            "mesh": mesh["launches"][row["name"]],
            "conformance": conformance["launches"][row["name"]],
        }
    kernels[-1]["launches"] = registry["dense"]["launches"]["assertion_eval"]
    kernels[0]["dense"]["launches"] = registry["dense"]["launches"]["hash_match"]
    kernels[1]["admission"]["launches"] = registry["csr"]["launches"]["assertion_eval_window"]

    print(json.dumps({"main_path": {
        "card": smi, "batch": BATCH, "max_nodes": MAX_NODES,
        "docs_per_s": main["docs_per_s"], "launch_ms": main["launch_ms"],
        "encode_us_per_doc": encode_us, "decided_share": main["decided_share"],
        "valid_share_of_decided": main["valid_share_of_decided"], "profile": prof,
        "host_ms_by_phase": host, "registry": registry,
    }}))
    print(json.dumps({"serve": serve}))
    print(json.dumps({"explain": explain}))
    print(json.dumps({"family": family}))
    print(json.dumps({"train": train}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"conformance": conformance}))
    print(json.dumps({"kernels": kernels, "timing_floor": floor}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
