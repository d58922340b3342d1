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
   and ``assertion_eval`` are timed at their largest call.

Any mismatch or exception exits non-zero.  The last lines are the kernels
JSON line (``launches`` counts the path each kernel serves: the CSR main
path for the first two, the dense admission for ``assertion_eval``;
``launches_by_path`` has every path's count; ``hash_match``'s ``dense``
holds its time, bound and launches in the dense admission,
``assertion_eval_window``'s ``admission`` the same in the csr admission),
the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Needs a CUDA device: without one, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import collections
import json
import random
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Tuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
CUDA_CORE_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores
BATCH = 4096
MAX_NODES = 64
TIMED_LAUNCHES = 10
# the AdmitCounts fields that PipelineStats also counts (all but per_group)
ADMIT_COUNT_FIELDS = ("batch_validated", "undecided", "oversize", "unroll_overflow",
                      "fallback_validated", "rejected_guard", "error_isolated",
                      "timed_out", "breaker_open")
SEED = 0

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


def profile(run: Callable[[], Any], tag: str) -> Dict[str, Any]:
    """One call of ``run`` under torch.profiler: device-busy time and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

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


def admission_controller(layout: str, device=None):
    """An ``AdmissionController`` over a registry of the five gateway
    endpoints (analysis and link grouping on, as a user builds it)."""
    from repro_torch.data.pipeline import AdmissionController
    from repro_torch.registry import SchemaRegistry
    from repro_torch.registry.presets import GATEWAY_SCHEMAS

    registry = SchemaRegistry(layout=layout, device=device)
    for name, schema in GATEWAY_SCHEMAS.items():
        registry.register(name, schema)
    return AdmissionController(registry=registry, endpoint=next(iter(GATEWAY_SCHEMAS)),
                               batch_max_nodes=MAX_NODES)


def _verdict_rows(verdicts) -> List[tuple]:
    return [(v.outcome.name, v.valid, v.engine) for v in verdicts]


def registry_phase(layout: str, docs, endpoints, oracle) -> Dict[str, Any]:
    """Registry admission of the gateway mix in one executor layout; returns
    (besides the numbers) every kernel input of its first call."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.hash_match import hash_match_cuda

    ctrl = admission_controller(layout)  # the default device: cuda
    reg = ctrl.registry
    # first call per batch shape (allocator growth), with every hash_match
    # call held against its plain version (the assertion kernels' calls in
    # assertion_eval_window_at_admission and assertion_eval_at_main)
    captured = capture_kernel_inputs(lambda: ctrl.admit_ex(docs, endpoints))
    for args in captured["hash_match"]:
        _check_equal(f"hash_match in {layout} admission", hash_match_cuda(*args),
                     ref.hash_match_ref(*args))
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
    n_groups = len({reg.group_of(e).label for e in set(endpoints)})
    per_call = {
        "hash_match": n_groups * (reg.max_depth if layout == "dense" else 1),
        "assertion_eval_window": n_groups if layout == "csr" else 0,
        "assertion_eval": n_groups if layout == "dense" else 0,
    }
    if launches != {k: v * TIMED_LAUNCHES for k, v in per_call.items()}:
        raise AssertionError(f"{layout} admission: launches {launches} in {TIMED_LAUNCHES} "
                             f"calls, want {per_call} per call")
    verdicts = _verdict_rows(results[0])
    if any(_verdict_rows(r) != verdicts for r in results[1:]):
        raise AssertionError(f"{layout} admission: repeated calls disagree")
    cpu = _verdict_rows(admission_controller(layout, device="cpu").admit_ex(docs, endpoints))
    if cpu != verdicts:
        diff = sum(a != b for a, b in zip(cpu, verdicts))
        raise AssertionError(f"{layout} admission: {diff} verdicts differ from the CPU registry")
    batched = [i for i, v in enumerate(results[0]) if v.engine == "batched"]
    if not batched:
        raise AssertionError(f"{layout} admission: no request was decided on the batched path")
    wrong = sum(results[0][i].valid != bool(oracle[i]) for i in batched)
    if wrong:
        raise AssertionError(f"{layout} admission: {wrong} batched verdicts differ from "
                             "the sequential Validator")
    admit_ms = statistics.median(times) * 1e3
    host = host_phases(lambda: ctrl.admit_ex(docs, endpoints), f"registry {layout}", reps=3)
    prof = profile(lambda: ctrl.admit_ex(docs, endpoints), f"registry {layout}")
    by_group = collections.Counter(reg.group_of(e).label for e in endpoints)
    print(f"[registry] layout={layout}: requests by group {dict(sorted(by_group.items()))}; "
          f"median admit_ex {admit_ms:.3f} ms over {TIMED_LAUNCHES} calls of {len(docs)} "
          f"requests, {len(docs) / (admit_ms / 1e3):.0f} requests/s; launches per call "
          f"{ {k: v // TIMED_LAUNCHES for k, v in launches.items()} }; AdmitCounts "
          f"{counts}; verdicts equal to the CPU registry and, for the {len(batched)} "
          "batched ones, to the sequential Validator")
    return {"admit_ms": admit_ms, "requests_per_s": len(docs) / (admit_ms / 1e3),
            "launches": launches, "launches_per_call": per_call, "counts": counts,
            "host_ms_by_phase": host, "profile": prof,
            "verdicts": verdicts, "captured": captured}


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
    for row in kernels:
        row["launches_by_path"] = {
            "main": main["launches"][row["name"]],
            **{f"registry_{k}": v["launches"][row["name"]] for k, v in registry.items()},
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
    print(json.dumps({"kernels": kernels, "timing_floor": floor}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
