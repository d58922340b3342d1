#!/usr/bin/env python3
"""Run the PyTorch/CUDA port's main path on one GPU and check every kernel.

    python3 chip_smoke.py

Phases, each printed on its own lines:

1. card: the torch device and ``nvidia-smi``'s name and power limit;
2. build: ``nvcc`` compiles every kernel source of ``src/repro_torch/csrc``
   in parallel, with its time and ``ptxas`` register/shared-memory use;
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   first on small adversarial cases, then on the inputs the main path gives
   it, with CUDA-event times, the plain version's time and the bound;
4. main path: batched CSR validation of the five-endpoint gateway mix
   (B=4096 documents, max_nodes=64, linked tape) through
   ``BatchValidator.validate_ex``: docs/s, launch and encode times, launch
   counts, and verdicts against the port's CPU run and the sequential
   ``Validator``;
5. isolation: one row's launch fault injected through ``set_fault_hook`` is
   cornered by ``validate_isolated`` while every other row stays bit-equal;
6. profile: host milliseconds per launch in each executor phase, then one
   launch under ``torch.profiler``: device-busy share and the heaviest
   device kernels.

Any mismatch or exception exits non-zero.  The last lines are the kernels
JSON line, the card's name and power limit, and
``{"ok": true, "device": {...}}``.  Needs a CUDA device: without one, or
without the rest of the repository beside it, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import random
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


def device_ms(fn: Callable[[], Any], reps: int = 20) -> float:
    """Median CUDA-event time of ``fn`` with the 50 MB L2 flushed before
    each call (a cold cache, as after the executor's other passes)."""
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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
    results = build_kernels(["hash_match", "assertion_eval_window"])
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


def adversarial_cases() -> int:
    """Small edge cases for both kernels; returns the number checked."""
    from repro_torch.core.tape import AOP
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval import assertion_eval_window_cuda
    from repro_torch.kernels.hash_match import hash_match_cuda

    rng = np.random.default_rng(SEED)
    pool = _key_pool()
    count = 0
    # hash_match: ragged N, several shared-memory chunks, owners -1 and -9
    for n, m in [(1, 1), (7, 5), (300, 130), (1000, 600), (4097, 257)]:
        q = _lanes(rng, n, pool)
        t = _lanes(rng, m, pool)
        q_owner = torch.from_numpy(rng.integers(-1, 4, n).astype(np.int32)).cuda()
        t_owner = torch.from_numpy(
            np.where(rng.random(m) < 0.1, -9, rng.integers(0, 4, m)).astype(np.int32)
        ).cuda()
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

    # assertion_eval_window: all 19 ops plus op -1, with the edges of
    # NUM_MULTIPLE (quotients at the 0.25 / 1e-6 tolerance), STR_PREFIX
    # (i0 from -2 to 12) and OBJ_HAS_SLOT (shifts outside 0..31)
    def case(n: int, w: int, ops, f0=None, i0=None, num=None, ntype=None):
        nodes = {
            "type": ntype if ntype is not None else rng.integers(0, 7, n),
            "is_int": rng.integers(0, 2, n),
            "num": num if num is not None else rng.normal(0, 10, n),
            "size": rng.integers(0, 12, n),
            "acquired": rng.integers(-(2**31), 2**31, n),
            "str_hash": pool[rng.integers(0, len(pool), n)],
            "str_prefix": rng.integers(0, 2**32, (n, 2), dtype=np.uint64).astype(np.uint32),
        }
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

        def dev(cols, floats):
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

        nd, wd = dev(nodes, {"num"}), dev(win, {"f0"})
        _check_equal(f"assertion_eval_window n={n} w={w} ops={list(ops)[:3]}...",
                     assertion_eval_window_cuda(nd, wd), ref.assertion_eval_window_ref(nd, wd))

    all_ops = list(range(-1, 19))
    for n, w in [(1, 1), (37, 3), (1000, 7), (4099, 8)]:
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
    return count


def capture_main_inputs(bv, table, ids) -> Dict[str, tuple]:
    """The exact inputs one main-path launch gives each kernel."""
    from repro_torch.kernels import ops

    captured: Dict[str, tuple] = {}
    originals = {"hash_match": ops.hash_match, "assertion_eval_window": ops.assertion_eval_window}

    def recorder(name):
        def record(*args):
            if name == "assertion_eval_window":
                args = (ops._with_acquired(args[0]), args[1])
            captured[name] = args
            return originals[name](*args)
        return record

    for name in originals:
        setattr(ops, name, recorder(name))
    try:
        bv.validate_ex(table, ids)
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
    return captured


def hash_match_at_main(args) -> Dict[str, Any]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.hash_match import hash_match_cuda

    q_lanes, q_owner, t_lanes, t_owner = args
    n, m = q_lanes.shape[0], t_lanes.shape[0]
    got = hash_match_cuda(*args)
    want = ref.hash_match_ref(*args)
    err = _check_equal("hash_match at the main path's inputs", got, want)
    # bytes this run's data needs: every owner and output word, the lanes of
    # queries that scan (owner != -1), the table once
    active = int((q_owner != -1).sum().item())
    nbytes = 4 * n + 32 * active + 36 * m + 4 * n
    # operations: nine int32 compares per row scanned, scans ending at the
    # first match (row `got`) or running over all M rows
    scanned = torch.where(got >= 0, got + 1, m)[q_owner != -1].sum().item()
    nops = 9 * int(scanned)
    ms = device_ms(lambda: hash_match_cuda(*args))
    plain_ms = device_ms(lambda: ref.hash_match_ref(*args))
    return _kernel_row("hash_match", "src/repro/kernels/hash_match.py:78",
                       "src/repro_torch/csrc/hash_match.cu", err, ms, plain_ms,
                       nbytes, nops, f"N={n} M={m}")


def assertion_eval_window_at_main(args) -> Dict[str, Any]:
    from repro_torch.kernels import ref
    from repro_torch.kernels.assertion_eval import assertion_eval_window_cuda

    node_cols, w_cols = args
    n, w = w_cols["op"].shape
    got = assertion_eval_window_cuda(node_cols, w_cols)
    want = ref.assertion_eval_window_ref(node_cols, w_cols)
    err = _check_equal("assertion_eval_window at the main path's inputs", got, want)
    # bytes this run's data needs: every op word and output byte; the other
    # 52 operand bytes of each live slot (op >= 0); 60 bytes of each node
    # with a live slot
    live = w_cols["op"] >= 0
    n_live = int(live.sum().item())
    n_nodes = int(live.any(dim=1).sum().item())
    nbytes = 4 * n * w + 52 * n_live + 60 * n_nodes + n * w
    # operations: about ten per live slot (the selected op's compares)
    nops = 10 * n_live
    ms = device_ms(lambda: assertion_eval_window_cuda(node_cols, w_cols))
    plain_ms = device_ms(lambda: ref.assertion_eval_window_ref(node_cols, w_cols))
    return _kernel_row("assertion_eval_window", "src/repro/kernels/assertion_eval.py:350",
                       "src/repro_torch/csrc/assertion_eval_window.cu", err, ms, plain_ms,
                       nbytes, nops, f"N={n} W={w}")


def _kernel_row(name, replaces, source, err, ms, plain_ms, nbytes, nops, shape):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / CUDA_CORE_OPS_PER_S * 1e3
    bound_ms, bound_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    print(f"[kernels] {name} at the main path's inputs ({shape}): equal; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms by {bound_by} "
          f"({nbytes} B at 3.35 TB/s, {nops} ops at 67 T/s)")
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": shape, "bytes": nbytes, "ops": nops,
    }


def main_path(linked, names, docs, ids, table) -> Dict[str, Any]:
    from repro_torch.core.batch_executor import BatchValidator
    from repro_torch.kernels import assertion_eval as ae_mod
    from repro_torch.kernels import hash_match as hm_mod

    bv = BatchValidator(linked)  # the default device: cuda
    bv.validate_ex(table, ids)  # first launch under this shape (allocator growth)
    torch.cuda.synchronize()

    hm_mod.launches = 0
    ae_mod.launches = 0
    times = []
    results = []
    for _ in range(TIMED_LAUNCHES):
        t0 = time.perf_counter()
        results.append(bv.validate_ex(table, ids))
        times.append(time.perf_counter() - t0)
    launches = {"hash_match": hm_mod.launches, "assertion_eval_window": ae_mod.launches}
    for name, count in launches.items():
        if count != TIMED_LAUNCHES:
            raise AssertionError(f"{name}: {count} launches in {TIMED_LAUNCHES} batches")
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


def host_phases(bv, table, ids, reps: int = 5) -> Dict[str, float]:
    """Host milliseconds per launch in each executor phase (``obs.profile``,
    exclusive times): the dispatch cost of the eager launch, stage by
    stage; ``executor.sync`` is the wait for the device at the end."""
    from repro_torch.obs.profile import Profiler

    with Profiler() as prof:
        for _ in range(reps):
            bv.validate_ex(table, ids)
    out = {name: st.self_ns / reps / 1e6 for name, st in prof.stats().items()}
    print("[host] per launch, host ms by executor phase: " + ", ".join(
        f"{name.split('.', 1)[1]} {ms:.3f}" for name, ms in sorted(out.items())))
    return out


def profile(bv, table, ids) -> Dict[str, Any]:
    """One launch under torch.profiler: device-busy time and top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile

    bv.validate_ex(table, ids)
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        bv.validate_ex(table, ids)
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
        print("[profile] the profiler recorded no device time: device busy share not measured")
    else:
        print(f"[profile] one launch under the profiler: wall {wall_ms:.3f} ms, device busy "
              f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}% of the wall), {calls} device "
              f"kernels and copies, of which copies {copy_ms:.3f} ms")
        for ms, count, key in rows[:10]:
            print(f"[profile]   {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_calls": calls,
            "copy_ms": copy_ms}


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

    host = host_phases(main["bv"], table, ids)
    prof = profile(main["bv"], table, ids)
    if prof["device_busy_ms"] > 0:
        print(f"[profile] device busy {prof['device_busy_ms']:.3f} ms is "
              f"{100 * prof['device_busy_ms'] / main['launch_ms']:.1f}% of the unprofiled "
              f"median launch ({main['launch_ms']:.3f} ms)")
    print(json.dumps({"main_path": {
        "card": smi, "batch": BATCH, "max_nodes": MAX_NODES,
        "docs_per_s": main["docs_per_s"], "launch_ms": main["launch_ms"],
        "encode_us_per_doc": encode_us, "decided_share": main["decided_share"],
        "valid_share_of_decided": main["valid_share_of_decided"], "profile": prof,
        "host_ms_by_phase": host,
    }}))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(run())
