"""Fault-tolerant training supervision.

Wraps the jitted train step with the control-plane logic a 1000-node run
needs:

* periodic async checkpoints + resume-from-latest on (re)start;
* per-step NaN/Inf guard: a poisoned step rolls back to the last
  checkpoint and skips ahead past the offending data batch;
* bounded retry on transient step failures (device loss on real fleets);
* straggler watch: an EMA of step time flags slow steps and invokes a
  remesh callback (on real fleets: exclude the slow host and restore onto
  the smaller mesh -- the elastic path exercised by
  tests/test_fault_tolerance.py via CheckpointManager resharding);
* failure injection hooks so every path above is testable on CPU.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from .checkpoint import CheckpointManager

Params = Any


@dataclass
class SupervisorConfig:
    checkpoint_every: int = 100
    max_step_retries: int = 2
    straggler_factor: float = 3.0  # step slower than factor x EMA => flag
    straggler_ema: float = 0.9
    nan_rollback: bool = True


@dataclass
class StepRecord:
    step: int
    loss: float
    seconds: float
    retried: int = 0
    rolled_back: bool = False
    straggler: bool = False


class TrainSupervisor:
    def __init__(
        self,
        step_fn: Callable,
        ckpt: CheckpointManager,
        cfg: SupervisorConfig = SupervisorConfig(),
        *,
        on_straggler: Optional[Callable[[int], None]] = None,
        fault_injector: Optional[Callable[[int], None]] = None,
        clock: Callable[[], float] = time.perf_counter,
    ):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.cfg = cfg
        self.on_straggler = on_straggler
        self.fault_injector = fault_injector
        self.clock = clock  # injectable for deterministic straggler tests
        self.history: List[StepRecord] = []
        self._ema: Optional[float] = None

    # ------------------------------------------------------------------

    def resume_or_init(
        self, params: Params, opt_state: Params, shardings: Optional[Params] = None
    ) -> Tuple[int, Params, Params]:
        """Restore the latest checkpoint if one exists."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return 0, params, opt_state
        bundle_like = {"params": params, "opt_state": opt_state}
        step, bundle = self.ckpt.restore(bundle_like, shardings=shardings)
        return step, bundle["params"], bundle["opt_state"]

    # ------------------------------------------------------------------

    def run(
        self,
        params: Params,
        opt_state: Params,
        batches: Iterator[Dict[str, Any]],
        *,
        start_step: int = 0,
        num_steps: int = 100,
    ) -> Tuple[Params, Params, List[StepRecord]]:
        step = start_step
        last_good = None
        for batch in batches:
            if step >= start_step + num_steps:
                break
            record = self._one_step(step, params, opt_state, batch)
            if record is None:  # NaN rollback: reload and skip this batch
                if last_good is None:
                    _, bundle = self.ckpt.restore(
                        {"params": params, "opt_state": opt_state}
                    )
                else:
                    bundle = last_good
                params, opt_state = bundle["params"], bundle["opt_state"]
                self.history.append(
                    StepRecord(step, float("nan"), 0.0, rolled_back=True)
                )
                step += 1
                continue
            params, opt_state, rec = record
            self.history.append(rec)
            if rec.straggler and self.on_straggler is not None:
                self.on_straggler(step)
            if self.cfg.checkpoint_every and (step + 1) % self.cfg.checkpoint_every == 0:
                self.ckpt.save(step + 1, {"params": params, "opt_state": opt_state})
                last_good = {"params": params, "opt_state": opt_state}
            step += 1
        self.ckpt.wait()
        return params, opt_state, self.history

    # ------------------------------------------------------------------

    def _one_step(self, step: int, params, opt_state, batch):
        retries = 0
        while True:
            t0 = self.clock()
            try:
                if self.fault_injector is not None:
                    self.fault_injector(step)
                new_params, new_opt, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
            except _InjectedFault:
                retries += 1
                if retries > self.cfg.max_step_retries:
                    raise
                continue
            dt = self.clock() - t0
            if self.cfg.nan_rollback and not np.isfinite(loss):
                return None
            straggler = False
            if self._ema is not None and dt > self.cfg.straggler_factor * self._ema:
                straggler = True
            a = self.cfg.straggler_ema
            self._ema = dt if self._ema is None else a * self._ema + (1 - a) * dt
            return new_params, new_opt, StepRecord(step, loss, dt, retries, False, straggler)


class _InjectedFault(RuntimeError):
    """Raised by test fault injectors to simulate transient device loss."""


def injected_fault() -> RuntimeError:
    return _InjectedFault("injected transient fault")
