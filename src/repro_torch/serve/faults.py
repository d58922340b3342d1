"""Fault-injection harness for the serve stack (DESIGN.md §11).

Chaos testing needs failures that are *injectable, seeded, and
deterministic*: the same seed and traffic always poison the same
documents, so degradation invariants (poison isolation, stats
reconciliation, breaker trips) are assertable bit-for-bit.

The production layers expose seams via
:func:`repro.core.outcomes.fault_point` -- ``"encode"``, ``"launch"``,
``"fallback"``, ``"link"`` -- each a single global ``None`` check when no
harness is armed.  :class:`FaultInjector` is a context manager that arms
those seams:

    inj = FaultInjector(seed=7).poison("encode", 3, 17).rate("fallback", 0.05)
    with inj:
        verdicts, counts = registry.admit_mixed_ex(docs, endpoints)
    assert inj.fired["encode"] == 2

Selection is by explicit key (``poison``) or by a seeded rate
(``rate``): a key is poisoned iff ``blake2b(seed:point:key)`` falls
under the rate -- stable across runs, processes, and machines (unlike
``hash()``, which is salted per process).  The ``"launch"`` point
receives the tuple of document keys in the launch and raises when ANY
poisoned key is aboard -- exactly the failure mode the bisecting
launch isolator (``BatchValidator.validate_isolated``) is built to
contain.
"""

from __future__ import annotations

import hashlib
from typing import Any, Dict, Set

from ..core.outcomes import InjectedFault, set_fault_hook

__all__ = ["FaultInjector", "InjectedFault"]


def _stable_unit(seed: int, point: str, key: Any) -> float:
    """Deterministic uniform-[0,1) draw for (seed, point, key)."""
    digest = hashlib.blake2b(
        f"{seed}:{point}:{key!r}".encode(), digest_size=8
    ).digest()
    return int.from_bytes(digest, "big") / 2.0**64


class FaultInjector:
    """Seeded, deterministic fault plan; arm with ``with injector:``."""

    def __init__(self, seed: int = 0):
        self.seed = seed
        self._keys: Dict[str, Set[Any]] = {}
        self._rates: Dict[str, float] = {}
        self.fired: Dict[str, int] = {}
        self._prev = None
        self._armed = False

    # -- plan construction (chainable) ----------------------------------------

    def poison(self, point: str, *keys: Any) -> "FaultInjector":
        """Poison specific document keys at ``point``."""
        self._keys.setdefault(point, set()).update(keys)
        return self

    def rate(self, point: str, probability: float) -> "FaultInjector":
        """Poison a seeded-deterministic fraction of keys at ``point``."""
        if not 0.0 <= probability <= 1.0:
            raise ValueError(f"rate {probability} outside [0, 1]")
        self._rates[point] = probability
        return self

    def selected(self, point: str, key: Any) -> bool:
        if key in self._keys.get(point, ()):
            return True
        p = self._rates.get(point, 0.0)
        return p > 0.0 and _stable_unit(self.seed, point, key) < p

    def poisoned_keys(self, point: str, keys) -> list:
        """The subset of ``keys`` this plan poisons at ``point``."""
        return [k for k in keys if self.selected(point, k)]

    # -- the armed hook --------------------------------------------------------

    def __call__(self, point: str, key: Any) -> None:
        if point == "launch" and isinstance(key, tuple):
            hit = self.poisoned_keys(point, key)
            if hit:
                self.fired[point] = self.fired.get(point, 0) + 1
                raise InjectedFault(
                    f"injected launch fault (poison keys {hit[:4]}"
                    f"{'...' if len(hit) > 4 else ''} aboard)"
                )
            return
        if self.selected(point, key):
            self.fired[point] = self.fired.get(point, 0) + 1
            raise InjectedFault(f"injected {point} fault at key {key!r}")

    # -- arming ----------------------------------------------------------------

    def __enter__(self) -> "FaultInjector":
        if self._armed:
            raise RuntimeError("FaultInjector already armed")
        self._prev = set_fault_hook(self)
        self._armed = True
        return self

    def __exit__(self, *exc) -> None:
        set_fault_hook(self._prev)
        self._prev = None
        self._armed = False
