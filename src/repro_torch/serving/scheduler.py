"""Batch schedulers: the SMDP policy (the paper) + benchmark policies.

A scheduler answers one question at each decision epoch (batch completion,
or arrival-at-idle): given s queued requests, what batch size now?
`0` means wait for more arrivals.

``as_action_table()`` lowers any stateless scheduler (SMDP / static /
greedy / Q-policy / oracle-phase) to the dense table the compiled event
kernel indexes.  Tables may carry a leading phase axis: a (K, L) stack,
one row per modulating phase; OraclePhaseScheduler selects the row from
the true switch trace, and its ``phase_at`` hands the same information to
the compiled lane as a per-arrival phase array.

Copied from the reference.  The scheduler banks, the online
AdaptiveController and the belief-filtered scheduler come with a later
slice of the port.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


class Scheduler:
    name = "base"

    def decide(self, queue_len: int) -> int:  # pragma: no cover - interface
        raise NotImplementedError

    def snapshot(self) -> dict:
        return {}

    def restore(self, state: dict) -> None:
        pass


class SMDPScheduler(Scheduler):
    """Table-driven scheduler from a solved SMDP (paper eq. 30).

    The table may be 1-D (queue-indexed) or a (K, L) phase-indexed stack;
    with a stack, ``phase`` selects the active row.
    """

    name = "smdp"

    def __init__(self, solution):
        self._set_table(solution.action_table())
        self.phase = 0

    def _set_table(self, table: np.ndarray) -> None:
        table = np.asarray(table, dtype=np.int64)
        if table.ndim not in (1, 2):
            raise ValueError(f"action table must be 1-D or (K, L); got {table.shape}")
        self.table = table
        self.s_max = table.shape[-1] - 1

    @classmethod
    def from_table(cls, table: np.ndarray) -> "SMDPScheduler":
        obj = cls.__new__(cls)
        obj._set_table(table)
        obj.phase = 0
        return obj

    def decide(self, queue_len: int) -> int:
        table = self.table
        if table.ndim == 1:
            row = table
        else:
            if not 0 <= self.phase < table.shape[0]:
                # same contract as the compiled lane's phases validation:
                # fail loudly instead of silently serving a clamped row
                raise ValueError(
                    f"phase {self.phase} outside table stack "
                    f"[0, {table.shape[0]})"
                )
            row = table[self.phase]
        return int(row[min(queue_len, len(row) - 1)])

    def phase_at(self, times) -> np.ndarray:
        """Per-arrival phases for the compiled lane: the pinned phase."""
        return np.full(len(times), int(self.phase), dtype=np.int64)

    def snapshot(self) -> dict:
        return {"phase": self.phase}

    def restore(self, state: dict) -> None:
        self.phase = int(state.get("phase", 0))


def _extend_last(t: np.ndarray, length: int) -> np.ndarray:
    """Extend a table along its last axis by repeating the final entry.

    The eq.-(30) infinite-state extension, so padded rows stay
    decision-for-decision identical to their originals.
    """
    width = length - t.shape[-1]
    if width <= 0:
        return t
    return np.concatenate([t, np.repeat(t[..., -1:], width, axis=-1)], axis=-1)


def _phase_stack(tables: Dict[int, np.ndarray]) -> np.ndarray:
    """(K, L) stack from a {phase: table} dict (contiguous 0..K-1 keys)."""
    keys = sorted(tables)
    if keys != list(range(len(keys))):
        raise ValueError(f"phase keys must be 0..K-1, got {keys}")
    tabs = [np.asarray(tables[k], dtype=np.int64) for k in keys]
    L = max(len(t) for t in tabs)
    return np.stack([_extend_last(t, L) for t in tabs])


class OraclePhaseScheduler(Scheduler):
    """Phase-aware with the true phase trace (estimation-free upper bound).

    Runs on both backends: the Python engine updates ``phase`` per admitted
    arrival (observe_arrival), and the compiled lane consumes the same
    information as a per-arrival phase array via ``phase_at`` +
    ``as_action_table`` (the (K, L) stack).
    """

    name = "smdp_oracle"

    def __init__(
        self,
        tables: Dict[int, np.ndarray],
        switch_log: Sequence[Tuple[float, int]],
    ):
        self.tables = {
            k: np.asarray(v, dtype=np.int64) for k, v in tables.items()
        }
        log = sorted(switch_log)
        self._switch_times = np.asarray([t for t, _ in log])
        self._phases = [p for _, p in log]
        self.phase = self._phases[0] if self._phases else 0

    def observe_arrival(self, t: float) -> None:
        if not self._phases:
            return
        i = int(np.searchsorted(self._switch_times, t, side="right")) - 1
        self.phase = self._phases[max(i, 0)]

    def phase_at(self, times) -> np.ndarray:
        """Vectorized phase lookup (the compiled lane's arrival phases)."""
        if not self._phases:
            return np.zeros(len(times), dtype=np.int64)
        i = np.searchsorted(self._switch_times, times, side="right") - 1
        return np.asarray(self._phases, dtype=np.int64)[np.maximum(i, 0)]

    def decide(self, queue_len: int) -> int:
        table = self.tables[self.phase]
        return int(table[min(queue_len, len(table) - 1)])

    def snapshot(self) -> dict:
        return {"phase": self.phase}

    def restore(self, state: dict) -> None:
        self.phase = state["phase"]


class StaticScheduler(Scheduler):
    """Fixed batch size b; waits until b requests are queued (Def. 1)."""

    def __init__(self, b: int):
        self.b = b
        self.name = f"static_{b}"

    def decide(self, queue_len: int) -> int:
        return self.b if queue_len >= self.b else 0


class GreedyScheduler(Scheduler):
    """Largest feasible batch now (Def. 2)."""

    name = "greedy"

    def __init__(self, b_min: int = 1, b_max: int = 32):
        self.b_min, self.b_max = b_min, b_max

    def decide(self, queue_len: int) -> int:
        if queue_len < self.b_min:
            return 0
        return min(queue_len, self.b_max)


class QPolicyScheduler(Scheduler):
    """Control-limit policy (Def. 3): serve min(s, B_max) iff s >= Q."""

    def __init__(self, q: int, b_max: int = 32):
        self.q, self.b_max = q, b_max
        self.name = f"qpolicy_{q}"

    def decide(self, queue_len: int) -> int:
        return min(queue_len, self.b_max) if queue_len >= self.q else 0


def as_action_table(scheduler: Scheduler, b_max: int) -> np.ndarray:
    """Lower a stateless scheduler to the dense table decide() implements.

    The compiled simulator indexes ``table[min(s, len - 1)]`` — identical
    to each scheduler's decide() for every queue length, because all
    these families are constant beyond their largest interesting state.
    Phase-indexed schedulers lower to their (K, L) stack.  Schedulers with
    no static table raise: they stay on the Python backend.
    """
    if isinstance(scheduler, OraclePhaseScheduler):
        return _phase_stack(scheduler.tables)
    if isinstance(scheduler, SMDPScheduler):
        return np.asarray(scheduler.table, dtype=np.int64)
    if isinstance(scheduler, StaticScheduler):
        s = np.arange(max(scheduler.b, b_max) + 1)
        return np.where(s >= scheduler.b, scheduler.b, 0).astype(np.int64)
    if isinstance(scheduler, GreedyScheduler):
        cap = min(scheduler.b_max, b_max)
        s = np.arange(max(scheduler.b_min, cap) + 1)
        return np.where(
            s >= scheduler.b_min, np.minimum(s, cap), 0
        ).astype(np.int64)
    if isinstance(scheduler, QPolicyScheduler):
        cap = min(scheduler.b_max, b_max)
        s = np.arange(max(scheduler.q, cap) + 1)
        return np.where(s >= scheduler.q, np.minimum(s, cap), 0).astype(
            np.int64
        )
    raise TypeError(
        f"{type(scheduler).__name__} has no static action table; "
        "run it on backend='python'"
    )
