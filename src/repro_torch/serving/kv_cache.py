"""Slot-based KV cache pool for continuous serving (counterpart of
repro.serving.kv_cache).

The ServingEngine forms discrete batches (the paper's service model); this
pool manages the device-resident cache buffers those batches decode into:
fixed-capacity slots, free-list allocation, O(1) claim/release, utilization
accounting for admission control.  A slot is one batch row of one cache
built by ``models.model.init_cache``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..models import model as M
from ..models.config import ModelConfig


@dataclasses.dataclass
class SlotStats:
    capacity: int
    in_use: int

    @property
    def utilization(self) -> float:
        return self.in_use / self.capacity if self.capacity else 0.0


class KVCachePool:
    def __init__(
        self,
        cfg: ModelConfig,
        n_slots: int,
        max_len: int,
        dtype: torch.dtype = torch.bfloat16,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.device = resolve_device(device)
        # one batched cache of capacity n_slots; slots are batch rows
        self.cache = M.init_cache(cfg, n_slots, max_len, dtype=dtype, device=self.device)
        self._free: List[int] = list(range(n_slots))
        self._lengths = [0] * n_slots

    def claim(self, n: int) -> Optional[List[int]]:
        """Claim n slots (a decode batch); None if the pool is exhausted."""
        if len(self._free) < n:
            return None
        slots = [self._free.pop() for _ in range(n)]
        for s in slots:
            self._lengths[s] = 0
        return slots

    def release(self, slots: List[int]) -> None:
        for s in slots:
            if s in self._free:
                raise ValueError(f"double release of slot {s}")
            self._lengths[s] = 0
            self._free.append(s)

    def lengths(self) -> torch.Tensor:
        return torch.tensor(self._lengths, dtype=torch.int32, device=self.device)

    def stats(self) -> SlotStats:
        return SlotStats(capacity=self.n_slots,
                         in_use=self.n_slots - len(self._free))

    def bytes_per_slot(self) -> int:
        """Bytes of one slot's cache as the reference counts them: every
        tensor of ``init_cache`` at its default dtype (bf16; the hybrid's
        SSM state f32) plus the int32 length counter the reference keeps
        beside them."""
        shapes = M.cache_shapes(self.cfg, 1, self.max_len).values()
        return int(sum(math.prod(shape) * dt.itemsize for shape, dt in shapes) + 4)
