"""Device-resident appearance-crop bank (port of ``busca_tpu.assoc.bank``).

Crops are born on the device (the crop op produces them from the frame), so
they stay there: the bank is a fixed-capacity ``[capacity, H, W, 3]`` uint8
tensor on the engine's device, tracks keep host numpy mirrors tagged with a
unit id, and the association engine ships slot indices — the scorer gathers
the crops from the bank.  Slot 0 is permanently the all-zero crop (the
reference's missing-candidate / incomplete-memory image, busca/network.py:
300-308, 352-355).

Eviction is LRU with per-call pinning: the bank is a cache, the host mirror
re-uploads on a miss, so capacity affects speed, never results.  Unlike the
JAX bank, whose functional scatter returns a new array, this bank is updated
in place with ``index_copy_``.
"""

from __future__ import annotations

import itertools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class BankedCrop(np.ndarray):
    """A host crop mirror that remembers its bank unit id.  Views and copies
    drop the uid (they are new buffers as far as the bank is concerned)."""

    uid: Optional[int]

    def __array_finalize__(self, obj):
        self.uid = None


def tag(arr: np.ndarray, uid: int) -> "BankedCrop":
    v = arr.view(BankedCrop)
    v.uid = uid
    return v


# One process-wide uid space, so crop identities never collide across banks.
_uid_iter = itertools.count(1)


def next_uid() -> int:
    return next(_uid_iter)


class DeviceCropBank:
    """Fixed-capacity LRU cache of ReID crops in device memory."""

    def __init__(self, crop_hw: Tuple[int, int] = (384, 128),
                 capacity: int = 4096, device="cuda"):
        if capacity < 2:
            raise ValueError("capacity must be >= 2 (slot 0 is reserved)")
        self.crop_hw = tuple(crop_hw)
        self.capacity = int(capacity)
        self.device = torch.device(device)
        self._array: Optional[torch.Tensor] = None  # lazy
        self._slot_of = {}  # uid -> slot
        self._uid_at: List[Optional[int]] = [None] * self.capacity
        # slot 0 reserved for the zero crop; never allocated
        self._free = list(range(self.capacity - 1, 0, -1))
        self._last_used = np.zeros(self.capacity, np.int64)
        self._clock = 0
        self._pinned: set = set()

    @property
    def array(self) -> torch.Tensor:
        """The device bank tensor (materialized on first use)."""
        if self._array is None:
            h, w = self.crop_hw
            self._array = torch.zeros((self.capacity, h, w, 3),
                                      dtype=torch.uint8, device=self.device)
        return self._array

    def __len__(self):
        return self.capacity - 1 - len(self._free)

    def _touch(self, slot: int):
        self._clock += 1
        self._last_used[slot] = self._clock

    def _alloc(self) -> int:
        """One free slot, evicting the LRU unpinned resident if needed."""
        if self._free:
            slot = self._free.pop()
        else:
            used = self._last_used.copy()
            used[0] = np.iinfo(np.int64).max
            if self._pinned:
                used[list(self._pinned)] = np.iinfo(np.int64).max
            slot = int(used.argmin())
            if used[slot] == np.iinfo(np.int64).max:
                raise RuntimeError(
                    f"crop bank exhausted: all {self.capacity} slots pinned "
                    "by one call — raise the capacity"
                )
            old = self._uid_at[slot]
            if old is not None:
                del self._slot_of[old]
        self._uid_at[slot] = None
        self._touch(slot)
        self._pinned.add(slot)
        return slot

    def _register(self, slot: int, uid: int):
        self._uid_at[slot] = uid
        self._slot_of[uid] = slot

    def _release(self, slots: Sequence[int]):
        """Roll back registrations whose pixels were never written."""
        for slot in slots:
            uid = self._uid_at[slot]
            if uid is not None:
                del self._slot_of[uid]
            self._uid_at[slot] = None
            self._free.append(slot)

    def _write(self, slots: List[int], crops: torch.Tensor):
        index = torch.tensor(slots, dtype=torch.long, device=self.device)
        self.array.index_copy_(0, index, crops.to(self.device, torch.uint8))

    def put_device(self, crops_device: torch.Tensor, n: int) -> List[int]:
        """Admit the first ``n`` rows of a device crop batch (float with
        integral 0..255 values, or uint8) without a host round-trip.
        Returns the ``n`` unit ids, to attach to the host mirrors via
        :func:`tag`."""
        if not 0 <= n <= crops_device.shape[0]:
            raise ValueError(f"n={n} outside the batch of "
                             f"{crops_device.shape[0]} crops")
        uids, slots = [], []
        try:
            try:
                for _ in range(n):
                    slot = self._alloc()
                    uid = next_uid()
                    self._register(slot, uid)
                    uids.append(uid)
                    slots.append(slot)
                if slots:
                    self._write(slots, crops_device[:n])
            except Exception:
                self._release(slots)
                raise
        finally:
            self._pinned.clear()
        return uids

    def resolve(self, crops: Sequence[Optional[np.ndarray]]) -> np.ndarray:
        """Slot indices for a batch of host crop mirrors.

        ``None`` maps to slot 0 (the zero crop).  Resident uids hit the
        cache; the rest are uploaded in one batched copy.  All returned slots
        are protected from eviction for the duration of the call."""
        slots = np.zeros(len(crops), np.int32)
        missing: List[Tuple[int, np.ndarray]] = []
        try:
            try:
                for i, crop in enumerate(crops):
                    if crop is None:
                        continue
                    uid = getattr(crop, "uid", None)
                    slot = self._slot_of.get(uid) if uid is not None else None
                    if slot is not None:
                        self._touch(slot)
                        self._pinned.add(slot)
                        slots[i] = slot
                        continue
                    slot = self._alloc()
                    if uid is None:
                        uid = next_uid()
                        if isinstance(crop, BankedCrop):
                            crop.uid = uid
                    self._register(slot, uid)
                    slots[i] = slot
                    missing.append((i, crop))
                if missing:
                    up = torch.from_numpy(np.stack(
                        [np.asarray(c, dtype=np.uint8) for _, c in missing]
                    ))
                    if tuple(up.shape[1:]) != self.crop_hw + (3,):
                        raise ValueError(
                            f"crop shape {tuple(up.shape[1:])} does not "
                            f"match the bank's {self.crop_hw + (3,)}"
                        )
                    self._write([int(slots[i]) for i, _ in missing], up)
            except Exception:
                self._release([int(slots[i]) for i, _ in missing])
                raise
        finally:
            self._pinned.clear()
        return slots
