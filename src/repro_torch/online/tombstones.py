"""Tombstones — a packed deletion bitmask over leaf slots (counterpart of
``repro.online.tombstones``).

Deletes never touch the index arrays: the leaf level, the payload codes and
the navigation prototypes stay frozen. A delete flips one bit here; at
search time the unpacked validity mask threads into the leaf ranking of
every mode (``ops.rank_gathered`` for dense and beam, ``ops.scan_quantized``
for two-stage) through ``ref.fold_slot_valid``, so masked slots price at
``distances.BIG`` and deleted ids vanish from all results.

Storage is one bit per leaf slot (``uint8`` words on the host, bit ``i & 7``
of word ``i >> 3``, the layout ``repro`` saves). The device ``bool[n]``
mask is made on first use and cached; :meth:`TombstoneSet.add` invalidates
it, so a serving epoch uploads the mask at most once per write batch.

A prototype at levels >= 1 may be a copy of a deleted point: prototypes are
navigation, not results. Compaction (``online.compact``) rebuilds the
affected groups and retires the tombstones.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve_device


class TombstoneSet:
    """Packed per-slot deletion bits + a cached device validity mask."""

    def __init__(self, n_slots: int, bits: Optional[np.ndarray] = None,
                 device="cuda"):
        self.n_slots = int(n_slots)
        self.device = resolve_device(device)
        n_words = -(-self.n_slots // 8)
        if bits is None:
            bits = np.zeros(n_words, np.uint8)
        else:
            bits = np.array(bits, np.uint8)
            if bits.shape != (n_words,):
                raise ValueError(
                    f"tombstone bitmap shape {bits.shape} != ({n_words},) "
                    f"for {self.n_slots} slots")
        self._bits = bits
        self.count = int(self._unpacked().sum())
        self._mask_cache: Optional[torch.Tensor] = None  # True = live

    def _unpacked(self) -> np.ndarray:
        return np.unpackbits(self._bits, count=self.n_slots, bitorder="little")

    # -- mutation -------------------------------------------------------------

    def add(self, slots) -> int:
        """Mark leaf slots deleted. Returns the number of *newly* dead
        slots (re-deleting is a no-op, not an error)."""
        slots = np.unique(np.asarray(slots, np.int64).reshape(-1))
        if slots.size == 0:
            return 0
        if slots.min() < 0 or slots.max() >= self.n_slots:
            raise IndexError(f"tombstone slot out of range [0, {self.n_slots})")
        words, bit = slots >> 3, (slots & 7).astype(np.uint8)
        masks = np.left_shift(np.uint8(1), bit)
        fresh = int(((self._bits[words] & masks) == 0).sum())
        if fresh:
            np.bitwise_or.at(self._bits, words, masks)
            self.count += fresh
            self._mask_cache = None
        return fresh

    # -- queries --------------------------------------------------------------

    def contains(self, slots) -> np.ndarray:
        slots = np.asarray(slots, np.int64)
        return (self._bits[slots >> 3] >> (slots & 7).astype(np.uint8)) & 1 != 0

    def ratio(self, n_valid: int) -> float:
        """Dead fraction of the (originally valid) leaf population: the
        compaction trigger metric."""
        return self.count / max(int(n_valid), 1)

    def valid_mask(self) -> torch.Tensor:
        """Device ``bool[n_slots]`` validity mask (True = live), cached
        until the next :meth:`add`: the ``slot_valid`` array the search
        modes receive."""
        if self._mask_cache is None:
            live = ~self._unpacked().astype(bool)
            self._mask_cache = torch.from_numpy(live).to(self.device)
        return self._mask_cache

    def dead_slots(self) -> np.ndarray:
        """All tombstoned slot indices (compaction input)."""
        return np.nonzero(self._unpacked())[0]

    # -- persistence ----------------------------------------------------------

    @property
    def bits(self) -> np.ndarray:
        """The packed bitmap (index save format v3)."""
        return self._bits

    @property
    def nbytes(self) -> int:
        return int(self._bits.nbytes)

    def __repr__(self):
        return f"TombstoneSet(n_slots={self.n_slots}, dead={self.count})"
