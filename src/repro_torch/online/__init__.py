"""Online mutability over an otherwise frozen PDASC index (counterpart of
``repro.online``): live upserts, deletes and epoch-swap compaction.

* ``delta``      — capacity-bounded fp32 append tier for recent upserts,
                   leaf-routed at insert time, searched by an exact
                   pairwise scan merged into every mode's results.
* ``tombstones`` — packed deletion bitmask, passed to the leaf ranking of
                   every search mode as a validity mask.
* ``compact``    — group-granular epoch-swap rebuild folding both tiers
                   into a fresh index.
* ``epoch``      — the RCU handle: one reference to the live epoch, write
                   runs with per-op error isolation, the swap policy.
"""

from repro_torch.online.compact import compact_index, live_dataset
from repro_torch.online.delta import DeltaBuffer, merge_topk
from repro_torch.online.epoch import EpochHandle, WriteLog
from repro_torch.online.tombstones import TombstoneSet

__all__ = [
    "DeltaBuffer",
    "EpochHandle",
    "TombstoneSet",
    "WriteLog",
    "compact_index",
    "live_dataset",
    "merge_topk",
]
