"""Durability: the disk-backed WAL + crash recovery (docs/RESILIENCE.md
"Durability & recovery").

A copy of the JAX package's ``durability/``: the same records give
byte-equal segments in both packages, and each package's recovery
reads the other's WAL, torn tails included.

The served-index daemon appends every state-mutating transition to a
segment-based write-ahead log (:mod:`.wal`); Snapshot-v2 seals become
incremental checkpoints (a seal records a truncation watermark, old
segments are garbage-collected) and a restart is "load last checkpoint
+ replay the WAL tail" (:mod:`.recover`) — bounding recovery by tail
length instead of snapshot size.
"""

from .wal import (
    DEFAULT_SEGMENT_BYTES,
    FsyncPolicy,
    WriteAheadLog,
)
from .recover import (
    RecoveryError,
    check_invariants,
    last_valid_lsn,
    read_autopilot_records,
    recover_unstarted,
    replay_wal_tail,
    truncate_wal_copy,
    wal_total_bytes,
)

__all__ = [
    "DEFAULT_SEGMENT_BYTES",
    "FsyncPolicy",
    "WriteAheadLog",
    "RecoveryError",
    "check_invariants",
    "last_valid_lsn",
    "read_autopilot_records",
    "recover_unstarted",
    "replay_wal_tail",
    "truncate_wal_copy",
    "wal_total_bytes",
]
