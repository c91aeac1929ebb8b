"""Cross-cell WAL shipping: a second, independent tail on one log.

A copy of the JAX package's ``federation/shipper.py``.

``ReplicationLog.take(after_lsn)`` is consumer-stateless — each caller
brings its own cursor — so a home cell's primary can feed TWO shippers
from the same sequenced log: the in-cell hot standby
(service/replication.py) and this :class:`WalShipper` streaming the same
``REPL_SYNC``/``REPL_APPEND`` frames to the DR cell's standby across
the cell boundary (docs/FEDERATION.md "Cross-cell shipping").

What changes at the cell boundary:

* **Fault site** — every outbound frame arms ``cell.ship``: a
  ``torn_frame`` rule tears mid-record, the loop reconnects and
  re-SYNCs, and the receiving standby's ``lsn <= applied_lsn`` overlap
  check makes the replay idempotent (never double-applies — the chaos
  matrix pins this).
* **Metrics** — shipping observes under ``cell_shipped`` /
  ``cell_ship_resyncs`` / ``cell_ship_lag_ms`` so cross-cell lag is
  distinguishable from in-cell replication lag on one dashboard
  (docs/OBSERVABILITY.md).
* **Fencing scope** — ``on_fenced`` is wired to the whole CELL, not
  one server: when the DR cell promotes past our term, the home cell's
  every shard fences (federation/cell.py ``Cell.fence``), so a zombie
  home cell refuses every write with the typed ``fenced`` error.

The receiving standby persists applied records into its OWN segment
WAL (service/server.py receive-side write-through), which is what the
"resume bit-identical from the remote WAL tail" law recovers from.
"""

from __future__ import annotations

from ..service import protocol as P
from ..service.replication import ReplicationShipper


class WalShipper(ReplicationShipper):
    """The home cell's background thread streaming its WAL to a remote
    cell's standby.  Same loop, frames and re-SYNC/fencing machinery as
    the in-cell :class:`~..service.replication.ReplicationShipper`;
    only the fault site, metric names and the cell stamp differ."""

    SITE = "cell.ship"
    M_SHIPPED = "cell_shipped"
    M_RESYNCS = "cell_ship_resyncs"
    M_LAG_MS = "cell_ship_lag_ms"

    def __init__(self, log, standby_address, *, cell_id: str,
                 target_cell: str, state_fn, term_fn, on_fenced,
                 metrics=None, timeout: float = 5.0) -> None:
        super().__init__(log, standby_address, state_fn=state_fn,
                         term_fn=term_fn, on_fenced=on_fenced,
                         metrics=metrics, timeout=timeout)
        self.cell_id = str(cell_id)
        self.target_cell = str(target_cell)

    def _ship(self, msg_type: int, header: dict) -> None:
        # the cell stamp is additive observability: the receiving cell's
        # telemetry can attribute a feed to its origin cell
        header = dict(header)
        header["cell"] = self.cell_id
        super()._ship(msg_type, header)

    def _send_frame(self, msg_type: int, header: dict) -> None:
        P.send_msg(self._sock, msg_type, header, site="cell.ship")
