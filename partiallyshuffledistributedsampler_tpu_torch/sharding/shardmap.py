"""The rank→shard map: one static, versioned partition of the rank space.

A copy of the JAX package's ``sharding/shardmap.py`` (pure standard
library): ``to_wire``, ``from_wire`` and ``fingerprint`` are byte-equal
across the two packages.

A sharded serving plane (docs/SHARDING.md) splits a spec's world into N
contiguous rank slices, one per shared-nothing ``IndexServer`` shard.
The map is the only piece of global state: it is derived purely from
``(world, n_shards)``, carries a monotonically increasing ``version``
(bumped by every cross-shard reshard commit), and a ``fingerprint`` over
its canonical wire form so a client, a router snapshot, and every shard
can cheaply agree they hold the same partition.  Shard ``i`` owns ranks
``[floor(i*W/N), floor((i+1)*W/N))`` — contiguous, so ownership lookup
is a bisect and slices stay aligned with the spec's blocked partition.
"""

from __future__ import annotations

import json
import zlib
from bisect import bisect_right
from typing import Optional, Sequence


class ShardMap:
    """Immutable-by-convention rank→shard partition (wire-serializable)."""

    def __init__(self, world: int, slices: Sequence[tuple],
                 addrs: Optional[Sequence] = None, *, version: int = 1):
        self.world = int(world)
        if self.world < 1:
            raise ValueError(f"world must be >= 1, got {world}")
        self.version = int(version)
        self.slices = tuple((int(lo), int(hi)) for lo, hi in slices)
        if not self.slices:
            raise ValueError("a shard map needs at least one shard")
        # Order-independent partition check: slice POSITION is a stable
        # shard id, not a rank-space ordinal — a split appends its new
        # shard at the end and a merge leaves an empty slice behind, so
        # ids survive elastic transforms (docs/AUTOPILOT.md).  The
        # non-empty slices must still tile [0, world) exactly.
        live = sorted(
            ((lo, hi, sid) for sid, (lo, hi) in enumerate(self.slices)
             if hi != lo),
            key=lambda t: t[0])
        cursor = 0
        for lo, hi, sid in live:
            if hi < lo or lo != cursor:
                raise ValueError(
                    f"shard {sid} slice [{lo}, {hi}) is not part of a "
                    f"contiguous cover of the rank space "
                    f"(expected lo={cursor})")
            cursor = hi
        if cursor != self.world:
            raise ValueError(
                f"slices cover [0, {cursor}) but world is {self.world}")
        self.addrs = list(addrs) if addrs is not None \
            else [None] * len(self.slices)
        if len(self.addrs) != len(self.slices):
            raise ValueError("one address per shard required")
        self.addrs = [None if a is None else (str(a[0]), int(a[1]))
                      for a in self.addrs]
        #: bisect keys over the rank-ordered NON-EMPTY slices, paired
        #: with the shard id owning each
        self._his = [hi for _, hi, _ in live]
        self._sids = [sid for _, _, sid in live]

    # ----------------------------------------------------------- derivation
    @classmethod
    def for_world(cls, world: int, n_shards: int, *,
                  version: int = 1) -> "ShardMap":
        """The canonical contiguous partition of ``world`` ranks over
        ``n_shards`` shards: shard i owns ``[i*W//N, (i+1)*W//N)``."""
        world, n = int(world), int(n_shards)
        if n < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        slices = [(i * world // n, (i + 1) * world // n) for i in range(n)]
        return cls(world, slices, version=version)

    def rebalanced(self, new_world: int) -> "ShardMap":
        """The post-reshard map: same shard count and addresses, the
        canonical slices over ``new_world``, ``version + 1``.  Shards a
        merge emptied STAY empty — a world change redistributes ranks
        over the live shards only, in their rank order."""
        new_world = int(new_world)
        live = sorted((i for i, (lo, hi) in enumerate(self.slices)
                       if hi != lo),
                      key=lambda i: self.slices[i][0])
        n = len(live)
        slices = [(0, 0)] * len(self.slices)
        for pos, sid in enumerate(live):
            slices[sid] = (pos * new_world // n,
                           (pos + 1) * new_world // n)
        m = ShardMap(new_world, slices, list(self.addrs),
                     version=self.version + 1)
        return m

    # ------------------------------------------------- elastic transforms
    # Each returns a NEW map at ``version + 1`` with stable shard ids —
    # the autopilot's shard-map arm composes these and hands the result
    # to the router's two-phase remap (docs/AUTOPILOT.md).
    def split(self, shard_id: int, at: Optional[int] = None) -> "ShardMap":
        """Split ``shard_id``'s slice at rank ``at`` (default midpoint).
        The upper half moves to a NEW shard appended at the end, so
        every existing shard keeps its id; the new shard starts with no
        address (the plane assigns one when it starts the server)."""
        sid = int(shard_id)
        lo, hi = self.slices[sid]
        if hi - lo < 2:
            raise ValueError(
                f"shard {sid} slice [{lo}, {hi}) is too small to split")
        cut = lo + (hi - lo) // 2 if at is None else int(at)
        if not lo < cut < hi:
            raise ValueError(
                f"split point {cut} outside shard {sid}'s open "
                f"interval ({lo}, {hi})")
        slices = list(self.slices)
        slices[sid] = (lo, cut)
        slices.append((cut, hi))
        return ShardMap(self.world, slices, list(self.addrs) + [None],
                        version=self.version + 1)

    def merged(self, into_id: int, from_id: int) -> "ShardMap":
        """Fold ``from_id``'s whole slice into rank-adjacent
        ``into_id``.  ``from_id`` keeps its id with an EMPTY slice, so
        no other shard's identity moves; its address is dropped (the
        plane stops the emptied server)."""
        into, frm = int(into_id), int(from_id)
        (ilo, ihi), (flo, fhi) = self.slices[into], self.slices[frm]
        if into == frm or fhi == flo:
            raise ValueError(
                f"cannot merge shard {frm} into {into}: nothing to fold")
        if ihi == flo:
            new = (ilo, fhi)
        elif fhi == ilo:
            new = (flo, ihi)
        else:
            raise ValueError(
                f"shards {into} [{ilo}, {ihi}) and {frm} [{flo}, {fhi}) "
                f"are not rank-adjacent")
        slices = list(self.slices)
        slices[into], slices[frm] = new, (0, 0)
        addrs = list(self.addrs)
        addrs[frm] = None
        return ShardMap(self.world, slices, addrs,
                        version=self.version + 1)

    def migrated(self, from_id: int, to_id: int, count: int) -> "ShardMap":
        """Move ``count`` boundary ranks from ``from_id`` to
        rank-adjacent ``to_id`` (a partial merge: both shards stay
        live, the shared boundary shifts)."""
        frm, to, count = int(from_id), int(to_id), int(count)
        (flo, fhi), (tlo, thi) = self.slices[frm], self.slices[to]
        if not 1 <= count < fhi - flo:
            raise ValueError(
                f"can move 1..{fhi - flo - 1} ranks out of shard {frm}, "
                f"asked for {count}")
        slices = list(self.slices)
        if fhi == tlo:      # donor sits below: its top ranks move
            slices[frm], slices[to] = (flo, fhi - count), (tlo - count, thi)
        elif thi == flo:    # donor sits above: its bottom ranks move
            slices[frm], slices[to] = (flo + count, fhi), (tlo, thi + count)
        else:
            raise ValueError(
                f"shards {frm} [{flo}, {fhi}) and {to} [{tlo}, {thi}) "
                f"are not rank-adjacent")
        return ShardMap(self.world, slices, list(self.addrs),
                        version=self.version + 1)

    def moved_spans(self, new: "ShardMap") -> list:
        """The rank spans whose owner differs between this map and
        ``new``: ``[(lo, hi, old_shard, new_shard), ...]`` in rank
        order — exactly the state the migration barrier must hand
        over.  Both maps must cover the same world."""
        if new.world != self.world:
            raise ValueError(
                f"moved_spans needs equal worlds, got {self.world} "
                f"and {new.world}")
        cuts = sorted({0, self.world,
                       *(b for s in (self, new)
                         for lo, hi in s.slices for b in (lo, hi))})
        out: list = []
        for lo, hi in zip(cuts, cuts[1:]):
            if lo >= hi or hi > self.world:
                continue
            a, b = self.owner(lo), new.owner(lo)
            if a == b:
                continue
            if out and out[-1][1] == lo and out[-1][2] == a \
                    and out[-1][3] == b:
                out[-1] = (out[-1][0], hi, a, b)
            else:
                out.append((lo, hi, a, b))
        return out

    # -------------------------------------------------------------- lookup
    @property
    def n_shards(self) -> int:
        return len(self.slices)

    def owner(self, rank: int) -> int:
        """The shard id owning ``rank`` (contiguous slices → bisect)."""
        rank = int(rank)
        if not 0 <= rank < self.world:
            raise ValueError(f"rank {rank} outside world {self.world}")
        return self._sids[bisect_right(self._his, rank)]

    def ranks(self, shard_id: int) -> tuple:
        """The ``[lo, hi)`` slice shard ``shard_id`` owns."""
        return self.slices[int(shard_id)]

    def owns(self, shard_id: int, rank: int) -> bool:
        lo, hi = self.slices[int(shard_id)]
        return lo <= int(rank) < hi

    def addr(self, shard_id: int):
        return self.addrs[int(shard_id)]

    def set_addr(self, shard_id: int, addr) -> None:
        """Record where a shard listens (plane startup / failover)."""
        self.addrs[int(shard_id)] = (str(addr[0]), int(addr[1]))

    # ---------------------------------------------------------------- wire
    def to_wire(self) -> dict:
        d = {
            "version": self.version,
            "world": self.world,
            "shards": [
                {"id": i, "ranks": [lo, hi],
                 "addr": None if self.addrs[i] is None
                 else [self.addrs[i][0], self.addrs[i][1]]}
                for i, (lo, hi) in enumerate(self.slices)
            ],
        }
        d["fingerprint"] = self.fingerprint()
        return d

    @classmethod
    def from_wire(cls, d: dict) -> "ShardMap":
        shards = sorted(d["shards"], key=lambda s: int(s["id"]))
        return cls(
            d["world"],
            [(s["ranks"][0], s["ranks"][1]) for s in shards],
            [s.get("addr") for s in shards],
            version=d.get("version", 1),
        )

    def fingerprint(self) -> str:
        """Stable hex digest of the canonical map (addresses included —
        a failover that moves a shard is a different deployment)."""
        body = json.dumps(
            {"version": self.version, "world": self.world,
             "slices": [list(s) for s in self.slices],
             "addrs": [None if a is None else list(a) for a in self.addrs]},
            sort_keys=True, separators=(",", ":")).encode()
        return f"{zlib.crc32(body) & 0xFFFFFFFF:08x}"

    def __eq__(self, other) -> bool:
        return (isinstance(other, ShardMap)
                and self.to_wire() == other.to_wire())

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"ShardMap(v{self.version}, world={self.world}, "
                f"slices={list(self.slices)})")
