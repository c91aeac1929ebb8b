"""The port's counterpart of the JAX package's ``tests/test_federation.py``.

Every case runs on ``partiallyshuffledistributedsampler_tpu_torch`` with its
specs on ``backend="cpu"`` (no card), under the port's lock-order
sanitizer; the cross-package checks at the end hold the port against the
JAX package.  The JAX file's text follows.

Multi-cell federation: shipping, cell-kill DR, fencing, migration.

The acceptance laws (docs/FEDERATION.md):

* **DR law** — kill an ENTIRE cell (primary shards + standbys + router)
  mid-epoch, in all three spec modes; after the DR cell promotes and
  the directory flips, every tenant resumes BIT-IDENTICAL from the
  remote cell's shipped WAL tail (the exactly-once union law intact).
* **Migration law** — a live tenant migrates between cells mid-epoch
  with zero duplicate and zero skipped indices; the two-phase cutover
  (freeze + drain → flip + fence) never leaks a frozen barrier.
* **Fencing law** — the superseded cell refuses EVERY write with the
  typed ``fenced`` error; a zombie cell can never double-serve a span.
* **Namespace law** — a client dialing the wrong cell rides the typed
  retryable ``wrong_cell`` redirect (``wrong_shard``'s shape, one layer
  up) to its home cell; directory adoption is version-gated.
* **Capability law** — each cell signs with its own keyring; after a
  failover the outstanding grant is still honored (the trust bundle
  holds the dead cell's key) and a rotated-away key fails LOUDLY with
  the re-issue ``CapabilityError``, never a silent accept/drop.
"""

from __future__ import annotations

import dataclasses
import json
import signal
import socket
import time
import warnings

import numpy as np
import pytest

from partiallyshuffledistributedsampler_tpu_torch.capability import (
    CapabilityError,
    EpochCapability,
)
from partiallyshuffledistributedsampler_tpu_torch.federation import (
    CellDirectory,
    CellKeyring,
    DirectoryRef,
    Federation,
    TrustBundle,
    sign_capability,
    verify_capability,
)
from partiallyshuffledistributedsampler_tpu_torch.ops.mixture import MixtureSpec
from partiallyshuffledistributedsampler_tpu_torch.service import (
    PartialShuffleSpec,
    ServiceIndexClient,
)
from partiallyshuffledistributedsampler_tpu_torch.service import protocol as P
from partiallyshuffledistributedsampler_tpu_torch.service.client import (
    ServiceError,
)
from partiallyshuffledistributedsampler_tpu_torch.tenancy import tenant_id_for

from partiallyshuffledistributedsampler_tpu_torch.analysis import lockorder
from partiallyshuffledistributedsampler_tpu_torch.service import IndexServer
from partiallyshuffledistributedsampler_tpu import capability as JC
from partiallyshuffledistributedsampler_tpu import federation as JF
from partiallyshuffledistributedsampler_tpu import service as JS
from partiallyshuffledistributedsampler_tpu.ops.mixture import (
    MixtureSpec as JMixtureSpec,
)

#: every port spec of this file regenerates on the host
BACKEND = "cpu"


#: each case's own wall-clock limit (pytest-timeout is not installed):
#: a hung socket fails its case, not the whole run
CASE_TIMEOUT_S = 90


@pytest.fixture(autouse=True)
def _case_deadline():
    def expired(signum, frame):
        raise TimeoutError(f"the case ran past {CASE_TIMEOUT_S} s")

    prev = signal.signal(signal.SIGALRM, expired)
    signal.alarm(CASE_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, prev)


@pytest.fixture(autouse=True)
def _port_sanitizer():
    """The port's lock-order graph over every lock a case creates: a
    recorded cycle, or a non-daemon thread left running, fails it."""
    prior = lockorder.is_enabled()
    lockorder.reset()
    lockorder.enable()
    baseline = lockorder.thread_snapshot()
    yield
    found = lockorder.violations()
    lockorder.reset()
    if not prior:
        lockorder.disable()
    assert not found, lockorder.render_violations(found)
    leaked = lockorder.leaked_threads(baseline)
    assert not leaked, lockorder.thread_stacks(leaked)


pytestmark = pytest.mark.federation


# ------------------------------------------------------------- the specs
def plain_spec(world=2):
    return PartialShuffleSpec.plain(300, window=16, seed=7, world=world, backend=BACKEND)


def mixture_spec(world=2):
    ms = MixtureSpec([100, 200, 50], [5, 3, 2], block=16)
    return PartialShuffleSpec.mixture(ms, seed=3, world=world,
                                      epoch_samples=300, backend=BACKEND)


def shard_spec(world=2):
    return PartialShuffleSpec.shard([17, 5, 29, 11, 40, 8, 23, 9], window=4,
                                    seed=9, world=world,
                                    within_shard_shuffle=True, backend=BACKEND)


SPECS = {"plain": plain_spec, "mixture": mixture_spec, "shard": shard_spec}


def _tenant(spec):
    return tenant_id_for(spec.fingerprint(include_world=False))


def _client(addr, rank, **kw):
    kw.setdefault("batch", 23)
    kw.setdefault("backoff_base", 0.01)
    kw.setdefault("reconnect_timeout", 0.5)
    return ServiceIndexClient(addr, rank=rank, **kw)


# ------------------------------------------------------- directory unit laws
def test_directory_flip_versioning_and_wire_roundtrip():
    d = CellDirectory({"east": ("127.0.0.1", 7001),
                       "west": ("127.0.0.1", 7002)},
                      default="east", dr={"east": "west", "west": "east"})
    assert d.home("t-any") == "east"
    assert d.dr_for("east") == "west"
    d2 = d.flip("t-any", "west")
    assert (d2.version, d2.home("t-any"), d.home("t-any")) == \
        (d.version + 1, "west", "east")
    d3 = d2.flip_cell("east", "west")
    assert d3.default == "west" and d3.version == d2.version + 1
    rt = CellDirectory.from_wire(d3.to_wire())
    assert rt.to_wire() == d3.to_wire()
    assert rt.fingerprint() == d3.fingerprint()
    with pytest.raises(ValueError):
        d.flip("t", "nowhere")


def test_directory_ref_is_monotonic():
    d1 = CellDirectory({"east": ("h", 1)})
    ref = DirectoryRef()
    assert ref.current() is None
    ref.set(d1)
    stale = CellDirectory({"east": ("h", 1)}, version=1)
    with pytest.raises(ValueError):
        ref.set(stale)  # a racing stale flip loses loudly
    ref.set(d1.flip_cell("east", "east"))
    assert ref.current().version == 2


# --------------------------------------------------------- keyring unit laws
def test_keyring_rotation_keeps_old_grants_until_retire():
    ring = CellKeyring("east", root="deployment-secret")
    cap = EpochCapability(fingerprint="fp", epoch=0, seed=11,
                          generation=0, world=1)
    signed = sign_capability(ring, cap)
    assert (signed.cell, signed.kid) == ("east", 1)
    assert verify_capability(ring, signed)
    ring.rotate()
    # rotation must not orphan outstanding grants at once
    assert verify_capability(ring, signed)
    resigned = sign_capability(ring, cap)
    assert resigned.kid == 2
    ring.retire(1)
    with pytest.raises(CapabilityError):
        verify_capability(ring, signed)  # loud re-issue, never ambiguity
    with pytest.raises(ValueError):
        ring.retire(2)  # the active signer cannot be retired


def test_trust_bundle_resolves_per_cell_and_is_loud_on_unknown():
    east = CellKeyring("east", root="s")
    west = CellKeyring("west", root="s")
    trust = TrustBundle([east, west])
    cap = EpochCapability(fingerprint="fp", epoch=1, seed=11,
                          generation=0, world=1)
    assert trust.verify(sign_capability(east, cap))
    assert trust.verify(sign_capability(west, cap))
    # an east-signed grant re-stamped as west's fails the HMAC check:
    # kid 1 exists in west's ring, so this resolves a key and refuses
    import dataclasses
    forged = sign_capability(east, cap)
    crossed = dataclasses.replace(forged, cell="west")
    assert trust.verify(crossed) is False
    with pytest.raises(CapabilityError):
        trust.verify(dataclasses.replace(forged, cell="north"))
    with pytest.raises(CapabilityError):
        trust.verify(cap)  # no cell/kid stamp: not a federated grant


# ----------------------------------------------------- wrong_cell redirects
def test_wrong_cell_redirect_reaches_home_cell(tmp_path):
    """A client dialing the DR cell's entry rides the typed retryable
    ``wrong_cell`` redirect (directory wire attached) to its home cell
    and streams bit-identically — ``wrong_shard``, one layer up."""
    spec = plain_spec(world=2)
    with Federation(spec, root=str(tmp_path), n_shards=2) as fed:
        fed.wait_synced()
        wrong = fed.cells["west"].address
        ref = np.asarray(spec.rank_indices(0, 0))
        with _client(wrong, 0) as c:
            got = np.concatenate(list(c.epoch_batches(0)))
            assert c.cell == "east"
            assert c.cell_directory is not None
            assert c.cell_directory["version"] >= 1
            redirects = c.metrics.report()["counters"].get(
                "wrong_cell_redirects", 0)
        assert np.array_equal(got, ref)
        assert redirects >= 1
        router_m = fed.cells["west"].router.metrics.report()["counters"]
        assert router_m.get("cell_redirects", 0) >= 1


# --------------------------------------------------------------- the DR law
@pytest.mark.parametrize("mode", sorted(SPECS))
def test_cell_kill_resumes_bit_identical(mode, tmp_path):
    """Kill the ENTIRE home cell mid-epoch (shards + router at once);
    promote the DR cell and flip the directory; every rank's resumed
    stream is bit-identical to the uninterrupted epoch — recovered
    solely from the shipped WAL tail."""
    spec = SPECS[mode](world=2)
    refs = {r: np.asarray(spec.rank_indices(0, r)) for r in range(2)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with Federation(spec, root=str(tmp_path), n_shards=2) as fed:
            addr = fed.address
            assert fed.wait_synced()
            clients = {r: _client(addr, r) for r in range(2)}
            its = {r: clients[r].epoch_batches(0) for r in range(2)}
            got = {r: [next(its[r])] for r in range(2)}  # mid-epoch
            assert fed.wait_shipped()
            fed.kill_cell("east")
            fed.promote("west")
            for r in range(2):
                for arr in its[r]:
                    got[r].append(arr)
                clients[r].close()
    for r in range(2):
        stream = np.concatenate(got[r])
        assert np.array_equal(stream, refs[r]), (
            f"rank {r} diverged after cell kill in {mode} mode")
    m = fed.metrics.report()["counters"]
    assert m.get("federation_failovers", 0) == 1
    assert m.get("cell_fenced", 0) >= 1


def test_client_dial_ladder_ends_at_dr_cell(tmp_path):
    """The cell-aware ladder: home entry dead → directory re-lookup →
    DR partner.  A client constructed with ONLY the (now dead) home
    address and the directory wire still reaches the promoted cell."""
    spec = plain_spec(world=1)
    with Federation(spec, root=str(tmp_path)) as fed:
        fed.wait_synced()
        wire = fed.directory().to_wire()
        home_addr = fed.address
        with _client(home_addr, 0) as warm:
            ref_head = next(warm.epoch_batches(0))
        assert fed.wait_shipped()
        fed.kill_cell("east")
        fed.promote("west")
        c = ServiceIndexClient(home_addr, rank=0, batch=23,
                               backoff_base=0.01, reconnect_timeout=0.5,
                               cell_directory=wire)
        try:
            got = np.concatenate(list(c.epoch_batches(0)))
            assert c.cell == "west"
        finally:
            c.close()
    ref = np.asarray(spec.rank_indices(0, 0))
    assert np.array_equal(got, ref)
    assert np.array_equal(ref_head, ref[:ref_head.size])


# -------------------------------------------------------- the migration law
def test_live_migration_zero_duplicate_zero_skip(tmp_path):
    """A tenant migrates between cells mid-epoch: the established
    client rides the cutover (freeze → drain → flip → fence) and its
    stream stays exactly the uninterrupted epoch — no index served
    twice, none skipped."""
    spec = plain_spec(world=2)
    tenant = _tenant(spec)
    refs = {r: np.asarray(spec.rank_indices(0, r)) for r in range(2)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with Federation(spec, root=str(tmp_path), n_shards=2) as fed:
            assert fed.wait_synced()
            clients = {r: _client(fed.address, r) for r in range(2)}
            its = {r: clients[r].epoch_batches(0) for r in range(2)}
            got = {r: [next(its[r])] for r in range(2)}
            nd = fed.migrate_tenant(tenant, "west")
            assert nd.home(tenant) == "west"
            for r in range(2):
                for arr in its[r]:
                    got[r].append(arr)
                clients[r].close()
    for r in range(2):
        stream = np.concatenate(got[r])
        assert stream.size == refs[r].size, (
            f"rank {r}: {stream.size} != {refs[r].size} "
            "(duplicate or skipped indices across the cutover)")
        assert np.array_equal(stream, refs[r])
    m = fed.metrics.report()["counters"]
    assert m.get("federation_migrations", 0) == 1


# ---------------------------------------------------------- the fencing law
def test_fenced_cell_refuses_every_write_with_typed_error(tmp_path):
    """After a promotion supersedes it, EVERY server of the old cell
    refuses every write with the typed ``fenced`` error — probed
    directly at each server socket, below the client's failover."""
    spec = plain_spec(world=2)
    with Federation(spec, root=str(tmp_path), n_shards=2) as fed:
        fed.wait_synced()
        assert fed.wait_shipped()
        fed.promote("west")  # operator switchover: east is alive AND fenced
        east = fed.cells["east"]
        assert east.servers(), "no servers to probe"
        for srv in east.servers():
            sock = socket.create_connection(srv.address, timeout=5.0)
            try:
                P.send_msg(sock, P.MSG_HELLO,
                           {"proto": P.PROTOCOL_VERSION, "rank": 0,
                            "batch": 8})
                msg, hdr, _ = P.recv_msg(sock)
            finally:
                sock.close()
            assert msg == P.MSG_ERROR
            assert hdr["code"] == "fenced", (
                f"shard {srv.shard_id} answered {hdr!r}, not fenced")
            assert hdr.get("serving") is False
        counters = [s.metrics.report()["counters"] for s in east.servers()]
        assert sum(c.get("fenced_writes", 0) for c in counters) >= 2


# ------------------------------------------------------- federated caps law
def test_federated_capability_survives_cell_kill(tmp_path):
    """Capability mode across a cell kill: the east-issued grant (cell
    + kid stamped inside the signed bytes) verifies against the trust
    bundle; after failover the west cell issues under ITS key and the
    regenerated stream stays bit-identical end to end."""
    spec = plain_spec(world=1)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with Federation(spec, root=str(tmp_path),
                        capability_root="fed-secret") as fed:
            fed.wait_synced()
            c = ServiceIndexClient(fed.address, rank=0, batch=23,
                                   backoff_base=0.01,
                                   reconnect_timeout=0.5,
                                   spec=spec,
                                   capability_secret=fed.trust)
            try:
                cap = c._fetch_capability(0, spec)
                assert (cap.cell, cap.kid) == ("east", 1)
                it = c.capability_epoch_batches(0, spec=spec)
                got = [next(it)]
                assert fed.wait_shipped()
                fed.kill_cell("east")
                fed.promote("west")
                for arr in it:
                    got.append(arr)
                # honored: the east-signed grant still verifies (the
                # bundle holds the dead cell's key) ...
                assert verify_capability(fed.trust, cap)
                # ... and the new home issues under its own key
                cap2 = c._fetch_capability(1, spec)
                assert (cap2.cell, cap2.kid) == ("west", 1)
            finally:
                c.close()
    ref = np.asarray(spec.rank_indices(0, 0))
    assert np.array_equal(np.concatenate(got), ref)


def test_rotated_away_key_is_a_loud_reissue_never_silent(tmp_path):
    """If the issuing key was rotated AND retired while a client held
    its grant, verification is a loud ``CapabilityError`` naming the
    missing key — the client re-issues; nothing silently passes."""
    spec = plain_spec(world=1)
    with Federation(spec, root=str(tmp_path),
                    capability_root="fed-secret") as fed:
        fed.wait_synced()
        c = ServiceIndexClient(fed.address, rank=0, batch=23,
                               spec=spec, capability_secret=fed.trust)
        try:
            cap = c._fetch_capability(0, spec)
            ring = fed.keyrings["east"]
            ring.rotate()
            ring.retire(1)
            with pytest.raises(CapabilityError, match="kid=1"):
                verify_capability(fed.trust, cap)
            cap2 = c._fetch_capability(0, spec)  # loud re-issue path
            assert cap2.kid == 2
            assert verify_capability(fed.trust, cap2)
        finally:
            c.close()


# -------------------------------------------------------------- wire extras
def test_welcome_carries_cell_and_directory(tmp_path):
    spec = plain_spec(world=1)
    with Federation(spec, root=str(tmp_path)) as fed:
        fed.wait_synced()
        with _client(fed.address, 0) as c:
            next(c.epoch_batches(0))
            assert c.cell == "east"
            d = c.cell_directory
            assert d is not None and set(d["cells"]) == {"east", "west"}
            assert d["dr"] == {"east": "west", "west": "east"}


# ---------------------------------------- the client's federated secret
def test_trust_bundle_grant_regenerates_the_served_stream(tmp_path):
    """A capability-mode client holding the federation's ``TrustBundle``
    verifies the home cell's grant and regenerates the stream on its own
    spec: byte-equal to what the cell serves over the wire."""
    spec = plain_spec(world=2)
    with Federation(spec, root=str(tmp_path), n_shards=2,
                    capability_root="fed-secret") as fed:
        fed.wait_synced()
        for r in range(2):
            c = ServiceIndexClient(fed.address, rank=r, batch=23,
                                   backoff_base=0.01, spec=spec,
                                   capability_secret=fed.trust)
            try:
                cap = c._fetch_capability(0, spec)
                assert c._cap_signature_ok(cap)
                regen = np.concatenate(
                    list(c.capability_epoch_batches(0, spec=spec)))
            finally:
                c.close()
            with _client(fed.address, r) as c:
                served = np.concatenate(list(c.epoch_batches(0)))
            assert (cap.cell, cap.kid) == ("east", 1)
            assert regen.tobytes() == served.tobytes()
            assert np.array_equal(served,
                                  np.asarray(spec.rank_indices(0, r)))


def test_client_refuses_a_retired_kid_loudly(tmp_path):
    """A grant signed under a kid the issuing cell has since retired is a
    loud ``CapabilityError`` from the client's own check (and from its
    capability stream), never a silent accept or a silent drop."""
    spec = plain_spec(world=1)
    with Federation(spec, root=str(tmp_path),
                    capability_root="fed-secret") as fed:
        fed.wait_synced()
        c = ServiceIndexClient(fed.address, rank=0, batch=23,
                               backoff_base=0.01, spec=spec,
                               capability_secret=fed.trust)
        try:
            cap = c._fetch_capability(0, spec)
            ring = fed.keyrings["east"]
            ring.rotate()
            ring.retire(1)
            with pytest.raises(CapabilityError, match="kid=1"):
                c._cap_signature_ok(cap)
            keyring_client = ServiceIndexClient(
                fed.address, rank=0, batch=23, backoff_base=0.01,
                spec=spec, capability_secret=ring)
            try:
                with pytest.raises(CapabilityError, match="kid=1"):
                    keyring_client._cap_signature_ok(cap)
                assert keyring_client._cap_signature_ok(
                    c._fetch_capability(0, spec))
            finally:
                keyring_client.close()
        finally:
            c.close()


# ------------------------------------------------- across the two packages
def _directories(m):
    d = m.CellDirectory({"east": ("127.0.0.1", 7001),
                         "west": ("127.0.0.1", 7002),
                         "north": ("10.0.0.3", 9)},
                        default="east",
                        dr={"east": "west", "west": "east"})
    d2 = d.flip("tenant-a", "west")
    d3 = d2.flip("tenant-b", "north").flip_cell("east", "west")
    return [d, d2, d3, m.CellDirectory({"solo": ("h", 1)})]


def test_directory_wire_and_fingerprint_equal_across_packages():
    """Every directory wire, flip and fingerprint is byte-equal across
    the packages, and each reads the other's wire back unchanged."""
    for a, b in zip(_directories(__import__(
            "partiallyshuffledistributedsampler_tpu_torch.federation",
            fromlist=["x"])), _directories(JF)):
        assert json.dumps(a.to_wire(), sort_keys=True) == \
            json.dumps(b.to_wire(), sort_keys=True)
        assert a.fingerprint() == b.fingerprint()
        assert CellDirectory.from_wire(b.to_wire()).to_wire() == a.to_wire()
        assert JF.CellDirectory.from_wire(a.to_wire()).fingerprint() == \
            b.fingerprint()
        for t in ("tenant-a", "tenant-b", "other"):
            assert a.home(t) == b.home(t)


@pytest.mark.parametrize("root", ["deployment-secret", b"\x00\xffraw"])
def test_keyring_signatures_equal_across_packages(root):
    """Per-cell key derivation, rotation and signatures are byte-equal
    across the packages; a grant signed by either verifies in the other's
    bundle, and a retired kid is refused loudly by both."""
    cap = EpochCapability(fingerprint="fp", epoch=3, seed=11,
                          generation=1, world=4, tenant="t")
    jcap = JC.EpochCapability(fingerprint="fp", epoch=3, seed=11,
                              generation=1, world=4, tenant="t")
    rings = {c: CellKeyring(c, root=root) for c in ("east", "west")}
    jrings = {c: JF.CellKeyring(c, root=root) for c in ("east", "west")}
    for c in rings:
        rings[c].rotate()
        jrings[c].rotate()
        for kid in (1, 2):
            assert rings[c].secret_for(kid) == jrings[c].secret_for(kid)
        a = sign_capability(rings[c], cap)
        b = JF.sign_capability(jrings[c], jcap)
        assert (a.cell, a.kid) == (b.cell, b.kid) == (c, 2)
        assert a.canonical() == b.canonical()
        assert a.sig == b.sig and a.sig
        assert json.dumps(a.to_wire(), sort_keys=True) == \
            json.dumps(b.to_wire(), sort_keys=True)
        trust, jtrust = TrustBundle(rings.values()), \
            JF.TrustBundle(jrings.values())
        assert verify_capability(trust,
                                 EpochCapability.from_wire(b.to_wire()))
        assert JF.verify_capability(jtrust,
                                    JC.EpochCapability.from_wire(a.to_wire()))
    explicit = CellKeyring("east", secret="given")
    assert explicit.secret_for(1) == JF.CellKeyring(
        "east", secret="given").secret_for(1)
    old = sign_capability(CellKeyring("east", root=root), cap)
    rings["east"].retire(1)
    jrings["east"].retire(1)
    with pytest.raises(CapabilityError, match="kid=1"):
        verify_capability(TrustBundle(rings.values()), old)
    with pytest.raises(JC.CapabilityError, match="kid=1"):
        JF.verify_capability(JF.TrustBundle(jrings.values()),
                             JC.EpochCapability.from_wire(old.to_wire()))


def _jax_plain(world):
    return JS.PartialShuffleSpec.plain(300, window=16, seed=7, world=world)


def _jax_mixture(world):
    return JS.PartialShuffleSpec.mixture(
        JMixtureSpec([100, 200, 50], [5, 3, 2], block=16), seed=3,
        world=world, epoch_samples=300)


JAX_SPECS = {"plain": _jax_plain, "mixture": _jax_mixture}
#: package -> (IndexServer, ServiceIndexClient, WalShipper, spec maker)
PACKAGES = {
    "jax": (JS.IndexServer, JS.ServiceIndexClient, JF.WalShipper,
            JAX_SPECS),
    "port": (IndexServer, ServiceIndexClient,
             __import__("partiallyshuffledistributedsampler_tpu_torch."
                        "federation", fromlist=["x"]).WalShipper, SPECS),
}


@pytest.mark.parametrize("mode", ["plain", "mixture"])
@pytest.mark.parametrize("home,remote", [("jax", "port"), ("port", "jax")])
def test_a_shipped_wal_replays_in_the_other_packages_cell(home, remote,
                                                          mode, tmp_path):
    """One package's home primary ships its WAL across the cell boundary
    to the other package's remote standby: the remote folds the home's
    state exactly, its own WAL is the dense shipped sequence, and a
    daemon of the remote's package restarted over that WAL resumes every
    rank bit-identically."""
    H_srv, H_cli, H_ship, h_specs = PACKAGES[home]
    R_srv, R_cli, _, r_specs = PACKAGES[remote]
    west = str(tmp_path / "west")
    primary = H_srv(h_specs[mode](2), wal_dir=str(tmp_path / "east"))
    standby = R_srv(r_specs[mode](2), role="standby",
                    repl_feed_timeout=60.0, wal_dir=west)
    standby.start()
    primary.start()
    shipper = H_ship(primary._repl_log, standby.address,
                     cell_id="east", target_cell="west",
                     state_fn=primary._repl_sync_state,
                     term_fn=lambda: primary.term,
                     on_fenced=lambda term: None, metrics=primary.metrics)
    try:
        shipper.start()
        assert shipper.synced.wait(10.0)
        with H_cli(primary.address, rank=0, batch=17) as c:
            c.set_epoch(2)
        for r in range(2):
            c = H_cli(primary.address, rank=r, batch=17)
            it = c.epoch_batches(2)
            for _ in range(2 + r):
                next(it)
            c.close()
        deadline = time.monotonic() + 10.0
        while shipper.shipped_lsn < primary._repl_log.lsn:
            assert time.monotonic() < deadline, "shipped tail never drained"
            time.sleep(0.01)
        deadline = time.monotonic() + 10.0
        while standby._applied_lsn < primary._repl_log.lsn:
            assert time.monotonic() < deadline, "remote never applied"
            time.sleep(0.01)
        assert standby.epoch == primary.epoch == 2
        assert standby._cursors == primary._cursors
        want = dict(primary._cursors)
    finally:
        shipper.stop()
        primary.kill()
        standby.kill()
    assert want, "nothing was consumed: vacuous"
    refs = {r: np.asarray(r_specs[mode](2).rank_indices(2, r))
            for r in range(2)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fresh = R_srv(r_specs[mode](2), wal_dir=west)
        host, port = fresh.start()
    try:
        assert fresh.epoch == 2 and fresh._cursors == want
        for r in range(2):
            with R_cli((host, port), rank=r, batch=41) as c:
                got = np.concatenate(list(c.epoch_batches(2)))
            assert np.array_equal(got, refs[r])
    finally:
        fresh.stop()


@pytest.mark.parametrize("backend", ["cpu", "native"])
def test_cell_failover_streams_equal_the_jax_federation(backend, tmp_path):
    """A port federation on ``backend`` and the JAX package's, each
    killed and promoted mid-epoch: every rank's stream through the cell
    failover is the JAX federation's, byte for byte."""
    streams = {}
    for name, fed_cls, spec in (
            ("jax", JF.Federation, _jax_mixture(2)),
            ("port", Federation, PartialShuffleSpec.from_wire(
                _jax_mixture(2).to_wire(), backend=backend))):
        cli = PACKAGES[name][1]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            with fed_cls(spec, root=str(tmp_path / name),
                         n_shards=2) as fed:
                assert fed.wait_synced()
                clients = {r: cli(fed.address, rank=r, batch=23,
                                  backoff_base=0.01, reconnect_timeout=0.5)
                           for r in range(2)}
                its = {r: clients[r].epoch_batches(0) for r in range(2)}
                got = {r: [next(its[r])] for r in range(2)}
                assert fed.wait_shipped()
                fed.kill_cell("east")
                fed.promote("west")
                for r in range(2):
                    got[r].extend(its[r])
                    clients[r].close()
        streams[name] = {r: np.concatenate(got[r]) for r in range(2)}
    for r in range(2):
        assert streams["port"][r].tobytes() == streams["jax"][r].tobytes()
