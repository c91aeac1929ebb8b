"""Shared index-serving daemon, end to end on one host.

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.index_service

The deployment shape of docs/SERVICE.md in miniature, in two phases:

1. **Loader integration** — one `IndexServer` owns the epoch streams of a
   4-rank job and regenerates each rank's epoch on the card (the spec's
   ``backend="cuda"``: one kernel launch and one readback a rank); four
   loader "processes" (threads here — the wire protocol is identical)
   each claim a rank and feed a `HostDataLoader` through
   ``index_client=``.  The served batches are asserted bit-identical to
   the local stream.

2. **Crash recovery** — a client streams an epoch batch by batch while the
   daemon is killed mid-stream and restarted from its snapshot.  The
   client reconnects with jittered backoff and resumes from its cursor;
   the delivered stream still equals the local stream, exactly once, no
   gaps, no duplicates.

Runs on the card; ``--cpu`` runs the regens and the batches on the host.
"""

from __future__ import annotations

import os
import tempfile
import threading

import numpy as np

from ..sampler import HostDataLoader
from ..service import IndexServer, PartialShuffleSpec, ServiceIndexClient
from .common import parse_device

N, WINDOW, WORLD, BATCH, EPOCH = 12_000, 256, 4, 128, 3


def phase_1_loaders(spec, data, device: str) -> None:
    streams: dict = {}
    errors: list = []

    def loader_process(address, rank: int) -> None:
        try:
            with ServiceIndexClient(address, rank=rank,
                                    batch=512) as client:
                loader = HostDataLoader(data, window=WINDOW, seed=11,
                                        rank=rank, world=WORLD, batch=BATCH,
                                        index_client=client,
                                        index_backend=spec.backend,
                                        device=device)
                try:
                    streams[rank] = np.concatenate(
                        [b["label"].cpu().numpy()
                         for b in loader.epoch(EPOCH)])
                finally:
                    # the boundary prefetch of the next epoch uses the
                    # client: let it finish while the daemon is up
                    loader.close()
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append((rank, exc))

    with IndexServer(spec) as server:
        host, port = server.address
        print(f"phase 1: daemon up on {host}:{port} (backend="
              f"{spec.backend}), {WORLD} loader ranks")
        workers = [threading.Thread(target=loader_process,
                                    args=((host, port), r))
                   for r in range(WORLD)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120.0)
        assert not errors, errors
        report = server.metrics.report()

    # the served streams are the local streams, exactly — HostDataLoader
    # serves whole batches, so compare that prefix
    for rank in range(WORLD):
        ref = spec.rank_indices(EPOCH, rank)
        ref = ref[: (len(ref) // BATCH) * BATCH]
        assert np.array_equal(streams[rank], ref), f"rank {rank} drifted"
    print(f"ok: phase 1, {WORLD} ranks x {len(streams[0])} samples on "
          f"{device}: bit-identical to the local stream")
    print("  batches served by rank:",
          {r: c["batches_served"]
           for r, c in sorted(report["clients"].items())})


def phase_2_crash_recovery(spec) -> None:
    with tempfile.TemporaryDirectory() as td:
        snap = os.path.join(td, "index_service.json")
        server = IndexServer(spec, snapshot_path=snap, snapshot_interval=1)
        host, port = server.start()
        print(f"phase 2: daemon on {host}:{port}, snapshot at {snap}")

        client = ServiceIndexClient((host, port), rank=0, batch=256,
                                    reconnect_timeout=30.0)
        delivered = []
        for i, batch in enumerate(client.epoch_batches(EPOCH)):
            delivered.append(batch)
            if i == 3:  # mid-stream: kill the daemon, restart from snapshot
                server.stop()
                print("  daemon killed after batch 3; restarting...")
                server = IndexServer(spec, host=host, port=port,
                                     snapshot_path=snap, snapshot_interval=1)
                server.start()
        stream = np.concatenate(delivered)
        reconnects = client.metrics.report()["counters"].get("reconnects", 0)
        client.close()
        server.stop()

    assert np.array_equal(stream, spec.rank_indices(EPOCH, 0)), \
        "stream across restart drifted from the local stream"
    assert reconnects >= 1, "restart was never exercised"
    print(f"ok: phase 2, {len(stream)} indices across the restart "
          f"({reconnects} reconnects): exactly-once, bit-identical")


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    data = {"tokens": np.arange(N * 8, dtype=np.int32).reshape(N, 8),
            "label": np.arange(N, dtype=np.int64)}
    # 'cuda' raises CudaUnavailableError here when there is no card
    spec = PartialShuffleSpec.plain(N, window=WINDOW, seed=11, world=WORLD,
                                    backend=device)
    phase_1_loaders(spec, data, device)
    phase_2_crash_recovery(spec)
    print("ok: index service end to end")


if __name__ == "__main__":
    main()
