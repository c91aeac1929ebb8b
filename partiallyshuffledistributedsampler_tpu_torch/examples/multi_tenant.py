"""One shared index daemon, many jobs: the multi-tenant deployment shape.

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.multi_tenant

The docs/SERVICE.md "Tenancy" story in miniature, in three phases:

1. **Namespaces** — one `IndexServer(multi_tenant=True)` hosts a plain job
   and a mixture job at once.  Each client HELLOs with its own spec; the
   daemon creates or attaches the matching namespace, keyed by the
   world-stripped spec fingerprint, and regenerates each through the
   spec's backend (on the card: ``index_amortized`` and
   ``mixture_fused``).  Both streams are asserted bit-identical to the
   local streams.

2. **Admission** — a `TenantQuota(max_ranks=1)` tenant refuses its second
   rank with a retryable ``tenant_admission`` error; the client waits the
   ``retry_ms`` hint out and is admitted the moment the first lease frees.

3. **Fair share** — both tenants regenerate through one concurrency-1
   `FairShareScheduler`; the ``regen_queue_ms`` histogram shows the stride
   queue arbitrated, and the streams stay exact.

Runs on the card; ``--cpu`` runs the regens on the host.
"""

from __future__ import annotations

import threading

import numpy as np

from ..ops import MixtureSpec
from ..service import (
    FairShareScheduler,
    IndexServer,
    PartialShuffleSpec,
    ServiceIndexClient,
    TenantQuota,
)
from .common import parse_device

N, WINDOW = 12_000, 256


def make_specs(backend: str):
    plain = PartialShuffleSpec.plain(N, window=WINDOW, seed=11, world=1,
                                     backend=backend)
    mixture = PartialShuffleSpec.mixture(
        MixtureSpec([N // 2, N // 4], [3, 1], windows=WINDOW),
        epoch_samples=N // 2, seed=23, world=1, backend=backend)
    return plain, mixture


def _serve_both(server, plain, mixture, epoch: int) -> dict:
    """Each job's rank 0 streams ``epoch`` from ``server`` on a thread of
    its own; ``{tag: stream}``."""
    got, errors = {}, []

    def job(tag, spec):
        try:
            with ServiceIndexClient(server.address, rank=0, batch=512,
                                    spec=spec) as client:
                got[tag] = client.epoch_indices(epoch)
        except BaseException as exc:  # noqa: BLE001 - reported below
            errors.append((tag, exc))

    workers = [threading.Thread(target=job, args=(t, s))
               for t, s in (("plain", plain), ("mixture", mixture))]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120.0)
    assert not errors, errors
    return got


def phase_1_namespaces(plain, mixture) -> None:
    with IndexServer(plain, multi_tenant=True) as server:
        print(f"phase 1: multi-tenant daemon on {server.address[0]}:"
              f"{server.address[1]} (backend={plain.backend})")
        got = _serve_both(server, plain, mixture, 1)
        tenants = sorted(server.tenants())
    for tag, spec in (("plain", plain), ("mixture", mixture)):
        assert np.array_equal(got[tag], spec.rank_indices(1, 0)), \
            f"tenant {tag} drifted"
    print(f"ok: phase 1, 2 jobs, 1 daemon, {len(tenants)} namespaces: both "
          "streams bit-identical to the local streams")


def phase_2_admission(plain, mixture) -> None:
    m2 = mixture.with_world(2)
    with IndexServer(plain, multi_tenant=True,
                     tenant_quota=TenantQuota(max_ranks=1)) as server:
        holder = ServiceIndexClient(server.address, rank=0, batch=512,
                                    spec=m2)
        try:
            holder.epoch_indices(0)  # rank 0 holds the tenant's only slot
            # rank 1 is over quota: the typed tenant_admission refusal is
            # waited out (inside the RPC retry loop) until holder.close()
            # frees the lease
            release = threading.Timer(0.4, holder.close)
            release.start()
            waiter = ServiceIndexClient(server.address, rank=1, batch=512,
                                        spec=m2, reconnect_timeout=30.0)
            try:
                stream = waiter.epoch_indices(0)
                waits = waiter.metrics.report()["counters"].get(
                    "admission_waits", 0)
            finally:
                release.cancel()
                waiter.close()
        finally:
            holder.close()
    assert np.array_equal(stream, m2.rank_indices(0, 1)), \
        "post-admission stream drifted"
    assert waits >= 1, "the quota never pushed back"
    print(f"ok: phase 2, the rank over quota waited out {waits} admission "
          "refusal(s), then streamed exactly")


def phase_3_fair_share(plain, mixture) -> None:
    sched = FairShareScheduler(concurrency=1)
    with IndexServer(plain, multi_tenant=True,
                     regen_scheduler=sched) as server:
        got = _serve_both(server, plain, mixture, 2)
        queue = server.metrics.report()["histograms"].get(
            "regen_queue_ms", {})
    for tag, spec in (("plain", plain), ("mixture", mixture)):
        assert np.array_equal(got[tag], spec.rank_indices(2, 0)), \
            f"tenant {tag} drifted under the fair-share queue"
    assert queue.get("count", 0) >= 2, "the regen queue never arbitrated"
    print(f"ok: phase 3, {queue['count']} regens arbitrated through the "
          "concurrency-1 fair-share queue, streams exact")


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    # 'cuda' raises CudaUnavailableError here when there is no card
    plain, mixture = make_specs(device)
    phase_1_namespaces(plain, mixture)
    phase_2_admission(plain, mixture)
    phase_3_fair_share(plain, mixture)
    print("ok: multi-tenant service end to end")


if __name__ == "__main__":
    main()
