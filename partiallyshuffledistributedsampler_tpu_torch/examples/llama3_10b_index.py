"""BASELINE config 5's shape: the Llama-3 8B pretrain, a 10B-sample index
space at world 256, with a reseed every epoch.

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.llama3_10b_index

Four tiers:

1. The 10B stream at true scale by random access
   (``stream_indices_at_cuda``): spot reads bit-identical to the plain law
   on the host, indices past 2^31 (int64), no collision.
2. One rank's whole epoch at world 256 (39M int64 indices; a wider world
   in the fast mode), its rank slice spot-checked against random access.
3. Reseed stress: ``make_regen_fn`` over the data mesh (a process group of
   one here, or the group ``torchrun`` made), the seed agreed from rank 0
   every epoch over divergent local seeds, each row held against the host
   law.
4. The pretrain data mixture (web/code/books at 70/20/10) through
   ``sharded_mixture_indices``: exact per-block proportions.

Runs on the card; ``--cpu`` runs it on the host.  ``PSDS_EXAMPLE_FAST=1``
shrinks the probe count, the shard and the reseed count (the same code
paths), as the JAX package's example does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from .. import (
    MixtureSpec,
    epoch_indices_cpu,
    epoch_indices_cuda,
    mixture_epoch_indices_cpu,
    parallel,
    stream_indices_at_cpu,
    stream_indices_at_cuda,
)
from .common import parse_device, process_group

N = 10_000_000_000  # the 10B-sample index space
WINDOW = 8192
WORLD = 256


def random_access_tier(device: str, fast: bool) -> None:
    rng = np.random.default_rng(0)
    probes = np.sort(rng.integers(0, N, size=512 if fast else 4096))
    got = stream_indices_at_cuda(torch.from_numpy(probes), N, WINDOW,
                                 seed=7, epoch=3, device=device).cpu()
    ref = stream_indices_at_cpu(probes, N, WINDOW, 7, 3)
    assert torch.equal(got, ref), "random access != the host law"
    assert got.dtype == torch.int64 and int(got.max()) > 2**31, (
        "a 10B stream must produce indices beyond int32 range")
    assert len(torch.unique(got)) == len(got)  # a bijection can't collide
    print(f"ok: tier 1, {len(probes)} random probes into the 10B stream "
          f"(int64, max index {int(got.max()):,} > 2^31, bit-identical to "
          f"the host law)")


def rank_shard_tier(device: str, fast: bool) -> None:
    # fast mode widens the world so the shard stays small: same code path
    world = 4096 * 16 if fast else WORLD
    t0 = time.perf_counter()
    shard = epoch_indices_cuda(N, WINDOW, 7, 3, 0, world, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    ns = shard.shape[0]
    assert ns == -(-N // world) and shard.dtype == torch.int64
    # the rank slice law: entry j of rank r's shard is stream position
    # j * world + r
    j = np.asarray([0, 1, ns // 2, ns - 1], dtype=np.int64)
    expect = stream_indices_at_cpu(j * world + 0, N, WINDOW, 7, 3)
    assert torch.equal(shard.cpu()[torch.from_numpy(j)], expect)
    print(f"ok: tier 2, rank-0 shard of world={world}: {ns:,} int64 "
          f"indices in {ms:.1f} ms (first call, build included) on "
          f"{device}")


def reseed_tier(device: str, fast: bool) -> None:
    mesh = parallel.data_mesh(device=device)
    world, rank = parallel.identity_from_mesh(mesh)
    # a scaled n so the demo runs anywhere; the program is the production
    # one: rank 0's triple broadcast, then the regen from device memory
    n_small = 1_000_000
    fn, num = parallel.make_regen_fn(n_small, WINDOW, mesh=mesh)
    epochs = 4 if fast else 32
    rows = []
    t0 = time.perf_counter()
    for e in range(epochs):
        # divergent seeds off rank 0: the agreement makes rank 0's
        # (seed, epoch) win on every reseed
        local = (7, 0, e) if rank == 0 else (9999 + rank, rank, e + 100)
        triple = parallel.make_seed_triple(None, None, mesh=mesh,
                                           local_seeds=local)
        rows.append(fn(triple))
    if device == "cuda":
        torch.cuda.synchronize()
    per_reseed_ms = (time.perf_counter() - t0) * 1e3 / epochs
    for e in (0, epochs - 1):
        assert torch.equal(rows[e].cpu(), epoch_indices_cpu(
            n_small, WINDOW, 7, e, rank, world)), (
            "rank 0's seed did not win the agreement")
    assert not torch.equal(rows[0], rows[1])  # a reseed reshuffles
    assert rows[0].numel() == num
    print(f"ok: tier 3, {epochs} consecutive reseeds over a {world}-rank "
          f"mesh, seed agreed from rank 0 each time, {per_reseed_ms:.2f} "
          f"ms/reseed wall incl. launch")
    spec = MixtureSpec([700_000, 200_000, 100_000], [70, 20, 10],
                       windows=WINDOW)
    mids = parallel.sharded_mixture_indices(spec, 7, 0, mesh=mesh).cpu()
    assert torch.equal(mids, mixture_epoch_indices_cpu(spec, 7, 0, rank,
                                                       world))
    src, _ = spec.decompose(mids.numpy())
    share = np.bincount(src, minlength=3) / len(src)
    print(f"ok: tier 4, 70/20/10 corpus mixture over the mesh: realized "
          f"proportions {share.round(4).tolist()} (exact per block), "
          f"rank {rank}'s shard bit-identical to the host law")


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    fast = os.environ.get("PSDS_EXAMPLE_FAST") == "1"
    with process_group(device):
        random_access_tier(device, fast)
        rank_shard_tier(device, fast)
        reseed_tier(device, fast)
    print("ok: config-5 shape end to end")


if __name__ == "__main__":
    main()
