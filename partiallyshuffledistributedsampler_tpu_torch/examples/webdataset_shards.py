"""BASELINE config 4's shape: WebDataset-style tar shards, the partial
shuffle over *shard indices*, the pipeline a ViT-L/16 data loader runs.

    python -m partiallyshuffledistributedsampler_tpu_torch.examples.webdataset_shards

The shuffle unit is the shard file: shard order is windowed-shuffled per
epoch (reads stay clustered within a storage prefix), each rank reads only
its own shards sequentially, and samples inside a shard pass through the
bounded shuffle buffer of SPEC.md §7.3.  Everything is deterministic in
(seed, epoch), so the stream checkpoints and resumes like the index path.

Three tiers: every rank's host stream (``PartialShuffleShardSampler``,
``shard_sample_order``, ``shuffle_buffer``) over two epochs serves every
sample; the rank's stream expanded to global sample indices on the card
(``device_epoch_indices``: ``shard_row_keys`` + ``shard_expand``),
bit-identical to the host expansion; and a corpus of hundreds of distinct
shard sizes expanded on the card the same way.  The tar layer is simulated
by in-memory shards (swap ``read_shard`` for a tar reader one for one).
Runs on the card; ``--cpu`` runs it on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import (
    PartialShuffleShardSampler,
    expand_shard_indices_cpu,
    expand_shard_indices_cuda,
    shard_sample_order,
    shuffle_buffer,
)
from .common import parse_device

NUM_SHARDS, WORLD, WINDOW, EPOCHS = 128, 4, 16, 2
SHARD_SIZES = [200 + (37 * s) % 100 for s in range(NUM_SHARDS)]
OFFSETS = np.concatenate([[0], np.cumsum(SHARD_SIZES)[:-1]])


def read_shard(sid: int):
    """Stand-in for a sequential tar read: yields (global_id, sample)."""
    for local in range(SHARD_SIZES[sid]):
        yield int(OFFSETS[sid]) + local, f"sample-{sid}-{local}"


def make_sampler(rank: int, epoch: int, seed: int, backend: str):
    sampler = PartialShuffleShardSampler(
        NUM_SHARDS, num_replicas=WORLD, rank=rank, window=WINDOW, seed=seed,
        backend=backend)
    sampler.set_epoch(epoch)
    return sampler


def rank_stream(rank: int, epoch: int, backend: str, seed: int = 11):
    """One rank's epoch: shards in partial-shuffle order; within each shard
    a *bounded* in-shard shuffle (window 64 of the §3 law, so a tar reader
    needs only a 64-sample decode buffer); then a 256-sample §7.3 shuffle
    buffer across shard boundaries."""
    sampler = make_sampler(rank, epoch, seed, backend)

    def samples():
        for sid in sampler:
            order = shard_sample_order(sid, SHARD_SIZES[sid], seed=seed,
                                       epoch=epoch, within_shard_shuffle=64)
            shard = list(read_shard(sid))
            for local in order.tolist():
                yield shard[local]

    yield from shuffle_buffer(samples(), 256, seed=seed, epoch=epoch)


def host_stream_tier(backend: str) -> None:
    total = sum(SHARD_SIZES)
    for epoch in range(EPOCHS):
        seen, touched = set(), set()
        for rank in range(WORLD):  # in production: one process per rank
            for gid, _payload in rank_stream(rank, epoch, backend):
                seen.add(gid)
                touched.add(int(np.searchsorted(OFFSETS, gid, "right")) - 1)
        pad = -(-NUM_SHARDS // WORLD) * WORLD - NUM_SHARDS
        assert len(seen) == total  # every sample despite the shard padding
        print(f"ok: tier 1, epoch {epoch}: {len(seen)}/{total} distinct "
              f"samples across {len(touched)} shards (wrap-pad duplicates: "
              f"{pad} shards) [backend={backend}]")


def device_tier(device: str) -> None:
    backend = "cuda" if device == "cuda" else "cpu"
    sampler = make_sampler(0, 0, 11, backend)
    dev = sampler.device_epoch_indices(SHARD_SIZES, within_shard_shuffle=64)
    host = expand_shard_indices_cpu(
        make_sampler(0, 0, 11, "cpu").epoch_indices(), SHARD_SIZES, seed=11,
        epoch=0, within_shard_shuffle=64)
    assert dev.device.type == device
    assert torch.equal(dev.cpu(), host)
    print(f"ok: tier 2, rank 0 epoch 0 expanded on {device}: {len(host)} "
          f"indices, bit-identical to the host expansion")
    # variable-length document shards: hundreds of distinct sizes expand
    # on the card in the same two launches
    rng = np.random.default_rng(5)
    var_sizes = rng.integers(20, 400, 800)
    var_stream = rng.permutation(800)[:300]
    vdev = expand_shard_indices_cuda(var_stream, var_sizes, seed=11,
                                     epoch=0, device=device)
    vhost = expand_shard_indices_cpu(var_stream, var_sizes, seed=11, epoch=0)
    assert torch.equal(vdev.cpu(), vhost)
    print(f"ok: tier 3, {len(set(var_sizes.tolist()))} distinct shard sizes "
          f"-> {len(vhost)} indices on {device}, bit-identical")


def main(argv=None) -> None:
    device = parse_device(__doc__.splitlines()[0], argv)
    if device == "cuda":
        from ..ops.cuda_kernel import require_cuda

        require_cuda()
    host_stream_tier("cuda" if device == "cuda" else "cpu")
    device_tier(device)
    print("ok: config-4 shape end to end")


if __name__ == "__main__":
    main()
