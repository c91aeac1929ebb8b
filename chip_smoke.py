#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA package partiallyshuffledistributedsampler_tpu_torch.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the CUDA index kernels from ``csrc/index_kernels.cu``, checks the
frozen goldens on the card, holds each kernel bit-exact against its plain
PyTorch version at the shapes of the main paths, drives each main path
through the entry points a user calls with the kernels' launch counters
reset just before and read just after, and times every kernel beside its
plain version and its bound.  Every failure exits non-zero.

* Slice 1, C4 1B samples / window 8192 at world 256 and 8, ImageNet-1k
  1,281,167 / 8192 at world 8: the sampler under a real ``DataLoader``
  and ``DeviceEpochIterator``.
* Slice 2, the Llama-3 8B pretrain config's 10B-sample index space /
  window 8192 (n >= 2^31, int64, the ``_wide`` kernels) at world 256 and
  8, n = 2^32 + 4097 at world 1 (num_samples >= 2^32), random access at
  10B; the sampler and ``DeviceEpochIterator`` at 10B / world 256; the
  seed agreement of ``parallel/``: an NCCL group of one process (32
  reseeds, then an agreed wide regen and an elastic remainder at 10B, all
  under ``torch.cuda.set_sync_debug_mode("error")``: no host
  synchronisation) and two gloo processes on the one card with divergent
  local seeds, where rank 0's must win.  The gloo processes are this
  script, run with ``--gloo-worker RANK PORT``.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is ``{"kernels": [...]}``.
"""

import itertools
import json
import os
import socket
import subprocess
import sys
import time

N_C4, W = 1_000_000_000, 8192
N_IMAGENET = 1_281_167
N_LLAMA = 10_000_000_000  # the Llama-3 8B pretrain config's index space
N_2_32 = 2**32 + 4097  # num_samples >= 2^32 at world 1
N_WIDE1 = 2**31 + 5000  # the least wide space, agreed at world 1 (17 GB)
#: the slice-1 kernels and the slice-2 ones (the wide forms)
SLICE1 = ("window_order_ids", "index_general", "index_amortized")
SLICE2 = ("window_order_ids", "index_amortized", "index_general_wide",
          "index_amortized_wide")
#: (seed_lo, seed_hi, epoch) of the two gloo ranks: divergent, rank 0 wins
GLOO_LOCAL = ((0x1234, 5, 7), (0xBEEF, 9, 99))
GLOO_LAYERS = [(8, 100_000)]
#: int32 ALU operations per element, counted from csrc/index_kernels.cu
#: with the fusions the ISA offers (3-input add, 3-input logic, min/max)
#: and without the two multiplies of mix32, which may issue on the FMA
#: pipe: per swap-or-not round 13 = partner (1) + wrap (2) + max (1) +
#: key xor (1) + mix32 shifts/xors (6) + decision bit and select (2)
ROUND_OPS = 13
#: per-element decision key of a per-window bijection:
#: inner_key (two mix32 + xors, 14) + key2 (mix32 + xor, 7)
INNER_KEY_OPS = 21
#: position and index arithmetic per element (div, mod, mod n)
POS_OPS = 3
#: extra per element of a wide (uint64-position) lane: the carry of the
#: 64-bit position multiply-add and of the 64-bit combine.  A 64-bit / or
#: % counts as one operation, as in POS_OPS: the bound leaves out the
#: software sequences that they compile to
WIDE_OPS = 2
INT32_OPS_PER_CLK_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def nvidia_smi(query: str) -> str:
    res = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def gloo_worker(rank: int, port: int) -> None:
    """One of two processes on the one card: agree on rank 0's seed over
    gloo with divergent local seeds, regenerate this rank's row through the
    kernels, and print what it found as one JSON line."""
    import torch
    import torch.distributed as dist

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch import parallel
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
    )

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        mesh = parallel.data_mesh(device="cuda")
        ck.reset_launches()
        row = parallel.sharded_epoch_indices(
            N_IMAGENET, W, None, None, mesh=mesh,
            local_seeds=GLOO_LOCAL[rank])
        el = parallel.sharded_elastic_indices(
            N_IMAGENET, W, None, None, GLOO_LAYERS, mesh=mesh,
            local_seeds=GLOO_LOCAL[rank])
        torch.cuda.synchronize()
        launches = dict(ck.launches)
        lo, hi, ep = GLOO_LOCAL[0]
        seed0 = lo | (hi << 32)
        want = pt.epoch_indices_cuda(N_IMAGENET, W, seed0, ep, rank, 2)
        chain, _, ns = core.elastic_chain(N_IMAGENET, GLOO_LAYERS, 2)
        want_el = pt.elastic_indices_cuda(N_IMAGENET, W, seed0, ep, rank, 2,
                                          ns, chain)
        lo, hi, ep = GLOO_LOCAL[rank]
        own = pt.epoch_indices_cuda(N_IMAGENET, W, lo | (hi << 32), ep, rank,
                                    2)
        print(json.dumps({
            "rank": rank, "is_cuda": row.is_cuda and el.is_cuda,
            "lanes": row.numel(), "elastic_lanes": el.numel(),
            "row_equal": torch.equal(row, want),
            "elastic_equal": torch.equal(el, want_el),
            "own_seed_differs": not torch.equal(own, want),
            "launches": launches,
        }))
    finally:
        dist.destroy_process_group()


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if sys.argv[1:2] == ["--gloo-worker"]:
        gloo_worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    try:
        import partiallyshuffledistributedsampler_tpu_torch as pt
        from partiallyshuffledistributedsampler_tpu_torch import parallel
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            core,
            cuda_kernel as ck,
        )
    except ImportError as exc:
        fail(f"the package is not importable here ({exc}); run from the "
             "repository root")
    import numpy as np
    import torch.distributed as dist
    from torch.utils.data import DataLoader, TensorDataset

    dev = torch.device("cuda")
    stats = {k: {"err": 0} for k in ck.launches}

    # ---------------------------------------------------------------- 1
    card = nvidia_smi("name,power.limit")
    print(card)
    max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = INT32_OPS_PER_CLK_PER_SM * sms * max_sm_mhz * 1e6
    print(f"device: {torch.cuda.get_device_name(0)}, {sms} SMs, max SM "
          f"clock {max_sm_mhz:.0f} MHz, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    ck.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    for line in ck.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # ---------------------------------------------------------------- 2
    g1 = pt.epoch_indices_cuda(1000, 64, 42, 3, 1, 4)
    g2 = pt.epoch_indices_cuda(500, 32, (1 << 40) + 7, 1, 0, 1)
    check(g1.is_cuda and g2.is_cuda, "goldens did not run on the card")
    print(f"golden 1: {g1[:8].tolist()}")
    print(f"golden 2: {g2[:8].tolist()}")
    check(g1[:8].tolist() == [706, 727, 713, 733, 717, 766, 744, 716],
          "golden 1 differs")
    check(g2[:8].tolist() == [91, 90, 77, 69, 83, 67, 95, 79],
          "golden 2 differs")

    # ---------------------------------------------------------------- 3
    def hold(name, got, want, label):
        equal = torch.equal(got.long(), want.long())
        err = int((got.long() - want.long()).abs().max().item())
        stats[name]["err"] = max(stats[name]["err"], err)
        print(f"check {name} {label}: lanes={got.numel()} equal={equal} "
              f"max_abs_err={err} (tolerance 0: the law is integer-exact)")
        check(equal and got.shape == want.shape,
              f"{name} {label} differs from its plain version")

    for epoch in (0, 1):
        ku = ck.window_order_ids(N_C4, W, 0, epoch)
        hold("window_order_ids", ku,
             ck.window_order_ids_ref(N_C4, W, 0, epoch, device=dev),
             f"n=1e9 W=8192 nw={N_C4 // W} epoch={epoch}")
        for rank in (0, 255):
            ns, _ = core.shard_sizes(N_C4, 256, False)
            hold("index_amortized",
                 ck.index_amortized(ku, N_C4, W, 0, epoch, rank, 256),
                 ck.index_amortized_ref(ku, N_C4, W, 0, epoch, rank, 256, ns),
                 f"n=1e9 W=8192 world=256 rank={rank} epoch={epoch}")
            hold("index_general",
                 ck.index_general(N_C4, W, 0, epoch, rank, 256, device=dev),
                 ck.index_general_ref(N_C4, W, 0, epoch, rank, 256,
                                      device=dev),
                 f"n=1e9 W=8192 world=256 rank={rank} epoch={epoch} "
                 "(amortize=False shape)")
    ku = ck.window_order_ids(N_C4, W, 0, 1)
    ns8, _ = core.shard_sizes(N_C4, 8, False)
    hold("index_amortized", ck.index_amortized(ku, N_C4, W, 0, 1, 3, 8),
         ck.index_amortized_ref(ku, N_C4, W, 0, 1, 3, 8, ns8),
         "n=1e9 W=8192 world=8 rank=3 epoch=1 (all 125M lanes)")
    for rank in range(8):
        kw = dict(partition="blocked", device=dev)
        hold("index_general",
             ck.index_general(N_IMAGENET, W, 0, 1, rank, 8, **kw),
             ck.index_general_ref(N_IMAGENET, W, 0, 1, rank, 8, **kw),
             f"ImageNet n=1281167 W=8192 world=8 blocked rank={rank}")
    del ku
    torch.cuda.empty_cache()

    # --------------------------------------------- 3b: n >= 2^31 (wide)
    def triple_of(seed, epoch):
        bits = np.array(core.seed_triple(seed, epoch), dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(dev)

    def routed(name, fn):
        """Run ``fn`` and check it launched kernel ``name`` once."""
        before = ck.launches[name]
        out = fn()
        check(ck.launches[name] == before + 1, f"{name} was not launched")
        check(out.is_cuda and out.dtype == torch.int64,
              f"{name} output is not CUDA int64")
        return out

    ns256, _ = core.shard_sizes(N_LLAMA, 256, False)
    for rank in (0, 255):
        ku = ck.window_order_ids(N_LLAMA, W, 0, 1)
        hold("window_order_ids", ku,
             ck.window_order_ids_ref(N_LLAMA, W, 0, 1, device=dev),
             f"n=1e10 W=8192 nw={N_LLAMA // W} epoch=1")
        got = routed("index_amortized_wide", lambda: pt.epoch_indices_cuda(
            N_LLAMA, W, 0, 1, rank, 256))
        hold("index_amortized_wide", got,
             ck.index_amortized_wide_ref(ku, N_LLAMA, W, 0, 1, rank, 256,
                                         ns256),
             f"n=1e10 W=8192 world=256 rank={rank} (all {ns256} lanes)")
        high = int(got.max().item())
        got = routed("index_general_wide", lambda: pt.epoch_indices_cuda(
            N_LLAMA, W, 0, 1, rank, 256, amortize=False))
        hold("index_general_wide", got,
             ck.index_general_wide_ref(N_LLAMA, W, 0, 1, rank, 256,
                                       device=dev),
             f"n=1e10 W=8192 world=256 rank={rank} amortize=False (all "
             f"{ns256} lanes)")
        print(f"  int64, max index {high} > 2^31: {high > 2**31}")
        check(high > 2**31, "no index above 2^31 at n=1e10")

    # the seed triple read from device memory, against scalar launches
    for n, world, rank in ((N_C4, 256, 5), (N_LLAMA, 256, 255)):
        wide = core.is_wide(n)
        t = triple_of(0x1_0000_0007, 3)
        ku = ck.window_order_ids(n, W, 0x1_0000_0007, 3)
        ku_t = ck.window_order_ids(n, W, None, None, triple=t)
        hold("window_order_ids", ku_t, ku, f"n={n:.0e} device triple")
        general = ck.index_general_wide if wide else ck.index_general
        amortized = ck.index_amortized_wide if wide else ck.index_amortized
        name = "_wide" if wide else ""
        hold("index_general" + name,
             general(n, W, None, None, rank, world, triple=t),
             general(n, W, 0x1_0000_0007, 3, rank, world),
             f"n={n:.0e} world={world} device triple")
        hold("index_amortized" + name,
             amortized(ku_t, n, W, None, None, rank, world, triple=t),
             amortized(ku, n, W, 0x1_0000_0007, 3, rank, world),
             f"n={n:.0e} world={world} device triple")
    del ku, ku_t, got
    torch.cuda.empty_cache()

    # world 8: 1.25B lanes (10 GB of int64), held on sampled lanes
    ns8, _ = core.shard_sizes(N_LLAMA, 8, False)
    body8 = (N_LLAMA // W) * (W // 8)
    out = routed("index_amortized_wide", lambda: pt.epoch_indices_cuda(
        N_LLAMA, W, 0, 1, 3, 8))
    rng = np.random.default_rng(0)
    lanes = np.unique(np.concatenate([
        rng.choice(ns8, 1_000_000, replace=False), np.arange(4),
        np.arange(body8 - 4, body8 + 4), np.arange(ns8 - 4, ns8)]))
    check(lanes.size >= 1_000_000, f"only {lanes.size} lanes sampled")
    lanes = torch.from_numpy(lanes).to(dev)
    hold("index_amortized_wide", out[lanes],
         pt.stream_indices_at_cuda(3 + 8 * lanes, N_LLAMA, W, 0, 1),
         f"n=1e10 W=8192 world=8 rank=3: {lanes.numel()} of {ns8} lanes "
         "(seeded, first, last, body/tail boundary) against the plain "
         "random-access law")
    del out
    torch.cuda.empty_cache()

    # num_samples >= 2^32: the 64-bit lane counter (34.4 GB of int64)
    out = routed("index_general_wide", lambda: pt.epoch_indices_cuda(
        N_2_32, W, 0, 1, 0, 1))
    check(out.numel() == N_2_32, "n = 2^32 + 4097 at world 1: lane count")
    lanes = torch.tensor([0, 2**32 - 2, 2**32 - 1, 2**32, 2**32 + 1,
                          2**32 + 2, N_2_32 - 1], device=dev)
    hold("index_general_wide", out[lanes],
         pt.stream_indices_at_cuda(lanes, N_2_32, W, 0, 1),
         f"n=2^32+4097 W=8192 world=1: lanes {lanes.tolist()} against the "
         "plain random-access law")
    del out
    torch.cuda.empty_cache()

    # random access at 10B on the card, against the plain law on the host
    probes = np.random.default_rng(1).integers(0, 2 * N_LLAMA, 4096)
    got = pt.stream_indices_at_cuda(probes, N_LLAMA, W, 0, 1)
    want = pt.stream_indices_at_cpu(probes, N_LLAMA, W, 0, 1)
    ok = (got.is_cuda and got.dtype == torch.int64
          and torch.equal(got.cpu(), want) and int(got.max()) > 2**31)
    print(f"stream_indices_at_cuda n=1e10: 4096 probes on the card, int64, "
          f"max {int(got.max())}, equal to the host law: {ok}")
    check(ok, "random access at n=1e10 differs from the plain law")

    # ------------------------------------------------------ main path
    ck.reset_launches()
    # 4: the sampler under a real DataLoader, ImageNet-1k config
    ds = TensorDataset(torch.arange(N_IMAGENET))

    def union_once(partition, workers):
        seen = []
        for rank in range(8):
            s = pt.PartiallyShuffleDistributedSampler(
                ds, num_replicas=8, rank=rank, window=W, partition=partition)
            s.set_epoch(1)
            seen += [b.numpy() for (b,) in DataLoader(
                ds, batch_size=256, sampler=s, num_workers=workers)]
        seen = np.concatenate(seen)
        counts = np.bincount(seen, minlength=N_IMAGENET)
        total = seen.size
        _ns, tot = core.shard_sizes(N_IMAGENET, 8, False)
        extras = tot - N_IMAGENET
        ok = (counts.min() >= 1 and total == tot
              and int((counts - 1).sum()) == extras and counts.max() <= 2)
        print(f"dataloader {partition} num_workers={workers}: "
              f"{total} samples over 8 ranks, every index of [0, "
              f"{N_IMAGENET}) at least once, {extras} wrap-pad extras: {ok}")
        check(ok, f"DataLoader union ({partition}, workers={workers}) is "
              "not exactly-once plus wrap padding")

    union_once("strided", 0)
    union_once("strided", 2)
    union_once("blocked", 0)

    s = pt.PartiallyShuffleDistributedSampler(ds, num_replicas=8, rank=3,
                                              window=W)
    s.set_epoch(1)
    full = list(s)
    it = iter(s)
    head = [next(it) for _ in range(50_000)]
    state = s.state_dict()
    r = pt.PartiallyShuffleDistributedSampler(ds, num_replicas=8, rank=3,
                                              window=W)
    r.load_state_dict(state)
    remaining = len(r)
    rest = list(r)
    ok = (head == full[:50_000] and rest == full[50_000:]
          and remaining == len(full) - 50_000)
    print(f"state_dict round trip at offset {state['offset']}: resumed "
          f"{len(rest)} indices equal the uninterrupted stream: {ok}")
    check(ok, "mid-epoch resume differs")
    loader = pt.StatefulDataLoader(ds, batch_size=256, sampler=s,
                                   num_workers=2)
    s.set_epoch(2)
    got = []
    for step, (b,) in enumerate(loader):
        got.append(b)
        if step == 99:
            ckpt = loader.state_dict()
            break
    s2 = pt.PartiallyShuffleDistributedSampler(ds, num_replicas=8, rank=3,
                                               window=W)
    loader2 = pt.StatefulDataLoader(ds, batch_size=256, sampler=s2,
                                    num_workers=2)
    loader2.load_state_dict(ckpt)
    resumed = torch.cat(got + [b for (b,) in loader2]).tolist()
    ok = resumed == s.epoch_indices(2).tolist()
    print(f"StatefulDataLoader(num_workers=2) resume after 100 batches: "
          f"{ok}")
    check(ok, "StatefulDataLoader resume differs")
    print(f"sampler regen timer (ImageNet rank 3, host ms incl. copy): "
          f"{s.regen_timer.report()}")

    # 5: device-resident iteration, C4 1B / 8192 at world 256
    it = pt.DeviceEpochIterator(N_C4, W, 512, seed=0, rank=5, world=256)
    check(it.steps_per_epoch == 3_906_250 // 512, "steps per epoch")
    for epoch in (0, 1):
        batches = list(it.epoch(epoch))
        check(len(batches) == it.steps_per_epoch, "iterator step count")
        check(all(b.is_cuda and b.dtype == torch.int32 and b.numel() == 512
                  for b in batches), "batches are not CUDA int32[512]")
        check(epoch + 1 in it._cache, "next epoch was not prefetched")
        want = ck.index_general_ref(N_C4, W, 0, epoch, 5, 256, device=dev)
        ok = torch.equal(torch.cat(batches),
                         want[:it.steps_per_epoch * 512])
        print(f"DeviceEpochIterator epoch {epoch}: {len(batches)} CUDA "
              f"int32 views of 512, next epoch prefetched, equal to the "
              f"law: {ok}")
        check(ok, "DeviceEpochIterator batches differ from the law")
    torch.cuda.synchronize()
    launches = dict(ck.launches)
    print(f"kernels (slice-1 main path): {json.dumps(launches)}")
    for name in SLICE1:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")

    # ------------------------------------------- slice-2 main path
    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    mesh = parallel.data_mesh()  # one process, one card
    layers = [(256, 39_000_000)]  # a reshard 39M samples into the epoch
    sh_layers = [(256, 39_062_000)]
    ck.reset_launches()
    # 7: the sampler at 10B / world 256
    s = pt.PartiallyShuffleDistributedSampler(N_LLAMA, num_replicas=256,
                                              rank=7, window=W)
    check(len(s) == 39_062_500, f"len(sampler) = {len(s)}")
    s.set_epoch(1)  # the amortized wide kernel + a 312.5 MB pinned copy
    head = list(itertools.islice(iter(s), 100_000))
    # 8: DeviceEpochIterator at 10B / world 256, strided and blocked
    it = pt.DeviceEpochIterator(N_LLAMA, W, 512, seed=0, rank=5, world=256)
    check(it.steps_per_epoch == 39_062_500 // 512, "steps per epoch")
    epochs = {}
    for epoch in (0, 1):
        batches = list(it.epoch(epoch))
        check(len(batches) == it.steps_per_epoch, "iterator step count")
        check(all(b.is_cuda and b.dtype == torch.int64 and b.numel() == 512
                  for b in batches), "batches are not CUDA int64[512]")
        check(epoch + 1 in it._cache, "next epoch was not prefetched")
        epochs[epoch] = torch.cat(batches)
    blocked = torch.cat(list(pt.DeviceEpochIterator(
        N_LLAMA, W, 512, seed=0, rank=5, world=256, partition="blocked",
        prefetch_next_epoch=False).epoch(1)))
    elastic = torch.cat(list(it.elastic_epoch(2, layers)))

    # 9: seed agreement over an NCCL group of one, no host sync
    def agreed_wide(epoch):
        """The agreed paths of the wide regime: the general wide kernel on
        the device triple (world 1 takes n >= 2^31 off the amortized
        route) and the elastic law at 10B, its keys from the agreed
        tensor."""
        return (parallel.sharded_epoch_indices(N_WIDE1, W, 0, epoch,
                                               mesh=mesh),
                parallel.sharded_elastic_indices(N_LLAMA, W, 0, epoch,
                                                 sh_layers, mesh=mesh))

    # warm-up: the NCCL communicator is built, the allocator caches blocks
    parallel.sharded_epoch_indices(N_IMAGENET, W, 0, 0, mesh=mesh)
    agreed_wide(0)
    torch.cuda.synchronize()
    reseeds, walls = [], []
    t_all = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for epoch in range(1, 33):
            t = time.perf_counter()
            reseeds.append(parallel.sharded_epoch_indices(
                N_IMAGENET, W, 0, epoch, mesh=mesh))
            walls.append((time.perf_counter() - t) * 1e3)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    all_ms = (time.perf_counter() - t_all) * 1e3
    torch.cuda.set_sync_debug_mode("error")
    try:
        sh_wide, sh_elastic = agreed_wide(1)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    launches2 = dict(ck.launches)
    print(f"kernels (slice-2 main path): {json.dumps(launches2)}")
    for name in SLICE2:
        check(launches2[name] > 0,
              f"kernel {name} was not launched on the slice-2 main path")

    # the slice-2 main path's outputs against the law
    want = pt.epoch_indices_cuda(N_LLAMA, W, 0, 1, 7, 256)
    ok = head == want[:100_000].tolist() and head == pt.stream_indices_at_cuda(
        7 + 256 * torch.arange(100_000, device=dev), N_LLAMA, W, 0, 1
    ).tolist()
    print(f"sampler n=1e10 world=256 rank=7: len {len(s)}, first 100,000 "
          f"indices equal the kernel output and the random-access law: "
          f"{ok}; regen timer {s.regen_timer.report()}")
    check(ok, "the sampler's stream at n=1e10 differs")
    for epoch, got in epochs.items():
        ok = torch.equal(got, ck.index_general_wide_ref(
            N_LLAMA, W, 0, epoch, 5, 256, device=dev)[:got.numel()])
        print(f"DeviceEpochIterator n=1e10 world=256 epoch {epoch}: "
              f"{it.steps_per_epoch} CUDA int64 views of 512, next epoch "
              f"prefetched, equal to the law: {ok}")
        check(ok, "DeviceEpochIterator batches at n=1e10 differ")
    ok = torch.equal(blocked, ck.index_general_wide_ref(
        N_LLAMA, W, 0, 1, 5, 256, partition="blocked",
        device=dev)[:blocked.numel()])
    print(f"DeviceEpochIterator n=1e10 world=256 blocked: equal to the law: "
          f"{ok}")
    check(ok, "blocked DeviceEpochIterator batches at n=1e10 differ")
    want = pt.elastic_indices_cpu(N_LLAMA, W, 0, 2, 5, 256, layers)
    ok = elastic.is_cuda and torch.equal(elastic.cpu(),
                                         want[:elastic.numel()])
    print(f"DeviceEpochIterator.elastic_epoch n=1e10 after {layers}: "
          f"{elastic.numel()} lanes, equal to the host law: {ok}")
    check(ok, "elastic_epoch at n=1e10 differs")
    ok = all(torch.equal(r, pt.epoch_indices_cuda(N_IMAGENET, W, 0, e, 0, 1))
             for e, r in enumerate(reseeds, start=1))
    print(f"sharded_epoch_indices ImageNet W=8192, NCCL group of one: 32 "
          f"reseeds under set_sync_debug_mode('error') with no error, each "
          f"equal to epoch_indices_cuda with the host seed: {ok}; host wall "
          f"per reseed median {float(np.median(walls)):.4f} ms min "
          f"{min(walls):.4f} ms, 32 reseeds to ready {all_ms:.4f} ms | "
          f"{card}")
    check(ok, "sharded_epoch_indices differs from epoch_indices_cuda")
    ok = (sh_wide.dtype == torch.int64 and sh_wide.numel() == N_WIDE1
          and torch.equal(sh_wide, pt.epoch_indices_cuda(N_WIDE1, W, 0, 1,
                                                         0, 1)))
    print(f"sharded_epoch_indices n=2^31+5000 W=8192 world=1 (general wide "
          f"kernel on the agreed device triple) under "
          f"set_sync_debug_mode('error') with no error: {sh_wide.numel()} "
          f"int64 lanes, equal to epoch_indices_cuda with the host seed: "
          f"{ok}")
    check(ok, "sharded_epoch_indices at n=2^31+5000 differs")
    del sh_wide
    want = pt.elastic_indices_cpu(N_LLAMA, W, 0, 1, 0, 1, sh_layers)
    ok = (sh_elastic.is_cuda and sh_elastic.dtype == torch.int64
          and torch.equal(sh_elastic.cpu(), want))
    print(f"sharded_elastic_indices n=1e10 after {sh_layers} under "
          f"set_sync_debug_mode('error') with no error: "
          f"{sh_elastic.numel()} lanes, equal to the host law: {ok}")
    check(ok, "sharded_elastic_indices at n=1e10 differs")
    dist.destroy_process_group()
    del s, it, epochs, blocked, elastic, reseeds, want
    torch.cuda.empty_cache()

    # 10: two gloo processes on the one card, divergent local seeds
    port = free_port()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--gloo-worker", str(r),
         str(port)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300))
    except subprocess.TimeoutExpired:
        fail("the gloo workers did not finish in 300 s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        check(p.returncode == 0, f"gloo worker failed:\n{err[-3000:]}")
        res = json.loads(out.strip().splitlines()[-1])
        print(f"gloo rank {res['rank']} of 2 on the one card: {res}")
        check(res["is_cuda"] and res["row_equal"] and res["elastic_equal"]
              and res["launches"]["index_amortized"] == 1,
              f"gloo rank {res['rank']}: rank 0's seed did not win")
        check(res["rank"] == 0 or res["own_seed_differs"],
              "rank 1's own seed gives rank 0's row: the check is vacuous")

    # ---------------------------------------------------------------- 6
    def gpu_ms(fn, reps):
        """Device time per call: CUDA events around ``reps`` calls queued
        behind a busy-wait kernel, so host launch gaps are hidden."""
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t
        cycles = int(min(5.0, 1.5 * reps * host_s + 1e-3)
                     * max_sm_mhz * 1e6)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / int_ops_per_s, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def lane_classes(n, world, rank, partition="strided", first=0):
        """Lanes t >= ``first`` of this rank's stream whose position is in
        a full window (two bijections) or in the tail window (one).  The
        positions never reach 2^32 here, so the narrow wrap changes
        nothing."""
        ns, _ = core.shard_sizes(n, world, False)
        t = torch.arange(first, ns, dtype=torch.int64, device=dev)
        p = (rank + world * t if partition == "strided"
             else rank * ns + t) % n
        body = int((p < (n // W) * W).sum().item())
        return body, ns - first - body

    nw = N_C4 // W
    son = 24 * ROUND_OPS
    ku = ck.window_order_ids(N_C4, W, 0, 1)
    rows = {}
    timings = [
        ("window_order_ids", "n=1e9 W=8192 nw=122070",
         lambda: ck.window_order_ids(N_C4, W, 0, 1),
         lambda: ck.window_order_ids_ref(N_C4, W, 0, 1, device=dev),
         nw * son, nw * 4),
    ]
    for world, rank in ((256, 5), (8, 3)):
        ns, _ = core.shard_sizes(N_C4, world, False)
        body = nw * (W // world)
        rest_body, rest_tail = lane_classes(N_C4, world, rank, first=body)
        timings.append((
            "index_amortized", f"n=1e9 W=8192 world={world}",
            lambda w=world, r=rank: ck.index_amortized(ku, N_C4, W, 0, 1, r,
                                                       w),
            lambda w=world, r=rank, ns=ns: ck.index_amortized_ref(
                ku, N_C4, W, 0, 1, r, w, ns),
            body * (son + INNER_KEY_OPS + POS_OPS)
            + rest_body * (2 * son + INNER_KEY_OPS + POS_OPS)
            + rest_tail * (son + POS_OPS),
            ns * 4 + nw * 4,
        ))
    for n, world, rank, part, label in (
            (N_C4, 256, 5, "strided", "n=1e9 W=8192 world=256"),
            (N_IMAGENET, 8, 3, "blocked", "ImageNet W=8192 world=8 blocked")):
        body, tail = lane_classes(n, world, rank, part)
        ns = body + tail
        timings.append((
            "index_general", label,
            lambda n=n, w=world, r=rank, p=part: ck.index_general(
                n, W, 0, 1, r, w, partition=p, device=dev),
            lambda n=n, w=world, r=rank, p=part: ck.index_general_ref(
                n, W, 0, 1, r, w, partition=p, device=dev),
            body * (2 * son + INNER_KEY_OPS + POS_OPS)
            + tail * (son + POS_OPS),
            ns * 4,
        ))
    nwl = N_LLAMA // W
    kul = ck.window_order_ids(N_LLAMA, W, 0, 1)
    for world, rank in ((256, 5), (8, 3)):
        ns, _ = core.shard_sizes(N_LLAMA, world, False)
        body = nwl * (W // world)
        rest_body, rest_tail = lane_classes(N_LLAMA, world, rank, first=body)
        timings.append((
            "index_amortized_wide", f"n=1e10 W=8192 world={world}",
            lambda w=world, r=rank: ck.index_amortized_wide(
                kul, N_LLAMA, W, 0, 1, r, w),
            # the plain version at world 8 needs ~60 GB of temporaries
            None if world == 8 else
            lambda w=world, r=rank, ns=ns: ck.index_amortized_wide_ref(
                kul, N_LLAMA, W, 0, 1, r, w, ns),
            body * (son + INNER_KEY_OPS + POS_OPS + 1)
            + rest_body * (2 * son + INNER_KEY_OPS + POS_OPS + WIDE_OPS)
            + rest_tail * (son + POS_OPS + WIDE_OPS),
            ns * 8 + nwl * 4,
        ))
    body, tail = lane_classes(N_LLAMA, 256, 5)
    timings.append((
        "index_general_wide", "n=1e10 W=8192 world=256",
        lambda: ck.index_general_wide(N_LLAMA, W, 0, 1, 5, 256),
        lambda: ck.index_general_wide_ref(N_LLAMA, W, 0, 1, 5, 256,
                                          device=dev),
        body * (2 * son + INNER_KEY_OPS + POS_OPS + WIDE_OPS)
        + tail * (son + POS_OPS + WIDE_OPS),
        (body + tail) * 8,
    ))
    for name, label, kfn, pfn, ops, nbytes in timings:
        ms = gpu_ms(kfn, 10 if "world=8" in label else 50)
        plain = (gpu_ms(pfn, 3 if "world=8" in label else 5)
                 if pfn is not None else None)
        b_ms, b_by = bound(ops, nbytes)
        plain_s = ("not measured" if plain is None else f"{plain:.4f} ms")
        print(f"time {name} {label}: kernel {ms:.4f} ms, plain {plain_s}, "
              f"bound {b_ms:.4f} ms ({b_by}; {ops / 1e9:.3f} G int32 ops, "
              f"{nbytes / 1e6:.1f} MB), {b_ms / ms:.1%} of bound | {card}")
        rows.setdefault(name, (ms, plain, b_ms, b_by))
    del kul
    torch.cuda.empty_cache()
    for n, world in ((N_C4, 256), (N_C4, 8), (N_LLAMA, 256), (N_LLAMA, 8)):
        fn = lambda n=n, w=world: pt.epoch_indices_cuda(n, W, 0, 1, 5 % w, w)
        dev_ms = gpu_ms(fn, 20 if world == 256 else 5)
        walls = []
        for _ in range(20 if world == 256 else 5):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        line = (f"regen per epoch n={n:.0e} W=8192 world={world}: device "
                f"{dev_ms:.4f} ms (2 launches), host wall to ready "
                f"median {float(np.median(walls)):.4f} ms min "
                f"{min(walls):.4f} ms")
        if world == 256:
            t3 = triple_of(0, 1)
            tri_ms = gpu_ms(lambda n=n: pt.epoch_indices_cuda(
                n, W, None, None, 5, 256, triple=t3), 20)
            line += f", device triple {tri_ms:.4f} ms"
        print(f"{line} | {card}")
    print("library call: none (no single PyTorch call computes this law; "
          "torch.randperm is a different function)")

    replaces = {
        "window_order_ids":
            "partiallyshuffledistributedsampler_tpu/ops/xla.py:58",
        "index_general":
            "partiallyshuffledistributedsampler_tpu/ops/pallas_kernel.py:75",
        "index_amortized":
            "partiallyshuffledistributedsampler_tpu/ops/pallas_kernel.py:161",
        "index_general_wide":
            "partiallyshuffledistributedsampler_tpu/ops/core.py:527",
        "index_amortized_wide":
            "partiallyshuffledistributedsampler_tpu/ops/xla.py:87",
    }
    kernels = []
    for name in replaces:
        ms, plain, b_ms, b_by = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "partiallyshuffledistributedsampler_tpu_torch/csrc/"
                      "index_kernels.cu",
            "replaces": replaces[name],
            # the count over the two main paths' runs
            "launches": launches.get(name, 0) + launches2.get(name, 0),
            "max_abs_err": stats[name]["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
