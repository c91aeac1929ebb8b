#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA package partiallyshuffledistributedsampler_tpu_torch.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the CUDA index kernels from ``csrc/index_kernels.cu``, checks the
frozen goldens on the card, holds each kernel bit-exact against its plain
PyTorch version at the shapes of the main path (C4 1B samples / window
8192 at world 256 and 8; ImageNet-1k 1,281,167 / 8192 at world 8), drives
the main path through the entry points a user calls — the sampler under a
real ``DataLoader`` and ``DeviceEpochIterator`` — with the kernels' launch
counters reset just before and read just after, and times every kernel
beside its plain version and its bound.  Every failure exits non-zero.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is ``{"kernels": [...]}``.
"""

import json
import subprocess
import sys
import time

N_C4, W = 1_000_000_000, 8192
N_IMAGENET = 1_281_167
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    try:
        import partiallyshuffledistributedsampler_tpu_torch as pt
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            core,
            cuda_kernel as ck,
        )
    except ImportError as exc:
        fail(f"the package is not importable here ({exc}); run from the "
             "repository root")
    import numpy as np
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
    print(f"kernels: {json.dumps(launches)}")
    for name, count in launches.items():
        check(count > 0, f"kernel {name} was not launched on the main path")

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
        a full window (two bijections) or in the tail window (one)."""
        ns, _ = core.shard_sizes(n, world, False)
        p = core.rank_positions(n, rank, world, ns, partition, False, dev)
        body = int((p[first:] < (n // W) * W).sum().item())
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
    for name, label, kfn, pfn, ops, nbytes in timings:
        ms = gpu_ms(kfn, 50)
        plain = gpu_ms(pfn, 3 if "world=8" in label else 5)
        b_ms, b_by = bound(ops, nbytes)
        print(f"time {name} {label}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}; "
              f"{ops / 1e9:.3f} G int32 ops, {nbytes / 1e6:.1f} MB), "
              f"{b_ms / ms:.1%} of bound | {card}")
        rows.setdefault(name, (ms, plain, b_ms, b_by))
    for world in (256, 8):
        fn = lambda w=world: pt.epoch_indices_cuda(N_C4, W, 0, 1, 5 % w, w)
        dev_ms = gpu_ms(fn, 20)
        walls = []
        for _ in range(20):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t) * 1e3)
        print(f"regen per epoch n=1e9 W=8192 world={world}: device "
              f"{dev_ms:.4f} ms (2 launches), host wall to ready "
              f"median {float(np.median(walls)):.4f} ms min "
              f"{min(walls):.4f} ms | {card}")
    print("library call: none (no single PyTorch call computes this law; "
          "torch.randperm is a different function)")

    replaces = {
        "window_order_ids":
            "partiallyshuffledistributedsampler_tpu/ops/xla.py:58",
        "index_general":
            "partiallyshuffledistributedsampler_tpu/ops/pallas_kernel.py:75",
        "index_amortized":
            "partiallyshuffledistributedsampler_tpu/ops/pallas_kernel.py:161",
    }
    kernels = []
    for name in ("window_order_ids", "index_general", "index_amortized"):
        ms, plain, b_ms, b_by = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "partiallyshuffledistributedsampler_tpu_torch/csrc/"
                      "index_kernels.cu",
            "replaces": replaces[name], "launches": launches[name],
            "max_abs_err": stats[name]["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
