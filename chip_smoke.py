#!/usr/bin/env python3
"""GPU smoke of the PyTorch/CUDA package partiallyshuffledistributedsampler_tpu_torch.

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It builds the CUDA kernels from ``csrc/index_kernels.cu``,
``csrc/mixture_kernels.cu``, ``csrc/shard_kernels.cu`` and
``csrc/sampling_kernels.cu`` (one nvcc each, run together), checks the
frozen goldens on the card, holds each kernel
bit-exact against its plain PyTorch version at the shapes of the main
paths, drives each main path
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
* Slice 3, the weighted multi-corpus mixture (SPEC.md §8) and its two
  kernels (``csrc/mixture_kernels.cu``): M1 is the repo's 1B three-corpus
  anchor (web/code/books 700M/200M/100M at 70/20/10, window 8192, block
  1024) at world 256, 32 and 8; M2 is M1's spec over a 10B-sample epoch
  (uint64 positions, int32 ids); M3 is the 10B id space as a 70/20/10
  mixture of six sources (int64 ids); and a 300-source spec.  The main
  path: ``PartialShuffleMixtureSampler`` under a real ``DataLoader``,
  ``MixtureEpochIterator`` (``epoch``, ``run_epoch``, ``run_epochs``,
  ``elastic_epoch``), 32 agreed ``sharded_mixture_indices`` reseeds and one
  ``sharded_mixture_elastic_indices`` over the NCCL group of one, and
  mixture rows in the two gloo processes; then the single-source
  ``run_epoch``/``run_epochs``.
* Slice 4, shard-index mode (SPEC.md §7, BASELINE config 4: WebDataset
  shards) and its two kernels (``csrc/shard_kernels.cu``): S1 is 100,000
  shards of 1,000 samples at world 8 and 1, S2 100,000 log-normal sizes of
  200..2000, S3 99,000 shards of 4..64 and 1,000 of 50,000..100,000, S4
  400,000 shards of 10,000 (int64); full, windowed (64) and sequential
  in-shard orders.  The main path: ``PartialShuffleShardSampler`` at S1 /
  world 8 under a real ``DataLoader`` for two epochs, each rank's
  ``device_epoch_indices`` beside it, then a reshard 8 -> 16.
* Slice 5 redesigned two kernels: the amortized index kernels compute the
  window order themselves (one launch per regen, checked wherever a regen
  is routed), and ``shard_row_keys`` stages its rows' heads in shared
  memory and writes their records four words per thread, coalesced.  The
  timings print the launch floor beside them, and a fill of the same
  table beside ``shard_row_keys``.
* Slice 6: every kernel family takes rounds above 64 (65, 102, 121 and
  the limit ``MAX_ROUNDS``, each held against its plain version; phase
  3e); ``shard_expand`` walks lane tiles with their rows staged in shared
  memory, and sequential mode is a copy that needs no ``shard_row_keys``
  (its tile edges are held in phase 3d); ``mixture_fused`` derives the keys
  of a small spec itself, so an M1/M2/M3 regen is one launch and
  ``mixture_source_keys`` runs only for the 300-source spec (on the
  slice-3 main path too), and phase 6 times the two routes over growing
  source counts; the elastic remainder regen is timed beside the kernel
  regen at 1B and 10B, world 256.
* Slice 7: the elastic remainder and random access run one kernel,
  ``index_positions`` (``_wide`` for n >= 2^31), which composes the
  reshard chain per lane or reads given int64 positions (phase 3f: 1B and
  10B at world 256 after a reshard 128 -> 256, a blocked 3-layer cascade
  at 1e8, 64- and 200-layer chains, rounds 65/102/121/4,096, 1M random
  positions with negative ones, each held against the plain chain law);
  the slice-1 main path adds a sampler reshard 8 -> 16 through a
  ``DataLoader`` and the iterator's ``elastic_epoch`` at 1B; the slice-2
  main path's remainders launch ``index_positions_wide``; phase 6 times
  both against the plain law and the kernel regen.
* Slice 8, ``HostDataLoader`` over host-resident data (phase 16,
  ``host_loader_phase``): on ``index_backend="cuda"`` over one 4 GB
  ``np.arange(1e9, int32)`` (a batch value is its row id), C4 1B/8192 at
  world 256 plain and after a reshard 128 -> 256, M1 at world 256 over
  concatenated data and per-source views, S1 at world 8, a
  ``StreamSpec.plain_stream(1e8, 8192)`` at horizons 0 and 1, and a
  boundary-prefetched epoch: each regen launches its kernels once, and
  every served batch is a CUDA tensor equal to the port's stream (on the
  card, and at sampled lanes from the CPU route); the epoch boundary at
  1B/world 256; then T1 (C4 GPT-2-small token rows) and T2 (ImageNet
  224x224x3 rows), cut in rows to fit host memory, with a per-row pattern
  checked on every served batch: gather and copy times, the host link,
  batches/s and ``StallProbe``'s stall share behind a synthetic step.

* Slice 9, weighted, prioritized and dedup sampling (phase 17,
  ``sampling_phase``): ``SamplingSpec`` on ``backend="cuda"`` over the
  ``weighted_stream`` kernels (``csrc/sampling_kernels.cu``).  W1 is M1's
  sources weighted 1/3/2 per sample, 1B draws at world 256 and 8; W2 the
  10B id space weighted 2/5/3 per source, 10B draws at world 256 (uint64
  ordinals, int64 ids, the 64-bit local draw); W3 the 300-source spec
  with quotas per 10^10 (the 64-bit accept draw, the table past the
  staging cap); W1 and W2 after a reshard 128 -> 256; W1 prioritized with
  weights adopted at epoch 1; an exact and a Bloom dedup over
  ImageNet-1k's ids, half of them an epoch.  Each regen is one launch (a
  dedup epoch ``retries + 1``), each stream is held against the kernel
  alone, the plain version on every lane and the CPU route, and each
  kernel is timed beside the uniform regen.  The phase alone:
  ``python3 chip_smoke.py --sampling`` (``--sampling --tile`` also folds
  the exact dedup's epoch 1, which tiles the id space: minutes of host
  Python).

* Slice 10, the consumer layer (phase 18, ``training_phase``): the
  port's GPT-2-small (config 3) and ViT-L/16 (config 4) at full width.
  Their forward on the card in f32 (TF32 off) against the same module on
  the CPU route; the slice's main path, the bf16 trainer at batch 8 x
  1,024 tokens over a device-resident token table of 2^20 rows (cut in
  rows only): ``make_run_runner`` (3 epochs x 8 steps) and
  ``make_mixture_run_runner`` over M1's 70/20/10 shape cut to 2^20 rows
  (2 epochs x 8 steps) under ``set_sync_debug_mode("error")``, one
  ``index_amortized`` or ``mixture_fused`` launch an epoch, each epoch's
  regen held against the plain law, finite losses and a falling
  GPT-2-small loss; the run runner then timed (``time_run``: device ms
  and host ms a step by CUDA events around whole runs, model TFLOP/s,
  the regen beside the step; a ``torch.profiler`` trace of a run for the
  launch gap, the device idle before a step, what the epoch boundary
  adds, the busy share and the kernels that take the time); T1's loader
  (2^20 host rows of 1,025 uint16 tokens) behind the GPT-2-small step,
  ``StallProbe`` at depth 1 and 2; ``demo_vit_run`` over 4,096 f32
  images, its regens held the same way, then its loop timed the same
  way.  The phase alone: ``python3 chip_smoke.py --train``.
  Phase 6 also times the masked per-source mixture (plain torch) at M1
  with ``fused=False`` and for a spec with a source past 2^31, beside its
  kernel since slice 15.

* Slice 11, signed epoch capabilities and the control plane (phase 19,
  ``capability_phase``): for C4 1B, M1, S1, W1 and a 1e8-horizon
  ``StreamSpec`` an ``EpochCapability`` is signed for the current
  membership, carried through its JSON wire and verified (a tampered copy
  and another deployment's key refused); ``replay_trail`` on
  ``backend="cuda"`` over a trail world/2 -> world (rank 0: the prefix it
  delivered, an orphan descriptor, the remainder; the last rank: joined at
  the reshard) is held at tolerance 0 against the same spec on 'cpu', each
  membership launching its kernels once; the replay is timed per
  membership (host wall with the readbacks, the device span by CUDA
  events) beside one ``rank_indices``, and sign/verify in microseconds.
  Then 20 ``epoch_indices_cuda`` regens at 1B/world 256 with telemetry on
  under ``set_sync_debug_mode("error")`` (one ``psds_epoch_regen`` span
  each), the regen with telemetry on and off, a fault site's no-plan
  cost; and three faults on the card: ``loader.prefetch`` at step 3
  (raised to the consumer, no thread left), ``loader.boundary`` (only the
  prefetch lost) and ``sampling.alias_build`` on W1 (the uniform table,
  warned and recorded).  The phase alone: ``python3 chip_smoke.py
  --capability``.
* Slice 12, the index service (phase 20, ``service_phase``): servers and
  clients run as threads of this process, every regen on specs with
  ``backend="cuda"``.  C4 1B / 8192 at world 256 served to 8 clients
  (ranks 0-6 and 255, transport batch 4,096), each stream byte-equal to a
  direct ``epoch_indices_cuda`` readback (ranks 0 and 255 also to the
  plain law on the card), one ``index_amortized`` an ``(epoch, rank)``, a
  reconnect replayed from the cache with no launch; one multi-tenant
  daemon with C4, M1 and W1 (two ranks each, concurrent regens, one
  launch of each tenant's kernel a regen); ImageNet at world 8 resharded
  to 16 after a third of the epoch (the union exactly once by
  ``tests/conftest.py``'s law, one ``index_positions`` a remainder rank);
  a primary killed under its ``role="standby"`` twin after 200 batches
  (streams without a gap or a duplicate, the failover time); a
  capability-mode client (zero index bytes on the wire); and
  ``HostDataLoader`` served over T1's rows behind the 5 ms step (stall %
  beside the local loader's), then degraded to a local regen on the card
  when its daemon stops.  Reported: ``epoch_regen_ms`` p50/p99 beside a
  direct regen, the ``GET_BATCH`` round trip, batches/s and MB/s a client
  and together, the failover time, wire bytes, the stall, launches.  The
  phase alone: ``python3 chip_smoke.py --service``.
* Slice 13, the sharded plane, federation and the autopilot (phase 21,
  ``sharding_phase``): shards, standbys, routers, cells and clients as
  threads of this process, every regen on specs with ``backend="cuda"``.
  C4 1B / 8192 at world 256 over ``ShardPlane(n_shards=4, standby=True,
  wal_dir=...)``: ranks 0, 63, 64, 127, 128, 191, 192, 255 dial the
  router, each redirected to its shard and byte-equal to a direct regen,
  one ``index_amortized`` an ``(epoch, rank)``, none on a cache replay,
  ``set_epoch`` fanned out; the cross-shard reshard 256 -> 192 a third of
  the way through an epoch over all 256 ranks (the union exactly once on
  the card, one ``index_positions`` a remainder rank held against its
  plain version); ``split_shard``, ``merge_shards`` and
  ``migrate_ranks`` under 8 live clients, then a shard primary killed
  under its standby; M1 and W1 attached as tenants (``mixture_fused``,
  ``weighted_stream``); a two-cell ``Federation`` (2 shards a cell)
  killed and promoted, a ``TrustBundle`` capability client, a live
  ``migrate_tenant``; the ``Autopilot`` at the policy's defaults in its
  predictive mode on a live plane (its card probe; under a hotspot a tune
  a client adopts and a split, each what a fresh policy decides on the
  observed window); a seeded
  ``FleetSim`` over the calibration the phase measured, printed and
  written to ``runs/fleetsim_calibration.json`` (gitignored).  Reported:
  ``epoch_regen_ms`` p50/p99 beside a direct regen, the ``GET_BATCH``
  round trip through the router and straight at a shard, batches/s, the
  reshard barrier, the shard and cell failover times, wire bytes in
  capability mode, launches.
  The phase alone: ``python3 chip_smoke.py --sharding``.
* Slice 15, the masked per-source mixture law on the card (phase 22):
  ``mixture_fused_wide`` (``csrc/mixture_kernels.cu``) takes every
  mixture with a source of 2^31 or more and every ``fused=False`` regen.
  The main path, with its own counter reset: the mixture 3e9/1e9/5e8 at
  60/25/15 (window 8192, block 1024, 24 rounds; no shape cut) through
  ``mixture_epoch_indices_cuda`` at world 256 (17.6M lanes) and world 8
  (562.5M lanes, 4.5 GB of int64), the elastic remainder after a reshard
  128 -> 256, one regen from a device triple, M1 with ``fused=False``
  (these under ``set_sync_debug_mode("error")``), then 1M random int64
  positions through ``mixture_stream_at_cuda``: one launch a regen, each
  held against the kernel's plain version (world 8 on sampled lanes, as
  M1's world 8 in phase 3c).  Phase 6 times the kernel beside its plain
  version and beside the masked torch loop it replaced, also on a 10B
  mixture (6e9/2.5e9/1.5e9) whose web source passes 2^32, and beside
  ``mixture_fused`` on M1, M2 and M3.

``python3 chip_smoke.py --regen`` prints only the per-epoch regen times,
the ``shard_row_keys`` and ``shard_expand`` times, the elastic remainder
regens, the launches per regen and a digest of each output, through
entry points that earlier trees share: run it as a copy inside an older
checkout to time that tree's route on the same card.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is ``{"kernels": [...]}``.
"""

import functools
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
SLICE1 = ("index_general", "index_amortized")
SLICE2 = ("index_amortized", "index_general_wide", "index_amortized_wide")
#: the slice-3 kernels, and the index kernels its mixture path never runs
SLICE3 = ("mixture_source_keys", "mixture_fused", "mixture_fused_wide")
#: round counts of slice 6: above the old limit of 64, SPEC.md §2's ~102
#: and ~121, and the new limit (ck.MAX_ROUNDS)
HIGH_ROUNDS = (65, 102, 121)
#: the slice-4 kernels (shard-index mode)
SLICE4 = ("shard_row_keys", "shard_expand")
#: shards each old rank has consumed when its checkpoint reshards 8 -> 16
SHARD_CONSUMED = 5000
INDEX_KERNELS = ("index_general", "index_amortized", "index_general_wide",
                 "index_amortized_wide")
#: the slice-7 kernels: the law on positions from the reshard chain or a
#: buffer (the elastic remainder, random access)
SLICE7 = ("index_positions", "index_positions_wide")
N_1E8 = 100_000_000
#: a blocked 3-layer reshard cascade at 1e8: 64 -> 96 -> 32 -> 48 ranks
CASCADE_1E8 = [(64, 700_000), (96, 200_000), (32, 50_000)]
#: per lane of index_positions besides the law, counted from
#: csrc/index_kernels.cu in the same way: the rank position (1) and its mod
#: by the remaining count (multiply-high, subtract, add, two shifts, and
#: the multiply-subtract of the remainder: 6); per strided layer the add
#: and the mod (7); per blocked layer the quotient (5), the gap remainder
#: and the combine (3) and the mod (6); a buffer lane its load and the mod
#: n (7).  A 64-bit operation of a wide lane counts as two.
CHAIN_LANE_OPS, STRIDED_LAYER_OPS, BLOCKED_LAYER_OPS = 7, 7, 14
BUFFER_LANE_OPS = 7
#: M1: the 1B three-corpus anchor of bench.py / README (web, code, books)
M1_SOURCES, M1_WEIGHTS = (700_000_000, 200_000_000, 100_000_000), (70, 20, 10)
#: M2: M1's spec over config 5's 10B-sample epoch (about 10 passes)
M2_SAMPLES = 10_000_000_000
#: M3: config 5's 10B id space as a 70/20/10 mixture (web in four shards)
M3_SOURCES = (1_750_000_000,) * 4 + (2_000_000_000, 1_000_000_000)
M3_WEIGHTS = (175,) * 4 + (200, 100)
#: the mixture goldens of tests/test_mixture.py (sources 1000/500/2500,
#: weights 5/1/4, window 64, block 100, seed 7, epoch 3, world 1), per
#: pattern version: the first 8 ids and the sum
MIX_GOLDENS = {1: ([394, 2255, 425, 2252, 411, 1363, 2260, 402], 5793243),
               2: ([2255, 394, 2252, 425, 1363, 2260, 411, 2262], 5793243)}
#: the agreed mixture reseeds run at world 1 (a group of one): M1's spec
#: over one world-256 rank's share, and a remainder after a reshard
MIX_AGREED_SAMPLES = 3_906_250
MIX_AGREED_LAYERS = [(256, 3_900_000)]
MIX_LAYERS = [(8, 50_000_000)]  # the iterator's reshard 8 -> 256
GLOO_MIX_SAMPLES = 4_000_000
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
#: mixture_fused per lane besides its bijections, counted from
#: csrc/mixture_kernels.cu in the same way: the position (1), block and
#: slot (2), the v2 rotation (mix32 and its xor 7, % B, add, wrap compare
#: and select: 11), the prefix count (two index multiply-adds, the wrap
#: select, an add and a subtract: 5), j, pass and offset (3), the
#: pass-folded decision key (four mix32 with their xors: 28), the body/tail
#: test, window and in-window offset (3), the combine and the base (2)
MIX_LANE_OPS = 55
#: key of the outer or tail bijection of a mixture lane: its decision key
#: (mix32 + xor, 7) and key2 (7); the inner one costs INNER_KEY_OPS
BIJ_KEY_OPS = 14
#: mixture_source_keys per word of its buffer: the source's seed key (three
#: mix32, two xors) and pass-free epoch key (two mix32, two xors), the
#: pairing key (mix32 + xor) and K_r (mix32, xor, multiply, compare, mod)
KEY_WORD_OPS = 51
#: slice 4, BASELINE config 4 (WebDataset shards, ViT-L/16): 100,000
#: shards of 1,000 samples, the shard sampler's window 64 (S1); S2/S3
#: have other size laws (shard_corpora); S4 is 400,000 x 10,000 (int64)
SHARDS, SHARD_M, SHARD_W = 100_000, 1_000, 64
S4_SHARDS, S4_M = 400_000, 10_000
#: the expansion goldens of tests/test_shard_mode.py (sizes 5/0/7/3/4,
#: ids [2, 0, 3], seed 3, epoch 1), per within_shard_shuffle
SHARD_GOLDENS = {True: [10, 8, 11, 6, 7, 9, 5, 1, 2, 0, 3, 4, 13, 12, 14],
                 2: [5, 6, 8, 7, 9, 10, 11, 0, 1, 3, 2, 4, 12, 13, 14]}
#: shard_expand per lane besides its bijection, counted from
#: csrc/shard_kernels.cu (lane tiles) in the same way: the staged row (t / m
#: as a multiply-high, its subtract, add and two shifts: 5, minus the
#: tile's first row: 1), u (end - m, t - start: 2), W and the body and
#: window tests (3), the combine (1) and the offset add (1); a window of
#: w < m adds WINDOW_LANE_OPS (u / w as a multiply-high: 5, the window base
#: and in-window offset: 2, the key index: 1).  Mixed sizes find the staged
#: row by a search in shared memory, SEARCH_STEP_OPS a step (the midpoint,
#: the compare and two selects), in place of the 6 of the division.  The
#: decision keys are counted once per row (INNER_KEY_OPS + TAIL_KEY_OPS)
#: and once per window of w (INNER_KEY_OPS), where the kernel derives them.
SHARD_LANE_OPS = 13
WINDOW_LANE_OPS = 8
SEARCH_STEP_OPS = 4
#: the tail bijection's key2 (mix32 + xor); the inner one is INNER_KEY_OPS
TAIL_KEY_OPS = 7
#: the first design's count per lane (one thread per lane, the keys per
#: lane, t / m or a binary search over all rows), for the old bound beside
#: the new
SHARD_LANE_OPS_V1 = 9
#: shard_row_keys per row: the carried fold (4), seed key (three mix32,
#: three xors: 21), epoch key (two mix32, two xors: 14), pairing and tail
#: keys (14), W and body (4); per pairing constant mix32, xor, multiply,
#: compare, mod and select (11), two schedules of `rounds`
ROW_BASE_OPS, ROW_KEY_OPS = 57, 11
#: slice 8, HostDataLoader timing cells, rows cut to fit host memory:
#: (label, rows, row shape, dtype, world, batch, timed steps, stall steps).
#: T1: the C4 config's GPT-2-small token rows (1,024 uint16 tokens, 2 KB),
#: 4,194,304 rows (8 GiB; C4 has ~365M documents); T2: ImageNet/ResNet-50
#: decoded 224x224x3 uint8 rows, 65,536 rows (9.9 GB; ImageNet-1k has
#: 1,281,167)
T_CASES = (("T1 (C4 / GPT-2 small rows)", 4_194_304, (1024,), "uint16", 8,
            32, 2000, 200),
           ("T2 (ImageNet / ResNet-50 rows)", 65_536, (224, 224, 3), "uint8",
            1, 256, 64, 64))
#: the kernels the slice-8 main path's regens launch
SLICE8 = ("index_amortized", "index_positions", "mixture_fused",
          "shard_row_keys", "shard_expand")
#: slice 9, weighted sampling (phase 17): W1 is M1's sources with the
#: high-quality corpora upsampled per sample (GPT-3's mix practice); W2 is
#: config 5's 10B id space (web past 2^31: int64 ids, the 64-bit local
#: draw); W3 is the 300-source spec of phase 3c with integer quotas per
#: 10^10 (its total passes 2^31: the 64-bit accept draw)
W1_WEIGHTS = (1, 3, 2)
W2_SOURCES = (7_000_000_000, 2_000_000_000, 1_000_000_000)
W2_WEIGHTS = (2, 5, 3)
W3_SIZES = tuple(2_000_000 + 17_000 * i for i in range(300))
#: the prioritized cell's weights, adopted at epoch 1 over W1's
W_PRIORITY = (1, 6, 2)
#: the dedup cell: ImageNet-1k's ids as one source, half of them an epoch
DEDUP_SAMPLES, DEDUP_RETRIES = 640_584, 4
DEDUP_BLOOM_BITS, DEDUP_BLOOM_HASHES = 1 << 24, 4
#: the slice-9 kernels
SLICE9 = ("weighted_stream", "weighted_stream_wide")
#: weighted_stream per lane, counted from csrc/sampling_kernels.cu as the
#: other kernels' counts are (mix32's multiplies free, a multiply-high
#: counted, a 64-bit operation as two): the rank position and its mod by T
#: (7); the base hash (the low word's xor and mix32, the three-input xor
#: with the key and the high word's constant hash, mix32: 14); the column
#: draw (hash 7, mod S 6, the column address 1: 14); the accept draw (hash
#: 7, mod total 6, the 64-bit threshold compare 2, the alias select and
#: address 2: 17; with a total past 2^31 two hashes, the 64-bit word and
#: its 64-bit mod: 32); the local draw (hash 7, the divisor's shifts 2, mod
#: n_j 6: 15; past 2^31 two hashes, the word, the shifts and a 64-bit mod:
#: 30); the body test, the offset add and the store (6).  uint64 ordinals
#: add the high word's hash and a 64-bit mod by T (14).  A lane in a full
#: window adds the window and offset (6; 12 with a 64-bit local), the
#: source key eks (8), the combine (2), INNER_KEY_OPS and the rounds.
W_POS_OPS, W_BASE_OPS, W_COLUMN_OPS = 7, 14, 14
W_ACCEPT_OPS, W_ACCEPT64_OPS = 17, 32
W_LOCAL_OPS, W_LOCAL64_OPS = 15, 30
W_TAIL_OPS, W_WIDE_OPS = 6, 14
W_SHUFFLE_OPS, W_SHUFFLE64_OPS = 16, 22
#: slice 10, the consumer layer (phase 18, ``training_phase``): BASELINE's
#: two consumers at full width, GPT-2-small (config 3: the C4 pretrain)
#: and ViT-L/16 (config 4), depth uncut
GPT2_SMALL = dict(vocab_size=50_257, seq_len=1024, d_model=768, n_layers=12,
                  n_heads=12, d_ff=3072)
VIT_L16 = dict(image_size=224, patch_size=16, channels=3, num_classes=1000,
               d_model=1024, n_layers=24, n_heads=16, d_ff=4096)
#: max |logits| between the card and the CPU route, f32 with TF32 off, 2
#: rows (2 x 1,024 tokens; 2 images): summation order alone differs
FWD_TOL = 1e-3
#: the trainer's data: a device-resident token table of 2^20 rows x 1,025
#: int32 (4.3 GB; C4 has ~365M documents, the cut is in rows only), the
#: sampler at window 8,192 and world 1, batch 8 x 1,024 tokens
TRAIN_ROWS, TRAIN_BATCH, TRAIN_STEPS, TRAIN_EPOCHS = 1 << 20, 8, 8, 3
#: M1's 70/20/10 three-source shape scaled to the table's 2^20 rows
MIX_TRAIN_SIZES = (734_003, 209_715, 104_858)
MIX_TRAIN_EPOCHS = 2
#: ViT-L/16's data: 4,096 f32 images (2.5 GB), window 1,024, batch 8
VIT_IMAGES, VIT_WINDOW, VIT_STEPS, VIT_EPOCHS = 4096, 1024, 4, 2
#: T1 behind the GPT-2-small step: 2^20 host rows of 1,025 uint16 tokens
#: (2.1 GB; T1 of phase 16 holds 4,194,304 rows of 1,024), world 8, the
#: trainer's batch of 8; the steps timed at each depth
T1_TRAIN_ROWS, T1_TRAIN_STEPS = 1 << 20, 40
#: the kernels the slice-10 main path launches
SLICE10 = ("index_amortized", "mixture_fused")
#: a mixture with a source past 2^31 (10B-class web, code, books), which
#: only the masked per-source law takes (mixture_fused_wide; slice 15)
MASKED_BIG_SOURCES = (3_000_000_000, 1_000_000_000, 500_000_000)
MASKED_BIG_WEIGHTS = (60, 25, 15)
#: a mixture with a source past 2^32 (config 5's 10B space: web, code,
#: books), whose web source's pass and window splits are 64-bit
MASKED_10B_SOURCES = (6_000_000_000, 2_500_000_000, 1_500_000_000)
#: the masked law's work per lane is mixture_fused's (MIX_LANE_OPS, and
#: WIDE_OPS at uint64 positions); a split that the law itself must make
#: in 64 bits adds the remainder's multiply and subtract as 64-bit ones
#: (a 64-bit / or % counts as one): the j split where n_s or j reaches
#: 2^32, the window split where u does.  Counted from the run's data
MIX_SPLIT64_OPS = 2
#: the masked per-source loop (port ops/mixture.py ``_masked_mixture_eval``
#: over ``_amortized_source_perm``), counted as MIX_LANE_OPS is: once a
#: lane, the position, block, slot and v2 rotation (14) and its source
#: (1); then for each source, on every lane, besides INNER_KEY_OPS and the
#: rounds of the inner bijection: the prefix count (5), j, pass and offset
#: (3), the pass clamp and the key gather (2), window and in-window offset
#: (3), the outer table's address (1), the body combine (1), the tail
#: position and its table's address (4), the body/tail select (1), the
#: source test, select and base (3).  A source whose tables exceed the
#: route's caps runs ``windowed_perm`` on every lane instead: the
#: pass-folded key (28, as in MIX_LANE_OPS) and the outer, inner and tail
#: keys and rounds
MASKED_LANE_OPS, MASKED_SOURCE_LANE_OPS, MASKED_PASS_KEY_OPS = 15, 24, 28
#: the kernel the slice-15 main path launches
SLICE15 = ("mixture_fused_wide",)
#: the kernels the slice-11 main path (the capability replays) launches
SLICE11 = ("index_amortized", "index_positions", "mixture_fused",
           "shard_row_keys", "shard_expand", "weighted_stream")
#: slice 12, the index service (phase 20): C4 at world 256 served to
#: ranks 0-6 and 255 at a transport batch of 4,096; the elastic cell's
#: ImageNet worlds; the failover cell's ranks and batches before the kill
SERVE_WORLD, SERVE_BATCH = 256, 4096
SERVE_RANKS = (0, 1, 2, 3, 4, 5, 6, 255)
ELASTIC_WORLDS = (8, 16)
FAILOVER_RANKS, FAILOVER_BATCHES = 4, 200
#: the kernels the slice-12 main path (the servers' and clients' regens)
#: launches
SLICE12 = ("index_amortized", "index_positions", "mixture_fused",
           "weighted_stream")
#: slice 13, the sharded plane (phase 21): C4 at world 256 over 4 shards
#: (docs/SHARDING.md's deployment), two client ranks a shard, the
#: cross-shard reshard's new world; the tenants' and the autopilot
#: plane's transport batch; the federation's client ranks and its
#: capability client; the dedup draws that price fleetsim's host fold
SHARD_WORLD, SHARD_SHARDS, SHARD_NEW_WORLD = 256, 4, 192
SHARD_RANKS = (0, 63, 64, 127, 128, 191, 192, 255)
TENANT_BATCH = 65536
FED_RANKS, FED_CAP_RANK = (0, 255), 1
DEDUP_DRAWS = 20_000
#: the kernels the slice-13 main path (shards, cells and the autopilot's
#: plane) launches
SLICE13 = ("index_amortized", "index_positions", "mixture_fused",
           "weighted_stream")
INT32_OPS_PER_CLK_PER_SM = 64  # Hopper SM: 4 partitions x 16 INT32 lanes
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def deep_layers(n: int, depth: int, seed: int = 9) -> list:
    """A reshard cascade of ``depth`` layers from a numpy seed: the first
    at world 8192 leaves 700 samples a rank, then random worlds of 2..8
    each consume 0..2 samples a rank."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ns = -(-n // 8192)
    layers, domain = [(8192, ns - 700)], 700 * 8192
    for _ in range(depth - 1):
        world = int(rng.integers(2, 9))
        ns = -(-domain // world)
        consumed = int(rng.integers(0, min(2, ns - 1) + 1))
        layers.append((world, consumed))
        domain = (ns - consumed) * world
    return layers


def shard_cells():
    """(sizes, label, world, within_shard_shuffle) of every shard_expand
    shape that is timed: S1 at world 8 (the main path; full, window 64,
    sequential) and 1, S2 and S3 at world 8 (full, window 64), S4."""
    sz1, sz2, sz3, sz4 = shard_corpora()
    return ((sz1, "S1", 8, True), (sz1, "S1", 8, SHARD_W),
            (sz1, "S1", 8, False), (sz1, "S1", 1, True),
            (sz1, "S1", 1, SHARD_W), (sz2, "S2", 8, True),
            (sz2, "S2", 8, SHARD_W), (sz3, "S3", 8, True),
            (sz3, "S3", 8, SHARD_W), (sz4, "S4", 8, True))


def shard_corpora():
    """The four shard-size tables of slice 4, from a numpy seed: S1
    uniform; S2 log-normal sizes clipped to 200..2000 (BASELINE.md round
    5's variable-length corpus); S3 99,000 shards of 4..64 and 1,000 of
    50,000..100,000, shuffled in id order; S4 uniform, 4e9 samples."""
    import numpy as np

    rng = np.random.default_rng(4)
    sz1 = np.full(SHARDS, SHARD_M, dtype=np.int64)
    sz2 = np.clip(np.rint(rng.lognormal(np.log(600), 0.55, SHARDS)), 200,
                 2000).astype(np.int64)
    sz3 = np.concatenate([rng.integers(4, 65, 99_000),
                         rng.integers(50_000, 100_001, 1_000)])
    rng.shuffle(sz3)
    sz4 = np.full(S4_SHARDS, S4_M, dtype=np.int64)
    return sz1, sz2, sz3, sz4


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


def device_ms(fn, reps: int, max_sm_mhz: float) -> float:
    """Device time per call: CUDA events around ``reps`` calls queued
    behind a busy-wait kernel, so host launch gaps are hidden."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_s = time.perf_counter() - t
    cycles = int(min(5.0, 1.5 * reps * host_s + 1e-3) * max_sm_mhz * 1e6)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def host_walls(fn, reps: int) -> list:
    """Host wall ms of each of ``reps`` calls, each to a synchronised
    device."""
    import torch

    walls = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t) * 1e3)
    return walls


def launch_floor_ms(max_sm_mhz: float) -> float:
    """The back-to-back device time of an empty kernel
    (``torch.cuda._sleep(0)``: one thread that exits at once), by
    ``device_ms``: what a kernel costs that does nothing."""
    import torch

    return device_ms(lambda: torch.cuda._sleep(0), 200, max_sm_mhz)


def digest(t) -> int:
    """A position-weighted checksum of a tensor's values (the sum of
    value * (position + 1), mod 2^64): two outputs with equal digests are
    the same output but for a collision."""
    import torch

    acc, flat, chunk = 0, t.reshape(-1), 1 << 26
    for c in range(0, flat.numel(), chunk):
        seg = flat[c:c + chunk].long()
        pos = torch.arange(c + 1, c + 1 + seg.numel(), device=seg.device)
        acc = (acc + int((seg * pos).sum())) % 2**64
    return acc


def regen_report() -> None:
    """``--regen``: the per-epoch regen times, the ``shard_row_keys``
    times, the kernel launches of each call and a digest of its output,
    for the package beside this file, through entry points that the trees
    since slice 4 share."""
    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
        shard as SH,
    )

    card = nvidia_smi("name,power.limit")
    sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    print(card)
    ck.build()
    print(f"launch floor (empty kernel, back to back): "
          f"{launch_floor_ms(sm_mhz):.4f} ms | {card}")
    sz1 = shard_corpora()[0]
    cases = [(f"regen per epoch n={n:.0e} W=8192 world={world}",
              lambda n=n, w=world: pt.epoch_indices_cuda(n, W, 0, 1, 5 % w, w),
              20 if world == 256 else 5)
             for n, world in ((N_C4, 256), (N_C4, 8), (N_LLAMA, 256),
                              (N_LLAMA, 8))]
    for world in (8, 1):
        sids = pt.epoch_indices_cuda(SHARDS, SHARD_W, 0, 1, 5 % world, world)
        tabs = SH.shard_tables(sz1, "cuda")
        cases.append((
            f"shard_row_keys S1 world={world} ({sids.numel()} rows, full)",
            lambda s=sids, t=tabs: ck.shard_row_keys(s, t, 0, 1, full=True,
                                                     w=0)[0], 50))
        sampler = pt.PartialShuffleShardSampler(SHARDS, num_replicas=world,
                                                rank=5 % world)
        cases.append((f"shard regen per epoch S1 world={world}",
                      lambda sm=sampler: sm.device_epoch_indices(sz1),
                      20 if world == 8 else 5))
    # the shard_expand kernel alone at every shape of PERF.md's table
    # (records from shard_row_keys, which the sequential mode ignores)
    for sizes, label, world, wss in shard_cells():
        sids = pt.epoch_indices_cuda(sizes.size, SHARD_W, 0, 1, 5 % world,
                                     world)
        tabs = SH.shard_tables(sizes, "cuda")
        full, w = SH.shuffle_mode(wss)
        rowtab, m_of = ck.shard_row_keys(sids, tabs, 0, 1, full=full, w=w,
                                         sizes_out=True)
        ends = None if tabs.m_uniform else torch.cumsum(m_of, 0)
        lanes = (sids.numel() * tabs.m_uniform if ends is None
                 else int(ends[-1]))
        cases.append((
            f"shard_expand {label} world={world} within_shard_shuffle={wss}"
            f" ({lanes} lanes)",
            lambda r=rowtab, s=sids, t=tabs, e=ends, k=dict(
                lanes=lanes, full=full, w=w): ck.shard_expand(r, s, t, e, **k),
            5 if label == "S4" or world == 1 else 20))
    m1 = pt.MixtureSpec(M1_SOURCES, M1_WEIGHTS, windows=W)
    cases.append(("mixture regen per epoch M1 world=256",
                  lambda: pt.mixture_epoch_indices_cuda(m1, 0, 1, 5, 256),
                  20))
    big = pt.MixtureSpec(MASKED_BIG_SOURCES, MASKED_BIG_WEIGHTS, windows=W)
    cases.append(("mixture regen per epoch 3e9/1e9/5e8 at 60/25/15 "
                  "world=256",
                  lambda: pt.mixture_epoch_indices_cuda(big, 0, 1, 5, 256),
                  5))
    for n in (N_C4, N_LLAMA):
        ns128, _ = core.shard_sizes(n, 128, False)
        layers = [(128, ns128 // 2)]
        chain, _rem, ns_el = core.elastic_chain(n, layers, 256)
        cases.append((
            f"elastic regen n={n:.0e} W=8192 world=256 after {layers}",
            lambda n=n, c=chain, k=ns_el: pt.elastic_indices_cuda(
                n, W, 0, 1, 5, 256, k, c), 10))
    for label, fn, reps in cases:
        before = sum(ck.launches.values())
        out = fn()
        torch.cuda.synchronize()
        n_launch = sum(ck.launches.values()) - before
        dev = device_ms(fn, reps, sm_mhz)
        walls = host_walls(fn, reps)
        print(f"{label}: device {dev:.4f} ms, host wall to ready median "
              f"{float(np.median(walls)):.4f} ms min {min(walls):.4f} ms, "
              f"{n_launch} kernel launches, digest {digest(out)} | {card}")
        del out
        torch.cuda.empty_cache()


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


class IdDataset:
    """A dataset over an id space whose item for a list of ids is the ids:
    a ``DataLoader`` over a ``BatchSampler`` serves the sampler's order."""

    def __init__(self, size: int) -> None:
        self.size = size

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, ids):
        import torch

        return torch.as_tensor(ids)


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
        mspec = pt.MixtureSpec(M1_SOURCES, M1_WEIGHTS, windows=W)
        mkw = dict(epoch_samples=GLOO_MIX_SAMPLES)
        mrow = parallel.sharded_mixture_indices(
            mspec, None, None, mesh=mesh, local_seeds=GLOO_LOCAL[rank], **mkw)
        mel = parallel.sharded_mixture_elastic_indices(
            mspec, None, None, GLOO_LAYERS, mesh=mesh,
            local_seeds=GLOO_LOCAL[rank], **mkw)
        torch.cuda.synchronize()
        launches = dict(ck.launches)
        lo, hi, ep = GLOO_LOCAL[0]
        seed0 = lo | (hi << 32)
        want = pt.epoch_indices_cuda(N_IMAGENET, W, seed0, ep, rank, 2)
        chain, _, ns = core.elastic_chain(N_IMAGENET, GLOO_LAYERS, 2)
        want_el = pt.elastic_indices_cuda(N_IMAGENET, W, seed0, ep, rank, 2,
                                          ns, chain)
        want_m = pt.mixture_epoch_indices_cuda(mspec, seed0, ep, rank, 2,
                                               **mkw)
        want_mel = pt.mixture_elastic_indices_cuda(mspec, seed0, ep, rank, 2,
                                                   GLOO_LAYERS, **mkw)
        lo, hi, ep = GLOO_LOCAL[rank]
        own = pt.epoch_indices_cuda(N_IMAGENET, W, lo | (hi << 32), ep, rank,
                                    2)
        own_m = pt.mixture_epoch_indices_cuda(mspec, lo | (hi << 32), ep,
                                              rank, 2, **mkw)
        print(json.dumps({
            "rank": rank,
            "is_cuda": all(t.is_cuda for t in (row, el, mrow, mel)),
            "lanes": row.numel(), "elastic_lanes": el.numel(),
            "mixture_lanes": mrow.numel(), "mixture_elastic_lanes":
                mel.numel(),
            "row_equal": torch.equal(row, want),
            "elastic_equal": torch.equal(el, want_el),
            "mixture_equal": torch.equal(mrow, want_m),
            "mixture_elastic_equal": torch.equal(mel, want_mel),
            "own_seed_differs": not torch.equal(own, want),
            "own_mixture_seed_differs": not torch.equal(own_m, want_m),
            "launches": launches,
        }))
    finally:
        dist.destroy_process_group()


def host_loader_phase(card: str, max_sm_mhz: float) -> dict:
    """Phase 16, the slice-8 main path: ``HostDataLoader`` over host data
    on ``index_backend="cuda"``.  (a) one 4 GB id array whose value is the
    row: each case's regen launches its kernels once and no regen runs on
    the CPU; every served batch is a CUDA tensor equal to the port's own
    stream (the entry points on the card, and the CPU route at sampled
    lanes); (b) T1/T2 rows with a per-row pattern checked on every served
    batch: gather and copy times, the host link, batches/s and the stall
    share behind a synthetic step; (c) the epoch boundary at 1B/world 256.
    Returns the launches of the phase's regens."""
    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
        host_array,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampler import (
        shard_mode as SM,
    )

    dev = torch.device("cuda")
    ck.reset_launches()
    mem = subprocess.run(["free", "-g"], capture_output=True, text=True)
    print("host memory before the phase (free -g):\n" + mem.stdout.strip())
    t0 = time.perf_counter()
    base = np.arange(N_C4, dtype=np.int32)  # row r holds r
    print(f"host data: np.arange(1e9, int32), {base.nbytes / 1e9:.1f} GB, "
          f"{time.perf_counter() - t0:.2f} s")
    launches8 = {k: 0 for k in ck.launches}
    rng = np.random.default_rng(8)

    def regen(fn, kernels, label):
        """``fn()`` (a loader call) launches each of ``kernels`` once (or,
        for a dict, as often as it says) and nothing else (None: anything):
        the regen ran on the card, never on the CPU.  The launches count to
        the main path."""
        before = dict(ck.launches)
        out = fn()
        got = {k: v - before[k] for k, v in ck.launches.items()
               if v != before[k]}
        for k, v in got.items():
            launches8[k] += v
        want = kernels if isinstance(kernels, dict) else {
            k: 1 for k in kernels or ()}
        check(kernels is None or got == want,
              f"{label}: the regen launched {got}, not {kernels} once each")
        return out

    def serve(loader, epoch, want, kernels, label, layers=None, cpu=None,
              cpu_lanes=None, steps=300, tail=20):
        """``steps`` batches of ``epoch`` and the last ``tail`` through a
        ``start_step`` resume, each held on the card against ``want`` (the
        port's stream); ``cpu(t)`` gives the CPU route's values at 4096
        sampled lanes ``t`` below ``cpu_lanes`` (default: all served)."""
        B = loader.batch
        it = regen(lambda: loader.epoch(epoch, layers=layers), kernels, label)
        total = loader._steps_for(len(loader.epoch_indices(epoch, layers)))
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        firsts = []
        for s, b in enumerate(it):
            check(b.is_cuda and b.dtype == want.dtype and b.numel() == B,
                  f"{label}: batch {s} is not a CUDA {want.dtype}[{B}]")
            bad += (b != want[s * B:(s + 1) * B]).sum()
            firsts.append(b)
            if s + 1 == steps:
                break
        it.close()
        start = total - tail
        it = regen(lambda: loader.epoch(epoch, start_step=start,
                                        layers=layers), kernels, label)
        n_tail = 0
        for s, b in enumerate(it, start):
            bad += (b != want[s * B:(s + 1) * B]).sum()
            n_tail += 1
        check(n_tail == tail, f"{label}: resume served {n_tail} batches")
        served = torch.cat(firsts)
        lanes = np.sort(rng.choice(cpu_lanes or served.numel(), 4096,
                                   replace=False))
        cpu_ok = np.array_equal(served.cpu().numpy()[lanes],
                                np.asarray(cpu(lanes)))
        ok = int(bad) == 0 and cpu_ok
        print(f"loader {label}: {steps} batches + {tail} resumed at step "
              f"{start} of {total}, CUDA {want.dtype}[{B}], equal to the "
              f"port's stream on the card: {int(bad) == 0}; 4096 sampled "
              f"lanes equal to the CPU route: {cpu_ok}")
        check(ok, f"loader {label}: served batches differ from the stream")
        return served

    # (a) C4 1B / 8192, world 256, batch 512: plain and elastic
    rank = 5
    c4 = pt.HostDataLoader(base, window=W, batch=512, rank=rank, world=256,
                           boundary_prefetch=False)
    check(c4.device.type == "cuda" and c4.index_backend == "cuda",
          "the loader's defaults are not the card's")
    serve(c4, 1, pt.epoch_indices_cuda(N_C4, W, 0, 1, rank, 256),
          ("index_amortized",), "C4 1B/8192 world=256",
          cpu=lambda t: pt.stream_indices_at_cpu(
              rank + 256 * torch.from_numpy(t), N_C4, W, 0, 1))
    ns128, _ = core.shard_sizes(N_C4, 128, False)
    layers = [(128, ns128 // 2)]
    chain, remaining, ns_el = core.elastic_chain(N_C4, layers, 256)
    serve(c4, 1, pt.elastic_indices_cuda(N_C4, W, 0, 1, rank, 256, ns_el,
                                         chain),
          ("index_positions",), f"C4 epoch(1, layers={layers})",
          layers=layers,
          cpu=lambda t: pt.stream_indices_at_cpu(core.compose_remainder_chain(
              (rank + 256 * torch.from_numpy(t)) % remaining, chain,
              "strided", False), N_C4, W, 0, 1))
    # M1 at world 256: concatenated (global ids) and per-source views
    m1 = pt.MixtureSpec(M1_SOURCES, M1_WEIGHTS, windows=W)
    want_g = pt.mixture_epoch_indices_cuda(m1, 0, 2, rank, 256)
    cpu_m1 = lambda t: pt.mixture_stream_at_cpu(  # noqa: E731
        rank + 256 * torch.from_numpy(t), m1, 0, 2)
    mix = pt.HostDataLoader(base, batch=512, rank=rank, world=256,
                            mixture=m1, boundary_prefetch=False)
    serve(mix, 2, want_g, ("mixture_fused",), "M1 world=256 concatenated",
          cpu=cpu_m1)
    views = [base[:n] for n in M1_SOURCES]
    per = pt.HostDataLoader(views, batch=512, rank=rank, world=256,
                            mixture=m1, boundary_prefetch=False)
    bases = torch.tensor(m1.bases, dtype=torch.int32, device=dev)
    want_l = want_g - bases[torch.searchsorted(bases, want_g, right=True) - 1]
    serve(per, 2, want_l, ("mixture_fused",),
          "M1 world=256 per-source views (local ids)",
          cpu=lambda t: m1.decompose(np.asarray(cpu_m1(t)))[1])
    del want_g, want_l
    # S1 shards at world 8: the shard ids and their expansion on the card
    sz1 = np.full(SHARDS, SHARD_M, dtype=np.int64)
    sh = pt.HostDataLoader(base[:SHARDS * SHARD_M], batch=512, rank=3,
                           world=8, shard_sizes=sz1, boundary_prefetch=False)
    sids = pt.epoch_indices_cuda(SHARDS, SHARD_W, 0, 1, 3, 8)
    first = SM.expand_shard_indices_cpu(sids[:64].cpu().numpy(), sz1, seed=0,
                                        epoch=1)
    serve(sh, 1, SM.expand_shard_indices_cuda(sids, sz1, seed=0, epoch=1),
          ("index_amortized", "shard_row_keys", "shard_expand"),
          "S1 100,000 x 1,000 world=8 (CPU route: the first 64 shards)",
          cpu=lambda t: first.numpy()[t], cpu_lanes=first.numel())
    # the moving-horizon stream, horizons 0 and 1
    st = pt.HostDataLoader(base, window=W, batch=512, rank=rank, world=256,
                           streaming=True, horizon=N_1E8,
                           boundary_prefetch=False)
    for g in (0, 1):
        want = pt.epoch_indices_cuda(N_1E8, W, 0, g, rank, 256) + g * N_1E8
        got = serve(st, g, want, ("index_amortized",),
                    f"StreamSpec.plain_stream(1e8, 8192) world=256 horizon "
                    f"{g}",
                    cpu=lambda t, g=g: pt.stream_indices_at_cpu(
                        rank + 256 * torch.from_numpy(t), N_1E8, W, 0, g)
                    + g * N_1E8)
        inside = bool(((got >= g * N_1E8) & (got < (g + 1) * N_1E8)).all())
        print(f"horizon {g}: every served value in [{g}*H, {g + 1}*H): "
              f"{inside}")
        check(inside, f"horizon {g} served a value outside its block")
    # a boundary-prefetched epoch e+1: adopted, nothing in the foreground
    # (the worker launches as soon as epoch() returns, so each epoch() is
    # counted together with the worker it kicks)
    bp = pt.HostDataLoader(base, window=W, batch=512, rank=rank, world=256)
    it = regen(lambda: (bp.epoch(0), bp._boundary_thread.join(60))[0],
               {"index_amortized": 2}, "epoch 0 and the worker's epoch 1")
    next(it)
    it.close()
    it = regen(lambda: (bp.epoch(1), bp._boundary_thread.join(60))[0],
               {"index_amortized": 1},
               "the adopted epoch 1 (only the worker's epoch 2 may launch)")
    want = pt.epoch_indices_cuda(N_C4, W, 0, 1, rank, 256)
    ok = all(torch.equal(b, want[s * 512:(s + 1) * 512])
             for s, b in zip(range(100), it))
    it.close()
    print(f"boundary prefetch: epoch 1 adopted the worker's array (one "
          f"launch in all, the worker's regen of epoch 2), 100 batches "
          f"equal to the stream: {ok}")
    check(ok, "the boundary-prefetched epoch differs from the stream")
    del c4, mix, per, sh, st, bp, views, sids
    torch.cuda.empty_cache()

    # (c) the epoch boundary at 1B / world 256, boundary_prefetch=False
    walls = {}
    for backend, reps in (("cuda", 5), ("cpu", 1)):
        ld = pt.HostDataLoader(base, window=W, batch=512, rank=rank,
                               world=256, index_backend=backend,
                               boundary_prefetch=False)
        if backend == "cuda":
            regen(lambda: ld.epoch_indices(0), None, "warm-up")
        walls[backend] = []
        for e in range(1, reps + 1):
            ld.clear_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            it = regen(lambda: ld.epoch(e), None, "epoch boundary")
            walls[backend].append((time.perf_counter() - t0) * 1e3)
            it.close()
    kernel_ms = device_ms(lambda: pt.epoch_indices_cuda(N_C4, W, 0, 1, rank,
                                                        256), 20, max_sm_mhz)
    idx_dev = pt.epoch_indices_cuda(N_C4, W, 0, 1, rank, 256)
    torch.cuda.synchronize()
    back = {"pageable .cpu()": [], "pinned (ops.host_array)": []}
    for _ in range(6):
        for form, fn in zip(back, (lambda: idx_dev.cpu().numpy(),
                                   lambda: host_array(idx_dev))):
            t0 = time.perf_counter()
            fn()
            back[form].append((time.perf_counter() - t0) * 1e3)
    print(f"epoch() at 1B/8192 world=256, boundary_prefetch=False: "
          f"index_backend='cuda' wall median "
          f"{float(np.median(walls['cuda'])):.4f} ms (min "
          f"{min(walls['cuda']):.4f}): kernel {kernel_ms:.4f} ms device, "
          f"readback of {idx_dev.numel() * 4 / 1e6:.1f} MB median (of 5 "
          f"after one) " + ", ".join(
              f"{form} {float(np.median(v[1:])):.4f} ms"
              for form, v in back.items())
          + f"; index_backend='cpu' "
          f"{', '.join(f'{w:.1f}' for w in walls['cpu'])} ms | {card}")
    # the boundary gap: six boundaries, each epoch entered 100 batches
    # before its end (time enough for the worker's regen)
    for prefetch in (True, False):
        ld = pt.HostDataLoader(base, window=W, batch=512, rank=rank,
                               world=256, depth=2,
                               boundary_prefetch=prefetch)
        last = ld.steps_per_epoch - 100
        before = dict(ck.launches)
        gaps, calls = [], []
        it = ld.epoch(0, start_step=last)
        for e in range(1, 7):
            for _ in it:
                pass
            t0 = time.perf_counter()
            it = ld.epoch(e, start_step=last)
            t1 = time.perf_counter()
            b = next(it)
            torch.cuda.current_stream().synchronize()
            gaps.append((time.perf_counter() - t0) * 1e3)
            calls.append((t1 - t0) * 1e3)
            check(b.is_cuda, "the boundary batch is not on the card")
        it.close()
        if ld._boundary_thread is not None:
            ld._boundary_thread.join(60)
        for k, v in ck.launches.items():
            launches8[k] += v - before[k]
        print(f"epoch boundary gap (the last batch of an epoch to the first "
              f"of the next on the card), boundary_prefetch={prefetch}: "
              f"median {float(np.median(gaps)):.4f} ms of "
              f"{', '.join(f'{g:.4f}' for g in gaps)}; of which the epoch() "
              f"call median {float(np.median(calls)):.4f} ms, the first "
              f"batch (producer start, gather, copy) the rest | {card}")
    del base, idx_dev
    launches8 = {k: launches8[k] + v for k, v in
                 host_loader_timing(card, max_sm_mhz).items()}
    return launches8


def host_loader_timing(card: str, max_sm_mhz: float) -> dict:
    """Phase 16 (b): T1 and T2 rows through ``HostDataLoader`` on the card,
    every served batch checked against its row pattern on the card.
    Returns the launches of the loaders' regens."""
    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        cuda_kernel as ck,
    )
    from partiallyshuffledistributedsampler_tpu_torch.utils.stall_probe import (
        StallProbe,
    )

    dev = torch.device("cuda")
    before = dict(ck.launches)

    class TimedLoader(pt.HostDataLoader):
        """The loader with each step's gather (host clock) and copy (CUDA
        events on its copy stream) timed."""

        times: list = []

        def _gather(self, sl):
            t0 = time.perf_counter()
            out = super()._gather(sl)
            self._gather_s = time.perf_counter() - t0
            return out

        def _to_device(self, host):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(self._copy_stream)
            out, ev = super()._to_device(host)
            b.record(self._copy_stream)
            self.times.append((self._gather_s, a, b))
            return out, ev

    # the host link: one 256 MB pinned copy, best of 5 after a warm-up
    src = torch.empty(256 << 20, dtype=torch.uint8, pin_memory=True)
    dst = torch.empty(src.shape, dtype=torch.uint8, device=dev)
    side = torch.cuda.Stream()
    link = []
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with torch.cuda.stream(side):
            a.record()
            dst.copy_(src, non_blocking=True)
            b.record()
        b.synchronize()
        link.append(a.elapsed_time(b))
    link_gbps = src.numel() / (min(link[1:]) / 1e3) / 1e9
    print(f"host link: one 256 MB pinned host-to-device copy, best of 5: "
          f"{min(link[1:]):.4f} ms, {link_gbps:.2f} GB/s | {card}")
    del src, dst
    # the synthetic step's busy-wait: 5 ms at the maximum SM clock
    cycles = int(5e-3 * max_sm_mhz * 1e6)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(cycles)
    b.record()
    b.synchronize()
    sleep_ms = a.elapsed_time(b)

    for label, rows, shape, dtype, world, batch, steps, stall_steps in T_CASES:
        t0 = time.perf_counter()
        data = pattern_rows(rows, shape, dtype)
        fill_s = time.perf_counter() - t0
        row_bytes = data.nbytes // rows
        print(f"{label}: {rows} rows of {shape} {np.dtype(dtype).name} "
              f"({row_bytes} B), {data.nbytes / 2**30:.2f} GiB host, filled "
              f"in {fill_s:.2f} s; world {world}, batch {batch}")
        bad = torch.zeros((), dtype=torch.int64, device=dev)
        checked = 0

        def ids_of(loader, epoch):
            return torch.from_numpy(loader.epoch_indices(epoch).astype(
                np.int32)).to(dev)

        # no consumer work: a warm-up pass (pinned and device caches),
        # then the timed pass; the batches are held and checked after it
        ld = TimedLoader(data, window=W, batch=batch, rank=3 % world,
                         world=world, depth=2, boundary_prefetch=False)
        for epoch in (0, 1):
            TimedLoader.times = []
            ids = ids_of(ld, epoch)
            it = ld.epoch(epoch)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            held = [b for _, b in zip(range(steps), it)]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            it.close()
            for s, b in enumerate(held):
                check(b.is_cuda and b.dtype == ld._dtypes["data"]
                      and tuple(b.shape) == (batch,) + shape,
                      f"{label}: batch {s} is not a CUDA batch of rows")
                bad += pattern_errors(b, ids[s * batch:(s + 1) * batch])
            checked += len(held)
            del held
        gather = [g * 1e3 for g, _, _ in TimedLoader.times[:steps]]
        h2d = [a.elapsed_time(b) for _, a, b in TimedLoader.times[:steps]]
        step_bytes = batch * row_bytes
        h2d_ms = float(np.median(h2d))
        print(f"{label}: per step gather median {float(np.median(gather)):.4f}"
              f" ms (min {min(gather):.4f}), host-to-device copy median "
              f"{h2d_ms:.4f} ms (min {min(h2d):.4f}) for {step_bytes / 1e6:.3f}"
              f" MB: {step_bytes / h2d_ms / 1e6:.2f} GB/s against the link's "
              f"{link_gbps:.2f}; no consumer work (depth 2): "
              f"{steps / wall:.1f} batches/s over {steps} steps | {card}")
        for depth in (1, 2):
            ld = pt.HostDataLoader(data, window=W, batch=batch,
                                   rank=3 % world, world=world, depth=depth,
                                   boundary_prefetch=False)
            epoch = 1 + depth
            ids = ids_of(ld, epoch)
            it = ld.epoch(epoch)
            probe = StallProbe(it)
            gen = iter(probe)
            t0 = time.perf_counter()
            for s, b in enumerate(gen):
                bad += pattern_errors(b, ids[s * batch:(s + 1) * batch])
                torch.cuda._sleep(cycles)
                torch.cuda.current_stream().synchronize()
                if s + 1 == stall_steps:
                    break
            gen.close()
            it.close()
            wall = time.perf_counter() - t0
            rep = probe.report()
            checked += rep["batches"]
            print(f"{label}: StallProbe depth {depth} behind a synthetic step "
                  f"(one pattern reduction over the batch, a {sleep_ms:.3f} "
                  f"ms busy-wait, a stream synchronize): stall "
                  f"{rep['stall_pct']:.3f} % over {rep['batches']} steps "
                  f"(wait {rep['wait_s'] * 1e3:.1f} ms, compute "
                  f"{rep['compute_s'] * 1e3:.1f} ms, "
                  f"{rep['batches'] / wall:.1f} steps/s) | {card}")
        errors = int(bad)
        print(f"{label}: {checked} served batches checked against the row "
              f"pattern on the card: {errors} bytes wrong")
        check(errors == 0, f"{label}: a served batch breaks its pattern")
        del data, ld
        torch.cuda.empty_cache()
    return {k: v - before[k] for k, v in ck.launches.items()}


def w3_weights() -> tuple:
    """W3's per-source integer quotas: proportions r_s = 1 + s % 13 turned
    into parts per 10^10, as a user turns float shares into the integer
    weights the alias table takes."""
    r = [1 + s % 13 for s in range(len(W3_SIZES))]
    return tuple(round(1e10 * x / sum(r)) for x in r)


def weighted_lane_ops(out, sizes, window: int, *, wide: bool, acc64: bool,
                      loc64: bool, rounds: int = 24,
                      depth: int = 0) -> tuple:
    """``(ops, shuffled lanes)`` of one ``weighted_stream(_wide)`` launch
    that wrote ``out``, counted from csrc/sampling_kernels.cu as the other
    kernels' counts are (the mix32 multiplies free; a multiply-high
    counted; a 64-bit operation as two).  Which lanes ran the in-window
    bijection is read off the output: a lane whose local id is below its
    source's full windows."""
    import torch

    offs = torch.tensor([0, *itertools.accumulate(sizes)][:-1],
                        dtype=torch.int64, device=out.device)
    body = torch.tensor([(n // window) * window for n in sizes],
                        dtype=torch.int64, device=out.device)
    ids = out.long()
    j = torch.searchsorted(offs, ids, right=True) - 1
    shuffled = int(((ids - offs[j]) < body[j]).sum().item())
    lane = (W_POS_OPS + W_BASE_OPS + W_COLUMN_OPS + W_TAIL_OPS
            + (W_ACCEPT64_OPS if acc64 else W_ACCEPT_OPS)
            + (W_LOCAL64_OPS if loc64 else W_LOCAL_OPS)
            + (W_WIDE_OPS if wide else 0) + depth * STRIDED_LAYER_OPS)
    per_shuffled = ((W_SHUFFLE64_OPS if loc64 else W_SHUFFLE_OPS)
                    + INNER_KEY_OPS + rounds * ROUND_OPS)
    return out.numel() * lane + shuffled * per_shuffled, shuffled


def masked_mixture_ops(spec, lanes: int, total: int, *, wide: bool,
                       rounds: int = 24) -> int:
    """int32 operations of the masked per-source loop over ``lanes`` lanes
    of an epoch of ``total`` positions, the same work the loop does (S
    passes over every lane, each source's outer and tail bijections once a
    (pass, table entry)), counted as the kernels' are (the mix32
    multiplies free, a 64-bit ``/`` or ``%`` as one operation)."""
    from partiallyshuffledistributedsampler_tpu_torch.ops import mixture as M

    son = rounds * ROUND_OPS
    ops = lanes * MASKED_LANE_OPS
    for s, (n_s, w_s) in enumerate(zip(spec.sources, spec.windows)):
        lane = MASKED_SOURCE_LANE_OPS + (WIDE_OPS if wide else 0)
        passes = M._max_pass(total - 1, spec, s)
        nw, tail = n_s // w_s, n_s % w_s
        table = passes * (nw + tail)
        if table <= M._TABLE_CAP and table <= 4 * lanes:
            ops += lanes * (lane + INNER_KEY_OPS + son)
            ops += passes * ((nw if nw > 1 else 0) + (tail if tail > 1
                                                      else 0)) * (
                BIJ_KEY_OPS + son)
        else:
            ops += lanes * (lane + MASKED_PASS_KEY_OPS + 2 * BIJ_KEY_OPS
                            + INNER_KEY_OPS + 3 * son)
    return ops


def sampling_phase(card: str, max_sm_mhz: float,
                   tile: bool = False) -> tuple:
    """Phase 17, the slice-9 main path: ``SamplingSpec`` on
    ``backend="cuda"`` (weighted, prioritized, dedup) at full width.  Each
    regen launches ``weighted_stream(_wide)`` once (a dedup epoch fold
    ``retries + 1`` times); each rank's stream equals the kernel alone,
    the plain version on the card over every lane, and the CPU route at
    4,096 sampled lanes (a dedup epoch: the CPU route's whole stream).
    Times each kernel beside its plain version, its bound and the uniform
    regen.  The dedup cell folds epoch 0; with ``tile`` the exact seen-set
    also folds epoch 1, which tiles the id space (its host fold took about
    two minutes a route on the H100's host: PERF.md §4).  Returns
    ``(launches, rows, errors)``: the main path's launches,
    ``{kernel: (ms, plain ms, bound ms, bound by)}`` and each kernel's
    largest error against its plain version."""
    import warnings

    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampling import (
        alias as A,
        dedup as D,
    )

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    int_ops_per_s = INT32_OPS_PER_CLK_PER_SM * sms * max_sm_mhz * 1e6
    launches9 = {k: 0 for k in ck.launches}
    errs = {k: 0 for k in SLICE9}
    rows9 = {}
    rng = np.random.default_rng(17)

    def gpu_ms(fn, reps):
        return device_ms(fn, reps, max_sm_mhz)

    def regen(fn, want, label):
        """``fn()`` (a spec call) launches the kernels of ``want`` as often
        as it says and nothing else: the main path's launches."""
        before = dict(ck.launches)
        out = fn()
        got = {k: v - before[k] for k, v in ck.launches.items()
               if v != before[k]}
        for k, v in got.items():
            launches9[k] += v
        check(got == want, f"{label}: the regen launched {got}, not {want}")
        return out

    def hold(name, got, want, label):
        equal = got.shape == want.shape and torch.equal(got.long(),
                                                        want.long())
        err = (int((got.long() - want.long()).abs().max().item())
               if got.shape == want.shape and got.numel() else 0)
        errs[name] = max(errs[name], err)
        print(f"check {name} {label}: lanes={got.numel()} equal={equal} "
              f"max_abs_err={err} (tolerance 0: the law is integer-exact)")
        check(equal, f"{name} {label} differs")

    def plain_chunked(table, sizes, seed, epoch, positions, window, **law):
        """The plain version over ``positions`` in chunks of 2^24 lanes (its
        int64 temporaries at 125M lanes would take tens of GB)."""
        return torch.cat([ck.weighted_stream_ref(
            table, sizes, seed, epoch, positions=positions[c:c + (1 << 24)],
            window=window, **law) for c in range(0, positions.numel(),
                                                 1 << 24)])

    def bound(ops, nbytes):
        t_ops, t_bytes = ops / int_ops_per_s, nbytes / HBM_BYTES_PER_S
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    def cell(label, sizes, weights, kind, T, world, ranks, layers=None,
             timed=False):
        """One weighted cell: the spec's regen of each rank held against
        the kernel alone, the plain version on every lane and the CPU
        route at 4,096 lanes; with ``timed`` the kernel, the plain version
        and the spec's wall.  Returns (kernel ms, plain ms, bound, its
        kind) of the last rank when timed."""
        spec = pt.SamplingSpec.weighted(sizes, weights, weight_kind=kind,
                                        epoch_samples=T, window=W,
                                        world=world)
        table = A.build_alias_table(weights, kind, sizes)
        wide = core.is_wide(T)
        name = "weighted_stream_wide" if wide else "weighted_stream"
        kernel = ck.weighted_stream_wide if wide else ck.weighted_stream
        acc64 = table.total > core.INT32_MAX
        loc64 = max(sizes) > core.INT32_MAX
        tag = (f"{label} T={T:.3g} world={world}"
               + (f" layers={layers}" if layers else "")
               + f" (S={len(sizes)}, total {table.total}, "
               f"{'64' if acc64 else '32'}-bit accept, "
               f"{'64' if loc64 else '32'}-bit local, "
               f"{'int64' if A.out_dtype(sizes) == torch.int64 else 'int32'}"
               f" ids)")
        res = None
        for rank in ranks:
            if layers is None:
                ns = spec.num_samples()
                src = dict(num_samples=ns)
            else:
                chain, _rem, ns = core.elastic_chain(T, layers, world)
                src = dict(num_samples=ns, chain=chain)
            pos = A.rank_ordinals(T, rank, world, ns, "strided",
                                  src.get("chain"), dev)
            host = regen(lambda r=rank: spec.rank_indices(1, r,
                                                          layers=layers),
                         {name: 1}, f"{tag} rank {rank}")
            got = torch.from_numpy(host).to(dev)
            kw = dict(epoch_samples=T, rank=rank, world=world, window=W,
                      **src)
            alone = kernel(table, sizes, 0, 1, **kw)
            hold(name, got, alone, f"{tag} rank={rank}: the spec's regen "
                 f"against the kernel alone")
            hold(name, alone, plain_chunked(table, sizes, 0, 1, pos, W),
                 f"{tag} rank={rank}: every lane against the plain version")
            lanes = np.sort(rng.choice(ns, min(4096, ns), replace=False))
            cpu = A.weighted_stream_at_cpu(pos[torch.from_numpy(lanes)
                                               .to(dev)].cpu(),
                                           table, sizes, 0, 1, window=W)
            ok = np.array_equal(host[lanes], cpu.numpy())
            print(f"check {tag} rank={rank}: {lanes.size} sampled lanes "
                  f"equal to the 'cpu' route: {ok}")
            check(ok, f"{tag}: the card's stream differs from the CPU route")
            if timed and rank == ranks[-1]:
                ms = gpu_ms(lambda: kernel(table, sizes, 0, 1, **kw),
                            20 if ns < 10**8 else 3)
                plain = None
                if ns < 10**8:
                    torch.cuda.reset_peak_memory_stats()
                    plain = gpu_ms(lambda: ck.weighted_stream_ref(
                        table, sizes, 0, 1, positions=pos, window=W), 2)
                    peak = torch.cuda.max_memory_allocated() / 2**30
                walls = host_walls(lambda r=rank: spec.rank_indices(
                    1, r, layers=layers), 10)
                ops, shuffled = weighted_lane_ops(
                    alone, sizes, W, wide=wide, acc64=acc64, loc64=loc64,
                    depth=0 if layers is None else len(layers))
                nbytes = (alone.numel() * alone.element_size()
                          + len(sizes) * ck.COL_WORDS * 8)
                b_ms, b_by = bound(ops, nbytes)
                plain_s = ("not measured (tens of GB of temporaries)"
                           if plain is None
                           else f"{plain:.4f} ms ({peak:.1f} GiB peak)")
                print(f"time {name} {tag} rank={rank}: kernel {ms:.4f} ms "
                      f"({ms * 1e9 / ns:.2f} ps a lane over {ns} lanes, "
                      f"{shuffled} through the bijection), plain {plain_s}, "
                      f"bound {b_ms:.4f} ms ({b_by}; {ops / 1e9:.3f} G int32 "
                      f"ops, {nbytes / 1e6:.1f} MB), {b_ms / ms:.1%} of "
                      f"bound; spec.rank_indices wall (kernel + readback) "
                      f"median {float(np.median(walls)):.4f} ms min "
                      f"{min(walls):.4f} ms | {card}")
                res = (ms, plain, b_ms, b_by)
            del got, alone, pos
        torch.cuda.empty_cache()
        return spec, res

    # ------------------------------------------------ W1, W2, W3 (+ elastic)
    ns128, _ = core.shard_sizes(N_C4, 128, False)
    w1, res = cell("W1", M1_SOURCES, W1_WEIGHTS, "per_sample", N_C4, 256,
                   (0, 255), timed=True)
    rows9["weighted_stream"] = res
    uniform = gpu_ms(lambda: ck.index_amortized(N_C4, W, 0, 1, 255, 256), 20)
    print(f"uniform regen at the same T: index_amortized n=1e9 W=8192 "
          f"world=256 {uniform:.4f} ms; weighted (W1) {res[0]:.4f} ms, "
          f"{res[0] / uniform:.2f}x (the JAX package's sampling-smoke "
          f"comparison; reported, not gated) | {card}")
    cell("W1", M1_SOURCES, W1_WEIGHTS, "per_sample", N_C4, 8, (3,))
    cell("W1 elastic 128 -> 256 half-way", M1_SOURCES, W1_WEIGHTS,
         "per_sample", N_C4, 256, (255,), layers=[(128, ns128 // 2)],
         timed=True)
    _w2, res = cell("W2", W2_SOURCES, W2_WEIGHTS, "per_source", N_LLAMA,
                    256, (0, 255), timed=True)
    rows9["weighted_stream_wide"] = res
    ns128w, _ = core.shard_sizes(N_LLAMA, 128, False)
    cell("W2 elastic 128 -> 256 half-way", W2_SOURCES, W2_WEIGHTS,
         "per_source", N_LLAMA, 256, (255,), layers=[(128, ns128w // 2)],
         timed=True)
    w3w = w3_weights()
    t3 = A.build_alias_table(w3w, "per_source", W3_SIZES)
    print(f"W3: 300 sources, {sum(W3_SIZES)} ids, weights per 10^10 (GCD "
          f"reduced total {t3.total}, past 2^31: "
          f"{t3.total > core.INT32_MAX}; columns past the staging cap of "
          f"{ck.STAGE_COLS}: {len(W3_SIZES) > ck.STAGE_COLS})")
    check(t3.total > core.INT32_MAX, "W3's total does not run the 64-bit "
          "accept draw")
    cell("W3", W3_SIZES, w3w, "per_source", N_C4, 256, (0, 255),
         timed=True)

    # ----------------------------------------------------------- prioritized
    base = pt.SamplingSpec.prioritized(M1_SOURCES, W1_WEIGHTS,
                                       weight_kind="per_sample",
                                       epoch_samples=N_C4, window=W,
                                       world=256)
    pri = base.with_stream_weights({1: W_PRIORITY})
    check(pri.fingerprint() == base.fingerprint(),
          "adopting weights moved the fingerprint")
    e0 = regen(lambda: pri.rank_indices(0, 7), {"weighted_stream": 1},
               "prioritized epoch 0")
    ok0 = np.array_equal(e0, w1.rank_indices(0, 7))
    e1 = regen(lambda: pri.rank_indices(1, 7), {"weighted_stream": 1},
               "prioritized epoch 1")
    adopted = A.build_alias_table(W_PRIORITY, "per_sample", M1_SOURCES)
    lanes = np.sort(rng.choice(e1.size, 4096, replace=False))
    cpu = A.weighted_stream_at_cpu(7 + 256 * lanes, adopted, M1_SOURCES, 0,
                                   1, window=W)
    ok1 = np.array_equal(e1[lanes], cpu.numpy())
    moved = not np.array_equal(e1, w1.rank_indices(1, 7))
    print(f"prioritized W1, weights {W_PRIORITY} adopted at epoch 1: epoch "
          f"0 equals the base table's stream: {ok0}; epoch 1 equals "
          f"weighted_stream_at_cpu under the adopted table at 4096 lanes: "
          f"{ok1}, and differs from the base table's: {moved}")
    check(ok0 and ok1 and moved, "the prioritized stream is wrong")

    # ------------------------------------------------------------------ dedup
    for kind, epochs in (("exact", (0, 1) if tile else (0,)),
                         ("bloom", (0,))):
        cfg = dict(kind=kind, retries=DEDUP_RETRIES, **(
            dict(bits=DEDUP_BLOOM_BITS, hashes=DEDUP_BLOOM_HASHES)
            if kind == "bloom" else {}))
        card_spec, host_spec = (pt.SamplingSpec.deduped(
            (N_IMAGENET,), epoch_samples=DEDUP_SAMPLES, window=W, world=8,
            dedup=cfg, backend=b) for b in ("cuda", "cpu"))
        table = A.build_alias_table((1,), "per_source", (N_IMAGENET,))
        served = []
        for epoch in epochs:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                t0 = time.perf_counter()
                regen(lambda e=epoch: card_spec.rank_indices(e, 0),
                      {"weighted_stream": DEDUP_RETRIES + 1},
                      f"dedup {kind} epoch {epoch}")
                fold_s = time.perf_counter() - t0
                t0 = time.perf_counter()
                host_spec.rank_indices(epoch, 0)
                cpu_s = time.perf_counter() - t0
            got = np.concatenate([regen(
                lambda e=epoch, r=r: card_spec.rank_indices(e, r), {},
                f"dedup {kind} epoch {epoch} rank {r}") for r in range(8)])
            want = np.concatenate([host_spec.rank_indices(epoch, r)
                                   for r in range(8)])
            kw = dict(window=W, retries=DEDUP_RETRIES)
            cand_walls = host_walls(lambda e=epoch: D.fold_candidates(
                table, (N_IMAGENET,), 0, e, DEDUP_SAMPLES, **kw), 3)
            cand_ms = gpu_ms(lambda e=epoch: [ck.weighted_stream(
                table, (N_IMAGENET,), 0, e, epoch_samples=DEDUP_SAMPLES,
                rank=0, world=1, num_samples=DEDUP_SAMPLES, window=W,
                retry=r) for r in range(DEDUP_RETRIES + 1)], 5)
            cand = float(np.median(cand_walls))
            ok = np.array_equal(got, want)
            served.append(got)
            msgs = sorted({str(w.message) for w in caught})
            print(f"dedup {kind} ImageNet {N_IMAGENET} ids, T={DEDUP_SAMPLES}"
                  f" world=8 epoch {epoch}: the 'cuda' stream equals the "
                  f"'cpu' stream over the whole epoch: {ok}; distinct ids "
                  f"{np.unique(got).size}; candidates ({DEDUP_RETRIES + 1} "
                  f"launches, {(DEDUP_RETRIES + 1) * DEDUP_SAMPLES} lanes) "
                  f"device {cand_ms:.4f} ms, with the readback wall median "
                  f"{cand:.4f} ms; host fold {fold_s * 1e3 - cand:.1f} ms "
                  f"(regen wall {fold_s * 1e3:.1f} ms); the 'cpu' route "
                  f"{cpu_s * 1e3:.1f} ms; warnings: {msgs} | {card}")
            check(ok, f"dedup {kind} epoch {epoch}: cuda differs from cpu")
        if kind == "exact" and tile:
            both = np.concatenate(served)
            distinct = np.unique(both).size
            print(f"dedup exact epochs 0 and 1: {both.size} draws over "
                  f"{N_IMAGENET} ids, {distinct} distinct (the last draw "
                  f"finds every id served)")
            check(np.unique(served[0]).size == served[0].size
                  and distinct == N_IMAGENET,
                  "dedup exact: the two epochs do not tile the id space")
        else:
            check(np.unique(served[0]).size == served[0].size,
                  f"dedup {kind}: epoch 0 repeats an id")
        del card_spec, host_spec
    return launches9, rows9, errs


def model_flops(cfg, batch: int, vit: bool) -> tuple:
    """``(matmul, attention)`` FLOPs of one train step (forward and
    backward, 3 x the forward): 6 x the matmul parameters x the tokens that
    pass through them, and 12 x B x T^2 x d per layer for the two attention
    products over every query and key (the plain attention computes the
    masked half too)."""
    d, L, f = cfg.d_model, cfg.n_layers, cfg.d_ff
    block = L * (4 * d * d + 2 * d * f)
    if vit:
        T = cfg.num_patches + 1
        patch = cfg.channels * cfg.patch_size ** 2 * d
        matmul = 6 * batch * (block * T + patch * (T - 1)
                              + d * cfg.num_classes)
    else:
        T = cfg.seq_len
        matmul = 6 * batch * T * (block + d * cfg.vocab_size)
    return matmul, 12 * batch * T * T * d * L


def trace_steps(prof, n_steps: int, steps: int):
    """Step metrics from a ``torch.profiler`` trace of a run of ``n_steps``
    steps, ``steps`` an epoch.  A step's launches end where its
    ``Optimizer.step`` range ends on the host; each device event is tied
    to its launch by the CUPTI correlation id, and a step's device span
    runs from the first to the last event it launched.  Returns the
    medians of the launch gap (host time between the ends of successive
    steps' launches), of the device time a step (end to end) and of the
    device idle before a step, within epochs; the device time an epoch
    boundary adds to its step; and the device busy share of the run.  A
    value the trace cannot give is None (not measured)."""
    import numpy as np

    out = dict(gap_ms=None, trace_step_ms=None, idle_ms=None,
               boundary_ms=None, busy=None)
    evs = list(prof.events())
    on_card = [e for e in evs if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)]
    host_ends = sorted(e.time_range.end for e in evs
                       if not str(e.device_type).endswith("CUDA")
                       and e.name.startswith("Optimizer.step#"))
    if len(host_ends) != n_steps:
        return out
    gaps = np.diff(host_ends) / 1e3
    within = [k for k in range(1, n_steps) if k % steps]
    out["gap_ms"] = float(np.median(gaps[[k - 1 for k in within]]))
    if not on_card:
        return out
    first = min(e.time_range.start for e in on_card)
    last = max(e.time_range.end for e in on_card)
    out["busy"] = sum(e.time_range.end - e.time_range.start
                      for e in on_card) / (last - first)
    # a launch is a CUDA API call (cudaLaunchKernel, cuLaunchKernel,
    # cudaMemcpyAsync, ...) carrying the correlation id of the device
    # event it made; the ops' own ids are of another space
    launched = {e.id: e.time_range.start for e in evs
                if not str(e.device_type).endswith("CUDA")
                and e.name.startswith("cu")}
    bounds = np.searchsorted(host_ends, [launched.get(e.id, np.inf)
                                         for e in on_card], side="right")
    spans = [[np.inf, -np.inf] for _ in range(n_steps)]
    for e, k in zip(on_card, bounds):
        if k < n_steps:
            spans[k][0] = min(spans[k][0], e.time_range.start)
            spans[k][1] = max(spans[k][1], e.time_range.end)
    if any(not np.isfinite(a) for a, _ in spans):
        return out  # a step with no device event tied to it
    end = np.array([b for _, b in spans])
    start = np.array([a for a, _ in spans])
    dev = (end[1:] - end[:-1]) / 1e3
    idle = (start[1:] - end[:-1]) / 1e3
    out["trace_step_ms"] = float(np.median(dev[[k - 1 for k in within]]))
    out["idle_ms"] = float(np.median(idle[[k - 1 for k in within]]))
    edges = [k - 1 for k in range(steps, n_steps, steps)]
    if edges:
        out["boundary_ms"] = float(np.median(dev[edges])) - out[
            "trace_step_ms"]
    return out


def time_run(label, cfg, vit, fn, epochs: int, steps: int, regen_ms,
             card) -> dict:
    """Times ``fn(first_epoch)``, a real run of ``epochs`` x ``steps``
    steps, after one run that warms it: CUDA events around a whole run
    (the device ms a step: its span over the steps, regens and epoch
    boundaries included) and the host clock (the host ms a step to queue
    it), then a ``torch.profiler`` trace of a third run for the launch
    gap, the device idle, the epoch boundary (``trace_steps``) and the
    kernels that take the time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    n = epochs * steps
    fn(0)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    fn(epochs)
    b.record()
    host_ms = (time.perf_counter() - t0) * 1e3 / n
    torch.cuda.synchronize()
    step_ms = a.elapsed_time(b) / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn(2 * epochs)
        torch.cuda.synchronize()
    mm, att = model_flops(cfg, TRAIN_BATCH, vit)
    out = dict(step_ms=step_ms, host_ms=host_ms,
               tflops=(mm + att) / (step_ms / 1e3) / 1e12, regen_ms=regen_ms,
               **trace_steps(prof, n, steps))
    ms = lambda v: "not measured" if v is None else f"{v:.4f} ms"  # noqa: E731
    print(f"{label} train step (batch {TRAIN_BATCH}, {cfg.dtype}), a run of "
          f"{epochs} epochs x {steps} steps: device {step_ms:.4f} ms a step "
          f"(CUDA events over the run, regens and boundaries included); "
          f"host {host_ms:.4f} ms a step to queue the run; "
          f"{out['tflops']:.1f} model TFLOP/s ({(mm + att) / 1e12:.3f} "
          f"TFLOP a step: 6*N*tokens {mm / 1e12:.3f} + attention "
          f"{att / 1e12:.3f}); regen {regen_ms:.4f} ms beside the step | "
          f"{card}")
    print(f"{label} trace of a run (profiler on), medians within epochs: "
          f"launch gap (host time between the ends of successive steps' "
          f"launches) {ms(out['gap_ms'])} against {ms(out['trace_step_ms'])}"
          f" a step on the device; device idle before a step "
          f"{ms(out['idle_ms'])}; the epoch boundary adds "
          f"{ms(out['boundary_ms'])} on the device; device busy "
          + ("not measured" if out["busy"] is None
             else f"{out['busy']:.1%} of the run") + f" | {card}")
    rows = []
    for evt in prof.key_averages():
        if (not str(evt.device_type).endswith("CUDA")
                or getattr(evt, "is_user_annotation", False)
                or evt.key.startswith("Optimizer.")):
            # host ops (their kernels are events of their own) and ranges
            # annotated on the device timeline, which overlap kernels
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            rows.append((us, evt.key, evt.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    for us, name, count in rows[:10]:
        print(f"  {us / n / 1e3:9.3f} ms a step {us / total:6.1%} "
              f"x{count // n:<5d} {name[:90]}")
    return out


def forward_parity(label, model, inputs, fwd, card) -> float:
    """Max |logits| between the card and the CPU route for the same
    module (f32, TF32 off) on ``inputs``; fails past ``FWD_TOL``."""
    import torch

    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            t0 = time.perf_counter()
            want = fwd(model, inputs)
            host_s = time.perf_counter() - t0
            model.to("cuda")
            got = fwd(model, inputs.cuda())
            check(got.is_cuda and got.dtype == torch.float32,
                  f"{label}: the card's logits are not f32 on the card")
            err = float((got.cpu() - want).abs().max())
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    n = sum(p.numel() for p in model.parameters())
    print(f"{label} forward parity (f32, TF32 off, {tuple(inputs.shape)}, "
          f"{n / 1e6:.1f}M parameters): max |logits card - CPU route| "
          f"{err:.3e} (tolerance {FWD_TOL:.0e}; CPU route {host_s:.1f} s, "
          f"max |logit| {float(want.abs().max()):.3f}) | {card}")
    check(err <= FWD_TOL, f"{label}: the card's forward differs from the "
          f"CPU route by {err:.3e} > {FWD_TOL:.0e}")
    return err


def t1_rows(rows: int):
    """T1's token rows for the trainer: row r holds r % 50,000 and
    r // 50,000 in its first two tokens and (r + j) % 50,257 at token j;
    every value is a token of GPT-2's vocabulary."""
    import numpy as np

    data = np.empty((rows, GPT2_SMALL["seq_len"] + 1), dtype=np.uint16)
    j = np.arange(data.shape[1], dtype=np.int64)
    for c in range(0, rows, 1 << 16):
        r = np.arange(c, min(rows, c + (1 << 16)), dtype=np.int64)
        data[c:c + r.size] = (r[:, None] + j[None, :]) % GPT2_SMALL[
            "vocab_size"]
        data[c:c + r.size, 0] = r % 50_000
        data[c:c + r.size, 1] = r // 50_000
    return data


def u16_tokens(b):
    """A served uint16 batch as int64 tokens, combined from its bytes on
    the card (uint16 tensors take few operations)."""
    import torch

    b8 = b.contiguous().view(torch.uint8).to(torch.int64)
    return b8[..., 0::2] + 256 * b8[..., 1::2]


def t1_errors(b, ids):
    """Tokens of a served batch that break ``t1_rows``'s pattern for the
    row ids ``ids`` (both on the card)."""
    import torch

    v = u16_tokens(b)
    rid = v[:, 0] + 50_000 * v[:, 1]
    j = torch.arange(v.shape[1], device=v.device)
    want = (rid[:, None] + j[None, :]) % GPT2_SMALL["vocab_size"]
    return (rid != ids).sum() + (v[:, 2:] != want[:, 2:]).sum()


def training_phase(card: str, max_sm_mhz: float) -> dict:
    """Phase 18: the consumer layer on the card.  GPT-2-small and ViT-L/16
    at full width: the forward against the CPU route (f32);
    ``make_run_runner`` and ``make_mixture_run_runner`` (bf16) under
    ``set_sync_debug_mode("error")`` with their launches counted and their
    regens held against the plain law, then the run runner timed
    (``time_run``); T1's loader behind the GPT-2-small step;
    ``demo_vit_run`` the same way, then its loop timed.  Returns the
    launches of the main-path runs and each kernel's max abs error."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch import parallel
    from partiallyshuffledistributedsampler_tpu_torch.models import (
        GPTConfig,
        ViTConfig,
        create_state,
        demo_vit_run,
        forward,
        init_params,
        init_vit_params,
        make_mixture_run_runner,
        make_run_runner,
        make_train_step,
        make_vit_train_step,
        vit_forward,
    )
    from partiallyshuffledistributedsampler_tpu_torch.models.train import (
        make_optimizer,
        triple_at_epoch,
    )
    from partiallyshuffledistributedsampler_tpu_torch.models.vit import (
        synthetic_images,
    )
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
        mixture as M,
    )
    from partiallyshuffledistributedsampler_tpu_torch.utils.stall_probe import (
        StallProbe,
    )

    dev = torch.device("cuda")
    gpu_ms = lambda fn, reps: device_ms(fn, reps, max_sm_mhz)  # noqa: E731
    launches = {k: 0 for k in ck.launches}
    errs = {k: 0 for k in SLICE10}

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    def hold(name, got, want, label):
        equal = got.shape == want.shape and torch.equal(got.long(),
                                                        want.long())
        err = (int((got.long() - want.long()).abs().max().item())
               if got.shape == want.shape and got.numel() else 0)
        errs[name] = max(errs[name], err)
        print(f"check {name} {label}: lanes={got.numel()} equal={equal} "
              f"max_abs_err={err} (tolerance 0: the law is integer-exact)")
        check(equal, f"{name} {label} differs from its plain version")

    # ------------------------------------------- forward parity, f32
    gen = torch.Generator().manual_seed(0)
    g32 = GPTConfig(dtype=torch.float32, **GPT2_SMALL)
    tok = torch.randint(0, g32.vocab_size, (2, g32.seq_len), generator=gen)
    forward_parity("GPT-2-small", init_params(g32, gen), tok,
                   lambda m, x: forward(g32, m, x), card)
    v32 = ViTConfig(dtype=torch.float32, **VIT_L16)
    img = torch.randn(2, v32.image_size, v32.image_size, v32.channels,
                      generator=gen)
    forward_parity("ViT-L/16", init_vit_params(v32, gen), img,
                   lambda m, x: vit_forward(v32, m, x), card)
    torch.cuda.empty_cache()

    dist.init_process_group("nccl",
                            init_method=f"tcp://localhost:{free_port()}",
                            rank=0, world_size=1)
    mesh = parallel.data_mesh()
    cfg = GPTConfig(**GPT2_SMALL)  # bf16 activations, the default
    tgen = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_ROWS, cfg.seq_len + 1),
                           generator=tgen, device=dev, dtype=torch.int32)
    print(f"GPT-2-small trainer: token table {tuple(tokens.shape)} int32 on "
          f"the card ({tokens.numel() * 4 / 1e9:.2f} GB, rows cut from C4's "
          f"~365M documents), window {W}, world 1, batch {TRAIN_BATCH} x "
          f"{cfg.seq_len} tokens, {cfg.dtype} activations")
    triple = parallel.make_seed_triple(0, 0, mesh=mesh)

    # ---------------- the slice-10 main path: the run runners, no sync
    model, opt = create_state(cfg, mesh, 0)
    run = make_run_runner(cfg, opt, mesh, TRAIN_BATCH, TRAIN_STEPS,
                          TRAIN_EPOCHS, TRAIN_ROWS, W)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        t0 = time.perf_counter()
        losses = run(model, tokens, triple, 0)
        host_s = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = dict(ck.launches)
    add(counts)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    means = losses.float().mean(dim=1).cpu().numpy()
    print(f"GPT-2-small make_run_runner: {TRAIN_EPOCHS} epochs x "
          f"{TRAIN_STEPS} steps under set_sync_debug_mode('error') with no "
          f"error, queued in {host_s:.2f} s, done in {wall_s:.2f} s; "
          f"launches {json.dumps({k: v for k, v in counts.items() if v})}; "
          f"epoch mean loss {[round(float(m), 4) for m in means]} | {card}")
    check(counts["index_amortized"] == TRAIN_EPOCHS
          and sum(counts.values()) == TRAIN_EPOCHS,
          "the run runner did not regenerate with one index_amortized "
          "launch an epoch")
    check(tuple(losses.shape) == (TRAIN_EPOCHS, TRAIN_STEPS)
          and losses.is_cuda and bool(torch.isfinite(losses).all()),
          "the run runner's losses are not finite [epochs, steps] on the "
          "card")
    check(means[-1] < means[0], "the GPT-2-small loss did not fall")
    # the runner's regen, made with its arguments, at every epoch it ran
    regen_fn, ns = parallel.make_regen_fn(TRAIN_ROWS, W, mesh=mesh)
    for e in range(TRAIN_EPOCHS):
        hold("index_amortized", regen_fn(triple_at_epoch(triple, e)),
             ck.epoch_indices_amortized_ref(TRAIN_ROWS, W, 0, e, 0, 1, ns,
                                            device=dev),
             f"make_run_runner's regen n={TRAIN_ROWS} W={W} world=1 "
             f"epoch={e}")
    regen_ms = gpu_ms(lambda: regen_fn(triple), 50)
    gpt = time_run("GPT-2-small", cfg, False,
                   lambda e0: run(model, tokens, triple, e0), TRAIN_EPOCHS,
                   TRAIN_STEPS, regen_ms, card)

    spec = pt.MixtureSpec(MIX_TRAIN_SIZES, [70, 20, 10], windows=W)
    mix = make_mixture_run_runner(cfg, opt, mesh, TRAIN_BATCH, TRAIN_STEPS,
                                  MIX_TRAIN_EPOCHS, spec)
    torch.cuda.synchronize()
    ck.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mlosses = mix(model, tokens, triple, 0)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts = dict(ck.launches)
    add(counts)
    torch.cuda.synchronize()
    mregen, mns = parallel.make_mixture_regen_fn(spec, mesh=mesh)
    _t, _ns, total = M.mixture_epoch_sizes(spec, None, 1, False)
    for e in range(MIX_TRAIN_EPOCHS):
        hold("mixture_fused", mregen(triple_at_epoch(triple, e)),
             ck.mixture_fused_ref(None, spec, 0, e, rank=0, world=1,
                                  num_samples=mns, device=dev,
                                  wide_pos=total + spec.block
                                  > core.INT32_MAX),
             f"make_mixture_run_runner's regen {MIX_TRAIN_SIZES} at "
             f"70/20/10 W={W} world=1 epoch={e}")
    mregen_ms = gpu_ms(lambda: mregen(triple), 50)
    print(f"GPT-2-small make_mixture_run_runner over {MIX_TRAIN_SIZES} at "
          f"70/20/10: {MIX_TRAIN_EPOCHS} epochs x {TRAIN_STEPS} steps under "
          f"set_sync_debug_mode('error') with no error; launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}; losses "
          f"finite: {bool(torch.isfinite(mlosses).all())}; mixture regen "
          f"{mregen_ms:.4f} ms beside the step's {gpt['step_ms']:.4f} ms "
          f"| {card}")
    check(counts["mixture_fused"] == MIX_TRAIN_EPOCHS
          and sum(counts.values()) == MIX_TRAIN_EPOCHS,
          "the mixture run runner did not regenerate with one mixture_fused "
          "launch an epoch")
    check(bool(torch.isfinite(mlosses).all()),
          "the mixture run runner's losses are not finite")

    # --------------------- T1's loader behind the GPT-2-small step
    rows = t1_rows(T1_TRAIN_ROWS)
    step_rows = make_train_step(cfg, opt, mesh, TRAIN_BATCH)
    in_order = torch.arange(TRAIN_BATCH, device=dev)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    stall = {}
    for depth in (1, 2):
        ld = pt.HostDataLoader(rows, window=W, batch=TRAIN_BATCH, rank=3,
                               world=8, depth=depth, boundary_prefetch=False)
        ids = torch.from_numpy(ld.epoch_indices(depth).astype(np.int64)).to(
            dev)
        it = ld.epoch(depth)
        probe = StallProbe(it)
        gen_b = iter(probe)
        step_ms = []
        for s, b in enumerate(gen_b):
            bad += t1_errors(b, ids[s * TRAIN_BATCH:(s + 1) * TRAIN_BATCH])
            t0 = time.perf_counter()
            step_rows(model, u16_tokens(b), in_order, 0)
            torch.cuda.current_stream().synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            if s + 1 == T1_TRAIN_STEPS:
                break
        gen_b.close()
        it.close()
        rep = probe.report()
        stall[depth] = rep["stall_pct"]
        print(f"T1 behind the GPT-2-small step: StallProbe depth {depth}: "
              f"stall {rep['stall_pct']:.3f} % over {rep['batches']} steps "
              f"(wait {rep['wait_s'] * 1e3:.1f} ms, compute "
              f"{rep['compute_s'] * 1e3:.1f} ms; the step to a synchronised "
              f"stream {float(np.median(step_ms)):.2f} ms median); "
              f"{T1_TRAIN_ROWS} host rows of {rows.shape[1]} uint16, world "
              f"8, batch {TRAIN_BATCH} | {card}")
    errors = int(bad)
    check(errors == 0, f"T1 behind the trainer: {errors} tokens break the "
          "row pattern")
    del rows, model, opt, run, mix, step_rows, tokens, losses, mlosses
    torch.cuda.empty_cache()

    vcfg = ViTConfig(**VIT_L16)
    # ----------------------------- ViT-L/16: demo_vit_run, then timed
    ck.reset_launches()
    vlosses = demo_vit_run(mesh, vcfg, n_samples=VIT_IMAGES,
                           window=VIT_WINDOW, batch_per_dp=TRAIN_BATCH,
                           steps_per_epoch=VIT_STEPS, epochs=VIT_EPOCHS)
    counts = dict(ck.launches)
    add(counts)
    print(f"ViT-L/16 demo_vit_run: {VIT_EPOCHS} epochs x {VIT_STEPS} steps "
          f"over {VIT_IMAGES} f32 images on the card "
          f"({VIT_IMAGES * 224 * 224 * 3 * 4 / 1e9:.2f} GB); launches "
          f"{json.dumps({k: v for k, v in counts.items() if v})}; losses "
          f"{[round(v, 4) for v in vlosses]} | {card}")
    check(counts["index_amortized"] == VIT_EPOCHS
          and sum(counts.values()) == VIT_EPOCHS,
          "demo_vit_run did not regenerate with one index_amortized launch "
          "an epoch")
    check(len(vlosses) == VIT_EPOCHS * VIT_STEPS
          and all(np.isfinite(vlosses)), "the ViT losses are not finite")
    for e in range(VIT_EPOCHS):
        hold("index_amortized",
             parallel.sharded_epoch_indices(VIT_IMAGES, VIT_WINDOW, 0, e,
                                            mesh=mesh),
             ck.epoch_indices_amortized_ref(VIT_IMAGES, VIT_WINDOW, 0, e, 0,
                                            1, VIT_IMAGES, device=dev),
             f"demo_vit_run's regen n={VIT_IMAGES} W={VIT_WINDOW} world=1 "
             f"epoch={e}")
    torch.cuda.empty_cache()
    # demo_vit_run's loop after its set-up (the port has no ViT runner):
    # one regen an epoch, then the epoch's steps of make_vit_train_step
    images, labels = synthetic_images(vcfg, VIT_IMAGES, 0, dev)
    vmodel = init_vit_params(vcfg, torch.Generator().manual_seed(0)).to(dev)
    vstep = make_vit_train_step(vcfg, make_optimizer(vmodel), mesh,
                                TRAIN_BATCH)

    def vit_epochs(first):
        out = []
        for e in range(first, first + VIT_EPOCHS):
            idx = parallel.sharded_epoch_indices(VIT_IMAGES, VIT_WINDOW, 0,
                                                 e, mesh=mesh)
            out += [vstep(vmodel, images, labels, idx, s)
                    for s in range(VIT_STEPS)]
        return torch.stack(out)

    vregen, _ = parallel.make_regen_fn(VIT_IMAGES, VIT_WINDOW, mesh=mesh)
    vit = time_run("ViT-L/16", vcfg, True, vit_epochs, VIT_EPOCHS, VIT_STEPS,
                   gpu_ms(lambda: vregen(triple), 50), card)
    del vmodel, vstep, images, labels
    dist.destroy_process_group()
    torch.cuda.empty_cache()
    print(json.dumps({"training": {"gpt2_small": gpt, "vit_l16": vit,
                                   "t1_stall_pct": stall}}))
    return launches, errs


def capability_phase(card: str, max_sm_mhz: float) -> tuple:
    """Phase 19, the slice-11 main path: signed epoch capabilities and the
    membership-trail replay on ``backend="cuda"`` over the PERF.md §4
    shapes, then the control plane on the card.  For each spec kind (C4
    1B, M1, S1, W1, a 1e8-horizon stream) an ``EpochCapability`` is
    signed for the current membership and verified, a tampered copy
    refused; ``replay_trail`` over a trail world/2 -> world (the first
    membership delivered a prefix; rank 0 with an orphan descriptor) is
    held at tolerance 0 against the same spec on 'cpu', and each
    membership launches its kernels once.  Then 20 traced regens at
    1B/world 256 under ``set_sync_debug_mode("error")`` (one span each),
    and three faults through ``HostDataLoader`` and ``SamplingSpec`` on
    the card.  Returns ``(launches, errors)``: the replays' launches and
    each kernel's largest error against the CPU route."""
    import warnings

    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch import (
        capability as C,
        faults as F,
        telemetry as T,
    )
    from partiallyshuffledistributedsampler_tpu_torch.analysis import (
        lockorder,
    )
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
        mixture as M,
    )

    dev = torch.device("cuda")
    launches19 = {k: 0 for k in ck.launches}
    errs = {k: 0 for k in SLICE11}
    secret = b"chip-smoke-deployment-secret"

    def gpu_ms(fn, reps):
        return device_ms(fn, reps, max_sm_mhz)

    def counted(fn):
        """``fn()`` and the launches it made, by kernel."""
        before = dict(ck.launches)
        out = fn()
        return out, {k: v - before[k] for k, v in ck.launches.items()
                     if v != before[k]}

    def add(total, got):
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return total

    class PlainOnCard:
        """A stream by the kernels' plain versions on the card, with the
        spec surface ``replay_trail`` reads (``with_world``,
        ``rank_indices``): the replay reference of a cell whose CPU route
        takes past ~30 s (C4 and M1: rank 0's three memberships at
        world 128 and 256 are ~17.6M lanes of the plain law)."""

        def __init__(self, full, remainder, world):
            self.full, self.remainder, self.world = full, remainder, world

        def with_world(self, world):
            return PlainOnCard(self.full, self.remainder, int(world))

        def rank_indices(self, epoch, rank, layers=None):
            out = (self.remainder(epoch, rank, self.world, layers) if layers
                   else self.full(epoch, rank, self.world))
            return out.cpu().numpy()

    def c4_full(epoch, rank, world):
        ns = core.shard_sizes(N_C4, world, False)[0]
        return ck.epoch_indices_amortized_ref(N_C4, W, 0, epoch, rank, world,
                                              ns, device=dev)

    def c4_remainder(epoch, rank, world, layers):
        chain, _, ns = core.elastic_chain(N_C4, layers, world)
        return ck.index_positions_ref(N_C4, W, 0, epoch, rank=rank,
                                      world=world, num_samples=ns,
                                      chain=chain, device=dev)

    # ------------------------------------------------------ the cells
    ns128, _ = core.shard_sizes(N_C4, 128, False)
    s1 = np.full(SHARDS, SHARD_M, dtype=np.int64)
    m1 = pt.MixtureSpec(M1_SOURCES, M1_WEIGHTS, windows=W)
    m1_plain = PlainOnCard(
        lambda e, r, w: M.mixture_epoch_indices_generic(m1, 0, e, r, w,
                                                        device=dev),
        lambda e, r, w, layers: M.mixture_elastic_indices_generic(
            m1, 0, e, r, w, layers, device=dev), 256)
    # (label, spec maker, world, what a rank consumed at world/2 in base
    # units (shards for S1), the kernels of one full membership, of one
    # remainder, the reference: the spec on 'cpu', or the plain versions
    # on the card where the CPU route takes past ~30 s)
    cells = (
        ("C4 1B/8192", lambda b: pt.PartialShuffleSpec.plain(
            N_C4, window=W, world=256, backend=b), 256, ns128 // 2,
         {"index_amortized": 1}, {"index_positions": 1},
         PlainOnCard(c4_full, c4_remainder, 256)),
        ("M1", lambda b: pt.PartialShuffleSpec.mixture(
            m1, world=256, backend=b), 256, ns128 // 2,
         {"mixture_fused": 1}, {"mixture_fused": 1}, m1_plain),
        ("S1 100,000 x 1,000", lambda b: pt.PartialShuffleSpec.shard(
            s1, window=SHARD_W, world=8, backend=b), 8, SHARDS // 8,
         {"index_amortized": 1, "shard_row_keys": 1, "shard_expand": 1},
         {"index_positions": 1, "shard_row_keys": 1, "shard_expand": 1},
         None),
        ("W1", lambda b: pt.SamplingSpec.weighted(
            M1_SOURCES, W1_WEIGHTS, weight_kind="per_sample",
            epoch_samples=N_C4, window=W, world=256, backend=b), 256,
         ns128 // 2, {"weighted_stream": 1}, {"weighted_stream": 1}, None),
        ("StreamSpec.plain_stream(1e8, 8192)",
         lambda b: pt.StreamSpec.plain_stream(N_1E8, window=W, world=256,
                                              backend=b), 256,
         core.shard_sizes(N_1E8, 128, False)[0] // 2,
         {"index_amortized": 1}, {"index_positions": 1}, None),
    )
    epoch = 1
    cpu_total = 0.0
    plain_cells = []
    for label, make, world, prefix, full_k, rem_k, plain_ref in cells:
        card_spec, host_spec = make("cuda"), make("cpu")
        if plain_ref is not None:
            plain_cells.append(label)
        old = world // 2
        layers = [(old, prefix)]
        # the samples that prefix is (a shard is SHARD_M samples)
        delivered = prefix * (SHARD_M if label.startswith("S1") else 1)
        # the orphan a departed rank left: the last 4,096 of its prefix
        orphan = {"epoch": epoch, "rank": old - 1, "world": old,
                  "lo": delivered - 4096, "hi": delivered, "layers": []}
        # ---- the capability: sign, verify, refuse a tampered copy
        cap = C.EpochCapability(
            fingerprint=card_spec.fingerprint(include_world=False),
            epoch=epoch, seed=card_spec.seed, generation=2, world=world,
            layers=tuple(layers), elastic_epoch=epoch, orphans=(orphan,),
            tenant="t-chip", stream_weights=None).signed(secret)
        wire = C.EpochCapability.from_wire(json.loads(json.dumps(
            cap.to_wire())))
        check(wire.verify(secret) and wire == cap,
              f"{label}: the capability does not verify after its wire")
        check(not wire.tampered().verify(secret)
              and not wire.verify(b"another-deployment"),
              f"{label}: a tampered capability verified")
        check(wire.fingerprint == host_spec.fingerprint(include_world=False),
              f"{label}: the capability names another stream")
        # ---- the replay: rank 0 (its prefix at world/2, the orphan, the
        # remainder) and the last rank (joined at the reshard: remainder)
        for rank in (0, world - 1):
            joined = rank >= old
            trail = ({"rank": None if joined else rank, "world": old,
                      "layers": [], "orphans": (), "samples": delivered},)
            kw = dict(rank=rank, world=wire.world,
                      layers=[list(x) for x in wire.layers],
                      orphans=wire.orphans if rank == 0 else (),
                      elastic_epoch=wire.elastic_epoch, trail=trail)
            want_k = add(add({}, rem_k), {} if joined else full_k)
            if rank == 0:
                want_k = add(want_k, full_k)  # the orphan's membership
            got, launched = counted(lambda: C.replay_trail(
                card_spec, wire.epoch, **kw))
            add(launches19, launched)
            check(launched == want_k,
                  f"{label} rank {rank}: the replay launched {launched}, "
                  f"not {want_k} (each membership once)")
            # rank 0's three memberships are the long CPU evaluation
            on_card = plain_ref is not None and rank == 0
            ref_name = ("the plain versions on the card" if on_card
                        else "the 'cpu' route")
            t0 = time.perf_counter()
            want = C.replay_trail(plain_ref if on_card else host_spec,
                                  epoch, **kw)
            ref_s = time.perf_counter() - t0
            if not on_card:
                cpu_total += ref_s
            equal = (got.shape == want.shape and np.array_equal(got, want)
                     and (on_card or got.dtype == want.dtype))
            err = (int(np.abs(got.astype(np.int64)
                              - want.astype(np.int64)).max())
                   if got.shape == want.shape and got.size else 0)
            for k in launched:
                errs[k] = max(errs[k], err)
            print(f"check replay {label} world {old} -> {world} rank {rank}"
                  f" ({'joined at the reshard' if joined else 'a prefix of '}"
                  f"{'' if joined else delivered}"
                  f"{', an orphan' if rank == 0 else ''}): {got.size} ids "
                  f"{got.dtype}, launches {json.dumps(launched)}, equal to "
                  f"{ref_name}: {equal} max_abs_err={err} (tolerance 0; "
                  f"the reference took {ref_s:.2f} s)")
            check(equal, f"{label} rank {rank}: the replay on the card "
                  f"differs from {ref_name}")
        # ---- the time of a replay, per membership, beside rank_indices
        rank = 0
        kw = dict(rank=rank, world=world, layers=layers, orphans=(orphan,),
                  elastic_epoch=epoch,
                  trail=({"rank": rank, "world": old, "layers": [],
                          "orphans": (), "samples": delivered},))
        memberships = 3  # the prefix, the orphan's, the remainder
        walls = host_walls(lambda: C.replay_trail(card_spec, epoch, **kw), 5)
        spans = []
        for w_, l_, o_ in ((old, [], ()), (world, layers, ())):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            a.record()
            C.membership_stream(card_spec, epoch, rank, w_, l_, o_)
            b.record()
            b.synchronize()
            spans.append(a.elapsed_time(b))
        one = host_walls(lambda: card_spec.rank_indices(epoch, rank), 5)
        row = (label, float(np.median(walls)) / memberships, spans,
               float(np.median(one)))
        print(f"time replay {label} rank 0 ({memberships} memberships: the "
              f"prefix at world {old}, the orphan, the remainder at world "
              f"{world}): host wall with the readbacks median "
              f"{float(np.median(walls)):.4f} ms = {row[1]:.4f} ms a "
              f"membership; device span (CUDA events around a membership's "
              f"kernels and readback) full {spans[0]:.4f} ms, remainder "
              f"{spans[1]:.4f} ms; one plain rank_indices at world {world} "
              f"host wall median {row[3]:.4f} ms | {card}")
        del card_spec, host_spec
        torch.cuda.empty_cache()
    print(f"replays held against the CPU route: every one but rank 0 of "
          f"{' and '.join(plain_cells)} ({cpu_total:.1f} s of CPU evaluation "
          f"in all); those two held against the kernels' plain versions on "
          f"the card (their CPU route would take past ~30 s)")
    for name in SLICE11:
        check(launches19[name] > 0,
              f"kernel {name} was not launched by the replays")

    # ---- sign and verify, host µs
    spec = pt.PartialShuffleSpec.plain(N_C4, window=W, world=256)
    base_cap = C.EpochCapability(
        fingerprint=spec.fingerprint(include_world=False), epoch=7, seed=0,
        generation=3, world=256, layers=((128, ns128 // 2),),
        elastic_epoch=7, tenant="t-chip")
    reps = 2000
    t0 = time.perf_counter()
    for _ in range(reps):
        signed = base_cap.signed(secret)
    sign_us = (time.perf_counter() - t0) / reps * 1e6
    t0 = time.perf_counter()
    for _ in range(reps):
        ok = signed.verify(secret)
    verify_us = (time.perf_counter() - t0) / reps * 1e6
    check(ok, "the timed capability does not verify")
    print(f"time capability: sign {sign_us:.2f} us, verify {verify_us:.2f} "
          f"us (host, HMAC-SHA256 over {len(signed.canonical())} canonical "
          f"bytes; mean of {reps}) | {card}")

    # ---- telemetry on the card: 20 traced regens, no host sync
    T.reset()
    T.configure(enabled=True)
    regen = lambda e=0: pt.epoch_indices_cuda(N_C4, W, 0, e, 3, 256)  # noqa: E731
    regen()
    torch.cuda.synchronize()
    before = len(T.snapshot())
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs, launched = counted(lambda: [regen(e) for e in range(20)])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    spans = [e for e in T.snapshot()[before:]
             if e.get("name") == "psds_epoch_regen"]
    print(f"telemetry on: 20 regens 1B/8192 world=256 under "
          f"set_sync_debug_mode('error'): no host sync, {len(spans)} "
          f"psds_epoch_regen spans (attrs {spans[0]['attrs'] if spans else None}), "
          f"launches {json.dumps(launched)}")
    check(len(spans) == 20 and launched == {"index_amortized": 20},
          "a traced regen is not one span and one launch")
    ns256, _ = core.shard_sizes(N_C4, 256, False)
    for e in (0, 19):
        want = ck.epoch_indices_amortized_ref(N_C4, W, 0, e, 3, 256, ns256,
                                              device=dev)
        check(torch.equal(outs[e].long(), want.long()),
              f"the traced regen of epoch {e} differs from the plain law")
    del outs
    on_ms, on_wall = gpu_ms(regen, 20), float(np.median(host_walls(regen,
                                                                   20)))
    T.configure(enabled=False)
    off_ms, off_wall = gpu_ms(regen, 20), float(np.median(host_walls(regen,
                                                                     20)))
    print(f"time regen 1B/8192 world=256 with telemetry on / off: device "
          f"{on_ms:.4f} / {off_ms:.4f} ms, host wall to ready median "
          f"{on_wall:.4f} / {off_wall:.4f} ms | {card}")
    hits = 1_000_000
    t0 = time.perf_counter()
    for _ in range(hits):
        F.fire("loader.prefetch")
    fire_ns = (time.perf_counter() - t0) / hits * 1e9
    t0 = time.perf_counter()
    for _ in range(hits):
        T.span("psds_epoch_regen", n=1, world=1)
    span_ns = (time.perf_counter() - t0) / hits * 1e9
    print(f"time the control plane off: a fault site hit with no plan "
          f"{fire_ns:.1f} ns, a disabled span {span_ns:.1f} ns (host, mean "
          f"of {hits}) | {card}")

    # ---- faults on the card
    T.reset()
    T.configure(enabled=True)
    base = np.arange(N_C4, dtype=np.int32)  # row r holds r
    threads = lockorder.thread_snapshot()
    loader = pt.HostDataLoader(base, window=W, batch=512, rank=5, world=256,
                               depth=2, boundary_prefetch=False)
    plan = F.FaultPlan([F.FaultRule("loader.prefetch", "error", nth=3)])
    served = 0
    raised = None
    with plan:
        try:
            for b in loader.epoch(1):
                check(b.is_cuda, "the loader served a host batch")
                served += 1
        except F.InjectedFault as exc:
            raised = exc
    loader.close()
    leaked = lockorder.leaked_threads(threads, include_daemon=True)
    print(f"fault loader.prefetch error nth=3: {served} batches served, "
          f"then {type(raised).__name__} at step {served + 1} "
          f"({raised}); threads left behind: {[t.name for t in leaked]}")
    check(raised is not None and served == 2 and plan.fired() == 1
          and not leaked, "the prefetch fault did not surface at step 3")
    loader = pt.HostDataLoader(base, window=W, batch=512, rank=5, world=256)
    plan = F.FaultPlan([F.FaultRule("loader.boundary", "error")])
    with plan:
        it = loader.epoch(1)
        next(it)
        it.close()
        suppressed = loader._boundary_thread is None
        it, launched = counted(lambda: loader.epoch(2))
        want = ck.epoch_indices_amortized_ref(N_C4, W, 0, 2, 5, 256, ns256,
                                              device=dev)
        ok = all(torch.equal(b.long(), want[s * 512:(s + 1) * 512].long())
                 for s, b in zip(range(100), it))
        it.close()
        idx_ok = np.array_equal(loader.epoch_indices(2),
                                want.cpu().numpy())
    loader.close()
    print(f"fault loader.boundary error: fired {plan.fired()}, the worker "
          f"suppressed: {suppressed}; epoch 2 regenerated in the foreground "
          f"({json.dumps(launched)}), its stream equal to the plain law on "
          f"the card: {idx_ok}, 100 batches equal: {ok}")
    check(plan.fired() == 1 and suppressed and idx_ok and ok
          and launched == {"index_amortized": 1},
          "the boundary fault did more than lose the prefetch")
    del base, loader, want
    w1 = pt.SamplingSpec.weighted(M1_SOURCES, W1_WEIGHTS,
                                  weight_kind="per_sample",
                                  epoch_samples=N_C4, window=W, world=256)
    plan = F.FaultPlan([F.FaultRule("sampling.alias_build", "error")])
    with plan, warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, launched = counted(lambda: w1.rank_indices(1, 3))
    uniform = pt.SamplingSpec.weighted(
        M1_SOURCES, (1, 1, 1), epoch_samples=N_C4, window=W, world=256,
        backend="cpu").rank_indices(1, 3)
    warned = [str(x.message) for x in caught
              if issubclass(x.category, RuntimeWarning)]
    events = [e for e in T.snapshot()
              if e.get("name") == "sampling_alias_fallback"]
    fell = np.array_equal(got, uniform)
    print(f"fault sampling.alias_build error on W1 world=256 rank 3: fired "
          f"{plan.fired()}, {len(warned)} RuntimeWarning "
          f"({warned[0][:60] if warned else None}...), {len(events)} "
          f"sampling_alias_fallback event, launches {json.dumps(launched)}, "
          f"equal to the uniform table's stream on the CPU route: {fell}")
    check(plan.fired() == 1 and len(warned) == 1 and len(events) == 1
          and fell and launched == {"weighted_stream": 1},
          "the alias-build fault did not fall back to the uniform table")
    T.reset()
    check(F.active() is None, "a fault plan stayed armed")
    return launches19, errs


def pattern_rows(rows: int, shape, dtype):
    """Phase 16's host rows: row r's first 4 bytes hold r (int32), every
    other byte r mod 251."""
    import numpy as np

    data = np.empty((rows,) + tuple(shape), dtype=dtype)
    b8 = data.reshape(rows, -1).view(np.uint8)
    b8[:, 4:] = (np.arange(rows) % 251).astype(np.uint8)[:, None]
    b8[:, :4] = np.arange(rows, dtype=np.int32).view(np.uint8).reshape(rows,
                                                                       4)
    return data


def pattern_errors(b, ids):
    """Bytes of a batch of ``pattern_rows`` on the card that break the
    pattern for the row ids ``ids``."""
    import torch

    b8 = b.view(torch.uint8).reshape(b.shape[0], -1)
    hdr = b8[:, :4].contiguous().view(torch.int32).reshape(-1)
    return ((hdr != ids).sum()
            + (b8[:, 4:] != (hdr % 251).to(torch.uint8)[:, None]).sum())


def timed_ms(fn) -> float:
    """Host wall ms of one call, to a synchronised device."""
    import torch

    t = time.perf_counter()
    fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3


def hold_stream(errs: dict, name: str, got, want, label: str) -> None:
    """A host stream ``got`` against the plain version ``want`` on the
    card at tolerance 0; its largest error into ``errs[name]``."""
    import numpy as np
    import torch

    g = torch.from_numpy(np.array(got)).to(want.device).long()
    same = g.shape == want.shape
    err = int((g - want.long()).abs().max()) if same and g.numel() else 0
    errs[name] = max(errs.get(name, 0), err)
    check(same and err == 0, f"{name} {label}: {g.numel()} lanes against "
          f"{want.numel()} of the plain version, max_abs_err {err}")


def take_launches(into: dict) -> dict:
    """The launches since the last reset, added to ``into``, and the
    counters reset."""
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        cuda_kernel as ck,
    )

    got = {k: v for k, v in ck.launches.items() if v}
    for k, v in got.items():
        into[k] += v
    ck.reset_launches()
    return got


def pct(xs, q) -> float:
    """The ``q`` th percentile of ``xs``."""
    import numpy as np

    return float(np.percentile(np.asarray(xs, dtype=np.float64), q))


def run_threads(fns, timeout: float = 300.0) -> None:
    """Run each of ``fns`` on a thread of its own; raise the first
    error."""
    import threading

    errors = []

    def wrap(fn):
        try:
            fn()
        except BaseException as exc:  # reported below
            errors.append(exc)

    threads = [threading.Thread(target=wrap, args=(fn,)) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
        check(not t.is_alive(), "a thread of the phase hung")
    if errors:
        raise errors[0]


def union_exactly_once(consumed, remainders, ranks, n, old_world,
                       consumed_n, new_world, dev) -> str:
    """``tests/conftest.py::assert_exactly_once`` on ``dev``, as a message
    ('' when it holds), for an id space of ``n``: the old ranks'
    ``consumed`` prefixes plus the new ranks' ``remainders`` are the old
    ranks' streams (``ranks``) as a multiset, plus exactly the wrap-pad
    count of extras, each drawn from the unconsumed parts."""
    import numpy as np
    import torch

    def counts(parts):
        x = torch.from_numpy(np.concatenate(parts)).to(dev).long()
        return torch.bincount(x, minlength=n).to(torch.int32)

    full = counts(ranks)
    got = counts(consumed)
    got += counts(remainders)
    missing = int((full - got).clamp_(min=0).sum())
    if missing:
        return f"{missing} epoch values missing"
    got -= full
    del full
    total = sum(len(r) for r in ranks)
    rem = total - consumed_n * old_world
    n_extra = -(-rem // new_world) * new_world - rem
    if int(got.sum()) != n_extra:
        return f"{int(got.sum())} extras, the wrap pad is {n_extra}"
    if bool((got > counts([r[consumed_n:] for r in ranks])).any()):
        return "a wrap-pad extra is not from the remainder"
    return ""


def service_phase(card: str, max_sm_mhz: float) -> tuple:
    """Phase 20, the slice-12 main path: the index service on the card.
    ``IndexServer`` and ``ServiceIndexClient`` s run as threads of this
    process (nothing forks after CUDA is initialized), each regen of the
    servers through specs on ``backend="cuda"``.  Six cases: C4 served to
    8 clients; a multi-tenant daemon with C4, M1 and W1; an elastic
    reshard 8 -> 16 over ImageNet; a primary killed under its standby; a
    capability-mode client; ``HostDataLoader`` served, then degraded to a
    local regen.  Every stream is held at tolerance 0.  Returns
    ``(launches, errors)``: the servers' and clients' launches, and each
    kernel's largest error against its plain version."""
    import threading
    import warnings

    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch import telemetry as T
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
        mixture as M,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampling import (
        alias as A,
    )
    from partiallyshuffledistributedsampler_tpu_torch.service import (
        IndexServer,
        ServiceError,
        ServiceIndexClient,
        protocol as P,
    )
    from partiallyshuffledistributedsampler_tpu_torch.utils.stall_probe import (
        StallProbe,
    )

    dev = torch.device("cuda")
    launches20 = {k: 0 for k in ck.launches}
    errs = {}  # only the kernels held against their plain versions
    hold = functools.partial(hold_stream, errs)
    take = functools.partial(take_launches, launches20)
    t_phase = time.perf_counter()

    c4 = pt.PartialShuffleSpec.plain(N_C4, window=W, world=SERVE_WORLD)
    ns256, _ = core.shard_sizes(N_C4, SERVE_WORLD, False)

    # ---- case 1: C4 served to 8 clients
    direct = {r: c4.rank_indices(0, r) for r in SERVE_RANKS}
    direct_ms = float(np.median(host_walls(lambda: c4.rank_indices(0, 3),
                                           20)))
    for r in (0, SERVE_WORLD - 1):
        hold("index_amortized", direct[r], ck.epoch_indices_amortized_ref(
            N_C4, W, 0, 0, r, SERVE_WORLD, ns256, device=dev),
             f"C4 world {SERVE_WORLD} rank {r}, the direct regen")
    ck.reset_launches()
    streams, rates = {}, {}
    with IndexServer(c4, max_inflight=16) as srv:

        def client(r):
            with ServiceIndexClient(srv.address, rank=r,
                                    batch=SERVE_BATCH) as c:
                t0 = time.perf_counter()
                parts = list(c.epoch_batches(0))
                rates[r] = (len(parts), time.perf_counter() - t0)
            streams[r] = np.concatenate(parts)

        t0 = time.perf_counter()
        run_threads([lambda r=r: client(r) for r in SERVE_RANKS])
        all_s = time.perf_counter() - t0
        got = take()
        regen_ms = list(srv.metrics.regen_timer.samples_ms)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # the cached arrays are read-only
            pinned = sum(bool(torch.from_numpy(a).is_pinned())
                         for a in srv._cache.values())
        check(pinned == 0, f"the server caches {pinned} page-locked arrays")
        # a reconnect of rank 0 replays from the cache: GET_BATCH on the
        # request-reply path (lookahead 1), each round trip timed
        rtt = []
        deadline = time.monotonic() + 10.0
        while True:  # the first rank-0 client's lease frees on its close
            c = ServiceIndexClient(srv.address, rank=0, batch=SERVE_BATCH,
                                   lookahead=1)
            try:
                c.heartbeat()
                break
            except ServiceError as exc:
                c.close()
                check(exc.code == "rank_taken"
                      and time.monotonic() < deadline,
                      f"rank 0 could not reconnect: {exc}")
                time.sleep(0.01)
        with c:
            it = c.epoch_batches(0)
            parts = []
            while True:
                t0 = time.perf_counter()
                try:
                    parts.append(next(it))
                except StopIteration:
                    break
                rtt.append((time.perf_counter() - t0) * 1e6)
        replay = take()
    for r in SERVE_RANKS:
        check(np.array_equal(streams[r], direct[r])
              and streams[r].dtype == direct[r].dtype,
              f"served C4 rank {r} differs from its direct regen")
    check(np.array_equal(np.concatenate(parts), direct[0]),
          "the replayed rank 0 differs")
    check(got == {"index_amortized": len(SERVE_RANKS)},
          f"served C4: launches {got}, not one index_amortized a rank")
    check(replay == {}, f"the cache replay launched {replay}")
    nbytes = direct[0].nbytes
    print(f"service C4 1B/8192 world {SERVE_WORLD}, ranks {SERVE_RANKS}, "
          f"batch {SERVE_BATCH}: every stream ({len(direct[0])} indices) "
          f"byte-equal to a direct epoch_indices_cuda readback, ranks 0 and "
          f"{SERVE_WORLD - 1} to the plain law on the card; launches "
          f"{json.dumps(got)}; every cached epoch in pageable memory; rank "
          f"0 reconnected: replayed from the cache, "
          f"launches {json.dumps(replay)} | {card}")
    print(f"time service epoch_regen_ms (server, kernel + readback, host "
          f"wall) over {len(regen_ms)} regens: p50 {pct(regen_ms, 50):.4f} "
          f"p99 {pct(regen_ms, 99):.4f} ms; a direct rank_indices of the "
          f"same spec: median {direct_ms:.4f} ms | {card}")
    print(f"time service GET_BATCH round trip (lookahead 1, cache hit, "
          f"{SERVE_BATCH} int32): p50 {pct(rtt, 50):.1f} p99 "
          f"{pct(rtt, 99):.1f} us over {len(rtt)} | {card}")
    for r in SERVE_RANKS:
        nb, s = rates[r]
        print(f"time service client rank {r}: {nb / s:.1f} batches/s, "
              f"{nbytes / s / 1e6:.1f} MB/s ({s:.3f} s for the epoch)")
    print(f"time service 8 clients together: "
          f"{sum(n for n, _ in rates.values()) / all_s:.1f} batches/s, "
          f"{nbytes * len(SERVE_RANKS) / all_s / 1e6:.1f} MB/s "
          f"({all_s:.3f} s) | {card}")

    # ---- case 2: one multi-tenant daemon, three tenants
    mspec = pt.MixtureSpec(M1_SOURCES, M1_WEIGHTS, windows=W)
    m1 = pt.PartialShuffleSpec.mixture(mspec, world=SERVE_WORLD)
    w1 = pt.SamplingSpec.weighted(M1_SOURCES, W1_WEIGHTS,
                                  weight_kind="per_sample",
                                  epoch_samples=N_C4, window=W,
                                  world=SERVE_WORLD)
    tenants = (("C4", c4, "index_amortized"), ("M1", m1, "mixture_fused"),
               ("W1", w1, "weighted_stream"))
    ranks2 = (0, SERVE_WORLD - 1)
    ck.reset_launches()
    got2 = {}
    with IndexServer(c4, multi_tenant=True, max_inflight=16) as srv:

        def tenant_client(label, spec, r):
            with ServiceIndexClient(srv.address, rank=r, batch=SERVE_BATCH,
                                    spec=spec) as c:
                got2[label, r] = c.epoch_indices(0)

        t0 = time.perf_counter()
        run_threads([lambda a=a, s=s, r=r: tenant_client(a, s, r)
                     for a, s, _ in tenants for r in ranks2])
        mt_s = time.perf_counter() - t0
        launched = take()
        n_tenants = len(srv.tenants())
        queue = srv.metrics.report()["histograms"].get("regen_queue_ms", {})
    for label, spec, kernel in tenants:
        for r in ranks2:
            want = direct[r] if label == "C4" else spec.rank_indices(0, r)
            check(np.array_equal(got2[label, r], want),
                  f"tenant {label} rank {r} differs from its direct regen")
    ck.reset_launches()  # the references' launches are not the path's
    # each tenant's served stream against its kernel's plain version
    _t, ns_m1, total_m1 = M.mixture_epoch_sizes(mspec, None, SERVE_WORLD,
                                                False)
    table_w1 = A.build_alias_table(W1_WEIGHTS, "per_sample", M1_SOURCES)
    for r in ranks2:
        hold("mixture_fused", got2["M1", r], ck.mixture_fused_ref(
            None, mspec, 0, 0, rank=r, world=SERVE_WORLD, num_samples=ns_m1,
            wide_pos=total_m1 + mspec.block > core.INT32_MAX, device=dev),
             f"tenant M1 world {SERVE_WORLD} rank {r}, served")
        hold("weighted_stream", got2["W1", r], ck.weighted_stream_ref(
            table_w1, M1_SOURCES, 0, 0, epoch_samples=N_C4, rank=r,
            world=SERVE_WORLD, num_samples=w1.num_samples(), window=W,
            device=dev), f"tenant W1 world {SERVE_WORLD} rank {r}, served")
    torch.cuda.empty_cache()
    want2 = {k: len(ranks2) for _, _, k in tenants}
    check(launched == want2 and n_tenants == len(tenants),
          f"multi-tenant: launches {launched}, {n_tenants} tenants")
    print(f"service multi-tenant: {n_tenants} tenants (C4, M1, W1 at world "
          f"{SERVE_WORLD}), ranks {ranks2} each, concurrent regens under the "
          f"fair-share scheduler (queue {queue.get('count', 0)} slots): "
          f"streams bit-exact to the direct regens and, for M1 and W1, to "
          f"mixture_fused's and weighted_stream's plain versions on the "
          f"card (max_abs_err 0), launches {json.dumps(launched)} "
          f"({mt_s:.3f} s) | {card}")

    # ---- case 3: elastic, ImageNet world 8 -> 16 after a third
    inet = pt.PartialShuffleSpec.plain(N_IMAGENET, window=W,
                                       world=ELASTIC_WORLDS[0])
    old_w, new_w = ELASTIC_WORLDS
    ns8, _ = core.shard_sizes(N_IMAGENET, old_w, False)
    third = -(-ns8 // 3 // SERVE_BATCH)  # batches before the reshard
    ck.reset_launches()
    delivered = {}
    hit = threading.Barrier(old_w)
    go = threading.Barrier(old_w)
    with IndexServer(inet, max_inflight=16) as srv:

        def old_rank(r):
            with ServiceIndexClient(srv.address, rank=r, batch=SERVE_BATCH,
                                    reconnect_timeout=60.0) as c:
                it = c.epoch_batches(0)
                got = [next(it) for _ in range(third)]
                hit.wait(60.0)
                if r == 0:
                    check(c.reshard(new_w), "the reshard was refused")
                go.wait(60.0)
                got += list(it)
                check(c.rank == r, f"old rank {r} came back as {c.rank}")
                delivered[r] = np.concatenate(got)

        def joiner(j):
            deadline = time.monotonic() + 60.0
            while srv.generation < 1:  # joiners dial after the commit
                check(time.monotonic() < deadline, "the reshard never "
                      "committed")
                time.sleep(0.01)
            with ServiceIndexClient(srv.address, rank=None,
                                    batch=SERVE_BATCH,
                                    reconnect_timeout=60.0) as c:
                parts = list(c.epoch_batches(0))
                check(c.rank is not None and old_w <= c.rank < new_w,
                      f"joiner {j} was given rank {c.rank}")
                delivered[c.rank] = (np.concatenate(parts) if parts
                                     else np.empty(0, np.int32))

        t0 = time.perf_counter()
        run_threads([lambda r=r: old_rank(r) for r in range(old_w)]
                    + [lambda j=j: joiner(j) for j in range(new_w - old_w)])
        el_s = time.perf_counter() - t0
        state = srv._state_dict()
        launched = take()
    check(state["generation"] == 1 and len(state["layers"]) == 1
          and int(state["layers"][0][0]) == old_w,
          f"elastic: generation {state['generation']}, layers "
          f"{state['layers']}")
    consumed = int(state["layers"][0][1])
    check(sorted(delivered) == list(range(new_w)),
          f"elastic: streams of ranks {sorted(delivered)}")
    streams8 = [inet.rank_indices(0, r) for r in range(old_w)]
    ck.reset_launches()
    # each old rank's stream up to the barrier, then each new rank's
    # remainder, against the plain laws on the card
    chain, _rem, ns_el = core.elastic_chain(N_IMAGENET,
                                            [(old_w, consumed)], new_w)
    for r in range(new_w):
        tail = delivered[r]
        if r < old_w:
            hold("index_amortized", tail[:consumed],
                 ck.epoch_indices_amortized_ref(
                     N_IMAGENET, W, 0, 0, r, old_w, ns8,
                     device=dev)[:consumed],
                 f"ImageNet world {old_w} rank {r} before the barrier")
            tail = tail[consumed:]
        hold("index_positions", tail, ck.index_positions_ref(
            N_IMAGENET, W, 0, 0, rank=r, world=new_w, num_samples=ns_el,
            chain=chain, device=dev),
             f"ImageNet world {new_w} rank {r}, the remainder after "
             f"{old_w} x {consumed}")
    why = union_exactly_once(
        [delivered[r][:consumed] for r in range(old_w)],
        [delivered[r][consumed:] for r in range(old_w)]
        + [delivered[r] for r in range(old_w, new_w)],
        streams8, N_IMAGENET, old_w, consumed, new_w, dev)
    check(why == "", f"elastic ImageNet {old_w} -> {new_w}: {why}")
    check(launched == {"index_amortized": old_w, "index_positions": new_w},
          f"elastic: launches {launched}, not one index_amortized an old "
          f"rank and one index_positions a remainder rank")
    print(f"service elastic ImageNet 1,281,167/8192 world {old_w} -> "
          f"{new_w} after {consumed} samples a rank (~a third): every rank "
          f"finished, each old rank's stream to the barrier and each new "
          f"rank's remainder equal to the plain laws on the card "
          f"(index_amortized, index_positions; max_abs_err 0), the union "
          f"the epoch exactly once (conftest's law, strided), launches {json.dumps(launched)} ({el_s:.3f} s) | "
          f"{card}")

    # ---- case 4: failover to a standby twin
    ck.reset_launches()
    standby = IndexServer(c4, role="standby", repl_feed_timeout=0.25)
    standby.start()
    primary = IndexServer(c4, standby=standby.address,
                          repl_feed_timeout=0.25, max_inflight=16)
    primary.start()
    ranks4 = range(FAILOVER_RANKS)
    fo = {}
    streamed = threading.Barrier(FAILOVER_RANKS + 1)
    killed = threading.Barrier(FAILOVER_RANKS + 1)

    def fo_client(r):
        with ServiceIndexClient(primary.address, rank=r, batch=SERVE_BATCH,
                                spec=c4, backoff_base=0.01,
                                reconnect_timeout=2.0) as c:
            it = c.epoch_batches(0)
            got = [next(it) for _ in range(FAILOVER_BATCHES)]
            streamed.wait(60.0)
            killed.wait(60.0)
            first = None
            for arr in it:
                got.append(arr)
                if first is None and c.metrics.report()["counters"].get(
                        "failovers", 0):
                    first = time.perf_counter()  # served by the standby
            fo[r] = (np.concatenate(got), first,
                     c.metrics.report()["counters"])

    try:
        threads = [threading.Thread(target=fo_client, args=(r,))
                   for r in ranks4]
        for t in threads:
            t.start()
        streamed.wait(60.0)
        deadline = time.monotonic() + 30.0
        while not (primary._shipper is not None
                   and primary._shipper.synced.is_set()
                   and standby._applied_lsn >= primary._repl_log.lsn):
            check(time.monotonic() < deadline, "the standby never synced")
            time.sleep(0.01)
        t_kill = time.perf_counter()
        primary.kill()
        killed.wait(60.0)
        for t in threads:
            t.join(120.0)
            check(not t.is_alive(), "a failover client hung")
        promoted = standby.role
    finally:
        primary.kill()
        standby.stop()
    launched = take()
    check(promoted == "primary", "the standby was not promoted")
    for r in ranks4:
        s, _, counters = fo.get(r, (None, 0, {}))
        check(s is not None and np.array_equal(s, direct[r]),
              f"failover rank {r}: the stream has a gap or a duplicate")
        check(counters.get("failovers", 0) >= 1
              and counters.get("degraded_mode", 0) == 0,
              f"failover rank {r}: counters {counters}")
    failover_ms = (min(f for _, f, _ in fo.values() if f is not None)
                   - t_kill) * 1e3
    check(launched == {"index_amortized": 2 * FAILOVER_RANKS},
          f"failover: launches {launched}")
    print(f"service failover C4 world {SERVE_WORLD}, ranks 0..."
          f"{FAILOVER_RANKS - 1}, primary killed after {FAILOVER_BATCHES} "
          f"batches: every stream bit-identical to case 1, no gap, no "
          f"duplicate, launches {json.dumps(launched)} (each rank once on "
          f"each server) | {card}")
    print(f"time service failover, the kill to the first batch served by "
          f"the standby: {failover_ms:.1f} ms (client reconnect_timeout "
          f"2.0 s, feed timeout 0.25 s) | {card}")

    # ---- case 5: capability mode (seeds, not indices)
    secret = b"chip-smoke-deployment-secret"
    real_recv = P._recv_exact
    wire = {"bytes": 0}

    def counting_recv(sock, n):
        wire["bytes"] += n
        return real_recv(sock, n)

    def index_bytes_of(fn):
        wire["bytes"] = 0
        frames = []
        real_msg = P.recv_msg

        def counting_msg(sock, **kw):
            msg, header, payload = real_msg(sock, **kw)
            if msg == P.MSG_BATCH:
                frames.append(len(payload))
            return msg, header, payload

        P._recv_exact, P.recv_msg = counting_recv, counting_msg
        try:
            out = fn()
        finally:
            P._recv_exact, P.recv_msg = real_recv, real_msg
        return out, wire["bytes"], sum(frames)

    ck.reset_launches()
    with IndexServer(c4, capability_secret=secret) as srv:
        with ServiceIndexClient(srv.address, rank=0, batch=SERVE_BATCH,
                                spec=c4, capability_secret=secret) as c:
            cap, cap_wire, cap_idx = index_bytes_of(
                lambda: c.capability_epoch_indices(0))
        cap_launched = take()
        # the server regenerates the rank once at issuance (the grant's
        # total); the rest is the client's regen
        issue_regens = srv.metrics.regen_timer.count
        with ServiceIndexClient(srv.address, rank=1, batch=SERVE_BATCH) as c:
            served1, srv_wire, srv_idx = index_bytes_of(
                lambda: c.epoch_indices(0))
        take()
    check(np.array_equal(cap, direct[0]),
          "the capability stream differs from case 1's")
    check(np.array_equal(served1, direct[1]), "served rank 1 differs")
    check(cap_idx == 0, f"capability mode moved {cap_idx} index bytes")
    check(issue_regens == 1 and cap_launched == {"index_amortized": 2},
          f"capability: launches {cap_launched} with {issue_regens} "
          f"server regens, not one at issuance and one for the client")
    print(f"service capability C4 world {SERVE_WORLD} rank 0: stream equal "
          f"to case 1's; launches {json.dumps(cap_launched)}: one at the "
          f"server's issuance (the grant's total), one the client's regen "
          f"on the card; wire bytes (both directions) "
          f"{cap_wire} with {cap_idx} index bytes, against {srv_wire} "
          f"({srv_idx} index bytes) served for rank 1 | {card}")

    # ---- case 6: HostDataLoader served, then degraded to a local regen
    label, rows, shape, dtype, world, batch, _, stall_steps = T_CASES[0]
    t0 = time.perf_counter()
    data = pattern_rows(rows, shape, dtype)
    fill_s = time.perf_counter() - t0
    t1 = pt.PartialShuffleSpec.plain(rows, window=W, world=world)
    rank6 = 3 % world
    cycles = int(5e-3 * max_sm_mhz * 1e6)
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    ids = {e: torch.from_numpy(t1.rank_indices(e, rank6).astype(
        np.int32)).to(dev) for e in (0, 1)}
    ck.reset_launches()
    stall = {}
    with IndexServer(t1) as srv:
        for mode in ("local", "served"):
            client = (ServiceIndexClient(srv.address, rank=rank6,
                                         batch=SERVE_BATCH)
                      if mode == "served" else None)
            ld = pt.HostDataLoader(data, window=W, batch=batch, rank=rank6,
                                   world=world, depth=2,
                                   boundary_prefetch=False,
                                   index_client=client)
            it = ld.epoch(0)
            probe = StallProbe(it)
            gen = iter(probe)
            for s, b in enumerate(gen):
                bad += pattern_errors(b, ids[0][s * batch:(s + 1) * batch])
                torch.cuda._sleep(cycles)
                torch.cuda.current_stream().synchronize()
                if s + 1 == stall_steps:
                    break
            gen.close()
            it.close()
            stall[mode] = probe.report()
            ld.close()
            if client is not None:
                client.close()
        served_launched = take()
        # the degrade: the served epoch 0 runs on after the daemon stops,
        # and epoch 1 is regenerated locally on the card
        T.reset()
        T.configure(enabled=True)
        client = ServiceIndexClient(srv.address, rank=rank6,
                                    batch=SERVE_BATCH, backoff_base=0.01,
                                    reconnect_timeout=1.0)
        ld = pt.HostDataLoader(data, window=W, batch=batch, rank=rank6,
                               world=world, depth=2, boundary_prefetch=False,
                               index_client=client, degraded_fallback=True)
        it = ld.epoch(0)
        steps0 = 0
        for s, b in enumerate(it):
            bad += pattern_errors(b, ids[0][s * batch:(s + 1) * batch])
            steps0 += 1
            if s + 1 == stall_steps:
                srv.stop()  # mid-epoch: the epoch's indices are in hand
            if s + 1 == 2 * stall_steps:
                break
        it.close()
        before_degrade = take()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        steps1 = 0
        it = ld.epoch(1)
        for s, b in enumerate(it):
            bad += pattern_errors(b, ids[1][s * batch:(s + 1) * batch])
            steps1 += 1
            if s + 1 == stall_steps:
                break
        it.close()
    degraded_launched = take()
    events = [ev["name"] for sp in T.snapshot() if sp.get("kind") == "span"
              for ev in sp.get("events", ())]
    T.configure(enabled=False)
    counters = client.metrics.report()["counters"]
    ld.close()
    client.close()
    errors6 = int(bad)
    check(errors6 == 0, f"served loader: {errors6} bytes break the pattern")
    check(served_launched == {"index_amortized": 2},
          f"served loader: launches {served_launched} (the local loader's "
          f"regen and the server's, one each)")
    check(before_degrade == {} and degraded_launched == {
        "index_amortized": 1}, f"degrade: launches {before_degrade} before, "
          f"{degraded_launched} for the local regen")
    check(ld.degraded and counters.get("degraded_mode", 0) == 1
          and "degraded_fallback" in events
          and any("unavailable" in str(w.message) for w in caught),
          f"degrade not recorded: counters {counters}, events {events}")
    print(f"service loader {label}: {rows} rows ({fill_s:.2f} s to fill), "
          f"world {world} rank {rank6}, batch {batch}, depth 2 behind the "
          f"5 ms synthetic step, {stall_steps} steps: stall local "
          f"{stall['local']['stall_pct']:.3f} % / served "
          f"{stall['served']['stall_pct']:.3f} % | {card}")
    print(f"service loader degrade: daemon stopped after {stall_steps} of "
          f"epoch 0's steps ({steps0} served, all bit-identical), epoch 1 "
          f"regenerated locally on the card ({steps1} steps checked): "
          f"launches {json.dumps(degraded_launched)}, degraded_mode "
          f"{counters.get('degraded_mode', 0)}, event degraded_fallback "
          f"recorded; every batch's rows checked: {errors6} bytes wrong | "
          f"{card}")
    del data
    print(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return launches20, errs


def sharding_phase(card: str) -> tuple:
    """Phase 21, the slice-13 main path: the sharded plane, federation and
    the autopilot on the card.  Shards, standbys, routers, cells and
    clients run as threads of this process, every regen of the servers
    through specs on ``backend="cuda"``: C4 1B/8192 at world 256 over
    ``ShardPlane(n_shards=4, standby=True, wal_dir=...)`` (the deployment
    of docs/SHARDING.md) served to two ranks a shard through the router;
    the cross-shard reshard 256 -> 192 a third of the way through an
    epoch (all 256 ranks; the union exactly once); ``split_shard``,
    ``merge_shards`` and ``migrate_ranks`` under live clients, then a
    shard primary killed under its standby; M1 and W1 attached as tenants
    across the shards; a two-cell ``Federation`` killed and promoted, a
    ``TrustBundle`` capability client, a live ``migrate_tenant``; the
    ``Autopilot`` on a live plane (the card probe, a tune a client adopts,
    a split under a hotspot); a seeded ``FleetSim`` over the calibration
    the phase measured, written to ``runs/fleetsim_calibration.json``.
    Every stream is held at tolerance 0.  Returns ``(launches, errors)``:
    the path's launches, and each kernel's largest error against its
    plain version."""
    import copy
    import dataclasses
    import math
    import tempfile
    import threading
    import warnings
    from pathlib import Path

    import numpy as np
    import torch

    import partiallyshuffledistributedsampler_tpu_torch as pt
    from partiallyshuffledistributedsampler_tpu_torch import fleetsim as fs
    from partiallyshuffledistributedsampler_tpu_torch.autopilot import (
        Autopilot,
        AutopilotPolicy,
        PolicyConfig,
    )
    from partiallyshuffledistributedsampler_tpu_torch.federation import (
        Federation,
        verify_capability,
    )
    from partiallyshuffledistributedsampler_tpu_torch.ops import (
        core,
        cuda_kernel as ck,
        mixture as M,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sampling import (
        alias as A,
    )
    from partiallyshuffledistributedsampler_tpu_torch.service import (
        ServiceError,
        ServiceIndexClient,
        protocol as P,
    )
    from partiallyshuffledistributedsampler_tpu_torch.sharding import (
        ShardPlane,
    )
    from partiallyshuffledistributedsampler_tpu_torch.tenancy import (
        tenant_id_for,
    )
    from partiallyshuffledistributedsampler_tpu_torch.utils import autotune

    dev = torch.device("cuda")
    n, world, new_world = N_C4, SHARD_WORLD, SHARD_NEW_WORLD
    launches21 = {k: 0 for k in ck.launches}
    errs = {}  # only the kernels held against their plain versions
    hold = functools.partial(hold_stream, errs)
    take = functools.partial(take_launches, launches21)
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory(prefix="psds-phase21-")

    def sigma_of(p50, p99):
        """The lognormal spread whose p99 / p50 is the measured one."""
        return (max(0.0, math.log(p99 / p50) / 2.326)
                if p50 > 0 and p99 > 0 else 0.0)

    def reconnect(addr, rank, **kw):
        """A client of ``rank`` once the lease of its last client frees."""
        deadline = time.monotonic() + 10.0
        while True:
            c = ServiceIndexClient(addr, rank=rank, **kw)
            try:
                c.heartbeat()
                return c
            except ServiceError as exc:
                c.close()
                check(exc.code == "rank_taken"
                      and time.monotonic() < deadline,
                      f"rank {rank} could not reconnect: {exc}")
                time.sleep(0.01)

    def timed_batches(c, epoch):
        """Each batch of ``epoch`` and the round trip of each (µs)."""
        it, parts, rtt = c.epoch_batches(epoch), [], []
        while True:
            t0 = time.perf_counter()
            try:
                parts.append(next(it))
            except StopIteration:
                return parts, rtt
            rtt.append((time.perf_counter() - t0) * 1e6)

    def wait_standby(primary, standby):
        deadline = time.monotonic() + 30.0
        while not (primary._shipper is not None
                   and primary._shipper.synced.is_set()
                   and standby._applied_lsn >= primary._repl_log.lsn):
            check(time.monotonic() < deadline, "a standby never synced")
            time.sleep(0.01)

    c4 = pt.PartialShuffleSpec.plain(n, window=W, seed=0, world=world)
    ns, _ = core.shard_sizes(n, world, False)
    skw = dict(repl_feed_timeout=0.25, max_inflight=16)
    direct = {r: c4.rank_indices(0, r) for r in SHARD_RANKS}
    # one rank again and again, as a shard's regens run (its pinned
    # readback buffer reused)
    direct_ms = float(np.median([timed_ms(lambda: c4.rank_indices(0, 3))
                                 for _ in range(20)]))
    for r in (0, world - 1):
        hold("index_amortized", direct[r], ck.epoch_indices_amortized_ref(
            n, W, 0, 0, r, world, ns, device=dev),
             f"C4 world {world} rank {r}, the direct regen")
    ck.reset_launches()

    # ---- (a) the sharded plane: two ranks a shard through the router
    plane = ShardPlane(c4, SHARD_SHARDS, standby=True,
                       wal_dir=os.path.join(tmp.name, "a"),
                       server_kwargs=skw)
    plane.start()
    try:
        streams, rates, routed = {}, {}, {}

        def client(r):
            with ServiceIndexClient(plane.address, rank=r,
                                    batch=SERVE_BATCH) as c:
                t0 = time.perf_counter()
                parts = list(c.epoch_batches(0))
                rates[r] = (len(parts), time.perf_counter() - t0)
                routed[r] = (tuple(c.address), c.shard_map is not None)
            streams[r] = np.concatenate(parts)

        t0 = time.perf_counter()
        run_threads([lambda r=r: client(r) for r in SHARD_RANKS])
        all_s = time.perf_counter() - t0
        got = take()
        for r in SHARD_RANKS:
            owner = plane.map.owner(r)
            check(routed[r] == (tuple(plane.shards[owner].address), True),
                  f"rank {r} was not redirected to its shard {owner}: "
                  f"{routed[r]}")
            check(np.array_equal(streams[r], direct[r])
                  and streams[r].dtype == direct[r].dtype,
                  f"sharded C4 rank {r} differs from its direct regen")
        check(got == {"index_amortized": len(SHARD_RANKS)},
              f"sharded C4: launches {got}")
        regen_ms = [x for s in plane.shards
                    for x in s.metrics.regen_timer.samples_ms]
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # cached arrays are read-only
            pinned = sum(bool(torch.from_numpy(a).is_pinned())
                         for s in plane.shards for a in s._cache.values())
        check(pinned == 0, f"the shards cache {pinned} page-locked arrays")
        # a reconnect through the router, then one straight at the shard:
        # both replay from the cache at lookahead 1, each round trip timed
        with reconnect(plane.address, 0, batch=SERVE_BATCH,
                       lookahead=1) as c:
            parts, rtt_router = timed_batches(c, 0)
        check(np.array_equal(np.concatenate(parts), direct[0]),
              "the replayed rank 0 differs")
        owner = plane.map.owner(SHARD_RANKS[1])
        with reconnect(plane.shards[owner].address, SHARD_RANKS[1],
                       batch=SERVE_BATCH, lookahead=1) as c:
            parts, rtt_direct = timed_batches(c, 0)
        check(np.array_equal(np.concatenate(parts), direct[SHARD_RANKS[1]]),
              "the directly replayed rank differs")
        replay = take()
        check(replay == {}, f"the cache replays launched {replay}")
        plane.router.set_epoch(1)
        check(all(s.epoch == 1 for s in plane.shards),
              f"set_epoch fan-out: shard epochs "
              f"{[s.epoch for s in plane.shards]}")
        nbytes = direct[0].nbytes
        print(f"sharding C4 {n}/8192 world {world} over {SHARD_SHARDS} "
              f"shards with standbys and WAL, ranks {SHARD_RANKS} through "
              f"the router, batch {SERVE_BATCH}: each redirected to its "
              f"shard, every stream ({len(direct[0])} indices) byte-equal "
              f"to a direct regen, ranks 0 and {world - 1} to the plain law; "
              f"launches {json.dumps(got)}; no cached epoch page-locked; "
              f"cache replays launched {json.dumps(replay)}; set_epoch "
              f"fan-out to epoch 1 on every shard | {card}")
        print(f"time sharding epoch_regen_ms (a shard: kernel + readback, "
              f"host wall) over {len(regen_ms)} regens: p50 "
              f"{pct(regen_ms, 50):.4f} p99 {pct(regen_ms, 99):.4f} ms; a "
              f"direct rank_indices: median {direct_ms:.4f} ms | {card}")
        print(f"time sharding GET_BATCH round trip (lookahead 1, cache "
              f"hit, {SERVE_BATCH} int32): through the router p50 "
              f"{pct(rtt_router, 50):.1f} p99 {pct(rtt_router, 99):.1f} us, "
              f"straight at the shard p50 {pct(rtt_direct, 50):.1f} p99 "
              f"{pct(rtt_direct, 99):.1f} us over {len(rtt_router)} | {card}")
        print(f"time sharding 8 clients together: "
              f"{sum(k for k, _ in rates.values()) / all_s:.1f} batches/s, "
              f"{nbytes * len(SHARD_RANKS) / all_s / 1e6:.1f} MB/s "
              f"({all_s:.3f} s; a client "
              f"{min(k / s for k, s in rates.values()):.1f}-"
              f"{max(k / s for k, s in rates.values()):.1f} batches/s) | "
              f"{card}")

        # ---- (b) the cross-shard reshard 256 -> 192 a third of the way
        epoch = 1
        ref1 = {r: c4.rank_indices(epoch, r) for r in range(world)}
        ck.reset_launches()
        batch_b = -(-ns // 15)
        third = 5  # batches of ns / 15: a third of the epoch
        delivered = {}
        hit = threading.Barrier(world + 1)
        go = threading.Barrier(world + 1)

        def old_rank(r):
            with ServiceIndexClient(plane.address, rank=r, batch=batch_b,
                                    lookahead=1, timeout=120.0,
                                    backoff_base=0.01,
                                    reconnect_timeout=60.0) as c:
                it = c.epoch_batches(epoch)
                got = [next(it) for _ in range(third)]
                hit.wait(120.0)
                go.wait(120.0)
                got += list(it)
                delivered[r] = np.concatenate(got)

        barrier_err = []

        def run_barrier():
            try:
                plane.router.reshard(new_world)
            except Exception as exc:  # raised below
                barrier_err.append(exc)

        def control():
            hit.wait(120.0)
            bt = threading.Thread(target=run_barrier)
            bt.start()
            deadline = time.monotonic() + 60.0
            while not all(s._reshard is not None for s in plane.shards):
                check(time.monotonic() < deadline and bt.is_alive(),
                      f"the shards never froze: {barrier_err}")
                time.sleep(0.002)
            go.wait(120.0)
            bt.join(120.0)
            check(not bt.is_alive() and not barrier_err,
                  f"the router's barrier failed: {barrier_err}")

        t0 = time.perf_counter()
        run_threads([lambda r=r: old_rank(r) for r in range(world)]
                    + [control])
        reshard_s = time.perf_counter() - t0
        launched_b = take()
        states = [s._state_dict() for s in plane.shards]
        gens = {int(st["generation"]) for st in states}
        layers = {tuple(map(tuple, st["layers"])) for st in states}
        check(gens == {1} and len(layers) == 1,
              f"reshard: generations {gens}, layers {layers}")
        (lay,) = layers
        check(len(lay) == 1 and int(lay[0][0]) == world,
              f"reshard: layers {lay}")
        consumed = int(lay[0][1])
        check(all(s.spec.world == new_world for s in plane.shards)
              and plane.router._map.version == 2,
              "reshard: a shard kept the old world or the map its version")
        freeze = [s.metrics.registry.histogram("barrier_freeze_ms")
                  .report()["p50_ms"] for s in plane.shards]
        drain = [s.metrics.registry.histogram("barrier_drain_ms")
                 .report()["p50_ms"] for s in plane.shards]
        barrier_ms = plane.router.metrics.registry.histogram(
            "shard_barrier_ms").report()["p50_ms"]
        wal = [s.metrics.registry.histogram("wal_fsync_ms").report()
               for s in plane.shards]
        # each old rank's stream to the barrier against the direct regen
        # (four of them also against the plain law), each new rank's
        # remainder against index_positions' plain version
        chain, _rem, ns_el = core.elastic_chain(n, [(world, consumed)],
                                                new_world)
        for r in range(world):
            check(np.array_equal(delivered[r][:consumed],
                                 ref1[r][:consumed]),
                  f"reshard: old rank {r}'s stream to the barrier differs")
            if r in (0, 63, 64, world - 1):
                hold("index_amortized", delivered[r][:consumed],
                     ck.epoch_indices_amortized_ref(
                         n, W, 0, epoch, r, world, ns,
                         device=dev)[:consumed],
                     f"C4 world {world} rank {r} to the barrier")
            if r >= new_world:
                check(len(delivered[r]) == consumed,
                      f"reshard: departed rank {r} took "
                      f"{len(delivered[r])} samples, not {consumed}")
                continue
            hold("index_positions", delivered[r][consumed:],
                 ck.index_positions_ref(
                     n, W, 0, epoch, rank=r, world=new_world,
                     num_samples=ns_el, chain=chain, device=dev),
                 f"C4 world {new_world} rank {r}, the remainder after "
                 f"{world} x {consumed}")
        why = union_exactly_once(
            [delivered[r][:consumed] for r in range(world)],
            [delivered[r][consumed:] for r in range(new_world)],
            [ref1[r] for r in range(world)], n, world, consumed,
            new_world, dev)
        check(why == "", f"reshard C4 {world} -> {new_world}: {why}")
        check(launched_b == {"index_amortized": world,
                             "index_positions": new_world},
              f"reshard: launches {launched_b}")
        del delivered, ref1
        print(f"sharding reshard C4 world {world} -> {new_world} across "
              f"{SHARD_SHARDS} shards (router two-phase barrier) after "
              f"{consumed} of {ns} samples a rank: every rank's stream to "
              f"the barrier equal to its direct regen (ranks 0, 63, 64, "
              f"{world - 1} to the plain law), every new rank's remainder "
              f"to index_positions' plain version (max_abs_err 0), the "
              f"union the epoch exactly once (conftest's law, on the "
              f"card); launches {json.dumps(launched_b)} ({reshard_s:.3f} s, "
              f"transport batch {batch_b}) | {card}")
        print(f"time sharding reshard barrier (router, prepare to commit) "
              f"{barrier_ms:.3f} ms; per shard freeze p50 "
              f"{json.dumps(freeze)} ms, drain p50 {json.dumps(drain)} ms | "
              f"{card}")
    finally:
        plane.stop()

    # ---- (c) split, merge, migrate under live clients; a shard failover
    plane = ShardPlane(c4, SHARD_SHARDS, standby=True,
                       wal_dir=os.path.join(tmp.name, "c"),
                       server_kwargs=skw)
    plane.start()
    steps = ("split", "merge", "migrate", "kill")
    gates = [threading.Barrier(len(SHARD_RANKS) + 1)
             for _ in range(2 * len(steps))]
    streams_c, first_after_kill = {}, {}
    # 10 batches between moves: more than the client's lookahead, so each
    # rank has re-HELLOed its new owner (and learned its standby) before
    # the next move
    per_step = 10
    batch_c = -(-ns // (per_step * (len(steps) + 2)))

    def live_client(r):
        with ServiceIndexClient(plane.address, rank=r, batch=batch_c,
                                spec=c4, backoff_base=0.01,
                                reconnect_timeout=2.0) as c:
            it = c.epoch_batches(0)
            got = []
            for g in range(len(steps)):
                got += [next(it) for _ in range(per_step)]
                gates[2 * g].wait(120.0)
                gates[2 * g + 1].wait(120.0)
            for arr in it:
                got.append(arr)
                if r not in first_after_kill and c.metrics.report()[
                        "counters"].get("failovers", 0):
                    first_after_kill[r] = time.perf_counter()
            streams_c[r] = (np.concatenate(got),
                            c.metrics.report()["counters"])

    moves, maps = {}, [plane.map]

    def conductor():
        for g, step in enumerate(steps):
            gates[2 * g].wait(120.0)
            if step == "split":
                moves[step] = plane.split_shard(0)
            elif step == "merge":
                moves[step] = plane.merge_shards(0, moves["split"]).version
            elif step == "migrate":
                moves[step] = plane.migrate_ranks(1, 2, 1).version
            else:
                victim = plane.map.owner(world // 2)
                primary = plane._server(victim)
                standby = next(s for s in plane.standbys
                               if s.shard_id == victim)
                wait_standby(primary, standby)
                moves[step] = (victim, time.perf_counter())
                primary.kill()
                moves["standby"] = standby
            maps.append(plane.map)
            gates[2 * g + 1].wait(120.0)

    ck.reset_launches()
    t0 = time.perf_counter()
    try:
        run_threads([lambda r=r: live_client(r) for r in SHARD_RANKS]
                    + [conductor])
        map_c = plane.map
        promoted = moves["standby"].role
    finally:
        plane.stop()
    maps_s = time.perf_counter() - t0
    launched_c = take()
    victim, t_kill = moves["kill"]
    check(promoted == "primary", "the shard's standby was not promoted")
    for r in SHARD_RANKS:
        s, counters = streams_c[r]
        check(np.array_equal(s, direct[r]),
              f"map changes: rank {r}'s stream has a gap or a duplicate")
        check(counters.get("degraded_mode", 0) == 0,
              f"map changes: rank {r} degraded: {counters}")
    killed_ranks = [r for r in SHARD_RANKS if map_c.owner(r) == victim]
    check(killed_ranks and all(r in first_after_kill
                               for r in killed_ranks),
          f"failover: ranks {killed_ranks} of shard {victim} never failed "
          f"over ({sorted(first_after_kill)})")
    shard_failover_ms = (min(first_after_kill[r] for r in killed_ranks)
                         - t_kill) * 1e3
    # one launch for each (server, rank) pair the moves made serve: a
    # rank on each owner it had, the killed shard's on its standby
    served_by = ({(m.owner(r), r) for m in maps for r in SHARD_RANKS}
                 | {("standby", r) for r in killed_ranks})
    check(launched_c == {"index_amortized": len(served_by)},
          f"map changes: launches {launched_c}, not one for each of "
          f"{len(served_by)} (server, rank) pairs served")
    print(f"sharding map changes under {len(SHARD_RANKS)} live clients "
          f"(batch {batch_c}, {per_step} batches between moves): "
          f"split_shard(0) -> shard {moves['split']}, merge_shards(0, "
          f"{moves['split']}) -> map v{moves['merge']}, migrate_ranks(1, 2, "
          f"1) -> map v{moves['migrate']}, then shard {victim}'s primary "
          f"killed under its standby: every stream bit-identical to its "
          f"direct regen, no gap, no duplicate, no degraded entry; "
          f"launches {json.dumps(launched_c)} (a rank again on each new "
          f"owner) ({maps_s:.3f} s) | {card}")
    print(f"time sharding shard failover, the kill to the first batch the "
          f"promoted standby serves: {shard_failover_ms:.1f} ms (ranks "
          f"{killed_ranks}, reconnect_timeout 2.0 s, feed timeout 0.25 s) | "
          f"{card}")

    # ---- (d) M1 and W1 attached as tenants across the shards
    # M1's sources (scaled with n: M1 itself at n = 1e9)
    sizes_m1 = list(M1_SOURCES)
    mspec = pt.MixtureSpec(sizes_m1, M1_WEIGHTS, windows=W)
    m1 = pt.PartialShuffleSpec.mixture(mspec, world=world)
    w1 = pt.SamplingSpec.weighted(sizes_m1, W1_WEIGHTS,
                                  weight_kind="per_sample",
                                  epoch_samples=n, window=W, world=world)
    tenants = (("M1", m1, "mixture_fused"), ("W1", w1, "weighted_stream"))
    ranks_d = (0, world - 1)
    got_d = {}
    ck.reset_launches()
    with ShardPlane(c4, SHARD_SHARDS, multi_tenant=True,
                    server_kwargs=skw) as tplane:
        attached = {label: tplane.router.attach_tenant(spec)
                    for label, spec, _ in tenants}

        def tenant_client(label, spec, r):
            with ServiceIndexClient(tplane.address, rank=r,
                                    batch=TENANT_BATCH, spec=spec) as c:
                got_d[label, r] = c.epoch_indices(0)

        t0 = time.perf_counter()
        run_threads([lambda a=a, s=s, r=r: tenant_client(a, s, r)
                     for a, s, _ in tenants for r in ranks_d])
        tenants_s = time.perf_counter() - t0
        launched_d = take()
    for label, spec, _ in tenants:
        check(attached[label] == list(range(SHARD_SHARDS)),
              f"tenant {label} attached on shards {attached[label]}")
        for r in ranks_d:
            check(np.array_equal(got_d[label, r], spec.rank_indices(0, r)),
                  f"tenant {label} rank {r} differs from its direct regen")
    ck.reset_launches()  # the references' launches are not the path's
    _t, ns_m1, total_m1 = M.mixture_epoch_sizes(mspec, None, world, False)
    table_w1 = A.build_alias_table(W1_WEIGHTS, "per_sample", sizes_m1)
    for r in ranks_d:
        hold("mixture_fused", got_d["M1", r], ck.mixture_fused_ref(
            None, mspec, 0, 0, rank=r, world=world, num_samples=ns_m1,
            wide_pos=total_m1 + mspec.block > core.INT32_MAX, device=dev),
             f"tenant M1 world {world} rank {r} across the shards")
        hold("weighted_stream", got_d["W1", r], ck.weighted_stream_ref(
            table_w1, sizes_m1, 0, 0, epoch_samples=n, rank=r, world=world,
            num_samples=w1.num_samples(), window=W, device=dev),
             f"tenant W1 world {world} rank {r} across the shards")
    check(launched_d == {k: len(ranks_d) for _, _, k in tenants},
          f"tenants: launches {launched_d}")
    # the weighted line against the uniform one (fleetsim's multiplier)
    w_ms = float(np.median([timed_ms(lambda: w1.rank_indices(0, 5))
                            for _ in range(7)]))
    u_ms = float(np.median([timed_ms(lambda: c4.rank_indices(0, 5))
                            for _ in range(7)]))
    ck.reset_launches()
    print(f"sharding tenants M1 and W1 attached on shards "
          f"{attached['M1']} / {attached['W1']}, ranks {ranks_d} each, "
          f"batch {TENANT_BATCH}: streams equal to the direct regens and to "
          f"mixture_fused's and weighted_stream's plain versions "
          f"(max_abs_err 0); launches {json.dumps(launched_d)} "
          f"({tenants_s:.3f} s) | {card}")
    print(f"time sharding direct regen, W1 {w_ms:.4f} ms against C4 "
          f"{u_ms:.4f} ms median (kernel + readback, world {world}) | "
          f"{card}")

    # ---- (e) federation: two cells, a cell failover, capabilities, and
    # a live tenant migration
    fed_root = "chip-smoke-federation-root"
    got_e, first_e = {}, {}
    streamed = threading.Barrier(len(FED_RANKS) + 1)
    killed = threading.Barrier(len(FED_RANKS) + 1)
    ck.reset_launches()
    real_recv = P._recv_exact
    main_thread = threading.current_thread()
    wire = {"bytes": 0, "index": 0}

    def counting_recv(sock, k):
        if threading.current_thread() is main_thread:
            wire["bytes"] += k
        return real_recv(sock, k)

    real_msg = P.recv_msg

    def counting_msg(sock, **kw):
        msg, header, payload = real_msg(sock, **kw)
        if threading.current_thread() is main_thread \
                and msg == P.MSG_BATCH:
            wire["index"] += len(payload)
        return msg, header, payload

    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with Federation(c4, root=os.path.join(tmp.name, "e"), home="east",
                        dr="west", n_shards=2, capability_root=fed_root,
                        repl_feed_timeout=0.25,
                        server_kwargs=dict(max_inflight=16)) as fed:
            check(fed.wait_synced(30.0), "the federation never synced")
            # capability mode through the trust bundle, before the kill
            P._recv_exact, P.recv_msg = counting_recv, counting_msg
            try:
                with ServiceIndexClient(fed.address, rank=FED_CAP_RANK,
                                        batch=SERVE_BATCH, spec=c4,
                                        capability_secret=fed.trust) as c:
                    cap = c._fetch_capability(0, c4)
                    cap_stream = c.capability_epoch_indices(0)
            finally:
                P._recv_exact, P.recv_msg = real_recv, real_msg
            cap_launched = take()
            check(verify_capability(fed.trust, cap)
                  and (cap.cell, cap.kid) == ("east", 1),
                  f"the grant is not east's kid 1: {cap.cell}/{cap.kid}")

            def cell_client(r):
                with ServiceIndexClient(fed.address, rank=r,
                                        batch=batch_c, backoff_base=0.01,
                                        reconnect_timeout=0.5) as c:
                    it = c.epoch_batches(0)
                    got = [next(it) for _ in range(per_step)]
                    streamed.wait(120.0)
                    killed.wait(120.0)
                    for arr in it:
                        got.append(arr)
                        if r not in first_e and c.metrics.report()[
                                "counters"].get("failovers", 0):
                            first_e[r] = time.perf_counter()
                    check(c.cell == "west", f"rank {r} ended in {c.cell}")
                    got_e[r] = np.concatenate(got)

            def dr_drill():
                streamed.wait(120.0)
                check(fed.wait_shipped(30.0), "the WAL tail never shipped")
                first_e["kill"] = time.perf_counter()
                fed.kill_cell("east")
                fed.promote("west", dead="east")
                killed.wait(120.0)

            run_threads([lambda r=r: cell_client(r) for r in FED_RANKS]
                        + [dr_drill])
            fed_counters = fed.metrics.report()["counters"]
        launched_e = take()
    for r in FED_RANKS:
        check(np.array_equal(got_e[r], direct[r]),
              f"cell failover: rank {r}'s stream differs from its direct "
              f"regen")
    check(np.array_equal(cap_stream, c4.rank_indices(0, FED_CAP_RANK)),
          "the federated capability stream differs")
    ck.reset_launches()
    check(wire["index"] == 0,
          f"capability mode moved {wire['index']} index bytes")
    check(fed_counters.get("federation_failovers", 0) == 1,
          f"federation counters {fed_counters}")
    check(all(r in first_e for r in FED_RANKS),
          f"cell failover: ranks {FED_RANKS} never failed over")
    cell_failover_ms = (min(first_e[r] for r in FED_RANKS)
                        - first_e["kill"]) * 1e3
    check(cap_launched == {"index_amortized": 2},
          f"capability: launches {cap_launched}")
    check(launched_e == {"index_amortized": 2 * len(FED_RANKS)},
          f"cell failover: launches {launched_e}")
    # a live tenant migration east -> west under a streaming client
    tenant = tenant_id_for(c4.fingerprint(include_world=False))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        with Federation(c4, root=os.path.join(tmp.name, "e2"),
                        n_shards=2, repl_feed_timeout=0.25,
                        server_kwargs=dict(max_inflight=16)) as fed:
            check(fed.wait_synced(30.0), "the federation never synced")
            with ServiceIndexClient(fed.address, rank=FED_RANKS[0],
                                    batch=batch_c, backoff_base=0.01,
                                    reconnect_timeout=0.5) as c:
                it = c.epoch_batches(0)
                got = [next(it) for _ in range(per_step)]
                t0 = time.perf_counter()
                nd = fed.migrate_tenant(tenant, "west", deadline_s=30.0)
                migrate_ms = (time.perf_counter() - t0) * 1e3
                got += list(it)
                migrated_cell = c.cell
            mig_counters = fed.metrics.report()["counters"]
    launched_m = take()
    check(nd.home(tenant) == "west" and migrated_cell == "west"
          and mig_counters.get("federation_migrations", 0) == 1,
          f"migrate_tenant: home {nd.home(tenant)}, client in "
          f"{migrated_cell}, counters {mig_counters}")
    check(np.array_equal(np.concatenate(got), direct[FED_RANKS[0]]),
          "the migrated stream has a gap or a duplicate")
    check(launched_m == {"index_amortized": 2},
          f"migration: launches {launched_m}")
    print(f"sharding federation east/west, 2 shards a cell, C4 world "
          f"{world}, batch {batch_c}: ranks {FED_RANKS} streamed "
          f"{per_step} batches, east "
          f"killed whole and west promoted, both laddered to west and "
          f"finished bit-identical (launches {json.dumps(launched_e)}: each "
          f"rank on each cell); a TrustBundle capability client (grant "
          f"east/kid 1) regenerated rank {FED_CAP_RANK} on the card, "
          f"launches {json.dumps(cap_launched)} (issuance and the client), "
          f"{wire['bytes']} wire bytes and {wire['index']} index bytes "
          f"received; migrate_tenant east -> west under a live client: "
          f"exactly once, directory v{nd.version}, launches "
          f"{json.dumps(launched_m)} | {card}")
    print(f"time sharding cell failover, the kill to the first batch from "
          f"west: {cell_failover_ms:.1f} ms (reconnect_timeout 0.5 s); "
          f"migrate_tenant {migrate_ms:.1f} ms | {card}")

    # ---- (f) the autopilot against a live plane, at the policy's own
    # thresholds in its predictive mode: a shard whose forecast load
    # passes hot_factor x the mean splits before its regen p99 reaches
    # split_p99_ms
    clock = [100.0]
    cfg_f = PolicyConfig(predictive=True)
    seen = []  # each tick's observation and the policy's state before it

    def observe():
        obs = ap._observe()
        seen.append(copy.deepcopy((obs, ap.policy.state_dict())))
        return obs

    def replay(config):
        """What a fresh policy of ``config`` decides on the last window
        the controller observed."""
        obs, state = copy.deepcopy(seen[-1])
        policy = AutopilotPolicy(config, clock=lambda: clock[0])
        policy.load_state_dict(state)
        return [(d.kind, d.target, d.args) for d in policy.decide(obs)]

    ck.reset_launches()
    with ShardPlane(c4, SHARD_SHARDS, server_kwargs=skw) as aplane:
        ap = Autopilot(plane=aplane, clock=lambda: clock[0], config=cfg_f,
                       observe=observe)
        t0 = time.perf_counter()
        cand = ap._pick_backend(aplane.shards[0])
        probe_s = time.perf_counter() - t0
        ck.reset_launches()  # the probe's regens are not the path's
        clock[0] += 1.0
        ap.tick()  # the baseline window
        # a hotspot: only shard 0's ranks stream epoch 0
        hot = (0, 1)
        c0 = ServiceIndexClient(aplane.address, rank=hot[0],
                                batch=TENANT_BATCH, auto_batch=True)
        try:
            e0 = {hot[0]: np.concatenate(list(c0.epoch_batches(0)))}
            with ServiceIndexClient(aplane.address, rank=hot[1],
                                    batch=TENANT_BATCH) as c:
                e0[hot[1]] = np.concatenate(list(c.epoch_batches(0)))
            clock[0] += 1.0
            decisions = ap.tick()
            c0.heartbeat()
            hint = c0._batch_hint
            aplane.router.set_epoch(1)
            e1 = np.concatenate(list(c0.epoch_batches(1)))
            adopted = c0.batch
        finally:
            c0.close()
        split_map = aplane.map
        lo, hi = split_map.slices[-1]
        after = {}
        for r in (hot[1], lo, hi - 1, world - 1):
            with ServiceIndexClient(aplane.address, rank=r,
                                    batch=TENANT_BATCH) as c:
                after[r] = np.concatenate(list(c.epoch_batches(1)))
        status = ap.status()
    launched_f = take()
    got_f = [(d.kind, d.target, d.args) for d in decisions]
    want_f = replay(cfg_f)
    reactive = replay(dataclasses.replace(cfg_f, predictive=False))
    hot_obs = seen[-1][0]["shards"][0]
    check(cand == "cuda" and ap._backend_gain is not None,
          f"the card probe answered {cand} for {ns} samples a rank")
    check(got_f == want_f, f"the autopilot actuated {got_f}; the policy "
          f"decides {want_f} on the window it observed")
    tunes = [args for kind, _, args in got_f if kind == "tune"]
    check(("split", 0, {}) in got_f and tunes
          and tunes[0].get("batch_hint") == hint == adopted,
          f"the autopilot decided {got_f} under the hotspot; the client "
          f"was hinted {hint} and adopted batch {adopted}")
    check(split_map.n_shards == SHARD_SHARDS + 1,
          f"the split left {split_map.n_shards} shards")
    for r, s in e0.items():
        check(np.array_equal(s, c4.rank_indices(0, r)),
              f"autopilot: rank {r}'s epoch 0 differs")
    check(np.array_equal(e1, c4.rank_indices(1, hot[0])),
          "autopilot: the adopting client's epoch 1 differs")
    for r, s in after.items():
        check(np.array_equal(s, c4.rank_indices(1, r)),
              f"autopilot: rank {r}'s epoch 1 after the split differs")
    ck.reset_launches()
    print(f"sharding autopilot on a live {SHARD_SHARDS}-shard plane at the "
          f"policy's defaults, predictive: the card probe picked {cand} "
          f"for {ns} samples a rank (gain {ap._backend_gain}, "
          f"{probe_s:.2f} s); under a hotspot on ranks {hot} (shard 0 "
          f"served {hot_obs['served']} batches in the window, its regen "
          f"p99 {hot_obs['p99_ms']:.3f} ms against split_p99_ms "
          f"{cfg_f.split_p99_ms}) it decided {json.dumps(got_f)}, what the "
          f"policy decides on that window; the reactive policy would have "
          f"decided {json.dumps(reactive)}; the client adopted batch "
          f"{adopted}, shard 0 split to {split_map.slices}, every epoch-1 "
          f"stream bit-identical; launches {json.dumps(launched_f)}; "
          f"status seq {status['policy']['seq']} | {card}")

    # ---- (g) fleetsim over this phase's calibration
    wal_p50 = float(np.median([h["p50_ms"] for h in wal if h["count"]]
                              or [0.0]))
    wal_p99 = float(np.median([h["p99_ms"] for h in wal if h["count"]]
                              or [0.0]))
    bar = [f + d for f, d in zip(freeze, drain)]
    rtt_ms = [x / 1e3 for x in rtt_router]
    channels = {
        "rpc": [pct(rtt_ms, 50), sigma_of(pct(rtt_ms, 50),
                                          pct(rtt_ms, 99))],
        "regen": [pct(regen_ms, 50), sigma_of(pct(regen_ms, 50),
                                              pct(regen_ms, 99))],
        "wal_fsync": [wal_p50, sigma_of(wal_p50, wal_p99)],
        "barrier": [pct(bar, 50), sigma_of(pct(bar, 50), pct(bar, 99))],
    }
    # the dedup fold's host rate: a small deduped regen on the host, a
    # fresh spec each time (a spec keeps its folded epochs)
    dedup_ms = min(timed_ms(lambda: pt.SamplingSpec.deduped(
        (40_000, 30_000, 26_000), epoch_samples=DEDUP_DRAWS, seed=7,
        window=W, backend="cpu").rank_indices(0, 0)) for _ in range(3))
    model = autotune.cost_model()
    check(model is not None, "autotune.cost_model() found no card")
    regen_cost = dict(model, weighted_rate_mult=w_ms / u_ms,
                      dedup_host_rate_ms=dedup_ms / DEDUP_DRAWS)
    record = {"kind": fs.latency.RECORD_KIND,
              "source": "chip_smoke.py --sharding",
              "device": {"platform": "gpu",
                         "name": card.split(",")[0].strip(),
                         "power_limit": card.split(",")[-1].strip()},
              "channels": channels, "regen_cost": regen_cost}
    cal = fs.Calibration(**{k: tuple(v) for k, v in channels.items()})
    rcm = fs.RegenCostModel(**regen_cost)

    def simulate():
        sim = fs.FleetSim(world=world, n_shards=SHARD_SHARDS, n=n, seed=0,
                          cells=("east", "west"), backend="cuda",
                          workload=fs.workload.hotspot(
                              50.0, hot_lo=0, hot_hi=world // SHARD_SHARDS,
                              factor=8.0, at_s=5.0, ramp_s=5.0),
                          latency=fs.LatencyModel(seed=0, calibration=cal),
                          regen_cost=rcm)
        sim.inject_cell_kill(at_s=20.0)
        return sim.run(40)

    t0 = time.perf_counter()
    sim = simulate()
    sim_s = time.perf_counter() - t0
    again = simulate()
    check(sim.trace.decision_log() == again.trace.decision_log(),
          "fleetsim: one seed gave two decision logs")
    counts = {}
    for d in sim.trace.decisions():
        counts[d["kind"]] = counts.get(d["kind"], 0) + 1
    out = Path(__file__).resolve().parent / "runs"
    out.mkdir(exist_ok=True)
    (out / "fleetsim_calibration.json").write_text(
        json.dumps(record, indent=1, sort_keys=True))
    print(f"fleetsim calibration {json.dumps(record, sort_keys=True)}")
    print(f"sharding fleetsim FleetSim(cells=east/west, world {world}, "
          f"{SHARD_SHARDS} shards, a hotspot, east killed at 20 s) over "
          f"this phase's calibration, 40 ticks in {sim_s:.3f} s: decisions "
          f"{json.dumps(counts, sort_keys=True)}, cell {sim.cell}, shards "
          f"{len(sim.live_shards())}, the decision log equal on a rerun | "
          f"{card}")
    tmp.cleanup()
    print(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return launches21, errs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a GPU")
    if sys.argv[1:2] == ["--gloo-worker"]:
        gloo_worker(int(sys.argv[2]), int(sys.argv[3]))
        return
    if sys.argv[1:2] == ["--regen"]:
        regen_report()
        return
    if sys.argv[1:2] == ["--train"]:
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            cuda_kernel as ck,
        )

        card = nvidia_smi("name,power.limit")
        print(card)
        t0 = time.perf_counter()
        ck.build()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        launches, errs = training_phase(
            card, float(nvidia_smi("clocks.max.sm").split()[0]))
        print(json.dumps({"launches": launches, "errors": errs}))
        return
    if sys.argv[1:2] == ["--capability"]:
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            cuda_kernel as ck,
        )

        card = nvidia_smi("name,power.limit")
        print(card)
        t0 = time.perf_counter()
        ck.build()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        launches, errs = capability_phase(
            card, float(nvidia_smi("clocks.max.sm").split()[0]))
        print(json.dumps({"launches": launches, "errors": errs}))
        return
    if sys.argv[1:2] == ["--service"]:
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            cuda_kernel as ck,
        )

        card = nvidia_smi("name,power.limit")
        print(card)
        t0 = time.perf_counter()
        ck.build()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        launches, errs = service_phase(
            card, float(nvidia_smi("clocks.max.sm").split()[0]))
        print(json.dumps({"launches": launches, "errors": errs}))
        return
    if sys.argv[1:2] == ["--sharding"]:
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            cuda_kernel as ck,
        )

        card = nvidia_smi("name,power.limit")
        print(card)
        t0 = time.perf_counter()
        ck.build()
        print(f"build: {time.perf_counter() - t0:.2f} s")
        launches, errs = sharding_phase(card)
        for name in SLICE13:
            check(launches.get(name, 0) > 0 and errs.get(name) == 0,
                  f"kernel {name} of the slice-13 main path: launches "
                  f"{launches.get(name, 0)}, max_abs_err {errs.get(name)}")
        print(json.dumps({"launches": launches, "errors": errs}))
        return
    if sys.argv[1:2] == ["--sampling"]:
        card = nvidia_smi("name,power.limit")
        print(card)
        res = sampling_phase(card,
                             float(nvidia_smi("clocks.max.sm").split()[0]),
                             tile=sys.argv[2:3] == ["--tile"])
        print(json.dumps(dict(zip(("launches", "rows", "errors"), res))))
        return
    try:
        import partiallyshuffledistributedsampler_tpu_torch as pt
        from partiallyshuffledistributedsampler_tpu_torch import parallel
        from partiallyshuffledistributedsampler_tpu_torch.ops import (
            core,
            cuda_kernel as ck,
            mixture as M,
            shard as SH,
        )
        from partiallyshuffledistributedsampler_tpu_torch.sampler import (
            shard_mode as SM,
        )
    except ImportError as exc:
        fail(f"the package is not importable here ({exc}); run from the "
             "repository root")
    import numpy as np
    import torch.distributed as dist
    from torch.utils.data import BatchSampler, DataLoader, TensorDataset

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

    def gpu_ms(fn, reps):
        return device_ms(fn, reps, max_sm_mhz)

    t0 = time.perf_counter()
    ck.build()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc, sm_90a, "
          f"{len(ck._SOURCES)} sources in parallel)")
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
    for pv, (head8, total) in MIX_GOLDENS.items():
        spec = pt.MixtureSpec([1000, 500, 2500], [5, 1, 4], windows=64,
                              block=100, pattern_version=pv)
        before = ck.launches["mixture_fused"]
        g = pt.mixture_epoch_indices_cuda(spec, 7, 3, 0, 1)
        check(g.is_cuda and ck.launches["mixture_fused"] == before + 1,
              "the mixture golden did not run the mixture kernel")
        print(f"mixture golden v{pv}: {g[:8].tolist()} sum "
              f"{int(g.long().sum())}")
        check(g[:8].tolist() == head8 and int(g.long().sum()) == total,
              f"mixture golden v{pv} differs")

    # ---------------------------------------------------------------- 3
    def hold(name, got, want, label):
        equal = torch.equal(got.long(), want.long())
        err = int((got.long() - want.long()).abs().max().item())
        stats[name]["err"] = max(stats[name]["err"], err)
        print(f"check {name} {label}: lanes={got.numel()} equal={equal} "
              f"max_abs_err={err} (tolerance 0: the law is integer-exact)")
        check(equal and got.shape == want.shape,
              f"{name} {label} differs from its plain version")

    ns256, _ = core.shard_sizes(N_C4, 256, False)
    for epoch in (0, 1):
        for rank in (0, 255):
            got = ck.index_amortized(N_C4, W, 0, epoch, rank, 256)
            hold("index_amortized", got, ck.epoch_indices_amortized_ref(
                N_C4, W, 0, epoch, rank, 256, ns256, device=dev),
                 f"n=1e9 W=8192 world=256 rank={rank} epoch={epoch} (all "
                 f"{ns256} lanes; window order in the kernel)")
            general = ck.index_general(N_C4, W, 0, epoch, rank, 256,
                                       device=dev)
            hold("index_general", general,
                 ck.index_general_ref(N_C4, W, 0, epoch, rank, 256,
                                      device=dev),
                 f"n=1e9 W=8192 world=256 rank={rank} epoch={epoch} "
                 "(amortize=False shape)")
            hold("index_amortized", got, general,
                 f"n=1e9 W=8192 world=256 rank={rank} epoch={epoch} against "
                 "the general kernel")
    ns8, _ = core.shard_sizes(N_C4, 8, False)
    got = ck.index_amortized(N_C4, W, 0, 1, 3, 8)
    hold("index_amortized", got, ck.epoch_indices_amortized_ref(
        N_C4, W, 0, 1, 3, 8, ns8, device=dev),
         "n=1e9 W=8192 world=8 rank=3 epoch=1 (all 125M lanes)")
    hold("index_amortized", got, ck.index_general(N_C4, W, 0, 1, 3, 8),
         "n=1e9 W=8192 world=8 rank=3 epoch=1 against the general kernel")
    for rank in range(8):
        kw = dict(partition="blocked", device=dev)
        hold("index_general",
             ck.index_general(N_IMAGENET, W, 0, 1, rank, 8, **kw),
             ck.index_general_ref(N_IMAGENET, W, 0, 1, rank, 8, **kw),
             f"ImageNet n=1281167 W=8192 world=8 blocked rank={rank}")
    del got, general
    torch.cuda.empty_cache()

    # --------------------------------------------- 3b: n >= 2^31 (wide)
    def triple_of(seed, epoch):
        bits = np.array(core.seed_triple(seed, epoch), dtype=np.uint32)
        return torch.from_numpy(bits.view(np.int32)).to(dev)

    def routed(name, fn, dtype=torch.int64):
        """Run ``fn`` and check it launched kernel ``name`` once and no
        other kernel: a regen is one launch."""
        before, total = ck.launches[name], sum(ck.launches.values())
        out = fn()
        check(ck.launches[name] == before + 1
              and sum(ck.launches.values()) == total + 1,
              f"{name} was not launched alone, once")
        check(out.is_cuda and out.dtype == dtype,
              f"{name} output is not CUDA {dtype}")
        return out

    ns256, _ = core.shard_sizes(N_LLAMA, 256, False)
    for rank in (0, 255):
        got = routed("index_amortized_wide", lambda: pt.epoch_indices_cuda(
            N_LLAMA, W, 0, 1, rank, 256))
        hold("index_amortized_wide", got,
             ck.epoch_indices_amortized_ref(N_LLAMA, W, 0, 1, rank, 256,
                                            ns256, device=dev),
             f"n=1e10 W=8192 world=256 rank={rank} (all {ns256} lanes; "
             "window order in the kernel)")
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
        general = ck.index_general_wide if wide else ck.index_general
        amortized = ck.index_amortized_wide if wide else ck.index_amortized
        name = "_wide" if wide else ""
        want = general(n, W, 0x1_0000_0007, 3, rank, world)
        hold("index_general" + name,
             general(n, W, None, None, rank, world, triple=t), want,
             f"n={n:.0e} world={world} device triple")
        hold("index_amortized" + name,
             amortized(n, W, None, None, rank, world, triple=t), want,
             f"n={n:.0e} world={world} device triple against the general "
             "kernel's scalar launch")
    del got, want
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
         core.stream_indices_at_generic(3 + 8 * lanes, N_LLAMA, W, 0, 1),
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
         core.stream_indices_at_generic(lanes, N_2_32, W, 0, 1),
         f"n=2^32+4097 W=8192 world=1: lanes {lanes.tolist()} against the "
         "plain random-access law")
    del out
    torch.cuda.empty_cache()

    # random access at 10B on the card, against the plain law on the host
    probes = np.random.default_rng(1).integers(0, 2 * N_LLAMA, 4096)
    got = routed("index_positions_wide", lambda: pt.stream_indices_at_cuda(
        probes, N_LLAMA, W, 0, 1))
    want = pt.stream_indices_at_cpu(probes, N_LLAMA, W, 0, 1)
    ok = torch.equal(got.cpu(), want) and int(got.max()) > 2**31
    print(f"stream_indices_at_cuda n=1e10: 4096 probes on the card, int64, "
          f"max {int(got.max())}, equal to the host law: {ok}")
    check(ok, "random access at n=1e10 differs from the plain law")

    # ------------------------------------ 3c: the mixture kernels (§8)
    m1 = pt.MixtureSpec(M1_SOURCES, M1_WEIGHTS, windows=W)
    m3 = pt.MixtureSpec(M3_SOURCES, M3_WEIGHTS, windows=W)
    s300 = pt.MixtureSpec([2_000_000 + 17_000 * i for i in range(300)],
                          [1 + i % 13 for i in range(300)], windows=W,
                          block=4096)

    def mix_sizes(spec, es, world):
        """(num_samples, uint64 positions?) of a mixture epoch."""
        _t, ns, total = M.mixture_epoch_sizes(spec, es, world, False)
        return ns, total + spec.block > core.INT32_MAX

    def mix_lanes(spec, es, world, rank, seed=0, epoch=1):
        """Lanes of this rank's mixture stream that are body lanes of
        their source (two bijections) or tail lanes (one), the lanes in or
        near a source's tail window, and the law's 64-bit splits (the j
        split where n_s or j reaches 2^32, the window split of a body lane
        where u does): this run's data, by the plain law on the card, in
        chunks."""
        ns, wide = mix_sizes(spec, es, world)
        n_s = torch.tensor(spec.sources, device=dev)
        body_s = torch.tensor([(n // w) * w for n, w in zip(spec.sources,
                                                            spec.windows)],
                              device=dev)
        tail, split, near = 0, 0, []
        for c0 in range(0, ns, 25_000_000):
            t = torch.arange(c0, min(ns, c0 + 25_000_000), device=dev)
            s, pas, u = M.lane_draws(rank + world * t, spec, seed, epoch,
                                     wide=wide)
            d = u - body_s[s]
            tail += int((d >= 0).sum())
            near.append(t[d >= -64])
            split += int(((n_s[s] >= 2**32) | (pas * n_s[s] + u >= 2**32))
                         .sum()) + int(((d < 0) & (u >= 2**32)).sum())
        return ns - tail, tail, torch.cat(near), split

    def mix_fused(spec, rank, world, es=None, seed=0, epoch=1, **kw):
        """The mixture kernel's output for a rank, and its plain version
        on the same inputs."""
        ns, wide = mix_sizes(spec, es, world)
        args = dict(rank=rank, world=world, num_samples=ns, wide_pos=wide,
                    **kw)
        keys = ck.mixture_source_keys(spec, seed, epoch)
        return (ck.mixture_fused(keys, spec, seed, epoch, **args),
                ck.mixture_fused_ref(keys, spec, seed, epoch, **args))

    for spec, label in ((m1, "M1"), (m3, "M3"), (s300, "S=300")):
        hold("mixture_source_keys", ck.mixture_source_keys(spec, 0, 1),
             ck.mixture_source_keys_ref(spec, 0, 1, device=dev),
             f"{label}: {spec.num_sources} sources, 24 rounds")
    t = triple_of(0x1_0000_0007, 3)
    hold("mixture_source_keys", ck.mixture_source_keys(m1, None, None,
                                                       triple=t),
         ck.mixture_source_keys(m1, 0x1_0000_0007, 3),
         "M1 device triple against scalars")
    for world, ranks in ((256, (0, 255)), (32, (5,))):
        for rank in ranks:
            got, want = mix_fused(m1, rank, world)
            hold("mixture_fused", got, want,
                 f"M1 world={world} rank={rank} (all {got.numel()} lanes)")
    for label, spec, kw in (
            ("blocked", m1, dict(partition="blocked")),
            ("shuffle=False", m1, dict(shuffle=False)),
            ("pattern_version=1", pt.MixtureSpec(
                M1_SOURCES, M1_WEIGHTS, windows=W, pattern_version=1), {})):
        hold("mixture_fused", *mix_fused(spec, 5, 256, **kw),
             f"M1 {label} world=256 rank=5")
    for rank in (0, 255):
        got, want = mix_fused(m1, rank, 256, es=M2_SAMPLES)
        check(got.dtype == torch.int32, "M2 ids are not int32")
        hold("mixture_fused", got, want,
             f"M2 (M1 over 1e10 samples, uint64 positions) world=256 "
             f"rank={rank} (all {got.numel()} lanes)")
        got, want = mix_fused(m3, rank, 256)
        high = int(got.max())
        hold("mixture_fused", got, want,
             f"M3 (6 sources, 1e10 ids, int64) world=256 rank={rank} (all "
             f"{got.numel()} lanes), max id {high}")
        check(got.dtype == torch.int64 and high > 2**31,
              "M3 ids are not int64 past 2^31")
    hold("mixture_fused", *mix_fused(s300, 7, 256),
         "S=300 (keys and source table read from global memory) world=256 "
         "rank=7")
    for spec, label in ((m1, "M1"), (m3, "M3")):
        got = pt.mixture_epoch_indices_cuda(spec, None, None, 5, 256,
                                            triple=t)
        hold("mixture_fused", got,
             pt.mixture_epoch_indices_cuda(spec, 0x1_0000_0007, 3, 5, 256),
             f"{label} world=256 device triple against scalars")
    # fused=False: the masked law's kernel, mixture_fused_wide, once
    ck.reset_launches()
    masked = pt.mixture_epoch_indices_cuda(m1, 0, 1, 5, 256, fused=False)
    ran = {k: v for k, v in ck.launches.items() if v}
    print(f"mixture fused=False route launches {ran}")
    check(ran == {"mixture_fused_wide": 1},
          "the fused=False mixture route did not launch mixture_fused_wide "
          "exactly once")
    ns256, wide256 = mix_sizes(m1, None, 256)
    hold("mixture_fused_wide", masked, pt.mixture_epoch_indices_cuda(
        m1, 0, 1, 5, 256), "M1 fused=False world=256 rank=5 against "
         "mixture_fused")
    hold("mixture_fused_wide", masked, ck.mixture_fused_wide_ref(
        None, m1, 0, 1, rank=5, world=256, num_samples=ns256,
        wide_pos=wide256, device=dev), "M1 fused=False world=256 rank=5 "
         f"(all {ns256} lanes)")
    # a source past 2^31: every lane of a world-4096 rank in the law's
    # variants, and a 12-source spec past the fold (mixture_source_keys
    # first)
    big = pt.MixtureSpec(MASKED_BIG_SOURCES, MASKED_BIG_WEIGHTS, windows=W)
    ns4k, _ = mix_sizes(big, None, 4096)
    for label, spec, kw in (
            ("v2", big, {}), ("blocked", big, dict(partition="blocked")),
            ("shuffle=False", big, dict(shuffle=False)),
            ("order_windows=False", big, dict(order_windows=False)),
            ("pattern_version=1", pt.MixtureSpec(
                MASKED_BIG_SOURCES, MASKED_BIG_WEIGHTS, windows=W,
                pattern_version=1), {})):
        args = dict(rank=7, world=4096, num_samples=ns4k, wide_pos=True,
                    **kw)
        hold("mixture_fused_wide",
             ck.mixture_fused_wide(None, spec, 0, 1, **args),
             ck.mixture_fused_wide_ref(None, spec, 0, 1, device=dev, **args),
             f"3e9/1e9/5e8 {label} world=4096 rank=7 (all {ns4k} lanes)")
    s12 = pt.MixtureSpec([2**31 + 1000 * i for i in range(12)],
                         [1 + i % 5 for i in range(12)], windows=W)
    check(not ck.mixture_folds(s12, 24), "12 wide sources fold their keys")
    ns12, _ = mix_sizes(s12, None, 4096)
    ck.reset_launches()
    got = pt.mixture_epoch_indices_cuda(s12, 0, 1, 7, 4096)
    ran = {k: v for k, v in ck.launches.items() if v}
    check(ran == {"mixture_source_keys": 1, "mixture_fused_wide": 1},
          f"a 12-source wide regen launched {ran}")
    hold("mixture_fused_wide", got, ck.mixture_fused_wide_ref(
        None, s12, 0, 1, rank=7, world=4096, num_samples=ns12, wide_pos=True,
        device=dev), f"12 sources of 2^31+ world=4096 rank=7 (keys buffer "
         f"from mixture_source_keys; all {ns12} lanes)")
    # world 8: 125M lanes, held on >= 1M sampled lanes and every lane in or
    # near a source's tail window, against the plain random-access law
    ns8, _ = mix_sizes(m1, None, 8)
    before = ck.launches["mixture_fused"]
    out = pt.mixture_epoch_indices_cuda(m1, 0, 1, 3, 8)
    check(ck.launches["mixture_fused"] == before + 1, "M1 world 8: no kernel")
    _b, _t, near, _sp = mix_lanes(m1, None, 8, 3)
    lanes = torch.unique(torch.cat([
        torch.from_numpy(np.random.default_rng(2).choice(
            ns8, 1_000_000, replace=False)).to(dev),
        torch.arange(4, device=dev), torch.arange(ns8 - 4, ns8, device=dev),
        near]))
    check(lanes.numel() >= 1_000_000, f"only {lanes.numel()} lanes sampled")
    hold("mixture_fused", out[lanes],
         M.mixture_stream_at_generic(3 + 8 * lanes, m1, 0, 1,
                                     big_positions=False, amortize=False),
         f"M1 world=8 rank=3: {lanes.numel()} of {ns8} lanes (seeded, "
         f"first, last, {near.numel()} in or near a source's tail window) "
         "against the plain random-access law")
    del out, got, want, masked, lanes, near
    torch.cuda.empty_cache()

    # ------------------------------- 3d: the shard kernels (§7, config 4)
    sz1, sz2, sz3, sz4 = shard_corpora()
    print(f"shard corpora: S1 {sz1.size} x {SHARD_M} = {int(sz1.sum())}; "
          f"S2 {sz2.size} log-normal 200..2000, {np.unique(sz2).size} "
          f"distinct sizes, {int(sz2.sum())} samples; S3 {sz3.size} "
          f"heavy-tailed, "
          f"{int(sz3.sum())} samples; S4 {sz4.size} x {int(sz4[0])} = "
          f"{int(sz4.sum())} (int64)")

    def shard_ids(num, world, rank, epoch=1):
        """The rank's shard-id stream, from the index kernels."""
        return pt.epoch_indices_cuda(num, SHARD_W, 0, epoch, rank, world)

    def hold_shard(sizes, sids, wss, label, seed=0, epoch=1, rounds=24):
        """Both shard kernels against their plain versions on the same
        inputs; returns the kernels' expansion.  Sequential mode launches
        no shard_row_keys."""
        tabs = SH.shard_tables(sizes, dev)
        full, w = SH.shuffle_mode(wss)
        rowtab, m_of = ck.shard_row_keys(sids, tabs, seed, epoch,
                                         full=full, w=w, rounds=rounds,
                                         sizes_out=True)
        rowtab_ref, m_ref = ck.shard_row_keys_ref(sids, tabs.dev_sizes, seed,
                                                  epoch, full=full, w=w,
                                                  rounds=rounds)
        hold("shard_row_keys", torch.cat([rowtab.long(), m_of]),
             torch.cat([rowtab_ref.long(), m_ref]),
             f"{label} within_shard_shuffle={wss} rounds={rounds}: "
             f"{sids.numel()} rows")
        before = dict(ck.launches)
        got = SM.expand_shard_indices_cuda(sids, sizes, seed=seed,
                                           epoch=epoch,
                                           within_shard_shuffle=wss,
                                           rounds=rounds)
        check(ck.launches["shard_expand"] == before["shard_expand"] + 1,
              f"{label}: the expansion did not launch shard_expand once")
        check(ck.launches["shard_row_keys"] == before["shard_row_keys"]
              + int(not SH.sequential(full, w)),
              f"{label}: shard_row_keys launches in mode {wss}")
        hold("shard_expand", got, SM.expand_shard_indices_generic(
            sids, sizes, seed=seed, epoch=epoch, within_shard_shuffle=wss,
            rounds=rounds),
             f"{label} within_shard_shuffle={wss} rounds={rounds} (all "
             f"{got.numel()} lanes)")
        return got

    sizes = [5, 0, 7, 3, 4]
    for wss, want in SHARD_GOLDENS.items():
        g = SM.expand_shard_indices_cuda([2, 0, 3], sizes, seed=3, epoch=1,
                                         within_shard_shuffle=wss)
        print(f"shard golden within_shard_shuffle={wss}: {g.tolist()}")
        check(g.is_cuda and g.tolist() == want, "shard golden differs")
    check(SM.shard_seed(3, 2) == 11400714819323198484
          and SM.shard_sample_order(2, 7, seed=3, epoch=1).tolist()
          == [5, 3, 6, 1, 2, 4, 0]
          and list(SM.shuffle_buffer(range(12), 4, seed=5, epoch=0))
          == [3, 4, 1, 5, 0, 6, 8, 2, 11, 9, 10, 7],
          "the host shard goldens differ")
    for wss in (True, SHARD_W, False):
        hold_shard(sz1, shard_ids(SHARDS, 8, 3), wss, "S1 world=8 rank=3")
    hold_shard(sz1, shard_ids(SHARDS, 1, 0), True, "S1 world=1")
    for sizes, label in ((sz2, "S2"), (sz3, "S3")):
        for wss in (True, SHARD_W):
            hold_shard(sizes, shard_ids(SHARDS, 8, 3), wss,
                       f"{label} world=8 rank=3")
    # the tile edges of shard_expand (tiles of at most 4,096 lanes, at most
    # 64 staged rows): S1's rows cut by tile edges and S3's tiles inside one
    # row are above; here rows past the staged budget (3M rows of 0..3
    # lanes), zero-size rows, a partial last tile and, in sequential mode,
    # row starts at every alignment of the 16-byte stores
    rng = np.random.default_rng(6)
    tiny = rng.integers(0, 4, 3_000_000)
    holes = rng.integers(0, 2000, 6000)
    holes[rng.random(6000) < 0.3] = 0
    odd = rng.integers(0, 12, 50_000) * 2 + 1
    odd[::13] = 0
    for sizes, label, modes in (
            (tiny, "3M rows of 0..3 lanes", (True, SHARD_W, 2, False)),
            (holes, "30% zero-size rows", (True, SHARD_W, False)),
            (np.full(12_345, 997), "12,345 x 997 (partial last tile)",
             (True, SHARD_W, False)),
            (odd, "odd sizes (unaligned row starts)", (False, 3))):
        sids = torch.from_numpy(
            rng.permutation(sizes.size).astype(np.int32)).to(dev)
        for wss in modes:
            hold_shard(sizes, sids, wss, f"tile edges, {label}")
    t = triple_of(0x1_0000_0007, 3)
    for sizes, wss, label in ((sz2, True, "S2"), (sz1, SHARD_W, "S1")):
        sids = shard_ids(SHARDS, 8, 5)
        tabs = SH.shard_tables(sizes, dev)
        full, w = SH.shuffle_mode(wss)
        hold("shard_row_keys", ck.shard_row_keys(
            sids, tabs, None, None, full=full, w=w, triple=t)[0],
            ck.shard_row_keys_ref(sids, tabs.dev_sizes, 0x1_0000_0007, 3,
                                  full=full, w=w)[0],
            f"{label} world=8 device triple, against the plain version")
        hold("shard_expand", SM.expand_shard_indices_cuda(
            sids, sizes, seed=None, epoch=None, within_shard_shuffle=wss,
            triple=t), SM.expand_shard_indices_cuda(
            sids, sizes, seed=0x1_0000_0007, epoch=3,
            within_shard_shuffle=wss), f"{label} world=8 device triple")
    # S4: 5e8 int64 lanes at world 8, held on sampled whole rows
    sids = shard_ids(S4_SHARDS, 8, 3)
    tabs = SH.shard_tables(sz4, dev)
    rowtab, _m = ck.shard_row_keys(sids, tabs, 0, 1, full=True, w=0)
    hold("shard_row_keys", rowtab, ck.shard_row_keys_ref(
        sids, tabs.dev_sizes, 0, 1, full=True, w=0)[0],
         f"S4 world=8 rank=3: {sids.numel()} rows")
    out = SM.expand_shard_indices_cuda(sids, sz4, seed=0, epoch=1)
    check(out.dtype == torch.int64 and out.numel() == sids.numel() * S4_M,
          "S4: not int64 lanes of every row")
    pick = torch.from_numpy(np.unique(np.concatenate([
        np.random.default_rng(5).choice(sids.numel(), 1024, replace=False),
        [0, sids.numel() - 1]]))).to(dev)
    hold("shard_expand", out.view(-1, S4_M)[pick].reshape(-1),
         SM.expand_shard_indices_generic(sids[pick], sz4, seed=0, epoch=1),
         f"S4 world=8 rank=3: {pick.numel()} of {sids.numel()} whole rows "
         f"(seeded, first, last), max index {int(out.max())}")
    check(int(out.max()) > 2**31, "S4 indices do not pass 2^31")
    del out, rowtab, sids, t
    torch.cuda.empty_cache()

    # ------------------------ 3e: rounds above 64 in every kernel family
    # 65, SPEC.md §2's ~102 and ~121 at the main paths' shapes, and the
    # limit at a smaller rank share (the plain versions loop over rounds)
    for rounds in (*HIGH_ROUNDS, ck.MAX_ROUNDS):
        at_limit = rounds == ck.MAX_ROUNDS
        world = 4096 if at_limit else 256
        kw = dict(rounds=rounds)
        want = ck.index_general_ref(N_C4, W, 0, 1, 5, world, device=dev,
                                    **kw)
        hold("index_general", ck.index_general(N_C4, W, 0, 1, 5, world, **kw),
             want, f"n=1e9 W=8192 world={world} rounds={rounds}")
        hold("index_amortized",
             ck.index_amortized(N_C4, W, 0, 1, 5, world, **kw), want,
             f"n=1e9 W=8192 world={world} rounds={rounds}")
        want = ck.index_general_wide_ref(N_WIDE1, W, 0, 1, 8191, 8192,
                                         device=dev, **kw)
        hold("index_general_wide",
             ck.index_general_wide(N_WIDE1, W, 0, 1, 8191, 8192, **kw), want,
             f"n=2^31+5000 W=8192 world=8192 rounds={rounds}")
        hold("index_amortized_wide",
             ck.index_amortized_wide(N_WIDE1, W, 0, 1, 8191, 8192, **kw),
             want, f"n=2^31+5000 W=8192 world=8192 rounds={rounds}")
        keys = ck.mixture_source_keys(m1, 0, 1, **kw)
        hold("mixture_source_keys", keys,
             ck.mixture_source_keys_ref(m1, 0, 1, device=dev, **kw),
             f"M1 rounds={rounds} ({keys.numel()} words)")
        ns, wide = mix_sizes(m1, None, world)
        lanes_kw = dict(rank=5, world=world, num_samples=ns, wide_pos=wide,
                        **kw)
        want = ck.mixture_fused_ref(keys, m1, 0, 1, **lanes_kw)
        hold("mixture_fused", ck.mixture_fused(keys, m1, 0, 1, **lanes_kw),
             want, f"M1 world={world} rounds={rounds}, keys given")
        if (ck.mixture_key_words(m1, rounds) + 8 * m1.num_sources
                <= ck.STAGE_WORDS_CAP):  # the kernel can derive them
            hold("mixture_fused", ck.mixture_fused(None, m1, 0, 1,
                                                   **lanes_kw), want,
                 f"M1 world={world} rounds={rounds}, keys derived in the "
                 "kernel")
        sworld = 64 if at_limit else 8
        for wss in (True, SHARD_W, False):
            hold_shard(sz1, shard_ids(SHARDS, sworld, 3), wss,
                       f"S1 world={sworld}", rounds=rounds)
        hold_shard(sz2, shard_ids(SHARDS, sworld, 3), SHARD_W,
                   f"S2 world={sworld}", rounds=rounds)
        del keys, want
        torch.cuda.empty_cache()

    # ------------- 3f: the positions kernels (elastic remainder, access)
    def positions_name(n):
        return "index_positions_wide" if core.is_wide(n) else "index_positions"

    def hold_elastic(n, world, layers, rank, label, partition="strided",
                     **kw):
        """One elastic regen through the entry point, held against the
        plain chain law on the card: one launch, every lane."""
        chain, _rem, ns = core.elastic_chain(n, layers, world)
        name = positions_name(n)
        got = routed(name, lambda: pt.elastic_indices_cuda(
            n, W, 0, 1, rank, world, ns, chain, partition=partition, **kw),
            core.out_dtype(n))
        hold(name, got, ck.index_positions_ref(
            n, W, 0, 1, rank=rank, world=world, num_samples=ns, chain=chain,
            partition=partition, device=dev, **kw),
             f"{label} rank={rank} ({ns} lanes, {len(chain)} layers)")

    for n in (N_C4, N_LLAMA):
        ns128, _ = core.shard_sizes(n, 128, False)
        for rank in (0, 255):
            hold_elastic(n, 256, [(128, ns128 // 2)], rank,
                         f"n={n:.0e} W=8192 world=256 after a reshard "
                         "128 -> 256 half-way")
    # a blocked 3-layer cascade at 1e8, and 64- and 200-layer chains (the
    # layers past 64 are read through the cache, not staged)
    for rank in (0, 47):
        hold_elastic(N_1E8, 48, CASCADE_1E8, rank,
                     f"n=1e8 W=8192 world=48 blocked after {CASCADE_1E8}",
                     partition="blocked")
    for depth, n in ((64, N_1E8), (200, N_1E8), (64, N_LLAMA)):
        layers = deep_layers(n, depth)
        for partition in ("strided", "blocked"):
            hold_elastic(n, 7, layers, 6, f"n={n:.0e} world=7 {partition} "
                         f"{depth}-layer chain", partition=partition)
    for rounds in (*HIGH_ROUNDS, ck.MAX_ROUNDS):
        world = 4096 if rounds == ck.MAX_ROUNDS else 256
        for n in (N_C4, N_WIDE1):
            ns_old, _ = core.shard_sizes(n, world // 2, False)
            hold_elastic(n, world, [(world // 2, ns_old // 2)], world - 1,
                         f"n={n:.0e} world={world} rounds={rounds}",
                         rounds=rounds)
    # random access: 1M int64 positions, a quarter of them negative (taken
    # as their uint64 or low 32 bits, as the reference casts them)
    rng = np.random.default_rng(12)
    probes = torch.from_numpy(np.concatenate([
        rng.integers(-(2**63), 2**63 - 1, 250_000, dtype=np.int64),
        rng.integers(-(2**40), 0, 250_000),
        rng.integers(0, 3 * N_LLAMA, 500_000)])).to(dev)
    for n in (N_LLAMA, N_C4):
        name = positions_name(n)
        got = routed(name, lambda n=n: pt.stream_indices_at_cuda(
            probes, n, W, 0, 1), core.out_dtype(n))
        hold(name, got, ck.index_positions_ref(n, W, 0, 1, positions=probes),
             f"stream_indices_at_cuda n={n:.0e}: {probes.numel()} random "
             "int64 positions, negative ones included")
    fault = pt.stream_indices_at_cuda([-1], 2**31 + 1, W, 0, 0,
                                      shuffle=False).tolist()
    print(f"stream_indices_at_cuda n=2^31+1 p=-1 unshuffled: {fault} "
          "(p is 2^64 - 1 as uint64; (2^64 - 1) mod n = 3)")
    check(fault == [3], "a negative position is not taken as uint64")
    del got, probes
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
    # 5b: the ImageNet sampler resharded 8 -> 16 20,000 samples into epoch
    # 3, every new rank's remainder through a real DataLoader; and the C4
    # iterator's remainder at world 256 after a reshard 128 -> 256
    consumed = 20_000
    seen = []
    for rank in range(8):
        s8 = pt.PartiallyShuffleDistributedSampler(ds, num_replicas=8,
                                                   rank=rank, window=W)
        s8.set_epoch(3)
        seen.append(np.fromiter(itertools.islice(iter(s8), consumed),
                                dtype=np.int64, count=consumed))
    state8 = s8.state_dict()
    check(state8["offset"] == consumed, "the old ranks' offset")
    for rank in range(16):
        r16 = pt.PartiallyShuffleDistributedSampler.reshard_from_state_dict(
            state8, 16, rank)
        seen += [b.numpy() for (b,) in DataLoader(ds, batch_size=256,
                                                   sampler=r16)]
    seen = np.concatenate(seen)
    counts = np.bincount(seen, minlength=N_IMAGENET)
    ok = (counts.min() >= 1
          and int((counts - 1).sum()) == seen.size - N_IMAGENET)
    print(f"sampler reshard 8 -> 16 after {consumed} samples a rank: "
          f"{seen.size} samples (consumed + 16 remainders through a "
          f"DataLoader), every index of [0, {N_IMAGENET}) at least once, "
          f"the repeats exactly the wrap padding: {ok}")
    check(ok, "the resharded sampler's remainder is not exactly-once")
    ns128, _ = core.shard_sizes(N_C4, 128, False)
    el_layers = [(128, ns128 // 2)]
    it_el = pt.DeviceEpochIterator(N_C4, W, 512, seed=0, rank=5, world=256,
                                   prefetch_next_epoch=False)
    el_batches = list(it_el.elastic_epoch(1, el_layers))
    torch.cuda.synchronize()
    launches = dict(ck.launches)
    print(f"kernels (slice-1 main path): {json.dumps(launches)}")
    for name in (*SLICE1, "index_positions"):
        check(launches[name] > 0,
              f"kernel {name} was not launched on the main path")
    chain, _, ns_el = core.elastic_chain(N_C4, el_layers, 256)
    el = torch.cat(el_batches)
    check(all(b.is_cuda and b.dtype == torch.int32 for b in el_batches),
          "elastic batches are not CUDA int32")
    hold("index_positions", el, ck.index_positions_ref(
        N_C4, W, 0, 1, rank=5, world=256, num_samples=ns_el, chain=chain,
        device=dev)[:el.numel()],
         f"DeviceEpochIterator.elastic_epoch n=1e9 world=256 after "
         f"{el_layers}: {len(el_batches)} batches")
    del it_el, el_batches, el

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
    for name in (*SLICE2, "index_positions_wide"):
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
    hold("index_positions_wide", elastic, want[:elastic.numel()].to(dev),
         f"DeviceEpochIterator.elastic_epoch n=1e10 after {layers}, "
         "against the host law")
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
    check(sh_elastic.is_cuda and sh_elastic.dtype == torch.int64,
          "sharded_elastic_indices at n=1e10 is not CUDA int64")
    hold("index_positions_wide", sh_elastic, want.to(dev),
         f"sharded_elastic_indices n=1e10 after {sh_layers} under "
         "set_sync_debug_mode('error') with no error, against the host law")
    del s, it, epochs, blocked, elastic, reseeds, want
    torch.cuda.empty_cache()

    # ------------------------------------------- slice-3 main path
    zero = torch.zeros((), dtype=torch.int64, device=dev)

    def step(c, b):
        return c + b.sum()

    def step_collect(c, b):
        return c + b.sum(), b.sum()

    ck.reset_launches()
    regens = 0
    # 11: the mixture sampler under a real DataLoader, M1 at world 256
    served = {}
    for workers in (0, 2):
        s = pt.PartialShuffleMixtureSampler(M1_SOURCES, M1_WEIGHTS,
                                            num_replicas=256, rank=9,
                                            windows=W)
        s.set_epoch(1)  # the kernels + a pinned non_blocking copy
        regens += 1
        served[workers] = torch.cat(list(DataLoader(
            IdDataset(m1.total_sources_len), batch_size=None,
            sampler=BatchSampler(s, 8192, False), num_workers=workers)))
    # 11b: the 300-source spec through the mixture sampler: its keys are
    # too many to fold, so its regen takes mixture_source_keys first
    s300_sampler = pt.PartialShuffleMixtureSampler(
        list(s300.sources), list(s300.weights), num_replicas=256, rank=9,
        windows=W, block=s300.block)
    s300_sampler.set_epoch(1)
    s300_served = torch.cat(list(DataLoader(
        IdDataset(s300.total_sources_len), batch_size=None,
        sampler=BatchSampler(s300_sampler, 8192, False))))
    regens300 = 1
    # 12: MixtureEpochIterator at M1 / world 256
    it = pt.MixtureEpochIterator(m1, 512, seed=0, rank=5, world=256)
    check(it.steps_per_epoch == 3_906_250 // 512, "steps per epoch")
    batches = list(it.epoch(0))  # regen 0, prefetch 1
    check(all(b.is_cuda and b.dtype == torch.int32 and b.numel() == 512
              for b in batches), "mixture batches are not CUDA int32[512]")
    check(1 in it._cache, "the next mixture epoch was not prefetched")
    it_epoch0 = torch.cat(batches)
    it_run1 = it.run_epoch(1, step, zero)  # from the prefetch; prefetch 2
    before = ck.launches["mixture_fused"]
    it_runs, it_ys = it.run_epochs(3, 2, step_collect, zero, collect=True)
    per_epochs = ck.launches["mixture_fused"] - before
    mix_elastic = torch.cat(list(it.elastic_epoch(2, MIX_LAYERS)))
    regens += 2 + 1 + 2 + 1
    # 13: mixture seed agreement over the NCCL group of one, no host sync
    agreed_kw = dict(mesh=mesh, epoch_samples=MIX_AGREED_SAMPLES)
    parallel.sharded_mixture_indices(m1, 0, 0, **agreed_kw)  # warm-up
    parallel.sharded_mixture_elastic_indices(m1, 0, 0, MIX_AGREED_LAYERS,
                                             mesh=mesh)
    torch.cuda.synchronize()
    mix_reseeds, mix_walls = [], []
    t_all = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for epoch in range(1, 33):
            t = time.perf_counter()
            mix_reseeds.append(parallel.sharded_mixture_indices(
                m1, 0, epoch, **agreed_kw))
            mix_walls.append((time.perf_counter() - t) * 1e3)
        mix_sh_elastic = parallel.sharded_mixture_elastic_indices(
            m1, 0, 1, MIX_AGREED_LAYERS, mesh=mesh)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    mix_all_ms = (time.perf_counter() - t_all) * 1e3
    regens += 2 + 32 + 1
    launches3 = dict(ck.launches)
    print(f"kernels (slice-3 main path): {json.dumps(launches3)}")
    # M1's keys fold into mixture_fused: one launch a regen; the 300-source
    # regen takes both kernels
    check(launches3["mixture_fused"] == regens + regens300,
          f"mixture_fused ran {launches3['mixture_fused']} times for "
          f"{regens + regens300} mixture regens on the slice-3 main path")
    check(launches3["mixture_source_keys"] == regens300,
          f"mixture_source_keys ran {launches3['mixture_source_keys']} "
          f"times: it runs only for the {regens300} 300-source regen")
    for name in INDEX_KERNELS:
        check(launches3[name] == 0,
              f"index kernel {name} ran on the mixture main path")
    check(per_epochs == 2, f"run_epochs launched {per_epochs} regens for 2 "
          "epochs")
    # 14: the single-source runners, C4 1B / 8192 at world 256
    ck.reset_launches()
    it1 = pt.DeviceEpochIterator(N_C4, W, 512, seed=0, rank=5, world=256)
    one_run0 = it1.run_epoch(0, step, zero)  # regen 0, prefetch 1
    one_runs, one_ys = it1.run_epochs(1, 2, step_collect, zero,
                                      collect=True)
    torch.cuda.synchronize()
    launches3b = dict(ck.launches)
    print(f"kernels (single-source runners): {json.dumps(launches3b)}")
    check(launches3b["index_amortized"] == 4
          and sum(launches3b.values()) == 4,
          "the single-source runners did not regenerate once per epoch "
          "through one launch of the amortized kernel")

    # the slice-3 main path's outputs against the law
    whole = it.steps_per_epoch * 512
    ok = all(torch.equal(v.cpu(), served[0].cpu()) for v in served.values())
    want = pt.mixture_epoch_indices_cuda(m1, 0, 1, 9, 256)
    ok = ok and torch.equal(served[0], want.cpu().long())
    shares = np.bincount(m1.decompose(served[0].numpy())[0], minlength=3)
    print(f"mixture sampler M1 world=256 rank=9 through a DataLoader "
          f"(num_workers 0 and 2): {served[0].numel()} ids equal to the "
          f"kernel's; per-source shares {(shares / shares.sum()).round(4)}: "
          f"{ok}; regen timer {s.regen_timer.report()}")
    check(ok, "the mixture sampler's stream differs")
    ok = torch.equal(s300_served, M.mixture_epoch_indices_generic(
        s300, 0, 1, 9, 256, device=dev).cpu().long())
    print(f"mixture sampler, 300 sources, world=256 rank=9 through a "
          f"DataLoader: {s300_served.numel()} ids equal to the plain law "
          f"(mixture_source_keys + mixture_fused): {ok}")
    check(ok, "the 300-source mixture sampler's stream differs")
    epochs = {e: pt.mixture_epoch_indices_cuda(m1, 0, e, 5, 256)
              for e in range(5)}
    ok = (torch.equal(it_epoch0, epochs[0][:whole])
          and torch.equal(epochs[0], M.mixture_epoch_indices_generic(
              m1, 0, 0, 5, 256, device=dev))
          and int(it_run1) == int(epochs[1][:whole].long().sum())
          and int(it_runs) == sum(int(epochs[e][:whole].long().sum())
                                  for e in (3, 4))
          and it_ys.shape == (2, it.steps_per_epoch)
          and torch.equal(it_ys[1], epochs[4][:whole].long().view(
              -1, 512).sum(1)))
    print(f"MixtureEpochIterator M1 world=256: epoch() {len(batches)} CUDA "
          f"int32 views (next epoch prefetched), run_epoch, run_epochs over "
          f"2 epochs ({per_epochs} kernel regens), equal to the law: {ok}")
    check(ok, "MixtureEpochIterator / its runners differ from the law")
    want = M.mixture_elastic_indices_generic(m1, 0, 2, 5, 256, MIX_LAYERS,
                                             device=dev)
    ok = mix_elastic.is_cuda and torch.equal(mix_elastic,
                                             want[:mix_elastic.numel()])
    print(f"MixtureEpochIterator.elastic_epoch M1 after {MIX_LAYERS} (8 -> "
          f"256): {mix_elastic.numel()} ids, equal to the plain law: {ok}")
    check(ok, "the mixture elastic_epoch differs")
    ok = all(torch.equal(r, pt.mixture_epoch_indices_cuda(
        m1, 0, e, 0, 1, epoch_samples=MIX_AGREED_SAMPLES))
        for e, r in enumerate(mix_reseeds, start=1))
    print(f"sharded_mixture_indices M1 over {MIX_AGREED_SAMPLES} samples, "
          f"NCCL group of one: 32 reseeds under set_sync_debug_mode('error') "
          f"with no error, each equal to mixture_epoch_indices_cuda with the "
          f"host seed: {ok}; host wall per reseed median "
          f"{float(np.median(mix_walls)):.4f} ms min {min(mix_walls):.4f} "
          f"ms, 32 reseeds to ready {mix_all_ms:.4f} ms | {card}")
    check(ok, "sharded_mixture_indices differs")
    want = M.mixture_elastic_indices_generic(m1, 0, 1, 0, 1,
                                             MIX_AGREED_LAYERS, device=dev)
    ok = mix_sh_elastic.is_cuda and torch.equal(mix_sh_elastic, want)
    print(f"sharded_mixture_elastic_indices M1 after {MIX_AGREED_LAYERS} "
          f"under set_sync_debug_mode('error') with no error: "
          f"{mix_sh_elastic.numel()} ids, equal to the plain law: {ok}")
    check(ok, "sharded_mixture_elastic_indices differs")
    c4 = {e: pt.epoch_indices_cuda(N_C4, W, 0, e, 5, 256) for e in range(3)}
    ok = (int(one_run0) == int(c4[0][:whole].long().sum())
          and int(one_runs) == sum(int(c4[e][:whole].long().sum())
                                   for e in (1, 2))
          and torch.equal(one_ys[0], c4[1][:whole].long().view(-1, 512)
                          .sum(1)))
    print(f"DeviceEpochIterator C4 1B world=256: run_epoch and run_epochs "
          f"over 2 epochs, one kernel regen per epoch, equal to the law: "
          f"{ok}")
    check(ok, "the single-source runners differ from the law")
    dist.destroy_process_group()
    del (served, it, batches, it_epoch0, epochs, mix_elastic, mix_reseeds,
         mix_sh_elastic, want, it1, c4, s300_served)
    torch.cuda.empty_cache()

    # ------------------------------------------- slice-4 main path
    # 15: PartialShuffleShardSampler under a real DataLoader, S1 at world 8
    # for two epochs, then a reshard 8 -> 16 in epoch 1; the plain versions
    # of the shard kernels are wrapped to count any call
    plain_calls = [0]

    def counted(fn):
        def wrapper(*args, **kwargs):
            plain_calls[0] += 1
            return fn(*args, **kwargs)
        return wrapper

    plain_fns = (SH.shard_row_keys_ref, SH.shard_expand_ref)
    SH.shard_row_keys_ref = ck.shard_row_keys_ref = counted(plain_fns[0])
    SH.shard_expand_ref = ck.shard_expand_ref = counted(plain_fns[1])
    ck.reset_launches()
    expansions = 0
    shard_out, served_ids, remainders = {}, {}, {}
    try:
        for epoch in (0, 1):
            for rank in range(8):
                s = pt.PartialShuffleShardSampler(SHARDS, num_replicas=8,
                                                  rank=rank)
                s.set_epoch(epoch)  # the shard-id regen + its pinned copy
                pending = s._pending
                shard_out[epoch, rank] = s.device_epoch_indices(sz1)
                expansions += 1
                check(s._pending is pending and s._pending_epoch == epoch
                      and s.state_dict()["offset"] == 0,
                      "device_epoch_indices touched the prefetch or the "
                      "consumption counter")
                served_ids[epoch, rank] = torch.cat(list(DataLoader(
                    IdDataset(SHARDS), batch_size=None,
                    sampler=BatchSampler(s, 1024, False),
                    num_workers=2 if rank == 0 else 0)))
                check(s._pending is None,
                      "the DataLoader did not take the set_epoch prefetch")
                if epoch == 1 and rank == 0:
                    state = s.state_dict(consumed=SHARD_CONSUMED)
        for rank in range(16):
            es = pt.PartialShuffleShardSampler.reshard_from_state_dict(
                state, num_replicas=16, rank=rank)
            remainders[rank] = (es.device_epoch_indices(sz1), es)
            expansions += 1
        torch.cuda.synchronize()
    finally:
        SH.shard_row_keys_ref = ck.shard_row_keys_ref = plain_fns[0]
        SH.shard_expand_ref = ck.shard_expand_ref = plain_fns[1]
    launches4 = dict(ck.launches)
    print(f"kernels (slice-4 main path): {json.dumps(launches4)}; "
          f"{expansions} expansions, plain shard versions called "
          f"{plain_calls[0]} times")
    for name in SLICE4:
        check(launches4[name] == expansions,
              f"kernel {name} ran {launches4[name]} times for {expansions} "
              "expansions on the slice-4 main path")
    check(plain_calls[0] == 0, "a plain shard version ran on the main path")
    check(launches4["index_amortized"] > 0,
          "the shard-id regen did not run the index kernels")

    # the slice-4 main path's outputs against the law
    for epoch in (0, 1):
        got = torch.cat([shard_out[epoch, r] for r in range(8)])
        counts = torch.bincount(got.long(), minlength=SHARDS * SHARD_M)
        ok = (got.dtype == torch.int32 and int(counts.min()) == 1
              and int(counts.max()) == 1)
        for rank in range(8):
            want_ids = pt.epoch_indices_cuda(SHARDS, SHARD_W, 0, epoch, rank,
                                             8)
            ok = ok and torch.equal(served_ids[epoch, rank],
                                    want_ids.cpu().long())
            ok = ok and torch.equal(
                shard_out[epoch, rank], SM.expand_shard_indices_generic(
                    served_ids[epoch, rank].to(dev), sz1, seed=0,
                    epoch=epoch))
        print(f"shard sampler S1 world=8 epoch {epoch}: each rank's "
              f"device_epoch_indices ({shard_out[epoch, 0].numel()} int32 "
              f"lanes) equals the plain expansion of the shard ids its "
              f"DataLoader served; the 8 ranks cover [0, 1e8) exactly "
              f"once: {ok}")
        check(ok, f"the slice-4 main path differs in epoch {epoch}")
    consumed = torch.cat([shard_out[1, r][:SHARD_CONSUMED * SHARD_M]
                          for r in range(8)])
    rest = torch.cat([out for out, _es in remainders.values()])
    counts = torch.bincount(torch.cat([consumed, rest]).long(),
                            minlength=SHARDS * SHARD_M)
    ok = int(counts.min()) == 1 and int(counts.max()) == 1
    for out, es in remainders.values():
        ok = ok and torch.equal(out, SM.expand_shard_indices_generic(
            torch.tensor(list(es), device=dev), sz1, seed=0, epoch=1))
    print(f"shard sampler reshard 8 -> 16 after {SHARD_CONSUMED} shards per "
          f"old rank in epoch 1: the 16 remainder expansions "
          f"({rest.numel()} lanes) equal the plain expansion of their shard "
          f"streams, and with the consumed prefix cover [0, 1e8) exactly "
          f"once: {ok}")
    check(ok, "the resharded shard expansion differs")
    del shard_out, served_ids, remainders, consumed, rest, counts, got
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
              and res["mixture_equal"] and res["mixture_elastic_equal"]
              and res["launches"]["index_amortized"] == 1
              and res["launches"]["index_positions"] == 1
              and res["launches"]["mixture_fused"] == 2
              and res["launches"]["mixture_source_keys"] == 0,
              f"gloo rank {res['rank']}: rank 0's seed did not win")
        check(res["rank"] == 0 or (res["own_seed_differs"]
                                   and res["own_mixture_seed_differs"]),
              "rank 1's own seed gives rank 0's row: the check is vacuous")

    # ------------------------------------------- slice-8 main path
    # 16: HostDataLoader over host data on the card (counters reset per
    # regen inside; launches8 sums them)
    launches8 = host_loader_phase(card, max_sm_mhz)
    print(f"kernels (slice-8 main path): {json.dumps(launches8)}")
    for name in SLICE8:
        check(launches8[name] > 0,
              f"kernel {name} was not launched on the slice-8 main path")

    # ------------------------------------------- slice-9 main path
    # 17: SamplingSpec on the card (launches counted per regen inside;
    # launches9 sums them)
    launches9, rows9, errs9 = sampling_phase(card, max_sm_mhz)
    print(f"kernels (slice-9 main path): {json.dumps(launches9)}")
    for name in SLICE9:
        check(launches9[name] > 0,
              f"kernel {name} was not launched on the slice-9 main path")
        stats[name]["err"] = max(stats[name]["err"], errs9[name])

    # ------------------------------------------- slice-10 main path
    # 18: the consumer layer (counters reset per run inside; launches10
    # sums them)
    launches10, errs10 = training_phase(card, max_sm_mhz)
    print(f"kernels (slice-10 main path): {json.dumps(launches10)}")
    for name in SLICE10:
        check(launches10[name] > 0,
              f"kernel {name} was not launched on the slice-10 main path")
        stats[name]["err"] = max(stats[name]["err"], errs10[name])

    # ------------------------------------------- slice-11 main path
    # 19: capabilities and the trail replay on the card, then the control
    # plane (launches counted per replay inside; launches19 sums them)
    launches19, errs19 = capability_phase(card, max_sm_mhz)
    print(f"kernels (slice-11 main path): {json.dumps(launches19)}")
    for name in SLICE11:
        check(launches19[name] > 0,
              f"kernel {name} was not launched on the slice-11 main path")
        stats[name]["err"] = max(stats[name]["err"], errs19[name])

    # ------------------------------------------- slice-12 main path
    # 20: the index service on the card (counters reset around each
    # case's servers and clients inside; launches20 sums them)
    launches20, errs20 = service_phase(card, max_sm_mhz)
    print(f"kernels (slice-12 main path): {json.dumps(launches20)}")
    for name in SLICE12:
        check(launches20[name] > 0,
              f"kernel {name} was not launched on the slice-12 main path")
        check(name in errs20, f"kernel {name} of the slice-12 main path "
              f"was not held against its plain version")
        stats[name]["err"] = max(stats[name]["err"], errs20[name])

    # ------------------------------------------- slice-13 main path
    # 21: the sharded plane, federation and the autopilot on the card
    # (counters reset around each case inside; launches21 sums them)
    launches21, errs21 = sharding_phase(card)
    print(f"kernels (slice-13 main path): {json.dumps(launches21)}")
    for name in SLICE13:
        check(launches21[name] > 0,
              f"kernel {name} was not launched on the slice-13 main path")
        check(name in errs21, f"kernel {name} of the slice-13 main path "
              f"was not held against its plain version")
        stats[name]["err"] = max(stats[name]["err"], errs21[name])

    # ------------------------------------------- slice-15 main path
    # 22: mixtures with a source past 2^31, and fused=False, through the
    # entry points: one mixture_fused_wide launch a regen (the keys of
    # S = 3 fold), no host sync but random access's read of its positions
    ns_big, _ = mix_sizes(big, None, 256)
    ns_big8, _ = mix_sizes(big, None, 8)
    layers15 = [(128, mix_sizes(big, None, 128)[0] // 2)]
    rand15 = torch.from_numpy(np.random.default_rng(15).integers(
        -2**40, 2**40, 1_000_000)).to(dev)
    t15 = triple_of(0, 1)
    for spec in (big, m1):  # the tables go to the card before the run
        ck.mixture_tables(spec, dev)
    torch.cuda.synchronize()
    ck.reset_launches()
    t_all = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        w256 = pt.mixture_epoch_indices_cuda(big, 0, 1, 5, 256)
        w8 = pt.mixture_epoch_indices_cuda(big, 0, 1, 3, 8)
        rest15 = pt.mixture_elastic_indices_cuda(big, 0, 1, 5, 256, layers15)
        tri15 = pt.mixture_epoch_indices_cuda(big, None, None, 5, 256,
                                              triple=t15)
        m1_masked = pt.mixture_epoch_indices_cuda(m1, 0, 1, 5, 256,
                                                  fused=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    rand_ids = pt.mixture_stream_at_cuda(rand15, big, 0, 1)
    torch.cuda.synchronize()
    wall15 = (time.perf_counter() - t_all) * 1e3
    launches15 = dict(ck.launches)
    print(f"kernels (slice-15 main path): {json.dumps(launches15)}; "
          f"6 regens in {wall15:.1f} ms host wall")
    check(launches15["mixture_fused_wide"] == 6
          and sum(launches15.values()) == 6,
          "the slice-15 main path did not launch mixture_fused_wide once "
          "a regen and nothing else")
    check(w256.dtype == torch.int64 and w256.numel() == ns_big
          and w8.numel() == ns_big8 == 562_500_000,
          f"3e9/1e9/5e8 regens: {w256.dtype} {w256.numel()} lanes at world "
          f"256, {w8.numel()} at world 8")
    hold("mixture_fused_wide", w256, ck.mixture_fused_wide_ref(
        None, big, 0, 1, rank=5, world=256, num_samples=ns_big, wide_pos=True,
        device=dev), f"3e9/1e9/5e8 world=256 rank=5 (all {ns_big} lanes)")
    hold("mixture_fused_wide", tri15, w256,
         "3e9/1e9/5e8 world=256 device triple against scalars")
    body8, tail8, near8, split8 = mix_lanes(big, None, 8, 3)
    lanes8 = torch.unique(torch.cat([
        torch.from_numpy(np.random.default_rng(8).choice(
            ns_big8, 1_000_000, replace=False)).to(dev),
        torch.arange(4, device=dev),
        torch.arange(ns_big8 - 4, ns_big8, device=dev), near8]))
    hold("mixture_fused_wide", w8[lanes8], M.mixture_stream_at_generic(
        3 + 8 * lanes8, big, 0, 1, big_positions=True, amortize=False,
        fused=False), f"3e9/1e9/5e8 world=8 rank=3: {lanes8.numel()} of "
         f"{ns_big8} lanes (seeded, first, last, {near8.numel()} in or near "
         "a source's tail window) against the plain random-access law")
    hold("mixture_fused_wide", rest15, M.mixture_elastic_indices_generic(
        big, 0, 1, 5, 256, layers15, amortize=False, fused=False,
        device=dev), f"3e9/1e9/5e8 world=256 rank=5 remainder after "
         f"{layers15}")
    hold("mixture_fused_wide", rand_ids, M.mixture_stream_at_generic(
        rand15, big, 0, 1, amortize=False, fused=False),
         "3e9/1e9/5e8 1M random int64 positions (negative ones as uint64)")
    hold("mixture_fused_wide", m1_masked, ck.mixture_fused_wide_ref(
        None, m1, 0, 1, rank=5, world=256, num_samples=mix_sizes(
            m1, None, 256)[0], wide_pos=False, device=dev),
         "M1 fused=False world=256 rank=5")
    del w256, w8, rest15, tri15, m1_masked, rand_ids, lanes8, near8
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 6
    floor_ms = launch_floor_ms(max_sm_mhz)
    print(f"launch floor (empty kernel, back to back): {floor_ms:.4f} ms | "
          f"{card}")

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
    rows = {}
    timings = []
    # the amortized kernels: one inner bijection per body lane, the general
    # law on the rest, and the window order's nw outer bijections
    for world, rank in ((256, 5), (8, 3)):
        ns, _ = core.shard_sizes(N_C4, world, False)
        body = nw * (W // world)
        rest_body, rest_tail = lane_classes(N_C4, world, rank, first=body)
        timings.append((
            "index_amortized", f"n=1e9 W=8192 world={world}",
            lambda w=world, r=rank: ck.index_amortized(N_C4, W, 0, 1, r, w),
            lambda w=world, r=rank, ns=ns: ck.epoch_indices_amortized_ref(
                N_C4, W, 0, 1, r, w, ns, device=dev),
            body * (son + INNER_KEY_OPS + POS_OPS)
            + rest_body * (2 * son + INNER_KEY_OPS + POS_OPS)
            + rest_tail * (son + POS_OPS) + nw * son,
            ns * 4,
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
    for world, rank in ((256, 5), (8, 3)):
        ns, _ = core.shard_sizes(N_LLAMA, world, False)
        body = nwl * (W // world)
        rest_body, rest_tail = lane_classes(N_LLAMA, world, rank, first=body)
        timings.append((
            "index_amortized_wide", f"n=1e10 W=8192 world={world}",
            lambda w=world, r=rank: ck.index_amortized_wide(
                N_LLAMA, W, 0, 1, r, w),
            # the plain version at world 8 needs ~60 GB of temporaries
            None if world == 8 else
            lambda w=world, r=rank, ns=ns: ck.epoch_indices_amortized_ref(
                N_LLAMA, W, 0, 1, r, w, ns, device=dev),
            body * (son + INNER_KEY_OPS + POS_OPS + 1)
            + rest_body * (2 * son + INNER_KEY_OPS + POS_OPS + WIDE_OPS)
            + rest_tail * (son + POS_OPS + WIDE_OPS) + nwl * son,
            ns * 8,
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
              f"{nbytes / 1e6:.1f} MB), {b_ms / ms:.1%} of bound, launch "
              f"floor {floor_ms:.4f} ms | {card}")
        rows.setdefault(name, (ms, plain, b_ms, b_by))
    torch.cuda.empty_cache()
    for n, world in ((N_C4, 256), (N_C4, 8), (N_LLAMA, 256), (N_LLAMA, 8)):
        fn = lambda n=n, w=world: pt.epoch_indices_cuda(n, W, 0, 1, 5 % w, w)
        dev_ms = gpu_ms(fn, 20 if world == 256 else 5)
        walls = host_walls(fn, 20 if world == 256 else 5)
        line = (f"regen per epoch n={n:.0e} W=8192 world={world}: device "
                f"{dev_ms:.4f} ms (1 launch), host wall to ready "
                f"median {float(np.median(walls)):.4f} ms min "
                f"{min(walls):.4f} ms")
        if world == 256:
            t3 = triple_of(0, 1)
            tri_ms = gpu_ms(lambda n=n: pt.epoch_indices_cuda(
                n, W, None, None, 5, 256, triple=t3), 20)
            line += f", device triple {tri_ms:.4f} ms"
        print(f"{line} | {card}")
    torch.cuda.empty_cache()
    # the elastic remainder regen (index_positions) beside the kernel regen
    # of the same shape: 1B and 10B, world 256, after one reshard 128 ->
    # 256 half-way through the epoch; the same timers as the regens, and
    # the plain chain law on the card
    def positions_lanes(p, n):
        """Lanes whose position (mod n) is in a full window (two
        bijections), and the rest (the tail window: one)."""
        body = int((p % n < (n // W) * W).sum().item())
        return body, p.numel() - body

    for n in (N_C4, N_LLAMA):
        wide = core.is_wide(n)
        name = positions_name(n)
        ns128, _ = core.shard_sizes(n, 128, False)
        layers_el = [(128, ns128 // 2)]
        chain, rem, ns_el = core.elastic_chain(n, layers_el, 256)
        it_el = pt.DeviceEpochIterator(n, W, 512, seed=0, rank=5, world=256,
                                       prefetch_next_epoch=False)
        regen = gpu_ms(lambda n=n: pt.epoch_indices_cuda(n, W, 0, 1, 5, 256),
                       20)
        regen_lanes, _ = core.shard_sizes(n, 256, False)
        kernel_ms = None
        for label, fn, reps in (
                ("elastic_indices_cuda", lambda n=n, c=chain, k=ns_el:
                 pt.elastic_indices_cuda(n, W, 0, 1, 5, 256, k, c), 20),
                ("DeviceEpochIterator.elastic_epoch_array",
                 lambda it=it_el, ly=layers_el: it.elastic_epoch_array(1, ly),
                 20),
                ("plain chain law (index_positions_ref)",
                 lambda n=n, c=chain, k=ns_el: ck.index_positions_ref(
                     n, W, 0, 1, rank=5, world=256, num_samples=k, chain=c,
                     device=dev), 3)):
            before = sum(ck.launches.values())
            fn()
            n_launch = sum(ck.launches.values()) - before
            dev_ms = gpu_ms(fn, reps)
            walls = host_walls(fn, reps)
            kernel_ms = dev_ms if kernel_ms is None else kernel_ms
            print(f"elastic regen {label} n={n:.0e} W=8192 world=256 after "
                  f"{layers_el} ({ns_el} lanes, {n_launch} kernel launches): "
                  f"device {dev_ms:.4f} ms, host wall to ready median "
                  f"{float(np.median(walls)):.4f} ms min {min(walls):.4f} ms;"
                  f" kernel regen of the full epoch ({regen_lanes} lanes) "
                  f"{regen:.4f} ms, per lane {dev_ms / ns_el:.3e} against "
                  f"{regen / regen_lanes:.3e} ms, "
                  f"{(dev_ms / ns_el) / (regen / regen_lanes):.2f}x | {card}")
        plain = dev_ms
        q = core.rank_positions(rem, 5, 256, ns_el, "strided", wide, dev)
        body, tail = positions_lanes(
            core.compose_remainder_chain(q, chain, "strided", wide), n)
        chain_ops = (CHAIN_LANE_OPS + STRIDED_LAYER_OPS) * (2 if wide else 1)
        ops = (body * (2 * son + INNER_KEY_OPS + 2) + tail * (son + 2)
               + ns_el * (chain_ops + (WIDE_OPS if wide else 0)))
        nbytes = ns_el * core.out_dtype(n).itemsize + ck.LAYER_WORDS * 8
        b_ms, b_by = bound(ops, nbytes)
        print(f"time {name} n={n:.0e} W=8192 world=256 remainder: kernel "
              f"{kernel_ms:.4f} ms, plain {plain:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}; {ops / 1e9:.3f} G int32 ops over {body} body + "
              f"{tail} tail lanes, {nbytes / 1e6:.1f} MB), "
              f"{b_ms / kernel_ms:.1%} of bound | {card}")
        rows[name] = (kernel_ms, plain, b_ms, b_by)
        del it_el, q
        torch.cuda.empty_cache()
    # random access: 1M int64 positions at 10B, a quarter negative
    rng = np.random.default_rng(12)
    probes = torch.from_numpy(np.concatenate([
        rng.integers(-(2**63), 2**63 - 1, 250_000, dtype=np.int64),
        rng.integers(0, 3 * N_LLAMA, 750_000)])).to(dev)
    ms = gpu_ms(lambda: pt.stream_indices_at_cuda(probes, N_LLAMA, W, 0, 1),
                50)
    plain = gpu_ms(lambda: ck.index_positions_ref(N_LLAMA, W, 0, 1,
                                                  positions=probes), 3)
    body, tail = positions_lanes(
        core.u64_divmod(probes, N_LLAMA)[1], N_LLAMA)
    ops = (body * (2 * son + INNER_KEY_OPS + 2) + tail * (son + 2)
           + probes.numel() * (2 * BUFFER_LANE_OPS + WIDE_OPS))
    b_ms, b_by = bound(ops, probes.numel() * 16)
    print(f"time index_positions_wide stream_indices_at_cuda n=1e10, "
          f"{probes.numel()} random int64 positions: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
          f"{b_ms / ms:.1%} of bound | {card}")
    del probes
    torch.cuda.empty_cache()
    # the three hot kernels at 121 rounds (SPEC.md §2), beside 24
    ns_m1, _ = mix_sizes(m1, None, 256)
    sids121 = pt.epoch_indices_cuda(SHARDS, SHARD_W, 0, 1, 5, 8)
    tabs121 = SH.shard_tables(sz1, dev)
    for rounds in (24, 121):
        rt = ck.shard_row_keys(sids121, tabs121, 0, 1, full=True, w=0,
                               rounds=rounds)[0]
        times = [gpu_ms(fn, 20) for fn in (
            lambda r=rounds: ck.index_amortized(N_C4, W, 0, 1, 5, 256,
                                                rounds=r),
            lambda r=rounds: ck.mixture_fused(None, m1, 0, 1, rank=5,
                                              world=256, num_samples=ns_m1,
                                              wide_pos=False, rounds=r),
            lambda r=rounds, rt=rt: ck.shard_expand(
                rt, sids121, tabs121, None, lanes=sids121.numel() * SHARD_M,
                full=True, w=0, rounds=r))]
        print(f"time at {rounds} rounds: index_amortized 1B/world 256 "
              f"{times[0]:.4f} ms, mixture_fused M1/world 256 {times[1]:.4f} "
              f"ms, shard_expand S1/world 8 full {times[2]:.4f} ms | {card}")
    del sids121, tabs121, rt
    torch.cuda.empty_cache()

    # the mixture kernels: M1 at world 256 / 32 / 8, M2, M3
    def table_bytes(spec, keys_read=True):
        """The kernels' inputs, each read once: pattern, prefix counts,
        source table and (unless the keys are folded) the keys buffer."""
        return 4 * (spec.block * (1 + spec.num_sources)
                    + 8 * spec.num_sources
                    + (ck.mixture_key_words(spec, 24) if keys_read else 0))

    def mix_grid(lanes):
        """Blocks of a mixture_fused launch: one per THREADS lanes, at most
        8 per SM (csrc/law.cuh grid_for)."""
        return min((lanes + 255) // 256, 8 * sms)

    # mixture_source_keys: now only for specs past the fold (300 sources)
    words = ck.mixture_key_words(s300, 24)
    ms = gpu_ms(lambda: ck.mixture_source_keys(s300, 0, 1), 200)
    plain = gpu_ms(lambda: ck.mixture_source_keys_ref(s300, 0, 1,
                                                      device=dev), 20)
    b_ms, b_by = bound(words * KEY_WORD_OPS, words * 4 + 32 * 300)
    print(f"time mixture_source_keys S=300 ({words} words): kernel {ms:.4f} "
          f"ms, plain {plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}), "
          f"{b_ms / ms:.1%} of bound (one launch) | {card}")
    rows["mixture_source_keys"] = (ms, plain, b_ms, b_by)
    son = 24 * ROUND_OPS
    for label, spec, es, world, rank in (
            ("M1 world=256", m1, None, 256, 5), ("M1 world=32", m1, None, 32,
                                                5),
            ("M1 world=8", m1, None, 8, 3),
            ("M2 world=256", m1, M2_SAMPLES, 256, 5),
            ("M3 world=256", m3, None, 256, 5)):
        ns, wide = mix_sizes(spec, es, world)
        body, tail, _near, _split = mix_lanes(spec, es, world, rank)
        lane = MIX_LANE_OPS + (WIDE_OPS if wide else 0)
        staged = ck.mixture_key_words(spec, 24) + 8 * spec.num_sources
        # folded: every block derives the key words (not the table) again
        ops = (body * (lane + BIJ_KEY_OPS + INNER_KEY_OPS + 2 * son)
               + tail * (lane + BIJ_KEY_OPS + son)
               + mix_grid(ns) * ck.mixture_key_words(spec, 24) * KEY_WORD_OPS)
        nbytes = (ns * spec.out_dtype().itemsize
                  + table_bytes(spec, keys_read=False))
        keys = ck.mixture_source_keys(spec, 0, 1)
        kw = dict(rank=rank, world=world, num_samples=ns, wide_pos=wide)
        reps = 5 if world == 8 else 20
        ms = gpu_ms(lambda s=spec, kw=kw: ck.mixture_fused(None, s, 0, 1,
                                                           **kw), reps)
        given = gpu_ms(lambda s=spec, k=keys, kw=kw: ck.mixture_fused(
            k, s, 0, 1, **kw), reps)
        plain = None
        if world != 8:  # world 8's plain version needs ~30 GB of int64
            torch.cuda.reset_peak_memory_stats()
            plain = gpu_ms(lambda s=spec, k=keys, kw=kw: ck.mixture_fused_ref(
                k, s, 0, 1, **kw), 3)
            peak = torch.cuda.max_memory_allocated() / 2**30
        b_ms, b_by = bound(ops, nbytes)
        plain_s = ("not measured" if plain is None
                   else f"{plain:.4f} ms ({peak:.1f} GiB peak)")
        print(f"time mixture_fused {label}: kernel {ms:.4f} ms (keys "
              f"folded, {staged} staged words; {given:.4f} ms reading the "
              f"keys buffer), plain {plain_s}, bound {b_ms:.4f} ms ({b_by}; "
              f"{ops / 1e9:.3f} G int32 ops over {body} body + {tail} tail "
              f"lanes and {mix_grid(ns)} blocks' keys, {nbytes / 1e6:.1f} "
              f"MB), {b_ms / ms:.1%} of bound | {card}")
        rows.setdefault("mixture_fused", (ms, plain, b_ms, b_by))
        del keys
        torch.cuda.empty_cache()
    # the fold threshold: one launch that derives the keys in every block,
    # against mixture_source_keys + mixture_fused, over growing source
    # counts (24 rounds; M1's window and block), at 3.9M lanes (world 256)
    # and 244k (world 4096, one lane per thread)
    for S in (3, 6, 12, 25):
        spec = pt.MixtureSpec([N_C4 // S] * S, [1 + i % 5 for i in range(S)],
                              windows=W)
        staged = ck.mixture_key_words(spec, 24) + 8 * S
        for world in (256, 4096):
            ns, wide = mix_sizes(spec, None, world)
            kw = dict(rank=5, world=world, num_samples=ns, wide_pos=wide)
            one = gpu_ms(lambda s=spec, kw=kw: ck.mixture_fused(
                None, s, 0, 1, **kw), 50)
            two = gpu_ms(lambda s=spec, kw=kw: ck.mixture_fused(
                ck.mixture_source_keys(s, 0, 1), s, 0, 1, **kw), 50)
            print(f"fold S={S} ({staged} staged words) world={world} "
                  f"({ns} lanes): folded {one:.4f} ms, two launches "
                  f"{two:.4f} ms, folded - two {one - two:+.4f} ms | {card}")
    for label, spec, es, world in (("M1", m1, None, 256), ("M1", m1, None, 32),
                                   ("M1", m1, None, 8),
                                   ("M2", m1, M2_SAMPLES, 256),
                                   ("M3", m3, None, 256),
                                   ("S=300", s300, None, 256)):
        fn = lambda s=spec, es=es, w=world: pt.mixture_epoch_indices_cuda(
            s, 0, 1, 5 % w, w, epoch_samples=es)
        before = sum(ck.launches.values())
        fn()
        n_launch = sum(ck.launches.values()) - before
        reps = 5 if world == 8 else 20
        dev_ms = gpu_ms(fn, reps)
        walls = host_walls(fn, reps)
        line = (f"mixture regen per epoch {label} world={world}: device "
                f"{dev_ms:.4f} ms ({n_launch} launches), host wall to ready "
                f"median {float(np.median(walls)):.4f} ms min "
                f"{min(walls):.4f} ms")
        if world == 256:
            t3 = triple_of(0, 1)
            tri_ms = gpu_ms(lambda s=spec, es=es: pt.mixture_epoch_indices_cuda(
                s, None, None, 5, 256, epoch_samples=es, triple=t3), 20)
            line += f", device triple {tri_ms:.4f} ms"
        print(f"{line} | {card}")
    # the masked per-source law: mixture_fused_wide beside its plain
    # version (the masked loop per lane) and beside the masked torch loop
    # that ran on the card before it (S passes, amortized tables), for M1
    # with fused=False, the 3e9/1e9/5e8 mixture at world 256 and the 10B
    # mixture whose web source passes 2^32 (64-bit splits); at world 8
    # (562.5M lanes) the kernel alone, and whether the torch loop fits
    fused_ms = gpu_ms(lambda: pt.mixture_epoch_indices_cuda(m1, 0, 1, 5,
                                                            256), 20)
    m10b = pt.MixtureSpec(MASKED_10B_SOURCES, MASKED_BIG_WEIGHTS, windows=W)
    for label, spec, world, rank, kw in (
            ("M1 fused=False", m1, 256, 5, dict(fused=False)),
            ("3e9/1e9/5e8 at 60/25/15", big, 256, 5, {}),
            ("6e9/2.5e9/1.5e9 at 60/25/15", m10b, 256, 5, {}),
            ("3e9/1e9/5e8 at 60/25/15", big, 8, 3, {})):
        ns, wide = mix_sizes(spec, None, world)
        if world == 8:
            body, tail, split = body8, tail8, split8
        else:
            body, tail, _near, split = mix_lanes(spec, None, world, rank)
        lane = MIX_LANE_OPS + (WIDE_OPS if wide else 0)
        ops = (body * (lane + BIJ_KEY_OPS + INNER_KEY_OPS + 2 * son)
               + tail * (lane + BIJ_KEY_OPS + son) + split * MIX_SPLIT64_OPS
               + mix_grid(ns) * ck.mixture_key_words(spec, 24) * KEY_WORD_OPS)
        itemsize = spec.out_dtype().itemsize
        b_ms, b_by = bound(ops, ns * itemsize
                           + table_bytes(spec, keys_read=False))
        fn = lambda s=spec, r=rank, w=world, kw=kw: \
            pt.mixture_epoch_indices_cuda(s, 0, 1, r, w, **kw)
        ck.reset_launches()
        fn()
        ran = {k: v for k, v in ck.launches.items() if v}
        check(ran == {"mixture_fused_wide": 1},
              f"the {label} regen launched {ran}")
        ms = gpu_ms(fn, 5 if world == 8 else 20)
        tag = f"{label} world={world}"
        if world == 8:
            # the torch loop at world 8: run it, or see it not fit
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                t = time.perf_counter()
                M.mixture_epoch_indices_generic(spec, 0, 1, rank, world,
                                                fused=False, device=dev)
                torch.cuda.synchronize()
                loop_s = (f"ran in {(time.perf_counter() - t) * 1e3:.1f} ms "
                          "host wall")
            except torch.cuda.OutOfMemoryError as exc:
                loop_s = f"out of memory ({str(exc).splitlines()[0]})"
            loop_s += (f", {torch.cuda.max_memory_allocated() / 2**30:.1f} "
                       "GiB peak")
            torch.cuda.empty_cache()
            print(f"time mixture_fused_wide {tag}: kernel {ms:.4f} ms for "
                  f"{ns} lanes ({body} body + {tail} tail, {split} 64-bit "
                  "splits), plain not "
                  f"measured; bound {b_ms:.4f} ms ({b_by}; {ops / 1e9:.3f} G "
                  f"int32 ops), {b_ms / ms:.1%} of bound; the masked torch "
                  f"loop at world 8 {loop_s} | {card}")
            continue
        args = dict(rank=rank, world=world, num_samples=ns, wide_pos=wide,
                    device=dev)
        torch.cuda.reset_peak_memory_stats()
        plain = gpu_ms(lambda s=spec, a=args: ck.mixture_fused_wide_ref(
            None, s, 0, 1, **a), 3)
        plain_peak = torch.cuda.max_memory_allocated() / 2**30
        torch.cuda.reset_peak_memory_stats()
        loop = gpu_ms(lambda s=spec, r=rank, w=world: \
                      M.mixture_epoch_indices_generic(s, 0, 1, r, w,
                                                      fused=False,
                                                      device=dev), 3)
        loop_peak = torch.cuda.max_memory_allocated() / 2**30
        _t, _ns, total = M.mixture_epoch_sizes(spec, None, world, False)
        loop_ops = masked_mixture_ops(spec, ns, total,
                                      wide=M.wide_positions(total - 1, spec))
        lb_ms, lb_by = bound(loop_ops, ns * itemsize)
        if spec is m10b:
            hold("mixture_fused_wide", fn(), ck.mixture_fused_wide_ref(
                None, spec, 0, 1, **args), f"{tag} rank={rank} (all {ns} "
                 f"lanes; {split} 64-bit splits)")
        print(f"time mixture_fused_wide {tag}: kernel {ms:.4f} ms for {ns} "
              f"lanes ({spec.out_dtype()}; {body} body + {tail} tail, "
              f"{split} 64-bit splits), plain {plain:.4f} ms "
              f"({plain_peak:.1f} GiB peak), bound "
              f"{b_ms:.4f} ms ({b_by}; {ops / 1e9:.3f} G int32 ops), "
              f"{b_ms / ms:.1%} of bound; per lane {ms / ns:.3e} ms against "
              f"mixture_fused M1 world=256 {fused_ms / ns_m1:.3e}, "
              f"{(ms / ns) / (fused_ms / ns_m1):.2f}x; the masked torch loop "
              f"(the route before this kernel) {loop:.4f} ms ({loop_peak:.1f}"
              f" GiB peak), its bound {lb_ms:.4f} ms ({lb_by}; "
              f"{loop_ops / 1e9:.3f} G int32 ops over {spec.num_sources} "
              f"passes), kernel {loop / ms:.1f}x faster | {card}")
        if spec is big:
            rows["mixture_fused_wide"] = (ms, plain, b_ms, b_by)
        torch.cuda.empty_cache()
    # could mixture_fused_wide take mixture_fused's specs?  Both kernels on
    # M1, M2 and M3 at world 256, keys folded, in one run
    for label, spec, es in (("M1", m1, None), ("M2", m1, M2_SAMPLES),
                            ("M3", m3, None)):
        ns, wide = mix_sizes(spec, es, 256)
        kw = dict(rank=5, world=256, num_samples=ns, wide_pos=wide)
        pair = [gpu_ms(lambda f=f, s=spec, kw=kw: f(None, s, 0, 1, **kw), 20)
                for f in (ck.mixture_fused, ck.mixture_fused_wide,
                          ck.mixture_fused, ck.mixture_fused_wide)]
        print(f"mixture_fused_wide on {label} world=256: "
              f"{pair[1]:.4f} / {pair[3]:.4f} ms against mixture_fused "
              f"{pair[0]:.4f} / {pair[2]:.4f} ms, "
              f"{(pair[1] + pair[3]) / (pair[0] + pair[2]):.3f}x | {card}")

    # the shard kernels: S1 at world 8 (the main path) and 1, S2, S3, S4
    def shard_work(sizes, sids, wss):
        """Lanes of an expansion in a body window (inner bijection), in a
        tail (tail bijection) or left in storage order: this run's data."""
        m = sizes[sids.cpu().numpy()]
        full, w = SH.shuffle_mode(wss)
        W = m if full else np.minimum(w, m)
        body = np.where(W > 1, m // np.maximum(W, 1) * W, m)
        shuffled = W > 1
        return (int(body[shuffled].sum()), int((m - body)[shuffled].sum()),
                int(m[~shuffled].sum()))

    def expand_tile(lanes):
        """shard_expand's tile (csrc/shard_kernels.cu expand_tile)."""
        cap = 8 * sms
        rounds_of_tiles = -(-lanes // (cap * 4096))
        tile = -(-lanes // (cap * rounds_of_tiles))
        return min(4096, -(-tile // 32) * 32)

    per_lane = {}
    for sizes, label, world, wss in shard_cells():
        sids = pt.epoch_indices_cuda(sizes.size, SHARD_W, 0, 1, 5 % world,
                                     world)
        tabs = SH.shard_tables(sizes, dev)
        full, w = SH.shuffle_mode(wss)
        seq = SH.sequential(full, w)
        rowtab, m_of = ck.shard_row_keys(sids, tabs, 0, 1, full=full, w=w,
                                         sizes_out=True)
        ends = None if tabs.m_uniform else torch.cumsum(m_of, 0)
        lanes = (sids.numel() * tabs.m_uniform if ends is None
                 else int(ends[-1]))
        rows_n, words = sids.numel(), SH.row_words(24)
        tag = f"{label} world={world} within_shard_shuffle={wss}"
        if wss is True and label != "S4":
            ms = gpu_ms(lambda: ck.shard_row_keys(sids, tabs, 0, 1, full=True,
                                                  w=0), 50)
            plain = gpu_ms(lambda: ck.shard_row_keys_ref(
                sids, tabs.dev_sizes, 0, 1, full=True, w=0), 5)
            b_ms, b_by = bound(rows_n * (ROW_BASE_OPS + 2 * 24 * ROW_KEY_OPS),
                               rows_n * (4 + 8 + 4 * words))
            # the stores alone: a PyTorch fill of the same table
            fill = gpu_ms(rowtab.zero_, 50)
            print(f"time shard_row_keys {tag}: kernel {ms:.4f} ms, plain "
                  f"{plain:.4f} ms, bound {b_ms:.6f} ms ({b_by}; "
                  f"{rows_n} rows), {b_ms / ms:.1%} of bound, launch floor "
                  f"{floor_ms:.4f} ms, zero_ of its {rowtab.numel() * 4 / 1e6:.1f}"
                  f" MB table {fill:.4f} ms | {card}")
            rows.setdefault("shard_row_keys", (ms, plain, b_ms, b_by))
        if seq:  # the copy reads no record
            rowtab = None
        body, tail, stored = shard_work(sizes, sids, wss)
        m = sizes[sids.cpu().numpy()]
        windowed = (m > w) if not full and not seq else np.zeros_like(m, bool)
        w_body = int((m // max(w, 1) * max(w, 1))[windowed].sum())
        n_windows = int((m // max(w, 1))[windowed].sum())
        # this PR's count: the staged row found by t / m, or by a search
        # over the staged rows of an average tile (mixed sizes)
        tile = expand_tile(lanes)
        steps = int(np.ceil(np.log2(min(64, max(2, rows_n * tile / lanes)))))
        lane = SHARD_LANE_OPS + (0 if ends is None
                                 else SEARCH_STEP_OPS * steps - 6)
        ops = ((body + tail) * (lane + son) + stored * lane
               + w_body * WINDOW_LANE_OPS + n_windows * INNER_KEY_OPS
               + (0 if seq else rows_n * (INNER_KEY_OPS + TAIL_KEY_OPS)))
        nbytes = (lanes * tabs.out_dtype.itemsize
                  + rows_n * (4 + 8 + (0 if seq else 4 * words)
                              + (0 if ends is None else 8)))
        # the first design's count: keys per lane, a search over every row
        lane4 = SHARD_LANE_OPS_V1 + (0 if ends is None else SEARCH_STEP_OPS
                                      * int(np.ceil(np.log2(max(rows_n, 2)))))
        ops4 = (body * (lane4 + INNER_KEY_OPS + son)
                + tail * (lane4 + TAIL_KEY_OPS + son) + stored * lane4)
        nbytes4 = (lanes * tabs.out_dtype.itemsize
                   + rows_n * (4 + 8 + 4 * words + (0 if ends is None else 8)))
        kw = dict(lanes=lanes, full=full, w=w)
        big = label == "S4" or world == 1
        ms = gpu_ms(lambda: ck.shard_expand(rowtab, sids, tabs, ends, **kw),
                    5 if big else 20)
        plain = None
        if label != "S4":  # S4's plain version needs ~80 GB of int64
            torch.cuda.reset_peak_memory_stats()
            plain = gpu_ms(lambda: ck.shard_expand_ref(
                rowtab, sids, tabs.dev_offsets, ends,
                m_uniform=tabs.m_uniform, out_dtype=tabs.out_dtype, **kw),
                2 if big else 3)
            peak = torch.cuda.max_memory_allocated() / 2**30
        b_ms, b_by = bound(ops, nbytes)
        b4_ms, b4_by = bound(ops4, nbytes4)
        plain_s = ("not measured" if plain is None
                   else f"{plain:.4f} ms ({peak:.1f} GiB peak)")
        per_lane[label, world, wss] = ms * 1e9 / lanes
        print(f"time shard_expand {tag}: kernel {ms:.4f} ms "
              f"({ms * 1e9 / lanes:.2f} ps a lane over {lanes} lanes, tiles "
              f"of {tile}), plain {plain_s}, bound {b_ms:.4f} ms ({b_by}; "
              f"{ops / 1e9:.3f} G int32 ops over {body} body + {tail} tail + "
              f"{stored} storage-order lanes, {nbytes / 1e6:.1f} MB), "
              f"{b_ms / ms:.1%} of bound; one-thread-per-lane count {b4_ms:.4f} ms "
              f"({b4_by}), {b4_ms / ms:.1%} of it | {card}")
        rows.setdefault("shard_expand", (ms, plain, b_ms, b_by))
        del sids, rowtab, m_of, ends
        torch.cuda.empty_cache()
    for label in ("S2", "S3"):
        for wss in (True, SHARD_W):
            ratio = per_lane[label, 8, wss] / per_lane["S1", 8, wss]
            print(f"shard_expand per lane, {label} against S1 (world 8, "
                  f"within_shard_shuffle={wss}): {ratio:.3f} | {card}")
    # the slice-4 regen per epoch: the sampler's shard ids and expansion
    for sizes, label, world in ((sz1, "S1", 8), (sz1, "S1", 1),
                                (sz2, "S2", 8)):
        sampler = pt.PartialShuffleShardSampler(SHARDS, num_replicas=world,
                                                rank=5 % world)
        fn = lambda sm=sampler, sz=sizes: sm.device_epoch_indices(sz)
        reps = 20 if world == 8 else 5
        walls = host_walls(fn, reps)
        before = sum(ck.launches.values())
        fn()
        n_launch = sum(ck.launches.values()) - before
        line = (f"shard regen per epoch {label} world={world} (shard ids + "
                f"expansion, {n_launch} launches): host wall to ready median "
                f"{float(np.median(walls)):.4f} ms min {min(walls):.4f} ms")
        if label == "S1":  # mixed sizes read the epoch length back
            line = line.replace(": host", f": device "
                                f"{gpu_ms(fn, reps):.4f} ms, host")
        print(f"{line} | {card}")
    print("library call: none (no single PyTorch call computes this law or "
          "the mixture's or §7's; torch.randperm is a different function)")

    # the amortized kernels compute the window order too (ops/xla.py:58,
    # _window_order_ids, XLA there)
    replaces = {
        "index_general":
            "partiallyshuffledistributedsampler_tpu/ops/pallas_kernel.py:75",
        "index_amortized":
            "partiallyshuffledistributedsampler_tpu/ops/pallas_kernel.py:161"
            " + partiallyshuffledistributedsampler_tpu/ops/xla.py:58",
        "index_general_wide":
            "partiallyshuffledistributedsampler_tpu/ops/core.py:527",
        "index_amortized_wide":
            "partiallyshuffledistributedsampler_tpu/ops/xla.py:87"
            " + partiallyshuffledistributedsampler_tpu/ops/xla.py:58",
        "mixture_source_keys":
            "partiallyshuffledistributedsampler_tpu/ops/mixture.py:534",
        "mixture_fused":
            "partiallyshuffledistributedsampler_tpu/ops/mixture.py:426",
        "mixture_fused_wide":
            "partiallyshuffledistributedsampler_tpu/ops/mixture.py:799"
            " + partiallyshuffledistributedsampler_tpu/ops/mixture.py:614",
        "shard_row_keys":
            "partiallyshuffledistributedsampler_tpu/sampler/shard_mode.py:121",
        "shard_expand":
            "partiallyshuffledistributedsampler_tpu/sampler/shard_mode.py:437",
        "index_positions":
            "partiallyshuffledistributedsampler_tpu/ops/xla.py:270"
            " + partiallyshuffledistributedsampler_tpu/ops/xla.py:347",
        "index_positions_wide":
            "partiallyshuffledistributedsampler_tpu/ops/xla.py:270"
            " + partiallyshuffledistributedsampler_tpu/ops/xla.py:347",
        "weighted_stream":
            "partiallyshuffledistributedsampler_tpu/sampling/alias.py:189",
        "weighted_stream_wide":
            "partiallyshuffledistributedsampler_tpu/sampling/alias.py:189",
    }
    rows.update(rows9)
    kernels = []
    for name in replaces:
        ms, plain, b_ms, b_by = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "partiallyshuffledistributedsampler_tpu_torch/csrc/"
                      + ("mixture_kernels.cu" if name in SLICE3
                         else "shard_kernels.cu" if name in SLICE4
                         else "sampling_kernels.cu" if name in SLICE9
                         else "index_kernels.cu"),
            "replaces": replaces[name],
            # the count over the main paths' runs
            "launches": sum(run.get(name, 0) for run in (
                launches, launches2, launches3, launches3b, launches4,
                launches8, launches9, launches10, launches19, launches20,
                launches21, launches15)),
            "max_abs_err": stats[name]["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
