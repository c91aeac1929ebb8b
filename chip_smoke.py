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
  with the kernels off and for a spec with a source past 2^31.

``python3 chip_smoke.py --regen`` prints only the per-epoch regen times,
the ``shard_row_keys`` and ``shard_expand`` times, the elastic remainder
regens, the launches per regen and a digest of each output, through
entry points that earlier trees share: run it as a copy inside an older
checkout to time that tree's route on the same card.

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
SLICE1 = ("index_general", "index_amortized")
SLICE2 = ("index_amortized", "index_general_wide", "index_amortized_wide")
#: the slice-3 kernels, and the index kernels its mixture path never runs
SLICE3 = ("mixture_source_keys", "mixture_fused")
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
#: takes only the masked per-source route, timed beside M1's
MASKED_BIG_SOURCES = (3_000_000_000, 1_000_000_000, 500_000_000)
MASKED_BIG_WEIGHTS = (60, 25, 15)
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

    def pattern_errors(b, ids):
        """Bytes of a batch that break the pattern: each row's first 4
        bytes hold its row id, every other byte the id mod 251."""
        b8 = b.view(torch.uint8).reshape(b.shape[0], -1)
        hdr = b8[:, :4].contiguous().view(torch.int32).reshape(-1)
        return ((hdr != ids).sum()
                + (b8[:, 4:] != (hdr % 251).to(torch.uint8)[:, None]).sum())

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
        data = np.empty((rows,) + shape, dtype=dtype)
        b8 = data.reshape(rows, -1).view(np.uint8)
        b8[:, 4:] = (np.arange(rows) % 251).astype(np.uint8)[:, None]
        b8[:, :4] = np.arange(rows, dtype=np.int32).view(np.uint8).reshape(
            rows, 4)
        fill_s = time.perf_counter() - t0
        row_bytes = b8.shape[1]
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
        del data, b8, ld
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
        their source (two bijections) or tail lanes (one), and the lanes
        in or near a source's tail window: this run's data, by the plain
        law on the card, in chunks."""
        ns, wide = mix_sizes(spec, es, world)
        body_s = torch.tensor([(n // w) * w for n, w in zip(spec.sources,
                                                            spec.windows)],
                              device=dev)
        tail, near = 0, []
        for c0 in range(0, ns, 25_000_000):
            t = torch.arange(c0, min(ns, c0 + 25_000_000), device=dev)
            s, _pas, u = M.lane_draws(rank + world * t, spec, seed, epoch,
                                      wide=wide)
            d = u - body_s[s]
            tail += int((d >= 0).sum())
            near.append(t[d >= -64])
        return ns - tail, tail, torch.cat(near)

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
    before = dict(ck.launches)
    masked = pt.mixture_epoch_indices_cuda(m1, 0, 1, 5, 256, fused=False)
    ok = (ck.launches == before and masked.is_cuda
          and torch.equal(masked, pt.mixture_epoch_indices_cuda(m1, 0, 1, 5,
                                                                256)))
    print(f"mixture fused=False route (the masked torch evaluator on the "
          f"card, no kernel) equals the kernel route: {ok}")
    check(ok, "the masked mixture route differs or launched a kernel")
    # world 8: 125M lanes, held on >= 1M sampled lanes and every lane in or
    # near a source's tail window, against the plain random-access law
    ns8, _ = mix_sizes(m1, None, 8)
    before = ck.launches["mixture_fused"]
    out = pt.mixture_epoch_indices_cuda(m1, 0, 1, 3, 8)
    check(ck.launches["mixture_fused"] == before + 1, "M1 world 8: no kernel")
    _b, _t, near = mix_lanes(m1, None, 8, 3)
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
        body, tail, _near = mix_lanes(spec, es, world, rank)
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
    # the masked per-source mixture (plain torch on the card): M1 with the
    # kernels turned off, and a spec with a source past 2^31, which only
    # this route takes; each beside mixture_fused at M1 / world 256
    fused_ms = gpu_ms(lambda: pt.mixture_epoch_indices_cuda(m1, 0, 1, 5,
                                                            256), 20)
    big = pt.MixtureSpec(MASKED_BIG_SOURCES, MASKED_BIG_WEIGHTS, windows=W)
    for label, spec, kw in (("M1", m1, dict(fused=False)),
                            ("3e9/1e9/5e8 at 60/25/15", big, {})):
        fn = lambda s=spec, kw=kw: pt.mixture_epoch_indices_cuda(
            s, 0, 1, 5, 256, **kw)
        before = sum(ck.launches.values())
        out = fn()
        n_launch = sum(ck.launches.values()) - before
        lanes = out.numel()
        torch.cuda.reset_peak_memory_stats()
        ms = gpu_ms(fn, 3)
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"time masked per-source mixture (plain torch) {label} "
              f"world=256: {ms:.4f} ms device for {lanes} lanes "
              f"({out.dtype}, {n_launch} kernel launches, {peak:.1f} GiB "
              f"peak), mixture_fused M1 world=256 {fused_ms:.4f} ms, per "
              f"lane {ms / lanes:.3e} against {fused_ms / ns_m1:.3e} ms, "
              f"{(ms / lanes) / (fused_ms / ns_m1):.1f}x | {card}")
        check(n_launch == 0, "the masked mixture launched a kernel")
        del out
        torch.cuda.empty_cache()

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
                launches8, launches9, launches10)),
            "max_abs_err": stats[name]["err"], "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
