"""The op, byte and FLOP counts against cases worked by hand."""

import math

import pytest

from bench_port.counts import law, model, peaks


def test_index_amortized_at_1b_world_256():
    # 122,070 full windows of 8,192, 32 lanes of each a rank; the rank's
    # 10 remaining lanes take the full law, in the body or the tail
    n, w, world, rank = 1_000_000_000, 8192, 256, 5
    nw = n // w
    body_end = nw * w
    rest = [rank + world * t for t in range(nw * (w // world),
                                            -(-n // world))]
    rest_body = sum(p % n < body_end for p in rest)
    son = 24 * 13
    want = (nw * 32 * (son + 21 + 3) + rest_body * (2 * son + 21 + 3)
            + (len(rest) - rest_body) * (son + 3) + nw * son)
    ops, nbytes = law.index_amortized(n, w, world, rank)
    assert (ops, nbytes) == (want, 3_906_250 * 4)
    assert len(rest) == 10


def test_shard_expansion_s1_world_8():
    rows = [1000] * 12_500
    ops, nbytes = law.shard_expansion(rows)
    lanes = 12_500_000
    want = (lanes * (13 + 24 * 13) + 12_500 * (21 + 7)
            + 12_500 * (57 + 2 * 24 * 11))
    assert ops == want
    assert nbytes == 12_500 * 12 + lanes * 4
    # 4.08 G ops at 64 x 132 x 1,980 MHz: PERF.md's 0.243 ms bound
    assert peaks.bound_s(ops, nbytes, 132, 1980.0) == pytest.approx(
        2.44e-4, rel=0.01)


def test_shard_expansion_windowed_and_sequential():
    ops, _ = law.shard_expansion([10, 3], within_shard_shuffle=4)
    son = 24 * 13
    # row 10: windows of 4: body 8 (two windows), tail 2; row 3: one
    # window of 3 (w = min(4, 3) = m, no window split)
    want = ((8 + 2 + 3) * (13 + son) + 8 * 8 + 2 * 21 + 2 * (21 + 7)
            + 2 * (57 + 2 * 24 * 11))
    assert ops == want
    assert law.shard_expansion([10, 3], within_shard_shuffle=False) == (
        13 * 13, 2 * 12 + 13 * 4)


def test_train_step_flops():
    gpt = dict(kind="gpt", vocab_size=50257, seq_len=1024, d_model=768,
               n_layers=12, n_heads=12, d_ff=3072)
    block = 12 * (4 * 768**2 + 2 * 768 * 3072)
    want = (6 * 12 * 1024 * (block + 768 * 50257)
            + 12 * 12 * 1024**2 * 768 * 12)
    assert model.train_step_flops(gpt, 12) == want
    vit = dict(kind="vit", image_size=224, patch_size=16, channels=3,
               num_classes=1000, d_model=1024, n_layers=24, n_heads=16,
               d_ff=4096)
    got = model.train_step_flops(vit, 64)
    assert got == pytest.approx(23.6e12, rel=0.01)
    block = 24 * (4 * 1024**2 + 2 * 1024 * 4096)
    assert got == 6 * 64 * (block * 197 + 768 * 1024 * 196 + 1024 * 1000) \
        + 12 * 64 * 197**2 * 1024 * 24


def test_peaks():
    assert peaks.int32_ops_per_s(132, 1980.0) == 64 * 132 * 1.98e9
    assert peaks.bound_s(0, 3.35e12, 132, 1980.0) == 1.0
    assert math.isclose(peaks.bound_s(64 * 132 * 1.98e9, 0, 132, 1980.0), 1)


def test_link_bytes_and_peaks():
    from bench_port.counts import link

    assert link.allreduce_bytes(163_087_441) == 4 * 163_087_442
    assert link.link_bytes(100.0, 4) == pytest.approx(150.0)
    smi = ("GPU 0: NVIDIA H100 80GB HBM3 (UUID: GPU-1)\n"
           + "".join(f"\t Link {i}: 26.562 GB/s\n" for i in range(18)))
    assert link.nvlink_bytes_per_s(smi) == pytest.approx(18 * 26.562e9)
    assert link.nvlink_bytes_per_s("GPU 0: x\n\t Link 0: <inactive>\n") \
        is None
    assert link.pcie_bytes_per_s(5, 16) == pytest.approx(
        16 * 32e9 / 8 * 128 / 130)
