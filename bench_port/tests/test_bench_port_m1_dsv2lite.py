"""The configuration m1_dsv2lite and its two cells on the CPU routes, at a
small size: the plain §8 law against the port's CPU mixture evaluator on
M1's shape cut small; the DeepSeek-V2 kind's contract; the mixture count
against a hand count; whole runs of both cells held to their committed
limits (sound: correct; each fault and the control: not); and the clean
refusal of a tree whose port lacks the model."""

import importlib.util
import json

import numpy as np
import pytest
import torch

from bench_port import control, harness, kinds
from bench_port.counts import law as law_counts
from bench_port.counts import mixture as mixture_counts
from bench_port.reference import mixture_law
from bench_port.tests.test_bench_port_kinds import CONTRACT

import partiallyshuffledistributedsampler_tpu_torch as pt

LOAD_CELL = harness.load_cell
REGEN, TRAIN = "m1_dsv2lite.regen", "m1_dsv2lite.train"
SMALL_MODEL = dict(vocab_size=256, hidden_size=64, num_hidden_layers=3,
                   num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
                   qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
                   moe_intermediate_size=32, n_routed_experts=8,
                   num_experts_per_tok=2, experts_held=4)


def small_cell(name):
    """The cell at the CPU tests' size: M1's weights, windows and block
    over sources of a thousandth (regen) or 2,621 host rows (train); the
    model at d 64, 3 layers, 4 of 8 experts held (from expert 2), top 2,
    vocabulary 256, 32 tokens; batch 4."""
    cell = LOAD_CELL(name)
    cfg = dict(cell["config"], **SMALL_MODEL, host_rows=2621,
               host_sources=[1835, 524, 262])
    cfg["mixture"] = dict(cfg["mixture"], sources=[700_000, 200_000, 100_000])
    cfg["model"] = dict(cfg["model"], seq_len=32, first_held_expert=2)
    cell["config"] = cfg
    if "batch" in cell["params"]:
        cell["params"] = dict(cell["params"], batch=4)
    return cell


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(harness, "load_cell", small_cell)


@pytest.mark.parametrize("sources,seed,epoch,rank,world,partition", [
    ((7_000, 2_000, 1_000), 2**31 + 7, 3, 5, 8, "strided"),
    ((700_000, 200_000, 100_000), 2**40 + 11, 0, 5, 256, "strided"),
    ((183_501, 52_429, 26_214), 12_345, 1, 3, 8, "strided"),
    ((7_000, 2_000, 1_000), 9, 2**32 - 1, 2, 4, "blocked"),
])
def test_mixture_law_matches_the_port(sources, seed, epoch, rank, world,
                                      partition):
    spec = pt.MixtureSpec(sources, [70, 20, 10], windows=8192, block=1024)
    want = pt.mixture_epoch_indices_cpu(spec, seed, epoch, rank, world,
                                        partition=partition).long()
    got = mixture_law.epoch_indices(sources, [70, 20, 10], 8192, 1024, seed,
                                    epoch, rank, world, partition=partition)
    assert torch.equal(got, want)


def test_fewer_rounds_change_the_mixture():
    """The regen cell's control (16 rounds for 24) differs on most lanes."""
    args = ((700_000, 200_000, 100_000), [70, 20, 10], 8192, 1024, 3, 0, 1,
            256)
    a = mixture_law.epoch_indices(*args)
    b = mixture_law.epoch_indices(*args, rounds=16)
    assert (a != b).float().mean() > 0.9


def test_the_kind_gives_the_contract():
    mod = kinds.load("deepseek_v2")
    assert all(callable(getattr(mod, f)) for f in CONTRACT)
    config = LOAD_CELL(TRAIN)["config"]
    m = mod.model_of(config)
    assert m["n_routed_experts"] == 64 and m["experts_held"] == 8
    params = sum(np.prod(s) for _, s, _ in mod.leaves(m))
    assert params == pytest.approx(2.744e9, rel=0.002)
    assert mod.train_step_flops(m, 2) == pytest.approx(67e12, rel=0.03)


@pytest.mark.parametrize("recompute", [True, False])
def test_the_expert_count_follows_the_models_recompute(monkeypatch,
                                                       recompute):
    """A held pair's FLOPs: 6 products of d x f a step (forward 2,
    backward 4) for gate, up and down, 8 where the model recomputes its
    experts in the backward, read from the port's flag."""
    from partiallyshuffledistributedsampler_tpu_torch.models import (
        deepseek_v2,
    )

    mod = kinds.load("deepseek_v2")
    m = mod.model_of(LOAD_CELL(TRAIN)["config"])
    assert deepseek_v2.RECOMPUTE_EXPERTS is True  # as the cells run
    monkeypatch.setattr(deepseek_v2, "RECOMPUTE_EXPERTS", recompute)
    passes = 8 if recompute else 6
    assert mod.expert_pair_flops(m) == passes * 3 * 2048 * 1408


def test_the_kind_refuses_another_router():
    config = dict(LOAD_CELL(TRAIN)["config"], scoring_func="sigmoid")
    with pytest.raises(harness.BenchError, match="scoring_func"):
        kinds.load("deepseek_v2").model_of(config)


def test_a_tree_without_the_model_is_refused(monkeypatch):
    find = importlib.util.find_spec

    def missing(name, *a):
        return None if name.endswith("models.deepseek_v2") else find(name, *a)

    monkeypatch.setattr(importlib.util, "find_spec", missing)
    for cell in (REGEN, TRAIN):
        with pytest.raises(harness.BenchError, match="missing"):
            harness.make_driver(LOAD_CELL(cell), 5, "cpu")


def test_the_mixture_count_by_hand():
    son = 24 * law_counts.ROUND_OPS
    ops, nbytes = mixture_counts.mixture_fused(10, 3, 3, 1024)
    want = (10 * (55 + 14 + 21 + 2 * son) + 3 * (55 + 14 + son)
            + (2 + 3 * (1 + 3 * 24)) * 51)
    assert (ops, nbytes) == (want, 13 * 4 + 4 * (1024 * 4 + 24))
    # the lanes split as the port's own draws split them
    spec = pt.MixtureSpec([7_000, 2_000, 1_000], [70, 20, 10], windows=512)
    body, tail = mixture_counts.rank_lanes([7_000, 2_000, 1_000],
                                           [70, 20, 10], 512, 1024, 5, 1, 3, 8)
    from partiallyshuffledistributedsampler_tpu_torch.ops import mixture
    s, _, u = mixture.lane_draws(3 + 8 * torch.arange(1250), spec, 5, 1)
    body_s = torch.tensor([6656, 1536, 512])
    assert (body, tail) == (int((u < body_s[s]).sum()),
                            int((u >= body_s[s]).sum()))


@pytest.mark.parametrize("cell,fault", [
    (REGEN, None), (TRAIN, None), (REGEN, "altered_answer"),
    (TRAIN, "frozen"), (TRAIN, "late_frozen"), (TRAIN, "half_batch"),
    (TRAIN, "altered_row")])
def test_a_fault_makes_the_run_incorrect(small, cell, fault):
    line, checks = harness.measure(cell, 2**31 + 5, 0.3, False,
                                   device="cpu", fault=fault)
    json.dumps(line)
    assert line["correct"] is (fault is None), line["checks"]
    if fault is None:
        assert set(line["metrics"]) == {
            m["name"] for m in LOAD_CELL(cell)["end_to_end"]}


def test_the_regen_control_fails(small):
    r = control.regen_readings(harness.load_cell(REGEN), 9, 0.2, "cpu",
                               "control")
    assert r["mismatched_lanes"] > 0 and r["correct"] is False


def test_the_train_control_fails_and_counts(small):
    c = harness.load_cell(TRAIN)
    sound = control.train_readings(c, 9, 0.2, "cpu", "sound")
    assert sound["correct"] is True, sound
    assert sound["tokens_dropped"] == 0
    r = control.train_readings(c, 9, 0.2, "cpu", "control", sound["rows"])
    assert r["correct"] is False, r
    assert r["route_mismatch"] > sound["route_mismatch"]
