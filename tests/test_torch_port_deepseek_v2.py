"""The port's DeepSeek-V2 (``models/deepseek_v2.py``) against the plain
float32 reference of the benchmark (``bench_port/reference/deepseek_v2.py``,
which imports nothing of the port) on seeded weights at a small size: d 64,
4 heads, kv rank 32, rope 16, 8 routed experts, top 2, 1 shared, 3 layers
with layer 0 dense, vocabulary 256, 32 tokens.  The port computes in
float32 here, so the two differ by the order of float32 sums alone.

Tolerances: the logits and the loss within 1e-5 of the reference's scale
(float32 sums in another order: SDPA's fused softmax, the grouped GEMM,
the combine's index_add against plain matmuls, a masked softmax and dense
adds; measured 1.1e-6 to 1.7e-6); each gradient within 2e-5 of its
leaf's norm (a backward sums over 64 tokens again in another order;
measured 1.7e-6 to 2.8e-6 on the worst leaf).
No routing decision is near a tie at these seeds (checked: the routes
agree exactly).

The expert-parallel share (model-configs §4): the routed parts of the held
sets {0-3} and {4-7}, with the shared expert counted once, add up to the
reference's uncut layer, and both shares give the whole router's balance
loss.
"""

import os
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from bench_port.reference import deepseek_v2 as ref
from partiallyshuffledistributedsampler_tpu_torch import parallel
from partiallyshuffledistributedsampler_tpu_torch.models import (
    DeepSeekV2Config,
    deepseek_v2 as D,
    init_deepseek_params,
    make_deepseek_train_step,
    moe_counters,
    reset_moe_counters,
)
from partiallyshuffledistributedsampler_tpu_torch.models.train import (
    make_optimizer,
)

SMALL = dict(vocab_size=256, seq_len=32, hidden_size=64, num_hidden_layers=3,
             num_attention_heads=4, kv_lora_rank=32, qk_nope_head_dim=16,
             qk_rope_head_dim=16, v_head_dim=16, intermediate_size=128,
             moe_intermediate_size=32, n_routed_experts=8,
             num_experts_per_tok=2, n_shared_experts=1,
             first_k_dense_replace=1)
LOGIT_TOL, GRAD_TOL = 1e-5, 2e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ref_model(cfg: DeepSeekV2Config) -> dict:
    """The reference's model dict of a port configuration."""
    m = {k: getattr(cfg, k) for k in SMALL}
    m.update(rms_norm_eps=cfg.rms_norm_eps, rope_theta=cfg.rope_theta,
             experts_held=cfg.experts_held,
             first_held_expert=cfg.first_held_expert,
             aux_loss_alpha=cfg.aux_loss_alpha,
             rope_scaling=dict(
                 type="yarn", factor=cfg.rope_factor,
                 original_max_position_embeddings=(
                     cfg.original_max_position_embeddings),
                 beta_fast=cfg.beta_fast, beta_slow=cfg.beta_slow,
                 mscale=cfg.mscale, mscale_all_dim=cfg.mscale_all_dim))
    return m


def small(**kw) -> DeepSeekV2Config:
    return DeepSeekV2Config(**(dict(SMALL, dtype=torch.float32) | kw))


def tokens(seed: int, cfg: DeepSeekV2Config, batch: int = 2):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1),
                         generator=g)


def weights_of(model) -> dict:
    return {k: v.detach().clone().requires_grad_(True)
            for k, v in model.state_dict().items()}


def port_loss(model, tok):
    logits, aux = model(tok[:, :-1])
    logp = torch.log_softmax(logits.float(), -1)
    nll = -logp.gather(-1, tok[:, 1:, None])[..., 0].mean()
    return logits, nll + aux


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("held", [(0, 8), (2, 4)])
def test_port_matches_the_reference(seed, held):
    cfg = small(first_held_expert=held[0], experts_held=held[1])
    model = init_deepseek_params(cfg, torch.Generator().manual_seed(seed))
    tok = tokens(seed + 10, cfg)
    w = weights_of(model)
    logits, loss = port_loss(model, tok)
    loss.backward()
    routes = {}
    m = ref_model(cfg)
    want_logits, _ = ref.logits_and_aux(w, m, tok[:, :-1], routes=routes)
    want = ref.loss(w, m, {"tokens": tok})
    grads = torch.autograd.grad(want, list(w.values()))
    for i, layer in enumerate(model.moe_layers(), start=1):
        assert torch.equal(layer.last_routes, routes[i])
    scale = want_logits.abs().max()
    assert (logits - want_logits).abs().max() <= LOGIT_TOL * scale
    assert abs(float(loss.detach()) - float(want.detach())) \
        <= LOGIT_TOL * float(want.detach())
    named = dict(model.named_parameters())
    for (name, _), g in zip(w.items(), grads):
        got = named[name].grad
        assert (got - g).norm() <= GRAD_TOL * max(float(g.norm()), 1e-12), \
            name


@pytest.mark.parametrize("seed", [3, 4])
def test_the_shares_add_up_to_the_uncut_layer(seed):
    """Held sets {0-3} and {4-7}: their routed parts plus the shared
    expert once equal the reference's layer with all 8 experts."""
    whole = small()
    m = ref_model(whole)
    model = init_deepseek_params(whole, torch.Generator().manual_seed(seed))
    w = {k: v.detach() for k, v in model.state_dict().items()}
    g = torch.Generator().manual_seed(seed + 100)
    h = torch.randn(2, whole.seq_len, whole.hidden_size, generator=g)
    want, want_aux = ref._moe(w, "layer1.", m, h, False, None, 1)
    parts, auxes = [], []
    for lo in (0, 4):
        cfg = small(first_held_expert=lo, experts_held=4)
        share = D.MoE(cfg)
        sd = {k.removeprefix("layer1.mlp."): v for k, v in w.items()
              if k.startswith("layer1.mlp.")}
        for k in ("experts_gate_up.weight", "experts_down.weight"):
            sd[k] = sd[k][lo:lo + 4]
        share.load_state_dict(sd)
        y, aux = share(h)
        parts.append(y.detach())
        auxes.append(aux.detach())
    shared = D.MoE(whole).shared
    shared.load_state_dict({k.removeprefix("layer1.mlp.shared."): v
                            for k, v in w.items()
                            if k.startswith("layer1.mlp.shared.")})
    got = parts[0] + parts[1] - shared(h, torch.float32).detach()
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    for aux in auxes:
        assert abs(float(aux) - float(want_aux)) <= 1e-6 * float(want_aux)


@pytest.mark.parametrize("held,first", [(8, 0), (3, 2), (1, 7)])
def test_route_plan_places_every_held_pair_once(held, first):
    """(8, 0) is the worst case: every slot names a held expert."""
    g = torch.Generator().manual_seed(held)
    idx = torch.stack([torch.randperm(8, generator=g)[:2]
                       for _ in range(97)])
    plan = D.route_plan(idx, first, held)
    flat = idx.reshape(-1)
    is_held = (flat >= first) & (flat < first + held)
    assert plan["rows"] == flat.numel() + held * (D.ALIGN - 1)
    ends = plan["ends"].long()
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    assert ((ends - starts) % D.ALIGN == 0).all()
    assert int(ends[-1]) <= plan["rows"]
    # row: -1 on exactly the pairs of experts held elsewhere; expert j's
    # pairs fill the first counts[j] rows of its group, one row each
    row = plan["row"]
    assert row.dtype == torch.int32 and row.shape == flat.shape
    assert torch.equal(row >= 0, is_held)
    for j in range(held):
        got = sorted(row[flat == first + j].tolist())
        assert len(got) == int(plan["counts"][j])
        assert got == list(range(int(starts[j]), int(starts[j]) + len(got)))
    assert int(plan["dropped"]) == 0
    assert is_held.all() == (held == 8)


def test_route_plan_with_no_held_pair():
    """No slot names a held expert: every group is empty, no row is
    filled and every pair's row is -1."""
    g = torch.Generator().manual_seed(9)
    others = torch.tensor([0, 1, 5, 6, 7])
    idx = torch.stack([others[torch.randperm(5, generator=g)[:2]]
                       for _ in range(97)])
    plan = D.route_plan(idx, 2, 3)
    assert plan["rows"] == 97 * 2 + 3 * (D.ALIGN - 1)
    assert plan["ends"].tolist() == [0, 0, 0]
    assert plan["counts"].tolist() == [0, 0, 0]
    assert int(plan["dropped"]) == 0
    assert plan["row"].dtype == torch.int32
    assert (plan["row"] == -1).all()


#: kinds of routes: random, every slot held, none held, each token's one
#: held slot on the first held expert, or on the last
ROUTES = ("random", "all", "none", "first", "last")


def routes_of(kind: str, n: int, experts: int, k: int, first: int,
              held: int, gen: torch.Generator) -> torch.Tensor:
    """Top-k expert ids ``[n, k]`` (distinct a token) of a kind of
    ``ROUTES``, for held experts ``[first, first + held)``."""
    others = torch.tensor([e for e in range(experts)
                           if not first <= e < first + held])
    out = []
    for _ in range(n):
        pool = others[torch.randperm(len(others), generator=gen)]
        if kind == "random":
            ids = torch.randperm(experts, generator=gen)[:k]
        elif kind == "all":
            ids = first + torch.randperm(held, generator=gen)[:k]
        elif kind == "none":
            ids = pool[:k]
        else:
            one = first if kind == "first" else first + held - 1
            ids = torch.cat([torch.tensor([one]), pool[:k - 1]])
        out.append(ids[torch.randperm(k, generator=gen)])
    return torch.stack(out)


def routed_torch(moe, x, w, plan: dict) -> torch.Tensor:
    """The routed part in PyTorch ops over every row of the buffer, the
    oracle of ``routed_kernels``: each row's pair found from ``row``, the
    rows that hold none masked with ``torch.where`` (a multiply by zero
    would keep a NaN of a row the grouped GEMM never writes), an
    ``index_add`` into zeros for the combine."""
    row, ends, dt = plan["row"].long(), plan["ends"], moe.cfg.dtype
    held = torch.nonzero(row >= 0)[:, 0]
    pair = torch.zeros(plan["rows"], dtype=torch.int64, device=row.device)
    pair[row[held]] = held
    valid = torch.zeros(plan["rows"], dtype=torch.bool, device=row.device)
    valid[row[held]] = True
    valid = valid[:, None]
    tok = pair // moe.cfg.num_experts_per_tok
    rows = torch.where(valid, x.index_select(0, tok), 0)
    gu = torch._grouped_mm(rows, moe.experts_gate_up.weight.to(
        dt).transpose(-2, -1), offs=ends)
    g, u = gu.split(moe.cfg.moe_intermediate_size, dim=-1)
    y = torch._grouped_mm(torch.nn.functional.silu(g) * u,
                          moe.experts_down.weight.to(dt).transpose(-2, -1),
                          offs=ends)
    y = torch.where(valid, y, 0).float() * w.reshape(-1).index_select(
        0, pair)[:, None]
    return torch.zeros(x.shape, device=x.device).index_add_(0, tok, y)


def routed_grads(path, moe, x0, w0, plan, cot) -> dict:
    """``path``'s routed part and its gradients with respect to the
    tokens, the routing weights and the held experts' weights."""
    moe.zero_grad(set_to_none=True)
    x = x0.clone().requires_grad_()
    w = w0.clone().requires_grad_()
    y = path(moe, x, w, plan)
    (y * cot).sum().backward()
    return dict(y=y.detach(), dx=x.grad, dw=w.grad,
                gate_up=moe.experts_gate_up.weight.grad,
                down=moe.experts_down.weight.grad)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ROUTES)
def test_the_kernel_path_matches_the_torch_path(kind, dtype):
    """``routed_kernels`` (here the kernels' plain versions of
    ``ops/cuda_kernel.py``, which the card's kernels are held to) against
    ``routed_torch``, PyTorch ops over the whole buffer: the routed part
    and the gradients of the tokens, the routing weights and both expert weights,
    bit for bit.  With two slots a token every sum of a token's slots is
    one rounded add in both paths: the torch path's ``index_add`` into
    zeros adds the first exactly and rounds the second, as the kernels'
    float32 sums do before their one rounding.  (From three slots on, the
    bf16 ``index_add`` of ``dx`` rounds at every add, the gather's
    backward once.)"""
    cfg = small(dtype=dtype, first_held_expert=2, experts_held=4)
    moe = init_deepseek_params(cfg, torch.Generator().manual_seed(5)
                               ).moe_layers()[0]
    g = torch.Generator().manual_seed(6)
    n, d = 40, cfg.hidden_size
    plan = D.route_plan(routes_of(kind, n, 8, 2, 2, 4, g), 2, 4)
    x0 = torch.randn(n, d, generator=g).to(dtype)
    w0 = torch.rand(n, 2, generator=g)
    cot = torch.randn(n, d, generator=g)
    got = routed_grads(D.routed_kernels, moe, x0, w0, plan, cot)
    want = routed_grads(routed_torch, moe, x0, w0, plan, cot)
    for name in got:
        assert torch.equal(got[name], want[name]), name
    if kind == "none":
        assert not got["y"].any() and not got["dx"].any()


def test_balance_loss_is_the_sequence_wise_law():
    cfg = small(aux_loss_alpha=0.5)
    moe = D.MoE(cfg)
    g = torch.Generator().manual_seed(5)
    scores = torch.softmax(torch.randn(2 * 6, 8, generator=g), -1)
    idx = scores.topk(2, -1).indices
    got = moe.balance_loss(scores, idx, 2)
    want = 0.0
    for b in range(2):
        s, i = scores[b * 6:(b + 1) * 6], idx[b * 6:(b + 1) * 6]
        f = torch.stack([(i == e).sum() for e in range(8)]).float() \
            * 8 / (6 * 2)
        want += float((f * s.mean(0)).sum()) / 2
    assert float(got) == pytest.approx(0.5 * want, rel=1e-6)


def test_yarn_frequencies_and_scale():
    cfg = DeepSeekV2Config(qk_nope_head_dim=128, qk_rope_head_dim=64,
                           seq_len=8)
    inv = D.yarn_inv_freq(cfg)
    base = 10000.0 ** (-torch.arange(0, 64, 2, dtype=torch.float64) / 64)
    # the fast pairs keep their frequency, the slow ones are divided by 40
    assert torch.allclose(inv[:10].double(), base[:10], rtol=1e-6)
    assert torch.allclose(inv[-8:].double(), base[-8:] / 40, rtol=1e-6)
    m = 0.1 * 0.707 * torch.log(torch.tensor(40.0)) + 1
    assert D.MLA(cfg).scale == pytest.approx(float(m * m) / 192 ** 0.5)
    ref_inv, mscale = ref.yarn(ref_model(cfg))
    assert torch.allclose(inv, ref_inv, rtol=1e-6)
    assert mscale == pytest.approx(float(m))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_recomputing_the_experts_changes_nothing(monkeypatch, dtype):
    """``RECOMPUTE_EXPERTS`` trades memory for a second forward of the
    held experts: the loss and every gradient are the same bits."""
    out = []
    for recompute in (True, False):
        monkeypatch.setattr(D, "RECOMPUTE_EXPERTS", recompute)
        cfg = small(dtype=dtype, first_held_expert=2, experts_held=4)
        model = init_deepseek_params(cfg, torch.Generator().manual_seed(11))
        _, loss = port_loss(model, tokens(12, cfg))
        loss.backward()
        out.append((loss.detach(), {k: p.grad
                                    for k, p in model.named_parameters()}))
    (l1, g1), (l2, g2) = out
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[k], g2[k]) for k in g1)


def test_config_guards():
    with pytest.raises(ValueError, match="held experts"):
        small(first_held_expert=6, experts_held=4)
    with pytest.raises(ValueError, match="num_experts_per_tok"):
        small(num_experts_per_tok=9)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def mesh():
    """A gloo group of one process on the CPU (destroyed afterwards)."""
    dist.init_process_group("gloo",
                            init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    try:
        yield parallel.data_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_step_trains_and_counts(mesh, dtype):
    """``make_deepseek_train_step`` over ``make_step``: the loss is the
    model's loss with the balance loss, AdamW moves every parameter, and
    the counters hold every held pair of the steps, no dropped one, and
    each forward's rows below the buffer's last offset."""
    cfg = small(dtype=dtype, first_held_expert=2, experts_held=4)
    model = init_deepseek_params(cfg, torch.Generator().manual_seed(7))
    opt = make_optimizer(model)
    step = make_deepseek_train_step(cfg, opt, mesh, 2)
    tok = tokens(8, cfg, batch=6)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        _, want = port_loss(model, tok[0:2])
    reset_moe_counters(model)
    losses, held, rows = [], 0, 0
    for s in range(3):
        losses.append(float(step(model, tok, torch.arange(6), s)))
        for m in model.moe_layers():
            held += int(((m.last_routes >= 2) & (m.last_routes < 6)).sum())
            # each held expert's group padded to ALIGN rows
            rows += sum(-(-int((m.last_routes == e).sum()) // D.ALIGN)
                        * D.ALIGN for e in range(2, 6))
    assert losses[0] == pytest.approx(float(want), rel=1e-6)
    counted = moe_counters(model)
    assert counted["tokens_dropped"] == 0
    assert sum(map(sum, counted["expert_tokens"])) == held
    assert len(counted["expert_tokens"]) == 2
    assert sum(counted["rows_filled"]) == rows
    assert len(counted["rows_filled"]) == 2
    after = model.state_dict()
    assert all(not torch.equal(before[k], after[k]) for k in before)


_TWO_RANKS = r"""
import sys
import torch
import torch.distributed as dist
from partiallyshuffledistributedsampler_tpu_torch import parallel
from partiallyshuffledistributedsampler_tpu_torch.models import (
    DeepSeekV2Config, init_deepseek_params, make_deepseek_train_step)
from partiallyshuffledistributedsampler_tpu_torch.models.train import (
    make_optimizer)
rank, port = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=rank, world_size=2)
try:
    cfg = DeepSeekV2Config(dtype=torch.float32,
                           first_held_expert=4 * rank, experts_held=4)
    model = init_deepseek_params(cfg, torch.Generator().manual_seed(0))
    try:
        make_deepseek_train_step(cfg, make_optimizer(model),
                                 parallel.data_mesh(device="cpu"), 2)
    except ValueError as e:
        print("refused:", e)
finally:
    dist.destroy_process_group()
"""


def test_the_step_refuses_a_mesh_of_two():
    """Two gloo processes, each holding other experts (the expert-parallel
    layout): the step has no all-to-all, and ``make_step``'s all-reduce
    would average different experts, so the constructor refuses."""
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_RANKS, str(r), port],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, cwd=ROOT)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        assert "refused:" in out and "world 2" in out, (out, err)
