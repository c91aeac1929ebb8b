"""Sampler-fed training on a mixture of sources: ``HostDataLoader`` in
mixture mode over the configuration's host sources, into the port's train
step, one rank of a data-parallel job (``train_loader.py`` gives the rest).

The loader serves the §8 stream of the host sources (their sizes in
``host_sources``, M1's weights, windows and block), gathering each batch
source by source (``MixtureSpec.decompose``) from views of one array of
rows; the served ids are held against the plain §8 law
(``reference/mixture_law.py``).  The model is the configuration's kind
(DeepSeek-V2: ``kinds/deepseek_v2.py``), whose weights, gradients and AdamW
moments fill most of the card.  So that the plain float32 reference fits
there after the program is released, it takes a step's batch one sequence
at a time (the loss is a per-sequence mean, so the blocks' mean loss and
gradient are the batch's), the first weights wait on the host while the
first steps run, and the steady step's state waits on the host until the
reference's AdamW reads it.  Beside ``train_loader``'s numbers, a run
compares ``tokens_dropped`` (the MoE layers' counter over every step:
(token, slot) pairs routed to a held expert that found no row) and
``route_mismatch`` (the share of the first step's (token, slot) choices,
over every MoE layer, that the reference's router does not make).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from bench_port import kinds, weights
from bench_port.reference import mixture_law
from bench_port.reference import models as ref
from bench_port.traffic import train_loader


def _host(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in host memory (a copy on the CPU route too)."""
    return t.detach().to("cpu", copy=True)


class _OnDevice(dict):
    """AdamW moments kept on the host, each moved to ``device`` when the
    reference's optimizer reads it (``models._run``), and dropped here, so
    that one copy lies on the card."""

    def __init__(self, moments: dict, device):
        super().__init__(moments)
        self.device = device

    def get(self, key, default=None):
        if key not in self:
            return default
        m, v, taken = self.pop(key)
        return m.to(self.device), v.to(self.device), taken


def route_mismatch(got: list, want: list) -> float:
    """The share of ``got``'s (token, slot) choices (a ``[tokens, k]``
    tensor a layer) that ``want`` does not make for the same token; 1
    where the two cover other tokens."""
    miss = total = 0
    for g, w in zip(got, want):
        if g.shape != w.shape:
            return 1.0
        hit = (g[:, :, None] == w.to(g.device)[:, None, :]).any(-1)
        miss += int((~hit).sum())
        total += g.numel()
    return miss / total if total else 1.0


class Driver(train_loader.Driver):
    CHECKED = train_loader.Driver.CHECKED + ("tokens_dropped",
                                             "route_mismatch")

    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 *, fault=None):
        kind = kinds.load(config["model"]["kind"])
        super().__init__(dict(config, model=kind.model_of(config)), params,
                         seed, device, fault=fault)
        mix, self.sources = config["mixture"], config["host_sources"]
        self.law = (self.sources, mix["weights"], mix["windows"],
                    mix["block"])
        self.law_kw = dict(rounds=mix["rounds"], partition=mix["partition"])

    # ----------------------------------------------------------- set-up
    def _loader(self, data, rank: int):
        from partiallyshuffledistributedsampler_tpu_torch import (
            HostDataLoader,
            MixtureSpec,
        )

        sources, mix_weights, windows, block = self.law
        spec = MixtureSpec(sources, mix_weights, windows=windows, block=block)
        ends = np.cumsum(sources)
        parts = [data[e - n:e] for n, e in zip(sources, ends)]
        p = self.params
        return HostDataLoader(
            parts, batch=self.batch, seed=self.seed, rank=rank,
            world=self.world, depth=p["depth"],
            boundary_prefetch=p["boundary_prefetch"],
            index_backend="cuda" if self.device != "cpu" else "cpu",
            device=self.device, mixture=spec, **self.law_kw)

    def setup(self):
        """``train_loader``'s set-up with the first weights on the host and
        the first step's routes kept (``first_routes``)."""
        self.setup_phases, self._t = [], time.perf_counter()
        self.rows = self._rows()
        self._phase("host rows")
        mesh = self._group()
        self._phase("process group")
        w0 = {k: _host(v) for k, v in self._prepare(mesh, self.rank).items()}
        named = dict(self.model.named_parameters())
        b1 = self.opt_cfg["betas"][0]
        for s in range(self.params["setup_steps"]):
            self._consume(next(self.feed))
            if s == 0:
                self.first_grads = ref.leaf_norms({
                    k: self.opt.state[p]["exp_avg"] / (1 - b1)
                    if p in self.opt.state else torch.zeros_like(p)
                    for k, p in named.items()})
                self.first_routes = [m.last_routes.clone()
                                     for m in self.model.moe_layers()]
            if s == 2:
                self.first_change = {
                    k: float((p.detach() - w0[k].to(p.device)).norm())
                    for k, p in named.items()}
        del w0
        if self.fault == "late_frozen":
            self.opt.step = lambda *a, **k: None
        self.sync()
        self._phase("first steps")

    # ------------------------------------------------------------- steps
    def traced(self) -> int:
        """The traced steps, with the (token, slot) pairs the held experts
        took in them (``traced_pairs``, on the card)."""
        layers = self.model.moe_layers()
        before = torch.stack([m.expert_tokens for m in layers])
        units = super().traced()
        self.traced_pairs = torch.stack([m.expert_tokens
                                         for m in layers]) - before
        return units

    def counts(self) -> dict:
        """Beside the step's model FLOPs, the held experts' product FLOPs
        a traced step, from their counter (``moe_experts_flops``)."""
        out = super().counts()
        pairs = getattr(self, "traced_pairs", None)
        if pairs is not None:
            out["moe_experts_flops"] = (
                float(pairs.sum()) * self.kind.expert_pair_flops(
                    self.model_cfg) / self.params["traced_steps"])
        return out

    def _steady_step(self):
        """``train_loader``'s steady step, its state before it kept on the
        host."""
        rng = np.random.default_rng([self.seed, 2])
        for _ in range(int(rng.integers(train_loader.STEADY_EXTRA_STEPS))):
            self._consume(next(self.feed))
        named = dict(self.model.named_parameters())
        before = {k: _host(p) for k, p in named.items()}
        moments = {k: (_host(self.opt.state[p]["exp_avg"]),
                       _host(self.opt.state[p]["exp_avg_sq"]),
                       int(self.opt.state[p]["step"]))
                   for k, p in named.items() if p in self.opt.state}
        item = next(self.feed)
        self._consume(item)
        self.steady = dict(
            place=item[2], before=before, moments=moments,
            loss=float(self.losses[-1]),
            grads=ref.leaf_norms({k: p.grad if p.grad is not None
                                  else torch.zeros_like(p)
                                  for k, p in named.items()}),
            change={k: float((p.detach() - before[k].to(p.device)).norm())
                    for k, p in named.items()})

    def release(self):
        from partiallyshuffledistributedsampler_tpu_torch.models import (
            moe_counters,
        )

        self._steady_step()
        self.moe_read = moe_counters(self.model)
        self._free()

    # ------------------------------------------------------- correctness
    def _reference_ids(self, epoch: int, rank=None,
                       device: str = "cpu") -> np.ndarray:
        rank = self.rank if rank is None else rank
        return mixture_law.epoch_indices(
            *self.law, self.seed, epoch, rank, self.world, device=device,
            **self.law_kw).cpu().numpy()

    def _step_batch(self, want_ids: dict, e: int, s: int) -> list:
        """The reference's batch of step ``s`` of epoch ``e``, a sequence
        a part."""
        ids = want_ids[e][s * self.batch:(s + 1) * self.batch]
        return [self.kind.reference_batch(self.rows, ids[i:i + 1],
                                          self.device)
                for i in range(len(ids))]

    @staticmethod
    def _routes(step: list) -> list:
        """The routes a reference step recorded, a layer a tensor over the
        step's tokens in order."""
        per = [part["routes"] for part in step]
        return [torch.cat([r[i] for r in per]) for i in sorted(per[0])]

    def readings(self, fp8: bool = False) -> dict:
        """``train_loader``'s numbers, each step's batch a sequence at a
        time, and ``tokens_dropped`` and ``route_mismatch``; with ``fp8``
        the control's (the reference at float8 in the program's place,
        its routes against the float32 reference's)."""
        want_ids = {e: self._reference_ids(e) for e in self.served}
        out = dict(mismatched_ids=self._id_errors(want_ids),
                   row_errors=self.error_count,
                   tokens_dropped=self.moe_read["tokens_dropped"])
        first = [self._step_batch(want_ids, 0, s) for s in range(3)]
        for part in first[0]:
            part["routes"] = {}
        w0 = weights.make(self.model_cfg, self.seed, self.device)
        want = ref.run_steps(w0, self.model_cfg, self.opt_cfg, first)
        want_routes = self._routes(first[0])
        if fp8:
            for part in first[0]:
                part["routes"] = {}
            got = ref.run_steps(w0, self.model_cfg, self.opt_cfg, first,
                                fp8=True)
            out["route_mismatch"] = route_mismatch(self._routes(first[0]),
                                                   want_routes)
            out.update(self._gaps(got["losses"], got["grad_norms"],
                                  got["change_norms"], want))
        else:
            out["route_mismatch"] = route_mismatch(self.first_routes,
                                                   want_routes)
            out.update(self._gaps(self.step_losses[:3].tolist(),
                                  self.first_grads, self.first_change, want))
        del w0, first
        st = self.steady
        e, s = st["place"]
        batch = [self._step_batch(want_ids, e, s)]
        before = {k: v.to(self.device) for k, v in st["before"].items()}
        want = ref.run_steps(before, self.model_cfg, self.opt_cfg, batch,
                             moments=_OnDevice(st["moments"], self.device))
        loss = st["loss"]
        if fp8:
            got = ref.run_steps(before, self.model_cfg, self.opt_cfg, batch,
                                fp8=True,
                                moments=_OnDevice(st["moments"], self.device))
            loss = got["losses"][0]
            out.update(self._gaps([loss], got["grad_norms"],
                                  got["change_norms"], want, "steady_"))
        else:
            out.update(self._gaps([loss], st["grads"], st["change"], want,
                                  "steady_"))
        out.update(steady_step=[e, s], steady_loss=[loss, want["losses"][0]])
        return out
