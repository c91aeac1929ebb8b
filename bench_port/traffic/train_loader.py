"""Sampler-fed training: ``HostDataLoader`` over host rows, into the port's
train step, one rank of a data-parallel job.

The loader serves this rank's batches (its index stream regenerated on
the card, in shard mode where the configuration has shards; the rows
gathered on the host and copied on a stream of its own); the benchmark
widens each batch on the card and calls the port's step (AdamW), both as
the model's kind says (``kinds/<kind>.py``: GPT's uint16 tokens to int64
into ``make_train_step``, ViT's uint8 pixels to float32 in [-1, 1] into
``make_vit_train_step``).  The rows carry their own id, so every
delivered batch is checked on the card against the ids the loader
served; the served ids against the law's reference; the first three
steps, which set-up runs through the same feed and step, against a plain
float32 reference (losses, the first gradient by leaf, each leaf's change
after the three); and one step in the steady state, a seed-drawn few
steps after the window, which the reference follows from the program's
own parameters and AdamW moments just before it (its loss, its gradient
and its change by leaf).
"""

from __future__ import annotations

import socket
import time

import numpy as np
import torch

from bench_port import kinds, stall, weights
from bench_port.reference import law
from bench_port.reference import models as ref
from bench_port.traffic.regen_plain import draw_rank

#: the steady step comes 0 to STEADY_EXTRA_STEPS - 1 steps (drawn from the
#: seed) after the window
STEADY_EXTRA_STEPS = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Driver:
    #: the numbers a cell may compare, each against its limit in the
    #: workload's file; a number the file gives no limit is not compared
    CHECKED = ("mismatched_ids", "row_errors", "loss_gap", "grad_gap",
               "change_gap", "steady_loss_gap", "steady_grad_gap",
               "steady_change_gap")

    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 *, fault=None):
        self.model_cfg, self.opt_cfg = config["model"], config["optimizer"]
        self.kind = kinds.load(self.model_cfg["kind"])
        #: the index stream is in shard mode where the configuration has
        #: shards, whatever the model
        self.shards = "shard_size" in config
        self.config, self.params = config, params
        self.seed, self.device = int(seed), device
        self.world, self.batch = params["world"], params["batch"]
        self.rank = draw_rank(self.seed, self.world)
        self.fault = fault
        self.served = {}
        self.losses = []
        self.failed = 0

    # ----------------------------------------------------------- set-up
    def _rows(self):
        return self.kind.host_rows(self.config)

    def _group(self):
        import torch.distributed as dist

        self.own_group = not dist.is_initialized()
        if self.own_group:
            dist.init_process_group(
                "nccl" if self.device != "cpu" else "gloo",
                init_method=f"tcp://localhost:{free_port()}", rank=0,
                world_size=1)
        from partiallyshuffledistributedsampler_tpu_torch import parallel

        return parallel.data_mesh(device=self.device)

    def _program(self, mesh, w0: dict):
        from partiallyshuffledistributedsampler_tpu_torch.models import train

        model, make_step = self.kind.program(self.model_cfg, self.device)
        model.load_state_dict(w0)
        opt = train.make_optimizer(model)
        batch = self.batch // 2 if self.fault == "half_batch" else self.batch
        if self.fault == "frozen":
            opt.step = lambda *a, **k: None  # the state comes back unchanged
        return model, opt, make_step(opt, mesh, batch), batch

    def _loader(self, data, rank: int):
        from partiallyshuffledistributedsampler_tpu_torch import HostDataLoader

        c, p = self.config, self.params
        kw = dict(window=c["window"], batch=self.batch, seed=self.seed,
                  rank=rank, world=self.world, depth=p["depth"],
                  boundary_prefetch=p["boundary_prefetch"],
                  index_backend="cuda" if self.device != "cpu" else "cpu",
                  device=self.device)
        if self.shards:
            kw["shard_sizes"] = [c["shard_size"]] * c["host_shards"]
            kw["within_shard_shuffle"] = c["within_shard_shuffle"]
        return HostDataLoader(data, **kw)

    def _feed(self):
        """The loader's batches over epochs 0, 1, ..., each with the ids
        the loader's own index stream says it holds (on the device) and
        its place, ``(epoch, step)``."""
        e = 0
        while True:
            ids = self.loader.epoch_indices(e)
            self.served[e] = ids
            dev_ids = torch.from_numpy(ids.astype(np.int64)).to(self.device)
            for s, b in enumerate(self.loader.epoch(e)):
                yield b, dev_ids[s * self.batch:(s + 1) * self.batch], (e, s)
            e += 1

    def _phase(self, name):
        now = time.perf_counter()
        self.setup_phases.append((name, round(now - self._t, 3)))
        self._t = now

    def _prepare(self, mesh, loader_rank: int) -> dict:
        """Everything before the first step: the weights from the seed, the
        program, the loader over this rank's stream and the feed; returns
        the weights."""
        w0 = weights.make(self.model_cfg, self.seed, self.device)
        self._phase("weights")
        self.model, self.opt, self.step, self.fed = self._program(mesh, w0)
        self._phase("model and step")
        self.loader = self._loader(self.rows, loader_rank)
        self._phase("loader")
        self.in_order = torch.arange(self.fed, device=self.device)
        self.errors = torch.zeros((), dtype=torch.int64, device=self.device)
        self.check_rows = self.kind.row_check(self.config, self.device)
        self.feed = self._feed()
        return w0

    def setup(self):
        self.setup_phases, self._t = [], time.perf_counter()
        self.rows = self._rows()
        self._phase("host rows")
        mesh = self._group()
        self._phase("process group")
        w0 = self._prepare(mesh, self.rank)
        named = dict(self.model.named_parameters())
        b1 = self.opt_cfg["betas"][0]
        for s in range(self.params["setup_steps"]):
            self._consume(next(self.feed))
            if s == 0:
                self.first_grads = ref.leaf_norms({
                    k: self.opt.state[p]["exp_avg"] / (1 - b1)
                    if p in self.opt.state else torch.zeros_like(p)
                    for k, p in named.items()})
            if s == 2:
                self.first_change = ref.leaf_norms(
                    {k: p.detach() - w0[k] for k, p in named.items()})
        del w0
        if self.fault == "late_frozen":  # unchanged from here on
            self.opt.step = lambda *a, **k: None
        self.sync()
        self._phase("first steps")

    def sync(self):
        if self.device != "cpu":
            torch.cuda.synchronize()

    # ------------------------------------------------------------- steps
    def _consume(self, item):
        """One step on a served batch: widened on the card, its rows
        checked against the ids the loader's stream says it holds, then
        the port's step on its first ``fed`` rows."""
        b, want, _ = item
        served = self.kind.widen(b)
        if self.fault == "altered_row":
            self.kind.alter(served)
        self.errors += self.check_rows(served, want)
        loss = self.step(self.model, *self.kind.step_inputs(served, self.fed),
                         self.in_order, 0)
        self.losses.append(loss)

    def window(self, seconds: float) -> dict:
        probe = stall.StallProbe(self.feed)
        it = iter(probe)
        steps, t0 = 0, time.perf_counter()
        while True:
            self._consume(next(it))
            steps += 1
            if time.perf_counter() - t0 >= seconds:
                break
        it.close()
        self.sync()
        wall = time.perf_counter() - t0
        return dict(attempted=steps, steps=steps, wall_s=wall,
                    wait_s=probe.wait_s, compute_s=probe.compute_s,
                    metrics=dict(train_samples_per_s=steps * self.batch
                                 / wall))

    def traced(self) -> int:
        """The traced steps, with a CUDA event recorded on the stream at
        each one's end (``trace.step_times`` reads them)."""
        self.step_marks = []
        for _ in range(self.params["traced_steps"]):
            self._consume(next(self.feed))
            mark = torch.cuda.Event(enable_timing=True)
            mark.record()
            self.step_marks.append(mark)
        return self.params["traced_steps"]

    def counts(self) -> dict:
        return {"train_step_flops": self.kind.train_step_flops(
            self.model_cfg, self.batch)}

    def _steady_step(self):
        """A seed-drawn 0 to ``STEADY_EXTRA_STEPS`` - 1 steps after the
        window, then one step through the same feed and call whose state
        just before it is kept (parameters and AdamW moments) for the
        reference to follow, with the program's loss, gradient (as the
        optimizer got it) and change by leaf."""
        rng = np.random.default_rng([self.seed, 2])
        for _ in range(int(rng.integers(STEADY_EXTRA_STEPS))):
            self._consume(next(self.feed))
        named = dict(self.model.named_parameters())
        before = {k: p.detach().clone() for k, p in named.items()}
        moments = {k: (self.opt.state[p]["exp_avg"].clone(),
                       self.opt.state[p]["exp_avg_sq"].clone(),
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
            change=ref.leaf_norms({k: p.detach() - before[k]
                                   for k, p in named.items()}))

    def release(self):
        self._steady_step()
        self._free()

    def _free(self):
        self.feed.close()
        self.loader.close()
        self.step_losses = torch.stack(self.losses).float().cpu()
        self.error_count = int(self.errors)
        self.model = self.opt = self.step = self.loader = self.feed = None
        self.losses = []
        if self.own_group:
            import torch.distributed as dist

            dist.destroy_process_group()
        if self.device != "cpu":
            torch.cuda.empty_cache()

    # ------------------------------------------------------- correctness
    def _reference_ids(self, epoch: int, rank=None,
                       device: str = "cpu") -> np.ndarray:
        """The law's ids of ``rank`` (this driver's by default) in
        ``epoch``, worked out on ``device``: shard mode where the
        configuration has shards."""
        c = self.config
        rank = self.rank if rank is None else rank
        if self.shards:
            sids = law.epoch_indices(c["host_shards"], c["window"], self.seed,
                                     epoch, rank, self.world, device=device)
            sizes = torch.full((c["host_shards"],), c["shard_size"],
                               dtype=torch.int64, device=device)
            return law.expand_shards(
                sids, sizes, self.seed, epoch,
                within_shard_shuffle=c["within_shard_shuffle"]).cpu().numpy()
        return law.epoch_indices(c["host_rows"], c["window"], self.seed,
                                 epoch, rank, self.world,
                                 device=device).cpu().numpy()

    def _id_errors(self, want_ids: dict) -> int:
        """Served ids that differ from the law's (every id of an epoch
        served at another length)."""
        return sum(int((np.asarray(got, np.int64) != want_ids[e]).sum())
                   if len(got) == len(want_ids[e]) else len(want_ids[e])
                   for e, got in self.served.items())

    def _step_batch(self, want_ids: dict, e: int, s: int):
        """The reference's batch of step ``s`` of epoch ``e``: the rows of
        the law's ids."""
        ids = want_ids[e][s * self.batch:(s + 1) * self.batch]
        return self.kind.reference_batch(self.rows, ids, self.device)

    @staticmethod
    def _gaps(losses, grads, change, want, prefix="") -> dict:
        """The largest loss gap as a share of the reference's loss, and
        the worst leaf of the gradient and of the change (``reference.
        models.leaf_gap``; the change over the leaves the reference's
        gradient moves)."""
        loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                           want["losses"]))
        grad_gap, grad_leaf = ref.leaf_gap(grads, want["grad_norms"])
        change_gap, change_leaf = ref.leaf_gap(
            change, want["change_norms"],
            ref.moving_leaves(want["grad_norms"]))
        return {prefix + "loss_gap": loss_gap, prefix + "grad_gap": grad_gap,
                prefix + "change_gap": change_gap,
                prefix + "grad_leaf": grad_leaf,
                prefix + "change_leaf": change_leaf}

    def readings(self, fp8: bool = False) -> dict:
        """The numbers compared: the ids served against the law's, the
        rows delivered against their ids, the first three steps from the
        seed's weights and the steady step from the program's state just
        before it (``_gaps``).  ``fp8`` puts the reference in float8 in
        the program's place: the control."""
        want_ids = {e: self._reference_ids(e) for e in self.served}
        out = dict(mismatched_ids=self._id_errors(want_ids),
                   row_errors=self.error_count)
        first = [self._step_batch(want_ids, 0, s) for s in range(3)]
        w0 = weights.make(self.model_cfg, self.seed, self.device)
        want = ref.run_steps(w0, self.model_cfg, self.opt_cfg, first)
        if fp8:
            got = ref.run_steps(w0, self.model_cfg, self.opt_cfg, first,
                                fp8=True)
            out.update(self._gaps(got["losses"], got["grad_norms"],
                                  got["change_norms"], want))
        else:
            out.update(self._gaps(self.step_losses[:3].tolist(),
                                  self.first_grads, self.first_change, want))
        del w0, first
        st = self.steady
        e, s = st["place"]
        batch = [self._step_batch(want_ids, e, s)]
        want = ref.run_steps(st["before"], self.model_cfg, self.opt_cfg,
                             batch, moments=st["moments"])
        loss = st["loss"]
        if fp8:
            got = ref.run_steps(st["before"], self.model_cfg, self.opt_cfg,
                                batch, fp8=True, moments=st["moments"])
            loss = got["losses"][0]
            out.update(self._gaps([loss], got["grad_norms"],
                                  got["change_norms"], want, "steady_"))
        else:
            out.update(self._gaps([loss], st["grads"], st["change"], want,
                                  "steady_"))
        out.update(steady_step=[e, s], steady_loss=[loss, want["losses"][0]])
        return out

    def checks(self, fp8: bool = False) -> list:
        """``[(name, value, limit)]`` of the ``CHECKED`` numbers; with
        ``fp8``, the control's."""
        r = self.last_readings = self.readings(fp8)
        limits = self.params["limits"]
        out = [(k, r[k], limits[k]) for k in self.CHECKED if k in limits]
        self.failed = sum(v > lim for _, v, lim in out)
        return out
