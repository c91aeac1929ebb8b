"""Sampler-fed training: ``HostDataLoader`` over host rows, into the port's
train step, one rank of a data-parallel job.

The loader serves this rank's batches (its index stream regenerated on
the card, the rows gathered on the host and copied on a stream of its
own); the benchmark widens each batch on the card (uint16 tokens to
int64, or uint8 pixels to float32 in [-1, 1]) and calls the port's step
(``make_train_step`` or ``make_vit_train_step``, AdamW).  The rows carry
their own id, so every delivered batch is checked on the card against the
ids the loader served; the served ids against the law's reference; the
first three steps, which set-up runs through the same feed and step,
against a plain float32 reference (losses, the first gradient by leaf,
each leaf's change after the three); and one step in the steady state, a
seed-drawn few steps after the window, which the reference follows from
the program's own parameters and AdamW moments just before it (its loss,
its gradient and its change by leaf).
"""

from __future__ import annotations

import socket
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from bench_port import stall, weights
from bench_port.counts import model as model_counts
from bench_port.reference import law
from bench_port.reference import models as ref
from bench_port.traffic.regen_plain import draw_rank

#: a token row holds its id in its first two tokens (id % ID_BASE, id //
#: ID_BASE) and (id + j) % vocab at token j
ID_BASE = 50_000
#: an image row holds its id in its first four bytes (little-endian) and
#: (PIX_STRIDE * id + j) % PIX_MOD at byte j; its label is
#: (id * LABEL_STRIDE) % classes
PIX_STRIDE, PIX_MOD, LABEL_STRIDE = 7, 251, 7919
CHUNK_BYTES = 64 << 20
#: the steady step comes 0 to STEADY_EXTRA_STEPS - 1 steps (drawn from the
#: seed) after the window
STEADY_EXTRA_STEPS = 4
#: the numbers a cell may compare, each against its limit in the
#: workload's file; a number the file gives no limit is not compared
CHECKED = ("mismatched_ids", "row_errors", "loss_gap", "grad_gap",
           "change_gap", "steady_loss_gap", "steady_grad_gap",
           "steady_change_gap")


def _fill(out: np.ndarray, tmpl: np.ndarray, key) -> None:
    """``out[r] = tmpl[key(r):key(r) + width]`` for every row: the
    template's windows laid out once, then taken in chunks on threads."""
    win = np.ascontiguousarray(np.lib.stride_tricks.sliding_window_view(
        tmpl, out.shape[1]))
    chunk = max(1, CHUNK_BYTES // out[0].nbytes)

    def part(c):
        r = np.arange(c, min(len(out), c + chunk), dtype=np.int64)
        np.take(win, key(r), axis=0, out=out[c:c + r.size], mode="clip")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(part, range(0, len(out), chunk)))


def token_rows(rows: int, seq: int, vocab: int) -> np.ndarray:
    width = seq + 1
    tmpl = (np.arange(vocab + width, dtype=np.int64) % vocab).astype(
        np.uint16)
    out = np.empty((rows, width), dtype=np.uint16)
    _fill(out, tmpl, lambda r: r % vocab)
    ids = np.arange(rows, dtype=np.int64)
    out[:, 0] = ids % ID_BASE
    out[:, 1] = ids // ID_BASE
    return out


def image_rows(rows: int, shape: tuple) -> np.ndarray:
    size = int(np.prod(shape))
    tmpl = (np.arange(size + PIX_MOD, dtype=np.int64) % PIX_MOD).astype(
        np.uint8)
    out = np.empty((rows, size), dtype=np.uint8)
    _fill(out, tmpl, lambda r: (PIX_STRIDE * r) % PIX_MOD)
    out[:, :4] = np.arange(rows, dtype="<u4").view(np.uint8).reshape(rows, 4)
    return out.reshape((rows,) + tuple(shape))


def u16_tokens(b: torch.Tensor) -> torch.Tensor:
    """A served uint16 batch as int64 tokens, combined from its bytes on
    the card (uint16 tensors take few operations)."""
    b8 = b.contiguous().view(torch.uint8).to(torch.int64)
    return b8[..., 0::2] + 256 * b8[..., 1::2]


def widen_pixels(x: torch.Tensor) -> torch.Tensor:
    return x.float().mul_(2.0 / 255.0).sub_(1.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class Driver:
    def __init__(self, config: dict, params: dict, seed: int, device: str,
                 *, fault=None):
        self.model_cfg, self.opt_cfg = config["model"], config["optimizer"]
        self.vit = self.model_cfg["kind"] == "vit"
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
        c = self.config
        if self.vit:
            m = self.model_cfg
            n = c["host_shards"] * c["shard_size"]
            images = image_rows(n, (m["image_size"], m["image_size"],
                                    m["channels"]))
            labels = ((np.arange(n, dtype=np.int64) * LABEL_STRIDE)
                      % m["num_classes"]).astype(np.int32)
            return {"x": images, "y": labels}
        return token_rows(c["host_rows"], self.model_cfg["seq_len"],
                          self.model_cfg["vocab_size"])

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
        from partiallyshuffledistributedsampler_tpu_torch.models import (
            gpt,
            train,
            vit,
        )

        m = self.model_cfg
        widths = {k: m[k] for k in m if k not in ("kind", "dtype")}
        dtype = getattr(torch, m["dtype"])
        with torch.device(self.device):
            if self.vit:
                cfg = vit.ViTConfig(dtype=dtype, **widths)
                model = vit.MiniViT(cfg)
            else:
                cfg = gpt.GPTConfig(dtype=dtype, **widths)
                model = gpt.MiniGPT(cfg)
        model.load_state_dict(w0)
        opt = train.make_optimizer(model)
        batch = self.batch // 2 if self.fault == "half_batch" else self.batch
        make = vit.make_vit_train_step if self.vit else train.make_train_step
        if self.fault == "frozen":
            opt.step = lambda *a, **k: None  # the state comes back unchanged
        return model, opt, make(cfg, opt, mesh, batch), batch

    def _loader(self, data):
        from partiallyshuffledistributedsampler_tpu_torch import HostDataLoader

        c, p = self.config, self.params
        kw = dict(window=c["window"], batch=self.batch, seed=self.seed,
                  rank=self.rank, world=self.world, depth=p["depth"],
                  boundary_prefetch=p["boundary_prefetch"],
                  index_backend="cuda" if self.device != "cpu" else "cpu",
                  device=self.device)
        if self.vit:
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

    def setup(self):
        self.setup_phases, self._t = [], time.perf_counter()
        self.rows = self._rows()
        self._phase("host rows")
        mesh = self._group()
        self._phase("process group")
        w0 = weights.make(self.model_cfg, self.seed, self.device)
        self._phase("weights")
        self.model, self.opt, self.step, self.fed = self._program(mesh, w0)
        self._phase("model and step")
        self.loader = self._loader(self.rows)
        self._phase("loader")
        self.in_order = torch.arange(self.fed, device=self.device)
        self.errors = torch.zeros((), dtype=torch.int64, device=self.device)
        if self.vit:
            size = int(np.prod(self.rows["x"].shape[1:]))
            self.byte_pos = torch.arange(size, dtype=torch.int32,
                                         device=self.device)
        self.feed = self._feed()
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
    def _row_errors(self, b, want):
        """Rows of a delivered batch that break their pattern or hold
        another id than the loader's stream says (a device scalar)."""
        if self.vit:
            x, y = b["x"], b["y"]
            flat = x.reshape(x.shape[0], -1)
            w = flat[:, :4].to(torch.int64)
            rid = w[:, 0] + (w[:, 1] << 8) + (w[:, 2] << 16) + (w[:, 3] << 24)
            pix = (PIX_STRIDE * rid.to(torch.int32))[:, None] + self.byte_pos
            return ((rid != want).sum() + (y.long() != (
                rid * LABEL_STRIDE) % self.model_cfg["num_classes"]).sum()
                + (flat[:, 4:] != (pix[:, 4:] % PIX_MOD)).sum())
        rid = b[:, 0] + ID_BASE * b[:, 1]
        j = torch.arange(b.shape[1], device=b.device)
        pat = (rid[:, None] + j) % self.model_cfg["vocab_size"]
        return (rid != want).sum() + (b[:, 2:] != pat[:, 2:]).sum()

    def _consume(self, item):
        b, want, _ = item
        if self.vit:
            if self.fault == "altered_row":
                b["x"][0, 0, 1, 2] += 1
            self.errors += self._row_errors(b, want)
            x, y = widen_pixels(b["x"][:self.fed]), b["y"][:self.fed]
            loss = self.step(self.model, x, y, self.in_order, 0)
        else:
            tokens = u16_tokens(b)
            if self.fault == "altered_row":
                tokens[0, 5] += 1
            self.errors += self._row_errors(tokens, want)
            loss = self.step(self.model, tokens[:self.fed], self.in_order, 0)
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
        return {"train_step_flops": model_counts.train_step_flops(
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
    def _reference_ids(self, epoch: int) -> np.ndarray:
        c = self.config
        if self.vit:
            sids = law.epoch_indices(c["host_shards"], c["window"], self.seed,
                                     epoch, self.rank, self.world)
            sizes = torch.full((c["host_shards"],), c["shard_size"],
                               dtype=torch.int64)
            return law.expand_shards(
                sids, sizes, self.seed, epoch,
                within_shard_shuffle=c["within_shard_shuffle"]).numpy()
        return law.epoch_indices(c["host_rows"], c["window"], self.seed,
                                 epoch, self.rank, self.world).numpy()

    def _reference_batch(self, ids: np.ndarray) -> dict:
        if self.vit:
            x = torch.from_numpy(self.rows["x"][ids]).to(self.device)
            y = torch.from_numpy(self.rows["y"][ids]).to(self.device)
            return {"images": widen_pixels(x), "labels": y}
        tok = torch.from_numpy(self.rows[ids].astype(np.int64))
        return {"tokens": tok.to(self.device)}

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
        bad_ids = sum(int((np.asarray(got, np.int64) != want_ids[e]).sum())
                      if len(got) == len(want_ids[e]) else len(want_ids[e])
                      for e, got in self.served.items())
        out = dict(mismatched_ids=bad_ids, row_errors=self.error_count)
        first = [self._reference_batch(i) for i in
                 want_ids[0][:3 * self.batch].reshape(3, self.batch)]
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
        batch = [self._reference_batch(
            want_ids[e][s * self.batch:(s + 1) * self.batch])]
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
        out = [(k, r[k], limits[k]) for k in CHECKED if k in limits]
        self.failed = sum(v > lim for _, v, lim in out)
        return out
