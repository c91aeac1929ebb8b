"""Sampler-fed data-parallel training across cards: one rank a card, each
rank's ``HostDataLoader`` over its share of the same host rows, into the
port's unchanged train step, whose gradient all-reduce joins the ranks.

The harness's process is rank 0, on the first card.  Set-up builds the
host rows once, in anonymous shared memory (one ``memfd`` an array), and
starts ranks 1 to ``world`` - 1 as child processes, one on each of the next
cards; each inherits the rows' file descriptors and maps them read-only,
so the host holds one copy whatever the world.  A child imports the port
and ``bench_port`` alone.  The ranks form one process group (NCCL on the
card, gloo on the CPU) whose rendezvous and collectives time out after
``GROUP_TIMEOUT_S``, and each builds the port's step over a data mesh of
``world``.

Rank 0 keeps the ranks in lock step on the host, with no collective and
no device sync of its own: as it queues a step it writes one byte to each
child's pipe, and a child queues its step only on reading it.  So
every rank runs the same steps, and the all-reduce of each joins them on
the card.  A child dies with rank 0 (``PR_SET_PDEATHSIG``) and leaves on
its pipe's end; rank 0 ends a run whose child dies early, and stops and
waits for every child in ``close()``, after a run or a failure alike.

The rate is the job's: ``steps x batch x world`` over rank 0's wall.  The
per-layer readings are rank 0's, but for the traced device time, which
each child reads under its own profiler over the same steps
(``peer_times``) for the harness to average over the cards.  Correctness
on rank 0 after ``release()``: the ids each rank served against the law's
for its rank (a child works the law's out on its own card once its
program's state is freed), and its rows, summed over the ranks; the first
three steps and the steady step against the float32 reference over the
union of the ranks' batches in rank order (``reference.models`` takes them
one rank at a time; with equal rows and tokens a rank that is the
all-reduced mean); and ``rank_param_gap``, the largest difference
between any child's parameters and rank 0's after the steady step (every
rank is given the same reduced gradient, so it is 0).  Each child also
reports the top-level modules it holds that a run must not
(``harness.FORBIDDEN``), read once its window has closed, and
``release()`` raises where one does.  Both sides time the phases of their
set-up and of the run's end, and rank 0 prints them on standard error.

Faults of a cell of this kind, beside those of ``train_loader``:
``no_allreduce`` (every rank steps on its own gradient), and a fault
named ``peer_<fault>`` planted in rank ``FAULTY_PEER`` alone:
``peer_rank0_ids`` (it is served rank 0's ids), ``peer_perturbed`` (its
parameters are moved before the window), ``peer_altered_row``, and
``peer_forbidden_import`` (a module named ``jax`` appears in it at the
window's start, which no check of rank 0's own process can see).
"""

from __future__ import annotations

import atexit
import importlib
import json
import math
import mmap
import os
import select
import subprocess
import sys
import threading
import time
import types

if __name__ == "__main__":  # a child rank: the repository's root on the path
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from bench_port import weights  # noqa: E402
from bench_port.counts import link  # noqa: E402
from bench_port.harness import (  # noqa: E402
    ROOT,
    BenchError,
    forbidden_modules,
    process_age_s,
)
from bench_port.traffic import train_loader  # noqa: E402

#: seconds the group's rendezvous and each collective may take
GROUP_TIMEOUT_S = 120
#: seconds rank 0 waits for a child's acknowledgement, report or exit
PEER_TIMEOUT_S = 90
#: rank 0's messages to a child, one byte each: queue a step, start and
#: stop the profiler, end the run
QUEUE, TRACE_ON, TRACE_OFF, END = b"q", b"p", b"x", b"e"
#: the child that a fault named ``peer_<fault>`` is planted in
FAULTY_PEER = 1
#: what ``peer_perturbed`` adds to the child's first parameter leaf
PERTURBATION = 1e-4
#: host rows shared by the drivers of one process, by configuration
_SHARED: dict = {}


def planted(fault, rank: int):
    """The fault that ``rank`` plants: the job's, or for ``peer_<fault>``
    that fault in rank ``FAULTY_PEER`` alone."""
    if fault and fault.startswith("peer_"):
        return fault[len("peer_"):] if rank == FAULTY_PEER else None
    return fault


class SharedRows:
    """Arrays in anonymous shared memory, one ``memfd`` each, that child
    processes inherit and map."""

    def __init__(self):
        self.fds, self.addrs, self.maps = [], [], []

    def alloc(self, shape, dtype) -> np.ndarray:
        nbytes = math.prod(shape) * np.dtype(dtype).itemsize
        fd = os.memfd_create("bench_port_rows")
        os.ftruncate(fd, nbytes)
        mm = mmap.mmap(fd, nbytes)
        out = np.ndarray(shape, dtype, buffer=mm)
        self.fds.append(fd)
        self.maps.append(mm)
        self.addrs.append(out.__array_interface__["data"][0])
        return out

    def layout(self, data) -> list:
        """How a child maps ``data`` (an array or a dict of arrays, each
        the whole of one of these buffers): ``[[key, fd, shape, dtype]]``."""
        items = data.items() if isinstance(data, dict) else [(None, data)]
        out = []
        for key, arr in items:
            at = self.addrs.index(arr.__array_interface__["data"][0])
            assert arr.flags.c_contiguous and arr.nbytes == len(self.maps[at])
            out.append([key, self.fds[at], list(arr.shape), arr.dtype.str])
        return out


def map_rows(layout: list):
    """The rows of ``SharedRows.layout``, mapped read-only."""
    out = {}
    for key, fd, shape, dtype in layout:
        mm = mmap.mmap(fd, math.prod(shape) * np.dtype(dtype).itemsize,
                       prot=mmap.PROT_READ)
        out[key] = np.ndarray(tuple(shape), dtype, buffer=mm)
    return out[None] if list(out) == [None] else out


class _Rank(train_loader.Driver):
    """What every rank of the job does: the group of ``world`` at
    ``init_method``, the faults of this kind, one step a ``_consume``."""

    CHECKED = train_loader.Driver.CHECKED + ("rank_param_gap",)

    def __init__(self, config, params, seed, device, *, fault=None,
                 rank=0):
        super().__init__(config, params, seed, device,
                         fault=planted(fault, rank))
        self.job_fault, self.rank = fault, rank
        self._unpatch = None

    def _group(self):
        import torch.distributed as dist
        from datetime import timedelta

        from partiallyshuffledistributedsampler_tpu_torch import parallel

        self.own_group = True
        dist.init_process_group(
            "nccl" if self.device != "cpu" else "gloo",
            init_method=self.init_method, rank=self.rank,
            world_size=self.world, timeout=timedelta(seconds=GROUP_TIMEOUT_S))
        return parallel.data_mesh(device=self.device)

    def _program(self, mesh, w0):
        out = super()._program(mesh, w0)
        if self.fault == "no_allreduce":
            from partiallyshuffledistributedsampler_tpu_torch.models import (
                train,
            )

            real = train.dist
            train.dist = types.SimpleNamespace(
                all_reduce=lambda *a, **k: None)
            self._unpatch = lambda: setattr(train, "dist", real)
        return out

    def _loader(self, data, rank):
        return super()._loader(data, 0 if self.fault == "rank0_ids" else rank)

    def _consume(self, item):
        super()._consume(item)
        # at world > 1 the port's loss is a view of its flat all-reduce
        # buffer, the size of every gradient: keep the loss, not the buffer
        # (a fault of the port, PERF.md's first open question)
        self.losses[-1] = self.losses[-1].clone()

    @staticmethod
    def _warm():
        """The port's step and its first optimizer's lazy imports (seconds
        on the card's host), paid before the rendezvous, where the ranks
        pay them side by side."""
        importlib.import_module(
            "partiallyshuffledistributedsampler_tpu_torch.models.train")
        torch.optim.AdamW([torch.zeros(1, requires_grad=True)])

    def _restore(self):
        if self._unpatch is not None:
            self._unpatch()
            self._unpatch = None


class Peer(_Rank):
    """Rank 1 to ``world`` - 1, in a child process: follows rank 0's
    messages, then reports its checks on its report pipe."""

    def __init__(self, boot: dict):
        super().__init__(boot["config"], boot["params"], boot["seed"],
                         boot["device"], fault=boot["fault"],
                         rank=boot["rank"])
        self.init_method, self.layout = boot["init_method"], boot["rows"]
        self.report = os.fdopen(boot["report_fd"], "w")
        self.times = None

    def _say(self, **what):
        self.report.write(json.dumps(what) + "\n")
        self.report.flush()

    def run(self, inbox) -> int:
        self.setup_phases = [("start", round(process_age_s(), 3))]
        self._t = time.perf_counter()
        self.rows = map_rows(self.layout)
        self._phase("host rows")
        self._warm()
        self._phase("imports")
        mesh = self._group()
        self._phase("process group")
        self._prepare(mesh, self.rank)
        steps, prof = 0, None
        while True:
            op = inbox.read(1)
            if op == QUEUE:
                self._consume(next(self.feed))
                steps += 1
                if steps == self.params["setup_steps"]:
                    self._window_starts()
            elif op == TRACE_ON:
                from torch.profiler import ProfilerActivity, profile

                self.sync()
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.__enter__()
                self._say(ack=True)
            elif op == TRACE_OFF:
                from bench_port import trace

                self.sync()
                prof.__exit__(None, None, None)
                s = trace.summarize(list(prof.events()))
                self.times, prof = [s["busy_s"], s["window_s"]], None
            elif op == END:
                break
            else:  # rank 0 has gone
                return 3
        # ``_phase`` times the run's end from here
        setup_phases, self.setup_phases = self.setup_phases, []
        self._t = time.perf_counter()
        self.sync()
        peak = (torch.cuda.max_memory_allocated() if self.device != "cpu"
                else 0)
        forbidden = forbidden_modules()
        self._phase("sync")
        gap = self._param_gap()
        self._phase("parameters")
        self.feed.close()
        self.loader.close()
        # the program's state goes before the reference: the law's ids on
        # the card take milliseconds, where three ranks working them out on
        # the host side by side took seconds each
        self.model = self.opt = self.step = self.loader = self.feed = None
        self.losses = []
        if self.device != "cpu":
            torch.cuda.empty_cache()
        self._phase("loader close, state freed")
        want = {e: self._reference_ids(e, device=self.device)
                for e in self.served}
        self._phase("law ids")
        mismatched = self._id_errors(want)
        self._phase("id check")
        self._say(rank=self.rank, mismatched_ids=mismatched,
                  row_errors=int(self.errors), rank_param_gap=gap,
                  memory_peak_bytes=int(peak), times=self.times,
                  forbidden=forbidden, setup_phases=setup_phases,
                  release_phases=self.setup_phases)
        import torch.distributed as dist

        t0 = time.perf_counter()
        dist.destroy_process_group()  # with rank 0, which has the reports
        print(f"rank {self.rank} release group end: "
              f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
        return 0

    def _window_starts(self):
        if self.fault == "late_frozen":  # unchanged from here on
            self.opt.step = lambda *a, **k: None
        if self.fault == "forbidden_import":
            sys.modules.setdefault("jax", types.ModuleType("jax"))
        if self.fault == "perturbed":
            with torch.no_grad():
                next(self.model.parameters()).add_(PERTURBATION)

    def _param_gap(self) -> float:
        """The largest |difference| between this rank's parameters and
        rank 0's, leaf by leaf as rank 0 broadcasts them."""
        import torch.distributed as dist

        gap = 0.0
        for p in self.model.parameters():
            theirs = torch.empty_like(p)
            dist.broadcast(theirs, src=0)
            gap = max(gap, float((p.detach() - theirs).abs().max()))
        return gap


class Driver(_Rank):
    """Rank 0, in the harness's process."""

    def __init__(self, config, params, seed, device, *, fault=None):
        super().__init__(config, params, seed, device, fault=fault, rank=0)
        self.peers = []
        self.peer_reports, self.peer_times = [], []
        self.peer_peak_bytes = 0
        self._ending = threading.Event()
        self._law_cache = {}

    # ----------------------------------------------------------- set-up
    def _shared(self):
        """The host rows and their layout, made once a process for a
        configuration (a control's seeds share them)."""
        key = json.dumps(self.config, sort_keys=True)
        if key not in _SHARED:
            arena = SharedRows()
            data = self.kind.host_rows(self.config, arena.alloc)
            _SHARED[key] = (data, arena.layout(data), arena)
        return _SHARED[key]

    def _rows(self):
        return self._shared()[0]

    def _group(self):
        if self.device != "cpu":  # built once, before the children look
            from partiallyshuffledistributedsampler_tpu_torch.ops import (
                cuda_kernel,
            )

            cuda_kernel.build()
        self.init_method = f"tcp://localhost:{train_loader.free_port()}"
        self._spawn(self._shared()[1])
        self._phase("children")
        self._warm()
        self._phase("imports")
        return super()._group()

    def _spawn(self, layout):
        atexit.register(self.close)
        for rank in range(1, self.world):
            read_fd, write_fd = os.pipe()
            proc = subprocess.Popen(
                [sys.executable, __file__], cwd=ROOT, stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL,
                pass_fds=[fd for _, fd, _, _ in layout] + [write_fd])
            os.close(write_fd)
            boot = dict(config=self.config, params=self.params,
                        seed=self.seed, device=self.device,
                        fault=self.job_fault, rank=rank,
                        init_method=self.init_method, rows=layout,
                        report_fd=write_fd, parent=os.getpid())
            proc.stdin.write(json.dumps(boot).encode() + b"\n")
            proc.stdin.flush()
            self.peers.append((rank, proc, read_fd))
        threading.Thread(target=self._watch, daemon=True).start()

    def _watch(self):
        """End the run where a child ends before rank 0 has ended it: on
        the card rank 0 would wait in the next all-reduce for ever."""
        while not self._ending.wait(0.5):
            for rank, proc, _ in self.peers:
                code = proc.poll()
                if code is not None and not self._ending.is_set():
                    print(f"bench_port: rank {rank} ended with {code} "
                          "before the run's end", file=sys.stderr)
                    self._ending.set()
                    self._stop_peers()
                    if self.device != "cpu":  # gloo fails on its own
                        os._exit(3)
                    return

    def _tell(self, op: bytes):
        for _, proc, _ in self.peers:
            os.write(proc.stdin.fileno(), op)

    def _line(self, fd) -> str:
        """One line from a child's report pipe, or a ``BenchError``."""
        buf, deadline = b"", time.monotonic() + PEER_TIMEOUT_S
        while not buf.endswith(b"\n"):
            left = deadline - time.monotonic()
            if left <= 0 or not select.select([fd], [], [], left)[0]:
                raise BenchError("a child rank gave no report in time")
            part = os.read(fd, 1 << 16)
            if not part:
                raise BenchError("a child rank ended without its report")
            buf += part
        return buf.decode()

    # ------------------------------------------------------------- steps
    def _consume(self, item):
        self._tell(QUEUE)  # first: gloo's all-reduce blocks the host
        super()._consume(item)

    def window(self, seconds: float) -> dict:
        out = super().window(seconds)
        out["metrics"]["train_samples_per_s"] = (
            out["steps"] * self.batch * self.world / out["wall_s"])
        return out

    def traced(self) -> int:
        self._tell(TRACE_ON)
        for _, _, fd in self.peers:
            self._line(fd)
        units = super().traced()
        self._tell(TRACE_OFF)
        return units

    def counts(self) -> dict:
        params = sum(math.prod(shape) for _, shape, _
                     in weights.leaves(self.model_cfg))
        return {"train_step_flops": self.world * self.kind.train_step_flops(
                    self.model_cfg, self.batch),
                "allreduce_bytes": link.allreduce_bytes(params),
                "world": self.world}

    def release(self):
        """The steady step, then the run's end on every rank; raises
        where a child held a forbidden module once its window closed."""
        import torch.distributed as dist

        # ``_phase`` times the run's end from here (the harness has printed
        # set-up's)
        self.setup_phases, self._t = [], time.perf_counter()
        self._steady_step()
        self._phase("steady step")
        self._ending.set()
        self._tell(END)
        for p in self.model.parameters():
            dist.broadcast(p.detach(), src=0)
        self._phase("parameters")
        self.peer_reports = [json.loads(self._line(fd))
                             for _, _, fd in self.peers]
        self._phase("reports")
        self.peer_times = [r["times"] for r in self.peer_reports
                           if r["times"]]
        self.peer_peak_bytes = max(r["memory_peak_bytes"]
                                   for r in self.peer_reports)
        self._restore()
        self._free()  # the group ends on every rank together (NCCL waits)
        self._phase("group end")
        for rank, proc, _ in self.peers:
            if proc.wait(timeout=PEER_TIMEOUT_S) != 0:
                raise BenchError(f"rank {rank} ended with {proc.returncode}")
        self._phase("exits")
        for r in self.peer_reports:
            for what in ("setup", "release"):
                print(f"rank {r['rank']} {what}: " + ", ".join(
                    f"{n} {s} s" for n, s in r[f"{what}_phases"]),
                    file=sys.stderr)
        print("rank 0 release: " + ", ".join(
            f"{n} {s} s" for n, s in self.setup_phases), file=sys.stderr)
        found = [(r["rank"], r["forbidden"]) for r in self.peer_reports
                 if r["forbidden"]]
        if found:
            raise BenchError("the window ran with forbidden modules loaded: "
                             + "; ".join(f"rank {r}: {', '.join(names)}"
                                         for r, names in found))

    def _stop_peers(self):
        for _, proc, _ in self.peers:
            if proc.poll() is None:
                proc.kill()
            proc.wait()

    def close(self):
        """Stop and wait for every child, after a run or a failure."""
        self._ending.set()
        self._stop_peers()
        for _, proc, fd in self.peers:
            os.close(fd)
            proc.stdin.close()
        self.peers = []
        self._restore()
        if self.device == "cpu":
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()

    # ------------------------------------------------------- correctness
    def _step_batch(self, want_ids: dict, e: int, s: int):
        """The ranks' batches of step ``s`` of epoch ``e``, in rank order:
        the rows of the law's ids of each."""
        lo, hi = s * self.batch, (s + 1) * self.batch
        return [self.kind.reference_batch(
            self.rows, (want_ids[e] if r == self.rank
                        else self._law_ids(e, r))[lo:hi], self.device)
                for r in range(self.world)]

    def _law_ids(self, e: int, r: int):
        if (e, r) not in self._law_cache:
            self._law_cache[(e, r)] = self._reference_ids(e, r)
        return self._law_cache[(e, r)]

    def readings(self, fp8: bool = False) -> dict:
        out = super().readings(fp8)
        for r in self.peer_reports:
            out["mismatched_ids"] += r["mismatched_ids"]
            out["row_errors"] += r["row_errors"]
        out["rank_param_gap"] = max(r["rank_param_gap"]
                                    for r in self.peer_reports)
        return out


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent ends (Linux's
    ``PR_SET_PDEATHSIG``), and end it now where the parent already has."""
    import ctypes
    import signal

    ctypes.CDLL(None, use_errno=True).prctl(1, int(signal.SIGKILL))
    if os.getppid() != parent:
        os._exit(3)


def peer_main() -> int:
    inbox = sys.stdin.buffer
    boot = json.loads(inbox.readline())
    _die_with_parent(boot["parent"])
    if boot["device"] != "cpu":
        torch.cuda.set_device(boot["rank"])
    else:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads()
                                  // boot["params"]["world"]))
    code = Peer(boot).run(inbox)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # no wait on threads that a library leaves behind


if __name__ == "__main__":
    peer_main()
