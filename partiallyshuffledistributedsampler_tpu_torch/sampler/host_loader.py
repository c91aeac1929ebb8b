"""Host-resident data → device batches, prefetched behind the train step.

The samplers keep *indices* on the card but say nothing about the *data*
when it lives in host memory (tokenized shards, memmapped arrays — the C4
config's shape).  :class:`HostDataLoader` is that stage: per step it
gathers ``data[idx]`` on the host into pinned memory and ships it to the
card with a ``non_blocking`` copy on a stream of its own, running
``depth`` steps ahead on a background thread so the gather and the
host→device copy hide behind the consumer's compute — the overlap
DataLoader workers buy, without processes, pickling, or a collate
function.

Every stream of the JAX package's loader rides through it:

* the single-source §3/§4 stream (default),
* the weighted **mixture** stream (``mixture=MixtureSpec(...)``, SPEC.md
  §8, with ``data`` either one concatenated pytree or one per source),
* the **shard-index** stream (``shard_sizes=[...]``, SPEC.md §7),
* the **elastic remainder** epoch after a world-size change
  (``epoch(e, layers=[(old_world, consumed), ...])``, SPEC.md §6),
* the moving-horizon stream (``streaming=True, horizon=H``),
* and each of them **served** by an index daemon (``index_client=``,
  ``service/``), with capability mode and a degraded local fallback.

The epoch's indices come from :class:`~..service.spec.PartialShuffleSpec`
on ``index_backend`` — on 'cuda' the hand-written kernels, read back once
per epoch, on a stream of the loader's own so the regen never queues
behind the consumer's work.  Determinism: batches are exactly the
sampler stream cut into ``batch``-sized slices — bit-identical to the JAX
package's ``HostDataLoader`` of the same config, so checkpoints
interoperate (resume with ``start_step``).

Device side, per batch: a freshly allocated pinned buffer (the caching
host allocator hands a block out again only after the copy that read it
has finished), one ``non_blocking`` copy on the copy stream, and an event
the consumer's current stream waits on where the batch is yielded; the
batch's memory is recorded on that stream so the allocator cannot reuse
it while the consumer's kernels read it.  The gather is numpy's, so
dtypes torch barely supports (uint16 token rows) travel as bytes.

Traced (``telemetry``), each batch is a ``loader.gather`` and a
``loader.copy`` span (the copy's enqueue) on the prefetch thread, and a
``loader.wait`` span where the consumer takes it from the queue.  The
counters of ``metrics`` (always kept) count the batches served, the bytes
gathered, and the batches that were ready when the consumer asked.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
import warnings
from typing import Iterator, Optional

import numpy as np
import torch

from .. import faults as F
from ..analysis.lockorder import new_lock
from ..ops import core, ensure_index_backend, resolve_host_backend
from ..ops.cuda_kernel import require_cuda
from ..service.spec import PartialShuffleSpec
from ..telemetry import NULL_SPAN
from ..telemetry import enabled as _tel_enabled
from ..telemetry import span as _span
from ..utils.autotune import pick_backend
from ..utils.metrics import MetricsRegistry
from ..utils.watchdog import StallError

_SENTINEL = object()
_ERROR = object()


class HostDataLoader:
    """Prefetching loader over a dict of host arrays.

        loader = HostDataLoader({"x": X, "y": Y}, window=8192, batch=512,
                                seed=0, rank=r, world=w, depth=2)
        for epoch in range(E):
            for batch in loader.epoch(epoch):      # {"x": cuda, "y": cuda}
                loss = train_step(batch)           # gather+copy hidden

    data: a dict (or single array) of host arrays sharing leading dim n —
        or, with ``mixture``, a LIST of per-source dicts/arrays (leading
        dims ``spec.sources``) gathered via ``spec.decompose``.
    depth: prefetch queue capacity; up to ``depth + 1`` gathered batches
        are live at once (the producer holds one more while the queue is
        full).  The default 1 therefore double-buffers.
    index_backend: 'cuda' (default: the kernels, one readback per epoch),
        'cpu' (the port's host evaluator), 'native' (the C++ host kernel)
        or 'auto': the host backend for a mixture or shard stream
        ('native' when it loads, else 'cpu'), and for a single-source
        stream ``utils.autotune.pick_backend`` (kept as ``_auto_cost``).
    device: where batches land: 'cuda' (default: the current device at
        construction), 'cuda:N', or 'cpu' (plain tensors; no pinning and no
        streams).
    mixture: a ``MixtureSpec`` — serve the §8 stream (global ids into the
        concatenated source space); ``epoch_samples`` sets the mixture
        epoch length T.  Mutually exclusive with ``shard_sizes``;
        ``window`` is carried by the spec and must be omitted.
    shard_sizes: per-shard sample counts — serve the §7 shard-index
        stream: the rank's shard order (windowed over ``window`` shard
        slots, default 64) expanded to global sample indices
        (``within_shard_shuffle`` as in shard_mode).  The per-epoch sample
        count varies with the rank's shard draw, so ``steps_per_epoch`` is
        None; ``loader.epoch_steps(e)`` gives the exact count.
    drop_last_batch: False serves the trailing partial batch.
    stall_timeout: prefetch watchdog deadline (seconds).  If the gather
        thread makes no progress for this long — wedged in a gather, or
        dead without delivering a batch or an error — the consumer gets
        a typed :class:`~..utils.watchdog.StallError` carrying the stuck
        thread's stack instead of blocking forever.  ``None`` disables
        the watchdog.
    boundary_prefetch: overlap the NEXT epoch's index regen with serving
        the current epoch: ``epoch(e)`` kicks a background worker that
        materializes epoch ``e+1``'s index stream, and the next
        ``epoch()`` call adopts it instead of paying the regen at the
        boundary.  The worker's result is advisory: it is discarded (and
        the boundary recomputed in the foreground) when it errored or is
        for a different epoch.  Costs one extra epoch index array held
        across the boundary; False restores strictly-serial boundaries.
        The worker is not a daemon: the interpreter's exit waits for a
        regen in flight (a daemon thread inside torch ops at exit aborts
        the process), and :meth:`close` waits for it at once.
    streaming: epochless moving-horizon mode (docs/STREAMING.md): the
        stream becomes a ``StreamSpec`` over ``horizon`` samples per
        generation (plain or mixture base), and ``epoch(g)`` serves
        horizon GENERATION ``g`` — absolute append-only indices for the
        plain base, global source ids for the mixture base.  A generation
        bump drops every cache (the index cache and the boundary box), so
        no stale-horizon indices survive an advance; ``data`` must cover
        every appended sample.
    horizon: samples per horizon generation (required with
        ``streaming=True``, invalid otherwise).
    index_client: a ``service.ServiceIndexClient`` — fetch the epoch index
        stream from an index-serving daemon (of either package) instead of
        regenerating it locally (docs/SERVICE.md).  The stream is
        bit-identical to the local path (the daemon evaluates the same
        ``PartialShuffleSpec`` wire form this loader builds), so
        checkpoints interoperate.  Explicit elastic ``layers`` raise on
        this path: there the world change is server-driven
        (docs/RESILIENCE.md "Elastic membership"), and the client rides
        through a reshard while this loader keeps serving batches.
    degraded_fallback: when the daemon stays unreachable past the client's
        ``reconnect_timeout``, compute the epoch locally from the same spec
        on ``index_backend`` (on 'cuda' the kernels) instead of failing the
        epoch; after a reshard the fallback composes from the client's
        adopted membership.  Entering degraded mode warns once and counts
        ``degraded_mode`` on the client's metrics; every
        ``reattach_interval`` seconds a later epoch probes the daemon and
        re-attaches when it returns.  False fails on an unavailable
        daemon.
    reattach_interval: minimum seconds between re-attach probes while
        degraded (each probe costs one TCP dial).
    capability_mode: serve seeds, not indices (docs/CAPABILITY.md): on the
        service path fetch one signed epoch capability per epoch and
        regenerate the stream on ``index_backend`` — O(1) wire bytes per
        rank per epoch, bit-identical.  Needs the client's
        ``capability_secret``; a refused capability falls back to served
        batches for that epoch with a warning.

    The sampler kwargs (shuffle/drop_last/order_windows/partition/rounds)
    pass through to the index law unchanged.
    """

    def __init__(
        self,
        data,
        *,
        window: Optional[int] = None,
        batch: int,
        seed: int = 0,
        rank: int = 0,
        world: int = 1,
        depth: int = 1,
        index_backend: str = "cuda",
        drop_last_batch: bool = True,
        device="cuda",
        mixture=None,
        epoch_samples: Optional[int] = None,
        shard_sizes=None,
        within_shard_shuffle=True,
        index_client=None,
        degraded_fallback=True,
        reattach_interval: float = 5.0,
        stall_timeout: Optional[float] = 30.0,
        boundary_prefetch: bool = True,
        capability_mode: bool = False,
        streaming: bool = False,
        horizon: Optional[int] = None,
        **kwargs,
    ) -> None:
        if mixture is not None and shard_sizes is not None:
            raise ValueError(
                "mixture and shard_sizes are mutually exclusive streams"
            )
        self.streaming = bool(streaming)
        self.horizon = None if horizon is None else int(horizon)
        if self.streaming:
            if self.horizon is None or self.horizon < 1:
                raise ValueError(
                    "streaming=True needs horizon (samples per horizon "
                    "generation, docs/STREAMING.md)"
                )
            if shard_sizes is not None:
                raise ValueError(
                    "shard-mode streams are frozen-dataset only; "
                    "streaming rides the plain or mixture base"
                )
            if mixture is not None and epoch_samples is None:
                # each horizon is one mixture epoch of H samples
                epoch_samples = self.horizon
        elif horizon is not None:
            raise ValueError("horizon applies to streaming loaders only")
        self.mixture = mixture
        self.shard_sizes = (
            None if shard_sizes is None
            else np.asarray(shard_sizes, dtype=np.int64)
        )
        self.within_shard_shuffle = within_shard_shuffle
        self.epoch_samples = (
            None if epoch_samples is None else int(epoch_samples)
        )
        self._source_data = None
        if mixture is not None:
            from ..ops.mixture import MixtureSpec

            if not isinstance(mixture, MixtureSpec):
                raise TypeError(
                    f"mixture must be a MixtureSpec, got "
                    f"{type(mixture).__name__}"
                )
            if window is not None:
                raise ValueError(
                    "window is carried by the MixtureSpec (per-source "
                    "windows); omit it for mixture loaders"
                )
            window = 1  # unused by the mixture stream
            data, self._source_data, bare_sources = (
                self._normalize_mixture_data(data, mixture)
            )
        else:
            bare_sources = False
            if epoch_samples is not None:
                raise ValueError(
                    "epoch_samples applies to mixture loaders only"
                )
        self.data = data if isinstance(data, dict) else {"data": data}
        if not self.data:
            raise ValueError("data must contain at least one array")
        lens = {k: int(np.shape(v)[0]) for k, v in self.data.items()}
        if len(set(lens.values())) != 1:
            raise ValueError(f"leading dims differ: {lens}")
        self.n_rows = next(iter(lens.values()))
        self._single = bare_sources or not isinstance(data, dict)
        if self.shard_sizes is not None:
            if window is None:
                window = 64  # the shard sampler's locality default
            total = int(self.shard_sizes.sum())
            if total != self.n_rows:
                raise ValueError(
                    f"shard_sizes sum to {total} but data has "
                    f"{self.n_rows} rows"
                )
            self.n = len(self.shard_sizes)  # the index space is SHARDS
        elif mixture is not None:
            if mixture.total_sources_len != self.n_rows:
                raise ValueError(
                    f"mixture sources sum to {mixture.total_sources_len} "
                    f"but data has {self.n_rows} rows"
                )
            self.n = (
                mixture.total_sources_len if self.epoch_samples is None
                else self.epoch_samples
            )
        else:
            if window is None:
                raise ValueError("window is required (single-source stream)")
            # a plain-base stream's per-horizon index space is H; the
            # absolute indices served for horizon g land in [g*H, (g+1)*H)
            # and the data must cover every appended sample
            self.n = self.horizon if self.streaming else self.n_rows
        if not 0 <= rank < world:
            raise ValueError(f"rank must be in [0, {world}), got {rank}")
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        num_samples, _ = core.shard_sizes(
            self.n, world, kwargs.get("drop_last", False)
        )
        self._auto_cost = None
        if index_backend == "auto":
            if mixture is not None or self.shard_sizes is not None:
                # the cost model prices the single-source law only: a
                # mixture stream stays host-side, and a shard stream's
                # cost is its expansion, which no backend choice moves
                index_backend = resolve_host_backend()
            else:
                index_backend, self._auto_cost = pick_backend(num_samples)
        try:
            # 'cuda' without a GPU raises; 'native' builds here or raises
            ensure_index_backend(index_backend)
        except ValueError as exc:
            raise ValueError(f"index_backend: {exc}") from None
        self.window, self.batch = int(window), int(batch)
        self.seed, self.rank, self.world = int(seed), int(rank), int(world)
        self.depth = int(depth)
        self.index_backend = index_backend
        self.drop_last_batch = bool(drop_last_batch)
        self.kwargs = kwargs
        self.num_samples = num_samples
        self.index_client = index_client
        self.capability_mode = bool(capability_mode)
        self.degraded_fallback = bool(degraded_fallback)
        self.reattach_interval = float(reattach_interval)
        self.stall_timeout = (
            None if stall_timeout is None else float(stall_timeout)
        )
        #: True while serving locally because the index daemon is down
        self.degraded = False
        self._last_probe = float("-inf")
        self._dtypes = {k: _torch_dtype(k, v) for k, v in self.data.items()}
        self.device = torch.device(device)
        self._copy_stream = None
        self._regen_device = None
        self._regen_stream = None
        if self.device.type == "cuda":
            require_cuda()
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            self._copy_stream = torch.cuda.Stream(self.device)
        elif self.device.type != "cpu":
            raise ValueError(
                f"device must be 'cpu' or a CUDA device, got {device!r}"
            )
        if index_backend == "cuda":
            self._regen_device = (
                self.device if self.device.type == "cuda"
                else torch.device("cuda", torch.cuda.current_device())
            )
            self._regen_stream = torch.cuda.Stream(self._regen_device)
        self.boundary_prefetch = bool(boundary_prefetch)
        #: ``batches_served``, ``bytes_gathered``, ``batches_ready``
        self.metrics = MetricsRegistry()
        self._boundary_lock = new_lock("loader.boundary")
        self._boundary_thread: Optional[threading.Thread] = None
        self._boundary_box = None  # (epoch, generation, idx or None)
        self._idx_cache = None
        #: highest horizon generation served (streaming only): a bump is
        #: an epoch boundary for every cache — stale-horizon indices must
        #: never outlive an advance (docs/STREAMING.md)
        self._stream_gen = -1
        # ONE description of this loader's stream; the JAX package's index
        # service evaluates the same object for the same config
        spec_kw = dict(seed=self.seed, world=self.world,
                       backend=self.index_backend, **self.kwargs)
        if self.streaming:
            from ..streaming import StreamSpec

            if self.mixture is not None:
                self.stream_spec = StreamSpec.mixture_stream(
                    self.horizon, mixture=self.mixture, **spec_kw)
            else:
                self.stream_spec = StreamSpec.plain_stream(
                    self.horizon, window=self.window, **spec_kw)
        elif self.mixture is not None:
            self.stream_spec = PartialShuffleSpec.mixture(
                self.mixture, epoch_samples=self.epoch_samples, **spec_kw)
        elif self.shard_sizes is not None:
            self.stream_spec = PartialShuffleSpec.shard(
                self.shard_sizes, window=self.window,
                within_shard_shuffle=self.within_shard_shuffle, **spec_kw)
        else:
            self.stream_spec = PartialShuffleSpec.plain(
                self.n, window=self.window, **spec_kw)
        if self.shard_sizes is not None:
            # the per-epoch SAMPLE count follows the rank's shard draw
            self.steps_per_epoch: Optional[int] = None
        else:
            self.steps_per_epoch = self._steps_for(self.num_samples)
            if self.steps_per_epoch == 0:
                raise ValueError(
                    f"batch={batch} exceeds the rank's "
                    f"{self.num_samples} samples"
                )

    @staticmethod
    def _normalize_mixture_data(data, spec):
        """Accept per-source data (list/tuple, one pytree per source) or
        one concatenated pytree; returns ``(dict_form, source_list,
        bare)`` where ``source_list`` is None for concatenated data and
        ``bare`` records that the sources were plain arrays (batches are
        then served unwrapped, like a plain-array loader)."""
        if not isinstance(data, (list, tuple)):
            return data, None, False
        if len(data) != spec.num_sources:
            raise ValueError(
                f"{spec.num_sources} sources but {len(data)} data entries"
            )
        per_source = [
            d if isinstance(d, dict) else {"data": d} for d in data
        ]
        keys = set(per_source[0])
        for i, d in enumerate(per_source):
            if set(d) != keys:
                raise ValueError(
                    f"source {i} keys {sorted(d)} != source 0 keys "
                    f"{sorted(keys)}"
                )
            for k, v in d.items():
                if int(np.shape(v)[0]) != spec.sources[i]:
                    raise ValueError(
                        f"source {i} array {k!r} has "
                        f"{int(np.shape(v)[0])} rows; spec says "
                        f"{spec.sources[i]}"
                    )
                # the gather buffer takes source 0's dtype/trailing shape:
                # a mismatched source would silently wrap values into it
                # (int64 ids into an int32 buffer) or fail mid-epoch in
                # the producer thread — refuse at construction instead
                ref = per_source[0][k]
                v_dt = np.asarray(v[:0]).dtype
                r_dt = np.asarray(ref[:0]).dtype
                if v_dt != r_dt:
                    raise ValueError(
                        f"source {i} array {k!r} has dtype {v_dt}; "
                        f"source 0 has {r_dt} — batches gather into one "
                        "buffer, so per-source dtypes must match"
                    )
                if tuple(np.shape(v)[1:]) != tuple(np.shape(ref)[1:]):
                    raise ValueError(
                        f"source {i} array {k!r} has trailing shape "
                        f"{tuple(np.shape(v)[1:])}; source 0 has "
                        f"{tuple(np.shape(ref)[1:])}"
                    )
        # a zero-copy stand-in dict keyed like the sources: the loader's
        # generic plumbing only reads its keys, (summed) length and dtype
        proto = {
            k: _ConcatView([d[k] for d in per_source])
            for k in per_source[0]
        }
        bare = not isinstance(data[0], dict)
        return proto, per_source, bare

    # ------------------------------------------------------------- indices
    def epoch_indices(self, epoch: int, layers=None) -> np.ndarray:
        """This rank's epoch stream as host sample indices — the exact
        sampler stream for the loader's config (elastic remainder when
        ``layers`` names a §6 reshard cascade).  One-entry cached per
        (epoch, layers): the shard-mode pattern calls ``epoch_steps(e)``
        then ``epoch(e)``, and the streams are pure, so a second regen
        would be pure waste.  Dropped once the epoch generator is
        exhausted (or via :meth:`clear_cache`) so the array doesn't
        outlive its epoch."""
        if self.streaming and int(epoch) != self._stream_gen:
            # horizon-generation bump = epoch boundary for every cache:
            # drop the previous horizon's index array and any boundary
            # box for a DIFFERENT horizon, so no stale-horizon indices
            # can be served after an advance; a prefetch for exactly this
            # horizon is still adoptable
            self._idx_cache = None
            with self._boundary_lock:
                box = self._boundary_box
                if box is not None and box[0] != int(epoch):
                    self._boundary_box = None
            self._stream_gen = int(epoch)
        key = (int(epoch),
               None if layers is None
               else tuple((int(w), int(c)) for w, c in layers))
        cached = self._idx_cache
        if cached is not None and cached[0] == key:
            return cached[1]
        idx = self._take_boundary(int(epoch)) if layers is None else None
        if idx is None:
            idx = self._compute_epoch_indices(epoch, layers)
            idx.setflags(write=False)  # shared between epoch_steps and epoch
        self._idx_cache = (key, idx)
        return idx

    def clear_cache(self) -> None:
        """Drop the one-entry epoch index cache now — for callers that
        keep the loader alive between epochs and want the (potentially
        hundreds of MB for shard-mode epochs) array reclaimed before the
        next ``epoch()`` call.  Exhausting an epoch clears it too."""
        self._idx_cache = None
        with self._boundary_lock:
            self._boundary_box = None

    def close(self) -> None:
        """Wait for the boundary worker, if one is running, and drop the
        caches.  The loader stays usable: a later ``epoch()`` regenerates
        in the foreground."""
        t = self._boundary_thread
        if t is not None:
            t.join()
            self._boundary_thread = None
        self.clear_cache()

    # ------------------------------------------------- boundary prefetch
    def _kick_boundary(self, next_epoch: int) -> None:
        """Start materializing ``next_epoch``'s index stream in the
        background so the next ``epoch()`` call finds it ready.

        Under an armed fault plan the worker is suppressed: its regen
        would interleave with the foreground's and perturb the plan's
        deterministic per-site hit counters.  The ``loader.boundary`` site
        still draws — in the caller's thread, so chaos runs stay
        replayable — and any firing fault simply loses the prefetch (the
        boundary falls back to foreground regen, stream unchanged)."""
        if not self.boundary_prefetch:
            return
        if F.active() is not None:
            try:
                F.fire("loader.boundary")
            except F.InjectedThreadDeath:
                pass  # the worker "died": the prefetch is simply lost
            except F.InjectedFault:
                pass  # advisory path: a typed fault only loses the overlap
            return
        with self._boundary_lock:
            box = self._boundary_box
        t = self._boundary_thread
        if (box is not None and box[0] == next_epoch) or (
                t is not None and t.is_alive()):
            return  # already prefetched (or in flight)

        def _work() -> None:
            F.fire("loader.boundary")
            gen = None
            try:
                idx = self._compute_epoch_indices(next_epoch, None)
                idx.setflags(write=False)
                gen = getattr(self.index_client, "generation", None)
            except Exception:  # lint: allow-broad-except(prefetch is advisory; the boundary recomputes in the foreground)
                idx = None
            with self._boundary_lock:
                self._boundary_box = (next_epoch, gen, idx)

        t = threading.Thread(target=_work, daemon=False,
                             name="psds-boundary-prefetch")
        self._boundary_thread = t
        t.start()

    def _take_boundary(self, epoch: int) -> Optional[np.ndarray]:
        """Adopt the boundary worker's result for ``epoch``, or None when
        it must be recomputed (wrong epoch, the worker errored or is still
        running past ``stall_timeout``, or — on the service path — the
        membership generation moved since the fetch, which re-partitions
        the epoch)."""
        t = self._boundary_thread
        if t is not None:
            t.join(self.stall_timeout)
            if t.is_alive():
                if self.index_client is not None:
                    # the client is not a concurrent-use surface: a
                    # foreground fetch alongside the wedged worker would
                    # interleave on one socket
                    raise StallError(
                        "boundary prefetch made no progress past "
                        f"stall_timeout={self.stall_timeout}",
                        thread=t,
                    )
                return None  # local regen: recompute alongside it
            self._boundary_thread = None
        with self._boundary_lock:
            box, self._boundary_box = self._boundary_box, None
        if F.active() is not None:
            # an armed plan targets the FOREGROUND path's deterministic
            # draw sequence; adopting a pre-plan prefetch would skip it
            return None
        if box is None or box[0] != epoch or box[2] is None:
            return None
        _, gen, idx = box
        if self.index_client is not None:
            try:
                fresh = self.index_client.heartbeat()
            except Exception:  # lint: allow-broad-except(freshness probe only; the foreground fetch surfaces real errors)
                return None
            if fresh != gen or self.index_client.generation != gen:
                return None  # resharded since the fetch: stale partition
        return idx

    def _regen_scope(self):
        """Where a regen runs: on 'cuda', the loader's regen device and a
        stream of its own (entered per thread — the current device and
        stream are thread-local)."""
        if self._regen_stream is None:
            return contextlib.nullcontext()
        scope = contextlib.ExitStack()
        scope.enter_context(torch.cuda.device(self._regen_device))
        scope.enter_context(torch.cuda.stream(self._regen_stream))
        return scope

    def _compute_epoch_indices(self, epoch: int, layers) -> np.ndarray:
        if self.index_client is not None:
            if layers is not None:
                raise ValueError(
                    "elastic layers are a local-sampler feature; the index "
                    "service path does not serve remainder epochs"
                )
            return self._served_indices(epoch)
        F.fire("loader.regen")
        # the shared stream description; §6 elastic remainder layers ride
        # the same surface for every stream kind
        with self._regen_scope():
            return self.stream_spec.rank_indices(
                epoch, self.rank,
                layers=None if layers is None else list(layers),
            )

    def _served_indices(self, epoch: int) -> np.ndarray:
        """The service path with graceful degradation (docs/RESILIENCE.md).

        Healthy: fetch the epoch stream from the daemon.  A dead primary
        with a hot standby is handled inside the client (transparent
        failover, no degraded entry); only if every peer stays down past
        the client's ``reconnect_timeout`` and ``degraded_fallback`` is on,
        compute the stream locally from the same spec — bit-identical by
        the fingerprint handshake — and keep training; while degraded,
        probe the daemon at most every ``reattach_interval`` seconds and
        re-attach when it answers."""
        if _tel_enabled():
            with _span("loader.serve_epoch", epoch=int(epoch),
                       rank=self.rank) as sp:
                return self._served_indices_impl(epoch, sp)
        # tracing off: no span machinery on the serve path
        return self._served_indices_impl(epoch, NULL_SPAN)

    def _served_indices_impl(self, epoch: int, sp) -> np.ndarray:
        from ..capability import CapabilityError
        from ..service.client import FencedError, ServiceUnavailable

        client = self.index_client
        if self.degraded:
            now = time.monotonic()
            if now - self._last_probe < self.reattach_interval:
                return self._local_indices(epoch)
            self._last_probe = now
            if not client.probe():
                return self._local_indices(epoch)
            self.degraded = False
            client.metrics.inc("reattached", self.rank)
            sp.event("reattached")
        try:
            if self.capability_mode:
                try:
                    with self._regen_scope():
                        return np.asarray(client.capability_epoch_indices(
                            epoch, spec=self.stream_spec))
                except CapabilityError as exc:
                    # fallback ladder (docs/CAPABILITY.md): a refused or
                    # unverifiable capability drops to the served-batch
                    # path for THIS epoch — loudly, never silently
                    warnings.warn(
                        f"capability path refused for epoch {epoch} "
                        f"({exc}); falling back to served batches",
                        RuntimeWarning,
                        stacklevel=3,
                    )
                    sp.event("capability_fallback", error=str(exc))
                    client.metrics.inc("capability_fallbacks", self.rank)
            return np.asarray(client.epoch_indices(epoch))
        except (ServiceUnavailable, FencedError) as exc:
            # FencedError: every reachable peer lost a promotion race and
            # no serving primary is attached — the same "both peers down"
            if not self.degraded_fallback:
                raise
            warnings.warn(
                f"index service unavailable ({exc}); serving epoch "
                f"{epoch} from the local spec (bit-identical stream) "
                "and probing for re-attach",
                RuntimeWarning,
                stacklevel=3,
            )
            sp.event("degraded_fallback", error=str(exc))
            client.metrics.inc("degraded_mode", self.rank)
            self.degraded = True
            self._last_probe = time.monotonic()
            return self._local_indices(epoch, after=exc)

    def _local_indices(self, epoch: int, *, after=None) -> np.ndarray:
        """Degraded-mode regen: evaluate the loader's own spec on
        ``index_backend``.  Safe to substitute for the served stream
        because the WELCOME handshake proved the daemon serves a spec with
        this (world-stripped) fingerprint.  After a reshard the local
        stream is composed from the client's adopted membership
        (``client.local_epoch_indices``); a stale base-spec regen would
        serve the wrong partition of the remainder.

        ``after`` is the exception that forced this fallback (if any);
        when it crossed a traced RPC, its span tag links the degraded
        regen span to the RPC that failed (docs/OBSERVABILITY.md)."""
        client = self.index_client
        wire = getattr(client, "spec_wire", None)
        if wire is not None:
            served = PartialShuffleSpec.from_wire(
                wire, backend=self.index_backend
            ).fingerprint(include_world=False)
            ours = self.stream_spec.fingerprint(include_world=False)
            if served != ours:
                raise RuntimeError(
                    f"cannot degrade to local regen: daemon spec "
                    f"fingerprint {served} != local {ours}"
                )
        link = getattr(after, "_psds_span", None)
        attrs = {"failed_rpc": list(link)} if link else {}
        with _span("loader.degraded_regen", epoch=int(epoch),
                   rank=self.rank, **attrs):
            F.fire("loader.regen")
            with self._regen_scope():
                if client is not None and getattr(client, "generation",
                                                  0) > 0:
                    return np.asarray(
                        client.local_epoch_indices(self.stream_spec, epoch)
                    )
                return self.stream_spec.rank_indices(epoch, self.rank)

    # -------------------------------------------------------------- gather
    def _gather(self, sl: np.ndarray) -> dict:
        """``data[sl]`` per key into a host buffer (pinned for a CUDA
        device): ``{k: (array, pinned byte tensor or None)}``."""
        if self._source_data is not None:
            s, loc = self.mixture.decompose(sl)
        out = {}
        for k, v in self.data.items():
            arr, buf = self._host_buffer(len(sl), v)
            if self._source_data is None:
                _take_rows(v, sl, arr)
            else:
                for si in range(self.mixture.num_sources):
                    m = s == si
                    if m.any():
                        arr[m] = np.take(self._source_data[si][k], loc[m],
                                         axis=0)
            out[k] = (arr, buf)
        return out

    def _host_buffer(self, rows: int, v):
        shape = (rows,) + tuple(np.shape(v)[1:])
        dt = _np_dtype(v)
        if self._copy_stream is None:
            return np.empty(shape, dtype=dt), None
        # bytes, so the copy never dispatches on a dtype torch barely has
        buf = torch.empty(int(np.prod(shape)) * dt.itemsize,
                          dtype=torch.uint8, pin_memory=True)
        return buf.numpy().view(dt).reshape(shape), buf

    def _to_device(self, host: dict):
        """The gathered batch on ``device``: ``(tensors, event)``, the
        event recorded on the copy stream after the copies (None on the
        CPU)."""
        if self._copy_stream is None:
            return {k: torch.from_numpy(a) for k, (a, _) in host.items()}, None
        out = {}
        with torch.cuda.stream(self._copy_stream):
            for k, (a, buf) in host.items():
                out[k] = buf.to(self.device, non_blocking=True).view(
                    self._dtypes[k]).view(a.shape)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        return out, ev

    # -------------------------------------------------------------- sizing
    def _steps_for(self, n_idx: int) -> int:
        if self.drop_last_batch:
            return n_idx // self.batch
        return -(-n_idx // self.batch)

    def epoch_steps(self, epoch: int, layers=None) -> int:
        """Exact step count ``epoch(epoch, layers=...)`` will serve —
        needed for shard-mode streams, whose per-epoch sample count
        follows the rank's shard draw."""
        return self._steps_for(len(self.epoch_indices(epoch, layers)))

    def _check_stall(self, thread: threading.Thread, progress: dict) -> None:
        """Raise :class:`StallError` when the gather thread is dead
        without having delivered a result, or has made no progress for
        ``stall_timeout`` seconds.  Called from the consumer's timed
        poll, so the error surfaces at the training loop — with the
        stuck thread's stack attached — instead of hanging it."""
        if not thread.is_alive():
            raise StallError(
                "prefetch thread died without delivering a batch, an "
                "error, or the end-of-epoch sentinel",
                thread=thread,
            )
        if self.stall_timeout is None:
            return
        stalled = time.monotonic() - progress["ts"]
        if stalled > self.stall_timeout:
            raise StallError(
                f"prefetch thread made no progress for {stalled:.1f}s "
                f"(stall_timeout={self.stall_timeout:.1f}s)",
                thread=thread,
            )

    # -------------------------------------------------------------- epochs
    def epoch(self, epoch: int, *, start_step: int = 0,
              layers=None) -> Iterator:
        """Device batches for ``epoch``, prefetched ``depth`` steps ahead.

        ``start_step`` resumes mid-epoch (e.g. from a checkpointed step
        count): batches ``start_step..`` are served, identical to the
        tail of an uninterrupted epoch.  ``layers`` switches the stream
        to the §6 elastic REMAINDER of the epoch after a world-size
        change (``[(old_world, consumed), ...]`` outermost first);
        subsequent epochs are ordinary full epochs at this loader's world
        size.
        """
        # validate eagerly AT THE CALL — this method returns a generator,
        # and a deferred error would fire wherever the caller first pulls
        # it.  The index stream is computed here for the same reason
        # (start_step bounds depend on it for shard/elastic streams).
        idx = self.epoch_indices(epoch, layers)
        steps = self._steps_for(len(idx))
        if not 0 <= start_step <= steps:
            raise ValueError(
                f"start_step {start_step} outside [0, {steps}]"
            )
        # overlap the NEXT boundary with this epoch's serving (epochs
        # after an elastic remainder are ordinary full epochs, so the
        # prefetch target never carries layers)
        self._kick_boundary(int(epoch) + 1)
        return self._epoch_gen(idx, steps, start_step)

    def _epoch_gen(self, idx: np.ndarray, steps: int,
                   start_step: int) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        # watchdog state: the producer stamps progress; the consumer's
        # timed poll compares against it so a wedged or silently-dead
        # gather thread becomes a typed StallError, never an infinite wait
        progress = {"ts": time.monotonic()}
        errbox: list = []

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    progress["ts"] = time.monotonic()
                    continue
            return False

        def produce() -> None:
            try:
                # the current device is per thread: without this a
                # 'cuda:1' loader would allocate and copy on card 0
                with (torch.cuda.device(self.device)
                      if self._copy_stream is not None
                      else contextlib.nullcontext()):
                    for s in range(start_step, steps):
                        if stop.is_set():
                            return
                        F.fire("loader.prefetch")
                        lo = s * self.batch
                        with _span("loader.gather", step=s):
                            host = self._gather(idx[lo:lo + self.batch])
                        self.metrics.inc("bytes_gathered", sum(
                            a.nbytes for a, _ in host.values()))
                        with _span("loader.copy", step=s):
                            item = self._to_device(host)
                        progress["ts"] = time.monotonic()
                        if not _put(item):
                            return
            except F.InjectedThreadDeath:
                return  # simulated silent death: no error, no sentinel
            except Exception as exc:
                # deliver the ORIGINAL exception object (its traceback
                # intact) — the consumer re-raises it, so the user's
                # stack shows the real gather failure, not loader goo
                errbox.append(exc)
                _put(_ERROR)
                return
            _put(_SENTINEL)

        t = threading.Thread(target=produce, daemon=True,
                             name="psds-host-prefetch")
        t.start()
        poll = (
            min(0.25, self.stall_timeout / 4)
            if self.stall_timeout else 0.25
        )
        try:
            while True:
                # the consumer is the queue's one reader: a batch queued
                # now is the one the get below returns at once
                ready = not q.empty()
                with _span("loader.wait"):
                    while True:
                        try:
                            item = q.get(timeout=poll)
                            break
                        except queue.Empty:
                            self._check_stall(t, progress)
                if item is _SENTINEL:
                    break
                if item is _ERROR:
                    raise errbox[0]
                self.metrics.inc("batches_served")
                if ready:
                    self.metrics.inc("batches_ready")
                out, ev = item
                if ev is not None:
                    # the consumer's stream (this thread's) waits for the
                    # copy, and the allocator keeps the batch's memory
                    # until that stream's work on it is done
                    cur = torch.cuda.current_stream(self.device)
                    cur.wait_event(ev)
                    for v in out.values():
                        v.record_stream(cur)
                yield out["data"] if self._single else out
        finally:
            # consumer broke out (or errored): unblock and retire the thread
            stop.set()
            # drain so a blocked put can observe stop; under the queue's
            # own lock, with no exception to catch, because this can run
            # at interpreter exit after the modules' globals are cleared
            with q.mutex:
                q.queue.clear()
                q.not_full.notify_all()
            t.join(timeout=5.0)
            # the epoch is over (exhausted or abandoned): the one-entry
            # index cache has served its epoch_steps+epoch purpose and
            # would otherwise pin the full epoch array until the next
            # epoch() call
            cached = self._idx_cache
            if cached is not None and cached[1] is idx:
                self._idx_cache = None


def _np_dtype(v) -> np.dtype:
    return v.dtype if isinstance(v, _ConcatView) else np.asarray(v[:0]).dtype


def _torch_dtype(key, v) -> torch.dtype:
    """The torch dtype a batch of ``v`` is served as (its numpy dtype's
    counterpart); a dtype with none is refused at construction."""
    try:
        return torch.from_numpy(np.empty(0, dtype=_np_dtype(v))).dtype
    except TypeError:
        raise TypeError(
            f"data {key!r} has dtype {_np_dtype(v)}, which has no torch "
            "counterpart"
        ) from None


def _take_rows(v, sl: np.ndarray, out: np.ndarray) -> None:
    """``out[:] = v[sl]`` along axis 0, written straight into ``out``:
    numpy buffers a ``take(..., out=)`` in its raising mode, so the bounds
    are checked here (the same IndexError) and the take wraps."""
    n = int(np.shape(v)[0])
    if len(sl):
        lo, hi = int(sl.min()), int(sl.max())
        bad = hi if hi >= n else lo if lo < -n else None
        if bad is not None:
            raise IndexError(
                f"index {bad} is out of bounds for axis 0 with size {n}")
    np.take(v, sl, axis=0, out=out, mode="wrap")


class _ConcatView:
    """Zero-copy stand-in for concatenated per-source arrays: only the
    leading length (the sum), ``np.shape`` and the dtype are ever read by
    the loader's generic plumbing; gathers go through the per-source
    path."""

    def __init__(self, parts) -> None:
        self._parts = parts
        self._len = int(sum(int(np.shape(p)[0]) for p in parts))
        self.shape = (self._len,) + tuple(np.shape(parts[0])[1:])

        self.dtype = np.asarray(parts[0][:0]).dtype

    def __len__(self) -> int:
        return self._len
