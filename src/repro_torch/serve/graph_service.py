"""Fault-tolerant online serving for temporal graphs, on the card.

Port of ``repro.serve.graph_service``. :class:`OnlineGraphService` turns the
training-side CTDG machinery into a live inference service:

* **Event ingest** — live ``(src, dst, t, eid)`` edge events flow through a
  bounded queue (blocking put, stop-aware worker) into the device-resident
  :class:`~repro_torch.core.device_sampler.DeviceRecencySampler` *and* an
  :class:`~repro_torch.models.tg.edgebank.EdgeBank` on the host, kept warm
  as the fallback tier. Duplicate events (same eid) are dropped;
  out-of-order events are applied and counted. One event is one sampler
  ``update``, as in the reference (dedup and the out-of-order count are per
  event), its four columns staged to the card by one non-blocking copy.
* **Deadline-aware microbatching** — ``predict_link`` / ``embed`` requests
  carry a deadline; a batcher thread flushes on size-or-timeout; requests
  already past their deadline at flush time are shed with an explicit
  :attr:`Status.REJECTED` (never silently dropped, never run).
* **Graceful degradation** — a count-based circuit breaker plus an EWMA
  latency estimate route traffic: healthy + under budget → learned model
  (:attr:`Status.OK`); unhealthy or over budget → EdgeBank answers link
  queries (:attr:`Status.DEGRADED`). Every ``probe_every``-th degraded
  flush probes the model so the breaker can close again. Embeddings have
  no non-parametric fallback and fail explicitly while degraded.
* **Crash safety** — :meth:`OnlineGraphService.snapshot` drains in-flight
  events and writes sampler buffers + EdgeBank memory + the event cursor
  through :mod:`repro_torch.distributed.checkpoint` (the reference's
  layout, so either package restores the other's snapshot); :meth:`restore`
  brings a fresh process back bit-identical to an uninterrupted one.

The sampler, the learned tier's parameters and every model call live on
``device`` (``"cuda"`` by default); EdgeBank stays on the host. The learned
tier is plain PyTorch, as the reference's is plain jnp outside any Pallas
kernel. Its parameters come from a ``torch.Generator`` seeded with
``seed`` (``learned_link_params``), so a restored service re-derives them;
parity tests install the reference's through ``convert.params_from_jax``
(the scorer reads ``self.params`` at call time).

**Flush shape.** The reference's ``learned_embed`` is row-wise, which makes
answers independent of how requests were batched. On the card a matrix
product's kernel (hence a row's rounding) may depend on the row count, so
the default tier pads every flush to ``max_batch`` rows
(``_link_scores(..., pad_to=)`` / ``_embed_rows``): every flush runs at one
shape, and a request's answer is the same bits whichever flush carried it.

Both worker threads touch the card: the sampler's ``update`` and ``sample``
run under ``_state_lock`` (``sample`` gathers into fresh tensors, so the
block handed to the model is a copy made under the lock), and ``stop()``
synchronizes the device after joining the workers, so no CUDA call is left
in flight.

Pass ``telemetry=`` (a :class:`repro_torch.obs.Telemetry`) to make the
service observable: per-tier request-latency histograms
(``serve/latency/model`` / ``serve/latency/edgebank``), a
``serve/latency/model_call`` histogram of the raw model-tier call time
feeding the EWMA, ingest/flush/shed/degrade/probe counters, and a
``serve/model_latency_ewma`` gauge (``0.7 * prev + 0.3 * lat``, as the
reference's).
"""

from __future__ import annotations

import enum
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.device import resolve_device
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models.tg.common import link_decoder, link_decoder_init
from repro_torch.models.tg.edgebank import EdgeBank
from repro_torch.nn.init import normal
from repro_torch.nn.linear import dense, dense_init
from repro_torch.nn.time_encode import time_encode, time_encode_init
from repro_torch.obs import NULL, EwmaGauge


class Status(enum.Enum):
    """Outcome of a serving request.

    ``OK``: answered by the learned model. ``DEGRADED``: answered by the
    EdgeBank fallback tier. ``REJECTED``: shed because its deadline passed
    before execution. ``FAILED``: errored with no fallback (embedding while
    degraded, fault with EdgeBank also unavailable, or service shutdown).
    """

    OK = "ok"
    DEGRADED = "degraded"
    REJECTED = "rejected"
    FAILED = "failed"


@dataclass
class Response:
    """Result of a serving request.

    ``tier`` names who answered ("model" or "edgebank"); ``latency_s`` is
    enqueue-to-resolve wall time; ``detail`` carries the error message for
    REJECTED/FAILED responses.
    """

    status: Status
    score: Optional[float] = None
    embedding: Optional[np.ndarray] = None
    tier: Optional[str] = None
    latency_s: float = 0.0
    detail: str = ""


class PendingResponse:
    """Handle for an in-flight request; resolved by the batcher thread."""

    def __init__(self):
        self._ev = threading.Event()
        self._resp: Optional[Response] = None

    def done(self) -> bool:
        """True once a Response has been attached."""
        return self._ev.is_set()

    def result(self, timeout: Optional[float] = None) -> Response:
        """Block until resolved (raises TimeoutError after ``timeout``)."""
        if not self._ev.wait(timeout):
            raise TimeoutError("serving request not resolved in time")
        assert self._resp is not None
        return self._resp

    def _resolve(self, resp: Response) -> None:
        self._resp = resp
        self._ev.set()


@dataclass
class _Request:
    kind: str  # "link" | "embed"
    src: int
    dst: int  # unused for embed
    t: int
    deadline: float  # absolute monotonic time; inf = no deadline
    enqueue_t: float
    pending: PendingResponse = field(default_factory=PendingResponse)


def learned_link_params(seed: int, num_nodes: int, d_model: int = 32,
                        time_dim: int = 8, device="cuda") -> dict:
    """Init params for the default learned tier: a node-embedding table
    (N(0, 0.1^2)), a Time2Vec encoder, a neighbor-aggregation projection
    and the shared 2-layer MLP link decoder, drawn on the CPU from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device`` (so a
    seed gives the same weights on every device; they are not the
    reference's ``jax.random`` draws)."""
    resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    return {
        "embed": normal(gen, (num_nodes + 1, d_model), 0.1, device),
        "time": time_encode_init(gen, time_dim, device),
        "proj": dense_init(gen, d_model + time_dim, d_model, device=device),
        "dec": link_decoder_init(gen, d_model, device=device),
    }


def learned_embed(params, seeds, t, nbr_ids, nbr_times, mask):
    """Embed seeds at query times from their recency neighbor block: node
    embedding + tanh-projected mean of [neighbor embedding ; Time2Vec of the
    time gap], masked to valid neighbors. Row-wise: a row's value depends
    on its own inputs only (its bits, on the card, also on the row count;
    see the module docstring)."""
    emb = params["embed"]
    base = emb[seeds.long()]
    ids = torch.where(mask, nbr_ids, 0)
    dt = torch.where(mask, t[:, None] - nbr_times, 0)
    nh = torch.cat([emb[ids.long()], time_encode(params["time"], dt)], dim=-1)
    nh = nh * mask[:, :, None].to(nh.dtype)
    agg = nh.sum(dim=1) / torch.clamp(mask.sum(dim=1, keepdim=True), min=1)
    return base + torch.tanh(dense(params["proj"], agg))


def _pad_rows(x, rows: int):
    """``x`` with zero rows appended up to ``rows`` (padding seeds are node
    0 with every neighbor slot masked)."""
    return torch.cat([x, x.new_zeros((rows - x.shape[0],) + x.shape[1:])])


def _link_scores(params, seeds, t, nbr_ids, nbr_times, mask, pad_to=None):
    """Link probabilities of the ``B`` pairs ``(seeds[:B], seeds[B:])``.
    ``pad_to`` pads each half to that many pairs first (the fixed flush
    shape) and returns the first ``B`` scores."""
    B = seeds.shape[0] // 2
    if pad_to is not None and pad_to > B:
        seeds, t, nbr_ids, nbr_times, mask = (
            torch.cat([_pad_rows(x[:B], pad_to), _pad_rows(x[B:], pad_to)])
            for x in (seeds, t, nbr_ids, nbr_times, mask))
    h = learned_embed(params, seeds, t, nbr_ids, nbr_times, mask)
    P = seeds.shape[0] // 2
    logit = link_decoder(params["dec"], h[:P], h[P:])
    return torch.sigmoid(logit)[:B]


def _embed_rows(params, seeds, t, nbr_ids, nbr_times, mask, pad_to=None):
    """``learned_embed`` of ``B`` seeds, padded to ``pad_to`` rows first
    (the fixed flush shape); returns the first ``B`` rows."""
    B = seeds.shape[0]
    if pad_to is not None and pad_to > B:
        seeds, t, nbr_ids, nbr_times, mask = (
            _pad_rows(x, pad_to) for x in (seeds, t, nbr_ids, nbr_times, mask))
    return learned_embed(params, seeds, t, nbr_ids, nbr_times, mask)[:B]


def _host(x) -> np.ndarray:
    """A model tier's output as a host array (tensors are read back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


_STOP = object()


class OnlineGraphService:
    """Live temporal-graph inference with deadline-aware microbatching,
    EdgeBank graceful degradation, and crash-safe snapshots.

    Two daemon threads run per service: an ingest worker applying events
    from a bounded queue to the sampler + EdgeBank, and a batcher flushing
    the request queue on size-or-timeout. ``stop()`` (or exiting the
    context manager) shuts both down and fails outstanding requests rather
    than leaving callers blocked.
    """

    def __init__(self, num_nodes: int, k: int = 8, *,
                 seed: int = 0,
                 device="cuda",
                 model_fn: Optional[Callable] = None,
                 embed_fn: Optional[Callable] = None,
                 max_batch: int = 32,
                 flush_interval: float = 0.005,
                 queue_depth: int = 256,
                 latency_budget: Optional[float] = None,
                 fail_threshold: int = 3,
                 probe_every: int = 8,
                 edgebank_window: Optional[int] = None,
                 fault_injector=None,
                 telemetry=None):
        """``model_fn``/``embed_fn`` override the learned tier (signature of
        :func:`_link_scores` / :func:`learned_embed` minus ``params``);
        ``latency_budget`` (seconds) bounds the EWMA model latency before
        degrading; ``fail_threshold`` consecutive model faults open the
        circuit breaker; every ``probe_every``-th degraded flush probes the
        model to let it close. ``telemetry`` (a ``repro_torch.obs.Telemetry``)
        enables the counters/histograms in the module docstring — the
        no-sink default records nothing and changes no behavior.
        ``device`` holds the sampler, the learned tier's parameters and its
        calls (``"cuda"`` by default; ``"cpu"`` runs the same code on the
        host)."""
        self.num_nodes = int(num_nodes)
        self.k = int(k)
        self.max_batch = int(max_batch)
        self.flush_interval = float(flush_interval)
        self.latency_budget = latency_budget
        self.fail_threshold = int(fail_threshold)
        self.probe_every = max(1, int(probe_every))
        self.telemetry = telemetry if telemetry is not None else NULL

        self.device = resolve_device(device)
        self.sampler = DeviceRecencySampler(self.num_nodes, self.k,
                                            device=self.device)
        self.edgebank = EdgeBank(self.num_nodes, window=edgebank_window)
        self.params = learned_link_params(seed, self.num_nodes,
                                          device=self.device)
        rows = self.max_batch
        score = model_fn or (
            lambda *a: _link_scores(self.params, *a, pad_to=rows))
        embed = embed_fn or (
            lambda *a: _embed_rows(self.params, *a, pad_to=rows))
        transfer = lambda x: np.ascontiguousarray(x)  # noqa: E731
        if fault_injector is not None:
            score = fault_injector.wrap_model(score)
            embed = fault_injector.wrap_model(embed)
            transfer = fault_injector.wrap_transfer(transfer)
        self._score_fn, self._embed_fn, self._transfer = score, embed, transfer

        self._state_lock = threading.Lock()
        self._applied: set[int] = set()
        self._last_t = -(2 ** 62)
        self._event_cursor = 0  # events applied (post-dedup)
        self.stats = {"ok": 0, "degraded": 0, "rejected": 0, "failed": 0,
                      "events_applied": 0, "events_deduped": 0,
                      "events_out_of_order": 0, "model_errors": 0,
                      "probes": 0}

        # Model-tier latency EWMA: the same float sequence the private
        # bookkeeping produced (decay/alpha = 0.7/0.3, first sample passes
        # through), now readable as a telemetry gauge too.
        self._lat = EwmaGauge(alpha=0.3, decay=0.7)
        self._failures = 0
        self._degraded_flushes = 0

        self._evq: queue.Queue = queue.Queue(maxsize=int(queue_depth))
        self._reqq: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self._ingest_thread = threading.Thread(
            target=self._ingest_loop, daemon=True, name="ogs-ingest")
        self._batch_thread = threading.Thread(
            target=self._batch_loop, daemon=True, name="ogs-batch")
        self._ingest_thread.start()
        self._batch_thread.start()

    # ------------------------------------------------------------- ingest

    def ingest(self, src: int, dst: int, t: int, eid: int = -1) -> None:
        """Enqueue one live edge event (blocking put = backpressure: a
        producer outrunning the ingest worker stalls instead of ballooning
        memory, mirroring ``PrefetchLoader``)."""
        self._check_alive()
        self._evq.put(("ev", (int(src), int(dst), int(t), int(eid))))

    def ingest_many(self, events: Iterable[Sequence[int]]) -> None:
        """Enqueue a sequence of ``(src, dst, t, eid)`` events in order."""
        for ev in events:
            self.ingest(*ev)

    def drain(self) -> None:
        """Block until every event enqueued so far has been applied.

        The sequencing barrier for read-your-writes tests and for
        :meth:`snapshot` (the event cursor must be quiescent to be
        meaningful)."""
        self._check_alive()
        barrier = threading.Event()
        self._evq.put(("barrier", barrier))
        if not barrier.wait(timeout=60):
            raise RuntimeError("ingest drain timed out")

    def _ingest_loop(self) -> None:
        while True:
            item = self._evq.get()
            if item is _STOP:
                return
            kind, payload = item
            if kind == "barrier":
                payload.set()
                continue
            src, dst, t, eid = payload
            if eid >= 0 and eid in self._applied:
                self.stats["events_deduped"] += 1
                self.telemetry.count("serve/events_deduped")
                continue
            if t < self._last_t:
                self.stats["events_out_of_order"] += 1
                self.telemetry.count("serve/events_out_of_order")
            self._last_t = max(self._last_t, t)
            if eid >= 0:
                self._applied.add(eid)
            cols = self._event_columns(src, dst, t, eid)
            with self._state_lock:
                self.sampler.update(*cols)
                self.edgebank.update_memory(src, dst, t)
            self._event_cursor += 1
            self.stats["events_applied"] += 1
            self.telemetry.count("serve/events_applied")

    # ------------------------------------------------------------ serving

    def submit_link(self, src: int, dst: int, t: int,
                    timeout: Optional[float] = None) -> PendingResponse:
        """Queue a link prediction; ``timeout`` (seconds) sets the deadline
        after which the request is shed as REJECTED instead of executed."""
        return self._submit("link", src, dst, t, timeout)

    def submit_embed(self, node: int, t: int,
                     timeout: Optional[float] = None) -> PendingResponse:
        """Queue an embedding request (learned tier only — no fallback)."""
        return self._submit("embed", node, node, t, timeout)

    def predict_link(self, src: int, dst: int, t: int,
                     timeout: Optional[float] = None) -> Response:
        """Synchronous :meth:`submit_link`: blocks until resolved."""
        return self.submit_link(src, dst, t, timeout).result(
            None if timeout is None else timeout + 10.0)

    def embed(self, node: int, t: int,
              timeout: Optional[float] = None) -> Response:
        """Synchronous :meth:`submit_embed`: blocks until resolved."""
        return self.submit_embed(node, t, timeout).result(
            None if timeout is None else timeout + 10.0)

    def _submit(self, kind, src, dst, t, timeout) -> PendingResponse:
        self._check_alive()
        now = time.monotonic()
        deadline = float("inf") if timeout is None else now + timeout
        req = _Request(kind, int(src), int(dst), int(t), deadline, now)
        self._reqq.put(req)
        return req.pending

    def _batch_loop(self) -> None:
        pending: list[_Request] = []
        while True:
            if pending:
                wait = (pending[0].enqueue_t + self.flush_interval
                        - time.monotonic())
            else:
                wait = 0.05
            item = None
            if wait > 0:
                try:
                    item = self._reqq.get(timeout=wait)
                except queue.Empty:
                    pass
            else:
                try:
                    item = self._reqq.get_nowait()
                except queue.Empty:
                    pass
            if item is _STOP:
                break
            if item is not None:
                pending.append(item)
            if pending and (len(pending) >= self.max_batch
                            or time.monotonic() - pending[0].enqueue_t
                            >= self.flush_interval):
                batch, pending = pending[:self.max_batch], pending[self.max_batch:]
                try:
                    self._flush(batch)
                except BaseException as e:  # never let the batcher die
                    for r in batch:
                        if not r.pending.done():
                            self._resolve(r, Response(
                                Status.FAILED, detail=f"flush error: {e!r}"))
        # shutdown: fail everything still queued or held
        leftovers = pending
        while True:
            try:
                item = self._reqq.get_nowait()
            except queue.Empty:
                break
            if item is not _STOP:
                leftovers.append(item)
        for r in leftovers:
            self._resolve(r, Response(Status.FAILED, detail="service stopped"))

    def _resolve(self, req: _Request, resp: Response) -> None:
        resp.latency_s = time.monotonic() - req.enqueue_t
        self.stats[resp.status.value] += 1
        tel = self.telemetry
        if tel.enabled:
            tel.count(f"serve/requests_{resp.status.value}")
            if resp.tier is not None:
                # Per-tier enqueue-to-resolve latency distribution.
                tel.observe(f"serve/latency/{resp.tier}", resp.latency_s)
        req.pending._resolve(resp)

    def _choose_tier(self) -> str:
        if self._failures >= self.fail_threshold or self._over_budget():
            self._degraded_flushes += 1
            self.telemetry.count("serve/degraded_flushes")
            if self._degraded_flushes % self.probe_every == 0:
                self.stats["probes"] += 1
                self.telemetry.count("serve/probes")
                return "model"  # probe so the breaker can close
            return "edgebank"
        return "model"

    def _over_budget(self) -> bool:
        return (self.latency_budget is not None
                and self._lat.value is not None
                and self._lat.value > self.latency_budget)

    def _flush(self, batch: list[_Request]) -> None:
        self.telemetry.count("serve/flushes")
        now = time.monotonic()
        live = []
        for r in batch:
            if now > r.deadline:
                self.telemetry.count("serve/shed")
                self._resolve(r, Response(Status.REJECTED,
                                          detail="deadline exceeded"))
            else:
                live.append(r)
        if not live:
            return
        links = [r for r in live if r.kind == "link"]
        embeds = [r for r in live if r.kind == "embed"]
        tier = self._choose_tier()

        if embeds:
            if tier == "model":
                try:
                    embs = self._run_embeds(embeds)
                    for r, e in zip(embeds, embs):
                        self._resolve(r, Response(Status.OK, embedding=e,
                                                  tier="model"))
                    self._failures = 0
                except Exception as e:
                    self._record_failure()
                    for r in embeds:
                        self._resolve(r, Response(
                            Status.FAILED, detail=f"model error: {e!r}"))
            else:
                for r in embeds:
                    self._resolve(r, Response(
                        Status.FAILED,
                        detail="degraded: no fallback tier for embeddings"))
        if not links:
            return

        if tier == "model":
            try:
                scores = self._run_links(links)
                for r, s in zip(links, scores):
                    self._resolve(r, Response(Status.OK, score=float(s),
                                              tier="model"))
                self._failures = 0
                return
            except Exception:
                self._record_failure()
                tier = "edgebank"  # fall through to the warm tier
        src = np.array([r.src for r in links], np.int64)
        dst = np.array([r.dst for r in links], np.int64)
        t = np.array([r.t for r in links], np.int64)
        with self._state_lock:
            scores = self.edgebank.predict_link(src, dst, t)
        for r, s in zip(links, scores):
            self._resolve(r, Response(Status.DEGRADED, score=float(s),
                                      tier="edgebank"))

    def _record_failure(self) -> None:
        self._failures += 1
        self.stats["model_errors"] += 1
        self.telemetry.count("serve/model_errors")

    def _run_links(self, links: list[_Request]) -> np.ndarray:
        B = len(links)
        seeds = self._transfer(np.array(
            [r.src for r in links] + [r.dst for r in links], np.int32))
        t = self._transfer(np.array([r.t for r in links] * 2, np.int32))
        t0 = time.perf_counter()
        seeds, t = self._on_device(seeds), self._on_device(t)
        with self._state_lock:
            blk = self.sampler.sample(seeds, query_t=t)
        with torch.no_grad():
            scores = _host(self._score_fn(
                seeds, t, blk.nbr_ids, blk.nbr_times, blk.mask))
        assert scores.shape == (B,)
        self._observe_latency(time.perf_counter() - t0)
        return scores

    def _run_embeds(self, embeds: list[_Request]) -> list[np.ndarray]:
        seeds = self._transfer(np.array([r.src for r in embeds], np.int32))
        t = self._transfer(np.array([r.t for r in embeds], np.int32))
        t0 = time.perf_counter()
        seeds, t = self._on_device(seeds), self._on_device(t)
        with self._state_lock:
            blk = self.sampler.sample(seeds, query_t=t)
        with torch.no_grad():
            h = _host(self._embed_fn(
                seeds, t, blk.nbr_ids, blk.nbr_times, blk.mask))
        self._observe_latency(time.perf_counter() - t0)
        return [h[i] for i in range(h.shape[0])]

    def _event_columns(self, src: int, dst: int, t: int, eid: int):
        """One event as four (1,) int32 tensors on the service's device,
        staged by a single copy: on the card from pinned memory without
        waiting for the card (a copy from pageable memory waits for every
        update queued before it, so four of them an event would hold the
        ingest thread to the card's pace)."""
        ev = torch.tensor([src, dst, t, eid], dtype=torch.int32)
        if self.device.type == "cuda":
            ev = ev.pin_memory().to(self.device, non_blocking=True)
        return ev[0:1], ev[1:2], ev[2:3], ev[3:4]

    def _on_device(self, a: np.ndarray) -> torch.Tensor:
        """A request column as an int32 tensor on the service's device."""
        return torch.from_numpy(np.array(a, np.int32)).to(self.device)

    def _observe_latency(self, lat: float) -> None:
        ewma = self._lat.update(lat)
        tel = self.telemetry
        if tel.enabled:
            tel.observe("serve/latency/model_call", lat)
            tel.gauge("serve/model_latency_ewma", ewma)

    # --------------------------------------------------------- durability

    def snapshot(self, ckpt_dir: str, step: int = 0) -> None:
        """Crash-safe snapshot: drain in-flight events, then write sampler
        buffers + EdgeBank memory + the event cursor atomically through
        :mod:`repro_torch.distributed.checkpoint` (the reference's layout
        and keys: ``sampler/``, ``edgebank/``, ``cursor/``)."""
        self.drain()
        with self._state_lock:
            applied = np.fromiter(sorted(self._applied), dtype=np.int64,
                                  count=len(self._applied))
            payload = {
                "sampler": self.sampler.state_dict(),
                "edgebank": self.edgebank.state_dict(),
                "cursor": {
                    "applied_eids": applied,
                    "last_t": np.asarray(self._last_t, np.int64),
                    "event_cursor": np.asarray(self._event_cursor, np.int64),
                },
            }
        ckpt.save(ckpt_dir, step, payload)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Load a :meth:`snapshot` back into this service (inverse of
        snapshot; returns the restored step). The learned tier's params are
        re-derived from ``seed``, so sampler + EdgeBank + cursor are the
        full mutable state and a restored service answers bit-identically
        to one that never died. Reads a snapshot of either package."""
        flat, got_step, _ = ckpt.restore(ckpt_dir, step=step)
        groups: dict[str, dict] = {}
        for k, v in flat.items():
            g, name = k.split("/", 1)
            groups.setdefault(g, {})[name] = v
        with self._state_lock:
            self.sampler.load_state_dict(groups["sampler"])
            self.edgebank.load_state_dict(groups["edgebank"])
            cur = groups["cursor"]
            self._applied = set(np.asarray(cur["applied_eids"]).tolist())
            self._last_t = int(cur["last_t"])
            self._event_cursor = int(cur["event_cursor"])
        return got_step

    # ---------------------------------------------------------- lifecycle

    def _check_alive(self) -> None:
        if self._stop.is_set():
            raise RuntimeError("OnlineGraphService is stopped")

    def stop(self) -> None:
        """Idempotent shutdown: stop both workers and fail any outstanding
        requests (callers blocked in ``result()`` wake with FAILED rather
        than deadlocking), then wait for the card to finish what the
        workers queued on it."""
        if self._stop.is_set():
            return
        self._stop.set()
        self._evq.put(_STOP)
        self._reqq.put(_STOP)
        self._ingest_thread.join(timeout=10)
        self._batch_thread.join(timeout=10)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        """Context-manager entry (service threads already run)."""
        return self

    def __exit__(self, *exc):
        """Context-manager exit: :meth:`stop`."""
        self.stop()
        return False
