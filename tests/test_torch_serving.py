"""The online graph service in the port (``repro_torch.serve``), on the CPU.

Held:

* the reference's ``tests/test_serving.py`` cases on the port's service
  (``device="cpu"``), with the same generous timeouts: microbatching,
  deadline shedding, EdgeBank degradation and breaker recovery, ingest
  dedup and out-of-order counting, shutdown without deadlock, snapshot and
  restore bit-identical to an uninterrupted service, the chaos run with its
  tallies equal to the telemetry counters;
* the learned tier (``learned_embed``, ``_link_scores``) against the
  reference's on converted parameters and the same neighbor blocks, within
  2e-5. The reference's ``_link_scores`` is jitted, and XLA's CPU compiler
  fuses the time encoding's ``dt * w + b`` into one FMA, which moves it at
  large time deltas (ROADMAP C, "Rounding under jit"); these tests keep the
  deltas below 200 s, where the two roundings agree to far below 2e-5;
* a request's score is the same bits whichever flush carried it (flushes
  of 1, 7 and 32 requests: every flush runs at ``max_batch`` rows);
* ``EdgeBank`` (both modes) and ``FaultInjector``'s draws bit-equal to the
  reference's; ``DeviceRecencySampler.sample(query_t=)`` equal to the
  reference's;
* a snapshot written by either package's service restores into the
  other's: sampler, EdgeBank and cursor equal, and the same scores (within
  2e-5) with the reference's parameters converted.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from repro.core.device_sampler import DeviceRecencySampler as JaxRecency
from repro.models.tg.edgebank import EdgeBank as JaxEdgeBank
from repro.serve import FaultInjector as JaxFaultInjector
from repro.serve import OnlineGraphService as JaxService
from repro.serve import graph_service as jax_gs
from repro_torch.convert import params_from_jax
from repro_torch.core.device_sampler import DeviceRecencySampler
from repro_torch.models.tg.edgebank import EdgeBank
from repro_torch.serve import FaultInjector, ModelFault, OnlineGraphService, Status
from repro_torch.serve import graph_service as gs

ATOL = 2e-5


def _events(n, num_nodes=40, seed=0, t0=100):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(num_nodes)), int(rng.integers(num_nodes)),
             t0 + i, i) for i in range(n)]


def _mk(num_nodes=40, **kw):
    kw.setdefault("k", 4)
    kw.setdefault("flush_interval", 0.002)
    return OnlineGraphService(num_nodes, device="cpu", **kw)


# ---------------------------------------------------------------- batching

def test_flush_on_timeout_single_request():
    with _mk() as svc:
        svc.ingest_many(_events(50))
        svc.drain()
        r = svc.predict_link(1, 2, 500)
        assert r.status is Status.OK and r.tier == "model"
        assert 0.0 <= r.score <= 1.0
        e = svc.embed(1, 500)
        assert e.status is Status.OK and e.embedding.shape == (32,)


def test_flush_on_size():
    with _mk(max_batch=4, flush_interval=5.0) as svc:  # size-only flush
        svc.ingest_many(_events(50))
        svc.drain()
        pend = [svc.submit_link(i, i + 1, 500) for i in range(4)]
        assert all(p.result(timeout=10).status is Status.OK for p in pend)


def test_deadline_shedding_is_explicit():
    with _mk() as svc:
        r = svc.submit_link(1, 2, 500, timeout=0.0).result(timeout=10)
        assert r.status is Status.REJECTED and "deadline" in r.detail
        assert svc.stats["rejected"] == 1


# -------------------------------------------------------------- degradation

def test_degrades_to_edgebank_and_probe_recovers():
    broken = {"on": True}

    def model(seeds, t, ids, times, mask):
        if broken["on"]:
            raise ModelFault("boom")
        return np.full(len(seeds) // 2, 0.5, np.float32)

    with _mk(model_fn=model, fail_threshold=2, probe_every=2) as svc:
        svc.ingest(3, 4, 100, 0)
        svc.drain()
        for _ in range(2):
            r = svc.predict_link(3, 4, 500)
            assert r.status is Status.DEGRADED and r.tier == "edgebank"
        assert svc.stats["model_errors"] == 2
        r = svc.predict_link(3, 4, 500)
        assert r.status is Status.DEGRADED and r.score == 1.0
        r = svc.predict_link(7, 8, 500)  # unseen pair
        assert r.status is Status.DEGRADED and r.score == 0.0
        broken["on"] = False
        statuses = [svc.predict_link(3, 4, 500).status for _ in range(4)]
        assert Status.OK in statuses and statuses[-1] is Status.OK
        assert svc.stats["probes"] >= 1


def test_embed_has_no_fallback_tier():
    def model(*a):
        raise ModelFault("boom")

    with _mk(model_fn=model, embed_fn=model, fail_threshold=1) as svc:
        svc.predict_link(1, 2, 100)  # opens the breaker
        r = svc.embed(1, 100)
        assert r.status is Status.FAILED and "no fallback" in r.detail


def test_latency_budget_degrades():
    def slow(seeds, t, ids, times, mask):
        time.sleep(0.05)
        return np.zeros(len(seeds) // 2, np.float32)

    with _mk(model_fn=slow, latency_budget=0.01, probe_every=100) as svc:
        assert svc.predict_link(1, 2, 100).status is Status.OK
        second = svc.predict_link(1, 2, 100)
        assert second.status is Status.DEGRADED and second.tier == "edgebank"


# ------------------------------------------------------------------ ingest

def test_ingest_dedup_and_out_of_order_counting():
    with _mk() as svc:
        svc.ingest(1, 2, 100, 7)
        svc.ingest(1, 2, 100, 7)   # duplicate eid: dropped
        svc.ingest(3, 4, 50, 8)    # out of order: applied + counted
        svc.drain()
        assert svc.stats["events_applied"] == 2
        assert svc.stats["events_deduped"] == 1
        assert svc.stats["events_out_of_order"] == 1
        assert svc.predict_link(3, 4, 500).status is Status.OK


def test_stop_fails_outstanding_requests_no_deadlock():
    def hang(seeds, t, ids, times, mask):
        time.sleep(0.2)
        return np.zeros(len(seeds) // 2, np.float32)

    svc = _mk(model_fn=hang)
    pend = [svc.submit_link(i, i + 1, 100) for i in range(3)]
    svc.stop()
    for p in pend:
        assert p.result(timeout=10).status in (Status.OK, Status.FAILED)
    with pytest.raises(RuntimeError):
        svc.ingest(1, 2, 3)


# -------------------------------------------------------------- durability

def test_snapshot_restore_bit_parity(tmp_path):
    ev = _events(120, seed=3)
    queries = [(s, d, 1000) for s, d, _, _ in _events(20, seed=9)]
    with _mk(seed=5) as clean:
        clean.ingest_many(ev)
        clean.drain()
        want = [clean.predict_link(*q).score for q in queries]
    with _mk(seed=5) as victim:
        victim.ingest_many(ev[:60])
        victim.snapshot(str(tmp_path), step=60)
    with _mk(seed=5) as revived:
        assert revived.restore(str(tmp_path)) == 60
        revived.ingest_many(ev[55:])  # eids 55-59 already applied
        revived.drain()
        assert revived.stats["events_deduped"] == 5
        got = [revived.predict_link(*q).score for q in queries]
    assert got == want  # bit-identical


def test_edgebank_state_roundtrip():
    bank = EdgeBank(30, window=50)
    rng = np.random.default_rng(0)
    bank.update_memory(rng.integers(0, 30, 40), rng.integers(0, 30, 40),
                       rng.integers(0, 200, 40))
    clone = EdgeBank(30, window=50)
    clone.load_state_dict(bank.state_dict())
    src, dst, t = (rng.integers(0, 30, 50), rng.integers(0, 30, 50),
                   rng.integers(0, 300, 50))
    np.testing.assert_array_equal(bank.predict_link(src, dst, t),
                                  clone.predict_link(src, dst, t))
    a, b = bank.state_dict(), clone.state_dict()
    np.testing.assert_array_equal(a["keys"], b["keys"])
    np.testing.assert_array_equal(a["times"], b["times"])


# ------------------------------------------------------------------- chaos

def test_chaos_never_deadlocks_and_degrades_gracefully():
    from repro_torch.obs import MemorySink, Telemetry, validate

    inj = FaultInjector(seed=0, drop_p=0.05, dup_p=0.05, reorder_p=0.15,
                        reorder_span=3, slow_p=0.5, slow_s=0.02, fail_p=0.6)
    sink = MemorySink()
    tel = Telemetry(sink)
    svc = _mk(num_nodes=60, fault_injector=inj, fail_threshold=2,
              probe_every=3, latency_budget=0.05, telemetry=tel)
    try:
        svc.ingest_many(inj.perturb_events(_events(150, num_nodes=60, seed=1)))
        svc.drain()
        assert inj.stats["dropped"] > 0 and inj.stats["duplicated"] > 0
        assert inj.stats["reordered"] > 0
        assert svc.stats["events_deduped"] >= inj.stats["duplicated"]
        pend = [svc.submit_link(int(i % 60), int((i * 7 + 1) % 60), 1000,
                                timeout=5.0) for i in range(30)]
        pend += [svc.submit_link(1, 2, 1000, timeout=0.0) for _ in range(3)]
        results = [p.result(timeout=30) for p in pend]
        statuses = {r.status for r in results}
        assert Status.REJECTED in statuses and Status.DEGRADED in statuses
        for r in results:
            if r.status in (Status.OK, Status.DEGRADED):
                assert r.score is not None and 0.0 <= r.score <= 1.0
        assert inj.stats["model_faults"] > 0
        assert sum(svc.stats[s] for s in ("ok", "degraded", "rejected", "failed")) \
            == len(results)
        assert tel.counter_value("serve/events_deduped") == svc.stats["events_deduped"]
        assert tel.counter_value("serve/model_errors") == svc.stats["model_errors"]
        assert sum(tel.counter_value(f"serve/requests_{s}") for s in
                   ("ok", "degraded", "rejected", "failed")) == len(results)
        answered = sum(tel.histogram(f"serve/latency/{tier}").count
                       for tier in ("model", "edgebank")
                       if tel.histogram(f"serve/latency/{tier}") is not None)
        assert answered == svc.stats["ok"] + svc.stats["degraded"]
        tel.flush()
        for rec in sink.records:
            validate(rec)
    finally:
        svc.stop()


def test_concurrent_ingest_and_requests_keep_the_sampler_exact():
    """Ingest on the service's thread while four client threads submit
    requests, with a short switch interval: every request resolves from the
    model tier, and after a drain the sampler holds exactly the state of
    the same events applied in order (a lost or torn update would differ)."""
    import sys
    import threading

    ev = _events(300, seed=11)
    want = DeviceRecencySampler(40, 4, device="cpu")
    for s, d, t, e in ev:
        want.update([s], [d], [t], [e])
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with _mk() as svc:
            results, errors = [], []

            def client(seed):
                try:
                    for s, d, _, _ in _events(25, seed=seed):
                        results.append(svc.predict_link(s, d, 1000, timeout=30))
                except Exception as e:  # surfaced by the assert below
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
            for th in threads:
                th.start()
            svc.ingest_many(ev)
            for th in threads:
                th.join(timeout=60)
            svc.drain()
            assert not any(th.is_alive() for th in threads) and not errors
            assert len(results) == 100
            assert all(r.status is Status.OK and r.tier == "model" for r in results)
            got, ref = svc.sampler.state_dict(), want.state_dict()
            for k in ref:
                np.testing.assert_array_equal(got[k], ref[k])
    finally:
        sys.setswitchinterval(interval)


# -------------------------------------------------- against the reference

def _blocks(rng, B, k=4, n=40, t_hi=1000, max_dt=150):
    """Seeds, query times and neighbor blocks with time deltas below
    ``max_dt`` (some slots masked, one row empty)."""
    seeds = rng.integers(0, n + 1, B).astype(np.int32)
    t = rng.integers(max_dt, t_hi, B).astype(np.int32)
    ids = rng.integers(0, n, (B, k)).astype(np.int32)
    times = (t[:, None] - rng.integers(0, max_dt, (B, k))).astype(np.int32)
    mask = rng.random((B, k)) < 0.7
    mask[0] = False
    ids, times = np.where(mask, ids, -1), np.where(mask, times, 0)
    return seeds, t, ids, times, mask


def test_learned_tier_matches_reference():
    jparams = jax_gs.learned_link_params(jax.random.PRNGKey(3), 40)
    params = params_from_jax(jax.device_get(jparams))
    rng = np.random.default_rng(0)
    seeds, t, ids, times, mask = _blocks(rng, 12)
    as_t = [torch.from_numpy(x) for x in (seeds, t, ids, times, mask)]
    want = np.asarray(jax_gs.learned_embed(jparams, seeds, t, ids, times, mask))
    got = gs.learned_embed(params, *as_t).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(gs._embed_rows(params, *as_t, pad_to=32).numpy(),
                               want, rtol=0, atol=ATOL)
    want = np.asarray(jax_gs._link_scores(jparams, seeds, t, ids, times, mask))
    for pad in (None, 32):
        got = gs._link_scores(params, *as_t, pad_to=pad).numpy()
        assert got.shape == (6,)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_learned_params_shapes_and_seed():
    a = gs.learned_link_params(7, 40, device="cpu")
    b = gs.learned_link_params(7, 40, device="cpu")
    jp = jax.device_get(jax_gs.learned_link_params(jax.random.PRNGKey(7), 40))

    def leaves(tree, prefix=""):
        for k, v in sorted(tree.items()):
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, v

    la, lb, lj = dict(leaves(a)), dict(leaves(b)), dict(leaves(jp))
    assert la.keys() == lj.keys()
    for k in la:
        assert tuple(la[k].shape) == np.shape(lj[k]) and torch.equal(la[k], lb[k])


def test_flush_composition_is_bit_identical():
    """The same requests answered in flushes of 1, 7 and 32 (each group
    submitted after the last one resolved): the same bits, since every
    flush runs at ``max_batch`` rows."""
    ev = _events(200, seed=2)
    reqs = [(s, d, 400) for s, d, _, _ in _events(32, seed=8)]
    out = []
    for size in (1, 7, 32):
        sizes = []
        with _mk(seed=1, max_batch=32, flush_interval=0.05) as svc:
            def model(seeds, *rest, svc=svc, sizes=sizes):
                sizes.append(len(seeds) // 2)
                return gs._link_scores(svc.params, seeds, *rest, pad_to=32)

            svc._score_fn = model
            svc.ingest_many(ev)
            svc.drain()
            scores = []
            for lo in range(0, len(reqs), size):
                pend = [svc.submit_link(*q) for q in reqs[lo:lo + size]]
                scores += [p.result(timeout=30).score for p in pend]
            assert svc.stats["ok"] == len(reqs)
        assert max(sizes) <= size and sum(sizes) == len(reqs)
        out.append(scores)
    assert out[0] == out[1] == out[2]


@pytest.mark.parametrize("window", [None, 50])
def test_edgebank_equals_reference(window):
    rng = np.random.default_rng(1)
    a, b = EdgeBank(30, window=window), JaxEdgeBank(30, window=window)
    for _ in range(3):
        upd = (rng.integers(0, 30, 25), rng.integers(0, 30, 25),
               rng.integers(0, 200, 25))
        a.update_memory(*upd)
        b.update_memory(*upd)
    q = rng.integers(0, 30, 60), rng.integers(0, 30, 60), rng.integers(0, 300, 60)
    np.testing.assert_array_equal(a.predict_link(*q), b.predict_link(*q))
    many = rng.integers(0, 30, (10, 4))
    np.testing.assert_array_equal(a.predict_many(q[0][:10], many, q[2][:10]),
                                  b.predict_many(q[0][:10], many, q[2][:10]))
    sa, sb = a.state_dict(), b.state_dict()
    for k in ("keys", "times"):
        np.testing.assert_array_equal(sa[k], sb[k])
        assert sa[k].dtype == sb[k].dtype


def test_fault_injector_draws_equal_reference():
    kw = dict(drop_p=0.1, dup_p=0.1, reorder_p=0.2, reorder_span=3,
              slow_p=0.3, slow_s=0.0, fail_p=0.4, transfer_fail_p=0.2)
    a, b = FaultInjector(seed=4, **kw), JaxFaultInjector(seed=4, **kw)
    ev = _events(200, seed=5)
    assert a.perturb_events(ev) == b.perturb_events(ev)

    def schedule(inj):
        step = inj.wrap_model(lambda: "ok")
        move = inj.wrap_transfer(lambda: "ok")
        out = []
        for fn in (step, move) * 40:
            try:
                out.append(fn())
            except RuntimeError as e:
                out.append(type(e).__name__)
        return out

    assert schedule(a) == schedule(b)
    assert a.stats == b.stats


def test_query_t_sample_equals_reference():
    rng = np.random.default_rng(6)
    a, b = DeviceRecencySampler(30, 5, device="cpu"), JaxRecency(30, 5)
    for lo in range(0, 120, 40):
        src, dst = rng.integers(0, 30, 40), rng.integers(0, 30, 40)
        t, eids = np.arange(lo, lo + 40), np.arange(lo, lo + 40)
        a.update(src, dst, t, eids)
        b.update(src, dst, t, eids)
    seeds = rng.integers(0, 30, 50)
    qt = rng.integers(0, 130, 50)
    for q in (None, qt):
        x, y = a.sample(seeds, query_t=q), b.sample(seeds, query_t=q)
        for f in ("nbr_ids", "nbr_times", "nbr_eids", "mask"):
            np.testing.assert_array_equal(getattr(x, f).numpy(),
                                          np.asarray(getattr(y, f)))
    assert not a.sample(seeds, query_t=qt).mask.all()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_snapshot_restores_across_packages(tmp_path, writer):
    """A snapshot written by one package's service restores into the
    other's: sampler, EdgeBank and cursor equal, and (with the reference's
    parameters converted) the same scores within 2e-5."""
    ev = _events(90, seed=3, t0=1000)
    queries = [(s, d, 1100) for s, d, _, _ in _events(6, seed=9)]
    ref = JaxService(40, k=4, flush_interval=0.002, seed=5)
    port = _mk(seed=5)
    port.params = params_from_jax(jax.device_get(ref.params))
    try:
        src, dst = (ref, port) if writer == "reference" else (port, ref)
        src.ingest_many(ev[:60])
        src.snapshot(str(tmp_path), step=60)
        assert dst.restore(str(tmp_path)) == 60
        for s in (ref, port):
            s.ingest_many(ev[55:])  # eids 55-59 deduped on the restored one
            s.drain()
        assert dst.stats["events_deduped"] == 5
        sa, sb = port.sampler.state_dict(), ref.sampler.state_dict()
        for k in sa:
            np.testing.assert_array_equal(sa[k], sb[k])
        for k in ("keys", "times"):
            np.testing.assert_array_equal(port.edgebank.state_dict()[k],
                                          ref.edgebank.state_dict()[k])
        assert port._applied == ref._applied
        assert (port._last_t, port._event_cursor) == (ref._last_t, ref._event_cursor)
        got = [port.predict_link(*q, timeout=30) for q in queries]
        want = [ref.predict_link(*q, timeout=30) for q in queries]
        assert all(r.tier == "model" for r in got + want)
        np.testing.assert_allclose([r.score for r in got], [r.score for r in want],
                                   rtol=0, atol=ATOL)
    finally:
        ref.stop()
        port.stop()
