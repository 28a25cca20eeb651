"""The port's runtime observability hooks and the deprecated profiler shim.

Held on the CPU: ``device_memory_gauges`` sets nothing and returns ``{}``
without CUDA (as the reference's on a CPU-only host); ``trace_capture``
writes a Chrome trace under its log directory and a ``profiler/trace`` span
naming it; ``repro_torch.utils.Profiler`` warns with ``DeprecationWarning``
and gives the reference's ``times`` / ``counts`` keys for the same sections;
and one sink sees a CTDG link epoch, a serving chaos run, a windowed
storage epoch and a streaming CSR build, every record valid, with the same
record names as the reference's run of the same scenario.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import pytest
import torch


def test_device_memory_gauges_empty_without_cuda(monkeypatch):
    from repro_torch.obs import MemorySink, Telemetry, device_memory_gauges

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sink = MemorySink()
    tel = Telemetry(sink)
    assert device_memory_gauges(tel) == {}
    tel.flush()
    assert not [r for r in sink.records if r["kind"] == "gauge"]


def test_trace_capture_writes_trace_and_span(tmp_path):
    from repro_torch.obs import MemorySink, Telemetry, trace_capture, validate

    sink = MemorySink()
    tel = Telemetry(sink)
    logdir = tmp_path / "trace"
    with trace_capture(str(logdir), telemetry=tel):
        x = torch.ones(64, 64)
        (x @ x).sum()
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(logdir / files[0]) as f:
        trace = json.load(f)
    assert any("aten::mm" in ev.get("name", "") for ev in trace["traceEvents"])
    spans = [r for r in sink.records if r["kind"] == "span"]
    assert [s["name"] for s in spans] == ["profiler/trace"]
    assert spans[0]["attrs"]["logdir"] == str(logdir)
    for r in sink.records:
        validate(r)


def _sections(make):
    p = make()
    for _ in range(2):
        with p("outer"):
            with p("inner"):
                time.sleep(0.001)
            with p("other"):
                pass
    with p("solo"):
        pass
    return p


def test_profiler_shim_matches_reference():
    from repro.utils import Profiler as JaxProfiler
    from repro_torch.utils import Profiler, profile_section

    with pytest.warns(DeprecationWarning, match="repro_torch.obs.Telemetry"):
        p = _sections(Profiler)
    with pytest.warns(DeprecationWarning):
        q = _sections(JaxProfiler)
    assert dict(p.counts) == dict(q.counts)
    assert p.times.keys() == q.times.keys()
    assert p.times["outer"] >= p.times["outer.inner"] > 0
    assert "outer" in p.report(min_pct=0.0)
    with pytest.warns(DeprecationWarning):
        blocking = Profiler(block=True)
    with profile_section(blocking, "a"), profile_section(None, "b"):
        pass
    assert dict(blocking.counts) == {"a": 1}
    p.reset()
    assert p.total() == 0.0


def _scenario(pkg, tmp_path):
    """One sink over a CTDG link epoch, a serving chaos run and a windowed
    storage epoch plus a streaming CSR, in package ``pkg`` ("repro" or
    "repro_torch"); returns the records of the shared JSONL file."""
    import importlib

    m = {name: importlib.import_module(f"{pkg}.{name}") for name in
         ("obs", "data", "core", "core.loader", "serve", "storage", "train.loop")}
    obs, port = m["obs"], pkg == "repro_torch"
    dev = {"device": "cpu"} if port else {}
    path = str(tmp_path / f"{pkg}.jsonl")
    tel = obs.Telemetry(obs.FileSink(path))
    mem = tel.attach(obs.MemorySink())

    data = m["data"].generate("tiny").slice_events(0, 300)
    pipe = m["train.loop"].CTDGLinkPipeline(
        "tgat", data, batch_size=100, seed=0, telemetry=tel,
        model_kwargs={"num_layers": 1, "d_model": 16, "d_time": 8}, **dev)
    m["train.loop"].TrainLoop(pipe).fit(epochs=1)

    serve = m["serve"]
    inj = serve.FaultInjector(seed=0, dup_p=0.1, fail_p=0.3)
    rng = np.random.default_rng(1)
    events = [(int(rng.integers(40)), int(rng.integers(40)), 100 + i, i)
              for i in range(80)]
    with serve.OnlineGraphService(40, k=4, flush_interval=0.002,
                                  fault_injector=inj, telemetry=tel, **dev) as svc:
        svc.ingest_many(inj.perturb_events(events))
        svc.drain()
        rs = [svc.submit_link(i % 40, (i * 3 + 1) % 40, 500).result(30)
              for i in range(10)]
    assert all(r.status is not None for r in rs)
    assert tel.counter_value("serve/events_applied") > 0

    src, dst = rng.integers(0, 40, 400), rng.integers(0, 40, 400)
    t = np.sort(rng.integers(0, 5000, 400))
    store = m["storage"].InMemoryStore.from_data(
        m["core"].DGData.from_arrays(src, dst, t, granularity="s"))
    loader = m["core.loader"].PrefetchLoader(
        m["storage"].StoreEventLoader(store, batch_size=100, telemetry=tel),
        telemetry=tel, **dev)
    assert len(list(loader)) == 4
    m["storage"].streaming_csr(store, chunk_size=150, telemetry=tel)
    assert tel.counter_value("storage/windows_read") > 0
    assert tel.counter_value("storage/csr_windows") > 0
    assert tel.counter_value("loader/batches") == 4
    tel.flush()
    with open(path) as f:
        records = [json.loads(ln) for ln in f.read().splitlines()]
    assert len(records) == len(mem.records)
    for r in records:
        obs.validate(r)
    assert "section" in obs.span_report(records, min_pct=0.0)
    return records


def test_single_sink_observes_train_serve_and_storage(tmp_path):
    got = {r["name"] for r in _scenario("repro_torch", tmp_path)}
    want = {r["name"] for r in _scenario("repro", tmp_path)}
    assert {"ctdg/epoch", "ctdg/step", "storage/csr_pass1", "storage/csr_pass2",
            "serve/events_applied"} <= got
    assert got == want
