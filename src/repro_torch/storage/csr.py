"""Streaming (two-pass, O(chunk)-resident) CSR-by-time adjacency build.

The uniform samplers' adjacency is the doubled edge list — each event
contributes ``(src -> dst)`` and ``(dst -> src)`` — laid out node-major
with times ascending per node. The in-RAM builders
(``UniformSampler.build`` / ``DeviceUniformSampler.build``) get there
with one global ``lexsort`` over ``2E`` materialized arrays;
:func:`streaming_csr` produces the same layout from any ``EventStore`` in
two windowed passes over the stream:

  1. **degree count** — accumulate per-node degrees (``bincount`` per
     window) into the global ``indptr``, and collect the unique-time table
     ``tvals`` (the stream is time-sorted, so per-window uniques merge at
     boundaries in O(#distinct) memory);
  2. **chunked fill** — for each window, double its events in *event
     order* (src entry then dst entry per event), stable-sort the chunk by
     node, and scatter each node's run at its write cursor. Because the
     stream is time-sorted, per-node runs land time-ascending — the CSR
     invariant — without ever sorting (or holding) the full edge list.

Only one window is resident at a time; the output arrays are plain RAM by
default or disk-backed memmaps under ``scratch_dir`` (for adjacencies that
exceed host RAM). The layout is **bit-identical** to the
in-RAM builders whenever no two *distinct* events share a ``(node,
timestamp)`` pair (always true for streams with unique timestamps;
self-loops are fine). On colliding pairs the builders break ties
differently — streaming keeps event order per entry-pair, ``lexsort``
keeps all src-side entries first — both are valid time-respecting layouts
and sampling distributions are identical; pipelines that need bit-exact
backend parity build both backends through this function (see
``train.loop.CTDGLinkPipeline``).
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def _alloc(scratch_dir: Optional[str], name: str, shape, dtype):
    """RAM array, or a disk-backed memmap under ``scratch_dir``."""
    if scratch_dir is None:
        return np.empty(shape, dtype)
    os.makedirs(scratch_dir, exist_ok=True)
    return np.lib.format.open_memmap(
        os.path.join(scratch_dir, name + ".npy"), mode="w+", dtype=dtype,
        shape=tuple(shape))


def streaming_csr(store, *, num_nodes: Optional[int] = None,
                  chunk_size: int = 1 << 20,
                  scratch_dir: Optional[str] = None,
                  with_keys: bool = True,
                  release: bool = True,
                  telemetry=None) -> dict:
    """Build the node-major/time-ascending doubled-edge CSR from a store.

    Returns ``{"adj_nbr", "adj_t", "adj_e", "indptr"}`` int64 (the shared
    uniform-sampler checkpoint contract) plus — when ``with_keys`` — the
    derived search structures ``{"adj_key", "tvals", "base"}`` (int64 key)
    that ``DeviceUniformSampler.build_from_store`` places as they are. Peak
    residency is O(chunk) beyond the outputs; pass ``scratch_dir`` to park
    the O(E) outputs on disk too. ``release=True`` drops the store's
    mapped pages after each window (memmap backends). ``telemetry`` (a
    ``repro_torch.obs.Telemetry``) times each pass as a ``storage/csr_pass1`` /
    ``storage/csr_pass2`` span and counts windows per pass
    (``storage/csr_windows``, on top of the window iterator's own
    read/release counters).
    """
    from repro_torch.obs import NULL

    tel = telemetry if telemetry is not None else NULL
    n = int(num_nodes if num_nodes is not None else store.num_nodes)
    E = store.num_edge_events

    # -- pass 1: degrees + unique-time table ----------------------------
    deg = np.zeros(n, dtype=np.int64)
    tvals_parts = []
    last_t = None
    with tel.span("storage/csr_pass1", events=E):
        for w in store.iter_windows(batch_size=chunk_size, release=release,
                                    telemetry=tel):
            tel.count("storage/csr_windows")
            deg += np.bincount(w.src, minlength=n)
            deg += np.bincount(w.dst, minlength=n)
            if with_keys and len(w):
                u = np.unique(np.asarray(w.t, dtype=np.int64))
                if last_t is not None and len(u) and u[0] == last_t:
                    u = u[1:]
                if len(u):
                    tvals_parts.append(u)
                    last_t = int(u[-1])
    indptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    m = int(indptr[-1])
    assert m == 2 * E, "degree pass disagrees with the event count"

    tvals = base = None
    if with_keys:
        tvals = (np.concatenate(tvals_parts) if tvals_parts
                 else np.empty(0, np.int64))
        base = len(tvals) + 1

    # -- pass 2: chunked fill at per-node write cursors ------------------
    adj_nbr = _alloc(scratch_dir, "adj_nbr", (m,), np.int64)
    adj_t = _alloc(scratch_dir, "adj_t", (m,), np.int64)
    adj_e = _alloc(scratch_dir, "adj_e", (m,), np.int64)
    adj_key = (_alloc(scratch_dir, "adj_key", (m,), np.int64)
               if with_keys else None)
    cursor = indptr[:-1].copy()
    with tel.span("storage/csr_pass2", entries=m):
        for w in store.iter_windows(batch_size=chunk_size, release=release,
                                    telemetry=tel):
            tel.count("storage/csr_windows")
            c = len(w)
            if c == 0:
                continue
            # Doubled entries in event order: (src->dst) then (dst->src).
            nodes = np.empty(2 * c, np.int64)
            nodes[0::2], nodes[1::2] = w.src, w.dst
            nbrs = np.empty(2 * c, np.int64)
            nbrs[0::2], nbrs[1::2] = w.dst, w.src
            times = np.repeat(np.asarray(w.t, np.int64), 2)
            es = np.repeat(np.asarray(w.eids, np.int64), 2)
            order = np.argsort(nodes, kind="stable")
            snodes = nodes[order]
            uniq, starts, counts = np.unique(snodes, return_index=True,
                                             return_counts=True)
            pos = cursor[snodes] + (
                np.arange(2 * c) - np.repeat(starts, counts))
            adj_nbr[pos] = nbrs[order]
            st = times[order]
            adj_t[pos] = st
            adj_e[pos] = es[order]
            if with_keys:
                adj_key[pos] = snodes * base + np.searchsorted(tvals, st)
            cursor[uniq] += counts
    out = {"adj_nbr": adj_nbr, "adj_t": adj_t, "adj_e": adj_e,
           "indptr": indptr}
    if with_keys:
        out.update(adj_key=adj_key, tvals=tvals, base=base)
    return out
