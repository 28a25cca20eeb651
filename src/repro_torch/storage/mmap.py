"""``MmapStore`` — the memory-mapped columnar ``EventStore`` backend.

On-disk layout (``docs/storage.md``): a directory holding **one ``.npy``
file per column** (``src.npy``/``dst.npy``/``edge_t.npy`` int64, optional
``edge_feats.npy`` float32, optional node-event and static-feature
columns) plus a fsync'd ``manifest.json`` recording dtype/shape/byte-size
per column. Opening a store memory-maps each column read-only
(``np.lib.format.open_memmap``), so every ``DGData``/loader/sampler path
downstream reads O(touched pages) instead of O(stream) — and
:meth:`MmapStore.release` hands the pages back (``madvise(MADV_DONTNEED)``)
so a windowed epoch's resident set stays bounded by the window.

Writes follow the ``distributed/checkpoint`` atomic-publish idiom: the
converter streams columns into ``<path>.tmp`` (fixed-size ``.npy`` headers
rewritten with the final row count at close), fsyncs every file, writes +
fsyncs the manifest, fsyncs the tmp directory, then ``os.rename``s it into
place and fsyncs the parent — a crash mid-convert can never publish a torn
store, and :meth:`MmapStore.is_intact` cross-checks byte sizes against the
manifest. The converters (:meth:`from_chunks` / :meth:`from_csv` /
:meth:`from_arrays`) are **chunked**: nothing ever materializes the full
stream, so a host can convert streams much larger than its RAM.
"""

from __future__ import annotations

import json
import mmap as _mmap_mod
import os
import struct
from typing import Iterable, Optional, Sequence

import numpy as np

from repro_torch.core.granularity import TimeDelta
from repro_torch.storage.base import EventStore

MANIFEST = "manifest.json"
FORMAT = "repro-eventstore"
VERSION = 1

# Fixed total .npy header size (magic + version + HEADER_LEN + dict + pad).
# Writing a placeholder header first and rewriting it with the final shape
# at close keeps the data stream append-only; 128 bytes fits any row count
# that fits an int64 and keeps data 64-byte aligned.
_NPY_HEADER_BYTES = 128

EDGE_COLUMNS = ("src", "dst", "edge_t")
OPTIONAL_COLUMNS = ("edge_feats", "eid", "node_ids", "node_t", "node_feats",
                    "static_node_feats")


def _fsync_path(path: str) -> None:
    """fsync a file or directory so the write survives power loss."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _npy_header(dtype: np.dtype, shape) -> bytes:
    """A v1.0 ``.npy`` header padded to exactly ``_NPY_HEADER_BYTES``."""
    descr = {"descr": np.lib.format.dtype_to_descr(np.dtype(dtype)),
             "fortran_order": False, "shape": tuple(int(s) for s in shape)}
    body = repr(descr).encode("latin1")
    magic = b"\x93NUMPY\x01\x00"
    hlen = _NPY_HEADER_BYTES - len(magic) - 2
    if len(body) > hlen - 1:
        raise ValueError(f"npy header too large for shape {shape}")
    return (magic + struct.pack("<H", hlen) + body
            + b" " * (hlen - 1 - len(body)) + b"\n")


class _ColumnWriter:
    """Append-only ``.npy`` column writer with a rewritten final header."""

    def __init__(self, path: str, dtype, width: Optional[int] = None):
        self.path = path
        self.dtype = np.dtype(dtype)
        self.width = width
        self.rows = 0
        self._f = open(path, "wb")
        self._f.write(_npy_header(self.dtype, self._shape(0)))

    def _shape(self, rows: int):
        return (rows,) if self.width is None else (rows, self.width)

    def append(self, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr, dtype=self.dtype)
        if arr.shape[1:] != self._shape(0)[1:]:
            raise ValueError(
                f"column {os.path.basename(self.path)}: chunk shape "
                f"{arr.shape} does not match {self._shape('N')}")
        self._f.write(arr.tobytes())
        self.rows += len(arr)

    def close(self) -> dict:
        """Rewrite the header with the final shape, fsync, and return the
        manifest entry for this column."""
        self._f.flush()
        self._f.seek(0)
        self._f.write(_npy_header(self.dtype, self._shape(self.rows)))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._f.close()
        return {
            "dtype": np.lib.format.dtype_to_descr(self.dtype),
            "shape": list(self._shape(self.rows)),
            "bytes": os.path.getsize(self.path),
        }


class MmapStore(EventStore):
    """Memory-mapped columnar event storage (read side).

    ``MmapStore(path)`` validates the manifest and maps each column
    read-only; all ``EventStore`` queries then run on the mapped arrays.
    Build stores with the chunked converters: :meth:`from_arrays`,
    :meth:`from_chunks` (any iterable of column-dict chunks — the
    out-of-core entry point), :meth:`from_csv`, or :meth:`from_data`.
    """

    def __init__(self, path: str):
        self.path = str(path)
        man_path = os.path.join(self.path, MANIFEST)
        if not os.path.isfile(man_path):
            raise FileNotFoundError(
                f"{self.path!r} is not an event store (no {MANIFEST}); "
                f"build one with MmapStore.from_arrays/from_csv")
        with open(man_path) as f:
            man = json.load(f)
        if man.get("format") != FORMAT:
            raise ValueError(f"{man_path}: not a {FORMAT} manifest")
        if int(man.get("version", 0)) > VERSION:
            raise ValueError(
                f"{man_path}: version {man['version']} is newer than "
                f"supported {VERSION}")
        self.manifest = man
        self.num_nodes = int(man["num_nodes"])
        g = man["granularity"]
        self.granularity = TimeDelta(g["unit"], int(g.get("value", 1)))
        cols = {}
        for name, meta in man["columns"].items():
            fpath = os.path.join(self.path, name + ".npy")
            size = os.path.getsize(fpath) if os.path.isfile(fpath) else -1
            if size != meta["bytes"]:
                raise ValueError(
                    f"torn store: {fpath} has {size} bytes, manifest says "
                    f"{meta['bytes']} — rebuild the store")
            cols[name] = np.lib.format.open_memmap(fpath, mode="r")
            if list(cols[name].shape) != list(meta["shape"]):
                raise ValueError(
                    f"torn store: {fpath} shape {cols[name].shape} != "
                    f"manifest {meta['shape']}")
        self.src = cols["src"]
        self.dst = cols["dst"]
        self.edge_t = cols["edge_t"]
        self.edge_feats = cols.get("edge_feats")
        self._eids = cols.get("eid")
        self.node_ids = cols.get("node_ids")
        self.node_t = cols.get("node_t")
        self.node_feats = cols.get("node_feats")
        self.static_node_feats = cols.get("static_node_feats")
        self._columns = cols

    # -- residency -------------------------------------------------------
    def release(self) -> None:
        """Advise the kernel to reclaim every mapped page
        (``MADV_DONTNEED``): resident set drops to ~0 for the store,
        touched pages fault back in on next access. Called per-window by
        ``iter_windows(release=True)`` / the store-aware loaders, this
        bounds an epoch's RSS by the window size instead of the stream."""
        advise = getattr(_mmap_mod, "MADV_DONTNEED", None)
        if advise is None:  # pragma: no cover - non-Linux hosts
            return
        for arr in self._columns.values():
            mm = getattr(arr, "_mmap", None)
            if mm is not None:
                try:
                    mm.madvise(advise)
                except (ValueError, OSError):  # pragma: no cover
                    pass

    def __repr__(self) -> str:  # pragma: no cover
        return (f"MmapStore({self.path!r}, edges={self.num_edge_events}, "
                f"nodes={self.num_nodes}, d_edge={self.edge_feat_dim})")

    # -- integrity -------------------------------------------------------
    @staticmethod
    def is_intact(path: str) -> bool:
        """True iff ``path`` holds a manifest whose per-column byte sizes
        all match the files on disk (the torn-write check)."""
        try:
            man_path = os.path.join(path, MANIFEST)
            with open(man_path) as f:
                man = json.load(f)
            if man.get("format") != FORMAT:
                return False
            for name, meta in man["columns"].items():
                if os.path.getsize(
                        os.path.join(path, name + ".npy")) != meta["bytes"]:
                    return False
            return True
        except (OSError, ValueError, KeyError):
            return False

    # -- converters ------------------------------------------------------
    @classmethod
    def from_chunks(cls, path: str, chunks: Iterable[dict], *,
                    granularity: TimeDelta | str = "s",
                    num_nodes: Optional[int] = None,
                    node_events: Optional[dict] = None,
                    static_node_feats=None,
                    overwrite: bool = False) -> "MmapStore":
        """Stream column-dict chunks into a new store — the out-of-core
        converter every other ``from_*`` delegates to.

        Each chunk is ``{"src", "dst", "t"[, "edge_feats"][, "eid"]}``;
        chunks must arrive **time-sorted** (within and across chunks —
        validated; unsorted streams must be sorted upstream, e.g. via
        ``from_arrays``). Only one chunk is resident at a time. Publication
        is atomic: the store appears at ``path`` complete or not at all.
        ``node_events`` (``{"ids", "t"[, "feats"]}``, assumed small) and
        ``static_node_feats`` are written alongside when given.
        """
        path = str(path)
        granularity = TimeDelta.coerce(granularity)
        if os.path.exists(path):
            if not overwrite:
                raise FileExistsError(
                    f"{path} exists; pass overwrite=True to replace it")
            import shutil

            shutil.rmtree(path)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            import shutil

            shutil.rmtree(tmp)
        os.makedirs(tmp)

        writers = {name: _ColumnWriter(os.path.join(tmp, name + ".npy"),
                                       np.int64)
                   for name in EDGE_COLUMNS}
        max_node = -1
        last_t = None
        try:
            for chunk in chunks:
                src = np.ascontiguousarray(chunk["src"], dtype=np.int64)
                dst = np.ascontiguousarray(chunk["dst"], dtype=np.int64)
                t = np.ascontiguousarray(chunk["t"], dtype=np.int64)
                if not (len(src) == len(dst) == len(t)):
                    raise ValueError("chunk src/dst/t length mismatch")
                if len(t) == 0:
                    continue
                if (last_t is not None and t[0] < last_t) or np.any(
                        np.diff(t) < 0):
                    raise ValueError(
                        "from_chunks requires a time-sorted stream (sort "
                        "upstream, or use from_arrays for in-RAM input)")
                last_t = int(t[-1])
                writers["src"].append(src)
                writers["dst"].append(dst)
                writers["edge_t"].append(t)
                if len(src):
                    max_node = max(max_node, int(src.max()), int(dst.max()))
                # Optional columns must be present from the first chunk on
                # (or never): the column files are append-only.
                first = writers["src"].rows == len(src)
                feats = chunk.get("edge_feats")
                if feats is None:
                    if "edge_feats" in writers:
                        raise ValueError(
                            "edge_feats missing from a chunk after being "
                            "present earlier")
                else:
                    feats = np.ascontiguousarray(feats, dtype=np.float32)
                    if feats.ndim != 2 or len(feats) != len(src):
                        raise ValueError("edge_feats must be (chunk, d)")
                    if "edge_feats" not in writers:
                        if not first:
                            raise ValueError(
                                "edge_feats appeared after the first chunk")
                        writers["edge_feats"] = _ColumnWriter(
                            os.path.join(tmp, "edge_feats.npy"), np.float32,
                            width=feats.shape[1])
                    writers["edge_feats"].append(feats)
                eid = chunk.get("eid")
                if eid is None:
                    if "eid" in writers:
                        raise ValueError(
                            "eid missing from a chunk after being present "
                            "earlier")
                else:
                    if "eid" not in writers:
                        if not first:
                            raise ValueError(
                                "eid appeared after the first chunk")
                        writers["eid"] = _ColumnWriter(
                            os.path.join(tmp, "eid.npy"), np.int64)
                    writers["eid"].append(
                        np.ascontiguousarray(eid, dtype=np.int64))

            if node_events is not None:
                ids = np.ascontiguousarray(node_events["ids"], np.int64)
                nt = np.ascontiguousarray(node_events["t"], np.int64)
                order = np.argsort(nt, kind="stable")
                writers["node_ids"] = _ColumnWriter(
                    os.path.join(tmp, "node_ids.npy"), np.int64)
                writers["node_ids"].append(ids[order])
                writers["node_t"] = _ColumnWriter(
                    os.path.join(tmp, "node_t.npy"), np.int64)
                writers["node_t"].append(nt[order])
                if len(ids):
                    max_node = max(max_node, int(ids.max()))
                nf = node_events.get("feats")
                if nf is not None:
                    nf = np.ascontiguousarray(nf, np.float32)
                    writers["node_feats"] = _ColumnWriter(
                        os.path.join(tmp, "node_feats.npy"), np.float32,
                        width=nf.shape[1])
                    writers["node_feats"].append(nf[order])
            if static_node_feats is not None:
                sf = np.ascontiguousarray(static_node_feats, np.float32)
                writers["static_node_feats"] = _ColumnWriter(
                    os.path.join(tmp, "static_node_feats.npy"), np.float32,
                    width=sf.shape[1])
                writers["static_node_feats"].append(sf)

            columns = {name: w.close() for name, w in writers.items()}
        except Exception:
            for w in writers.values():
                try:
                    w._f.close()
                except Exception:  # pragma: no cover
                    pass
            import shutil

            shutil.rmtree(tmp, ignore_errors=True)
            raise

        manifest = {
            "format": FORMAT,
            "version": VERSION,
            "num_nodes": int(num_nodes if num_nodes is not None
                             else max_node + 1),
            "granularity": {"unit": granularity.unit,
                            "value": granularity.value},
            "num_edge_events": columns["src"]["shape"][0],
            "num_node_events": columns.get("node_ids",
                                           {"shape": [0]})["shape"][0],
            "columns": columns,
        }
        man_path = os.path.join(tmp, MANIFEST)
        with open(man_path, "w") as f:
            json.dump(manifest, f, indent=2)
            f.flush()
            os.fsync(f.fileno())
        _fsync_path(tmp)
        os.rename(tmp, path)
        _fsync_path(os.path.dirname(os.path.abspath(path)) or ".")
        return cls(path)

    @classmethod
    def from_arrays(cls, path: str, src, dst, t, *, edge_feats=None,
                    eids=None, node_ids=None, node_t=None, node_feats=None,
                    static_node_feats=None,
                    granularity: TimeDelta | str = "s",
                    num_nodes: Optional[int] = None,
                    chunk_rows: int = 1 << 18,
                    overwrite: bool = False) -> "MmapStore":
        """Convert in-RAM arrays (sorted here if needed — they already fit)
        by streaming fixed-size slices through :meth:`from_chunks`."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        t = np.asarray(t, dtype=np.int64)
        if not (len(src) == len(dst) == len(t)):
            raise ValueError("src/dst/t length mismatch")
        if len(t) and np.any(np.diff(t) < 0):
            order = np.argsort(t, kind="stable")
            src, dst, t = src[order], dst[order], t[order]
            if edge_feats is not None:
                edge_feats = np.asarray(edge_feats, np.float32)[order]
            if eids is not None:
                eids = np.asarray(eids, np.int64)[order]

        def chunks():
            for lo in range(0, max(len(src), 1), chunk_rows):
                hi = min(lo + chunk_rows, len(src))
                if hi <= lo:
                    break
                c = {"src": src[lo:hi], "dst": dst[lo:hi], "t": t[lo:hi]}
                if edge_feats is not None:
                    c["edge_feats"] = edge_feats[lo:hi]
                if eids is not None:
                    c["eid"] = eids[lo:hi]
                yield c

        node_events = None
        if node_ids is not None:
            node_events = {"ids": node_ids, "t": node_t}
            if node_feats is not None:
                node_events["feats"] = node_feats
        return cls.from_chunks(
            path, chunks(), granularity=granularity, num_nodes=num_nodes,
            node_events=node_events, static_node_feats=static_node_feats,
            overwrite=overwrite)

    @classmethod
    def from_data(cls, path: str, data, *, chunk_rows: int = 1 << 18,
                  overwrite: bool = False) -> "MmapStore":
        """Convert an existing ``DGData`` (columns already sorted)."""
        return cls.from_arrays(
            path, data.src, data.dst, data.edge_t,
            edge_feats=data.edge_feats, node_ids=data.node_ids,
            node_t=data.node_t, node_feats=data.node_feats,
            static_node_feats=data.static_node_feats,
            granularity=data.granularity, num_nodes=data.num_nodes,
            chunk_rows=chunk_rows, overwrite=overwrite)

    @classmethod
    def from_csv(cls, path: str, csv_path: str, *, src_col: int = 0,
                 dst_col: int = 1, t_col: int = 2,
                 feat_cols: Optional[Sequence[int]] = None,
                 delimiter: str = ",", skip_header: int = 1,
                 granularity: TimeDelta | str = "s",
                 num_nodes: Optional[int] = None,
                 chunk_rows: int = 1 << 16,
                 overwrite: bool = False) -> "MmapStore":
        """Chunked CSV converter: parse ``chunk_rows`` lines at a time
        (int64 id/time columns parsed exactly — no float round-trip) and
        stream them through :meth:`from_chunks`. The CSV must be
        time-sorted; the full file is never resident."""
        from repro_torch.core.graph import iter_csv_chunks

        return cls.from_chunks(
            path,
            iter_csv_chunks(csv_path, src_col=src_col, dst_col=dst_col,
                            t_col=t_col, feat_cols=feat_cols,
                            delimiter=delimiter, skip_header=skip_header,
                            chunk_rows=chunk_rows),
            granularity=granularity, num_nodes=num_nodes,
            overwrite=overwrite)
