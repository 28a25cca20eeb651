"""Dynamic node property prediction (TGB nodeprop-style, paper Table 4).

Port of ``repro.train.nodeprop``. Task (genre-like): for each user node,
predict the distribution of its interactions over destination categories in
the *next* time window, scored with NDCG@10 against the realized
distribution.

Two pipeline families share the ``TrainLoop`` surface
(``train_epoch``/``evaluate``/checkpointing), on ``device`` (``"cuda"`` by
default):

  * ``DTDGNodePipeline`` — snapshot models (GCN, GCLSTM, T-GCN) + linear
    head over the device ``SnapshotTensor``; every graph convolution sums
    through the segment-sum kernel on the card. The reference's
    ``lax.scan`` epoch becomes a Python loop over prediction pairs running
    the same step, with the labels scattered on the device from the next
    snapshot's edges. ``compiled`` is accepted for parity with the
    reference; the reference's scan and loop are one loop here.
  * ``EventNodePipeline`` — the window-loop baselines: ``pf`` (persistent
    forecast, host numpy) and ``tgn`` (memory embeddings + linear head over
    event windows with the host recency sampler's neighbors; the embed
    takes TGN's classic path: the attention kernel on the card, and its
    backward kernel in training).

``NodePropertyTrainer`` is the legacy shim: it dispatches on the model
name and keeps the historical ``run(train_frac)`` one-shot API.

The snapshot family's labels count *unique* ``(window, src, dst)``
interactions (the ``SnapshotTensor`` view collapses duplicate event
classes, paper Def. 3.5), while the event-window family counts raw event
multiplicity.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import DGData, DGDataLoader, DGraph, TimeDelta
from repro_torch.core.sampler import RecencySampler
from repro_torch.device import resolve_device
from repro_torch.models.tg import snapshot, tgn
from repro_torch.nn.init import normal
from repro_torch.obs import Telemetry
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train.loop import (
    SnapshotPairPipeline,
    _ParamsAndOptimizer,
    _state_map,
    restore_bundle,
    save_bundle,
)
from repro_torch.train.metrics import ndcg_at_k

EVENT_NODE_MODELS = ("pf", "tgn")


def _window_labels(data: DGData, unit: TimeDelta, num_nodes: int,
                   num_cats: int, cat_of_dst: np.ndarray):
    """Per (window, user) -> category distribution; yields consecutive
    (window_events, next_window_user_dist) pairs."""
    loader = DGDataLoader(DGraph(data), None, batch_size=None, batch_unit=unit,
                          emit_empty=True)
    windows = []
    for b in loader:
        counts = np.zeros((num_nodes, num_cats), np.float32)
        if b.num_events:
            np.add.at(counts, (b["src"], cat_of_dst[b["dst"]]), 1.0)
        windows.append((b, counts))
    return windows


def _category_map(data: DGData, num_cats: Optional[int]) -> Tuple[int, np.ndarray]:
    """Hashed destination buckets (genre-like): ``(num_cats, cat_of_dst)``."""
    dsts = np.unique(data.dst)
    c = num_cats or min(32, len(dsts))
    cat = np.zeros(data.num_nodes, np.int64)
    cat[dsts] = np.arange(len(dsts)) % c
    return c, cat


def _soft_cross_entropy(logits, labels):
    """Cross-entropy of the logits against each row's normalized label
    counts, averaged over the active rows (a row is active when it has a
    label)."""
    active = (labels.sum(-1) > 0).float()
    logp = torch.log_softmax(logits, -1)
    tgt = labels / torch.clamp(labels.sum(-1, keepdim=True), min=1.0)
    loss = -(tgt * logp).sum(-1)
    return (loss * active).sum() / torch.clamp(active.sum(), min=1.0)


def _ndcg_rows(rows, k_eval: int) -> float:
    """NDCG@``k_eval`` averaged over the (probs, labels) rows that have an
    active user, as the reference aggregates (0 without one)."""
    scores = []
    for pr, lab in rows:
        active = lab.sum(-1) > 0
        if active.any():
            scores.append(ndcg_at_k(pr[active], lab[active], k_eval))
    return float(np.mean(scores)) if scores else 0.0


# ----------------------------------------------------------------------
# DTDG: snapshot node property pipeline
# ----------------------------------------------------------------------
class DTDGNodePipeline(SnapshotPairPipeline, _ParamsAndOptimizer):
    """Node property prediction over the snapshot tensor, on ``device``.

    Snapshot t's per-node embeddings (any ``models.tg.snapshot`` model with
    ``d_node = d_embed``, and a linear category head) predict each active
    user's category distribution in snapshot t+1: soft cross-entropy, the
    gradient with respect to the parameters only (the carried recurrent
    state is an input), one AdamW update (``lr``, default 1e-3). Parameters
    ``{"m", "head"}`` come from a ``torch.Generator`` seeded with ``seed``
    or from ``load_params``. The labels are scattered on the device from
    the predicted snapshot's edges (sums of ones: exact in any order).
    Every split runs one pair at a time from the snapshot rows, whatever
    ``compiled`` says: the reference's scan and its loop are the same step,
    and the pair inputs are views of those rows either way (the link
    pipeline's flag matters: its negatives differ). ``mode`` goes to every
    segment sum (``"auto"``:
    the CUDA kernel on the card, its plain version on the CPU; ``"ref"``
    forces the plain version). Splits map ``DGData.split`` boundaries to
    snapshot rows (``SnapshotPairPipeline``); ``evaluate`` warms the state
    through every earlier snapshot with advance-only steps and reads the
    split's probabilities back once.
    """

    def __init__(
        self,
        model_name: str,
        data: DGData,
        unit: TimeDelta | str = "d",
        num_cats: Optional[int] = None,
        d_embed: int = 32,
        lr: Optional[float] = None,
        seed: int = 0,
        val_ratio: float = 0.15,
        test_ratio: float = 0.15,
        capacity: Optional[int] = None,
        compiled: bool = True,
        mode: str = "auto",
        device="cuda",
        telemetry: Optional[Telemetry] = None,
    ):
        if model_name not in snapshot.SNAPSHOT_MODELS:
            raise ValueError(
                f"unknown snapshot model {model_name!r}; "
                f"have {snapshot.SNAPSHOT_MODELS}"
            )
        self.device = resolve_device(device)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.model_name = model_name
        self.data = data
        self.unit = TimeDelta.coerce(unit)
        self.n = data.num_nodes
        self.compiled = compiled
        self.mode = mode
        self.num_cats, self.cat_of_dst = _category_map(data, num_cats)
        self._cat = torch.as_tensor(self.cat_of_dst).to(self.device)

        self._init_snapshots(data, self.unit, capacity, self.device,
                             val_ratio, test_ratio)

        self.cfg = snapshot.SnapshotConfig(num_nodes=self.n, d_node=d_embed,
                                           d_embed=d_embed)
        gen = torch.Generator().manual_seed(seed)
        self.load_params({
            "m": snapshot.init_params(model_name, gen, self.cfg),
            "head": normal(gen, (d_embed, self.num_cats), 0.05),
        })
        self._apply = snapshot.make_apply(model_name, self.cfg)
        self._has_state = model_name != "gcn"
        self.model_state = self._init_state()

        self.opt_cfg = AdamWConfig(lr=1e-3 if lr is None else lr)
        self.opt_state = adamw_init(self.params)

    # ------------------------------------------------------------------
    def labels_of(self, x) -> torch.Tensor:
        """Next-window category counts (N, C), scattered on the device from
        the predicted snapshot's (deduplicated) edges."""
        lab = torch.zeros((self.n, self.num_cats), dtype=torch.float32,
                          device=self.device)
        return lab.index_put_((x["nsrc"].long(), self._cat[x["ndst"].long()]),
                              x["nmask"].to(torch.float32), accumulate=True)

    def _forward(self, params, state, x):
        z, new_state = self._apply(params["m"], x["src"], x["dst"], x["mask"],
                                   state, mode=self.mode)
        return z @ params["head"], new_state

    def _loss_and_state(self, params, state, x):
        """The step function every path runs: the soft cross-entropy of pair
        ``x`` and the recurrent state after snapshot p."""
        logits, new_state = self._forward(params, state, x)
        return _soft_cross_entropy(logits, self.labels_of(x)), new_state

    def _train_step(self, x) -> torch.Tensor:
        """Loss, gradient and one AdamW update on pair ``x``; carries the
        new recurrent state on. Returns the loss as a device scalar."""
        loss, new_state = self._loss_and_state(self.params, self.model_state, x)
        self._update(self._grads(loss))
        self.model_state = _state_map(torch.Tensor.detach, new_state)
        return loss.detach()

    @torch.no_grad()
    def _eval_step(self, state, x):
        logits, new_state = self._forward(self.params, state, x)
        return new_state, torch.softmax(logits, -1), self.labels_of(x)

    @torch.no_grad()
    def _advance_step(self, state, p: int):
        st = self.snapshots
        _, new_state = self._apply(self.params["m"], st.src[p], st.dst[p],
                                   st.mask[p], state, mode=self.mode)
        return new_state

    # ------------------------------------------------------------------
    def _pair_x(self, p: int) -> Dict[str, Any]:
        """Prediction pair p's tensors: snapshot p and the next one's edges."""
        st = self.snapshots
        return {
            "src": st.src[p], "dst": st.dst[p], "mask": st.mask[p],
            "nsrc": st.src[p + 1], "ndst": st.dst[p + 1],
            "nmask": st.mask[p + 1],
        }

    def _pairs(self, lo: int, hi: int):
        """Pair inputs ``[lo, hi)``."""
        for p in range(lo, hi):
            yield self._pair_x(p)

    def reset_epoch_state(self) -> None:
        """Reset the recurrent state (start of an epoch)."""
        self.model_state = self._init_state()

    # ------------------------------------------------------------------
    def train_epoch(self) -> Tuple[float, float]:
        """One epoch over the train pairs. Returns (mean loss, seconds); the
        losses are read back once, at the end."""
        with self.telemetry.span("node/epoch", model=self.model_name,
                                 compiled=self.compiled) as sp:
            lo, hi = self._split_pairs("train")
            self.reset_epoch_state()
            t0 = time.perf_counter()
            steps = []
            for x in self._pairs(lo, hi):
                with self.telemetry.span("node/step"):
                    steps.append(self._train_step(x))
            losses = torch.stack(steps).cpu().tolist() if steps else []
            mean = float(np.mean(losses)) if losses else 0.0
            sp["loss"], sp["pairs"] = mean, len(losses)
        return mean, time.perf_counter() - t0

    def evaluate(self, split: str = "test", k_eval: int = 10) -> Tuple[float, float]:
        """NDCG@``k_eval`` over a split's prediction pairs, averaged over
        the windows with an active user. The recurrent state is warmed
        from scratch through all earlier snapshots; the training state is
        left as it was. Returns (NDCG, seconds)."""
        with self.telemetry.span("node/eval", split=split) as sp:
            lo, hi = self._split_pairs(split)
            t0 = time.perf_counter()
            state = self._init_state()
            if self._has_state:
                for p in range(lo):
                    state = self._advance_step(state, p)
            probs, labels = [], []
            for x in self._pairs(lo, hi) if hi > lo else ():
                state, pr, lab = self._eval_step(state, x)
                probs.append(pr)
                labels.append(lab)
            rows = []
            if probs:  # one read of the split's probabilities and labels
                rows = zip(torch.stack(probs).cpu().numpy(),
                           torch.stack(labels).cpu().numpy())
            out = _ndcg_rows(rows, k_eval)
            sp["ndcg"] = out
        return out, time.perf_counter() - t0

    # -- checkpointing ---------------------------------------------------
    def _ckpt_tree(self) -> Dict[str, Any]:
        tree = {"params": self.params, "opt_state": self.opt_state,
                "hooks": {}}
        if self._has_state:
            tree["model_state"] = self.model_state
        return tree

    def save_checkpoint(self, ckpt_dir: str, step: int) -> str:
        """Write a checkpoint (atomic step directory). Returns its path."""
        return save_bundle(ckpt_dir, step, self._ckpt_tree(), self.model_name,
                           trainer="nodeprop")

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore params, optimizer (and recurrent) state, written by
        either package; returns the step."""
        target = {k: v for k, v in self._ckpt_tree().items() if k != "hooks"}
        tree, step = restore_bundle(ckpt_dir, step, target, self.model_name)
        self.load_params(tree["params"])
        self.load_opt_state(tree["opt_state"])
        if self._has_state:
            self.load_model_state(tree["model_state"])
        return step


# ----------------------------------------------------------------------
# CTDG: window-loop baselines (persistent forecast, windowed TGN)
# ----------------------------------------------------------------------
class EventNodePipeline(_ParamsAndOptimizer):
    """Window-loop node property prediction (``pf`` / windowed TGN).

    Iterates the event stream by time windows (``DGDataLoader``
    iterate-by-time with empty windows emitted); ``tgn`` embeds each
    window's active users with memory + recency neighbors (the host
    ``RecencySampler``, sampled before the window's update, power-of-two
    buckets) and trains a linear category head online, one AdamW step
    (``lr``, default 1e-3) per window; ``pf`` forecasts each user's
    previous window distribution on the host. TGN runs on ``device``: its
    embed takes the classic path, and ``mode`` goes to it as ``fused``
    (``"auto"``: the attention kernel, and its backward kernel in
    training, on the card; ``"ref"``: the plain version). As in the
    reference, the seed users are padded with node 0, so every padding row
    takes node 0's next-window distribution as its label.
    ``train_epoch``/``evaluate`` expose the shared pipeline surface;
    ``run_online`` keeps the historical single-pass train-then-score
    behavior.
    """

    def __init__(self, model_name: str, data: DGData,
                 unit: TimeDelta | str = "d", num_cats: Optional[int] = None,
                 d_embed: int = 32, lr: Optional[float] = None, seed: int = 0,
                 val_ratio: float = 0.15, test_ratio: float = 0.15,
                 mode: str = "auto", device="cuda",
                 telemetry: Optional[Telemetry] = None):
        if model_name not in EVENT_NODE_MODELS:
            raise ValueError(f"unknown event node model {model_name!r}")
        self.device = resolve_device(device)
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.model_name = model_name
        self.data = data
        self.unit = TimeDelta.coerce(unit)
        self.n = data.num_nodes
        self.mode = mode
        self.num_cats, self.cat_of_dst = _category_map(data, num_cats)
        self._train_frac = max(1.0 - val_ratio - test_ratio, 0.0)
        self._val_frac = max(1.0 - test_ratio, 0.0)
        self._windows = None
        self._sampler = None

        if model_name == "tgn":
            self.cfg = tgn.TGNConfig(num_nodes=self.n, d_edge=0, d_model=d_embed,
                                     d_time=16, d_memory=d_embed, k=4)
            gen = torch.Generator().manual_seed(seed)
            self.load_params({
                "tgn": tgn.init(self.cfg, gen),
                "head": normal(gen, (d_embed, self.num_cats), 0.05),
            })
            self.opt_cfg = AdamWConfig(lr=1e-3 if lr is None else lr)
            self.opt_state = adamw_init(self.params)
        else:
            self.params = None

    # ------------------------------------------------------------------
    def _embed(self, state, batch):
        return tgn.embed(self.params["tgn"], self.cfg, state, batch,
                         fused=self.mode)

    @torch.no_grad()
    def _advance(self, state, batch):
        """The memory after ``batch`` (no autograd)."""
        return tgn.update_memory(self.params["tgn"], self.cfg, state, batch)

    def _train_step(self, state, batch, labels):
        """Loss, backward and one AdamW update on a window; returns the
        loss as a device scalar and the memory after the window (computed
        from the parameters before the update, outside the gradient)."""
        logits = self._embed(state, batch) @ self.params["head"]
        loss = _soft_cross_entropy(logits, labels)
        new_state = self._advance(state, batch)
        self._update(self._grads(loss))
        return loss.detach(), new_state

    @torch.no_grad()
    def _predict(self, state, batch):
        probs = torch.softmax(self._embed(state, batch) @ self.params["head"], -1)
        return probs, self._advance(state, batch)

    def _next_labels(self, i: int, seed_user: np.ndarray) -> np.ndarray:
        """Window i+1's category counts of the (padded) seed users."""
        return self.windows()[i + 1][1][seed_user]

    # ------------------------------------------------------------------
    def windows(self):
        """Materialized (window batch, label counts) pairs, cached."""
        if self._windows is None:
            self._windows = _window_labels(self.data, self.unit, self.n,
                                           self.num_cats, self.cat_of_dst)
        return self._windows

    def _bounds(self) -> Tuple[int, int]:
        """(first val window, first test window) indices."""
        w = len(self.windows())
        return max(1, int(w * self._train_frac)), max(1, int(w * self._val_frac))

    def reset_epoch_state(self) -> None:
        """Drop the recency-neighbor buffer so the next pass re-warms
        chronologically from the stream head (each train/eval pass walks
        the windows from window 0; a buffer left warm by a previous pass
        would leak future neighbors into the walk)."""
        self._sampler = None

    def train_epoch(self) -> Tuple[float, float]:
        """One online pass over the train windows (no-op for ``pf``); the
        losses are read back once, at the end."""
        t0 = time.perf_counter()
        if self.model_name == "pf":
            return 0.0, time.perf_counter() - t0
        with self.telemetry.span("node/epoch", model=self.model_name) as sp:
            self.reset_epoch_state()
            n_val, _ = self._bounds()
            windows = self.windows()
            state = tgn.init_state(self.cfg, self.device)
            steps = []
            for i in range(min(n_val, len(windows)) - 1):
                b, _ = windows[i]
                if b.num_events == 0:
                    continue
                batch, seed_user = self._tgn_batch(b)
                labels = self._put(self._next_labels(i, seed_user))
                with self.telemetry.span("node/step"):
                    loss, state = self._train_step(state, batch, labels)
                steps.append(loss)
            losses = torch.stack(steps).cpu().tolist() if steps else []
            mean = float(np.mean(losses)) if losses else 0.0
            sp["loss"], sp["windows"] = mean, len(losses)
        return mean, time.perf_counter() - t0

    def _pf_scores(self, scored, k_eval: int) -> float:
        """Persistent forecast: NDCG@k of each user's last non-empty window
        distribution against its next one, over the windows ``i + 1`` for
        which ``scored(i + 1)`` holds."""
        windows = self.windows()
        last = np.zeros((self.n, self.num_cats), np.float32)
        scores = []
        for i in range(len(windows) - 1):
            _, counts = windows[i]
            nxt = windows[i + 1][1]
            if scored(i + 1):
                active = nxt.sum(-1) > 0
                if active.any():
                    scores.append(ndcg_at_k(last[active], nxt[active], k_eval))
            last = np.where(counts.sum(-1, keepdims=True) > 0, counts, last)
        return float(np.mean(scores)) if scores else 0.0

    def evaluate(self, split: str = "test", k_eval: int = 10) -> Tuple[float, float]:
        """NDCG@``k_eval`` over a split's windows (state warmed through all
        earlier windows without parameter updates: their memory updates
        only). Returns (NDCG, seconds)."""
        n_val, n_test = self._bounds()
        windows = self.windows()
        lo, hi = ((n_val, n_test) if split == "val"
                  else (n_test, len(windows)) if split == "test"
                  else (1, n_val))
        self.reset_epoch_state()
        t0 = time.perf_counter()
        if self.model_name == "pf":
            out = self._pf_scores(lambda w: lo <= w < hi, k_eval)
            return out, time.perf_counter() - t0
        with self.telemetry.span("node/eval", split=split) as sp:
            state = tgn.init_state(self.cfg, self.device)
            probs, labels = [], []
            for i in range(len(windows) - 1):
                b, _ = windows[i]
                if b.num_events == 0 or i + 1 >= hi:
                    continue
                batch, seed_user = self._tgn_batch(b)
                if lo <= i + 1:
                    pr, state = self._predict(state, batch)
                    probs.append(pr)
                    labels.append(self._next_labels(i, seed_user))
                else:
                    state = self._advance(state, batch)
            out = _ndcg_rows(self._host_rows(probs, labels), k_eval)
            sp["ndcg"] = out
        return out, time.perf_counter() - t0

    @staticmethod
    def _host_rows(probs, labels):
        """(probs, labels) numpy pairs, the probabilities read back in one
        transfer."""
        if not probs:
            return []
        flat = torch.cat(probs).cpu().numpy()
        return zip(np.split(flat, np.cumsum([len(p) for p in probs])[:-1]),
                   labels)

    # -- checkpointing ---------------------------------------------------
    def _ckpt_tree(self) -> Dict[str, Any]:
        if self.model_name == "pf":
            # Persistent forecast is parameter-free; checkpoint a marker so
            # the bundle round-trips through the shared contract.
            return {"pipeline": {"stateless": np.int64(1)}, "hooks": {}}
        return {"params": self.params, "opt_state": self.opt_state, "hooks": {}}

    def save_checkpoint(self, ckpt_dir: str, step: int) -> str:
        """Write a checkpoint (atomic step directory). Returns its path."""
        return save_bundle(ckpt_dir, step, self._ckpt_tree(), self.model_name,
                           trainer="nodeprop")

    def restore_checkpoint(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore params/opt state (no-op payload for ``pf``), written by
        either package; returns the checkpoint step."""
        target = {k: v for k, v in self._ckpt_tree().items() if k != "hooks"}
        tree, step = restore_bundle(ckpt_dir, step, target, self.model_name)
        if self.model_name != "pf":
            self.load_params(tree["params"])
            self.load_opt_state(tree["opt_state"])
        return step

    # ------------------------------------------------------------------
    def run_online(self, train_frac: float = 0.7, k_eval: int = 10) -> Tuple[float, float]:
        """Historical single-pass behavior: train online through the first
        ``train_frac`` windows, score NDCG@k on the rest. Returns
        (test NDCG@k, seconds)."""
        windows = self.windows()
        n_train = max(1, int(len(windows) * train_frac))
        self.reset_epoch_state()
        t0 = time.perf_counter()
        if self.model_name == "pf":
            out = self._pf_scores(lambda w: w >= n_train, k_eval)
            return out, time.perf_counter() - t0

        state = tgn.init_state(self.cfg, self.device)
        probs, labels = [], []
        for i in range(len(windows) - 1):
            b, _ = windows[i]
            if b.num_events == 0:
                continue
            batch, seed_user = self._tgn_batch(b)
            lab = self._next_labels(i, seed_user)
            if i + 1 < n_train:
                _, state = self._train_step(state, batch, self._put(lab))
            else:
                pr, state = self._predict(state, batch)
                probs.append(pr)
                labels.append(lab)
        out = _ndcg_rows(self._host_rows(probs, labels), k_eval)
        return out, time.perf_counter() - t0

    def _put(self, a) -> torch.Tensor:
        return torch.as_tensor(a).to(self.device)

    def _tgn_batch(self, b) -> Tuple[Dict[str, torch.Tensor], np.ndarray]:
        """A TGN batch for node prediction on the device, and its padded
        seed users on the host: seeds = the window's active users, sampled
        from the recency buffer before the window's events update it, at
        ``t_ref`` = the window's last time. Shapes are power-of-two
        bucketed; seed rows are padded with node 0 (time 0, no neighbors)
        and events with masked zeros, as in the reference."""
        if self._sampler is None:
            self._sampler = RecencySampler(self.n, self.cfg.k)
        users = np.unique(b["src"])
        blk = self._sampler.sample(users)
        t_ref = np.full(len(users), int(b["time"].max()), np.int64)
        self._sampler.update(b["src"], b["dst"], b["time"])

        def p2(n):
            return 1 << int(np.ceil(np.log2(max(n, 2))))

        ucap, ecap = p2(len(users)), p2(b.num_events)
        upad, epad = ucap - len(users), ecap - b.num_events
        emask = np.zeros(ecap, bool)
        emask[: b.num_events] = True
        seed_user = np.pad(users, (0, upad))
        put = self._put
        batch = {
            "src": put(np.pad(b["src"], (0, epad))),
            "dst": put(np.pad(b["dst"], (0, epad))),
            "time": put(np.pad(b["time"], (0, epad))),
            "batch_mask": put(emask),
            "seed_nodes": put(seed_user),
            "seed_times": put(np.pad(t_ref, (0, upad))),
            "nbr_ids": put(np.pad(blk.nbr_ids, ((0, upad), (0, 0)),
                                  constant_values=-1)),
            "nbr_times": put(np.pad(blk.nbr_times, ((0, upad), (0, 0)))),
            "nbr_mask": put(np.pad(blk.mask, ((0, upad), (0, 0)))),
            "seed_user": put(seed_user),
        }
        return batch, seed_user


class NodePropertyTrainer:
    """Legacy one-shot node-property entry point (prefer ``repro_torch.tg.
    Experiment`` with ``task="node"``).

    Dispatches on the model name: ``pf``/``tgn`` keep the window loop
    (``EventNodePipeline.run_online``); snapshot models (``gcn``,
    ``gclstm``, ``tgcn``) run through ``DTDGNodePipeline``.
    """

    def __init__(self, model_name: str, data: DGData, unit: TimeDelta | str = "d",
                 num_cats: Optional[int] = None, d_embed: int = 32,
                 lr: float = 1e-3, seed: int = 0, compiled: bool = True,
                 mode: str = "auto", device="cuda"):
        kw = dict(unit=unit, num_cats=num_cats, d_embed=d_embed, lr=lr,
                  seed=seed, mode=mode, device=device)
        if model_name in EVENT_NODE_MODELS:
            self._impl = EventNodePipeline(model_name, data, **kw)
        else:
            self._impl = DTDGNodePipeline(model_name, data, compiled=compiled,
                                          **kw)
        self.model_name = model_name

    @property
    def pipeline(self):
        """The underlying pipeline (event windows or snapshots)."""
        return self._impl

    def run(self, train_frac: float = 0.7, k_eval: int = 10) -> Tuple[float, float]:
        """Train on the first ``train_frac`` windows, return
        (test NDCG@k, seconds) — the historical one-shot API."""
        if isinstance(self._impl, EventNodePipeline):
            return self._impl.run_online(train_frac, k_eval)
        # Snapshot pipeline: map train_frac to a snapshot-row boundary (no
        # val split), train one epoch, score the remaining rows.
        impl = self._impl
        n_train = max(1, int(impl.snapshots.num_snapshots * train_frac))
        impl.set_split_rows(n_train, n_train)
        t0 = time.perf_counter()
        impl.train_epoch()
        ndcg, _ = impl.evaluate("test", k_eval)
        return ndcg, time.perf_counter() - t0
