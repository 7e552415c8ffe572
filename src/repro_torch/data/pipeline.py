"""Deterministic, resumable synthetic token pipeline, and row dedup.

The port of the JAX package's ``data/pipeline.py``.  Generation is numpy
only, the same code from the same seeds, so a step's batch is bit for bit
the reference's: any step's batch follows from (seed, step) alone, and a
host's shard is a slice of the step's global batch.  The synthetic
distribution is a mixture of Zipfian unigrams and repeated motifs, so the
cross-entropy has learnable structure.

Dedup keeps the first occurrence of each distinct token row: fingerprints
(a uint32 polynomial hash of each row) are grouped through the port's
sorts, and rows of a group are compared byte for byte before any is
dropped.  ``dedup_rows`` groups with ``relational.unique`` (its sort, K3
on the card on the ``radix`` plan); ``global_dedup`` with the spill tier's
``spill_sort_kv`` (chunk sorts and K2 merges), for columns larger than the
device.  ``to_device`` puts a numpy batch on a device (the reference's
``device_put_batch`` onto a mesh).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    motif_len: int = 16
    n_motifs: int = 64
    zipf_a: float = 1.2


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed motif bank (part of the dataset definition, not the stream)
        self.motifs = rng.integers(
            0, cfg.vocab_size, size=(cfg.n_motifs, cfg.motif_len),
            dtype=np.int32)
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        p = ranks ** -cfg.zipf_a
        self.zipf_p = (p / p.sum()).astype(np.float64)

    def global_batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """The full (global_batch, seq_len) batch for a step — deterministic
        in (seed, step)."""
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = rng.choice(cfg.vocab_size, size=(b, s), p=self.zipf_p
                          ).astype(np.int32)
        # plant motifs: ~25% of positions covered by repeated motifs
        n_plant = max(1, (b * s) // (4 * cfg.motif_len))
        rows = rng.integers(0, b, n_plant)
        offs = rng.integers(0, max(1, s - cfg.motif_len), n_plant)
        ids = rng.integers(0, cfg.n_motifs, n_plant)
        for r, o, m in zip(rows, offs, ids):
            toks[r, o:o + cfg.motif_len] = self.motifs[m]
        labels = np.concatenate([toks[:, 1:], np.full((b, 1), -100,
                                                      np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    def shard_at(self, step: int, shard: int, n_shards: int
                 ) -> Dict[str, np.ndarray]:
        """This host's slice of the step's global batch; a layout that
        does not divide raises ``ValueError``."""
        b = self.cfg.global_batch
        if n_shards < 1 or b % n_shards != 0:
            raise ValueError(
                f"global_batch={b} is not divisible into n_shards="
                f"{n_shards} equal host shards; adjust the dp degree or "
                f"the batch size")
        if not 0 <= shard < n_shards:
            raise ValueError(
                f"shard index {shard} out of range for n_shards={n_shards}")
        g = self.global_batch_at(step)
        lo = (b // n_shards) * shard
        hi = lo + b // n_shards
        return {k: v[lo:hi] for k, v in g.items()}

    def iterate(self, start_step: int = 0, shard: int = 0,
                n_shards: int = 1, dedup: bool = False, *, device="cuda"
                ) -> Iterator[Dict[str, np.ndarray]]:
        """Batch stream; ``dedup=True`` drops duplicate token rows within
        each shard batch (``dedup_rows`` on ``device``), so the batch
        dimension can shrink step to step."""
        step = start_step
        while True:
            batch = self.shard_at(step, shard, n_shards)
            if dedup:
                keep = dedup_rows(batch["tokens"], device=device)
                batch = {k: v[keep] for k, v in batch.items()}
            yield batch
            step += 1


def row_fingerprints(tokens: np.ndarray) -> np.ndarray:
    """uint32 polynomial hash of each token row (multiplier 1000003,
    modular): equal rows always share a fingerprint."""
    t = np.ascontiguousarray(tokens).astype(np.uint32)
    s = t.shape[-1]
    pows = np.empty((s,), np.uint32)
    acc = 1
    for i in range(s - 1, -1, -1):
        pows[i] = acc
        acc = (acc * 1000003) % (1 << 32)
    return (t * pows).sum(axis=-1, dtype=np.uint32)


def _keep_first_distinct(tokens: np.ndarray, group: np.ndarray,
                         keep: np.ndarray) -> None:
    """Within one fingerprint group (ascending original positions), mark the
    first occurrence of each distinct token row; a row is dropped only after
    a full comparison against a kept member of its group (two different
    rows can share a fingerprint)."""
    if group.shape[0] == 1:
        keep[group[0]] = True
        return
    kept: list = []
    for gi in group:
        gi = int(gi)
        if not any(np.array_equal(tokens[gi], tokens[kj]) for kj in kept):
            keep[gi] = True
            kept.append(gi)


def _first_occurrence_mask(tokens: np.ndarray, sorted_groups: np.ndarray,
                           sorted_pos: np.ndarray) -> np.ndarray:
    """Keep-mask from a fingerprint column sorted into groups:
    ``sorted_groups[i]`` is the group key at sorted rank i and
    ``sorted_pos[i]`` the row's original position (ascending within a group:
    the sort must be stable)."""
    n = sorted_pos.shape[0]
    keep = np.zeros((n,), bool)
    bounds = np.flatnonzero(
        np.r_[True, sorted_groups[1:] != sorted_groups[:-1], True])
    for s, e in zip(bounds[:-1], bounds[1:]):
        _keep_first_distinct(tokens, sorted_pos[s:e], keep)
    return keep


def dedup_rows(tokens: np.ndarray, *, method: str = "auto",
               device="cuda") -> np.ndarray:
    """Keep-mask selecting the first occurrence of each distinct token row.

    The fingerprint column goes through ``relational.unique`` (``method``,
    on ``device``) for the candidate duplicate groups; rows inside a group
    are then compared byte for byte before any is dropped."""
    from repro_torch import relational
    tokens = np.asarray(tokens)
    h = row_fingerprints(tokens)
    n = h.shape[0]
    if n == 0:
        return np.zeros((0,), bool)
    u = relational.unique(torch.from_numpy(h), return_inverse=True,
                          method=method, device=device)
    inv = u.inverse.cpu().numpy()
    order = np.argsort(inv, kind="stable").astype(np.int64)
    return _first_occurrence_mask(tokens, inv[order], order)


def global_dedup(tokens: np.ndarray, *, chunk_bytes: Optional[int] = None,
                 method: str = "auto", device="cuda") -> np.ndarray:
    """Dataset-scale first-occurrence keep-mask over the spill tier: the
    fingerprint column is sorted out of core (``engine.spill.spill_sort_kv``
    carrying the row positions: chunk sorts of ``method`` on ``device``,
    then K2 merges), so only one chunk is resident on the device at a time.
    The key-value spill sort is stable, so positions within a group come
    back ascending.  ``chunk_bytes`` forces a chunk size; the default is
    the active profile's spill threshold."""
    from repro_torch.engine import spill
    tokens = np.asarray(tokens)
    n = tokens.shape[0]
    if n == 0:
        return np.zeros((0,), bool)
    h = row_fingerprints(tokens)
    pos = np.arange(n, dtype=np.int32)
    sh, sp = spill.spill_sort_kv(torch.from_numpy(h), torch.from_numpy(pos),
                                 chunk_bytes=chunk_bytes, method=method,
                                 device=device)
    return _first_occurrence_mask(tokens, sh.cpu().numpy(),
                                  sp.cpu().numpy().astype(np.int64))


def to_device(batch: Dict[str, np.ndarray], device="cuda"
              ) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (default ``"cuda"``)."""
    from repro_torch.core.sortspec import resolve_device
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}
