"""Data pipeline: deterministic synthetic token stream with host prefetch.

The port of the reference's ``data/pipeline.py``, pure numpy as there, so
``synth_batch`` gives the reference's arrays for a given ``(seed, step)``.
Determinism is the fault-tolerance contract: batch(step) is a pure
function of (seed, step), so a restart from checkpoint step k replays
exactly the same stream, and batch elements are indexed globally.

A background thread keeps ``prefetch`` batches ready (double buffering) so
host batch synthesis overlaps device compute.

numpy has no bfloat16: where ``DataConfig.dtype`` is ``"bfloat16"`` the
frontend embeddings come as float32 arrays holding the bfloat16 values
(rounded to nearest even, as the reference's cast), so
``torch.from_numpy(a).to(torch.bfloat16)`` is exact and bitwise the
reference's array.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    frontend_tokens: int = 0      # multimodal prefix supplied as embeddings
    d_model: int = 0
    encdec: bool = False
    dtype: str = "float32"


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


def _cast(a: np.ndarray, dtype: str) -> np.ndarray:
    """``a.astype(dtype)``; for bfloat16 the float32 array of the rounded
    values (round to nearest even on the upper 16 bits)."""
    if dtype != "bfloat16":
        return a.astype(dtype)
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    bits = (bits + (np.uint32(0x7FFF) + ((bits >> 16) & 1))) \
        & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def synth_batch(cfg: DataConfig, step: int) -> dict:
    """Pure function of (seed, step) -> batch dict matching the planned
    forward's inputs (``tokens``, ``frontend_embeds`` for the vlm prefix or
    the encdec frames, ``labels`` with -100 where no loss is taken)."""
    rng = _rng_for(cfg.seed, step)
    b = cfg.global_batch
    s_text = cfg.seq_len - (0 if cfg.encdec else cfg.frontend_tokens)
    # Markov-ish stream: correlated tokens so the loss actually decreases
    base = rng.integers(0, cfg.vocab, size=(b, 1), dtype=np.int32)
    drift = rng.integers(0, 7, size=(b, s_text), dtype=np.int32)
    tokens = (base + np.cumsum(drift, axis=1)) % cfg.vocab
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -100
    out = {"tokens": tokens.astype(np.int32)}
    full_labels = labels
    if cfg.frontend_tokens and not cfg.encdec:
        emb = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32) * 0.02
        out["frontend_embeds"] = _cast(emb, cfg.dtype)
        pad = np.full((b, cfg.frontend_tokens), -100, np.int32)
        full_labels = np.concatenate([pad, labels], axis=1)
    if cfg.encdec:
        emb = rng.standard_normal(
            (b, cfg.seq_len, cfg.d_model)).astype(np.float32) * 0.02
        out["frontend_embeds"] = _cast(emb, cfg.dtype)
    out["labels"] = full_labels.astype(np.int32)
    return out


class PrefetchPipeline:
    """Background-thread prefetch of deterministic batches."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 prefetch: int = 2):
        self.cfg = cfg
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = synth_batch(self.cfg, step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)
