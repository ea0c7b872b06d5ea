"""Deterministic, step-keyed synthetic LM data (counterpart of
``repro.data.pipeline``).

A batch is a pure function of ``(seed, step)``: the same numpy generator
as the reference draws a mixture of arithmetic-progression and
repeated-motif sequences, so the port's batches equal the reference's
element for element, and a run resumed at step k sees the same stream.
Batches are int32 CPU tensors (the host side of the pipeline); the train
step moves them to the model's device.  ``iterate`` prefetches on a
background thread.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    batch: int = 8
    seq_len: int = 128
    vocab_size: int = 512
    prefetch: int = 2


class SyntheticLMDataset:
    """Deterministic step -> batch mapping with an optional prefetch thread."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> dict:
        """``{"tokens", "labels"}``, each ``(batch, seq_len)`` int32; the
        labels are the tokens shifted by one."""
        cfg = self.cfg
        rng = np.random.default_rng(np.uint64(cfg.seed * 1_000_003 + step))
        b, t = cfg.batch, cfg.seq_len
        v = cfg.vocab_size
        kinds = rng.integers(0, 2, size=(b,))
        tokens = np.empty((b, t + 1), np.int32)
        for i in range(b):
            if kinds[i] == 0:  # arithmetic progression mod vocab
                start = rng.integers(0, v)
                stride = rng.integers(1, 7)
                tokens[i] = (start + stride * np.arange(t + 1)) % v
            else:  # repeated motif
                mlen = int(rng.integers(4, 17))
                motif = rng.integers(0, v, size=(mlen,))
                reps = -(-(t + 1) // mlen)
                tokens[i] = np.tile(motif, reps)[: t + 1]
        return {
            "tokens": torch.from_numpy(np.ascontiguousarray(tokens[:, :-1])),
            "labels": torch.from_numpy(np.ascontiguousarray(tokens[:, 1:])),
        }

    def iterate(self, start_step: int = 0) -> Iterator[dict]:
        """Prefetching iterator starting at ``start_step``."""
        q: queue.Queue = queue.Queue(maxsize=self.cfg.prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                batch = self.batch_at(step)
                while not stop.is_set():
                    try:
                        q.put(batch, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                step += 1

        th = threading.Thread(target=worker, daemon=True)
        th.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
            th.join(timeout=5.0)
