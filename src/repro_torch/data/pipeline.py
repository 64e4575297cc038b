"""Deterministic, resumable synthetic data pipeline.

Fault-tolerance contract (the property the Jup2Kub scheduler relies on):
``batch_at(step)`` is a pure function of (seed, step) — after a crash and
checkpoint restore at step k, the pipeline replays the *exact* same stream
from k, on any number of hosts, with no shared state.

The corpus is a seeded first-order Markov chain (bigram table), so a model
trained on it has real signal to learn — smoke-train loss curves must
*decrease*, which the integration tests assert.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # extra modality fields (stub frontends)
    vision_tokens: int = 0
    frames: bool = False
    d_model: int = 0
    dtype: str = "float32"


class SyntheticCorpus:
    """Markov-chain token stream, indexable by step."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        v = min(cfg.vocab_size, 2048)
        self._v = v
        rng = np.random.default_rng(cfg.seed)
        # sparse bigram transition table: each token has 4 likely successors
        succ = rng.integers(0, v, size=(v, 4))
        self._succ = succ

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        b, s = cfg.global_batch, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, self._v, size=b)
        choices = rng.integers(0, 4, size=(b, s))
        noise = rng.random((b, s)) < 0.05
        rand = rng.integers(0, self._v, size=(b, s))
        for t in range(s):
            nxt = self._succ[toks[:, t], choices[:, t]]
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:].copy()}
        if cfg.vision_tokens:
            batch["vision_embeds"] = rng.standard_normal(
                (b, cfg.vision_tokens, cfg.d_model)
            ).astype(cfg.dtype)
        if cfg.frames:
            batch["frames"] = rng.standard_normal((b, s, cfg.d_model)).astype(cfg.dtype)
        return batch


class PrefetchLoader:
    """Background-thread prefetch over an indexable source; resumable."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._step = start_step
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
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
