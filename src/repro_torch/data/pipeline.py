"""Deterministic, checkpointable synthetic data pipeline — the port's
counterpart of ``repro.data.pipeline``.

Batches are pure functions of ``(seed, step)`` (counter-based Philox), so a
restore at step N reproduces exactly the stream an uninterrupted run would
have seen. The draws are numpy's, in the reference's order, so a batch is
bitwise the reference's; ``data.specs.as_tensors`` puts one on a device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..configs.base import ArchConfig

__all__ = ["TokenPipeline"]


@dataclasses.dataclass
class TokenPipeline:
    cfg: ArchConfig
    batch: int
    seq: int
    seed: int = 0
    step: int = 0

    def state(self) -> dict:
        return dict(seed=self.seed, step=self.step)

    def restore(self, state: dict) -> None:
        self.seed = int(state["seed"])
        self.step = int(state["step"])

    def _rng(self, step: int) -> np.random.Generator:
        return np.random.Generator(np.random.Philox(key=self.seed, counter=[0, 0, 0, step]))

    def _materialize(self, step: int) -> dict:
        """numpy arrays: ``embeddings`` (encoder) or ``patches`` and
        ``tokens`` (``vision_stub``: ``min(n_frontend_tokens, seq // 2)``
        patches before ``seq - n_p`` tokens) or ``tokens``, then ``labels``
        (batch, seq) over the whole sequence."""
        rng = self._rng(step)
        out: dict = {}
        c = self.cfg
        if c.is_encoder:
            out["embeddings"] = rng.standard_normal((self.batch, self.seq, c.d_model)).astype(
                np.float32)
        elif c.frontend == "vision_stub":
            n_p = min(c.n_frontend_tokens, self.seq // 2)
            out["patches"] = rng.standard_normal((self.batch, n_p, c.d_model)).astype(np.float32)
            out["tokens"] = rng.integers(0, c.vocab_size, (self.batch, self.seq - n_p)).astype(
                np.int32)
        else:
            out["tokens"] = rng.integers(0, c.vocab_size, (self.batch, self.seq)).astype(np.int32)
        out["labels"] = rng.integers(0, c.vocab_size, (self.batch, self.seq)).astype(np.int32)
        return out

    def next_batch(self) -> dict:
        b = self._materialize(self.step)
        self.step += 1
        return b

    def peek(self, step: int) -> dict:
        return self._materialize(step)
