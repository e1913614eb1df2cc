"""Input specs and synthetic batch builders per (architecture x shape
cell) — the port's counterpart of ``repro.data.specs``.

``input_specs(cfg, shape)`` gives ``{name: (shape, dtype)}``, as
``model_zoo.cache_spec`` does, where the reference gives
``jax.ShapeDtypeStruct``s; ``make_batch`` draws a concrete batch with the
reference's numpy draws in its order, and ``as_tensors`` puts a numpy batch
(``make_batch``'s draws, or a ``TokenPipeline`` batch) on a device:
embeddings and patches in the compute type, ids as int64 (the index type
of ``torch``'s gathers; the values are the reference's int32 ids).

Modality frontends are stubs, as in the reference: encoder (``audio_stub``)
and ``vision_stub`` configs take precomputed frame or patch embeddings.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..device import resolve_device
from ..models.common import DTYPES
from ..models.model_zoo import cache_spec

__all__ = ["input_specs", "make_batch", "decode_cache_specs", "as_tensors"]


def _train_specs(cfg: ArchConfig, B: int, S: int) -> dict:
    cdt = DTYPES[cfg.compute_dtype]
    if cfg.is_encoder:
        return {"embeddings": ((B, S, cfg.d_model), cdt), "labels": ((B, S), torch.int64)}
    if cfg.frontend == "vision_stub":
        Np = min(cfg.n_frontend_tokens, S // 2)
        return {"patches": ((B, Np, cfg.d_model), cdt), "tokens": ((B, S - Np), torch.int64),
                "labels": ((B, S), torch.int64)}
    return {"tokens": ((B, S), torch.int64), "labels": ((B, S), torch.int64)}


def input_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    """``{name: (shape, dtype)}`` of the step a cell runs (train, prefill or
    decode; a decode step's ``cache`` is :func:`decode_cache_specs`)."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        return _train_specs(cfg, B, S)
    if shape.kind == "prefill":
        specs = _train_specs(cfg, B, S)
        specs.pop("labels")
        return specs
    if shape.kind == "decode":
        return {"token": ((B, 1), torch.int64), "pos": ((B,), torch.int32),
                "cache": cache_spec(cfg, B, S)}
    raise ValueError(shape.kind)


def decode_cache_specs(cfg: ArchConfig, shape: ShapeSpec) -> dict:
    return cache_spec(cfg, shape.global_batch, shape.seq_len)


def as_tensors(batch: dict, cfg: ArchConfig, device="cuda") -> dict:
    """A numpy batch as tensors on ``device`` (the card unless
    ``device="cpu"``): float arrays in the compute type, id arrays int64."""
    device = resolve_device(device)
    cdt = DTYPES[cfg.compute_dtype]
    return {name: torch.as_tensor(np.asarray(a)).to(
                device=device, dtype=cdt if np.asarray(a).dtype.kind == "f" else torch.int64)
            for name, a in batch.items()}


def make_batch(rng: np.random.Generator, cfg: ArchConfig, B: int, S: int, kind: str = "train",
               device="cuda") -> dict:
    """A concrete random batch matching :func:`input_specs`, drawn from
    ``rng`` as the reference draws it (embeddings or patches first, then
    tokens, then labels for ``kind="train"``), on ``device``."""
    out: dict = {}
    if cfg.is_encoder:
        out["embeddings"] = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    elif cfg.frontend == "vision_stub":
        Np = min(cfg.n_frontend_tokens, S // 2)
        out["patches"] = rng.standard_normal((B, Np, cfg.d_model)).astype(np.float32)
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S - Np))
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S))
    if kind == "train":
        out["labels"] = rng.integers(0, cfg.vocab_size, (B, S))
    return as_tensors(out, cfg, device)
