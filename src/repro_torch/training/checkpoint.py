"""Checkpointing: atomic, manifest-based, async-capable — the port's
counterpart of ``repro.training.checkpoint``, with its on-disk contract.

Every leaf of a state tree (dicts, lists and ``nn.Module``s, whose
parameters and buffers are leaves under their state_dict names) is written
as one ``.npy`` file under ``step_<N>.tmp/``, which is renamed to
``step_<N>/`` once ``manifest.json`` is written: a preempted writer never
corrupts the latest checkpoint. A leaf's key is its path joined by ``/``
(``params/blocks.0.attn.wq.weight``, ``opt/m/embed``, ``opt/step``), the
file its key with ``/`` as ``__``. numpy has no bfloat16, so a bfloat16
leaf is stored as its ``uint16`` bits and named ``bfloat16`` in the
manifest. A leaf is restored onto the device and into the type of its
``state_like`` leaf.

Checkpoints are mesh-independent, as the reference's: each leaf is written
as its global array. Across ranks, ``shardings`` (the tree of
``distributed.sharding.Sharding`` that ``training.train_loop.state_shardings``
gives: a ZeRO-1 state's moments cut over "data", under tensor-parallel
training the parameters and moments cut over "model" too) names the
leaves that are this rank's blocks: :func:`save_checkpoint` all-gathers each of them, rank 0
writes the files, byte for byte those of a one-rank checkpoint of the same
state, and the other ranks wait for it at a barrier. :func:`restore_checkpoint`
loads each global array and keeps this rank's block by the current mesh's
``shardings`` (elastic restore: a state saved on a (2, 2) mesh restores
onto (4, 1), (1, 4), or onto one rank without ``shardings``).

``AsyncCheckpointer`` gathers and copies the state to the host on the
caller's thread (a consistent snapshot) and writes it on a background
thread of rank 0, one write in flight; ``keep`` bounds the checkpoints on
disk.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step", "AsyncCheckpointer",
           "flatten_state"]

_MANIFEST = "manifest.json"


def _leaves(tree, prefix=()):
    """[(path, leaf)] of a tree in order; a module's leaves are its
    state_dict entries."""
    if isinstance(tree, nn.Module):
        return [(prefix + (name,), t) for name, t in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, dict):
        return [kv for key in tree for kv in _leaves(tree[key], prefix + (str(key),))]
    if isinstance(tree, (list, tuple)):
        return [kv for i, x in enumerate(tree) for kv in _leaves(x, prefix + (str(i),))]
    return [(prefix, tree)]


def flatten_state(tree) -> dict:
    """``{key: leaf}`` of a state tree in order, each key the leaf's path
    joined by ``/`` (the names of its checkpoint files)."""
    return {"/".join(path): leaf for path, leaf in _leaves(tree)}


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.uint16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _gathered(state, shardings) -> dict:
    """``flatten_state(state)`` with each leaf that ``shardings`` cuts
    all-gathered to its global array (every rank of its axes calls this)."""
    sh = {} if shardings is None else flatten_state(shardings)
    return {key: (sh[key].gather(leaf.detach()) if key in sh and not sh[key].replicated
                  else leaf) for key, leaf in flatten_state(state).items()}


def _write(ckpt_dir, step: int, leaves: dict, extra, keep: int) -> Path:
    """Write the flat ``leaves`` as ``ckpt_dir/step_<step>/`` and keep the
    newest ``keep`` checkpoints."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f"step_{step}.tmp"
    final = ckpt_dir / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    manifest = dict(step=step, leaves={}, extra=extra or {})
    for key, leaf in leaves.items():
        arr, dtype = _to_numpy(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = dict(file=fname, shape=list(arr.shape), dtype=dtype)
    (tmp / _MANIFEST).write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)  # atomic publish

    # retention
    steps = sorted(int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
                   if p.is_dir() and not p.name.endswith(".tmp"))
    for old in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{old}", ignore_errors=True)
    return final


def save_checkpoint(ckpt_dir, step: int, state, extra: dict | None = None,
                    keep: int = 3, shardings=None) -> Path:
    """Write ``state`` as ``ckpt_dir/step_<step>/`` and keep the newest
    ``keep`` checkpoints. Returns the checkpoint's directory. Across ranks
    every rank calls it: the leaves ``shardings`` cuts are gathered, rank 0
    writes, and every rank returns once the files are there."""
    leaves = _gathered(state, shardings)
    final = Path(ckpt_dir) / f"step_{step}"
    if _rank() == 0:
        _write(ckpt_dir, step, leaves, extra, keep)
    _barrier()
    return final


def latest_step(ckpt_dir) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.glob("step_*")
             if p.is_dir() and (p / _MANIFEST).exists()]
    return max(steps) if steps else None


def _load(src, meta) -> torch.Tensor:
    arr = np.load(src / meta["file"])
    t = torch.from_numpy(arr)
    return t.view(torch.bfloat16) if meta["dtype"] == "bfloat16" else t


def _rebuild(tree, out: dict, prefix=()):
    """``tree`` with its leaves replaced by ``out[key]``: a module's
    parameters and buffers are copied into it in place, dicts and lists are
    rebuilt."""
    if isinstance(tree, nn.Module):
        with torch.no_grad():
            for name, t in tree.state_dict(keep_vars=True).items():
                t.copy_(out["/".join(prefix + (name,))])
        return tree
    if isinstance(tree, dict):
        return {key: _rebuild(x, out, prefix + (str(key),)) for key, x in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(x, out, prefix + (str(i),)) for i, x in enumerate(tree))
    return out["/".join(prefix)]


def restore_checkpoint(ckpt_dir, step: int, state_like, shardings=None):
    """Restore ``ckpt_dir/step_<step>/`` into the structure of ``state_like``:
    each leaf in the type and on the device of its ``state_like`` leaf (a
    module's parameters are overwritten in place). With ``shardings`` (the
    same tree structure, the current mesh's), a leaf they cut is this rank's
    block of the global array; a ``state_like`` leaf may be either the
    global shape or the block's. Returns (state, extra)."""
    src = Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((src / _MANIFEST).read_text())
    sh = {} if shardings is None else flatten_state(shardings)
    out = {}
    for key, like in flatten_state(state_like).items():
        meta = manifest["leaves"].get(key)
        if meta is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _load(src, meta)
        like_t = torch.as_tensor(like) if not isinstance(like, torch.Tensor) else like
        cut = key in sh and not sh[key].replicated
        blk = sh[key].local(t) if cut else t
        if tuple(like_t.shape) not in (tuple(t.shape), tuple(blk.shape)):
            raise ValueError(f"{key}: shape {tuple(t.shape)} (this rank's block "
                             f"{tuple(blk.shape)}) != expected {tuple(like_t.shape)}")
        out[key] = blk.to(device=like_t.device, dtype=like_t.dtype, copy=cut)
    return _rebuild(state_like, out), manifest["extra"]


class AsyncCheckpointer:
    """Background checkpoint writer with a single in-flight slot. Across
    ranks every rank calls :meth:`save` (the gathers) and :meth:`wait` (a
    barrier after a save: the files are there on every rank's return)."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._pending = False

    def save(self, step: int, state, extra: dict | None = None, shardings=None):
        self.wait()
        leaves = _gathered(state, shardings)
        self._pending = True
        if _rank() != 0:  # rank 0 writes
            return
        # the device->host copy on the caller thread (consistent snapshot): the
        # leaves by key, each a new host copy, even of a CPU tensor
        host_state = {key: (leaf.detach().to("cpu", copy=True)
                            if isinstance(leaf, torch.Tensor) else np.array(leaf))
                      for key, leaf in leaves.items()}

        def _run():
            try:
                _write(self.ckpt_dir, step, host_state, extra, self.keep)
            except Exception as e:  # noqa: BLE001 — raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err
