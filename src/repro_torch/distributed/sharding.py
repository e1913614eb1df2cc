"""Logical-axis sharding rules -> specs on a model mesh — the port's
counterpart of ``repro.distributed.sharding``.

Every parameter dim carries a logical axis name ("embed", "ff", "heads",
"kv", "vocab", "experts", None: ``models.model_zoo.template``). This module
translates those to a :class:`PartitionSpec` for a mesh
(``launch.mesh.ModelMesh``), by the reference's rules:

  TP  : ff / heads / kv / vocab  -> "model"
  DP  : batch dims               -> ("pod", "data") / ("data",)
  EP  : experts -> "model"; expert FFN inner dims additionally shard "ff"
        over "data"
  ZeRO: optimizer moments additionally shard "embed" over "data"
  SP  : long-context caches shard sequence over "data" when batch < data

A mapping is dropped (the dim replicated) when the dim's size does not
divide by the mesh axis's, and each mesh axis is used at most once per spec,
by the first logical dim that asks for it. A spec is computed in the
reference leaf's dim order and then permuted to the port tensor's
(``Leaf.perm``: an ``nn.Linear`` weight is the reference's (in, out)
matrix transposed), so that "first" means what it means in the reference.

The reference hands its specs to GSPMD; the port is SPMD, one process per
rank, and a :class:`Sharding` (a mesh and a spec) does by hand what
``jax.device_put`` and a global view do: :meth:`Sharding.local` cuts this
rank's block, :meth:`Sharding.gather` rebuilds the global tensor from the
blocks with ``all_gather``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .context import all_gather

__all__ = [
    "PartitionSpec", "Sharding", "param_rules", "zero_rules", "batch_axes",
    "specs_for_template", "param_shardings", "train_state_shardings", "batch_shardings",
    "decode_shardings", "named",
]


class PartitionSpec(tuple):
    """One entry per dim: a mesh axis name, a tuple of names (the dim cut
    over their product, the first name major), or None (replicated)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _names(entry) -> tuple:
    return () if entry is None else entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on ``mesh``: dim d is cut over the mesh axes of
    ``spec[d]`` (dims past the spec's length are whole)."""

    mesh: object
    spec: PartitionSpec

    def cuts(self) -> list[tuple[int, tuple]]:
        """[(dim, the axes it is cut over)] of the dims cut over more than one rank."""
        shape = self.mesh.shape
        return [(d, names) for d, names in ((d, _names(e)) for d, e in enumerate(self.spec))
                if names and int(np.prod([shape[a] for a in names])) > 1]

    @property
    def replicated(self) -> bool:
        return not self.cuts()

    def local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's block of the global tensor ``t`` (a view)."""
        for d, names in self.cuts():
            size, index = 1, 0
            for a in names:  # the first name major
                ax = self.mesh.axis(a)
                size, index = size * ax.size, index * ax.size + ax.index
            n = t.shape[d] // size
            t = t.narrow(d, index * n, n)
        return t

    def within(self, held: "Sharding") -> "Sharding":
        """This layout's block as a block of ``held``'s block (which holds
        it): each dim cut over the axes of this spec that ``held``'s does not
        cut it over. ``ValueError`` where ``held`` cuts a dim over an axis
        that this spec does not."""
        n = max(len(self.spec), len(held.spec))
        mine = [_names(e) for e in (*self.spec, *([None] * (n - len(self.spec))))]
        theirs = [_names(e) for e in (*held.spec, *([None] * (n - len(held.spec))))]
        shape = self.mesh.shape
        entries = []
        for d, (a, b) in enumerate(zip(mine, theirs)):
            b = tuple(x for x in b if shape[x] > 1)
            if not set(b) <= set(a) or a[:len(b)] != b:
                raise ValueError(f"{held.spec} does not hold a block of {self.spec} (dim {d})")
            rest = a[len(b):]
            entries.append(None if not rest else rest[0] if len(rest) == 1 else rest)
        return Sharding(self.mesh, P(*entries))

    def gather(self, t: torch.Tensor, tag: str = "dp") -> torch.Tensor:
        """The global tensor (contiguous) from this rank's block ``t``
        (every rank of the axes it is cut over calls it); the all-gathers
        over ``"model"`` are counted under ``"tp"``, the others under ``tag``."""
        cuts = self.cuts()
        for d, names in cuts:
            for a in reversed(names):  # the minor axis first
                t = all_gather(t.movedim(d, 0), self.mesh.axis(a),
                               "tp" if a == "model" else tag).movedim(0, d)
        return t.contiguous() if cuts else t


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of the trees ``rest`` of
    the same structure); a :class:`PartitionSpec` or :class:`Sharding` is a
    leaf."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def _has_pod(mesh) -> bool:
    return "pod" in mesh.axis_names


def batch_axes(mesh):
    return ("pod", "data") if _has_pod(mesh) else ("data",)


def param_rules(mesh) -> dict:
    return {
        "vocab": "model",
        "heads": "model",
        "kv": "model",
        "ff": "model",
        "experts": "model",
        "embed": None,
        "layers": None,
        None: None,
    }


def zero_rules(mesh) -> dict:
    """ZeRO-1: moments also shard the replicated 'embed' axis over data."""
    r = dict(param_rules(mesh))
    r["embed"] = "data"
    return r


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([mesh.shape[a] for a in axis]))
    return mesh.shape[axis]


def _spec_for_leaf(shape: tuple, axes: tuple, rules: dict, mesh) -> PartitionSpec:
    entries = []
    used: set = set()
    is_expert_leaf = "experts" in axes
    ep_axis = rules.get("experts", "model")
    ep_other = {"model": "data", "data": "model"}.get(ep_axis, None)
    for dim, ax in zip(shape, axes):
        target = rules.get(ax, None)
        if is_expert_leaf and ax == "experts":
            target = ep_axis
        if is_expert_leaf and ax == "ff":
            # the expert FFN's inner dim takes the axis the experts do not use
            target = ep_other
        if target is None:
            entries.append(None)
            continue
        flat = target if isinstance(target, tuple) else (target,)
        if any(t in used for t in flat) or dim % _axis_size(mesh, target) != 0:
            entries.append(None)
            continue
        used.update(flat)
        entries.append(target)
    return P(*entries)


def specs_for_template(template: dict, rules: dict, mesh) -> dict:
    """``{parameter name: PartitionSpec}`` in the port's layout, from
    ``model_zoo.template``'s leaves: each spec built in the reference's dim
    order, then permuted."""
    out = {}
    for name, leaf in template.items():
        spec = _spec_for_leaf(leaf.shape, leaf.axes, rules, mesh)
        out[name] = P(*(spec[d] for d in leaf.perm))
    return out


def named(mesh, spec_tree):
    """The :class:`Sharding` of each spec of ``spec_tree`` (nested dicts) on ``mesh``."""
    return _tree_map(lambda s: Sharding(mesh, s), spec_tree)


def _rules_for_cfg(cfg, rules: dict) -> dict:
    r = dict(rules)
    if getattr(cfg, "ep_axis", "model") != "model":
        r["experts"] = cfg.ep_axis
    return r


def param_shardings(cfg, mesh) -> dict:
    from ..models import model_zoo

    tmpl = model_zoo.template(cfg)
    return named(mesh, specs_for_template(tmpl, _rules_for_cfg(cfg, param_rules(mesh)), mesh))


def train_state_shardings(cfg, mesh, tcfg) -> dict:
    """The training state's shardings, ``training.init_train_state``'s
    tree: ``params`` by the parameter rules, the moments ``m`` and ``v`` (and
    the compression's ``err``) by the ZeRO-1 rules when
    ``tcfg.opt.zero_sharding``, else as the parameters; ``step`` and
    ``router_state`` replicated."""
    from ..models import model_zoo

    tmpl = model_zoo.template(cfg)
    p_specs = specs_for_template(tmpl, _rules_for_cfg(cfg, param_rules(mesh)), mesh)
    m_rules = zero_rules(mesh) if tcfg.opt.zero_sharding else param_rules(mesh)
    m_specs = specs_for_template(tmpl, _rules_for_cfg(cfg, m_rules), mesh)
    out = dict(params=p_specs, opt=dict(m=m_specs, v=dict(m_specs), step=P()),
               router_state=P())
    if tcfg.grad_compression:
        out["err"] = dict(m_specs)
    return named(mesh, out)


def _batch_dim_spec(mesh, dim_size: int):
    """Largest prefix of the DP axes that evenly divides the batch."""
    ba = batch_axes(mesh)
    if dim_size % _axis_size(mesh, ba) == 0:
        return ba if len(ba) > 1 else ba[0]
    for a in ba:  # try single axes
        if dim_size % mesh.shape[a] == 0:
            return a
    return None


def _shape(leaf) -> tuple:
    """A leaf's shape: a tensor's, or the shape of a ``(shape, dtype)``
    pair (``model_zoo.cache_spec``'s entries)."""
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf[0])


def batch_shardings(batch_tree: dict, mesh) -> dict:
    """Shard dim 0 (global batch) of every input leaf over the DP axes."""

    def one(leaf):
        shape = _shape(leaf)
        b = _batch_dim_spec(mesh, shape[0])
        return Sharding(mesh, P(b, *([None] * (len(shape) - 1))))

    return _tree_map(one, batch_tree)


def decode_shardings(cfg, cache_tree: dict, mesh, batch: int) -> dict:
    """Cache shardings: batch over DP when divisible, else sequence over
    'data' (context parallelism for batch=1 long-context decode); heads /
    d_in dims over 'model' when divisible."""
    b = _batch_dim_spec(mesh, batch)

    def dim_ok(size, axis):
        return axis is not None and size % _axis_size(mesh, axis) == 0

    def kv_spec(shape):  # (L, B, S, Hkv, HD)
        # TP the cache over heads when they divide; otherwise over the cache length
        if dim_ok(shape[3], "model"):
            h_ax, s_ax = "model", None
        elif dim_ok(shape[2], "model"):
            h_ax, s_ax = None, "model"
        else:
            h_ax, s_ax = None, None
        if b is not None:
            return P(None, b, s_ax, h_ax, None)
        seq = "data" if dim_ok(shape[2], "data") else None
        if seq is not None and s_ax is not None:
            return P(None, None, (seq, s_ax), h_ax, None)
        return P(None, None, seq or s_ax, h_ax, None)  # SP over cache length

    def conv_spec(shape):  # (L, B, K-1, C)
        model = "model" if dim_ok(shape[3], "model") else None
        return P(None, b, None, model)

    def ssm_spec(shape):  # (L, B, H, P, S)
        model = "model" if dim_ok(shape[2], "model") else None
        return P(None, b, model, None, None)

    out = {}
    for name, leaf in cache_tree.items():
        shape = _shape(leaf)
        if name in ("k", "v"):
            out[name] = Sharding(mesh, kv_spec(shape))
        elif name == "conv":
            out[name] = Sharding(mesh, conv_spec(shape))
        elif name == "ssm":
            out[name] = Sharding(mesh, ssm_spec(shape))
        else:
            raise KeyError(name)
    return out
