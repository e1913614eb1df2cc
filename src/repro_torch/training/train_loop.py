"""Loss and train step — the port's counterpart of
``repro.training.train_loop``.

``make_train_step(cfg, tcfg)`` returns ``train_step(state, batch) ->
(state, metrics)`` with ``state = {params, opt: {m, v, step},
router_state, err?}``: ``params`` the model (an ``nn.Module`` from
``model_zoo.init(..., requires_grad=True)``), ``opt`` AdamW's state keyed
by parameter name, ``router_state`` the MoE router's (E,) virtual queues
((1,) zeros without MoE), ``err`` the compression's error feedback. One
step runs the forward, the loss, the backward (on the card the flash
attention kernels both ways), the optional compression and AdamW; the
parameters and moments are updated in place and the state is returned.

Under a model mesh (``distributed.set_mesh``, a ``launch.mesh.ModelMesh``
set when :func:`make_train_step` is called) the step is data-parallel over
its ``"data"`` axis, SPMD. Every rank passes the same global batch and takes
its rows by ``distributed.sharding.batch_shardings``; a batch whose rows do
not split over the ranks runs whole on every rank. The loss is the global
loss: the token count is a ``psum``, and each rank's term is its
cross-entropy sum over the global count. The gradients are ``psum``-ed over
``"data"``, or, with ``grad_specs`` (``specs_for_template(template,
zero_rules(mesh), mesh)``, as the reference builds them), ``psum_scatter``-ed
onto the blocks of the leaves those specs cut. With ``tcfg.opt.zero_sharding``
the moments are ZeRO-1 blocks (:func:`shard_train_state` cuts them, the
counterpart of ``jax.device_put(state, train_state_shardings(...))``); each
rank updates its block of each parameter and all-gathers the parameters.
The metrics are the global values, the same on every rank. A rank off the
mesh takes no part: its state comes back as given, with the mesh's metrics.
On a mesh of one rank the step is the one-rank step, bitwise. Tensor-parallel
training (a ``"model"`` axis of more than one rank) raises
``NotImplementedError`` (module item 5b).

An MoE config trains across ranks by either of the reference's routes:

* the global-batch router (``moe_ep_shardmap`` off): each MoE layer routes
  the global batch (``models.moe.moe_ffn`` with the rows' axis: capacity,
  positions, loads, the router state and ``dropped_frac`` are the
  reference's under GSPMD, from collectives), with the whole expert weights
  on every rank. The reference's layout cuts the experts' inner dim F over
  "data" (FSDP); here the parameters stay whole, their moments cut by the
  ZeRO-1 rules as any leaf's; holding them as blocks and gathering them a
  layer at a time is left for later (ROADMAP.md, module item 5b);
* the expert-parallel route (``moe_ep_shardmap`` with the mesh set, the
  model placed by ``models.moe_ep.place_``): each rank holds E/n experts,
  whose gradients are complete on their rank (the ``all_to_all``'s
  backward) and are not summed; their moments are blocks of the same
  layout, updated in place with no gather. Its batch must split over
  "data".

:func:`state_shardings` gives the layout a rank holds the state in, which
:func:`shard_train_state` cuts and ``training.checkpoint`` gathers and
restores. The load-balance loss of each rank is its term
(``moe_aux_term``), whose sum over the ranks is the global one.
"""
from __future__ import annotations

import dataclasses

import torch

from ..device import resolve_device
from ..distributed import sharding as shd
from ..distributed.context import SOLO, get_mesh, psum, psum_scatter, set_mesh
from ..models import model_zoo
from ..models.moe import init_router_state
from .compression import compress_grads, init_error_state
from .optimizer import OptConfig, adamw_update, init_opt_state

__all__ = ["TrainConfig", "make_loss_fn", "make_train_step", "init_train_state",
           "shard_train_state", "state_shardings"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    remat: str = "none"  # none | full | dots | dots_no_batch
    microbatches: int = 1  # gradient accumulation
    grad_compression: bool = False
    moe_aux_weight: float = 0.01
    z_loss: float = 0.0


def make_loss_fn(cfg, tcfg: TrainConfig, *, ops=None):
    """``loss_fn(model, batch, router_state) -> (loss, (metrics,
    router_state))``: mean cross-entropy over the labels >= 0 (a
    ``vision_stub`` batch's labels cover patches and tokens), plus
    ``z_loss * mean(logsumexp^2)`` and ``moe_aux_weight`` times the mean
    MoE load-balance loss over the layers. ``ops`` picks the attention route
    as ``model_zoo.forward`` does (``kernels.ops.plain`` to compare)."""
    return _loss_fn(cfg, tcfg, ops, SOLO)


def _loss_fn(cfg, tcfg: TrainConfig, ops, axis):
    """:func:`make_loss_fn`'s loss on this rank's rows of a batch whose other
    rows the ranks of ``axis`` hold: the loss (and the metrics' ``loss`` and
    ``ce``) is this rank's term of the global loss, whose sum over ``axis``
    is the global loss; ``ntok`` is the global token count."""

    def loss_fn(model, batch, router_state):
        logits, aux = model_zoo.forward(model, cfg, batch, router_state, ops=ops,
                                        remat=tcfg.remat, axis=axis)
        labels = batch["labels"]
        logits32 = logits.float()
        valid = labels >= 0
        safe = labels.clamp_min(0)
        logz = torch.logsumexp(logits32, dim=-1)
        # the gold logit by a gather: the reference's one-hot contraction sums
        # exact zeros beside it, so the two are equal for finite logits
        gold = logits32.gather(-1, safe[..., None].long())[..., 0]
        ce = (logz - gold) * valid
        ntok = psum(valid.sum(), axis, "dp").clamp_min(1)
        loss = ce.sum() / ntok
        if tcfg.z_loss and axis.size == 1:
            loss = loss + tcfg.z_loss * torch.mean(torch.square(logz) * valid)
        elif tcfg.z_loss:  # this rank's sum over the global batch's element count
            loss = loss + tcfg.z_loss * (torch.sum(torch.square(logz) * valid)
                                         / (valid.numel() * axis.size))
        if cfg.moe:
            # this rank's term of the global load-balance loss
            loss = loss + tcfg.moe_aux_weight * aux["moe_aux_term"] / max(cfg.n_layers, 1)
        metrics = dict(loss=loss.detach(), ce=(ce.sum() / ntok).detach(), ntok=ntok,
                       moe_aux=aux["moe_aux_loss"].detach())
        return loss, (metrics, aux["router_state"])

    return loss_fn


def init_train_state(cfg, tcfg: TrainConfig, generator: torch.Generator, device="cuda") -> dict:
    """A model drawn from ``generator`` with gradients on, AdamW's zero state
    and the router state, on the card unless ``device="cpu"``."""
    device = resolve_device(device)
    model = model_zoo.init(cfg, generator, device, requires_grad=True)
    params = dict(model.named_parameters())
    state = dict(params=model, opt=init_opt_state(params, tcfg.opt),
                 router_state=(init_router_state(cfg, device) if cfg.moe
                               else torch.zeros((1,), dtype=torch.float32, device=device)))
    if tcfg.grad_compression:
        state["err"] = init_error_state(params)
    return state


def _split_microbatches(batch, n):
    return [{k: a[i::n] for k, a in batch.items()} for i in range(n)]


#: the expert leaves' blocks under the expert-parallel route (``moe_ep.place_``'s cuts)
_EXPERT_BLOCKS = {"w_gate": ("data", None, "model"), "w_up": ("data", None, "model"),
                  "w_down": ("data", "model", None)}


def state_shardings(cfg, mesh, tcfg: TrainConfig) -> dict:
    """The layout a rank holds the training state in on an ``(n, 1)``
    ``mesh``, in ``distributed.sharding.train_state_shardings``'s tree: the
    parameters whole, but under the expert-parallel route
    (``cfg.moe_ep_shardmap``) the experts' ``w_gate``, ``w_up`` and
    ``w_down``, which are this rank's blocks of E/n experts; the moments
    (and the compression's ``err``) by ``train_state_shardings``'s (ZeRO-1)
    specs, those expert leaves' as their parameters' blocks. For a dense
    config this is ``train_state_shardings``."""
    out = shd.train_state_shardings(cfg, mesh, tcfg)
    whole = shd.Sharding(mesh, shd.PartitionSpec())
    out["params"] = {n: whole for n in out["params"]}
    if cfg.moe and cfg.moe_ep_shardmap:
        for n in out["params"]:
            owner, _, leaf = n.rpartition(".")
            if owner.endswith(".moe") and leaf in _EXPERT_BLOCKS:
                blk = shd.Sharding(mesh, shd.PartitionSpec(*_EXPERT_BLOCKS[leaf]))
                out["params"][n] = out["opt"]["m"][n] = out["opt"]["v"][n] = blk
                if "err" in out:
                    out["err"][n] = blk
    return out


def shard_train_state(state: dict, shardings: dict) -> dict:
    """The counterpart of ``jax.device_put(state, shardings)`` with
    ``shardings = state_shardings(cfg, mesh, tcfg)``: AdamW's moments ``m``
    and ``v`` (and the compression's ``err``), made at the parameters' whole
    shapes, replaced by this rank's blocks, new tensors. The parameters are
    left as they are: whole, or under the expert-parallel route the blocks
    ``models.moe_ep.place_`` cut. In place; returns ``state``."""

    def cut(tree, sh):
        return {n: sh[n].local(t).clone() for n, t in tree.items()}

    state["opt"]["m"] = cut(state["opt"]["m"], shardings["opt"]["m"])
    state["opt"]["v"] = cut(state["opt"]["v"], shardings["opt"]["v"])
    if "err" in state:
        state["err"] = cut(state["err"], shardings["err"])
    return state


def _check_mesh(mesh) -> None:
    """Raise for what data-parallel training does not cover yet."""
    if mesh is None:
        return
    other = {a: n for a, n in mesh.shape.items() if a != "data" and n > 1}
    if other:
        raise NotImplementedError(
            f"make_train_step on mesh axes {other}: tensor-parallel training is not ported yet "
            "(ROADMAP.md, section 1, module item 5b); train data-parallel on an (n, 1) mesh")


class _Layout:
    """Where a data-parallel step's gradients go: ``grad`` the shardings of
    ``grad_specs`` (None without them), ``moment`` the moments' (the blocks
    the optimizer updates), ``params`` the parameters' as held
    (:func:`state_shardings`), ``owned`` the parameters that are this
    rank's blocks (the expert-parallel route's experts)."""

    def __init__(self, cfg, tcfg, mesh, grad_specs):
        self.mesh = mesh
        self.data = mesh.axis("data")
        held = state_shardings(cfg, mesh, tcfg)
        self.moment, self.params = held["opt"]["m"], held["params"]
        self.owned = {n for n, sh in self.params.items() if not sh.replicated}
        self.grad = None if grad_specs is None else shd.named(mesh, grad_specs)

    def rows(self, batch: dict):
        """(this rank's rows of ``batch``, the axis the rest lie on); the
        whole batch and a world of one when its rows do not split."""
        if shd._batch_dim_spec(self.mesh, next(iter(batch.values())).shape[0]) is None:
            if self.owned:
                raise ValueError(
                    f"the expert-parallel route trains on a batch whose rows split over the "
                    f"{self.data.size} ranks of 'data'; this one has "
                    f"{next(iter(batch.values())).shape[0]}")
            return batch, SOLO
        sh = shd.batch_shardings(batch, self.mesh)
        return {k: sh[k].local(a) for k, a in batch.items()}, self.data

    def check(self, params: dict, opt: dict) -> None:
        for n, p in params.items():
            want = tuple(p.shape if n in self.owned else self.moment[n].local(p).shape)
            if tuple(opt["m"][n].shape) != want:
                raise ValueError(f"the moments of {n} are {tuple(opt['m'][n].shape)}, this "
                                 f"rank's block is {want}: cut the state with "
                                 "shard_train_state(state, state_shardings(...)) first")

    def reduce(self, name: str, summed, whole):
        """The gradient of ``name`` in the moments' layout, from ``summed``
        (this rank's rows' gradient, to sum over "data") and ``whole`` (the
        global gradient of rows every rank ran), either None. An owned
        block's gradient is complete on this rank."""
        if name in self.owned:
            return summed
        g_sh, m_sh = None if self.grad is None else self.grad[name], self.moment[name]
        g, blk = None, None
        if summed is not None:
            cuts = [] if g_sh is None else g_sh.cuts()
            if cuts:  # the reduce-scatter onto grad_specs' block (one dim, over "data")
                (d, _), = cuts
                g, blk = psum_scatter(summed, self.data, d, "dp"), g_sh
            else:
                g = psum(summed, self.data, "dp")
        if whole is not None:
            part = whole if blk is None else blk.local(whole)
            g = part if g is None else g + part
        if blk is not None and blk.cuts() == m_sh.cuts():
            return g
        return m_sh.local(g if blk is None else blk.gather(g))


def make_train_step(cfg, tcfg: TrainConfig, grad_specs=None, *, ops=None):
    """``train_step(state, batch) -> (state, metrics)``, which runs under the
    model mesh ambient when it was made (``distributed.set_mesh``);
    ``metrics``: loss, ce, ntok, moe_aux (of the last microbatch), grad_norm,
    lr. With ``microbatches`` n > 1 the batch is split as ``a[i::n]``, the
    gradients accumulated in float32 and averaged, the router state threaded through
    the microbatches, and the loss the mean of theirs. Under the ambient
    model mesh the step is data-parallel (see the module's docstring): each
    microbatch of the global batch is cut into the ranks' rows, and
    ``grad_specs`` (``{name: PartitionSpec}``) reduce-scatters the
    gradients of the leaves it cuts over "data"."""
    mesh = get_mesh()
    _check_mesh(mesh)
    layout = (None if mesh is None or not mesh.member or mesh.shape["data"] == 1
              else _Layout(cfg, tcfg, mesh, grad_specs))
    loss_whole = make_loss_fn(cfg, tcfg, ops=ops)
    loss_rows = None if layout is None else _loss_fn(cfg, tcfg, ops, layout.data)

    def grads_of(model, names, batch, rs, split):
        loss, (metrics, rs_new) = (loss_rows if split else loss_whole)(model, batch, rs)
        grads = torch.autograd.grad(loss, [p for _, p in names], allow_unused=True,
                                    materialize_grads=True)
        rs = rs if rs_new is None else rs_new.detach()
        return loss.detach(), metrics, dict(zip((n for n, _ in names), grads)), rs

    def train_step(state, batch):
        # the MoE blocks read the ambient mesh as they run: the step's, which remat's
        # re-runs in the backward pass see too
        outer = get_mesh()
        set_mesh(mesh)
        try:
            return step_under_mesh(state, batch)
        finally:
            set_mesh(outer)

    def step_under_mesh(state, batch):
        if mesh is not None and not mesh.member:
            return state, mesh.share(None)
        model = state["params"]
        names = list(model.named_parameters())
        if layout is not None:
            layout.check(dict(names), state["opt"])
        rs = state["router_state"]
        n_micro = tcfg.microbatches
        # by whether the rows were split over "data": the gradients (to sum over the
        # ranks, or global already) and the losses
        grads, losses = {True: None, False: None}, {True: None, False: None}
        for mb in (_split_microbatches(batch, n_micro) if n_micro > 1 else [batch]):
            rows, axis = (mb, SOLO) if layout is None else layout.rows(mb)
            split = axis.size > 1
            loss, metrics, g, rs = grads_of(model, names, rows, rs, split)
            if n_micro == 1:
                grads[split], losses[split] = g, loss
                continue
            if grads[split] is None:
                grads[split] = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                                for n, p in names}
                losses[split] = torch.zeros((), dtype=torch.float32, device=rs.device)
            for n in grads[split]:
                grads[split][n] = grads[split][n] + g[n]
            losses[split] = losses[split] + loss

        if layout is None:
            grads, loss_sum = grads[False], losses[False]
        else:
            grads = {n: layout.reduce(n, None if grads[True] is None else grads[True][n],
                                      None if grads[False] is None else grads[False][n])
                     for n, _ in names}
            # the rows' loss terms and the last microbatch's ce, summed over the ranks in one
            zero = torch.zeros((), dtype=torch.float32, device=rs.device)
            terms = psum(torch.stack([zero if losses[True] is None else losses[True],
                                      metrics["ce"] if split else zero]), layout.data, "dp")
            loss_sum = terms[0] + (zero if losses[False] is None else losses[False])
            if split:
                metrics["ce"] = terms[1]
        if n_micro > 1:
            grads = {n: g / n_micro for n, g in grads.items()}
            metrics["loss"] = loss_sum / n_micro
        else:
            metrics["loss"] = loss_sum

        moment = None if layout is None else layout.moment
        if tcfg.grad_compression:
            grads, state["err"] = compress_grads(grads, state["err"], moment)
        _, state["opt"], opt_metrics = adamw_update(dict(names), grads, state["opt"], tcfg.opt,
                                                    moment, None if layout is None
                                                    else layout.params)
        metrics.update(opt_metrics)
        state["router_state"] = rs
        if mesh is not None and mesh.idle:  # the ranks off the mesh take rank 0's metrics
            mesh.share({k: v.detach().cpu() for k, v in metrics.items()})
        return state, metrics

    return train_step
