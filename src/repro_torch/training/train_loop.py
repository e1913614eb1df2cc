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
On a mesh of one rank the step is the one-rank step, bitwise.

A ``"model"`` axis of m > 1 ranks trains a dense decoder (family
``"dense"``), an MoE decoder (family ``"moe"``), a ``vision_stub`` config
or an encoder tensor-parallel, composed with the ``"data"`` axis on (1, m)
and (d, m) meshes (Megatron's layout, ``models.common``): each rank holds
its blocks of the weights that the reference's rules cut over "model"
(heads, kv heads, d_ff and the vocabulary,
``distributed.sharding.param_rules``) and whole the others (the norms, the
MoE router); :func:`shard_train_state` cuts them. Every rank of a data row
computes the same loss. On vocabulary-cut logits the loss takes ``logz``
by a ``pmax`` and a sum of ``exp`` over "model", and the gold logit by a
masked local gather summed over "model" (the reference's one-hot
contraction); the z-loss reads the same ``logz``. A model-cut leaf's
gradient is this rank's block, complete; a replicated leaf's is the same on
every model rank (``distributed.copy_to``'s backward sums the ranks'
parts); both are summed over "data" only. With ZeRO-1 the moments of a
model-cut leaf are cut over both axes; AdamW updates the moment block
within the rank's parameter block and all-gathers over "data" alone. The
heads must divide over the ranks (``ValueError``); kv heads that do not
leave ``wk``/``wv`` whole on every rank (:func:`state_shardings`, a layout
that parts from the reference's, whose flat kv dim may cut a head). A
vocabulary that does not divide stays whole on every rank, as the
reference drops the cut, and the loss takes whole logits. A ``vision_stub``
config's patches join the lookup's output whole on every model rank, and an
encoder's frame embeddings enter the first block whole (it has no lookup;
its head is cut by the vocabulary as a decoder's is); neither is summed over
"model" or takes a gradient. Labels below 0 (say, at the patch positions)
are masked in either branch of the loss, and ``ntok`` counts the others.
SSM and hybrid configs on such a mesh, and any axis other than "data" and
"model", raise ``NotImplementedError`` (module item 5b).

An MoE config trains across ranks by either of the reference's routes:

* the global-batch router (``moe_ep_shardmap`` off): each MoE layer routes
  the global batch (``models.moe.moe_ffn`` with the rows' axis: capacity,
  positions, loads, the router state and ``dropped_frac`` are the
  reference's under GSPMD, from collectives), with the whole expert weights
  on every rank. The reference's layout cuts the experts' inner dim F over
  "data" (FSDP); here F stays whole, the moments cut by the ZeRO-1 rules
  within the held block; holding F as blocks and gathering it a layer at
  a time is left for later (ROADMAP.md, module item 5b). On a "model" axis
  of m > 1 ranks each rank holds E/m of the experts by the reference's
  rule (whole where E does not divide): the routing is computed whole on
  every model rank and each rank runs its own experts' entries
  (``moe_ffn``'s ``tp``); their gradients are complete on the rank and
  summed over "data";
* the expert-parallel route (``moe_ep_shardmap`` with the mesh set, the
  model placed by ``models.moe_ep.place_``): each rank holds E/d experts,
  each cut to its F/m block over "model", whose gradients are complete on
  their rank (the ``all_to_all``'s backward, the model ranks' cotangents
  summed by ``copy_to``) and are not summed; their moments are blocks of
  the same layout, updated in place with no gather. Its batch must split
  over "data".

:func:`state_shardings` gives the layout a rank holds the state in, which
:func:`shard_train_state` cuts and ``training.checkpoint`` gathers and
restores. The load-balance loss of each rank is its term
(``moe_aux_term``), whose sum over the ranks is the global one.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..device import resolve_device
from ..distributed import sharding as shd
from ..distributed.context import (SOLO, get_mesh, pmax, psum, psum_scatter, reduce_from,
                                   set_mesh)
from ..models import model_zoo
from ..models.common import tp_cut
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
    ``vision_stub`` batch's labels cover patches and tokens; -1 at the
    patch positions leaves them out), plus
    ``z_loss * mean(logsumexp^2)`` and ``moe_aux_weight`` times the mean
    MoE load-balance loss over the layers. ``ops`` picks the attention route
    as ``model_zoo.forward`` does (``kernels.ops.plain`` to compare)."""
    return _loss_fn(cfg, tcfg, ops, SOLO)


def _logz_gold(cfg, logits32, safe, tp):
    """``logsumexp`` of the logits and the gold logit at ``safe``. Over a
    model axis ``tp`` that cuts the vocabulary, ``logits32`` is this rank's
    block: the maximum is a ``pmax`` (no gradient: ``logsumexp``'s does not
    depend on the shift), and the sum of ``exp`` and the masked local gold
    logit are summed over the ranks in one ``reduce_from``, whose backward
    gives this rank the gradient of the loss every rank computes."""
    if not tp_cut(cfg.vocab_size, tp):
        # the gold logit by a gather: the reference's one-hot contraction sums
        # exact zeros beside it, so the two are equal for finite logits
        return (torch.logsumexp(logits32, dim=-1),
                logits32.gather(-1, safe[..., None].long())[..., 0])
    n = logits32.shape[-1]
    top = pmax(logits32.detach().amax(dim=-1), tp, "tp")
    ids = safe.long() - tp.index * n
    mine = (ids >= 0) & (ids < n)
    gold = logits32.gather(-1, ids.clamp(0, n - 1)[..., None])[..., 0]
    sums = reduce_from(torch.stack([torch.exp(logits32 - top[..., None]).sum(dim=-1),
                                    torch.where(mine, gold, torch.zeros_like(gold))]), tp)
    return torch.log(sums[0]) + top, sums[1]


def _loss_fn(cfg, tcfg: TrainConfig, ops, axis, tp=SOLO):
    """:func:`make_loss_fn`'s loss on this rank's rows of a batch whose other
    rows the ranks of ``axis`` hold: the loss (and the metrics' ``loss`` and
    ``ce``) is this rank's term of the global loss, whose sum over ``axis``
    is the global loss; ``ntok`` is the global count of labels >= 0. ``tp``:
    the model axis the weights are cut over, whose ranks compute the same
    loss, from vocabulary-cut or whole logits (:func:`_logz_gold`), the
    labels below 0 masked either way."""

    def loss_fn(model, batch, router_state):
        logits, aux = model_zoo.forward(model, cfg, batch, router_state, ops=ops,
                                        remat=tcfg.remat, axis=axis, tp=tp)
        labels = batch["labels"]
        logits32 = logits.float()
        valid = labels >= 0
        safe = labels.clamp_min(0)
        logz, gold = _logz_gold(cfg, logits32, safe, tp)
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


def _kv_leaves(names) -> list[str]:
    """The parameters of ``wk`` and ``wv`` (weights and biases) among ``names``."""
    return [n for n in names if n.split(".")[-3:-1] in (["attn", "wk"], ["attn", "wv"])]


def _expert_leaves(names) -> list[str]:
    """The experts' ``w_gate``, ``w_up`` and ``w_down`` among ``names`` (not the
    shared expert's)."""
    return [n for n in names if n.rpartition(".")[0].endswith(".moe")
            and n.rpartition(".")[2] in _EXPERT_BLOCKS]


def state_shardings(cfg, mesh, tcfg: TrainConfig) -> dict:
    """The layout a rank holds the training state in on ``mesh``, in
    ``distributed.sharding.train_state_shardings``'s tree; the moments (and
    the compression's ``err``) by its (ZeRO-1) specs, but under the
    expert-parallel route (``cfg.moe_ep_shardmap``) the experts' ``w_gate``,
    ``w_up`` and ``w_down`` and their moments are held as the blocks
    ``moe_ep.place_`` cuts, E/d experts by "data" and F/m by "model". On an
    ``(n, 1)`` mesh the other parameters are whole. On a ``"model"`` axis of
    m > 1 ranks they are cut by ``train_state_shardings``'s rules (heads, kv
    heads, d_ff and the vocabulary over "model" where they divide), but
    where ``n_kv_heads`` does not divide by m the ``wk``/``wv`` leaves stay
    whole (the reference cuts their flat dim whenever it divides, which can
    leave part of a head on a rank; their moments keep its layout); an
    encoder has no ``embed`` leaf and its ``lm_head`` is cut by the
    vocabulary, and a ``vision_stub`` config's leaves are a decoder's; the MoE
    router stays whole (every model rank routes the whole batch); and under
    the global-batch router the experts are held as E/m of them where E
    divides, F whole (the reference also cuts F over "data", its FSDP
    storage), their moments the ZeRO-1 blocks within that block."""
    out = shd.train_state_shardings(cfg, mesh, tcfg)
    whole = shd.Sharding(mesh, shd.PartitionSpec())
    params = out["params"]
    if mesh.shape.get("model", 1) > 1:
        model = mesh.axis("model")
        if not tp_cut(cfg.n_kv_heads, model):
            params.update(dict.fromkeys(_kv_leaves(params), whole))
        if cfg.moe:
            params.update({n: whole for n in params if n.endswith(".moe.router")})
            if not cfg.moe_ep_shardmap:
                experts = (shd.Sharding(mesh, shd.PartitionSpec("model"))
                           if tp_cut(cfg.n_experts, model) else whole)
                params.update(dict.fromkeys(_expert_leaves(params), experts))
    else:
        out["params"] = params = {n: whole for n in params}
    if cfg.moe and cfg.moe_ep_shardmap:
        for n in _expert_leaves(params):
            blk = shd.Sharding(mesh, shd.PartitionSpec(*_EXPERT_BLOCKS[n.rpartition(".")[2]]))
            params[n] = out["opt"]["m"][n] = out["opt"]["v"][n] = blk
            if "err" in out:
                out["err"][n] = blk
    return out


def shard_train_state(state: dict, shardings: dict) -> dict:
    """The counterpart of ``jax.device_put(state, shardings)`` with
    ``shardings = state_shardings(cfg, mesh, tcfg)``: AdamW's moments ``m``
    and ``v`` (and the compression's ``err``), made at the parameters' whole
    shapes, replaced by this rank's blocks, new tensors; the parameters that
    the layout cuts over "model" (tensor-parallel training) replaced by this
    rank's blocks, new parameters of the model, unless they are that block
    already: under the expert-parallel route ``models.moe_ep.place_`` cut the
    experts and the shared expert's columns (a parameter whose shape is not
    its moments' whole one is left as it is), and cutting them again would
    cut a block of the block. The other parameters are left whole. In place;
    returns ``state``."""

    def cut(tree, sh):
        return {n: sh[n].local(t).clone() for n, t in tree.items()}

    model = state["params"]
    for n, sh in shardings["params"].items():
        if any("model" in names for _, names in sh.cuts()):
            owner, _, leaf = n.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            p = getattr(module, leaf)
            if p.shape != state["opt"]["m"][n].shape:  # placed: this rank's block already
                continue
            with torch.no_grad():
                setattr(module, leaf, nn.Parameter(sh.local(p).clone(),
                                                   requires_grad=p.requires_grad))

    state["opt"]["m"] = cut(state["opt"]["m"], shardings["opt"]["m"])
    state["opt"]["v"] = cut(state["opt"]["v"], shardings["opt"]["v"])
    if "err" in state:
        state["err"] = cut(state["err"], shardings["err"])
    return state


def _check_mesh(cfg, mesh) -> None:
    """Raise for what training across ranks does not cover yet (an SSM or
    hybrid config on a "model" axis above 1, an axis other than "data" and
    "model"), and for heads that do not divide over the "model" axis; before
    any collective."""
    if mesh is None:
        return
    other = {a: n for a, n in mesh.shape.items() if a not in ("data", "model") and n > 1}
    m = mesh.shape.get("model", 1)
    if other or (m > 1 and cfg.ssm):
        what = (f"mesh axes {other}" if other
                else f"{cfg.name} (family {cfg.family!r}) on a \"model\" axis of {m}")
        raise NotImplementedError(
            f"make_train_step on {what}: tensor-parallel training covers the dense and MoE "
            "decoders, the vision_stub configs and the encoders only; the SSM and hybrid "
            "configs are not ported yet (ROADMAP.md, section 1, module item 5b); train them "
            "data-parallel on an (n, 1) mesh")
    if m > 1 and cfg.n_heads % m:
        raise ValueError(f"make_train_step: {cfg.name}'s {cfg.n_heads} heads do not divide over "
                         f"the {m} ranks of the \"model\" axis")


class _Layout:
    """Where a step's gradients go across ranks: ``grad`` the shardings of
    ``grad_specs`` within the held parameters (None without them),
    ``moment`` the moments' (the global layout of the blocks the optimizer
    updates), ``params`` the parameters' as held (:func:`state_shardings`),
    ``within`` each moment block's place in the held parameter, ``owned``
    the parameters whose gradient is complete on this rank and is not
    summed (the expert-parallel route's experts)."""

    def __init__(self, cfg, tcfg, mesh, grad_specs):
        self.mesh = mesh
        self.data = mesh.axis("data")
        held = state_shardings(cfg, mesh, tcfg)
        self.moment, self.params = held["opt"]["m"], held["params"]
        self.within = {n: self.moment[n].within(self.params[n]) for n in self.params}
        self.owned = set(_expert_leaves(self.params) if cfg.moe and cfg.moe_ep_shardmap else ())
        self.grad = None if grad_specs is None else {
            n: sh.within(self.params[n]) for n, sh in shd.named(mesh, grad_specs).items()
            if n not in self.owned}

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
            want = tuple(self.within[n].local(p).shape)
            if tuple(opt["m"][n].shape) != want:
                raise ValueError(f"the moments of {n} are {tuple(opt['m'][n].shape)}, this "
                                 f"rank's block is {want}: cut the state with "
                                 "shard_train_state(state, state_shardings(...)) first")

    def reduce(self, name: str, summed, whole):
        """The gradient of ``name`` in the moments' layout, from ``summed``
        (this rank's rows' gradient, to sum over "data") and ``whole`` (the
        global gradient of rows every rank ran), either None, each in the
        held parameter's layout. An owned block's gradient is complete on
        this rank; a model-cut block's and a replicated leaf's are complete
        over "model" (the same on every model rank for the latter)."""
        if name in self.owned:  # rows over a "data" axis of one rank are not split
            return whole if summed is None else summed
        g_sh, m_sh = None if self.grad is None else self.grad[name], self.within[name]
        g, blk = None, None
        if summed is not None:
            cuts = [] if g_sh is None else [(d, a) for d, a in g_sh.cuts() if a == ("data",)]
            if cuts:  # the reduce-scatter onto grad_specs' block (one dim, over "data")
                (d, _), = cuts
                g = psum_scatter(summed, self.data, d, "dp")
                blk = shd.Sharding(self.mesh, shd.PartitionSpec(*[None] * d, "data"))
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
    model mesh the step is data-parallel, and tensor-parallel over a
    "model" axis above 1 (see the module's docstring): each
    microbatch of the global batch is cut into the ranks' rows, and
    ``grad_specs`` (``{name: PartitionSpec}``) reduce-scatters the
    gradients of the leaves it cuts over "data"."""
    mesh = get_mesh()
    _check_mesh(cfg, mesh)
    layout = (None if mesh is None or not mesh.member
              or mesh.shape["data"] == mesh.shape.get("model", 1) == 1
              else _Layout(cfg, tcfg, mesh, grad_specs))
    tp = SOLO if layout is None else mesh.axis("model")
    loss_whole = _loss_fn(cfg, tcfg, ops, SOLO, tp)
    loss_rows = None if layout is None else _loss_fn(cfg, tcfg, ops, layout.data, tp)

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
