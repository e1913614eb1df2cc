"""Instance-sharded execution on ``torch.distributed`` (DESIGN.md §7, §13):
the port's counterpart of ``repro.core.sharded``.

POTUS makes its dispatch decisions at each instance; here that is real.
Rows of the decision — one per source instance — are independent given the
global ``q_in``, so the schedule and the slot dynamics shard over a 1-D
mesh of ranks, each holding a contiguous block of instance rows for the
whole run. The reference is one controller over a device mesh
(``shard_map``); the port is SPMD: every rank of a process group calls the
same entry point with the same arguments and returns the same full result.
With no process group the world is one rank and every collective is the
identity (``distributed.context``).

* :func:`instance_mesh` takes the largest prefix of ranks whose count
  divides I; :func:`fleet_mesh` the (batch, instance) divisor pair using
  the most ranks, ties to the instance axis. Ranks past the prefix take no
  rows and receive the results by one broadcast (:meth:`Mesh.share`).
  Meshes are cut from the default process group, so every rank of it
  builds them together.
* :func:`sharded_schedule` / :func:`sharded_schedule_batch`: Algorithm 1 on
  this rank's rows after one all-gather of ``q_in``; X is gathered back so
  every rank returns it whole.
* :func:`run_sim_sharded` (``engine="sharded"``): the plain scan engine's
  dynamics on this rank's rows; per slot the ``q_in`` all-gather, the
  landing ``psum`` of the column sums and five scalar sums (four of them in
  the landing's ``psum``) — ``2I + 5`` elements in three collectives,
  nothing (I, I)-shaped crosses ranks.

Like the reference, both run the plain rows (``core.potus._price_rows`` and
``_allocate_rows``), not the schedule kernel, which computes whole (I, I)
problems. The sharded cohort-fused scan lives in ``core.cohort_fused`` next
to its dense twin; :func:`cohort_state_specs` records which axis of its
state is row-sharded and :func:`cohort_slot_payload_floats` its per-slot
payload. :data:`ROUTES` counts the route each sharded chunk took.
"""
from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..distributed.context import (PAYLOAD, SOLO, Axis, all_gather, grid_axes, psum,
                                   rank_device)
from ..obs.metrics import build_frame, compute_scan_streams, scan_stream_names
from ..obs.trace import span as obs_span
from .compact import _rows_add
from .network import NetworkCosts
from .potus import (SchedProblem, SlotCaps, _allocate_rows, _mandatory_dispatch, _price_rows,
                    apply_caps, hold_mask_for, make_problem)
from .queues import SimState, effective_qout, init_state, slot_update_rows
from .topology import Topology

__all__ = ["Mesh", "instance_mesh", "fleet_mesh", "sharded_schedule", "sharded_schedule_batch",
           "run_sim_sharded", "cohort_state_specs", "cohort_slot_payload_floats", "ROUTES",
           "route_counts"]

#: chunks of sharded cohort-fused runs by route: ``"kernel"`` (the slot
#: kernel, one-rank meshes only) or ``"compact"`` (the compact step with
#: collectives)
ROUTES: collections.Counter = collections.Counter()


def route_counts() -> dict:
    """:data:`ROUTES` of this process, as a plain dict."""
    return dict(ROUTES)


def cohort_state_specs() -> tuple:
    """The sharded axis of each of the fused cohort engine's seven state
    tensors (leading scenario axis first): 1 where the instance rows are
    split over the mesh for the whole scan, None where every rank holds the
    whole tensor — the response accumulators, which every rank folds from
    the same global completed mass, so no end-of-run gather is needed."""
    return (
        1,     # q_rem   (N, I, S, W+1)
        1,     # admit   (N, I, S)
        1,     # q_in    (N, I, Atot)
        1,     # q_out   (N, I, S, Atot)
        1,     # transit (N, I, Atot)
        None,  # resp_mass (N, C, L)
        None,  # resp_time (N, C, L)
    )


def cohort_slot_payload_floats(I: int, C: int, K: int, atot: int, n_shards: int) -> int:
    """Per-slot cross-rank payload of the sharded compact slot step, in
    elements (DESIGN.md §13): the (K, C) decision folds (candidate min and
    argmin, the owner pmin, the ``u_sum`` psum), the (I, Atot) landing psum
    (the physical tuple transfer), the (C, Atot) even-spread and served-mass
    folds, the (C,) alive counts under events and two scalar metrics. 0 on
    one shard, where every collective is the identity."""
    if n_shards <= 1:
        return 0
    return 4 * K * C + I * atot + 2 * C * atot + C + 2


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (batch, instance) mesh of ranks as this rank sees it: its two axes,
    whether it takes part (``member``) and whether some ranks of the world
    take no part (``idle``). A mesh is always a prefix of the ranks, so rank
    0 is its first."""

    i: Axis = SOLO
    b: Axis = SOLO
    member: bool = True
    idle: bool = False

    @property
    def shape(self) -> dict:
        return {"b": self.b.size, "i": self.i.size}

    def rows(self, n: int) -> slice:
        """This rank's block of ``n`` rows split along the instance axis."""
        n_local = n // self.i.size
        return slice(self.i.index * n_local, (self.i.index + 1) * n_local)

    def batch(self, n: int) -> slice:
        """This rank's block of ``n`` entries split along the batch axis."""
        n_local = n // self.b.size
        return slice(self.b.index * n_local, (self.b.index + 1) * n_local)

    def share(self, obj):
        """``obj`` of the mesh's first rank on every rank of the world: one
        broadcast when some ranks took no part, else ``obj`` itself."""
        if not self.idle:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]


def _mesh_of(n_batch_ranks: int, n_inst_ranks: int) -> Mesh:
    """The mesh over the first ``nb * ni`` ranks of the default group, rank
    ``r`` at (r // ni, r % ni) (``distributed.grid_axes``)."""
    b, i, member = grid_axes(n_batch_ranks, n_inst_ranks)
    idle = n_batch_ranks * n_inst_ranks < dist.get_world_size()
    return Mesh(i=i, b=b, member=member, idle=idle)


def instance_mesh(n_instances: int) -> Mesh:
    """1-D mesh over the largest prefix of ranks whose count divides ``I``
    (a world of one without a process group)."""
    if not dist.is_initialized():
        return Mesh()
    n = dist.get_world_size()
    while n > 1 and n_instances % n != 0:
        n -= 1
    return _mesh_of(1, n)


def fleet_mesh(n_instances: int, n_batch: int) -> Mesh:
    """2-D ``(batch, instance)`` mesh for the serving-fleet path (DESIGN.md
    §10): the divisor pair ``(nb | n_batch, ni | n_instances)`` using the
    most ranks, ties to instance sharding (it cuts the O(I²) price and
    decision memory). The 1-D instance mesh when ``n_batch == 1``."""
    if not dist.is_initialized():
        return Mesh()
    n = dist.get_world_size()
    best = (1, 1)
    for nb in range(1, n + 1):
        if n_batch % nb != 0:
            continue
        ni = n // nb
        while ni > 1 and n_instances % ni != 0:
            ni -= 1
        if nb * ni > best[0] * best[1] or (nb * ni == best[0] * best[1] and ni > best[1]):
            best = (nb, ni)
    return _mesh_of(*best)


def _check_divides(n_instances: int, mesh: Mesh) -> None:
    if n_instances % mesh.i.size != 0:
        raise ValueError(f"mesh size {mesh.i.size} does not divide I={n_instances}")


def _local_problem(prob: SchedProblem, rows: slice) -> SchedProblem:
    """This rank's rows of the problem: ``edge_mask``, ``gamma`` and
    ``is_spout`` by row; the column metadata (``inst_comp``,
    ``inst_container``, ``comp_count``) whole."""
    return dataclasses.replace(prob, edge_mask=prob.edge_mask[rows], gamma=prob.gamma[rows],
                               is_spout=prob.is_spout[rows])


def _local_rows(full: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's slice of a per-instance vector every rank holds whole."""
    n_local = full.shape[0] // axis.size
    return full[axis.index * n_local:(axis.index + 1) * n_local]


def _local_schedule(prob_l: SchedProblem, U, q_in_full, q_out, must_send, V, beta, method,
                    axis: Axis, caps: SlotCaps | None = None):
    """Algorithm 1 for this rank's rows ``prob_l``; returns X rows (I_loc,
    I) and their pair costs. ``caps`` carries a disruption slot with
    row-shaped ``mu``/``gamma``/``row_alive`` and the global ``alive``
    (every rank masks the whole column set alike; DESIGN.md §9)."""
    prob_l, must_send = apply_caps(prob_l, must_send, caps)
    kc = prob_l.inst_container.long()
    u_pair = U[_local_rows(kc, axis)[:, None], kc[None, :]]  # (I_loc, I)
    l = _price_rows(u_pair, q_in_full, q_out, prob_l.inst_comp, prob_l.edge_mask, V, beta)
    x = _allocate_rows(l, q_out, prob_l.gamma, prob_l.inst_comp, prob_l.n_components,
                       prob_l.max_succ, method)
    x = _mandatory_dispatch(x, must_send, prob_l.edge_mask, prob_l.inst_comp, prob_l.comp_count,
                            prob_l.n_components)
    return x, u_pair


def _gather_rows(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """The ranks' blocks of ``x`` concatenated along ``dim`` (an output
    replicated at the end of a call: tag ``"out"``)."""
    moved = all_gather(x.movedim(dim, 0), axis, tag="out")
    return moved.movedim(0, dim)


def sharded_schedule(mesh: Mesh | None, prob: SchedProblem, U, q_in, q_out, must_send, V, beta,
                     method: str = "sort") -> torch.Tensor:
    """One slot of Algorithm 1, row-sharded over ``mesh`` (None: the
    :func:`instance_mesh` of I). Every rank passes the whole problem and
    inputs (I,) / (I, C) and gets X (I, I) whole."""
    return sharded_schedule_batch(mesh, prob, U, q_in[None], q_out[None], must_send[None], V,
                                  beta, method=method)[0]


def sharded_schedule_batch(mesh: Mesh | None, prob: SchedProblem, U, q_in, q_out, must_send, V,
                           beta, method: str = "sort", caps=None) -> torch.Tensor:
    """A batch of independent Algorithm-1 slots on a :func:`fleet_mesh`
    (None: ``fleet_mesh(I, B)``):
    ``q_in`` (B, I), ``q_out`` and ``must_send`` (B, I, C), whole on every
    rank; returns X (B, I, I) whole. Each rank takes its block of batch
    entries and its block of rows; the ``q_in`` all-gather runs along the
    instance axis only, so batch entries never communicate.

    ``caps`` is one disruption slot per batch entry as a ``(mu, gamma,
    alive)`` triple of (B, I) tensors: ``mu``/``gamma`` go with the rows,
    ``alive`` stays whole (DESIGN.md §9). This is the route of
    ``DispatcherConfig(sharded=True)``."""
    B, I = q_in.shape
    mesh = mesh if mesh is not None else fleet_mesh(I, B)
    if B % mesh.b.size != 0:
        raise ValueError(f"batch {B} not divisible by mesh batch axis {mesh.b.size}")
    _check_divides(I, mesh)
    if not mesh.member:
        return mesh.share(None)
    rows, bs = mesh.rows(I), mesh.batch(B)
    prob_l = _local_problem(prob, rows)
    # the local row blocks, gathered again along the instance axis (the
    # reference's all-gather of the sharded q_in)
    q_in_full = all_gather(q_in[bs, rows].T, mesh.i).T  # (B_loc, I)
    xs = []
    for n, b in enumerate(range(B)[bs]):
        sc = None
        if caps is not None:
            mu_b, gamma_b, alive_b = (c[b] for c in caps)
            sc = SlotCaps(alive=alive_b, row_alive=alive_b[rows], mu=mu_b[rows],
                          gamma=gamma_b[rows])
        x, _ = _local_schedule(prob_l, U, q_in_full[n], q_out[b, rows], must_send[b, rows], V,
                               beta, method, mesh.i, caps=sc)
        xs.append(x)
    x = _gather_rows(_gather_rows(torch.stack(xs), mesh.i, 1), mesh.b, 0)
    return mesh.share(x)


def _local_sim_step(prob_l: SchedProblem, U, mu_l, sel_rows_l, comp_onehot, V, beta,
                    state: SimState, new_arr, caps: SlotCaps | None = None, *, axis: Axis,
                    method: str, metrics_spec=None):
    """One slot of the §3 dynamics on this rank's rows (cf.
    ``simulator.sim_step``). The metrics and the obs streams are global —
    psum'd scalars, the gathered ``q_in`` and the psum'd column sums — so
    every rank returns the same rows."""
    q_in_full = all_gather(state.q_in, axis)
    q_out = effective_qout(prob_l, state)  # every input row-local
    must_send = state.q_rem[:, :, 0]
    x, u_pair = _local_schedule(prob_l, U, q_in_full, q_out, must_send, V, beta, method, axis,
                                caps=caps)
    # one psum: the (I,) column sums (tuples landing everywhere), h(t) (eq. 12),
    # Theta(t) (eq. 11) and the two queue totals
    folded = psum(torch.cat([x.sum(dim=0), torch.stack([
        state.q_in.sum() + beta * q_out.sum(), (x * u_pair).sum(), state.q_in.sum(),
        q_out.sum()])]), axis)
    col_sums, (h, cost, q_in_total, q_out_total) = folded[:-4], folded[-4:].unbind()
    mu_eff = mu_l if caps is None else caps.mu
    hold = None if caps is None else hold_mask_for(prob_l, caps)
    new_state, info = slot_update_rows(state, x, _local_rows(col_sums, axis), new_arr, mu_eff,
                                       sel_rows_l, prob_l.is_spout, comp_onehot, hold_mask=hold)
    metrics = (h, cost, q_in_total, q_out_total, psum(info["served"].sum(), axis))
    if metrics_spec is not None:
        comp = torch.zeros(prob_l.n_components, dtype=torch.float32, device=h.device)
        ctx = {
            "h": h,
            "q_in": q_in_full,
            "price": V * U.mean(dim=0)[prob_l.inst_container.long()] + q_in_full,
            "landed": col_sums,
            "transit_total": psum(new_state.transit.sum(), axis, tag="obs"),
            "comp_backlog": _rows_add(comp, prob_l.inst_comp.long(), q_in_full),
        }
        metrics = metrics + compute_scan_streams(scan_stream_names(metrics_spec), ctx)
    return new_state, metrics


def run_sim_sharded(topo: Topology, net: NetworkCosts, inst_container: np.ndarray,
                    arrivals: np.ndarray, T: int, cfg, mu: np.ndarray | None = None,
                    mesh: Mesh | None = None, events=None, metrics=None, device="cuda"):
    """The plain scan engine's semantics on an instance mesh (DESIGN.md §7),
    ``engine="sharded"``: POTUS only (``potus`` or ``potus-loop``), every
    rank's rows on its own device (``distributed.context.rank_device``),
    the whole horizon's arrival rows moved to the device once. Returns the
    same :class:`~repro_torch.core.simulator.SimResult` on every rank, its
    final state gathered whole; the ``payload`` stream is the elements the
    slots' collectives moved, per slot (``2I + 5`` on more than one rank).
    ``use_pallas`` and ``chunk`` do not apply (``simulate`` rejects them)."""
    from .simulator import (_POTUS_METHODS, SimResult, _check_mu_override, _StreamRows,
                            host_trace, pad_arrivals)

    _check_mu_override(mu, events)
    if cfg.scheduler not in _POTUS_METHODS:
        raise ValueError(f"sharded engine only runs POTUS, got {cfg.scheduler!r}")
    mesh = mesh if mesh is not None else instance_mesh(topo.n_instances)
    _check_divides(topo.n_instances, mesh)
    if not mesh.member:
        return mesh.share(None)
    device = rank_device(resolve_device(device))
    f32 = dict(dtype=torch.float32, device=device)
    W = cfg.window
    arrivals = pad_arrivals(np.asarray(arrivals), T + W + 1)
    rows, axis = mesh.rows(topo.n_instances), mesh.i

    def local(x):  # this rank's rows of a host array, on the device
        return torch.as_tensor(np.ascontiguousarray(x[..., rows, :]), **f32)

    prob_l = make_problem(topo, net, inst_container, device, rows=rows)
    full = init_state(topo, W, arrivals[: W + 1], device)
    state = SimState(*(getattr(full, f.name)[rows] for f in dataclasses.fields(SimState)))
    window_stream = local(np.asarray(arrivals[W + 1: T + W + 1], np.float32))
    ev_host = host_trace(events, T)
    ev = None if ev_host is None else tuple(torch.as_tensor(e, **f32) for e in ev_host)
    mu_l = torch.as_tensor(mu if mu is not None else topo.inst_mu, **f32)[rows]
    sel_rows_l = torch.as_tensor(topo.selectivity[topo.inst_comp], **f32)[rows]
    U = torch.as_tensor(net.U, **f32)
    comp_onehot = torch.nn.functional.one_hot(prob_l.inst_comp.long(),
                                              prob_l.n_components).to(torch.float32)
    V, beta = float(cfg.V), float(cfg.beta)
    method = _POTUS_METHODS[cfg.scheduler]
    per_slot = torch.empty((T, 5), **f32)
    streams = _StreamRows(T)
    moved = PAYLOAD.n()
    with obs_span("potus/sharded/scan", T=T, n_shards=axis.size):
        for k in range(T):
            caps = None
            if ev is not None:  # capacities go with the rows, liveness stays whole
                caps = SlotCaps(alive=ev[2][k], row_alive=ev[2][k][rows], mu=ev[0][k][rows],
                                gamma=ev[1][k][rows])
            state, met = _local_sim_step(prob_l, U, mu_l, sel_rows_l, comp_onehot, V, beta,
                                         state, window_stream[k], caps, axis=axis,
                                         method=method, metrics_spec=metrics)
            per_slot[k] = torch.stack(met[:5])
            streams.put(k, met[5:])
    moved = PAYLOAD.n() - moved
    final = SimState(*(_gather_rows(getattr(state, f.name), axis, 0).cpu().numpy()
                       for f in dataclasses.fields(SimState)))
    per_slot = per_slot.cpu().numpy()
    frame = None
    if metrics is not None:
        frame = build_frame(metrics, [r.cpu().numpy() for r in streams.split()], n_slots=T,
                            payload_floats=moved / max(T, 1))
    result = SimResult(backlog=per_slot[:, 0].copy(), comm_cost=per_slot[:, 1].copy(),
                       q_in_total=per_slot[:, 2].copy(), q_out_total=per_slot[:, 3].copy(),
                       served_total=per_slot[:, 4].copy(), final_state=final, metrics=frame)
    return mesh.share(result)
