"""The slot kernel's decomposition (``csrc/potus_slot.cu``), stated in plain
PyTorch on the CPU and held bitwise against the reference's
``compact_slot_step`` on the dyadic system of ``tests/test_potus_slot.py:44``.

:func:`design_slot` runs one slot the way the CUDA kernel does, with its
fixed reduction orders written out:

* sums across a row's buckets or components: each lane of the row's warp
  adds the elements ``lane, lane + 32, ...`` in order, then a shuffle tree
  into lane 0 (:func:`lane_sum`);
* the oldest-first drains of service and shipping: inclusive Kogge-Stone
  scans across the buckets, 32 at a time, plus the carry of the rounds
  before (:func:`lane_scan`);
* the per-container partials of landing and served mass: each of the
  container block's eight warps sums its rows (``w, w + 8, ...`` of the
  container's ascending rows) in order, then a fixed tree over the warps;
* landing: each target written once, by the first container whose target
  it is, summing the containers' partials in ascending order; the even
  spread and served mass per component over the containers in ascending
  order;
* the slot metrics: per-block sums over the block's eight rows in order,
  then a 256-thread strided sum and a halving tree over the blocks.

On the dyadic tier every quantity is a dyadic rational, so these orders
give the reference's numbers exactly: the match is bitwise, for POTUS,
Shuffle and JSQ over 40 slots.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from test_torch_compact import AGE_CAP, T, _port_inputs, _ref_run

torch.set_num_threads(1)

LANES = 32
ROW_WARPS = 8     # rows (one warp each) per block of the row kernels
GROUP_WARPS = 8   # warps of a container block
BLOCK = 256       # threads of the fold and metric blocks
_BIG = 1e30


def lane_sum(x):
    """Sum over the last axis as a warp takes it: per-lane sums of the
    elements ``lane, lane + 32, ...`` in order, then the shuffle tree."""
    n = x.shape[-1]
    R = max(1, -(-n // LANES))
    v = F.pad(x, (0, R * LANES - n)).reshape(*x.shape[:-1], R, LANES)
    acc = torch.zeros((*x.shape[:-1], LANES), dtype=x.dtype)
    for r in range(R):
        acc = acc + v[..., r, :]
    for o in (16, 8, 4, 2, 1):  # lane l += lane l + o; lane 0 holds the total
        acc = acc[..., :o] + acc[..., o:2 * o]
    return acc[..., 0]


def lane_scan(x):
    """Inclusive prefix sums over the last axis: rounds of 32 buckets, a
    Kogge-Stone scan in each, plus the carry of the rounds before."""
    n = x.shape[-1]
    R = max(1, -(-n // LANES))
    v = F.pad(x, (0, R * LANES - n)).reshape(*x.shape[:-1], R, LANES)
    carry = torch.zeros(x.shape[:-1], dtype=x.dtype)
    out = []
    for r in range(R):
        s = v[..., r, :]
        for o in (1, 2, 4, 8, 16):  # lane l >= o: s[l - o] + s[l]
            s = torch.cat([s[..., :o], s[..., :LANES - o] + s[..., o:]], dim=-1)
        out.append(carry[..., None] + s)
        carry = carry + s[..., LANES - 1]
    return torch.cat(out, dim=-1)[..., :n]


def drain(x, amount):
    """Mass drained oldest-first from the buckets ``x`` (last axis)."""
    cum = lane_scan(x)
    return torch.minimum(torch.clamp_min(amount[..., None] - (cum - x), 0.0), x)


def block_tree(x, nt=BLOCK):
    """Sum of ``x`` (n,) by ``nt`` threads: thread j adds ``x[j], x[j + nt],
    ...`` in order, then a halving tree."""
    n = x.shape[0]
    R = max(1, -(-n // nt))
    v = F.pad(x, (0, R * nt - n)).reshape(R, nt)
    acc = torch.zeros(nt, dtype=x.dtype)
    for r in range(R):
        acc = acc + v[r]
    h = nt // 2
    while h:
        acc = acc[:h] + acc[h:2 * h]
        h //= 2
    return acc[0]


def row_blocks(vals):
    """The per-block partials of a row value (warps in order), then their tree."""
    I = vals.shape[0]
    nblk = -(-I // ROW_WARPS)
    v = F.pad(vals, (0, nblk * ROW_WARPS - I)).reshape(nblk, ROW_WARPS)
    part = torch.zeros(nblk, dtype=vals.dtype)
    for w in range(ROW_WARPS):
        part = part + v[:, w]
    return block_tree(part)


def shift(x):
    """Age b+1 -> b on the last axis; the oldest bucket saturates."""
    return torch.cat([x[..., 0:1] + x[..., 1:2], x[..., 2:], torch.zeros_like(x[..., :1])], -1)


def _fold(c, qin, scheduler):
    """M, J, u_sum per (container, component); JSQ's winners."""
    NK, C, I = c.U.shape[0], c.adj_rows.shape[1], qin.shape[0]
    cont = c.inst_cont.long()
    M = torch.full((NK, C), _BIG)
    J = torch.full((NK, C), I, dtype=torch.long)
    usum = torch.zeros((NK, C))
    winner, win_ok = torch.zeros(C, dtype=torch.long), torch.zeros(C, dtype=torch.bool)
    for comp in range(C):
        lo, hi = int(c.comp_start[comp]), int(c.comp_start[comp + 1])
        if hi > lo:
            u = c.U[:, cont[lo:hi]]  # (NK, n)
            t1 = c.V * u + qin[None, lo:hi]
            M[:, comp] = t1.min(dim=1).values
            J[:, comp] = lo + (t1 == M[:, comp:comp + 1]).int().argmax(dim=1)  # lowest index
            qv = qin[lo:hi]
            winner[comp] = lo + int((qv == qv.min()).int().argmax())
            win_ok[comp] = True
        for k in range(NK):
            usum[k, comp] = block_tree(c.U[k, cont[lo:hi]])
    return M, J, usum, winner, win_ok


def _decide(c, scheduler, q_out_arr, must, M, J, usum, winner, win_ok):
    """(ship, point weight, even weight) per (row, component) and the row costs."""
    I, C = q_out_arr.shape
    cont = c.inst_cont.long()
    edge = c.adj_rows > 0
    cc = c.comp_count[None, :]
    g = c.gamma[:, None]
    if scheduler == "potus":
        m_raw = M[cont] - c.beta * q_out_arr
        cand = edge & (m_raw < 0)
        m = torch.where(cand, m_raw, torch.inf)
        jc = torch.where(edge, J[cont], I)
        bud = torch.where(cand, torch.clamp_min(q_out_arr, 0.0), 0.0)
        before = torch.zeros((I, C))
        for d in range(C):  # in ascending d, as each lane walks them
            prec = (m[:, d:d + 1] < m) | ((m[:, d:d + 1] == m) & (jc[:, d:d + 1] < jc))
            before = before + torch.where(prec, bud[:, d:d + 1], 0.0)
        after = before + bud
        fill = torch.minimum(after, g) - torch.minimum(before, g)
        sf = torch.where(edge & (cc > 0), torch.clamp_min(must - fill, 0.0), 0.0)
        ev = sf / torch.clamp_min(cc, 1.0)
        kj = torch.where(jc < I, cont[torch.clamp_max(jc, I - 1)], 0)
        ca = fill * c.U[cont[:, None], kj]
        cb = ev * usum[cont]
        ship, point, even = fill + sf, fill, ev
    else:
        total = lane_sum(q_out_arr)[:, None]
        scale = torch.where(total > 0, torch.clamp_max(g / torch.clamp_min(total, 1e-9), 1.0),
                            0.0)
        sh = torch.maximum(q_out_arr * scale, must)
        if scheduler == "shuffle":
            pt = torch.where(edge & (cc > 0), sh / torch.clamp_min(cc, 1.0), 0.0)
            ca = pt * usum[cont]
            ship, point, even = pt * cc, torch.zeros_like(pt), pt
        else:
            ship = torch.where(edge & win_ok[None, :], sh, 0.0)
            ca = ship * c.U[cont[:, None], cont[winner][None, :]]
            point, even = ship, torch.zeros_like(ship)
        cb = torch.zeros_like(ca)
    sh_safe = torch.where(ship > 0, ship, 1.0)
    live = ship > 1e-12
    wpt = torch.where(live, point / sh_safe, 0.0)
    wev = torch.where(live, even / sh_safe, 0.0)
    return ship, wpt, wev, lane_sum(ca), lane_sum(cb)


def design_slot(c, state, act_t, pred_t, nxt_t, t, scheduler, age_cap):
    """One slot of the cohort dynamics in the slot kernel's orders; returns
    ``(state, (backlog, cost, capped, served))``."""
    q_rem, admit, q_in, q_out, transit, rmass, rtime = (x.clone() for x in state)
    I, S, W1 = q_rem.shape
    A = q_in.shape[-1]
    C, NK = c.adj_rows.shape[1], c.U.shape[0]
    ac = age_cap
    succ, comp = c.succ_map.long(), c.inst_comp.long()
    has = succ < C
    sc = torch.clamp_max(succ, C - 1)
    rows = torch.arange(I)
    sp = c.spout_f
    bo = 1.0 - sp
    spout = (sp > 0)[:, None]

    # observe: reconcile window position 0, observe the queues
    qin = lane_sum(q_in)
    pm = (torch.where(has, pred_t.gather(1, sc), 0.0) * c.valid_cmp) * c.stream_cmp
    am = (torch.where(has, act_t.gather(1, sc), 0.0) * c.valid_cmp) * c.stream_cmp
    tp = torch.minimum(pm, am)
    tn = am - tp
    r = torch.where(pm > 0, q_rem[:, :, 0] / torch.where(pm > 0, pm, 1.0), 0.0)
    q_rem[:, :, 0] = r * tp + tn
    qo_s = torch.where(spout, lane_sum(q_rem), lane_sum(q_out))
    q_out_arr, must = torch.zeros((I, C)), torch.zeros((I, C))
    for s in range(S):  # distinct successors of a row: no two terms meet
        hs = has[:, s]
        q_out_arr[rows[hs], succ[hs, s]] += qo_s[hs, s]
        must[rows[hs], succ[hs, s]] += ((q_rem[:, s, 0] + admit[:, s]) * sp)[hs]
    backlog_parts = (row_blocks(qin), row_blocks(lane_sum(q_out_arr)))

    # fold, then rows_b: decide, serve, drain, shift
    M, J, usum, winner, win_ok = _fold(c, qin, scheduler)
    ship, wpt, wev, cost_a, cost_b = _decide(c, scheduler, q_out_arr, must, M, J, usum, winner,
                                             win_ok)
    cost = row_blocks(cost_a) + row_blocks(cost_b)
    av = q_in + transit
    amt = torch.minimum(lane_sum(av), c.mu * c.inv_service) * bo
    sb = drain(av, amt)
    served_term = sb * c.term_f[:, None]
    q_in = shift((av - sb) * bo[:, None])
    d_land = torch.zeros((I, S, A))
    for s in range(S):
        adm = admit[:, s]
        src_spout = torch.cat([torch.zeros((I, ac)), q_rem[:, s], adm[:, None]], -1)
        src_bolt = torch.cat([q_out[:, s], torch.zeros((I, 1))], -1)
        xb = torch.where(spout, src_spout, src_bolt)
        amount = torch.where(has[:, s], ship.gather(1, sc[:, s:s + 1])[:, 0], 0.0) \
            * c.valid_cmp[:, s]
        dr = drain(xb, amount)
        d_land[:, s] = dr[:, :A]
        d_land[:, s, ac] = dr[:, ac] + dr[:, A]
        wb = torch.where(spout, q_rem[:, s] - dr[:, ac:A] * sp[:, None], q_rem[:, s])
        add = (sb * c.sel_cmp[:, s:s + 1]) * bo[:, None]
        vb = torch.where(spout, q_out[:, s] + add, (xb[:, :A] - dr[:, :A] * bo[:, None]) + add)
        q_out[:, s] = shift(vb)
        new = (torch.where(has[:, s], nxt_t.gather(1, sc[:, s:s + 1])[:, 0], 0.0)
               * c.valid_cmp[:, s]) * c.stream_cmp[:, s]
        q_rem[:, s] = torch.cat([wb[:, 1:], new[:, None]], -1)
        admit[:, s] = torch.where(sp > 0, adm - dr[:, A] * sp, adm) + wb[:, 0] * sp

    # group: per container, per-warp partials over the warp's rows, a tree over the warps
    P = torch.zeros((3, NK, C, A))
    for k in range(NK):
        ks = c.cont_rows[int(c.cont_start[k]):int(c.cont_start[k + 1])].long()
        part = torch.zeros((GROUP_WARPS, 3, C, A))
        for pos, i in enumerate(ks.tolist()):
            w = pos % GROUP_WARPS
            for s in range(S):
                if has[i, s]:
                    c2 = int(succ[i, s])
                    part[w, 0, c2] = part[w, 0, c2] + wpt[i, c2] * d_land[i, s]
                    part[w, 1, c2] = part[w, 1, c2] + wev[i, c2] * d_land[i, s]
            part[w, 2, comp[i]] = part[w, 2, comp[i]] + served_term[i]
        h = GROUP_WARPS // 2
        while h:
            part = part[:h] + part[h:2 * h]
            h //= 2
        P[:, k] = part[0]

    # reduce: landing per target, even spread and served mass per component
    if scheduler == "potus":
        target = J
    elif scheduler == "jsq":
        target = torch.where(win_ok, winner, I)[None, :].expand(NK, C)
    else:
        target = torch.full((NK, C), I, dtype=torch.long)
    land = torch.zeros((I, A))
    for cc_ in range(C):
        done = set()
        for k in range(NK):
            tgt = int(target[k, cc_])
            if tgt >= I or tgt in done:
                continue
            done.add(tgt)
            acc = torch.zeros(A)
            for k2 in range(k, NK):
                if int(target[k2, cc_]) == tgt:
                    acc = acc + P[0, k2, cc_]
            land[tgt] = acc
    ev_cb, cmass = torch.zeros((C, A)), torch.zeros((C, A))
    for k in range(NK):
        ev_cb = ev_cb + P[1, k]
        cmass = cmass + P[2, k]
    cols = slice(t, t + A)
    rmass[:, cols] = rmass[:, cols] + cmass
    rtime[:, cols] = rtime[:, cols] + cmass * torch.clamp_min(ac - torch.arange(A), 0.0)
    transit = shift(land + ev_cb[comp])

    # the slot's metrics
    flat = cmass.reshape(-1)
    at_zero = torch.where(torch.arange(C * A) % A == 0, flat, 0.0)
    met = (backlog_parts[0] + c.beta * backlog_parts[1], cost, block_tree(at_zero),
           block_tree(flat))
    return (q_rem, admit, q_in, q_out, transit, rmass, rtime), met


@pytest.mark.parametrize("scheduler", ["potus", "shuffle", "jsq"])
def test_design_slot_bitwise_against_reference(scheduler):
    """40 slots of the design on the dyadic system against the reference's
    compact step (``kernel_safe=True``, the arithmetic the kernel replaces)."""
    ref_state, ref_met = _ref_run(scheduler, "xla-kernel-safe", False)
    consts, state, (act, pred, nxt) = _port_inputs(False)
    mets = []
    for t in range(T):
        state, m = design_slot(consts, state, act[t], pred[t], nxt[t], t, scheduler, AGE_CAP)
        mets.append(torch.stack(m))
    np.testing.assert_array_equal(torch.stack(mets, dim=1).numpy(), ref_met)
    for x, y in zip(state, ref_state):
        np.testing.assert_array_equal(x.numpy(), y)


def test_lane_orders_on_exact_values():
    """The warp sum and the rounds-of-32 scan give the plain sums on exact
    values, across round boundaries (69 and 70 buckets, the fleet's)."""
    rng = np.random.default_rng(1)
    for n in (5, 32, 69, 70, 100):
        x = torch.from_numpy(rng.integers(-8, 9, (7, n)).astype(np.float32) / 4)
        assert torch.equal(lane_sum(x), x.sum(-1))
        assert torch.equal(lane_scan(x), torch.cumsum(x, -1))
        assert torch.equal(block_tree(x[0]), x[0].sum())
