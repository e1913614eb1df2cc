// Hand-written Hopper (sm_90a) kernels for one POTUS cohort slot, K slots per call.
//
// Replaces the TPU kernel src/repro/kernels/potus_slot.py:57 potus_slot_kernel, whose body is
// src/repro/core/compact.py compact_slot_step(kernel_safe=True): window reconcile, the (K, C)
// cheapest-candidate min/argmin, the precedence-rank water-fill of gamma, the mandatory even
// split, the oldest-first drain and point landing, service up to mu, the age shift with
// age_cap saturation, the (C, T+Atot) response accumulators and the per-slot metrics
// (backlog, cost, capped, served). The plain version of the same function is
// repro_torch.core.compact.compact_slot_step(kernel_safe=True).
//
// Why the TPU layout does not carry over: the TPU version keeps all queue state of the slot in
// one program's VMEM. At I=16384 and Atot=69 the output queues q_out (I, S, Atot) alone are
// 4.5 MB, against 227 KB of shared memory per SM, and the slot has grid-wide folds in the
// middle (the (K, C) min/argmin over every instance before the water-fill; the landing, the
// even-spread and the served-mass sums after it). So a slot here is a short sequence of phase
// kernels on one stream, one thread per instance row for row-local work:
//   p1 observe/reconcile (rows)      p2 fold: min/argmin and u_sum per (component, container)
//   p3 decide (rows)                 p4 drain and serve, age shift (rows)
//   p5 group: per-container partial sums of landing, even spread and served mass
//   p6 reduce: landing per target, even spread and served mass per component, accumulators
//   p7 transit (rows)                p8 slot metrics (one block)
//
// What bounds it on this card: bytes. Each phase streams the (I, ., Atot) queue state once;
// the arithmetic is a few hundred operations per row. The design keeps the state in place in
// the output buffers (one device copy in per call), keeps every intermediate at O(I*C) or
// O(K*C*Atot), and never forms an (I, I) tensor.
//
// Every float reduction has one fixed order, so a run is bitwise reproducible: row sums run
// sequentially in index order; per-component sums run per (container, component) in ascending
// row order and then over containers in ascending order; whole-fleet sums use a fixed
// block-tree. Nothing accumulates a float with an atomic. Landing is a scatter in the plain
// version: here each target is written by exactly one block, the first container whose
// cheapest candidate it is, which sums the containers' partials in ascending order.
// Build with --fmad=false so that a*b+c rounds twice, as the plain version does.
// The kernels are f32 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#ifndef POTUS_ROW_THREADS
#define POTUS_ROW_THREADS 128
#endif
#ifndef POTUS_RED_THREADS
#define POTUS_RED_THREADS 256  // a power of two: the block trees halve it
#endif
#define POTUS_MAXC 64          // most components the row kernels hold (checked by the wrapper)
#define POTUS_BIG 1e30f        // finite stand-in for +inf, as compact.py's _BIG

enum { SCHED_POTUS = 0, SCHED_SHUFFLE = 1, SCHED_JSQ = 2 };

// One struct carries every pointer and size; the wrapper fills it (ctypes mirror in
// repro_torch/kernels/potus_slot.py) and every kernel takes it by value.
struct PotusSlotArgs {
    // slot-invariant constants
    const float* U;            // (NK, NK)
    const float* mu;           // (I,)
    const float* inv_service;  // (I,)
    const float* sel;          // (I, S)
    const float* stream;       // (I, S)
    const float* valid;        // (I, S)
    const int* succ;           // (I, S), C = no successor
    const float* term;         // (I,)
    const int* inst_comp;      // (I,)
    const int* inst_cont;      // (I,)
    const float* gamma;        // (I,)
    const float* comp_count;   // (C,)
    const float* spout;        // (I,)
    const float* adj;          // (I, C)
    const float* vb;           // (2,) V, beta
    const int* comp_start;     // (C+1,) instance range of each component
    const int* cont_rows;      // (I,) instances grouped by container, ascending
    const int* cont_start;     // (NK+1,) each container's span of cont_rows
    // n_slots slots of arrivals, (n_slots, I, C) each
    const float* act;
    const float* pred;
    const float* nxt;
    // state in
    const float* q_rem_in;     // (I, S, W1)
    const float* admit_in;     // (I, S)
    const float* q_in_in;      // (I, Atot)
    const float* q_out_in;     // (I, S, Atot)
    const float* transit_in;   // (I, Atot)
    const float* rmass_in;     // (C, L)
    const float* rtime_in;     // (C, L)
    // state out, updated in place after one copy of the state in
    float* q_rem;
    float* admit;
    float* q_in;
    float* q_out;
    float* transit;
    float* rmass;
    float* rtime;
    float* met;                // (4, n_slots): backlog, cost, capped, served
    // scratch
    float* q_in_arr;           // (I,)
    float* q_out_arr;          // (I, C)
    float* must;               // (I, C)
    float* row_bl;             // (2, I)
    float* row_cost;           // (2, I)
    float* M;                  // (NK, C)
    int* J;                    // (NK, C)
    float* usum;               // (NK, C)
    int* winner;               // (C,)
    int* win_ok;               // (C,)
    float* shipped;            // (I, C)
    float* w_pt;               // (I, C)
    float* w_ev;               // (I, C)
    float* d_land;             // (I, S, Atot)
    float* served_term;        // (I, Atot)
    float* P_pt;               // (NK, C, Atot)
    float* P_ev;               // (NK, C, Atot)
    float* CM;                 // (NK, C, Atot)
    float* land;               // (I, Atot)
    float* ev_cb;              // (C, Atot)
    float* cmass;              // (C, Atot)
    void* stream_handle;       // cudaStream_t of the caller
    int I, S, W1, C, NK, Atot, L, age_cap, n_slots, t0, sched;
};

// -- p1: reconcile window position 0 with this slot's actual arrivals; observe the queues ----
__global__ void potus_p1_observe(PotusSlotArgs a, int slot) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.I) return;
    const int S = a.S, C = a.C, W1 = a.W1, A = a.Atot;
    const float* act = a.act + (size_t)slot * a.I * C + (size_t)i * C;
    const float* pred = a.pred + (size_t)slot * a.I * C + (size_t)i * C;
    float* qoa = a.q_out_arr + (size_t)i * C;
    float* must = a.must + (size_t)i * C;
    float qin = 0.f;
    for (int b = 0; b < A; ++b) qin += a.q_in[(size_t)i * A + b];
    for (int c = 0; c < C; ++c) { qoa[c] = 0.f; must[c] = 0.f; }
    const float sp = a.spout[i];
    for (int s = 0; s < S; ++s) {
        const int is = i * S + s;
        const int c2 = a.succ[is];
        const float v = a.valid[is], st = a.stream[is];
        const float pm = ((c2 < C ? pred[c2] : 0.f) * v) * st;
        const float am = ((c2 < C ? act[c2] : 0.f) * v) * st;
        const float tp = fminf(pm, am);
        const float tn = am - tp;
        float* qr = a.q_rem + (size_t)is * W1;
        const float r = pm > 0.f ? qr[0] / pm : 0.f;
        const float q0 = r * tp + tn;
        qr[0] = q0;
        float qo = 0.f;
        if (sp > 0.f) {
            for (int w = 0; w < W1; ++w) qo += qr[w];
        } else {
            const float* qq = a.q_out + (size_t)is * A;
            for (int b = 0; b < A; ++b) qo += qq[b];
        }
        if (c2 < C) {
            qoa[c2] += qo;
            must[c2] += (q0 + a.admit[is]) * sp;
        }
    }
    float qsum = 0.f;
    for (int c = 0; c < C; ++c) qsum += qoa[c];
    a.q_in_arr[i] = qin;
    a.row_bl[i] = qin;
    a.row_bl[a.I + i] = qsum;
    for (int b = 0; b < A; ++b) a.land[(size_t)i * A + b] = 0.f;
}

// -- p2: per (component c, container k) cheapest candidate M, J (lowest index on ties) and
//        the alive-column sum u_sum; for JSQ also the per-component shortest queue ----------
__global__ void potus_p2_fold(PotusSlotArgs a) {
    __shared__ float sv[POTUS_RED_THREADS];
    __shared__ int sj[POTUS_RED_THREADS];
    __shared__ float su[POTUS_RED_THREADS];
    const int c = blockIdx.x, k = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
    const int lo = a.comp_start[c], hi = a.comp_start[c + 1];
    const float V = a.vb[0];
    const float* Uk = a.U + (size_t)k * a.NK;
    float bv = INFINITY, us = 0.f;
    int bj = a.I;
    for (int j = lo + tid; j < hi; j += nt) {
        const float u = Uk[a.inst_cont[j]];
        const float t1 = V * u + a.q_in_arr[j];
        if (t1 < bv || (t1 == bv && j < bj)) { bv = t1; bj = j; }
        us += u;
    }
    sv[tid] = bv; sj[tid] = bj; su[tid] = us;
    __syncthreads();
    for (int h = nt / 2; h > 0; h >>= 1) {
        if (tid < h) {
            const float ov = sv[tid + h];
            const int oj = sj[tid + h];
            if (ov < sv[tid] || (ov == sv[tid] && oj < sj[tid])) { sv[tid] = ov; sj[tid] = oj; }
            su[tid] += su[tid + h];
        }
        __syncthreads();
    }
    if (tid == 0) {
        const int kc = k * a.C + c;
        a.M[kc] = sj[0] < a.I ? sv[0] : POTUS_BIG;
        a.J[kc] = sj[0];
        a.usum[kc] = su[0];
    }
    if (a.sched == SCHED_JSQ && k == 0) {  // uniform over the block
        __syncthreads();
        float qv = INFINITY;
        int qj = a.I;
        for (int j = lo + tid; j < hi; j += nt) {
            const float q = a.q_in_arr[j];
            if (q < qv || (q == qv && j < qj)) { qv = q; qj = j; }
        }
        sv[tid] = qv; sj[tid] = qj;
        __syncthreads();
        for (int h = nt / 2; h > 0; h >>= 1) {
            if (tid < h) {
                const float ov = sv[tid + h];
                const int oj = sj[tid + h];
                if (ov < sv[tid] || (ov == sv[tid] && oj < sj[tid])) { sv[tid] = ov; sj[tid] = oj; }
            }
            __syncthreads();
        }
        if (tid == 0) {
            a.winner[c] = sj[0] < a.I ? sj[0] : 0;
            a.win_ok[c] = sj[0] < a.I ? 1 : 0;
        }
    }
}

__device__ __forceinline__ void potus_store_decision(const PotusSlotArgs& a, int i, int c,
                                                     float shipped, float point, float even) {
    const size_t ic = (size_t)i * a.C + c;
    const float sh_safe = shipped > 0.f ? shipped : 1.f;
    const bool live = shipped > 1e-12f;
    a.shipped[ic] = shipped;
    a.w_pt[ic] = live ? point / sh_safe : 0.f;
    a.w_ev[ic] = live ? even / sh_safe : 0.f;
}

// -- p3: the compact decision of each row: rank water-fill, even split, cost terms ----------
__global__ void potus_p3_decide(PotusSlotArgs a) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.I) return;
    const int C = a.C, I = a.I;
    const int k = a.inst_cont[i];
    const float g = a.gamma[i], beta = a.vb[1];
    const float* Uk = a.U + (size_t)k * a.NK;
    const float* qo = a.q_out_arr + (size_t)i * C;
    const float* ms = a.must + (size_t)i * C;
    const float* adj = a.adj + (size_t)i * C;
    float cost_a = 0.f, cost_b = 0.f;
    if (a.sched == SCHED_POTUS) {
        float m[POTUS_MAXC], bud[POTUS_MAXC];
        int jc[POTUS_MAXC];
        for (int c = 0; c < C; ++c) {
            const int kc = k * C + c;
            const bool edge = adj[c] > 0.f;
            const float m_raw = a.M[kc] - beta * qo[c];
            const bool cand = edge && m_raw < 0.f;
            m[c] = cand ? m_raw : INFINITY;
            jc[c] = edge ? a.J[kc] : I;
            bud[c] = cand ? fmaxf(qo[c], 0.f) : 0.f;
        }
        for (int e = 0; e < C; ++e) {
            float before = 0.f;
            for (int d = 0; d < C; ++d)
                if (m[d] < m[e] || (m[d] == m[e] && jc[d] < jc[e])) before += bud[d];
            const float after = before + bud[e];
            const float fill = fminf(after, g) - fminf(before, g);
            const float cc = a.comp_count[e];
            const float sf = (adj[e] > 0.f && cc > 0.f) ? fmaxf(ms[e] - fill, 0.f) : 0.f;
            const float ev = sf / fmaxf(cc, 1.f);
            const int kj = jc[e] < I ? a.inst_cont[jc[e]] : 0;
            cost_a += fill * Uk[kj];
            cost_b += ev * a.usum[k * C + e];
            potus_store_decision(a, i, e, fill + sf, fill, ev);
        }
    } else {
        float total = 0.f;
        for (int c = 0; c < C; ++c) total += qo[c];
        const float scale = total > 0.f ? fminf(g / fmaxf(total, 1e-9f), 1.f) : 0.f;
        for (int c = 0; c < C; ++c) {
            const float ship = fmaxf(qo[c] * scale, ms[c]);
            const bool edge = adj[c] > 0.f;
            if (a.sched == SCHED_SHUFFLE) {
                const float cc = a.comp_count[c];
                const float pt = (edge && cc > 0.f) ? ship / fmaxf(cc, 1.f) : 0.f;
                cost_a += pt * a.usum[k * C + c];
                potus_store_decision(a, i, c, pt * cc, 0.f, pt);
            } else {
                const float sh = (edge && a.win_ok[c]) ? ship : 0.f;
                cost_a += sh * Uk[a.inst_cont[a.winner[c]]];
                potus_store_decision(a, i, c, sh, sh, 0.f);
            }
        }
    }
    a.row_cost[i] = cost_a;
    a.row_cost[I + i] = cost_b;
}

// -- p4: drain oldest-first, serve bolts, admit leftovers, shift windows and ages ------------
__global__ void potus_p4_drain_serve(PotusSlotArgs a, int slot) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= a.I) return;
    const int S = a.S, C = a.C, W1 = a.W1, A = a.Atot, ac = a.age_cap;
    const float sp = a.spout[i], bo = 1.f - sp;
    for (int s = 0; s < S; ++s) {
        const int is = i * S + s;
        const int c2 = a.succ[is];
        const float amount = (c2 < C ? a.shipped[(size_t)i * C + c2] : 0.f) * a.valid[is];
        float* qr = a.q_rem + (size_t)is * W1;
        float* qo = a.q_out + (size_t)is * A;
        float* dl = a.d_land + (size_t)is * A;
        float cum = 0.f, d_ac = 0.f;
        for (int b = 0; b <= A; ++b) {  // bucket A is the admission backlog
            float x;
            if (sp > 0.f) x = b < ac ? 0.f : (b < A ? qr[b - ac] : a.admit[is]);
            else x = b < A ? qo[b] : 0.f;
            cum += x;
            const float dr = fminf(fmaxf(amount - (cum - x), 0.f), x);
            if (b < A) {
                dl[b] = dr;
                if (b == ac) d_ac = dr;
                if (sp > 0.f) {
                    if (b >= ac) qr[b - ac] -= dr * sp;
                } else {
                    qo[b] -= dr * bo;
                }
            } else {
                dl[ac] = d_ac + dr;  // the admission slot lands at age 0
                if (sp > 0.f) a.admit[is] -= dr * sp;
            }
        }
    }
    // serve: land last slot's transit, drain up to mu oldest-first
    float* qi = a.q_in + (size_t)i * A;
    const float* tr = a.transit + (size_t)i * A;
    float total = 0.f;
    for (int b = 0; b < A; ++b) total += qi[b] + tr[b];
    const float amt = fminf(total, a.mu[i] * a.inv_service[i]) * bo;
    const float term = a.term[i];
    float cum = 0.f;
    for (int b = 0; b < A; ++b) {
        const float av = qi[b] + tr[b];
        cum += av;
        const float sb = fminf(fmaxf(amt - (cum - av), 0.f), av);
        qi[b] = (av - sb) * bo;
        a.served_term[(size_t)i * A + b] = sb * term;
        for (int s = 0; s < S; ++s)
            a.q_out[((size_t)i * S + s) * A + b] += (sb * a.sel[i * S + s]) * bo;
    }
    // admit leftover actuals, shift the window, shift the age axes
    const float* nxt = a.nxt + (size_t)slot * a.I * C + (size_t)i * C;
    for (int s = 0; s < S; ++s) {
        const int is = i * S + s;
        float* qr = a.q_rem + (size_t)is * W1;
        a.admit[is] += qr[0] * sp;
        for (int w = 0; w + 1 < W1; ++w) qr[w] = qr[w + 1];
        const int c2 = a.succ[is];
        qr[W1 - 1] = ((c2 < C ? nxt[c2] : 0.f) * a.valid[is]) * a.stream[is];
        float* qo = a.q_out + (size_t)is * A;
        qo[0] = qo[0] + qo[1];
        for (int b = 1; b + 1 < A; ++b) qo[b] = qo[b + 1];
        qo[A - 1] = 0.f;
    }
    qi[0] = qi[0] + qi[1];
    for (int b = 1; b + 1 < A; ++b) qi[b] = qi[b + 1];
    qi[A - 1] = 0.f;
}

// -- p5: per container, in ascending row order: partial landing (point and even parts) per
//        successor component, and served terminal mass per own component ---------------------
__global__ void potus_p5_group(PotusSlotArgs a) {
    const int k = blockIdx.x;
    const int S = a.S, C = a.C, A = a.Atot;
    const int r0 = a.cont_start[k], r1 = a.cont_start[k + 1];
    for (int b = threadIdx.x; b < A; b += blockDim.x) {
        for (int c = 0; c < C; ++c) {
            const size_t kc = ((size_t)k * C + c) * A + b;
            a.P_pt[kc] = 0.f; a.P_ev[kc] = 0.f; a.CM[kc] = 0.f;
        }
        for (int r = r0; r < r1; ++r) {
            const int i = a.cont_rows[r];
            for (int s = 0; s < S; ++s) {
                const int c2 = a.succ[i * S + s];
                if (c2 >= C) continue;
                const float d = a.d_land[((size_t)i * S + s) * A + b];
                const size_t kc = ((size_t)k * C + c2) * A + b;
                a.P_pt[kc] += a.w_pt[(size_t)i * C + c2] * d;
                a.P_ev[kc] += a.w_ev[(size_t)i * C + c2] * d;
            }
            a.CM[((size_t)k * C + a.inst_comp[i]) * A + b] += a.served_term[(size_t)i * A + b];
        }
    }
}

// the one instance that rows of container k aim their point mass at in component c (I = none)
__device__ __forceinline__ int potus_target(const PotusSlotArgs& a, int k, int c) {
    if (a.sched == SCHED_POTUS) return a.J[k * a.C + c];
    if (a.sched == SCHED_JSQ) return a.win_ok[c] ? a.winner[c] : a.I;
    return a.I;
}

// -- p6: landing per target (one writer each), even spread and served mass per component,
//        response accumulators at chunk-local columns [t, t + Atot) --------------------------
__global__ void potus_p6_reduce(PotusSlotArgs a, int t) {
    const int c = blockIdx.x, k = blockIdx.y;
    const int C = a.C, A = a.Atot, NK = a.NK;
    const int tgt = potus_target(a, k, c);
    bool owner = tgt < a.I;
    for (int k2 = 0; owner && k2 < k; ++k2)
        if (potus_target(a, k2, c) == tgt) owner = false;
    if (owner) {
        for (int b = threadIdx.x; b < A; b += blockDim.x) {
            float acc = 0.f;
            for (int k2 = k; k2 < NK; ++k2)
                if (potus_target(a, k2, c) == tgt) acc += a.P_pt[((size_t)k2 * C + c) * A + b];
            a.land[(size_t)tgt * A + b] = acc;
        }
    }
    if (k == 0) {
        for (int b = threadIdx.x; b < A; b += blockDim.x) {
            float ev = 0.f, cm = 0.f;
            for (int k2 = 0; k2 < NK; ++k2) {
                const size_t kc = ((size_t)k2 * C + c) * A + b;
                ev += a.P_ev[kc];
                cm += a.CM[kc];
            }
            a.ev_cb[(size_t)c * A + b] = ev;
            a.cmass[(size_t)c * A + b] = cm;
            const size_t col = (size_t)c * a.L + t + b;
            a.rmass[col] += cm;
            a.rtime[col] += cm * fmaxf((float)(a.age_cap - b), 0.f);
        }
    }
}

// -- p7: transit = shift(point landing + even spread) ----------------------------------------
__global__ void potus_p7_transit(PotusSlotArgs a) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j >= a.I) return;
    const int A = a.Atot;
    const float* ld = a.land + (size_t)j * A;
    const float* ev = a.ev_cb + (size_t)a.inst_comp[j] * A;
    float* tr = a.transit + (size_t)j * A;
    tr[0] = (ld[0] + ev[0]) + (ld[1] + ev[1]);
    for (int b = 1; b + 1 < A; ++b) tr[b] = ld[b + 1] + ev[b + 1];
    tr[A - 1] = 0.f;
}

// -- p8: the slot's metrics, block-tree sums in a fixed order --------------------------------
__global__ void potus_p8_metrics(PotusSlotArgs a, int slot) {
    __shared__ float sh[6][POTUS_RED_THREADS];
    const int tid = threadIdx.x, nt = blockDim.x;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < a.I; i += nt) {
        v[0] += a.row_bl[i];
        v[1] += a.row_bl[a.I + i];
        v[2] += a.row_cost[i];
        v[3] += a.row_cost[a.I + i];
    }
    const int CA = a.C * a.Atot;
    for (int x = tid; x < CA; x += nt) {
        const float m = a.cmass[x];
        v[5] += m;
        if (x % a.Atot == 0) v[4] += m;
    }
    for (int q = 0; q < 6; ++q) sh[q][tid] = v[q];
    __syncthreads();
    for (int h = nt / 2; h > 0; h >>= 1) {
        if (tid < h)
            for (int q = 0; q < 6; ++q) sh[q][tid] += sh[q][tid + h];
        __syncthreads();
    }
    if (tid == 0) {
        const int n = a.n_slots;
        a.met[slot] = sh[0][0] + a.vb[1] * sh[1][0];
        a.met[n + slot] = sh[2][0] + sh[3][0];
        a.met[2 * n + slot] = sh[4][0];
        a.met[3 * n + slot] = sh[5][0];
    }
}

#define POTUS_CHECK(expr)                                   \
    do {                                                    \
        cudaError_t err_ = (expr);                          \
        if (err_ != cudaSuccess) return (int)err_;          \
    } while (0)

extern "C" int potus_slot_args_size() { return (int)sizeof(PotusSlotArgs); }

// Copies the state in to the state out, then runs n_slots slots in place on the state out.
// Returns cudaGetLastError() (0 on success) after the last launch, or the first error.
extern "C" int potus_slot_run(const PotusSlotArgs* args) {
    const PotusSlotArgs a = *args;
    cudaStream_t st = (cudaStream_t)a.stream_handle;
    const size_t f = sizeof(float);
    const size_t I = (size_t)a.I, S = (size_t)a.S, A = (size_t)a.Atot;
    const size_t CL = (size_t)a.C * (size_t)a.L;
    POTUS_CHECK(cudaMemcpyAsync(a.q_rem, a.q_rem_in, I * S * a.W1 * f, cudaMemcpyDeviceToDevice, st));
    POTUS_CHECK(cudaMemcpyAsync(a.admit, a.admit_in, I * S * f, cudaMemcpyDeviceToDevice, st));
    POTUS_CHECK(cudaMemcpyAsync(a.q_in, a.q_in_in, I * A * f, cudaMemcpyDeviceToDevice, st));
    POTUS_CHECK(cudaMemcpyAsync(a.q_out, a.q_out_in, I * S * A * f, cudaMemcpyDeviceToDevice, st));
    POTUS_CHECK(cudaMemcpyAsync(a.transit, a.transit_in, I * A * f, cudaMemcpyDeviceToDevice, st));
    POTUS_CHECK(cudaMemcpyAsync(a.rmass, a.rmass_in, CL * f, cudaMemcpyDeviceToDevice, st));
    POTUS_CHECK(cudaMemcpyAsync(a.rtime, a.rtime_in, CL * f, cudaMemcpyDeviceToDevice, st));
    const int rows = (a.I + POTUS_ROW_THREADS - 1) / POTUS_ROW_THREADS;
    const dim3 comp_by_cont(a.C, a.NK);
    for (int k = 0; k < a.n_slots; ++k) {
        const int t = a.t0 + k;
        potus_p1_observe<<<rows, POTUS_ROW_THREADS, 0, st>>>(a, k);
        POTUS_CHECK(cudaGetLastError());
        potus_p2_fold<<<comp_by_cont, POTUS_RED_THREADS, 0, st>>>(a);
        POTUS_CHECK(cudaGetLastError());
        potus_p3_decide<<<rows, POTUS_ROW_THREADS, 0, st>>>(a);
        POTUS_CHECK(cudaGetLastError());
        potus_p4_drain_serve<<<rows, POTUS_ROW_THREADS, 0, st>>>(a, k);
        POTUS_CHECK(cudaGetLastError());
        potus_p5_group<<<a.NK, POTUS_ROW_THREADS, 0, st>>>(a);
        POTUS_CHECK(cudaGetLastError());
        potus_p6_reduce<<<comp_by_cont, POTUS_ROW_THREADS, 0, st>>>(a, t);
        POTUS_CHECK(cudaGetLastError());
        potus_p7_transit<<<rows, POTUS_ROW_THREADS, 0, st>>>(a);
        POTUS_CHECK(cudaGetLastError());
        potus_p8_metrics<<<1, POTUS_RED_THREADS, 0, st>>>(a, k);
        POTUS_CHECK(cudaGetLastError());
    }
    return (int)cudaGetLastError();
}
