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
// even-spread and the served-mass sums after it). So a slot is five kernels on one stream,
// cut where a grid-wide fold sits, and a call of K slots is 1 + 5K launches:
//
//   observe   one warp per instance row: reconcile window position 0 with the slot's actual
//             arrivals and observe the queues (slot 0 reads the state in and copies q_rem,
//             admit and the accumulators out); for slot >= 1 its block 0 sums the slot
//             before's metrics
//   fold      per (component, container): cheapest candidate M, J and u_sum (JSQ: the winners)
//   rows_b    one warp per instance row: the decision (rank water-fill, even split, cost), the
//             service of the bolts (its transit formed on the fly from the slot before's
//             landing and even spread), the oldest-first drain of every successor's queue, the
//             age and window shifts
//   group     per (container, chunk of components), eight warps: the partial landing (point and
//             even) per successor component and the served terminal mass per component
//   reduce    per (component, container): landing per target (one writer each), even spread and
//             served mass per component, the response accumulators
//   finish    (once a call) the transit out; its block 0 sums the last slot's metrics
//
// In the row kernels the lanes of a warp run across the age axis (and across the components in
// the decision): a warp reads a row's 276 bytes of q_in, q_out, d_land and served_term as
// contiguous lines. The oldest-first drains are inclusive warp scans across the buckets, 32 at
// a time with the carry of the rounds before; the age shifts read bucket b+1 from a per-warp
// copy of the row in shared memory. The state in is read where it lies (the first slot's
// observe and rows_b), so a call copies only q_rem and admit.
//
// What bounds it on this card: bytes, 0.0095 ms for the I=16384 fleet (the state read and
// written once). A slot streams the (I, ., Atot) state about three times (rows_b reads and
// writes it and writes d_land and served_term, group reads those two back), which the 50 MB L2
// partly holds. What keeps it above that is latency: a row is one warp's chain of dependent
// shuffles (two scans and a handful of warp sums) and loads, at 32 warps an SM; the folds are
// short kernels whose time is their launch, fill and drain.
//
// Every float reduction has one fixed order, so a run is bitwise reproducible: sums across a
// row's buckets or components are per-lane sums in ascending order, then a fixed shuffle tree
// (lane 0's result, broadcast); scans are Kogge-Stone shuffles with the rounds' carry; the
// per-container partials are per-warp sums over the warp's rows in ascending order, then a
// fixed tree over the warps, written once; per-component sums run over the containers in
// ascending order; the slot metrics are per-block sums (warps in order) and then one fixed
// block tree over the blocks. Nothing accumulates a float
// with an atomic. Landing is a scatter in the plain version: here each target is written by
// exactly one block, the first container whose cheapest candidate it is, which sums the
// containers' partials in ascending order, and stamps the target with the slot; a landing is
// read only where the stamp is the slot's.
// Build with --fmad=false so that a*b+c rounds twice, as the plain version does.
// The kernels are f32 only.
//
// A call runs N scenarios of one sweep partition at once (the reference runs its Pallas kernel
// under jax.vmap over the scenarios): every kernel takes its scenario from blockIdx.z and works
// on that scenario's view of the arguments (potus_scenario): its own V, beta, state, metrics and
// scratch, its own arrivals unless the partition shares one stream. A call stays 1 + 5K
// launches whatever N is, and nothing a block computes, nor the order it sums in, depends on
// N, so scenario n of a call equals a one-scenario call on that scenario bitwise. A call of one
// scenario takes each kernel's instance without the view (BATCHED false): the view's pointer
// arithmetic costs the row kernels registers and time.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define POTUS_ROW_WARPS 8      // rows (one warp each) per block of the row kernels, at most
#define POTUS_GROUP_WARPS 8    // warps of a container block in `group`, at most
#define POTUS_RED_THREADS 256  // a power of two: the block trees halve it
#define POTUS_REDUCE_THREADS 128
#define POTUS_GROUP_CHUNKS 4   // component chunks of a container in `group`, at least
#define POTUS_SMEM_MAX (200 * 1024)
#define POTUS_MAXC 64          // most components the row kernels hold (checked by the wrapper)
#define POTUS_BIG 1e30f        // finite stand-in for +inf, as compact.py's _BIG
#define POTUS_FULL 0xffffffffu

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
    const float* V;            // (N,)
    const float* beta;         // (N,)
    const int* comp_start;     // (C+1,) instance range of each component
    const int* cont_rows;      // (I,) instances grouped by container, ascending
    const int* cont_start;     // (NK+1,) each container's span of cont_rows
    // n_slots slots of arrivals, (n_slots, I, C) each: scenario n's at n * xs_stride
    const float* act;
    const float* pred;
    const float* nxt;
    // state in; the state, metrics and scratch below carry a leading scenario axis N
    const float* q_rem_in;     // (I, S, W1)
    const float* admit_in;     // (I, S)
    const float* q_in_in;      // (I, Atot)
    const float* q_out_in;     // (I, S, Atot)
    const float* transit_in;   // (I, Atot)
    const float* rmass_in;     // (C, L)
    const float* rtime_in;     // (C, L)
    // state out: the first launch copies the state in, the rest update it in place
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
    float* M;                  // (NK, C)
    int* J;                    // (NK, C)
    float* usum;               // (NK, C)
    int* winner;               // (C,)
    int* win_ok;               // (C,)
    float* wpt;                // (I, S) point weight of each (row, successor)
    float* wev;                // (I, S) even weight of each (row, successor)
    float* d_land;             // (I, S, Atot)
    float* served_term;        // (I, Atot)
    float* P_pt;               // (NK, C, Atot)
    float* P_ev;               // (NK, C, Atot)
    float* CM;                 // (NK, C, Atot)
    float* land;               // (I, Atot), a slot's where land_stamp holds its stamp
    int* land_stamp;           // (I,)
    float* ev_cb;              // (C, Atot)
    float* cmass;              // (C, Atot)
    float* part;               // (2, I, 4) per-block metric sums, by slot % 2
    void* stream_handle;       // cudaStream_t of the caller
    int I, S, W1, C, NK, Atot, L, age_cap, n_slots, t0, sched, stamp0;
    int N;                     // scenarios
    long long xs_stride;       // floats between two scenarios' arrivals, 0 when they share them
};

// scenario blockIdx.z's view of the arguments: the slot-invariant constants are shared
__device__ __forceinline__ PotusSlotArgs potus_scenario(const PotusSlotArgs& g) {
    PotusSlotArgs a = g;
    const size_t n = blockIdx.z;
    const size_t I = g.I, S = g.S, A = g.Atot, C = g.C, NK = g.NK;
    const size_t xs = n * (size_t)g.xs_stride;
    const size_t rem = n * I * S * g.W1, is = n * I * S, ia = n * I * A, isa = n * I * S * A;
    const size_t cl = n * C * g.L, ic = n * I * C, kc = n * NK * C, kca = n * NK * C * A;
    a.V = g.V + n;
    a.beta = g.beta + n;
    a.act = g.act + xs;
    a.pred = g.pred + xs;
    a.nxt = g.nxt + xs;
    a.q_rem_in = g.q_rem_in + rem;
    a.admit_in = g.admit_in + is;
    a.q_in_in = g.q_in_in + ia;
    a.q_out_in = g.q_out_in + isa;
    a.transit_in = g.transit_in + ia;
    a.rmass_in = g.rmass_in + cl;
    a.rtime_in = g.rtime_in + cl;
    a.q_rem = g.q_rem + rem;
    a.admit = g.admit + is;
    a.q_in = g.q_in + ia;
    a.q_out = g.q_out + isa;
    a.transit = g.transit + ia;
    a.rmass = g.rmass + cl;
    a.rtime = g.rtime + cl;
    a.met = g.met + n * 4 * g.n_slots;
    a.q_in_arr = g.q_in_arr + n * I;
    a.q_out_arr = g.q_out_arr + ic;
    a.must = g.must + ic;
    a.M = g.M + kc;
    a.J = g.J + kc;
    a.usum = g.usum + kc;
    a.winner = g.winner + n * C;
    a.win_ok = g.win_ok + n * C;
    a.wpt = g.wpt + is;
    a.wev = g.wev + is;
    a.d_land = g.d_land + isa;
    a.served_term = g.served_term + ia;
    a.P_pt = g.P_pt + kca;
    a.P_ev = g.P_ev + kca;
    a.CM = g.CM + kca;
    a.land = g.land + ia;
    a.land_stamp = g.land_stamp + n * I;
    a.ev_cb = g.ev_cb + n * C * A;
    a.cmass = g.cmass + n * C * A;
    a.part = g.part + n * 2 * I * 4;
    return a;
}

// the sum of v over the warp: a fixed shuffle tree into lane 0, broadcast to every lane
__device__ __forceinline__ float potus_warp_sum(float v) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(POTUS_FULL, v, o);
    return __shfl_sync(POTUS_FULL, v, 0);
}

// inclusive prefix sum of v over the lanes (Kogge-Stone, a fixed order)
__device__ __forceinline__ float potus_warp_scan(float v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(POTUS_FULL, v, o);
        if (lane >= o) v = u + v;
    }
    return v;
}

// floats of one warp's shared memory in rows_b: the decision (6 C), the drain and serve rows
// (5 Atot + 2) and the window (W1), rounded up to whole 16 bytes
__host__ __device__ __forceinline__ int potus_rows_b_floats(int C, int A, int W1) {
    return (6 * C + 5 * A + 2 + W1 + 3) & ~3;
}

// -- the metrics of `slot` (an extra block of a row kernel): per-block sums, a block tree ----
__device__ void potus_metrics(const PotusSlotArgs& a, int slot, int nblk) {
    __shared__ float sh[6][32 * POTUS_ROW_WARPS];
    const int tid = threadIdx.x, nt = blockDim.x;
    float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const float* part = a.part + (size_t)(slot % 2) * a.I * 4;
    for (int blk = tid; blk < nblk; blk += nt)
        for (int q = 0; q < 4; ++q) v[q] += part[(size_t)blk * 4 + q];
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
        a.met[slot] = sh[0][0] + *a.beta * sh[1][0];
        a.met[n + slot] = sh[2][0] + sh[3][0];
        a.met[2 * n + slot] = sh[4][0];
        a.met[3 * n + slot] = sh[5][0];
    }
}

// a block's sums of two row values (its warps in order) into part[slot % 2][block][q, q + 1]
__device__ __forceinline__ void potus_block_part(const PotusSlotArgs& a, float (*blk)[2],
                                                 int rb, int slot, int q, float v0, float v1) {
    const int warp = threadIdx.x >> 5, RW = blockDim.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        blk[warp][0] = v0;
        blk[warp][1] = v1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        float s0 = 0.f, s1 = 0.f;
        for (int w = 0; w < RW; ++w) {
            s0 += blk[w][0];
            s1 += blk[w][1];
        }
        float* p = a.part + ((size_t)(slot % 2) * a.I + rb) * 4 + q;
        p[0] = s0;
        p[1] = s1;
    }
}

// -- observe: reconcile window position 0 of `slot` with its actual arrivals and observe the
//             queues (slot 0: of the state in, copying q_rem, admit and the accumulators out;
//             later slots: of the state out, in place); for slot >= 1 block 0 sums the metrics
//             of the slot before ------------------------------------------------------------
__device__ __forceinline__ void potus_observe_body(const PotusSlotArgs& a, int slot) {
    __shared__ float blk[POTUS_ROW_WARPS][2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, RW = blockDim.x >> 5;
    if (slot > 0 && blockIdx.x == 0) {  // first, so that it does not trail the row blocks
        potus_metrics(a, slot - 1, (a.I + RW - 1) / RW);
        return;
    }
    const int rb = blockIdx.x - (slot > 0);  // this block's rows
    const bool first = slot == 0;
    // a warp past the last row repeats it and stores nothing: every warp runs the same code, so
    // its shuffles sit in warp-uniform control flow
    const bool live = rb * RW + warp < a.I;
    const int i = live ? rb * RW + warp : a.I - 1;
    const int A = a.Atot, S = a.S, C = a.C, W1 = a.W1;
    if (first) {
        const size_t CL = (size_t)C * a.L, n = (size_t)gridDim.x * blockDim.x;
        for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < CL; e += n) {
            a.rmass[e] = a.rmass_in[e];
            a.rtime[e] = a.rtime_in[e];
        }
    }
    float qin = 0.f, qsum = 0.f;
    {
        const float* qi = (first ? a.q_in_in : a.q_in) + (size_t)i * A;
        float part = 0.f;
        for (int b = lane; b < A; b += 32) part += qi[b];
        qin = potus_warp_sum(part);
        const float* act = a.act + ((size_t)slot * a.I + i) * C;
        const float* pred = a.pred + ((size_t)slot * a.I + i) * C;
        const float sp = a.spout[i];
        float qoa0 = 0.f, qoa1 = 0.f, must0 = 0.f, must1 = 0.f;  // components lane, lane + 32
        for (int s = 0; s < S; ++s) {
            const int is = i * S + s;
            const int c2 = a.succ[is];
            const float v = a.valid[is], st = a.stream[is];
            const float pm = ((c2 < C ? pred[c2] : 0.f) * v) * st;
            const float am = ((c2 < C ? act[c2] : 0.f) * v) * st;
            const float tp = fminf(pm, am);
            const float tn = am - tp;
            const float* qr_src = (first ? a.q_rem_in : a.q_rem) + (size_t)is * W1;
            float* qr = a.q_rem + (size_t)is * W1;
            const float r = pm > 0.f ? qr_src[0] / pm : 0.f;
            const float q0 = r * tp + tn;
            __syncwarp();  // every lane has read qr_src[0] before lane 0 writes it in place
            float win = 0.f;
            for (int w = lane; w < W1; w += 32) {
                const float x = w == 0 ? q0 : qr_src[w];
                win += x;
                if (live && (first || w == 0)) qr[w] = x;
            }
            float qo_part = win;
            if (!(sp > 0.f)) {
                const float* qq = (first ? a.q_out_in : a.q_out) + (size_t)is * A;
                qo_part = 0.f;
                for (int b = lane; b < A; b += 32) qo_part += qq[b];
            }
            const float qo = potus_warp_sum(qo_part);
            const float adm = (first ? a.admit_in : a.admit)[is];
            if (first && live && lane == 0) a.admit[is] = adm;
            if (c2 < C && lane == (c2 & 31)) {
                const float mv = (q0 + adm) * sp;
                if (c2 < 32) {
                    qoa0 += qo;
                    must0 += mv;
                } else {
                    qoa1 += qo;
                    must1 += mv;
                }
            }
        }
        float* qoa_row = a.q_out_arr + (size_t)i * C;
        float* must_row = a.must + (size_t)i * C;
        float part2 = 0.f;
        if (lane < C) {
            if (live) qoa_row[lane] = qoa0;
            if (live) must_row[lane] = must0;
            part2 += qoa0;
        }
        if (lane + 32 < C) {
            if (live) qoa_row[lane + 32] = qoa1;
            if (live) must_row[lane + 32] = must1;
            part2 += qoa1;
        }
        qsum = potus_warp_sum(part2);
        if (live && lane == 0) a.q_in_arr[i] = qin;
    }
    potus_block_part(a, blk, rb, slot, 0, live ? qin : 0.f, live ? qsum : 0.f);
}

template <bool BATCHED>
__global__ void __launch_bounds__(32 * POTUS_ROW_WARPS)
potus_observe(PotusSlotArgs g, int slot) {
    if constexpr (BATCHED) potus_observe_body(potus_scenario(g), slot);
    else potus_observe_body(g, slot);
}

// transit bucket b of row i after a slot: its landing (where stamped with the slot) and its
// component's even spread, shifted by one age
__device__ __forceinline__ float potus_transit(const PotusSlotArgs& a, int i, int b,
                                               bool landed) {
    const int A = a.Atot;
    const float* ld = a.land + (size_t)i * A;
    const float* ev = a.ev_cb + (size_t)a.inst_comp[i] * A;
    if (b == 0) return ((landed ? ld[0] : 0.f) + ev[0]) + ((landed ? ld[1] : 0.f) + ev[1]);
    return b + 1 < A ? (landed ? ld[b + 1] : 0.f) + ev[b + 1] : 0.f;
}

// -- finish: the transit out of the call's last slot; block 0, its metrics ------------------
__device__ __forceinline__ void potus_finish_body(const PotusSlotArgs& a) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, RW = blockDim.x >> 5;
    const int nblk = (a.I + RW - 1) / RW, last = a.n_slots - 1;
    if (blockIdx.x == 0) {  // first, so that it does not trail the row blocks
        potus_metrics(a, last, nblk);
        return;
    }
    const int i = (blockIdx.x - 1) * RW + warp;
    if (i >= a.I) return;
    const bool landed = a.land_stamp[i] == a.stamp0 + last;
    for (int b = lane; b < a.Atot; b += 32)
        a.transit[(size_t)i * a.Atot + b] = potus_transit(a, i, b, landed);
}

template <bool BATCHED>
__global__ void __launch_bounds__(32 * POTUS_ROW_WARPS)
potus_finish(PotusSlotArgs g) {
    if constexpr (BATCHED) potus_finish_body(potus_scenario(g));
    else potus_finish_body(g);
}

// -- fold: per (component c, container k) cheapest candidate M, J (lowest index on ties) and
//          the alive-column sum u_sum; for JSQ also the per-component shortest queue ----------
__device__ __forceinline__ void potus_fold_body(const PotusSlotArgs& a) {
    __shared__ float sv[POTUS_RED_THREADS];
    __shared__ int sj[POTUS_RED_THREADS];
    __shared__ float su[POTUS_RED_THREADS];
    const int c = blockIdx.x, k = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
    const int lo = a.comp_start[c], hi = a.comp_start[c + 1];
    const float V = *a.V;
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

template <bool BATCHED>
__global__ void potus_fold(PotusSlotArgs g) {
    if constexpr (BATCHED) potus_fold_body(potus_scenario(g));
    else potus_fold_body(g);
}

// one component's decision of a row, into the warp's shared arrays
__device__ __forceinline__ void potus_decision(float* ship_s, float* wpt_c, float* wev_c, int c,
                                               float shipped, float point, float even) {
    const float sh_safe = shipped > 0.f ? shipped : 1.f;
    const bool live = shipped > 1e-12f;
    ship_s[c] = shipped;
    wpt_c[c] = live ? point / sh_safe : 0.f;
    wev_c[c] = live ? even / sh_safe : 0.f;
}

// -- rows_b: decide, serve, drain oldest-first, admit leftovers, shift windows and ages -------
__device__ __forceinline__ void potus_rows_b_body(const PotusSlotArgs& a, int slot, int per_warp) {
    extern __shared__ float potus_smem[];
    __shared__ float blk[POTUS_ROW_WARPS][2];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, RW = blockDim.x >> 5;
    const int rb = blockIdx.x;  // this block's rows
    // a warp past the last row repeats it and stores nothing: every warp runs the same code, so
    // its shuffles sit in warp-uniform control flow
    const bool live = rb * RW + warp < a.I;
    const int i = live ? rb * RW + warp : a.I - 1;
    const int C = a.C, S = a.S, W1 = a.W1, A = a.Atot, ac = a.age_cap, I = a.I;
    const bool first = slot == 0;
    float* m_s = potus_smem + (size_t)warp * per_warp;  // the decision, per component
    int* j_s = (int*)(m_s + C);
    float* b_s = m_s + 2 * C;
    float* ship_s = m_s + 3 * C;
    float* wpt_c = m_s + 4 * C;
    float* wev_c = m_s + 5 * C;
    float* xb = m_s + 6 * C;  // a successor's drain sources, buckets 0..A (A: admission)
    float* drb = xb + A + 1;  // drained per bucket, 0..A
    float* vb = drb + A + 1;  // the successor's q_out before the age shift
    float* sbb = vb + A;      // served per bucket
    float* avb = sbb + A;     // q_in + transit, then q_in before the age shift
    float* wb = avb + A;      // the window q_rem of a successor
    float cost_a = 0.f, cost_b = 0.f;
    {
        const int k = a.inst_cont[i];
        const float g = a.gamma[i], beta = *a.beta;
        const float* Uk = a.U + (size_t)k * a.NK;
        const float* qoa_row = a.q_out_arr + (size_t)i * C;
        const float* must_row = a.must + (size_t)i * C;
        const float* adj = a.adj + (size_t)i * C;
        float ca = 0.f, cb = 0.f;
        if (a.sched == SCHED_POTUS) {
            for (int c = lane; c < C; c += 32) {
                const int kc = k * C + c;
                const float qo = qoa_row[c];
                const bool edge = adj[c] > 0.f;
                const float m_raw = a.M[kc] - beta * qo;
                const bool cand = edge && m_raw < 0.f;
                m_s[c] = cand ? m_raw : INFINITY;
                j_s[c] = edge ? a.J[kc] : I;
                b_s[c] = cand ? fmaxf(qo, 0.f) : 0.f;
            }
            __syncwarp();
            for (int e = lane; e < C; e += 32) {
                const float me = m_s[e];
                const int je = j_s[e];
                float before = 0.f;
                for (int d = 0; d < C; ++d) {
                    const float md = m_s[d];
                    if (md < me || (md == me && j_s[d] < je)) before += b_s[d];
                }
                const float after = before + b_s[e];
                const float fill = fminf(after, g) - fminf(before, g);
                const float cc = a.comp_count[e];
                const float sf =
                    (adj[e] > 0.f && cc > 0.f) ? fmaxf(must_row[e] - fill, 0.f) : 0.f;
                const float ev = sf / fmaxf(cc, 1.f);
                const int kj = je < I ? a.inst_cont[je] : 0;
                ca += fill * Uk[kj];
                cb += ev * a.usum[k * C + e];
                potus_decision(ship_s, wpt_c, wev_c, e, fill + sf, fill, ev);
            }
        } else {
            float part = 0.f;
            for (int c = lane; c < C; c += 32) part += qoa_row[c];
            const float total = potus_warp_sum(part);
            const float scale = total > 0.f ? fminf(g / fmaxf(total, 1e-9f), 1.f) : 0.f;
            for (int c = lane; c < C; c += 32) {
                const float ship = fmaxf(qoa_row[c] * scale, must_row[c]);
                const bool edge = adj[c] > 0.f;
                if (a.sched == SCHED_SHUFFLE) {
                    const float cc = a.comp_count[c];
                    const float pt = (edge && cc > 0.f) ? ship / fmaxf(cc, 1.f) : 0.f;
                    ca += pt * a.usum[k * C + c];
                    potus_decision(ship_s, wpt_c, wev_c, c, pt * cc, 0.f, pt);
                } else {
                    const float sh = (edge && a.win_ok[c]) ? ship : 0.f;
                    ca += sh * Uk[a.inst_cont[a.winner[c]]];
                    potus_decision(ship_s, wpt_c, wev_c, c, sh, sh, 0.f);
                }
            }
        }
        cost_a = potus_warp_sum(ca);
        cost_b = potus_warp_sum(cb);
        __syncwarp();
        for (int s = lane; live && s < S; s += 32) {
            const int c2 = a.succ[i * S + s];
            a.wpt[i * S + s] = c2 < C ? wpt_c[c2] : 0.f;
            a.wev[i * S + s] = c2 < C ? wev_c[c2] : 0.f;
        }

        // serve: land last slot's transit (the state in's, or the slot before's landing and even
        // spread), drain up to mu oldest-first, shift q_in
        const float sp = a.spout[i], bo = 1.f - sp;
        const float* qi_src = (first ? a.q_in_in : a.q_in) + (size_t)i * A;
        float* qi = a.q_in + (size_t)i * A;
        const bool landed = !first && a.land_stamp[i] == a.stamp0 + slot - 1;
        float part = 0.f;
        for (int b = lane; b < A; b += 32) {
            const float tr = first ? a.transit_in[(size_t)i * A + b]
                                   : potus_transit(a, i, b, landed);
            const float av = qi_src[b] + tr;
            avb[b] = av;
            part += av;
        }
        const float total = potus_warp_sum(part);
        const float amt = fminf(total, a.mu[i] * a.inv_service[i]) * bo;
        const float term = a.term[i];
        float carry = 0.f;
#pragma unroll 4
        for (int b0 = 0; b0 < A; b0 += 32) {
            const int b = b0 + lane;
            const float av = b < A ? avb[b] : 0.f;
            const float incl = potus_warp_scan(av, lane);
            const float cum = carry + incl;
            if (b < A) {
                const float sb = fminf(fmaxf(amt - (cum - av), 0.f), av);
                sbb[b] = sb;
                avb[b] = (av - sb) * bo;
                if (live) a.served_term[(size_t)i * A + b] = sb * term;
            }
            carry = carry + __shfl_sync(POTUS_FULL, incl, 31);
        }
        __syncwarp();
        for (int b = lane; live && b < A; b += 32)
            qi[b] = b == 0 ? avb[0] + avb[1] : (b + 1 < A ? avb[b + 1] : 0.f);

        // each successor: drain oldest-first, add the served emissions, shift
        const float* nxt = a.nxt + ((size_t)slot * I + i) * C;
        for (int s = 0; s < S; ++s) {
            const int is = i * S + s;
            const int c2 = a.succ[is];
            const float vd = a.valid[is], st = a.stream[is];
            const float amount = (c2 < C ? ship_s[c2] : 0.f) * vd;
            float* qr = a.q_rem + (size_t)is * W1;
            const float* qq_src = (first ? a.q_out_in : a.q_out) + (size_t)is * A;
            float* qq = a.q_out + (size_t)is * A;
            float* dl = a.d_land + (size_t)is * A;
            const float adm = a.admit[is];
            for (int w = lane; w < W1; w += 32) wb[w] = qr[w];
            for (int b = lane; b <= A; b += 32) {
                float x;
                if (sp > 0.f) x = b < ac ? 0.f : (b < A ? qr[b - ac] : adm);
                else x = b < A ? qq_src[b] : 0.f;
                xb[b] = x;
            }
            float cry = 0.f;
#pragma unroll 4
            for (int b0 = 0; b0 <= A; b0 += 32) {
                const int b = b0 + lane;
                const float x = b <= A ? xb[b] : 0.f;
                const float incl = potus_warp_scan(x, lane);
                const float cum = cry + incl;
                if (b <= A) drb[b] = fminf(fmaxf(amount - (cum - x), 0.f), x);
                cry = cry + __shfl_sync(POTUS_FULL, incl, 31);
            }
            __syncwarp();
            const float drA = drb[A];  // the admission slot lands at age 0
            const float sel = a.sel[is];
            for (int b = lane; b < A; b += 32) {
                const float dr = drb[b];
                if (live) dl[b] = b == ac ? dr + drA : dr;
                if (sp > 0.f) {
                    if (b >= ac) wb[b - ac] = wb[b - ac] - dr * sp;
                    vb[b] = qq_src[b] + (sbb[b] * sel) * bo;
                } else {
                    vb[b] = (xb[b] - dr * bo) + (sbb[b] * sel) * bo;
                }
            }
            __syncwarp();
            for (int b = lane; live && b < A; b += 32)
                qq[b] = b == 0 ? vb[0] + vb[1] : (b + 1 < A ? vb[b + 1] : 0.f);
            const float adm_new = (sp > 0.f ? adm - drA * sp : adm) + wb[0] * sp;
            if (live && lane == 0) a.admit[is] = adm_new;
            const float last = ((c2 < C ? nxt[c2] : 0.f) * vd) * st;  // the window's new end
            for (int w = lane; live && w < W1; w += 32) qr[w] = w + 1 < W1 ? wb[w + 1] : last;
            __syncwarp();  // the buffers are reused by the next successor
        }
    }
    potus_block_part(a, blk, rb, slot, 2, live ? cost_a : 0.f, live ? cost_b : 0.f);
}

template <bool BATCHED>
__global__ void __launch_bounds__(32 * POTUS_ROW_WARPS, 3)
potus_rows_b(PotusSlotArgs g, int slot, int per_warp) {
    if constexpr (BATCHED) potus_rows_b_body(potus_scenario(g), slot, per_warp);
    else potus_rows_b_body(g, slot, per_warp);
}

// -- group: per container and chunk of cc components, the partial landing (point and even
//           parts) per successor component and the served terminal mass per own component -----
__device__ __forceinline__ void potus_group_body(const PotusSlotArgs& a, int cc) {
    extern __shared__ float potus_smem[];
    const int k = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int NW = blockDim.x >> 5;  // a power of two, at most POTUS_GROUP_WARPS
    const int S = a.S, C = a.C, A = a.Atot;
    const int r0 = a.cont_start[k], n_rows = a.cont_start[k + 1] - r0;
    const int span = cc * A;  // floats of one of the warp's three partial arrays
    float* mine = potus_smem + (size_t)warp * 3 * span;
    const int c0 = blockIdx.y * cc, cn = min(cc, C - c0);
    for (int e = lane; e < 3 * span; e += 32) mine[e] = 0.f;
    __syncwarp();
    // this warp's rows are the container's rows warp, warp + NW, ... in ascending order;
    // 32 at a time, lane j holds the scalars of the j-th (none: c2_l = ci_l = -1). The loops'
    // bounds are the block's, so every shuffle sits in warp-uniform control flow.
    for (int base0 = 0; base0 < n_rows; base0 += 32 * NW) {
        const int pos = base0 + warp + lane * NW;
        const bool ok = pos < n_rows;
        const int i_l = ok ? a.cont_rows[r0 + pos] : 0;
        const int ci_l = ok ? a.inst_comp[i_l] - c0 : -1;
        const int cnt = min(32, (n_rows - base0 + NW - 1) / NW);
        for (int s = 0; s < S; ++s) {
            const int c2_l = ok ? a.succ[i_l * S + s] - c0 : -1;
            const float w1_l = ok ? a.wpt[i_l * S + s] : 0.f;
            const float w2_l = ok ? a.wev[i_l * S + s] : 0.f;
#pragma unroll 4
            for (int jr = 0; jr < cnt; ++jr) {
                const int i = __shfl_sync(POTUS_FULL, i_l, jr);
                const int c2 = __shfl_sync(POTUS_FULL, c2_l, jr);
                const float w1 = __shfl_sync(POTUS_FULL, w1_l, jr);
                const float w2 = __shfl_sync(POTUS_FULL, w2_l, jr);
                if (c2 < 0 || c2 >= cn) continue;  // uniform over the warp
                const float* d = a.d_land + ((size_t)i * S + s) * A;
                float* pp = mine + c2 * A;
                float* pe = mine + span + c2 * A;
                for (int b = lane; b < A; b += 32) {
                    const float v = __ldg(d + b);
                    pp[b] += w1 * v;
                    pe[b] += w2 * v;
                }
            }
        }
#pragma unroll 4
        for (int jr = 0; jr < cnt; ++jr) {
            const int i = __shfl_sync(POTUS_FULL, i_l, jr);
            const int ci = __shfl_sync(POTUS_FULL, ci_l, jr);
            if (ci < 0 || ci >= cn) continue;
            const float* st = a.served_term + (size_t)i * A;
            float* pc = mine + 2 * span + ci * A;
            for (int b = lane; b < A; b += 32) pc[b] += __ldg(st + b);
        }
    }
    __syncthreads();
    // a fixed tree over the warps, one writer per (array, component, bucket)
    for (int e = threadIdx.x; e < 3 * cn * A; e += blockDim.x) {
        const int q = e / (cn * A), rem = e - q * (cn * A);
        const int off = q * span + rem;
        float v[POTUS_GROUP_WARPS];
#pragma unroll
        for (int w = 0; w < POTUS_GROUP_WARPS; ++w)
            v[w] = w < NW ? potus_smem[(size_t)w * 3 * span + off] : 0.f;
#pragma unroll
        for (int h = POTUS_GROUP_WARPS / 2; h > 0; h >>= 1)
#pragma unroll
            for (int w = 0; w < h; ++w) v[w] = v[w] + v[w + h];
        float* dst = q == 0 ? a.P_pt : (q == 1 ? a.P_ev : a.CM);
        dst[((size_t)k * C + c0 + rem / A) * A + rem % A] = v[0];
    }
}

template <bool BATCHED>
__global__ void potus_group(PotusSlotArgs g, int cc) {
    if constexpr (BATCHED) potus_group_body(potus_scenario(g), cc);
    else potus_group_body(g, cc);
}

// the one instance that rows of container k aim their point mass at in component c (I = none)
__device__ __forceinline__ int potus_target(const PotusSlotArgs& a, int k, int c) {
    if (a.sched == SCHED_POTUS) return a.J[k * a.C + c];
    if (a.sched == SCHED_JSQ) return a.win_ok[c] ? a.winner[c] : a.I;
    return a.I;
}

// -- reduce: landing per target (one writer each, stamped with the slot), even spread and
//            served mass per component, response accumulators at columns [t, t + Atot) ------
__device__ __forceinline__ void potus_reduce_body(const PotusSlotArgs& a, int slot) {
    extern __shared__ int potus_tg[];  // (NK,) each container's target in component c
    const int c = blockIdx.x, k = blockIdx.y;
    const int C = a.C, A = a.Atot, NK = a.NK;
    for (int k2 = threadIdx.x; k2 < NK; k2 += blockDim.x) potus_tg[k2] = potus_target(a, k2, c);
    __syncthreads();
    const int tgt = potus_tg[k];
    bool owner = tgt < a.I;
    for (int k2 = 0; owner && k2 < k; ++k2)
        if (potus_tg[k2] == tgt) owner = false;
    if (owner) {
        for (int b = threadIdx.x; b < A; b += blockDim.x) {
            float acc = 0.f;
            for (int k2 = k; k2 < NK; ++k2)
                if (potus_tg[k2] == tgt) acc += a.P_pt[((size_t)k2 * C + c) * A + b];
            a.land[(size_t)tgt * A + b] = acc;
        }
        if (threadIdx.x == 0) a.land_stamp[tgt] = a.stamp0 + slot;
    }
    if (k == 0) {
        const int t = a.t0 + slot;
        for (int b = threadIdx.x; b < A; b += blockDim.x) {
            float ev = 0.f, cm = 0.f;
#pragma unroll 8
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

template <bool BATCHED>
__global__ void potus_reduce(PotusSlotArgs g, int slot) {
    if constexpr (BATCHED) potus_reduce_body(potus_scenario(g), slot);
    else potus_reduce_body(g, slot);
}

#define POTUS_CHECK(expr)                                   \
    do {                                                    \
        cudaError_t err_ = (expr);                          \
        if (err_ != cudaSuccess) return (int)err_;          \
    } while (0)

extern "C" int potus_slot_args_size() { return (int)sizeof(PotusSlotArgs); }

// Runs n_slots slots of N scenarios: the first slot reads the state in and writes the state
// out, the later ones update the state out. Returns cudaGetLastError() (0 on success) after the
// last launch, or the first error; cudaErrorInvalidValue when a row or a container's partials
// do not fit the shared memory (an age axis of thousands of buckets, or tens of thousands of
// containers). One scenario takes the kernels without the scenario view (BATCHED false), whose
// code is that of a kernel with no scenario axis.
template <bool BATCHED>
static int potus_slot_run_n(const PotusSlotArgs* args) {
    const PotusSlotArgs a = *args;
    cudaStream_t st = (cudaStream_t)a.stream_handle;
    const size_t f = sizeof(float);
    // the row kernels: RW warps (rows) a block, a power of two that fits rows_b's shared memory
    const int per_warp = potus_rows_b_floats(a.C, a.Atot, a.W1);
    int RW = POTUS_ROW_WARPS;
    while (RW > 1 && (size_t)RW * per_warp * f > POTUS_SMEM_MAX) RW >>= 1;
    const size_t smem_b = (size_t)RW * per_warp * f;
    // group: NW warps, a power of two, each with three (cc, Atot) partial arrays
    const size_t per_comp = 3 * (size_t)a.Atot * f;
    int NW = POTUS_GROUP_WARPS;
    while (NW > 1 && NW * per_comp > POTUS_SMEM_MAX) NW >>= 1;
    const int cc_fit = (int)(POTUS_SMEM_MAX / (NW * per_comp));
    const int cc = min(cc_fit, (a.C + POTUS_GROUP_CHUNKS - 1) / POTUS_GROUP_CHUNKS);
    const size_t smem_r = (size_t)a.NK * sizeof(int);
    if (smem_b > POTUS_SMEM_MAX || cc < 1 || smem_r > POTUS_SMEM_MAX || a.N < 1 || a.N > 65535)
        return (int)cudaErrorInvalidValue;
    const size_t smem_g = (size_t)NW * cc * per_comp;
    if (smem_b > 48 * 1024)
        POTUS_CHECK(cudaFuncSetAttribute(potus_rows_b<BATCHED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_b));
    if (smem_g > 48 * 1024)
        POTUS_CHECK(cudaFuncSetAttribute(potus_group<BATCHED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_g));
    if (smem_r > 48 * 1024)
        POTUS_CHECK(cudaFuncSetAttribute(potus_reduce<BATCHED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_r));
    const int nblk = (a.I + RW - 1) / RW, N = a.N;
    const dim3 comp_by_cont(a.C, a.NK, N);
    for (int k = 0; k < a.n_slots; ++k) {
        potus_observe<BATCHED><<<dim3(nblk + (k > 0), 1, N), 32 * RW, 0, st>>>(a, k);
        POTUS_CHECK(cudaGetLastError());
        potus_fold<BATCHED><<<comp_by_cont, POTUS_RED_THREADS, 0, st>>>(a);
        POTUS_CHECK(cudaGetLastError());
        potus_rows_b<BATCHED><<<dim3(nblk, 1, N), 32 * RW, smem_b, st>>>(a, k, per_warp);
        POTUS_CHECK(cudaGetLastError());
        potus_group<BATCHED><<<dim3(a.NK, (a.C + cc - 1) / cc, N), 32 * NW, smem_g, st>>>(a, cc);
        POTUS_CHECK(cudaGetLastError());
        potus_reduce<BATCHED><<<comp_by_cont, POTUS_REDUCE_THREADS, smem_r, st>>>(a, k);
        POTUS_CHECK(cudaGetLastError());
    }
    potus_finish<BATCHED><<<dim3(nblk + 1, 1, N), 32 * RW, 0, st>>>(a);
    return (int)cudaGetLastError();
}

extern "C" int potus_slot_run(const PotusSlotArgs* args) {
    return args->N > 1 ? potus_slot_run_n<true>(args) : potus_slot_run_n<false>(args);
}
