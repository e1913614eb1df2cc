// Hand-written Hopper (sm_90a) kernels for blockwise online-softmax GQA attention over a full
// sequence, causal or bidirectional (prefill and forward):
//
//   out[b, h, s, :] = softmax_t( q[b, h, s, :] . k[b, h/G, t, :] / sqrt(D) ) . v[b, h/G, t, :]
//
// over keys t <= s when causal, every key otherwise; G = Hq / Hkv query heads share a KV head.
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:24 flash_attention_kernel. The
// plain version of the same function is repro_torch.kernels.flash_attention.flash_attention_plain
// (the semantics of src/repro/kernels/ref.py:15).
//
// Both routes take one block per (query-row tile, KV head, batch). The rows of a (b, KV head)
// pair are its G query heads at every position, flattened as r = s*G + g, so each K/V tile
// staged in shared memory serves all G heads of the block's rows: the GQA grouping of the TPU
// kernel's `h // G` BlockSpec is the block's own row set here. The key loop runs to the last
// position of the block when causal (the TPU kernel's `nk` bound). Running (m, l, acc) stay in
// float32 registers and the output is acc / max(l, 1e-30) in q's type. No atomics and a fixed
// order of every sum: two runs are bitwise equal. Any S (a ragged last tile is masked); the
// model's (B, S, H, D) layout is read in place through its strides.
//
// Tensor-core route (bfloat16, D in {64, 128}: every bf16 launch of the served models).
//   What bounds it: operations, 4*B*Hq*D*S^2 (halved when causal) at 989 TFLOP/s, against bytes
//   that are read once per KV head. At the served prompts (S <= 512: 2.7 GFLOP at qwen widths,
//   320 blocks for 132 SMs) it is set by latency and by filling the SMs, not by the peak; at
//   S=4096 (172 GFLOP) by the rate of the mma.sync pipe.
//   What the design does: 64-row tiles, four warps of 16 rows; both products on the tensor
//   cores as mma.sync m16n8k16 bf16 with float32 accumulators. Q fragments are loaded once
//   with ldmatrix.x4; K tiles of 64 keys feed Q.K^T through ldmatrix (a row-major K is the
//   `col` B operand), V feeds P.V through ldmatrix.trans. K and V are staged in bf16 in a
//   two-stage ring filled by 16-byte cp.async, so tile i+1 loads while tile i computes (the Q
//   tile borrows stage 1 until then: 68 KB a block at D=128, three blocks an SM); rows are
//   padded by 16 bytes so the eight rows an ldmatrix phase reads fall in distinct banks. The
//   softmax stays in registers: scores are scaled by 1/sqrt(D) in float32 after Q.K^T (and by
//   log2(e), so the exponentials are exp2), masked with -inf above the diagonal and past S,
//   each row's max and sum reduced over its quad of lanes; P is rounded to bf16 in registers
//   and fed to P.V as the A fragment (the m16n8 C layout of two adjacent key groups is the
//   m16k16 A layout), never through shared memory.
//   Rounding P to bf16 is what ref.py does to the softmax weights; the TPU kernel kept them in
//   float32. The grid runs tile-major over all (KV head, request) pairs, causal tiles longest
//   first, so the diagonal's short tiles fill the tail.
//
// SIMT route (float32, and bf16 at any other D <= 256): warp-level float32 FMAs, 32 keys a
//   tile staged as float32, one warp per row (see flash_simt_kernel). float32 stays here because
//   TF32 tensor cores would break its 2e-5 limit.

#include "attention.cuh"

// ---------------------------------------------------------------------------------------------
// tensor-core route
// ---------------------------------------------------------------------------------------------

#define TC_BM 64     // query rows per block: four warps of 16
#define TC_BN 64     // keys per K/V tile
#define TC_THREADS 128

// Thread layout of an m16n8 accumulator: lane l holds rows l/4 and l/4 + 8, columns
// 2*(l%4) and 2*(l%4) + 1; c[0], c[1] are the first row's, c[2], c[3] the second's.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 3)
flash_tc_kernel(const att_bf16* __restrict__ q, const att_bf16* __restrict__ k,
                const att_bf16* __restrict__ v, att_bf16* __restrict__ out, int B, int Hkv,
                int S, int G,
                int64_t qb, int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks,
                int64_t ob, int64_t oh, int64_t os, int causal, float scale) {
    constexpr int DP = D + 8;     // padded row, elements
    constexpr int NCH = D / 8;    // 16-byte chunks per row
    constexpr int KD = D / 16;    // k-steps of Q.K^T
    constexpr int ND = D / 8;     // 8-wide column blocks of the output
    constexpr int NB = TC_BN / 8; // 8-key column blocks of a score tile
    extern __shared__ __align__(16) unsigned char tc_smem[];
    att_bf16* Ks = reinterpret_cast<att_bf16*>(tc_smem);  // 2 stages x TC_BN x DP
    att_bf16* Vs = Ks + 2 * TC_BN * DP;               // 2 stages x TC_BN x DP
    att_bf16* Qs = Ks + TC_BN * DP;  // TC_BM x DP: the Q tile borrows stage 1 of K until tile 1

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // blocks run tile-major (every head's tile i before any head's tile i + 1), causal tiles
    // longest first, so the diagonal's short tiles fill the tail of the grid
    const int heads = Hkv * B, ntile = (int)gridDim.x / heads;
    const int hb = (int)blockIdx.x % heads, h = hb % Hkv, b = hb / Hkv;
    const int rows = S * G;
    const int tile = causal ? ntile - 1 - (int)blockIdx.x / heads : (int)blockIdx.x / heads;
    const int r0 = tile * TC_BM;
    const int kend = causal ? (min(r0 + TC_BM, rows) - 1) / G + 1 : S;
    const int ntiles = (kend + TC_BN - 1) / TC_BN;
    const att_bf16* kp = k + b * kb + h * kh;
    const att_bf16* vp = v + b * kb + h * kh;  // v has k's strides (checked by the wrapper)

    // the block's query rows; rows past S*G are zero and never stored
    for (int e = tid; e < TC_BM * NCH; e += TC_THREADS) {
        const int i = e / NCH, c = e - i * NCH;
        const int r = r0 + i;
        const bool in = r < rows;
        const int rr = in ? r : 0;
        att_cp_async16(Qs + i * DP + c * 8,
                       q + b * qb + (int64_t)(h * G + rr % G) * qh + (int64_t)(rr / G) * qs + c * 8,
                       in);
    }
    att_cp_async_commit();
    // keys [t0, t0 + TC_BN) into stage st; keys at or past kend are zero and never read
    auto stage_kv = [&](int t0, int st) {
        att_bf16* kd = Ks + st * TC_BN * DP;
        att_bf16* vd = Vs + st * TC_BN * DP;
        for (int e = tid; e < TC_BN * NCH; e += TC_THREADS) {
            const int j = e / NCH, c = e - j * NCH;
            const bool in = t0 + j < kend;
            const int64_t at = (int64_t)(in ? t0 + j : 0) * ks + c * 8;
            att_cp_async16(kd + j * DP + c * 8, kp + at, in);
            att_cp_async16(vd + j * DP + c * 8, vp + at, in);
        }
    };
    stage_kv(0, 0);
    att_cp_async_commit();

    // this thread's two rows: ra (accumulator halves 0, 1) and ra + 8 (halves 2, 3)
    const int ra = r0 + warp * 16 + (lane >> 2);
    const int qa = ra < rows ? ra / G : S;  // a row past S*G masks nothing but keys >= S
    const int qb8 = ra + 8 < rows ? (ra + 8) / G : S;
    const int qmin = r0 / G;  // the smallest query position of the block
    const float scale_log2 = scale * 1.4426950408889634f;

    att_cp_async_wait<1>();  // Q has landed
    __syncthreads();
    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
        att_ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
    __syncthreads();  // every warp holds its Q fragments: stage 1 may take tile 1

    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;  // l: this lane's columns

    for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles) stage_kv((it + 1) * TC_BN, (it + 1) & 1);
        att_cp_async_commit();
        att_cp_async_wait<1>();  // tile it has landed
        __syncthreads();
        const att_bf16* Kt = Ks + (it & 1) * TC_BN * DP;
        const att_bf16* Vt = Vs + (it & 1) * TC_BN * DP;
        const int t0 = it * TC_BN;

        // S = Q K^T: 16 rows x 64 keys per warp
        float s[NB][4];
#pragma unroll
        for (int n = 0; n < NB; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
            for (int n2 = 0; n2 < NB / 2; ++n2) {
                uint32_t bk[4];
                att_ldmatrix_x4(bk, Kt + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP + kk * 16
                                       + ((lane >> 3) & 1) * 8);
                att_mma(s[2 * n2], qf[kk], bk[0], bk[1]);
                att_mma(s[2 * n2 + 1], qf[kk], bk[2], bk[3]);
            }
        }

        // scale (by log2(e)/sqrt(D): the softmax runs in base 2), mask, and the online softmax
        // of the two rows
        const bool need_mask = t0 + TC_BN > S || (causal && t0 + TC_BN - 1 > qmin);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                float x = s[n][e] * scale_log2;
                if (need_mask) {
                    const int key = t0 + n * 8 + 2 * (lane & 3) + (e & 1);
                    const int qp = e < 2 ? qa : qb8;
                    if (key >= S || (causal && key > qp)) x = -INFINITY;
                }
                s[n][e] = x;
            }
            mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
            mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // a row with no valid key yet keeps m = -inf; exp against 0 then gives p = 0
        const float base_a = mn_a == -INFINITY ? 0.0f : mn_a;
        const float base_b = mn_b == -INFINITY ? 0.0f : mn_b;
        const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            s[n][0] = exp2f(s[n][0] - base_a);
            s[n][1] = exp2f(s[n][1] - base_a);
            s[n][2] = exp2f(s[n][2] - base_b);
            s[n][3] = exp2f(s[n][3] - base_b);
            ps_a += s[n][0] + s[n][1];
            ps_b += s[n][2] + s[n][3];
        }
        l_a = l_a * al_a + ps_a;
        l_b = l_b * al_b + ps_b;
#pragma unroll
        for (int n = 0; n < ND; ++n) {
            o[n][0] *= al_a;
            o[n][1] *= al_a;
            o[n][2] *= al_b;
            o[n][3] *= al_b;
        }

        // O += P V: P in bf16 straight from the score registers
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {
            uint32_t pa[4];
            pa[0] = att_pack(s[2 * j][0], s[2 * j][1]);
            pa[1] = att_pack(s[2 * j][2], s[2 * j][3]);
            pa[2] = att_pack(s[2 * j + 1][0], s[2 * j + 1][1]);
            pa[3] = att_pack(s[2 * j + 1][2], s[2 * j + 1][3]);
#pragma unroll
            for (int n2 = 0; n2 < ND / 2; ++n2) {
                uint32_t bv[4];
                att_ldmatrix_x4_trans(bv, Vt + (j * 16 + (lane & 15)) * DP + n2 * 16
                                             + (lane >> 4) * 8);
                att_mma(o[2 * n2], pa, bv[0], bv[1]);
                att_mma(o[2 * n2 + 1], pa, bv[2], bv[3]);
            }
        }
        __syncthreads();  // the stage is consumed before the next tile refills it
    }

    // the rows' sums over the quad, then out = acc / max(l, 1e-30)
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
    }
    const float inv_a = 1.0f / fmaxf(l_a, 1e-30f), inv_b = 1.0f / fmaxf(l_b, 1e-30f);
    const int col = 2 * (lane & 3);
    if (ra < rows) {
        att_bf16* dst =
            out + b * ob + (int64_t)(h * G + ra % G) * oh + (int64_t)(ra / G) * os + col;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
                __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    }
    if (ra + 8 < rows) {
        const int rb = ra + 8;
        att_bf16* dst =
            out + b * ob + (int64_t)(h * G + rb % G) * oh + (int64_t)(rb / G) * os + col;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
                __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
    }
}

template <int D>
static int launch_tc(const void* q, const void* k, const void* v, void* out, int B, int Hkv,
                     int S, int G, const int64_t* st, int causal, float scale,
                     cudaStream_t stream) {
    const int grid = (S * G + TC_BM - 1) / TC_BM * Hkv * B;
    const int smem = 4 * TC_BN * (D + 8) * (int)sizeof(att_bf16);  // Q borrows a K stage
    const cudaError_t e = cudaFuncSetAttribute(
        flash_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    flash_tc_kernel<D><<<grid, TC_THREADS, smem, stream>>>(
        (const att_bf16*)q, (const att_bf16*)k, (const att_bf16*)v, (att_bf16*)out, B, Hkv, S, G,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
    return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------------------------
// SIMT route
// ---------------------------------------------------------------------------------------------
//
// A row's state: lane l holds the query and the running output for the head dimensions
// d = l + 32*i, i < NS (NS = ceil(D / 32)); the row's running max m and sum l are the same on
// every lane. A tile holds SIMT_TK = 32 keys (one per lane) in shared memory as float32, row
// stride 32*NS, the dimensions d >= D zero-filled. Each lane takes the partial dot products of
// its NS dimensions with all 32 keys, then a butterfly transpose-reduction (31 shuffles) leaves
// the full score of key j on lane j; p_j is broadcast with one shuffle per key for P.V. The
// query is scaled by 1/sqrt(D) before Q.K^T, as the TPU kernel scales q.

#define SIMT_TK 32      // keys per staged tile: one per lane
#define SIMT_WARPS 8    // warps per block
#define SIMT_RPW 4      // query rows per warp

template <int NS>
struct SimtRow {
    float m, l;
    float q[NS];
    float acc[NS];
};

template <typename T, int NS>
__device__ __forceinline__ void simt_row_init(SimtRow<NS>& r, const T* __restrict__ q, int D,
                                              float scale, int lane) {
    r.m = -INFINITY;
    r.l = 0.0f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int d = lane + 32 * i;
        r.q[i] = d < D ? att_to_f32(q[d]) * scale : 0.0f;
        r.acc[i] = 0.0f;
    }
}

// Stage keys [t0, t0 + SIMT_TK) into Ks/Vs (float32, row stride 32*NS); key rows at or beyond
// `kend` and dimensions d >= D are zero. Called by all threads, between two __syncthreads.
template <typename T, int NS>
__device__ __forceinline__ void simt_stage(float* __restrict__ Ks, float* __restrict__ Vs,
                                           const T* __restrict__ k, const T* __restrict__ v,
                                           int64_t ks, int t0, int kend, int D) {
    constexpr int DP = 32 * NS;
    for (int e = threadIdx.x; e < SIMT_TK * DP; e += blockDim.x) {
        const int j = e / DP, d = e - j * DP;
        const int key = t0 + j;
        const bool in = key < kend && d < D;
        const int64_t at = (int64_t)key * ks + d;
        Ks[e] = in ? att_to_f32(k[at]) : 0.0f;
        Vs[e] = in ? att_to_f32(v[at]) : 0.0f;
    }
}

// Fold keys j < nvalid of the staged tile into the row (0 < nvalid <= SIMT_TK); warp-uniform.
template <int NS>
__device__ __forceinline__ void simt_fold(SimtRow<NS>& r, const float* __restrict__ Ks,
                                          const float* __restrict__ Vs, int nvalid, int lane) {
    constexpr int DP = 32 * NS;
    constexpr unsigned FULL = 0xffffffffu;
    float part[SIMT_TK];
#pragma unroll
    for (int j = 0; j < SIMT_TK; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) s += r.q[i] * Ks[j * DP + lane + 32 * i];
        part[j] = s;
    }
    // butterfly transpose-reduction: after the step of width w, lane l keeps w values, those of
    // the keys whose high bits equal l's; at the end lane j holds the full score of key j
#pragma unroll
    for (int w = SIMT_TK / 2; w >= 1; w >>= 1) {
        const bool upper = (lane & w) != 0;
#pragma unroll
        for (int i = 0; i < w; ++i) {
            const float keep = upper ? part[i + w] : part[i];
            const float send = upper ? part[i] : part[i + w];
            part[i] = keep + __shfl_xor_sync(FULL, send, w);
        }
    }
    const bool valid = lane < nvalid;
    const float s = valid ? part[0] : -INFINITY;
    float tmax = s;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) tmax = fmaxf(tmax, __shfl_xor_sync(FULL, tmax, o));
    const float m_new = fmaxf(r.m, tmax);  // finite: key t0 is valid
    const float alpha = expf(r.m - m_new);  // 0 on the first tile (m = -inf)
    const float p = valid ? expf(s - m_new) : 0.0f;
    float psum = p;
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) psum += __shfl_xor_sync(FULL, psum, o);
    r.l = r.l * alpha + psum;
    r.m = m_new;
#pragma unroll
    for (int i = 0; i < NS; ++i) r.acc[i] *= alpha;
    for (int j = 0; j < nvalid; ++j) {
        const float pj = __shfl_sync(FULL, p, j);
#pragma unroll
        for (int i = 0; i < NS; ++i) r.acc[i] += pj * Vs[j * DP + lane + 32 * i];
    }
}

template <typename T, int NS>
__device__ __forceinline__ void simt_row_store(const SimtRow<NS>& r, T* __restrict__ out, int D,
                                               int lane) {
    const float l = fmaxf(r.l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int d = lane + 32 * i;
        if (d < D) out[d] = att_from_f32<T>(r.acc[i] / l);
    }
}

template <typename T, int NS>
__global__ void __launch_bounds__(SIMT_WARPS * 32)
flash_simt_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  T* __restrict__ out, int S, int G, int D, int64_t qb, int64_t qh, int64_t qs,
                  int64_t kb, int64_t kh, int64_t ks, int64_t ob, int64_t oh, int64_t os,
                  int causal, float scale) {
    extern __shared__ float simt_smem[];
    float* Ks = simt_smem;
    float* Vs = simt_smem + SIMT_TK * 32 * NS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = blockIdx.y, b = blockIdx.z;
    const int rows = S * G;
    const int r0 = blockIdx.x * (SIMT_WARPS * SIMT_RPW);

    SimtRow<NS> st[SIMT_RPW];
    int qpos[SIMT_RPW], head[SIMT_RPW];
#pragma unroll
    for (int rr = 0; rr < SIMT_RPW; ++rr) {
        const int r = r0 + rr * SIMT_WARPS + warp;
        qpos[rr] = r < rows ? r / G : -1;
        head[rr] = h * G + (r < rows ? r % G : 0);
        if (qpos[rr] >= 0)
            simt_row_init<T, NS>(st[rr], q + b * qb + head[rr] * qh + (int64_t)qpos[rr] * qs, D,
                                 scale, lane);
    }
    const int r_last = min(r0 + SIMT_WARPS * SIMT_RPW, rows) - 1;
    const int kend = causal ? r_last / G + 1 : S;
    const T* kp = k + b * kb + h * kh;
    const T* vp = v + b * kb + h * kh;

    for (int t0 = 0; t0 < kend; t0 += SIMT_TK) {
        __syncthreads();  // the previous tile is consumed
        simt_stage<T, NS>(Ks, Vs, kp, vp, ks, t0, kend, D);
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < SIMT_RPW; ++rr) {
            if (qpos[rr] < 0) continue;
            const int nvalid = min((causal ? qpos[rr] + 1 : S) - t0, SIMT_TK);
            if (nvalid <= 0) continue;  // the whole tile lies above this row's diagonal
            simt_fold<NS>(st[rr], Ks, Vs, nvalid, lane);
        }
    }
#pragma unroll
    for (int rr = 0; rr < SIMT_RPW; ++rr)
        if (qpos[rr] >= 0)
            simt_row_store<T, NS>(st[rr], out + b * ob + head[rr] * oh + (int64_t)qpos[rr] * os,
                                  D, lane);
}

template <typename T, int NS>
static int launch_simt(const void* q, const void* k, const void* v, void* out, int B, int Hkv,
                       int S, int G, int D, const int64_t* st, int causal, float scale,
                       cudaStream_t stream) {
    const int rows = S * G, per_block = SIMT_WARPS * SIMT_RPW;
    const dim3 grid((rows + per_block - 1) / per_block, Hkv, B);
    const int smem = 2 * SIMT_TK * 32 * NS * (int)sizeof(float);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_simt_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    flash_simt_kernel<T, NS><<<grid, SIMT_WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, S, G, D, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_simt_d(const void* q, const void* k, const void* v, void* out, int B, int Hkv,
                         int S, int G, int D, const int64_t* st, int causal, float scale,
                         cudaStream_t s) {
    if (D <= 32) return launch_simt<T, 1>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, s);
    if (D <= 64) return launch_simt<T, 2>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, s);
    if (D <= 128) return launch_simt<T, 4>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, s);
    if (D <= 256) return launch_simt<T, 8>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, s);
    return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------------------------
// entry points
// ---------------------------------------------------------------------------------------------

// q/out (B, Hq, S, D) and k/v (B, Hkv, S, D) with element strides `strides` = (q: b, h, s;
// k and v: b, h, s; out: b, h, s), the head dimension contiguous. The tensor-core route takes
// bfloat16 at D in {64, 128} with every pointer and stride 16-byte aligned (the wrapper checks
// it); the SIMT route takes float32 (`bf16_in` = 0) or bfloat16 at D <= 256. Launches on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_tc_run(const void* q, const void* k, const void* v, void* out,
                                      int B, int Hq, int Hkv, int S, int D,
                                      const int64_t* strides, int causal, float scale,
                                      void* stream) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
    const int G = Hq / Hkv;
    const cudaStream_t st = (cudaStream_t)stream;
    if (D == 64) return launch_tc<64>(q, k, v, out, B, Hkv, S, G, strides, causal, scale, st);
    if (D == 128) return launch_tc<128>(q, k, v, out, B, Hkv, S, G, strides, causal, scale, st);
    return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_simt_run(const void* q, const void* k, const void* v, void* out,
                                        int B, int Hq, int Hkv, int S, int D,
                                        const int64_t* strides, int causal, float scale,
                                        int bf16_in, void* stream) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
    const int G = Hq / Hkv;
    const cudaStream_t st = (cudaStream_t)stream;
    return bf16_in ? launch_simt_d<__nv_bfloat16>(q, k, v, out, B, Hkv, S, G, D, strides, causal,
                                                 scale, st)
                   : launch_simt_d<float>(q, k, v, out, B, Hkv, S, G, D, strides, causal, scale,
                                          st);
}
