// Hand-written Hopper (sm_90a) kernels for the backward pass of flash attention: given q, k,
// v and the output's gradient dO, the gradients dQ, dK and dV of
//
//   o[b, h, s, :] = softmax_t( q[b, h, s, :] . k[b, h/G, t, :] * scale ) . v[b, h/G, t, :]
//
// over keys t <= s when causal, every key otherwise, G = Hq / Hkv query heads to a KV head:
//
//   P = softmax(S),  dV_t = sum_s P_st dO_s,  dP_st = dO_s . v_t,  D_s = sum_t P_st dP_st,
//   dS_st = P_st (dP_st - D_s),  dQ_s = scale sum_t dS_st k_t,  dK_t = scale sum_s dS_st q_s,
//
// the dK and dV of a KV head summed over its G query heads. D_s equals dO_s . o_s; both routes
// take it as the sum over the recomputed P and dP in float32, which the plain version's softmax
// backward computes too, and not from the forward's output rounded to bfloat16: with that,
// sum_t dS_st is no longer ~0 to float32's precision, and the rounding of o adds to gradients
// that cancel (a key projection's, whose bias gradient is exactly zero). The forward's output
// is not read. Replaces no TPU kernel: the reference differentiates its plain attention with
// XLA (src/repro/models/common.py:169-244) and no Pallas kernel of the repository has a VJP.
// It is the backward of flash_attention.cu (kernels/ops.py's autograd Function), so training
// on the card never runs attention's gradient through the plain version. The plain version is
// the autograd gradient of repro_torch.kernels.flash_attention.flash_attention_plain.
//
// What bounds it: operations, 10*B*Hq*D*S^2 (halved when causal: five products of the
// forward's size) against bytes that are read once; the card's bound is the bf16 tensor-core
// peak. Two routes, chosen by the wrapper before the launch (flash_attention.py's bwd_route):
//
// Tensor-core route (bfloat16, D in {64, 80, 128}: internvl2-1b's, hubert-xlarge's and qwen's
//   heads, each a multiple of 16). Every product on mma.sync m16n8k16 bf16 with float32
//   accumulators, K/V (pass A) or Q/dO (pass B) tiles staged in bf16 by 16-byte cp.async in a
//   two-stage ring, rows padded by 16 bytes (DP = D + 8) as in the forward. It does nine
//   products of the forward's size against the bound's five (S and dP twice, dQ, and S^T, dP^T,
//   dV, dK), so its rate on the bound's count reads below what the pipe does.
//   pass A, one block per (64 query rows, query head, request), four warps of 16 rows, Q and dO
//   in shared memory for the whole block: sweep 1 over the key tiles takes S = Q K^T and
//   dP = dO V^T and keeps the rows' running (m, l, u = sum exp2(S - m) dP) in float32
//   registers, then writes lse = m + log2(l) (base 2, of the scores scaled by
//   scale*log2(e)) and D = u / l in float32; sweep 2 takes P = exp2(S - lse) and
//   dS = P (dP - D) in float32, rounds dS to bf16 as the A operand of dQ += dS K (K through
//   ldmatrix.trans), and writes dQ once, scaled.
//   pass B, one block per (64 keys, query head, request): K and V staged once; over the query
//   tiles, from the diagonal when causal, with that head's lse and D: S^T = K Q^T and
//   dP^T = V dO^T, so that P^T and dS^T come out in the accumulator layout and are rounded to
//   bf16 in registers as the A operands of dV += P^T dO and dK += dS^T Q (dO and Q through
//   ldmatrix.trans). A block per query head (not per KV head) fills the card at GQA shapes
//   (internvl2-1b: 448 blocks, against 64 per KV head); each writes its float32 partial dK, dV
//   into scratch (2, B, Hq, S, D), and a third kernel sums the G partials of a KV head in
//   ascending g into dK, dV in the model's layout. When G = 1 pass B writes the rounded result
//   itself and the sum is skipped (the same values: a sum of one term).
//
// SIMT route (float32, since TF32 tensor cores would break its 2e-5 limit, and bf16 at any other
//   D up to 256): both passes in the SIMT layout of the forward's SIMT route (a row's head
//   dimensions d = lane + 32*i, i < NS, spread over the 32 lanes of a warp; 32 rows of the
//   other operand staged in shared memory as float32, one per lane; a butterfly
//   transpose-reduction leaves row j's dot product on lane j).
//   pass A, one block per (tile of query rows, KV head, request), rows r = s*G + g as in the
//   forward, so a staged K/V tile serves the G heads: a first sweep over the keys recomputes
//   the row's running max and sum (m, l), written as lse = m + log(l), and the running sum
//   u of exp(S - m) dP, so D = u / l; a second sweep takes P = exp(S - lse) and dP per key
//   and accumulates dQ in registers.
//   pass B, one block per (tile of keys, KV head, request): each warp holds its keys' k and v
//   and accumulates dK and dV in registers over the tiles of the G heads' query rows (q
//   scaled, dO, lse, D staged), from the first row at or after the block's first key when
//   causal.
//
// Accumulators are float32; every sum has a fixed order and nothing is summed with atomics,
// so two runs are bitwise equal. The causal loops stop at the diagonal.

#include "attention.cuh"

#define BWD_TK 32     // rows staged per tile (keys in pass A, query rows in pass B): one a lane
#define BWD_WARPS 8   // warps per block
#define BWD_RPW 2     // rows a warp holds (query rows in pass A, keys in pass B)

// One step of width W of the butterfly below: lane l keeps the W values of the keys whose bit W
// equals l's, each summed with its partner lane's. W is a template constant so that every index
// into `part` is known at compile time and the array stays in registers.
template <int W>
__device__ __forceinline__ void bwd_butterfly(float (&part)[BWD_TK], int lane) {
    const bool upper = (lane & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
        const float keep = upper ? part[i + W] : part[i];
        const float send = upper ? part[i] : part[i + W];
        part[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
}

// The 32 partial sums part[j] of every lane reduced across the warp: on return, lane j holds
// the sum of part[j] over the lanes (a butterfly transpose-reduction, 31 shuffles).
__device__ __forceinline__ float bwd_transpose_sum(float (&part)[BWD_TK], int lane) {
    bwd_butterfly<16>(part, lane);
    bwd_butterfly<8>(part, lane);
    bwd_butterfly<4>(part, lane);
    bwd_butterfly<2>(part, lane);
    bwd_butterfly<1>(part, lane);
    return part[0];
}

__device__ __forceinline__ float bwd_warp_sum(float x) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    return x;
}

__device__ __forceinline__ float bwd_warp_max(float x) {
#pragma unroll
    for (int o = 16; o >= 1; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    return x;
}

// lane j: the dot product of `row` (this lane's NS dimensions) with staged row j of `tile`
template <int NS>
__device__ __forceinline__ float bwd_dots(const float (&row)[NS], const float* __restrict__ tile,
                                          int lane) {
    constexpr int DP = 32 * NS;
    float part[BWD_TK];
#pragma unroll
    for (int j = 0; j < BWD_TK; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) s += row[i] * tile[j * DP + lane + 32 * i];
        part[j] = s;
    }
    return bwd_transpose_sum(part, lane);
}

// Stage rows [t0, t0 + BWD_TK) (global row index t, element (t, d) at t * st + d) of `a` into
// `dst` as float32, row stride 32*NS; rows at or past `end` and dimensions d >= D are zero.
// Called by all threads, between two __syncthreads.
template <typename T, int NS>
__device__ __forceinline__ void bwd_stage(float* __restrict__ dst, const T* __restrict__ a,
                                          int64_t st, int t0, int end, int D) {
    constexpr int DP = 32 * NS;
    for (int e = threadIdx.x; e < BWD_TK * DP; e += blockDim.x) {
        const int j = e / DP, d = e - j * DP;
        const bool in = t0 + j < end && d < D;
        dst[e] = in ? att_to_f32(a[(int64_t)(t0 + j) * st + d]) : 0.0f;
    }
}

// ---------------------------------------------------------------------------------------------
// pass A: lse, D and dQ
// ---------------------------------------------------------------------------------------------

template <typename T, int NS>
__global__ void __launch_bounds__(BWD_WARPS * 32)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse,
                    float* __restrict__ dsum, int Hq, int S, int G, int D, int64_t qb,
                    int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks, int64_t gb,
                    int64_t gh, int64_t gs, int64_t db, int64_t dh, int64_t ds, int causal,
                    float scale) {
    constexpr int DP = 32 * NS;
    extern __shared__ float bwd_smem[];
    float* Ks = bwd_smem;
    float* Vs = bwd_smem + BWD_TK * DP;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = blockIdx.y, b = blockIdx.z;
    const int rows = S * G;
    const int r0 = blockIdx.x * (BWD_WARPS * BWD_RPW);

    float qr[BWD_RPW][NS], gr[BWD_RPW][NS], acc[BWD_RPW][NS];
    float m[BWD_RPW], l[BWD_RPW], u[BWD_RPW], dd[BWD_RPW];
    int qpos[BWD_RPW], head[BWD_RPW];
#pragma unroll
    for (int rr = 0; rr < BWD_RPW; ++rr) {
        const int r = r0 + rr * BWD_WARPS + warp;
        qpos[rr] = r < rows ? r / G : -1;
        head[rr] = h * G + (r < rows ? r % G : 0);
        m[rr] = -INFINITY;
        l[rr] = u[rr] = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int d = lane + 32 * i;
            const bool in = qpos[rr] >= 0 && d < D;
            qr[rr][i] = in ? att_to_f32(q[b * qb + head[rr] * qh + (int64_t)qpos[rr] * qs + d])
                                 * scale
                           : 0.0f;
            gr[rr][i] = in ? att_to_f32(dout[b * gb + head[rr] * gh + (int64_t)qpos[rr] * gs + d])
                           : 0.0f;
            acc[rr][i] = 0.0f;
        }
    }
    const int r_last = min(r0 + BWD_WARPS * BWD_RPW, rows) - 1;
    const int kend = causal ? r_last / G + 1 : S;
    const T* kp = k + b * kb + h * kh;
    const T* vp = v + b * kb + h * kh;  // v has k's strides (checked by the wrapper)

    // sweep 1: the rows' max and sum over their keys, and the sum of exp(S - m) dP
    for (int t0 = 0; t0 < kend; t0 += BWD_TK) {
        __syncthreads();  // the previous tile is consumed
        bwd_stage<T, NS>(Ks, kp, ks, t0, kend, D);
        bwd_stage<T, NS>(Vs, vp, ks, t0, kend, D);
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < BWD_RPW; ++rr) {
            if (qpos[rr] < 0) continue;
            const int nvalid = min((causal ? qpos[rr] + 1 : S) - t0, BWD_TK);
            if (nvalid <= 0) continue;  // the whole tile lies above this row's diagonal
            const float s = bwd_dots<NS>(qr[rr], Ks, lane);
            const float dp = bwd_dots<NS>(gr[rr], Vs, lane);
            const float sv = lane < nvalid ? s : -INFINITY;
            const float m_new = fmaxf(m[rr], bwd_warp_max(sv));  // finite: key t0 is valid
            const float p = lane < nvalid ? expf(s - m_new) : 0.0f;
            const float rescale = expf(m[rr] - m_new);
            l[rr] = l[rr] * rescale + bwd_warp_sum(p);
            u[rr] = u[rr] * rescale + bwd_warp_sum(p * dp);
            m[rr] = m_new;
        }
    }
    float ls[BWD_RPW];
#pragma unroll
    for (int rr = 0; rr < BWD_RPW; ++rr) {
        ls[rr] = m[rr] + logf(l[rr]);
        dd[rr] = qpos[rr] >= 0 ? u[rr] / l[rr] : 0.0f;  // D_s = sum_t P_st dP_st
    }

    // sweep 2: P, dP and dS per key; dQ += dS k
    for (int t0 = 0; t0 < kend; t0 += BWD_TK) {
        __syncthreads();
        bwd_stage<T, NS>(Ks, kp, ks, t0, kend, D);
        bwd_stage<T, NS>(Vs, vp, ks, t0, kend, D);
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < BWD_RPW; ++rr) {
            if (qpos[rr] < 0) continue;
            const int nvalid = min((causal ? qpos[rr] + 1 : S) - t0, BWD_TK);
            if (nvalid <= 0) continue;
            const float s = bwd_dots<NS>(qr[rr], Ks, lane);
            const float dp = bwd_dots<NS>(gr[rr], Vs, lane);
            const float p = lane < nvalid ? expf(s - ls[rr]) : 0.0f;
            const float dsv = p * (dp - dd[rr]);
            for (int j = 0; j < nvalid; ++j) {
                const float dsj = __shfl_sync(0xffffffffu, dsv, j);
#pragma unroll
                for (int i = 0; i < NS; ++i) acc[rr][i] += dsj * Ks[j * DP + lane + 32 * i];
            }
        }
    }
#pragma unroll
    for (int rr = 0; rr < BWD_RPW; ++rr) {
        if (qpos[rr] < 0) continue;
        T* dst = dq + b * db + head[rr] * dh + (int64_t)qpos[rr] * ds;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int d = lane + 32 * i;
            if (d < D) dst[d] = att_from_f32<T>(acc[rr][i] * scale);
        }
        if (lane == 0) {
            const int64_t at = ((int64_t)b * Hq + head[rr]) * S + qpos[rr];
            lse[at] = ls[rr];
            dsum[at] = dd[rr];
        }
    }
}

// ---------------------------------------------------------------------------------------------
// pass B: dK and dV
// ---------------------------------------------------------------------------------------------

template <typename T, int NS>
__global__ void __launch_bounds__(BWD_WARPS * 32)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, T* __restrict__ dk, T* __restrict__ dv,
                     const float* __restrict__ lse, const float* __restrict__ dsum, int Hq,
                     int S, int G, int D, int64_t qb, int64_t qh, int64_t qs, int64_t kb,
                     int64_t kh, int64_t ks, int64_t gb, int64_t gh, int64_t gs, int64_t eb,
                     int64_t eh, int64_t es, int causal, float scale) {
    constexpr int DP = 32 * NS;
    extern __shared__ float bwd_smem[];
    float* Qs = bwd_smem;                 // BWD_TK query rows, scaled by `scale`
    float* Gs = bwd_smem + BWD_TK * DP;   // their dO rows
    float* Ls = Gs + BWD_TK * DP;         // their lse
    float* Ds = Ls + BWD_TK;              // their D
    int* Ps = reinterpret_cast<int*>(Ds + BWD_TK);  // their positions (-1 past the end)
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = blockIdx.y, b = blockIdx.z;
    const int rows = S * G;
    const int t_first = blockIdx.x * (BWD_WARPS * BWD_RPW);

    float kr[BWD_RPW][NS], vr[BWD_RPW][NS], ak[BWD_RPW][NS], av[BWD_RPW][NS];
    int key[BWD_RPW];
#pragma unroll
    for (int rr = 0; rr < BWD_RPW; ++rr) {
        const int t = t_first + rr * BWD_WARPS + warp;
        key[rr] = t < S ? t : -1;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int d = lane + 32 * i;
            const bool in = key[rr] >= 0 && d < D;
            const int64_t at = b * kb + h * kh + (int64_t)key[rr] * ks + d;
            kr[rr][i] = in ? att_to_f32(k[at]) : 0.0f;
            vr[rr][i] = in ? att_to_f32(v[at]) : 0.0f;
            ak[rr][i] = av[rr][i] = 0.0f;
        }
    }
    // the first query row that sees the block's first key
    const int r_begin = causal ? t_first * G : 0;

    for (int r0 = r_begin; r0 < rows; r0 += BWD_TK) {
        __syncthreads();  // the previous tile is consumed
        for (int e = threadIdx.x; e < BWD_TK * DP; e += blockDim.x) {
            const int j = e / DP, d = e - j * DP;
            const int r = r0 + j;
            const bool in = r < rows && d < D;
            const int64_t hq = h * G + (in ? r % G : 0), sq = in ? r / G : 0;
            Qs[e] = in ? att_to_f32(q[b * qb + hq * qh + sq * qs + d]) * scale : 0.0f;
            Gs[e] = in ? att_to_f32(dout[b * gb + hq * gh + sq * gs + d]) : 0.0f;
        }
        if (threadIdx.x < BWD_TK) {
            const int r = r0 + threadIdx.x;
            const bool in = r < rows;
            const int64_t at = in ? ((int64_t)b * Hq + h * G + r % G) * S + r / G : 0;
            Ls[threadIdx.x] = in ? lse[at] : 0.0f;
            Ds[threadIdx.x] = in ? dsum[at] : 0.0f;
            Ps[threadIdx.x] = in ? r / G : -1;
        }
        __syncthreads();
        const int nrows = min(rows - r0, BWD_TK);
#pragma unroll
        for (int rr = 0; rr < BWD_RPW; ++rr) {
            if (key[rr] < 0) continue;
            const int sp = Ps[lane];
            const bool valid = sp >= 0 && (!causal || sp >= key[rr]);
            if (!__any_sync(0xffffffffu, valid)) continue;  // the tile lies before this key
            const float s = bwd_dots<NS>(kr[rr], Qs, lane);
            const float dp = bwd_dots<NS>(vr[rr], Gs, lane);
            const float p = valid ? expf(s - Ls[lane]) : 0.0f;
            const float dsv = p * (dp - Ds[lane]);
            for (int j = 0; j < nrows; ++j) {
                const float pj = __shfl_sync(0xffffffffu, p, j);
                const float dsj = __shfl_sync(0xffffffffu, dsv, j);
#pragma unroll
                for (int i = 0; i < NS; ++i) {
                    av[rr][i] += pj * Gs[j * DP + lane + 32 * i];
                    ak[rr][i] += dsj * Qs[j * DP + lane + 32 * i];
                }
            }
        }
    }
#pragma unroll
    for (int rr = 0; rr < BWD_RPW; ++rr) {
        if (key[rr] < 0) continue;
        const int64_t at = b * eb + h * eh + (int64_t)key[rr] * es;
#pragma unroll
        for (int i = 0; i < NS; ++i) {
            const int d = lane + 32 * i;
            if (d < D) {
                dk[at + d] = att_from_f32<T>(ak[rr][i]);
                dv[at + d] = att_from_f32<T>(av[rr][i]);
            }
        }
    }
}

// ---------------------------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------------------------

template <typename K>
static cudaError_t bwd_smem_attr(K kernel, int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <typename T, int NS>
static int launch_bwd(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      void* dk, void* dv, float* lse, float* dsum, int B, int Hq, int Hkv, int S,
                      int D, const int64_t* st, int causal, float scale, cudaStream_t stream) {
    const int G = Hq / Hkv, rows = S * G, per_block = BWD_WARPS * BWD_RPW;
    const int smem_a = 2 * BWD_TK * 32 * NS * (int)sizeof(float);
    const int smem_b = smem_a + 3 * BWD_TK * (int)sizeof(float);
    cudaError_t e = bwd_smem_attr(flash_bwd_dq_kernel<T, NS>, smem_a);
    if (e != cudaSuccess) return (int)e;
    e = bwd_smem_attr(flash_bwd_dkv_kernel<T, NS>, smem_b);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid_a((rows + per_block - 1) / per_block, Hkv, B);
    flash_bwd_dq_kernel<T, NS><<<grid_a, BWD_WARPS * 32, smem_a, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dq, lse, dsum, Hq, S, G, D,
        st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10], st[11],
        causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const dim3 grid_b((S + per_block - 1) / per_block, Hkv, B);
    flash_bwd_dkv_kernel<T, NS><<<grid_b, BWD_WARPS * 32, smem_b, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (T*)dk, (T*)dv, lse, dsum, Hq, S,
        G, D, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13],
        st[14], causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_bwd_d(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, float* lse, float* dsum, int B, int Hq, int Hkv,
                        int S, int D, const int64_t* st, int causal, float scale,
                        cudaStream_t s) {
#define BWD_ARGS q, k, v, dout, dq, dk, dv, lse, dsum, B, Hq, Hkv, S, D, st, causal, scale, s
    if (D <= 32) return launch_bwd<T, 1>(BWD_ARGS);
    if (D <= 64) return launch_bwd<T, 2>(BWD_ARGS);
    if (D <= 128) return launch_bwd<T, 4>(BWD_ARGS);
    if (D <= 256) return launch_bwd<T, 8>(BWD_ARGS);
#undef BWD_ARGS
    return (int)cudaErrorInvalidValue;
}

// q, dout, dq (B, Hq, S, D) and k, v, dk, dv (B, Hkv, S, D), the head dimension contiguous,
// with element strides `strides` = (q: b, h, s; k and v: b, h, s; dout: b, h, s; dq: b, h, s;
// dk and dv: b, h, s); lse and dsum: float32 scratch of B*Hq*S each, contiguous (B, Hq, S).
// `bf16_in` = 1 for bfloat16 tensors, 0 for float32. Launches pass A then pass B on `stream`;
// returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_run(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       float* lse, float* dsum, int B, int Hq, int Hkv, int S,
                                       int D, const int64_t* strides, int causal, float scale,
                                       int bf16_in, void* stream) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    return bf16_in ? launch_bwd_d<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse, dsum, B, Hq,
                                                Hkv, S, D, strides, causal, scale, st)
                   : launch_bwd_d<float>(q, k, v, dout, dq, dk, dv, lse, dsum, B, Hq, Hkv, S,
                                         D, strides, causal, scale, st);
}

// ---------------------------------------------------------------------------------------------
// tensor-core route (bfloat16, D in {64, 80, 128})
// ---------------------------------------------------------------------------------------------
//
// Fragments of mma.sync m16n8k16 (attention.cuh's att_mma): an m16n8 accumulator holds, on lane
// l, rows l/4 and l/4 + 8 at columns 2*(l%4) and 2*(l%4) + 1 (c[0], c[1] the first row's, c[2],
// c[3] the second's). Two adjacent 8-column accumulators, rounded to bf16 pairs, are an m16k16 A
// fragment, so P, dS and their transposes feed the next product from registers.

#define BT_ROWS 64      // query rows of a pass-A block, keys of a pass-B block: four warps of 16
#define BT_KEYS 64      // keys of a pass-A tile
#define BT_THREADS 128

// rows [r0, r0 + n) of `src` (row stride `st`, D columns) into `dst` (row stride D + 8) by
// cp.async; rows at or past `end` are zero and read nothing. Called by every thread.
template <int D>
__device__ __forceinline__ void bt_stage(att_bf16* __restrict__ dst,
                                         const att_bf16* __restrict__ src, int64_t st, int r0,
                                         int n, int end) {
    constexpr int NCH = D / 8;  // 16-byte chunks a row
    for (int e = threadIdx.x; e < n * NCH; e += BT_THREADS) {
        const int i = e / NCH, c = e - i * NCH;
        const bool in = r0 + i < end;
        const int64_t at = (int64_t)(in ? r0 + i : 0) * st + c * 8;
        att_cp_async16(dst + i * (D + 8) + c * 8, src + at, in);
    }
}

// acc (16 x 8N) += x . t^T: x the 16 rows of `xs` from row r0, t the 8N rows of `ts` from row 0,
// both D columns wide (row stride D + 8). x is the A operand, t's rows the B operand's columns.
template <int D, int N>
__device__ __forceinline__ void bt_mma_nt(float (&acc)[N][4], const att_bf16* xs, int r0,
                                          const att_bf16* ts, int lane) {
    constexpr int DP = D + 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t a[4];
        att_ldmatrix_x4(a, xs + (r0 + (lane & 15)) * DP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int n2 = 0; n2 < N / 2; ++n2) {
            uint32_t bb[4];
            att_ldmatrix_x4(bb, ts + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * DP + kk * 16
                                    + ((lane >> 3) & 1) * 8);
            att_mma(acc[2 * n2], a, bb[0], bb[1]);
            att_mma(acc[2 * n2 + 1], a, bb[2], bb[3]);
        }
    }
}

// acc (16 x D) += p . t: p (16 x 8N) in the accumulator layout, rounded to bf16 here as the A
// operand; t the 8N rows of `ts` (row stride D + 8) through ldmatrix.trans as the B operand.
template <int D, int N>
__device__ __forceinline__ void bt_mma_pn(float (&acc)[D / 8][4], const float (&p)[N][4],
                                          const att_bf16* ts, int lane) {
    constexpr int DP = D + 8;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
        uint32_t a[4];
        a[0] = att_pack(p[2 * j][0], p[2 * j][1]);
        a[1] = att_pack(p[2 * j][2], p[2 * j][3]);
        a[2] = att_pack(p[2 * j + 1][0], p[2 * j + 1][1]);
        a[3] = att_pack(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
            uint32_t bb[4];
            att_ldmatrix_x4_trans(bb, ts + (j * 16 + (lane & 15)) * DP + n2 * 16 + (lane >> 4) * 8);
            att_mma(acc[2 * n2], a, bb[0], bb[1]);
            att_mma(acc[2 * n2 + 1], a, bb[2], bb[3]);
        }
    }
}

template <int N>
__device__ __forceinline__ void bt_zero(float (&x)[N][4]) {
#pragma unroll
    for (int n = 0; n < N; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
}

// s = Q K^T, scaled by scale*log2(e) and -inf above the diagonal and past S, and dp = dO V^T:
// this warp's 16 rows of the staged Q and dO (this thread's rows ra and ra + 8) against the
// BT_KEYS keys of the staged tile Kt, Vt, the first of them key t0; s0 the block's first row
template <int D>
__device__ __forceinline__ void bt_scores(float (&s)[BT_KEYS / 8][4], float (&dp)[BT_KEYS / 8][4],
                                          const att_bf16* Qs, const att_bf16* Gs,
                                          const att_bf16* Kt, const att_bf16* Vt, int t0, int s0,
                                          int ra, int S, int causal, float scale_log2, int warp,
                                          int lane) {
    constexpr int NB = BT_KEYS / 8;
    bt_zero(s);
    bt_zero(dp);
    bt_mma_nt<D, NB>(s, Qs, warp * 16, Kt, lane);
    bt_mma_nt<D, NB>(dp, Gs, warp * 16, Vt, lane);
    const bool need_mask = t0 + BT_KEYS > S || (causal && t0 + BT_KEYS - 1 > s0);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            float x = s[n][e] * scale_log2;
            if (need_mask) {
                const int key = t0 + n * 8 + 2 * (lane & 3) + (e & 1);
                const int row = e < 2 ? ra : ra + 8;
                if (key >= S || (causal && key > row)) x = -INFINITY;
            }
            s[n][e] = x;
        }
    }
}

// pass A: lse, D and dQ of 64 query rows of one query head
template <int D>
__global__ void __launch_bounds__(BT_THREADS)
flash_bwd_tc_dq_kernel(const att_bf16* __restrict__ q, const att_bf16* __restrict__ k,
                       const att_bf16* __restrict__ v, const att_bf16* __restrict__ dout,
                       att_bf16* __restrict__ dq, float* __restrict__ lse,
                       float* __restrict__ dsum, int B, int Hq, int S, int Sp, int G,
                       int64_t qb, int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks,
                       int64_t gb, int64_t gh, int64_t gs, int64_t ob, int64_t oh, int64_t os,
                       int causal, float scale) {
    constexpr int DP = D + 8, ND = D / 8, NB = BT_KEYS / 8;
    extern __shared__ __align__(16) unsigned char bt_smem[];
    att_bf16* Qs = reinterpret_cast<att_bf16*>(bt_smem);  // BT_ROWS x DP
    att_bf16* Gs = Qs + BT_ROWS * DP;                      // their dO rows
    att_bf16* Ks = Gs + BT_ROWS * DP;                      // 2 stages x BT_KEYS x DP
    att_bf16* Vs = Ks + 2 * BT_KEYS * DP;                  // 2 stages x BT_KEYS x DP

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // tile-major over every (query head, request), causal tiles longest first
    const int heads = Hq * B, ntile = (int)gridDim.x / heads;
    const int hb = (int)blockIdx.x % heads, h = hb % Hq, b = hb / Hq;
    const int tile = causal ? ntile - 1 - (int)blockIdx.x / heads : (int)blockIdx.x / heads;
    const int s0 = tile * BT_ROWS;
    const int kend = causal ? min(s0 + BT_ROWS, S) : S;
    const int ntiles = (kend + BT_KEYS - 1) / BT_KEYS;
    const att_bf16* kp = k + b * kb + (int64_t)(h / G) * kh;
    const att_bf16* vp = v + b * kb + (int64_t)(h / G) * kh;  // v has k's strides

    bt_stage<D>(Qs, q + b * qb + h * qh, qs, s0, BT_ROWS, S);
    bt_stage<D>(Gs, dout + b * gb + h * gh, gs, s0, BT_ROWS, S);
    att_cp_async_commit();
    auto stage_kv = [&](int it) {
        const int st = it & 1;
        bt_stage<D>(Ks + st * BT_KEYS * DP, kp, ks, it * BT_KEYS, BT_KEYS, kend);
        bt_stage<D>(Vs + st * BT_KEYS * DP, vp, ks, it * BT_KEYS, BT_KEYS, kend);
    };

    // this thread's rows: ra (accumulator halves 0, 1) and ra + 8 (halves 2, 3); a row at or
    // past S has zero q and dO, is masked at keys >= S only, and is never stored
    const int ra = s0 + warp * 16 + (lane >> 2);
    const float scale_log2 = scale * 1.4426950408889634f;
    float s[NB][4], dp[NB][4];
    // sweep 1: the rows' running max m, sum l and u = sum exp2(S - m) dP (l, u: this lane's
    // columns, summed over the quad at the end)
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f, u_a = 0.0f, u_b = 0.0f;
    stage_kv(0);
    att_cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles) stage_kv(it + 1);
        att_cp_async_commit();
        att_cp_async_wait<1>();  // tile it (and Q, dO) has landed
        __syncthreads();
        bt_scores<D>(s, dp, Qs, Gs, Ks + (it & 1) * BT_KEYS * DP, Vs + (it & 1) * BT_KEYS * DP,
                     it * BT_KEYS, s0, ra, S, causal, scale_log2, warp, lane);
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
            mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // a row with no valid key yet keeps m = -inf; exp2 against 0 then gives 0
        const float base_a = mn_a == -INFINITY ? 0.0f : mn_a;
        const float base_b = mn_b == -INFINITY ? 0.0f : mn_b;
        const float al_a = exp2f(m_a - base_a), al_b = exp2f(m_b - base_b);
        float ps_a = 0.0f, ps_b = 0.0f, pu_a = 0.0f, pu_b = 0.0f;
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            const float p0 = exp2f(s[n][0] - base_a), p1 = exp2f(s[n][1] - base_a);
            const float p2 = exp2f(s[n][2] - base_b), p3 = exp2f(s[n][3] - base_b);
            ps_a += p0 + p1;
            ps_b += p2 + p3;
            pu_a += p0 * dp[n][0] + p1 * dp[n][1];
            pu_b += p2 * dp[n][2] + p3 * dp[n][3];
        }
        l_a = l_a * al_a + ps_a;
        l_b = l_b * al_b + ps_b;
        u_a = u_a * al_a + pu_a;
        u_b = u_b * al_b + pu_b;
        m_a = mn_a;
        m_b = mn_b;
        __syncthreads();  // the stage is consumed before the next tile refills it
    }
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
        u_a += __shfl_xor_sync(0xffffffffu, u_a, o2);
        u_b += __shfl_xor_sync(0xffffffffu, u_b, o2);
    }
    // every row sees key 0, so l > 0
    const float lse_a = m_a + log2f(l_a), lse_b = m_b + log2f(l_b);
    const float d_a = u_a / l_a, d_b = u_b / l_b;  // D = sum_t P dP
    if ((lane & 3) == 0) {  // every row of the tile, those past S too (pass B reads whole tiles)
        const int64_t at = ((int64_t)b * Hq + h) * Sp + ra;
        lse[at] = lse_a;
        lse[at + 8] = lse_b;
        dsum[at] = d_a;
        dsum[at + 8] = d_b;
    }

    // sweep 2: P = exp2(S - lse), dS = P (dP - D); dQ += dS K
    float acc[ND][4];
    bt_zero(acc);
    stage_kv(0);
    att_cp_async_commit();
    for (int it = 0; it < ntiles; ++it) {
        if (it + 1 < ntiles) stage_kv(it + 1);
        att_cp_async_commit();
        att_cp_async_wait<1>();
        __syncthreads();
        bt_scores<D>(s, dp, Qs, Gs, Ks + (it & 1) * BT_KEYS * DP, Vs + (it & 1) * BT_KEYS * DP,
                     it * BT_KEYS, s0, ra, S, causal, scale_log2, warp, lane);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
            s[n][0] = exp2f(s[n][0] - lse_a) * (dp[n][0] - d_a);
            s[n][1] = exp2f(s[n][1] - lse_a) * (dp[n][1] - d_a);
            s[n][2] = exp2f(s[n][2] - lse_b) * (dp[n][2] - d_b);
            s[n][3] = exp2f(s[n][3] - lse_b) * (dp[n][3] - d_b);
        }
        bt_mma_pn<D, NB>(acc, s, Ks + (it & 1) * BT_KEYS * DP, lane);
        __syncthreads();
    }
    const int col = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = ra + 8 * half;
        if (row >= S) continue;
        att_bf16* dst = dq + b * ob + h * oh + (int64_t)row * os + col;
#pragma unroll
        for (int n = 0; n < ND; ++n)
            *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) = __floats2bfloat162_rn(
                acc[n][2 * half] * scale, acc[n][2 * half + 1] * scale);
    }
}

// pass B: dK and dV of 64 keys from one query head's rows, BQ query rows a tile
template <int D, int BQ>
__global__ void __launch_bounds__(BT_THREADS)
flash_bwd_tc_dkv_kernel(const att_bf16* __restrict__ q, const att_bf16* __restrict__ k,
                        const att_bf16* __restrict__ v, const att_bf16* __restrict__ dout,
                        att_bf16* __restrict__ dk, att_bf16* __restrict__ dv,
                        float* __restrict__ part, const float* __restrict__ lse,
                        const float* __restrict__ dsum, int B, int Hq, int S, int Sp, int G,
                        int64_t qb, int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks,
                        int64_t gb, int64_t gh, int64_t gs, int64_t eb, int64_t eh, int64_t es,
                        int causal, float scale) {
    constexpr int DP = D + 8, ND = D / 8, NB = BQ / 8;
    extern __shared__ __align__(16) unsigned char bt_smem[];
    att_bf16* Ks = reinterpret_cast<att_bf16*>(bt_smem);  // BT_ROWS x DP
    att_bf16* Vs = Ks + BT_ROWS * DP;                      // BT_ROWS x DP
    att_bf16* Qs = Vs + BT_ROWS * DP;                      // 2 stages x BQ x DP
    att_bf16* Gs = Qs + 2 * BQ * DP;                       // 2 stages x BQ x DP (dO)
    float* Ls = reinterpret_cast<float*>(Gs + 2 * BQ * DP);  // 2 stages x BQ: lse
    float* Ds = Ls + 2 * BQ;                                 // 2 stages x BQ: D

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    // tile-major over every (query head, request); a causal block's query loop starts at its
    // own tile, so ascending tiles run longest first
    const int heads = Hq * B;
    const int hb = (int)blockIdx.x % heads, h = hb % Hq, b = hb / Hq, hk = h / G;
    const int t0 = (int)blockIdx.x / heads * BT_ROWS;
    const att_bf16* qp = q + b * qb + h * qh;
    const att_bf16* gp = dout + b * gb + h * gh;
    const float* lp = lse + ((int64_t)b * Hq + h) * Sp;
    const float* dpp = dsum + ((int64_t)b * Hq + h) * Sp;

    bt_stage<D>(Ks, k + b * kb + (int64_t)hk * kh, ks, t0, BT_ROWS, S);
    bt_stage<D>(Vs, v + b * kb + (int64_t)hk * kh, ks, t0, BT_ROWS, S);  // v has k's strides
    att_cp_async_commit();
    const int q_begin = causal ? t0 : 0;
    const int nq = (S - q_begin + BQ - 1) / BQ;
    // query rows [q_begin + it*BQ, + BQ) into stage it & 1, with their lse and D (written by
    // pass A for every row below Sp, so whole tiles are read)
    auto stage_q = [&](int it) {
        const int st = it & 1, r0 = q_begin + it * BQ;
        bt_stage<D>(Qs + st * BQ * DP, qp, qs, r0, BQ, S);
        bt_stage<D>(Gs + st * BQ * DP, gp, gs, r0, BQ, S);
        if (tid < BQ / 4)
            att_cp_async16(Ls + st * BQ + tid * 4, lp + r0 + tid * 4, true);
        else if (tid < BQ / 2)
            att_cp_async16(Ds + st * BQ + (tid - BQ / 4) * 4, dpp + r0 + (tid - BQ / 4) * 4, true);
    };

    // this thread's keys: ka (accumulator halves 0, 1) and ka + 8 (halves 2, 3)
    const int ka = t0 + warp * 16 + (lane >> 2);
    const float scale_log2 = scale * 1.4426950408889634f;
    float ak[ND][4], av[ND][4];
    bt_zero(ak);
    bt_zero(av);
    stage_q(0);
    att_cp_async_commit();
    for (int it = 0; it < nq; ++it) {
        if (it + 1 < nq) stage_q(it + 1);
        att_cp_async_commit();
        att_cp_async_wait<1>();  // tile it (and K, V) has landed
        __syncthreads();
        const att_bf16* Qt = Qs + (it & 1) * BQ * DP;
        const att_bf16* Gt = Gs + (it & 1) * BQ * DP;
        const float* Lt = Ls + (it & 1) * BQ;
        const float* Dt = Ds + (it & 1) * BQ;
        const int q0 = q_begin + it * BQ;
        // S^T = K Q^T and dP^T = V dO^T: 16 keys x BQ query rows a warp
        float st[NB][4], dpt[NB][4];
        bt_zero(st);
        bt_zero(dpt);
        bt_mma_nt<D, NB>(st, Ks, warp * 16, Qt, lane);
        bt_mma_nt<D, NB>(dpt, Vs, warp * 16, Gt, lane);
        // P^T = exp2(S^T scale log2(e) - lse), zero below the diagonal and past S; dS^T
        const bool need_mask = q0 + BQ > S || (causal && q0 < t0 + BT_ROWS);
#pragma unroll
        for (int n = 0; n < NB; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int c = n * 8 + 2 * (lane & 3) + (e & 1);
                const int key = e < 2 ? ka : ka + 8;
                const bool valid = !need_mask || (q0 + c < S && (!causal || q0 + c >= key));
                const float p = valid ? exp2f(st[n][e] * scale_log2 - Lt[c]) : 0.0f;
                st[n][e] = p;
                dpt[n][e] = p * (dpt[n][e] - Dt[c]);
            }
        }
        bt_mma_pn<D, NB>(av, st, Gt, lane);   // dV += P^T dO
        bt_mma_pn<D, NB>(ak, dpt, Qt, lane);  // dK += dS^T Q
        __syncthreads();  // the stage is consumed before the next tile refills it
    }

    const int col = 2 * (lane & 3);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int key = ka + 8 * half;
        if (key >= S) continue;
        if (G == 1) {  // the KV head's only query head: the result itself, rounded
            att_bf16* pk = dk + b * eb + hk * eh + (int64_t)key * es + col;
            att_bf16* pv = dv + b * eb + hk * eh + (int64_t)key * es + col;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                *reinterpret_cast<__nv_bfloat162*>(pk + n * 8) = __floats2bfloat162_rn(
                    ak[n][2 * half] * scale, ak[n][2 * half + 1] * scale);
                *reinterpret_cast<__nv_bfloat162*>(pv + n * 8) =
                    __floats2bfloat162_rn(av[n][2 * half], av[n][2 * half + 1]);
            }
        } else {  // this query head's float32 partials, (2, B, Hq, S, D)
            float* pk = part + (((int64_t)b * Hq + h) * S + key) * D + col;
            float* pv = pk + (int64_t)B * Hq * S * D;
#pragma unroll
            for (int n = 0; n < ND; ++n) {
                *reinterpret_cast<float2*>(pk + n * 8) =
                    make_float2(ak[n][2 * half] * scale, ak[n][2 * half + 1] * scale);
                *reinterpret_cast<float2*>(pv + n * 8) =
                    make_float2(av[n][2 * half], av[n][2 * half + 1]);
            }
        }
    }
}

// dK, dV of each KV head: its G query heads' partials (2, B, Hq, S, D) summed in ascending g,
// rounded to bf16 into the model's layout. A thread a group of 4 head dimensions.
__global__ void __launch_bounds__(256)
flash_bwd_tc_reduce_kernel(const float* __restrict__ part, att_bf16* __restrict__ dk,
                           att_bf16* __restrict__ dv, int B, int Hkv, int S, int D, int G,
                           int64_t eb, int64_t eh, int64_t es) {
    const int nd4 = D / 4;
    const int64_t total = 2LL * B * Hkv * S * nd4;
    const int64_t head = (int64_t)S * D / 4;  // float4s between two query heads' partials
    for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (int64_t)gridDim.x * blockDim.x) {
        int64_t r = i;
        const int c = (int)(r % nd4);
        r /= nd4;
        const int s = (int)(r % S);
        r /= S;
        const int hk = (int)(r % Hkv);
        r /= Hkv;
        const int b = (int)(r % B), which = (int)(r / B);
        const float4* src = reinterpret_cast<const float4*>(
                                part + ((((int64_t)which * B + b) * Hkv + hk) * G * S + s) * D) + c;
        float4 acc = src[0];
        for (int g = 1; g < G; ++g) {
            const float4 x = src[g * head];
            acc.x += x.x;
            acc.y += x.y;
            acc.z += x.z;
            acc.w += x.w;
        }
        att_bf16* dst = (which ? dv : dk) + b * eb + hk * eh + (int64_t)s * es + c * 4;
        reinterpret_cast<__nv_bfloat162*>(dst)[0] = __floats2bfloat162_rn(acc.x, acc.y);
        reinterpret_cast<__nv_bfloat162*>(dst)[1] = __floats2bfloat162_rn(acc.z, acc.w);
    }
}

template <int D, int BQ>
static int launch_bwd_tc(const void* q, const void* k, const void* v, const void* dout, void* dq,
                         void* dk, void* dv, float* lse, float* dsum, float* part, int B, int Hq,
                         int Hkv, int S, const int64_t* st, int causal, float scale,
                         cudaStream_t stream) {
    const int G = Hq / Hkv, ntile = (S + BT_ROWS - 1) / BT_ROWS, Sp = ntile * BT_ROWS;
    const int smem_a = (2 * BT_ROWS + 4 * BT_KEYS) * (D + 8) * (int)sizeof(att_bf16);
    const int smem_b = (2 * BT_ROWS + 4 * BQ) * (D + 8) * (int)sizeof(att_bf16)
                       + 4 * BQ * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(flash_bwd_tc_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(flash_bwd_tc_dkv_kernel<D, BQ>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_b);
    if (e != cudaSuccess) return (int)e;
    const int grid = ntile * Hq * B;
    flash_bwd_tc_dq_kernel<D><<<grid, BT_THREADS, smem_a, stream>>>(
        (const att_bf16*)q, (const att_bf16*)k, (const att_bf16*)v, (const att_bf16*)dout,
        (att_bf16*)dq, lse, dsum, B, Hq, S, Sp, G, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7], st[8], st[9], st[10], st[11], causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    flash_bwd_tc_dkv_kernel<D, BQ><<<grid, BT_THREADS, smem_b, stream>>>(
        (const att_bf16*)q, (const att_bf16*)k, (const att_bf16*)v, (const att_bf16*)dout,
        (att_bf16*)dk, (att_bf16*)dv, part, lse, dsum, B, Hq, S, Sp, G, st[0], st[1], st[2],
        st[3], st[4], st[5], st[6], st[7], st[8], st[12], st[13], st[14], causal, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess || G == 1) return (int)e;
    const int64_t total = 2LL * B * Hkv * S * (D / 4);
    const int64_t want = (total + 255) / 256;
    const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
    flash_bwd_tc_reduce_kernel<<<blocks, 256, 0, stream>>>(part, (att_bf16*)dk, (att_bf16*)dv, B,
                                                          Hkv, S, D, G, st[12], st[13], st[14]);
    return (int)cudaGetLastError();
}

// The tensor-core route: bfloat16 q, k, v, dout, dq, dk, dv at D in {64, 80, 128}, every pointer
// and row stride 16-byte aligned (the wrapper checks it), strides as flash_attention_bwd_run's;
// lse and dsum float32 scratch of B*Hq*Sp each, Sp = S rounded up to a multiple of 64; `part`
// float32 scratch (2, B, Hq, S, D) when Hq > Hkv (unused, may be null, when Hq == Hkv). Launches
// pass A, pass B and, when Hq > Hkv, the sum over the G heads on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_bwd_tc_run(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          float* lse, float* dsum, float* part, int B, int Hq,
                                          int Hkv, int S, int D, const int64_t* strides,
                                          int causal, float scale, void* stream) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
    if (Hq > Hkv && part == nullptr) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
#define BWD_TC_ARGS q, k, v, dout, dq, dk, dv, lse, dsum, part, B, Hq, Hkv, S, strides, causal, \
                    scale, st
    if (D == 64) return launch_bwd_tc<64, 64>(BWD_TC_ARGS);
    if (D == 80) return launch_bwd_tc<80, 64>(BWD_TC_ARGS);
    if (D == 128) return launch_bwd_tc<128, 32>(BWD_TC_ARGS);
#undef BWD_TC_ARGS
    return (int)cudaErrorInvalidValue;
}
