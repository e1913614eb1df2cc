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
// the dK and dV of a KV head summed over its G query heads. D_s equals dO_s . o_s; it is
// taken as the sum over the recomputed P and dP in float32, which the plain version's
// softmax backward computes too, and not from the forward's output rounded to bfloat16: with
// that, sum_t dS_st is no longer ~0 to float32's precision, and the rounding of o adds to
// gradients that cancel (a key projection's, whose bias gradient is exactly zero). Replaces no TPU kernel: the
// reference differentiates its plain attention with XLA (src/repro/models/common.py:169-244)
// and no Pallas kernel of the repository has a VJP. It is the backward of
// flash_attention.cu (kernels/ops.py's autograd Function), so training on the card never
// runs attention's gradient through the plain version. The plain version is the autograd
// gradient of repro_torch.kernels.flash_attention.flash_attention_plain.
//
// What bounds it: operations, 10*B*Hq*D*S^2 (halved when causal: five products of the
// forward's size) against bytes that are read once; the card's bound is the bf16 tensor-core
// peak. This first kernel runs on the CUDA cores in float32 (a simple kernel that is right:
// both types, any head_dim up to 256, any S, GQA), so it sits far above that bound.
//
// Design: two passes, both in the SIMT layout of the forward's SIMT route (a row's head
// dimensions d = lane + 32*i, i < NS, spread over the 32 lanes of a warp; 32 rows of the
// other operand staged in shared memory as float32, one per lane; a butterfly
// transpose-reduction leaves row j's dot product on lane j).
//
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
