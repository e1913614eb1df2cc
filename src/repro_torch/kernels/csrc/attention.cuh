// Shared device code of the two attention kernels (flash_attention.cu, decode_attention.cu):
// the online softmax of one query row over one staged tile of keys, spread over a warp.
//
// Layout of a row's state: lane l holds the query and the running output for the head
// dimensions d = l + 32*i, i < NS (NS = ceil(D / 32), so D <= 32*NS). The row's running
// max m and sum l are the same on every lane. Everything is float32, whatever the input type.
//
// A tile holds TK = 32 keys (one per lane) in shared memory as float32, row stride 32*NS, the
// dimensions d >= D zero-filled, so the inner loops need no guard. Scores are formed without any
// matrix library: each lane takes the partial dot products of its NS dimensions with all 32 keys,
// then a butterfly transpose-reduction (31 shuffles) leaves the full score of key j on lane j.
// The exponentials and sums follow; p_j is broadcast with one shuffle per key for the PV product.
// No atomics, and every reduction has a fixed order, so two runs are bitwise equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define ATT_TK 32       // keys per staged tile: one per lane
#define ATT_WARPS 8     // warps per block
#define ATT_RPW 4       // query rows per warp

__device__ __forceinline__ float att_to_f32(float x) { return x; }
__device__ __forceinline__ float att_to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T att_from_f32(float x);
template <> __device__ __forceinline__ float att_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 att_from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

template <int NS>
struct AttRow {
    float m, l;
    float q[NS];
    float acc[NS];
};

// The row's query (pre-scaled by `scale`, as the TPU kernel scales q before Q K^T), zeroed state.
template <typename T, int NS>
__device__ __forceinline__ void att_row_init(AttRow<NS>& r, const T* __restrict__ q, int D,
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

// Stage keys [t0, t0 + ATT_TK) of one KV head into Ks/Vs (float32, row stride 32*NS); key rows
// at or beyond `kend` and dimensions d >= D are zero. `k`/`v` point at key 0 of the head, key
// rows `ks` elements apart. Called by all threads of the block, between two __syncthreads.
template <typename T, int NS>
__device__ __forceinline__ void att_stage(float* __restrict__ Ks, float* __restrict__ Vs,
                                          const T* __restrict__ k, const T* __restrict__ v,
                                          int64_t ks, int t0, int kend, int D) {
    constexpr int DP = 32 * NS;
    for (int e = threadIdx.x; e < ATT_TK * DP; e += blockDim.x) {
        const int j = e / DP, d = e - j * DP;
        const int key = t0 + j;
        const bool in = key < kend && d < D;
        const int64_t at = (int64_t)key * ks + d;
        Ks[e] = in ? att_to_f32(k[at]) : 0.0f;
        Vs[e] = in ? att_to_f32(v[at]) : 0.0f;
    }
}

// Fold keys j < nvalid of the staged tile into the row (0 < nvalid <= ATT_TK); warp-uniform.
template <int NS>
__device__ __forceinline__ void att_fold(AttRow<NS>& r, const float* __restrict__ Ks,
                                         const float* __restrict__ Vs, int nvalid, int lane) {
    constexpr int DP = 32 * NS;
    constexpr unsigned FULL = 0xffffffffu;
    // partial dot products of this lane's dimensions with every key of the tile
    float part[ATT_TK];
#pragma unroll
    for (int j = 0; j < ATT_TK; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int i = 0; i < NS; ++i) s += r.q[i] * Ks[j * DP + lane + 32 * i];
        part[j] = s;
    }
    // butterfly transpose-reduction: after the step of width w, lane l keeps w values, those of
    // the keys whose high bits equal l's; at the end lane j holds the full score of key j
#pragma unroll
    for (int w = ATT_TK / 2; w >= 1; w >>= 1) {
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

// out[d] = acc[d] / max(l, 1e-30), in the output type.
template <typename T, int NS>
__device__ __forceinline__ void att_row_store(const AttRow<NS>& r, T* __restrict__ out, int D,
                                              int lane) {
    const float l = fmaxf(r.l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
        const int d = lane + 32 * i;
        if (d < D) out[d] = att_from_f32<T>(r.acc[i] / l);
    }
}

// Dynamic shared memory of one block: the K and V tiles.
template <int NS>
constexpr int att_smem_bytes() { return 2 * ATT_TK * 32 * NS * (int)sizeof(float); }
