// Hand-written Hopper (sm_90a) kernel for blockwise online-softmax GQA attention over a full
// sequence, causal or bidirectional (prefill and forward):
//
//   out[b, h, s, :] = softmax_t( q[b, h, s, :] . k[b, h/G, t, :] / sqrt(D) ) . v[b, h/G, t, :]
//
// over keys t <= s when causal, every key otherwise; G = Hq / Hkv query heads share a KV head.
// Replaces the TPU kernel src/repro/kernels/flash_attention.py:24 flash_attention_kernel. The
// plain version of the same function is repro_torch.kernels.flash_attention.flash_attention_plain
// (the semantics of src/repro/kernels/ref.py:15).
//
// Design. One block per (query-row tile, KV head, batch). The rows of a (b, KV head) pair are
// its G query heads at every position, flattened as r = s*G + g, so one block holds all G heads
// of 32 / G positions (ATT_WARPS warps of ATT_RPW rows) and each K/V tile staged in shared memory
// serves all of them: the GQA grouping of the TPU kernel's `h // G` BlockSpec is the block's own
// row set here. The key loop runs to the last position of the block when causal (the TPU
// kernel's `nk` bound); a row skips the tiles above its diagonal. Running (m, l, acc) stay in
// float32 registers, q is scaled by 1/sqrt(D) before Q K^T and the output is acc / max(l, 1e-30)
// in q's type, as in the TPU kernel. No atomics: two runs are bitwise equal. Any S (a ragged
// last tile is masked), any strides with a contiguous head dimension (the model's (B, S, H, D)
// layout is read in place), D <= 256, float32 or bfloat16.
//
// What bounds it on this card: at the served prompt lengths, operations. The TPU kernel's two
// products run on the MXU; here they are warp-level float32 FMAs fed from shared memory (no
// tensor cores, no matrix library), so the kernel stays well above the bf16 tensor-core bound
// (4*B*Hq*D*S^2 operations, halved when causal, at 989 TFLOP/s). Tensor-core (wgmma) tiles are
// the lever for a later change.

#include "attention.cuh"

template <typename T, int NS>
__global__ void __launch_bounds__(ATT_WARPS * 32)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S, int G, int D,
                       int64_t qb, int64_t qh, int64_t qs, int64_t kb, int64_t kh, int64_t ks,
                       int64_t ob, int64_t oh, int64_t os, int causal, float scale) {
    extern __shared__ float att_smem[];
    float* Ks = att_smem;
    float* Vs = att_smem + ATT_TK * 32 * NS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = blockIdx.y, b = blockIdx.z;
    const int rows = S * G;
    const int r0 = blockIdx.x * (ATT_WARPS * ATT_RPW);

    AttRow<NS> st[ATT_RPW];
    int qpos[ATT_RPW], head[ATT_RPW];
#pragma unroll
    for (int rr = 0; rr < ATT_RPW; ++rr) {
        const int r = r0 + rr * ATT_WARPS + warp;
        qpos[rr] = r < rows ? r / G : -1;
        head[rr] = h * G + (r < rows ? r % G : 0);
        if (qpos[rr] >= 0)
            att_row_init<T, NS>(st[rr], q + b * qb + head[rr] * qh + (int64_t)qpos[rr] * qs, D,
                                scale, lane);
    }
    const int r_last = min(r0 + ATT_WARPS * ATT_RPW, rows) - 1;
    const int kend = causal ? r_last / G + 1 : S;
    const T* kp = k + b * kb + h * kh;
    const T* vp = v + b * kb + h * kh;  // v has k's strides (checked by the wrapper)

    for (int t0 = 0; t0 < kend; t0 += ATT_TK) {
        __syncthreads();  // the previous tile is consumed
        att_stage<T, NS>(Ks, Vs, kp, vp, ks, t0, kend, D);
        __syncthreads();
#pragma unroll
        for (int rr = 0; rr < ATT_RPW; ++rr) {
            if (qpos[rr] < 0) continue;
            const int nvalid = min((causal ? qpos[rr] + 1 : S) - t0, ATT_TK);
            if (nvalid <= 0) continue;  // the whole tile lies above this row's diagonal
            att_fold<NS>(st[rr], Ks, Vs, nvalid, lane);
        }
    }
#pragma unroll
    for (int rr = 0; rr < ATT_RPW; ++rr)
        if (qpos[rr] >= 0)
            att_row_store<T, NS>(st[rr], out + b * ob + head[rr] * oh + (int64_t)qpos[rr] * os,
                                 D, lane);
}

template <typename T, int NS>
static int launch(const void* q, const void* k, const void* v, void* out, int B, int Hkv, int S,
                  int G, int D, const int64_t* st, int causal, float scale, cudaStream_t stream) {
    const int rows = S * G, per_block = ATT_WARPS * ATT_RPW;
    const dim3 grid((rows + per_block - 1) / per_block, Hkv, B);
    const int smem = att_smem_bytes<NS>();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            flash_attention_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    flash_attention_kernel<T, NS><<<grid, ATT_WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, S, G, D, st[0], st[1], st[2], st[3],
        st[4], st[5], st[6], st[7], st[8], causal, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* k, const void* v, void* out, int B, int Hkv,
                    int S, int G, int D, const int64_t* st, int causal, float scale,
                    cudaStream_t stream) {
    if (D <= 32) return launch<T, 1>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, stream);
    if (D <= 64) return launch<T, 2>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, stream);
    if (D <= 128) return launch<T, 4>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, stream);
    if (D <= 256) return launch<T, 8>(q, k, v, out, B, Hkv, S, G, D, st, causal, scale, stream);
    return (int)cudaErrorInvalidValue;
}

// q/out (B, Hq, S, D) and k/v (B, Hkv, S, D) with element strides `strides` = (q: b, h, s;
// k and v: b, h, s; out: b, h, s), the head dimension contiguous; `bf16` selects __nv_bfloat16
// over float. Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int flash_attention_run(const void* q, const void* k, const void* v, void* out,
                                   int B, int Hq, int Hkv, int S, int D,
                                   const int64_t* strides, int causal, float scale, int bf16,
                                   void* stream) {
    if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
    const int G = Hq / Hkv;
    const cudaStream_t st = (cudaStream_t)stream;
    return bf16 ? launch_d<__nv_bfloat16>(q, k, v, out, B, Hkv, S, G, D, strides, causal, scale,
                                          st)
                : launch_d<float>(q, k, v, out, B, Hkv, S, G, D, strides, causal, scale, st);
}
