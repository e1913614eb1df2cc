// Hand-written Hopper (sm_90a) kernel for single-token GQA attention against a KV cache (one
// decode step of every request):
//
//   out[b, h, :] = softmax_t( q[b, h, :] . k_cache[b, t, h/G, :] / sqrt(D) ) . v_cache[b, t, h/G, :]
//
// over the cache positions t <= pos[b] (the current token is already written at pos[b]).
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:23 decode_attention_kernel. The
// plain version of the same function is
// repro_torch.kernels.decode_attention.decode_attention_plain (src/repro/kernels/ref.py:31).
//
// Design. One block per (KV head, request), as the TPU kernel's (B, Hkv) grid: the G query
// heads of the KV head are the block's rows, one per warp (ATT_WARPS warps of up to ATT_RPW
// rows, so G <= 32), and every warp helps stage the K/V tiles. The loop stops at pos[b]: the
// chunks past it are never read, as the TPU kernel's loop bound skips them. The cache is
// (B, S, Hkv, D), so one head's rows are Hkv*D elements apart; a tile of 32 positions is staged
// into shared memory as float32 and serves all G heads. Running (m, l, acc) stay in float32,
// q is scaled by 1/sqrt(D) first and the output is acc / max(l, 1e-30) in q's type. No atomics:
// two runs are bitwise equal. Any S, D <= 256, float32 or bfloat16.
//
// What bounds it on this card: bytes, the cache rows t <= pos[b] of every KV head, read once.
// With one block per (KV head, request) a small batch fills few SMs (32 blocks at B=4, Hkv=8),
// so the kernel sits well above that bound; splitting the positions over blocks (a second pass
// to merge the partial softmaxes) is the lever for a later change.

#include "attention.cuh"

template <typename T, int NS>
__global__ void __launch_bounds__(ATT_WARPS * 32)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                        const T* __restrict__ vc, const int* __restrict__ pos,
                        T* __restrict__ out, int S, int Hkv, int G, int D, float scale) {
    extern __shared__ float att_smem[];
    float* Ks = att_smem;
    float* Vs = att_smem + ATT_TK * 32 * NS;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int h = blockIdx.x, b = blockIdx.y;
    const int Hq = Hkv * G;

    AttRow<NS> st[ATT_RPW];
#pragma unroll
    for (int rr = 0; rr < ATT_RPW; ++rr) {
        const int g = rr * ATT_WARPS + warp;
        if (g < G)
            att_row_init<T, NS>(st[rr], q + ((int64_t)b * Hq + h * G + g) * D, D, scale, lane);
    }
    const int kend = min(pos[b] + 1, S);
    const int64_t row = (int64_t)Hkv * D;  // elements between two positions of one head
    const T* kp = kc + (int64_t)b * S * row + (int64_t)h * D;
    const T* vp = vc + (int64_t)b * S * row + (int64_t)h * D;

    for (int t0 = 0; t0 < kend; t0 += ATT_TK) {
        __syncthreads();  // the previous tile is consumed
        att_stage<T, NS>(Ks, Vs, kp, vp, row, t0, kend, D);
        __syncthreads();
        const int nvalid = min(kend - t0, ATT_TK);
#pragma unroll
        for (int rr = 0; rr < ATT_RPW; ++rr)
            if (rr * ATT_WARPS + warp < G) att_fold<NS>(st[rr], Ks, Vs, nvalid, lane);
    }
#pragma unroll
    for (int rr = 0; rr < ATT_RPW; ++rr) {
        const int g = rr * ATT_WARPS + warp;
        if (g < G) att_row_store<T, NS>(st[rr], out + ((int64_t)b * Hq + h * G + g) * D, D, lane);
    }
}

template <typename T, int NS>
static int launch(const void* q, const void* kc, const void* vc, const int* pos, void* out,
                  int B, int S, int Hkv, int G, int D, float scale, cudaStream_t stream) {
    const int smem = att_smem_bytes<NS>();
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            decode_attention_kernel<T, NS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    decode_attention_kernel<T, NS><<<dim3(Hkv, B), ATT_WARPS * 32, smem, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, pos, (T*)out, S, Hkv, G, D, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_d(const void* q, const void* kc, const void* vc, const int* pos, void* out,
                    int B, int S, int Hkv, int G, int D, float scale, cudaStream_t stream) {
    if (D <= 32) return launch<T, 1>(q, kc, vc, pos, out, B, S, Hkv, G, D, scale, stream);
    if (D <= 64) return launch<T, 2>(q, kc, vc, pos, out, B, S, Hkv, G, D, scale, stream);
    if (D <= 128) return launch<T, 4>(q, kc, vc, pos, out, B, S, Hkv, G, D, scale, stream);
    if (D <= 256) return launch<T, 8>(q, kc, vc, pos, out, B, S, Hkv, G, D, scale, stream);
    return (int)cudaErrorInvalidValue;
}

// q/out (B, Hq, D), caches (B, S, Hkv, D), all contiguous; pos (B,) int32; `bf16` selects
// __nv_bfloat16 over float. Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int decode_attention_run(const void* q, const void* kc, const void* vc,
                                    const int* pos, void* out, int B, int Hq, int Hkv, int S,
                                    int D, float scale, int bf16, void* stream) {
    if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Hq / Hkv > ATT_WARPS * ATT_RPW)
        return (int)cudaErrorInvalidValue;
    const int G = Hq / Hkv;
    const cudaStream_t st = (cudaStream_t)stream;
    return bf16 ? launch_d<__nv_bfloat16>(q, kc, vc, pos, out, B, S, Hkv, G, D, scale, st)
                : launch_d<float>(q, kc, vc, pos, out, B, S, Hkv, G, D, scale, st);
}
