// Hand-written Hopper (sm_90a) kernels for the Mamba2 SSD intra-chunk block and the per-chunk
// input states, for every (batch, chunk, head):
//
//   y[q, :]  = sum_{k <= q} (C[q] . B[k]) * exp(dA[q] - dA[k]) * dt[k] * x[k, :]
//   state    = sum_k x[k, :]^T (B[k, :] * (exp(dA[Q-1] - dA[k]) * dt[k]))      (P, S)
//
// with dA the cumulative sum of dt * A over the chunk. Replaces the TPU kernel
// src/repro/kernels/ssd_scan.py:23 ssd_intra_chunk_kernel. The plain version of the same function
// is repro_torch.kernels.ssd_scan.ssd_intra_chunk_plain (src/repro/kernels/ref.py:49).
//
// Layouts, all contiguous: x and y (b*nc, Q, H, P); dt and dA (b*nc, Q, H); B and C (b*nc, Q, S),
// one group shared by every head; states (b*nc, H, P, S) in float32. x, B and C share one type
// TX and dt has its own TD (float or __nv_bfloat16 each: the model hands bf16 activations with a
// float32 dA); dA is float32. y is written in TX. Everything accumulates in float32.
//
// Design. Two kernels, launched one after the other on the caller's stream:
//
// * ssd_y_kernel: one block of 256 threads (16 x 16) per (64-row q tile, head and 64-wide p tile,
//   b*nc). The block loops over the 64-key tiles up to its diagonal; for each it forms the
//   masked 64 x 64 weights W = (C B^T) * decay * dt in registers (C and B staged in shared memory
//   32 state columns at a time, each thread a 4 x 4 micro-tile with rows ty + 16 i and columns
//   tx + 16 j, so a warp reads shared memory without bank conflicts), stores W in shared memory
//   and adds W x_tile to its 4 x 4 slice of y. The decay is a select before the exp: for k > q
//   the exponent is positive and may overflow, and inf * 0 would be NaN. C B^T is recomputed for
//   every head, as the TPU kernel does: reusing it across the H heads of a (b, chunk) would leave
//   b*nc*Q/64 blocks (32 at b=1, T=2048) for 132 SMs, or a (b, nc, Q, Q) product in global memory
//   for a later change to read from L2.
// * ssd_state_kernel: one block per (64 x 64 tile of (P, S), head, b*nc). It reduces over all Q
//   keys of the chunk in 64-key tiles staged in shared memory: x (keys x P) and
//   B * (exp(dA_end - dA) * dt) (keys x S). A block owns its tile and sums in one fixed order;
//   there are no atomics, so two runs are bitwise equal.
//
// No tensor cores, no TMA, no library: plain float32 FMAs on the CUDA cores (a first version;
// --fmad=false, so every product and sum rounds as written). Any Q, H, P and S.
//
// What bounds it on this card: at mamba2-1.3b widths (b=1, T=2048, Q=256, H=64, P=64, S=128)
// in bf16, bytes: 52 MB read and written once, 0.016 ms at 3.35 TB/s (4.4 GFLOP over the causal
// triangle would take less on the tensor cores); in float32, operations at 67 TFLOP/s. This
// version sits well above either: its inner loops issue two shared-memory loads per four FMAs,
// and C B^T per head is 2/3 of the y kernel's multiply-adds. Reusing C B^T across heads, then
// tensor-core tiles (mma/wgmma) for the three products, are the levers for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SSD_T 64   // rows of a q tile, keys of a k tile, columns of a p or s tile
#define SSD_SC 32  // state columns of C and B staged per step of C B^T
#define SSD_THREADS 256

__device__ __forceinline__ float ssd_ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ssd_ld(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
}
__device__ __forceinline__ void ssd_st(float* p, int64_t i, float v) { p[i] = v; }
__device__ __forceinline__ void ssd_st(__nv_bfloat16* p, int64_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
}

// shared memory of ssd_y_kernel, in floats: C and B stages, W, the x tile, dA of the q rows,
// dA and dt of the keys
#define SSD_Y_SMEM_FLOATS (2 * SSD_T * (SSD_SC + 1) + 2 * SSD_T * (SSD_T + 1) + 3 * SSD_T)

template <typename TX, typename TD>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_y_kernel(const TX* __restrict__ x, const TD* __restrict__ dt, const float* __restrict__ dA,
             const TX* __restrict__ Bm, const TX* __restrict__ Cm, TX* __restrict__ y, int Q,
             int H, int P, int S) {
    extern __shared__ float ssd_smem[];
    float* Cs = ssd_smem;                     // [SSD_T][SSD_SC + 1]
    float* Bs = Cs + SSD_T * (SSD_SC + 1);    // [SSD_T][SSD_SC + 1]
    float* Ws = Bs + SSD_T * (SSD_SC + 1);    // [SSD_T][SSD_T + 1]
    float* Xs = Ws + SSD_T * (SSD_T + 1);     // [SSD_T][SSD_T + 1]
    float* dAq = Xs + SSD_T * (SSD_T + 1);    // [SSD_T]
    float* dAk = dAq + SSD_T;                 // [SSD_T]
    float* dtk = dAk + SSD_T;                 // [SSD_T]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    const int q0 = blockIdx.x * SSD_T;
    const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * SSD_T;
    const int64_t bn = blockIdx.z;
    const TX* xb = x + bn * Q * H * P;
    const TD* dtb = dt + bn * Q * H;
    const float* dAb = dA + bn * Q * H;
    const TX* Bb = Bm + bn * Q * S;
    const TX* Cb = Cm + bn * Q * S;

    for (int r = tid; r < SSD_T; r += SSD_THREADS)
        dAq[r] = q0 + r < Q ? dAb[(int64_t)(q0 + r) * H + h] : 0.f;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    const int q_last = min(q0 + SSD_T, Q) - 1;
    for (int k0 = 0; k0 <= q_last; k0 += SSD_T) {
        __syncthreads();  // the previous tile's W and x are consumed
        for (int r = tid; r < SSD_T; r += SSD_THREADS) {
            const bool ok = k0 + r < Q;
            dAk[r] = ok ? dAb[(int64_t)(k0 + r) * H + h] : 0.f;
            dtk[r] = ok ? ssd_ld(dtb, (int64_t)(k0 + r) * H + h) : 0.f;
        }
        // C B^T over this (q tile, k tile), 4 x 4 per thread
        float cb[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) cb[i][j] = 0.f;
        for (int s0 = 0; s0 < S; s0 += SSD_SC) {
            __syncthreads();  // the previous stage is consumed
            for (int e = tid; e < SSD_T * SSD_SC; e += SSD_THREADS) {
                const int r = e / SSD_SC, c = e % SSD_SC, s = s0 + c;
                Cs[r * (SSD_SC + 1) + c] =
                    (q0 + r < Q && s < S) ? ssd_ld(Cb, (int64_t)(q0 + r) * S + s) : 0.f;
                Bs[r * (SSD_SC + 1) + c] =
                    (k0 + r < Q && s < S) ? ssd_ld(Bb, (int64_t)(k0 + r) * S + s) : 0.f;
            }
            __syncthreads();
            const int ns = min(SSD_SC, S - s0);
            for (int c = 0; c < ns; ++c) {
                float bv[4];
#pragma unroll
                for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * (SSD_SC + 1) + c];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    const float cv = Cs[(ty + 16 * i) * (SSD_SC + 1) + c];
#pragma unroll
                    for (int j = 0; j < 4; ++j) cb[i][j] = cb[i][j] + cv * bv[j];
                }
            }
        }
        // W = cb * decay * dt, masked by a select before the exp
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int r = ty + 16 * i, q = q0 + r;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int c = tx + 16 * j, k = k0 + c;
                const float decay = (k <= q && q < Q) ? expf(dAq[r] - dAk[c]) : 0.f;
                Ws[r * (SSD_T + 1) + c] = cb[i][j] * decay * dtk[c];
            }
        }
        for (int e = tid; e < SSD_T * SSD_T; e += SSD_THREADS) {
            const int r = e / SSD_T, c = e % SSD_T, k = k0 + r, p = p0 + c;
            Xs[r * (SSD_T + 1) + c] =
                (k < Q && p < P) ? ssd_ld(xb, ((int64_t)k * H + h) * P + p) : 0.f;
        }
        __syncthreads();
        const int nk = min(SSD_T, q_last + 1 - k0);
        for (int c = 0; c < nk; ++c) {
            float xv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) xv[j] = Xs[c * (SSD_T + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float w = Ws[(ty + 16 * i) * (SSD_T + 1) + c];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + w * xv[j];
            }
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int p = p0 + tx + 16 * j;
            if (p < P) ssd_st(y + bn * Q * H * P, ((int64_t)q * H + h) * P + p, acc[i][j]);
        }
    }
}

// shared memory of ssd_state_kernel, in floats: the x tile, the weighted B tile, the keys' weights
#define SSD_S_SMEM_FLOATS (2 * SSD_T * (SSD_T + 1) + SSD_T)

template <typename TX, typename TD>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_state_kernel(const TX* __restrict__ x, const TD* __restrict__ dt,
                 const float* __restrict__ dA, const TX* __restrict__ Bm,
                 float* __restrict__ states, int Q, int H, int P, int S) {
    extern __shared__ float ssd_smem[];
    float* Xs = ssd_smem;                   // [SSD_T keys][SSD_T + 1] x[k, p0 + c]
    float* Bw = Xs + SSD_T * (SSD_T + 1);   // [SSD_T keys][SSD_T + 1] B[k, s0 + c] * wk[k]
    float* wk = Bw + SSD_T * (SSD_T + 1);   // [SSD_T] exp(dA_end - dA[k]) * dt[k]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    const int s0 = blockIdx.x * SSD_T;
    const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * SSD_T;
    const int64_t bn = blockIdx.z;
    const TX* xb = x + bn * Q * H * P;
    const TD* dtb = dt + bn * Q * H;
    const float* dAb = dA + bn * Q * H;
    const TX* Bb = Bm + bn * Q * S;
    const float dA_end = dAb[(int64_t)(Q - 1) * H + h];

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < Q; k0 += SSD_T) {
        __syncthreads();  // the previous tile is consumed
        for (int r = tid; r < SSD_T; r += SSD_THREADS) {
            const int64_t k = (int64_t)(k0 + r) * H + h;
            wk[r] = k0 + r < Q ? expf(dA_end - dAb[k]) * ssd_ld(dtb, k) : 0.f;
        }
        __syncthreads();
        for (int e = tid; e < SSD_T * SSD_T; e += SSD_THREADS) {
            const int r = e / SSD_T, c = e % SSD_T, k = k0 + r;
            const int p = p0 + c, s = s0 + c;
            Xs[r * (SSD_T + 1) + c] =
                (k < Q && p < P) ? ssd_ld(xb, ((int64_t)k * H + h) * P + p) : 0.f;
            Bw[r * (SSD_T + 1) + c] =
                (k < Q && s < S) ? ssd_ld(Bb, (int64_t)k * S + s) * wk[r] : 0.f;
        }
        __syncthreads();
        const int nk = min(SSD_T, Q - k0);
        for (int r = 0; r < nk; ++r) {
            float bv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bw[r * (SSD_T + 1) + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float xv = Xs[r * (SSD_T + 1) + ty + 16 * i];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + xv * bv[j];
            }
        }
    }
    float* out = states + (bn * H + h) * (int64_t)P * S;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int p = p0 + ty + 16 * i;
        if (p >= P) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int s = s0 + tx + 16 * j;
            if (s < S) out[(int64_t)p * S + s] = acc[i][j];
        }
    }
}

template <typename TX, typename TD>
static int launch(const void* x, const void* dt, const float* dA, const void* Bm, const void* Cm,
                  void* y, float* states, int BN, int Q, int H, int P, int S,
                  cudaStream_t stream) {
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    const int y_smem = SSD_Y_SMEM_FLOATS * (int)sizeof(float);
    const int s_smem = SSD_S_SMEM_FLOATS * (int)sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(ssd_y_kernel<TX, TD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, y_smem);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(ssd_state_kernel<TX, TD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, s_smem);
    if (e != cudaSuccess) return (int)e;
    ssd_y_kernel<TX, TD><<<dim3((Q + SSD_T - 1) / SSD_T, H * n_pt, BN), SSD_THREADS, y_smem,
                           stream>>>((const TX*)x, (const TD*)dt, dA, (const TX*)Bm,
                                     (const TX*)Cm, (TX*)y, Q, H, P, S);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    ssd_state_kernel<TX, TD><<<dim3((S + SSD_T - 1) / SSD_T, H * n_pt, BN), SSD_THREADS, s_smem,
                               stream>>>((const TX*)x, (const TD*)dt, dA, (const TX*)Bm, states,
                                         Q, H, P, S);
    return (int)cudaGetLastError();
}

// x/y (BN, Q, H, P), dt/dA (BN, Q, H), B/C (BN, Q, S), states (BN, H, P, S) float32, all
// contiguous, BN = b * nc. `x_bf16` selects __nv_bfloat16 over float for x, B, C and y, `dt_bf16`
// for dt. Launches both kernels on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ssd_intra_chunk_run(const void* x, const void* dt, const float* dA,
                                   const void* Bm, const void* Cm, void* y, float* states, int BN,
                                   int Q, int H, int P, int S, int x_bf16, int dt_bf16,
                                   void* stream) {
    if (BN <= 0 || Q <= 0 || H <= 0 || P <= 0 || S <= 0 || BN > 65535 ||
        H * ((P + SSD_T - 1) / SSD_T) > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (x_bf16)
        return dt_bf16 ? launch<__nv_bfloat16, __nv_bfloat16>(x, dt, dA, Bm, Cm, y, states, BN, Q,
                                                              H, P, S, st)
                       : launch<__nv_bfloat16, float>(x, dt, dA, Bm, Cm, y, states, BN, Q, H, P,
                                                      S, st);
    return dt_bf16 ? launch<float, __nv_bfloat16>(x, dt, dA, Bm, Cm, y, states, BN, Q, H, P, S, st)
                   : launch<float, float>(x, dt, dA, Bm, Cm, y, states, BN, Q, H, P, S, st);
}
