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
// one group shared by every head; states (b*nc, H, P, S) in float32; the scratch cb (b*nc, Q, Q)
// in float32. x, B and C share one type TX and dt has its own TD (float or __nv_bfloat16 each:
// the model hands bf16 activations with a float32 dA); dA is float32. y is written in TX.
// Everything accumulates in float32.
//
// Design. Three kernels on the caller's stream:
//
// * C B^T once per (b, chunk), over the 64 x 64 tiles on and below the diagonal, into the
//   scratch cb (2 MB at b=1, T=2048: it stays in the 50 MB L2 for the H heads that read it):
//   ssd_cb_tc_kernel on the tensor cores for bf16 B and C (exact products, float32 sums),
//   ssd_cb_kernel on the CUDA cores for float32. It is 1/(1 + H P / S) of the block's
//   multiply-adds (3% at mamba2-1.3b widths). A block per (q tile, b*chunk) holding C B^T in
//   shared memory for a group of heads would read it from shared memory instead of L2, with
//   fewer blocks in flight; the L2 scratch keeps one block per (q tile, head, b*chunk).
// * y, bf16 x: ssd_y_tc_kernel, tensor cores. A block of four warps per (64-row q tile, head and
//   64-wide p tile, b*nc); each warp owns 16 rows and walks the 16-key steps up to its diagonal.
//   Per 64-key tile the block stages x and the C B^T tile in shared memory. Each thread forms
//   its part of W = (C B^T) * decay * dt in registers, in the m16n8k16 A-fragment layout (rows g
//   and g+8, keys 2t and 2t+1 of each 8-key half; tiles wholly below the diagonal need no mask),
//   and splits it in two bf16 terms, W = hi + lo (hi = bf16(W), lo = bf16(W - hi), two weights a
//   conversion): the two products hi.x and lo.x on mma.sync with float32 accumulation keep y
//   at about 2^-16 of |W| |x| per term, well inside the bf16 output's own rounding (and exact
//   on the dyadic inputs of the tests, whose W needs at most 16 significant bits). x rows are
//   padded to 144 bytes, so the eight rows of an ldmatrix phase fall in distinct banks, and x
//   is read as the `col` B operand through ldmatrix.trans, as csrc/attention.cuh's helpers do
//   for V.
// * states, bf16 x: ssd_state_tc_kernel, tensor cores. state^T = B^T (x * w), w = exp(dA_end -
//   dA) * dt per key. The states' limit is 1e-5 of scale, so the float32 x * w is split in three
//   bf16 terms (x w = t1 + t2 + t3 exactly, 24 significant bits), each a B operand read
//   through ldmatrix.trans; B, exact in bf16, is the A operand, read transposed from its
//   [key][s] tile; state^T (S rows, P columns) accumulates the three products in float32. One
//   block of eight warps per (128 state columns, 64-wide p tile, head, b*nc), so the split of a
//   key's x * w serves 128 state columns.
// * y and states, float32 x: ssd_y_kernel and ssd_state_kernel on the CUDA cores (the 1e-5 limit
//   of y in float32 leaves no room for bf16 terms of an f32 x): one block of 256 threads (16 x 16,
//   4 x 4 micro-tiles with rows ty + 16 i and columns tx + 16 j, so a warp reads shared memory
//   without bank conflicts) per tile; the y kernel reads C B^T from the scratch.
//
// Every block owns its outputs and sums in one fixed order; there are no atomics, so two runs
// are bitwise equal. The decay is masked by selects, not by a branch around the exp (where
// k > q the exponent is positive and may overflow, and inf * 0 would be NaN: the select drops
// it); masked entries never read cb's tiles above the diagonal, which are not written.
// --fmad=false, so every float32 product and sum on the CUDA cores rounds as written.
// Any Q, H, P and S; rows load 16 bytes at a time where their widths allow.
//
// What bounds it on this card: at mamba2-1.3b widths (b=1, T=2048, Q=256, H=64, P=64, S=128)
// in bf16, bytes: 52 MB read and written once, 0.016 ms at 3.35 TB/s; the split terms double
// and triple the tensor-core products (22 GFLOP of mma over the causal triangle and the states,
// about 0.022 ms at the bf16 peak). What keeps the y kernel above that: W is formed per head on
// the CUDA cores, an exp, two products and the split per weight, several times the instruction
// slots of its two mma, and every head reads the C B^T tiles from L2 again (about 80 MB a
// call); overlapping a tile's staging with the products of the one before (a cp.async ring)
// did not help. In float32, operations at 67 TFLOP/s (0.065 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention.cuh"

#define SSD_T 64   // rows of a q tile, keys of a k tile, columns of a p or s tile
#define SSD_SC 32  // state columns of C and B staged per step of C B^T
#define SSD_THREADS 256
#define SSD_TC_THREADS 128  // four warps of 16 rows
#define SSD_XP (SSD_T + 8)  // bf16 row stride of a staged tile: 144 bytes

__device__ __forceinline__ float ssd_ld(const float* p, int64_t i) { return p[i]; }
__device__ __forceinline__ float ssd_ld(const __nv_bfloat16* p, int64_t i) {
    return __bfloat162float(p[i]);
}

// -- C B^T once per (b, chunk), float32 B and C: the 64 x 64 tiles (q tile, k tile) with
//    k tile <= q tile, on the CUDA cores ----------------------------------------------------
__global__ void __launch_bounds__(SSD_THREADS)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ cb,
              int Q, int S) {
    __shared__ float Cs[SSD_T][SSD_SC + 1];
    __shared__ float Bs[SSD_T][SSD_SC + 1];
    if (blockIdx.y > blockIdx.x) return;  // above the diagonal: never read
    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int q0 = blockIdx.x * SSD_T, k0 = blockIdx.y * SSD_T;
    const int64_t bn = blockIdx.z;
    const float* Bb = Bm + bn * Q * S;
    const float* Cb = Cm + bn * Q * S;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int s0 = 0; s0 < S; s0 += SSD_SC) {
        __syncthreads();  // the previous stage is consumed
        for (int e = tid; e < SSD_T * SSD_SC; e += SSD_THREADS) {
            const int r = e / SSD_SC, c = e % SSD_SC, s = s0 + c;
            Cs[r][c] = (q0 + r < Q && s < S) ? ssd_ld(Cb, (int64_t)(q0 + r) * S + s) : 0.f;
            Bs[r][c] = (k0 + r < Q && s < S) ? ssd_ld(Bb, (int64_t)(k0 + r) * S + s) : 0.f;
        }
        __syncthreads();
        const int ns = min(SSD_SC, S - s0);
        for (int c = 0; c < ns; ++c) {
            float bv[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = Bs[tx + 16 * j][c];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
                const float cv = Cs[ty + 16 * i][c];
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = acc[i][j] + cv * bv[j];
            }
        }
    }
    float* out = cb + bn * Q * Q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
        if (q >= Q) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int k = k0 + tx + 16 * j;
            if (k < Q) out[(int64_t)q * Q + k] = acc[i][j];
        }
    }
}

// Stage rows [r0, r0 + 64) x columns [c0, c0 + 64) of a bf16 matrix (row stride ld) into dst
// (row stride ldd), zero outside nr rows and nc columns; 16-byte loads where `vec`.
__device__ __forceinline__ void ssd_stage(att_bf16* dst, int ldd, const att_bf16* src, int64_t ld,
                                          int r0, int nr, int c0, int nc, bool vec) {
    for (int e = threadIdx.x; e < SSD_T * (SSD_T / 8); e += blockDim.x) {
        const int r = e >> 3, c8 = (e & 7) * 8, row = r0 + r, col = c0 + c8;
        att_bf16* d = dst + r * ldd + c8;
        const att_bf16* g = src + (int64_t)row * ld + col;
        if (vec && row < nr && col + 8 <= nc) {
            *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(g);
        } else {
#pragma unroll
            for (int j = 0; j < 8; ++j)
                d[j] = (row < nr && col + j < nc) ? g[j] : __float2bfloat16_rn(0.f);
        }
    }
}

__device__ __forceinline__ bool ssd_aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// -- C B^T on the tensor cores, bf16 B and C (exact products, float32 sums) -----------------
__global__ void __launch_bounds__(SSD_TC_THREADS)
ssd_cb_tc_kernel(const att_bf16* __restrict__ Bm, const att_bf16* __restrict__ Cm,
                 float* __restrict__ cb, int Q, int S) {
    __shared__ __align__(16) att_bf16 Cs[SSD_T * SSD_XP];  // q rows x 64 state columns
    __shared__ __align__(16) att_bf16 Bs[SSD_T * SSD_XP];  // k rows x 64 state columns
    if (blockIdx.y > blockIdx.x) return;  // above the diagonal: never read
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
    const int q0 = blockIdx.x * SSD_T, k0 = blockIdx.y * SSD_T;
    const int64_t bn = blockIdx.z;
    const att_bf16* Bb = Bm + bn * Q * S;
    const att_bf16* Cb = Cm + bn * Q * S;
    const bool vec = (S & 7) == 0 && ssd_aligned16(Bm) && ssd_aligned16(Cm);
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;
    for (int s0 = 0; s0 < S; s0 += SSD_T) {
        __syncthreads();  // the previous stage is consumed
        ssd_stage(Cs, SSD_XP, Cb, S, q0, Q, s0, S, vec);
        ssd_stage(Bs, SSD_XP, Bb, S, k0, Q, s0, S, vec);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < SSD_T / 16; ++kk) {
            uint32_t a[4];
            att_ldmatrix_x4(a, Cs + (warp * 16 + (lane & 15)) * SSD_XP + kk * 16 + (lane >> 4) * 8);
#pragma unroll
            for (int n2 = 0; n2 < SSD_T / 16; ++n2) {
                uint32_t bk[4];
                att_ldmatrix_x4(bk, Bs + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * SSD_XP
                                        + kk * 16 + ((lane >> 3) & 1) * 8);
                att_mma(acc[2 * n2], a, bk[0], bk[1]);
                att_mma(acc[2 * n2 + 1], a, bk[2], bk[3]);
            }
        }
    }
    float* out = cb + bn * Q * Q;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int q = q0 + warp * 16 + g + 8 * rr;
        if (q >= Q) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int k = k0 + 8 * n + 2 * t4;
            if (k < Q) out[(int64_t)q * Q + k] = acc[n][2 * rr];
            if (k + 1 < Q) out[(int64_t)q * Q + k + 1] = acc[n][2 * rr + 1];
        }
    }
}

#define SSD_CP (SSD_T + 8)  // float row stride of a staged C B^T tile: 288 bytes

// -- y, bf16 x: W = hi + lo on the tensor cores ------------------------------------------------
template <typename TD>
__global__ void __launch_bounds__(SSD_TC_THREADS)
ssd_y_tc_kernel(const att_bf16* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ dA, const float* __restrict__ cb,
                att_bf16* __restrict__ y, int Q, int H, int P) {
    __shared__ __align__(16) att_bf16 Xs[SSD_T * SSD_XP];  // keys x p
    __shared__ __align__(16) float CBs[SSD_T * SSD_CP];    // q rows x keys of C B^T
    __shared__ float dAk[SSD_T], dtk[SSD_T];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    const int q0 = blockIdx.x * SSD_T;
    const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * SSD_T;
    const int64_t bn = blockIdx.z;
    const att_bf16* xb = x + bn * Q * H * P;
    const TD* dtb = dt + bn * Q * H;
    const float* dAb = dA + bn * Q * H;
    const float* cbb = cb + bn * Q * Q;
    const bool vec = (P & 7) == 0 && ssd_aligned16(x);
    const bool vec_cb = (Q & 3) == 0 && ssd_aligned16(cb);
    const int rl[2] = {warp * 16 + g, warp * 16 + g + 8};  // this thread's two rows, in the tile
    const float dAq[2] = {q0 + rl[0] < Q ? dAb[(int64_t)(q0 + rl[0]) * H + h] : 0.f,
                          q0 + rl[1] < Q ? dAb[(int64_t)(q0 + rl[1]) * H + h] : 0.f};
    const int warp_last = min(q0 + warp * 16 + 15, Q - 1);
    float o[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[n][c] = 0.f;

    const int q_last = min(q0 + SSD_T, Q) - 1;
    for (int k0 = 0; k0 <= q_last; k0 += SSD_T) {
        __syncthreads();  // the previous tile is consumed
        ssd_stage(Xs, SSD_XP, xb + (int64_t)h * P, (int64_t)H * P, k0, Q, p0, P, vec);
        for (int e = tid; e < SSD_T * (SSD_T / 4); e += SSD_TC_THREADS) {
            const int r = e >> 4, c4 = (e & 15) * 4, q = q0 + r, k = k0 + c4;
            float* d = CBs + r * SSD_CP + c4;
            const float* src = cbb + (int64_t)q * Q + k;
            if (vec_cb && q < Q && k + 4 <= Q) {
                *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src);
            } else {
#pragma unroll
                for (int j = 0; j < 4; ++j) d[j] = (q < Q && k + j < Q) ? src[j] : 0.f;
            }
        }
        for (int r = tid; r < SSD_T; r += SSD_TC_THREADS) {
            const bool ok = k0 + r < Q;
            dAk[r] = ok ? dAb[(int64_t)(k0 + r) * H + h] : 0.f;
            dtk[r] = ok ? ssd_ld(dtb, (int64_t)(k0 + r) * H + h) : 0.f;
        }
        __syncthreads();
        // a tile wholly below the diagonal, of rows that all exist, needs no mask
        const bool full = k0 + SSD_T <= q0 && q0 + SSD_T <= Q;
#pragma unroll
        for (int j = 0; j < SSD_T / 16; ++j) {
            if (k0 + 16 * j > warp_last) break;  // warp-uniform: keys beyond every row
            // W at rows rl[rr], keys 16 j + 8 hh + 2 t4 + cc of the tile; the A fragment's order
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int hh = 0; hh < 2; ++hh)
#pragma unroll
                for (int rr = 0; rr < 2; ++rr) {
                    const int kl = 16 * j + 8 * hh + 2 * t4;
                    const float2 c2 = *reinterpret_cast<const float2*>(CBs + rl[rr] * SSD_CP + kl);
                    const float cbv[2] = {c2.x, c2.y};
                    float w[2];
#pragma unroll
                    for (int cc = 0; cc < 2; ++cc) {
                        // above the diagonal the exp may overflow: the select drops it
                        const int k = k0 + kl + cc, q = q0 + rl[rr];
                        const float v =
                            (cbv[cc] * expf(dAq[rr] - dAk[kl + cc])) * dtk[kl + cc];
                        w[cc] = (full || (k <= q && q < Q)) ? v : 0.f;
                    }
                    const __nv_bfloat162 hi = __floats2bfloat162_rn(w[0], w[1]);
                    const float2 hf = __bfloat1622float2(hi);
                    ahi[2 * hh + rr] = *reinterpret_cast<const uint32_t*>(&hi);
                    alo[2 * hh + rr] = att_pack(w[0] - hf.x, w[1] - hf.y);
                }
#pragma unroll
            for (int n2 = 0; n2 < SSD_T / 16; ++n2) {
                uint32_t bv[4];
                att_ldmatrix_x4_trans(bv, Xs + (16 * j + (lane & 15)) * SSD_XP + n2 * 16
                                              + (lane >> 4) * 8);
                att_mma(o[2 * n2], ahi, bv[0], bv[1]);
                att_mma(o[2 * n2 + 1], ahi, bv[2], bv[3]);
                att_mma(o[2 * n2], alo, bv[0], bv[1]);
                att_mma(o[2 * n2 + 1], alo, bv[2], bv[3]);
            }
        }
    }
    att_bf16* yb = y + bn * Q * H * P;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int q = q0 + rl[rr];
        if (q >= Q) continue;
        att_bf16* dst = yb + ((int64_t)q * H + h) * P;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int p = p0 + 8 * n + 2 * t4;
            if (p < P) dst[p] = __float2bfloat16_rn(o[n][2 * rr]);
            if (p + 1 < P) dst[p + 1] = __float2bfloat16_rn(o[n][2 * rr + 1]);
        }
    }
}

// -- states, bf16 x: on the tensor cores, x scaled by the keys' weights in three bf16 terms ------
#define SSD_ST_S 128              // state columns of a block: eight warps of 16
#define SSD_BP (SSD_ST_S + 8)     // bf16 row stride of the staged B tile: 272 bytes

template <typename TD>
__global__ void __launch_bounds__(2 * SSD_TC_THREADS)
ssd_state_tc_kernel(const att_bf16* __restrict__ x, const TD* __restrict__ dt,
                    const float* __restrict__ dA, const att_bf16* __restrict__ Bm,
                    float* __restrict__ states, int Q, int H, int P, int S) {
    __shared__ __align__(16) att_bf16 Bs[SSD_T * SSD_BP];     // keys x s, as B is
    __shared__ __align__(16) att_bf16 Xw[3][SSD_T * SSD_XP];  // keys x p, x * wk in 3 terms
    __shared__ float wk[SSD_T];                               // exp(dA_end - dA[k]) * dt[k]
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    const int s0 = blockIdx.x * SSD_ST_S;
    const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * SSD_T;
    const int64_t bn = blockIdx.z;
    const att_bf16* xh = x + bn * Q * H * P + (int64_t)h * P;
    const TD* dtb = dt + bn * Q * H;
    const float* dAb = dA + bn * Q * H;
    const att_bf16* Bb = Bm + bn * Q * S;
    const float dA_end = dAb[(int64_t)(Q - 1) * H + h];
    const bool vec = (P & 7) == 0 && ssd_aligned16(x);
    const bool vec_b = (S & 7) == 0 && ssd_aligned16(Bm);
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

    for (int k0 = 0; k0 < Q; k0 += SSD_T) {
        __syncthreads();  // the previous tile is consumed
        for (int r = tid; r < SSD_T; r += blockDim.x) {
            const int64_t k = (int64_t)(k0 + r) * H + h;
            wk[r] = k0 + r < Q ? expf(dA_end - dAb[k]) * ssd_ld(dtb, k) : 0.f;
        }
        ssd_stage(Bs, SSD_BP, Bb, S, k0, Q, s0, S, vec_b);
        ssd_stage(Bs + SSD_T, SSD_BP, Bb, S, k0, Q, s0 + SSD_T, S, vec_b);
        __syncthreads();
        // x * wk for 8 columns a step, split in three (x w = t1 + t2 + t3 exactly), [key][p]
        for (int e = tid; e < SSD_T * (SSD_T / 8); e += blockDim.x) {
            const int r = e >> 3, c8 = (e & 7) * 8, k = k0 + r, p = p0 + c8;
            const float wr = wk[r];
            float xv[8];
            if (vec && k < Q && p + 8 <= P) {
                const uint4 raw = *reinterpret_cast<const uint4*>(xh + (int64_t)k * H * P + p);
                const att_bf16* xb8 = reinterpret_cast<const att_bf16*>(&raw);
#pragma unroll
                for (int j = 0; j < 8; ++j) xv[j] = __bfloat162float(xb8[j]);
            } else {
#pragma unroll
                for (int j = 0; j < 8; ++j)
                    xv[j] = (k < Q && p + j < P) ? __bfloat162float(xh[(int64_t)k * H * P + p + j])
                                                 : 0.f;
            }
            uint32_t t[3][4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                float2 rem = make_float2(xv[2 * j] * wr, xv[2 * j + 1] * wr);
#pragma unroll
                for (int q3 = 0; q3 < 3; ++q3) {
                    const __nv_bfloat162 tq = __floats2bfloat162_rn(rem.x, rem.y);
                    const float2 tf = __bfloat1622float2(tq);
                    t[q3][j] = *reinterpret_cast<const uint32_t*>(&tq);
                    rem = make_float2(rem.x - tf.x, rem.y - tf.y);
                }
            }
#pragma unroll
            for (int q3 = 0; q3 < 3; ++q3)
                *reinterpret_cast<uint4*>(Xw[q3] + r * SSD_XP + c8) =
                    make_uint4(t[q3][0], t[q3][1], t[q3][2], t[q3][3]);
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < SSD_T / 16; ++kk) {
            uint32_t a[4];  // B^T (s rows, keys): the transposed 8 x 8 blocks of [key][s]
            att_ldmatrix_x4_trans(a, Bs + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * SSD_BP
                                         + warp * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int n2 = 0; n2 < SSD_T / 16; ++n2)
#pragma unroll
                for (int q3 = 0; q3 < 3; ++q3) {
                    uint32_t bv[4];
                    att_ldmatrix_x4_trans(bv, Xw[q3] + (kk * 16 + (lane & 15)) * SSD_XP
                                                  + n2 * 16 + (lane >> 4) * 8);
                    att_mma(acc[2 * n2], a, bv[0], bv[1]);
                    att_mma(acc[2 * n2 + 1], a, bv[2], bv[3]);
                }
        }
    }
    float* out = states + (bn * H + h) * (int64_t)P * S;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
        const int s = s0 + warp * 16 + g + 8 * rr;
        if (s >= S) continue;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
            const int p = p0 + 8 * n + 2 * t4;
            if (p < P) out[(int64_t)p * S + s] = acc[n][2 * rr];
            if (p + 1 < P) out[(int64_t)(p + 1) * S + s] = acc[n][2 * rr + 1];
        }
    }
}

// shared memory of ssd_y_kernel, in floats: W, the x tile, dA of the q rows, dA and dt of the keys
#define SSD_Y_SMEM_FLOATS (2 * SSD_T * (SSD_T + 1) + 3 * SSD_T)

// -- y, float32 x: CUDA cores, C B^T from the scratch ----------------------------------------
template <typename TD>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_y_kernel(const float* __restrict__ x, const TD* __restrict__ dt,
             const float* __restrict__ dA, const float* __restrict__ cb, float* __restrict__ y,
             int Q, int H, int P) {
    extern __shared__ float ssd_smem[];
    float* Ws = ssd_smem;                     // [SSD_T][SSD_T + 1]
    float* Xs = Ws + SSD_T * (SSD_T + 1);     // [SSD_T][SSD_T + 1]
    float* dAq = Xs + SSD_T * (SSD_T + 1);    // [SSD_T]
    float* dAk = dAq + SSD_T;                 // [SSD_T]
    float* dtk = dAk + SSD_T;                 // [SSD_T]

    const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    const int q0 = blockIdx.x * SSD_T;
    const int h = blockIdx.y / n_pt, p0 = (blockIdx.y % n_pt) * SSD_T;
    const int64_t bn = blockIdx.z;
    const float* xb = x + bn * Q * H * P;
    const TD* dtb = dt + bn * Q * H;
    const float* dAb = dA + bn * Q * H;
    const float* cbb = cb + bn * Q * Q;

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
        __syncthreads();
        // W = cb * decay * dt, masked by a select before the exp
        for (int e = tid; e < SSD_T * SSD_T; e += SSD_THREADS) {
            const int r = e / SSD_T, c = e % SSD_T, q = q0 + r, k = k0 + c;
            const bool in = k <= q && q < Q;
            const float ex = expf(in ? dAq[r] - dAk[c] : 0.f);
            Ws[r * (SSD_T + 1) + c] = in ? (cbb[(int64_t)q * Q + k] * ex) * dtk[c] : 0.f;
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
            if (p < P) y[bn * Q * H * P + ((int64_t)q * H + h) * P + p] = acc[i][j];
        }
    }
}

// shared memory of ssd_state_kernel, in floats: the x tile, the weighted B tile, the keys' weights
#define SSD_S_SMEM_FLOATS (2 * SSD_T * (SSD_T + 1) + SSD_T)

// -- states, float32 x: CUDA cores -------------------------------------------------------------
template <typename TD>
__global__ void __launch_bounds__(SSD_THREADS)
ssd_state_kernel(const float* __restrict__ x, const TD* __restrict__ dt,
                 const float* __restrict__ dA, const float* __restrict__ Bm,
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
    const float* xb = x + bn * Q * H * P;
    const TD* dtb = dt + bn * Q * H;
    const float* dAb = dA + bn * Q * H;
    const float* Bb = Bm + bn * Q * S;
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

// bf16 x, B, C: C B^T, then y and the states on the tensor cores
template <typename TD>
static int launch_tc(const void* x, const void* dt, const float* dA, const void* Bm,
                     const void* Cm, void* y, float* states, float* cb, int BN, int Q, int H,
                     int P, int S, cudaStream_t stream) {
    const int n_qt = (Q + SSD_T - 1) / SSD_T;
    ssd_cb_tc_kernel<<<dim3(n_qt, n_qt, BN), SSD_TC_THREADS, 0, stream>>>(
        (const att_bf16*)Bm, (const att_bf16*)Cm, cb, Q, S);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    ssd_y_tc_kernel<TD><<<dim3((Q + SSD_T - 1) / SSD_T, H * n_pt, BN), SSD_TC_THREADS, 0,
                          stream>>>((const att_bf16*)x, (const TD*)dt, dA, cb, (att_bf16*)y, Q, H,
                                    P);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    ssd_state_tc_kernel<TD><<<dim3((S + SSD_ST_S - 1) / SSD_ST_S, H * n_pt, BN),
                              2 * SSD_TC_THREADS, 0, stream>>>(
        (const att_bf16*)x, (const TD*)dt, dA, (const att_bf16*)Bm, states, Q, H, P, S);
    return (int)cudaGetLastError();
}

// float32 x, B, C: C B^T, then y and the states on the CUDA cores
template <typename TD>
static int launch_simt(const void* x, const void* dt, const float* dA, const void* Bm,
                       const void* Cm, void* y, float* states, float* cb, int BN, int Q, int H,
                       int P, int S, cudaStream_t stream) {
    const int n_qt = (Q + SSD_T - 1) / SSD_T;
    ssd_cb_kernel<<<dim3(n_qt, n_qt, BN), SSD_THREADS, 0, stream>>>((const float*)Bm,
                                                                   (const float*)Cm, cb, Q, S);
    int e = (int)cudaGetLastError();
    if (e != 0) return e;
    const int n_pt = (P + SSD_T - 1) / SSD_T;
    ssd_y_kernel<TD><<<dim3((Q + SSD_T - 1) / SSD_T, H * n_pt, BN), SSD_THREADS,
                       SSD_Y_SMEM_FLOATS * sizeof(float), stream>>>(
        (const float*)x, (const TD*)dt, dA, cb, (float*)y, Q, H, P);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    ssd_state_kernel<TD><<<dim3((S + SSD_T - 1) / SSD_T, H * n_pt, BN), SSD_THREADS,
                           SSD_S_SMEM_FLOATS * sizeof(float), stream>>>(
        (const float*)x, (const TD*)dt, dA, (const float*)Bm, states, Q, H, P, S);
    return (int)cudaGetLastError();
}

// x/y (BN, Q, H, P), dt/dA (BN, Q, H), B/C (BN, Q, S), states (BN, H, P, S) float32, the scratch
// cb (BN, Q, Q) float32, all contiguous, BN = b * nc. `x_bf16` selects __nv_bfloat16 over float
// for x, B, C and y (and with it the tensor-core route), `dt_bf16` for dt. Launches the three
// kernels on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int ssd_intra_chunk_run(const void* x, const void* dt, const float* dA,
                                   const void* Bm, const void* Cm, void* y, float* states,
                                   float* cb, int BN, int Q, int H, int P, int S, int x_bf16,
                                   int dt_bf16, void* stream) {
    const int n_qt = (Q + SSD_T - 1) / SSD_T;
    if (BN <= 0 || Q <= 0 || H <= 0 || P <= 0 || S <= 0 || BN > 65535 || n_qt > 65535 ||
        H * ((P + SSD_T - 1) / SSD_T) > 65535)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (x_bf16)
        return dt_bf16 ? launch_tc<att_bf16>(x, dt, dA, Bm, Cm, y, states, cb, BN, Q, H, P, S, st)
                       : launch_tc<float>(x, dt, dA, Bm, Cm, y, states, cb, BN, Q, H, P, S, st);
    return dt_bf16 ? launch_simt<att_bf16>(x, dt, dA, Bm, Cm, y, states, cb, BN, Q, H, P, S, st)
                   : launch_simt<float>(x, dt, dA, Bm, Cm, y, states, cb, BN, Q, H, P, S, st);
}
