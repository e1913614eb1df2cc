// Hand-written Hopper (sm_90a) kernel for the POTUS price matrix (paper eq. 16):
//
//   l[i, j] = (V * U[kc[i], kc[j]] + q_in[j]) - beta * q_out[i, comp[j]]   where mask[i, j]
//   l[i, j] = +inf                                                          elsewhere
//
// Replaces the TPU kernel src/repro/kernels/potus_price.py:26 potus_price_kernel. The plain
// version of the same function is repro_torch.kernels.potus_price.potus_price_plain.
//
// Why the TPU layout does not carry over: the TPU kernel forms both gathers, U[kc_i, kc_j] and
// q_out[i, comp_j], as one-hot matmuls so that the MXU produces the tile (DESIGN.md §4). On
// Hopper a gather is an ordinary load: U (K*K floats) and the q_out row stay in L1/L2, so the
// kernel reads them directly.
//
// What bounds it on this card: bytes. Per element it reads one mask byte and writes one f32;
// the arithmetic is five operations. One thread per output element, neighbouring threads on
// neighbouring columns j (coalesced mask reads and output writes); each thread loads its
// column's kc[j], comp[j] and q_in[j] once and reuses them over the rows of its block
// (PRICE_ROWS at a time, striding over the grid's rows when I needs more than 65535 blocks).
//
// The sum is formed in the plain version's order, (V*u + q_in) - beta*q_out, and the source is
// built with --fmad=false, so each element equals the plain version's bitwise. f32 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define PRICE_THREADS 256
#define PRICE_ROWS 8  // rows per block

__global__ void potus_price_kernel(const float* __restrict__ U, const float* __restrict__ q_in,
                                   const float* __restrict__ q_out, const int* __restrict__ kc,
                                   const int* __restrict__ comp,
                                   const unsigned char* __restrict__ mask,
                                   float* __restrict__ out, int I, int K, int C, float V,
                                   float beta) {
    const int j = blockIdx.x * PRICE_THREADS + threadIdx.x;
    if (j >= I) return;
    const int kc_j = kc[j];
    const int comp_j = comp[j];
    const float qin_j = q_in[j];
    for (int i0 = blockIdx.y * PRICE_ROWS; i0 < I; i0 += gridDim.y * PRICE_ROWS)
    for (int i = i0; i < min(i0 + PRICE_ROWS, I); ++i) {
        const size_t at = (size_t)i * (size_t)I + (size_t)j;
        float l = INFINITY;
        if (mask[at]) {
            const float vu = V * U[(size_t)kc[i] * K + kc_j];
            const float a = vu + qin_j;
            const float bq = beta * q_out[(size_t)i * C + comp_j];
            l = a - bq;
        }
        out[at] = l;
    }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int potus_price_run(const float* U, const float* q_in, const float* q_out,
                               const int* kc, const int* comp, const unsigned char* mask,
                               float* out, int I, int K, int C, float V, float beta,
                               void* stream) {
    if (I <= 0) return (int)cudaGetLastError();
    const int row_blocks = (I + PRICE_ROWS - 1) / PRICE_ROWS;
    const dim3 grid((I + PRICE_THREADS - 1) / PRICE_THREADS,
                    row_blocks < 65535 ? row_blocks : 65535);
    potus_price_kernel<<<grid, PRICE_THREADS, 0, (cudaStream_t)stream>>>(
        U, q_in, q_out, kc, comp, mask, out, I, K, C, V, beta);
    return (int)cudaGetLastError();
}
