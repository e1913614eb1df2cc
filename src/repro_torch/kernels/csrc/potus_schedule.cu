// Hand-written Hopper (sm_90a) kernel for the fused POTUS schedule: the greedy allocation
// X (I, I) of Algorithm 1 lines 9-14 (before the mandatory dispatch of actual arrivals),
// with the (I, I) price matrix never written to device memory (DESIGN.md §7).
//
// Replaces the TPU kernel src/repro/kernels/potus_schedule.py:35 potus_schedule_kernel. The
// plain version of the same function is potus_prices followed by the sort water-fill,
// repro_torch.kernels.potus_schedule.potus_schedule_alloc_plain.
//
// Per source row i, in one warp:
//   1. fold: the lanes stream the row's columns j = lane, lane+32, ... (coalesced), form the
//      price (V*U[kc_i, kc_j] + q_in[j]) - beta*q_out[i, comp_j] on DAG edges in the price
//      kernel's order, and keep per component the pair (min price, lowest column) over the
//      candidates with price < 0. Each lane's pairs sit in shared memory as [C][32], so lane
//      l always touches bank l.
//   2. reduce: lane c (mod 32) folds component c's 32 pairs in lane order, lowest column on
//      equal prices. Min with an index tie-break picks the same pair in any order; no float
//      is accumulated, so nothing here depends on the order and no atomics are used.
//   3. water-fill: lane 0 sorts the components that have a candidate by (price, column) and
//      fills gamma_i with sequential prefix sums in that order,
//      fill = min(prefix, gamma) - min(before, gamma), as the plain version's sorted cumsum.
//      (The TPU kernel's O(C^2) rank sum agrees with it only to rounding.)
//   4. write: the lanes write the row, zero except each component's fill at its column.
//
// Why the TPU layout does not carry over: the TPU kernel walks row stripes in a sequential
// grid and forms the price tile with one-hot matmuls (DESIGN.md §4). Here each warp owns a
// row, so the fold needs no carry between blocks, and the gathers are plain loads.
//
// What bounds it on this card: bytes. The (I, I) bool mask is read once and X written once;
// the (I,) and (I, C) vectors stay in L1/L2. The per-row state is O(C), in shared memory.
// C <= SCHED_MAXC (the wrapper checks it). Build with --fmad=false. f32 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define SCHED_WARPS 4   // warps (rows in flight) per block
#define SCHED_MAXC 64   // most components the water-fill holds

__global__ void potus_schedule_kernel(const float* __restrict__ U,
                                      const float* __restrict__ q_in,
                                      const float* __restrict__ q_out,
                                      const int* __restrict__ kc, const int* __restrict__ comp,
                                      const unsigned char* __restrict__ mask,
                                      const float* __restrict__ gamma, float* __restrict__ X,
                                      int I, int K, int C, float V, float beta) {
    extern __shared__ float smem[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* m_s = smem + (size_t)warp * 64 * C;  // [C][32] min price per (component, lane)
    int* j_s = (int*)(m_s + 32 * C);            // [C][32] its column

    for (int i = blockIdx.x * SCHED_WARPS + warp; i < I; i += gridDim.x * SCHED_WARPS) {
        // 1. fold
        for (int c = 0; c < C; ++c) {
            m_s[c * 32 + lane] = INFINITY;
            j_s[c * 32 + lane] = I;
        }
        const float* u_row = U + (size_t)kc[i] * K;
        const float* qo_row = q_out + (size_t)i * C;
        const unsigned char* mask_row = mask + (size_t)i * I;
        for (int j = lane; j < I; j += 32) {
            if (!mask_row[j]) continue;
            const int c = comp[j];
            const float vu = V * u_row[kc[j]];
            const float a = vu + q_in[j];
            const float bq = beta * qo_row[c];
            const float l = a - bq;
            // columns rise within a lane, so a strict < keeps the lowest column on ties
            if (l < 0.f && l < m_s[c * 32 + lane]) {
                m_s[c * 32 + lane] = l;
                j_s[c * 32 + lane] = j;
            }
        }
        __syncwarp();
        // 2. reduce across lanes
        for (int c = lane; c < C; c += 32) {
            float m = m_s[c * 32];
            int jj = j_s[c * 32];
            for (int s = 1; s < 32; ++s) {
                const float m2 = m_s[c * 32 + s];
                const int j2 = j_s[c * 32 + s];
                if (m2 < m || (m2 == m && j2 < jj)) {
                    m = m2;
                    jj = j2;
                }
            }
            m_s[c * 32] = m;
            j_s[c * 32] = jj;
        }
        __syncwarp();
        // 3. water-fill; the fill of component c goes to m_s[c*32 + 1], and a component
        //    without a candidate gets column -1 (it receives nothing)
        if (lane == 0) {
            int order[SCHED_MAXC];
            int n = 0;
            for (int c = 0; c < C; ++c) {
                const float m = m_s[c * 32];
                const int jj = j_s[c * 32];
                if (!(m < 0.f)) {
                    j_s[c * 32] = -1;
                    continue;
                }
                int k = n++;
                while (k > 0) {  // insertion by (price, column)
                    const int p = order[k - 1];
                    const float mp = m_s[p * 32];
                    if (mp < m || (mp == m && j_s[p * 32] < jj)) break;
                    order[k] = p;
                    --k;
                }
                order[k] = c;
            }
            const float g = gamma[i];
            float prefix = 0.f;
            for (int k = 0; k < n; ++k) {
                const int c = order[k];
                const float before = prefix;
                prefix = prefix + fmaxf(qo_row[c], 0.f);
                m_s[c * 32 + 1] = fminf(prefix, g) - fminf(before, g);
            }
        }
        __syncwarp();
        // 4. write the row
        float* x_row = X + (size_t)i * I;
        for (int j = lane; j < I; j += 32) {
            const int c = comp[j];
            x_row[j] = j_s[c * 32] == j ? m_s[c * 32 + 1] : 0.f;
        }
        __syncwarp();  // the next row's fold overwrites what step 4 reads
    }
}

// Launches on `stream`; returns cudaGetLastError() (0 on success), or the error of the
// shared-memory attribute call.
extern "C" int potus_schedule_run(const float* U, const float* q_in, const float* q_out,
                                  const int* kc, const int* comp, const unsigned char* mask,
                                  const float* gamma, float* X, int I, int K, int C, float V,
                                  float beta, void* stream) {
    if (C > SCHED_MAXC || C < 0) return (int)cudaErrorInvalidValue;
    if (I <= 0) return (int)cudaGetLastError();
    const size_t smem = (size_t)SCHED_WARPS * 64 * C * sizeof(float);
    // above 48 KB (C > 48) dynamic shared memory needs the opt-in
    cudaError_t err = cudaFuncSetAttribute(potus_schedule_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (I + SCHED_WARPS - 1) / SCHED_WARPS;
    potus_schedule_kernel<<<blocks, SCHED_WARPS * 32, smem, (cudaStream_t)stream>>>(
        U, q_in, q_out, kc, comp, mask, gamma, X, I, K, C, V, beta);
    return (int)cudaGetLastError();
}
