// Hand-written Hopper (sm_90a) kernel for the drain and split of the fused cohort engine's dense
// route (DESIGN.md §8):
//
//   drained[i, c, b] = clip(ship[i, c] - (cum[i, c, b] - src[i, c, b]), 0, src[i, c, b])
//                      (cum: inclusive running sum over b = 0 .. Atot)
//   land_src[i, c, b] = drained[i, c, b] for b < Atot, plus drained[i, c, Atot] at b = age_bucket
//   land[j, b]        = sum over i of ratio[i, j] * land_src[i, comp[j], b]
//
// Replaces the TPU kernel src/repro/kernels/cohort_drain.py:38 cohort_drain_kernel. The plain
// version of the same function is repro_torch.kernels.cohort_drain.cohort_drain_split_plain.
//
// Why the TPU layout does not carry over: the Pallas body contracts each source stripe against
// all C component planes on the MXU, (bj, bi) x (bi, C * Atot), and then keeps one plane per
// target with a one-hot product: C times the needed work. Here each target column reads only its
// own plane comp[j]. The TPU kernel also carries the landing tile across the sequential source
// grid axis in VMEM; on Hopper a loop over the sources inside the thread takes that place.
//
// What bounds it on this card: the (I, I) f32 ratio matrix is read once (1.07 GB at I=16384) and
// the own-plane products are 2 * I * I * Atot operations at most; the kernel skips ratio[i, j]
// == 0 (drained is finite and >= 0, so the skipped term is exactly +0), so the operations this
// run needs are 2 * Atot per nonzero ratio entry.
//
// Two phases, one launch each, on the caller's stream:
//
//   A  one thread per (i, c) walks the Atot + 1 buckets in ascending order: running sum, clip in
//      the plain version's order, the admission slot folded into bucket age_bucket; writes
//      land_src (I, C, Atot) to a scratch buffer the wrapper allocates.
//   B  a block of 32 x BY threads owns 32 target columns j (neighbouring threads on neighbouring
//      j, so the ratio[i, j] loads coalesce); thread row y owns the age slices y, y + BY, ... of
//      DRAIN_BW buckets each. Each (j, b) is accumulated over i = 0 .. I-1 in ascending order,
//      one rounding per product and one per sum (built with --fmad=false), with no atomics: two
//      runs are bitwise identical, and on exact (dyadic) inputs the result equals the plain one.
//      The ratio loads of DRAIN_UNROLL rows are issued before they are used.
//
// comp[j] may be any assignment of columns to components (they need not be contiguous); a value
// outside [0, C) writes NaN into that target's row. f32 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#define DRAIN_BW 16      // age buckets per thread slice
#define DRAIN_BY_MAX 8   // thread rows per block in phase B
#define DRAIN_UNROLL 16  // ratio rows loaded ahead in phase B

__global__ void cohort_drain_phase_a(const float* __restrict__ src, const float* __restrict__ ship,
                                     float* __restrict__ land_src, int IC, int Atot,
                                     int age_bucket) {
    const int ic = blockIdx.x * blockDim.x + threadIdx.x;
    if (ic >= IC) return;
    const int Aext = Atot + 1;
    const float* s = src + (size_t)ic * Aext;
    float* out = land_src + (size_t)ic * Atot;
    const float amount = ship[ic];
    float cum = 0.0f;
    float last = 0.0f;
    for (int b = 0; b < Aext; ++b) {
        const float v = s[b];
        cum = cum + v;
        const float d = fminf(fmaxf(amount - (cum - v), 0.0f), v);
        if (b < Atot) {
            out[b] = d;
        } else {
            last = d;
        }
    }
    out[age_bucket] = out[age_bucket] + last;
}

__global__ void cohort_drain_phase_b(const float* __restrict__ land_src,
                                     const float* __restrict__ ratio,
                                     const int* __restrict__ comp, float* __restrict__ land,
                                     int I, int C, int Atot) {
    const int j = blockIdx.x * 32 + threadIdx.x;
    if (j >= I) return;
    const int cj = comp[j];
    const int n_slices = (Atot + DRAIN_BW - 1) / DRAIN_BW;
    if (cj < 0 || cj >= C) {
        for (int sl = threadIdx.y; sl < n_slices; sl += blockDim.y)
            for (int k = 0; k < DRAIN_BW && sl * DRAIN_BW + k < Atot; ++k)
                land[(size_t)j * Atot + sl * DRAIN_BW + k] = NAN;
        return;
    }
    for (int sl = threadIdx.y; sl < n_slices; sl += blockDim.y) {
        const int b0 = sl * DRAIN_BW;
        const int nb = min(DRAIN_BW, Atot - b0);
        float acc[DRAIN_BW];
#pragma unroll
        for (int k = 0; k < DRAIN_BW; ++k) acc[k] = 0.0f;
        for (int i0 = 0; i0 < I; i0 += DRAIN_UNROLL) {
            float r[DRAIN_UNROLL];
#pragma unroll
            for (int u = 0; u < DRAIN_UNROLL; ++u)
                r[u] = (i0 + u < I) ? ratio[(size_t)(i0 + u) * I + j] : 0.0f;
#pragma unroll
            for (int u = 0; u < DRAIN_UNROLL; ++u) {
                if (r[u] == 0.0f) continue;
                const float* row = land_src + ((size_t)(i0 + u) * C + cj) * Atot + b0;
#pragma unroll
                for (int k = 0; k < DRAIN_BW; ++k)
                    if (k < nb) acc[k] = acc[k] + r[u] * row[k];
            }
        }
#pragma unroll
        for (int k = 0; k < DRAIN_BW; ++k)
            if (k < nb) land[(size_t)j * Atot + b0 + k] = acc[k];
    }
}

// Launches both phases on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int cohort_drain_run(const float* src, const float* ship, const float* ratio,
                                const int* comp, float* land_src, float* land, int I, int C,
                                int Atot, int age_bucket, void* stream) {
    if (I <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int IC = I * C;
    cohort_drain_phase_a<<<(IC + 255) / 256, 256, 0, st>>>(src, ship, land_src, IC, Atot,
                                                          age_bucket);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;
    const int n_slices = (Atot + DRAIN_BW - 1) / DRAIN_BW;
    const dim3 block(32, n_slices < DRAIN_BY_MAX ? n_slices : DRAIN_BY_MAX);
    cohort_drain_phase_b<<<(I + 31) / 32, block, 0, st>>>(land_src, ratio, comp, land, I, C,
                                                          Atot);
    return (int)cudaGetLastError();
}
