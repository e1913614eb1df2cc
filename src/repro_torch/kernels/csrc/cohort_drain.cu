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
// grid axis in VMEM; on Hopper each warp carries its own landing tile in shared memory over a
// chunk of the sources, and a second pass adds the chunks in a fixed order.
//
// What bounds it on this card: the one read of the (I, I) f32 ratio matrix (1.07 GB at
// I=16384), at 3.35 TB/s. The products cost 2 * Atot operations per nonzero ratio entry, and on
// the dense route almost every entry is zero (drained is finite and >= 0, so a skipped term is
// exactly +0). So the design streams the ratio once, at full width, and finds the few nonzeros
// with a warp vote.
//
// Three launches on the caller's stream (the third only when the sources come in chunks):
//
//   A  cohort_drain_phase_a: one warp per (i, c) row, its lanes across the Atot + 1 buckets:
//      inclusive Kogge-Stone scans in rounds of 32 plus the carry of the rounds before, the
//      clip in the plain version's order, the admission slot folded into bucket age_bucket;
//      writes land_src (I, C, Atot), coalesced, to scratch the wrapper allocates.
//   B  cohort_drain_phase_b: a warp owns a strip of 32 target columns and a chunk of source
//      rows (the wrapper's plan: rows a multiple of 32), and streams the strip's rows with
//      16-byte loads, eight per lane and the next eight in flight (each element of ratio is
//      read from device memory once, by one warp). A warp vote finds a load group with a
//      nonzero; its nonzeros go, in ascending row and then column order, into a queue of 32
//      whose land_src rows are loaded 16 at a time and added into the warp's landing tile
//      (32 columns x Atot buckets, shared memory). So each (j, b) sums its chunk's nonzero
//      terms in ascending i, one rounding per product and one per sum (--fmad=false). The tile
//      is written once: into land when there is one chunk, else into the chunk's partial.
//   M  cohort_drain_merge: land[j, b] = partial 0 + partial 1 + ... in ascending chunk order.
//
// No float atomics: two runs are bitwise identical, and on exact (dyadic) inputs the result
// equals the plain one. comp[j] may be any assignment of columns to components; a value outside
// [0, C) writes NaN into that target's row. f32 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define DRAIN_FULL 0xffffffffu
#define DRAIN_A_WARPS 8            // rows (one warp each) per block of phase A
#define DRAIN_A_ROUNDS 4           // rounds of 32 buckets whose loads phase A issues together
#define DRAIN_U 8                  // 16-byte ratio loads per lane per group, 4 rows each
#define DRAIN_GROUP (4 * DRAIN_U)  // ratio rows of a warp's load group
#define DRAIN_B_WARPS 4            // strips (one warp each) per block of phase B, at most
#define DRAIN_BMAX 256             // buckets of a landing tile; more take a grid slice each
#define DRAIN_NB 32                // nonzeros queued before their products are added
#define DRAIN_G 16                 // land_src loads per lane in flight while adding them
#define DRAIN_SMEM 49152           // shared memory of a phase-B block, at most

// inclusive prefix sum of v over the lanes (Kogge-Stone, a fixed order)
__device__ __forceinline__ float drain_warp_scan(float v, int lane) {
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const float u = __shfl_up_sync(DRAIN_FULL, v, o);
        if (lane >= o) v = u + v;
    }
    return v;
}

__global__ void __launch_bounds__(32 * DRAIN_A_WARPS)
cohort_drain_phase_a(const float* __restrict__ src, const float* __restrict__ ship,
                     float* __restrict__ land_src, int IC, int Atot, int age_bucket) {
    const int lane = threadIdx.x & 31;
    const int ic = blockIdx.x * DRAIN_A_WARPS + (threadIdx.x >> 5);
    if (ic >= IC) return;  // the whole warp
    const int Aext = Atot + 1;
    const float* s = src + (size_t)ic * Aext;
    float* out = land_src + (size_t)ic * Atot;
    const float amount = ship[ic];
    float carry = 0.f, d_age = 0.f, last = 0.f;
    for (int base = 0; base < Aext; base += 32 * DRAIN_A_ROUNDS) {
        float vr[DRAIN_A_ROUNDS];  // every load of these rounds in flight before the first scan
#pragma unroll
        for (int r = 0; r < DRAIN_A_ROUNDS; ++r) {
            const int b = base + 32 * r + lane;
            vr[r] = b < Aext ? s[b] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < DRAIN_A_ROUNDS; ++r) {
            const int b0 = base + 32 * r, b = b0 + lane;
            if (b0 >= Aext) break;  // the whole warp
            const float v = vr[r];
            const float incl = drain_warp_scan(v, lane);
            const float cum = carry + incl;
            const float d = fminf(fmaxf(amount - (cum - v), 0.f), v);
            if (b == age_bucket)
                d_age = d;
            else if (b < Atot)
                out[b] = d;
            if (Atot < b0 + 32) last = __shfl_sync(DRAIN_FULL, d, Atot - b0);  // admission slot
            carry = carry + __shfl_sync(DRAIN_FULL, incl, 31);
        }
    }
    if (lane == (age_bucket & 31)) out[age_bucket] = d_age + last;
}

// one lane's four ratio entries of a load group: row `row` (0 if not below `row_end`), columns
// col .. col + 3 (0 from I on); V4: one 16-byte load (I a multiple of 4, the matrix aligned)
template <bool V4>
__device__ __forceinline__ float4 drain_load(const float* __restrict__ ratio, int row,
                                             int row_end, int col, int I) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row >= row_end) return v;
    const float* p = ratio + (size_t)row * I + col;
    if (V4) {
        if (col < I) v = __ldcs(reinterpret_cast<const float4*>(p));
    } else {
        if (col < I) v.x = __ldcs(p);
        if (col + 1 < I) v.y = __ldcs(p + 1);
        if (col + 2 < I) v.z = __ldcs(p + 2);
        if (col + 3 < I) v.w = __ldcs(p + 3);
    }
    return v;
}

__device__ __forceinline__ bool drain_nonzero(float4 v) {
    const unsigned bits = __float_as_uint(v.x) | __float_as_uint(v.y) | __float_as_uint(v.z)
                          | __float_as_uint(v.w);
    return (bits & 0x7fffffffu) != 0u;  // -0 counts as zero, NaN as nonzero
}

// The queued nonzeros' products, added into the landing tile in queue order: the items are queue
// entry k's bucket slices s = 0 .. ns - 1 (buckets 32 s + lane), entry by entry, so each (column,
// bucket) takes its entries in the order they were queued.
__device__ __noinline__ void drain_flush(float* acc, int AB, int nb, const int* q_row,
                                         const int* q_col, const float* q_r, const int* q_comp,
                                         int npend, const float* __restrict__ land_src, int C,
                                         int Atot, int b0, int lane) {
    __syncwarp();
    const int ns = (nb + 31) >> 5;
    for (int k0 = 0, s0 = 0; k0 < npend;) {
        float x[DRAIN_G];
        int k = k0, sl = s0;
#pragma unroll
        for (int g = 0; g < DRAIN_G; ++g) {
            const int b = sl * 32 + lane;
            x[g] = k < npend && b < nb
                       ? land_src[((size_t)q_row[k] * C + q_comp[k]) * Atot + b0 + b]
                       : 0.f;
            if (++sl == ns) sl = 0, ++k;
        }
        k = k0, sl = s0;
#pragma unroll
        for (int g = 0; g < DRAIN_G; ++g) {
            const int b = sl * 32 + lane;
            if (k < npend && b < nb) {
                float* a = acc + q_col[k] * AB + b;
                *a = *a + q_r[k] * x[g];
            }
            if (++sl == ns) sl = 0, ++k;
        }
        k0 = k, s0 = sl;
    }
    __syncwarp();
}

// floats of one warp's shared memory in phase B: the staged load group (4 x 32), the landing
// tile (32 x AB) and the queue (4 x DRAIN_NB); a multiple of 4, so each warp's stage is aligned
__host__ __device__ __forceinline__ int drain_warp_floats(int AB) {
    return 128 + 32 * AB + 4 * DRAIN_NB;
}

template <bool V4>
__global__ void __launch_bounds__(32 * DRAIN_B_WARPS, 4)
cohort_drain_phase_b(const float* __restrict__ land_src, const float* __restrict__ ratio,
                     const int* __restrict__ comp, float* __restrict__ out, int I, int C,
                     int Atot, int AB, int rows_per_chunk, size_t chunk_stride) {
    extern __shared__ float4 drain_smem[];
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const int j0 = (blockIdx.x * (blockDim.x >> 5) + w) * 32;
    if (j0 >= I) return;  // the whole warp; phase B has no block-wide barrier
    float* stage = reinterpret_cast<float*>(drain_smem) + (size_t)w * drain_warp_floats(AB);
    float* acc = stage + 128;
    float* q_r = acc + 32 * AB;
    int* q_row = reinterpret_cast<int*>(q_r + DRAIN_NB);
    int* q_col = q_row + DRAIN_NB;
    int* q_comp = q_col + DRAIN_NB;
    out += blockIdx.y * chunk_stride;  // this chunk's partial, or land itself
    const int b0 = blockIdx.z * AB, nb = min(AB, Atot - b0);
    const int r_begin = blockIdx.y * rows_per_chunk, r_end = min(I, r_begin + rows_per_chunk);

    const int my_comp = j0 + lane < I ? comp[j0 + lane] : -1;  // lane jj owns column j0 + jj
    const bool my_valid = my_comp >= 0 && my_comp < C;
    for (int jj = 0; jj < 32; ++jj)
        for (int b = lane; b < nb; b += 32) acc[jj * AB + b] = 0.f;
    __syncwarp();

    const int q = lane >> 3, col = j0 + 4 * (lane & 7);  // this lane's row in a 4-row load
    float4 cur[DRAIN_U], nxt[DRAIN_U];
#pragma unroll
    for (int u = 0; u < DRAIN_U; ++u)
        cur[u] = drain_load<V4>(ratio, r_begin + 4 * u + q, r_end, col, I);
    int npend = 0;
    for (int r = r_begin; r < r_end; r += DRAIN_GROUP) {
        const bool more = r + DRAIN_GROUP < r_end;  // warp-uniform
#pragma unroll
        for (int u = 0; u < DRAIN_U; ++u)
            nxt[u] = more ? drain_load<V4>(ratio, r + DRAIN_GROUP + 4 * u + q, r_end, col, I)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
        bool any = false;
#pragma unroll
        for (int u = 0; u < DRAIN_U; ++u) any |= drain_nonzero(cur[u]);
        if (__any_sync(DRAIN_FULL, any)) {
            // the rare group with a nonzero: queue its nonzeros in ascending row, then column
            // (unrolled: cur stays in registers)
#pragma unroll
            for (int u = 0; u < DRAIN_U; ++u) {
                if (!__any_sync(DRAIN_FULL, drain_nonzero(cur[u]))) continue;
                reinterpret_cast<float4*>(stage)[lane] = cur[u];  // row lane / 8 of the four
                __syncwarp();
                for (int rq = 0; rq < 4; ++rq) {
                    const float v = stage[rq * 32 + lane];
                    unsigned m = __ballot_sync(DRAIN_FULL, v != 0.f && my_valid);
                    while (m) {
                        const int room = DRAIN_NB - npend;
                        const int rank = __popc(m & ((1u << lane) - 1u));
                        if (((m >> lane) & 1u) && rank < room) {
                            q_row[npend + rank] = r + 4 * u + rq;
                            q_col[npend + rank] = lane;
                            q_r[npend + rank] = v;
                            q_comp[npend + rank] = my_comp;
                        }
                        const int took = min(__popc(m), room);
                        for (int t = 0; t < took; ++t) m &= m - 1u;
                        npend += took;
                        if (npend == DRAIN_NB) {
                            drain_flush(acc, AB, nb, q_row, q_col, q_r, q_comp, npend,
                                        land_src, C, Atot, b0, lane);
                            npend = 0;
                        }
                    }
                }
                __syncwarp();  // the stage is rewritten by the next load
            }
        }
#pragma unroll
        for (int u = 0; u < DRAIN_U; ++u) cur[u] = nxt[u];
    }
    if (npend > 0)
        drain_flush(acc, AB, nb, q_row, q_col, q_r, q_comp, npend, land_src, C, Atot, b0, lane);
    __syncwarp();

    // the tile, written once: columns j0 .. j0 + 31 are 32 consecutive rows of out
    for (int jj = 0; jj < 32 && j0 + jj < I; ++jj) {
        const bool valid = __shfl_sync(DRAIN_FULL, my_valid, jj);
        float* row = out + (size_t)(j0 + jj) * Atot + b0;
        for (int b = lane; b < nb; b += 32) row[b] = valid ? acc[jj * AB + b] : NAN;
    }
}

__global__ void cohort_drain_merge(const float* __restrict__ part, const int* __restrict__ comp,
                                   float* __restrict__ land, int I, int C, int Atot,
                                   int n_chunks) {
    const size_t n = (size_t)I * Atot;
    const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n) return;
    const int cj = comp[e / Atot];
    if (cj < 0 || cj >= C) {
        land[e] = NAN;
        return;
    }
    float v = part[e];
#pragma unroll 4
    for (int c = 1; c < n_chunks; ++c) v = v + part[(size_t)c * n + e];
    land[e] = v;
}

// Launches the phases on `stream`: land_src (I, C, Atot) and, for n_chunks > 1, part
// (n_chunks, I, Atot) are scratch; rows_per_chunk * n_chunks covers I. Returns
// cudaGetLastError() (0 on success).
extern "C" int cohort_drain_run(const float* src, const float* ship, const float* ratio,
                                const int* comp, float* land_src, float* part, float* land,
                                int I, int C, int Atot, int age_bucket, int rows_per_chunk,
                                int n_chunks, void* stream) {
    if (I <= 0) return (int)cudaGetLastError();
    cudaStream_t st = (cudaStream_t)stream;
    const int IC = I * C;
    cohort_drain_phase_a<<<(IC + DRAIN_A_WARPS - 1) / DRAIN_A_WARPS, 32 * DRAIN_A_WARPS, 0,
                           st>>>(src, ship, land_src, IC, Atot, age_bucket);
    int err = (int)cudaGetLastError();
    if (err != 0) return err;

    const int AB = Atot < DRAIN_BMAX ? Atot : DRAIN_BMAX;
    const int warp_bytes = 4 * drain_warp_floats(AB);
    int wpb = DRAIN_SMEM / warp_bytes;
    wpb = wpb < 1 ? 1 : (wpb > DRAIN_B_WARPS ? DRAIN_B_WARPS : wpb);
    const int strips = (I + 31) / 32;
    const dim3 grid((strips + wpb - 1) / wpb, n_chunks, (Atot + AB - 1) / AB);
    float* out = n_chunks > 1 ? part : land;
    const size_t stride = n_chunks > 1 ? (size_t)I * Atot : 0;
    const bool v4 = I % 4 == 0 && ((uintptr_t)ratio & 15u) == 0;
    if (v4)
        cohort_drain_phase_b<true><<<grid, 32 * wpb, wpb * warp_bytes, st>>>(
            land_src, ratio, comp, out, I, C, Atot, AB, rows_per_chunk, stride);
    else
        cohort_drain_phase_b<false><<<grid, 32 * wpb, wpb * warp_bytes, st>>>(
            land_src, ratio, comp, out, I, C, Atot, AB, rows_per_chunk, stride);
    err = (int)cudaGetLastError();
    if (err != 0 || n_chunks == 1) return err;

    const size_t n = (size_t)I * Atot;
    cohort_drain_merge<<<(unsigned)((n + 255) / 256), 256, 0, st>>>(part, comp, land, I, C, Atot,
                                                                    n_chunks);
    return (int)cudaGetLastError();
}
