// Hand-written Hopper (sm_90a) kernels for single-token GQA attention against a KV cache (one
// decode step of every request):
//
//   out[b, h, :] = softmax_t( q[b, h, :] . k_cache[b, t, h/G, :] / sqrt(D) ) . v_cache[b, t, h/G, :]
//
// over the cache positions t <= pos[b] (the current token is already written at pos[b]).
// Replaces the TPU kernel src/repro/kernels/decode_attention.py:23 decode_attention_kernel. The
// plain version of the same function is
// repro_torch.kernels.decode_attention.decode_attention_plain (src/repro/kernels/ref.py:31).
//
// What bounds it on this card: bytes, the cache rows t <= pos[b] of every KV head, read once
// (G flops per byte, far below the ~295 at which the tensor cores would be the limit). A grid
// of one block per (KV head, request), as the TPU kernel's (B, Hkv) grid, fills 32 of 132 SMs
// at B=4, Hkv=8 and walks each cache serially; once the positions are split over blocks, the
// per-block latency of staging a tile and reducing it is what remains, and float32 dot
// products on the CUDA cores spend it reading the query and the tile from shared memory.
//
// Design: a split over positions ("flash-decoding"), two launches.
// Pass 1, grid (splits, Hkv x row groups, B): a block takes L consecutive positions of one
//   (request, KV head) for a group of its G query rows (G <= DEC_MAX_G). It stages K and V in
//   their own type in shared memory, a sub-tile of positions at a time, with 16-byte cp.async
//   (a two-stage ring when L spans two sub-tiles, so sub-tile i+1 loads while sub-tile i
//   computes); rows are padded by 16 bytes, so eight rows read at one column fall in distinct
//   banks. The scores are scaled by 1/sqrt(D) in float32 after the dot product. Two kernels,
//   chosen by the wrapper from the type and head_dim:
//   - tensor cores (bfloat16, D in {64, 128}; groups of 16 rows): decode_split_tc_kernel, the
//     flash kernel's mma.sync tiles with the rows as the M side;
//   - CUDA cores (float32, which keeps its 2e-5 limit, and bfloat16 at other D; groups of 8
//     rows): decode_split_kernel, every thread on all the group's rows at once.
//   The block writes its partial (acc, m, l) in float32 to a workspace (B, Hkv, splits, G,
//   D + 2). A block whose first position lies past pos[b] returns at once; no position past
//   pos[b] is read.
// Pass 2, grid (G, Hkv, B): the ceil((pos[b] + 1) / L) valid splits of each row are merged in
//   ascending order with the usual rescale (each split weighted by exp(m_i - max m)), and
//   acc / max(l, 1e-30) is written in q's type.
// No atomics: two runs are bitwise equal. L and the number of splits come from the wrapper's
// decode_split_plan (shapes and SM count only, never pos). Any S, D <= 256 with rows of a
// multiple of 16 bytes, float32 or bfloat16.

#include <algorithm>

#include "attention.cuh"

#define DEC_THREADS 128
#define DEC_MAX_G 32          // query heads per KV head
#define DEC_GB 8              // query rows per block of pass 1
#define DEC_TILE_BYTES 16384  // K bytes of one staged sub-tile (SIMT route)
#define DEC_TC_TS 64          // positions per staged sub-tile (tensor-core route): 16 a warp
#define DEC_MERGE_PRE 16      // splits whose partials pass 2 loads ahead of the weights

template <typename T> struct DecVec;
template <> struct DecVec<float> {
    static constexpr int CH = 4;  // elements per 16 bytes
    __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
        f[0] = __uint_as_float(u.x);
        f[1] = __uint_as_float(u.y);
        f[2] = __uint_as_float(u.z);
        f[3] = __uint_as_float(u.w);
    }
};
template <> struct DecVec<__nv_bfloat16> {
    static constexpr int CH = 8;
    // a bf16 is the high half of the float32 with the same value
    __device__ static __forceinline__ void unpack(const uint4& u, float* f) {
        f[0] = __uint_as_float(u.x << 16);
        f[1] = __uint_as_float(u.x & 0xffff0000u);
        f[2] = __uint_as_float(u.y << 16);
        f[3] = __uint_as_float(u.y & 0xffff0000u);
        f[4] = __uint_as_float(u.z << 16);
        f[5] = __uint_as_float(u.z & 0xffff0000u);
        f[6] = __uint_as_float(u.w << 16);
        f[7] = __uint_as_float(u.w & 0xffff0000u);
    }
};

// Compile-time shape of pass 1 for element type T and head_dim at most DMAX.
template <typename T, int DMAX>
struct DecShape {
    static constexpr int CH = DecVec<T>::CH;
    // positions per staged sub-tile: DEC_TILE_BYTES of K, at most 64 (two per lane in softmax)
    static constexpr int TS_RAW = DEC_TILE_BYTES / (DMAX * (int)sizeof(T));
    static constexpr int TS = TS_RAW < 64 ? TS_RAW : 64;
    static constexpr int TPP = DEC_THREADS / TS;  // threads per position in the scores
};

// Pass 1, CUDA-core route. Block (split, KV head x row group, request): rows g0 .. g0 + GB - 1
// (GB <= DEC_GB) of the KV head's G query heads, positions [split*L, split*L + L) up to pos[b].
//   Scores: TPP adjacent lanes per position, each takes the 16-byte chunks c = j, j + TPP, ...
//   of the position's K row for all GB rows (K read from shared memory once), then a butterfly
//   over the TPP lanes (every lane gets the same sum).
//   P.V: thread (chunk c, position group tg) = tid / TG, tid % TG holds acc[GB][16 bytes] over
//   the positions tg, tg + TG, ...; the TG partials are summed in order at the end of the block.
template <typename T, int DMAX>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
                    const int* __restrict__ pos, float* __restrict__ ws, int S, int Hkv, int G,
                    int D, int L, int splits, int nst, float scale) {
    using P = DecShape<T, DMAX>;
    constexpr int CH = P::CH, TS = P::TS, TPP = P::TPP;
    const int split = blockIdx.x, b = blockIdx.z;
    const int ngg = (G + DEC_GB - 1) / DEC_GB;
    const int h = blockIdx.y / ngg, g0 = (blockIdx.y - h * ngg) * DEC_GB;
    const int GB = min(DEC_GB, G - g0);
    const int kend = min(pos[b] + 1, S);
    const int p_start = split * L;
    if (p_start >= kend) return;  // past pos[b]: this split holds nothing
    const int p_end = min(p_start + L, kend);
    const int nsub = (p_end - p_start + TS - 1) / TS;
    const int NCH = D / CH;                  // 16-byte chunks per row
    const int RP = D * (int)sizeof(T) + 16;  // padded row, bytes: an odd number of 16-byte units
    const int stage_bytes = max(2 * nst * TS * RP, GB * DEC_THREADS * CH * (int)sizeof(float));

    extern __shared__ __align__(16) unsigned char dec_smem[];
    unsigned char* Kst = dec_smem;                               // nst x TS x RP
    unsigned char* Vst = Kst + nst * TS * RP;                    // nst x TS x RP
    float* qs = reinterpret_cast<float*>(dec_smem + stage_bytes);  // GB x D
    float* Ss = qs + GB * D;                                     // GB x TS: scores, then p
    float* m_run = Ss + GB * TS;                                 // DEC_GB each
    float* l_run = m_run + DEC_GB;
    float* alpha = l_run + DEC_GB;
    float* red = reinterpret_cast<float*>(dec_smem);  // after the loop: GB x DEC_THREADS x CH

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t row = (int64_t)Hkv * D;  // elements between two positions of one head
    const T* kbase = kc + (int64_t)b * S * row + (int64_t)h * D;
    const T* vbase = vc + (int64_t)b * S * row + (int64_t)h * D;

    // positions [p0, p0 + TS) into stage st; those at or past p_end are zero and never read
    auto stage = [&](int sub, int st) {
        const int p0 = p_start + sub * TS;
        unsigned char* kd = Kst + st * TS * RP;
        unsigned char* vd = Vst + st * TS * RP;
        for (int e = tid; e < TS * NCH; e += DEC_THREADS) {
            const int j = e / NCH, c = e - j * NCH;
            const bool in = p0 + j < p_end;
            const int64_t at = (int64_t)(in ? p0 + j : 0) * row + c * CH;
            att_cp_async16(kd + j * RP + c * 16, kbase + at, in);
            att_cp_async16(vd + j * RP + c * 16, vbase + at, in);
        }
    };
    stage(0, 0);
    att_cp_async_commit();
    const T* qrow = q + ((int64_t)b * Hkv * G + (int64_t)h * G + g0) * D;
    for (int e = tid; e < GB * D; e += DEC_THREADS) qs[e] = att_to_f32(qrow[e]);
    if (tid < GB) {
        m_run[tid] = -INFINITY;
        l_run[tid] = 0.0f;
    }

    const int TG = DEC_THREADS / NCH;  // position groups of P.V
    const int pc = tid / TG, tg = tid - pc * TG;
    float acc[DEC_GB][CH];
#pragma unroll
    for (int i = 0; i < DEC_GB; ++i)
#pragma unroll
        for (int e = 0; e < CH; ++e) acc[i][e] = 0.0f;

    for (int sub = 0; sub < nsub; ++sub) {
        if (sub + 1 < nsub) stage(sub + 1, (sub + 1) % nst);  // nst == 2 whenever nsub > 1
        att_cp_async_commit();
        att_cp_async_wait<1>();  // sub-tile `sub` has landed
        __syncthreads();
        const unsigned char* kd = Kst + (sub % nst) * TS * RP;
        const unsigned char* vd = Vst + (sub % nst) * TS * RP;
        const int nt = min(TS, p_end - (p_start + sub * TS));

        // scores of position t for every row of the block
        {
            const int t = tid / TPP, j = tid - t * TPP;
            float part[DEC_GB];
#pragma unroll
            for (int i = 0; i < DEC_GB; ++i) part[i] = 0.0f;
            for (int c = j; c < NCH; c += TPP) {
                float kv[CH];
                DecVec<T>::unpack(*reinterpret_cast<const uint4*>(kd + t * RP + c * 16), kv);
#pragma unroll
                for (int i = 0; i < DEC_GB; ++i) {
                    if (i < GB) {
                        const float4* qg = reinterpret_cast<const float4*>(qs + i * D + c * CH);
                        float x = part[i];
#pragma unroll
                        for (int e4 = 0; e4 < CH / 4; ++e4) {
                            const float4 qv = qg[e4];
                            x += qv.x * kv[4 * e4];
                            x += qv.y * kv[4 * e4 + 1];
                            x += qv.z * kv[4 * e4 + 2];
                            x += qv.w * kv[4 * e4 + 3];
                        }
                        part[i] = x;
                    }
                }
            }
#pragma unroll
            for (int o = 1; o < TPP; o <<= 1)
#pragma unroll
                for (int i = 0; i < DEC_GB; ++i)
                    if (i < GB) part[i] += __shfl_xor_sync(0xffffffffu, part[i], o);
            if (j == 0)
#pragma unroll
                for (int i = 0; i < DEC_GB; ++i)
                    if (i < GB) Ss[i * TS + t] = t < nt ? part[i] * scale : -INFINITY;
        }
        __syncthreads();

        // online softmax, one warp per row
        for (int i = warp; i < GB; i += DEC_THREADS / 32) {
            float* si = Ss + i * TS;
            const float v0 = lane < TS ? si[lane] : -INFINITY;
            const float v1 = lane + 32 < TS ? si[lane + 32] : -INFINITY;
            float mx = fmaxf(v0, v1);
#pragma unroll
            for (int o = 16; o >= 1; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
            const float m_old = m_run[i];
            const float m_new = fmaxf(m_old, mx);  // finite: position p0 is valid
            const float a = expf(m_old - m_new);   // 0 on the first sub-tile
            const float p0 = expf(v0 - m_new), p1 = expf(v1 - m_new);
            if (lane < TS) si[lane] = p0;
            if (lane + 32 < TS) si[lane + 32] = p1;
            float sum = p0 + p1;
#pragma unroll
            for (int o = 16; o >= 1; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
            __syncwarp();  // every lane has read m_run[i]
            if (lane == 0) {
                m_run[i] = m_new;
                l_run[i] = l_run[i] * a + sum;
                alpha[i] = a;
            }
        }
        __syncthreads();

        // acc = acc * alpha + sum_t p[i, t] v[t, chunk pc]
        if (pc < NCH) {
#pragma unroll
            for (int i = 0; i < DEC_GB; ++i) {
                const float a = i < GB ? alpha[i] : 0.0f;
#pragma unroll
                for (int e = 0; e < CH; ++e) acc[i][e] *= a;
            }
            for (int t = tg; t < nt; t += TG) {
                float vv[CH];
                DecVec<T>::unpack(*reinterpret_cast<const uint4*>(vd + t * RP + pc * 16), vv);
#pragma unroll
                for (int i = 0; i < DEC_GB; ++i) {
                    if (i < GB) {
                        const float pt = Ss[i * TS + t];
#pragma unroll
                        for (int e = 0; e < CH; ++e) acc[i][e] += pt * vv[e];
                    }
                }
            }
        }
        __syncthreads();  // the stage and Ss are consumed before they are refilled
    }

    // the partial (acc, m, l) of this split: acc summed over the TG position groups in order,
    // through the consumed stages
    if (pc < NCH)
#pragma unroll
        for (int i = 0; i < DEC_GB; ++i)
            if (i < GB)
#pragma unroll
                for (int e = 0; e < CH; ++e) red[(i * DEC_THREADS + tid) * CH + e] = acc[i][e];
    __syncthreads();
    float* wrow = ws + ((((int64_t)b * Hkv + h) * splits + split) * G + g0) * (D + 2);
    for (int id = tid; id < GB * D; id += DEC_THREADS) {
        const int i = id / D, d = id - i * D;
        const int c = d / CH, e = d - c * CH;
        const float* ri = red + (i * DEC_THREADS + c * TG) * CH + e;
        float x = 0.0f;
        for (int k = 0; k < TG; ++k) x += ri[k * CH];
        wrow[i * (D + 2) + d] = x;
    }
    if (tid < GB) {
        wrow[tid * (D + 2) + D] = m_run[tid];
        wrow[tid * (D + 2) + D + 1] = l_run[tid];
    }
}

// Pass 1, tensor-core route (bfloat16, D in {64, 128}). Block (split, KV head x group of 16
// rows, request): the block's rows (zero-padded to 16) are the A operand of mma.sync m16n8k16;
// each of the four warps takes 16 of a sub-tile's 64 positions: S = Q K^T from ldmatrix'd K,
// an online softmax over its 16 keys in registers (exp, as pass 2), P rounded to bf16 in
// registers as the A operand of P V (V through ldmatrix.trans). Each warp keeps its own
// (m, l, acc) over the sub-tiles; the four are merged in warp order through shared memory.
template <int D>
__global__ void __launch_bounds__(DEC_THREADS)
decode_split_tc_kernel(const att_bf16* __restrict__ q, const att_bf16* __restrict__ kc,
                       const att_bf16* __restrict__ vc, const int* __restrict__ pos,
                       float* __restrict__ ws, int S, int Hkv, int G, int L, int splits, int nst,
                       float scale) {
    constexpr int DP = D + 8;  // padded row, elements: ldmatrix reads eight rows conflict-free
    constexpr int NCH = D / 8, KD = D / 16, ND = D / 8;
    constexpr int TS = DEC_TC_TS;
    const int split = blockIdx.x, b = blockIdx.z;
    const int ngg = (G + 15) / 16;
    const int h = blockIdx.y / ngg, g0 = (blockIdx.y - h * ngg) * 16;
    const int GB = min(16, G - g0);
    const int kend = min(pos[b] + 1, S);
    const int p_start = split * L;
    if (p_start >= kend) return;  // past pos[b]: this split holds nothing
    const int p_end = min(p_start + L, kend);
    const int nsub = (p_end - p_start + TS - 1) / TS;

    extern __shared__ __align__(16) unsigned char dtc_smem[];
    att_bf16* Ks = reinterpret_cast<att_bf16*>(dtc_smem);  // nst x TS x DP
    att_bf16* Vs = Ks + nst * TS * DP;                     // nst x TS x DP
    att_bf16* Qs = Vs + nst * TS * DP;                     // 16 x DP
    float* red = reinterpret_cast<float*>(dtc_smem);  // after the loop: 4 x 16 x (D + 2)

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int64_t row = (int64_t)Hkv * D;  // elements between two positions of one head
    const att_bf16* kbase = kc + (int64_t)b * S * row + (int64_t)h * D;
    const att_bf16* vbase = vc + (int64_t)b * S * row + (int64_t)h * D;
    auto stage = [&](int sub, int st) {
        const int p0 = p_start + sub * TS;
        att_bf16* kd = Ks + st * TS * DP;
        att_bf16* vd = Vs + st * TS * DP;
        for (int e = tid; e < TS * NCH; e += DEC_THREADS) {
            const int j = e / NCH, c = e - j * NCH;
            const bool in = p0 + j < p_end;
            const int64_t at = (int64_t)(in ? p0 + j : 0) * row + c * 8;
            att_cp_async16(kd + j * DP + c * 8, kbase + at, in);
            att_cp_async16(vd + j * DP + c * 8, vbase + at, in);
        }
    };
    const att_bf16* qrow = q + ((int64_t)b * Hkv * G + (int64_t)h * G + g0) * D;
    for (int e = tid; e < 16 * NCH; e += DEC_THREADS) {
        const int i = e / NCH, c = e - i * NCH;
        att_cp_async16(Qs + i * DP + c * 8, qrow + (i < GB ? i : 0) * D + c * 8, i < GB);
    }
    stage(0, 0);
    att_cp_async_commit();

    uint32_t qf[KD][4];
    float o[ND][4];
#pragma unroll
    for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.0f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;  // l: this lane's columns

    for (int sub = 0; sub < nsub; ++sub) {
        if (sub + 1 < nsub) stage(sub + 1, (sub + 1) % nst);  // nst == 2 whenever nsub > 1
        att_cp_async_commit();
        att_cp_async_wait<1>();  // sub-tile `sub` (and Q) has landed
        __syncthreads();
        if (sub == 0)
#pragma unroll
            for (int kk = 0; kk < KD; ++kk)
                att_ldmatrix_x4(qf[kk], Qs + (lane & 15) * DP + kk * 16 + (lane >> 4) * 8);
        const att_bf16* Kw = Ks + ((sub % nst) * TS + warp * 16) * DP;
        const att_bf16* Vw = Vs + ((sub % nst) * TS + warp * 16) * DP;
        const int t0 = warp * 16;  // this warp's first position in the sub-tile
        const int nt = min(TS, p_end - (p_start + sub * TS));

        float s[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t bk[4];
            att_ldmatrix_x4(bk, Kw + ((lane & 7) + ((lane >> 4) << 3)) * DP + kk * 16
                                    + ((lane >> 3) & 1) * 8);
            att_mma(s[0], qf[kk], bk[0], bk[1]);
            att_mma(s[1], qf[kk], bk[2], bk[3]);
        }
        float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int t = t0 + n * 8 + 2 * (lane & 3) + (e & 1);
                s[n][e] = t < nt ? s[n][e] * scale : -INFINITY;
            }
            mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
            mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
        }
#pragma unroll
        for (int o2 = 1; o2 <= 2; o2 <<= 1) {
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o2));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o2));
        }
        // a warp whose positions all lie past p_end keeps m = -inf, p = 0
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        const float base_a = mn_a == -INFINITY ? 0.0f : mn_a;
        const float base_b = mn_b == -INFINITY ? 0.0f : mn_b;
        const float al_a = expf(m_a - base_a), al_b = expf(m_b - base_b);
        m_a = mn_a;
        m_b = mn_b;
        float ps_a = 0.0f, ps_b = 0.0f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
            s[n][0] = expf(s[n][0] - base_a);
            s[n][1] = expf(s[n][1] - base_a);
            s[n][2] = expf(s[n][2] - base_b);
            s[n][3] = expf(s[n][3] - base_b);
            ps_a += s[n][0] + s[n][1];
            ps_b += s[n][2] + s[n][3];
        }
        l_a = l_a * al_a + ps_a;
        l_b = l_b * al_b + ps_b;
        uint32_t pa[4];
        pa[0] = att_pack(s[0][0], s[0][1]);
        pa[1] = att_pack(s[0][2], s[0][3]);
        pa[2] = att_pack(s[1][0], s[1][1]);
        pa[3] = att_pack(s[1][2], s[1][3]);
#pragma unroll
        for (int n2 = 0; n2 < ND / 2; ++n2) {
            o[2 * n2][0] *= al_a;
            o[2 * n2][1] *= al_a;
            o[2 * n2][2] *= al_b;
            o[2 * n2][3] *= al_b;
            o[2 * n2 + 1][0] *= al_a;
            o[2 * n2 + 1][1] *= al_a;
            o[2 * n2 + 1][2] *= al_b;
            o[2 * n2 + 1][3] *= al_b;
            uint32_t bv[4];
            att_ldmatrix_x4_trans(bv, Vw + (lane & 15) * DP + n2 * 16 + (lane >> 4) * 8);
            att_mma(o[2 * n2], pa, bv[0], bv[1]);
            att_mma(o[2 * n2 + 1], pa, bv[2], bv[3]);
        }
        __syncthreads();  // the stage is consumed before it is refilled
    }

    // each warp's (acc, m, l) into shared memory, then the four merged in warp order
#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, o2);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, o2);
    }
    const int ra = lane >> 2, col = 2 * (lane & 3);
    float* rw = red + warp * 16 * (D + 2);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
        rw[ra * (D + 2) + n * 8 + col] = o[n][0];
        rw[ra * (D + 2) + n * 8 + col + 1] = o[n][1];
        rw[(ra + 8) * (D + 2) + n * 8 + col] = o[n][2];
        rw[(ra + 8) * (D + 2) + n * 8 + col + 1] = o[n][3];
    }
    if ((lane & 3) == 0) {
        rw[ra * (D + 2) + D] = m_a;
        rw[ra * (D + 2) + D + 1] = l_a;
        rw[(ra + 8) * (D + 2) + D] = m_b;
        rw[(ra + 8) * (D + 2) + D + 1] = l_b;
    }
    __syncthreads();
    float* wrow = ws + ((((int64_t)b * Hkv + h) * splits + split) * G + g0) * (D + 2);
    for (int id = tid; id < GB * (D + 1); id += DEC_THREADS) {
        const int i = id / (D + 1), d = id - i * (D + 1);  // d == D: the row's m and l
        float M = -INFINITY;
#pragma unroll
        for (int w = 0; w < 4; ++w) M = fmaxf(M, red[(w * 16 + i) * (D + 2) + D]);
        float x = 0.0f;
#pragma unroll
        for (int w = 0; w < 4; ++w) {
            const float* rr = red + (w * 16 + i) * (D + 2);
            x += rr[d < D ? d : D + 1] * expf(rr[D] - M);  // exp(-inf) = 0 for an empty warp
        }
        if (d < D) {
            wrow[i * (D + 2) + d] = x;
        } else {
            wrow[i * (D + 2) + D] = M;
            wrow[i * (D + 2) + D + 1] = x;
        }
    }
}

// Pass 2. Block (row g, KV head, request): M = max of the valid splits' m, each split's weight
// w_i = exp(m_i - M), l = sum_i l_i w_i; then out[g, d] = (sum_i acc_i[d] w_i) / max(l, 1e-30).
// Every sum runs over the splits in ascending order. The first DEC_MERGE_PRE partials of each
// column are loaded while warp 0 forms the weights, so the block waits on memory once.
template <typename T>
__global__ void __launch_bounds__(DEC_THREADS)
decode_merge_kernel(const float* __restrict__ ws, const int* __restrict__ pos,
                    T* __restrict__ out, int S, int Hkv, int G, int D, int L, int splits) {
    extern __shared__ float merge_smem[];
    float* W = merge_smem;     // splits: m_i, then the weights
    float* Ls = W + splits;    // splits: l_i
    float* lsum = Ls + splits;
    const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int tid = threadIdx.x;
    const int kend = min(pos[b] + 1, S);
    const int n = kend > 0 ? min((kend + L - 1) / L, splits) : 0;
    const int64_t step = (int64_t)G * (D + 2);  // one split to the next
    const float* w = ws + (((int64_t)b * Hkv + h) * splits * G + g) * (D + 2);
    float a[2][DEC_MERGE_PRE];  // columns tid and tid + DEC_THREADS (D <= 256)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const int d = tid + c * DEC_THREADS;
#pragma unroll
        for (int i = 0; i < DEC_MERGE_PRE; ++i) a[c][i] = i < n && d < D ? w[i * step + d] : 0.0f;
    }
    if (tid < 32) {
        float M = -INFINITY;
        for (int i = tid; i < n; i += 32) {
            W[i] = w[i * step + D];
            Ls[i] = w[i * step + D + 1];
            M = fmaxf(M, W[i]);
        }
#pragma unroll
        for (int o = 16; o >= 1; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
        for (int i = tid; i < n; i += 32) W[i] = expf(W[i] - M);
        __syncwarp();
        if (tid == 0) {
            float l = 0.0f;
            for (int i = 0; i < n; ++i) l += Ls[i] * W[i];
            lsum[0] = fmaxf(l, 1e-30f);
        }
    }
    __syncthreads();
    T* o = out + (((int64_t)b * Hkv + h) * G + g) * D;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
        const int d = tid + c * DEC_THREADS;
        if (d >= D) continue;
        float acc = 0.0f;
#pragma unroll
        for (int i = 0; i < DEC_MERGE_PRE; ++i) acc += a[c][i] * (i < n ? W[i] : 0.0f);
        for (int i = DEC_MERGE_PRE; i < n; ++i) acc += w[i * step + d] * W[i];
        o[d] = att_from_f32<T>(acc / lsum[0]);
    }
}

static int launch_merge_d(const float* ws, const int* pos, void* out, int bf16, int B, int S,
                          int Hkv, int G, int D, int L, int splits, cudaStream_t stream) {
    const int msmem = (int)sizeof(float) * (2 * splits + 1);
    const dim3 grid(G, Hkv, B);
    if (bf16) {
        if (msmem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                decode_merge_kernel<att_bf16>, cudaFuncAttributeMaxDynamicSharedMemorySize, msmem);
            if (e != cudaSuccess) return (int)e;
        }
        decode_merge_kernel<att_bf16><<<grid, DEC_THREADS, msmem, stream>>>(
            ws, pos, (att_bf16*)out, S, Hkv, G, D, L, splits);
    } else {
        if (msmem > 48 * 1024) {
            const cudaError_t e = cudaFuncSetAttribute(
                decode_merge_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize, msmem);
            if (e != cudaSuccess) return (int)e;
        }
        decode_merge_kernel<float><<<grid, DEC_THREADS, msmem, stream>>>(ws, pos, (float*)out, S,
                                                                        Hkv, G, D, L, splits);
    }
    return (int)cudaGetLastError();
}

template <typename T, int DMAX>
static int launch_simt(const void* q, const void* kc, const void* vc, const int* pos, float* ws,
                       int B, int S, int Hkv, int G, int D, int L, int splits, float scale,
                       cudaStream_t stream) {
    using P = DecShape<T, DMAX>;
    if (L % P::TS != 0) return (int)cudaErrorInvalidValue;
    const int nst = L > P::TS ? 2 : 1;
    const int RP = D * (int)sizeof(T) + 16;
    const int GB = G < DEC_GB ? G : DEC_GB;
    const int stage_bytes = std::max(2 * nst * P::TS * RP,
                                     GB * DEC_THREADS * P::CH * (int)sizeof(float));
    const int smem = stage_bytes + (int)sizeof(float) * (GB * D + GB * P::TS + 3 * DEC_GB);
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            decode_split_kernel<T, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int ngg = (G + DEC_GB - 1) / DEC_GB;
    decode_split_kernel<T, DMAX><<<dim3(splits, Hkv * ngg, B), DEC_THREADS, smem, stream>>>(
        (const T*)q, (const T*)kc, (const T*)vc, pos, ws, S, Hkv, G, D, L, splits, nst, scale);
    return (int)cudaGetLastError();
}

template <typename T>
static int launch_simt_d(const void* q, const void* kc, const void* vc, const int* pos,
                         float* ws, int B, int S, int Hkv, int G, int D, int L, int splits,
                         float scale, cudaStream_t st) {
    if (D <= 32)
        return launch_simt<T, 32>(q, kc, vc, pos, ws, B, S, Hkv, G, D, L, splits, scale, st);
    if (D <= 64)
        return launch_simt<T, 64>(q, kc, vc, pos, ws, B, S, Hkv, G, D, L, splits, scale, st);
    if (D <= 128)
        return launch_simt<T, 128>(q, kc, vc, pos, ws, B, S, Hkv, G, D, L, splits, scale, st);
    if (D <= 256)
        return launch_simt<T, 256>(q, kc, vc, pos, ws, B, S, Hkv, G, D, L, splits, scale, st);
    return (int)cudaErrorInvalidValue;
}

template <int D>
static int launch_tc(const void* q, const void* kc, const void* vc, const int* pos, float* ws,
                     int B, int S, int Hkv, int G, int L, int splits, float scale,
                     cudaStream_t stream) {
    if (L % DEC_TC_TS != 0) return (int)cudaErrorInvalidValue;
    const int nst = L > DEC_TC_TS ? 2 : 1;
    const int stage_bytes = (2 * nst * DEC_TC_TS + 16) * (D + 8) * (int)sizeof(att_bf16);
    const int smem = std::max(stage_bytes, 4 * 16 * (D + 2) * (int)sizeof(float));
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            decode_split_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    const int ngg = (G + 15) / 16;
    decode_split_tc_kernel<D><<<dim3(splits, Hkv * ngg, B), DEC_THREADS, smem, stream>>>(
        (const att_bf16*)q, (const att_bf16*)kc, (const att_bf16*)vc, pos, ws, S, Hkv, G, L,
        splits, nst, scale);
    return (int)cudaGetLastError();
}

// q/out (B, Hq, D), caches (B, S, Hkv, D), all contiguous and 16-byte aligned with rows of a
// multiple of 16 bytes; pos (B,) int32; ws (B, Hkv, splits, G, D + 2) float32 scratch;
// positions split into `splits` runs of L. The tensor-core route takes bfloat16 at D in
// {64, 128}; the SIMT route float32 (`bf16` = 0) or bfloat16 at D <= 256. Pass 1 and pass 2
// launch on `stream`; returns cudaGetLastError() (0 on success).
static bool decode_args_ok(int B, int Hq, int Hkv, int L, int splits) {
    return B > 0 && Hkv > 0 && Hq % Hkv == 0 && Hq / Hkv <= DEC_MAX_G && L > 0 && splits > 0;
}

extern "C" int decode_attention_tc_run(const void* q, const void* kc, const void* vc,
                                       const int* pos, void* ws, void* out, int B, int Hq,
                                       int Hkv, int S, int D, int L, int splits, float scale,
                                       void* stream) {
    if (!decode_args_ok(B, Hq, Hkv, L, splits)) return (int)cudaErrorInvalidValue;
    const int G = Hq / Hkv;
    const cudaStream_t st = (cudaStream_t)stream;
    float* w = (float*)ws;
    int err = (int)cudaErrorInvalidValue;
    if (D == 64) err = launch_tc<64>(q, kc, vc, pos, w, B, S, Hkv, G, L, splits, scale, st);
    if (D == 128) err = launch_tc<128>(q, kc, vc, pos, w, B, S, Hkv, G, L, splits, scale, st);
    if (err != 0) return err;
    return launch_merge_d(w, pos, out, 1, B, S, Hkv, G, D, L, splits, st);
}

extern "C" int decode_attention_simt_run(const void* q, const void* kc, const void* vc,
                                         const int* pos, void* ws, void* out, int B, int Hq,
                                         int Hkv, int S, int D, int L, int splits, float scale,
                                         int bf16, void* stream) {
    if (!decode_args_ok(B, Hq, Hkv, L, splits) || (D * (bf16 ? 2 : 4)) % 16 != 0)
        return (int)cudaErrorInvalidValue;
    const int G = Hq / Hkv;
    const cudaStream_t st = (cudaStream_t)stream;
    float* w = (float*)ws;
    const int err = bf16 ? launch_simt_d<att_bf16>(q, kc, vc, pos, w, B, S, Hkv, G, D, L, splits,
                                                   scale, st)
                         : launch_simt_d<float>(q, kc, vc, pos, w, B, S, Hkv, G, D, L, splits,
                                                scale, st);
    if (err != 0) return err;
    return launch_merge_d(w, pos, out, bf16, B, S, Hkv, G, D, L, splits, st);
}
