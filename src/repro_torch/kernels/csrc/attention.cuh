// Shared device code of the two attention kernels (flash_attention.cu, decode_attention.cu):
// conversions between the input type and float32; the 16-byte asynchronous copy (cp.async)
// from global into shared memory that both use to stage K and V in their own type; and the
// warp-level tensor-core pieces of their bfloat16 routes (ldmatrix, mma.sync m16n8k16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

__device__ __forceinline__ float att_to_f32(float x) { return x; }
__device__ __forceinline__ float att_to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T att_from_f32(float x);
template <> __device__ __forceinline__ float att_from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 att_from_f32<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t att_smem_addr(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

// Copy 16 bytes from `src` (global, 16-byte aligned) to `dst` (shared, 16-byte aligned), or
// write 16 zero bytes to `dst` and read nothing when `valid` is false.
__device__ __forceinline__ void att_cp_async16(void* dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(att_smem_addr(dst)),
                 "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void att_cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed copy groups are still in flight.
template <int N>
__device__ __forceinline__ void att_cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------------------------
// tensor cores (bfloat16)
// ---------------------------------------------------------------------------------------------

typedef __nv_bfloat16 att_bf16;

__device__ __forceinline__ void att_ldmatrix_x4(uint32_t* r, const att_bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(att_smem_addr(p)));
}

__device__ __forceinline__ void att_ldmatrix_x4_trans(uint32_t* r, const att_bf16* p) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(att_smem_addr(p)));
}

// c (16x8, f32) += a (16x16, bf16, row) . b (16x8, bf16, col)
__device__ __forceinline__ void att_mma(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as one bf16 pair: `lo` in the low half (the lower column of an mma fragment)
__device__ __forceinline__ uint32_t att_pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}
