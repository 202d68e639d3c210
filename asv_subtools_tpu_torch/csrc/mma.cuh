// The tensor cores' fragment loads and product as inline PTX (mma.sync on
// bf16 or fp16 with f32 sums), shared by fbank.cu, att_pooling.cu,
// res2_chain.cu and rel_attention.cu; and the padded transpose that writes
// the weight layouts of att_pooling.cu's and res2_chain.cu's tensor-core
// kernels.
// Shared-memory addresses are u32 (smem_u32 in async_copy.cuh).
//
// m16n8k16 fragments (g = lane / 4, tg = lane % 4): A [16 rows][16 k],
// a[0] rows g, k 2tg..+1; a[1] rows g + 8; a[2] k + 8; a[3] both. B
// [16 k][8 cols], b[0] k 2tg..+1 of col g, b[1] k + 8. C [16][8], c[0..1]
// row g, cols 2tg..+1; c[2..3] row g + 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned)
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// the same, each matrix transposed: from rows that lie [k][n], the B
// fragments of two n8 tiles (matrices k 0-7 and 8-15 of cols 0-7, then of
// cols 8-15)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void mma_f16_16816(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 h = __floats2half2_rn(lo, hi);  // .x = lo in the low half
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The weight layouts the tensor-core launchers write into their workspace:
// dst[b][i][j] = src[b][j][i] (i < cols, j < rows), else 0, bit for bit.
template <typename T>
__global__ void __launch_bounds__(256) padded_transpose_kernel(const T* __restrict__ src, T* __restrict__ dst,
                                                               int rows, int cols, int dst_rows, int dst_cols,
                                                               size_t n) {
  const size_t per = (size_t)dst_rows * dst_cols;
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n; e += (size_t)gridDim.x * blockDim.x) {
    const size_t b = e / per, r = e - b * per;
    const int i = (int)(r / dst_cols), j = (int)(r - (size_t)i * dst_cols);
    dst[e] = i < cols && j < rows ? src[(b * rows + j) * cols + i] : T(0);
  }
}

template <typename T>
int padded_transpose(const void* src, void* dst, int batch, int rows, int cols, int dst_rows, int dst_cols,
                     cudaStream_t st) {
  const size_t n = (size_t)batch * dst_rows * dst_cols, blocks = (n + 255) / 256;
  padded_transpose_kernel<T><<<(unsigned)(blocks < 2048 ? blocks : 2048), 256, 0, st>>>(
      static_cast<const T*>(src), static_cast<T*>(dst), rows, cols, dst_rows, dst_cols, n);
  return (int)cudaGetLastError();
}

}  // namespace
