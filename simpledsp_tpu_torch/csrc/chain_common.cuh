// Building blocks of the fused chain kernels (chain_natural.cuh): the fp32
// product loop on the CUDA cores (mac_rows, which the IIR block by column
// bands runs) and the constants of a block.  A frame of n1 rows of n2 <= 128
// samples sits in shared memory as rows of up to 128 floats; the tables H^T
// (n2, 128) and Phi^T (D, 128) are read in rows 128 wide.

#pragma once

#include <cuda_runtime.h>

namespace sdsp_chain {

constexpr int kN2 = 128;              // lanes of a frame row in shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sums over k run in chunks of kChunk terms, each chunk into a fresh partial
// that is then added to the total.  One running sum over 256 terms (the
// four-step form's step 3, emulated in float64 on random frames at
// N = 4096) lost about 6 dB against the chunked sum, 129.6 dB against
// 136.4 dB, which would leave no margin under the chain's 130 dB bar.
constexpr int kChunk = 16;

// Largest shared memory a block may opt into on an H100 (232,448 bytes).
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ void fma4(float (&p)[4], float a, const float4& b) {
  p[0] = fmaf(a, b.x, p[0]);
  p[1] = fmaf(a, b.y, p[1]);
  p[2] = fmaf(a, b.z, p[2]);
  p[3] = fmaf(a, b.w, p[3]);
}

// part[r][:] += sum over k .. k + 3 of A[row_r, k] B[k, col0 : col0 + 4].
template <int TM>
__device__ __forceinline__ void mac4(float (&part)[TM][4],
                                     const float* const (&arow)[TM],
                                     const float* bp, int k) {
  float4 bv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    bv[q] = *reinterpret_cast<const float4*>(bp + (k + q) * kN2);
  }
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    const float4 av = *reinterpret_cast<const float4*>(arow[r] + k);
    fma4(part[r], av.x, bv[0]);
    fma4(part[r], av.y, bv[1]);
    fma4(part[r], av.z, bv[2]);
    fma4(part[r], av.w, bv[3]);
  }
}

// acc[r][:] += sum_{k < K} arow[r][k] bp[k * 128 : k * 128 + 4]: the
// thread's TM rows of A (16-byte aligned) against its four columns of B
// (row stride 128), k ascending in chunks of kChunk.  A full chunk is
// unrolled; the chunk loop is not (see the kernels' n2 argument).
template <int TM>
__device__ __forceinline__ void mac_rows(float (&acc)[TM][4],
                                         const float* const (&arow)[TM],
                                         const float* bp, int K) {
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    float part[TM][4] = {};
    if (k0 + kChunk <= K) {
#pragma unroll
      for (int k = k0; k < k0 + kChunk; k += 4) mac4<TM>(part, arow, bp, k);
    } else {
      int k = k0;
      for (; k + 4 <= K; k += 4) mac4<TM>(part, arow, bp, k);
      for (; k < K; ++k) {  // K % 4 tail: the D state columns, odd n2
        const float4 bv = *reinterpret_cast<const float4*>(bp + k * kN2);
#pragma unroll
        for (int r = 0; r < TM; ++r) fma4(part[r], arow[r][k], bv);
      }
    }
#pragma unroll
    for (int r = 0; r < TM; ++r) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] += part[r][j];
    }
  }
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// Row stride of the sub-block starts held transposed, (rows, dp).
__host__ __device__ __forceinline__ int starts_stride(int d) {
  return (d + 3) & ~3;
}

}  // namespace sdsp_chain
