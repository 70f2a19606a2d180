// Building blocks of the fused chain kernels: the fp32 product loop on the
// CUDA cores (mac_rows, which chain.cu's IIR block also runs) and the stages
// of the four-step form, which only chain_tc.cu ("regs") still runs.  There
// a frame of n1 rows of n2 <= 128 samples sits in shared memory as rows of
// 128 floats, and every table row is 128 wide: HT = H^T (n2, 128), PhiT =
// Phi^T (D, 128), Tc / Ts (n1p, 128) and the step-3 table [P^T; Q^T]
// (2 n2, 128), zero-padded to n1p = n1 rounded up to a multiple of 8 rows
// (kernels/chain.py _padded_tables).

#pragma once

#include <cuda_runtime.h>

namespace sdsp_chain {

constexpr int kN2 = 128;              // lanes of a frame row in shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sums over k run in chunks of kChunk terms, each chunk into a fresh partial
// that is then added to the total.  One running sum over all 256 terms of
// step 3 loses about 6 dB against the chunked sum (emulated in float64 on
// random frames at N = 4096: 129.6 dB against 136.4 dB), which would leave
// no margin under the chain's 130 dB bar.
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

// mac_rows for the rows row_r = m0 + warp + 8 r of A (row stride lda, a
// multiple of 4) and the four columns col0 = 4 lane of B.
template <int TM>
__device__ __forceinline__ void mac(float (&acc)[TM][4], int m0,
                                    const float* a, int lda, const float* b,
                                    int K) {
  const float* arow[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    arow[r] = a + (m0 + (threadIdx.x >> 5) + kWarps * r) * lda;
  }
  mac_rows<TM>(acc, arow, b + 4 * (threadIdx.x & 31), K);
}

__device__ __forceinline__ void store4(float* dst, const float (&v)[4]) {
  *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
}

// Row stride of the sub-block starts held transposed, (rows, dp).
__host__ __device__ __forceinline__ int starts_stride(int d) {
  return (d + 3) & ~3;
}

// Shared memory of a block that holds `rows` frame rows (a multiple of 8):
// two frame buffers of rows x 128, the output stage of 128 x (rows + 1) or
// the frame's y at a row stride of ldy, and the transposed starts.
__host__ __device__ __forceinline__ size_t smem_floats(int rows, int d,
                                                       int ldy) {
  const size_t stage = static_cast<size_t>(kN2) * (rows + 1);
  const size_t y = static_cast<size_t>(rows) * ldy;
  return 2 * static_cast<size_t>(rows) * kN2 + (stage > y ? stage : y) +
         static_cast<size_t>(starts_stride(d)) * rows;
}

// Loads frame f of x (frames, n1, n2) into buf (n1p rows of 128, zero
// outside (n1, n2)) and its starts s (frames, d, n1) transposed into st
// (n1p, dp).  Without kPad, n1 == n1p and n2 == 128.
template <bool kPad>
__device__ __forceinline__ void load_frame(float* buf, float* st,
                                           const float* x, const float* s,
                                           size_t f, int n1, int n1p, int n2,
                                           int d) {
  const int tid = threadIdx.x;
  const int dp = starts_stride(d);
  const int n = n1p * kN2;
  if (!kPad) {
    const float4* xf = reinterpret_cast<const float4*>(x + f * n);
    for (int i = tid; i < n / 4; i += kThreads) {
      reinterpret_cast<float4*>(buf)[i] = xf[i];
    }
  } else {
    const float* xf = x + f * n1 * n2;
    for (int i = tid; i < n; i += kThreads) {
      const int p = i / kN2, j = i % kN2;
      buf[i] = (p < n1 && j < n2) ? xf[p * n2 + j] : 0.f;
    }
    for (int i = tid; i < (n1p - n1) * dp; i += kThreads) st[n1 * dp + i] = 0.f;
  }
  const float* sf = s + f * d * n1;
  for (int i = tid; i < d * n1; i += kThreads) {
    st[(i % n1) * dp + i / n1] = sf[i];
  }
}

// IIR block: y = x (rows, 128) H^T + starts^T (rows, D) Phi^T, written at a
// row stride of ldy.  The depth n2 stays a run-time value on purpose: with a
// compile-time depth the compiler unrolls the whole sum, hoists all 128 rows
// of H^T into registers ahead of the row loop and spills them (seen at
// TM = 1: a 3.8 KB stack frame and a 20x slower kernel at N = 1024).
template <int TM>
__device__ __forceinline__ void iir_stage(float* y, int ldy, const float* x,
                                          const float* st, const float* HT,
                                          const float* PhiT, int rows, int n2,
                                          int d) {
  const int warp = threadIdx.x >> 5, col0 = 4 * (threadIdx.x & 31);
  for (int m0 = 0; m0 < rows; m0 += kWarps * TM) {
    float acc[TM][4] = {};
    mac<TM>(acc, m0, x, kN2, HT, n2);
    mac<TM>(acc, m0, st, starts_stride(d), PhiT, d);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      store4(y + (m0 + warp + kWarps * r) * ldy + col0, acc[r]);
    }
  }
}

// Twiddle in place over `rows` rows, row = k1: tr = c Tc - s Ts,
// ti = s Tc + c Ts.
__device__ __forceinline__ void twiddle_stage(float* c, float* s,
                                              const float* Tc, const float* Ts,
                                              int rows) {
  for (int i = threadIdx.x; i < rows * kN2; i += kThreads) {
    const float cv = c[i], sv = s[i], tc = Tc[i], ts = Ts[i];
    c[i] = cv * tc - sv * ts;
    s[i] = sv * tc + cv * ts;
  }
}

// Step 3 over `rows` rows: tr T[:n2] + ti T[n2:2 n2], staged transposed as
// out^T[l, row] at a row stride of ldo, so that a store reads consecutive
// k1 from consecutive addresses.
template <int TM>
__device__ __forceinline__ void step3_stage(float* out_t, int ldo,
                                            const float* tr, const float* ti,
                                            const float* T, int rows, int n2) {
  const int warp = threadIdx.x >> 5, col0 = 4 * (threadIdx.x & 31);
  for (int m0 = 0; m0 < rows; m0 += kWarps * TM) {
    float acc[TM][4] = {};
    mac<TM>(acc, m0, tr, kN2, T, n2);
    mac<TM>(acc, m0, ti, kN2, T + n2 * kN2, n2);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = m0 + warp + kWarps * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) out_t[(col0 + j) * ldo + m] = acc[r][j];
    }
  }
}

// The Nyquist bin X[N/2] = sum_t tr[0, t] (-1)^t of one frame, reduced by
// one warp; every lane of the warp returns it.
__device__ __forceinline__ float nyquist_warp(const float* tr_row0) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int t = lane; t < kN2; t += 32) acc += (t & 1) ? -tr_row0[t] : tr_row0[t];
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// Packed one-sided spectrum of one frame from the staged out^T: natural
// bin order k = k1 + n1 k2, consecutive threads on consecutive k, X[N/2].re
// in the imaginary plane's bin 0.
__device__ __forceinline__ void store_natural(float* re, float* im,
                                              const float* out_t, int ldo,
                                              int n1, int n2, float nyq) {
  const int h = n1 * n2 / 2;
  for (int k = threadIdx.x; k < h; k += kThreads) {
    const int k1 = k % n1, k2 = k / n1;
    re[k] = out_t[k2 * ldo + k1];
    im[k] = k == 0 ? nyq : out_t[(n2 / 2 + k2) * ldo + k1];
  }
}

}  // namespace sdsp_chain
