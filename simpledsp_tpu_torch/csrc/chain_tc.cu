// The fused chain with step 1 on the tensor cores (sm_90a): the packed
// half-spectrum chain on the four-step design (chain_common.cuh), one frame
// per block, where the step-1 DFT [W1c; W1s] y runs as bf16 x bf16 -> fp32
// mma.sync products that are exact.  Per frame, with x viewed as (n1, n2)
// and the sub-block starts s as (D, n1):
//
//   1. IIR block     y[p, i]  = sum_j x[p, j] H[i, j] + sum_e s[e, p] Phi[i, e]
//   2. step 1        [c; s][k1, t] = sum_p W1cs[k1, p] y[p, t]
//   3. twiddle       tr = c Tc - s Ts,  ti = s Tc + c Ts
//   4. step 3        out[k1, l] = sum_t tr[k1, t] P[l, t] + ti[k1, t] Q[l, t]
//                    (lanes l < n2/2: Re X, l >= n2/2: Im X, bin k1 + n1 (l % (n2/2)))
//   5. Nyquist       X[N/2] = sum_t tr[0, t] (-1)^t into the Im slot of bin 0
//
// Replaces the TPU kernel simpledsp_tpu/kernels/chain_variants.py
// _make_packed_regs_kernel (:67), fused_chain_frames(layout="regs"): float32
// only.  Each factor is split into three bf16 parts, a = a_h + a_m + a_l
// (round to nearest even, each part the rounded residual of the last; 3 x 8
// bits carry float32's 24): y in the kernel, the table W1cs on the host from
// its float64 values (chain_variants._bf16_split3).  A product of two bf16
// parts is exact in fp32, and all nine, W_a y_b for a, b in {h, m, l}, are
// summed: per table part a and 16-deep step of K, the three y parts go into
// one fresh fp32 partial (low parts first), the partials are added in IEEE
// fp32, and the three sums are added (l + m) + h.
// The IIR block, the twiddle and step 3 stay IEEE fp32 on the CUDA cores, as
// in the TPU variant; nothing runs in TF32.
//
// Step 1 is m16n8k16 tiles: M = 2 n1p rows of the table, N = 128 columns of
// y, K = n1p rows of y padded to a multiple of 16 (zeros in the table's
// extra columns, zeros read for y's extra rows).  A fragments are read from
// the split table in global memory, (3, 2 n1p, K16) bf16, row-major; B
// fragments from y in shared memory, stored at a row stride of 132 floats so
// that the four k rows a warp reads fall in different banks, and split into
// bf16 parts in registers.  What bounds the kernel is FMA issue on the
// CUDA cores: at N = 4096 a frame is about 3.7 MFLOP of fp32 FMAs against
// 32 KB of input and output, and step 1 is about a tenth of them.

#include <cuda_bf16.h>
#include <stdint.h>

#include "chain_common.cuh"

namespace {

using namespace sdsp_chain;

constexpr int kLdy = kN2 + 4;   // row stride of y for the B fragments

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Step 1 with the split products: c = rows [0, n1p) of W1cs y into c_out,
// s = rows [n1p, 2 n1p) into s_out (row stride 128).  W3 holds the table's
// three bf16 parts, each (2 n1p, k16).
__device__ __forceinline__ void step1_split(float* c_out, float* s_out,
                                            const float* y,
                                            const __nv_bfloat16* W3, int n1p,
                                            int k16) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m_tiles = 2 * n1p / 16;
  const size_t plane = static_cast<size_t>(2 * n1p) * k16;
  for (int tile = warp; tile < m_tiles * (kN2 / 8); tile += kWarps) {
    const int r0 = (tile / (kN2 / 8)) * 16 + gid;
    const int col = (tile % (kN2 / 8)) * 8;
    float acc[3][4] = {};
    for (int k0 = 0; k0 < k16; k0 += 16) {
      // B fragment: y[k0 + 2 tig + {0, 1}][col + gid] and the same 8 rows on.
      uint32_t b[3][2];
#pragma unroll
      for (int hk = 0; hk < 2; ++hk) {
        __nv_bfloat16 parts[3][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = k0 + 2 * tig + e + 8 * hk;
          const float v = p < n1p ? y[p * kLdy + col + gid] : 0.f;
          const __nv_bfloat16 vh = __float2bfloat16_rn(v);
          const float r1 = v - __bfloat162float(vh);
          const __nv_bfloat16 vm = __float2bfloat16_rn(r1);
          parts[0][e] = vh;
          parts[1][e] = vm;
          parts[2][e] = __float2bfloat16_rn(r1 - __bfloat162float(vm));
        }
#pragma unroll
        for (int q = 0; q < 3; ++q) b[q][hk] = pack2(parts[q][0], parts[q][1]);
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const __nv_bfloat16* w = W3 + a * plane + k0 + 2 * tig;
        uint32_t af[4];
        af[0] = *reinterpret_cast<const uint32_t*>(w + r0 * k16);
        af[1] = *reinterpret_cast<const uint32_t*>(w + (r0 + 8) * k16);
        af[2] = *reinterpret_cast<const uint32_t*>(w + r0 * k16 + 8);
        af[3] = *reinterpret_cast<const uint32_t*>(w + (r0 + 8) * k16 + 8);
        // A fresh partial for each 16-deep step, added in IEEE fp32: the
        // tensor cores' own fp32 accumulation over all of K = 128 gave
        // 127.9 dB against the float64 plain version at N = 16384 on an
        // H100, the partials 135.9 dB.
        float part[4] = {};
        mma_bf16(part, af, b[2]);
        mma_bf16(part, af, b[1]);
        mma_bf16(part, af, b[0]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[a][j] += part[j];
      }
    }
    // C fragment: rows r0 and r0 + 8, columns col + 2 tig + {0, 1}.
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int r = r0 + 8 * hr;
      const float2 v = make_float2((acc[2][2 * hr] + acc[1][2 * hr]) + acc[0][2 * hr],
                                   (acc[2][2 * hr + 1] + acc[1][2 * hr + 1]) +
                                       acc[0][2 * hr + 1]);
      float* dst = (r < n1p ? c_out + r * kN2 : s_out + (r - n1p) * kN2) +
                   col + 2 * tig;
      *reinterpret_cast<float2*>(dst) = v;
    }
  }
}

template <int TM, bool kPad>
__global__ void __launch_bounds__(kThreads)
chain_regs_kernel(const float* __restrict__ x, const float* __restrict__ s,
                  const float* __restrict__ HT, const float* __restrict__ PhiT,
                  const __nv_bfloat16* __restrict__ W3,
                  const float* __restrict__ Tc, const float* __restrict__ Ts,
                  const float* __restrict__ PQT, float* __restrict__ re,
                  float* __restrict__ im, int n1, int n1p_arg, int n2_arg,
                  int d) {
  const int n1p = kPad ? n1p_arg : n1;
  const int n2 = kPad ? n2_arg : kN2;
  const int k16 = (n1p + 15) & ~15;
  extern __shared__ float4 smem4[];
  __shared__ float nyq;
  const int n = n1p * kN2;
  const int ldo = n1p + 1;
  const size_t mid = smem_floats(n1p, d, kLdy) - 2 * static_cast<size_t>(n) -
                     static_cast<size_t>(starts_stride(d)) * n1p;
  float* buf_a = reinterpret_cast<float*>(smem4);  // x, then c -> tr
  float* buf_b = buf_a + n;                        // y (stride kLdy), out^T
  float* buf_c = buf_b + mid;                      // s -> ti
  float* st = buf_c + n;
  const size_t f = blockIdx.x;

  load_frame<kPad>(buf_a, st, x, s, f, n1, n1p, n2, d);
  __syncthreads();
  iir_stage<TM>(buf_b, kLdy, buf_a, st, HT, PhiT, n1p, n2_arg, d);
  __syncthreads();
  step1_split(buf_a, buf_c, buf_b, W3, n1p, k16);
  __syncthreads();
  twiddle_stage(buf_a, buf_c, Tc, Ts, n1p);
  __syncthreads();
  step3_stage<TM>(buf_b, ldo, buf_a, buf_c, PQT, n1p, n2_arg);
  if ((threadIdx.x >> 5) == 0) {
    const float v = nyquist_warp(buf_a);
    if (threadIdx.x == 0) nyq = v;
  }
  __syncthreads();
  const size_t h = static_cast<size_t>(n1) * n2 / 2;
  store_natural(re + f * h, im + f * h, buf_b, ldo, n1, n2, nyq);
}

template <int TM, bool kPad>
cudaError_t launch(const float* x, const float* s, const float* HT,
                   const float* PhiT, const __nv_bfloat16* W3, const float* Tc,
                   const float* Ts, const float* PQT, float* re, float* im,
                   int frames, int n1, int n1p, int n2, int d, size_t smem,
                   cudaStream_t stream) {
  const auto kernel = chain_regs_kernel<TM, kPad>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<frames, kThreads, smem, stream>>>(x, s, HT, PhiT, W3, Tc, Ts, PQT,
                                             re, im, n1, n1p, n2, d);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  Every pointer is device memory holding
// contiguous float32: x (frames, n1, n2), s (frames, d, n1), the tables as
// chain_common.cuh lays them out, and W3: the step-1 table's three bf16
// parts, (3, 2 n1p, K16) with K16 = n1p rounded up to a multiple of 16,
// cos rows at 0 and sin rows at n1p, zero-padded.  re / im (frames,
// n1 n2 / 2): the packed one-sided spectrum in natural order, X[N/2].re in
// im[:, 0].  n2 is even.
extern "C" int sdsp_chain_regs_f32(const float* x, const float* s,
                                   const float* HT, const float* PhiT,
                                   const void* W3, const float* Tc,
                                   const float* Ts, const float* PQT, float* re,
                                   float* im, int frames, int n1, int n2, int d,
                                   int device, void* stream) {
  if (n2 < 2 || n2 > kN2 || n2 % 2 || n1 < 1 || n1 > 128 || d < 1 ||
      frames < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const int n1p = (n1 + 7) & ~7;
  const size_t smem = sizeof(float) * smem_floats(n1p, d, kLdy);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* w3 = static_cast<const __nv_bfloat16*>(W3);
  const bool pad = n1p != n1 || n2 != kN2;
#define SDSP_RUN(TM)                                                          \
  (pad ? launch<TM, true>(x, s, HT, PhiT, w3, Tc, Ts, PQT, re, im, frames, n1, \
                          n1p, n2, d, smem, st)                                \
       : launch<TM, false>(x, s, HT, PhiT, w3, Tc, Ts, PQT, re, im, frames,    \
                           n1, n1p, n2, d, smem, st))
  if (n1p % 32 == 0) {
    err = SDSP_RUN(4);
  } else if (n1p % 16 == 0) {
    err = SDSP_RUN(2);
  } else {
    err = SDSP_RUN(1);
  }
#undef SDSP_RUN
  return static_cast<int>(err);
}
