// Fused north-star chain kernel for Hopper (sm_90a): block IIR + packed
// half-spectrum four-step FFT, one frame per thread block.
//
// Replaces the TPU kernel simpledsp_tpu/kernels/chain.py:
// _make_packed_reg_kernel / _make_packed_kernel, reached through
// fused_chain_frames(half_spectrum=True).  One kernel serves every frame
// size N = n1 * n2 that the JAX package's fused path takes (n1 <= 128,
// n2 <= 128 even: N = 200, 256, ..., 16384) and writes the bins in natural
// order, so the TPU's two output layouts ("reg", "k1") have no counterpart
// here.
//
// Per frame, with x viewed as (n1, n2) and the sub-block starts s as
// (D, n1), D = 2(M+1):
//
//   1. IIR block     y[p, i]  = sum_j x[p, j] H[i, j] + sum_e s[e, p] Phi[i, e]
//   2. step 1        [c; s][k1, t] = sum_p W1cs[k1, p] y[p, t]
//   3. twiddle       tr = c Tc - s Ts,  ti = s Tc + c Ts
//   4. step 3        out[k1, l] = sum_t tr[k1, t] P[l, t] + ti[k1, t] Q[l, t]
//                    (lanes l < 64: Re X, l >= 64: Im X, bin k1 + n1 (l % 64))
//   5. Nyquist       X[N/2] = sum_t tr[0, t] (-1)^t  into the Im slot of bin 0
//
// The tables arrive transposed where that makes each product's right-hand
// operand row-major over the output columns: HT = H^T (n2, 128),
// PhiT = Phi^T (D, 128), PQT = [P^T; Q^T] (2 n2, 128), W1cs (2 n1p, n1p),
// Tc/Ts (n1p, 128).  Every row is 128 wide and the frame has n1p rows, n1
// rounded up to a multiple of 8: for a smaller frame (n2 < 128 or n1 % 8)
// the wrapper zero-pads the tables to that shape, the kernel zero-fills the
// frame's extra rows and columns, and the zeros flow through every product
// into output lanes and rows that are never stored.  The depth of the IIR
// and step-3 products is n2 at run time, so a padded column costs no FMA
// there; at n2 = 128 and n1 % 8 == 0 nothing is padded.
//
// What bounds it: at N = 4096 a frame is about 3.7 MFLOP of fp32 FMAs against
// 32 KB of input and output, about 115 FLOP per byte, so the kernel is bound
// by FMA issue on the CUDA cores, not by device memory.  This first version
// keeps IEEE fp32 on the CUDA cores (no tensor cores, no TF32), which holds
// the chain's 130 dB bar.  The frame and every intermediate stay in shared
// memory (three frame-sized buffers, reused: 197 KB at n1 = 128, above the
// 48 KB default, hence the opt-in); the constant tables (about 200 KB at
// N = 4096) are read from global memory, where all blocks share them in L2.
// Each thread holds a TM-row by 4-column tile of every product in registers
// and reads its left operand four k at a time.

#include <cuda_runtime.h>

namespace {

constexpr int kN2 = 128;              // lanes of a frame row in shared memory
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// Sums over k run in chunks of kChunk terms, each chunk into a fresh partial
// that is then added to the total.  One running sum over all 256 terms of
// step 3 loses about 6 dB against the chunked sum (emulated in float64 on
// random frames at N = 4096: 129.6 dB against 136.4 dB), which would leave
// no margin under the chain's 130 dB bar.
constexpr int kChunk = 16;

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

// acc[r][:] += sum_{k < K} A[row_r, k] B[k, col0 : col0 + 4] for the rows
// row_r = m0 + warp + 8 r of A (row stride lda, a multiple of 4) and the
// four columns col0 = 4 lane of B (row stride 128).  A full chunk is
// unrolled; the chunk loop is not (see the kernel's n2 argument).
template <int TM>
__device__ __forceinline__ void mac(float (&acc)[TM][4], int m0,
                                    const float* a, int lda, const float* b,
                                    int K) {
  const float* arow[TM];
#pragma unroll
  for (int r = 0; r < TM; ++r) {
    arow[r] = a + (m0 + (threadIdx.x >> 5) + kWarps * r) * lda;
  }
  const float* bp = b + 4 * (threadIdx.x & 31);
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    float part[TM][4] = {};
    if (k0 + kChunk <= K) {
#pragma unroll
      for (int k = k0; k < k0 + kChunk; k += 4) mac4<TM>(part, arow, bp, k);
    } else {
      int k = k0;
      for (; k + 4 <= K; k += 4) mac4<TM>(part, arow, bp, k);
      for (; k < K; ++k) {  // K % 4 tail: the D state columns
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

// TM rows per warp in the n1p-row products; step 1 has 2 n1p rows.  The
// host picks TM so that 8 TM divides n1p: every row chunk is full.  kPad
// selects the padded frame (n2 < 128 or n1 % 8); without it n1p == n1 and
// n2 == 128 are known, and the kernel is the unpadded one instruction for
// instruction (a single instance with run-time padding was measured 24%
// slower at N = 16384).
template <int TM, bool kPad>
__global__ void __launch_bounds__(kThreads)
chain_frames_kernel(const float* __restrict__ x, const float* __restrict__ s,
                    const float* __restrict__ HT, const float* __restrict__ PhiT,
                    const float* __restrict__ W1cs, const float* __restrict__ Tc,
                    const float* __restrict__ Ts, const float* __restrict__ PQT,
                    float* __restrict__ re, float* __restrict__ im, int n1,
                    int n1p_arg, int n2_arg, int d) {
  const int n1p = kPad ? n1p_arg : n1;
  const int n2 = kPad ? n2_arg : kN2;
  // n2_arg is the depth of the IIR and step-3 products.  It stays a run-time
  // value on purpose, also where it is 128: with a compile-time depth the
  // compiler unrolls the whole sum, hoists all 128 rows of H^T into
  // registers ahead of the row loop and spills them (seen at TM = 1: a
  // 3.8 KB stack frame and a 20x slower kernel at N = 1024).
  constexpr int TM1 = TM == 4 ? 4 : 2 * TM;
  extern __shared__ float4 smem4[];
  __shared__ float nyq;
  const int n = n1p * kN2;       // floats of one padded frame buffer
  const int ldo = n1p + 1;       // row stride of the transposed output stage
  const int dp = (d + 3) & ~3;   // row stride of the transposed starts
  float* buf_a = reinterpret_cast<float*>(smem4);  // x, then c -> tr
  float* buf_b = buf_a + n;                        // y, then out^T (128 x ldo)
  float* buf_c = buf_b + kN2 * ldo;                // s -> ti
  float* st = buf_c + n;                           // starts^T (n1p, dp)
  const size_t f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int col0 = 4 * (tid & 31);

  if (!kPad) {
    const float4* xf = reinterpret_cast<const float4*>(x + f * n);
    for (int i = tid; i < n / 4; i += kThreads) {
      reinterpret_cast<float4*>(buf_a)[i] = xf[i];
    }
  } else {  // a padded frame: row p, column j of x, zero outside (n1, n2)
    const float* xf = x + f * n1 * n2;
    for (int i = tid; i < n; i += kThreads) {
      const int p = i / kN2, j = i % kN2;
      buf_a[i] = (p < n1 && j < n2) ? xf[p * n2 + j] : 0.f;
    }
    for (int i = tid; i < (n1p - n1) * dp; i += kThreads) st[n1 * dp + i] = 0.f;
  }
  const float* sf = s + f * d * n1;
  for (int i = tid; i < d * n1; i += kThreads) {
    st[(i % n1) * dp + i / n1] = sf[i];
  }
  __syncthreads();

  // 1. IIR block: x (n1p, 128) H^T + starts^T (n1p, D) Phi^T -> y in buf_b.
  for (int m0 = 0; m0 < n1p; m0 += kWarps * TM) {
    float acc[TM][4] = {};
    mac<TM>(acc, m0, buf_a, kN2, HT, n2_arg);
    mac<TM>(acc, m0, st, dp, PhiT, d);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      store4(buf_b + (m0 + warp + kWarps * r) * kN2 + col0, acc[r]);
    }
  }
  __syncthreads();

  // 2. Step 1: [W1c; W1s] (2 n1p, n1p) y -> c in buf_a, s in buf_c.
  for (int m0 = 0; m0 < 2 * n1p; m0 += kWarps * TM1) {
    float acc[TM1][4] = {};
    mac<TM1>(acc, m0, W1cs, n1p, buf_b, n1p);
#pragma unroll
    for (int r = 0; r < TM1; ++r) {
      const int m = m0 + warp + kWarps * r;
      store4((m < n1p ? buf_a + m * kN2 : buf_c + (m - n1p) * kN2) + col0,
             acc[r]);
    }
  }
  __syncthreads();

  // 3. Twiddle, in place.
  for (int i = tid; i < n; i += kThreads) {
    const float c = buf_a[i], sn = buf_c[i], tc = Tc[i], ts = Ts[i];
    buf_a[i] = c * tc - sn * ts;
    buf_c[i] = sn * tc + c * ts;
  }
  __syncthreads();

  // 4. Step 3: tr P^T + ti Q^T, staged transposed (out^T[l, k1]) in buf_b so
  // that the store below reads consecutive k1 from consecutive addresses.
  for (int m0 = 0; m0 < n1p; m0 += kWarps * TM) {
    float acc[TM][4] = {};
    mac<TM>(acc, m0, buf_a, kN2, PQT, n2_arg);
    mac<TM>(acc, m0, buf_c, kN2, PQT + n2 * kN2, n2_arg);
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      const int m = m0 + warp + kWarps * r;
#pragma unroll
      for (int j = 0; j < 4; ++j) buf_b[(col0 + j) * ldo + m] = acc[r][j];
    }
  }
  // 5. Nyquist bin from tr row 0 (buf_a is not written by step 3).
  if (tid < 32) {
    float acc = 0.f;
    for (int t = tid; t < kN2; t += 32) acc += (t & 1) ? -buf_a[t] : buf_a[t];
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (tid == 0) nyq = acc;
  }
  __syncthreads();

  // Natural bin order k = k1 + n1 k2: consecutive threads write consecutive k.
  const int h = kPad ? n1 * n2 / 2 : n / 2;
  float* ref = re + f * h;
  float* imf = im + f * h;
  for (int k = tid; k < h; k += kThreads) {
    const int k1 = k % n1, k2 = k / n1;
    ref[k] = buf_b[k2 * ldo + k1];
    imf[k] = k == 0 ? nyq : buf_b[(n2 / 2 + k2) * ldo + k1];
  }
}

template <int TM, bool kPad>
cudaError_t launch(const float* x, const float* s, const float* HT,
                   const float* PhiT, const float* W1cs, const float* Tc,
                   const float* Ts, const float* PQT, float* re, float* im,
                   int frames, int n1, int n1p, int n2, int d, size_t smem,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      chain_frames_kernel<TM, kPad>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  chain_frames_kernel<TM, kPad><<<frames, kThreads, smem, stream>>>(
      x, s, HT, PhiT, W1cs, Tc, Ts, PQT, re, im, n1, n1p, n2, d);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block, in bytes: two frame buffers, the padded output
// stage and the transposed starts, for frames of n1p (padded) rows.
extern "C" size_t sdsp_chain_frames_smem_bytes(int n1p, int d) {
  const size_t dp = (d + 3) & ~3;
  return sizeof(float) * (2 * static_cast<size_t>(n1p) * kN2 +
                          static_cast<size_t>(kN2) * (n1p + 1) + dp * n1p);
}

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  Every pointer is device memory holding
// contiguous float32: x (frames, n1, n2), s (frames, d, n1), re/im
// (frames, n1 n2 / 2), tables as described at the top of this file, padded
// to n1p = n1 rounded up to a multiple of 8.
extern "C" int sdsp_chain_frames_f32(const float* x, const float* s,
                                     const float* HT, const float* PhiT,
                                     const float* W1cs, const float* Tc,
                                     const float* Ts, const float* PQT,
                                     float* re, float* im, int frames, int n1,
                                     int n2, int d, int device, void* stream) {
  if (n2 < 2 || n2 > kN2 || n2 % 2 || n1 < 1 || n1 > 128 || d < 1 ||
      frames < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const int n1p = (n1 + 7) & ~7;
  const size_t smem = sdsp_chain_frames_smem_bytes(n1p, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool pad = n1p != n1 || n2 != kN2;
  const auto run = [&](auto kernel_launch) {
    return kernel_launch(x, s, HT, PhiT, W1cs, Tc, Ts, PQT, re, im, frames, n1,
                         n1p, n2, d, smem, st);
  };
  if (n1p % 32 == 0) {
    err = pad ? run(launch<4, true>) : run(launch<4, false>);
  } else if (n1p % 16 == 0) {
    err = pad ? run(launch<2, true>) : run(launch<2, false>);
  } else {
    err = pad ? run(launch<1, true>) : run(launch<1, false>);
  }
  return static_cast<int>(err);
}
