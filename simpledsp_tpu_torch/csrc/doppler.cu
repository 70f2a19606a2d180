// The radar's Doppler stage for Hopper (sm_90a), in one pass: for each
// (beam, range cell) of a (B, P, N) pulse-compressed map, the window across
// the P pulses, the P-point FFT, the power and the roll by P / 2:
//
//   out[b, (k + P/2) mod P, c] = |sum_p w[p] y[b, p, c] e^{-2 pi i k p / P}|^2
//
// Replaces no TPU kernel: the JAX package's models/radar.py range_doppler_map
// runs its Doppler transform as XLA's dense DFT.  Its plain version,
// kernels/doppler.py doppler_power_plain (the route models/radar.py keeps for
// the CPU, float64, a DTensor and P outside the gate), windows both planes,
// transposes them, runs the FFT engine across the pulses (at P <= 128 the
// small-DFT route's fixed-shape products over a padded copy), transposes back,
// squares, adds and rolls: at 64 x 128 x 4096 about 3.7 ms of device time for
// work that needs y read once and the map written once.
//
// What bounds it: bytes.  A cell reads 8 (re, im) and writes 4: 402.7 MB at
// 64 x 128 x 4096, 0.120 ms at 3.35 TB/s; its FFT is 5 P log2 P operations a
// column, 1.17 GFLOP there (0.018 ms).  The design:
// - A block of 256 threads owns one beam and a tile of T = 256 / P2 range
//   cells across all P = P1 P2 pulses.  P2 threads share a column: thread q
//   loads pulses q, q + P2, ... (P1 of them) of its cell straight into
//   registers, a warp on 32 consecutive cells of one pulse (128 bytes of a
//   row, every load coalesced), all of its loads in flight before the first
//   is used.  y is read where it lies, with a beam stride and a pulse stride
//   (the trimmed view of the matched filter's wider rows), never copied.
// - The FFT is the four-step split k = k1 + P1 k2: thread q runs the P1-point
//   DFT of its pulses as an unrolled radix-2 pass in registers, multiplies by
//   e^{-2 pi i q k1 / P}, and writes its P1 values to shared memory; after one
//   barrier it reads back the P2 values of P1 / P2 of the k1 and runs their
//   P2-point DFTs in registers.  P (16-512) picks (P1, P2): 4 x 4, 8 x 4,
//   8 x 8, 16 x 8, 16 x 16, 32 x 16.  In the exchange a warp reads and
//   writes 32 consecutive words, or two half-warps 16 apart (T = 16), which a
//   pad of 16 words a k1 row keeps on disjoint banks.
// - Twiddles come from a float64-built table rounded to float (the wrapper's
//   (2, P) table), staged in shared memory with the window; butterflies on
//   1 and -i are exact moves.  No fast math: IEEE float32 throughout.
// - The power of bin k is written to row (k + P/2) mod P with streaming
//   stores, a warp on 32 consecutive cells of one row.
//
// Bits: a column's operations depend only on P, never on its place in the
// tile, the tile, N or B, so a beam or a range cell has the same bits alone
// as inside a batch (as the FFT engine guarantees for its rows).

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kPad = 16;   // words after each k1 row of the exchange

__host__ __device__ constexpr int ilog2(int n) {
  return n <= 1 ? 0 : 1 + ilog2(n / 2);
}

// The bits of i, low `bits` of them, in reverse order.
__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

template <int P1, int P2>
struct Plan {
  static constexpr int P = P1 * P2;
  static constexpr int T = kThreads / P2;     // range cells a block
  static constexpr int kRow = P2 * T + kPad;  // words a k1 row of the exchange
  static constexpr int kSmemFloats = 2 * P1 * kRow + 3 * P;
};

// f(std::integral_constant<int, i>) for i = 0 .. N - 1, in order (f reads
// i as decltype(i)::value), so that every index into a register array is a
// compile-time constant whatever the unroller decides: a loop it left
// rolled would put the arrays in local memory or behind select chains.
template <int N, int I = 0, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (I < N) {
    f(std::integral_constant<int, I>{});
    static_for<N, I + 1>(f);
  }
}

// In-place R-point DFT of registers given in bit-reversed order, bins out in
// natural order (radix 2, decimation in time); the twiddle e^{-2 pi i t / R}
// is (wr, wi)[t * kStride] of the P-point table (kStride = P / R).
template <int R, int kStride>
__device__ __forceinline__ void dft_regs(float (&xr)[R], float (&xi)[R],
                                         const float* wr, const float* wi) {
  static_for<ilog2(R)>([&](auto stage_c) {
    constexpr int stage = decltype(stage_c)::value;
    constexpr int half = 1 << stage;   // butterflies of span 2 half
    static_for<R / 2>([&](auto f_c) {
      constexpr int f = decltype(f_c)::value;
      constexpr int j = f & (half - 1);
      constexpr int a = ((f >> stage) << (stage + 1)) + j, b = a + half;
      float tr, ti;
      if constexpr (j == 0) {
        tr = xr[b];
        ti = xi[b];
      } else if constexpr (2 * j == half) {  // e^{-i pi / 2} = -i
        tr = xi[b];
        ti = -xr[b];
      } else {
        constexpr int t = j * (R / (2 * half)) * kStride;
        const float c = wr[t], s = wi[t];
        tr = xr[b] * c - xi[b] * s;
        ti = xr[b] * s + xi[b] * c;
      }
      xr[b] = xr[a] - tr;
      xi[b] = xi[a] - ti;
      xr[a] = xr[a] + tr;
      xi[a] = xi[a] + ti;
    });
  });
}

template <int P1, int P2>
__global__ void __launch_bounds__(kThreads, 2)
doppler_power_kernel(const float* __restrict__ yr,
                     const float* __restrict__ yi,
                     const float* __restrict__ window,
                     const float* __restrict__ twiddles,
                     float* __restrict__ out, int n, int tiles,
                     long long beam_stride, long long pulse_stride) {
  using Pl = Plan<P1, P2>;
  constexpr int P = Pl::P, T = Pl::T, kRow = Pl::kRow;
  constexpr int L1 = ilog2(P1), L2 = ilog2(P2);
  extern __shared__ float sm[];
  float* ex_r = sm;                 // exchange: [k1][q][c], kRow words a k1
  float* ex_i = sm + P1 * kRow;
  float* w_r = sm + 2 * P1 * kRow;  // twiddles e^{-2 pi i t / P}
  float* w_i = w_r + P;
  float* win = w_i + P;             // the window

  const long long beam = blockIdx.x / static_cast<unsigned>(tiles);
  const int tile = static_cast<int>(blockIdx.x % static_cast<unsigned>(tiles));
  const int c = threadIdx.x % T;
  const int q = threadIdx.x / T;
  const int col = tile * T + c;
  const bool live = col < n;

  // Pulses q + P2 p1 of the cell, all loads issued before the tables'
  // barrier; slot brev(p1) so that the radix-2 pass ends in natural order.
  float ar[P1], ai[P1];
  const float* src_r = yr + beam * beam_stride + col + q * pulse_stride;
  const float* src_i = yi + beam * beam_stride + col + q * pulse_stride;
  static_for<P1>([&](auto p1_c) {
    constexpr int p1 = decltype(p1_c)::value, slot = brev(p1, L1);
    const long long off = static_cast<long long>(p1 * P2) * pulse_stride;
    ar[slot] = live ? __ldcs(src_r + off) : 0.0f;
    ai[slot] = live ? __ldcs(src_i + off) : 0.0f;
  });
  static_for<(2 * P + kThreads - 1) / kThreads>([&](auto k_c) {
    const int i = decltype(k_c)::value * kThreads + threadIdx.x;
    if (i < 2 * P) w_r[i] = twiddles[i];
    if (i < P) win[i] = window[i];
  });
  __syncthreads();

  static_for<P1>([&](auto p1_c) {
    constexpr int p1 = decltype(p1_c)::value, slot = brev(p1, L1);
    const float w = win[q + P2 * p1];
    ar[slot] *= w;
    ai[slot] *= w;
  });
  dft_regs<P1, P2>(ar, ai, w_r, w_i);
  static_for<P1>([&](auto k1_c) {
    constexpr int k1 = decltype(k1_c)::value;
    float vr = ar[k1], vi = ai[k1];
    if constexpr (k1 != 0) {
      const int t = (q * k1) & (P - 1);
      const float cr = w_r[t], ci = w_i[t];
      const float r = vr * cr - vi * ci;
      vi = vr * ci + vi * cr;
      vr = r;
    }
    ex_r[k1 * kRow + q * T + c] = vr;
    ex_i[k1 * kRow + q * T + c] = vi;
  });
  __syncthreads();

  float* dst = out + beam * P * static_cast<long long>(n) + col;
  static_for<P1 / P2>([&](auto j_c) {
    const int k1 = q + P2 * decltype(j_c)::value;
    float br[P2], bi[P2];
    static_for<P2>([&](auto p2_c) {
      constexpr int p2 = decltype(p2_c)::value, slot = brev(p2, L2);
      br[slot] = ex_r[k1 * kRow + p2 * T + c];
      bi[slot] = ex_i[k1 * kRow + p2 * T + c];
    });
    dft_regs<P2, P1>(br, bi, w_r, w_i);
    if (live) {
      static_for<P2>([&](auto k2_c) {
        constexpr int k2 = decltype(k2_c)::value;
        const int row = (k1 + P1 * k2 + P / 2) & (P - 1);
        __stcs(dst + static_cast<long long>(row) * n,
               br[k2] * br[k2] + bi[k2] * bi[k2]);
      });
    }
  });
}

template <int P1, int P2>
int launch(const float* yr, const float* yi, const float* window,
           const float* twiddles, float* out, long long beams, int n,
           long long beam_stride, long long pulse_stride,
           cudaStream_t stream) {
  using Pl = Plan<P1, P2>;
  const int tiles = (n + Pl::T - 1) / Pl::T;
  if (beams > INT_MAX / tiles) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * Pl::kSmemFloats;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        doppler_power_kernel<P1, P2>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  doppler_power_kernel<P1, P2>
      <<<static_cast<unsigned>(beams * tiles), kThreads, smem, stream>>>(
          yr, yi, window, twiddles, out, n, tiles, beam_stride, pulse_stride);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The Doppler power map of y, (beams, pulses, n) float32 planes yr and yi
// with element stride 1 along n, pulse_stride between pulses and
// beam_stride between beams, into out (beams, pulses, n) contiguous:
// window (pulses) float32, twiddles (2, pulses) float32, the cosines then
// the sines of -2 pi t / pulses.  pulses is a power of two in 16..512.
// Returns a CUDA error code (0 on success).
extern "C" int sdsp_doppler_power_f32(const float* yr, const float* yi,
                                      const float* window,
                                      const float* twiddles, float* out,
                                      long long beams, int pulses, int n,
                                      long long beam_stride,
                                      long long pulse_stride, int device,
                                      void* stream) {
  if (beams < 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (beams == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pulses) {
    case 16:
      return launch<4, 4>(yr, yi, window, twiddles, out, beams, n,
                          beam_stride, pulse_stride, s);
    case 32:
      return launch<8, 4>(yr, yi, window, twiddles, out, beams, n,
                          beam_stride, pulse_stride, s);
    case 64:
      return launch<8, 8>(yr, yi, window, twiddles, out, beams, n,
                          beam_stride, pulse_stride, s);
    case 128:
      return launch<16, 8>(yr, yi, window, twiddles, out, beams, n,
                           beam_stride, pulse_stride, s);
    case 256:
      return launch<16, 16>(yr, yi, window, twiddles, out, beams, n,
                            beam_stride, pulse_stride, s);
    case 512:
      return launch<32, 16>(yr, yi, window, twiddles, out, beams, n,
                            beam_stride, pulse_stride, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
