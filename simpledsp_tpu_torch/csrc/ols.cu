// Overlap-save convolution kernel for Hopper (sm_90a): per pair of frames,
// FFT -> product with the tap spectrum -> inverse FFT -> the non-aliased
// samples, without writing a spectrum to device memory.
//
// Replaces the TPU kernel simpledsp_tpu/kernels/ols.py:_make_ols_kernel,
// reached through conv_ols_frames / convolve_ols_fused from the public
// convolve / fftconvolve / oaconvolve / correlate for long real signals.
//
// The TPU kernel runs the four-step FFT as dense DFT matmuls because it has
// a matrix unit: 14 N (n1 + n2) flops a frame, about 9.2 MFLOP at N = 4096.
// Here the transforms run on the FFT core (fft_core.cuh), the frames FFT
// kernel's radix-16 register passes: three passes and two exchanges through
// shared memory at N = 4096, about 5 N log2 N flops a transform.
//
// Two real frames a, b ride in one complex transform, z = a + i b.  The tap
// spectrum H (of real taps, with the 1/N of the inverse folded in) is
// Hermitian, so IFFT(FFT(z) H) = (a (*) h) + i (b (*) h) with both circular
// convolutions real: the real part is frame a's output, the imaginary part
// frame b's.  The inverse runs as conj(FFT(conj(Y))), so one forward FFT
// serves both directions.  The forward transform's last pass and the
// inverse's first run as one (pass_turn): each thread's last butterfly of
// the forward transform holds the inputs of its first butterfly of the
// inverse, taken through conj(Z H) in registers (TapTurn; the inverse runs
// the plan reversed, so that its first radix is the forward's last), and
// the inverse transform's last pass stores the samples straight to device
// memory (SkipSplitStore): Re to frame a, -Im to frame b, the first `skip`
// of each dropped.  Per pair of frames: one load, two N-point complex FFTs
// with one exchange through shared memory fewer than two apart (where the
// forward transform's last radix is not 16; at 16 the turn's registers
// spill, and its last pass writes conj(Z H) through its destination
// functor, TapProduct), one store of 2 (N - skip) samples.  Between passes
// the buffer holds interleaved complex values (Interleaved: one 8-byte
// access a value, a cheap swizzle) where the frames kernel keeps two
// planes.
//
// Frames are read where they lie, by cp.async: frame f of row r starts at
// sample f * frame_stride - offset of that row, and samples outside
// [0, valid) read as zeros.  So the signal path passes the unpadded signal
// (frame_stride = hop, offset = the zero history, valid = its length) and
// the frames path a strided frames tensor (offset 0), and no framed copy is
// ever made.  Where the signal, its row stride, frame stride and offset
// allow (every default split: hop and the history are multiples of 128),
// the copies are 16 bytes (four samples, zero-filled past `valid`), else
// 4.  They land in two planes, frame a's and frame b's; the first pass
// reads them so (a warp on 32 consecutive values) and writes the
// interleaved buffer in their place.
//
// A block holds 4096 values: one pair of frames at N >= 4096, else 4096 / N
// pairs stacked (64 at N = 64), so that every thread holds one radix-16
// butterfly, as in the frames FFT kernel (fft.cu).
//
// What bounds it: by its bytes (32 KB read and 29 KB written a pair at
// N = 4096, about 8 flops a byte against the card's 20) it would be
// bound by device memory; on the H100 it is not: its loads alone take a
// sixth of its time (tools/ols_variants.py, a build cut after them), and
// the passes execute about 20 instructions a value each (the radix-16 DFT,
// the twiddles, the exchange through shared memory), two transforms a pair.
// So the design cuts instructions and latency: the interleaved buffer (one
// access and three integer operations a value, against two and six for
// the core's two swizzled planes), the turn (one exchange and its barriers
// fewer), the tap product and the store inside passes, and 64 registers a
// thread, four 256-thread blocks (32 warps) an SM to hide the exchanges'
// latency (at 128 registers, two blocks, it ran slower at N = 4096 and
// 8192: PERF.md).  Twiddles, small-DFT constants and the tap
// spectrum are float32 tables built in float64 on the host (kernels/fft.py,
// kernels/ols.py) and read through the read-only cache; no fast-math
// intrinsic is used.  N = 8192 and 16384 need 64 and 128 KB of shared
// memory, above the 48 KB default, hence the opt-in.

#include <stdint.h>

#include "fft_core.cuh"

namespace {

using namespace sdsp_fft;

constexpr int kEPT = 16;                   // values a thread holds a pass
constexpr int kBlockElems = 4096;          // values a block holds at N < 4096
constexpr int kMinN = 64;
constexpr int kMaxFrames = 2 * kBlockElems / kMinN;   // frames a block

struct Source {
  const float* x;
  long long row_stride;   // elements between rows
  long long frame_stride; // elements between consecutive frames of a row
  long long offset;       // frame 0 of a row starts at sample -offset
  long long valid;        // samples [0, valid) of a row exist; others are 0
  int nf;                 // frames per row
  int total;              // frames in all rows
};

// The core's buffer between passes as interleaved complex values, one
// 8-byte access a value: value p at float2 index p ^ ((p >> 4) & 15), a
// permutation within each row of 16 values (128 bytes).  A half-warp's
// accesses (one phase of 8-byte accesses) then fall in distinct banks for
// every power-of-two pass: 16 consecutive values (the reads, and the writes
// of a pass of stride ns >= 16) lie in one row, and the first pass's writes
// r j + m (16 consecutive j, one m) in 16 rows whose XORs differ.
struct Interleaved {
  __device__ __forceinline__ float2 operator()(int p) const {
    return reinterpret_cast<const float2*>(dyn_smem())[p ^ ((p >> 4) & 15)];
  }
  __device__ __forceinline__ void put(int p, float2 v) const {
    reinterpret_cast<float2*>(dyn_smem())[p ^ ((p >> 4) & 15)] = v;
  }
};

// Bin p of the block's forward transforms times the tap spectrum (1/N
// folded in), conjugated: the inverse transform that follows is
// conj(FFT(conj(Z H))).  Applied in registers between the forward
// transform's last pass and the inverse's first (pass_turn).
struct TapTurn {
  const float2* __restrict__ H;
  int mask;                // N - 1
  __device__ __forceinline__ float2 operator()(int p, float2 v) const {
    const float2 h = __ldg(H + (p & mask));
    return make_float2(v.x * h.x - v.y * h.y, -(v.x * h.y + v.y * h.x));
  }
};

// The same product as the last pass's destination, into the buffer (where
// the forward transform's last radix is 16: there pass_turn's registers
// spill and it ran slower on the H100, tools/ols_variants.py).
struct TapProduct {
  Interleaved s;
  TapTurn tap;
  __device__ __forceinline__ void put(int p, float2 v) const {
    s.put(p, tap(p, v));
  }
};

// Sample p of the block's inverse transforms (pair p / N, sample t =
// p mod N), stored to device memory: Re to frame a of the pair, -Im to
// frame b, both at t - skip of their output rows of hop = N - skip; the
// first skip samples are aliased and dropped.  A last pair without frame b
// (an odd frame count) writes a only.
struct SkipSplitStore {
  float* out;              // the output row of the block's first frame
  int lg;                  // log2 N
  int mask;                // N - 1
  int skip;
  int hop;
  int frames;              // frames of the block
  __device__ __forceinline__ void put(int p, float2 v) const {
    const int t = p & mask;
    if (t < skip) return;
    const int fa = 2 * (p >> lg);
    float* o = out + static_cast<long long>(fa) * hop + (t - skip);
    o[0] = v.x;
    if (fa + 1 < frames) o[hop] = -v.y;
  }
};

// Asynchronous copy into shared memory of `bytes` (0 .. cp) bytes from src,
// the rest of the cp bytes zero-filled; src must be a valid address also
// when bytes is 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

// Pairs [pair0, pair0 + P) of the flattened frames (pair i: frames 2 i and
// 2 i + 1), P = ppb but the last block's rest.  The planes of the core's
// buffer hold z = a + i b of each pair, pair q's sample t at q N + t.
template <int kNT, bool kTurn>
__global__ void __launch_bounds__(kNT, 1024 / kNT)
ols_frames_kernel(Source src, Plan plan, const float2* __restrict__ tab,
                  Plan iplan, const float2* __restrict__ itab,
                  const float2* __restrict__ H, float* __restrict__ out,
                  int ppb, int lg, int skip, int wide) {
  __shared__ long long row_at[kMaxFrames];   // the frame's row, as an offset
  __shared__ long long start[kMaxFrames];    // its sample 0 in the row
  const int n = plan.n;
  const int tid = threadIdx.x;
  const long long pair0 = static_cast<long long>(blockIdx.x) * ppb;
  const long long g0 = 2 * pair0;            // the block's first frame
  const int np = static_cast<int>(
      min(static_cast<long long>(ppb), (src.total + 1) / 2 - pair0));
  const int frames = static_cast<int>(
      min(static_cast<long long>(2 * np), src.total - g0));
  for (int i = tid; i < 2 * np; i += kNT) {
    if (i < frames) {
      const long long g = g0 + i;
      const long long row = g / src.nf;
      row_at[i] = row * src.row_stride;
      start[i] = (g - row * src.nf) * src.frame_stride - src.offset;
    } else {                                 // no frame b: all zeros
      row_at[i] = 0;
      start[i] = src.valid;
    }
  }
  __syncthreads();

  const int total = np * n;
  const int im = ppb * n;
  float* const smem = dyn_smem();
  if (wide) {
    for (int c = tid; c < total / 4; c += kNT) {
      const int e = 4 * c;
      const int q = e >> lg, t = e & (n - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long pos = start[2 * q + h] + t;
        const long long left = src.valid - pos;
        const int bytes = pos < 0 ? 0 : left >= 4 ? 16
                                  : left > 0 ? 4 * static_cast<int>(left) : 0;
        cp_async16(smem + h * im + e,
                   bytes ? src.x + row_at[2 * q + h] + pos : src.x, bytes);
      }
    }
  } else {
    for (int e = tid; e < total; e += kNT) {
      const int q = e >> lg, t = e & (n - 1);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long pos = start[2 * q + h] + t;
        const bool ok = pos >= 0 && pos < src.valid;
        cp_async4(smem + h * im + e,
                  ok ? src.x + row_at[2 * q + h] + pos : src.x, ok ? 4 : 0);
      }
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // The forward transform's first pass reads the planes the copies filled
  // and writes the interleaved buffer over them (a pass reads all its
  // values before it writes); its last pass turns into the inverse's first
  // through the tap product (at radix 16 it writes the product, and the
  // inverse's first pass reads it); the inverse runs the reversed plan
  // (iplan), its last pass storing the samples.
  const Interleaved s{};
  const TapTurn tap{H, n - 1};
  const int last = plan.npass - 1;     // n >= 64: at least two passes
  run_pass<kEPT>(s, Planes<0>{0, im}, s, tab, plan, 0, total);
  for (int p = 1; p < last; ++p) run_pass<kEPT>(s, s, s, tab, plan, p, total);
  if constexpr (kTurn) {
    run_turn<kEPT>(s, tap, tab, plan, last, total);
  } else {
    run_pass<kEPT>(s, s, TapProduct{s, tap}, tab, plan, last, total);
    run_pass<kEPT>(s, s, s, itab, iplan, 0, total);
  }
  for (int p = 1; p < last; ++p) run_pass<kEPT>(s, s, s, itab, iplan, p, total);
  run_pass<kEPT>(s, s,
                 SkipSplitStore{out + g0 * (n - skip), lg, n - 1, skip,
                                n - skip, frames},
                 itab, iplan, last, total);
}

template <int kNT, bool kTurn>
cudaError_t launch(const Source& src, const Plan& plan, const float2* tab,
                   const Plan& iplan, const float2* itab, const float2* H,
                   float* out, int ppb, int lg, int skip, int wide,
                   int blocks, int smem, cudaStream_t stream) {
  const auto kernel = ols_frames_kernel<kNT, kTurn>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, kNT, smem, stream>>>(src, plan, tab, iplan, itab, H, out,
                                        ppb, lg, skip, wide);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  x holds `rows` rows of float32 samples,
// row r at x + r row_stride; frame f of a row covers samples
// [f frame_stride - offset, + n), those outside [0, valid) reading as zero.
// radices[0..npass) and tab are the FFT core's plan and table for n points
// (fft_core.cuh make_plan; kernels/fft.py _plan, _kernel_table_f64), itab
// the table of the reversed plan (the inverse transform's); H is the
// (n, 2) float32 (re, im) n-point spectrum of the taps divided by n.  out
// is (rows nf, n - skip) float32, frames in row-major order.  n must be a
// power of two, 2^6 to 2^14.
extern "C" int sdsp_ols_frames_f32(const float* x, long long row_stride,
                                   long long frame_stride, long long offset,
                                   long long valid, int rows, int nf,
                                   const int* radices, int npass,
                                   const float* tab, const float* itab,
                                   const float* H, float* out, int n,
                                   int skip, int device, void* stream) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  int reversed[kMaxPasses];
  for (int p = 0; p < npass && p < kMaxPasses; ++p) {
    reversed[p] = radices[npass - 1 - p];
  }
  Plan plan, iplan;
  if ((1 << lg) != n || n < kMinN || n > kMaxN || skip < 0 || skip >= n ||
      rows < 0 || nf < 0 || !make_plan(n, radices, npass, &plan) ||
      !make_plan(n, reversed, npass, &iplan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(rows) * nf;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if (total > 0x7ffffffeLL) return static_cast<int>(cudaErrorInvalidValue);
  const int ppb = n >= kBlockElems ? 1 : kBlockElems / n;
  const int threads = ppb * n / kEPT;
  const int smem = 2 * ppb * n * static_cast<int>(sizeof(float));
  const long long pairs = (total + 1) / 2;
  const int blocks = static_cast<int>((pairs + ppb - 1) / ppb);
  const Source src{x, row_stride, frame_stride, offset, valid, nf,
                   static_cast<int>(total)};
  const int wide = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   row_stride % 4 == 0 && frame_stride % 4 == 0 &&
                   offset % 4 == 0;
  const auto* t2 = reinterpret_cast<const float2*>(tab);
  const auto* i2 = reinterpret_cast<const float2*>(itab);
  const auto* h2 = reinterpret_cast<const float2*>(H);
  const auto st = static_cast<cudaStream_t>(stream);
  // The turn where the forward transform's last radix is not 16 (every n
  // but 256 and 4096).
  const bool turn = plan.radix[npass - 1] != 16;
#define SDSP_RUN(NT)                                                         \
  (turn ? launch<NT, true>(src, plan, t2, iplan, i2, h2, out, ppb, lg, skip, \
                           wide, blocks, smem, st)                           \
        : launch<NT, false>(src, plan, t2, iplan, i2, h2, out, ppb, lg,      \
                            skip, wide, blocks, smem, st))
  if (threads <= 256) {
    err = SDSP_RUN(256);
  } else if (threads <= 512) {
    err = SDSP_RUN(512);
  } else {
    err = SDSP_RUN(1024);
  }
#undef SDSP_RUN
  return static_cast<int>(err);
}
