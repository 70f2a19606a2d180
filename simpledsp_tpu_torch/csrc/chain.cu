// Fused north-star chain kernel for Hopper (sm_90a): block IIR + FFT of
// each frame, the filtered signal never written to device memory.
//
// Replaces the TPU kernels reached through simpledsp_tpu/kernels/chain.py
// fused_chain_frames, all as forms of one kernel, chain_natural_kernel:
//   form kHalf, the packed half spectrum in natural bin order:
//     _make_packed_reg_kernel (:362) and _make_packed_kernel (:283),
//     layouts "reg" and "k1" (the TPU's two output layouts have no
//     counterpart here), g frames a block as the kernel picks them;
//     chain_variants.py _make_packed_regg_kernel (:227, reg2/reg4),
//     _make_packed_regp_kernel (:298) and _make_packed_pair_kernel (:435),
//     the same with the layout's g frames a block (the caller's g);
//     chain_variants.py _make_packed_regw_kernel (:144) and
//     _make_packed_fmajor_kernel (:374), the same with another store
//     (kWide: 16-byte stores of the natural-order planes; kFmajor: each
//     frame's (n1, n2/2) rows k1-major), staged in shared memory;
//   forms kFull / kPairs / kOdd: _make_fused_kernel (:425),
//     half_spectrum=False (the JAX default), the full complex spectrum in
//     natural bin order, any n1, n2 <= 128 (odd too: odd N up to 127 x 127).
// chain_tc.cu holds the "regs" form, the same kernel with its IIR block as
// split-bf16 products on the tensor cores; the kernel's template is in
// chain_natural.cuh, which both sources include.
//
// Per frame: the IIR block, then, for an even N, the real FFT of y as the
// N/2-point complex FFT of z[t] = y[2t] + i y[2t+1] on the FFT core
// (fft_core.cuh) and the split into the one-sided spectrum (see the
// kernel); the half spectrum stores bins 0 .. N/2 - 1, the full one all N
// bins, the upper half by the mirror X[N - k] = conj X[k] (a store twice as
// wide, the same FFT).  n2 odd with N even reads each sample of a pair at
// its own row (kPairs).  An odd N has no split: the N-point complex FFT of
// (y, 0) runs on the core, its last pass storing the bins.
//
// What bounds it: at N = 4096 the IIR block is about 0.34 M FMAs a frame
// (0.30 M in the chunks of H^T it keeps, 0.04 M for the starts) and the FFT
// about 0.12 MFLOP, against 32 KB of input and output (48 KB for the full
// spectrum), about 24 flops a byte (16 for the full), near the card's 20
// (67 TFLOP/s over 3.35 TB/s): FMA issue and device memory both.  The design
// removes work: the FFT replaces the dense four-step DFT products (1.3 M
// FMAs a frame for the half spectrum, 3.7 M for the full one), and the IIR
// block skips the all-zero chunks of the triangular H^T (about half its
// FMAs).  A block takes g frames (by default two at N = 4096, four at 2048,
// eight at 1024, 32 at 200: rows stacked unpadded), so that the FFT's passes
// give every thread a butterfly and the IIR block's bands balance; shared
// memory holds their x, y and starts (71 KB at N = 4096, two blocks an SM
// at 128 registers), one block's loads overlapping the other's work.  A
// caller's g may give up to 8192 FFT values a block (32 a thread: four
// frames at N = 4096, one block an SM).  An odd N stacks frames the same
// way (eight at 375); above 4096 values, one frame a block, it runs 512
// threads with 16 or 32 values each (to 127 x 127 = 16129, whose planes,
// 126 KB, fit in x's and y's space).  Its large odd-radix passes (101 at
// 8181, 127 at 16129) are latency-bound: the largest N runs slower than the
// four-step form it replaced (PERF.md).  Every form keeps IEEE fp32 on the
// CUDA cores (no tensor cores, no TF32), which holds the chain's 130 dB
// bar.  The store forms change no arithmetic: their planes are the bits of
// the direct store at the same g.

#include "chain_natural.cuh"

namespace {

using namespace sdsp_chain;

template <int TM, int kEPT, int kForm, int kNT, int kStore>
cudaError_t launch_natural(const float* x, const float* s, const float* HT,
                           const float* PhiT, const sdsp_fft::Plan& plan,
                           const float2* tab, const float2* split, float* re,
                           float* im, int frames, int g, int n1, int rows,
                           int n2, int d, int lpad, size_t smem,
                           cudaStream_t stream) {
  const auto kernel =
      chain_natural_kernel<kBands, TM, kEPT, kForm, kNT, kStore>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(frames + g - 1) / g, kNT, smem, stream>>>(
      x, s, HT, PhiT, nullptr, plan, tab, split, re, im, frames, g, n1, rows,
      n2, d, 1.0f / static_cast<float>(n2), lpad);
  return cudaGetLastError();
}

// The instance of the form for the block's rows (an even number of row
// groups of 8 TM rows balances the bands) and values (kEPT 32 above 16 a
// thread).  An odd N above 16 values a thread (one frame a block) runs 512
// threads, TM 1: 16 or 32 values a thread, twice the warps to hide the
// odd-radix passes' latency.
template <int kForm, int kStore>
cudaError_t dispatch_natural(const float* x, const float* s, const float* HT,
                             const float* PhiT, const sdsp_fft::Plan& plan,
                             const float2* tab, const float2* split, float* re,
                             float* im, int frames, int g, int n1, int rows,
                             int n2, int d, int lpad, int values, size_t smem,
                             cudaStream_t st) {
#define SDSP_RUN(TM, EPT, NT)                                                 \
  launch_natural<TM, EPT, kForm, NT, kStore>(x, s, HT, PhiT, plan, tab, split, \
                                             re, im, frames, g, n1, rows, n2,  \
                                             d, lpad, smem, st)
  if constexpr (kForm == kOdd) {
    if (values > 16 * 512) return SDSP_RUN(1, 32, 512);
    if (values > 16 * kThreads) return SDSP_RUN(1, 16, 512);
  } else {
    if (values > 16 * kThreads) {
      if (rows % 64 == 0) return SDSP_RUN(4, 32, kThreads);
      if (rows % 32 == 0) return SDSP_RUN(2, 32, kThreads);
      return SDSP_RUN(1, 32, kThreads);
    }
  }
  if (rows % 64 == 0) return SDSP_RUN(4, 16, kThreads);
  if (rows % 32 == 0) return SDSP_RUN(2, 16, kThreads);
  return SDSP_RUN(1, 16, kThreads);
#undef SDSP_RUN
}

}  // namespace

// The half spectrum (full = 0) or the full spectrum (full = 1) in natural
// order, on the FFT core.  Launch on `stream` of `device`; returns
// cudaGetLastError() after the launch (0 when the launch was accepted).
// Every pointer is device memory holding contiguous float32: x (frames,
// n1, n2), s (frames, d, n1) the sub-block starts (D-major), HT (n2, 128)
// H^T and PhiT (d, 128) Phi^T, rows 128 wide (zero-padded for n2 < 128);
// HT must be upper-triangular (H lower-triangular), as the IIR block's
// H^T is.  radices[0..npass) and tab are the core's plan and table
// (fft_core.cuh make_plan) for M = n1 n2 / 2 points where N = n1 n2 is
// even, for N points where it is odd (full spectrum only); split holds the
// M / 2 + 1 twiddles exp(-2 pi i k / (2 M)), (re, im) float32 pairs
// (unread for an odd N).  re / im: the half spectrum as `store` (enum
// Store) lays it out, X[N/2].re in the imaginary plane's bin 0; or with
// full, (frames, N), the spectrum in natural order.  n2 is even for the
// half spectrum.  g: frames a block, or 0 for the kernel's own choice.  A
// block that needs more shared memory than kMaxSmem (a large d or g), more
// than 32 FFT values a thread, or a staged plane larger than half of y's
// space, is refused.
extern "C" int sdsp_chain_natural_f32(const float* x, const float* s,
                                      const float* HT, const float* PhiT,
                                      const int* radices, int npass,
                                      const float* tab, const float* split,
                                      float* re, float* im, int frames, int n1,
                                      int n2, int d, int full, int g,
                                      int store, int device, void* stream) {
  const int nn = n1 * n2;
  const bool odd = nn % 2 != 0;
  sdsp_fft::Plan plan;
  if (n2 < 1 || n2 > kN2 || (!full && n2 % 2) || n1 < 1 || n1 > 128 ||
      d < 1 || frames < 0 || g < 0 || g > 128 || store < kDirect ||
      store > kFmajor || (full && store != kDirect) ||
      !sdsp_fft::make_plan(odd ? nn : nn / 2, radices, npass, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // Frames a block: the caller's, or the kernel's own (natural_frames).
  const int per = odd ? nn : nn / 2;   // FFT values a frame
  if (g == 0) g = natural_frames(n1, per);
  const int rows = (g * n1 + 7) & ~7;
  const int values = g * per;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(rows) * kLdx +
                                       static_cast<size_t>(starts_stride(d)) * rows);
  int lpad = 32;                       // lcm(n1, 32)
  while (lpad % n1) lpad += 32;
  if (smem > kMaxSmem || values > 32 * (odd ? 512 : kThreads) ||
      (store != kDirect &&
       values + (values - 1) / lpad + 1 > rows * (kLdx / 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* t2 = reinterpret_cast<const float2*>(tab);
  const auto* sp = reinterpret_cast<const float2*>(split);
#define SDSP_FORM(F, S)                                                       \
  dispatch_natural<F, S>(x, s, HT, PhiT, plan, t2, sp, re, im, frames, g, n1,  \
                         rows, n2, d, lpad, values, smem, st)
  if (full) {
    err = odd ? SDSP_FORM(kOdd, kDirect)
              : n2 % 2 ? SDSP_FORM(kPairs, kDirect) : SDSP_FORM(kFull, kDirect);
  } else if (store == kWide) {
    err = SDSP_FORM(kHalf, kWide);
  } else if (store == kFmajor) {
    err = SDSP_FORM(kHalf, kFmajor);
  } else {
    err = SDSP_FORM(kHalf, kDirect);
  }
#undef SDSP_FORM
  return static_cast<int>(err);
}
