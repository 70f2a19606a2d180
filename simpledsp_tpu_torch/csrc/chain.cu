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
// chain_tc.cu holds the split-bf16 tensor-core form ("regs"), the one form
// still on the four-step design (chain_common.cuh).
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

#include "chain_common.cuh"
#include "fft_core.cuh"

namespace {

using namespace sdsp_chain;

// -- the half spectrum in natural order on the FFT core ----------------------

constexpr int kLdx = kN2 + 4;   // row stride of x and y in shared memory

// IIR block by column bands: y = x H^T + starts^T Phi^T over n1p rows,
// written at a row stride of kLdx.  A work item is a band of 16 output
// columns and 8 TM rows; lane = 8 cl + rl holds rows m0 + rl + 8 r and
// columns 16 band + 4 cl.  H is lower-triangular, so the band's outputs
// need the k-chunks up to its last column only: the depth stops at
// 16 (band + 1), skipping chunks of H^T that are all zero for the band.
// Chunks and the order within them are mac's, so y is bit for bit the
// y of iir_stage for finite input.  Items alternate the band order by row
// group (band w, then 7 - w), so that with an even number of row groups
// each warp sums 9 chunks a group pair.  Phases of 8 lanes read 8 rows of x
// (at a stride of kLdx words: 8 distinct bank quads) and write 8 rows of y.
template <int TM>
__device__ __forceinline__ void iir_band_stage(float* y, const float* x,
                                               const float* st,
                                               const float* HT,
                                               const float* PhiT, int n1p,
                                               int n2, int d) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cl = lane >> 3, rl = lane & 7;
  const int dp = starts_stride(d);
  const int items = 8 * (n1p / (8 * TM));
  for (int it = warp; it < items; it += blockDim.x >> 5) {
    const int grp = it >> 3, b8 = it & 7;
    const int band = (grp & 1) ? 7 - b8 : b8;
    if (16 * band >= n2) continue;   // no column of the frame
    const int col0 = 16 * band + 4 * cl;
    const int m0 = grp * 8 * TM + rl;
    const float* xrow[TM];
    const float* srow[TM];
#pragma unroll
    for (int r = 0; r < TM; ++r) {
      xrow[r] = x + (m0 + 8 * r) * kLdx;
      srow[r] = st + (m0 + 8 * r) * dp;
    }
    float acc[TM][4] = {};
    mac_rows<TM>(acc, xrow, HT + col0, min(n2, 16 * (band + 1)));
    mac_rows<TM>(acc, srow, PhiT + col0, d);
#pragma unroll
    for (int r = 0; r < TM; ++r) store4(y + (m0 + 8 * r) * kLdx + col0, acc[r]);
  }
}

// The filtered frame y (rows of n2 at a stride of kLdx, at offset y of the
// dynamic shared memory) as the FFT's first pass reads it.  FrameAsComplex:
// z[t] = y[2t] + i y[2t+1] as one float2 (n2 even: a pair never straddles
// rows).  FramePairs: the same z with each sample's own row (n2 odd, N
// even).  FrameReal: (y[t], 0) (N odd).  Frames of a block are stacked, so
// value t of frame q is value q (its count) + t of the block.
struct FrameAsComplex {
  int y;
  int n2;
  float rn2;   // 1 / n2
  __device__ __forceinline__ float2 operator()(int t) const {
    const int e = 2 * t;
    const int row = sdsp_fft::fdiv(e, rn2);
    return *reinterpret_cast<const float2*>(sdsp_fft::dyn_smem() + y +
                                            row * kLdx + e - row * n2);
  }
};

struct FramePairs {
  int y;
  int n2;
  float rn2;
  __device__ __forceinline__ float2 operator()(int t) const {
    const int e = 2 * t;
    const int r0 = sdsp_fft::fdiv(e, rn2), r1 = sdsp_fft::fdiv(e + 1, rn2);
    const float* b = sdsp_fft::dyn_smem() + y;
    return make_float2(b[r0 * kLdx + e - r0 * n2],
                       b[r1 * kLdx + e + 1 - r1 * n2]);
  }
};

struct FrameReal {
  int y;
  int n2;
  float rn2;
  __device__ __forceinline__ float2 operator()(int t) const {
    const int row = sdsp_fft::fdiv(t, rn2);
    return make_float2(sdsp_fft::dyn_smem()[y + row * kLdx + t - row * n2],
                       0.f);
  }
};

// The last pass of an odd N's FFT stores bin p straight to device memory.
struct SpectrumOut {
  float* re;
  float* im;
  __device__ __forceinline__ void put(int p, float2 v) const {
    re[p] = v.x;
    im[p] = v.y;
  }
};

// The output forms of chain_natural_kernel.  kHalf: the packed one-sided
// spectrum (frames, N/2), X[N/2].re in the imaginary plane's bin 0.  The
// full spectrum (frames, N) in natural order: kFull (n2 even) and kPairs
// (n2 odd, N even) through the split and its conjugate mirror
// X[N - k] = conj X[k]; kOdd (N odd) as the N-point complex FFT of (y, 0),
// its last pass storing the bins.
enum Form { kHalf = 0, kFull = 1, kPairs = 2, kOdd = 3 };

// The stores of the half spectrum (kernels/chain.py passes the same
// numbers).  kDirect: each bin from the split straight to device memory,
// (frames, N/2) natural order.  kWide: the same planes in 16-byte stores.
// kFmajor: (frames, n1, n2/2), row k1 holding bins k1 + n1 k2.  kWide and
// kFmajor stage the block's planes in shared memory first.  The store is a
// template parameter: as a run-time argument of one instance it cost regw
// and fmajor 4-5 % and reg 1.3 % at N = 4096 on an H100 (PERF.md).
enum Store { kDirect = 0, kWide = 1, kFmajor = 2 };

// g frames a block (the last block may hold fewer), their rows stacked
// unpadded: frame q's rows are q n1 .. q n1 + n1 - 1, its z values q M ..
// q M + M - 1 (M = N/2; an odd N's values q N .. q N + N - 1), and the
// block's rows = g n1 rounded up to a multiple of 8 (zero rows after the
// frames).  Shared memory: x (rows x kLdx), whose space then holds the
// FFT's two planes, y (rows x kLdx) and the starts (rows x dp).  Per
// frame: the IIR block into y; the M-point complex FFT of z read from y,
// into the planes; the split
// X[k] = E - i w^k D, E = (Z[k] + conj Z[M-k]) / 2, D = (Z[k] - conj
// Z[M-k]) / 2, with bin M - k from the same two values (twiddle
// -conj w^k); X[0] = Re Z[0] + Im Z[0] and X[M] = Re Z[0] - Im Z[0].  The
// half spectrum stores bins 0 .. M - 1 with X[M] in the imaginary plane's
// bin 0; the full one also bins M .. N - 1 by the mirror, and real X[0]
// and X[M].  An odd N has no split: the N-point FFTs' planes (2 g N
// floats) overlap x's and y's space, which the first pass has read into
// registers before any pass writes.  Several frames a block give the FFT's
// radix-16 passes a butterfly for every thread (M = 2048 has 128) and the
// IIR block rows enough for balanced bands.  kStore (enum Store) picks the
// half spectrum's store, kDirect for the other forms; lpad = lcm(n1, 32)
// pads kFmajor's staging.
template <int TM, int kEPT, int kForm, int kNT, int kStore>
__global__ void __launch_bounds__(kNT, kEPT > 16 || kNT > kThreads
                                           ? 1 : (TM == 4 ? 2 : 3))
chain_natural_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ HT,
                     const float* __restrict__ PhiT, sdsp_fft::Plan plan,
                     const float2* __restrict__ tab,
                     const float2* __restrict__ split, float* __restrict__ re,
                     float* __restrict__ im, int frames, int g, int n1,
                     int rows, int n2, int d, float rn2, int lpad) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);
  float* ys = xs + rows * kLdx;
  float* st = ys + rows * kLdx;
  const int tid = threadIdx.x;
  const int dp = starts_stride(d);
  const size_t f0 = static_cast<size_t>(blockIdx.x) * g;
  const int nf = static_cast<int>(min(static_cast<size_t>(g), frames - f0));
  const int nn = n1 * n2;              // N
  const int m = nn / 2;
  const int vr = nf * n1;              // rows that hold frames

  // Frames and starts; rows vr .. rows - 1 zero.
  if (n2 == kN2) {
    const float4* xf = reinterpret_cast<const float4*>(x + f0 * n1 * kN2);
    for (int i = tid; i < vr * kN2 / 4; i += kNT) {
      *reinterpret_cast<float4*>(xs + (i >> 5) * kLdx + 4 * (i & 31)) = xf[i];
    }
  } else {
    const float* xf = x + f0 * n1 * n2;
    for (int i = tid; i < vr * n2; i += kNT) {
      const int p = i / n2;
      xs[p * kLdx + i - p * n2] = xf[i];
    }
  }
  for (int i = tid; i < (rows - vr) * kLdx; i += kNT) xs[vr * kLdx + i] = 0.f;
  for (int i = tid; i < (rows - vr) * dp; i += kNT) st[vr * dp + i] = 0.f;
  const float* sf = s + f0 * d * n1;
  for (int i = tid; i < nf * d * n1; i += kNT) {
    const int q = i / (d * n1), r = i - q * d * n1;
    st[(q * n1 + r % n1) * dp + r / n1] = sf[i];
  }
  __syncthreads();

  iir_band_stage<TM>(ys, xs, st, HT, PhiT, rows, n2, d);
  __syncthreads();

  if constexpr (kForm == kOdd) {
    // Unswizzled: the swizzle spreads power-of-two strides only, and costs
    // conflicts where a warp's consecutive values cross a row of 32.
    const sdsp_fft::Planes<0> z{0, sdsp_fft::round32(g * nn)};
    sdsp_fft::fft_block<kEPT>(z, FrameReal{rows * kLdx, n2, rn2},
                              SpectrumOut{re + f0 * nn, im + f0 * nn}, plan,
                              tab, nf * nn);
    return;
  }

  // x's space holds the FFT's planes, swizzled also for an odd factor of m
  // (one instance, not two); y lies at offset rows kLdx.
  const sdsp_fft::Planes<31> z{0, sdsp_fft::round32(g * m)};
  if constexpr (kForm == kPairs) {
    sdsp_fft::fft_block<kEPT>(z, FramePairs{rows * kLdx, n2, rn2}, z, plan,
                              tab, nf * m);
  } else {
    sdsp_fft::fft_block<kEPT>(z, FrameAsComplex{rows * kLdx, n2, rn2}, z,
                              plan, tab, nf * m);
  }

  constexpr bool kMirror = kForm != kHalf;
  const int len = kMirror ? nn : m;    // bins a frame stores
  // kWide and kFmajor stage the block's planes in y's space, which only the
  // FFT's first pass reads (a pass reads all its values before it writes):
  // re at ys, im at ys + sp, frame q's bin k at p = q M + k (kWide), or at
  // p + p / lpad (kFmajor: one pad word every lcm(n1, 32) words, so that
  // the reads at a stride of n1 below fall in 32 banks).  The host checks
  // that a plane fits in sp.
  constexpr bool kStaged = !kMirror && kStore != kDirect;
  const int sp = rows * (kLdx / 2);
  const float rl = __frcp_rn(static_cast<float>(lpad));
  for (int q = 0; q < nf; ++q) {
    float* ref = re + (f0 + q) * len;
    float* imf = im + (f0 + q) * len;
    const int zq = q * m;
    // Bin k of frame q to device memory, or to its staging place.
    const auto put = [&](int k, float vr, float vi) {
      if constexpr (kForm == kHalf && kStore != kDirect) {   // kStaged
        int p = zq + k;
        if (kStore == kFmajor) p += sdsp_fft::fdiv(p, rl);
        ys[p] = vr;
        ys[sp + p] = vi;
      } else {
        ref[k] = vr;
        imf[k] = vi;
      }
    };
    for (int k = tid; 2 * k <= m; k += kNT) {
      const float2 a = z(zq + k);
      if (k == 0) {
        if (kMirror) {
          put(0, a.x + a.y, 0.f);
          put(m, a.x - a.y, 0.f);
        } else {
          put(0, a.x + a.y, a.x - a.y);
        }
        continue;
      }
      const float2 b = z(zq + m - k);
      const float2 w = __ldg(split + k);
      const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
      const float dr = 0.5f * (a.x - b.x), di = 0.5f * (a.y + b.y);
      const float u = w.x * di + w.y * dr;    // Re(-i w D)
      const float v = w.y * di - w.x * dr;    // Im(-i w D)
      put(k, er + u, ei + v);
      if (kMirror) put(nn - k, er + u, -(ei + v));   // X[N - k] = conj X[k]
      if (2 * k < m) {
        put(m - k, er - u, v - ei);
        if (kMirror) put(m + k, er - u, ei - v);     // X[M + k] = conj X[M - k]
      }
    }
  }
  if constexpr (!kStaged) return;
  __syncthreads();

  // The block's frames are one run of nf M values of each output plane.
  const size_t base = f0 * m;
  const int total = nf * m;
  if constexpr (kStore == kWide) {
    if (m % 4 == 0) {   // base, sp and the planes 16-byte aligned
      const float4* sr = reinterpret_cast<const float4*>(ys);
      const float4* si = reinterpret_cast<const float4*>(ys + sp);
      for (int i = tid; i < total / 4; i += kNT) {
        reinterpret_cast<float4*>(re + base)[i] = sr[i];
        reinterpret_cast<float4*>(im + base)[i] = si[i];
      }
    } else {
      for (int i = tid; i < total; i += kNT) {
        re[base + i] = ys[i];
        im[base + i] = ys[sp + i];
      }
    }
    return;
  }
  // kFmajor: value e = (q, k1, k2) of the run holds bin k1 + n1 k2 of frame
  // q; consecutive threads write consecutive e, reading the staging at a
  // stride of n1.
  const int h = n2 / 2;
  const float rm = __frcp_rn(static_cast<float>(m));
  const float rh = __frcp_rn(static_cast<float>(h));
  for (int e = tid; e < total; e += kNT) {
    const int q = sdsp_fft::fdiv(e, rm), r = e - q * m;
    const int k1 = sdsp_fft::fdiv(r, rh);
    const int p = q * m + k1 + n1 * (r - k1 * h);
    const int i = p + sdsp_fft::fdiv(p, rl);
    re[base + e] = ys[i];
    im[base + e] = ys[sp + i];
  }
}

template <int TM, int kEPT, int kForm, int kNT, int kStore>
cudaError_t launch_natural(const float* x, const float* s, const float* HT,
                           const float* PhiT, const sdsp_fft::Plan& plan,
                           const float2* tab, const float2* split, float* re,
                           float* im, int frames, int g, int n1, int rows,
                           int n2, int d, int lpad, size_t smem,
                           cudaStream_t stream) {
  const auto kernel = chain_natural_kernel<TM, kEPT, kForm, kNT, kStore>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(frames + g - 1) / g, kNT, smem, stream>>>(
      x, s, HT, PhiT, plan, tab, split, re, im, frames, g, n1, rows, n2, d,
      1.0f / static_cast<float>(n2), lpad);
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
  // Frames a block: the caller's, or as many as keep the block's FFT at
  // 4096 values and its rows at 64 (two frames at N = 4096, eight at 1024
  // and at the odd 375).
  const int per = odd ? nn : nn / 2;   // FFT values a frame
  if (g == 0) {
    g = 1;
    while (2 * g * per <= 4096 && ((2 * g * n1 + 7) & ~7) <= 64) g *= 2;
  }
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
