// Fused north-star chain kernels for Hopper (sm_90a): block IIR + FFT of
// each frame, the filtered signal never written to device memory.
//
// Replaces the TPU kernels reached through simpledsp_tpu/kernels/chain.py
// fused_chain_frames:
//   chain_natural_kernel, form kHalf: _make_packed_reg_kernel (:362) and
//     _make_packed_kernel (:283), layouts "reg" and "k1", the packed half
//     spectrum in natural bin order (the TPU's two output layouts have no
//     counterpart here);
//   chain_natural_kernel, forms kFull / kPairs / kOdd: _make_fused_kernel
//     (:425), half_spectrum=False (the JAX default), the full complex
//     spectrum in natural bin order, any n1, n2 <= 128 (odd too: odd N up
//     to 127 x 127);
//   chain_frames_kernel, modes kWide and kFmajor: the store orders of
//     chain_variants.py _make_packed_regw_kernel (:144, 16-byte stores of
//     the natural-order planes) and _make_packed_fmajor_kernel (:374, each
//     frame's (n1, n2/2) Re/Im rows k1-major, written from the step-3
//     accumulators);
//   chain_grouped_kernel: _make_packed_regg_kernel (:227, reg2/reg4),
//     _make_packed_regp_kernel (:298) and _make_packed_pair_kernel (:435),
//     step 1 over g frames a block.
// chain_tc.cu holds the split-bf16 tensor-core form ("regs").
//
// chain_natural_kernel runs per frame the IIR block, then, for an even N,
// the real FFT of y as the N/2-point complex FFT of z[t] = y[2t] + i y[2t+1]
// on the FFT core (fft_core.cuh) and the split into the one-sided spectrum
// (see the kernel); the half spectrum stores bins 0 .. N/2 - 1, the full
// one all N bins, the upper half by the mirror X[N - k] = conj X[k] (a store
// twice as wide, the same FFT).  n2 odd with N even reads each sample of a
// pair at its own row (kPairs).  An odd N has no split: the N-point complex
// FFT of (y, 0) runs on the core, its last pass storing the bins.  What
// bounds it: at N = 4096 the IIR block is about 0.34 M FMAs
// a frame (0.30 M in the chunks of H^T it keeps, 0.04 M for the starts) and
// the FFT about 0.12 MFLOP, against 32 KB of input and output (48 KB for the
// full spectrum), about 24 flops a byte (16 for the full), near the card's
// 20 (67 TFLOP/s over 3.35 TB/s): FMA issue and device memory both.  The
// design removes work: the FFT replaces the dense four-step DFT products
// (1.3 M FMAs a frame for the half spectrum, 3.7 M in all for the full one
// before), and the IIR block skips the all-zero chunks of the triangular
// H^T (about half its FMAs).  A block takes g frames (two at N = 4096, four
// at 2048, eight at 1024, 32 at 200: rows stacked unpadded), so that the
// FFT's passes give every thread a butterfly and the IIR block's bands
// balance; shared memory holds their x, y and starts (71 KB at N = 4096,
// two blocks an SM at 128 registers), one block's loads overlapping the
// other's work.  An odd N stacks frames the same way (eight at 375); above
// 4096 values, one frame a block, it runs 512 threads with 16 or 32 values
// each (to 127 x 127 = 16129, whose planes, 126 KB, fit in x's and y's
// space).  Its large odd-radix passes (101 at 8181, 127 at 16129) are
// latency-bound: the largest N runs slower than the four-step form it
// replaced (PERF.md).
//
// The store forms and the grouped form keep the four-step design.  Per
// frame, with x viewed as (n1, n2) and the sub-block starts s as (D, n1),
// D = 2(M+1):
//
//   1. IIR block     y[p, i]  = sum_j x[p, j] H[i, j] + sum_e s[e, p] Phi[i, e]
//   2. step 1        [c; s][k1, t] = sum_p W1cs[k1, p] y[p, t]
//   3. twiddle       tr = c Tc - s Ts,  ti = s Tc + c Ts
//   4. step 3        out[k1, l] = sum_t tr[k1, t] P[l, t] + ti[k1, t] Q[l, t]
//                    (lanes l < n2/2: Re X, l >= n2/2: Im X, bin k1 + n1 (l % (n2/2)))
//   5. Nyquist       X[N/2] = sum_t tr[0, t] (-1)^t into the Im slot of bin 0
//
// The tables arrive transposed where that makes each product's right-hand
// operand row-major over the output columns: HT = H^T (n2, 128),
// PhiT = Phi^T (D, 128), W1cs (2 n1p, n1p), Tc/Ts (n1p, 128), and the
// step-3 table T = [P^T; Q^T] (2 n2, 128).  Every row is 128 wide and the
// frame has n1p rows, n1 rounded up to a multiple of 8: for a smaller frame
// (n2 < 128 or n1 % 8) the wrapper zero-pads the tables to that shape, the
// kernel zero-fills the frame's extra rows and columns, and the zeros flow
// through every product into output lanes and rows that are never stored.
// The depth of the IIR and step-3 products is n2 at run time, so a padded
// column costs no FMA there; at n2 = 128 and n1 % 8 == 0 nothing is padded.
//
// What bounds the four-step forms: at N = 4096 a frame is about 3.7 MFLOP of
// fp32 FMAs against 32 KB of input and output, about 115 FLOP per byte, so
// they are bound by FMA issue on the CUDA cores, not by device memory.
// Every form keeps IEEE fp32 on the CUDA cores (no tensor cores, no TF32),
// which holds the chain's 130 dB bar.  The frame and every intermediate stay
// in shared memory (three frame-sized buffers, reused: 200 KB at n1 = 128,
// above the 48 KB default, hence the opt-in); the constant tables (about
// 200 KB at N = 4096) are read from global memory, where all blocks share
// them in L2.  Each thread holds a TM-row by 4-column tile of every product
// in registers and reads its left operand four k at a time.

#include "chain_common.cuh"
#include "fft_core.cuh"

namespace {

using namespace sdsp_chain;

// The output forms of sdsp_chain_frames_f32 (kernels/chain.py _MODES); the
// natural-order half spectrum and the full spectrum have their own kernel,
// chain_natural_kernel.
enum Mode { kWide = 1, kFmajor = 2 };

// TM rows per warp in the n1p-row products; step 1 has 2 n1p rows.  The
// host picks TM so that 8 TM divides n1p: every row chunk is full.  kPad
// selects the padded frame (n2 < 128 or n1 % 8); without it n1p == n1 and
// n2 == 128 are known, and the kernel is the unpadded one instruction for
// instruction (a single instance with run-time padding was measured 24%
// slower at N = 16384).
template <int TM, bool kPad, int kMode>
__global__ void __launch_bounds__(kThreads)
chain_frames_kernel(const float* __restrict__ x, const float* __restrict__ s,
                    const float* __restrict__ HT, const float* __restrict__ PhiT,
                    const float* __restrict__ W1cs, const float* __restrict__ Tc,
                    const float* __restrict__ Ts, const float* __restrict__ T3,
                    float* __restrict__ re, float* __restrict__ im, int n1,
                    int n1p_arg, int n2_arg, int d) {
  const int n1p = kPad ? n1p_arg : n1;
  const int n2 = kPad ? n2_arg : kN2;
  constexpr int TM1 = TM == 4 ? 4 : 2 * TM;
  extern __shared__ float4 smem4[];
  __shared__ float nyq;
  const int n = n1p * kN2;       // floats of one padded frame buffer
  const int ldo = n1p + 1;       // row stride of the transposed output stage
  float* buf_a = reinterpret_cast<float*>(smem4);  // x, then c -> tr
  float* buf_b = buf_a + n;                        // y, then out^T (128 x ldo)
  float* buf_c = buf_b + kN2 * ldo;                // s -> ti
  float* st = buf_c + n;                           // starts^T (n1p, dp)
  const size_t f = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int col0 = 4 * (tid & 31);

  load_frame<kPad>(buf_a, st, x, s, f, n1, n1p, n2, d);
  __syncthreads();

  // 1. IIR block -> y in buf_b.
  iir_stage<TM>(buf_b, kN2, buf_a, st, HT, PhiT, n1p, n2_arg, d);
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
  twiddle_stage<false>(buf_a, buf_c, Tc, Ts, n1p, n1);
  __syncthreads();

  if constexpr (kMode == kFmajor) {
    // 4-5. Step 3 stored from the accumulators: each frame's Re rows
    // (n1, n2/2) and Im rows, k1-major.  Row k1 = 0 belongs to warp 0,
    // whose lanes all hold the Nyquist bin for the Im X[0] slot.
    const int h = n2 / 2;
    const float nyq_w = warp == 0 ? nyquist_warp(buf_a) : 0.f;
    float* ref = re + f * n1 * h;
    float* imf = im + f * n1 * h;
    for (int m0 = 0; m0 < n1p; m0 += kWarps * TM) {
      float acc[TM][4] = {};
      mac<TM>(acc, m0, buf_a, kN2, T3, n2_arg);
      mac<TM>(acc, m0, buf_c, kN2, T3 + n2 * kN2, n2_arg);
#pragma unroll
      for (int r = 0; r < TM; ++r) {
        const int m = m0 + warp + kWarps * r;
        if (m >= n1) continue;
        if (m == 0) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (col0 + j == h) acc[r][j] = nyq_w;
          }
        }
        if (h % 4 == 0) {   // four lanes of one half: one 16-byte store
          if (col0 < h) {
            store4(ref + m * h + col0, acc[r]);
          } else if (col0 < n2) {
            store4(imf + m * h + col0 - h, acc[r]);
          }
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l = col0 + j;
            if (l < h) {
              ref[m * h + l] = acc[r][j];
            } else if (l < n2) {
              imf[m * h + l - h] = acc[r][j];
            }
          }
        }
      }
    }
    return;
  }

  // 4. Step 3, staged transposed in buf_b.  5. Nyquist bin from tr row 0
  // (buf_a is not written by step 3).
  step3_stage<TM>(buf_b, ldo, buf_a, buf_c, T3, n1p, n2_arg);
  if (warp == 0) {
    const float v = nyquist_warp(buf_a);
    if (tid == 0) nyq = v;
  }
  __syncthreads();

  const int h = kPad ? n1 * n2 / 2 : n / 2;
  float* ref = re + f * h;
  float* imf = im + f * h;
  if (kMode == kWide && h % 4 == 0) {
    // The natural-order planes of chain_natural_kernel, four bins a thread
    // in one 16-byte store per plane.
    for (int k4 = 4 * tid; k4 < h; k4 += 4 * kThreads) {
      float vr[4], vi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k4 + j, k1 = k % n1, k2 = k / n1;
        vr[j] = buf_b[k2 * ldo + k1];
        vi[j] = k == 0 ? nyq : buf_b[(n2 / 2 + k2) * ldo + k1];
      }
      store4(ref + k4, vr);
      store4(imf + k4, vi);
    }
  } else {
    store_natural(ref, imf, buf_b, ldo, 0, n1, n2, nyq);
  }
}

// g frames a block, their rows stacked: rows q n1 + p for frame q, R = g n1
// rows padded to Rp (a multiple of 8, R itself unpadded per frame, so that
// frames of 2-6 rows fill a block instead of one frame padded to 8 rows).
// The IIR block, the twiddle and step 3 are row-wise and run over all the
// rows; step 1 runs per frame against the one (2 n1, n1) table W1cs
// (unpadded here); the twiddle row is the row index mod n1.
template <int TM>
__global__ void __launch_bounds__(kThreads)
chain_grouped_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ HT, const float* __restrict__ PhiT,
                     const float* __restrict__ W1cs, const float* __restrict__ Tc,
                     const float* __restrict__ Ts, const float* __restrict__ T3,
                     float* __restrict__ re, float* __restrict__ im, int frames,
                     int n1, int n2, int d, int g) {
  extern __shared__ float4 smem4[];
  __shared__ float nyq[kN2];
  const int R = g * n1, Rp = (R + 7) & ~7;
  const int n = Rp * kN2;
  const int ldo = Rp + 1;
  const int dp = starts_stride(d);
  float* buf_a = reinterpret_cast<float*>(smem4);
  float* buf_b = buf_a + n;
  float* buf_c = buf_b + kN2 * ldo;
  float* st = buf_c + n;
  const int f0 = blockIdx.x * g;
  const int gv = min(g, frames - f0);   // frames of this block
  const int rv = gv * n1;               // their rows
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int col0 = 4 * (tid & 31);

  const float* xf = x + static_cast<size_t>(f0) * n1 * n2;
  for (int i = tid; i < n; i += kThreads) {
    const int row = i / kN2, j = i % kN2;
    buf_a[i] = (row < rv && j < n2) ? xf[row * n2 + j] : 0.f;
  }
  const float* sf = s + static_cast<size_t>(f0) * d * n1;
  for (int i = tid; i < Rp * dp; i += kThreads) {
    const int row = i / dp, e = i % dp;
    st[i] = (row < rv && e < d) ? sf[(row / n1) * d * n1 + e * n1 + row % n1]
                                : 0.f;
  }
  __syncthreads();

  iir_stage<TM>(buf_b, kN2, buf_a, st, HT, PhiT, Rp, n2, d);
  __syncthreads();

  // Step 1 per frame: output row i = (q, k) of the 2 R rows, k < 2 n1.
  for (int i = warp; i < 2 * R; i += kWarps) {
    const int q = i / (2 * n1), k = i % (2 * n1);
    const float* w = W1cs + k * n1;
    const float* yq = buf_b + q * n1 * kN2 + col0;
    float acc[4] = {};
    for (int p0 = 0; p0 < n1; p0 += kChunk) {
      float part[4] = {};
      const int pe = min(n1, p0 + kChunk);
      for (int p = p0; p < pe; ++p) {
        fma4(part, w[p], *reinterpret_cast<const float4*>(yq + p * kN2));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[j] += part[j];
    }
    store4((k < n1 ? buf_a : buf_c) + (q * n1 + k % n1) * kN2 + col0, acc);
  }
  __syncthreads();

  twiddle_stage<true>(buf_a, buf_c, Tc, Ts, R, n1);
  __syncthreads();

  step3_stage<TM>(buf_b, ldo, buf_a, buf_c, T3, Rp, n2);
  for (int q = warp; q < g; q += kWarps) {
    const float v = nyquist_warp(buf_a + q * n1 * kN2);
    if ((tid & 31) == 0) nyq[q] = v;
  }
  __syncthreads();

  const int h = n1 * n2 / 2;
  for (int q = 0; q < gv; ++q) {
    const size_t off = static_cast<size_t>(f0 + q) * h;
    store_natural(re + off, im + off, buf_b, ldo, q * n1, n1, n2, nyq[q]);
  }
}

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
// IIR block rows enough for balanced bands.
template <int TM, int kEPT, int kForm, int kNT>
__global__ void __launch_bounds__(kNT, kEPT > 16 || kNT > kThreads
                                           ? 1 : (TM == 4 ? 2 : 3))
chain_natural_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ HT,
                     const float* __restrict__ PhiT, sdsp_fft::Plan plan,
                     const float2* __restrict__ tab,
                     const float2* __restrict__ split, float* __restrict__ re,
                     float* __restrict__ im, int frames, int g, int n1,
                     int rows, int n2, int d, float rn2) {
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
  for (int q = 0; q < nf; ++q) {
    float* ref = re + (f0 + q) * len;
    float* imf = im + (f0 + q) * len;
    const int zq = q * m;
    for (int k = tid; 2 * k <= m; k += kNT) {
      const float2 a = z(zq + k);
      if (k == 0) {
        ref[0] = a.x + a.y;
        if (kMirror) {
          imf[0] = 0.f;
          ref[m] = a.x - a.y;
          imf[m] = 0.f;
        } else {
          imf[0] = a.x - a.y;
        }
        continue;
      }
      const float2 b = z(zq + m - k);
      const float2 w = __ldg(split + k);
      const float er = 0.5f * (a.x + b.x), ei = 0.5f * (a.y - b.y);
      const float dr = 0.5f * (a.x - b.x), di = 0.5f * (a.y + b.y);
      const float u = w.x * di + w.y * dr;    // Re(-i w D)
      const float v = w.y * di - w.x * dr;    // Im(-i w D)
      ref[k] = er + u;
      imf[k] = ei + v;
      if (kMirror) {                          // X[N - k] = conj X[k]
        ref[nn - k] = er + u;
        imf[nn - k] = -(ei + v);
      }
      if (2 * k < m) {
        ref[m - k] = er - u;
        imf[m - k] = v - ei;
        if (kMirror) {                        // X[M + k] = conj X[M - k]
          ref[m + k] = er - u;
          imf[m + k] = ei - v;
        }
      }
    }
  }
}

template <int TM, int kEPT, int kForm, int kNT = kThreads>
cudaError_t launch_natural(const float* x, const float* s, const float* HT,
                           const float* PhiT, const sdsp_fft::Plan& plan,
                           const float2* tab, const float2* split, float* re,
                           float* im, int frames, int g, int n1, int rows,
                           int n2, int d, size_t smem, cudaStream_t stream) {
  const auto kernel = chain_natural_kernel<TM, kEPT, kForm, kNT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(frames + g - 1) / g, kNT, smem, stream>>>(
      x, s, HT, PhiT, plan, tab, split, re, im, frames, g, n1, rows, n2, d,
      1.0f / static_cast<float>(n2));
  return cudaGetLastError();
}

// The instance of the form for the block's rows (an even number of row
// groups of 8 TM rows balances the bands) and values (kEPT 32 above 16 a
// thread).  An odd N above 16 values a thread (one frame a block) runs 512
// threads, TM 1: 16 or 32 values a thread, twice the warps to hide the
// odd-radix passes' latency.
template <int kForm>
cudaError_t dispatch_natural(const float* x, const float* s, const float* HT,
                             const float* PhiT, const sdsp_fft::Plan& plan,
                             const float2* tab, const float2* split, float* re,
                             float* im, int frames, int g, int n1, int rows,
                             int n2, int d, int values, size_t smem,
                             cudaStream_t st) {
#define SDSP_RUN(TM, EPT, NT)                                                 \
  launch_natural<TM, EPT, kForm, NT>(x, s, HT, PhiT, plan, tab, split, re, im, \
                                     frames, g, n1, rows, n2, d, smem, st)
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

template <int TM, bool kPad, int kMode>
cudaError_t launch_frames(const float* x, const float* s, const float* HT,
                          const float* PhiT, const float* W1cs, const float* Tc,
                          const float* Ts, const float* T3, float* re,
                          float* im, int frames, int n1, int n1p, int n2,
                          int d, size_t smem, cudaStream_t stream) {
  const auto kernel = chain_frames_kernel<TM, kPad, kMode>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<frames, kThreads, smem, stream>>>(x, s, HT, PhiT, W1cs, Tc, Ts, T3,
                                             re, im, n1, n1p, n2, d);
  return cudaGetLastError();
}

template <int kMode>
cudaError_t dispatch_frames(const float* x, const float* s, const float* HT,
                            const float* PhiT, const float* W1cs,
                            const float* Tc, const float* Ts, const float* T3,
                            float* re, float* im, int frames, int n1, int n1p,
                            int n2, int d, size_t smem, cudaStream_t st) {
  const bool pad = n1p != n1 || n2 != kN2;
#define SDSP_RUN(TM)                                                         \
  (pad ? launch_frames<TM, true, kMode>(x, s, HT, PhiT, W1cs, Tc, Ts, T3, re, \
                                        im, frames, n1, n1p, n2, d, smem, st) \
       : launch_frames<TM, false, kMode>(x, s, HT, PhiT, W1cs, Tc, Ts, T3,    \
                                         re, im, frames, n1, n1p, n2, d,      \
                                         smem, st))
  if (n1p % 32 == 0) return SDSP_RUN(4);
  if (n1p % 16 == 0) return SDSP_RUN(2);
  return SDSP_RUN(1);
#undef SDSP_RUN
}

template <int TM>
cudaError_t launch_grouped(const float* x, const float* s, const float* HT,
                           const float* PhiT, const float* W1cs,
                           const float* Tc, const float* Ts, const float* T3,
                           float* re, float* im, int frames, int n1, int n2,
                           int d, int g, size_t smem, cudaStream_t stream) {
  const auto kernel = chain_grouped_kernel<TM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int blocks = (frames + g - 1) / g;
  kernel<<<blocks, kThreads, smem, stream>>>(x, s, HT, PhiT, W1cs, Tc, Ts, T3,
                                             re, im, frames, n1, n2, d, g);
  return cudaGetLastError();
}

}  // namespace

// Shared memory of one block, in bytes, for `rows` frame rows (n1p, or the
// padded rows of a group).
extern "C" size_t sdsp_chain_frames_smem_bytes(int rows, int d) {
  return sizeof(float) * smem_floats(rows, d, kN2);
}

// The half spectrum (full = 0) or the full spectrum (full = 1) in natural
// order, on the FFT core.
// Launch on `stream` of `device`; returns cudaGetLastError() after the
// launch (0 when the launch was accepted).  x (frames, n1, n2), s
// (frames, d, n1), HT (n2, 128) and PhiT (d, 128) as for
// sdsp_chain_frames_f32; HT must be lower-triangular (H^T[j, i] = 0 for
// j > i), as the IIR block's H^T is.  radices[0..npass) and tab are the
// core's plan and table (fft_core.cuh make_plan) for M = n1 n2 / 2 points
// where N = n1 n2 is even, for N points where it is odd (full spectrum
// only); split holds the M / 2 + 1 twiddles
// exp(-2 pi i k / (2 M)), (re, im) float32 pairs (unread for an odd N).
// re / im: (frames, M), the packed one-sided spectrum in natural order with
// X[N/2].re in im[:, 0]; or with full, (frames, N), the spectrum in natural
// order.  n2 is even for the half spectrum.  A block that needs more
// shared memory than kMaxSmem (a large d) is refused.
extern "C" int sdsp_chain_natural_f32(const float* x, const float* s,
                                      const float* HT, const float* PhiT,
                                      const int* radices, int npass,
                                      const float* tab, const float* split,
                                      float* re, float* im, int frames, int n1,
                                      int n2, int d, int full, int device,
                                      void* stream) {
  const int nn = n1 * n2;
  const bool odd = nn % 2 != 0;
  sdsp_fft::Plan plan;
  if (n2 < 1 || n2 > kN2 || (!full && n2 % 2) || n1 < 1 || n1 > 128 ||
      d < 1 || frames < 0 ||
      !sdsp_fft::make_plan(odd ? nn : nn / 2, radices, npass, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  // Frames a block: as many as keep the block's FFT at 4096 values and its
  // rows at 64 (two frames at N = 4096, eight at 1024 and at the odd 375).
  const int per = odd ? nn : nn / 2;   // FFT values a frame
  int g = 1;
  while (2 * g * per <= 4096 && ((2 * g * n1 + 7) & ~7) <= 64) g *= 2;
  const int rows = (g * n1 + 7) & ~7;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(rows) * kLdx +
                                       static_cast<size_t>(starts_stride(d)) * rows);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* t2 = reinterpret_cast<const float2*>(tab);
  const auto* sp = reinterpret_cast<const float2*>(split);
  const int values = g * per;
  if (!full) {
    err = dispatch_natural<kHalf>(x, s, HT, PhiT, plan, t2, sp, re, im, frames,
                                  g, n1, rows, n2, d, values, smem, st);
  } else if (odd) {
    err = dispatch_natural<kOdd>(x, s, HT, PhiT, plan, t2, sp, re, im, frames,
                                 g, n1, rows, n2, d, values, smem, st);
  } else if (n2 % 2) {
    err = dispatch_natural<kPairs>(x, s, HT, PhiT, plan, t2, sp, re, im,
                                   frames, g, n1, rows, n2, d, values, smem, st);
  } else {
    err = dispatch_natural<kFull>(x, s, HT, PhiT, plan, t2, sp, re, im, frames,
                                  g, n1, rows, n2, d, values, smem, st);
  }
  return static_cast<int>(err);
}

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  Every pointer is device memory holding
// contiguous float32: x (frames, n1, n2), s (frames, d, n1), tables as
// described at the top of this file, padded to n1p = n1 rounded up to a
// multiple of 8.  mode (enum Mode) picks the output: kWide re/im
// (frames, n1 n2 / 2); kFmajor re/im (frames, n1, n2 / 2).  n2 is even.
// The natural order and the full spectrum have their own entry,
// sdsp_chain_natural_f32.
extern "C" int sdsp_chain_frames_f32(const float* x, const float* s,
                                     const float* HT, const float* PhiT,
                                     const float* W1cs, const float* Tc,
                                     const float* Ts, const float* T3,
                                     float* re, float* im, int frames, int n1,
                                     int n2, int d, int mode, int device,
                                     void* stream) {
  if (n2 < 2 || n2 > kN2 || n2 % 2 || n1 < 1 || n1 > 128 || d < 1 ||
      frames < 0 || mode < kWide || mode > kFmajor) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const int n1p = (n1 + 7) & ~7;
  const size_t smem = sdsp_chain_frames_smem_bytes(n1p, d);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kWide:
      err = dispatch_frames<kWide>(x, s, HT, PhiT, W1cs, Tc, Ts, T3, re, im,
                                   frames, n1, n1p, n2, d, smem, st);
      break;
    default:
      err = dispatch_frames<kFmajor>(x, s, HT, PhiT, W1cs, Tc, Ts, T3, re, im,
                                     frames, n1, n1p, n2, d, smem, st);
      break;
  }
  return static_cast<int>(err);
}

// The grouped form: g frames a block (the last block may hold fewer).  As
// sdsp_chain_frames_f32 in mode kWide, except W1cs, which is the
// unpadded (2 n1, n1) table.  g n1 rows padded to a multiple of 8 must fit
// the block's shared memory, and g <= 128.
extern "C" int sdsp_chain_grouped_f32(const float* x, const float* s,
                                      const float* HT, const float* PhiT,
                                      const float* W1cs, const float* Tc,
                                      const float* Ts, const float* T3,
                                      float* re, float* im, int frames, int n1,
                                      int n2, int d, int g, int device,
                                      void* stream) {
  const int rp = (g * n1 + 7) & ~7;
  const size_t smem = sdsp_chain_frames_smem_bytes(rp, d);
  if (n2 < 2 || n2 > kN2 || n2 % 2 || n1 < 1 || n1 > 128 || d < 1 ||
      frames < 0 || g < 1 || g > kN2 ||
      smem + sizeof(float) * kN2 > kMaxSmem) {  // with the static nyq[]
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rp % 32 == 0) {
    err = launch_grouped<4>(x, s, HT, PhiT, W1cs, Tc, Ts, T3, re, im, frames,
                            n1, n2, d, g, smem, st);
  } else if (rp % 16 == 0) {
    err = launch_grouped<2>(x, s, HT, PhiT, W1cs, Tc, Ts, T3, re, im, frames,
                            n1, n2, d, g, smem, st);
  } else {
    err = launch_grouped<1>(x, s, HT, PhiT, W1cs, Tc, Ts, T3, re, im, frames,
                            n1, n2, d, g, smem, st);
  }
  return static_cast<int>(err);
}
