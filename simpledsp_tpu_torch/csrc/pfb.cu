// Polyphase filter-bank receiver kernels for Hopper (sm_90a): branch FIR ->
// M-point inverse DFT across branches -> FM discriminator / AM envelope ->
// optional audio decimator, one pass over the input per stream and tile.
//
// Replaces the TPU kernels of simpledsp_tpu/kernels/pfb.py:
//   flat layout   _make_flat_body   (reached through _run_flat: pfb_fm_flat,
//                                    pfb_am_flat; the receiver banks' path)
//   frames layout _make_packed_body (reached through _run_packed:
//                                    pfb_fm_frames, pfb_am_frames,
//                                    pfb_channelize_frames)
// The two layouts differ only in how a block reads its input.  Stream b's
// frame f, sample m (0 <= m < M) is
//   flat   x[b * ld + f * M + m]     (the history-prefixed (B, W) plane)
//   frames x[b * ld + m * ld_m + f]  (channel-major (B, M, nfr) planes)
//
// Per output frame n and channel c, with taps_t[m, j] = h[j M + M-1-m] (the
// branch flip folded in, PFBOperators.taps_t) and W = wfc + i wfs:
//   1. branch FIR   u[n, m] = sum_{j<K} taps_t[m, j] x[n + K-1-j, m]
//   2. inverse DFT  y[n, c] = sum_m W[c, m] u[n, m]   (unscaled, sign +i)
//   3. demod        FM: d[n] = gain atan2(Im q, Re q), q = y[n] conj(y[n-1]),
//                       y[-1] = the carried (prev_r, prev_i)
//                   AM: d[n] = |y[n]|;  chan: write y itself
//   4. decimator    audio[t] = sum_{j<kd} h_d[j] ext[kd-1 + t decim - j],
//                   ext = [ahist (kd-1) | d], the new ahist = ext's last kd-1
//   5. emit_sum     (am_dec) the sum of d over the call's frames
//
// Parallel over time.  One block per (stream, tile of gt output frames):
// the block stages the tile's input plus a halo of earlier frames in shared
// memory and recomputes the halo (1 y frame for the FM carry, kd-1 demod
// samples for the decimator) instead of receiving it from the previous tile.
// A halo frame before the call's first frame comes from the carried state
// instead.  The recomputed values come from the same code on the same
// inputs, so outputs do not depend on gt, bit for bit.  The TPU kernel's
// sequential grid with a scratch carry would put one stream on one SM: at
// B = 16 that is 16 of 132 SMs.
//
// The emit_sum partials are per 16-frame chunk (a tile holds whole chunks),
// summed in a fixed order by a second small kernel: no atomics, and the sum
// does not depend on the tile either.
//
// What bounds it on this card: at M = K = 16 a frame costs about 1.8 k fp32
// FMAs (512 FIR, 1024 DFT, 256 decimator) against 128 bytes of input, so at
// B = 16 x 2^20 samples the ideal is about 40 us of HBM reads at 3.35 TB/s
// against about 55 us of FMAs at 67 TFLOP/s: near the balance of the two.
// Every stage reads its operands from shared memory, so shared-memory
// traffic per FMA is what each stage cuts by blocking in registers (on an
// H100 at 700 W the fm_dec kernel then takes about 0.44 ms, about 13% of
// the FMA peak and 10% of HBM bandwidth: neither bound is reached):
//   FIR      a thread runs kR consecutive frames of one branch: each tap
//            brings one new input sample into a sliding register window
//            (1 tap + 2 input loads per 2 kR FMAs);
//   DFT      a thread runs kCB channels of one frame: the table rows are
//            read as warp-uniform float4s, the branch outputs once
//            (4 loads per 4 kCB FMAs);
//   decim    the demod output is stored by decimation phase, so a warp on
//            consecutive outputs of one channel reads consecutive words,
//            and each tap is one (weight, offset) pair from a table.
// The halo costs (Hb / gt) more work (25% at the banks' gt = 256, kd = 64).
// Plain fp32 on the CUDA cores: no tensor cores, no TF32.  The small tables
// are read through the read-only cache.  Every sum keeps one fixed order,
// so blocking changes no bit of the result.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kSumChunk = 16;  // frames per emit_sum partial
// FIR frames per thread.  Odd on purpose: with a row stride of M words the
// warps of an M < 32 bank read blocks kR M words apart, and an odd kR puts
// those blocks on disjoint banks.
constexpr int kR = 7;
constexpr int kCB = 4;         // DFT channels per thread (M % 4 == 0)

enum Mode : int { kFm = 0, kFmDec = 1, kAm = 2, kAmDec = 3, kChan = 4 };

struct Params {
  const float* xr;
  const float* xi;
  long long ld;      // elements between streams
  long long ld_m;    // frames layout: elements between rows m
  const float* taps_jm;  // (K, M): taps_t transposed, [j][m]
  const float* wct;      // (M, M): wfc transposed, [m][c]
  const float* wst;      // (M, M): wfs transposed, [m][c]
  const float* dtaps;    // (kd,)
  const float* prev_r;   // (B, M)
  const float* prev_i;
  const float* ahist;    // (B, M, kd-1)
  float* out0;           // disc / env / audio / chan re: (B, M, g or g/decim)
  float* out1;           // chan im (B, M, g)
  float* prev_r_out;     // (B, M)
  float* prev_i_out;
  float* ahist_out;      // (B, M, kd-1)
  float* partials;       // (B, M, nchunks)
  int M, K, g, gt, kd, decim, mode, emit_sum;
  float gain;
  int lg_m;              // log2 M (M is a power of two)
};

__host__ __device__ inline bool is_fm(int mode) {
  return mode == kFm || mode == kFmDec;
}
__host__ __device__ inline bool is_dec(int mode) {
  return mode == kFmDec || mode == kAmDec;
}
// y frames a tile computes before its first output frame.
__host__ __device__ inline int halo_before(int mode, int kd) {
  return (is_dec(mode) ? kd - 1 : 0) + (is_fm(mode) ? 1 : 0);
}
// Shared memory, in floats.  Region A holds the input frames (2 planes,
// row stride M), then y (2 planes, row stride M+1: a warp reading one
// channel across frames hits distinct banks).  Region B holds the branch
// outputs u (2 planes, row stride M+1), then the demod output d laid out
// [c][k % decim][k / decim] with an odd channel stride (d_stride).  Region
// C holds the decimator's (tap, offset) table, kd int2s.
__host__ __device__ inline long long region_a(int M, int K, int ny) {
  const long long x = 2LL * (ny + K - 1) * M, y = 2LL * ny * (M + 1);
  return x > y ? x : y;
}
__host__ __device__ inline int d_rows(int ny, int decim) {
  return (ny + decim - 1) / decim;
}
__host__ __device__ inline int d_stride(int ny, int decim) {
  return (decim * d_rows(ny, decim)) | 1;
}
__host__ __device__ inline long long region_b(int M, int ny, int decim) {
  const long long u = 2LL * ny * (M + 1), d = 1LL * M * d_stride(ny, decim);
  return ((u > d ? u : d) + 1) & ~1LL;   // region C holds int2s
}

// Stage 3 of the kernel: y[i, c] = sum_m W[c, m] u[i, m] for frames
// [i0, ny), CB channels per thread.  Consecutive threads take consecutive
// frames of one channel block, so the table reads are warp-uniform.
template <int CB>
__device__ __forceinline__ void dft_blocked(const Params& p,
                                            const float* u_r,
                                            const float* u_i, float* y_r,
                                            float* y_i, int i0, int ny,
                                            int us, int ys) {
  const int M = p.M;
  const int nyr = ny - i0;
  for (int e = threadIdx.x; e < (M / CB) * nyr; e += kThreads) {
    const int c0 = (e / nyr) * CB, i = i0 + e % nyr;
    const float* ur = u_r + i * us;
    const float* ui = u_i + i * us;
    float cr[CB] = {}, si[CB] = {}, ci[CB] = {}, sr[CB] = {};
    for (int m = 0; m < M; ++m) {
      const float vr = ur[m], vi = ui[m];
      float wc[CB], ws[CB];
      if constexpr (CB == 4) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(
            p.wct + m * M + c0));
        const float4 b = __ldg(reinterpret_cast<const float4*>(
            p.wst + m * M + c0));
        wc[0] = a.x; wc[1] = a.y; wc[2] = a.z; wc[3] = a.w;
        ws[0] = b.x; ws[1] = b.y; ws[2] = b.z; ws[3] = b.w;
      } else {
#pragma unroll
        for (int q = 0; q < CB; ++q) {
          wc[q] = __ldg(p.wct + m * M + c0 + q);
          ws[q] = __ldg(p.wst + m * M + c0 + q);
        }
      }
#pragma unroll
      for (int q = 0; q < CB; ++q) {
        cr[q] = fmaf(wc[q], vr, cr[q]);
        si[q] = fmaf(ws[q], vi, si[q]);
        ci[q] = fmaf(wc[q], vi, ci[q]);
        sr[q] = fmaf(ws[q], vr, sr[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < CB; ++q) {
      y_r[i * ys + c0 + q] = cr[q] - si[q];
      y_i[i * ys + c0 + q] = ci[q] + sr[q];
    }
  }
}

// Two 512-thread blocks an SM: at most 64 registers a thread.  Without the
// bound the flat instance took 80, ran one block an SM and was 25-30%
// slower on an H100.
template <bool kFlat>
__global__ void __launch_bounds__(kThreads, 2)
pfb_kernel(const Params p) {
  extern __shared__ float smem[];
  const int M = p.M, K = p.K, mode = p.mode;
  const bool fm = is_fm(mode), dec = is_dec(mode);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * p.gt;            // first output frame
  const int gc = min(p.gt, p.g - f0);          // output frames of this tile
  const int hd = dec ? p.kd - 1 : 0;           // demod halo
  const int hb = halo_before(mode, p.kd);      // y halo
  const int ny_max = p.gt + hb;
  const int ny = gc + hb;                      // y frames: index i <-> f0-hb+i
  const int nx = ny + K - 1;                   // input frames, same origin
  const int a0 = f0 - hb;
  const int i0 = a0 < 0 ? -a0 : 0;             // first index at frame >= 0
  const int ys = M + 1;

  const int us = M + 1;
  float* xs_r = smem;                           // region A: input frames
  float* xs_i = xs_r + static_cast<long long>(nx) * M;
  float* y_r = smem;                            //   then y
  float* y_i = y_r + static_cast<long long>(ny_max) * ys;
  float* rb = smem + region_a(M, K, ny_max);    // region B: u, then d
  float* u_r = rb;
  float* u_i = u_r + static_cast<long long>(ny_max) * us;
  float* d = rb;
  const int dq = d_rows(ny_max, p.decim);       // d[c][ph][q]: q rows
  const int dsc = d_stride(ny_max, p.decim);    // channel stride

  const float* __restrict__ xr = p.xr + b * p.ld;
  const float* __restrict__ xi = p.xi + b * p.ld;
  const int tid = threadIdx.x;

  // 1. Input frames [i0, nx) into shared memory.
  if (kFlat) {
    const long long base = static_cast<long long>(a0) * M;
    for (int e = i0 * M + tid; e < nx * M; e += kThreads) {
      xs_r[e] = xr[base + e];
      xs_i[e] = xi[base + e];
    }
  } else {
    const int cnt = nx - i0;
    for (int e = tid; e < cnt * M; e += kThreads) {
      const int m = e / cnt, i = i0 + e % cnt;
      xs_r[i * M + m] = xr[m * p.ld_m + a0 + i];
      xs_i[i * M + m] = xi[m * p.ld_m + a0 + i];
    }
  }
  __syncthreads();

  // 2. Branch FIR: u[i, m] for y frames [i0, ny), kR frames per thread.
  // The window w[r] holds input frame i + r + K-1-j at tap j.
  const int nblk = (ny - i0 + kR - 1) / kR;
  for (int e = tid; e < nblk * M; e += kThreads) {
    const int m = e % M, i = i0 + (e / M) * kR;
    float wr[kR], wi[kR], ar[kR], ai[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int f = i + K - 1 + r;
      wr[r] = f < nx ? xs_r[f * M + m] : 0.f;
      wi[r] = f < nx ? xs_i[f * M + m] : 0.f;
      ar[r] = ai[r] = 0.f;
    }
    for (int j = 0; j < K; ++j) {
      const float t = __ldg(p.taps_jm + j * M + m);
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        ar[r] = fmaf(t, wr[r], ar[r]);
        ai[r] = fmaf(t, wi[r], ai[r]);
      }
      if (j + 1 < K) {
#pragma unroll
        for (int r = kR - 1; r > 0; --r) {
          wr[r] = wr[r - 1];
          wi[r] = wi[r - 1];
        }
        const int f = i + K - 2 - j;
        wr[0] = xs_r[f * M + m];
        wi[0] = xs_i[f * M + m];
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (i + r < ny) {
        u_r[(i + r) * us + m] = ar[r];
        u_i[(i + r) * us + m] = ai[r];
      }
    }
  }
  __syncthreads();

  // 3. Inverse DFT across branches: y[i, c] (overwrites the input frames).
  if (M % kCB == 0) {
    dft_blocked<kCB>(p, u_r, u_i, y_r, y_i, i0, ny, us, ys);
  } else {
    dft_blocked<1>(p, u_r, u_i, y_r, y_i, i0, ny, us, ys);
  }
  // The FM carry stands in for frame -1.
  if (fm && i0 > 0) {
    for (int c = tid; c < M; c += kThreads) {
      y_r[(i0 - 1) * ys + c] = p.prev_r[b * M + c];
      y_i[(i0 - 1) * ys + c] = p.prev_i[b * M + c];
    }
  }
  __syncthreads();

  const long long row = static_cast<long long>(b) * M;  // (b, c = 0)
  if (f0 + gc == p.g && fm) {  // new FM carry: y of the call's last frame
    const int i = p.g - 1 - a0;
    for (int c = tid; c < M; c += kThreads) {
      p.prev_r_out[row + c] = y_r[i * ys + c];
      p.prev_i_out[row + c] = y_i[i * ys + c];
    }
  }

  if (!dec) {
    // 4. Full-rate outputs, written channel-major: consecutive threads
    // write consecutive frames of one channel.
    for (int e = tid; e < M * gc; e += kThreads) {
      const int c = e / gc, n = e % gc;
      const int i = hb + n;
      const float yr = y_r[i * ys + c], yi = y_i[i * ys + c];
      const long long o = (row + c) * p.g + f0 + n;
      if (mode == kChan) {
        p.out0[o] = yr;
        p.out1[o] = yi;
      } else if (mode == kAm) {
        p.out0[o] = sqrtf(yr * yr + yi * yi);
      } else {
        const float pr = y_r[(i - 1) * ys + c], pi = y_i[(i - 1) * ys + c];
        const float dr = yr * pr + yi * pi;
        const float di = yi * pr - yr * pi;
        p.out0[o] = atan2f(di, dr) * p.gain;
      }
    }
    return;
  }

  // 4. Demod output d for frames f0 - hd + k, k in [0, hd + gc)
  // (overwrites u); frames before the call come from the carried ahist.
  // A thread writes one row q of channel c: k = q decim + ph, every phase.
  const int nd = hd + gc;
  const int dec_n = p.decim;
  const int nq = (nd + dec_n - 1) / dec_n;
  for (int e = tid; e < nq * M; e += kThreads) {
    const int c = e & (M - 1), q = e >> p.lg_m;
    float* dcol = d + c * dsc + q;
    for (int ph = 0, k = q * dec_n; ph < dec_n && k < nd; ++ph, ++k) {
      const int a = f0 - hd + k;
      float v;
      if (a < 0) {
        v = p.ahist[(row + c) * hd + hd + a];
      } else {
        const int i = k + hb - hd;
        const float yr = y_r[i * ys + c], yi = y_i[i * ys + c];
        if (fm) {
          const float pr = y_r[(i - 1) * ys + c], pi = y_i[(i - 1) * ys + c];
          const float dr = yr * pr + yi * pi;
          const float di = yi * pr - yr * pi;
          v = atan2f(di, dr) * p.gain;
        } else {
          v = sqrtf(yr * yr + yi * yi);
        }
      }
      dcol[ph * dq] = v;
    }
  }
  // The decimator's table: tap j reads d at k = t decim + hd - j, whose
  // phase (hd - j) % decim is the same for every t and whose row is
  // t + (hd - j) / decim, so tap j is (h[j], offset) with d[c][offset + t].
  int2* tab = reinterpret_cast<int2*>(rb + region_b(M, ny_max, dec_n));
  for (int j = tid; j < p.kd; j += kThreads) {
    const int ph = (hd - j) % dec_n;
    tab[j] = make_int2(__float_as_int(__ldg(p.dtaps + j)),
                       ph * dq + (hd - j) / dec_n);
  }
  __syncthreads();

  // 5. Decimator: audio (B, M, g / decim), consecutive threads on
  // consecutive outputs of one channel.
  const int nt = gc / dec_n;
  const int gd = p.g / dec_n;
  for (int e = tid; e < M * nt; e += kThreads) {
    const int c = e / nt, t = e % nt;
    const float* dc = d + c * dsc + t;
    float acc = 0.f;
    for (int j = 0; j < p.kd; ++j) {
      const int2 tj = tab[j];
      acc = fmaf(__int_as_float(tj.x), dc[tj.y], acc);
    }
    p.out0[(row + c) * gd + f0 / dec_n + t] = acc;
  }
  if (f0 + gc == p.g) {  // new ahist: the call's last kd-1 demod samples
    for (int e = tid; e < hd * M; e += kThreads) {
      const int c = e / hd, k = gc + e % hd;
      p.ahist_out[(row + c) * hd + e % hd] =
          d[c * dsc + (k % dec_n) * dq + k / dec_n];
    }
  }
  if (p.emit_sum) {
    // 16-frame chunk partials, each summed in frame order.
    const int nchunks = (p.g + kSumChunk - 1) / kSumChunk;
    const int nck = (gc + kSumChunk - 1) / kSumChunk;
    for (int e = tid; e < M * nck; e += kThreads) {
      const int c = e / nck, q = e % nck;
      const int n_end = min(gc, (q + 1) * kSumChunk);
      float s = 0.f;
      for (int n = q * kSumChunk; n < n_end; ++n) {
        const int k = hd + n;
        s += d[c * dsc + (k % dec_n) * dq + k / dec_n];
      }
      p.partials[(row + c) * nchunks + f0 / kSumChunk + q] = s;
    }
  }
}

// esum[r] = sum of partials[r, :] for r = (b, c), one warp per row: lane l
// adds chunks l, l + 32, ... in order, then a fixed butterfly.
__global__ void __launch_bounds__(256)
sum_partials_kernel(const float* __restrict__ partials, float* __restrict__ esum,
                    int rows, int nchunks) {
  const int r = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;
  const float* pr = partials + static_cast<long long>(r) * nchunks;
  float s = 0.f;
  for (int q = lane; q < nchunks; q += 32) s += pr[q];
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if (lane == 0) esum[r] = s;
}

}  // namespace

// Shared memory of one block, in bytes, for tiles of gt frames.
extern "C" long long sdsp_pfb_smem_bytes(int mode, int M, int K, int kd,
                                         int decim, int gt) {
  const int ny = gt + halo_before(mode, kd);
  const bool dec = is_dec(mode);
  return static_cast<long long>(sizeof(float)) *
         (region_a(M, K, ny) + region_b(M, ny, dec ? decim : 1) +
          (dec ? 2LL * kd : 0));
}

// Launch on `stream` of `device`; returns cudaGetLastError() after the
// launches (0 when they were accepted), or cudaErrorInvalidValue for
// arguments the kernel does not take.  Every pointer is device memory
// holding contiguous float32 (see Params for the shapes); pointers a mode
// does not use may be null.  layout: 0 flat, 1 frames.  `partials` holds
// B * M * ceil(g / 16) floats when emit_sum is set.
extern "C" int sdsp_pfb_f32(int layout, int mode, const float* xr,
                            const float* xi, long long ld, long long ld_m,
                            const float* taps_jm, const float* wct,
                            const float* wst, const float* dtaps,
                            const float* prev_r, const float* prev_i,
                            const float* ahist, float* out0, float* out1,
                            float* prev_r_out, float* prev_i_out,
                            float* ahist_out, float* partials, float* esum,
                            int B, int M, int K, int g, int gt, int kd,
                            int decim, int emit_sum, float gain, int device,
                            void* stream) {
  const bool dec = is_dec(mode);
  if (layout < 0 || layout > 1 || mode < kFm || mode > kChan || B < 1 ||
      M < 1 || M > 128 || (M & (M - 1)) || K < 1 || K > 32 || g < 1 ||
      gt < 1 ||
      (dec && (kd < 1 || decim < 1 || g % decim || gt % decim)) ||
      (emit_sum && (mode != kAmDec || gt % kSumChunk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{xr, xi, ld, ld_m, taps_jm, wct, wst, dtaps, prev_r, prev_i, ahist,
           out0, out1, prev_r_out, prev_i_out, ahist_out, partials,
           M, K, g, gt, dec ? kd : 1, dec ? decim : 1, mode, emit_sum, gain,
           __builtin_ctz(static_cast<unsigned>(M))};
  const long long smem = sdsp_pfb_smem_bytes(mode, M, K, p.kd, p.decim, gt);
  const dim3 grid((g + gt - 1) / gt, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    err = cudaFuncSetAttribute(pfb_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pfb_kernel<true><<<grid, kThreads, smem, st>>>(p);
  } else {
    err = cudaFuncSetAttribute(pfb_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    pfb_kernel<false><<<grid, kThreads, smem, st>>>(p);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || !emit_sum) return static_cast<int>(err);
  const int rows = B * M;
  const int nchunks = (g + kSumChunk - 1) / kSumChunk;
  sum_partials_kernel<<<(rows + 7) / 8, 256, 0, st>>>(partials, esum, rows,
                                                       nchunks);
  return static_cast<int>(cudaGetLastError());
}
