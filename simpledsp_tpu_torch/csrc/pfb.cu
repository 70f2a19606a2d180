// Polyphase filter-bank receiver kernel for Hopper (sm_90a): branch FIR ->
// M-point inverse FFT across branches -> FM discriminator / AM envelope ->
// optional polyphase audio decimator, one pass over the input per stream and
// tile.
//
// Replaces the TPU kernels of simpledsp_tpu/kernels/pfb.py:
//   flat layout   _make_flat_body   (reached through _run_flat: pfb_fm_flat,
//                                    pfb_am_flat; the receiver banks' path)
//   frames layout _make_packed_body (reached through _run_packed:
//                                    pfb_fm_frames, pfb_am_frames,
//                                    pfb_channelize_frames)
// The two layouts differ only in how a block reads its input.  Stream b's
// frame f, sample m (0 <= m < M) is
//   flat   element j = f * M + m of the stream [hist | x]: hist[b * ld_h + j]
//          below h, else x[b * ld + j - h]  (the carried history's (B, h)
//          planes and the call's (B, T) planes, each with its own row
//          stride: no prefixed copy of the stream exists)
//   frames x[b * ld + m * ld_m + f]  (channel-major (B, M, nfr) planes)
//
// Per output frame n and channel c, with taps_t[m, j] = h[j M + M-1-m] (the
// branch flip folded in, PFBOperators.taps_t):
//   1. branch FIR   u[n, m] = sum_{j<K} taps_t[m, j] x[n + K-1-j, m]
//   2. inverse DFT  y[n, c] = sum_r exp(+2 pi i c r / M) u[n, M-1-r]
//   3. demod        FM: d[n] = gain atan2(Im q, Re q), q = y[n] conj(y[n-1]),
//                       y[-1] = the carried (prev_r, prev_i)
//                   AM: d[n] = |y[n]|;  chan: write y itself
//   4. decimator    audio[t] = sum_{j<kd} h_d[j] ext[kd-1 + t decim - j],
//                   ext = [ahist (kd-1) | d], the new ahist = ext's last kd-1
//   5. emit_sum     (am_dec) the sum of d over the call's frames
//
// Parallel over time.  One block per (stream, tile of gt output frames)
// recomputes a halo of earlier frames (1 y frame for the FM carry, kd-1
// demod samples for the decimator) instead of receiving it from the previous
// tile; a halo frame before the call's first comes from the carried state.
// The recomputed values come from the same code on the same inputs, so the
// outputs do not depend on gt, bit for bit.
//
// What bounds it: at M = K = 16, kd = 64, decim = 4 a frame is 128 bytes of
// input against about 512 FIR FMAs, a 16-point FFT, 16 atan2 and 256
// decimator FMAs: at 16 x 2^20 samples about 40 us of device-memory reads
// against about 30 us of fp32 FMAs at the peak, so by the roofline bytes
// bound it.  In practice instruction issue does: atan2f alone (kept, no
// fast-math intrinsic) and the shuffles of the FFT cost more than the FMAs'
// count says.  The previous design read every operand from shared memory (a
// dense M x M DFT, a (tap, offset) table in the decimator: up to 2 shared
// loads an FMA, against the one load an SM issues for four FMAs), staged
// every intermediate there and took 25 % more frames for the halo.  This
// one keeps each stage near a quarter of a load an FMA or under, and the
// intermediates in registers:
//   input    the tile goes to shared memory by cp.async, 16 bytes a copy
//            where the address allows, the next round's frames in flight
//            while the current round computes (flat layout; the frames
//            layout keeps its transposing reader); the part of a tile that
//            lies in the history (the first tile's first h elements at
//            most) comes by 4-byte copies from hist, the rest from x;
//   FIR      a thread runs R consecutive frames of P branches (P = M / 32
//            above M = 32, else 1; R = 9, 4, 2): each tap brings one input
//            sample into a sliding register window, 3 loads for 2 R FMAs;
//   FFT      the branches of a frame lie on L = min(M, 32) lanes (and P
//            registers): a radix-2 decimation-in-frequency FFT, register
//            stages first, then log2 L stages of __shfl_xor_sync, one
//            twiddle load a stage for R frames; the branch flip is which
//            row a lane filters (order[0]), the output lands in bit-reversed
//            order (order[1] names each lane's channel);
//   demod    the FM conjugate product from the thread's own frames: an FM
//            group also computes the frame before its first (E = 1), so no
//            value crosses threads; d goes to shared memory once, [c][k];
//   decim    polyphase, a function of its own: an item is kQ consecutive
//            outputs of one channel and one phase; a register window
//            slides over that phase's samples of d, eight tap weights at a
//            time in two 16-byte loads (per-phase taps from the host,
//            dec_taps[ph][o]); the phases' partial sums are added in phase
//            order and stored a channel row at a time;
//   tiles    up to 1024 frames, chosen by the frames a tile computes per
//            output frame (kernels/pfb.py _tile): the kd-frame halo costs
//            about 13 % more frames at M = K = 16 instead of 25 %.
// Plain fp32 on the CUDA cores: no tensor cores, no TF32, no fast-math
// intrinsic (atan2f, sqrtf).  Every sum keeps one fixed order, so neither
// the tile nor the blocking changes a bit of the result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumChunk = 16;  // frames per emit_sum partial
constexpr int kQ = 9;          // decimator outputs per thread

enum Mode : int { kFm = 0, kFmDec = 1, kAm = 2, kAmDec = 3, kChan = 4 };

struct Params {
  const float* xr;
  const float* xi;
  long long ld;          // elements between streams
  long long ld_m;        // frames layout: elements between rows m
  const float* hist_r;   // flat layout: the history, (B, h) at row stride ld_h
  const float* hist_i;
  long long ld_h;
  int h;
  const float* fir_taps; // (K, M): [j][e], the taps of the row FFT input e reads
  const int* order;      // (2, M): [0][e] that row, [1][e] the channel output e holds
  const float2* tw;      // (log2 M, M): twiddle of FFT stage s at position e
  const float* dec_taps; // (decim, nph), 16-byte rows: [ph][o] = h_d[kd-1 - ph - decim o]
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
  int nph;               // row stride of dec_taps: ceil(kd / decim) to 4
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
// Branches a thread filters (P) and frames it runs (R).
__host__ __device__ constexpr int branches_per_thread(int M) {
  return M > 32 ? M / 32 : 1;
}
__host__ __device__ constexpr int frames_per_thread(int P) {
  return P == 1 ? 9 : P == 2 ? 4 : 2;
}

// Shared memory, in floats: the input tile (2 planes of frames of M, with
// slack that groups read and discard: a frame before the first, which the
// FM's extra frame reads at the tile's start, and R frames after the last;
// 4 floats to align each plane's copies with device memory), then d (2
// planes for chan, else 1), d[c][k] at channel stride dsc, with room past
// the tile's samples for the decimator's window to read ahead.  dsc is
// congruent to 32 / min(M, 32) mod 32, so that the min(M, 32) channels a
// warp writes or reads at one time fall on distinct banks.
struct Layout {
  long long x_plane, d_plane, total;
  int front, dsc;
};

__host__ __device__ inline Layout d_layout(int mode, int M, int K, int kd,
                                           int decim, int gt) {
  const int R = frames_per_thread(branches_per_thread(M));
  const int ny = gt + halo_before(mode, kd);
  const int nx = ny + K - 1;
  Layout s;
  s.front = (M + 3) & ~3;
  s.x_plane = (s.front + static_cast<long long>(nx + R) * M + 4 + 3) & ~3LL;
  const int lc = M < 32 ? M : 32;
  const int want = (32 / lc) & 31;
  const int base = ny + (kQ + 8) * decim;
  s.dsc = base + ((want - base % 32) % 32 + 32) % 32;
  s.d_plane = (static_cast<long long>(M) * s.dsc + kQ + 1 + 3) & ~3LL;
  s.total = 2 * s.x_plane + (mode == kChan ? 2 : 1) * s.d_plane;
  return s;
}

// The block's dynamic shared memory (see d_layout).
extern __shared__ float4 smem4[];

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(float* s, const float* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_async4(float* s, const float* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)),
               "l"(g));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Elements [e0, e1) of a tile plane: xs[e] <- src[e] (src is the device
// address of the tile's element 0, xs its shared copy, both congruent mod
// 16 bytes).  16-byte copies between a scalar head and tail.
__device__ __forceinline__ void copy_range(float* xs, const float* src, int e0,
                                           int e1) {
  const int tid = threadIdx.x;
  const int head = (4 - static_cast<int>((smem_addr(xs + e0) >> 2) & 3)) & 3;
  const int a = min(e1, e0 + head);
  const int nv = (e1 - a) >> 2;
  const int t = a + 4 * nv;
  for (int v = tid; v < nv; v += kThreads) {
    cp_async16(xs + a + 4 * v, src + a + 4 * v);
  }
  if (tid < a - e0) {
    cp_async4(xs + e0 + tid, src + e0 + tid);
  } else if (tid >= 32 && tid - 32 < e1 - t) {
    cp_async4(xs + t + tid - 32, src + t + tid - 32);
  }
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

// Branch FIR of input row m (taps column e of fir_taps) for frames
// i .. i + R-1 of the tile: the window w[r] holds frame i + r + K-1-j at
// tap j.  Reads frames up to i + R-1 + K-1.
template <int R>
__device__ __forceinline__ void fir(float2 (&acc)[R], const float* xr,
                                    const float* xi, const float* taps, int m,
                                    int e, int i, int K, int M) {
  float wr[R], wi[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = i + K - 1 + r;
    wr[r] = xr[f * M + m];
    wi[r] = xi[f * M + m];
    acc[r] = make_float2(0.f, 0.f);
  }
  // Unrolled so that the window's shifts are renamings and the next taps'
  // loads issue ahead of their FMAs.
#pragma unroll 4
  for (int j = 0; j < K; ++j) {
    const float t = __ldg(taps + j * M + e);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc[r].x = fmaf(t, wr[r], acc[r].x);
      acc[r].y = fmaf(t, wi[r], acc[r].y);
    }
    if (j + 1 < K) {
#pragma unroll
      for (int r = R - 1; r > 0; --r) {
        wr[r] = wr[r - 1];
        wi[r] = wi[r - 1];
      }
      const int f = i + K - 2 - j;
      wr[0] = xr[f * M + m];
      wi[0] = xi[f * M + m];
    }
  }
}

// A register stage of the FFT (half size h = 32 HP): positions e and e + h
// in registers p and p + HP of one lane.
template <int HP, int P, int R>
__device__ __forceinline__ void reg_stage(float2 (&v)[P][R],
                                          const float2* __restrict__ tw,
                                          int l) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    if (p & HP) continue;
    const int q = p + HP;
    const float2 w = __ldg(tw + l + 32 * q);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 a = v[p][r], b = v[q][r];
      v[p][r] = make_float2(a.x + b.x, a.y + b.y);
      v[q][r] = cmul(make_float2(a.x - b.x, a.y - b.y), w);
    }
  }
}

// The unscaled M-point inverse FFT of each of the thread's R frames, the
// frame's M values at positions e = l + L p (lane l of its L-lane group,
// register p).  Radix-2 decimation in frequency: the stage of half size h
// maps (a, b) at (e, e + h) to (a + b, (a - b) w), w = tw[s][e + h] =
// exp(+2 pi i (e mod h) / 2h); the top's table entry is 1.  Position e ends
// holding bin bitrev(e).  Every lane of the warp calls it.
template <int P, int R>
__device__ __forceinline__ void fft_lanes(float2 (&v)[P][R],
                                          const float2* __restrict__ tw, int M,
                                          int L, int l) {
  int s = 0;
  if constexpr (P == 4) {
    reg_stage<2>(v, tw, l);
    ++s;
  }
  if constexpr (P >= 2) {
    reg_stage<1>(v, tw + s * M, l);
    ++s;
  }
  for (int h = L >> 1; h >= 1; h >>= 1, ++s) {
    const float2 w = __ldg(tw + s * M + l);
    const float sg = (l & h) ? -1.f : 1.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float ox = __shfl_xor_sync(0xffffffffu, v[p][r].x, h);
        const float oy = __shfl_xor_sync(0xffffffffu, v[p][r].y, h);
        v[p][r] = cmul(make_float2(ox + sg * v[p][r].x, oy + sg * v[p][r].y),
                       w);
      }
    }
  }
}

// The decimator of one tile (stage decim of pfb_kernel), a function of its
// own so that its registers are allocated apart from the rounds'.  Output t
// of channel c is the sum over phases ph, in order, of the phase's partial
// sum over its taps o of dec_taps[ph][o] d[c][(t + o) decim + ph] (tap
// j = hd - ph - decim o reads demod sample t decim + hd - j).  An item is
// kQ consecutive outputs of one channel and one phase, the channel fastest:
// a warp's lanes read distinct banks.  The partials go to the input's space
// (dead since the rounds), [c][ph][t], then the phases are summed and
// stored a channel row at a time: out[c gd + t].  d lies at offset d_off of
// the dynamic shared memory, channel stride dsc.
__device__ __noinline__ void decimate(float* __restrict__ out,
                                      const float* __restrict__ dec_taps,
                                      int nph, int d_off, int dsc, int M,
                                      int lg_m, int decim, int hd, int nt,
                                      int gd) {
  float* smem = reinterpret_cast<float*>(smem4);
  const float* ds = smem + d_off;
  const int tid = threadIdx.x;
  const int ntb = (nt + kQ - 1) / kQ;
  const int ntp = nt | 1;
  for (int w = tid; w < M * decim * ntb; w += kThreads) {
    const int c = w & (M - 1), rest = w >> lg_m;
    const int ph = rest % decim, t0 = (rest / decim) * kQ;
    float acc[kQ];
#pragma unroll
    for (int u = 0; u < kQ; ++u) acc[u] = 0.f;
    if (ph <= hd) {
      const float* dr = ds + c * dsc + t0 * decim + ph;
      const float* hp = dec_taps + ph * nph;
      const int no = (hd - ph) / decim + 1;
      // The window holds rows o .. o + kQ + 6: eight taps a step, their
      // weights as two 16-byte loads, then the window moves eight rows; the
      // last taps (no % 8) move it one row each.
      float win[kQ + 7];
#pragma unroll
      for (int u = 0; u < kQ + 7; ++u) win[u] = dr[u * decim];
      int o = 0;
      for (; o + 8 <= no; o += 8) {
        const float4 h0 = __ldg(reinterpret_cast<const float4*>(hp + o));
        const float4 h1 = __ldg(reinterpret_cast<const float4*>(hp + o + 4));
        const float h[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int u = 0; u < kQ; ++u) acc[u] = fmaf(h[j], win[j + u], acc[u]);
        }
#pragma unroll
        for (int u = 0; u < kQ - 1; ++u) win[u] = win[u + 8];
#pragma unroll
        for (int j = 0; j < 8; ++j) win[kQ - 1 + j] = dr[(o + kQ + 7 + j) * decim];
      }
      for (; o < no; ++o) {
        const float h = __ldg(hp + o);
#pragma unroll
        for (int u = 0; u < kQ; ++u) acc[u] = fmaf(h, win[u], acc[u]);
#pragma unroll
        for (int u = 0; u < kQ + 6; ++u) win[u] = win[u + 1];
      }
    }
    float* dst = smem + (c * decim + ph) * ntp + t0;
#pragma unroll
    for (int u = 0; u < kQ; ++u) {
      if (t0 + u < nt) dst[u] = acc[u];
    }
  }
  __syncthreads();
  for (int c = 0; c < M; ++c) {
    const float* pc = smem + c * decim * ntp;
    for (int t = tid; t < nt; t += kThreads) {
      float a = pc[t];
      for (int ph = 1; ph < decim; ++ph) a += pc[ph * ntp + t];
      out[c * gd + t] = a;
    }
  }
}

// Stage-truncated builds (simpledsp_tpu_torch/tools/pfb_stages.py) define
// SDSP_PFB_CUT_AT = 1 .. 4: the kernel stops after the input (1), the FIR
// (2), the FFT (3) or the demod (4), the values computed so far kept live,
// and returns after the rounds.
#if defined(SDSP_PFB_CUT_AT)
#define SDSP_PFB_SINK(n)                                                  \
  if ((n) == SDSP_PFB_CUT_AT) {                                           \
    float s_ = 0.f;                                                       \
    for (int p_ = 0; p_ < P; ++p_) {                                      \
      for (int r_ = 0; r_ < R; ++r_) s_ += v[p_][r_].x + v[p_][r_].y;     \
    }                                                                     \
    if (s_ == 1.5e-30f) smem[tid] = s_;                                   \
    continue;                                                             \
  }
#else
#define SDSP_PFB_SINK(n)
#endif

// Two 256-thread blocks an SM: at most 128 registers a thread.
template <int P, bool kFlat, bool kFm>
__global__ void __launch_bounds__(kThreads, 2)
pfb_kernel(const Params p) {
  constexpr int R = frames_per_thread(P);
  constexpr int E = kFm ? 1 : 0;   // frames a group computes before its own
  float* smem = reinterpret_cast<float*>(smem4);
  const int M = p.M, K = p.K, mode = p.mode;
  const bool dec = is_dec(mode);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * p.gt;            // first output frame
  const int gc = min(p.gt, p.g - f0);          // output frames of this tile
  const int hd = dec ? p.kd - 1 : 0;           // demod halo
  const int hb = halo_before(mode, p.kd);      // y halo
  const int ny = gc + hb;                      // y frames: index i <-> f0-hb+i
  const int nx = ny + K - 1;                   // input frames, same origin
  const int a0 = f0 - hb;
  const int i0 = a0 < 0 ? -a0 : 0;             // first index at frame >= 0
  const Layout lay = d_layout(mode, M, K, p.kd, p.decim, p.gt);
  const int dsc = lay.dsc, decim = p.decim;
  const long long row = static_cast<long long>(b) * M;  // (b, c = 0)
  const int tid = threadIdx.x, lane = tid & 31;

  // The tile's element e (frame a0 + e / M) at xs[e].  Flat: it is stream
  // element gbase + e, from the history below h and from x at xo + e past
  // it; a plane's origin is shifted so that xs + e and x's address of e
  // agree mod 16 bytes (the history's elements go by 4-byte copies).
  const long long gbase = static_cast<long long>(a0) * M;
  const long long xo = kFlat ? gbase - p.h : 0;
  const float* gr = p.xr + b * p.ld;
  const float* gi = p.xi + b * p.ld;
  const int sr = kFlat ? static_cast<int>(
      ((reinterpret_cast<uintptr_t>(gr) >> 2) + xo) & 3) : 0;
  const int si = kFlat ? static_cast<int>(
      ((reinterpret_cast<uintptr_t>(gi) >> 2) + xo) & 3) : 0;
  float* xs_r = smem + lay.front + sr;
  float* xs_i = smem + lay.x_plane + lay.front + si;
  float* ds = smem + 2 * lay.x_plane;          // d, [c][k]
  float* ds_im = ds + lay.d_plane;             // chan: Im y

  const int L = M < 32 ? M : 32;               // lanes of a frame
  const int l = lane & (L - 1);
  const int gpr = kThreads / L;                // FIR groups a round
  const int F = gpr * R;                       // frames a round
  const int nrounds = (ny - i0 + F - 1) / F;
  // Round rd computes frames [i0 + rd F, i0 + (rd + 1) F) and reads input
  // frames below chunk_end(rd).
  auto chunk_end = [&](int rd) { return min(nx, i0 + (rd + 1) * F + K - 1); };
  // Tile elements [lo M, hi M) from x (past the history's end).
  auto copy_chunk = [&](int lo, int hi) {
    copy_range(xs_r, gr + xo, lo * M, hi * M);
    copy_range(xs_i, gi + xo, lo * M, hi * M);
  };
  if (kFlat) {
    // The first chunk holds every element the tile takes from the history
    // (e >= i0 M, so stream elements >= 0): those below the tile's element
    // h - gbase, which lies before the chunk's end unless the chunk is the
    // whole tile (the chunk spans F + K - 1 frames, F >= 2, and h < K M).
    // They go by 4-byte copies, the rest from x.
    const int e0 = i0 * M, e1 = chunk_end(0) * M;
    const int eh = -xo <= e0 ? e0 : -xo >= e1 ? e1 : static_cast<int>(-xo);
    const float* hsr = p.hist_r + b * p.ld_h + gbase;
    const float* hsi = p.hist_i + b * p.ld_h + gbase;
    for (int e = e0 + tid; e < eh; e += kThreads) {
      cp_async4(xs_r + e, hsr + e);
      cp_async4(xs_i + e, hsi + e);
    }
    copy_range(xs_r, gr + xo, eh, e1);
    copy_range(xs_i, gi + xo, eh, e1);
    cp_async_commit();
  } else {
    const int cnt = nx - i0;
    for (int e = tid; e < cnt * M; e += kThreads) {
      const int m = e / cnt, i = i0 + e % cnt;
      xs_r[i * M + m] = gr[m * p.ld_m + a0 + i];
      xs_i[i * M + m] = gi[m * p.ld_m + a0 + i];
    }
  }
  // Demod samples before the call come from the carried ahist.
  if (dec && f0 < hd) {
    const int nh = hd - f0;
    for (int e = tid; e < M * nh; e += kThreads) {
      const int c = e / nh, k = e - c * nh;
      ds[c * dsc + k] = p.ahist[(row + c) * hd + f0 + k];
    }
  }

  // The lane's FFT positions, the rows they filter, the channels they end on.
  int pos[P], xrow[P], chan[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    pos[q] = l + L * q;
    xrow[q] = __ldg(p.order + pos[q]);
    chan[q] = __ldg(p.order + M + pos[q]);
  }
  const int koff = dec ? hb - hd : hb;         // d index k = i - koff
  const bool last_tile = f0 + gc == p.g;

  for (int rd = 0; rd < nrounds; ++rd) {
    if (kFlat) {
      if (rd + 1 < nrounds) copy_chunk(chunk_end(rd), chunk_end(rd + 1));
      cp_async_commit();
      cp_async_wait1();
    }
    __syncthreads();
    const int grp = rd * gpr + tid / L;
    const int iv = i0 + grp * R;               // the group's first frame
    const bool live = iv < ny;
    const int i = live ? iv : i0;              // a dead group recomputes
#if defined(SDSP_PFB_CUT_AT) && SDSP_PFB_CUT_AT == 1
    continue;
#endif
    // v[q][E + r] holds frame i + r; FM also computes frame i - 1 in v[q][0],
    // the previous group's last, for the conjugate product.
    float2 v[P][E + R];
    // stage: fir
#pragma unroll
    for (int q = 0; q < P; ++q) {
      fir<E + R>(v[q], xs_r, xs_i, p.fir_taps, xrow[q], pos[q], i - E, K, M);
    }
    SDSP_PFB_SINK(2)
    // stage: fft
    fft_lanes<P, E + R>(v, p.tw, M, L, l);
    SDSP_PFB_SINK(3)
    // stage: demod
    if (!live) continue;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int c = chan[q];
      if (kFm && last_tile) {    // new FM carry: y of the call's last frame
        const int r = p.g - 1 - a0 - i;
#pragma unroll
        for (int rr = 0; rr < R; ++rr) {
          if (rr == r) {
            p.prev_r_out[row + c] = v[q][E + rr].x;
            p.prev_i_out[row + c] = v[q][E + rr].y;
          }
        }
      }
      int k = i - koff;
      float* dc = ds + c * dsc;
#pragma unroll
      for (int r = 0; r < R; ++r, ++k) {
        if (k < 0 || i + r >= ny) continue;
        const float2 y = v[q][E + r];
        if (mode == kChan) {
          dc[k] = y.x;
          ds_im[c * dsc + k] = y.y;
        } else if constexpr (kFm) {
          // The call's first frame follows the carried y.
          const float2 s = r == 0 && i == i0 && i0 > 0
              ? make_float2(p.prev_r[row + c], p.prev_i[row + c])
              : v[q][E + r - 1];
          const float dr = y.x * s.x + y.y * s.y;
          const float di = y.y * s.x - y.x * s.y;
          dc[k] = atan2f(di, dr) * p.gain;
        } else {
          dc[k] = sqrtf(y.x * y.x + y.y * y.y);
        }
      }
    }
  }
  __syncthreads();
#if defined(SDSP_PFB_CUT_AT)
  if (p.gain == 1.5e-30f) p.out0[tid] = ds[tid];   // keeps d live
  return;
#endif

  if (!dec) {
    // Full-rate outputs, channel-major: consecutive threads write
    // consecutive frames of one channel.
    for (int c = 0; c < M; ++c) {
      const long long o = (row + c) * p.g + f0;
      for (int n = tid; n < gc; n += kThreads) {
        p.out0[o + n] = ds[c * dsc + n];
        if (mode == kChan) p.out1[o + n] = ds_im[c * dsc + n];
      }
    }
    return;
  }

  const int nt = gc / decim;
  decimate(p.out0 + row * (p.g / decim) + f0 / decim, p.dec_taps, p.nph,
           static_cast<int>(ds - smem), dsc, M, p.lg_m, decim, hd, nt,
           p.g / decim);
  if (last_tile) {  // new ahist: the call's last kd-1 demod samples
    for (int e = tid; e < hd * M; e += kThreads) {
      const int c = e / hd, k = gc + e % hd;
      p.ahist_out[(row + c) * hd + e % hd] = ds[c * dsc + k];
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
        s += ds[c * dsc + hd + n];
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

template <int P, bool kFlat>
cudaError_t launch(const Params& p, dim3 grid, long long smem,
                   cudaStream_t st) {
  const auto kernel = is_fm(p.mode) ? pfb_kernel<P, kFlat, true>
                                    : pfb_kernel<P, kFlat, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, smem, st>>>(p);
  return cudaGetLastError();
}

template <bool kFlat>
cudaError_t launch_m(const Params& p, dim3 grid, long long smem,
                     cudaStream_t st) {
  if (p.M == 128) return launch<4, kFlat>(p, grid, smem, st);
  if (p.M == 64) return launch<2, kFlat>(p, grid, smem, st);
  return launch<1, kFlat>(p, grid, smem, st);
}

}  // namespace

// Shared memory of one block, in bytes, for tiles of gt frames.
extern "C" long long sdsp_pfb_smem_bytes(int mode, int M, int K, int kd,
                                         int decim, int gt) {
  const bool dec = is_dec(mode);
  return static_cast<long long>(sizeof(float)) *
         d_layout(mode, M, K, dec ? kd : 1, dec ? decim : 1, gt).total;
}

// Launch on `stream` of `device`; returns cudaGetLastError() after the
// launches (0 when they were accepted), or cudaErrorInvalidValue for
// arguments the kernel does not take.  Every pointer is device memory
// holding contiguous float32 (int32 for order; see Params for the shapes),
// but for the input planes' rows: x at stride ld and, flat, the history
// (h samples a stream) at stride ld_h; pointers a mode or layout does not
// use may be null.  layout: 0 flat, 1 frames.  `partials` holds
// B * M * ceil(g / 16) floats when emit_sum is set.
extern "C" int sdsp_pfb_f32(int layout, int mode, const float* xr,
                            const float* xi, long long ld, long long ld_m,
                            const float* hist_r, const float* hist_i,
                            long long ld_h, int h,
                            const float* fir_taps, const int* order,
                            const float* tw, const float* dec_taps,
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
      gt < 1 || h < 0 || (layout == 0 && h > 0 && (!hist_r || !hist_i)) ||
      (dec && (kd < 1 || decim < 1 || g % decim || gt % decim)) ||
      (emit_sum && (mode != kAmDec || gt % kSumChunk))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int kd_ = dec ? kd : 1, decim_ = dec ? decim : 1;
  Params p{xr, xi, ld, ld_m, hist_r, hist_i, ld_h, layout == 0 ? h : 0,
           fir_taps, order,
           reinterpret_cast<const float2*>(tw), dec_taps, prev_r, prev_i,
           ahist, out0, out1, prev_r_out, prev_i_out, ahist_out, partials,
           M, K, g, gt, kd_, decim_, mode, emit_sum, gain,
           __builtin_ctz(static_cast<unsigned>(M)),
           ((kd_ + decim_ - 1) / decim_ + 3) & ~3};
  const long long smem = sdsp_pfb_smem_bytes(mode, M, K, kd_, decim_, gt);
  const dim3 grid((g + gt - 1) / gt, B);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  err = layout == 0 ? launch_m<true>(p, grid, smem, st)
                    : launch_m<false>(p, grid, smem, st);
  if (err != cudaSuccess || !emit_sum) return static_cast<int>(err);
  const int rows = B * M;
  const int nchunks = (g + kSumChunk - 1) / kSumChunk;
  sum_partials_kernel<<<(rows + 7) / 8, 256, 0, st>>>(partials, esum, rows,
                                                       nchunks);
  return static_cast<int>(cudaGetLastError());
}
