// Batched frames FFT for Hopper (sm_90a): F frames of N complex (or real)
// float32 samples -> their N-point DFTs in natural bin order, forward or
// inverse, unscaled or scaled by 1/N, one read of the input and one write of
// the output.
//
// Replaces the TPU kernel simpledsp_tpu/kernels/fft.py:_fft_frames (body
// _make_kernel), which the FFT engine (ops/fft._fft_ri) reaches for every
// float32 transform of n = 128 m, 2 <= m <= 128: rfft / irfft packing, dct,
// hilbert, Bluestein's convolutions, stft / istft, the 2-D transforms and the
// radar's range and Doppler FFTs.
//
// The TPU kernel runs the four-step split N = n1 n2 as two dense DFT matmuls
// for its matrix unit (8 N (n1 + n2) flops a frame, 8.4 MFLOP at N = 4096),
// then leaves the bins in a (k1, frame, k2) layout that the host transposes,
// a Mosaic workaround.  On the card's CUDA cores this kernel runs a
// mixed-radix Stockham FFT on the frame in shared memory instead (about
// 5 N log2 N flops, 0.25 MFLOP at N = 4096) and writes natural order itself:
//
//   - the odd prime factors of N (3, 5, 7, ... 127) each take a direct
//     small-DFT pass: an elementwise twiddle, then every output is the sum of
//     its r inputs times exp(-2 pi i q m / r) from a table;
//   - the powers of two take radix-4 passes and, for an odd power, one
//     radix-2 pass last.
//
// The pass of radix r and stride ns (the product of the earlier radices)
// reads s[j + q N / r], q < r, twiddles them by exp(-2 pi i q k / (r ns)),
// k = j mod ns, and writes the r-point DFT to s[(j - k) r + k + m ns]: the
// Stockham autosort order, so the last pass leaves bin k at s[k].  The values
// of a pass travel through registers, each thread holding at most kEPT of
// them, so one shared buffer serves both sides.  The inverse runs as
// conj(FFT(conj(x))): the imaginary plane is negated on load and on store.
// Twiddles and small-DFT tables are float32 tables built in float64 on the
// host with exact integer phases, read through the read-only cache; no
// fast-math intrinsic is used.  Real input (no imaginary plane) reads zeros.
//
// Frames are read in place with an element stride and a row stride for each
// plane, so rfft_ri's even and odd samples (x[..., 0::2], x[..., 1::2]) are
// read where they lie.  A block holds kBlockElems samples: one frame when
// N >= 4096, else 4096 / N frames, so that every block has 256 threads of
// work.  N = 16384 needs 128 KB of shared memory, above the 48 KB default,
// hence the opt-in on every launch.
//
// Index arithmetic: a thread's butterfly w of a pass lies in frame
// f = w / q at j = w mod q, with k = j mod ns.  Run-time integer division
// costs about 20 instructions, more than a butterfly's arithmetic, so the
// quotients come from float reciprocals the host computes (exact below
// 2^22, see fdiv), and each butterfly's indices are computed once and kept
// in registers across the pass's barrier.  Each block size is its own
// instance with its own launch bound: the 256-thread one (N <= 4096) keeps
// two blocks an SM, the 1024-thread one (N = 16384) is held to 64
// registers.  A thread issues all its frame loads before it stores the
// first to shared memory.
//
// What bounds it: at N = 4096 a complex frame is about 0.25 MFLOP against
// 32 KB read and 32 KB written, about 8 flops a byte, under the card's 20
// (67 TFLOP/s over 3.35 TB/s): device memory is the bound.  The kernel
// reaches it only if its six shared-memory passes, each between two
// barriers, keep up; the design keeps the passes' reads and the frame's
// loads and stores contiguous across a warp.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxN = 16384;        // 16384 complex float32 = 128 KB
constexpr int kMaxPasses = 24;
constexpr int kEPT = 16;            // values a thread holds through a pass
constexpr int kBlockElems = 4096;   // samples a block holds when N < 4096

struct Plan {
  int n;
  int npass;
  float rn;                // 1 / n
  int radix[kMaxPasses];
  int ns[kMaxPasses];      // product of the earlier radices
  float rns[kMaxPasses];   // 1 / ns
  int q[kMaxPasses];       // n / radix: butterflies a frame
  float rq[kMaxPasses];    // 1 / q
  int tw[kMaxPasses];      // offset of the pass's (r - 1) ns twiddles
  int dft[kMaxPasses];     // offset of the r-point DFT table (odd r)
};

struct Frames {
  const float* xr;
  const float* xi;         // null: real input
  long long rs_r, es_r;    // row and element strides of xr
  long long rs_i, es_i;    // of xi
  int frames;
};

// floor(x / d) for 0 <= x < 2^22 and d >= 1, given rd = 1 / d rounded to
// float: (x + 0.5) / d lies at least 0.5 / d from an integer, and the two
// roundings move the product by at most (x + 0.5) / d * 2^-23 < 0.5 / d.
__device__ __forceinline__ int fdiv(int x, float rd) {
  return __float2int_rz((static_cast<float>(x) + 0.5f) * rd);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ void radix4(float2 (&v)[4]) {
  const float2 a0 = make_float2(v[0].x + v[2].x, v[0].y + v[2].y);
  const float2 a1 = make_float2(v[0].x - v[2].x, v[0].y - v[2].y);
  const float2 a2 = make_float2(v[1].x + v[3].x, v[1].y + v[3].y);
  // (v1 - v3) times -i
  const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);
  v[0] = make_float2(a0.x + a2.x, a0.y + a2.y);
  v[2] = make_float2(a0.x - a2.x, a0.y - a2.y);
  v[1] = make_float2(a1.x + a3.x, a1.y + a3.y);
  v[3] = make_float2(a1.x - a3.x, a1.y - a3.y);
}

// One radix-4 pass over the `total` values of the block's frames (n each):
// butterfly w reads s[f n + j + r q], r < 4, and writes
// s[f n + (j - k) 4 + k + m ns], m < 4.  The caller synchronises before;
// the pass ends synchronised.
__device__ void pass4(float2* s, const float2* __restrict__ tw, const Plan& pl,
                      int p, int total) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = pl.n, ns = pl.ns[p], q = pl.q[p];
  const float rq = pl.rq[p], rns = pl.rns[p];
  const int nb = total >> 2;
  float2 v[kEPT / 4][4];
  int dst[kEPT / 4];
#pragma unroll
  for (int b = 0; b < kEPT / 4; ++b) {
    const int w = tid + b * nt;
    if (w < nb) {
      const int f = fdiv(w, rq);
      const int j = w - f * q;
      const int k = j - fdiv(j, rns) * ns;
      const float2* sf = s + f * n + j;
#pragma unroll
      for (int r = 0; r < 4; ++r) v[b][r] = sf[r * q];
      if (ns > 1) {
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          v[b][r] = cmul(v[b][r], __ldg(tw + (r - 1) * ns + k));
        }
      }
      radix4(v[b]);
      dst[b] = f * n + (j - k) * 4 + k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kEPT / 4; ++b) {
    if (tid + b * nt < nb) {
      float2* d = s + dst[b];
#pragma unroll
      for (int r = 0; r < 4; ++r) d[r * ns] = v[b][r];
    }
  }
  __syncthreads();
}

// One radix-2 pass; as pass4.
__device__ void pass2(float2* s, const float2* __restrict__ tw, const Plan& pl,
                      int p, int total) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = pl.n, ns = pl.ns[p], q = pl.q[p];
  const float rq = pl.rq[p], rns = pl.rns[p];
  const int nb = total >> 1;
  float2 v[kEPT / 2][2];
  int dst[kEPT / 2];
#pragma unroll
  for (int b = 0; b < kEPT / 2; ++b) {
    const int w = tid + b * nt;
    if (w < nb) {
      const int f = fdiv(w, rq);
      const int j = w - f * q;
      const int k = j - fdiv(j, rns) * ns;
      const float2* sf = s + f * n + j;
      const float2 v0 = sf[0];
      float2 v1 = sf[q];
      if (ns > 1) v1 = cmul(v1, __ldg(tw + k));
      v[b][0] = make_float2(v0.x + v1.x, v0.y + v1.y);
      v[b][1] = make_float2(v0.x - v1.x, v0.y - v1.y);
      dst[b] = f * n + (j - k) * 2 + k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kEPT / 2; ++b) {
    if (tid + b * nt < nb) {
      float2* d = s + dst[b];
      d[0] = v[b][0];
      d[ns] = v[b][1];
    }
  }
  __syncthreads();
}

// One direct pass of an odd radix r: the twiddles applied in place, then
// output m of butterfly j is sum_q s[j + q n / r] W[(q m) mod r], W the
// r-point DFT table.  A thread computes outputs o = m (n / r) + j, so a
// warp reads consecutive inputs and one table entry.
__device__ void pass_odd(float2* s, const float2* __restrict__ tw,
                         const float2* __restrict__ W, const Plan& pl, int p,
                         int total) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r = pl.radix[p], n = pl.n, ns = pl.ns[p], q = pl.q[p];
  const float rn = pl.rn, rq = pl.rq[p], rns = pl.rns[p];
  if (ns > 1) {
    for (int e = tid; e < total; e += nt) {
      const int t = e - fdiv(e, rn) * n;
      const int qi = fdiv(t, rq);
      if (qi > 0) {
        const int j = t - qi * q;
        const int k = j - fdiv(j, rns) * ns;
        s[e] = cmul(s[e], __ldg(tw + (qi - 1) * ns + k));
      }
    }
    __syncthreads();
  }
  float2 out[kEPT];
  int dst[kEPT];
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int w = tid + i * nt;
    if (w < total) {
      const int f = fdiv(w, rn);
      const int o = w - f * n;
      const int m = fdiv(o, rq);
      const int j = o - m * q;
      const float2* sf = s + f * n + j;
      float2 acc = sf[0];
      int idx = m;
      for (int qq = 1; qq < r; ++qq) {
        const float2 x = sf[qq * q];
        const float2 wv = __ldg(W + idx);
        acc.x += x.x * wv.x - x.y * wv.y;
        acc.y += x.x * wv.y + x.y * wv.x;
        idx += m;
        if (idx >= r) idx -= r;
      }
      out[i] = acc;
      const int k = j - fdiv(j, rns) * ns;
      dst[i] = f * n + (j - k) * r + k + m * ns;
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    if (tid + i * nt < total) s[dst[i]] = out[i];
  }
  __syncthreads();
}

// A 256-thread block is held to 128 registers, so two fit an SM.
template <int kThreads>
__global__ void __launch_bounds__(kThreads, kThreads == 256 ? 2 : 1)
fft_frames_kernel(Frames src, Plan plan, const float2* __restrict__ tab,
                  float* __restrict__ yr, float* __restrict__ yi, int fpb,
                  float sgn, float scale) {
  extern __shared__ float2 s[];
  const int n = plan.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * fpb;
  const int nf = static_cast<int>(
      min(static_cast<long long>(fpb), src.frames - g0));
  const int total = nf * n;
  // Every load of the thread is issued before the first is used, so the
  // device-memory latency is paid once a block, not once an element.
  float re[kEPT], im[kEPT];
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int e = tid + i * nt;
    if (e < total) {
      const int f = fdiv(e, plan.rn);
      const long long t = e - f * n;
      const long long g = g0 + f;
      re[i] = __ldg(src.xr + g * src.rs_r + t * src.es_r);
      im[i] = src.xi != nullptr ? __ldg(src.xi + g * src.rs_i + t * src.es_i)
                                : 0.0f;
    }
  }
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int e = tid + i * nt;
    if (e < total) s[e] = make_float2(re[i], sgn * im[i]);
  }
  __syncthreads();
  for (int p = 0; p < plan.npass; ++p) {
    const int r = plan.radix[p];
    if (r == 4) {
      pass4(s, tab + plan.tw[p], plan, p, total);
    } else if (r == 2) {
      pass2(s, tab + plan.tw[p], plan, p, total);
    } else {
      pass_odd(s, tab + plan.tw[p], tab + plan.dft[p], plan, p, total);
    }
  }
  const long long base = g0 * n;
  const float iscale = sgn * scale;
  for (int e = tid; e < total; e += nt) {
    const float2 v = s[e];
    yr[base + e] = v.x * scale;
    yi[base + e] = v.y * iscale;
  }
}

template <int kThreads>
cudaError_t launch(const Frames& src, const Plan& plan, const float2* tab,
                   float* yr, float* yi, int fpb, float sgn, float scale,
                   int blocks, int threads, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      fft_frames_kernel<kThreads>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  fft_frames_kernel<kThreads><<<blocks, threads, smem, stream>>>(
      src, plan, tab, yr, yi, fpb, sgn, scale);
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  Frame g of xr is xr[g rs_r + t es_r],
// t < n, likewise xi (null for real input).  radices[0..npass) is the pass
// plan, its product n, in the order the table was built: for each pass the
// (r - 1) ns twiddles exp(-2 pi i q k / (r ns)), laid out [q - 1][k], then,
// for a radix other than 2 and 4, the r values exp(-2 pi i t / r); (re, im)
// float32 pairs.  yr and yi are (frames, n) float32, bins in natural order.
// inverse conjugates the transform; scale multiplies the output by 1 / n.
extern "C" int sdsp_fft_frames_f32(const float* xr, const float* xi,
                                   long long rs_r, long long es_r,
                                   long long rs_i, long long es_i, int frames,
                                   int n, const int* radices, int npass,
                                   const float* tab, float* yr, float* yi,
                                   int inverse, int scale, int device,
                                   void* stream) {
  if (n < 1 || n > kMaxN || npass < 0 || npass > kMaxPasses || frames < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan plan{};
  plan.n = n;
  plan.npass = npass;
  plan.rn = 1.0f / static_cast<float>(n);
  int ns = 1, off = 0;
  for (int p = 0; p < npass; ++p) {
    const int r = radices[p];
    if (r < 2 || n % (ns * r) != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    plan.radix[p] = r;
    plan.ns[p] = ns;
    plan.rns[p] = 1.0f / static_cast<float>(ns);
    plan.q[p] = n / r;
    plan.rq[p] = 1.0f / static_cast<float>(n / r);
    plan.tw[p] = off;
    off += (r - 1) * ns;
    plan.dft[p] = off;
    if (r != 2 && r != 4) off += r;
    ns *= r;
  }
  if (ns != n) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const int fpb = n >= kBlockElems ? 1 : kBlockElems / n;
  const int elems = fpb * n;
  int threads = (elems + kEPT - 1) / kEPT;
  threads = ((threads + 31) / 32) * 32;
  const int smem = elems * static_cast<int>(sizeof(float2));
  const Frames src{xr, xi, rs_r, es_r, rs_i, es_i, frames};
  const int blocks = (frames + fpb - 1) / fpb;
  const auto* t2 = reinterpret_cast<const float2*>(tab);
  const float sgn = inverse ? -1.0f : 1.0f;
  const float sc = scale ? 1.0f / static_cast<float>(n) : 1.0f;
  const auto st = static_cast<cudaStream_t>(stream);
  if (threads <= 256) {
    err = launch<256>(src, plan, t2, yr, yi, fpb, sgn, sc, blocks, threads,
                      smem, st);
  } else if (threads <= 512) {
    err = launch<512>(src, plan, t2, yr, yi, fpb, sgn, sc, blocks, threads,
                      smem, st);
  } else {
    err = launch<1024>(src, plan, t2, yr, yi, fpb, sgn, sc, blocks, threads,
                       smem, st);
  }
  return static_cast<int>(err);
}
