// Block-level FFT core for Hopper (sm_90a), shared by the frames FFT kernel
// (fft.cu) and the chain kernel's half spectrum (chain.cu).
//
// fft_block transforms, in place in one shared-memory buffer, the `total`
// complex float32 values of a block's frames of n points each (frame f at
// [f n, f n + n)), forward, bins in natural order.  The buffer is two planes,
// re and im, indexed through swz (below).
//
// The transform is a mixed-radix Stockham FFT run as a few register passes.
// The pass of radix r and stride ns (the product of the earlier radices),
// q = n / r, has one butterfly for each j < q: it reads s[j + t q], t < r,
// twiddles them by exp(-2 pi i t k / (r ns)), k = j mod ns, runs the r-point
// DFT and writes s[(j - k) r + k + m ns], m < r; the last pass leaves bin k
// at s[k].  The powers of two take radix-16 passes in registers, each
// thread one butterfly of 16 values at a time, and one pass of 8, 4 or 2 for
// what is left (n = 4096 = 16 16 16: three passes and two exchanges;
// 2048 = 16 16 8; 16384 = 16 16 16 4); the r-point DFT of a power of two
// runs in registers as 4 x 4 (16) or 2 x 4 (8) with constant twiddles.  An
// odd prime factor (3 ... 127) takes a table-driven small-DFT pass: the
// twiddles applied in place, then every output is the sum of its r inputs
// times exp(-2 pi i t m / r), inputs t and r - t taken as a pair.  The odd
// passes come first.
//
// Values cross a pass in registers, at most kEPT a thread, so one buffer
// serves both sides: every thread reads, the block synchronises, every
// thread writes, the block synchronises.  The first pass reads through a
// functor and the last writes through one, so a caller hands the core its
// data where it lies (device memory, another layout in shared memory) and
// takes the bins where it wants them.
//
// Bank conflicts: for a power-of-two n the buffer index p is swizzled,
// p ^ g(p >> 5), g taking the low four bits of the 32-word row and its
// bit 3 into bit 4 (swz).  A pass
// reads 32 consecutive p a warp (conflict-free under any XOR within the
// row); the first pass writes at a stride of r (16 j + m), the second of a
// radix-16 plan in runs of 16 (256 a + 16 m + k): g spreads both over all 32
// banks.  Every power-of-two n >= 256 runs with no conflict
// (tests/test_torch_fft.py simulates each warp's accesses); n < 256 and odd
// factors, which run unswizzled (swz_mask), may see conflicts.
//
// Twiddles and small-DFT tables are float32 tables built in float64 on the
// host with exact integer phases (kernels/fft.py), read through the
// read-only cache; the radix-8 and radix-16 constants are float32
// roundings of cos(pi / 8), sin(pi / 8) and sqrt(1/2).  No fast-math
// intrinsic is used.
//
// Index arithmetic: run-time integer division costs about 20 instructions,
// more than a butterfly's arithmetic, so the quotients come from float
// reciprocals the host computes (exact below 2^22, see fdiv).

#pragma once

#include <cuda_runtime.h>

namespace sdsp_fft {

constexpr int kMaxN = 16384;        // 16384 complex float32 = 128 KB
constexpr int kMaxPasses = 24;

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

// Fills `pl` for an n-point transform from the radices in the order of the
// table (kernels/fft.py _plan and _kernel_table_f64): for each pass the
// (r - 1) ns twiddles, laid out [t - 1][k], then, for an odd r, the r values
// exp(-2 pi i t / r).  Returns false unless every radix is 2, 4, 8, 16 or
// odd and their product is n <= kMaxN.
inline bool make_plan(int n, const int* radices, int npass, Plan* pl) {
  if (n < 1 || n > kMaxN || npass < 0 || npass > kMaxPasses) return false;
  *pl = Plan{};
  pl->n = n;
  pl->npass = npass;
  pl->rn = 1.0f / static_cast<float>(n);
  int ns = 1, off = 0;
  for (int p = 0; p < npass; ++p) {
    const int r = radices[p];
    const bool pow2 = r == 2 || r == 4 || r == 8 || r == 16;
    if (r < 2 || (!pow2 && r % 2 == 0) || n % (ns * r) != 0) return false;
    pl->radix[p] = r;
    pl->ns[p] = ns;
    pl->rns[p] = 1.0f / static_cast<float>(ns);
    pl->q[p] = n / r;
    pl->rq[p] = 1.0f / static_cast<float>(n / r);
    pl->tw[p] = off;
    off += (r - 1) * ns;
    pl->dft[p] = off;
    if (!pow2) off += r;
    ns *= r;
  }
  return ns == n;
}

// One pass of a plan, as its functions take it: by value, so that a pass
// compiled on its own (see fft_block) never takes the plan's address.
struct Pass {
  int r, n, ns, q;
  float rn, rq, rns;
  const float2* tw;        // the pass's (r - 1) ns twiddles
  const float2* W;         // the r-point DFT table (odd r)
};

// floor(x / d) for 0 <= x < 2^22 and d >= 1, given rd = 1 / d rounded to
// float: (x + 0.5) / d lies at least 0.5 / d from an integer, and the two
// roundings move the product by at most (x + 0.5) / d * 2^-23 < 0.5 / d.
__device__ __forceinline__ int fdiv(int x, float rd) {
  return __float2int_rz((static_cast<float>(x) + 0.5f) * rd);
}

// The swizzled buffer index of p: a permutation within each row of 32
// (mask 31), or p itself (mask 0).  Planes hold the values' count rounded
// up to a multiple of 32.
__host__ __device__ __forceinline__ int swz(int p, int mask) {
  const int r = p >> 5;
  return p ^ (((r & 15) | ((r & 8) << 1)) & mask);
}

// The swizzle mask for an n-point transform: the swizzle spreads the
// strides of power-of-two plans over the banks; an odd factor's strides
// it does not, and there its index arithmetic only costs time (n = 100
// and 1152 ran slower swizzled on the H100).
__host__ __device__ __forceinline__ int swz_mask(int n) {
  return (n & (n - 1)) == 0 ? 31 : 0;
}

__host__ __device__ constexpr int round32(int n) { return (n + 31) & ~31; }

// The block's dynamic shared memory.  The core addresses its buffers by
// offsets into it: a pointer handed to a separately compiled pass would be
// a generic one, each access a generic load or store, where an offset from
// this array keeps every access a shared-memory instruction.
extern __shared__ float4 fft_smem4[];

__device__ __forceinline__ float* dyn_smem() {
  return reinterpret_cast<float*>(fft_smem4);
}

// The block's buffer: two planes of float32 at offsets re and im of the
// dynamic shared memory, indexed through swz with the mask kMask
// (swz_mask: a compile-time mask costs no arithmetic where it is 0).
template <int kMask>
struct Planes {
  int re;
  int im;
  __device__ __forceinline__ float2 operator()(int p) const {
    const float* b = dyn_smem();
    const int i = swz(p, kMask);
    return make_float2(b[re + i], b[im + i]);
  }
  __device__ __forceinline__ void put(int p, float2 v) const {
    float* b = dyn_smem();
    const int i = swz(p, kMask);
    b[re + i] = v.x;
    b[im + i] = v.y;
  }
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}

constexpr float kC1 = 0.92387953251128674f;   // cos(pi / 8)
constexpr float kS1 = 0.38268343236508977f;   // sin(pi / 8)
constexpr float kH = 0.70710678118654752f;    // sqrt(1 / 2)

// v exp(-2 pi i e / 16).  e is a constant once the callers' loops are
// unrolled, so the switch folds to the one case; the multiples of 4 cost no
// multiplication.
__device__ __forceinline__ float2 rot16(float2 v, int e) {
  const float x = v.x, y = v.y;
  switch (e & 15) {
    case 0: return v;
    case 1: return make_float2(x * kC1 + y * kS1, y * kC1 - x * kS1);
    case 2: return make_float2((x + y) * kH, (y - x) * kH);
    case 3: return make_float2(x * kS1 + y * kC1, y * kS1 - x * kC1);
    case 4: return make_float2(y, -x);
    case 5: return make_float2(y * kC1 - x * kS1, -(x * kC1 + y * kS1));
    case 6: return make_float2((y - x) * kH, -(x + y) * kH);
    case 7: return make_float2(y * kS1 - x * kC1, -(x * kS1 + y * kC1));
    case 8: return make_float2(-x, -y);
    case 9: return make_float2(-(x * kC1 + y * kS1), x * kS1 - y * kC1);
    case 10: return make_float2(-(x + y) * kH, (x - y) * kH);
    case 11: return make_float2(-(x * kS1 + y * kC1), x * kC1 - y * kS1);
    case 12: return make_float2(-y, x);
    case 13: return make_float2(x * kS1 - y * kC1, x * kC1 + y * kS1);
    case 14: return make_float2((x - y) * kH, (x + y) * kH);
    default: return make_float2(x * kC1 - y * kS1, x * kS1 + y * kC1);
  }
}

template <int R>
__device__ __forceinline__ void dft(float2 (&v)[R]);

template <>
__device__ __forceinline__ void dft<2>(float2 (&v)[2]) {
  const float2 a = v[0];
  v[0] = cadd(a, v[1]);
  v[1] = csub(a, v[1]);
}

template <>
__device__ __forceinline__ void dft<4>(float2 (&v)[4]) {
  const float2 a0 = cadd(v[0], v[2]);
  const float2 a1 = csub(v[0], v[2]);
  const float2 a2 = cadd(v[1], v[3]);
  // (v1 - v3) times -i
  const float2 a3 = make_float2(v[1].y - v[3].y, v[3].x - v[1].x);
  v[0] = cadd(a0, a2);
  v[2] = csub(a0, a2);
  v[1] = cadd(a1, a3);
  v[3] = csub(a1, a3);
}

// The R = A B point DFT: t = B t1 + t2, k = k1 + A k2; an A-point DFT over
// t1 for each t2, the twiddle exp(-2 pi i t2 k1 / R), a B-point DFT over t2
// for each k1.
template <int A, int B>
__device__ __forceinline__ void dft_split(float2 (&v)[A * B]) {
  constexpr int R = A * B;
  float2 u[B][A];
#pragma unroll
  for (int t2 = 0; t2 < B; ++t2) {
#pragma unroll
    for (int t1 = 0; t1 < A; ++t1) u[t2][t1] = v[B * t1 + t2];
    dft<A>(u[t2]);
  }
#pragma unroll
  for (int k1 = 0; k1 < A; ++k1) {
    float2 w[B];
#pragma unroll
    for (int t2 = 0; t2 < B; ++t2) {
      w[t2] = rot16(u[t2][k1], t2 * k1 * (16 / R));
    }
    dft<B>(w);
#pragma unroll
    for (int k2 = 0; k2 < B; ++k2) v[k1 + A * k2] = w[k2];
  }
}

template <>
__device__ __forceinline__ void dft<8>(float2 (&v)[8]) {
  dft_split<2, 4>(v);
}

template <>
__device__ __forceinline__ void dft<16>(float2 (&v)[16]) {
  dft_split<4, 4>(v);
}

// One power-of-two pass of radix R over the block's `total` values; each
// thread holds kEPT / R butterflies.  Reads through `src`, writes through
// `out`.  The caller synchronises before; the pass ends synchronised.
template <int R, int kEPT, class Src, class Dst>
__device__ __noinline__ void pass_pow2(Src src, Dst out, Pass ps, int total) {
  constexpr int kB = kEPT / R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = ps.n, ns = ps.ns, q = ps.q;
  const float rq = ps.rq, rns = ps.rns;
  const float2* __restrict__ tw = ps.tw;
  const int nb = total / R;
  float2 v[kB][R];
  int dst[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int w = tid + b * nt;
    if (w < nb) {
      const int f = fdiv(w, rq);
      const int j = w - f * q;
      const int k = ns == 1 ? 0 : j - fdiv(j, rns) * ns;
      const int s0 = f * n + j;
#pragma unroll
      for (int t = 0; t < R; ++t) v[b][t] = src(s0 + t * q);
      if (ns > 1) {
#pragma unroll
        for (int t = 1; t < R; ++t) {
          v[b][t] = cmul(v[b][t], __ldg(tw + (t - 1) * ns + k));
        }
      }
      dft<R>(v[b]);
      dst[b] = f * n + (j - k) * R + k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (tid + b * nt < nb) {
#pragma unroll
      for (int m = 0; m < R; ++m) out.put(dst[b] + m * ns, v[b][m]);
    }
  }
  __syncthreads();
}

// The radix-16 pass: each butterfly's 16 values are read, twiddled and
// put through the first radix-4 stage a quarter at a time (t = 4 t1 + t2
// for one t2), then the second radix-4 stage runs over the quarters
// (dft_split's order, with the twiddles applied as the values arrive).
template <int kEPT, class Src, class Dst>
__device__ __noinline__ void pass16(Src src, Dst out, Pass ps, int total) {
  constexpr int kB = kEPT / 16;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = ps.n, ns = ps.ns, q = ps.q;
  const float2* __restrict__ tw = ps.tw;
  const int nb = total / 16;
  float2 v[kB][16];
  int dst[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int w = tid + b * nt;
    if (w < nb) {
      const int f = fdiv(w, ps.rq);
      const int j = w - f * q;
      const int k = ns == 1 ? 0 : j - fdiv(j, ps.rns) * ns;
      const int s0 = f * n + j;
      float2 u[4][4];
#pragma unroll
      for (int t2 = 0; t2 < 4; ++t2) {
#pragma unroll
        for (int t1 = 0; t1 < 4; ++t1) {
          const int t = 4 * t1 + t2;
          u[t2][t1] = src(s0 + t * q);
          if (ns > 1 && t > 0) {
            u[t2][t1] = cmul(u[t2][t1], __ldg(tw + (t - 1) * ns + k));
          }
        }
        dft<4>(u[t2]);
      }
#pragma unroll
      for (int k1 = 0; k1 < 4; ++k1) {
        float2 x[4];
#pragma unroll
        for (int t2 = 0; t2 < 4; ++t2) x[t2] = rot16(u[t2][k1], t2 * k1);
        dft<4>(x);
#pragma unroll
        for (int k2 = 0; k2 < 4; ++k2) v[b][k1 + 4 * k2] = x[k2];
      }
      dst[b] = f * n + (j - k) * 16 + k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (tid + b * nt < nb) {
#pragma unroll
      for (int m = 0; m < 16; ++m) out.put(dst[b] + m * ns, v[b][m]);
    }
  }
  __syncthreads();
}

// Adds the inputs t and r - t of an odd-radix butterfly's output m to e:
// with w = exp(-2 pi i t m / r), x_t w + x_{r-t} conj(w) is
// (a.re w.re - b.im w.im, a.im w.re + b.re w.im), a = x_t + x_{r-t},
// b = x_t - x_{r-t}.
__device__ __forceinline__ void pair_term(float2& e, float2 p, float2 n,
                                          float2 w) {
  e.x += (p.x + n.x) * w.x - (p.y - n.y) * w.y;
  e.y += (p.y + n.y) * w.x + (p.x - n.x) * w.y;
}

// One pass of an odd radix r: the twiddles applied in place (ns > 1, so
// never the first pass), then output m of butterfly j is
// sum_t src[j + t q] W[(t m) mod r], W the r-point DFT table, summed as
// x_0 and the (r - 1) / 2 pairs t, r - t (pair_term: half the products and
// one table entry a pair), alternately into two sums, which halves both the
// chain of dependent adds and the terms each sum rounds.  A thread computes
// outputs o = m q + j, so a warp reads consecutive inputs and one table
// entry.
template <int kEPT, class Buf, class Src, class Dst>
__device__ __noinline__ void pass_odd(Buf s, Src src, Dst out, Pass ps,
                                      int total) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int r = ps.r, n = ps.n, ns = ps.ns, q = ps.q;
  const float rn = ps.rn, rq = ps.rq, rns = ps.rns;
  const float2* __restrict__ tw = ps.tw;
  const float2* __restrict__ W = ps.W;
  if (ns > 1) {
    for (int e = tid; e < total; e += nt) {
      const int t = e - fdiv(e, rn) * n;
      const int qi = fdiv(t, rq);
      if (qi > 0) {
        const int j = t - qi * q;
        const int k = j - fdiv(j, rns) * ns;
        s.put(e, cmul(s(e), __ldg(tw + (qi - 1) * ns + k)));
      }
    }
    __syncthreads();
  }
  float2 acc[kEPT];
  int dst[kEPT];
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int w = tid + i * nt;
    if (w < total) {
      const int f = fdiv(w, rn);
      const int o = w - f * n;
      const int m = fdiv(o, rq);
      const int j = o - m * q;
      const int k = j - fdiv(j, rns) * ns;
      const int s0 = f * n + j;
      dst[i] = f * n + (j - k) * r + k + m * ns;
      const int h = r >> 1;
      float2 e0 = src(s0), e1 = make_float2(0.f, 0.f);
      int idx = m;                      // (t m) mod r
      int t = 1;
      for (; t < h; t += 2) {
        pair_term(e0, src(s0 + t * q), src(s0 + (r - t) * q), __ldg(W + idx));
        idx += m;
        if (idx >= r) idx -= r;
        pair_term(e1, src(s0 + (t + 1) * q), src(s0 + (r - t - 1) * q),
                  __ldg(W + idx));
        idx += m;
        if (idx >= r) idx -= r;
      }
      if (t == h) {
        pair_term(e0, src(s0 + t * q), src(s0 + (r - t) * q), __ldg(W + idx));
      }
      acc[i] = cadd(e0, e1);
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    if (tid + i * nt < total) out.put(dst[i], acc[i]);
  }
  __syncthreads();
}

template <int kEPT, class Buf, class Src, class Dst>
__device__ __forceinline__ void run_pass(const Buf& s, const Src& src,
                                         const Dst& out,
                                         const float2* __restrict__ tab,
                                         const Plan& pl, int p, int total) {
  const Pass ps{pl.radix[p], pl.n, pl.ns[p], pl.q[p], pl.rn, pl.rq[p],
                pl.rns[p], tab + pl.tw[p], tab + pl.dft[p]};
  switch (ps.r) {
    case 16: pass16<kEPT>(src, out, ps, total); break;
    case 8: pass_pow2<8, kEPT>(src, out, ps, total); break;
    case 4: pass_pow2<4, kEPT>(src, out, ps, total); break;
    case 2: pass_pow2<2, kEPT>(src, out, ps, total); break;
    default: pass_odd<kEPT>(s, src, out, ps, total);
  }
}

// The last pass of one transform and the first of the next, fused in
// registers (a power-of-two radix R): the last pass's butterfly j (ns = q =
// n / R, so k = j) leaves bins j + m ns of its frame, which are the inputs
// t = m of the next transform's first butterfly j (ns = 1, the same q), so
// the thread hands each bin p through mid(p, value) and runs the second
// R-point DFT at once, writing its outputs to the next pass's places
// f n + j R + m.  The next transform's plan must start with radix R (the
// reverse of this one, say).  Saves one exchange through `s` and its two
// barriers.  The caller synchronises before; the pass ends synchronised.
template <int R, int kEPT, class Buf, class Mid>
__device__ __noinline__ void pass_turn(Buf s, Mid mid, Pass ps, int total) {
  constexpr int kB = kEPT / R;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n = ps.n, q = ps.q;
  const float2* __restrict__ tw = ps.tw;
  const int nb = total / R;
  float2 v[kB][R];
  int dst[kB];
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    const int w = tid + b * nt;
    if (w < nb) {
      const int f = fdiv(w, ps.rq);
      const int j = w - f * q;
      const int s0 = f * n + j;
#pragma unroll
      for (int t = 0; t < R; ++t) {
        v[b][t] = s(s0 + t * q);
        if (t > 0) v[b][t] = cmul(v[b][t], __ldg(tw + (t - 1) * q + j));
      }
      dft<R>(v[b]);
#pragma unroll
      for (int m = 0; m < R; ++m) v[b][m] = mid(s0 + m * q, v[b][m]);
      dft<R>(v[b]);
      dst[b] = f * n + j * R;
    }
  }
  __syncthreads();
#pragma unroll
  for (int b = 0; b < kB; ++b) {
    if (tid + b * nt < nb) {
#pragma unroll
      for (int m = 0; m < R; ++m) s.put(dst[b] + m, v[b][m]);
    }
  }
  __syncthreads();
}

// pass_turn for pass p, the last, of a power-of-two plan.
template <int kEPT, class Buf, class Mid>
__device__ __forceinline__ void run_turn(const Buf& s, const Mid& mid,
                                         const float2* __restrict__ tab,
                                         const Plan& pl, int p, int total) {
  const Pass ps{pl.radix[p], pl.n, pl.ns[p], pl.q[p], pl.rn, pl.rq[p],
                pl.rns[p], tab + pl.tw[p], tab + pl.dft[p]};
  switch (ps.r) {
    case 16: pass_turn<16, kEPT>(s, mid, ps, total); break;
    case 8: pass_turn<8, kEPT>(s, mid, ps, total); break;
    case 4: pass_turn<4, kEPT>(s, mid, ps, total); break;
    default: pass_turn<2, kEPT>(s, mid, ps, total);
  }
}

// A block's values copied from `src` into `s`: the transform of n = 1.
template <int kEPT, class Src, class Dst>
__device__ __noinline__ void copy_block(Src src, Dst out, int total) {
  float2 v[kEPT];
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) v[i] = src(e);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kEPT; ++i) {
    const int e = threadIdx.x + i * blockDim.x;
    if (e < total) out.put(e, v[i]);
  }
  __syncthreads();
}

// Each pass is a function of its own (__noinline__): inlined into one loop
// over the plan, the five pass types' register needs added up (254
// registers, and spills under the 64 that four blocks an SM allow); called,
// the block holds one pass's registers at a time.
//
// The forward FFT of the block's `total` values (a multiple of pl.n, at
// most kEPT blockDim.x), bins in natural order.  The first pass reads
// through `first` (input value p of the block, natural order), the last
// writes through `last` (bin p of the block), the others read and write
// `s`.  The caller synchronises before; the call ends synchronised.  With
// no pass (n = 1) the values are copied.
template <int kEPT, class Buf, class Src, class Dst>
__device__ __forceinline__ void fft_block(const Buf& s, const Src& first,
                                          const Dst& last, const Plan& pl,
                                          const float2* __restrict__ tab,
                                          int total) {
  static_assert(kEPT % 16 == 0, "a thread holds whole radix-16 butterflies");
  const int np = pl.npass;
  if (np == 0) {
    copy_block<kEPT>(first, last, total);
  } else if (np == 1) {
    run_pass<kEPT>(s, first, last, tab, pl, 0, total);
  } else {
    run_pass<kEPT>(s, first, s, tab, pl, 0, total);
    for (int p = 1; p < np - 1; ++p) run_pass<kEPT>(s, s, s, tab, pl, p, total);
    run_pass<kEPT>(s, s, last, tab, pl, np - 1, total);
  }
}

}  // namespace sdsp_fft
