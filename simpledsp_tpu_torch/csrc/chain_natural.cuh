// The fused chain kernel's template, chain_natural_kernel, shared by the
// forms of chain.cu (the IIR block by column bands on the CUDA cores) and
// the "regs" form of chain_tc.cu (the IIR block as split-bf16 products on
// the tensor cores), each source instantiating its own forms, so that the
// two build in parallel.  Per frame: the IIR block y = x H^T + starts^T
// Phi^T, then, for an even N, the real FFT of y as the N/2-point complex
// FFT of z[t] = y[2t] + i y[2t+1] on the FFT core (fft_core.cuh) and the
// split into the one-sided spectrum; an odd N takes the N-point complex FFT
// of (y, 0).  chain.cu's header says what bounds it and why it is built so.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "chain_common.cuh"
#include "fft_core.cuh"

namespace sdsp_chain {

constexpr int kLdx = kN2 + 4;   // row stride of x and y in shared memory

// IIR block by column bands: y = x H^T + starts^T Phi^T over n1p rows,
// written at a row stride of kLdx.  A work item is a band of 16 output
// columns and 8 TM rows; lane = 8 cl + rl holds rows m0 + rl + 8 r and
// columns 16 band + 4 cl.  H is lower-triangular, so the band's outputs
// need the k-chunks up to its last column only: the depth stops at
// 16 (band + 1), skipping chunks of H^T that are all zero for the band
// (a skipped chunk adds zeros: y keeps the bits of the dense sum for finite
// input).  Items alternate the band order by row
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

// -- the IIR block on the tensor cores ("regs") ----------------------------
//
// y = A T for the block's rows, A = [x | starts^T] (rows, K) and T =
// [H^T; Phi^T] (K, n2), K = n2 + d rounded up to 16 (split_depth), as
// split-bf16 products: each float32 operand is the sum of three bfloat16
// parts, a = a_h + a_m + a_l (round to nearest even, each part the rounded
// residual of the one before: 3 x 8 bits carry float32's 24), the product of
// two parts is exact in fp32, and all nine part products are summed.  A is
// split on the device once per value (split_load) into three bf16 planes in
// shared memory, row p at p lda (lda = K + 8: an odd number of 16-byte
// units, so that the eight rows an ldmatrix phase reads fall in distinct
// banks); T's parts are split on the host from its float64 values and laid
// out in mma.sync B-fragment order (kernels/chain_variants.py
// _regs_fragments).  The tensor cores' own fp32 accumulation over a long K
// loses bits (127.9 dB against 135.9 dB over K = 128 at N = 16384 on an
// H100, the four-step form's step 1), so every 16-deep K step sums its nine
// products into a fresh fp32 partial, lowest parts first, and the partials
// are added in IEEE fp32.

// K of the block's product: n2 + d rounded up to a multiple of 16.
__host__ __device__ __forceinline__ int split_depth(int n2, int d) {
  return (n2 + d + 15) & ~15;
}

// Rows of the split form's block: g n1 rounded up to whole 16-row M tiles.
__host__ __device__ __forceinline__ int split_rows(int g, int n1) {
  return (g * n1 + 15) & ~15;
}

// Shared memory of the split form's block: the three bf16 planes of A
// (rows x lda), whose space then holds the FFT's two planes, and y (rows x
// kLdx floats).
__host__ __device__ __forceinline__ size_t split_smem_bytes(int rows, int n2,
                                                            int d) {
  const size_t lda = split_depth(n2, d) + 8;
  return 6 * static_cast<size_t>(rows) * lda +
         sizeof(float) * static_cast<size_t>(rows) * kLdx;
}

__device__ __forceinline__ void split3(float v, __nv_bfloat16 (&p)[3]) {
  p[0] = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(p[0]);
  p[1] = __float2bfloat16_rn(r1);
  p[2] = __float2bfloat16_rn(r1 - __bfloat162float(p[1]));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// Element at of the three planes (plane apart) from v's parts.
__device__ __forceinline__ void put_split(__nv_bfloat16* a3, int plane, int at,
                                          float v) {
  __nv_bfloat16 p[3];
  split3(v, p);
  a3[at] = p[0];
  a3[plane + at] = p[1];
  a3[2 * plane + at] = p[2];
}

// The block's frames and starts as A's three parts: row p = q n1 + r (frame
// q, row r) holds x[q, r, 0 .. n2) in columns 0 .. n2 - 1 and
// starts[q, 0 .. d, r] in columns n2 .. n2 + d - 1, zeros up to kp; rows
// vr .. rows - 1 are zero.  Every column a K step reads is written: a NaN
// left in a pad column would reach y through its zero table entries.
template <int kNT>
__device__ __forceinline__ void split_load(__nv_bfloat16* a3, int lda, int kp,
                                           const float* x, const float* s,
                                           size_t f0, int nf, int n1, int rows,
                                           int n2, int d, float rn2) {
  const int tid = threadIdx.x;
  const int plane = rows * lda;
  const int vr = nf * n1;
  if (n2 == kN2) {
    const float4* xf = reinterpret_cast<const float4*>(x + f0 * n1 * kN2);
    for (int i = tid; i < vr * kN2 / 4; i += kNT) {
      const float4 v = xf[i];
      __nv_bfloat16 p[4][3];
      split3(v.x, p[0]);
      split3(v.y, p[1]);
      split3(v.z, p[2]);
      split3(v.w, p[3]);
      const int at = (i >> 5) * lda + 4 * (i & 31);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        *reinterpret_cast<uint2*>(a3 + a * plane + at) =
            make_uint2(pack2(p[0][a], p[1][a]), pack2(p[2][a], p[3][a]));
      }
    }
  } else {
    const float* xf = x + f0 * n1 * n2;
    for (int i = tid; i < vr * n2; i += kNT) {
      const int p = sdsp_fft::fdiv(i, rn2);
      put_split(a3, plane, p * lda + i - p * n2, xf[i]);
    }
  }
  const float* sf = s + f0 * d * n1;
  for (int i = tid; i < nf * d * n1; i += kNT) {
    const int q = i / (d * n1), r = i - q * d * n1;
    put_split(a3, plane, (q * n1 + r % n1) * lda + n2 + r / n1, sf[i]);
  }
  const int pc = kp - n2 - d;          // zero columns after the starts
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  for (int i = tid; i < vr * pc; i += kNT) {
    const int p = i / pc;
    const int at = p * lda + n2 + d + i - p * pc;
    a3[at] = zero;
    a3[plane + at] = zero;
    a3[2 * plane + at] = zero;
  }
  const int z = (rows - vr) * lda / 8;   // 16-byte units of a plane's zero rows
  for (int i = tid; i < 3 * z; i += kNT) {
    const int a = i / z;
    reinterpret_cast<uint4*>(a3 + a * plane + vr * lda)[i - a * z] =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// y (rows x kLdx) = A T as m16n8k16 tiles: M tiles of 16 rows, N tiles of
// 8 output columns, K steps of 16.  A warp takes N tiles w, 2 nw - 1 - w,
// 2 nw + w, ... (nw warps): T's triangle makes tile nt need nt / 2 + 1 K
// steps of H^T, so the pairs balance.  For each of its N tiles and each
// group of up to eight M tiles it walks the K steps the tile needs: those of
// H^T up to the tile's last column (H is lower-triangular: the rest of H^T's
// rows are zero for the tile, half the product) and those holding Phi^T.
// A step reads the lane's B fragments of the three parts (16 + 8 bytes from
// the table: tc holds, for each (N tile, K step), 32 lanes' uint4 (h.b0,
// h.b1, m.b0, m.b1) then 32 lanes' uint2 (l.b0, l.b1)), and for each M tile
// the three A fragments by ldmatrix (lane l addresses row l % 16, column
// 8 (l / 16) of the 16 x 16 tile), runs the nine products into a fresh
// partial, lowest parts first, and adds it to the tile's sum.  C fragment:
// rows gid and gid + 8, columns 2 tig and 2 tig + 1 (lane = 4 gid + tig).
__device__ __forceinline__ void iir_mma_stage(float* y,
                                              const __nv_bfloat16* a3,
                                              int lda, int kp,
                                              const uint4* __restrict__ tc,
                                              int rows, int n2) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int ntiles = (n2 + 7) >> 3, ksteps = kp >> 4, mtiles = rows >> 4;
  const int hlast = (n2 - 1) >> 4, phi0 = n2 >> 4;
  const uint32_t plane = 2u * static_cast<uint32_t>(rows * lda);   // bytes
  const uint32_t a_lane = static_cast<uint32_t>(__cvta_generic_to_shared(
      a3 + (lane & 15) * lda + ((lane >> 4) << 3)));
  for (int j = 0; j * nw < ntiles; ++j) {
    const int nt = (j & 1) ? (j + 1) * nw - 1 - warp : j * nw + warp;
    if (nt >= ntiles) continue;
    const int hend = min((8 * nt + 7) >> 4, hlast);   // its last step of H^T
    const int phi = max(hend + 1, phi0);              // its first after that
    const uint4* tn = tc + static_cast<size_t>(nt) * ksteps * 48;
    const auto hm_at = [&](int ks) { return __ldg(tn + ks * 48 + lane); };
    const auto lo_at = [&](int ks) {
      return __ldg(reinterpret_cast<const uint2*>(tn + ks * 48 + 32) + lane);
    };
    for (int m0 = 0; m0 < mtiles; m0 += 8) {
      float acc[8][4] = {};
      // The next step's B fragments load while this step's products run.
      uint4 hm = hm_at(0);
      uint2 lo = lo_at(0);
      for (int ks = 0; ks < ksteps;) {
        const int kn = ks == hend ? phi : ks + 1;
        uint4 hm_n = hm;
        uint2 lo_n = lo;
        if (kn < ksteps) {
          hm_n = hm_at(kn);
          lo_n = lo_at(kn);
        }
        const uint32_t b[3][2] = {{hm.x, hm.y}, {hm.z, hm.w}, {lo.x, lo.y}};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (m0 + i < mtiles) {
            const uint32_t at = a_lane + 2u * static_cast<uint32_t>(
                                             (m0 + i) * 16 * lda + 16 * ks);
            uint32_t a[3][4];
            ldmatrix_x4(a[0], at);
            ldmatrix_x4(a[1], at + plane);
            ldmatrix_x4(a[2], at + 2 * plane);
            float part[4] = {0.f, 0.f, 0.f, 0.f};
            mma_bf16(part, a[2], b[2]);
            mma_bf16(part, a[2], b[1]);
            mma_bf16(part, a[1], b[2]);
            mma_bf16(part, a[1], b[1]);
            mma_bf16(part, a[2], b[0]);
            mma_bf16(part, a[0], b[2]);
            mma_bf16(part, a[1], b[0]);
            mma_bf16(part, a[0], b[1]);
            mma_bf16(part, a[0], b[0]);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][e] += part[e];
          }
        }
        hm = hm_n;
        lo = lo_n;
        ks = kn;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (m0 + i < mtiles) {
          float* yr = y + (16 * (m0 + i) + gid) * kLdx + 8 * nt + 2 * tig;
          *reinterpret_cast<float2*>(yr) = make_float2(acc[i][0], acc[i][1]);
          *reinterpret_cast<float2*>(yr + 8 * kLdx) =
              make_float2(acc[i][2], acc[i][3]);
        }
      }
    }
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

#if defined(SDSP_CHAIN_CUT_AT)
#define SDSP_CHAIN_SINK(n, v)                                             \
  if ((n) == SDSP_CHAIN_CUT_AT) {                                         \
    if ((v)[tid] == 1.5e-30f) re[f0] = (v)[tid];                          \
    return;                                                               \
  }
#else
#define SDSP_CHAIN_SINK(n, v)
#endif

// How a block computes its frames' IIR block: by column bands on the CUDA
// cores (iir_band_stage, every form of chain.cu) or as split-bf16 products
// on the tensor cores (iir_mma_stage, the "regs" form of chain_tc.cu).
enum Iir { kBands = 0, kSplit = 1 };

// g frames a block (the last block may hold fewer), their rows stacked
// unpadded: frame q's rows are q n1 .. q n1 + n1 - 1, its z values q M ..
// q M + M - 1 (M = N/2; an odd N's values q N .. q N + N - 1), and the
// block's rows = g n1 rounded up to a multiple of 8 (kSplit: of 16, whole
// M tiles; zero rows after the frames).  Shared memory, kBands: x (rows x
// kLdx), whose space then holds the FFT's two planes, y (rows x kLdx) and
// the starts (rows x dp); kSplit: A's three bf16 planes (split_load), whose
// space then holds the FFT's planes, and y (rows x kLdx).  Per frame: the
// IIR block into y (kIir, enum Iir; tc the split form's table, null for
// kBands); the M-point complex FFT of z read from y, into the planes; the
// split
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
//
// SDSP_CHAIN_CUT_AT = 1 or 2, defined when the source is built, stops every
// block after its loads (1) or after its IIR block (2), the values computed
// so far kept live (tools/chain_stages.py times the stages so).
template <int kIir, int TM, int kEPT, int kForm, int kNT, int kStore>
__global__ void __launch_bounds__(
    kNT, kEPT > 16 || kNT > kThreads ? 1 : (kIir == kSplit || TM == 4 ? 2 : 3))
chain_natural_kernel(const float* __restrict__ x, const float* __restrict__ s,
                     const float* __restrict__ HT,
                     const float* __restrict__ PhiT,
                     const uint4* __restrict__ tc, sdsp_fft::Plan plan,
                     const float2* __restrict__ tab,
                     const float2* __restrict__ split, float* __restrict__ re,
                     float* __restrict__ im, int frames, int g, int n1,
                     int rows, int n2, int d, float rn2, int lpad) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const size_t f0 = static_cast<size_t>(blockIdx.x) * g;
  const int nf = static_cast<int>(min(static_cast<size_t>(g), frames - f0));
  const int nn = n1 * n2;              // N
  const int m = nn / 2;
  const int vr = nf * n1;              // rows that hold frames
  int yo;                              // y's offset in the shared memory

  if constexpr (kIir == kSplit) {
    const int kp = split_depth(n2, d), lda = kp + 8;
    auto* a3 = reinterpret_cast<__nv_bfloat16*>(smem4);
    yo = 3 * rows * lda / 2;
    split_load<kNT>(a3, lda, kp, x, s, f0, nf, n1, rows, n2, d, rn2);
    __syncthreads();
    SDSP_CHAIN_SINK(1, smem);
    iir_mma_stage(smem + yo, a3, lda, kp, tc, rows, n2);
  } else {
    float* xs = smem;
    float* ys = xs + rows * kLdx;
    float* st = ys + rows * kLdx;
    const int dp = starts_stride(d);
    yo = rows * kLdx;
    // Frames and starts; rows vr .. rows - 1 zero.
    if (n2 == kN2) {
      const float4* xf = reinterpret_cast<const float4*>(x + f0 * n1 * kN2);
      for (int i = tid; i < vr * kN2 / 4; i += kNT) {
        *reinterpret_cast<float4*>(xs + (i >> 5) * kLdx + 4 * (i & 31)) =
            xf[i];
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
    SDSP_CHAIN_SINK(1, smem);
    iir_band_stage<TM>(ys, xs, st, HT, PhiT, rows, n2, d);
  }
  __syncthreads();
  float* const ys = smem + yo;
  SDSP_CHAIN_SINK(2, ys);

  if constexpr (kForm == kOdd) {
    // Unswizzled: the swizzle spreads power-of-two strides only, and costs
    // conflicts where a warp's consecutive values cross a row of 32.
    const sdsp_fft::Planes<0> z{0, sdsp_fft::round32(g * nn)};
    sdsp_fft::fft_block<kEPT>(z, FrameReal{yo, n2, rn2},
                              SpectrumOut{re + f0 * nn, im + f0 * nn}, plan,
                              tab, nf * nn);
    return;
  }

  // x's (kSplit: A's) space holds the FFT's planes, swizzled also for an
  // odd factor of m (one instance, not two); y lies at offset yo.
  const sdsp_fft::Planes<31> z{0, sdsp_fft::round32(g * m)};
  if constexpr (kForm == kPairs) {
    sdsp_fft::fft_block<kEPT>(z, FramePairs{yo, n2, rn2}, z, plan,
                              tab, nf * m);
  } else {
    sdsp_fft::fft_block<kEPT>(z, FrameAsComplex{yo, n2, rn2}, z,
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

// Frames a block as the kernel picks them, for `per` FFT values a frame:
// as many as keep the block's FFT at 4096 values and its rows (g n1
// rounded up to 8) at 64 (two frames at N = 4096, eight at 1024 and at the
// odd 375).
inline int natural_frames(int n1, int per) {
  int g = 1;
  while (2 * g * per <= 4096 && ((2 * g * n1 + 7) & ~7) <= 64) g *= 2;
  return g;
}

}  // namespace sdsp_chain
