// Direct VALID 2-D convolution kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel simpledsp_tpu/kernels/conv2d.py:_make_body,
// reached through conv2d_valid_fused from the public convolve2d /
// correlate2d (direct route, concrete float32 kernels of at most 169 taps).
//
// out[b, r, c] = sum_i sum_j k[i, j] x[b, r + i, c + j] over the already
// flipped (kh, kw) taps, for a pre-padded (B, Hp, Wp) float32 image.
//
// Bit for bit the plain version (kernels/conv2d.py:conv2d_valid_reference,
// the JAX package's _conv2d_direct_real): every output starts at +0 and adds
// the rounded product of each tap, i outer and j inner, as a rounded sum.
// nvcc would contract k * x + acc into one FMA, which rounds once and so
// differs, so the products and sums are written with __fmul_rn / __fadd_rn,
// which it never contracts.  Zero taps are not skipped (the TPU body skips
// them, which is bit-equal only on finite data): every tap is applied, so
// the kernel equals the plain version also where the image holds inf or NaN.
//
// What bounds it: the rounding above forbids the FMA, so every tap and
// output costs two fp32 instructions, and the card issues one warp
// instruction a clock on each of an SM's four schedulers: 33.4 T fp32
// instructions a second (132 SMs x 128 lanes x 1.98 GHz, the clock the card
// holds under this kernel).  At 9 x 9 on 32 x 512 x 512 that is 1.36 G
// instructions, 0.041 ms; at 13 x 13 0.085 ms; at 3 x 3 the image's bytes
// in and the output's out, 0.020 ms at 3.35 TB/s, bound it instead.  So
// every instruction that is not a product or a sum takes an issue slot from
// them, and the design spends as few as it can:
//
// - A thread owns 2 rows x 8 columns of outputs.  Each tap row i is read
//   once (one to four 16-byte loads, a broadcast to the warp) and feeds the
//   thread's 2 output rows from the windows of input rows i and i + 1,
//   8 + kw - 1 values each in 16-byte loads: straight-line code, so every
//   output still adds its taps i outer and j inner.  In the 9 x 9 loop 90 %
//   of the instructions are the products and sums (the rest loads and
//   addresses; tools/ptxas_report.py --sass).
// - The tap loop is fully unrolled: one instance for each kw of 1 to 16,
//   and one generic instance for wider rows (kw up to 169), which walks the
//   row eight taps at a time (uniform branches skip past the last tap).
// - A block of 256 threads owns a 32 x 128 output tile, three blocks an SM.
//   Persistent blocks (as many as fit on the card) walk the tiles, and the
//   next tile's input is in flight by cp.async during the current tile's
//   arithmetic: two stages of (32 + kh - 1) rows, zeros beyond the image,
//   16-byte copies where the image's rows allow them, 4-byte ones
//   otherwise; a lane's copies cost a pointer increment each.  A warp whose
//   16 x 32 outputs all lie past the image's edge skips its arithmetic and
//   leaves its issue slots to the SM's other warps.
// - Shared-memory layout: rows of a pitch that is a multiple of 8 floats;
//   16-byte slot q of staged row r sits at slot q ^ ((r / 2) & 1).  A
//   quarter-warp (the unit a 16-byte load serves at a time) holds 4 column
//   threads (slots 2 tc + q) of two row threads two rows apart, whose slots
//   the swizzle puts on opposite parities: 8 distinct 16-byte bank groups,
//   no conflict (tests/test_torch_conv2d_schedule.py mirrors the schedule
//   and layout for its bank model and its emulation of the schedule).
// - Results leave a row of each thread at a time through the warp's own
//   stage in shared memory, as whole 128-byte rows: 16-byte stores where the
//   output's rows allow them, else 4-byte ones.  (Stores straight from the
//   registers would land 32 bytes apart, a partial sector each: at 3 x 3 on
//   510-wide rows they bound the kernel at three times its time.)
//
// The TPU's whole image resident in VMEM and its taps baked into the code
// as Python floats have no counterpart here.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxTaps = 169;
constexpr int kR = 2;                       // output rows a thread owns
constexpr int kC = 8;                       // output columns a thread owns
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = kR * 16;          // 32: 16 row threads
constexpr int kTileCols = kC * 16;          // 128: 16 column threads
constexpr int kWarpRows = 8 * kR;           // a warp's outputs: 16 rows
constexpr int kWarpCols = 4 * kC;           //   x 32 columns
constexpr int kOutPitch = kWarpCols + 4;    // a warp's output stage: 8 rows
constexpr int kOutStage = kWarps * 8 * kOutPitch;   // floats, all warps
constexpr int kJB = 8;                      // generic instance: taps a step
constexpr int kSmemMax = 232448;            // a block's shared memory

struct Taps {
  float k[kMaxTaps];
};

// What the host computes once a launch (see sdsp_conv2d_valid_f32).
struct Plan {
  int hp, wp, oh, ow, kh, kw;
  int tiles_x, tiles_y, tiles;
  int rows;     // input rows a tile stages: kTileRows + kh - 1
  int pitch;    // floats a staged row (a multiple of 8)
  int kstride;  // floats a tap row in shared memory (a multiple of 4)
  int stage;    // floats a stage
  int vec_in;   // 16-byte input copies
  int vec_out;  // 16-byte output stores
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct TileAt {
  long long b;
  int r0, c0;
};

__device__ __forceinline__ TileAt tile_at(const Plan& p, int tile) {
  const int tx = tile % p.tiles_x;
  const int rest = tile / p.tiles_x;
  return {rest / p.tiles_y, (rest % p.tiles_y) * kTileRows, tx * kTileCols};
}

// Stage the tile's input rows r0 .. r0 + rows - 1, columns c0 .. c0 + pitch
// - 1 (zeros past the image), each staged row swizzled by 16-byte slot.
// Warp w copies rows w, w + 8, ..., which all have the swizzle bit
// ((w / kR) & 1); a lane walks its column slots outside and the rows
// inside, so a copy costs a few pointer increments.
__device__ __forceinline__ void load_tile(const float* __restrict__ x,
                                          float* dst, const Plan& p,
                                          int tile) {
  const TileAt t = tile_at(p, tile);
  const float* img = x + t.b * p.hp * static_cast<long long>(p.wp);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sw = (static_cast<unsigned>(warp) / kR) & 1;
  const long long step = static_cast<long long>(kWarps) * p.wp;
  const float* first = img + static_cast<long long>(t.r0 + warp) * p.wp + t.c0;
  const int rows_left = min(p.rows, p.hp - t.r0);  // staged rows in the image
  const int per = p.vec_in ? 4 : 1;                 // floats a copy
  for (int cc = per * lane; cc < p.pitch; cc += 32 * per) {
    const bool cok = t.c0 + cc < p.wp;
    const float* src = first + cc;
    float* d = dst + warp * p.pitch + (((cc >> 2) ^ sw) << 2) + (cc & 3);
    for (int rr = warp; rr < p.rows; rr += kWarps) {
      const bool ok = cok && rr < rows_left;
      if (p.vec_in) {
        cp_async16(d, ok ? src : img, ok);
      } else {
        cp_async4(d, ok ? src : img, ok);
      }
      src += step;
      d += kWarps * p.pitch;
    }
  }
}

__device__ __forceinline__ void unpack(float* w, float4 v) {
  w[0] = v.x;
  w[1] = v.y;
  w[2] = v.z;
  w[3] = v.w;
}

// The 16-byte window loads of the thread's staged row s (row tr kR + s):
// logical slot 2 tc + q (+ jb / 4) lies at slot 2 tc + (q ^ sw) (+ jb / 4).
template <int NQ>
__device__ __forceinline__ void window(float* w, const float* base, int s,
                                       int tr, int pitch, int jb = 0) {
  const int sw = (static_cast<unsigned>(tr * kR + s) / kR) & 1;
  const float* even = base + s * pitch + 4 * sw + jb;
  const float* odd = base + s * pitch - 4 * sw + jb;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    unpack(w + 4 * q,
           *reinterpret_cast<const float4*>((q & 1 ? odd : even) + 4 * q));
  }
}

template <int N>
__device__ __forceinline__ void tap_row(float* t, const float* ki) {
#pragma unroll
  for (int q = 0; q < N / 4; ++q) {
    unpack(t + 4 * q, reinterpret_cast<const float4*>(ki)[q]);
  }
}

// acc[c] += t[j] w[c + j], j = 0 .. KW - 1 (j < kw - jb where KW is the
// generic instance's step).
template <int KW, bool kGuard>
__device__ __forceinline__ void taps_times(float (&acc)[kC], const float* t,
                                           const float* w, int left) {
#pragma unroll
  for (int j = 0; j < KW; ++j) {
    if (kGuard && j >= left) break;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      acc[c] = __fadd_rn(acc[c], __fmul_rn(t[j], w[c + j]));
    }
  }
}

// One tile's outputs of thread (tr, tc) from the staged input `in`, through
// this warp's output stage `os` to device memory.  KW > 0: kw == KW;
// KW == 0: any kw, eight taps a step.
template <int KW>
__device__ __forceinline__ void compute_tile(const float* in, const float* ks,
                                             float* os,
                                             float* __restrict__ out,
                                             const Plan& p, int tile, int tr,
                                             int tc) {
  const TileAt t = tile_at(p, tile);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wr0 = t.r0 + (warp >> 2) * kWarpRows;
  const int wc0 = t.c0 + (warp & 3) * kWarpCols;
  if (wr0 >= p.oh || wc0 >= p.ow) {
    return;  // every output of this warp lies past the image
  }
  float acc[kR][kC];
#pragma unroll
  for (int o = 0; o < kR; ++o) {
#pragma unroll
    for (int c = 0; c < kC; ++c) acc[o][c] = 0.0f;
  }
  const float* base = in + tr * kR * p.pitch + kC * tc;
  constexpr int kNQ = KW > 0 ? (kC + KW - 1 + 3) / 4 : 4;
  constexpr int kKS = KW > 0 ? (KW + 3) & ~3 : kJB;
  // Tap row i feeds each output row o from the window of input row i + o:
  // every output still adds its taps i outer and j inner.
  for (int i = 0; i < p.kh; ++i) {
    for (int jb = 0; jb < (KW > 0 ? 1 : p.kw); jb += kJB) {
      float tk[kKS];
      tap_row<kKS>(tk, ks + i * p.kstride + jb);
#pragma unroll
      for (int o = 0; o < kR; ++o) {
        float w[4 * kNQ];
        window<kNQ>(w, base, i + o, tr, p.pitch, jb);
        taps_times<(KW > 0 ? KW : kJB), (KW == 0)>(acc[o], tk, w, p.kw - jb);
      }
    }
  }
  // Out through the warp's stage, one output row of each thread at a time:
  // the stage holds the warp's 8 rows r = wr0 + kR rr + o, 32 columns.
  const int lr = lane >> 2, lc = lane & 3;
#pragma unroll
  for (int o = 0; o < kR; ++o) {
    __syncwarp();
    float4* mine = reinterpret_cast<float4*>(os + lr * kOutPitch + kC * lc);
    mine[0] = make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
    mine[1] = make_float4(acc[o][4], acc[o][5], acc[o][6], acc[o][7]);
    __syncwarp();
    if (p.vec_out) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int rr = (lane >> 3) + 4 * h, col = wc0 + 4 * (lane & 7);
        const int r = wr0 + kR * rr + o;
        if (r < p.oh && col < p.ow) {
          *reinterpret_cast<float4*>(
              out + (t.b * p.oh + r) * static_cast<long long>(p.ow) + col) =
              reinterpret_cast<const float4*>(os + rr * kOutPitch)[lane & 7];
        }
      }
    } else {
#pragma unroll
      for (int rr = 0; rr < 8; ++rr) {
        const int r = wr0 + kR * rr + o, col = wc0 + lane;
        if (r < p.oh && col < p.ow) {
          out[(t.b * p.oh + r) * static_cast<long long>(p.ow) + col] =
              os[rr * kOutPitch + lane];
        }
      }
    }
  }
}

template <int KW>
__global__ void __launch_bounds__(kThreads, 3)
conv2d_valid_kernel(const float* __restrict__ x, float* __restrict__ out,
                    const Plan p, const __grid_constant__ Taps taps) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                          // kh rows of kstride taps
  float* os = smem + p.kh * p.kstride;       // the warps' output stages
  float* buf = os + kOutStage;               // two stages
  const int tid = threadIdx.x;
  for (int e = tid; e < p.kh * p.kstride; e += kThreads) {
    const int i = e / p.kstride, j = e - i * p.kstride;
    ks[e] = j < p.kw ? taps.k[i * p.kw + j] : 0.0f;
  }
  // Warp w: row threads 8 (w >> 2) .. + 7, column threads 4 (w & 3) .. + 3;
  // lane l: row thread + (l >> 2), column thread + (l & 3).
  const int lane = tid & 31, warp = tid >> 5;
  const int tr = (warp >> 2) * 8 + (lane >> 2);
  const int tc = (warp & 3) * 4 + (lane & 3);

  int tile = blockIdx.x;
  int stage = 0;
  if (tile < p.tiles) load_tile(x, buf, p, tile);
  cp_async_commit();
  for (; tile < p.tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    if (next < p.tiles) load_tile(x, buf + (stage ^ 1) * p.stage, p, next);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    compute_tile<KW>(buf + stage * p.stage, ks,
                     os + (tid >> 5) * 8 * kOutPitch, out, p, tile, tr, tc);
    __syncthreads();  // every read of this stage is done
    stage ^= 1;
  }
  cp_async_wait<0>();
}

using KernelFn = void (*)(const float*, float*, const Plan, const Taps);

template <int... KWs>
struct Instances {
  static KernelFn pick(int kw) {
    KernelFn fn = conv2d_valid_kernel<0>;
    ((kw == KWs ? (fn = conv2d_valid_kernel<KWs>, 0) : 0), ...);
    return fn;
  }
};

int sm_count(int device) {
  static int cached[64] = {};
  if (device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    cudaDeviceGetAttribute(&cached[device], cudaDevAttrMultiProcessorCount,
                           device);
  }
  return cached[device];
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  x is (batch, hp, wp) and out
// (batch, hp - kh + 1, wp - kw + 1), both contiguous float32 in device
// memory; taps is a host array of kh kw float32 (row-major, already flipped).
extern "C" int sdsp_conv2d_valid_f32(const float* x, float* out, int batch,
                                     int hp, int wp, const float* taps, int kh,
                                     int kw, int device, void* stream) {
  const int oh = hp - kh + 1, ow = wp - kw + 1;
  if (kh < 1 || kw < 1 || kh * kw > kMaxTaps || oh < 1 || ow < 1 ||
      batch < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (batch == 0) return static_cast<int>(cudaSuccess);
  Taps t{};
  for (int q = 0; q < kh * kw; ++q) t.k[q] = taps[q];
  Plan p{};
  p.hp = hp;
  p.wp = wp;
  p.oh = oh;
  p.ow = ow;
  p.kh = kh;
  p.kw = kw;
  p.tiles_x = (ow + kTileCols - 1) / kTileCols;
  p.tiles_y = (oh + kTileRows - 1) / kTileRows;
  const long long tiles = static_cast<long long>(p.tiles_x) * p.tiles_y * batch;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  p.tiles = static_cast<int>(tiles);
  p.rows = kTileRows + kh - 1;
  // Columns the windows read: the last column thread's window starts at
  // kTileCols - kC; a templated window is kC + kw - 1 values rounded up to
  // 16 bytes, a generic one reads 16 values at each eight-tap step.
  const int window = kw <= 16 ? ((kC + kw - 1 + 3) & ~3)
                              : kJB * ((kw + kJB - 1) / kJB - 1) + 16;
  p.pitch = (kTileCols - kC + window + 7) & ~7;
  p.kstride = kw <= 16 ? ((kw + 3) & ~3) : kJB * ((kw + kJB - 1) / kJB);
  p.stage = p.rows * p.pitch;
  // Two stages fit every kernel of at most 169 taps (169 x 1 takes the
  // most, 216,720 bytes).
  const size_t smem =
      sizeof(float) * (kh * p.kstride + kOutStage + 2 * p.stage);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  p.vec_in = wp % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_out = ow % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;

  const KernelFn fn = Instances<1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14,
                                15, 16>::pick(kw);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long fill = static_cast<long long>(per_sm > 0 ? per_sm : 1) *
                         sm_count(device);
  const unsigned blocks =
      static_cast<unsigned>(tiles < fill || fill <= 0 ? tiles : fill);
  void* args[] = {&x, &out, &p, &t};
  err = cudaLaunchKernel(reinterpret_cast<const void*>(fn), dim3(blocks),
                         dim3(kThreads), args, smem,
                         static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
