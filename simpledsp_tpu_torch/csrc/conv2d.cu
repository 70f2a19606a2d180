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
// Layout: a block of 256 threads owns a 32-row by 128-column output tile of
// one image and stages the (32 + kh - 1) x (128 + kw - 1) input tile (zeros
// beyond the image) in shared memory with cp.async, its rows padded to an
// odd pitch: the copies need no registers, so every load of the tile is in
// flight at once instead of one device-memory latency per loop trip.  The
// taps arrive by value as a kernel parameter (at most 169 floats, one build
// for every tap set) and are copied to shared memory, where a warp reads each
// one as a broadcast.  Lane l of warp w computes row l, columns
// 16 w .. 16 w + 15: the 32 lanes of a warp read 32 different rows of one
// column, conflict-free at an odd pitch.  Along a tap row the thread slides a
// window of 16 + 16 input values through registers, so a shared-memory load
// feeds 16 products.  The finished tile goes back through shared memory,
// so each warp stores whole 128-byte row segments.
//
// What bounds it: two fp32 instructions per tap and output (no FMA, for the
// rounding above).  At 9 x 9 on 32 x 512 x 512 that is 1.3 G instructions,
// and the kernel issues them at about 40 % of the card's fp32 rate; at 3 x 3
// it moves the image in and the output out at about half the device-memory
// bandwidth (NVIDIA H100, PERF.md).  The TPU's whole image resident in VMEM
// and its taps baked into the code as Python floats have no counterpart
// here.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 169;
constexpr int kTileRows = 32;             // one warp's lanes
constexpr int kCols = 16;                 // outputs a thread computes in a row
constexpr int kWarps = 8;
constexpr int kTileCols = kWarps * kCols; // 128
constexpr int kThreads = kWarps * 32;
constexpr int kOutPitch = kTileCols + 1;  // odd: lanes' rows on distinct banks

// Asynchronous 4-byte copy into shared memory; reads nothing and writes a
// zero when `valid` is false (src must still be a valid address).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

struct Taps {
  float k[kMaxTaps];
};

__global__ void __launch_bounds__(kThreads)
conv2d_valid_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int hp, int wp, int oh, int ow, int kh, int kw, int tiles_x,
                    int tiles_y, int pitch, const __grid_constant__ Taps taps) {
  extern __shared__ float smem[];
  float* ks = smem;                          // kh kw taps
  float* xs = smem + ((kh * kw + 3) & ~3);   // (32 + kh - 1) rows of `pitch`

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = (tile / tiles_x) % tiles_y;
  const long long b = tile / (tiles_x * tiles_y);
  const int r0 = ty * kTileRows;
  const int c0 = tx * kTileCols;
  const float* img = x + b * hp * static_cast<long long>(wp);

  for (int t = tid; t < kh * kw; t += kThreads) ks[t] = taps.k[t];
  // Stage rows r0 .. r0 + 32 + kh - 2 over the whole pitch (zeros past the
  // image: the window below reads up to kCols - 1 columns beyond the tile).
  const int rows = kTileRows + kh - 1;
  for (int rr = warp; rr < rows; rr += kWarps) {
    const int gr = r0 + rr;
    const float* src = img + static_cast<long long>(gr < hp ? gr : 0) * wp;
    for (int cc = lane; cc < pitch; cc += 32) {
      const int gc = c0 + cc;
      const bool ok = gr < hp && gc < wp;
      cp_async_f32(xs + rr * pitch + cc, ok ? src + gc : img, ok);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  float acc[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) acc[q] = 0.0f;
  const int col = warp * kCols;
  for (int i = 0; i < kh; ++i) {
    const float* src = xs + (lane + i) * pitch + col;
    const float* ki = ks + i * kw;
    float w0[kCols], w1[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q) w0[q] = src[q];
    for (int jb = 0; jb < kw; jb += kCols) {
#pragma unroll
      for (int q = 0; q < kCols; ++q) w1[q] = src[jb + kCols + q];
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        if (jb + jj < kw) {
          const float k = ki[jb + jj];
#pragma unroll
          for (int q = 0; q < kCols; ++q) {
            const float v = q + jj < kCols ? w0[q + jj] : w1[q + jj - kCols];
            acc[q] = __fadd_rn(acc[q], __fmul_rn(k, v));
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q) w0[q] = w1[q];
    }
  }

  // Every read of the input tile is done: reuse it for the output tile.
  __syncthreads();
  float* os = xs;
#pragma unroll
  for (int q = 0; q < kCols; ++q) os[lane * kOutPitch + col + q] = acc[q];
  __syncthreads();
  for (int rr = warp; rr < kTileRows && r0 + rr < oh; rr += kWarps) {
    float* dst = out + (b * oh + r0 + rr) * static_cast<long long>(ow) + c0;
    for (int cc = lane; cc < kTileCols && c0 + cc < ow; cc += 32) {
      dst[cc] = os[rr * kOutPitch + cc];
    }
  }
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
  const int tiles_x = (ow + kTileCols - 1) / kTileCols;
  const int tiles_y = (oh + kTileRows - 1) / kTileRows;
  const long long blocks = static_cast<long long>(tiles_x) * tiles_y * batch;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  // Columns a thread's window reads: the tile, the kw - 1 halo and up to
  // kCols - 1 more; an odd pitch keeps the lanes' rows on distinct banks.
  const int pitch = (kTileCols + kw - 1 + kCols) | 1;
  const size_t smem = sizeof(float) * (((kh * kw + 3) & ~3) +
                                       static_cast<size_t>(kTileRows + kh - 1) * pitch);
  err = cudaFuncSetAttribute(conv2d_valid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  conv2d_valid_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      x, out, hp, wp, oh, ow, kh, kw, tiles_x, tiles_y, pitch, t);
  return static_cast<int>(cudaGetLastError());
}
