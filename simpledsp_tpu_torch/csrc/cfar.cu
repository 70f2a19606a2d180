// Cell-averaging CFAR along the last axis for Hopper (sm_90a), in one pass.
//
// Replaces no TPU kernel: the JAX package's models/radar.py cfar_ca is XLA's
// shifted adds, and so was the port's until this kernel.  Its plain version,
// kernels/cfar.py cfar_rolled (the route models/radar.py cfar_ca keeps for
// the CPU, float64, a DTensor and a span past kMaxSpan), adds 2 train rolled
// copies of the map in turn: at 64 x 128 x 4096 about 17 GB of traffic a
// call for a result that needs the map read once and two maps written once.
//
// Bit for bit the rolled path on the card.  Each cell i of a row of n:
//   s = 0; for k = guard + 1 .. guard + train: s = (s + x[i - k]) + x[i + k]
// with indices mod n; then noise = s * (1 / (2 train)) (PyTorch divides a
// CUDA tensor by a host scalar as a product with the float reciprocal),
// thresh = alpha * noise with alpha rounded to float (as PyTorch's scalar
// multiply rounds it), det = x > thresh.  __fadd_rn / __fmul_rn, so that
// nvcc contracts nothing into an FMA.  No running sum: it would round
// otherwise.
//
// What bounds it: bytes.  A cell reads 4 and writes 4 + 1: 302 MB at
// 64 x 128 x 4096, 0.090 ms at 3.35 TB/s; its 2 train + 1 operations are
// 0.84 GFLOP there (0.013 ms).  The design:
// - A block of 256 threads owns a tile of 1024 cells of one row, and stages
//   the tile and a halo of span = guard + train cells on each side (read
//   with wrap-around) in shared memory: 16-byte loads where the row allows,
//   so each cell comes from device memory once but for the halos (2.7 % more
//   at span 14).  Blocks are (row, tile) pairs in a one-dimensional grid:
//   8192 rows of 4096 are 32768 blocks, eight resident on each of 132 SMs.
// - A thread owns four consecutive cells.  Their left and right terms slide
//   by one cell a step, so a step loads two values from shared memory and
//   adds eight: the two windows are rings of four registers, and the loop,
//   unrolled by four, renames the ring's slots instead of moving values.
// - Neighbouring threads load 4 words apart, which would put four threads
//   on one bank; a pad word after every 32 spreads them (at most two share a
//   bank, and only the warp's first and last).
// - Each thread stores its four thresholds as one float4 and its four mask
//   bytes as one 32-bit word, both as streaming (evict-first) stores, where
//   the row's length is a multiple of 4 and the buffers are aligned; else a
//   cell at a time.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCells = 4;                  // cells a thread
constexpr int kTile = kThreads * kCells;   // cells a block
// The widest span the tile takes: at 2048 a block's shared memory is 21 KB,
// so eight blocks of 256 threads still fit an SM.  kernels/cfar.py MAX_SPAN.
constexpr int kMaxSpan = 2048;

// Where staged cell p lies in shared memory: one pad word after every 32.
__host__ __device__ constexpr int padded(int p) { return p + (p >> 5); }

__global__ void __launch_bounds__(kThreads)
cfar_ca_kernel(const float* __restrict__ x, float* __restrict__ thresh,
               uint8_t* __restrict__ det, int n, int tiles, int guard,
               int train, float inv_train, float alpha, int vec) {
  extern __shared__ float sm[];
  const int span = guard + train;
  const long long row = blockIdx.x / static_cast<unsigned>(tiles);
  const int c0 = static_cast<int>(blockIdx.x % static_cast<unsigned>(tiles)) *
                 kTile;
  const int cells = min(kTile, n - c0);
  const float* xr = x + row * n;

  // Stage columns c0 - span .. c0 + cells + span - 1 (mod n): column
  // c0 - span + m at sm[padded(m)].
  if (vec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr + c0);
    for (int i = threadIdx.x; i < cells / 4; i += kThreads) {
      const float4 v = __ldcs(x4 + i);
      const int m = span + 4 * i;
      sm[padded(m)] = v.x;
      sm[padded(m + 1)] = v.y;
      sm[padded(m + 2)] = v.z;
      sm[padded(m + 3)] = v.w;
    }
  } else {
    for (int i = threadIdx.x; i < cells; i += kThreads) {
      sm[padded(span + i)] = __ldcs(xr + c0 + i);
    }
  }
  for (int i = threadIdx.x; i < 2 * span; i += kThreads) {
    int col, m;
    if (i < span) {
      col = c0 - span + i;
      m = i;
      if (col < 0) col += n;
    } else {
      col = c0 + cells + (i - span);
      m = cells + i;
      if (col >= n) col -= n;
    }
    sm[padded(m)] = __ldg(xr + col);
  }
  __syncthreads();

  const int first = kCells * threadIdx.x;  // the thread's first cell
  if (first >= cells) return;
  const int c = span + first;               // where it is staged
  // l holds x[c + j - k] for j = 0..3 in slot (j - q) & 3 and r holds
  // x[c + j + k] in slot (j + q) & 3, at step q = k - guard - 1.
  float l[kCells], r[kCells], s[kCells];
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    l[j] = sm[padded(c + j - guard - 1)];
    r[j] = sm[padded(c + j + guard + 1)];
    s[j] = 0.0f;
  }
  for (int q0 = 0; q0 < train; q0 += kCells) {
#pragma unroll
    for (int u = 0; u < kCells; ++u) {
      const int q = q0 + u;
      if (q < train) {
        if (q > 0) {
          const int k = guard + 1 + q;
          l[(kCells - u) & 3] = sm[padded(c - k)];
          r[(kCells - 1 + u) & 3] = sm[padded(c + kCells - 1 + k)];
        }
#pragma unroll
        for (int j = 0; j < kCells; ++j) {
          s[j] = __fadd_rn(__fadd_rn(s[j], l[(j - u + kCells) & 3]),
                           r[(j + u) & 3]);
        }
      }
    }
  }

  float th[kCells];
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kCells; ++j) {
    th[j] = __fmul_rn(alpha, __fmul_rn(s[j], inv_train));
    bits |= static_cast<uint32_t>(sm[padded(c + j)] > th[j]) << (8 * j);
  }
  const long long at = row * n + c0 + first;
  if (vec) {  // cells is a multiple of 4: all four cells are in the row
    __stcs(reinterpret_cast<float4*>(thresh + at),
           make_float4(th[0], th[1], th[2], th[3]));
    __stcs(reinterpret_cast<unsigned int*>(det + at), bits);
  } else {
#pragma unroll
    for (int j = 0; j < kCells; ++j) {
      if (first + j < cells) {
        thresh[at + j] = th[j];
        det[at + j] = static_cast<uint8_t>((bits >> (8 * j)) & 1u);
      }
    }
  }
}

bool aligned(const void* p, unsigned bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

// CA-CFAR along the last axis of a (rows, n) contiguous float32 map x:
// thresh (rows, n) float32 and det (rows, n) bytes of 0 or 1, as the rolled
// path computes them for guard >= 0, 1 <= train, guard + train <= kMaxSpan,
// n >= 2 (guard + train) + 1, with the multiplier alpha (rounded to float
// here).  Returns a CUDA error code (0 on success).
extern "C" int sdsp_cfar_ca_f32(const float* x, float* thresh,
                                unsigned char* det, long long rows, int n,
                                int guard, int train, double alpha,
                                int device, void* stream) {
  const int span = guard + train;
  if (rows < 0 || guard < 0 || train < 1 || span > kMaxSpan ||
      n < 2 * span + 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles = (n + kTile - 1) / kTile;
  if (rows > INT_MAX / tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const int vec = n % 4 == 0 && aligned(x, 16) && aligned(thresh, 16) &&
                  aligned(det, 4);
  const unsigned blocks = static_cast<unsigned>(rows * tiles);
  const size_t smem = sizeof(float) * (padded(kTile + 2 * span) + 1);
  cfar_ca_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, thresh, reinterpret_cast<uint8_t*>(det), n, tiles, guard, train,
      1.0f / static_cast<float>(2 * train), static_cast<float>(alpha), vec);
  return static_cast<int>(cudaGetLastError());
}
