// The probes' kernels for Hopper (sm_90a): four small kernel families that
// ask, on this card, the questions the TPU probes in tools/probe_*.py asked
// of the TPU.  Each replaces one or more Pallas bodies there:
//
//   scale_copy    y = s x, with 4-, 8- or 16-byte vector loads and stores
//                 (the width is a template parameter), or, in "same tile"
//                 mode, G blocks that each rewrite the same small tile.
//                 Replaces the copy bodies of probe_dispatch.py:30,
//                 probe_dma_scale.py:18, probe_store.py:59 (body_copy) and
//                 probe_hlo.py:17.
//   permute       y[b, c, r] = s x[b, r, c]: a batched transpose of the two
//                 minor axes of a strided (B, R, C) view through a 32 x 33
//                 shared-memory tile, optionally split at C/2 into two
//                 output planes.  Replaces probe_store.py:68 (body_regmix),
//                 probe_relayout.py:33, probe_transpose.py:82 and
//                 probe_mosaic.py:129 (k4).
//   contract      C = A B for small strided float32 operands on the CUDA
//                 cores, IEEE FMAs only (no TF32, no tensor cores), with an
//                 optional shift-in epilogue: out row j of each group of J
//                 rows takes product row j - 1, and row 0 takes sf.
//                 Replaces probe_mosaic.py:36 (k1) and :62 (k2).
//   row_sum       y[i] = sum_j x[i, j], one warp a row.  Replaces
//                 probe_mosaic.py:97 (k3).
//
// What bounds them: the copies and transposes move every byte once each way
// and do at most one multiply a value, so device memory bounds them
// (3.35 TB/s); their designs keep every warp's loads and stores on
// consecutive addresses (the transpose through the shared tile, whose odd
// pitch keeps both its row and its column accesses free of bank conflicts);
// the copy runs 8 blocks an SM, each thread with four vector loads in
// flight before its stores, to keep enough bytes in the air.  The
// contraction at the probe's sizes (64 x 320 x 320) is a few microseconds
// of work for a handful of blocks: launch latency bounds it.  It stages
// 32 x 32 tiles of A and B in shared memory and sums each 32-deep step as a
// fresh partial that is then added to the total, which keeps float32
// rounding close to a pairwise sum's.  The row sum reads (rows, 320) once.
//
// Every entry point returns cudaGetLastError() after its launch (0 when the
// launch was accepted); shapes and strides are in elements, all tensors are
// float32 in device memory, and a kernel allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kCopyThreads = 256;
constexpr int kUnroll = 4;       // vectors a copy thread has in flight
constexpr int kTile = 32;        // the transpose's and the product's tile
constexpr int kTileRows = 8;     // 32 x 8 threads cover a tile in 4 steps
constexpr int kSumThreads = 256; // row sum: 8 warps, a row each

template <int kVec>
struct VecOf;
template <>
struct VecOf<1> {
  using T = float;
};
template <>
struct VecOf<2> {
  using T = float2;
};
template <>
struct VecOf<4> {
  using T = float4;
};

__device__ __forceinline__ float scaled(float s, float v) {
  return __fmul_rn(s, v);
}
__device__ __forceinline__ float2 scaled(float s, float2 v) {
  return make_float2(__fmul_rn(s, v.x), __fmul_rn(s, v.y));
}
__device__ __forceinline__ float4 scaled(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z),
                     __fmul_rn(s, v.w));
}

// y = s x over n floats as kVec-float vectors, grid-stride, each thread
// issuing kUnroll loads before its kUnroll stores; the n % kVec tail is
// scalar.  same_tile: every block walks the whole range itself (the
// dispatch probe's grid, each step the same block).
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads)
scale_copy_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n, float s, int same_tile) {
  using V = typename VecOf<kVec>::T;
  const long long start =
      same_tile ? threadIdx.x
                : static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride =
      same_tile ? blockDim.x : static_cast<long long>(gridDim.x) * blockDim.x;
  const long long nvec = n / kVec;
  const V* xv = reinterpret_cast<const V*>(x);
  V* yv = reinterpret_cast<V*>(y);
  for (long long base = start; base < nvec; base += kUnroll * stride) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) v[u] = xv[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < nvec) yv[i] = scaled(s, v[u]);
    }
  }
  for (long long i = nvec * kVec + start; i < n; i += stride) {
    y[i] = scaled(s, x[i]);
  }
}

// One block: a 32-column strip of one batch entry's (R, C) matrix, over
// rows_per_block rows (32 at a time) and batch_per_block batch entries.
// Loads read 32 consecutive columns of a row (stride sc apart), stores write
// 32 consecutive r of an output row; the tile's pitch of 33 keeps the
// column-wise reads of the tile on 32 distinct banks.
__global__ void __launch_bounds__(kTile * kTileRows)
permute_kernel(const float* __restrict__ x, float* __restrict__ y0,
               float* __restrict__ y1, long long nb, long long nr,
               long long nc, long long sb, long long sr, long long sc, float s,
               int rows_per_block, int batch_per_block, long long ctiles,
               long long rtiles) {
  __shared__ float tile[kTile][kTile + 1];
  const long long id = blockIdx.x;
  const long long ct = id % ctiles;
  const long long rt = (id / ctiles) % rtiles;
  const long long bt = id / (ctiles * rtiles);
  const int tx = threadIdx.x, ty = threadIdx.y;
  const long long c0 = ct * kTile;
  const long long half = nc / 2;
  for (long long b = bt * batch_per_block;
       b < nb && b < (bt + 1) * batch_per_block; ++b) {
    const float* xb = x + b * sb;
    for (long long r0 = rt * rows_per_block;
         r0 < nr && r0 < (rt + 1) * rows_per_block; r0 += kTile) {
      for (int j = ty; j < kTile; j += kTileRows) {
        const long long r = r0 + j, c = c0 + tx;
        if (r < nr && c < nc) tile[j][tx] = xb[r * sr + c * sc];
      }
      __syncthreads();
      for (int j = ty; j < kTile; j += kTileRows) {
        const long long c = c0 + j, r = r0 + tx;
        if (r < nr && c < nc) {
          const float v = __fmul_rn(s, tile[tx][j]);
          if (y1 == nullptr) {
            y0[(b * nc + c) * nr + r] = v;
          } else if (c < half) {
            y0[(b * half + c) * nr + r] = v;
          } else {
            y1[(b * half + c - half) * nr + r] = v;
          }
        }
      }
      __syncthreads();
    }
  }
}

// C (m, n) = A (m, k) B (k, n); a block computes a 32 x 32 tile, a thread 4
// rows of one column.  Each 32-deep step sums into a fresh partial with
// IEEE FMAs, added to the total after the step.  With sf: out row m + 1
// takes product row m unless m + 1 starts a group of `group` rows, and the
// first row of each group takes sf's row (group index).
__global__ void __launch_bounds__(kTile * kTileRows)
contract_kernel(const float* __restrict__ a, const float* __restrict__ b,
                float* __restrict__ c, int m, int n, int k, long long sam,
                long long sak, long long sbk, long long sbn,
                const float* __restrict__ sf, long long ssr, long long ssn,
                int group) {
  __shared__ float as[kTile][kTile + 1];   // [row][k]
  __shared__ float bs[kTile][kTile + 1];   // [k][col]
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row0 = blockIdx.y * kTile, col0 = blockIdx.x * kTile;
  float acc[kTile / kTileRows];
#pragma unroll
  for (int i = 0; i < kTile / kTileRows; ++i) acc[i] = 0.0f;
  for (int k0 = 0; k0 < k; k0 += kTile) {
    for (int j = ty; j < kTile; j += kTileRows) {
      const int r = row0 + j, kk = k0 + tx;
      as[j][tx] = (r < m && kk < k) ? a[r * sam + kk * sak] : 0.0f;
      const int kb = k0 + j, col = col0 + tx;
      bs[j][tx] = (kb < k && col < n) ? b[kb * sbk + col * sbn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kTile / kTileRows; ++i) {
      float part = 0.0f;
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) {
        part = __fmaf_rn(as[ty + i * kTileRows][kk], bs[kk][tx], part);
      }
      acc[i] = __fadd_rn(acc[i], part);
    }
    __syncthreads();
  }
  const int col = col0 + tx;
  if (col >= n) return;
#pragma unroll
  for (int i = 0; i < kTile / kTileRows; ++i) {
    const int r = row0 + ty + i * kTileRows;
    if (r >= m) continue;
    if (sf == nullptr) {
      c[static_cast<long long>(r) * n + col] = acc[i];
      continue;
    }
    if (r % group == 0) {
      c[static_cast<long long>(r) * n + col] = sf[(r / group) * ssr + col * ssn];
    }
    if ((r + 1) % group != 0) {
      c[static_cast<long long>(r + 1) * n + col] = acc[i];
    }
  }
}

// y[i] = x[i, 0] + ... + x[i, cols - 1]: lane l sums columns l, l + 32, ...
// in order, then the warp adds its 32 partials as a tree.
__global__ void __launch_bounds__(kSumThreads)
row_sum_kernel(const float* __restrict__ x, float* __restrict__ y,
               long long rows, int cols, long long row_stride) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (kSumThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float* xr = x + row * row_stride;
  float part = 0.0f;
  for (int j = lane; j < cols; j += 32) part = __fadd_rn(part, xr[j]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    part = __fadd_rn(part, __shfl_down_sync(0xffffffffu, part, off));
  }
  if (lane == 0) y[row] = part;
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess) {
    return 0;
  }
  return sms;
}

}  // namespace

// y = scale x over n floats with vec_bytes (4, 8 or 16) loads and stores;
// x and y aligned to vec_bytes.  same_tile_blocks = 0: one pass over the
// range by a grid that fills the card; G > 0: G blocks that each rewrite
// the whole range (a tile of at most a few thousand floats).
extern "C" int sdsp_scale_copy_f32(const float* x, float* y, long long n,
                                   float scale, int vec_bytes,
                                   int same_tile_blocks, int device,
                                   void* stream) {
  if (n < 0 || same_tile_blocks < 0 ||
      (vec_bytes != 4 && vec_bytes != 8 && vec_bytes != 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const int vec = vec_bytes / 4;
  long long blocks = same_tile_blocks;
  if (blocks == 0) {
    const long long per_block = static_cast<long long>(kCopyThreads) * kUnroll;
    const long long need = (n / vec + per_block - 1) / per_block;
    const long long fill = 8LL * sm_count(device);
    blocks = need < fill ? need : fill;
    if (blocks < 1) blocks = 1;
  }
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int same = same_tile_blocks > 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    scale_copy_kernel<4><<<static_cast<unsigned>(blocks), kCopyThreads, 0, st>>>(
        x, y, n, scale, same);
  } else if (vec == 2) {
    scale_copy_kernel<2><<<static_cast<unsigned>(blocks), kCopyThreads, 0, st>>>(
        x, y, n, scale, same);
  } else {
    scale_copy_kernel<1><<<static_cast<unsigned>(blocks), kCopyThreads, 0, st>>>(
        x, y, n, scale, same);
  }
  return static_cast<int>(cudaGetLastError());
}

// y[b, c, r] = scale x[b, r, c] for x read at b sb + r sr + c sc.  y1 null:
// y0 is (nb, nc, nr); else nc is even and y0 / y1 are the (nb, nc / 2, nr)
// planes of c < nc / 2 and c >= nc / 2.  A block covers rows_per_block rows
// (a multiple of 32) of batch_per_block batch entries.
extern "C" int sdsp_permute_f32(const float* x, float* y0, float* y1,
                                long long nb, long long nr, long long nc,
                                long long sb, long long sr, long long sc,
                                float scale, int rows_per_block,
                                int batch_per_block, int device, void* stream) {
  if (nb < 0 || nr < 0 || nc < 0 || rows_per_block < kTile ||
      rows_per_block % kTile != 0 || batch_per_block < 1 ||
      (y1 != nullptr && nc % 2 != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0 || nr == 0 || nc == 0) return static_cast<int>(cudaSuccess);
  const long long ctiles = (nc + kTile - 1) / kTile;
  const long long rtiles = (nr + rows_per_block - 1) / rows_per_block;
  const long long btiles = (nb + batch_per_block - 1) / batch_per_block;
  const long long blocks = ctiles * rtiles * btiles;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  permute_kernel<<<static_cast<unsigned>(blocks), dim3(kTile, kTileRows), 0,
                   static_cast<cudaStream_t>(stream)>>>(
      x, y0, y1, nb, nr, nc, sb, sr, sc, scale, rows_per_block,
      batch_per_block, ctiles, rtiles);
  return static_cast<int>(cudaGetLastError());
}

// c (m, n) contiguous = a (m, k) b (k, n), read at r sam + kk sak and
// kk sbk + col sbn.  sf null: the product.  Else m is a multiple of `group`
// and c takes the shift-in epilogue, sf (m / group, n) read at
// g ssr + col ssn.
extern "C" int sdsp_contract_f32(const float* a, const float* b, float* c,
                                 int m, int n, int k, long long sam,
                                 long long sak, long long sbk, long long sbn,
                                 const float* sf, long long ssr, long long ssn,
                                 int group, int device, void* stream) {
  if (m < 0 || n < 0 || k < 0 ||
      (sf != nullptr && (group < 1 || m % group != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  contract_kernel<<<grid, dim3(kTile, kTileRows), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      a, b, c, m, n, k, sam, sak, sbk, sbn, sf, ssr, ssn, group);
  return static_cast<int>(cudaGetLastError());
}

// y[i] = sum over j < cols of x[i row_stride + j], i < rows.
extern "C" int sdsp_row_sum_f32(const float* x, float* y, long long rows,
                                int cols, long long row_stride, int device,
                                void* stream) {
  if (rows < 0 || cols < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (rows + kSumThreads / 32 - 1) / (kSumThreads / 32);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  row_sum_kernel<<<static_cast<unsigned>(blocks), kSumThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(x, y, rows, cols,
                                                        row_stride);
  return static_cast<int>(cudaGetLastError());
}
