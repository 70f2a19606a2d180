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
//                 minor axes of a strided (B, R, C) view through 32 KB
//                 shared-memory tiles, optionally split at C/2 into two
//                 output planes.  Replaces probe_store.py:68 (body_regmix),
//                 probe_relayout.py:33, probe_transpose.py:82 and
//                 probe_mosaic.py:129 (k4).
//   contract      C = A B for strided float32 operands on the CUDA cores,
//                 IEEE FMAs only (no TF32, no tensor cores), with an
//                 optional shift-in epilogue: out row j of each group of J
//                 rows takes product row j - 1, and row 0 takes sf.
//                 Replaces probe_mosaic.py:36 (k1) and :62 (k2).
//   row_sum       y[i] = sum_j x[i, j], one warp a row.  Replaces
//                 probe_mosaic.py:97 (k3).
//
// What bounds them: the copies and transposes move every byte once each way
// and do at most one multiply a value, so device memory bounds them
// (3.35 TB/s).  The row sum reads (rows, 320) once.
//
// - The copy: a one-shot grid, each thread moving kCopyBytes = 16 bytes
//   (one 16-byte vector, two 8-byte or four 4-byte ones, each width's
//   fastest), all loaded before any is stored, from one 64-bit base
//   address, with no loop and no bound check but in the last block; loads
//   skip L1 and are the first out of L2 (an evict-first policy), stores
//   stream.  It runs level with the card's own device-to-device copy (a
//   ring of TMA bulk copies in persistent blocks measured 5 % slower).
// - The transpose: a tile is TB batch entries x TR rows x TC columns of the
//   input, 8192 floats (32 KB), the sides powers of two picked from the
//   shape by kernels/probes.py permute_plan (TC = C rounded up, 16 to 128;
//   TR up to 8192 / TC; a narrow R or C folds batch entries into the tile,
//   so at C = 16 a tile is 512 rows, one 32 KB run of the input, and at
//   R = 16 four whole batch entries).  It is read in 16-byte copies along
//   C (cp.async) into shared memory in input order, each 16-byte slot
//   XOR-swizzled by its row (perm_swizzle), and a lane then owns a 4 x 4
//   block: four 16-byte reads (a row each, a quarter-warp on 8 distinct
//   bank groups) and four 16-byte stores along R (a column each, a
//   quarter-warp 128 contiguous bytes, 64 at TR = 16).  Persistent blocks
//   take the tiles in turn with the next tile's copies in flight (a double
//   buffer), in the order of the JAX probe's blocks (rows_per_block x
//   batch_per_block, a "unit"), a tile's place worked out once in 32-bit
//   arithmetic.  A view whose strides, sizes or base pointers do not allow
//   16-byte accesses takes the same tiles in 4-byte copies and stores.
//
// The contraction keeps one rule in both its forms: each 32-deep K step's
// products sum into a fresh partial (IEEE FMAs, k in order) that is then
// added to a total, which keeps float32 rounding close to a pairwise sum's.
// The order in which the partials are added is fixed by the form alone (so
// by N alone): in K order in the tiled form, in four interleaved groups in
// the skinny form.  So a row's bits depend neither on block timing, nor on
// the row count M, nor on the card: contract(a[:r]) is contract(a)[:r]
// bit for bit.  What bounds it depends on the shape, and the form follows
// the shape:
//
// - tiled (N > 16): FMAs, 67 TFLOP/s, at the chain's (16384, 320) x (320, 320);
//   launch latency at the probe's (64, 320) x (320, 320), a few microseconds of
//   work.  A thread owns 8 rows x 4 columns of C, so a 16-byte shared-memory
//   load feeds 8 or 16 FMAs; a block owns 128 x 64 of C (256 threads, two
//   blocks an SM) where those tiles still give every SM two blocks, else 64 x
//   64 (128 threads, three).  A and B are staged by cp.async in a ring of three
//   K steps; where both operands' rows are contiguous and aligned, an instance
//   of 16-byte copies whose addresses are set up once a block (each step then
//   adds its offset: the K loop is 83 % FMAs), else 4-byte copies of any
//   strides.  A warp's A reads are two rows on different bank groups (pitch
//   36), its B reads consecutive 16-byte slots.  Where the tiles cannot fill
//   the card (the probe: 5 tiles for 132 SMs) each K step of a tile goes to
//   a block of its own (10 a tile at the probe, at most 16), and a tile's
//   blocks form a thread-block cluster: each leaves its partial in its own
//   shared memory, and after the cluster's barrier block r adds rows r,
//   r + S, ... of the S partials, read from its peers' shared memory, in K
//   order from +0, which gives the bits of the unsplit sum.  One launch, no
//   workspace and no state beyond it: calls on any streams share nothing.
// - skinny (N <= 16; the probe's and the prepass's x KT, N = 10): device
//   memory, A read once (289 MB at the chain's (524288, 128) x (128, 10), 0.086
//   ms at 3.35 TB/s).  A block owns 32 rows of C, one a lane, and its KG warps
//   split the K steps (warp g takes g, g + KG, ...), each streaming A's 32 rows
//   of a step in 16-byte copies (whole 128-byte rows) through a ring of two,
//   with B's 32 x N slice of the step read as a broadcast; the instance is
//   templated on N, so a lane's N partials sit in registers.  Step s adds to
//   group s % 4 (a warp keeps 4 / KG groups' totals); the four groups' totals
//   meet in shared memory, are added in group order and go out as
//   consecutive floats, whatever KG.  KG = 4 where the blocks are few (the
//   probe's 64: a step a warp, latency), 2 where they are many (the chain's
//   16384: two steps of each warp in flight).  A row's 16-byte reads (pitch
//   36) put a quarter-warp's 8 rows on 8 bank groups.
//
// Every entry point returns cudaGetLastError() after its launch (0 when the
// launch was accepted); shapes and strides are in elements, all tensors are
// float32 in device memory, and a kernel allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <utility>

namespace {

constexpr int kSumThreads = 256; // row sum: 8 warps, a row each

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess) {
    return 0;
  }
  return sms;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
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

// -- scale_copy ----------------------------------------------------------------

constexpr int kCopyThreads = 256;
constexpr int kCopyBytes = 16;        // bytes a thread: 1, 2 or 4 vectors
constexpr bool kStreamHints = true;   // evict-first loads, streaming stores

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

// An L2 policy under which the lines a load brings in are the first to go.
__device__ __forceinline__ unsigned long long evict_first() {
  unsigned long long p;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// Loads of data read once: not kept in L1, first out of L2.
__device__ __forceinline__ float load_once(const float* p,
                                           unsigned long long pol) {
  float v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.f32 %0, [%1], %2;"
      : "=f"(v)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float2 load_once(const float2* p,
                                            unsigned long long pol) {
  float2 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v2.f32 {%0, %1}, [%2], "
      "%3;"
      : "=f"(v.x), "=f"(v.y)
      : "l"(p), "l"(pol));
  return v;
}
__device__ __forceinline__ float4 load_once(const float4* p,
                                            unsigned long long pol) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, "
      "[%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p), "l"(pol));
  return v;
}

template <typename V>
__device__ __forceinline__ V load_x(const V* p, unsigned long long pol) {
  if constexpr (kStreamHints) {
    return load_once(p, pol);
  } else {
    return *p;
  }
}

template <typename V>
__device__ __forceinline__ void store_y(V* p, V v) {
  if constexpr (kStreamHints) {
    __stcs(p, v);
  } else {
    *p = v;
  }
}

// y = s x over n floats as kVec-float vectors: thread t of block k owns
// vectors k kCopyThreads kCopyVecs + t + u kCopyThreads, u < kCopyVecs
// (kCopyBytes a thread), all loaded before any is stored; only the last
// block checks bounds.  Block 0 also writes the n % kVec tail.
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads)
scale_copy_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n, float s) {
  using V = typename VecOf<kVec>::T;
  constexpr int kCopyVecs = kCopyBytes / sizeof(V);
  const long long nvec = n / kVec;
  const long long first =
      static_cast<long long>(blockIdx.x) * (kCopyThreads * kCopyVecs) +
      threadIdx.x;
  const V* xv = reinterpret_cast<const V*>(x) + first;
  V* yv = reinterpret_cast<V*>(y) + first;
  const unsigned long long pol = kStreamHints ? evict_first() : 0ull;
  V v[kCopyVecs];
  if (first + (kCopyVecs - 1) * kCopyThreads < nvec) {
#pragma unroll
    for (int u = 0; u < kCopyVecs; ++u) v[u] = load_x(xv + u * kCopyThreads, pol);
#pragma unroll
    for (int u = 0; u < kCopyVecs; ++u) {
      store_y(yv + u * kCopyThreads, scaled(s, v[u]));
    }
  } else {
#pragma unroll
    for (int u = 0; u < kCopyVecs; ++u) {
      if (first + u * kCopyThreads < nvec) {
        v[u] = load_x(xv + u * kCopyThreads, pol);
      }
    }
#pragma unroll
    for (int u = 0; u < kCopyVecs; ++u) {
      if (first + u * kCopyThreads < nvec) {
        store_y(yv + u * kCopyThreads, scaled(s, v[u]));
      }
    }
  }
  if (blockIdx.x == 0 && threadIdx.x < n - nvec * kVec) {
    const long long i = nvec * kVec + threadIdx.x;
    y[i] = __fmul_rn(s, x[i]);
  }
}

// Same-tile mode: every block rewrites all n floats (a tile of a few
// thousand), as each step of the TPU probe's grid rewrote one block.
template <int kVec>
__global__ void __launch_bounds__(kCopyThreads)
scale_tile_kernel(const float* __restrict__ x, float* __restrict__ y,
                  long long n, float s) {
  using V = typename VecOf<kVec>::T;
  const long long nvec = n / kVec;
  for (long long i = threadIdx.x; i < nvec; i += kCopyThreads) {
    reinterpret_cast<V*>(y)[i] = scaled(s, reinterpret_cast<const V*>(x)[i]);
  }
  for (long long i = nvec * kVec + threadIdx.x; i < n; i += kCopyThreads) {
    y[i] = __fmul_rn(s, x[i]);
  }
}

// -- permute -------------------------------------------------------------------

constexpr int kPermThreads = 256;
constexpr int kPermTile = 8192;       // floats a tile (kernels/probes.py)
constexpr size_t kPermSmem = 2 * sizeof(float) * kPermTile;  // two tiles

struct PermArgs {
  const float* x;
  float* y0;
  float* y1;  // null: one output
  long long nb, nr, nc, sb, sr, sc;
  float s;
  int ltr, ltc, tb;  // a tile: tb batch entries x 2^ltr rows x 2^ltc columns
  int tile;          // its floats, kPermTile
  unsigned nbt, nrt, nct, tiles;  // tiles along b, r, c, and in all
  unsigned ub, ur;   // a unit: ub batch tiles x ur row tiles, within those
};

struct Tile {
  long long b0, r0, c0;  // its first batch entry, row and column
  bool whole;            // all of it inside the view: no bound checks
};

// Where 16-byte slot q of a tile (input order, (b, r, c)) sits: q ^
// perm_swizzle(r).  The XOR stays within 8 slots, one row of TC >= 32 or
// two rows of one r / 4 (TC = 16).  A quarter-warp's 16-byte reads of the
// stores are one slot of 8 consecutive r / 4 (TR >= 32), or two
// neighbouring slots of 4 consecutive r / 4 (TR = 16): on 8 distinct
// 16-byte bank groups either way.
__device__ __forceinline__ int perm_swizzle(int r, int ltr) {
  return ltr >= 5 ? (r >> 2) & 7 : (r >> 1) & 6;
}

// Tile t of the order: units of ub batch tiles x ur row tiles (those at
// the ends may be short) in (batch, row) order, and within a unit the tiles
// in (b, r, c) order.
__device__ __forceinline__ Tile tile_at(const PermArgs& a, unsigned t) {
  const unsigned band = a.ub * a.nrt * a.nct;  // a row of whole units
  const unsigned ubi = t / band;
  t -= ubi * band;
  const unsigned ubn = min(a.ub, a.nbt - ubi * a.ub);
  const unsigned unit = ubn * a.ur * a.nct;
  const unsigned uri = t / unit;
  t -= uri * unit;
  const unsigned urn = min(a.ur, a.nrt - uri * a.ur);
  const unsigned per_b = urn * a.nct;
  const unsigned bi = t / per_b;
  t -= bi * per_b;
  const unsigned ri = t / a.nct;
  Tile out;
  out.b0 = static_cast<long long>(ubi * a.ub + bi) * a.tb;
  out.r0 = static_cast<long long>(uri * a.ur + ri) << a.ltr;
  out.c0 = static_cast<long long>(t - ri * a.nct) << a.ltc;
  out.whole = out.b0 + a.tb <= a.nb && out.r0 + (1 << a.ltr) <= a.nr &&
              out.c0 + (1 << a.ltc) <= a.nc;
  return out;
}

// Tile `at` into `st`: kVec, 16-byte copies of 4 columns (thread `tid`
// takes slots tid, tid + 256, ...), else 4-byte copies of any strides;
// then one commit.
template <bool kVec>
__device__ __forceinline__ void perm_load(const PermArgs& a, float* st,
                                          const Tile& at, int tid) {
  const float* xt = a.x + at.b0 * a.sb + at.r0 * a.sr + at.c0 * a.sc;
  const int mc = (1 << a.ltc) - 1, mr = (1 << a.ltr) - 1;
  const int per = kVec ? 4 : 1;
  for (int e = per * tid; e < a.tile; e += per * kPermThreads) {
    const int c = e & mc, r = (e >> a.ltc) & mr, bi = e >> (a.ltc + a.ltr);
    if (!at.whole && (at.b0 + bi >= a.nb || at.r0 + r >= a.nr ||
                      at.c0 + c >= a.nc)) {
      continue;
    }
    const float* src = xt + bi * a.sb + r * a.sr + c * (kVec ? 1 : a.sc);
    float* dst = st + 4 * ((e >> 2) ^ perm_swizzle(r, a.ltr)) + (e & 3);
    if constexpr (kVec) {
      cp_async16(dst, src, true);
    } else {
      cp_async4(dst, src, true);
    }
  }
  cp_async_commit();
}

__device__ __forceinline__ float part(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Tile `at` from `st` to the output, scaled.  A lane owns a 4 x 4 block,
// rows 4 r4 .. 4 r4 + 3 of 4-column slot s: four 16-byte reads (a row
// each), then each column's four rows in one 16-byte store (kVec) or four
// 4-byte ones.  A warp takes units of 32 blocks (warp w units w, w + 8,
// ...): TR >= 32, 4 slots x 8 r4, lane l slot l / 8 and r4 l % 8, so a
// quarter-warp stores 128 contiguous bytes of a column; TR = 16, 8 slots x
// 4 r4 (a quarter-warp two columns of 64 bytes).
template <bool kVec>
__device__ __forceinline__ void perm_store(const PermArgs& a, const float* st,
                                           const Tile& at, int tid) {
  const int lane = tid & 31;
  const int lcs = a.ltc - 2;  // log2 of the 4-column slots of a row
  const long long half = a.nc / 2;
  for (int u = tid >> 5; u < a.tile / 512; u += kPermThreads / 32) {
    int s, r4;
    if (a.ltr >= 5) {
      r4 = 8 * (u & ((1 << (a.ltr - 5)) - 1)) + (lane & 7);
      s = 4 * (u >> (a.ltr - 5)) + (lane >> 3);
    } else {
      r4 = lane & 3;
      s = 8 * u + (lane >> 2);
    }
    const int bi = s >> lcs, cg = s & ((1 << lcs) - 1);
    const long long gb = at.b0 + bi, gc = at.c0 + 4 * cg, gr = at.r0 + 4 * r4;
    if (!at.whole && (gb >= a.nb || gc >= a.nc || gr >= a.nr)) continue;
    float4 v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * r4 + i;
      const int q = (((bi << a.ltr) + r) << lcs) + cg;
      v[i] = *reinterpret_cast<const float4*>(
          st + 4 * (q ^ perm_swizzle(r, a.ltr)));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long c = gc + k;
      if (!kVec && c >= a.nc) break;
      float* row;
      if (a.y1 == nullptr) {
        row = a.y0 + (gb * a.nc + c) * a.nr;
      } else if (c < half) {
        row = a.y0 + (gb * half + c) * a.nr;
      } else {
        row = a.y1 + (gb * half + c - half) * a.nr;
      }
      const float4 w = make_float4(
          __fmul_rn(a.s, part(v[0], k)), __fmul_rn(a.s, part(v[1], k)),
          __fmul_rn(a.s, part(v[2], k)), __fmul_rn(a.s, part(v[3], k)));
      if constexpr (kVec) {
        *reinterpret_cast<float4*>(row + gr) = w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (gr + j < a.nr) row[gr + j] = part(w, j);
        }
      }
    }
  }
}

// Persistent blocks: block k moves tiles k, k + G, ..., tile t + G's copies
// in flight while tile t is stored.
template <bool kVec>
__global__ void __launch_bounds__(kPermThreads)
permute_kernel(const PermArgs a) {
  extern __shared__ __align__(16) float stage[];
  const int tid = threadIdx.x;
  unsigned t = blockIdx.x;
  if (t >= a.tiles) return;
  Tile cur = tile_at(a, t);
  perm_load<kVec>(a, stage, cur, tid);
  for (int k = 0; t < a.tiles; ++k, t += gridDim.x) {
    const unsigned tn = t + gridDim.x;
    const Tile next = tn < a.tiles ? tile_at(a, tn) : cur;
    const float* here = stage + (k & 1) * a.tile;
    if (tn < a.tiles) {
      perm_load<kVec>(a, stage + ((k + 1) & 1) * a.tile, next, tid);
    } else {
      cp_async_commit();
    }
    cp_async_wait<1>();
    __syncthreads();
    perm_store<kVec>(a, here, cur, tid);
    __syncthreads();  // this stage is refilled next
    cur = next;
  }
}

// -- contract ----------------------------------------------------------------

constexpr int kKStep = 32;                // a fresh partial every 32 k
constexpr int kApitch = kKStep + 4;       // floats a staged row of A
// Tiled form: a block owns a BM x kBN tile of C, BM = 64 (128 threads,
// three blocks an SM) or 128 (256 threads, two); thread (ty, tx) =
// (t / kColThreads, t % kColThreads) owns the kTM rows ty + (BM / kTM) i
// and the kTN columns 4 tx + 4 kColThreads h + j (j < 4), in a ring of
// kStages K steps.
constexpr int kSplitBM = 64, kBigBM = 128, kBN = 64;
constexpr int kTM = 8, kTN = 4;
constexpr int kColThreads = kBN / kTN;
constexpr int kStages = 3;
constexpr int kBpitch = kBN + 4;          // floats a staged row of B
constexpr int kMaxSplit = 16;             // the largest cluster on the card
__host__ __device__ constexpr int tiled_threads(int bm) {
  return bm / kTM * kColThreads;
}
__host__ __device__ constexpr int tiled_blocks(int bm) {
  return bm == kSplitBM ? 3 : 2;
}
__host__ __device__ constexpr int tiled_stage(int bm) {
  return bm * kApitch + kKStep * kBpitch;
}
// Skinny form: a block of KG warps owns 32 rows of C; warp g takes K steps
// g, g + KG, ... in a ring of two, and step s adds to group s % kGroups.
constexpr int kSkinnyRows = 32;
constexpr int kSkinnyMaxN = 16;
constexpr int kGroups = 4;

struct Operands {
  const float* a;
  const float* b;
  float* c;
  int m, n, k;
  long long sam, sak, sbk, sbn;
  const float* sf;  // null: no shift-in epilogue
  long long ssr, ssn;
  int group;
  int a_vec, b_vec;  // 16-byte copies of A's rows / B's rows
  int c_vec;         // 16-byte stores of C's rows
};

// A's rows m0 .. m0 + rows - 1 at k0 .. k0 + 31 into as (pitch kApitch),
// zeros past A; thread `t` of kThreadsPer copies.
template <int kThreadsPer>
__device__ __forceinline__ void stage_a(const Operands& o, float* as, int m0,
                                        int rows, int k0, int t) {
  if (o.a_vec) {
    for (int e = t; e < rows * (kKStep / 4); e += kThreadsPer) {
      const int r = e / (kKStep / 4), q = e % (kKStep / 4);
      const int gr = m0 + r, gk = k0 + 4 * q;
      const bool ok = gr < o.m && gk < o.k;
      cp_async16(as + r * kApitch + 4 * q, ok ? o.a + gr * o.sam + gk : o.a,
                 ok);
    }
  } else {
    const bool by_rows = o.sam == 1 && o.sak != 1;  // A's columns contiguous
    for (int e = t; e < rows * kKStep; e += kThreadsPer) {
      const int r = by_rows ? e % rows : e / kKStep;
      const int kk = by_rows ? e / rows : e % kKStep;
      const int gr = m0 + r, gk = k0 + kk;
      const bool ok = gr < o.m && gk < o.k;
      cp_async4(as + r * kApitch + kk,
                ok ? o.a + gr * o.sam + gk * o.sak : o.a, ok);
    }
  }
}

// B's rows k0 .. k0 + 31 at columns n0 .. n0 + width - 1 into bs (pitch
// `pitch`), zeros past B; thread `t` of kThreadsPer copies.
template <int kThreadsPer>
__device__ __forceinline__ void stage_b(const Operands& o, float* bs,
                                        int pitch, int n0, int width, int k0,
                                        int t) {
  if (o.b_vec) {
    const int chunks = width / 4;
    for (int e = t; e < kKStep * chunks; e += kThreadsPer) {
      const int kk = e / chunks, q = e % chunks;
      const int gk = k0 + kk, gn = n0 + 4 * q;
      const bool ok = gk < o.k && gn < o.n;
      cp_async16(bs + kk * pitch + 4 * q, ok ? o.b + gk * o.sbk + gn : o.b,
                 ok);
    }
  } else {
    const bool by_k = o.sbk == 1 && o.sbn != 1;  // B's columns contiguous
    for (int e = t; e < kKStep * width; e += kThreadsPer) {
      const int kk = by_k ? e % kKStep : e / width;
      const int nn = by_k ? e / kKStep : e % width;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool ok = gk < o.k && gn < o.n;
      cp_async4(bs + kk * pitch + nn,
                ok ? o.b + gk * o.sbk + gn * o.sbn : o.b, ok);
    }
  }
}

// Output (r, col) = v, or with the shift-in: row r + 1 takes v unless it
// starts a group, and row r takes sf's row when r starts one.
__device__ __forceinline__ void put(const Operands& o, int r, int col,
                                    float v) {
  const long long n = o.n;
  if (o.sf == nullptr) {
    o.c[r * n + col] = v;
    return;
  }
  if (r % o.group == 0) {
    o.c[r * n + col] = o.sf[(r / o.group) * o.ssr + col * o.ssn];
  }
  if ((r + 1) % o.group != 0) o.c[(r + 1) * n + col] = v;
}

// C's tile `blockIdx.x` (tiles_n tiles a row of tiles): every K step, or
// with gridDim.y = S > 1 the K step blockIdx.y alone, in a cluster of the
// tile's S blocks.  Each step's products sum into a fresh partial (IEEE
// FMAs, k in order) that is then added to the total, from +0.  With S > 1
// the cluster adds the S blocks' totals in K order, from +0, and stores: 0 +
// p is p but for p = -0, and a total that starts at +0 is never -0, so
// these are the bits of the unsplit sum.
template <bool kVec, int kBM>
__global__ void __launch_bounds__(tiled_threads(kBM), tiled_blocks(kBM))
contract_tiled_kernel(const Operands o, int tiles_n) {
  constexpr int kRowThreads = kBM / kTM;
  constexpr int kTiledThreads = tiled_threads(kBM);
  constexpr int kTiledStage = tiled_stage(kBM);
  static_assert(kBM * kBN <= kStages * kTiledStage, "a partial fits the ring");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int ty = tid / kColThreads, tx = tid % kColThreads;
  auto col_of = [&](int j) {
    return 4 * tx + 4 * kColThreads * (j >> 2) + (j & 3);
  };
  const int tile = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int m0 = (tile / tiles_n) * kBM, n0 = (tile % tiles_n) * kBN;
  const int first = split;
  const int count = splits > 1 ? 1 : (o.k + kKStep - 1) / kKStep;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.0f;
  }
  // kVec (A's and B's rows contiguous and aligned): the thread's 16-byte
  // copies are the same rows and columns every K step but for the step's
  // offset, so their addresses are set up once (rows past A clamped to
  // row 0, read as nothing).  Else 4-byte copies of any strides.
  constexpr int kAC = kBM * (kKStep / 4) / kTiledThreads;
  constexpr int kBC = kKStep * (kBN / 4) / kTiledThreads;
  constexpr int kARows = kTiledThreads / (kKStep / 4);
  constexpr int kBRows = kTiledThreads / (kBN / 4);
  const int qa = tid % (kKStep / 4), qb = tid % (kBN / 4);
  const float* a_src[kAC];
  bool a_live[kAC];
#pragma unroll
  for (int u = 0; u < kAC; ++u) {
    const int r = m0 + tid / (kKStep / 4) + u * kARows;
    a_live[u] = r < o.m;
    a_src[u] = o.a + static_cast<long long>(a_live[u] ? r : 0) * o.sam + 4 * qa;
  }
  const bool b_col = n0 + 4 * qb < o.n;
  const float* b_src = o.b + static_cast<long long>(tid / (kBN / 4)) * o.sbk +
                       (b_col ? n0 + 4 * qb : 0);
  const long long b_rows = kBRows * o.sbk;
  auto stage = [&](int st) {
    float* as = smem + (st % kStages) * kTiledStage;
    float* bs = as + kBM * kApitch;
    const int k0 = (first + st) * kKStep;
    if constexpr (kVec) {
      const bool a_in = k0 + 4 * qa < o.k;
#pragma unroll
      for (int u = 0; u < kAC; ++u) {
        cp_async16(as + (tid / (kKStep / 4) + u * kARows) * kApitch + 4 * qa,
                   a_src[u] + (a_in ? k0 : 0), a_live[u] && a_in);
      }
      const float* b_at = b_src + static_cast<long long>(k0) * o.sbk;
#pragma unroll
      for (int u = 0; u < kBC; ++u) {
        const int kk = tid / (kBN / 4) + u * kBRows;
        const bool ok = b_col && k0 + kk < o.k;
        cp_async16(bs + kk * kBpitch + 4 * qb, ok ? b_at + u * b_rows : o.b,
                   ok);
      }
    } else {
      stage_a<kTiledThreads>(o, as, m0, kBM, k0, tid);
      stage_b<kTiledThreads>(o, bs, kBpitch, n0, kBN, k0, tid);
    }
  };
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < count) stage(st);
    cp_async_commit();
  }
  for (int st = 0; st < count; ++st) {
    if (st + kStages - 1 < count) stage(st + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* as = smem + (st % kStages) * kTiledStage;
    const float* bs = as + kBM * kApitch;
    float part[kTM][kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) part[i][j] = 0.0f;
    }
#pragma unroll
    for (int kk = 0; kk < kKStep; kk += 4) {
      float bk[4][kTN];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int j4 = 0; j4 < kTN / 4; ++j4) {
          const float4 v = *reinterpret_cast<const float4*>(
              bs + (kk + q) * kBpitch + col_of(4 * j4));
          bk[q][4 * j4] = v.x;
          bk[q][4 * j4 + 1] = v.y;
          bk[q][4 * j4 + 2] = v.z;
          bk[q][4 * j4 + 3] = v.w;
        }
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(
            as + (ty + kRowThreads * i) * kApitch + kk);
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
#pragma unroll
          for (int j = 0; j < kTN; ++j) {
            part[i][j] = __fmaf_rn(a4[q], bk[q][j], part[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
      }
    }
    __syncthreads();  // this stage is refilled kStages - 1 steps on
  }
  cp_async_wait<0>();

  if (splits > 1) {
    // The ring is free (its last reads are behind the loop's barrier): this
    // block's total goes there, rows of kBN floats.  The cluster's ranks
    // run along y, so rank s holds K step s.
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int i = 0; i < kTM; ++i) {
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        smem[(ty + kRowThreads * i) * kBN + col_of(j)] = acc[i][j];
      }
    }
    cluster.sync();
    const float* theirs[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      theirs[s] = s < splits ? cluster.map_shared_rank(smem, s) : smem;
    }
    for (int rr = split * (kTiledThreads / kBN) + tid / kBN; rr < kBM;
         rr += splits * (kTiledThreads / kBN)) {
      const int r = m0 + rr, col = n0 + tid % kBN;
      float v = 0.0f;
#pragma unroll
      for (int s = 0; s < kMaxSplit; ++s) {
        if (s < splits) v = __fadd_rn(v, theirs[s][rr * kBN + tid % kBN]);
      }
      if (r < o.m && col < o.n) put(o, r, col, v);
    }
    cluster.sync();  // no block leaves while its peers read its partial
    return;
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int r = m0 + ty + kRowThreads * i;
    if (r >= o.m) break;
#pragma unroll
    for (int j4 = 0; j4 < kTN / 4; ++j4) {
      const int c4 = n0 + col_of(4 * j4);
      if (o.c_vec && c4 < o.n) {
        float* row = o.c + static_cast<long long>(r) * o.n;
        reinterpret_cast<float4*>(row)[c4 / 4] =
            make_float4(acc[i][4 * j4], acc[i][4 * j4 + 1], acc[i][4 * j4 + 2],
                        acc[i][4 * j4 + 3]);
        continue;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c4 + j < o.n) put(o, r, c4 + j, acc[i][4 * j4 + j]);
      }
    }
  }
}

// The skinny form, n == NN <= 16: block b owns rows 32 b .. 32 b + 31 of C,
// lane l of each of its KG warps row 32 b + l.  Warp g streams A's 32 rows
// at its K steps g, g + KG, ... through a ring of two stages (16-byte
// copies: a warp's copies are whole 128-byte rows of a step) with B's
// 32 x NN slice of the step, which every lane reads as a broadcast.  Step s
// adds to the total of group s % kGroups: warp g holds groups g, g + KG,
// ...  The groups' totals meet in shared memory, are added in group order
// and go out as consecutive floats: the same sum for KG = 2 and 4.
template <int NN, int KG>
__global__ void __launch_bounds__(32 * KG)
contract_skinny_kernel(const Operands o) {
  static_assert(kGroups % KG == 0, "a warp holds whole groups");
  constexpr int kNP = (NN + 3) & ~3;
  constexpr int kStage = kSkinnyRows * kApitch + kKStep * kNP;
  constexpr int kTotPitch = kNP + 1;
  constexpr int kTot = kSkinnyRows * kTotPitch;  // floats a group's totals
  constexpr int kHeld = kGroups / KG;            // groups a warp holds
  static_assert(kHeld * kTot <= 2 * kStage, "a warp's ring holds its totals");
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* mine = smem + warp * 2 * kStage;
  const int m0 = blockIdx.x * kSkinnyRows;
  const int steps = (o.k + kKStep - 1) / kKStep;
  const int count =
      steps > warp ? (steps - warp + KG - 1) / KG : 0;
  float acc[kHeld][NN];
#pragma unroll
  for (int h = 0; h < kHeld; ++h) {
#pragma unroll
    for (int j = 0; j < NN; ++j) acc[h][j] = 0.0f;
  }
  // The lane's 16-byte copies of A: rows lane / 8 + 4 u, chunk lane % 8,
  // the same every K step but for the step's offset.
  constexpr int kAC = kSkinnyRows * (kKStep / 4) / 32;
  const int qa = lane % (kKStep / 4);
  const float* a_src[kAC];
  bool a_live[kAC];
#pragma unroll
  for (int u = 0; u < kAC; ++u) {
    const int r = m0 + lane / (kKStep / 4) + u * (32 / (kKStep / 4));
    a_live[u] = r < o.m;
    a_src[u] = o.a + static_cast<long long>(a_live[u] ? r : 0) * o.sam + 4 * qa;
  }
  auto stage = [&](int n) {
    float* as = mine + (n & 1) * kStage;
    const int k0 = (warp + KG * n) * kKStep;
    if (o.a_vec) {
      const bool kin = k0 + 4 * qa < o.k;
#pragma unroll
      for (int u = 0; u < kAC; ++u) {
        const int r = lane / (kKStep / 4) + u * (32 / (kKStep / 4));
        const bool ok = a_live[u] && kin;
        cp_async16(as + r * kApitch + 4 * qa, ok ? a_src[u] + k0 : o.a, ok);
      }
    } else {
      stage_a<32>(o, as, m0, kSkinnyRows, k0, lane);
    }
    stage_b<32>(o, as + kSkinnyRows * kApitch, kNP, 0, NN, k0, lane);
  };
  if (count > 0) stage(0);
  cp_async_commit();
  // Step warp + KG n is in group (warp + KG n) % kGroups, the warp's group
  // n % kHeld: the loop takes kHeld steps a trip, one of each held group.
  for (int n0 = 0; n0 < count; n0 += kHeld) {
#pragma unroll
    for (int h = 0; h < kHeld; ++h) {
      const int n = n0 + h;
      if (n >= count) break;
      if (n + 1 < count) stage(n + 1);
      cp_async_commit();
      cp_async_wait<1>();
      __syncwarp();
      const float* as = mine + (n & 1) * kStage + lane * kApitch;
      const float* bs = mine + (n & 1) * kStage + kSkinnyRows * kApitch;
      float part[NN];
#pragma unroll
      for (int j = 0; j < NN; ++j) part[j] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKStep; kk += 4) {
        const float4 av = *reinterpret_cast<const float4*>(as + kk);
        const float a4[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float bk[kNP];
#pragma unroll
          for (int j4 = 0; j4 < kNP / 4; ++j4) {
            const float4 bv =
                reinterpret_cast<const float4*>(bs + (kk + q) * kNP)[j4];
            bk[4 * j4] = bv.x;
            bk[4 * j4 + 1] = bv.y;
            bk[4 * j4 + 2] = bv.z;
            bk[4 * j4 + 3] = bv.w;
          }
#pragma unroll
          for (int j = 0; j < NN; ++j) {
            part[j] = __fmaf_rn(a4[q], bk[j], part[j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < NN; ++j) acc[h][j] = __fadd_rn(acc[h][j], part[j]);
      __syncwarp();  // this stage is refilled next step
    }
  }
  cp_async_wait<0>();
  __syncwarp();
#pragma unroll
  for (int h = 0; h < kHeld; ++h) {
#pragma unroll
    for (int j = 0; j < NN; ++j) {
      mine[h * kTot + lane * kTotPitch + j] = acc[h][j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSkinnyRows * NN; e += 32 * KG) {
    const int r = e / NN, j = e % NN;
    if (m0 + r >= o.m) break;
    float v = smem[r * kTotPitch + j];
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      v = __fadd_rn(v, smem[(g % KG) * 2 * kStage + (g / KG) * kTot +
                            r * kTotPitch + j]);
    }
    put(o, m0 + r, j, v);
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

// One block a tile, or with `split` one a K step of each tile, the steps
// of a tile a cluster (2 to kMaxSplit steps).  Where the card cannot hold
// such a cluster, one block a tile: the same bits.
template <bool kVec, int kBM>
cudaError_t launch_tiled(const Operands& o, bool split, cudaStream_t st) {
  constexpr size_t smem = sizeof(float) * kStages * tiled_stage(kBM);
  const auto fn = contract_tiled_kernel<kVec, kBM>;
  const int steps = (o.k + kKStep - 1) / kKStep;
  const long long tiles_n = (o.n + kBN - 1) / kBN;
  const long long tiles = (o.m + kBM - 1) / kBM * tiles_n;
  if (tiles > 0x7fffffffLL || (split && (steps < 2 || steps > kMaxSplit))) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster[1] = {};
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = split ? steps : 1;
  cluster[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles), split ? steps : 1);
  cfg.blockDim = dim3(tiled_threads(kBM));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = cluster;
  cfg.numAttrs = split ? 1 : 0;
  if (split) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    int fits = 0;
    err = cudaOccupancyMaxActiveClusters(&fits, fn, &cfg);
    if (err != cudaSuccess) return err;
    if (fits < 1) {
      cfg.gridDim.y = 1;
      cfg.numAttrs = 0;
    }
  }
  err = cudaLaunchKernelEx(&cfg, fn, o, static_cast<int>(tiles_n));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int NN, int KG>
cudaError_t launch_skinny(const Operands& o, cudaStream_t st) {
  constexpr int kNP = (NN + 3) & ~3;
  constexpr size_t smem =
      sizeof(float) * KG * 2 * (kSkinnyRows * kApitch + kKStep * kNP);
  cudaError_t err = cudaFuncSetAttribute(
      contract_skinny_kernel<NN, KG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const long long blocks = (o.m + kSkinnyRows - 1) / kSkinnyRows;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  contract_skinny_kernel<NN, KG>
      <<<static_cast<unsigned>(blocks), 32 * KG, smem, st>>>(o);
  return cudaGetLastError();
}

// The skinny instance for o.n: four warps a block split a block's K steps
// where the blocks leave the card's SMs thin (the probe's 64 blocks), two
// where there are blocks to spare (the chain's 16384), which keeps two K
// steps of each warp in flight.
template <int... Ns>
cudaError_t launch_skinny_n(const Operands& o, cudaStream_t st, int sms,
                            std::integer_sequence<int, Ns...>) {
  const bool many = (o.m + kSkinnyRows - 1) / kSkinnyRows >= 8LL * sms;
  cudaError_t err = cudaErrorInvalidValue;
  ((o.n == Ns + 1 ? (err = many ? launch_skinny<Ns + 1, 2>(o, st)
                                : launch_skinny<Ns + 1, 4>(o, st),
                     0)
                  : 0),
   ...);
  return err;
}

// The blocks of a permute instance (kVec) that fill a device, found, and
// the instance's shared memory raised to two tiles, at its first launch
// there; later launches read them back.
constexpr int kMaxDevices = 64;
std::atomic<int> perm_fill[kMaxDevices][2];  // 0: not found yet

cudaError_t perm_blocks(bool vec, int device, long long* out) {
  std::atomic<int>* slot =
      device >= 0 && device < kMaxDevices ? &perm_fill[device][vec] : nullptr;
  const int known = slot ? slot->load(std::memory_order_relaxed) : 0;
  if (known > 0) {
    *out = known;
    return cudaSuccess;
  }
  const auto fn = vec ? permute_kernel<true> : permute_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kPermSmem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn,
                                                      kPermThreads, kPermSmem);
  if (err != cudaSuccess) return err;
  const int fill = (per_sm < 1 ? 1 : per_sm) * sm_count(device);
  if (slot && fill > 0) slot->store(fill, std::memory_order_relaxed);
  *out = fill < 1 ? 1 : fill;
  return cudaSuccess;
}

}  // namespace

// y = scale x over n floats with vec_bytes (4, 8 or 16) loads and stores;
// x and y aligned to vec_bytes.  same_tile_blocks = 0: one pass over the
// range (a one-shot grid); G > 0: G blocks that each rewrite the whole range
// (a tile of at most a few thousand floats).
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (same_tile_blocks > 0) {
    const unsigned g = static_cast<unsigned>(same_tile_blocks);
    if (vec == 4) {
      scale_tile_kernel<4><<<g, kCopyThreads, 0, st>>>(x, y, n, scale);
    } else if (vec == 2) {
      scale_tile_kernel<2><<<g, kCopyThreads, 0, st>>>(x, y, n, scale);
    } else {
      scale_tile_kernel<1><<<g, kCopyThreads, 0, st>>>(x, y, n, scale);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long per_block =
      static_cast<long long>(kCopyThreads) * (kCopyBytes / vec_bytes);
  long long blocks = (n / vec + per_block - 1) / per_block;
  if (blocks < 1) blocks = 1;  // the tail alone
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const unsigned g = static_cast<unsigned>(blocks);
  if (vec == 4) {
    scale_copy_kernel<4><<<g, kCopyThreads, 0, st>>>(x, y, n, scale);
  } else if (vec == 2) {
    scale_copy_kernel<2><<<g, kCopyThreads, 0, st>>>(x, y, n, scale);
  } else {
    scale_copy_kernel<1><<<g, kCopyThreads, 0, st>>>(x, y, n, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

// y[b, c, r] = scale x[b, r, c] for x read at b sb + r sr + c sc.  y1 null:
// y0 is (nb, nc, nr); else nc is even and y0 / y1 are the (nb, nc / 2, nr)
// planes of c < nc / 2 and c >= nc / 2.  A tile is tile_batch x tile_rows x
// tile_cols (powers of two, each side >= 16, kPermTile floats in all;
// kernels/probes.py permute_plan picks them); vec = 1 takes 16-byte copies
// and stores, which need sc = 1, nc, nr, sr and (nb > 1) sb multiples of 4
// and 16-byte aligned x, y0 and y1.  The tiles go in units of
// rows_per_block rows (a multiple of 32) of batch_per_block batch entries.
extern "C" int sdsp_permute_f32(const float* x, float* y0, float* y1,
                                long long nb, long long nr, long long nc,
                                long long sb, long long sr, long long sc,
                                float scale, int rows_per_block,
                                int batch_per_block, int tile_rows,
                                int tile_cols, int tile_batch, int vec,
                                int device, void* stream) {
  auto pow2 = [](int v) { return v >= 16 && (v & (v - 1)) == 0; };
  const long long tile = static_cast<long long>(tile_rows) * tile_cols *
                         (tile_batch < 1 ? 0 : tile_batch);
  if (nb < 0 || nr < 0 || nc < 0 || rows_per_block < 32 ||
      rows_per_block % 32 != 0 || batch_per_block < 1 ||
      (y1 != nullptr && nc % 2 != 0) || !pow2(tile_rows) ||
      !pow2(tile_cols) || tile_batch < 1 || tile != kPermTile) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (vec && !(sc == 1 && nc % 4 == 0 && nr % 4 == 0 && sr % 4 == 0 &&
               (nb <= 1 || sb % 4 == 0) && aligned16(x) && aligned16(y0) &&
               (y1 == nullptr || aligned16(y1)))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 0 || nr == 0 || nc == 0) return static_cast<int>(cudaSuccess);
  PermArgs a{};
  a.x = x;
  a.y0 = y0;
  a.y1 = y1;
  a.nb = nb, a.nr = nr, a.nc = nc, a.sb = sb, a.sr = sr, a.sc = sc;
  a.s = scale;
  a.ltr = __builtin_ctz(tile_rows);
  a.ltc = __builtin_ctz(tile_cols);
  a.tb = tile_batch;
  a.tile = static_cast<int>(tile);
  const long long nbt = (nb + tile_batch - 1) / tile_batch;
  const long long nrt = (nr + tile_rows - 1) / tile_rows;
  const long long nct = (nc + tile_cols - 1) / tile_cols;
  const long long tiles = nbt * nrt * nct;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long ub = (batch_per_block + tile_batch - 1) / tile_batch;
  const long long ur = (rows_per_block + tile_rows - 1) / tile_rows;
  a.nbt = static_cast<unsigned>(nbt);
  a.nrt = static_cast<unsigned>(nrt);
  a.nct = static_cast<unsigned>(nct);
  a.tiles = static_cast<unsigned>(tiles);
  // a unit wider than the view is the view: the same order
  a.ub = static_cast<unsigned>(ub < nbt ? ub : nbt);
  a.ur = static_cast<unsigned>(ur < nrt ? ur : nrt);
  // As many blocks as fit the card, then fewer where that evens the
  // rounds: every block takes ceil(tiles / most) tiles or one fewer.
  long long most = 0;
  err = perm_blocks(vec != 0, device, &most);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rounds = (a.tiles + most - 1) / most;
  const long long blocks = (a.tiles + rounds - 1) / rounds;
  const auto fn = vec ? permute_kernel<true> : permute_kernel<false>;
  fn<<<static_cast<unsigned>(blocks), kPermThreads, kPermSmem,
       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// c (m, n) contiguous = a (m, k) b (k, n), read at r sam + kk sak and
// kk sbk + col sbn.  sf null: the product.  Else m is a multiple of `group`
// and c takes the shift-in epilogue, sf (m / group, n) read at
// g ssr + col ssn.  n <= 16 takes the skinny form (split must be 0); a
// wider n the tiled form, with `split` each of its S = ceil(k / 32) K steps
// in a block of its own (2 <= S <= 16), a tile's S blocks a cluster.  The
// bits are the same with and without `split`.
extern "C" int sdsp_contract_f32(const float* a, const float* b, float* c,
                                 int m, int n, int k, long long sam,
                                 long long sak, long long sbk, long long sbn,
                                 const float* sf, long long ssr, long long ssn,
                                 int group, int split, int device,
                                 void* stream) {
  if (m < 0 || n < 0 || k < 0 ||
      (sf != nullptr && (group < 1 || m % group != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (m == 0 || n == 0) return static_cast<int>(cudaSuccess);
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const Operands o{a, b, c, m, n, k, sam, sak, sbk, sbn, sf, ssr, ssn,
                   group < 1 ? 1 : group,
                   sak == 1 && sam % 4 == 0 && k % 4 == 0 && aligned(a),
                   sbn == 1 && sbk % 4 == 0 && n % 4 == 0 && aligned(b),
                   sf == nullptr && n % 4 == 0 && aligned(c)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= kSkinnyMaxN) {
    if (split) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        launch_skinny_n(o, st, sm_count(device),
                        std::make_integer_sequence<int, kSkinnyMaxN>{}));
  }
  // A launch of one block a tile takes 128-row tiles where they still give
  // every SM two blocks (the chain's (16384, 320) x (320, 320)); a split
  // launch, or one of fewer tiles, takes 64-row tiles.
  const long long big_tiles =
      (m + kBigBM - 1) / kBigBM * ((n + kBN - 1) / kBN);
  cudaError_t e;
  if (o.a_vec && o.b_vec && !split && big_tiles >= 2LL * sm_count(device)) {
    e = launch_tiled<true, kBigBM>(o, false, st);
  } else if (o.a_vec && o.b_vec) {
    e = launch_tiled<true, kSplitBM>(o, split, st);
  } else {
    e = launch_tiled<false, kSplitBM>(o, split, st);
  }
  return static_cast<int>(e);
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
