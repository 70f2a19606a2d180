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
// a Mosaic workaround.  Here a block loads its frames into shared memory,
// runs the register-radix FFT of fft_core.cuh on them (about 5 N log2 N
// flops, 0.25 MFLOP at N = 4096: three radix-16 passes) and writes natural
// order itself.  The inverse runs as conj(FFT(conj(x))): the imaginary plane
// is negated on load and on store.  Real input (no imaginary plane) reads
// zeros.
//
// Frames are read in place with an element stride and a row stride for each
// plane, so rfft_ri's even and odd samples (x[..., 0::2], x[..., 1::2]) are
// read where they lie.  For a power-of-two N the first pass reads its
// butterflies' samples from device memory into registers and the last
// writes its bins there, a warp on 32 consecutive samples or bins: no
// staging pass through shared memory (on the H100 faster at every
// power-of-two size than staging with 16-byte loads and stores, most at
// N = 16384).  With an odd factor the first pass is a small-DFT pass that
// reads each input r times, so the frames are staged through shared memory
// with scalar loads and stores (16-byte ones, where strides and alignment
// allowed, ran no faster at N = 100, 384 and 1152 on the H100).  A block
// holds kBlockElems samples: one frame when N >= 4096, else 4096 / N
// frames, with N / 16 threads a frame, so that a thread holds one radix-16
// butterfly.  N = 16384 needs 128 KB of shared memory, above the 48 KB
// default, hence the opt-in on every launch.
//
// What bounds it: at N = 4096 a complex frame is about 0.25 MFLOP against
// 32 KB read and 32 KB written, about 8 flops a byte, under the card's 20
// (67 TFLOP/s over 3.35 TB/s): device memory is the bound.  A block loads
// its frames, computes with device memory idle, then stores, so the design
// cuts the block's compute to three radix-16 passes and two shared-memory
// exchanges at N = 4096 (against six radix-4 passes before), and keeps
// several blocks on an SM so that one block's loads and stores overlap the
// others' passes.  A 256-thread block is held to 128 registers, two blocks
// and 16 warps an SM: at 64 registers (four blocks) and at 80 (three) the
// radix-16 pass spills, and both ran slower at N = 4096 on the H100.

#include "fft_core.cuh"

namespace {

using namespace sdsp_fft;

constexpr int kEPT = 16;            // values a thread holds through a pass
constexpr int kBlockElems = 4096;   // samples a block holds when N < 4096

struct Frames {
  const float* xr;
  const float* xi;         // null: real input
  long long rs_r, es_r;    // row and element strides of xr
  long long rs_i, es_i;    // of xi
  int frames;
};

// Blocks an SM for each block size: up to 128 registers a thread (1024
// threads: 64), see the note above.
constexpr int min_blocks(int threads) { return threads >= 512 ? 1 : 2; }

// Input value p of the block (frame f = p / n, sample t = p mod n), read
// from device memory where it lies: the first pass of a power-of-two plan
// reads its butterflies' values straight into registers, a warp's 32
// threads on 32 consecutive samples of a frame.
struct FramesIn {
  Frames src;
  long long g0;            // the block's first frame
  int n;
  float rn;
  float sgn;               // -1: the inverse (conjugated input)
  __device__ __forceinline__ float2 operator()(int p) const {
    const int f = fdiv(p, rn);
    const long long t = p - f * n;
    const long long g = g0 + f;
    const float im = src.xi != nullptr
                         ? __ldg(src.xi + g * src.rs_i + t * src.es_i) : 0.0f;
    return make_float2(__ldg(src.xr + g * src.rs_r + t * src.es_r), sgn * im);
  }
};

// Output value p of the block: the last pass of a power-of-two plan writes
// its bins straight to device memory, a warp on 32 consecutive bins.
struct FramesOut {
  float* yr;
  float* yi;
  long long base;          // the block's first output
  float scale, iscale;
  __device__ __forceinline__ void put(int p, float2 v) const {
    yr[base + p] = v.x * scale;
    yi[base + p] = v.y * iscale;
  }
};

// kMask: the swizzle mask of the plan (swz_mask).  A power-of-two plan
// (31) reads its frames in its first pass and writes its bins in its last;
// a plan with an odd factor (0) stages them through shared memory.
template <int kThreads, int kMask>
__global__ void __launch_bounds__(kThreads, min_blocks(kThreads))
fft_frames_kernel(Frames src, Plan plan, const float2* __restrict__ tab,
                  float* __restrict__ yr, float* __restrict__ yi, int fpb,
                  float sgn, float scale) {
  const int n = plan.n;
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long g0 = static_cast<long long>(blockIdx.x) * fpb;
  const int nf = static_cast<int>(
      min(static_cast<long long>(fpb), src.frames - g0));
  const int total = nf * n;
  const Planes<kMask> s{0, round32(fpb * n)};
  const long long base = g0 * n;
  const float iscale = sgn * scale;
  if constexpr (kMask != 0) {
    fft_block<kEPT>(s, FramesIn{src, g0, n, plan.rn, sgn},
                    FramesOut{yr, yi, base, scale, iscale}, plan, tab, total);
    return;
  }
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
    if (e < total) s.put(e, make_float2(re[i], sgn * im[i]));
  }
  __syncthreads();
  fft_block<kEPT>(s, s, s, plan, tab, total);
  for (int e = tid; e < total; e += nt) {
    const float2 v = s(e);
    yr[base + e] = v.x * scale;
    yi[base + e] = v.y * iscale;
  }
}

template <int kThreads, int kMask>
cudaError_t launch_masked(const Frames& src, const Plan& plan,
                          const float2* tab, float* yr, float* yi, int fpb,
                          float sgn, float scale, int blocks, int threads,
                          int smem, cudaStream_t stream) {
  const auto kernel = fft_frames_kernel<kThreads, kMask>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<blocks, threads, smem, stream>>>(src, plan, tab, yr, yi, fpb, sgn,
                                            scale);
  return cudaGetLastError();
}

// The instance of kThreads threads with the swizzle of the plan's n.
template <int kThreads>
cudaError_t launch(const Frames& src, const Plan& plan, const float2* tab,
                   float* yr, float* yi, int fpb, float sgn, float scale,
                   int blocks, int threads, int smem, cudaStream_t stream) {
  return swz_mask(plan.n)
             ? launch_masked<kThreads, 31>(src, plan, tab, yr, yi, fpb, sgn,
                                           scale, blocks, threads, smem,
                                           stream)
             : launch_masked<kThreads, 0>(src, plan, tab, yr, yi, fpb, sgn,
                                          scale, blocks, threads, smem,
                                          stream);
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  Frame g of xr is xr[g rs_r + t es_r],
// t < n, likewise xi (null for real input).  radices[0..npass) is the pass
// plan, its product n, in the order the table was built (fft_core.cuh
// make_plan); (re, im) float32 pairs.  yr and yi are (frames, n) float32,
// bins in natural order.  inverse conjugates the transform; scale multiplies
// the output by 1 / n.
extern "C" int sdsp_fft_frames_f32(const float* xr, const float* xi,
                                   long long rs_r, long long es_r,
                                   long long rs_i, long long es_i, int frames,
                                   int n, const int* radices, int npass,
                                   const float* tab, float* yr, float* yi,
                                   int inverse, int scale, int device,
                                   void* stream) {
  Plan plan;
  if (frames < 0 || !make_plan(n, radices, npass, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const int fpb = n >= kBlockElems ? 1 : kBlockElems / n;
  const int elems = fpb * n;
  int threads = (elems + kEPT - 1) / kEPT;
  threads = ((threads + 31) / 32) * 32;
  const int smem = 2 * round32(elems) * static_cast<int>(sizeof(float));
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
