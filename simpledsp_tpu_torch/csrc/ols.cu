// Overlap-save convolution kernel for Hopper (sm_90a): per frame, FFT ->
// product with the tap spectrum -> inverse FFT -> the non-aliased samples,
// without writing a spectrum to device memory.
//
// Replaces the TPU kernel simpledsp_tpu/kernels/ols.py:_make_ols_kernel,
// reached through conv_ols_frames / convolve_ols_fused from the public
// convolve / fftconvolve / oaconvolve / correlate for long real signals.
//
// The TPU kernel runs the four-step FFT as dense DFT matmuls because it has
// a matrix unit: 14 N (n1 + n2) flops a frame, about 9.2 MFLOP at N = 4096.
// On CUDA cores this kernel runs a radix-4 Stockham FFT in shared memory
// instead, about 5 N log2 N flops a transform.
//
// Two real frames a, b ride in one complex transform, z = a + i b.  The tap
// spectrum H (of real taps, with the 1/N of the inverse folded in) is
// Hermitian, so IFFT(FFT(z) H) = (a (*) h) + i (b (*) h) with both circular
// convolutions real: the real part is frame a's output, the imaginary part
// frame b's.  The inverse runs as conj(FFT(conj(Y))), so one forward FFT
// routine serves both directions.  Per pair of frames: one load, two
// N-point complex FFTs, one store of 2 (N - skip) samples.
//
// Frames are read where they lie, by cp.async: frame f of row r starts at
// sample f * frame_stride - offset of that row, and samples outside
// [0, valid) read as zeros.  So the signal path passes the unpadded signal (frame_stride =
// hop, offset = the zero history, valid = its length) and the frames path a
// strided frames tensor (offset 0), and no framed copy is ever made.
//
// What bounds it: at N = 4096 a pair of frames is about 0.5 MFLOP against
// 32 KB read and 29 KB written.  Measured at about 11 % of the card's fp32
// rate and 30 % of its device-memory bandwidth (NVIDIA H100, PERF.md), it
// is bound by neither: each radix-4 pass reads and writes the whole frame in
// shared memory (with bank conflicts in the first two) between two
// barriers.  Twiddles and the tap spectrum are float32 tables built in
// float64 on the host and read through the read-only cache, the twiddles
// laid out pass by pass so that a warp's reads are contiguous; no fast-math
// intrinsic is used.  The frame needs 8 N bytes of shared memory: 128 KB at
// N = 16384, above the 48 KB default, hence the opt-in.

#include <cuda_runtime.h>

namespace {

constexpr int kMinLog2 = 6;
constexpr int kMaxLog2 = 14;              // 16384 complex float32 = 128 KB
constexpr int kBPT = 4;                   // radix-4 butterflies per thread a pass

struct Source {
  const float* x;
  long long row_stride;   // elements between rows
  long long frame_stride; // elements between consecutive frames of a row
  long long offset;       // frame 0 of a row starts at sample -offset
  long long valid;        // samples [0, valid) of a row exist; others are 0
  int nf;                 // frames per row
  int total;              // frames in all rows
};

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

// In-place forward FFT (unscaled, natural order in and out) of the n = 2^lg
// complex values in s.  Stockham autosort: the radix-4 pass of stride ns
// reads s[j + r n/4], twiddles them by exp(-2 pi i r k / (4 ns)),
// k = j mod ns, and writes s[(j - k) 4 + k + r ns]; the values travel
// through registers, so one buffer serves both sides of a pass.  An odd lg
// ends with one radix-2 pass (ns = n / 2, twiddle exp(-2 pi i j / n)).
// tw holds each pass's twiddles in turn, as [r - 1][k] planes of ns values
// (the radix-2 pass: its n / 2), so consecutive lanes read consecutive
// entries.  The caller synchronises before the call; the call ends
// synchronised.
__device__ void fft_shared(float2* s, const float2* __restrict__ tw, int n,
                           int lg) {
  const int tid = threadIdx.x;
  const int nt = blockDim.x;           // n / (4 kBPT)
  const int quarter = n >> 2;
  int ns = 1;
  for (int done = 0; done + 2 <= lg; done += 2) {
    float2 v[kBPT][4];
#pragma unroll
    for (int b = 0; b < kBPT; ++b) {
      const int j = tid + b * nt;
      const int k = j & (ns - 1);
#pragma unroll
      for (int r = 0; r < 4; ++r) v[b][r] = s[j + r * quarter];
      if (ns > 1) {
#pragma unroll
        for (int r = 1; r < 4; ++r) {
          v[b][r] = cmul(v[b][r], __ldg(tw + (r - 1) * ns + k));
        }
      }
      radix4(v[b]);
    }
    tw += 3 * ns;
    __syncthreads();
#pragma unroll
    for (int b = 0; b < kBPT; ++b) {
      const int j = tid + b * nt;
      const int k = j & (ns - 1);
      const int base = (j - k) * 4 + k;
#pragma unroll
      for (int r = 0; r < 4; ++r) s[base + r * ns] = v[b][r];
    }
    __syncthreads();
    ns <<= 2;
  }
  if (lg & 1) {
    const int half = n >> 1;
#pragma unroll
    for (int b = 0; b < 2 * kBPT; ++b) {
      const int j = tid + b * nt;
      const float2 v0 = s[j];
      const float2 v1 = cmul(s[j + half], __ldg(tw + j));
      s[j] = make_float2(v0.x + v1.x, v0.y + v1.y);
      s[j + half] = make_float2(v0.x - v1.x, v0.y - v1.y);
    }
    __syncthreads();
  }
}

// Asynchronous 4-byte copy into shared memory; reads nothing and writes a
// zero when `valid` is false (src must still be a valid address).
__device__ __forceinline__ void cp_async_f32(float* dst, const float* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ const float* frame_base(const Source& src, int g,
                                                   long long& start) {
  const int row = g / src.nf;
  start = static_cast<long long>(g - row * src.nf) * src.frame_stride -
          src.offset;
  return src.x + row * src.row_stride;
}

__global__ void __launch_bounds__(1024)
ols_frames_kernel(Source src, const float2* __restrict__ tw,
                  const float2* __restrict__ H, float* __restrict__ out, int n,
                  int lg, int skip) {
  extern __shared__ float2 s[];
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int ga = 2 * blockIdx.x;
  const bool has_b = ga + 1 < src.total;
  long long ua, ub = 0;
  const float* xa = frame_base(src, ga, ua);
  const float* xb = has_b ? frame_base(src, ga + 1, ub) : xa;

  // z = a + i b; samples outside the row's [0, valid) are zeros.  cp.async
  // keeps every load of the frame pair in flight at once.
  float* sf = reinterpret_cast<float*>(s);
  for (int t = tid; t < n; t += nt) {
    const long long pa = ua + t, pb = ub + t;
    const bool va = pa >= 0 && pa < src.valid;
    const bool vb = has_b && pb >= 0 && pb < src.valid;
    cp_async_f32(sf + 2 * t, va ? xa + pa : src.x, va);
    cp_async_f32(sf + 2 * t + 1, vb ? xb + pb : src.x, vb);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  fft_shared(s, tw, n, lg);
  // Y = conj(Z H): the inverse transform is conj(FFT(conj(Z H))).
  for (int k = tid; k < n; k += nt) {
    const float2 y = cmul(s[k], __ldg(H + k));
    s[k] = make_float2(y.x, -y.y);
  }
  __syncthreads();
  fft_shared(s, tw, n, lg);
  // Re of the inverse is frame a's circular convolution, -Im frame b's; the
  // first `skip` samples of each are aliased.
  const int hop = n - skip;
  float* oa = out + static_cast<long long>(ga) * hop;
  for (int t = tid; t < hop; t += nt) oa[t] = s[skip + t].x;
  if (has_b) {
    float* ob = oa + hop;
    for (int t = tid; t < hop; t += nt) ob[t] = -s[skip + t].y;
  }
}

}  // namespace

// Launch on `stream` of `device`; returns cudaGetLastError() after the launch
// (0 when the launch was accepted).  x holds `rows` rows of float32 samples,
// row r at x + r row_stride; frame f of a row covers samples
// [f frame_stride - offset, + n), those outside [0, valid) reading as zero.
// tw and H are (n, 2) float32 (re, im) tables: tw the passes' twiddles in
// the layout fft_shared reads (at most n of them), H the n-point spectrum of
// the taps divided by n.  out is (rows nf, n - skip)
// float32, frames in row-major order.  n must be a power of two, 2^6 to 2^14.
extern "C" int sdsp_ols_frames_f32(const float* x, long long row_stride,
                                   long long frame_stride, long long offset,
                                   long long valid, int rows, int nf,
                                   const float* tw, const float* H, float* out,
                                   int n, int skip, int device, void* stream) {
  int lg = 0;
  while ((1 << lg) < n) ++lg;
  if ((1 << lg) != n || lg < kMinLog2 || lg > kMaxLog2 || skip < 0 ||
      skip >= n || rows < 0 || nf < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total = static_cast<long long>(rows) * nf;
  if (total == 0) return static_cast<int>(cudaSuccess);
  if (total > 0x7ffffffeLL) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = n * static_cast<int>(sizeof(float2));
  err = cudaFuncSetAttribute(ols_frames_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Source src{x, row_stride, frame_stride, offset, valid, nf,
                   static_cast<int>(total)};
  const int blocks = static_cast<int>((total + 1) / 2);
  ols_frames_kernel<<<blocks, n / (4 * kBPT), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      src, reinterpret_cast<const float2*>(tw),
      reinterpret_cast<const float2*>(H), out, n, lg, skip);
  return static_cast<int>(cudaGetLastError());
}
