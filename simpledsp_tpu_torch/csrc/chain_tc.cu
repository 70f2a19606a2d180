// The fused chain's "regs" form for Hopper (sm_90a): chain_natural_kernel
// (chain_natural.cuh) with its IIR block as exact split-bf16 products on the
// tensor cores, then the half spectrum on the FFT core as in chain.cu.
//
// Replaces the TPU kernel simpledsp_tpu/kernels/chain_variants.py
// _make_packed_regs_kernel (:67), fused_chain_frames(layout="regs"): float32
// only.  The TPU variant put its matrix unit's product, the four-step FFT's
// step 1, on exact split-bf16 passes at float32-grade accuracy.  On the FFT
// core step 1 is no product; the one product left is the IIR block
// y = [x | starts^T] [H^T; Phi^T], about 0.34 M of the frame's 0.40 M FMAs
// at N = 4096 (chain.cu), so that is what this form splits: A's three bf16
// parts on the device, the table's on the host from its float64 values,
// all nine part products as mma.sync.m16n8k16 bf16 x bf16 -> fp32, a fresh
// fp32 partial for each 16-deep K step added in IEEE fp32, and the K steps
// of H^T that are zero for an 8-column tile skipped (chain_natural.cuh
// iir_mma_stage).  Nothing runs in TF32.
//
// What bounds it: at N = 4096 the split products are about 3.2 M bf16 MACs
// a frame (nine products over the kept triangle, 0.36 M MACs each).  On
// the H100 they ran at about 305 TFLOP/s, which makes the IIR block only
// 12 % faster than chain.cu's bands on the CUDA cores (0.087 against
// 0.099 ms for 16 x 2^20 samples; PERF.md): exactness costs nine
// products, and A's three planes are read by ldmatrix once per N tile
// (about 270 KB of shared-memory reads a frame).  The table (768 bytes a
// tile and K step) comes from L2, the next step's fragments loading while
// a step's products run.  The FFT, the split and the store are chain.cu's.
// Shared memory: A's planes (rows x (K + 8) bf16 each) and y (rows x kLdx
// floats), 89 KB at N = 4096 (two frames, 64 rows: two blocks an SM).

#include "chain_natural.cuh"

namespace {

using namespace sdsp_chain;

template <int kEPT>
cudaError_t launch_split(const float* x, const float* s, const uint4* tc,
                         const sdsp_fft::Plan& plan, const float2* tab,
                         const float2* split, float* re, float* im, int frames,
                         int g, int n1, int rows, int n2, int d, size_t smem,
                         cudaStream_t stream) {
  const auto kernel =
      chain_natural_kernel<kSplit, 1, kEPT, kHalf, kThreads, kDirect>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(frames + g - 1) / g, kThreads, smem, stream>>>(
      x, s, nullptr, nullptr, tc, plan, tab, split, re, im, frames, g, n1,
      rows, n2, d, 1.0f / static_cast<float>(n2), 0);
  return cudaGetLastError();
}

}  // namespace

// The packed half spectrum in natural order with the IIR block on the
// tensor cores.  Launch on `stream` of `device`; returns cudaGetLastError()
// after the launch (0 when the launch was accepted).  Every pointer is
// device memory: x (frames, n1, n2) and s (frames, d, n1) contiguous
// float32 (the sub-block starts, D-major); tc the table [H^T; Phi^T]'s
// three bf16 parts in B-fragment order, for each of the ceil(n2 / 8) N
// tiles and K / 16 K steps (K = n2 + d rounded up to 16) 192 words: 32
// lanes' uint4 (h.b0, h.b1, m.b0, m.b1), then 32 lanes' uint2 (l.b0, l.b1)
// (kernels/chain_variants.py _regs_fragments), H^T upper-triangular;
// radices[0..npass) and tab the FFT core's plan and table for M = n1 n2 / 2
// points (fft_core.cuh make_plan); split the M / 2 + 1 twiddles
// exp(-2 pi i k / (2 M)), (re, im) float32 pairs.  re / im (frames,
// n1 n2 / 2): the packed one-sided spectrum in natural order, X[N/2].re in
// im[:, 0].  n2 is even.  The kernel's own g frames a block
// (natural_frames); a block that needs more shared memory than kMaxSmem (a
// large d) is refused.
extern "C" int sdsp_chain_regs_f32(const float* x, const float* s,
                                   const void* tc, const int* radices,
                                   int npass, const float* tab,
                                   const float* split, float* re, float* im,
                                   int frames, int n1, int n2, int d,
                                   int device, void* stream) {
  const int m = n1 * n2 / 2;
  sdsp_fft::Plan plan;
  if (n2 < 2 || n2 > kN2 || n2 % 2 || n1 < 1 || n1 > 128 || d < 1 ||
      frames < 0 || !sdsp_fft::make_plan(m, radices, npass, &plan)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int g = natural_frames(n1, m);
  const int rows = split_rows(g, n1);
  const size_t smem = split_smem_bytes(rows, n2, d);
  const int values = g * m;
  if (smem > kMaxSmem || values > 32 * kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (frames == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* t4 = static_cast<const uint4*>(tc);
  const auto* t2 = reinterpret_cast<const float2*>(tab);
  const auto* sp = reinterpret_cast<const float2*>(split);
  err = values > 16 * kThreads
            ? launch_split<32>(x, s, t4, plan, t2, sp, re, im, frames, g, n1,
                               rows, n2, d, smem, st)
            : launch_split<16>(x, s, t4, plan, t2, sp, re, im, frames, g, n1,
                               rows, n2, d, smem, st);
  return static_cast<int>(err);
}
