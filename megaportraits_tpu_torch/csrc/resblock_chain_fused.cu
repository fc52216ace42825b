// A chain of N ResBlock2D blocks (eval mode, BatchNorm folded) in ONE
// launch, for Hopper. For each block b:
//
//   h = relu(conv3x3(x, w[b,0]) * s[b,0] + t[b,0])
//   x = relu(conv3x3(h, w[b,1]) * s[b,1] + t[b,1] + x)
//
// x [H, W, C] bf16 (NHWC), w [N, 2, 3, 3, C, C] bf16 (HWIO per conv),
// s and t [N, 2, C] f32. Each conv zero-pads its own input (conv2 pads h).
//
// Replaces the TPU kernel megaportraits_tpu/ops/pallas/g2d_chain.py
// (fused_resblock_chain): the whole trunk in one pallas_call over a grid of
// blocks, the activation updated in place in VMEM and the next conv's
// weights fetched by hand-issued DMA while the current one computes.
//
// Bound on an H100 SXM for the 8-block 64x64x512 trunk: 16 convs of 19.33
// GFLOP of bf16 products over 989 TFLOP/s is 0.313 ms, while the bytes it
// must move (x and out 4 MB each, weights 75.5 MB) take 0.025 ms at 3.35
// TB/s: it is bound by the tensor cores.
//
// Design: a persistent cooperative grid, launched once per call with
// cudaLaunchCooperativeKernel and sized to what the card can hold resident
// at once (occupancy x SMs), capped at the tiles of one conv. Each CTA walks
// the 128 x 128 (pixels x channels) output tiles of the current conv, in
// the tile routine that K1 uses (conv3x3_tile.cuh); the whole grid meets at
// a barrier (cooperative_groups grid sync) between one conv and the next,
// 2N - 1 barriers a call. At 64x64x512 one conv has 128 tiles, one per CTA.
//
// The activation lives in one buffer, `act`, updated in place by conv2 as
// the TPU kernel does: conv2 reads h for its convolution, and its residual
// read of act is the element that the same thread then writes. Block 0
// reads the input x directly and writes act, so x is never written and is
// not copied. `h` is the second buffer. Both (4 MB each at the trunk
// shape) stay in the 50 MB L2 across the barriers; the tile routine reads
// them through L2 only.
//
// Later work: wgmma with TMA-fed operands, and the next conv's weights
// streamed into shared memory ahead of the barrier, as the TPU kernel's
// double buffer does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace conv3x3;

__global__ void __launch_bounds__(THREADS)
    resblock_chain_fused_kernel(const __nv_bfloat16* x,
                                const __nv_bfloat16* w, const float* scales,
                                const float* shifts, __nv_bfloat16* act,
                                __nv_bfloat16* h, int H, int W, int C,
                                int n_blocks) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  cg::grid_group grid = cg::this_grid();
  const int tiles_n = (C + BN - 1) / BN;
  const int tiles = ((H * W + BM - 1) / BM) * tiles_n;
  const size_t conv_w = static_cast<size_t>(9) * C * C;

  for (int k = 0; k < 2 * n_blocks; ++k) {
    if (k > 0) grid.sync();  // the previous conv's output is complete
    const bool conv1 = (k & 1) == 0;
    // conv1 reads the block's input (x for block 0, else act) and writes h;
    // conv2 reads h, adds the block's input and writes act.
    const __nv_bfloat16* block_in = k < 2 ? x : act;
    const __nv_bfloat16* src = conv1 ? block_in : h;
    const __nv_bfloat16* residual = conv1 ? nullptr : block_in;
    __nv_bfloat16* dst = conv1 ? h : act;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const int m0 = (t / tiles_n) * BM;
      const int n0 = (t - (t / tiles_n) * tiles_n) * BN;
      conv3x3_tile(src, w + k * conv_w, scales + k * C, shifts + k * C,
                   residual, dst, H, W, C, C, true, m0, n0, smem_raw);
    }
  }
}

cudaError_t grid_size(int H, int W, int C, int* grid) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(resblock_chain_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, resblock_chain_fused_kernel, THREADS, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = ((H * W + BM - 1) / BM) * ((C + BN - 1) / BN);
  *grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  return cudaSuccess;
}

}  // namespace

// The number of CTAs a call at this shape launches, into *grid. Returns a
// cudaError_t code.
extern "C" int resblock_chain_fused_grid(int H, int W, int C, int* grid) {
  return static_cast<int>(grid_size(H, W, C, grid));
}

// Launches on `stream` and returns the launch's cudaError_t code. Output in
// `act`, scratch in `h`, both [H, W, C] and distinct from x. Preconditions
// (the Python wrapper checks them): contiguous tensors on the current
// device, C % 32 == 0, n_blocks >= 1, 16-byte aligned base pointers.
extern "C" int resblock_chain_fused(const void* x, const void* w,
                                    const void* scales, const void* shifts,
                                    void* act, void* h, int H, int W, int C,
                                    int n_blocks, void* stream) {
  int grid = 0;
  cudaError_t err = grid_size(H, W, C, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* tp = static_cast<const float*>(shifts);
  __nv_bfloat16* ap = static_cast<__nv_bfloat16*>(act);
  __nv_bfloat16* hp = static_cast<__nv_bfloat16*>(h);
  void* args[] = {&xp, &wp, &sp, &tp, &ap, &hp, &H, &W, &C, &n_blocks};
  err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(resblock_chain_fused_kernel), dim3(grid),
      dim3(THREADS), args, SMEM_BYTES, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; it is returned instead
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* resblock_chain_fused_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
