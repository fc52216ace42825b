// Fused 3x3 SAME convolution with a per-channel affine epilogue, for Hopper.
//
//   out[y, x, f] = act( sum_{dy,dx,c} x[y+dy-1, x+dx-1, c] * w[dy, dx, c, f]
//                       * scale[f] + shift[f] (+ residual[y, x, f]) )
//
// x [H, W, C] bf16 (NHWC, no batch), w [3, 3, C, F] bf16 (HWIO), scale and
// shift [F] f32 (eval-mode BatchNorm and conv bias folded), residual and
// out [H, W, F] bf16; act is ReLU or the identity. Zero SAME padding.
//
// Replaces the TPU kernel megaportraits_tpu/ops/pallas/conv2d.py
// (fused_conv3x3). It is also the building block of the ResBlock2D chain
// (megaportraits_tpu/ops/pallas/g2d_chain_v2.py, fused_resblock_chain_v2),
// which runs it 2N times (ops/kernels/resblock_chain.py).
//
// Bound on an H100 SXM at the G2d trunk shape 64x64x512 -> 512: 19.33
// GFLOP of bf16 products over 989 TFLOP/s is 19.5 us, while the bytes it
// must move (x 4 MB, w 4.7 MB, residual 4 MB, out 4 MB) take about 5 us at
// 3.35 TB/s: the kernel is bound by the tensor cores.
//
// Design: one CTA of 8 warps per 128 x 128 output tile (two 64-pixel image
// rows at the trunk shape by 128 channels; 128 CTAs for the trunk conv,
// about one per SM). The tile routine, an implicit GEMM on bf16 WMMA with a
// cp.async pipeline, is in conv3x3_tile.cuh, shared with K3.
// Later work: wgmma with TMA-fed operands.

#include <cuda_runtime.h>

#include "conv3x3_tile.cuh"

namespace {

using namespace conv3x3;

__global__ void __launch_bounds__(THREADS)
    conv3x3_bn_act_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ scale,
                          const float* __restrict__ shift,
                          const __nv_bfloat16* __restrict__ residual,
                          __nv_bfloat16* __restrict__ out, int H, int W, int C,
                          int F, int relu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  conv3x3_tile(x, w, scale, shift, residual, out, H, W, C, F, relu != 0,
               blockIdx.x * BM, blockIdx.y * BN, smem_raw);
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError(). Preconditions (the
// Python wrapper checks them): contiguous tensors on one device, C % 32 == 0,
// F % 8 == 0, 16-byte aligned base pointers; residual may be null.
extern "C" int conv3x3_bn_act(const void* x, const void* w, const void* scale,
                              const void* shift, const void* residual,
                              void* out, int H, int W, int C, int F, int relu,
                              void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3x3_bn_act_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((H * W + BM - 1) / BM, (F + BN - 1) / BN);
  conv3x3_bn_act_kernel<<<grid, THREADS, SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(shift),
      static_cast<const __nv_bfloat16*>(residual),
      static_cast<__nv_bfloat16*>(out), H, W, C, F, relu);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* conv3x3_bn_act_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
