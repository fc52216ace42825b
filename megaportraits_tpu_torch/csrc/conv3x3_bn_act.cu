// Fused 3x3 SAME convolution with a per-channel affine epilogue, for Hopper,
// and the chain of ResBlock2D blocks built from it.
//
//   out[y, x, f] = act( sum_{dy,dx,c} x[y+dy-1, x+dx-1, c] * w[dy, dx, c, f]
//                       * scale[f] + shift[f] (+ residual[y, x, f]) )
//
// x [H, W, C] bf16 (NHWC, no batch), w [3, 3, C, F] bf16 (HWIO), scale and
// shift [F] f32 (eval-mode BatchNorm and conv bias folded), residual and
// out [H, W, F] bf16; act is ReLU or the identity. Zero SAME padding.
//
// conv3x3_bn_act replaces the TPU kernel
// megaportraits_tpu/ops/pallas/conv2d.py (fused_conv3x3). resblock_chain
// replaces megaportraits_tpu/ops/pallas/g2d_chain_v2.py
// (fused_resblock_chain_v2): for each block b,
//
//   h = relu(conv3x3(x, w[b,0]) * s[b,0] + t[b,0])
//   x = relu(conv3x3(h, w[b,1]) * s[b,1] + t[b,1] + x)
//
// Bound on an H100 SXM at the G2d trunk shape 64x64x512 -> 512: 19.33
// GFLOP of bf16 products over 989 TFLOP/s is 19.5 us a conv, 0.313 ms for the
// 16 convs of the 8-block trunk, while the bytes a conv must move (x 4 MB, w
// 4.7 MB, residual 4 MB, out 4 MB) take about 5 us at 3.35 TB/s: the tensor
// cores bound it. What the tile routine moves from L2 into shared memory is
// far more, 186 MB a conv at that shape (conv3x3_wgmma.cuh).
//
// Design: one CTA per output tile of 128 pixels (a box of the image) x 128
// channels; 128 CTAs for a trunk conv, about one per SM. The tile routine
// (TMA loads into rings of shared-memory buffers, wgmma, the epilogue from
// registers, a TMA store) is in conv3x3_wgmma.cuh. The host side here gets
// the tensor maps that TMA needs (conv3x3_maps.cuh encodes and caches them)
// and launches. The chain is ONE host call: it enqueues its 2N convs on the
// stream over two ping-pong activation buffers and one h buffer, each conv
// a programmatic dependent launch, so that a conv's set-up and first weight
// loads overlap the tail of the conv before, as the TPU kernel fetches the
// next conv's weights while the current one computes.

#include <cuda_runtime.h>

#include <mutex>

#include "conv3x3_maps.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace conv3x3_wgmma;
using conv3x3_maps::get_map;

__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_bn_act_kernel(__grid_constant__ const CUtensorMap map_x,
                          __grid_constant__ const CUtensorMap map_w,
                          __grid_constant__ const CUtensorMap map_res,
                          __grid_constant__ const CUtensorMap map_out,
                          const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  conv3x3_tile(&map_x, &map_w, &map_res, &map_out, p, smem_raw);
}

// Devices of this process on which the kernel's shared-memory limit is set.
std::mutex g_attr_mutex;
bool g_attr_set[64] = {};

// Once per device of the process: the kernel may use SMEM_BYTES.
int ensure_attribute() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(g_attr_mutex);
  if (dev < 64 && g_attr_set[dev]) return 0;
  err = cudaFuncSetAttribute(conv3x3_bn_act_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) g_attr_set[dev] = true;
  return 0;
}

// One conv on `stream`. With `dependent`, a programmatic dependent launch:
// this conv may begin while the launch before it on the stream ends.
int launch_conv(const void* x, const void* w, const float* scale,
                const float* shift, const void* residual, void* out, int H,
                int W, int C, int F, int relu, int bw, int dependent,
                cudaStream_t stream) {
  if (bw != 8 && bw != 16 && bw != 32 && bw != 64)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bh = BM / bw;
  int err = ensure_attribute();
  if (err != 0) return err;
  CUtensorMap map_x, map_w, map_res, map_out;
  // The pixel box with its halo where the tile routine takes the nine taps
  // from one load, else the box of one tap.
  const bool halo = bw == HALO_BW;
  if ((err = get_map(x, C, W, H, BK, halo ? HALO_PITCH : bw,
                     halo ? bh + 2 : bh, &map_x)) != 0)
    return err;
  if ((err = get_map(w, F, C, 9, 64, BK, 1, &map_w)) != 0) return err;
  if ((err = get_map(out, F, W, H, 64, bw, bh / 2, &map_out)) != 0) return err;
  map_res = map_out;
  if (residual != nullptr &&
      (err = get_map(residual, F, W, H, 64, bw, bh / 2, &map_res)) != 0)
    return err;
  Params p;
  p.scale = scale;
  p.shift = shift;
  p.H = H;
  p.W = W;
  p.C = C;
  p.F = F;
  p.bw = bw;
  p.bh = bh;
  p.relu = relu;
  p.has_residual = residual != nullptr;

  const int tiles = ((W + bw - 1) / bw) * ((H + bh - 1) / bh);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(tiles, (F + BN - 1) / BN);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = SMEM_BYTES;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = dependent ? 1 : 0;
  cudaError_t lerr = cudaLaunchKernelEx(&config, conv3x3_bn_act_kernel, map_x,
                                        map_w, map_res, map_out, p);
  if (lerr != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; it is returned instead
    return static_cast<int>(lerr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches on `stream` and returns 0 or an error code (see
// conv3x3_bn_act_error_string). `bw` is the width of the pixel box (8, 16, 32
// or 64; its height is 128 / bw). Preconditions
// (the Python wrapper checks them): contiguous tensors on the current
// device, C % 8 == 0, F % 8 == 0, 16-byte aligned base pointers; residual
// may be null and, like x, must not overlap out.
extern "C" int conv3x3_bn_act(const void* x, const void* w, const void* scale,
                              const void* shift, const void* residual,
                              void* out, int H, int W, int C, int F, int relu,
                              int bw, void* stream) {
  return launch_conv(x, w, static_cast<const float*>(scale),
                     static_cast<const float*>(shift), residual, out, H, W, C,
                     F, relu, bw, 0, static_cast<cudaStream_t>(stream));
}

// The chain of n_blocks ResBlock2D blocks in one call: 2 * n_blocks convs
// enqueued on `stream`, no host synchronisation. w [N, 2, 3, 3, C, C],
// scales and shifts [N, 2, C]; h, buf0 and buf1 are [H, W, C] scratch,
// distinct from each other and from x; the result is in buf0 if n_blocks is
// odd, else in buf1. With `dependent`, every conv after the first is a
// programmatic dependent launch. *launches receives the number of convs
// launched (also when a later one fails). Returns 0 or an error code.
extern "C" int resblock_chain(const void* x, const void* w, const void* scales,
                              const void* shifts, void* h, void* buf0,
                              void* buf1, int H, int W, int C, int n_blocks,
                              int bw, int dependent, void* stream,
                              int* launches) {
  const __nv_bfloat16* wp = static_cast<const __nv_bfloat16*>(w);
  const float* sp = static_cast<const float*>(scales);
  const float* tp = static_cast<const float*>(shifts);
  const size_t conv_w = static_cast<size_t>(9) * C * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const void* cur = x;
  *launches = 0;
  for (int b = 0; b < n_blocks; ++b) {
    void* dst = (b % 2 == 0) ? buf0 : buf1;
    const int k = 2 * b;
    // The first conv waits for whatever the stream holds in the ordinary
    // way; every later one may begin under the conv before it.
    int err = launch_conv(cur, wp + k * conv_w, sp + k * C, tp + k * C,
                          nullptr, h, H, W, C, C, 1, bw,
                          b == 0 ? 0 : dependent, st);
    if (err != 0) return err;
    ++*launches;
    err = launch_conv(h, wp + (k + 1) * conv_w, sp + (k + 1) * C,
                      tp + (k + 1) * C, cur, dst, H, W, C, C, 1, bw, dependent,
                      st);
    if (err != 0) return err;
    ++*launches;
    cur = dst;
  }
  return 0;
}

// Tensor maps encoded so far in this process (cache misses).
extern "C" long long conv3x3_bn_act_maps_encoded() {
  return conv3x3_maps::maps_encoded();
}

extern "C" const char* conv3x3_bn_act_error_string(int code) {
  return conv3x3_maps::error_string(code);
}
