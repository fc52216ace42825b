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
// registers, a TMA store) is in conv3x3_wgmma.cuh. The host side here
// encodes the tensor maps that TMA needs, keeps them in a small cache, and
// launches. The chain is ONE host call: it enqueues its 2N convs on the
// stream over two ping-pong activation buffers and one h buffer, each conv
// a programmatic dependent launch, so that a conv's set-up and first weight
// loads overlap the tail of the conv before, as the TPU kernel fetches the
// next conv's weights while the current one computes.

#include <cuda_runtime.h>

#include <mutex>

#include "conv3x3_wgmma.cuh"

namespace {

using namespace conv3x3_wgmma;

__global__ void __launch_bounds__(THREADS, 1)
    conv3x3_bn_act_kernel(__grid_constant__ const CUtensorMap map_x,
                          __grid_constant__ const CUtensorMap map_w,
                          __grid_constant__ const CUtensorMap map_res,
                          __grid_constant__ const CUtensorMap map_out,
                          const Params p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  conv3x3_tile(&map_x, &map_w, &map_res, &map_out, p, smem_raw);
}

// cudaError_t codes are small; failures of libcuda's tensor-map encoder are
// reported above this base.
constexpr int ENCODE_ERROR_BASE = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// A dense bf16 tensor [d2][d1][d0] (d0 innermost) cut into boxes
// [b2][b1][b0], 128-byte swizzle, zeros outside.
struct MapKey {
  const void* ptr;
  int d[3];
  int b[3];
  bool operator==(const MapKey& o) const {
    return ptr == o.ptr && d[0] == o.d[0] && d[1] == o.d[1] &&
           d[2] == o.d[2] && b[0] == o.b[0] && b[1] == o.b[1] &&
           b[2] == o.b[2];
  }
};

// The maps of recent launches. A map holds nothing but its key's pointer,
// shape and box, so an entry whose tensor was freed and whose address was
// given to a new tensor of the same shape is still the right map for it. At
// most MAP_SLOTS entries (an 8-block chain uses 16 weight maps and up to 8
// activation maps); a new one overwrites the oldest.
constexpr int MAP_SLOTS = 64;
struct MapCache {
  std::mutex mutex;
  EncodeTiled encode = nullptr;
  MapKey keys[MAP_SLOTS];
  CUtensorMap maps[MAP_SLOTS];
  int used = 0;
  int next = 0;
  long long encoded = 0;
  bool attr_set[64] = {};
};
MapCache g_cache;

// Looks the map up or encodes it, into *out. Returns 0 or an error code.
int get_map(const void* ptr, int d0, int d1, int d2, int b0, int b1, int b2,
            CUtensorMap* out) {
  const MapKey key{ptr, {d0, d1, d2}, {b0, b1, b2}};
  std::lock_guard<std::mutex> lock(g_cache.mutex);
  for (int i = 0; i < g_cache.used; ++i) {
    if (g_cache.keys[i] == key) {
      *out = g_cache.maps[i];
      return 0;
    }
  }
  if (g_cache.encode == nullptr) {
    // libcuda's entry point, resolved at run time: libcuda is not linked.
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || fn == nullptr)
      return static_cast<int>(cudaErrorNotSupported);
    g_cache.encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(d0),
                              static_cast<cuuint64_t>(d1),
                              static_cast<cuuint64_t>(d2)};
  const cuuint64_t strides[2] = {dims[0] * 2, dims[0] * dims[1] * 2};  // bytes
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(b0),
                             static_cast<cuuint32_t>(b1),
                             static_cast<cuuint32_t>(b2)};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  CUtensorMap map;
  const CUresult res = g_cache.encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return ENCODE_ERROR_BASE + static_cast<int>(res);
  const int slot = g_cache.next;
  g_cache.next = (g_cache.next + 1) % MAP_SLOTS;
  if (g_cache.used < MAP_SLOTS) ++g_cache.used;
  g_cache.keys[slot] = key;
  g_cache.maps[slot] = map;
  ++g_cache.encoded;
  *out = map;
  return 0;
}

// Once per device of the process: the kernel may use SMEM_BYTES.
int ensure_attribute() {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(g_cache.mutex);
  if (dev < 64 && g_cache.attr_set[dev]) return 0;
  err = cudaFuncSetAttribute(conv3x3_bn_act_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64) g_cache.attr_set[dev] = true;
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
  std::lock_guard<std::mutex> lock(g_cache.mutex);
  return g_cache.encoded;
}

extern "C" const char* conv3x3_bn_act_error_string(int code) {
  if (code >= ENCODE_ERROR_BASE) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
