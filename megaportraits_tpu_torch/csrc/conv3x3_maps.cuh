// The host side of TMA for the conv kernels: tensor maps of dense bf16
// tensors, encoded by libcuda and kept in a small cache. Included by
// conv3x3_bn_act.cu (K1, K2) and resblock_chain_fused.cu (K3); each library
// has a cache of its own.

#pragma once

#include <cuda.h>  // CUtensorMap and the encoder's types; libcuda is not linked
#include <cuda_runtime.h>

#include <mutex>

namespace conv3x3_maps {
namespace {

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
// most MAP_SLOTS entries (an 8-block chain of K2 uses 16 weight maps and up
// to 8 activation maps, a chain of K3 one weight map and 6 activation
// maps); a new one overwrites the oldest.
constexpr int MAP_SLOTS = 64;
struct MapCache {
  std::mutex mutex;
  EncodeTiled encode = nullptr;
  MapKey keys[MAP_SLOTS];
  CUtensorMap maps[MAP_SLOTS];
  int used = 0;
  int next = 0;
  long long encoded = 0;
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

// Tensor maps encoded so far by this library (cache misses).
long long maps_encoded() {
  std::lock_guard<std::mutex> lock(g_cache.mutex);
  return g_cache.encoded;
}

const char* error_string(int code) {
  if (code >= ENCODE_ERROR_BASE) return "cuTensorMapEncodeTiled failed";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // namespace
}  // namespace conv3x3_maps
