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
// TB/s: it is bound by the tensor cores. What one launch can save over 2N
// dependent launches of K1 is what lies between two convs, so the design is
// about the conv boundary.
//
// Design: a persistent cooperative grid of min(SMs, tiles of one conv) CTAs
// (199,936 B of shared memory, one CTA an SM; cooperative so that all are
// resident at once). A CTA sets up once: mbarriers, registers per role,
// tensor-map prefetch. Then it takes, for conv 0, 1, ... 2N - 1 in turn,
// the tiles blockIdx.x, blockIdx.x + grid, ... of that conv, each with the
// pieces of conv3x3_wgmma.cuh (TMA loads into rings, wgmma, epilogue from
// registers, TMA store): the arithmetic and its order are K1's, so the
// result equals K2's bit for bit. The rings' running counts carry on from
// tile to tile and conv to conv.
//
//   * The boundary. A conv reads what every CTA wrote in the conv before.
//     A consumer warpgroup that has stored its last tile of conv k waits
//     for the store to be complete in global memory, fences and adds one to
//     a counter in global memory with release at GPU scope. The pixels'
//     producer thread, and no other, waits at the boundary: it spins until
//     the counter shows both warpgroups of every CTA for conv k (acquire),
//     puts a proxy fence, as its reads are TMA's, and starts conv k + 1's
//     loads. A spin of seconds traps, as a wait on an mbarrier does. A tile
//     needs less: of the conv before, only the pixel boxes around its own.
//     One counter a pixel box and a wait for the three or nine around the
//     tile was built and measured (utils/probe_conv3x3.py): no faster, so
//     the one counter stays.
//   * Weights cross the boundary. The weights' producer thread depends on
//     no conv: it runs on into conv k + 1 as far as the weight ring lets it
//     (B_STAGES K steps, 64 KB) while the consumers are in conv k's
//     epilogue and while the CTA waits at the boundary, which is the TPU
//     kernel's weight double buffer. All 2N convs' weights are ONE tensor
//     map [18 N taps][C][C]; conv k's taps start at 9 k.
//   * The block's residual stays in shared memory. Tile j of a CTA uses
//     epilogue buffer j % 2. When the grid has one tile a CTA (tiles <=
//     SMs, the trunk shape), conv1's tiles use buffer 0 and conv2's buffer
//     1, and what conv2 of block b stored from buffer 1 is the residual
//     that conv2 of block b + 1 adds: it is not loaded again. Block 0's
//     residual is x and arrives by TMA. With several tiles a CTA every
//     conv2 tile's residual arrives by TMA, into the buffer that the tile
//     two before it has finished storing (epi_free). Which of the two
//     holds is fixed by the shape; both are this kernel.
//   * In place. conv1 writes h, conv2 writes act over the block's input
//     (block 0 reads x and writes act: x is never written). Every reader of
//     a tile of act or h belongs to the conv before the one that overwrites
//     it, so the boundary orders them.
//
// The counter and a count of finished CTAs live in a two-word scratch
// buffer that the caller zeroes once; the last CTA to pass its last
// boundary zeroes both again, so the next launch on the same stream finds
// them clean and no memset is launched per call.

#include <cuda_runtime.h>

#include <mutex>

#include "conv3x3_maps.cuh"
#include "conv3x3_wgmma.cuh"

namespace {

using namespace conv3x3_wgmma;
using conv3x3_maps::get_map;

constexpr int CHAIN_SMEM_BYTES = smem_bytes(2);  // 199,936 B

struct ChainParams {
  const float* scales;  // [2N][C]
  const float* shifts;
  unsigned int* sync;  // [0] arrivals at boundaries, [1] CTAs past the last
  int H, W, C, n_blocks;
  int bw, bh;
};

// A consumer warpgroup's storing thread, after its stores are complete: the
// boundary sees this warpgroup.
__device__ __forceinline__ void boundary_arrive(unsigned int* counter) {
  // The stores were TMA's (async proxy) and this thread has waited for
  // them: the proxy fence, for global memory alone, orders them before the
  // release at GPU scope.
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
               : "memory");
}

// Spins until `counter` has reached `target`, then orders the TMA loads
// that follow after what the arriving threads stored.
__device__ __forceinline__ void boundary_wait(const unsigned int* counter,
                                              unsigned int target) {
  auto arrived = [&]() {
    unsigned int v;
    asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                 : "=r"(v)
                 : "l"(counter)
                 : "memory");
    return v >= target;
  };
  if (!arrived()) {
    const long long t0 = clock64();
    while (!arrived()) {
      if (clock64() - t0 > 8000000000LL) __trap();
    }
  }
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

__global__ void __launch_bounds__(THREADS, 1) resblock_chain_fused_kernel(
    __grid_constant__ const CUtensorMap map_x_in,    // x as a conv's input
    __grid_constant__ const CUtensorMap map_x_res,   // x as a residual
    __grid_constant__ const CUtensorMap map_act_in,  // act as a conv's input
    __grid_constant__ const CUtensorMap map_act_io,  // act stored and added
    __grid_constant__ const CUtensorMap map_h_in,    // h as a conv's input
    __grid_constant__ const CUtensorMap map_h_out,   // h stored
    __grid_constant__ const CUtensorMap map_w,       // [18 N][C][C]
    const ChainParams cp) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const Smem sm(smem_raw, 2);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  const int boxes = ((cp.W + cp.bw - 1) / cp.bw) * ((cp.H + cp.bh - 1) / cp.bh);
  const int tiles = boxes * ((cp.C + BN - 1) / BN);
  const int n_convs = 2 * cp.n_blocks;
  const int grid = gridDim.x;
  // One tile a CTA: conv2's tile stays in its epilogue buffer as the next
  // block's residual.
  const bool keep_residual = grid == tiles;

  Params p;
  p.scale = cp.scales;
  p.shift = cp.shifts;
  p.H = cp.H;
  p.W = cp.W;
  p.C = cp.C;
  p.F = cp.C;
  p.bw = cp.bw;
  p.bh = cp.bh;
  p.relu = 1;
  p.has_residual = 0;

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == 0) {
    // ---- producers --------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      // The weights' producer: bound by the ring alone, not by the boundary.
      tma_prefetch_map(&map_w);
      uint32_t nb = 0;
      for (int k = 0; k < n_convs; ++k) {
        for (int ti = blockIdx.x; ti < tiles; ti += grid) {
          const Tile t(p, ti % boxes, ti / boxes);
          for (int i = 0; i < t.k.n_steps; ++i)
            load_weights(sm, &map_w, t, i, nb++, 9 * k);
        }
      }
    } else if (warp == 1 && lane == 0) {
      // The pixels' producer (and the residual's): the one thread that
      // waits at the boundary.
      tma_prefetch_map(&map_x_in);
      tma_prefetch_map(&map_x_res);
      tma_prefetch_map(&map_act_in);
      tma_prefetch_map(&map_act_io);
      tma_prefetch_map(&map_h_in);
      tma_prefetch_map(&map_h_out);
      uint32_t na = 0;
      uint32_t j = 0;  // tiles of this CTA so far
      for (int k = 0; k < n_convs; ++k) {
        const bool conv1 = (k & 1) == 0;
        // conv1 reads the block's input (x for block 0, else act); conv2
        // reads h and adds the block's input.
        const CUtensorMap* map_in =
            conv1 ? (k == 0 ? &map_x_in : &map_act_in) : &map_h_in;
        const CUtensorMap* map_res = k == 1 ? &map_x_res : &map_act_io;
        const bool residual_by_tma = !conv1 && (k == 1 || !keep_residual);
        if (k > 0) boundary_wait(cp.sync, 2u * grid * k);
        for (int ti = blockIdx.x; ti < tiles; ti += grid, ++j) {
          const Tile t(p, ti % boxes, ti / boxes);
          if (residual_by_tma) {
            // The tile two before this one has left the buffer.
            mbar_wait(sm.epi_free(j & 1), ((j >> 1) & 1) ^ 1);
            load_residual(sm, j & 1, map_res, t, p);
          }
          for (int i = 0; i < t.k.n_steps; ++i)
            if (t.k.a_first(i)) load_pixels(sm, map_in, t, i, na++);
        }
      }
      // Every arrival of this launch precedes any CTA's last wait: the last
      // CTA to get here leaves the scratch zeroed for the next launch.
      if (atomicAdd(cp.sync + 1, 1u) == static_cast<unsigned int>(grid) - 1) {
        cp.sync[0] = 0;
        cp.sync[1] = 0;
        __threadfence();
      }
    }
  } else {
    // ---- consumers ----------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1;  // which 64 pixel rows of a tile
    const bool storing_thread = (warp & 3) == 0 && lane == 0;
    uint32_t na = 0, nb = 0;
    uint32_t j = 0;
    uint32_t res_phase = 0;  // bit e: the parity of res_full(e)'s next phase
    for (int k = 0; k < n_convs; ++k) {
      const bool conv1 = (k & 1) == 0;
      const CUtensorMap* map_out = conv1 ? &map_h_out : &map_act_io;
      const bool residual_by_tma = !conv1 && (k == 1 || !keep_residual);
      p.scale = cp.scales + k * cp.C;
      p.shift = cp.shifts + k * cp.C;
      for (int ti = blockIdx.x; ti < tiles; ti += grid, ++j) {
        const Tile t(p, ti % boxes, ti / boxes);
        const int e = j & 1;
        float acc[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
        multiply_tile(sm, t, g, lane, acc, na, nb);
        int parity = -1;  // the residual is in the buffer already
        if (residual_by_tma) {
          parity = (res_phase >> e) & 1;
          res_phase ^= 1u << e;
        }
        finish_tile(sm, e, map_out, t, p, !conv1, parity, g, warp, lane, acc);
        if (storing_thread) mbar_arrive(sm.epi_free(e));
      }
      // No one waits for the last conv; its arrivals would outlive the
      // scratch's reset.
      if (storing_thread && k + 1 < n_convs) boundary_arrive(cp.sync);
    }
  }
}

// Once per device of the process: the kernel may use CHAIN_SMEM_BYTES.
std::mutex g_attr_mutex;
bool g_attr_set[64] = {};

cudaError_t ensure_attribute(int dev) {
  std::lock_guard<std::mutex> lock(g_attr_mutex);
  if (dev < 64 && g_attr_set[dev]) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      resblock_chain_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      CHAIN_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (dev < 64) g_attr_set[dev] = true;
  return cudaSuccess;
}

// min(CTAs that can be resident at once, tiles of one conv), into *grid.
cudaError_t grid_size(int H, int W, int C, int bw, int* grid) {
  if (bw != 8 && bw != 16 && bw != 32 && bw != 64) return cudaErrorInvalidValue;
  const int bh = BM / bw;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((err = ensure_attribute(dev)) != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, resblock_chain_fused_kernel, THREADS, CHAIN_SMEM_BYTES);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int tiles = ((W + bw - 1) / bw) * ((H + bh - 1) / bh) *
                    ((C + BN - 1) / BN);
  *grid = per_sm * sms < tiles ? per_sm * sms : tiles;
  return cudaSuccess;
}

}  // namespace

// The number of CTAs a call at this shape launches, into *grid. `bw` is the
// width of the pixel box (8, 16, 32 or 64). Returns 0 or an error code.
extern "C" int resblock_chain_fused_grid(int H, int W, int C, int bw,
                                         int* grid) {
  return static_cast<int>(grid_size(H, W, C, bw, grid));
}

// Dynamic shared memory of one CTA, in bytes.
extern "C" int resblock_chain_fused_smem_bytes() { return CHAIN_SMEM_BYTES; }

// Launches on `stream` and returns 0 or an error code (see
// resblock_chain_fused_error_string). Output in `act`, scratch in `h`, both
// [H, W, C] and distinct from x and from each other. `sync` is two 32-bit
// words that were zero before the first launch that used them and that only
// launches on this stream use. Preconditions (the Python wrapper checks
// them): contiguous tensors on the current device, C % 8 == 0,
// n_blocks >= 1, 16-byte aligned base pointers.
extern "C" int resblock_chain_fused(const void* x, const void* w,
                                    const void* scales, const void* shifts,
                                    void* act, void* h, void* sync, int H,
                                    int W, int C, int n_blocks, int bw,
                                    void* stream) {
  int grid = 0;
  cudaError_t cerr = grid_size(H, W, C, bw, &grid);
  if (cerr != cudaSuccess) return static_cast<int>(cerr);
  const int bh = BM / bw;
  const bool halo = bw == HALO_BW;
  // A conv's input: the pixel box with its halo where the tile routine
  // takes the nine taps from one load, else the box of one tap. Stored and
  // added: half a tile's rows by 64 channels.
  const int in_w = halo ? HALO_PITCH : bw, in_h = halo ? bh + 2 : bh;
  CUtensorMap map_x_in, map_x_res, map_act_in, map_act_io, map_h_in, map_h_out,
      map_w;
  int err;
  if ((err = get_map(x, C, W, H, BK, in_w, in_h, &map_x_in)) != 0) return err;
  if ((err = get_map(x, C, W, H, 64, bw, bh / 2, &map_x_res)) != 0) return err;
  if ((err = get_map(act, C, W, H, BK, in_w, in_h, &map_act_in)) != 0)
    return err;
  if ((err = get_map(act, C, W, H, 64, bw, bh / 2, &map_act_io)) != 0)
    return err;
  if ((err = get_map(h, C, W, H, BK, in_w, in_h, &map_h_in)) != 0) return err;
  if ((err = get_map(h, C, W, H, 64, bw, bh / 2, &map_h_out)) != 0) return err;
  if ((err = get_map(w, C, C, 18 * n_blocks, 64, BK, 1, &map_w)) != 0)
    return err;
  ChainParams cp;
  cp.scales = static_cast<const float*>(scales);
  cp.shifts = static_cast<const float*>(shifts);
  cp.sync = static_cast<unsigned int*>(sync);
  cp.H = H;
  cp.W = W;
  cp.C = C;
  cp.n_blocks = n_blocks;
  cp.bw = bw;
  cp.bh = bh;

  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(THREADS);
  config.dynamicSmemBytes = CHAIN_SMEM_BYTES;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = &attr;
  config.numAttrs = 1;
  cerr = cudaLaunchKernelEx(&config, resblock_chain_fused_kernel, map_x_in,
                            map_x_res, map_act_in, map_act_io, map_h_in,
                            map_h_out, map_w, cp);
  if (cerr != cudaSuccess) {
    cudaGetLastError();  // clear the launch error; it is returned instead
    return static_cast<int>(cerr);
  }
  return static_cast<int>(cudaGetLastError());
}

// Tensor maps encoded so far by this library (cache misses).
extern "C" long long resblock_chain_fused_maps_encoded() {
  return conv3x3_maps::maps_encoded();
}

extern "C" const char* resblock_chain_fused_error_string(int code) {
  return conv3x3_maps::error_string(code);
}
