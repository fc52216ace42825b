// One output tile of a fused 3x3 SAME convolution with a per-channel affine
// epilogue, for Hopper: operands by TMA, products by wgmma. The tile routine
// of K1 (conv3x3_bn_act.cu), through it of K2's 2N convolutions, and of K3
// (resblock_chain_fused.cu).
//
//   out[y, x, f] = act( sum_{dy,dx,c} x[y+dy-1, x+dx-1, c] * w[dy, dx, c, f]
//                       * scale[f] + shift[f] (+ residual[y, x, f]) )
//
// x [H, W, C] bf16 (NHWC, no batch), w [3, 3, C, F] bf16 (HWIO), scale and
// shift [F] f32, residual and out [H, W, F] bf16; act is ReLU or the
// identity. Zero SAME padding.
//
// Replaces the TPU kernel megaportraits_tpu/ops/pallas/conv2d.py
// (fused_conv3x3). The one-launch chain (resblock_chain_fused.cu) walks all
// its tiles with the same pieces, so the two chains sum in one order.
//
// Bound on an H100 SXM at the G2d trunk shape 64x64x512 -> 512: 19.33 GFLOP
// of bf16 products over 989 TFLOP/s is 19.5 us (the bytes it must move take
// 5 us): the tensor cores bound it. What the kernel waits for, though, is
// its operands coming out of L2 into shared memory (PERF.md has the
// measurements). A CTA that loads a pixel box and a weight box per tap and
// channel slice brings 72 x (16 KB + 16 KB), and 128 CTAs make 302 MB a
// conv; loading the box once per slice WITH ITS HALO and taking the nine
// taps from it (below) leaves 8 x 33 KB + 72 x 16 KB, 186 MB a conv.
//
// Design. An implicit GEMM: M = pixels, N = F, K = 9*C. A CTA owns a tile of
// 128 pixels x 128 channels. The pixels are a BOX of the image, bh rows x bw
// pixels with bh * bw = 128, chosen by the host to fit W, not a run of flat
// indices. TMA loads boxes at signed coordinates and fills what lies outside
// the image with zeros, which is the SAME padding; it writes rows of 128
// bytes (64 channels of one pixel) with the 128-byte swizzle, which is
// wgmma's K-major operand as it stands. The weights come the same way from
// a [9][C][F] map, two boxes of 64 c x 64 f a K step, which is wgmma's
// MN-major B operand. A K step is one tap x 64 channels. The pixels come in
// one of two ways:
//   * bw == 64 (images wider than 32): once per channel slice, the box with
//     its halo, (bh + 2) x (bw + 2) pixels at (y0 - 1, x0 - 1). A warpgroup's
//     64 pixels are one image row, so its operand for tap (dy, dx) is 64
//     consecutive rows of the haloed box starting at row (g + dy) * 66 + dx:
//     the same bytes, another start address in the descriptor. The K loop
//     runs slice by slice, nine taps inside.
//   * narrower boxes: once per K step, the box of the tap at
//     (y0 + dy - 1, x0 + dx - 1); a warpgroup's 64 pixels span several image
//     rows, which a haloed box would not leave evenly spaced. The K loop
//     runs tap by tap, the slices inside; a tap whose box lies wholly
//     outside the image is left out.
// Both run the same loop: a ring of A buffers (2 haloed boxes or 4 tap
// boxes) and a ring of B_STAGES weight boxes, each with full/empty
// mbarriers.
//
// Three warpgroups: warpgroup 0 gives its registers away (setmaxnreg) and
// two of its threads are the producers, one for the weights and one for the
// pixels, which keep the rings full;
// warpgroups 1 and 2 each own 64 of the tile's pixels and all 128 channels:
// four m64n128k16 wgmma a K step, 64 f32 accumulators a thread, one wgmma
// group kept in flight. The epilogue works on the accumulator fragment in
// registers: scale, shift, residual, ReLU in f32, one rounding to bf16. The
// residual tile arrives by TMA into a swizzled bf16 tile in shared memory,
// each thread replaces the elements it read with its results, and a TMA
// store writes the tile out: whole lines both ways, and the ragged edges (a
// box that runs off the image, F not a multiple of 64) are clipped by the
// hardware.
//
// Programmatic dependent launch: everything up to the first read of an
// activation (barrier set-up, tensor-map prefetch, the weight boxes of the
// first B_STAGES K steps) runs before griddepcontrol.wait, so in a chain of
// convs it overlaps the tail of the conv before; nothing global is written
// and no activation is read before the wait.

#pragma once

#include <cuda.h>  // CUtensorMap: the type only, nothing of libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace conv3x3_wgmma {

constexpr int BM = 128;  // output pixels per tile (a box of bh x bw)
constexpr int BN = 128;  // output channels per tile
constexpr int BK = 64;   // input channels per K step: one 128-byte row
constexpr int THREADS = 384;  // producer warpgroup + two consumer warpgroups
constexpr int HALO_BW = 64;   // the box width that loads with a halo
constexpr int HALO_PITCH = HALO_BW + 2;  // pixels of one haloed image row
constexpr int A_TAP_BYTES = BM * BK * 2;  // 16 KB: 128 pixel rows of 128 B
constexpr int A_HALO_BYTES = 4 * HALO_PITCH * BK * 2;  // 33 KB: 4 x 66 rows
constexpr int A_TAP_STAGES = 4;
constexpr int A_HALO_STAGES = 2;
constexpr int A_BYTES = A_HALO_STAGES * A_HALO_BYTES;  // either ring fits
constexpr int B_HALF_BYTES = BK * 64 * 2;  // 8 KB: 64 c rows of 64 f
constexpr int B_BYTES = 2 * B_HALF_BYTES;
constexpr int B_STAGES = 4;
constexpr int EPI_PART_BYTES = 64 * 128;  // 64 pixel rows x 64 channels
constexpr int EPI_BYTES = 4 * EPI_PART_BYTES;  // [warpgroup][channel half]
constexpr int BAR_BYTES = 256;  // 2 * (A_TAP_STAGES + B_STAGES) + 4 mbarriers
// Dynamic shared memory of a CTA with `epi_bufs` epilogue buffers. 1 KB of
// slack: the swizzled tiles must start on 1024-byte boundaries.
constexpr int smem_bytes(int epi_bufs) {
  return 1024 + A_BYTES + B_STAGES * B_BYTES + epi_bufs * EPI_BYTES +
         BAR_BYTES;
}
constexpr int SMEM_BYTES = smem_bytes(1);  // one tile a CTA: 167,168 B
static_assert(A_TAP_STAGES * A_TAP_BYTES <= A_BYTES, "the tap ring must fit");
static_assert(A_HALO_BYTES % 1024 == 0 && A_BYTES % 1024 == 0, "alignment");

struct Params {
  const float* scale;
  const float* shift;
  int H, W, C, F;
  int bw, bh;  // the pixel box; bw * bh == BM
  int relu;
  int has_residual;
};

// ---- PTX wrappers ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Waits until the barrier has left phase `parity`. A wait of more than a
// few seconds is a deadlock: trap, so that the launch fails and does not
// hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > 8000000000LL) __trap();
  }
}

__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory operand descriptor with the 128-byte swizzle. The
// hardware swizzles by the bits of the shared-memory address, as TMA does,
// so an operand may start on any 128-byte row of a buffer that TMA filled,
// not only on the 1024-byte pattern's first row, and needs nothing for it
// but its start address: on an H100 the descriptor's base-offset field must
// stay 0 for that (set to the row, the products came out wrong).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr,
                                               uint32_t lead_bytes,
                                               uint32_t stride_bytes) {
  uint64_t d = static_cast<uint64_t>((addr & 0x3FFFF) >> 4);
  d |= static_cast<uint64_t>((lead_bytes & 0x3FFFF) >> 4) << 16;
  d |= static_cast<uint64_t>((stride_bytes & 0x3FFFF) >> 4) << 32;
  d |= static_cast<uint64_t>(1) << 62;
  return d;
}

// acc[64] += A (64 x 16, K-major) * B (16 x 128, MN-major), bf16 -> f32.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64],
                                                 uint64_t desc_a,
                                                 uint64_t desc_b) {
  // Operands after the descriptors: scale-d (a predicate: accumulate),
  // scale-a = scale-b = 1, A K-major (0), B MN-major (1).
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t ld_shared_u32(uint32_t addr) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// Bit t is set if tap t = dy * 3 + dx of the tile at (y0, x0) touches the
// image at all. A tap whose box lies wholly past the bottom or the right
// edge adds nothing and is left out of the K loop (by both roles), so no
// load ever asks for a box that lies wholly outside its tensor.
__device__ __forceinline__ uint32_t valid_taps(int y0, int x0, int H, int W) {
  uint32_t mask = 0;
  for (int tap = 0; tap < 9; ++tap)
    if (y0 + tap / 3 - 1 < H && x0 + tap % 3 - 1 < W) mask |= 1u << tap;
  return mask;
}

// The K loop of one tile, as both roles walk it. With a halo, step i is
// (slice i / 9, tap i % 9) and A buffer i / 9 serves nine steps; without,
// step i is (the i / c_slices'th valid tap, slice i % c_slices) and every
// step has its own A buffer.
struct KLoop {
  bool halo;
  int c_slices;
  uint32_t taps;
  int n_steps;

  __device__ __forceinline__ KLoop(bool halo_, int c_slices_, uint32_t taps_)
      : halo(halo_), c_slices(c_slices_), taps(halo_ ? 0x1FFu : taps_) {
    n_steps = __popc(taps) * c_slices;
  }
  __device__ __forceinline__ int tap(int i) const {
    if (halo) return i % 9;
    int nth = i / c_slices;
    int t = 0;
    for (;; ++t) {
      if ((taps >> t) & 1u) {
        if (nth == 0) break;
        --nth;
      }
    }
    return t;
  }
  __device__ __forceinline__ int slice(int i) const {
    return halo ? i / 9 : i % c_slices;
  }
  __device__ __forceinline__ int a_index(int i) const {
    return halo ? i / 9 : i;
  }
  __device__ __forceinline__ bool a_first(int i) const {
    return !halo || i % 9 == 0;
  }
  __device__ __forceinline__ bool a_last(int i) const {
    return !halo || i % 9 == 8;
  }
};

// ---- the pieces of the tile routine ------------------------------------------
//
// A launch initialises the mbarriers once, reassigns its registers once and
// then walks one tile (K1, conv3x3_tile below) or many (the one-launch
// chain, resblock_chain_fused.cu). So nothing here counts from a tile's
// start: every ring has a RUNNING count of the loads made into it since the
// launch began, kept in step by the producer and the consumers, and a
// load's buffer and barrier phase follow from that count alone. A ring is
// drained at the end of a tile (the consumers release the last step's
// buffers too), so the next tile may belong to another conv.

// Where a CTA's dynamic shared memory holds what. `epi_bufs` epilogue
// buffers (1 for a single tile; 2 where tiles follow each other and one
// buffer's store may still be read while the next tile's residual
// arrives).
struct Smem {
  uint32_t a_base, b_base, epi, bars;

  __device__ __forceinline__ Smem(const unsigned char* raw, int epi_bufs) {
    a_base = (smem_u32(raw) + 1023u) & ~1023u;
    b_base = a_base + A_BYTES;
    epi = b_base + B_STAGES * B_BYTES;
    bars = epi + epi_bufs * EPI_BYTES;
  }
  __device__ __forceinline__ uint32_t a_full(int s) const {
    return bars + 8u * s;
  }
  __device__ __forceinline__ uint32_t a_empty(int s) const {
    return bars + 8u * (A_TAP_STAGES + s);
  }
  __device__ __forceinline__ uint32_t b_full(int s) const {
    return bars + 8u * (2 * A_TAP_STAGES + s);
  }
  __device__ __forceinline__ uint32_t b_empty(int s) const {
    return bars + 8u * (2 * A_TAP_STAGES + B_STAGES + s);
  }
  // The residual of epilogue buffer e has arrived.
  __device__ __forceinline__ uint32_t res_full(int e) const {
    return bars + 8u * (2 * A_TAP_STAGES + 2 * B_STAGES + e);
  }
  // Epilogue buffer e has been stored and may be loaded into again.
  __device__ __forceinline__ uint32_t epi_free(int e) const {
    return bars + 8u * (2 * A_TAP_STAGES + 2 * B_STAGES + 2 + e);
  }
  __device__ __forceinline__ uint32_t epi_buf(int e) const {
    return epi + e * EPI_BYTES;
  }
  // One thread calls this, once a launch, before a CTA-wide barrier.
  __device__ __forceinline__ void init_barriers() const {
    for (int s = 0; s < A_TAP_STAGES; ++s) {
      mbar_init(a_full(s), 1);
      mbar_init(a_empty(s), 8);  // one arrival a consumer warp
    }
    for (int s = 0; s < B_STAGES; ++s) {
      mbar_init(b_full(s), 1);
      mbar_init(b_empty(s), 8);
    }
    for (int e = 0; e < 2; ++e) {
      mbar_init(res_full(e), 1);
      mbar_init(epi_free(e), 2);  // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
};

// One output tile: pixel box `box` (x fastest over the image), channels
// [channel_tile * BN, + BN).
struct Tile {
  int x0, y0, n0;
  int n_halves;  // 64-channel halves in range
  KLoop k;

  __device__ __forceinline__ Tile(const Params& p, int box, int channel_tile)
      : x0((box % ((p.W + p.bw - 1) / p.bw)) * p.bw),
        y0((box / ((p.W + p.bw - 1) / p.bw)) * p.bh),
        n0(channel_tile * BN),
        n_halves(p.F - channel_tile * BN > 64 ? 2 : 1),
        k(p.bw == HALO_BW, (p.C + BK - 1) / BK,
          valid_taps(y0, x0, p.H, p.W)) {}
};

// The weight boxes of K step i of tile t, as the n'th load into the weight
// ring since the launch began: waits until the buffer's last reader has
// released it (at once for the first B_STAGES loads of a launch). `tap0` is
// the conv's first tap in the weight map (0, or 9 * conv in a chain's map).
__device__ __forceinline__ void load_weights(const Smem& sm,
                                             const CUtensorMap* map_w,
                                             const Tile& t, int i, uint32_t n,
                                             int tap0) {
  const int s = n % B_STAGES;
  mbar_wait(sm.b_empty(s), ((n / B_STAGES) & 1) ^ 1);
  mbar_expect_tx(sm.b_full(s), t.n_halves * B_HALF_BYTES);
  for (int h = 0; h < t.n_halves; ++h)
    tma_load_3d(sm.b_base + s * B_BYTES + h * B_HALF_BYTES, map_w,
                sm.b_full(s), t.n0 + h * 64, t.k.slice(i) * BK,
                tap0 + t.k.tap(i));
}

// The pixel box that K step i of tile t begins (k.a_first(i)), as the n'th
// load into the pixel ring since the launch began.
__device__ __forceinline__ void load_pixels(const Smem& sm,
                                            const CUtensorMap* map_x,
                                            const Tile& t, int i, uint32_t n) {
  const uint32_t stages = t.k.halo ? A_HALO_STAGES : A_TAP_STAGES;
  const uint32_t a_bytes = t.k.halo ? A_HALO_BYTES : A_TAP_BYTES;
  const int s = n % stages;
  const int tap = t.k.halo ? 0 : t.k.tap(i);  // the haloed box is tap (0, 0)'s
  mbar_wait(sm.a_empty(s), ((n / stages) & 1) ^ 1);
  mbar_expect_tx(sm.a_full(s), a_bytes);
  tma_load_3d(sm.a_base + s * a_bytes, map_x, sm.a_full(s), t.k.slice(i) * BK,
              t.x0 + tap % 3 - 1, t.y0 + tap / 3 - 1);
}

// The residual tile of t into epilogue buffer e; res_full(e) completes when
// it has arrived.
__device__ __forceinline__ void load_residual(const Smem& sm, int e,
                                              const CUtensorMap* map_res,
                                              const Tile& t, const Params& p) {
  const int half_rows = p.bh / 2;
  int parts = 0;
  for (int g = 0; g < 2; ++g)
    if (t.y0 + g * half_rows < p.H) parts += t.n_halves;
  mbar_expect_tx(sm.res_full(e), parts * EPI_PART_BYTES);
  for (int g = 0; g < 2; ++g) {
    if (t.y0 + g * half_rows >= p.H) continue;
    for (int h = 0; h < t.n_halves; ++h)
      tma_load_3d(sm.epi_buf(e) + (g * 2 + h) * EPI_PART_BYTES, map_res,
                  sm.res_full(e), t.n0 + h * 64, t.x0, t.y0 + g * half_rows);
  }
}

// A consumer warpgroup's K loop over tile t: acc += its 64 pixels x 128
// channels. `na` and `nb` are the loads made into the pixel and the weight
// ring before this tile; they are advanced past it. Every buffer of the
// tile has been released when this returns.
__device__ __forceinline__ void multiply_tile(const Smem& sm, const Tile& t,
                                              int g, int lane,
                                              float (&acc)[64], uint32_t& na,
                                              uint32_t& nb) {
  const KLoop& k = t.k;
  const uint32_t a_stages = k.halo ? A_HALO_STAGES : A_TAP_STAGES;
  const uint32_t a_bytes = k.halo ? A_HALO_BYTES : A_TAP_BYTES;
  for (int i = 0; i < k.n_steps; ++i) {
    const uint32_t ai = na + k.a_index(i);
    const int sa = ai % a_stages;
    const uint32_t bi = nb + i;
    const int sb = bi % B_STAGES;
    // One lane of each warp polls: 256 threads polling one barrier get in
    // the way of the arrivals it waits for.
    if (lane == 0) {
      if (k.a_first(i)) mbar_wait(sm.a_full(sa), (ai / a_stages) & 1);
      mbar_wait(sm.b_full(sb), (bi / B_STAGES) & 1);
    }
    __syncwarp();
    // A: rows of 128 B, 8-row groups 1024 B apart; this warpgroup's 64
    // rows start at row g * 64 of a tap box, or at the tap's place in the
    // haloed box. B: 64-channel halves 8 KB apart (leading), 8-row (k)
    // groups 1024 B apart (stride).
    uint32_t a = sm.a_base + sa * a_bytes;
    if (k.halo) {
      const int tap = k.tap(i);
      a += ((g + tap / 3) * HALO_PITCH + tap % 3) * 128;
    } else {
      a += g * (64 * 128);
    }
    const uint64_t da = wgmma_desc(a, 16, 1024);
    const uint64_t db =
        wgmma_desc(sm.b_base + sb * B_BYTES, B_HALF_BYTES, 1024);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(acc, da + kk * 2, db + kk * 128);
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // One group stays in flight; the one before it has read its buffers.
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i > 0 && lane == 0) {
      mbar_arrive(sm.b_empty((bi - 1) % B_STAGES));
      if (k.a_last(i - 1))
        mbar_arrive(sm.a_empty((na + k.a_index(i - 1)) % a_stages));
    }
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  // The last step's buffers: a tile that follows finds its rings drained.
  if (lane == 0) {
    mbar_arrive(sm.b_empty((nb + k.n_steps - 1) % B_STAGES));
    mbar_arrive(sm.a_empty((na + k.a_index(k.n_steps - 1)) % a_stages));
  }
  na += k.a_index(k.n_steps - 1) + 1;
  nb += k.n_steps;
}

// A consumer warpgroup's epilogue on its accumulators and the store of its
// half of tile t from epilogue buffer e. With `add_residual` the buffer
// holds the residual tile, in the swizzled layout that TMA writes and this
// routine stores: with `residual_parity` >= 0 it is on its way by TMA and
// res_full(e) leaves that phase when it has arrived; with -1 it is there
// already (the tile this warpgroup stored from the buffer earlier). When
// this returns, the storing thread's store is complete in global memory.
__device__ __forceinline__ void finish_tile(const Smem& sm, int e,
                                            const CUtensorMap* map_out,
                                            const Tile& t, const Params& p,
                                            bool add_residual,
                                            int residual_parity, int g,
                                            int warp, int lane,
                                            float (&acc)[64]) {
  const int row_y = t.y0 + g * (p.bh / 2);
  // The vote tells the compiler what it cannot see, that a warp's lanes
  // agree here. With a plain `if`, it takes a caller's tile loop for
  // divergent, keeps the K loop's addresses and wgmma descriptors out of the
  // uniform registers, and the four wgmma of a step no longer start back to
  // back (the one-launch chain was a quarter slower).
  if (__all_sync(0xffffffffu, row_y < p.H)) {
    if (add_residual && residual_parity >= 0)
      mbar_wait(sm.res_full(e), residual_parity);
    // Fragment: acc[4j + {0,1}] is row r0, acc[4j + {2,3}] row r0 + 8,
    // channels 8j + 2 * (lane % 4) + {0,1}. In the swizzled tile the
    // 16-byte chunk j % 8 of row r lies at chunk (j % 8) ^ (r % 8), so the
    // 32 lanes of a warp touch 32 different banks.
    const int r0 = (warp & 3) * 16 + (lane >> 2);
    const uint32_t part = sm.epi_buf(e) + g * 2 * EPI_PART_BYTES;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int col = t.n0 + j * 8 + (lane & 3) * 2;
      float2 sc = make_float2(0.0f, 0.0f), sh = make_float2(0.0f, 0.0f);
      if (col < p.F) {
        sc = __ldg(reinterpret_cast<const float2*>(p.scale + col));
        sh = __ldg(reinterpret_cast<const float2*>(p.shift + col));
      }
      const uint32_t addr = part + (j >> 3) * EPI_PART_BYTES + r0 * 128 +
                            ((((j & 7) ^ (lane >> 2)) & 7) << 4) +
                            (lane & 3) * 4;
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // rows r0 and r0 + 8
        float v0 = acc[4 * j + 2 * q] * sc.x + sh.x;
        float v1 = acc[4 * j + 2 * q + 1] * sc.y + sh.y;
        if (add_residual) {
          const uint32_t rv = ld_shared_u32(addr + q * 1024);
          const float2 rf = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&rv));
          v0 += rf.x;
          v1 += rf.y;
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        const __nv_bfloat162 ob = __floats2bfloat162_rn(v0, v1);
        st_shared_u32(addr + q * 1024, *reinterpret_cast<const uint32_t*>(&ob));
      }
    }
    // Make the tile visible to the TMA engine, then one thread stores it and
    // waits until the store is complete (not only until it has read the
    // buffer): in a chain, other CTAs load what it wrote.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(g + 1) : "memory");
    if ((warp & 3) == 0 && lane == 0) {
      for (int h = 0; h < t.n_halves; ++h)
        tma_store_3d(map_out, part + h * EPI_PART_BYTES, t.n0 + h * 64, t.x0,
                     row_y);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
  }
}

// ---- one tile a CTA: K1 --------------------------------------------------------

// The tile of blockIdx: pixel box blockIdx.x (x fastest), channels
// [blockIdx.y * BN, + BN). Every thread of the CTA calls this and none
// returns before its role is done. `map_x` has the haloed box if
// p.bw == HALO_BW, else the tap box. Preconditions: C % 8 == 0, F % 8 == 0,
// 16-byte aligned base pointers; `map_res` is not used if
// p.has_residual == 0.
__device__ __forceinline__ void conv3x3_tile(const CUtensorMap* map_x,
                                             const CUtensorMap* map_w,
                                             const CUtensorMap* map_res,
                                             const CUtensorMap* map_out,
                                             const Params& p,
                                             unsigned char* smem_raw) {
  const Smem sm(smem_raw, 1);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const Tile t(p, blockIdx.x, blockIdx.y);

  if (tid == 0) sm.init_barriers();
  __syncthreads();

  if (wg == 0) {
    // ---- producer -------------------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 0 && lane == 0) {
      // The weights' producer (and the residual's).
      tma_prefetch_map(map_w);
      tma_prefetch_map(map_out);
      if (p.has_residual) tma_prefetch_map(map_res);
      // Before the dependency wait: the weights of the first steps.
      const int n_pre = t.k.n_steps < B_STAGES ? t.k.n_steps : B_STAGES;
      for (int i = 0; i < n_pre; ++i) load_weights(sm, map_w, t, i, i, 0);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      if (p.has_residual) load_residual(sm, 0, map_res, t, p);
      for (int i = n_pre; i < t.k.n_steps; ++i)
        load_weights(sm, map_w, t, i, i, 0);
    } else if (warp == 1 && lane == 0) {
      // The pixels' producer: a thread of its own, so that a haloed box is
      // asked for as soon as its buffer is free, two slices ahead, and not
      // when the weights' loop gets there.
      tma_prefetch_map(map_x);
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
      uint32_t na = 0;
      for (int i = 0; i < t.k.n_steps; ++i)
        if (t.k.a_first(i)) load_pixels(sm, map_x, t, i, na++);
    }
  } else {
    // ---- consumers --------------------------------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int g = wg - 1;  // which 64 pixel rows of the tile

    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    uint32_t na = 0, nb = 0;
    multiply_tile(sm, t, g, lane, acc, na, nb);
    // The conv after this one may start its own set-up now.
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    // Orders this thread's global reads and the tile's store after the
    // grid before (the producer's wait already ordered the loads).
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    finish_tile(sm, 0, map_out, t, p, p.has_residual != 0, 0, g, warp, lane,
                acc);
  }
}

}  // namespace conv3x3_wgmma
