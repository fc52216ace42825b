// One output tile of a fused 3x3 SAME convolution with a per-channel affine
// epilogue, shared by K1 (conv3x3_bn_act.cu, one tile per CTA) and K3
// (resblock_chain_fused.cu, a persistent grid that walks the tiles of 2N
// convolutions).
//
//   out[p, f] = act( sum_{dy,dx,c} x[p + (dy-1, dx-1), c] * w[dy, dx, c, f]
//                    * scale[f] + shift[f] (+ residual[p, f]) )
//
// x [H, W, C] bf16 (NHWC, no batch), w [3, 3, C, F] bf16 (HWIO), scale and
// shift [F] f32, residual and out [H, W, F] bf16; act is ReLU or the
// identity. Zero SAME padding.
//
// An implicit GEMM: M = H*W output pixels, N = F, K = 9*C. A CTA of 8 warps
// computes one 128 x 128 output tile. The K loop walks the 9 taps and,
// inside each tap, C in slices of 32. Each step copies an A tile (128
// shifted input pixels x 32 channels; out-of-image pixels are zero-filled
// by the copy itself, which is the SAME padding) and a B tile (32 x 128 of
// the weights) into shared memory with cp.async, four stages deep, so that
// loads run ahead of the tensor cores. Each warp owns a 64 x 32 sub-tile and
// accumulates it in f32 with 16x16x16 bf16 WMMA fragments (mma.sync). The
// epilogue stages the f32 tile through shared memory, applies scale, shift,
// residual and ReLU in f32 and stores 16-byte vectors of bf16.
//
// Every read of x and of the residual goes through L2 (cp.async.cg and
// ld.global.cg), never through the SM's L1: in K3, other CTAs wrote them
// earlier in the same launch, and L1 is not coherent across SMs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace conv3x3 {

using namespace nvcuda;

constexpr int BM = 128;  // output pixels per tile
constexpr int BN = 128;  // output channels per tile
constexpr int BK = 32;   // input channels per K step
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int LDA = BK + 8;  // padded smem rows (bf16 elements)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;  // f32 epilogue rows
constexpr int A_STAGE = BM * LDA;
constexpr int B_STAGE = BK * LDB;
constexpr int PIPE_BYTES = STAGES * (A_STAGE + B_STAGE) * 2;
constexpr int EPI_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = PIPE_BYTES > EPI_BYTES ? PIPE_BYTES : EPI_BYTES;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = valid ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The output tile [m0, m0 + BM) x [n0, n0 + BN), masked at the ragged edges.
// `residual` may be null, or may alias `out`: each element of it is read
// once, by the thread that then writes that element of `out`. `smem_raw`
// holds SMEM_BYTES; it is free again when the call returns. Preconditions:
// C % 32 == 0, F % 8 == 0, 16-byte aligned base pointers.
__device__ __forceinline__ void conv3x3_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ shift,
    const __nv_bfloat16* residual, __nv_bfloat16* out, int H, int W, int C,
    int F, bool relu, int m0, int n0, unsigned char* smem_raw) {
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Bs = As + STAGES * A_STAGE;
  float* Cs = reinterpret_cast<float*>(smem_raw);  // reused after the K loop

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;  // 2 warps along M, 64 rows each
  const int warp_n = warp & 3;   // 4 warps along N, 32 columns each
  const int HW = H * W;

  // A loads: rows tid/4 and tid/4 + 64, 16-byte chunk tid%4 of the slice.
  const int a_chunk = tid & 3;
  int a_py[2], a_px[2];
  bool a_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + (tid >> 2) + i * 64;
    a_ok[i] = p < HW;
    a_py[i] = p / W;
    a_px[i] = p - (p / W) * W;
  }
  // B loads: rows tid/16 and tid/16 + 16, 16-byte chunk tid%16 of BN.
  const int b_chunk = tid & 15;
  const int b_n = n0 + b_chunk * 8;
  const bool b_ok = b_n < F;

  const int c_tiles = C / BK;
  const int KT = 9 * c_tiles;

  auto load_tile = [&](int kt, int stage) {
    const int tap = kt / c_tiles;
    const int c0 = (kt - tap * c_tiles) * BK;
    const int dy = tap / 3 - 1;
    const int dx = tap % 3 - 1;
    __nv_bfloat16* as = As + stage * A_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (tid >> 2) + i * 64;
      const int sy = a_py[i] + dy;
      const int sx = a_px[i] + dx;
      const bool ok = a_ok[i] && sy >= 0 && sy < H && sx >= 0 && sx < W;
      const __nv_bfloat16* src =
          ok ? x + (static_cast<size_t>(sy) * W + sx) * C + c0 + a_chunk * 8
             : x;
      cp_async16(as + r * LDA + a_chunk * 8, src, ok);
    }
    __nv_bfloat16* bs = Bs + stage * B_STAGE;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = (tid >> 4) + i * 16;
      const __nv_bfloat16* src =
          b_ok ? w + static_cast<size_t>(tap * C + c0 + k) * F + b_n : w;
      cp_async16(bs + k * LDB + b_chunk * 8, src, b_ok);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load_tile(s, s);
    cp_async_commit();
  }

  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed; every warp is done with tile kt-1
    const int nk = kt + STAGES - 1;
    if (nk < KT) load_tile(nk, nk % STAGES);
    cp_async_commit();

    const __nv_bfloat16* as = As + (kt % STAGES) * A_STAGE;
    const __nv_bfloat16* bs = Bs + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          af[4];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(af[i], as + (warp_m * 64 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bf[j], bs + kk * LDB + warp_n * 32 + j * 16,
                               LDB);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], af[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // pipeline smem is free: stage the f32 tile there

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          Cs + (warp_m * 64 + i * 16) * LDC + warp_n * 32 + j * 16, acc[i][j],
          LDC, wmma::mem_row_major);
  __syncthreads();

  // Epilogue: 8 consecutive channels of one pixel per item.
  for (int e = tid; e < BM * (BN / 8); e += THREADS) {
    const int r = e / (BN / 8);
    const int c8 = (e - r * (BN / 8)) * 8;
    const int p = m0 + r;
    const int n = n0 + c8;
    if (p >= HW || n >= F) continue;
    const float4 lo = *reinterpret_cast<const float4*>(Cs + r * LDC + c8);
    const float4 hi = *reinterpret_cast<const float4*>(Cs + r * LDC + c8 + 4);
    float v[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = v[q] * scale[n + q] + shift[n + q];
    const size_t off = static_cast<size_t>(p) * F + n;
    if (residual != nullptr) {
      const uint4 rv = __ldcg(reinterpret_cast<const uint4*>(residual + off));
      const __nv_bfloat16* rb = reinterpret_cast<const __nv_bfloat16*>(&rv);
#pragma unroll
      for (int q = 0; q < 8; ++q) v[q] += __bfloat162float(rb[q]);
    }
    uint4 ov;
    __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(&ov);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      ob[q] = __float2bfloat16(relu ? fmaxf(v[q], 0.0f) : v[q]);
    *reinterpret_cast<uint4*>(out + off) = ov;
  }
  __syncthreads();  // every warp is done with Cs: smem is free again
}

}  // namespace conv3x3
