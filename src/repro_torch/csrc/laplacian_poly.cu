// The dense-Laplacian panel product of the limit series, fp32, sm_90a.
//
// K5  poly_step  replaces repro/kernels/laplacian_poly/kernel.py:44
//     `poly_step` (body `_poly_step_kernel` :25, pallas_call at :54):
//     out = U - c * (L @ U), L (n, n), U (n, k), with the AXPY fused into
//     the epilogue so L @ U never round-trips device memory.
// K6  dense_matvec_panel  replaces repro/kernels/laplacian_poly/kernel.py:80
//     `dense_matvec_panel` (body `_matmul_kernel` :66, pallas_call at :88):
//     the plain out = L @ U, the unfused baseline K5 is measured against.
//
// Bound: bytes.  Both read L once (4 n^2 bytes) and the panel a few times
// (4 n k each); the arithmetic is 2 n^2 k FLOP, k / 2 FLOP per byte of L,
// below the H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s, ~20) for any
// k < 40.  At n = 16384, k = 10 the bound is 0.321 ms.
//
// Design.  The TPU kernel carries the (256, k) sum across a sequential j
// grid axis in its resident output block.  Here that axis is a loop inside
// one thread block, which owns a strip of kStripRows rows of L:
//   * each warp owns kRowsPerWarp rows and streams them once, lane l
//     reading columns 4l, 4l + 128, ... of a kTileCols-wide tile as float4
//     (512 contiguous bytes per row per warp instruction), with the
//     evict-first hint so L does not push U out of the L2;
//   * the block stages the (kTileCols, k) tile of U TRANSPOSED in shared
//     memory, so a lane's four columns of one panel column are one
//     conflict-free float4 load, reused across the warp's rows; the tile's
//     row stride is padded by four floats so the transposing stores of
//     neighbouring panel columns fall in different banks;
//   * the (rows, k) fp32 sum lives in registers, per lane, and is reduced
//     across the warp with shuffles once at the end; lane j of the warp
//     writes column j, as U_row - c * sum (K5) or the sum itself (K6).
// Strips of 32 rows give n / 32 blocks (512 at n = 16384), several per SM.
// Rows past n are masked; a row length that is not a multiple of four (or
// an L that is not 16-byte aligned) takes the scalar-load variant.  Panels
// wider than kMaxCols run as column groups, one launch each: the columns of
// the product are independent.  No tensor cores: fp32 FMA throughout, so
// no TF32 rounding enters the series.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kStripRows = kWarps * kRowsPerWarp;  // 32
constexpr int kTileCols = 512;
constexpr int kTileStride = kTileCols + 4;  // floats per staged panel column
constexpr int kMaxCols = 16;

template <int KMAX, int VEC, bool kAxpy>
__global__ void __launch_bounds__(kThreads, 2)
    dense_panel_kernel(const float* __restrict__ l, const float* __restrict__ u,
                       float* __restrict__ out, float c, int n, int k,
                       int ldu) {
  extern __shared__ __align__(16) float ut[];  // k x kTileStride, U^T tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const long long row0 =
      (long long)blockIdx.x * kStripRows + warp * kRowsPerWarp;
  float acc[kRowsPerWarp][KMAX];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[r][j] = 0.f;
  }
  for (int j0 = 0; j0 < n; j0 += kTileCols) {
    const int cols = min(kTileCols, n - j0);
    __syncthreads();  // every warp is done with the previous tile
    // coalesced read of U rows j0 .. j0 + cols, transposed into ut;
    // columns past n are zero-filled
    for (int i = threadIdx.x; i < kTileCols * k; i += kThreads) {
      const int j = i / k;
      const int cc = i - j * k;
      ut[cc * kTileStride + j] =
          j < cols ? u[(long long)(j0 + j) * ldu + cc] : 0.f;
    }
    __syncthreads();
    for (int jj = lane * VEC; jj < cols; jj += 32 * VEC) {
      float lv[kRowsPerWarp][VEC];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const long long row = row0 + r;
        if (row < n) {
          const float* src = l + row * n + j0 + jj;
          if constexpr (VEC == 4) {
            const float4 x = __ldcs(reinterpret_cast<const float4*>(src));
            lv[r][0] = x.x;
            lv[r][1] = x.y;
            lv[r][2] = x.z;
            lv[r][3] = x.w;
          } else {
            lv[r][0] = __ldcs(src);
          }
        } else {
#pragma unroll
          for (int q = 0; q < VEC; ++q) lv[r][q] = 0.f;
        }
      }
#pragma unroll
      for (int cc = 0; cc < KMAX; ++cc) {
        if (cc < k) {
          float uq[VEC];
          const float* col = ut + cc * kTileStride + jj;
          if constexpr (VEC == 4) {
            const float4 y = *reinterpret_cast<const float4*>(col);
            uq[0] = y.x;
            uq[1] = y.y;
            uq[2] = y.z;
            uq[3] = y.w;
          } else {
            uq[0] = *col;
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
            for (int q = 0; q < VEC; ++q) {
              acc[r][cc] = fmaf(lv[r][q], uq[q], acc[r][cc]);
            }
          }
        }
      }
    }
  }
  // butterfly sums leave every lane with the row totals; lane j keeps
  // column j's and writes it
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float mine = 0.f;
#pragma unroll
    for (int cc = 0; cc < KMAX; ++cc) {
      float s = acc[r][cc];
#pragma unroll
      for (int off = 16; off > 0; off /= 2) {
        s += __shfl_xor_sync(0xffffffffu, s, off);
      }
      if (lane == cc) mine = s;
    }
    const long long row = row0 + r;
    if (row < n && lane < k) {
      const long long o = row * ldu + lane;
      if constexpr (kAxpy) {
        out[o] = u[o] - c * mine;
      } else {
        out[o] = mine;
      }
    }
  }
}

template <int KMAX, bool kAxpy>
void launch_group(const float* l, const float* u, float* out, float c, int n,
                  int k, int ldu, bool vec4, cudaStream_t s) {
  const int blocks = (n + kStripRows - 1) / kStripRows;
  const size_t smem = (size_t)k * kTileStride * sizeof(float);
  if (vec4) {
    dense_panel_kernel<KMAX, 4, kAxpy>
        <<<blocks, kThreads, smem, s>>>(l, u, out, c, n, k, ldu);
  } else {
    dense_panel_kernel<KMAX, 1, kAxpy>
        <<<blocks, kThreads, smem, s>>>(l, u, out, c, n, k, ldu);
  }
}

// one launch per group of at most kMaxCols panel columns; U and out are
// row-major (n, k), L row-major (n, n)
template <bool kAxpy>
int launch(const float* l, const float* u, float* out, float c, int n, int k,
           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec4 =
      n % 4 == 0 && reinterpret_cast<unsigned long long>(l) % 16 == 0;
  if (n > 0) {
    for (int g0 = 0; g0 < k; g0 += kMaxCols) {
      const int kg = min(kMaxCols, k - g0);
      if (kg <= 4) {
        launch_group<4, kAxpy>(l, u + g0, out + g0, c, n, kg, k, vec4, s);
      } else if (kg <= 8) {
        launch_group<8, kAxpy>(l, u + g0, out + g0, c, n, kg, k, vec4, s);
      } else if (kg <= 12) {
        launch_group<12, kAxpy>(l, u + g0, out + g0, c, n, kg, k, vec4, s);
      } else {
        launch_group<16, kAxpy>(l, u + g0, out + g0, c, n, kg, k, vec4, s);
      }
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int poly_step_launch(const float* l, const float* u, float* out,
                                float c, int n, int k, void* stream) {
  return launch<true>(l, u, out, c, n, k, stream);
}

extern "C" int dense_matvec_panel_launch(const float* l, const float* u,
                                         float* out, int n, int k,
                                         void* stream) {
  return launch<false>(l, u, out, 0.f, n, k, stream);
}
