// Incidence SpMM kernels of the dilated Laplacian matvec, fp32, sm_90a.
//
// One row-gather body computes the fused series step
//     out[i, :] = alpha * (deg_i * Vs[i, :] - sum_j w_ij V[j, :]) + beta * Vs[i, :]
// with L = X^T W X of an edge list and V an (n_in, k) row-major panel, over
// a destination-sorted half-edge CSR (row_ptr (n+1,), other, weight): row i
// lists every live half-edge (i <- j, w_ij) of the edge list, so deg_i is
// the sum of the row's own weights.  Vs is the (n, k) panel of the rows'
// own ("self") terms: V itself for a whole graph (n_in = n), or a row
// range of V for a panel shard, whose n owned rows start at row_start
// (Vs = V + row_start * k) while their neighbours index all of V.  Both
// kernels launch it:
//
// K1  edge_spmm  replaces repro/kernels/edge_spmm/kernel.py:94 `edge_spmm`
//     (pallas_call at :106), the one-hot incidence SpMM of small graphs and
//     of the probes; its CSR is built once per edge list on the card.
// K2  edge_spmm_nb  replaces repro/kernels/edge_spmm/kernel.py:151
//     `edge_spmm_nb` (pallas_call at :188), the node-blocked SpMM of large
//     graphs (n > 4096 on the kernel path); its CSR is built the same way.
//
// Bound: bytes.  The work is 2E gathered V rows, two FLOP per gathered
// element; at k = 10 that is ~0.5 FLOP per byte moved, far below the
// fp32 ridge.  The streamed index and weight arrays (8 B per half-edge)
// are read once with the evict-first hint (`__ldcs`), so the 42 MB panel
// of the main path (n = 2^20, k = 10) keeps the 50 MB L2 for its random
// row gathers; out is stored with the default policy, since the next
// series step reads it as its V.
//
// Design.  Every output row is written once, by the threads that summed
// it, in registers: no init pass, no atomics (shared or global), no
// division per item, and a summation order fixed by the layout, so two
// calls give the same bits.
//   * Column split.  A row of V is cw <= 16 floats of one column group
//     (gridDim.y groups of 16 columns cover wider panels).  A group of
//     LPR = cw / VW lanes owns one row; lane s holds columns
//     [s*VW, s*VW + VW) as one float4 / float2 / float load (VW = 4 when k
//     is a multiple of 4, 2 when even, 1 otherwise).  At k = 10 that is
//     five float2 lanes per row and six rows per warp (30 of 32 lanes
//     busy).  The lanes of a group walk the whole neighbour list together:
//     the index and weight loads of a group hit one address, and each
//     gathered V row is one contiguous 40-byte read.  Each lane keeps
//     kUnroll neighbours' loads in flight.  No shuffles are needed: a lane
//     already holds the full sums of its own columns.
//   * Hub rows.  A row longer than hub_threshold would serialize its group
//     (a power-law hub has ~10^4 neighbours), so the light path skips it
//     and a hub block takes it: the block's kThreads / LPR groups each sum
//     every NG-th neighbour of the row, write their partials to shared
//     memory, and a fixed tree over the groups reduces them; the hub
//     blocks come first in the grid, so they start first, and each walks
//     the list hub_rows (ascending, padded with n) built with the CSR.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 16;  // panel columns per column group
constexpr int kUnroll = 4;    // neighbours in flight per lane
constexpr int kMaxHubBlocks = 1024;

template <int VW>
__device__ __forceinline__ void load_row(const float* p, float (&x)[VW]) {
  if constexpr (VW == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = t.x;
    x[1] = t.y;
    x[2] = t.z;
    x[3] = t.w;
  } else if constexpr (VW == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = t.x;
    x[1] = t.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int VW>
__device__ __forceinline__ void store_row(float* p, const float (&x)[VW]) {
  if constexpr (VW == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VW == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

// acc += sum of w_p * V[other_p, col:col+VW] and dsum += sum of w_p over
// the entries p = p0, p0 + step, ... < p1, in that order
template <int VW>
__device__ __forceinline__ void gather(const int* __restrict__ other,
                                       const float* __restrict__ weight,
                                       const float* __restrict__ v, int k,
                                       int col, int p0, int p1, int step,
                                       float (&acc)[VW], float& dsum) {
  int p = p0;
  for (; p + (kUnroll - 1) * step < p1; p += kUnroll * step) {
    int j[kUnroll];
    float w[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      j[u] = __ldcs(other + p + u * step);
      w[u] = __ldcs(weight + p + u * step);
    }
    float x[kUnroll][VW];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      load_row<VW>(v + (long long)j[u] * k + col, x[u]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      dsum += w[u];
#pragma unroll
      for (int q = 0; q < VW; ++q) acc[q] = fmaf(w[u], x[u][q], acc[q]);
    }
  }
  for (; p < p1; p += step) {
    const int j = __ldcs(other + p);
    const float w = __ldcs(weight + p);
    float x[VW];
    load_row<VW>(v + (long long)j * k + col, x);
    dsum += w;
#pragma unroll
    for (int q = 0; q < VW; ++q) acc[q] = fmaf(w, x[q], acc[q]);
  }
}

// out[r, col:col+VW] = alpha * (dsum * Vs[r] - acc) + beta * Vs[r]
template <int VW>
__device__ __forceinline__ void epilogue(const float* __restrict__ v_self,
                                         float* __restrict__ out, long long o,
                                         const float (&acc)[VW], float dsum,
                                         float alpha, float beta) {
  float vi[VW], y[VW];
  load_row<VW>(v_self + o, vi);
#pragma unroll
  for (int q = 0; q < VW; ++q) {
    y[q] = alpha * (dsum * vi[q] - acc[q]) + beta * vi[q];
  }
  store_row<VW>(out + o, y);
}

template <int VW>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const int* __restrict__ row_ptr,
                      const int* __restrict__ other,
                      const float* __restrict__ weight,
                      const int* __restrict__ hub_rows,
                      const float* __restrict__ v,
                      const float* __restrict__ v_self,
                      float* __restrict__ out, float alpha, float beta,
                      int n, int k, int hub_slots, int hub_threshold,
                      int hub_blocks) {
  // per-group partials of a hub row: kMaxCols sums, then the weight sum
  __shared__ float part[kThreads][kMaxCols + 1];
  const int c0 = blockIdx.y * kMaxCols;
  const int cw = min(kMaxCols, k - c0);
  const int lpr = cw / VW;  // lanes per row
  if ((int)blockIdx.x < hub_blocks) {
    const int ng = kThreads / lpr;
    const int g = threadIdx.x / lpr;
    const int col = c0 + (threadIdx.x - g * lpr) * VW;
    for (int h = blockIdx.x; h < hub_slots; h += hub_blocks) {
      const int r = hub_rows[h];
      if (r >= n) break;  // the list is padded with n past its last hub
      if (g < ng) {
        float acc[VW] = {};
        float dsum = 0.f;
        gather<VW>(other, weight, v, k, col, row_ptr[r] + g, row_ptr[r + 1],
                   ng, acc, dsum);
#pragma unroll
        for (int q = 0; q < VW; ++q) part[g][col - c0 + q] = acc[q];
        part[g][kMaxCols] = dsum;
      }
      __syncthreads();
      // fixed tree over the groups: s runs over powers of two below ng
      int s = 1;
      while (2 * s < ng) s *= 2;
      for (; s > 0; s /= 2) {
        for (int i = threadIdx.x; i < s * (kMaxCols + 1); i += kThreads) {
          const int gg = i / (kMaxCols + 1);
          const int cc = i - gg * (kMaxCols + 1);
          if (gg + s < ng && (cc < cw || cc == kMaxCols)) {
            part[gg][cc] += part[gg + s][cc];
          }
        }
        __syncthreads();
      }
      if ((int)threadIdx.x < cw) {
        const long long o = (long long)r * k + c0 + threadIdx.x;
        const float vi = v_self[o];
        out[o] = alpha * (part[0][kMaxCols] * vi - part[0][threadIdx.x]) +
                 beta * vi;
      }
      __syncthreads();  // part is rewritten for the next hub row
    }
    return;
  }
  const int lane = threadIdx.x % 32;
  const int rpw = 32 / lpr;  // rows per warp
  const int gi = lane / lpr;
  if (gi >= rpw) return;  // the lanes a row width leaves over
  const long long row =
      ((long long)(blockIdx.x - hub_blocks) * kWarps + threadIdx.x / 32) *
          rpw + gi;
  if (row >= n) return;
  const int p0 = row_ptr[row];
  const int p1 = row_ptr[row + 1];
  if (p1 - p0 > hub_threshold) return;  // a hub block writes this row
  const int col = c0 + (lane - gi * lpr) * VW;
  float acc[VW] = {};
  float dsum = 0.f;
  gather<VW>(other, weight, v, k, col, p0, p1, 1, acc, dsum);
  epilogue<VW>(v_self, out, row * k + col, acc, dsum, alpha, beta);
}

template <int VW>
cudaError_t launch(const int* row_ptr, const int* other, const float* weight,
                   const int* hub_rows, const float* v, const float* v_self,
                   float* out, float alpha, float beta, int n, int k,
                   int hub_slots, int hub_threshold, cudaStream_t s) {
  const int lpr = min(kMaxCols, k) / VW;
  const long long rows_per_block = (long long)kWarps * (32 / lpr);
  const long long light = (n + rows_per_block - 1) / rows_per_block;
  const int hub_blocks = min(hub_slots - 1, kMaxHubBlocks);
  const long long blocks = light + (hub_blocks > 0 ? hub_blocks : 0);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (k + kMaxCols - 1) / kMaxCols);
  row_gather_kernel<VW><<<grid, kThreads, 0, s>>>(
      row_ptr, other, weight, hub_rows, v, v_self, out, alpha, beta, n, k,
      hub_slots, hub_threshold, hub_blocks > 0 ? hub_blocks : 0);
  return cudaGetLastError();
}

}  // namespace

// The one entry of both K1 and K2: n is the number of output rows (the
// rows of row_ptr and v_self; v has any number of rows the CSR indexes),
// hub_slots the length of hub_rows (at least 1: the list ends with n).
// An empty panel launches nothing.
extern "C" int edge_spmm_rows_launch(const int* row_ptr, const int* other,
                                     const float* weight, const int* hub_rows,
                                     const float* v, const float* v_self,
                                     float* out, float alpha, float beta,
                                     int n, int k, int hub_slots,
                                     int hub_threshold, void* stream) {
  if (n <= 0 || k <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const unsigned long long align =
      reinterpret_cast<unsigned long long>(v) |
      reinterpret_cast<unsigned long long>(v_self) |
      reinterpret_cast<unsigned long long>(out);
  // a column group's first column is a multiple of 16, so with k a
  // multiple of VW every row slice a lane reads is VW-aligned
  if (k % 4 == 0 && align % 16 == 0) {
    return (int)launch<4>(row_ptr, other, weight, hub_rows, v, v_self, out,
                          alpha, beta, n, k, hub_slots, hub_threshold, s);
  }
  if (k % 2 == 0 && align % 8 == 0) {
    return (int)launch<2>(row_ptr, other, weight, hub_rows, v, v_self, out,
                          alpha, beta, n, k, hub_slots, hub_threshold, s);
  }
  return (int)launch<1>(row_ptr, other, weight, hub_rows, v, v_self, out,
                        alpha, beta, n, k, hub_slots, hub_threshold, s);
}
