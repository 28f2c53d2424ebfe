// k-means' nearest-centre search, fp32, sm_90a: for each row x of an
// (n, d) matrix and (m, d) centres c, min_j sum_t (x_t - c_jt)^2 and the
// argmin j, or the elementwise min of that minimum and a running one.
//
// kmeans_dist  replaces no Pallas kernel: repro/core/kmeans.py is plain
//     jnp.  The port's k-means broadcast an (n, m, d) tensor of
//     differences, squared it and summed it, then took min and argmin: at
//     n = 2^22, m = d = 30 two (n, 30, 30) f32 tensors of 15 GB written and
//     read each Lloyd pass, and in the k-means++ seeding an (n, i, d) tensor
//     at each draw i.
//     Arithmetic.  Each distance is summed from the differences, never
//     from |x|^2 - 2 x.c + |c|^2, which cancels where a point lies near a
//     centre.  And it is summed exactly as the broadcast twin,
//     torch.sum((x - c) ** 2, -1), sums it on the card (torch 2.11's
//     reduction of a contiguous row, ATen/native/cuda/Reduce.cuh, for
//     d < 128; a private heuristic of torch, which a later release may
//     change, and then the bitwise card tests fail): each
//     difference and square rounds on its own, lane l of W = min(
//     last_pow2(d), 32) adds v_l and v_{l+W}, and the lanes meet in a tree
//     of halving offsets.  So the kernel's distances, minima and argmins
//     are the twin's bit for bit, and k-means through it draws and labels
//     as the broadcast k-means did: its labels flip by ~0.1 % under any
//     other rounding (its embedding, five solver steps from a random
//     panel, leaves many points near two centres).  Centres are scanned
//     in ascending j with a strict `<`, so ties take the lowest j and a
//     NaN distance wins at its first j, as torch.argmin and torch.min do.
//     No atomics: a repeat gives the same bits.
//     Bound: FP32 throughput.  n m d subtractions, multiplies and adds, each an
//     instruction (3 n m d are 0.34 ms at n = 2^22, m = d = 30 on 132 SMs x
//     128 lanes at 1.98 GHz; an FMA would save a third but round
//     otherwise), against one read of x (503 MB, 0.15 ms at 3.35 TB/s); a
//     row writes only its minimum (4 bytes) and argmin (8).
//     Design.  One thread a row, kThreads rows a block.  The block's rows
//     are one contiguous range of x: they are copied into shared memory by
//     coalesced 16-byte loads (4-byte where x is not 16-byte aligned), and
//     each thread then takes its row into registers: one compile-time body
//     for each lane width W (1, 2, 4, ..., 32; so d <= 64), the row
//     zero-padded to 2W, so every register and shared offset and the lane
//     tree are immediates.  The padding adds +0 to a lane's sum, which
//     changes no bit.
//     The same shared memory then holds the centres, kCentreFloats at a
//     time (any m) in rows padded to 4 floats, which every thread reads as
//     float4 broadcasts.  Rows wider than 64 (no caller of the pipeline has
//     them) take a body that reads x and c through the read-only cache in
//     the same order.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // rows a block, one a thread
constexpr int kMaxD = 64;            // widest row with a compile-time body
constexpr int kCentreFloats = 4096;  // shared floats of one chunk of centres

// the running argmin: the first strictly smaller distance, or the first NaN
__device__ __forceinline__ void take(float acc, int j, float* best, int* arg) {
  if (acc < *best || (isnan(acc) && !isnan(*best))) {
    *best = acc;
    *arg = j;
  }
}

// min(last_pow2(d), 32): the lanes over which torch's CUDA reduction sums
// a contiguous row of d < 128 floats (ATen/native/cuda/Reduce.cuh)
__host__ __device__ constexpr int lane_width(int d) {
  int w = 1;
  while (2 * w <= d && w < 32) w *= 2;
  return w;
}

// torch.sum((x - c) ** 2) of one row in torch's order: lane l of W holds
// v_l + v_{l+W} (v_t the rounded square of the rounded difference), then
// the lanes are added in a tree of halving offsets W/2, ..., 1; every
// operation rounds on its own (no FMA).  xr holds the row zero-padded to
// 2W floats, cj a shared centre row of kStride floats (16-byte aligned,
// zero past d).
template <int W>
__device__ __forceinline__ float sq_dist(const float (&xr)[2 * W],
                                         const float* cj) {
  constexpr int kStride = (2 * W + 3) / 4 * 4;
  float cv[kStride];
#pragma unroll
  for (int t = 0; t < kStride; t += 4) {
    const float4 q = *reinterpret_cast<const float4*>(cj + t);
    cv[t] = q.x;
    cv[t + 1] = q.y;
    cv[t + 2] = q.z;
    cv[t + 3] = q.w;
  }
  float s[W];
#pragma unroll
  for (int l = 0; l < W; ++l) {
    const float e = __fsub_rn(xr[l], cv[l]);
    const float f = __fsub_rn(xr[l + W], cv[l + W]);
    s[l] = __fadd_rn(__fmul_rn(e, e), __fmul_rn(f, f));
  }
#pragma unroll
  for (int off = W / 2; off > 0; off /= 2) {
#pragma unroll
    for (int l = 0; l < off; ++l) s[l] = __fadd_rn(s[l], s[l + off]);
  }
  return s[0];
}

// row i's result: its minimum (or the min with the running one) and argmin
__device__ __forceinline__ void store_row(long long i, float best, int arg,
                                          const float* prev, float* out_min,
                                          long long* out_arg) {
  if (prev != nullptr) {
    const float p = prev[i];
    if (isnan(p) || p < best) best = p;
  }
  out_min[i] = best;
  if (out_arg != nullptr) out_arg[i] = arg;
}

template <int W>
__global__ void __launch_bounds__(kThreads)
    nearest_kernel(const float* __restrict__ x, const float* __restrict__ c,
                   const float* prev, float* out_min,
                   long long* __restrict__ out_arg, int n, int m, int d) {
  constexpr int D = 2 * W;                  // the padded row
  constexpr int kStride = (D + 3) / 4 * 4;  // a centre's shared row
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * kThreads;
  const int rows = (int)min((long long)kThreads, (long long)n - r0);

  // the block's rows, one contiguous range of x, into shared memory
  const float* src = x + r0 * d;
  const int floats = rows * d;
  int head = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    head = floats / 4 * 4;
    for (int f = 4 * tid; f < head; f += 4 * kThreads) {
      *reinterpret_cast<float4*>(smem + f) =
          __ldg(reinterpret_cast<const float4*>(src + f));
    }
  }
  for (int f = head + tid; f < floats; f += kThreads) smem[f] = __ldg(src + f);
  __syncthreads();

  // this thread's row into registers, zero past d
  const bool active = tid < rows;
  float xr[D];
  const float* row = smem + tid * d;
#pragma unroll
  for (int t = 0; t < D; ++t) xr[t] = (active && t < d) ? row[t] : 0.0f;
  __syncthreads();  // the rows are read: the memory takes the centres

  float best = CUDART_INF_F;
  int arg = 0;
  constexpr int kChunk = kCentreFloats / kStride;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int cnt = min(kChunk, m - j0);
    for (int f = tid; f < cnt * kStride; f += kThreads) {
      const int j = f / kStride;
      const int t = f - j * kStride;
      smem[f] = t < d ? __ldg(c + (long long)(j0 + j) * d + t) : 0.0f;
    }
    __syncthreads();
    if (active) {
      for (int j = 0; j < cnt; ++j) {
        take(sq_dist<W>(xr, smem + j * kStride), j0 + j, &best, &arg);
      }
    }
    __syncthreads();
  }
  if (active) store_row(r0 + tid, best, arg, prev, out_min, out_arg);
}

// rows wider than kMaxD: x and c through the read-only cache
__global__ void __launch_bounds__(kThreads)
    nearest_wide_kernel(const float* __restrict__ x,
                        const float* __restrict__ c, const float* prev,
                        float* out_min, long long* __restrict__ out_arg, int n,
                        int m, int d) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float* xi = x + i * d;
  float best = CUDART_INF_F;
  int arg = 0;
  for (int j = 0; j < m; ++j) {
    const float* cj = c + (long long)j * d;
    // torch's order for 64 < d < 128 (and rounding-close past it): lane l
    // of 32 sums t = l + 32 i into four accumulators, i mod 4, which it
    // then adds in order; then the tree over the 32 lanes
    float s[32];
#pragma unroll
    for (int l = 0; l < 32; ++l) {
      float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      int t = l;
      for (; t + 96 < d; t += 128) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = __fsub_rn(__ldg(xi + t + 32 * i), __ldg(cj + t + 32 * i));
          a[i] = __fadd_rn(a[i], __fmul_rn(e, e));
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        if (t + 32 * i < d) {
          const float e = __fsub_rn(__ldg(xi + t + 32 * i), __ldg(cj + t + 32 * i));
          a[i] = __fadd_rn(a[i], __fmul_rn(e, e));
        }
      }
      s[l] = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
#pragma unroll
      for (int l = 0; l < off; ++l) s[l] = __fadd_rn(s[l], s[l + off]);
    }
    take(s[0], j, &best, &arg);
  }
  store_row(i, best, arg, prev, out_min, out_arg);
}

using NearestKernel = void (*)(const float*, const float*, const float*,
                               float*, long long*, int, int, int);

// the body of lane width W = lane_width(d), d <= kMaxD
NearestKernel pick_nearest(int d) {
  switch (lane_width(d)) {
    case 1: return nearest_kernel<1>;
    case 2: return nearest_kernel<2>;
    case 4: return nearest_kernel<4>;
    case 8: return nearest_kernel<8>;
    case 16: return nearest_kernel<16>;
    default: return nearest_kernel<32>;
  }
}

}  // namespace

// x (n, d), c (m, d), prev (n,) or null; out_min (n,), out_arg (n,) or null
extern "C" int kmeans_dist_launch(const float* x, const float* c,
                                  const float* prev, float* out_min,
                                  long long* out_arg, int n, int m, int d,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0) return (int)cudaGetLastError();
  const unsigned blocks = (unsigned)(((long long)n + kThreads - 1) / kThreads);
  if (d > kMaxD) {
    nearest_wide_kernel<<<blocks, kThreads, 0, s>>>(x, c, prev, out_min,
                                                    out_arg, n, m, d);
    return (int)cudaGetLastError();
  }
  const int stride = (2 * lane_width(d) + 3) / 4 * 4;
  const int chunk = kCentreFloats / stride;
  const size_t smem =
      (size_t)max(kThreads * d, min(m, chunk) * stride) * sizeof(float);
  const NearestKernel kernel = pick_nearest(d);
  if (smem > 48 * 1024) {  // past 48 KB only by opt-in (d > 48)
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks, kThreads, smem, s>>>(x, c, prev, out_min, out_arg, n, m, d);
  return (int)cudaGetLastError();
}
