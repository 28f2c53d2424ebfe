// The two panel passes of the fused mu-EigenGame step, fp32, sm_90a.
//
// A mu-EG step is V' = (V M1 + AV M2) * colscale with k x k coefficients
// from the (2k, 2k) gram of [V | AV]; the k x k algebra in between stays
// plain PyTorch.  Both kernels use fp32 FMA on the CUDA cores and never the
// tensor cores, so no TF32 rounding enters the step.
//
// K3  gram2k  replaces repro/kernels/eg_update/kernel.py:40 `gram2k` (body
//     :29, pallas_call at :45), whose 1-D grid carries the sum in its output
//     block from one 512-row block to the next.
//     Bound: bytes.  V and AV are read once (84 MB at n = 2^20, k = 10,
//     0.025 ms at 3.35 TB/s); the 210 upper-triangle entries of S cost
//     ~2 FLOP per byte, and the partials are small.  What the card needs to
//     reach that rate is bytes in flight, ~25 KB per SM at ~1 us of latency.
//     Design.  A grid of four blocks per SM, all resident at once (the
//     wrapper's `gram2k_parts`), gives each block a contiguous row range
//     in whole tiles of kGramTileFloats / k rows.  A tile of V and one of
//     AV are each one contiguous byte range, copied into shared memory
//     with 16-byte cp.async where source and shared slot are both 16-byte
//     aligned (the slot is shifted by the source's offset within 16 bytes,
//     so any 4-byte-aligned panel takes the wide path) and 4-byte cp.async
//     at the ragged ends: no division, no V/AV branch per element.
//     kGramStages = 4 buffers keep three tiles in flight (31 KB per block
//     at k = 10, 42 KB of shared memory each) while the fourth is summed;
//     one barrier per tile.  The upper triangle of S, padded to 4-column
//     groups, is cut into 4x4 tiles; each thread owns one such tile and a
//     row group (every G-th row of a staged tile), so it reads 8 values per
//     row from shared memory for 16 FMAs into 16 independent accumulators
//     (k = 10: 15 tiles x 17 row groups = 255 threads).  With the bytes
//     in flight, the row loop's instruction issue is what is left, and
//     with k known only at run time each shared load costs two address
//     instructions.  So k <= kFixedK (the main path's k = 10) gets a
//     compile-time body: one shared pointer per column, rows four at a
//     time, every offset an immediate (~27 instructions per row).  A
//     stage's V and AV regions are whole multiples of 32 floats apart, so
//     at k = 10 a warp's loads hit distinct banks.  Past 256 tiles (k > 44)
//     the tiles are split over gridDim.y.  The row groups are then summed
//     in shared memory in a fixed order.
//     Cross-block sum: a second launch from the same C entry (one call).
//     Its partials are entry-major (partial[entry][block]), so one warp
//     per entry reads neighbouring addresses, sums them in block order per
//     lane, and a fixed butterfly of shuffles finishes; the result is
//     deterministic and run-to-run bitwise equal, and needs no counter
//     that a graph replay would have to reset (the other option, a last
//     block that sums, does).  It mirrors each entry into both halves.
//
// K4  panel_mix  replaces repro/kernels/eg_update/kernel.py:64 `panel_mix`
//     (body :58, pallas_call at :71): out = (V M1 + AV M2) * colscale, the
//     two products summed, then scaled once, as there.
//     Bound: bytes.  V and AV are read and V' written once (126 MB at
//     n = 2^20, k = 10, 0.0376 ms); 4k FLOP per row is ~1 FLOP per byte.
//     Design.  A register pass: one thread per row, in a grid-stride loop
//     over a grid that fills the card once (occupancy query).  A block
//     stages M1, M2 and colscale in shared memory once, rows padded to 16
//     bytes, behind the only barrier; every thread then reads them as
//     float4 broadcasts.  The thread loads its rows of V and AV straight
//     into registers with 16-, 8- or 4-byte loads (the widest that k and
//     the three panels' alignment allow: float2 at k = 10, so 80 bytes in
//     flight per thread), keeps the two sums in two sets of k registers,
//     and streams its output row out with the same width (`__stcs`, the
//     next pass reads it from HBM anyway).  k <= kFixedK is a
//     compile-time body (all loops unrolled, rows in registers); wider
//     panels take 16-column groups over gridDim.y, reading V and AV a
//     float at a time and the coefficients through the read-only cache,
//     so K4 has no width limit.  The TPU version padded k to 128 lanes;
//     here k is used as it is.
#include <cuda_runtime.h>

#include <utility>

namespace {

constexpr int kThreads = 256;
constexpr int kGramTileFloats = 1280;  // floats of V (and of AV) per tile
constexpr int kGramStages = 4;
constexpr int kFixedK = 16;    // widest k with a compile-time body (K3, K4)
constexpr int kMixCols = 16;   // K4's output columns per thread past it

// (a, c), a <= c, of upper-triangle entry o of a k2 x k2 matrix
__device__ void upper_entry(int o, int k2, int* a, int* c) {
  int row = 0;
  while (o >= k2 - row) {
    o -= k2 - row;
    ++row;
  }
  *a = row;
  *c = row + o;
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// how many floats src lies past a 16-byte boundary (0..3)
__device__ __forceinline__ int lead_of(const float* src) {
  return (int)(((unsigned long long)src & 15) >> 2);
}

// Copy count floats from src to dst + lead_of(src), dst 16-byte aligned, so
// that the 16-byte chunks of src land on 16-byte chunks of dst: full
// chunks go as one 16-byte copy, the partial first and last chunk float by
// float.  Asynchronous; the caller commits and waits.
__device__ __forceinline__ void stage_range(float* dst, const float* src,
                                            int count) {
  const int lead = lead_of(src);
  const float* base = src - lead;
  const int total = lead + count;
  const int chunks = (total + 3) >> 2;
  for (int c = threadIdx.x; c < chunks; c += blockDim.x) {
    const int lo = c << 2;
    if (lo >= lead && lo + 4 <= total) {
      cp_async16(dst + lo, base + lo);
    } else {
      for (int i = max(lo, lead); i < min(lo + 4, total); ++i) {
        cp_async4(dst + i, base + i);
      }
    }
  }
}

// floats of a stage region: a tile and up to 3 floats of lead, in whole
// 32-bank rows, so AV's columns sit in the banks V's would continue into
// (V and AV with the same lead: no bank conflict at k = 10)
__host__ __device__ constexpr int gram_region(int tile_rows, int k) {
  return (tile_rows * k + 3 + 31) & ~31;
}

// the 4x4 outer product of one row: columns q[0..3] times q[4..7]
__device__ __forceinline__ void gram_row(const float* (&q)[8], int off,
                                         float (&acc)[16]) {
  float a[4], c[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a[i] = q[i][off];
    c[i] = q[4 + i][off];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[4 * i + j] = fmaf(a[i], c[j], acc[4 * i + j]);
    }
  }
}

// Launch one: block (x, y) sums the 4x4 tiles [y * pairs_per_y, ...) of
// the upper triangle of S over rows [x * rows_per_part, ...) and writes
// each entry's partial to partial[entry * num_parts + x].  KT > 0 fixes
// k = KT at compile time (k <= kFixedK: one gridDim.y, and the tile
// shape, row-group stride and shared offsets fold into immediates); KT = 0
// takes k, tile_rows and region as given.
template <int KT>
__global__ void __launch_bounds__(kThreads)
    gram2k_partial_kernel(const float* __restrict__ v,
                          const float* __restrict__ av,
                          float* __restrict__ partial, int n, int k_arg,
                          int rows_per_part, int tile_rows_arg, int region_arg,
                          int pairs_per_y, int num_parts) {
  extern __shared__ __align__(16) float smem[];  // kGramStages x (V, AV)
  const int k = KT > 0 ? KT : k_arg;
  const int tile_rows = KT > 0 ? kGramTileFloats / KT : tile_rows_arg;
  const int region = KT > 0 ? gram_region(tile_rows, KT) : region_arg;
  const int k2 = 2 * k;
  const int groups4 = (k2 + 3) >> 2;  // 4-column groups of [V | AV]
  const int pairs = groups4 * (groups4 + 1) / 2;
  const int p0 = KT > 0 ? 0 : blockIdx.y * pairs_per_y;
  const int py = KT > 0 ? pairs : min(pairs_per_y, pairs - p0);
  const int num_groups = kThreads / py;  // row groups
  const int pl = threadIdx.x % py;
  const int g = threadIdx.x / py;
  const bool active = g < num_groups;

  // this thread's 8 columns: 4 of tile row ti, 4 of tile column tj; a
  // padding column past 2k reads column 2k - 1 and its sums are dropped
  int ti = 0, tj = 0;
  upper_entry(p0 + pl, groups4, &ti, &tj);
  int col[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    col[i] = min(4 * ti + i, k2 - 1);
    col[4 + i] = min(4 * tj + i, k2 - 1);
  }

  const long long r0 = (long long)blockIdx.x * rows_per_part;
  const long long r1 = min((long long)n, r0 + rows_per_part);
  const int num_tiles =
      r1 > r0 ? (int)((r1 - r0 + tile_rows - 1) / tile_rows) : 0;

  auto issue = [&](int t) {
    if (t < num_tiles) {
      const long long rs = r0 + (long long)t * tile_rows;
      const int rows = (int)min((long long)tile_rows, r1 - rs);
      float* st = smem + (t % kGramStages) * 2 * region;
      stage_range(st, v + rs * k, rows * k);
      stage_range(st + region, av + rs * k, rows * k);
    }
    cp_async_commit();  // an empty group past the last tile keeps counts
  };

  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

#pragma unroll
  for (int t = 0; t < kGramStages - 1; ++t) issue(t);
  for (int t = 0; t < num_tiles; ++t) {
    cp_async_wait<kGramStages - 2>();  // this thread's copies of tile t
    __syncthreads();  // everyone's copies of tile t; tile t - 1 is summed
    issue(t + kGramStages - 1);  // into the stage of tile t - 1
    if (active) {
      const long long rs = r0 + (long long)t * tile_rows;
      const int rows = (int)min((long long)tile_rows, r1 - rs);
      const float* st = smem + (t % kGramStages) * 2 * region;
      const int lead_v = lead_of(v + rs * k);
      const int lead_av = region + lead_of(av + rs * k);
      // one shared pointer per column, at this thread's first row; rows
      // go four at a time, so their offsets are immediates when KT > 0
      const float* q[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        q[i] = st + g * k +
               (col[i] < k ? lead_v + col[i] : lead_av + col[i] - k);
      }
      const int step = num_groups * k;
      int r = g;
      for (; r + 3 * num_groups < rows; r += 4 * num_groups) {
#pragma unroll
        for (int u = 0; u < 4; ++u) gram_row(q, u * step, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] += 4 * step;
      }
      for (; r < rows; r += num_groups) {
        gram_row(q, 0, acc);
#pragma unroll
        for (int i = 0; i < 8; ++i) q[i] += step;
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the stages are free: reuse them for the group sums

  float* red = smem;  // [group][tile pl][16]
  if (active) {
#pragma unroll
    for (int e = 0; e < 16; ++e) red[(g * py + pl) * 16 + e] = acc[e];
  }
  __syncthreads();
  for (int item = threadIdx.x; item < py * 16; item += blockDim.x) {
    float s = 0.f;
    for (int q = 0; q < num_groups; ++q) s += red[q * py * 16 + item];
    int a, c;
    upper_entry(p0 + (item >> 4), groups4, &a, &c);
    a = 4 * a + ((item >> 2) & 3);
    c = 4 * c + (item & 3);
    if (a <= c && c < k2) {
      const int entry = a * k2 - a * (a - 1) / 2 + (c - a);
      partial[(long long)entry * num_parts + blockIdx.x] = s;
    }
  }
}

// Launch two: one warp per upper-triangle entry sums its num_parts
// partials (contiguous), each lane in block order, then a fixed butterfly;
// the entry is mirrored into both halves of S
__global__ void __launch_bounds__(kThreads)
    gram2k_reduce_kernel(const float* __restrict__ partial,
                         float* __restrict__ out, int num_parts, int k2) {
  const int entries = k2 * (k2 + 1) / 2;
  const int o = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (o >= entries) return;
  const int lane = threadIdx.x & 31;
  const float* p = partial + (long long)o * num_parts;
  float s = 0.f;
  for (int q = lane; q < num_parts; q += 32) s += p[q];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  if (lane == 0) {
    int a, c;
    upper_entry(o, k2, &a, &c);
    out[a * k2 + c] = s;
    out[c * k2 + a] = s;
  }
}

using PartialKernel = void (*)(const float*, const float*, float*, int, int,
                               int, int, int, int, int);

// the compile-time-k body for k <= kFixedK, else the runtime one
template <int... Ks>
PartialKernel pick_partial(int k, std::integer_sequence<int, Ks...>) {
  PartialKernel f = gram2k_partial_kernel<0>;
  ((f = (Ks > 0 && k == Ks) ? gram2k_partial_kernel<Ks> : f), ...);
  return f;
}

template <int K, int VW>
__device__ __forceinline__ void load_row(const float* p, float (&x)[K]) {
#pragma unroll
  for (int c = 0; c < K / VW; ++c) {
    if constexpr (VW == 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p) + c);
      x[4 * c] = t.x;
      x[4 * c + 1] = t.y;
      x[4 * c + 2] = t.z;
      x[4 * c + 3] = t.w;
    } else if constexpr (VW == 2) {
      const float2 t = __ldg(reinterpret_cast<const float2*>(p) + c);
      x[2 * c] = t.x;
      x[2 * c + 1] = t.y;
    } else {
      x[c] = __ldg(p + c);
    }
  }
}

template <int K, int VW>
__device__ __forceinline__ void store_row(float* p, const float (&o)[K]) {
#pragma unroll
  for (int c = 0; c < K / VW; ++c) {
    if constexpr (VW == 4) {
      __stcs(reinterpret_cast<float4*>(p) + c,
             make_float4(o[4 * c], o[4 * c + 1], o[4 * c + 2], o[4 * c + 3]));
    } else if constexpr (VW == 2) {
      __stcs(reinterpret_cast<float2*>(p) + c,
             make_float2(o[2 * c], o[2 * c + 1]));
    } else {
      __stcs(p + c, o[c]);
    }
  }
}

// s[j] += x * row[j] for j < K, row a 16-byte-aligned shared row of
// coefficients read as float4 broadcasts
template <int K>
__device__ __forceinline__ void axpy_row(float x, const float* row,
                                         float (&s)[K]) {
#pragma unroll
  for (int c = 0; c < (K + 3) / 4; ++c) {
    const float4 m = reinterpret_cast<const float4*>(row)[c];
    const float mv[4] = {m.x, m.y, m.z, m.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      if (4 * c + t < K) s[4 * c + t] = fmaf(x, mv[t], s[4 * c + t]);
    }
  }
}

// k = K <= kFixedK: one thread per row, VW-wide loads and stores
template <int K, int VW>
__global__ void __launch_bounds__(kThreads)
    panel_mix_rows_kernel(const float* __restrict__ v,
                          const float* __restrict__ av,
                          const float* __restrict__ m1,
                          const float* __restrict__ m2,
                          const float* __restrict__ colscale,
                          float* __restrict__ out, int n) {
  constexpr int KP = (K + 3) & ~3;  // coefficient row stride, 16 bytes
  __shared__ __align__(16) float sm1[K * KP];
  __shared__ __align__(16) float sm2[K * KP];
  __shared__ __align__(16) float scs[KP];
  for (int i = threadIdx.x; i < K * KP; i += kThreads) {
    const int l = i / KP;
    const int j = i - l * KP;
    sm1[i] = j < K ? m1[l * K + j] : 0.f;
    sm2[i] = j < K ? m2[l * K + j] : 0.f;
  }
  if (threadIdx.x < KP) {
    scs[threadIdx.x] = threadIdx.x < K ? colscale[threadIdx.x] : 0.f;
  }
  __syncthreads();
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    float x[K], y[K];
    load_row<K, VW>(v + i * K, x);
    load_row<K, VW>(av + i * K, y);
    float s1[K], s2[K];
#pragma unroll
    for (int j = 0; j < K; ++j) s1[j] = s2[j] = 0.f;
#pragma unroll
    for (int l = 0; l < K; ++l) {
      axpy_row<K>(x[l], sm1 + l * KP, s1);
      axpy_row<K>(y[l], sm2 + l * KP, s2);
    }
    float o[K];
#pragma unroll
    for (int j = 0; j < K; ++j) o[j] = (s1[j] + s2[j]) * scs[j];
    store_row<K, VW>(out + i * K, o);
  }
}

// k > kFixedK: thread (row, column group blockIdx.y of kMixCols)
__global__ void __launch_bounds__(kThreads)
    panel_mix_wide_kernel(const float* __restrict__ v,
                          const float* __restrict__ av,
                          const float* __restrict__ m1,
                          const float* __restrict__ m2,
                          const float* __restrict__ colscale,
                          float* __restrict__ out, int n, int k) {
  const int c0 = blockIdx.y * kMixCols;
  const int cols = min(kMixCols, k - c0);
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += stride) {
    const float* vr = v + i * k;
    const float* ar = av + i * k;
    float s1[kMixCols], s2[kMixCols];
#pragma unroll
    for (int j = 0; j < kMixCols; ++j) s1[j] = s2[j] = 0.f;
    for (int l = 0; l < k; ++l) {
      const float xl = __ldg(vr + l);
      const float yl = __ldg(ar + l);
      const float* r1 = m1 + (long long)l * k + c0;
      const float* r2 = m2 + (long long)l * k + c0;
#pragma unroll
      for (int j = 0; j < kMixCols; ++j) {
        if (j < cols) {
          s1[j] = fmaf(xl, __ldg(r1 + j), s1[j]);
          s2[j] = fmaf(yl, __ldg(r2 + j), s2[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kMixCols; ++j) {
      if (j < cols) {
        __stcs(out + i * k + c0 + j,
               (s1[j] + s2[j]) * __ldg(colscale + c0 + j));
      }
    }
  }
}

using MixKernel = void (*)(const float*, const float*, const float*,
                           const float*, const float*, float*, int);

// the compile-time body for k = K and load width vw
template <int K>
MixKernel mix_body(int vw) {
  if constexpr (K % 4 == 0) {
    if (vw == 4) return panel_mix_rows_kernel<K, 4>;
  }
  if constexpr (K % 2 == 0) {
    if (vw == 2) return panel_mix_rows_kernel<K, 2>;
  }
  return panel_mix_rows_kernel<K, 1>;
}

// mix_body<k>(vw) for 1 <= k <= kFixedK
template <int... Is>
MixKernel pick_mix(int k, int vw, std::integer_sequence<int, Is...>) {
  MixKernel f = nullptr;
  ((f = k == Is + 1 ? mix_body<Is + 1>(vw) : f), ...);
  return f;
}

}  // namespace

extern "C" int gram2k_launch(const float* v, const float* av, float* partial,
                             float* out, int n, int k, int num_parts,
                             int rows_per_part, int tile_rows, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int k2 = 2 * k;
  const int entries = k2 * (k2 + 1) / 2;
  const int groups4 = (k2 + 3) / 4;
  const int pairs = groups4 * (groups4 + 1) / 2;
  const int grid_y = (pairs + kThreads - 1) / kThreads;
  const int pairs_per_y = (pairs + grid_y - 1) / grid_y;
  const int region = gram_region(tile_rows, k);
  // at most 42 KB for tile_rows * k <= kGramTileFloats: no opt-in needed
  const size_t smem = (size_t)max(kGramStages * 2 * region, kThreads * 16) *
                      sizeof(float);
  const PartialKernel kernel =
      pick_partial(k, std::make_integer_sequence<int, kFixedK + 1>{});
  kernel<<<dim3(num_parts, grid_y), kThreads, smem, s>>>(
      v, av, partial, n, k, rows_per_part, tile_rows, region, pairs_per_y,
      num_parts);
  const int warps = kThreads / 32;
  gram2k_reduce_kernel<<<(entries + warps - 1) / warps, kThreads, 0, s>>>(
      partial, out, num_parts, k2);
  return (int)cudaGetLastError();
}

extern "C" int panel_mix_launch(const float* v, const float* av,
                                const float* m1, const float* m2,
                                const float* colscale, float* out, int n, int k,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (n == 0 || k == 0) return (int)cudaGetLastError();
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return (int)err;
  const long long row_blocks = ((long long)n + kThreads - 1) / kThreads;
  int per_sm = 0;
  if (k <= kFixedK) {
    // the widest of 16, 8, 4 bytes that divides a row and all three panels
    const unsigned long long addr = (unsigned long long)v |
                                    (unsigned long long)av |
                                    (unsigned long long)out;
    const int vw = (k % 4 == 0 && addr % 16 == 0)  ? 4
                   : (k % 2 == 0 && addr % 8 == 0) ? 2
                                                   : 1;
    const MixKernel kernel =
        pick_mix(k, vw, std::make_integer_sequence<int, kFixedK>{});
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)min(row_blocks, (long long)max(1, per_sm) * sms);
    kernel<<<blocks, kThreads, 0, s>>>(v, av, m1, m2, colscale, out, n);
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, panel_mix_wide_kernel, kThreads, 0);
    if (err != cudaSuccess) return (int)err;
    const int groups = (k + kMixCols - 1) / kMixCols;
    const long long fill =
        ((long long)max(1, per_sm) * sms + groups - 1) / groups;
    const int blocks = (int)min(row_blocks, fill);
    panel_mix_wide_kernel<<<dim3(blocks, groups), kThreads, 0, s>>>(
        v, av, m1, m2, colscale, out, n, k);
  }
  return (int)cudaGetLastError();
}
