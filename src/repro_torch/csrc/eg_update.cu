// The two panel passes of the fused mu-EigenGame step, fp32, sm_90a.
//
// A mu-EG step is V' = (V M1 + AV M2) * colscale with k x k coefficients
// from the (2k, 2k) gram of [V | AV]; the k x k algebra in between stays
// plain PyTorch.  Both kernels use fp32 FMA on the CUDA cores and never the
// tensor cores, so no TF32 rounding enters the step.
//
// K3  gram2k  replaces repro/kernels/eg_update/kernel.py:40 `gram2k` (body
//     :29, pallas_call at :45), whose 1-D grid carries the sum in its output
//     block from one 512-row block to the next.  Hopper blocks run in no
//     order, so the reduction is two launches.  Launch one gives each thread
//     block a row slice (grid.y a range of entries, one row of blocks up to
//     k = 11): the block stages 32-row tiles of [V | AV] in shared memory and
//     each thread accumulates one entry (a, c), a <= c, of the symmetric
//     gram over its slice.  Launch two gives each entry one thread block,
//     which sums the per-slice partials in a fixed order (strided per
//     thread, then a shared-memory tree), so the result is deterministic,
//     and mirrors it into both halves.  Bound: bytes (V and AV read once;
//     the partials are small).
//
// K4  panel_mix  replaces repro/kernels/eg_update/kernel.py:64 `panel_mix`
//     (body :58, pallas_call at :71).  One thread block takes 64 rows: it
//     stages M1, M2, colscale and its rows of V and AV in shared memory,
//     then each thread forms out[i, j] = (sum_l V[i,l] M1[l,j] +
//     AV[i,l] M2[l,j]) * cs[j] for its elements.  Bound: bytes (V, AV read
//     and V' written once).  The TPU version padded k to 128 lanes; here k
//     is used as it is.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGramTileRows = 32;
constexpr int kMixRows = 64;
constexpr int kDefaultSmem = 48 * 1024;

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

__global__ void gram2k_partial_kernel(const float* __restrict__ v,
                                      const float* __restrict__ av,
                                      float* __restrict__ partial, int n, int k,
                                      int rows_per_part) {
  extern __shared__ float tile[];  // kGramTileRows x 2k
  const int k2 = 2 * k;
  const int entries = k2 * (k2 + 1) / 2;  // the upper triangle of S
  const int o = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = o < entries;
  int a = 0, c = 0;
  if (active) upper_entry(o, k2, &a, &c);
  const long long r0 = (long long)blockIdx.x * rows_per_part;
  const long long r1 = min((long long)n, r0 + rows_per_part);
  float acc = 0.f;
  for (long long base = r0; base < r1; base += kGramTileRows) {
    const int rows = (int)min((long long)kGramTileRows, r1 - base);
    for (int i = threadIdx.x; i < rows * k2; i += blockDim.x) {
      int r = i / k2;
      int col = i - r * k2;
      long long g = base + r;
      tile[i] = col < k ? v[g * k + col] : av[g * k + (col - k)];
    }
    __syncthreads();
    if (active) {
      for (int r = 0; r < rows; ++r) {
        acc = fmaf(tile[r * k2 + a], tile[r * k2 + c], acc);
      }
    }
    __syncthreads();
  }
  if (active) partial[(long long)blockIdx.x * entries + o] = acc;
}

// one block per upper-triangle entry: each thread sums a strided set of
// partials in slice order, then a shared-memory tree in a fixed order, so
// the sum is the same on every run; the entry is mirrored into both halves
__global__ void gram2k_reduce_kernel(const float* __restrict__ partial,
                                     float* __restrict__ out, int num_parts,
                                     int k2) {
  __shared__ float buf[kThreads];
  const int entries = k2 * (k2 + 1) / 2;
  const int o = blockIdx.x;
  float s = 0.f;
  for (int p = threadIdx.x; p < num_parts; p += blockDim.x) {
    s += partial[(long long)p * entries + o];
  }
  buf[threadIdx.x] = s;
  __syncthreads();
  for (int half = blockDim.x / 2; half > 0; half /= 2) {
    if (threadIdx.x < half) buf[threadIdx.x] += buf[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    int a, c;
    upper_entry(o, k2, &a, &c);
    out[a * k2 + c] = buf[0];
    out[c * k2 + a] = buf[0];
  }
}

__global__ void panel_mix_kernel(const float* __restrict__ v,
                                 const float* __restrict__ av,
                                 const float* __restrict__ m1,
                                 const float* __restrict__ m2,
                                 const float* __restrict__ colscale,
                                 float* __restrict__ out, int n, int k) {
  extern __shared__ float sm[];
  float* sm1 = sm;
  float* sm2 = sm1 + k * k;
  float* scs = sm2 + k * k;
  float* sv = scs + k;
  float* sav = sv + kMixRows * k;
  for (int i = threadIdx.x; i < k * k; i += blockDim.x) {
    sm1[i] = m1[i];
    sm2[i] = m2[i];
  }
  for (int i = threadIdx.x; i < k; i += blockDim.x) scs[i] = colscale[i];
  const long long base = (long long)blockIdx.x * kMixRows * k;
  const int rows = (int)min((long long)kMixRows, (long long)n - (long long)blockIdx.x * kMixRows);
  const int items = rows * k;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    sv[i] = v[base + i];
    sav[i] = av[base + i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    int r = i / k;
    int j = i - r * k;
    const float* vr = sv + r * k;
    const float* avr = sav + r * k;
    float acc = 0.f;
    for (int l = 0; l < k; ++l) {
      acc = fmaf(vr[l], sm1[l * k + j], acc);
      acc = fmaf(avr[l], sm2[l * k + j], acc);
    }
    out[base + i] = acc * scs[j];
  }
}

}  // namespace

extern "C" int gram2k_launch(const float* v, const float* av, float* partial,
                             float* out, int n, int k, int num_parts,
                             void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int k2 = 2 * k;
  const int entries = k2 * (k2 + 1) / 2;
  const int rows_per_part = (n + num_parts - 1) / num_parts;
  const size_t smem = (size_t)kGramTileRows * k2 * sizeof(float);
  dim3 grid(num_parts, (entries + kThreads - 1) / kThreads);
  gram2k_partial_kernel<<<grid, kThreads, smem, s>>>(v, av, partial, n, k,
                                                      rows_per_part);
  gram2k_reduce_kernel<<<entries, kThreads, 0, s>>>(partial, out, num_parts,
                                                     k2);
  return (int)cudaGetLastError();
}

extern "C" int panel_mix_launch(const float* v, const float* av,
                                const float* m1, const float* m2,
                                const float* colscale, float* out, int n, int k,
                                void* stream) {
  const size_t smem = (size_t)(2 * k * k + k + 2 * kMixRows * k) * sizeof(float);
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        panel_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (n + kMixRows - 1) / kMixRows;
  if (blocks > 0) {
    panel_mix_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        v, av, m1, m2, colscale, out, n, k);
  }
  return (int)cudaGetLastError();
}
