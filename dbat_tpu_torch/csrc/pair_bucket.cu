// Kernel B: the off-diagonal fill-in of the reduced camera system S,
// gathered and folded per camera pair:
//
//     out[c, o] = sum_{rows r of camera pair c} sum_{p in bucket r}
//                 sum_{j < g} Y[i1[p], ia(o, j)] * Y[i2[p], ib(o, j)]
//
// with the (ia, ib) table of abt_terms(nb, 3, nb), i.e. the per-pair
// block Y_i1 Y_i2' summed over every observation pair of the camera
// pair.  Pairs are sorted by camera pair and padded to buckets of `cap`
// pairs; a pad pair holds an index outside [0, n_y) and contributes
// zero.
//
// Replaces the Pallas TPU kernel `pair_bucket_acc`
// (dbat_tpu/solve/pallas_kernels.py:129, body `_pair_bucket_kernel`
// :113) together with the XLA work around it: the `Yz[i1]`, `Yz[i2]`
// gathers before it and the bucket-row -> camera-pair segment_sum
// after it (PairBucketPlan.__call__, :203-212).
//
// What bounds it on the H100: at the bundle's C5 shape (1.28 M pairs,
// d_out = 196, g = 3) it does ~1.5 GFLOP against ~51 MB of compulsory
// traffic (Y once, the two index arrays, the output), so the f32
// arithmetic rate bounds it, not the bytes (see PERF.md).  Gathered Y
// rows are re-read from L2 (Y is 33 MB < 50 MB of L2).
//
// Design: one block per camera pair.  A camera pair's bucket rows are
// contiguous (row_ptr), so the block loops over them and keeps the sum
// in registers: no row sums reach device memory, no atomics, and the
// result does not depend on scheduling.  For each bucket row the block
// loads its 2 * cap indices, gathers the Y rows itself into shared
// memory (consecutive threads read consecutive columns of a row), and
// thread o adds the cap * g products of output o.  The launcher
// allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void pair_bucket_kernel(const T* __restrict__ Y, int64_t n_y, int d_y,
                                   const int* __restrict__ i1,
                                   const int* __restrict__ i2,
                                   const int* __restrict__ row_ptr,
                                   const int* __restrict__ tab,
                                   T* __restrict__ out, int d_out, int g,
                                   int cap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // [Y rows of the i1 side | Y rows of the i2 side | table | indices]
  T* sY = reinterpret_cast<T*>(smem_raw);
  const int half = cap * d_y;
  int* sTab = reinterpret_cast<int*>(sY + 2 * half);
  int* sIdx = sTab + 2 * d_out * g;

  const int c = blockIdx.x;
  const int row_begin = row_ptr[c];
  const int row_end = row_ptr[c + 1];
  for (int i = threadIdx.x; i < 2 * d_out * g; i += blockDim.x) sTab[i] = tab[i];

  const int o = threadIdx.x;
  T acc = T(0);
  for (int row = row_begin; row < row_end; ++row) {
    __syncthreads();  // the previous row's shared data is consumed
    const int64_t p0 = static_cast<int64_t>(row) * cap;
    for (int k = threadIdx.x; k < 2 * cap; k += blockDim.x)
      sIdx[k] = k < cap ? i1[p0 + k] : i2[p0 + k - cap];
    __syncthreads();
    for (int k = threadIdx.x; k < 2 * half; k += blockDim.x) {
      const int side = k / half;
      const int rem = k - side * half;
      const int p = rem / d_y;
      const int col = rem - p * d_y;
      const int idx = sIdx[side * cap + p];
      sY[k] = (idx >= 0 && idx < n_y) ? Y[static_cast<int64_t>(idx) * d_y + col] : T(0);
    }
    __syncthreads();
    if (o < d_out) {
      const int* t = sTab + 2 * o * g;
      for (int p = 0; p < cap; ++p) {
        const T* y1 = sY + p * d_y;
        const T* y2 = sY + half + p * d_y;
        for (int j = 0; j < g; ++j) acc = add_rn(acc, mul_rn(y1[t[2 * j]], y2[t[2 * j + 1]]));
      }
    }
  }
  if (o < d_out) out[static_cast<int64_t>(c) * d_out + o] = acc;
}

template <typename T>
int launch(const void* Y, int64_t n_y, int64_t d_y, const void* i1, const void* i2,
           const void* row_ptr, int64_t n_campair, const void* tab, void* out,
           int64_t d_out, int64_t g, int64_t cap, void* stream) {
  const size_t smem = 2 * static_cast<size_t>(cap) * d_y * sizeof(T) +
                      (2 * static_cast<size_t>(d_out) * g + 2 * cap) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pair_bucket_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = static_cast<int>(((d_out + 31) / 32) * 32);
  pair_bucket_kernel<T><<<static_cast<unsigned>(n_campair), threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(Y), n_y, static_cast<int>(d_y),
      static_cast<const int*>(i1), static_cast<const int*>(i2),
      static_cast<const int*>(row_ptr), static_cast<const int*>(tab),
      static_cast<T*>(out), static_cast<int>(d_out), static_cast<int>(g),
      static_cast<int>(cap));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dbat_pair_bucket_acc_f32(const void* Y, int64_t n_y, int64_t d_y,
                                        const void* i1, const void* i2,
                                        const void* row_ptr, int64_t n_campair,
                                        const void* tab, void* out, int64_t d_out,
                                        int64_t g, int64_t cap, void* stream) {
  return launch<float>(Y, n_y, d_y, i1, i2, row_ptr, n_campair, tab, out, d_out,
                       g, cap, stream);
}

extern "C" int dbat_pair_bucket_acc_f64(const void* Y, int64_t n_y, int64_t d_y,
                                        const void* i1, const void* i2,
                                        const void* row_ptr, int64_t n_campair,
                                        const void* tab, void* out, int64_t d_out,
                                        int64_t g, int64_t cap, void* stream) {
  return launch<double>(Y, n_y, d_y, i1, i2, row_ptr, n_campair, tab, out, d_out,
                        g, cap, stream);
}
