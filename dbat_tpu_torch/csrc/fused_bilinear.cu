// Kernel A: the flat-lane block product
//
//     out[n, o] = sum_{j < g}  A[n, ia(o, j)] * B[n, ib(o, j)]
//
// Replaces the Pallas TPU kernel `fused_bilinear`
// (dbat_tpu/solve/pallas_kernels.py:84, body `_bilinear_kernel` :70).
// The TPU kernel computes the two index gathers as one-hot "select"
// matmuls on the matrix unit; here the (ia, ib) term table is indexed
// directly.  Callers: every FlatBilinear of the Schur assembly and S
// build (U = A'A, V = B'B, W = A'B, Y = W L, the self-pair diagonal
// Y Y'), with d_a, d_b <= 42, d_out <= 196 and g <= 3 on the bundle's
// path.
//
// What bounds it on the H100: bytes.  Each row reads d_a + d_b values
// and writes d_out, against 2 * d_out * g flops: about one flop per
// byte, far below the card's ~20 flop/byte f32 balance point.
//
// Design: a block takes kRows consecutive rows.  Because the arrays
// are row-major and contiguous, the block's slices of A, B and out are
// contiguous runs, so the loads into shared memory and the stores of
// the results are fully coalesced.  The term table sits in shared
// memory too.  Each thread then computes outputs (row, o) from shared
// memory, summing the g products in registers in term order with
// explicitly rounded multiply and add (no fused multiply-add), the
// same arithmetic as the plain PyTorch version.  Only (n, d_out) is
// written.  The launcher allocates nothing and returns
// cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kRows = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__global__ void fused_bilinear_kernel(const T* __restrict__ A,
                                      const T* __restrict__ B,
                                      const int* __restrict__ tab,
                                      T* __restrict__ out, int64_t n, int d_a,
                                      int d_b, int d_out, int g) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sA = reinterpret_cast<T*>(smem_raw);
  T* sB = sA + kRows * d_a;
  int* sTab = reinterpret_cast<int*>(sB + kRows * d_b);

  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int64_t left = n - r0;
  const int rows = left < kRows ? static_cast<int>(left) : kRows;

  for (int i = threadIdx.x; i < 2 * d_out * g; i += blockDim.x) sTab[i] = tab[i];
  const T* gA = A + r0 * d_a;
  for (int i = threadIdx.x; i < rows * d_a; i += blockDim.x) sA[i] = gA[i];
  const T* gB = B + r0 * d_b;
  for (int i = threadIdx.x; i < rows * d_b; i += blockDim.x) sB[i] = gB[i];
  __syncthreads();

  T* gOut = out + r0 * d_out;
  for (int i = threadIdx.x; i < rows * d_out; i += blockDim.x) {
    const int r = i / d_out;
    const int o = i - r * d_out;
    const int* t = sTab + 2 * o * g;
    const T* a = sA + r * d_a;
    const T* b = sB + r * d_b;
    T acc = mul_rn(a[t[0]], b[t[1]]);
    for (int j = 1; j < g; ++j) acc = add_rn(acc, mul_rn(a[t[2 * j]], b[t[2 * j + 1]]));
    gOut[i] = acc;
  }
}

template <typename T>
int launch(const void* A, const void* B, const void* tab, void* out, int64_t n,
           int64_t d_a, int64_t d_b, int64_t d_out, int64_t g, void* stream) {
  const size_t smem = static_cast<size_t>(kRows) * (d_a + d_b) * sizeof(T) +
                      2 * static_cast<size_t>(d_out) * g * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fused_bilinear_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kRows - 1) / kRows;
  fused_bilinear_kernel<T><<<static_cast<unsigned>(blocks), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<const T*>(B),
      static_cast<const int*>(tab), static_cast<T*>(out), n,
      static_cast<int>(d_a), static_cast<int>(d_b), static_cast<int>(d_out),
      static_cast<int>(g));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dbat_fused_bilinear_f32(const void* A, const void* B,
                                       const void* tab, void* out, int64_t n,
                                       int64_t d_a, int64_t d_b, int64_t d_out,
                                       int64_t g, void* stream) {
  return launch<float>(A, B, tab, out, n, d_a, d_b, d_out, g, stream);
}

extern "C" int dbat_fused_bilinear_f64(const void* A, const void* B,
                                       const void* tab, void* out, int64_t n,
                                       int64_t d_a, int64_t d_b, int64_t d_out,
                                       int64_t g, void* stream) {
  return launch<double>(A, B, tab, out, n, d_a, d_b, d_out, g, stream);
}
