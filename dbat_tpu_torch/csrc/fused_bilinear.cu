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
// byte, far below the card's ~20 flop/byte f32 balance point.  The
// output is most of the bytes (87% for U = A'A).
//
// Design: persistent blocks, one per resident slot of the card, walk
// tiles of R consecutive rows.  Arrays are row-major and contiguous,
// so a tile of A (and of B) is one contiguous run: a 1-D TMA bulk copy
// (cp.async.bulk, completion on an mbarrier) brings it into shared
// memory while the block computes and stores the previous tile (two
// buffers).  A tile whose run is not 16-byte aligned or not a multiple
// of 16 bytes long (the ragged last tile, an operand view at an odd
// offset) is loaded by the threads instead.  When A and B are the same
// array (U, V, Y Y') it is loaded once.  A row's outputs are q = d_out
// / V vectors of V values (V = 4, 2 or 1, the widest vector dividing
// d_out), shared by tq = min(q, 256) threads.  Thread t owns vector
// t % tq of row t / tq of every pass; with q <= 256 (every call on the
// bundle's path) that is its only vector, its (ia, ib) terms sit in
// registers for the whole kernel and no division runs per output;
// wider rows read the terms from shared memory and each thread loops
// over vectors t % tq, + tq, ...  Each pass stores whole 16-, 8- or
// 4-byte vectors, coalesced.  The g
// products of an output are summed in term order with explicitly
// rounded multiply and add (no fused multiply-add), the same
// arithmetic as the plain PyTorch version.  The launcher allocates
// nothing and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMinTileRows = 32;
constexpr int kHeader = 128;  // bytes: the two mbarriers, then the table
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use on sm_90

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// V values of T stored as one aligned vector.
template <typename T, int V>
struct Vec;
template <>
struct Vec<float, 1> {
  using type = float;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};
template <>
struct Vec<float, 4> {
  using type = float4;
};
template <>
struct Vec<double, 1> {
  using type = double;
};
template <>
struct Vec<double, 2> {
  using type = double2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of `bar`'s phase of parity `parity`.  A bulk
// copy that never lands traps after a few seconds instead of hanging.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  for (int64_t i = 0; !mbar_try_wait(a, parity); ++i)
    if (i > (int64_t{1} << 24)) __trap();
}

// One thread: expect `bytes` on `bar`, then bulk-copy the runs.
__device__ __forceinline__ void bulk_load(uint64_t* bar, void* dst_a, const void* src_a,
                                          uint32_t bytes_a, void* dst_b, const void* src_b,
                                          uint32_t bytes_b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes_a + bytes_b)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_addr(dst_a)),
      "l"(src_a), "r"(bytes_a), "r"(smem_addr(bar))
      : "memory");
  if (bytes_b)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst_b)),
        "l"(src_b), "r"(bytes_b), "r"(smem_addr(bar))
        : "memory");
}

struct Geometry {
  int64_t n;
  int d_a, d_b, d_out, g;
  int tile_rows;   // R
  int64_t n_tiles;
  int tq;          // threads per output row, min(d_out / V, kMaxThreads)
  int pass_rows;   // rows per pass, blockDim.x / tq
  bool same;       // A and B are one array: load it once
};

// G: the number of terms when it is 2 or 3 and a row has at most
// kMaxThreads vectors (terms in registers), else 0 (any g and d_out,
// terms read from the table in shared memory).
template <typename T, int V, int G>
__global__ void __launch_bounds__(kMaxThreads)
    fused_bilinear_kernel(const T* __restrict__ A, const T* __restrict__ B,
                          const int* __restrict__ tab, T* __restrict__ out, Geometry geo) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  int* sTab = reinterpret_cast<int*>(smem_raw + 16);
  const int d_a = geo.d_a, d_b = geo.d_b, d_out = geo.d_out;
  const int R = geo.tile_rows;
  const int b_cols = geo.same ? 0 : d_b;
  const int tab_bytes = G == 0 ? (2 * d_out * geo.g * 4 + 127) / 128 * 128 : 0;
  T* bufs = reinterpret_cast<T*>(smem_raw + kHeader + tab_bytes);
  const int buf_len = R * (d_a + b_cols);  // values; a multiple of 16 bytes

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row_in_pass = tid / geo.tq;
  const int o0 = (tid - row_in_pass * geo.tq) * V;

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  constexpr int kG = G > 0 ? G : 1;
  int ia[V][kG], ib[V][kG];
  if constexpr (G > 0) {
#pragma unroll
    for (int v = 0; v < V; ++v)
#pragma unroll
      for (int j = 0; j < G; ++j) {
        ia[v][j] = tab[((o0 + v) * G + j) * 2];
        ib[v][j] = tab[((o0 + v) * G + j) * 2 + 1];
      }
  } else {
    for (int i = tid; i < 2 * d_out * geo.g; i += nt) sTab[i] = tab[i];
  }
  __syncthreads();

  // Tile t: rows [t R, t R + rows); bulk-copied when both runs allow it.
  auto tile_rows = [&](int64_t t) -> int {
    const int64_t left = geo.n - t * R;
    return left < R ? static_cast<int>(left) : R;
  };
  auto bulk_ok = [&](int64_t t) -> bool {
    const int rows = tile_rows(t);
    const uintptr_t a = reinterpret_cast<uintptr_t>(A + t * R * d_a);
    const uintptr_t b = reinterpret_cast<uintptr_t>(B + t * R * d_b);
    return a % 16 == 0 && (static_cast<size_t>(rows) * d_a * sizeof(T)) % 16 == 0 &&
           (geo.same ||
            (b % 16 == 0 && (static_cast<size_t>(rows) * d_b * sizeof(T)) % 16 == 0));
  };
  auto issue = [&](int64_t t, int buf) {
    const int rows = tile_rows(t);
    T* dst = bufs + buf * buf_len;
    bulk_load(&bars[buf], dst, A + t * R * d_a,
              static_cast<uint32_t>(rows * d_a * sizeof(T)), dst + R * d_a,
              B + t * R * d_b, geo.same ? 0u : static_cast<uint32_t>(rows * d_b * sizeof(T)));
  };

  uint32_t phases = 0;  // parity of the next completion of each buffer's mbarrier
  int64_t t = blockIdx.x;
  if (tid == 0 && t < geo.n_tiles && bulk_ok(t)) issue(t, 0);
  for (int k = 0; t < geo.n_tiles; t += gridDim.x, ++k) {
    const int buf = k & 1;
    const int64_t t_next = t + gridDim.x;
    if (tid == 0 && t_next < geo.n_tiles && bulk_ok(t_next)) issue(t_next, buf ^ 1);

    const int rows = tile_rows(t);
    T* sA = bufs + buf * buf_len;
    const T* sB = geo.same ? sA : sA + R * d_a;
    if (bulk_ok(t)) {
      mbar_wait(&bars[buf], (phases >> buf) & 1u);
      phases ^= 1u << buf;
    } else {
      const T* gA = A + t * R * d_a;
      for (int i = tid; i < rows * d_a; i += nt) sA[i] = gA[i];
      if (!geo.same) {
        const T* gB = B + t * R * d_b;
        T* sBw = sA + R * d_a;
        for (int i = tid; i < rows * d_b; i += nt) sBw[i] = gB[i];
      }
      __syncthreads();
    }

    using VT = typename Vec<T, V>::type;
    T* gOut = out + t * R * d_out;
    for (int r = row_in_pass; r < rows; r += geo.pass_rows) {
      const T* a = sA + r * d_a;
      const T* b = sB + r * d_b;
      T* gRow = gOut + static_cast<int64_t>(r) * d_out;
      if constexpr (G > 0) {
        VT res;
        T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
        for (int v = 0; v < V; ++v) {
          T acc = mul_rn(a[ia[v][0]], b[ib[v][0]]);
#pragma unroll
          for (int j = 1; j < G; ++j) acc = add_rn(acc, mul_rn(a[ia[v][j]], b[ib[v][j]]));
          rv[v] = acc;
        }
        *reinterpret_cast<VT*>(gRow + o0) = res;
      } else {
        for (int o = o0; o < d_out; o += geo.tq * V) {
          VT res;
          T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const int* tv = sTab + 2 * (o + v) * geo.g;
            T acc = mul_rn(a[tv[0]], b[tv[1]]);
            for (int j = 1; j < geo.g; ++j)
              acc = add_rn(acc, mul_rn(a[tv[2 * j]], b[tv[2 * j + 1]]));
            rv[v] = acc;
          }
          *reinterpret_cast<VT*>(gRow + o) = res;
        }
      }
    }
    // Order this tile's shared-memory reads (and writes) before the bulk
    // copy that refills the buffer two tiles on.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
  }
}

int gcd(int a, int b) { return b ? gcd(b, a % b) : a; }
int lcm(int a, int b) { return a / gcd(a, b) * b; }

// Resident blocks of `fn` on the current device at this block size and
// shared memory (cached: the occupancy query costs host time).
int resident_blocks(const void* fn, int threads, size_t smem) {
  struct Entry {
    const void* fn;
    int threads;
    size_t smem;
    int dev;
    int blocks;
  };
  static std::mutex mu;
  static Entry cache[64];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn == fn && e.threads == threads && e.smem == smem && e.dev == dev) return e.blocks;
  }
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads, smem);
  const int blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (used < 64) cache[used++] = Entry{fn, threads, smem, dev, blocks};
  return blocks;
}

template <typename T, int V, int G>
int run(const T* A, const T* B, const int* tab, T* out, Geometry geo, cudaStream_t stream) {
  const void* fn = reinterpret_cast<const void*>(fused_bilinear_kernel<T, V, G>);
  const int threads = geo.tq * geo.pass_rows;
  const size_t tab_bytes = G == 0 ? (2 * static_cast<size_t>(geo.d_out) * geo.g * 4 + 127) / 128 * 128 : 0;
  const size_t smem = kHeader + tab_bytes +
                      2 * static_cast<size_t>(geo.tile_rows) *
                          (geo.d_a + (geo.same ? 0 : geo.d_b)) * sizeof(T);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int64_t grid = resident_blocks(fn, threads, smem);
  if (grid > geo.n_tiles) grid = geo.n_tiles;
  fused_bilinear_kernel<T, V, G><<<static_cast<unsigned>(grid), threads, smem, stream>>>(
      A, B, tab, out, geo);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int run_g(const T* A, const T* B, const int* tab, T* out, Geometry geo, cudaStream_t s) {
  const bool regs = geo.d_out / V <= kMaxThreads;  // one vector per thread
  if (regs && geo.g == 2) return run<T, V, 2>(A, B, tab, out, geo, s);
  if (regs && geo.g == 3) return run<T, V, 3>(A, B, tab, out, geo, s);
  return run<T, V, 0>(A, B, tab, out, geo, s);
}

template <typename T>
int launch(const void* A_, const void* B_, const void* tab_, void* out_, int64_t n, int64_t d_a,
           int64_t d_b, int64_t d_out, int64_t g, void* stream) {
  const T* A = static_cast<const T*>(A_);
  const T* B = static_cast<const T*>(B_);
  const int* tab = static_cast<const int*>(tab_);
  T* out = static_cast<T*>(out_);
  auto s = static_cast<cudaStream_t>(stream);
  // Widest output vector (16 bytes at most) dividing d_out and out's alignment.
  int vec = static_cast<int>(16 / sizeof(T));
  while (vec > 1 && (d_out % vec || reinterpret_cast<uintptr_t>(out) % (vec * sizeof(T)))) vec /= 2;
  Geometry geo;
  geo.n = n;
  geo.d_a = static_cast<int>(d_a);
  geo.d_b = static_cast<int>(d_b);
  geo.d_out = static_cast<int>(d_out);
  geo.g = static_cast<int>(g);
  if (d_out < 1 || g < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int q = geo.d_out / vec;
  geo.tq = q < kMaxThreads ? q : kMaxThreads;
  geo.pass_rows = kMaxThreads / geo.tq;
  geo.same = A == B && d_a == d_b;
  // R: a multiple of the pass rows whose A and B runs are whole 16-byte
  // units, at least kMinTileRows.
  const int unit_a = 16 / gcd(16, static_cast<int>(d_a * sizeof(T)));
  const int unit_b = 16 / gcd(16, static_cast<int>(d_b * sizeof(T)));
  const int unit = lcm(geo.pass_rows, lcm(unit_a, geo.same ? 1 : unit_b));
  geo.tile_rows = unit * ((kMinTileRows + unit - 1) / unit);
  geo.n_tiles = (n + geo.tile_rows - 1) / geo.tile_rows;
  if constexpr (sizeof(T) == 4)
    if (vec == 4) return run_g<T, 4>(A, B, tab, out, geo, s);
  if (vec == 2) return run_g<T, 2>(A, B, tab, out, geo, s);
  return run_g<T, 1>(A, B, tab, out, geo, s);
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
