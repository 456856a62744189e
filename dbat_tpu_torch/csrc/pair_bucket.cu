// Kernel B: the off-diagonal fill-in of the reduced camera system S,
// gathered and folded per camera pair:
//
//     out[c] = sum_{rows r of camera pair c} sum_{p in bucket r}
//              Y[i1[p]] Y[i2[p]]'            (nb x nb, flattened)
//
// with Y[i] an (nb, 3) block stored as a flat row of d_y = 3 nb values:
// the flat product abt_terms(nb, 3, nb), summed over every observation
// pair of the camera pair.  Pairs are sorted by camera pair and padded
// to buckets of `cap` pairs; a pad pair holds an index outside [0, n_y)
// and contributes zero.  A camera pair with no bucket rows gets zeros.
//
// Replaces the Pallas TPU kernel `pair_bucket_acc`
// (dbat_tpu/solve/pallas_kernels.py:129, body `_pair_bucket_kernel`
// :113) together with the XLA work around it: the `Yz[i1]`, `Yz[i2]`
// gathers before it and the bucket-row -> camera-pair segment_sum
// after it (PairBucketPlan.__call__, :203-212).
//
// What bounds it on the H100: at the bundle's C5 shape (1.28 M pairs,
// nb = 14) it does ~1.5 GFLOP of f32 arithmetic against ~51 MB of
// compulsory traffic, so the arithmetic bounds it (22 us at 67 TFLOP/s),
// not the bytes (15 us).  The pair order re-reads every Y row about 13
// times: ~429 MB of row gathers, which Y (33 MB) serves from L2.
//
// Design, for the one product that reaches it (k = 3, nb <= 32):
//  * Static balance.  The plan (solve/kernels.py PairBucketPlan) splits
//    the camera pairs into contiguous chunks of about equal bucket-row
//    counts, one chunk per warp of a persistent grid: as many warps as
//    the card holds at once, which the plan asks of the launcher
//    (dbat_pair_bucket_resident_warps_*, an occupancy query).  A camera pair lies in exactly one chunk, so one warp
//    sums each output in a fixed order: no atomics, and two runs give
//    the same bits.
//  * Gathers by the copy engine.  Each warp streams its chunk's bucket
//    rows through a ring of `stages` slots in shared memory, `stages` -
//    1 rows ahead.  Lane j fetches row j of a slot (its pair index was
//    loaded into a register one step earlier) with ONE 1-D TMA bulk
//    copy (cp.async.bulk) completing on the slot's mbarrier: the
//    16-byte aligned window around the row (an f32 row of 168 B starts
//    8- but not 16-byte aligned), placed so that the row keeps its
//    16-byte phase `sh`, which the lane records beside the slot.  A row
//    whose window would pass the end of Y is copied by the lane itself;
//    a pad pair is marked (sh = -1) and skipped.  The copy engine takes
//    one instruction per row where per-lane cp.async of 8-byte pieces
//    takes 21 copies and shuffles per lane and bucket row.  The warps,
//    not the ring depth, hide the copies' latency: four blocks of four
//    warps share an SM (kBlocksPerSm), with a ring of two slots each.
//  * Register blocking.  Slot rows have room for 3 * NBP values (NBP =
//    nb rounded up to 8, 16 or 32) so every lane owns a fixed TA x 4
//    tile of the padded output; per pair it reads its 3-vectors once
//    with LDW-byte shared loads (16, 8 or 4: what `sh` allows) and adds
//    TA * 4 * 3 FMAs.  With NBP <= 16 the warp works on 32 /
//    lanes-per-tile pairs at once and folds the groups with a fixed
//    shuffle tree at the end of a camera pair.  In f32 each bucket
//    row's sum joins the camera pair's with Kahan compensation.
// The launcher allocates nothing and returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarps = 4;  // warps per block, one chunk each
// Resident blocks per SM aimed at for f32 with nb <= 16 (16 warps: the
// warps, not the ring depth, hide the copies' latency); the ring gets
// the stages (2 to kMaxStages) that still fit that many blocks.
constexpr int kBlocksPerSm = 4;
constexpr int kMaxStages = 4;
constexpr size_t kMaxSmem = 232448;   // bytes a block may use on sm_90
constexpr size_t kSmemPerSm = 233472;  // bytes an SM has, 1 KB reserved per block
// A lane's loads of a row shifted by sh reach up to sh < 16 bytes past
// the row's slot; the block's shared memory ends with this much slack.
constexpr size_t kTail = 16;

template <int NBP>
struct Tiling {
  static constexpr int TA = NBP == 32 ? 8 : 4;  // output rows a lane owns
  static constexpr int TC = 4;                  // output columns a lane owns
  static constexpr int LANES = (NBP / TA) * (NBP / TC);  // lanes per pair
  static constexpr int GROUPS = 32 / LANES;  // pairs the warp works on at once
};

// Bytes of one warp's slot headers: the mbarriers, then the row shifts.
__host__ __device__ constexpr int header_bytes(int stages, int cap) {
  return (stages * 8 + 15) / 16 * 16 + (stages * 2 * cap * 4 + 15) / 16 * 16;
}

template <typename T, int LDW>
struct Word;  // the shared-memory load of LDW bytes
template <>
struct Word<float, 4> {
  using type = float;
};
template <>
struct Word<float, 8> {
  using type = float2;
};
template <>
struct Word<float, 16> {
  using type = float4;
};
template <>
struct Word<double, 8> {
  using type = double;
};
template <>
struct Word<double, 16> {
  using type = double2;
};

// N values from LDW-byte aligned shared memory into registers.
template <typename T, int LDW, int N>
__device__ __forceinline__ void load_words(const unsigned char* src, T (&dst)[N]) {
  using W = typename Word<T, LDW>::type;
  constexpr int kPer = LDW / static_cast<int>(sizeof(T));
  static_assert(N % kPer == 0, "whole words");
  const W* s = reinterpret_cast<const W*>(src);
#pragma unroll
  for (int i = 0; i < N / kPer; ++i) {
    const W w = s[i];
    const T* e = reinterpret_cast<const T*>(&w);
#pragma unroll
    for (int j = 0; j < kPer; ++j) dst[i * kPer + j] = e[j];
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Wait for the completion of the phase of parity `parity` of `bar`.  A
// bulk copy that never lands traps after a few seconds instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int64_t i = 0; !mbar_try_wait(bar, parity); ++i)
    if (i > (int64_t{1} << 24)) __trap();
}

// One row of a slot: a lane that owns a row (`mine`) fetches Y row
// `idx` into the slot row at `dst` and records its shift in `*shift`;
// every lane, fetching or not, arrives once on the slot's mbarrier.
template <typename T>
__device__ __forceinline__ void fetch_row(const T* Y, int64_t n_y, int row_bytes, int idx,
                                          bool mine, unsigned char* dst, int* shift,
                                          uint32_t bar) {
  uint32_t tx = 0;
  const char* wsrc = nullptr;
  if (mine) {
    int sh = -1;  // pad pair
    if (idx >= 0 && idx < n_y) {
      const char* Yb = reinterpret_cast<const char*>(Y);
      const char* src = Yb + static_cast<int64_t>(idx) * row_bytes;
      sh = static_cast<int>(reinterpret_cast<uintptr_t>(src) & 15);
      const uint32_t win = static_cast<uint32_t>((sh + row_bytes + 15) & ~15);
      if (src - sh + win <= Yb + n_y * row_bytes) {
        wsrc = src - sh;
        tx = win;
      } else {  // the window would pass the end of Y: copy the row itself
        const T* s = reinterpret_cast<const T*>(src);
        T* d = reinterpret_cast<T*>(dst + sh);
        for (int e = 0; e < row_bytes / static_cast<int>(sizeof(T)); ++e) d[e] = s[e];
      }
    }
    *shift = sh;
  }
  // Earlier generic reads and writes of the slot before the copy engine's writes.
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  if (!tx) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
    return;
  }
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(tx)
               : "memory");
  asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
        "[%3];\n" ::"r"(smem_addr(dst)),
        "l"(wsrc), "r"(tx), "r"(bar)
        : "memory");
}

// This lane's pair index of bucket row r (-1 past the chunk's rows).
__device__ __forceinline__ int row_index(const int* i1, const int* i2, int r, int r_end,
                                         int cap, int lane) {
  if (r >= r_end || lane >= 2 * cap) return -1;
  const int64_t p0 = static_cast<int64_t>(r) * cap;
  return lane < cap ? i1[p0 + lane] : i2[p0 + lane - cap];
}

// f32 sums: a lane adds at most kChain pairs (3 kChain products) into a
// plain partial sum, then moves it into its running sum with Kahan
// compensation, so a long camera pair (~1,000 pairs) keeps the error of
// short sums instead of one that grows with the pair count.  f64 adds
// every product straight into the running sum.
constexpr int kChain = 8;

template <typename T, int TA, int TC>
__device__ __forceinline__ void kahan_add(T (&acc)[TA][TC], T (&comp)[TA][TC],
                                          T (&part)[TA][TC]) {
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int k = 0; k < TC; ++k) {
      const T y = part[i][k] - comp[i][k];
      const T t = acc[i][k] + y;
      comp[i][k] = (t - acc[i][k]) - y;
      acc[i][k] = t;
      part[i][k] = T(0);
    }
}

// Add the products of one pair (slot rows `row1`, `row2`, already
// shifted) into this lane's tile `sum`.
template <typename T, int NBP, int LDW>
__device__ __forceinline__ void add_pair(const unsigned char* row1, const unsigned char* row2,
                                         int a0, int c0,
                                         T (&sum)[Tiling<NBP>::TA][Tiling<NBP>::TC]) {
  constexpr int TA = Tiling<NBP>::TA, TC = Tiling<NBP>::TC;
  T v[3 * TC];
  load_words<T, LDW>(row2 + 3 * c0 * sizeof(T), v);
#pragma unroll
  for (int i0 = 0; i0 < TA; i0 += 4) {  // four output rows' 3-vectors at a time
    T u[12];
    load_words<T, LDW>(row1 + 3 * (a0 + i0) * sizeof(T), u);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        T s = sum[i0 + i][k];
        s = fma(u[3 * i], v[3 * k], s);
        s = fma(u[3 * i + 1], v[3 * k + 1], s);
        s = fma(u[3 * i + 2], v[3 * k + 2], s);
        sum[i0 + i][k] = s;
      }
  }
}

// Add the products of the pairs p = group, group + GROUPS, ... of a
// slot (rows `rows`, shifts `shift`) into this lane's tile `acc`.
template <typename T, int NBP, int LDW>
__device__ __forceinline__ void add_row(const unsigned char* rows, const int* shift, int cap,
                                        int group, int a0, int c0,
                                        T (&acc)[Tiling<NBP>::TA][Tiling<NBP>::TC],
                                        T (&comp)[Tiling<NBP>::TA][Tiling<NBP>::TC]) {
  constexpr int TA = Tiling<NBP>::TA, TC = Tiling<NBP>::TC;
  constexpr int kRowB = 3 * NBP * sizeof(T);
  T part[TA][TC];
#pragma unroll
  for (int i = 0; i < TA; ++i)
#pragma unroll
    for (int k = 0; k < TC; ++k) part[i][k] = T(0);
  int chain = 0;
#pragma unroll 2
  for (int p = group; p < cap; p += Tiling<NBP>::GROUPS) {
    const int s1 = shift[p], s2 = shift[cap + p];
    if (s1 < 0 || s2 < 0) continue;  // a pad pair adds nothing
    const unsigned char* row1 = rows + p * kRowB + s1;
    const unsigned char* row2 = rows + (cap + p) * kRowB + s2;
    if constexpr (sizeof(T) == 4) {
      add_pair<T, NBP, LDW>(row1, row2, a0, c0, part);
      if (++chain == kChain) {
        kahan_add(acc, comp, part);
        chain = 0;
      }
    } else {
      add_pair<T, NBP, LDW>(row1, row2, a0, c0, acc);
    }
  }
  if constexpr (sizeof(T) == 4)
    if (chain) kahan_add(acc, comp, part);
}

template <typename T, int NBP, int LDW>
__global__ void __launch_bounds__(kWarps * 32, sizeof(T) == 4 && NBP <= 16 ? kBlocksPerSm : 1)
    pair_bucket_kernel(const T* __restrict__ Y, int64_t n_y, int nb,
                       const int* __restrict__ i1, const int* __restrict__ i2,
                       const int* __restrict__ row_ptr,
                       const int* __restrict__ chunk_ptr, int n_chunks,
                       T* __restrict__ out, int cap, int stages) {
  using Tl = Tiling<NBP>;
  constexpr int TA = Tl::TA, TC = Tl::TC;
  constexpr int kRowB = 3 * NBP * sizeof(T);  // bytes of a slot row
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int chunk = blockIdx.x * kWarps + warp;
  if (chunk >= n_chunks) return;  // no block barrier below

  // This warp's slot headers (stages mbarriers, stages x 2 cap shifts)
  // and ring (stages x 2 cap rows of kRowB bytes).
  const int slot_bytes = 2 * cap * kRowB;
  unsigned char* base = smem_raw + static_cast<size_t>(warp) *
                                       (header_bytes(stages, cap) + stages * slot_bytes);
  int* shifts = reinterpret_cast<int*>(base + (stages * 8 + 15) / 16 * 16);
  unsigned char* ring = base + header_bytes(stages, cap);
  const uint32_t bar0 = smem_addr(base);
  if (lane < stages)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 32;\n" ::"r"(bar0 + 8 * lane) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  __syncwarp();

  const int row_bytes = 3 * nb * static_cast<int>(sizeof(T));
  const bool mine = lane < 2 * cap;
  unsigned char* my_row = ring + lane * kRowB;  // in slot 0
  int* my_shift = shifts + lane;

  const int cp_begin = chunk_ptr[chunk], cp_end = chunk_ptr[chunk + 1];
  const int r_begin = row_ptr[cp_begin], r_end = row_ptr[cp_end];

  // Prologue: rows r_begin .. r_begin + stages - 2 into slots 0 .. stages - 2.
  for (int s = 0; s < stages - 1 && r_begin + s < r_end; ++s)
    fetch_row(Y, n_y, row_bytes, row_index(i1, i2, r_begin + s, r_end, cap, lane), mine,
              my_row + s * slot_bytes, my_shift + s * 2 * cap, bar0 + 8 * s);
  int next_idx = row_index(i1, i2, r_begin + stages - 1, r_end, cap, lane);

  const int group = lane / Tl::LANES;
  const int li = lane - group * Tl::LANES;
  const int a0 = (li / (NBP / TC)) * TA;
  const int c0 = (li % (NBP / TC)) * TC;

  uint32_t parity = 0;  // bit s: parity of slot s's next completion
  int r = r_begin, slot = 0;
  for (int c = cp_begin; c < cp_end; ++c) {
    const int r_stop = row_ptr[c + 1];
    T acc[TA][TC], comp[TA][TC];
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int k = 0; k < TC; ++k) acc[i][k] = comp[i][k] = T(0);

    for (; r < r_stop; ++r) {
      // Refill the slot consumed one step ago with row r + stages - 1.
      const int ahead = r + stages - 1;
      if (ahead < r_end) {
        const int s = slot == 0 ? stages - 1 : slot - 1;
        fetch_row(Y, n_y, row_bytes, next_idx, mine, my_row + s * slot_bytes,
                  my_shift + s * 2 * cap, bar0 + 8 * s);
      }
      next_idx = row_index(i1, i2, ahead + 1, r_end, cap, lane);
      mbar_wait(bar0 + 8 * slot, (parity >> slot) & 1u);  // row r has landed
      parity ^= 1u << slot;
      __syncwarp();

      add_row<T, NBP, LDW>(ring + slot * slot_bytes, shifts + slot * 2 * cap, cap, group, a0,
                           c0, acc, comp);
      __syncwarp();  // every lane is done with the slot before it is refilled
      slot = slot + 1 == stages ? 0 : slot + 1;
    }

    // Fold the pair groups (fixed tree), then group 0 stores the block.
#pragma unroll
    for (int i = 0; i < TA; ++i)
#pragma unroll
      for (int k = 0; k < TC; ++k) {
        if constexpr (sizeof(T) == 4) acc[i][k] -= comp[i][k];  // see kChain
#pragma unroll
        for (int off = 16; off >= Tl::LANES; off >>= 1)
          acc[i][k] += __shfl_xor_sync(0xffffffffu, acc[i][k], off);
      }
    if (group == 0) {
      T* o = out + static_cast<int64_t>(c) * nb * nb;
#pragma unroll
      for (int i = 0; i < TA; ++i)
#pragma unroll
        for (int k = 0; k < TC; ++k)
          if (a0 + i < nb && c0 + k < nb) o[(a0 + i) * nb + c0 + k] = acc[i][k];
    }
  }
}

// Let `fn` use up to kMaxSmem bytes of dynamic shared memory on the
// current device (once per kernel and device: the call costs host time).
cudaError_t allow_smem(const void* fn) {
  struct Entry {
    const void* fn;
    int dev;
  };
  static std::mutex mu;
  static Entry done[32];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i)
    if (done[i].fn == fn && done[i].dev == dev) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kMaxSmem));
  if (err == cudaSuccess && used < 32) done[used++] = Entry{fn, dev};
  return err;
}

// One instance of the kernel with its ring depth and shared memory for
// `cap` pairs per bucket row.
struct Instance {
  const void* fn;
  int stages;
  size_t smem;
};

template <typename T, int NBP, int LDW>
Instance instance(int cap) {
  const size_t slot_bytes = 2 * static_cast<size_t>(cap) * 3 * NBP * sizeof(T);
  auto warp_bytes = [&](int st) { return header_bytes(st, cap) + st * slot_bytes; };
  int stages = kMaxStages;
  while (stages > 2 && kWarps * warp_bytes(stages) + kTail > kSmemPerSm / kBlocksPerSm - 1024)
    --stages;
  return Instance{reinterpret_cast<const void*>(pair_bucket_kernel<T, NBP, LDW>), stages,
                  kWarps * warp_bytes(stages) + kTail};
}

// The instance for nb: tiles of NBP = 8, 16 or 32; shared loads of 16
// bytes when every row keeps a 16-byte phase of 0, else 8 or 4 (the
// element size at least).  fn is null when nb is not supported.
template <typename T>
Instance select(int64_t nb, int64_t cap) {
  if (nb < 1 || nb > 32 || cap < 1 || cap > 16) return Instance{nullptr, 0, 0};
  const int c = static_cast<int>(cap);
  const int64_t row_bytes = 3 * nb * sizeof(T);
  const int ldw = row_bytes % 16 == 0 ? 16 : row_bytes % 8 == 0 ? 8 : 4;
  if (ldw < static_cast<int>(sizeof(T))) return Instance{nullptr, 0, 0};
  const int nbp = nb <= 8 ? 8 : nb <= 16 ? 16 : 32;
#define DBAT_PB_NBP(N)                                            \
  if (nbp == N) {                                                 \
    if (ldw == 16) return instance<T, N, 16>(c);                  \
    if (ldw == 8) return instance<T, N, 8>(c);                    \
    if constexpr (sizeof(T) == 4) return instance<T, N, 4>(c);    \
  }
  DBAT_PB_NBP(8)
  DBAT_PB_NBP(16)
  DBAT_PB_NBP(32)
#undef DBAT_PB_NBP
  return Instance{nullptr, 0, 0};
}

template <typename T>
int launch(const void* Y, int64_t n_y, int64_t nb, const void* i1, const void* i2,
           const void* row_ptr, const void* chunk_ptr, int64_t n_chunks, void* out,
           int64_t cap, void* stream) {
  const Instance in = select<T>(nb, cap);
  if (!in.fn || reinterpret_cast<uintptr_t>(Y) % 16 || in.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_smem(in.fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  // The kernel's parameters, in order, for cudaLaunchKernel.
  const int64_t blocks = (n_chunks + kWarps - 1) / kWarps;
  int nb32 = static_cast<int>(nb), n_chunks32 = static_cast<int>(n_chunks);
  int cap32 = static_cast<int>(cap), stages = in.stages;
  void* args[] = {&Y, &n_y, &nb32, &i1, &i2, &row_ptr, &chunk_ptr, &n_chunks32,
                  &out, &cap32, &stages};
  const cudaError_t lerr =
      cudaLaunchKernel(in.fn, dim3(static_cast<unsigned>(blocks)), dim3(kWarps * 32), args,
                       in.smem, static_cast<cudaStream_t>(stream));
  return static_cast<int>(lerr != cudaSuccess ? lerr : cudaGetLastError());
}

// Warps of the kernel for (nb, cap) that the current device holds at
// once: the size of the persistent grid, and so the number of chunks the
// plan cuts.  Negative on an error.
template <typename T>
int resident_warps(int64_t nb, int64_t cap) {
  const Instance in = select<T>(nb, cap);
  if (!in.fn || in.smem > kMaxSmem) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = allow_smem(in.fn);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, in.fn, kWarps * 32, in.smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return sms * (per_sm > 0 ? per_sm : 1) * kWarps;
}

}  // namespace

extern "C" int dbat_pair_bucket_acc_f32(const void* Y, int64_t n_y, int64_t nb,
                                        const void* i1, const void* i2,
                                        const void* row_ptr, const void* chunk_ptr,
                                        int64_t n_chunks, void* out, int64_t cap,
                                        void* stream) {
  return launch<float>(Y, n_y, nb, i1, i2, row_ptr, chunk_ptr, n_chunks, out, cap, stream);
}

extern "C" int dbat_pair_bucket_acc_f64(const void* Y, int64_t n_y, int64_t nb,
                                        const void* i1, const void* i2,
                                        const void* row_ptr, const void* chunk_ptr,
                                        int64_t n_chunks, void* out, int64_t cap,
                                        void* stream) {
  return launch<double>(Y, n_y, nb, i1, i2, row_ptr, chunk_ptr, n_chunks, out, cap, stream);
}

extern "C" int dbat_pair_bucket_resident_warps_f32(int64_t nb, int64_t cap) {
  return resident_warps<float>(nb, cap);
}

extern "C" int dbat_pair_bucket_resident_warps_f64(int64_t nb, int64_t cap) {
  return resident_warps<double>(nb, cap);
}
