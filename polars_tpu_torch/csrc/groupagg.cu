// K1: masked per-group sums of k columns, read in place.
//
// Replaces the TPU kernel polars_tpu/kernels/pallas_groupagg.py `_kernel`
// (launched by `groupagg_sums_pallas` through `_call`), which contracted a
// one-hot (BLOCK, cap) matrix against hi/lo f32 planes of the values on the
// MXU. None of that carries over: Hopper adds f64 and i64 natively, and the
// work is bound by bytes about ten times over, so the tensor cores stay idle.
//
// What bounds it on an H100: bytes. Per row it reads a 1-byte mask, a 4-byte
// group id and 8 bytes per column, and does one add per column. The card
// streams at its memory rate only with tens of kilobytes in flight per SM all
// the time, so the design keeps the loads independent of the adds:
//   * persistent blocks, one per SM, walk the row tiles b, b + G, b + 2G, ...
//     of a fixed number of rows. The assignment is static, so a block always
//     sums the same rows in the same order;
//   * a ring of 2-8 stages in shared memory. One producer thread fills a
//     stage with 1-D bulk copies (cp.async.bulk, the TMA unit, no tensor
//     map: every operand is a contiguous array) of the tile's mask bytes,
//     ids and column slices, which complete on the stage's `full` mbarrier;
//     the consumer warps add the stage that has arrived and release it
//     through its `empty` mbarrier. Nothing a consumer does delays a load;
//   * all rows of a tile are copied, masked or not; a value enters a sum
//     only under a select on `mask && 0 <= id < cap`, so masked-out rows may
//     hold NaN, inf or ids out of range;
//   * a bulk copy needs a 16-byte aligned source. Tiles start at multiples of
//     512 rows, so an operand is aligned in every tile or in none: one whose
//     pointer is not 16-byte aligned (a view with a storage offset) is read
//     with plain loads straight from global memory by the thread that adds
//     it, and so is the ragged last tile. A null column pointer stands for a
//     column of ones and is neither copied nor read;
//   * accumulators: MODE_PRIVATE gives every consumer thread its own
//     (cap, kt) slice of shared memory (no atomics, conflict-free banks, a
//     fixed order, so f64 sums repeat bit for bit); MODE_SHARED keeps a few
//     slices per block and adds with shared atomics; MODE_GLOBAL, for a
//     column that does not fit shared memory, adds with global atomics into
//     slices of zeroed scratch that the blocks share round robin. i64 is
//     exact in every mode. In MODE_SHARED f64 atomics add in an order that
//     varies from run to run (rtol 1e-9). In MODE_GLOBAL, the mode of the
//     sorted group-by (capacity = rows), an f64 call adds exact words
//     instead (four int64 accumulators per sum), so its sums repeat bit for
//     bit: a first small kernel finds the largest exponent e of each
//     column's selected finite values, and every value v splits into three
//     int64 words d_k = trunc of v's remainder * 2^(k w - e), |d_k| < 2^w,
//     added with integer atomics; w = min(50, 62 - bits(n)), so no sum of n
//     words overflows. Integer sums do not depend on the order of the adds,
//     and the finish kernel puts the words together in a fixed order. What
//     is cut off is below 2^(e - 3w) per value: a group whose values all lie
//     far below the column's largest loses their low bits (at 60M rows,
//     w = 36, rtol 1e-9 holds down to about 2^-78 of the largest). A fourth
//     word counts the non-finite values (+inf in its low 32 bits, -inf in
//     its high bits, NaN in both);
//   * each block leaves one partial slice; a small second kernel sums the
//     slices in slice order, one thread per output.
// The Python side (kernels/groupagg.py `plan`) sizes threads, tile rows,
// stages, replicas, blocks and slices; `layout_bytes` here must agree with it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C ABI,
// loaded with ctypes by polars_tpu_torch/kernels/groupagg.py).

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_KT = 16;       // columns per launch
constexpr int MAX_STAGES = 8;    // ring depth
constexpr int U = 4;             // consecutive rows per consumer thread per step
constexpr int MAX_CONSUMERS = 512;
constexpr int PRODUCER_THREADS = 32;
constexpr int HEADER = 128;      // bytes of mbarriers ahead of the accumulators
constexpr int SMEM_MAX = 232448;
constexpr unsigned VIA_IDS = 1u << 30;
constexpr unsigned VIA_MASK = 1u << 31;
constexpr unsigned FULL_WARP = 0xffffffffu;
constexpr int NWORDS = 4;        // exact words per f64 accumulator: three parts and the non-finite counts
constexpr int EXP_MIN = -800;    // the words' scale: every 2^(+-(k w - e)) stays a normal double

enum { MODE_PRIVATE = 0, MODE_SHARED = 1, MODE_GLOBAL = 2 };

template <typename T>
struct Args {
  const int* gids;
  const unsigned char* mask;
  const T* cols[MAX_KT];
  long long n;
  int kt, cap;
  int ct;        // consumer threads
  int tile;      // rows per tile, a multiple of ct * U
  int stages;
  int repl;      // MODE_SHARED: accumulator slices per block
  int slices;    // partial slices in `partials`
  unsigned acc_bytes;  // shared-memory bytes of accumulators, a multiple of 128
  T* partials;         // exact words: NWORDS long longs per accumulator instead
  const int* exps;     // exact words: per column, the largest ilogb of its selected finite values
  int wbits;           // exact words: w
};

template <typename T>
struct alignas(16) Pair {
  T a, b;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}
// Spins until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// 1-D bulk copy global -> shared; `bytes` and both addresses are multiples of 16.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(__cvta_generic_to_global(src)), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void atomic_add(double* a, double v) { atomicAdd(a, v); }
__device__ __forceinline__ void atomic_add(long long* a, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(a), static_cast<unsigned long long>(v));
}

// The exponent e of a column's words: every selected finite |v| < 2^e.
__device__ __forceinline__ int word_exp(const int* exps, int c) { return max(__ldg(exps + c) + 1, EXP_MIN); }

// Adds v to its accumulator's exact words `w` (scale 2^e, w = `bits` bits a word).
__device__ __forceinline__ void add_words(unsigned long long* w, double v, int e, int bits) {
  if (isfinite(v)) {
    double r = v;
#pragma unroll
    for (int k = 1; k < NWORDS; ++k) {
      const double d = trunc(scalbn(r, k * bits - e));
      if (d != 0.0) atomicAdd(&w[k - 1], static_cast<unsigned long long>(static_cast<long long>(d)));
      r -= scalbn(d, e - k * bits);
    }
  } else {
    atomicAdd(&w[NWORDS - 1], isnan(v) ? 0x100000001ULL : (v > 0.0 ? 1ULL : 0x100000000ULL));
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Adds rows [r0, r0 + rows) to the accumulators. An operand whose bit is set
// in `via` is read from the stage at `st` (the whole tile is there); any other
// is read from global memory under the row's predicate. Offsets are 32-bit:
// the launcher checks that cap * kt * ct fits.
template <typename T, int MODE, int CCH, bool W>
__device__ __forceinline__ void consume(const Args<T>& a, long long r0, int rows, const unsigned char* st,
                                        unsigned via, T* my, int tid) {
  const int kt = a.kt, ct = a.ct, tile = a.tile;
  const T* s_cols = reinterpret_cast<const T*>(st);
  const int* s_ids = reinterpret_cast<const int*>(st + static_cast<size_t>(tile) * 8 * kt);
  const unsigned char* s_mask = st + static_cast<size_t>(tile) * (8 * kt + 4);
  const unsigned cap = static_cast<unsigned>(a.cap);
  // elements between two accumulators of one thread: private slices interleave the threads
  const int stride = MODE == MODE_PRIVATE ? ct : 1;
  const int row_step = kt * stride;

  for (int base = 0; base < rows; base += ct * U) {
    const int i = base + tid * U;
    unsigned m4 = 0;
    if (via & VIA_MASK) {
      m4 = *reinterpret_cast<const unsigned*>(s_mask + i);
    } else {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (i + j < rows && a.mask[r0 + i + j] != 0) m4 |= 0xffu << (8 * j);
      }
    }
    int g[U];
    if (via & VIA_IDS) {
      const int4 q = *reinterpret_cast<const int4*>(s_ids + i);
      g[0] = q.x, g[1] = q.y, g[2] = q.z, g[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < U; ++j) g[j] = ((m4 >> (8 * j)) & 0xffu) ? a.gids[r0 + i + j] : -1;
    }
    // element offset of each row's group, or -1 for a row that is dropped
    int off[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const bool ok = ((m4 >> (8 * j)) & 0xffu) != 0 && static_cast<unsigned>(g[j]) < cap;
      off[j] = ok ? g[j] * row_step : -1;
    }
#pragma unroll 1
    for (int c0 = 0; c0 < kt; c0 += CCH) {
      T v[CCH][U];
#pragma unroll
      for (int cc = 0; cc < CCH; ++cc) {
        const int c = c0 + cc;
        if (c >= kt) break;
        if (a.cols[c] == nullptr) {
#pragma unroll
          for (int j = 0; j < U; ++j) v[cc][j] = T(1);
        } else if ((via >> c) & 1u) {
          const Pair<T>* sp = reinterpret_cast<const Pair<T>*>(s_cols + c * tile + i);
          const Pair<T> lo = sp[0], hi = sp[1];
          v[cc][0] = lo.a, v[cc][1] = lo.b, v[cc][2] = hi.a, v[cc][3] = hi.b;
        } else {
          const T* p = a.cols[c] + r0 + i;
#pragma unroll
          for (int j = 0; j < U; ++j) v[cc][j] = off[j] >= 0 ? p[j] : T(0);
        }
      }
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (off[j] < 0) continue;
        T* dst = my + off[j] + c0 * stride;
#pragma unroll
        for (int cc = 0; cc < CCH; ++cc) {
          if (c0 + cc >= kt) break;
          if constexpr (W) {
            unsigned long long* w = reinterpret_cast<unsigned long long*>(my) +
                                    (static_cast<long long>(off[j]) + c0 + cc) * NWORDS;
            add_words(w, static_cast<double>(v[cc][j]), word_exp(a.exps, c0 + cc), a.wbits);
          } else if (MODE == MODE_PRIVATE) {
            dst[cc * stride] += v[cc][j];
          } else {
            atomic_add(&dst[cc * stride], v[cc][j]);
          }
        }
      }
    }
  }
}

template <typename T, int MODE, int CCH, bool W>
__global__ void __launch_bounds__(MAX_CONSUMERS + PRODUCER_THREADS, 1)
groupagg_main(const __grid_constant__ Args<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + MAX_STAGES;
  T* acc = reinterpret_cast<T*>(smem + HEADER);
  unsigned char* ring = smem + HEADER + a.acc_bytes;

  const int tid = threadIdx.x, lane = tid & 31;
  const int ct = a.ct, kt = a.kt, tile = a.tile, stages = a.stages;
  const size_t stage_bytes = static_cast<size_t>(tile) * (8 * kt + 5);
  const long long slice = static_cast<long long>(a.cap) * kt;
  T* part = a.partials + (blockIdx.x % a.slices) * slice * (W ? NWORDS : 1);

  // operands that ride the ring: the 16-byte aligned ones
  unsigned via = 0;
  for (int c = 0; c < kt; ++c) {
    if (a.cols[c] != nullptr && aligned16(a.cols[c])) via |= 1u << c;
  }
  if (aligned16(a.gids)) via |= VIA_IDS;
  if (aligned16(a.mask)) via |= VIA_MASK;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), ct / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  }
  if (MODE != MODE_GLOBAL) {
    const long long acc_elems = slice * (MODE == MODE_PRIVATE ? ct : a.repl);
    for (long long e = tid; e < acc_elems; e += blockDim.x) acc[e] = T(0);
  }
  __syncthreads();

  // where this thread adds: its private slice, its warp's replica, or the block's global slice
  T* my = part;
  if (MODE == MODE_PRIVATE) my = acc + tid;
  if (MODE == MODE_SHARED) my = acc + ((tid >> 5) % a.repl) * slice;

  const long long n_full = a.n / tile;
  if (tid >= ct) {
    // producer warp: one thread keeps the ring full
    if (tid == ct) {
      uint32_t bytes = 0;
      for (int c = 0; c < kt; ++c) bytes += ((via >> c) & 1u) ? tile * 8u : 0u;
      if (via & VIA_IDS) bytes += tile * 4u;
      if (via & VIA_MASK) bytes += tile;
      int s = 0;
      uint32_t phase = 0;
      for (long long t = blockIdx.x; t < n_full; t += gridDim.x) {
        mbar_wait(smem_u32(&empty[s]), phase ^ 1u);
        const uint32_t bar = smem_u32(&full[s]);
        mbar_arrive_expect_tx(bar, bytes);
        const long long r0 = t * tile;
        const uint32_t dst = smem_u32(ring + s * stage_bytes);
        for (int c = 0; c < kt; ++c) {
          if ((via >> c) & 1u) bulk_load(dst + static_cast<uint32_t>(c) * tile * 8u, a.cols[c] + r0, tile * 8u, bar);
        }
        if (via & VIA_IDS) bulk_load(dst + static_cast<uint32_t>(kt) * tile * 8u, a.gids + r0, tile * 4u, bar);
        if (via & VIA_MASK) bulk_load(dst + static_cast<uint32_t>(tile) * (8u * kt + 4u), a.mask + r0, tile, bar);
        if (++s == stages) s = 0, phase ^= 1u;
      }
    }
    __syncwarp();
  } else {
    int s = 0;
    uint32_t phase = 0;
    for (long long t = blockIdx.x; t < n_full; t += gridDim.x) {
      mbar_wait(smem_u32(&full[s]), phase);
      consume<T, MODE, CCH, W>(a, t * tile, tile, ring + s * stage_bytes, via, my, tid);
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(&empty[s]));
      if (++s == stages) s = 0, phase ^= 1u;
    }
    // the ragged last tile goes to the block next in turn, with plain loads
    if (n_full % gridDim.x == blockIdx.x) {
      consume<T, MODE, CCH, W>(a, n_full * tile, static_cast<int>(a.n - n_full * tile), ring, 0u, my, tid);
    }
  }
  if (MODE == MODE_GLOBAL) return;
  __syncthreads();
  if (tid >= ct) return;
  if (MODE == MODE_PRIVATE) {
    // one warp per output: lanes stride the thread slices, then a butterfly;
    // the order is fixed, so the block's sum repeats bit for bit
    for (long long e = tid >> 5; e < slice; e += ct / 32) {
      T s = T(0);
      for (int i = lane; i < ct; i += 32) s += acc[e * ct + i];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(FULL_WARP, s, off);
      if (lane == 0) part[e] = s;
    }
  } else {
    for (long long e = tid; e < slice; e += ct) {
      T s = T(0);
      for (int r = 0; r < a.repl; ++r) s += acc[r * slice + e];
      part[e] = s;
    }
  }
}

template <typename T>
__global__ void groupagg_zero(T* __restrict__ p, long long count) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; e < count; e += step) p[e] = T(0);
}

// out[g, col0 + c] = the partial slices summed in slice order.
template <typename T>
__global__ void groupagg_finish(const T* __restrict__ partials, int slices, long long slice, int kt,
                                T* __restrict__ out, int out_ld, int col0) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= slice) return;
  T s = T(0);
#pragma unroll 4
  for (int b = 0; b < slices; ++b) s += partials[b * slice + e];
  out[(e / kt) * out_ld + col0 + (e % kt)] = s;
}

// out[g, col0 + c] from the exact words of the partial slices: each word
// summed over the slices, the three parts added in a fixed order, then inf or
// NaN where non-finite values were added.
__global__ void groupagg_finish_words(const long long* __restrict__ partials, int slices, long long slice, int kt,
                                      const int* __restrict__ exps, int bits, double* __restrict__ out, int out_ld,
                                      int col0) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= slice) return;
  long long s[NWORDS] = {0, 0, 0, 0};
  for (int b = 0; b < slices; ++b) {
#pragma unroll
    for (int k = 0; k < NWORDS; ++k) s[k] += partials[(b * slice + e) * NWORDS + k];
  }
  const int c = static_cast<int>(e % kt);
  const int ex = word_exp(exps, c);
  double r = scalbn(static_cast<double>(s[0]), ex - bits) + scalbn(static_cast<double>(s[1]), ex - 2 * bits);
  r += scalbn(static_cast<double>(s[2]), ex - 3 * bits);
  const unsigned long long nf = static_cast<unsigned long long>(s[NWORDS - 1]);
  const bool pos = (nf & 0xffffffffULL) != 0, neg = (nf >> 32) != 0;
  if (pos && neg) {
    r = __longlong_as_double(0x7ff8000000000000LL);
  } else if (pos) {
    r = __longlong_as_double(0x7ff0000000000000LL);
  } else if (neg) {
    r = __longlong_as_double(static_cast<long long>(0xfff0000000000000ULL));
  }
  out[(e / kt) * out_ld + col0 + c] = r;
}

// *e_out = max(*e_out, ilogb |v|) over the selected finite non-zero values v
// of one column (a null column stands for ones: ilogb 1 = 0).
__global__ void groupagg_exponent(const unsigned char* __restrict__ mask, const double* __restrict__ col, long long n,
                                  int* __restrict__ e_out) {
  if (col == nullptr) {
    if (blockIdx.x == 0 && threadIdx.x == 0) atomicMax(e_out, 0);
    return;
  }
  int m = INT_MIN;
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < n; r += step) {
    const double v = col[r];
    if (mask[r] != 0 && isfinite(v) && v != 0.0) m = max(m, ilogb(v));
  }
  m = __reduce_max_sync(FULL_WARP, m);
  if ((threadIdx.x & 31) == 0 && m != INT_MIN) atomicMax(e_out, m);
}

// Shared-memory bytes of one block; kernels/groupagg.py `plan` computes the same.
long long layout_bytes(int mode, int cap, int kt, int ct, int tile, int stages, int repl, unsigned* acc_bytes) {
  long long acc = 0;
  if (mode == MODE_PRIVATE) acc = 8LL * cap * kt * ct;
  if (mode == MODE_SHARED) acc = 8LL * cap * kt * repl;
  acc = (acc + 127) / 128 * 128;
  const long long total = HEADER + acc + static_cast<long long>(stages) * tile * (8 * kt + 5);
  *acc_bytes = static_cast<unsigned>(acc <= SMEM_MAX ? acc : 0);
  return total;
}

template <typename T, int MODE, int CCH, bool W>
int launch_main(const Args<T>& a, int blocks, size_t smem, cudaStream_t stream) {
  auto kern = groupagg_main<T, MODE, CCH, W>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
  if (err != cudaSuccess) return err;
  kern<<<blocks, a.ct + PRODUCER_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int MODE, bool W = false>
int dispatch_width(const Args<T>& a, int blocks, size_t smem, cudaStream_t stream) {
  if (a.kt == 1) return launch_main<T, MODE, 1, W>(a, blocks, smem, stream);
  return launch_main<T, MODE, 4, W>(a, blocks, smem, stream);
}

template <typename T>
int groupagg(const int* gids, const unsigned char* mask, const void* const* col_ptrs, int kt, long long n,
             int cap, int mode, int threads, int tile, int stages, int repl, int blocks, int slices,
             int smem_bytes, T* partials, T* out, int out_ld, int col0, int* exps, int wbits, int sms,
             cudaStream_t stream) {
  // f64 in MODE_GLOBAL adds exact words, and nothing else does
  constexpr bool kWords = std::is_same<T, double>::value;
  const bool words = kWords && mode == MODE_GLOBAL;
  if ((exps != nullptr) != words || (words && (wbits < 1 || wbits > 50)) ||
      kt < 1 || kt > MAX_KT || cap < 1 || n < 0 || mode < 0 || mode > 2 || threads < 32 ||
      threads > MAX_CONSUMERS || threads % 32 != 0 || tile < threads * U || tile % (threads * U) != 0 ||
      stages < 2 || stages > MAX_STAGES || blocks < 1 || slices < 1 || slices > blocks ||
      (mode != MODE_GLOBAL && slices != blocks) || (mode == MODE_SHARED && repl < 1) ||
      static_cast<long long>(cap) * kt * (mode == MODE_PRIVATE ? threads : 1) > 0x7fffffffLL) {
    return cudaErrorInvalidValue;
  }
  Args<T> a;
  a.gids = gids, a.mask = mask, a.n = n, a.kt = kt, a.cap = cap, a.ct = threads, a.tile = tile;
  a.stages = stages, a.repl = repl, a.slices = slices, a.partials = partials;
  a.exps = exps, a.wbits = wbits;
  for (int c = 0; c < MAX_KT; ++c) a.cols[c] = c < kt ? static_cast<const T*>(col_ptrs[c]) : nullptr;
  const long long smem = layout_bytes(mode, cap, kt, threads, tile, stages, repl, &a.acc_bytes);
  if (smem > SMEM_MAX || smem != smem_bytes) return cudaErrorInvalidValue;

  const long long slice = static_cast<long long>(cap) * kt;
  int err;
  if (words) {
    // each column's exponent first: 0x80 bytes make an int below every ilogb
    err = cudaMemsetAsync(exps, 0x80, sizeof(int) * kt, stream);
    if (err != cudaSuccess) return err;
    const long long eb = (n + 1023) / 1024;
    const unsigned e_blocks = static_cast<unsigned>(eb < 1 ? 1 : (eb < 4LL * sms ? eb : 4LL * sms));
    for (int c = 0; c < kt; ++c) {
      groupagg_exponent<<<e_blocks, 256, 0, stream>>>(mask, static_cast<const double*>(col_ptrs[c]), n, exps + c);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  if (mode == MODE_PRIVATE) {
    err = dispatch_width<T, MODE_PRIVATE>(a, blocks, smem, stream);
  } else if (mode == MODE_SHARED) {
    err = dispatch_width<T, MODE_SHARED>(a, blocks, smem, stream);
  } else {
    const long long count = slice * slices * (words ? NWORDS : 1);
    const long long zb = (count + 1023) / 1024;
    groupagg_zero<T><<<static_cast<unsigned>(zb < 1024 ? zb : 1024), 256, 0, stream>>>(partials, count);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    err = dispatch_width<T, MODE_GLOBAL, kWords>(a, blocks, smem, stream);
  }
  if (err != cudaSuccess) return err;
  const int t2 = 256;
  const long long b2 = (slice + t2 - 1) / t2;
  if (words) {
    groupagg_finish_words<<<static_cast<unsigned>(b2), t2, 0, stream>>>(
        reinterpret_cast<const long long*>(partials), slices, slice, kt, exps, wbits,
        reinterpret_cast<double*>(out), out_ld, col0);
  } else {
    groupagg_finish<T><<<static_cast<unsigned>(b2), t2, 0, stream>>>(partials, slices, slice, kt, out, out_ld, col0);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[g, col0 + c] = sum of col_ptrs[c][r] over rows r with mask[r] and
// gids[r] == g, for c < kt. `out` is (cap, out_ld) row-major; `partials`
// holds slices * cap * kt elements of scratch (times NWORDS with exact
// words). The launch shape (threads, tile, stages, repl, blocks, slices,
// smem_bytes) comes from `plan` in kernels/groupagg.py. An f64 call in
// MODE_GLOBAL adds exact words and must pass `exps` (kt ints of scratch) and
// `wbits` = w; every other call passes a null `exps`. Returns a cudaError_t.
int groupagg_sums_f64(const int* gids, const unsigned char* mask, const void* const* col_ptrs, int kt,
                      long long n, int cap, int mode, int threads, int tile, int stages, int repl,
                      int blocks, int slices, int smem_bytes, double* partials, double* out, int out_ld,
                      int col0, int* exps, int wbits, int sms, void* stream) {
  return groupagg<double>(gids, mask, col_ptrs, kt, n, cap, mode, threads, tile, stages, repl, blocks,
                          slices, smem_bytes, partials, out, out_ld, col0, exps, wbits, sms,
                          static_cast<cudaStream_t>(stream));
}

int groupagg_sums_i64(const int* gids, const unsigned char* mask, const void* const* col_ptrs, int kt,
                      long long n, int cap, int mode, int threads, int tile, int stages, int repl,
                      int blocks, int slices, int smem_bytes, long long* partials, long long* out,
                      int out_ld, int col0, int* exps, int wbits, int sms, void* stream) {
  return groupagg<long long>(gids, mask, col_ptrs, kt, n, cap, mode, threads, tile, stages, repl, blocks,
                             slices, smem_bytes, partials, out, out_ld, col0, exps, wbits, sms,
                             static_cast<cudaStream_t>(stream));
}

}  // extern "C"
