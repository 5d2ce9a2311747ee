// K1: masked per-group sums of k columns, read in place.
//
// Replaces the TPU kernel polars_tpu/kernels/pallas_groupagg.py `_kernel`
// (launched by `groupagg_sums_pallas` through `_call`), which contracted a
// one-hot (BLOCK, cap) matrix against hi/lo f32 planes of the values on the
// MXU. None of that carries over: Hopper adds f64 and i64 natively.
//
// What bounds it on an H100: bytes. Per row it reads a 1-byte mask, a 4-byte
// group id and 8 bytes per column, and does one add per column; at 3.35 TB/s
// the reads take ~10x longer than the adds. So the design is about reading
// every byte once and never stalling on the accumulators:
//   * the k column pointers are read in place (no (n, k) stack, no masked
//     copies); a null pointer stands for a column of ones, so counts read
//     nothing but the mask and the ids;
//   * each thread loads U rows of all KT columns before it adds any of them,
//     so many loads are in flight per thread at low occupancy;
//   * accumulators live in shared memory. With cap = 12 (PDS-H Q1) every
//     thread owns a private (cap, kt) slice: no atomics, no contention, and
//     the per-block result is a fixed-order sum, so f64 results repeat
//     bit for bit. Larger caps fall back to one slice per warp with shared
//     atomics (MODE_SHARED), and caps whose single column exceeds shared
//     memory accumulate in the block's own slice of global scratch with
//     global atomics (MODE_GLOBAL). In those two modes the f64 summation
//     order varies from run to run (results agree to rtol 1e-9); i64 stays
//     exact in every mode.
//   * blocks write per-block partials; a second kernel reduces them over the
//     blocks in a fixed order.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C ABI,
// loaded with ctypes by polars_tpu_torch/kernels/groupagg.py).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int U = 4;          // rows per thread per iteration
constexpr int MAX_KT = 16;    // columns per launch
constexpr int REPL = THREADS / 32;  // MODE_SHARED: one slice per warp

enum { MODE_PRIVATE = 0, MODE_SHARED = 1, MODE_GLOBAL = 2 };

template <typename T>
struct Cols {
  const T* p[MAX_KT];
};

__device__ __forceinline__ void atomic_add(double* a, double v) { atomicAdd(a, v); }
__device__ __forceinline__ void atomic_add(long long* a, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(a), static_cast<unsigned long long>(v));
}

template <typename T, int MODE, int KT>
__global__ void __launch_bounds__(THREADS)
groupagg_pass1(const int* __restrict__ gids, const unsigned char* __restrict__ mask,
               Cols<T> cols, int kt, long long n, int cap, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* acc = reinterpret_cast<T*>(smem_raw);
  const int tid = threadIdx.x;
  const long long slice = static_cast<long long>(cap) * kt;
  T* part = partials + blockIdx.x * slice;

  if (MODE == MODE_GLOBAL) {
    for (long long e = tid; e < slice; e += THREADS) part[e] = T(0);
  } else {
    const long long acc_elems = slice * (MODE == MODE_PRIVATE ? THREADS : REPL);
    for (long long e = tid; e < acc_elems; e += THREADS) acc[e] = T(0);
  }
  __syncthreads();

  const int rep = tid >> 5;
  const long long step = static_cast<long long>(gridDim.x) * THREADS * U;
  for (long long base = static_cast<long long>(blockIdx.x) * THREADS * U; base < n; base += step) {
    int g[U];
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const long long r = base + j * THREADS + tid;
      int gg = -1;
      if (r < n && mask[r]) {
        gg = gids[r];
        if (static_cast<unsigned>(gg) >= static_cast<unsigned>(cap)) gg = -1;  // dropped
      }
      g[j] = gg;
    }
    T v[KT][U];
#pragma unroll
    for (int c = 0; c < KT; ++c) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        const long long r = base + j * THREADS + tid;
        T x = T(0);
        if (c < kt && g[j] >= 0) x = cols.p[c] ? cols.p[c][r] : T(1);
        v[c][j] = x;
      }
    }
#pragma unroll
    for (int c = 0; c < KT; ++c) {
      if (c >= kt) continue;
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (g[j] < 0) continue;
        const long long e = static_cast<long long>(g[j]) * kt + c;
        if (MODE == MODE_PRIVATE) {
          acc[e * THREADS + tid] += v[c][j];
        } else if (MODE == MODE_SHARED) {
          atomic_add(&acc[rep * slice + e], v[c][j]);
        } else {
          atomic_add(&part[e], v[c][j]);
        }
      }
    }
  }
  if (MODE == MODE_GLOBAL) return;
  __syncthreads();
  for (long long e = tid; e < slice; e += THREADS) {
    T s = T(0);
    if (MODE == MODE_PRIVATE) {
      // rotated start: lanes read different banks; the order is fixed per e
      for (int i = 0; i < THREADS; ++i) s += acc[e * THREADS + ((i + e) & (THREADS - 1))];
    } else {
      for (int r = 0; r < REPL; ++r) s += acc[r * slice + e];
    }
    part[e] = s;
  }
}

template <typename T>
__global__ void groupagg_pass2(const T* __restrict__ partials, int blocks, long long slice,
                               int kt, T* __restrict__ out, int out_ld, int col0) {
  const long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= slice) return;
  T s = T(0);
  for (int b = 0; b < blocks; ++b) s += partials[b * slice + e];
  out[(e / kt) * out_ld + col0 + (e % kt)] = s;
}

template <typename T, int MODE, int KT>
int launch_pass1(const int* gids, const unsigned char* mask, const Cols<T>& cols, int kt,
                 long long n, int cap, int blocks, T* partials, cudaStream_t stream) {
  size_t smem = 0;
  if (MODE == MODE_PRIVATE) smem = sizeof(T) * static_cast<size_t>(cap) * kt * THREADS;
  if (MODE == MODE_SHARED) smem = sizeof(T) * static_cast<size_t>(cap) * kt * REPL;
  auto kern = groupagg_pass1<T, MODE, KT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<blocks, THREADS, smem, stream>>>(gids, mask, cols, kt, n, cap, partials);
  return cudaGetLastError();
}

template <typename T, int MODE>
int dispatch_kt(const int* gids, const unsigned char* mask, const Cols<T>& cols, int kt,
                long long n, int cap, int blocks, T* partials, cudaStream_t stream) {
  if (kt <= 1) return launch_pass1<T, MODE, 1>(gids, mask, cols, kt, n, cap, blocks, partials, stream);
  if (kt <= 4) return launch_pass1<T, MODE, 4>(gids, mask, cols, kt, n, cap, blocks, partials, stream);
  return launch_pass1<T, MODE, MAX_KT>(gids, mask, cols, kt, n, cap, blocks, partials, stream);
}

template <typename T>
int groupagg(const int* gids, const unsigned char* mask, const void* const* col_ptrs, int kt,
             long long n, int cap, int mode, int blocks, T* partials, T* out, int out_ld,
             int col0, cudaStream_t stream) {
  if (kt < 1 || kt > MAX_KT || cap < 1 || blocks < 1 || mode < 0 || mode > 2) {
    return cudaErrorInvalidValue;
  }
  Cols<T> cols;
  for (int c = 0; c < MAX_KT; ++c) cols.p[c] = c < kt ? static_cast<const T*>(col_ptrs[c]) : nullptr;
  int err;
  if (mode == MODE_PRIVATE) {
    err = dispatch_kt<T, MODE_PRIVATE>(gids, mask, cols, kt, n, cap, blocks, partials, stream);
  } else if (mode == MODE_SHARED) {
    err = dispatch_kt<T, MODE_SHARED>(gids, mask, cols, kt, n, cap, blocks, partials, stream);
  } else {
    err = dispatch_kt<T, MODE_GLOBAL>(gids, mask, cols, kt, n, cap, blocks, partials, stream);
  }
  if (err != cudaSuccess) return err;
  const long long slice = static_cast<long long>(cap) * kt;
  const int t2 = 256;
  const long long b2 = (slice + t2 - 1) / t2;
  groupagg_pass2<T><<<static_cast<unsigned>(b2), t2, 0, stream>>>(partials, blocks, slice, kt, out,
                                                                out_ld, col0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[g, col0 + c] = sum of col_ptrs[c][r] over rows r with mask[r] and
// gids[r] == g, for c < kt. `out` is (cap, out_ld) row-major; `partials`
// holds blocks * cap * kt elements of scratch. Returns a cudaError_t.
int groupagg_sums_f64(const int* gids, const unsigned char* mask, const void* const* col_ptrs,
                      int kt, long long n, int cap, int mode, int blocks, double* partials,
                      double* out, int out_ld, int col0, void* stream) {
  return groupagg<double>(gids, mask, col_ptrs, kt, n, cap, mode, blocks, partials, out, out_ld,
                          col0, static_cast<cudaStream_t>(stream));
}

int groupagg_sums_i64(const int* gids, const unsigned char* mask, const void* const* col_ptrs,
                      int kt, long long n, int cap, int mode, int blocks, long long* partials,
                      long long* out, int out_ld, int col0, void* stream) {
  return groupagg<long long>(gids, mask, col_ptrs, kt, n, cap, mode, blocks, partials, out,
                             out_ld, col0, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
