// K2: stable stream compaction of k columns by one row mask.
//
// Replaces the TPU kernel polars_tpu/kernels/pallas_compact.py
// `_compact_kernel` (launched by `compact_columns_pallas` through
// `_call_compact`), which built prefix sums as tril-ones matmuls, permuted
// rows with one-hot matmuls, carried a 128-aligned DMA window between grid
// steps and split f64 into hi/lo f32 halves (not exact for i64). None of that
// carries over: this kernel moves raw bits of 1-, 2-, 4- and 8-byte payloads,
// so every dtype (f64, i64, int32 codes, dates, bool validity) is bit-exact.
//
// What bounds it on an H100: bytes. It reads the mask and the surviving
// values once and writes the survivors once; the arithmetic is a popcount
// per 32 rows. The design keeps the mask off the per-column path:
//   1. compact_count_kernel: each block counts the survivors of its tile of
//      TILE rows (warp ballot + popc);
//   2. compact_scan_kernel: one block turns the block counts into exclusive
//      offsets and the total (read back by the caller to size the outputs);
//   3. compact_scatter_kernel: each block re-ranks its survivors with warp
//      ballot/popc, keeps the destinations in registers, and then moves every
//      column of the segment in the same pass.
// The mask is read twice per segment, never once per column.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C ABI,
// loaded with ctypes by polars_tpu_torch/kernels/compact.py).

#include <cuda_runtime.h>

namespace {

constexpr int CT = 256;                 // threads per block
constexpr int WARPS = CT / 32;
constexpr int ROUNDS = 16;              // 32-row rounds per warp
constexpr int TILE = CT * ROUNDS;       // rows per block
constexpr int MAXC = 32;                // columns per scatter launch
constexpr unsigned FULL = 0xffffffffu;

struct ColSet {
  const void* in[MAXC];
  void* out[MAXC];
  int size[MAXC];
};

__device__ __forceinline__ long long tile_row(int warp, int r, int lane) {
  return static_cast<long long>(blockIdx.x) * TILE + warp * (32 * ROUNDS) + r * 32 + lane;
}

__global__ void __launch_bounds__(CT)
compact_count_kernel(const unsigned char* __restrict__ mask, long long n,
                     long long* __restrict__ block_counts) {
  __shared__ int warp_counts[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long row = tile_row(warp, r, lane);
    const bool m = row < n && mask[row];
    cnt += __popc(__ballot_sync(FULL, m));
  }
  if (lane == 0) warp_counts[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < WARPS; ++w) s += warp_counts[w];
    block_counts[blockIdx.x] = s;
  }
}

// In-place exclusive scan of offs[0, nb); writes the total to offs[nb].
__global__ void __launch_bounds__(1024) compact_scan_kernel(long long* offs, long long nb) {
  __shared__ long long sums[1024];
  const int tid = threadIdx.x;
  const long long per = (nb + 1023) / 1024;
  const long long lo = tid * per;
  const long long hi = lo + per < nb ? lo + per : nb;
  long long s = 0;
  for (long long i = lo; i < hi; ++i) s += offs[i];
  sums[tid] = s;
  __syncthreads();
  for (int d = 1; d < 1024; d <<= 1) {  // Hillis-Steele inclusive scan
    const long long add = tid >= d ? sums[tid - d] : 0;
    __syncthreads();
    sums[tid] += add;
    __syncthreads();
  }
  long long run = sums[tid] - s;
  for (long long i = lo; i < hi; ++i) {
    const long long v = offs[i];
    offs[i] = run;
    run += v;
  }
  if (tid == 1023) offs[nb] = sums[1023];
}

template <typename W>
__device__ __forceinline__ void move_column(const void* in_v, void* out_v, const long long (&dst)[ROUNDS],
                                            int warp, int lane) {
  const W* __restrict__ in = static_cast<const W*>(in_v);
  W* __restrict__ out = static_cast<W*>(out_v);
  W v[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (dst[r] >= 0) v[r] = in[tile_row(warp, r, lane)];
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (dst[r] >= 0) out[dst[r]] = v[r];
  }
}

__global__ void __launch_bounds__(CT)
compact_scatter_kernel(const unsigned char* __restrict__ mask, long long n,
                       const long long* __restrict__ offs, ColSet cols, int k) {
  __shared__ long long warp_offs[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned bal[ROUNDS];
  int cnt = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const long long row = tile_row(warp, r, lane);
    const bool m = row < n && mask[row];
    bal[r] = __ballot_sync(FULL, m);
    cnt += __popc(bal[r]);
  }
  if (lane == 0) warp_offs[warp] = cnt;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long s = 0;
    for (int w = 0; w < WARPS; ++w) {
      const long long c = warp_offs[w];
      warp_offs[w] = s;
      s += c;
    }
  }
  __syncthreads();
  const long long base = offs[blockIdx.x] + warp_offs[warp];
  const unsigned lt = (1u << lane) - 1u;
  long long dst[ROUNDS];
  int run = 0;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    dst[r] = ((bal[r] >> lane) & 1u) ? base + run + __popc(bal[r] & lt) : -1;
    run += __popc(bal[r]);
  }
  for (int c = 0; c < k; ++c) {
    switch (cols.size[c]) {
      case 8: move_column<unsigned long long>(cols.in[c], cols.out[c], dst, warp, lane); break;
      case 4: move_column<unsigned int>(cols.in[c], cols.out[c], dst, warp, lane); break;
      case 2: move_column<unsigned short>(cols.in[c], cols.out[c], dst, warp, lane); break;
      default: move_column<unsigned char>(cols.in[c], cols.out[c], dst, warp, lane); break;
    }
  }
}

}  // namespace

extern "C" {

// Rows per block; the caller allocates blocks(n) + 1 offsets.
long long compact_tile_rows() { return TILE; }

// Passes 1 and 2: offs[b] = survivors before block b, offs[nb] = total.
int compact_count(const unsigned char* mask, long long n, long long* offs, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + TILE - 1) / TILE;
  if (nb > 0) compact_count_kernel<<<static_cast<unsigned>(nb), CT, 0, s>>>(mask, n, offs);
  compact_scan_kernel<<<1, 1024, 0, s>>>(offs, nb);
  return cudaGetLastError();
}

// Pass 3: out[c][offs-rank] = in[c][row] for every surviving row, for the
// k columns whose element sizes are 1, 2, 4 or 8 bytes.
int compact_scatter(const unsigned char* mask, long long n, const long long* offs, int k,
                    const void* const* in, void* const* out, const int* sizes, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nb = (n + TILE - 1) / TILE;
  for (int c0 = 0; c0 < k; c0 += MAXC) {
    const int kc = k - c0 < MAXC ? k - c0 : MAXC;
    ColSet cols;
    for (int c = 0; c < MAXC; ++c) {
      const bool live = c < kc;
      cols.in[c] = live ? in[c0 + c] : nullptr;
      cols.out[c] = live ? out[c0 + c] : nullptr;
      cols.size[c] = live ? sizes[c0 + c] : 1;
      if (live && sizes[c0 + c] != 1 && sizes[c0 + c] != 2 && sizes[c0 + c] != 4 &&
          sizes[c0 + c] != 8) {
        return cudaErrorInvalidValue;
      }
    }
    if (nb > 0) compact_scatter_kernel<<<static_cast<unsigned>(nb), CT, 0, s>>>(mask, n, offs, cols, kc);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
