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
// What bounds it on an H100: bytes. It must read every mask byte and the
// surviving values once and write the survivors once; the arithmetic is a
// popcount per 32 rows. At a segment end with few survivors (a 60M-slot
// result holding 10 rows) the bound is the mask alone, about 18 us, so fixed
// passes and host round trips are what cost; with many survivors the column
// moves are. Rows fall in chunks of CHUNK = 512 (one warp, one 16-byte mask
// load a lane), each with one offset. Two launches per compaction, split by
// the caller's one host read of the total (which sizes the outputs and
// carries the segment's validation flags):
//   1. compact_count_kernel counts AND scans in one pass, with decoupled
//      look-back (Merrill & Garland, "Single-pass Parallel Prefix Scan with
//      Decoupled Look-back", 2016), over tiles of 128 chunks. A block takes
//      its tile from an atomic ticket (CUDA does not start blocks in order,
//      and looking back at a tile no block has taken yet could spin
//      forever), counts each chunk's survivors from 16-byte mask loads,
//      publishes the tile's count in its 64-bit status word (2-bit state +
//      value, release store), then the whole block reads its predecessors'
//      words CT at a time (acquire loads) down to the nearest inclusive
//      prefix, so a wave of tiles that finish together settles in a few
//      windows. It writes its chunks' offsets, and the last tile the total.
//      The status words and the ticket are zeroed on the stream before every
//      launch (a single tile uses neither). No pass runs on one SM alone.
//   2. compact_scatter_kernel: a block takes 8 chunks, a warp one (32 and
//      four where under one row in 64 survives), with no barrier. Chunks
//      whose two offsets are equal hold no survivor and read no mask byte
//      (nor does a block whose chunks are all empty). Any other chunk is
//      re-ranked from 16-byte mask loads (shuffles rebuild the warp ballots,
//      popc ranks each survivor into a register), and every column of the
//      segment moves in the same pass, 16 loads in flight a thread,
//      coalesced, 8-byte columns first, then 4, 2 and 1.
// A mask that does not start on a 16-byte boundary (a view with a storage
// offset) and the ragged end of the last chunk take the byte path inside the
// kernel; no vector load is ever misaligned.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -shared (plain C ABI,
// loaded with ctypes by polars_tpu_torch/kernels/compact.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <vector>

namespace {

constexpr int CT = 256;                        // threads per block
constexpr int WARPS = CT / 32;
constexpr int VEC = 16;                        // mask bytes per thread and load
constexpr int CHUNK = 32 * VEC;                // rows per chunk: one warp, one 16-byte load a lane; one offset
constexpr int ROUNDS = VEC;                    // 32-row rounds per chunk
constexpr int COUNT_LOADS = 16;                // mask loads per thread of a count tile
constexpr int TILE_CHUNKS = WARPS * COUNT_LOADS;  // chunks per count tile (128)
constexpr int TILE = TILE_CHUNKS * CHUNK;      // rows per count tile (65536): one status word
constexpr int MAXC = 32;                       // columns per scatter launch
constexpr unsigned FULL = 0xffffffffu;
constexpr unsigned long long ST_AGGREGATE = 1ull << 62;  // value = this tile's count
constexpr unsigned long long ST_INCLUSIVE = 2ull << 62;  // value = count of tiles 0..this
constexpr unsigned long long ST_VALUE = (1ull << 62) - 1;

// Up to MAXC columns, ordered by element size: [0, end[0]) move 8 bytes a
// row, [end[0], end[1]) 4, [end[1], end[2]) 2, [end[2], end[3]) 1, one loop
// per size and no switch inside a loop.
struct ColSet {
  const void* in[MAXC];
  void* out[MAXC];
  int end[4];
};

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Bit b of the result is set when byte b of w is nonzero (b = 0..3).
__device__ __forceinline__ unsigned nonzero4(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

// Mask rows [g, g + 16) as a bitmap (bit b: row g + b survives); rows at or
// past n read as false. One 16-byte load where the mask is aligned and the
// whole group lies inside it, else byte loads.
__device__ __forceinline__ unsigned mask_bits16(const unsigned char* __restrict__ mask, long long n, long long g,
                                                bool vec) {
  if (vec && g + VEC <= n) {
    const uint4 w = *reinterpret_cast<const uint4*>(mask + g);
    return nonzero4(w.x) | nonzero4(w.y) << 4 | nonzero4(w.z) << 8 | nonzero4(w.w) << 12;
  }
  unsigned bits = 0;
  for (int b = 0; b < VEC; ++b) {
    if (g + b < n && mask[g + b]) bits |= 1u << b;
  }
  return bits;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// Survivors in the tiles before tile t > 0: the whole block reads the status
// words of the CT tiles before `j` at once (thread i: tile j - i), waits for
// each to hold a count, and sums them down to the nearest inclusive prefix;
// without one, the next CT tiles (tile 0 always publishes one).
__device__ long long look_back(const unsigned long long* status, long long t, int* stop_w, long long* red) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  long long excl = 0;
  for (long long j = t - 1;; j -= CT) {
    const long long p = j - tid;
    unsigned long long st = ST_INCLUSIVE;
    if (p >= 0) {
      do {
        st = load_acquire(status + p);
      } while ((st & ~ST_VALUE) == 0);
    }
    const unsigned incl = __ballot_sync(FULL, (st & ~ST_VALUE) == ST_INCLUSIVE);
    if (lane == 0) stop_w[warp] = incl ? warp * 32 + __ffs(incl) - 1 : CT;
    __syncthreads();
    int stop = CT;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) stop = min(stop, stop_w[w]);
    const long long part = warp_sum(tid <= stop ? static_cast<long long>(st & ST_VALUE) : 0);
    if (lane == 0) red[warp] = part;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < WARPS; ++w) excl += red[w];
    __syncthreads();  // stop_w and red are written again by the next window
    if (stop < CT) return excl;
  }
}

// One count tile: its chunks' survivor counts, their offsets within the
// tile, its aggregate published, the look-back, its chunks' offsets.
__global__ void __launch_bounds__(CT, 4)
compact_count_kernel(const unsigned char* __restrict__ mask, long long n, long long nt, long long nc,
                     unsigned long long* status, unsigned* ticket, long long* __restrict__ offs) {
  __shared__ long long tile_s;
  __shared__ int chunk_off[TILE_CHUNKS];
  __shared__ int warp_part[TILE_CHUNKS / 32];
  __shared__ int stop_w[WARPS];
  __shared__ long long red[WARPS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) tile_s = nt == 1 ? 0 : atomicAdd(ticket, 1u);
  __syncthreads();
  const long long t = tile_s;
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & (VEC - 1)) == 0;
  // load s of warp w covers chunk s * WARPS + w of the tile
  unsigned bits[COUNT_LOADS];
#pragma unroll
  for (int s = 0; s < COUNT_LOADS; ++s) bits[s] = mask_bits16(mask, n, t * TILE + (s * WARPS + warp) * CHUNK + lane * VEC, vec);
#pragma unroll
  for (int s = 0; s < COUNT_LOADS; ++s) {
    const unsigned c = __reduce_add_sync(FULL, static_cast<unsigned>(__popc(bits[s])));
    if (lane == 0) chunk_off[s * WARPS + warp] = static_cast<int>(c);
  }
  __syncthreads();
  // exclusive scan of the tile's chunk counts, one per thread of warps 0-3
  int mine = 0, incl = 0;
  if (tid < TILE_CHUNKS) {
    mine = incl = chunk_off[tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int up = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += up;
    }
    if (lane == 31) warp_part[warp] = incl;
  }
  __syncthreads();
  int agg = 0, before = 0;
#pragma unroll
  for (int w = 0; w < TILE_CHUNKS / 32; ++w) {
    agg += warp_part[w];
    before += w < warp ? warp_part[w] : 0;
  }
  long long excl = 0;
  if (t > 0) {
    if (tid == 0) store_release(status + t, ST_AGGREGATE | static_cast<unsigned long long>(agg));
    excl = look_back(status, t, stop_w, red);
  }
  if (tid == 0 && nt > 1) store_release(status + t, ST_INCLUSIVE | static_cast<unsigned long long>(excl + agg));
  const long long c = t * TILE_CHUNKS + tid;
  if (tid < TILE_CHUNKS && c < nc) offs[c] = excl + before + incl - mine;
  if (tid == 0 && t == nt - 1) offs[nc] = excl + agg;
}

// Moves one column's survivors of a chunk: round r's row is row0 + 32 r,
// its destination out[base + rank[r]] (rank -1: dropped). The empty asm
// makes the ranks opaque to the compiler, which would otherwise hoist every
// round's scaled destination offset, for every element size, out of the
// column loops and run out of registers (16 loads in flight a thread need
// 2 blocks of 256 threads an SM within 128 registers).
template <typename W>
__device__ __forceinline__ void move_column(const void* in_v, void* out_v, long long row0, long long base,
                                            int (&rank)[ROUNDS]) {
  const W* __restrict__ in = static_cast<const W*>(in_v) + row0;
  W* __restrict__ out = static_cast<W*>(out_v) + base;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) asm volatile("" : "+r"(rank[r]));
  W v[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (rank[r] >= 0) v[r] = in[32 * r];
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (rank[r] >= 0) out[rank[r]] = v[r];
  }
}

// WARPS * WC chunks; each warp takes WC of them, independently (no
// barrier). WC = 4 when few rows survive (a quarter of the blocks to launch,
// most of which only read two offsets), 1 otherwise (more blocks in flight).
template <int WC>
__global__ void __launch_bounds__(CT, 2)
compact_scatter_kernel(const unsigned char* __restrict__ mask, long long n, long long nc,
                       const long long* __restrict__ offs, ColSet cols) {
  constexpr int BLOCK_CHUNKS = WARPS * WC;
  const long long c0 = static_cast<long long>(blockIdx.x) * BLOCK_CHUNKS;
  const long long c_end = c0 + BLOCK_CHUNKS < nc ? c0 + BLOCK_CHUNKS : nc;
  if (offs[c0] == offs[c_end]) return;  // no survivor in the block's chunks
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(mask) & (VEC - 1)) == 0;
  const unsigned lt = (1u << lane) - 1u;
  for (long long c = c0 + warp; c < c_end; c += WARPS) {
    const long long base = offs[c];
    if (offs[c + 1] == base) continue;  // no survivor in this chunk
    // lane i holds rows 16 i + b of the chunk; round r covers rows 32 r + i,
    // held by lanes 2r (i < 16) and 2r + 1
    const unsigned bits = mask_bits16(mask, n, c * CHUNK + lane * VEC, vec);
    int rank[ROUNDS];
    int run = 0;
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const unsigned bal = __shfl_sync(FULL, bits, 2 * r) | __shfl_sync(FULL, bits, 2 * r + 1) << 16;
      rank[r] = ((bal >> lane) & 1u) ? run + __popc(bal & lt) : -1;
      run += __popc(bal);
    }
    const long long row0 = c * CHUNK + lane;
    int col = 0;
    for (; col < cols.end[0]; ++col) move_column<unsigned long long>(cols.in[col], cols.out[col], row0, base, rank);
    for (; col < cols.end[1]; ++col) move_column<unsigned int>(cols.in[col], cols.out[col], row0, base, rank);
    for (; col < cols.end[2]; ++col) move_column<unsigned short>(cols.in[col], cols.out[col], row0, base, rank);
    for (; col < cols.end[3]; ++col) move_column<unsigned char>(cols.in[col], cols.out[col], row0, base, rank);
  }
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// Rows per chunk (one offset each) and per count tile (one status word each).
long long compact_chunk_rows() { return CHUNK; }
long long compact_tile_rows() { return TILE; }

// The fused count and scan over n rows: chunks = ceil(n / CHUNK) offsets and
// the total, from tiles = ceil(n / TILE) blocks. `scratch` holds chunks +
// tiles + 2 64-bit words: offs[chunks + 1] (offs[c] = survivors before chunk
// c, offs[chunks] = the total), one status word per tile, the ticket. Zeroes
// the status words and the ticket on the stream (not for a single tile,
// which needs neither), then launches; never synchronises.
int compact_count(const unsigned char* mask, long long n, long long* scratch, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nc = cdiv(n, CHUNK), nt = cdiv(n, TILE);
  if (nt == 0) return cudaMemsetAsync(scratch, 0, sizeof(long long), s);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(scratch + nc + 1);
  if (nt > 1) {
    const cudaError_t err = cudaMemsetAsync(status, 0, (nt + 1) * sizeof(unsigned long long), s);
    if (err != cudaSuccess) return err;
  }
  compact_count_kernel<<<static_cast<unsigned>(nt), CT, 0, s>>>(mask, n, nt, nc, status,
                                                                 reinterpret_cast<unsigned*>(status + nt), scratch);
  return cudaGetLastError();
}

// out[c][offs-rank] = in[c][row] for every surviving row; `count` is the
// total. `cols_desc` holds 3k words: the k input pointers, the k output
// pointers, the k element sizes (1, 2, 4 or 8 bytes). Columns go MAXC to a
// launch, by size.
int compact_scatter(const unsigned char* mask, long long n, const long long* offs, long long count, int k,
                    const unsigned long long* cols_desc, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long nc = cdiv(n, CHUNK);
  const bool sparse = count * 64 < n;  // under one row in 64 survives
  const long long blocks = cdiv(nc, WARPS * (sparse ? 4 : 1));
  for (int c = 0; c < k; ++c) {
    const unsigned long long size = cols_desc[2 * k + c];
    if (size != 1 && size != 2 && size != 4 && size != 8) return cudaErrorInvalidValue;
  }
  std::vector<int> order;  // the columns by element size, 8 bytes first
  order.reserve(k);
  for (unsigned long long size = 8; size >= 1; size >>= 1) {
    for (int c = 0; c < k; ++c) {
      if (cols_desc[2 * k + c] == size) order.push_back(c);
    }
  }
  for (int c0 = 0; c0 < k; c0 += MAXC) {
    const int kc = k - c0 < MAXC ? k - c0 : MAXC;
    ColSet cols = {};
    for (int i = 0; i < kc; ++i) {
      const int c = order[c0 + i];
      cols.in[i] = reinterpret_cast<const void*>(cols_desc[c]);
      cols.out[i] = reinterpret_cast<void*>(cols_desc[k + c]);
      for (int b = 0; b < 4; ++b) {
        if (cols_desc[2 * k + c] >= (8ull >> b)) cols.end[b] = i + 1;
      }
    }
    if (blocks > 0 && sparse) {
      compact_scatter_kernel<4><<<static_cast<unsigned>(blocks), CT, 0, s>>>(mask, n, nc, offs, cols);
    } else if (blocks > 0) {
      compact_scatter_kernel<1><<<static_cast<unsigned>(blocks), CT, 0, s>>>(mask, n, nc, offs, cols);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // extern "C"
