// Reproducible GROUPBY (segment RSUM, paper §V) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_rsum/kernel.py::_segment_kernel
// (launcher segment_rsum_pallas_call), the TPU kernel that contracts the
// extracted contributions with a one-hot of the group ids on the MXU.
//
// What bounds it on an H100: at small G it streams the rows once (4 bytes of
// id + 4 bytes per accumulator column), so device-memory bandwidth bounds it
// (3.35 TB/s).  What kept an atomic design from that bound: each row's
// ncols * nlev integer contributions went into a shared table with atomics,
// and with few groups the lanes of a warp hit the same few addresses (up to
// 8-way serialization at 4 groups); rows were read as scalar 4-byte loads,
// one row in flight per thread.  At large G the table no longer fits one
// block's shared memory: the rows are partitioned by group tile first, and
// writing the (G, ncols, nlev) int32 table itself is a large part of the
// bound (3.2 GB for a 64,128 x 3,072 vocabulary shard at two levels).
//
// Design: two paths, chosen by the wrapper from the size of the table
// E = G * ncols * nlev (segment_rsum/ops.py::launch_shape):
// * private (small E, ncols <= 8, nlev <= 4; the main path): every thread
//   owns a private int32 slice of the table in shared memory, laid out
//   [entry][thread] so that the lanes of a warp always touch 32 distinct
//   banks.  Updates are plain ld.shared/st.shared adds: no atomics.  Each
//   warp streams chunks of 128 contiguous rows (128 * ncols floats and 128
//   ids) into a double buffer in shared memory with 16-byte cp.async
//   copies, each instruction 512 contiguous bytes, the next chunk in flight
//   while the lanes sum this one, four rows a lane.  (A lane loading its
//   own four rows as float4 straight from memory would issue loads 16 *
//   ncols bytes apart across the warp, each 32-byte sector fetched for half
//   its bytes.)  NLEV and NC are template parameters: the ladder sits in
//   registers and every loop unrolls.  A thread flushes its slice into the
//   block's int64 table before its int32 entries could overflow
//   (flush_rows * 2^(W-1) <= 2^30); at the end the warps fold the slices
//   with exact int64 adds.  A ragged last chunk or an input not 16-byte
//   aligned takes scalar loads;
// * tiled (any other E): the table is cut into group tiles that fit a
//   block's shared memory, int32 (k, C) tables with one copy per warp as
//   far as they fit, so lanes contend only within their warp.  A warp
//   whose 32 rows all carry one group of the tile (sorted or clustered
//   input) sums each contribution with __reduce_add_sync (|sum| <= 32 *
//   2^(W-1) fits int32) and adds it with one atomicAdd; any other warp
//   adds lane by lane.  (Grouping the lanes with __match_any_sync instead
//   costs a match per row even when every lane has its own group, the
//   common case for unsorted input.)
//   - one tile (all G groups fit a block): grid = row slabs, each block
//     sums its slab (segment_tiled);
//   - several tiles: partition, then aggregate (the paper's
//     PartitionAndAggregate, §V-B), so that a launch reads each row a
//     fixed number of times whatever G: the ids at most five times and
//     the values twice (the input's, then the copy's), and writes each
//     row's copy once (rows already in tile order: the ids twice, the
//     values once, nothing copied), where a (tiles x slabs) grid read the
//     ids once per tile.  partition_count counts the rows of each tile
//     (id / tile; padding and ids outside [0, G) are dropped) in a
//     shared-memory histogram, and notes whether the rows already come in
//     tile order with none dropped; partition_scan (one block) scans the
//     counts into bucket offsets and a work list of (tile, chunk of <=
//     chunk_rows of its bucket) items, at least one item a tile, and maps
//     each item to its tile; partition_scatter, unless the rows already
//     come in tile order (then the buckets are ranges of the input and it
//     returns at once), claims each block's slots in a bucket with one
//     atomic per (block, tile) and copies each row's id and values there
//     (order inside a bucket is free: the sums are exact integers).  Rows
//     of fewer than 32 columns are staged in tile order in shared memory,
//     up to 8,192 at a time, and each tile's run of them is written
//     together: written straight to its slot, each row lands alone in its
//     bucket and each store is a partly written sector (several times
//     slower at permuted Q18 on an H100).  With more tiles than staged
//     rows the rows go straight to their slots; with more tiles than a
//     block's shared histogram holds (4 bytes a tile) the counts and
//     claims go to the global counters.  Slots are 32-bit: a launch over
//     several tiles takes fewer than 2^31 rows.  segment_partitioned, a
//     persistent grid,
//     walks the work list: an empty tile writes its zeros and reads no
//     rows; a tile of one item sums its rows in shared memory and writes
//     its canonical (k, C) straight away; a tile split over several items
//     (a hot key) writes one int64 partial per item, and the item that
//     finishes last adds them and writes the tile.  No (slabs x G) array
//     exists on this path.  Rows of fewer than 32 columns go a thread per
//     row, four rows in flight; wider rows a warp per row with the lanes
//     over the columns (coalesced loads, distinct banks).
// Every path renormalizes or flushes before int32 can overflow.  The
// private path and the one-tile case write each slab's exact int64 sums T
// in (G, ncols, nlev) order, and a second kernel on the same stream adds
// the slabs; every path ends in the canonical int32 split k = T mod
// 2^(m-2), C = T >> (m-2).  Integer addition is exact and associative and
// the split is unique, so the bits are those of any sequential order.  Per
// row and level: q = (r + A) - A, r -= q with __fadd_rn/__fsub_rn,
// k = __float2int_rz(q * 2^(m - e)), an exact integer.
// The f32 one-hot contraction of the TPU kernel, and its 128-row bound,
// existed to use the MXU and are not carried over.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kPrivateThreads = 256;

__device__ __forceinline__ int extract(float& r, float a, float s) {
  const float q = __fsub_rn(__fadd_rn(r, a), a);
  r = __fsub_rn(r, q);
  return __float2int_rz(__fmul_rn(q, s));
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// ---------------------------------------------------------------------------
// private path
// ---------------------------------------------------------------------------

// cp.async: 16-byte copies from global to shared memory that bypass the
// registers and complete in commit groups.
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void commit_async() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int PENDING>
__device__ __forceinline__ void wait_async() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

// Adds four rows (ids g, values v[row][column]) to a thread's slice.
template <int NLEV, int NC>
__device__ __forceinline__ void add_rows(int* mine, const int (&g)[4],
                                         const float (&v)[4 * NC],
                                         const float (&a)[NC][NLEV],
                                         const float (&s)[NC][NLEV],
                                         int num_segments) {
  constexpr int NT = kPrivateThreads;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    // padding ids (-1), ids past G and rows past the slab fall outside [0, G)
    if (static_cast<unsigned>(g[rr]) < static_cast<unsigned>(num_segments)) {
      int* e = mine + g[rr] * NC * NLEV * NT;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float r = v[rr * NC + c];
#pragma unroll
        for (int l = 0; l < NLEV; ++l) {
          e[(c * NLEV + l) * NT] += extract(r, a[c][l], s[c][l]);
        }
      }
    }
  }
}

// Moves a thread's slice into the block's int64 table (before int32 could
// overflow).
__device__ __forceinline__ void flush(int* mine, long long* blk, int ent) {
  for (int e = 0; e < ent; ++e) {
    const int v = mine[e * kPrivateThreads];
    atomicAdd(reinterpret_cast<unsigned long long*>(&blk[e]),
              static_cast<unsigned long long>(static_cast<long long>(v)));
    mine[e * kPrivateThreads] = 0;
  }
}

// Shared memory: blk int64 [ent], slices int32 [ent][NT], then, 16-byte
// aligned, two chunk buffers per warp of STAGE float4 (rows, then ids).
template <int NLEV, int NC>
__global__ void __launch_bounds__(kPrivateThreads) segment_private(
    const int* __restrict__ ids, const float* __restrict__ x,
    const float* __restrict__ A, const float* __restrict__ inv_ulp,
    long long* __restrict__ part, long long n, int num_segments,
    long long rows_per_slab, int flush_rows, int vec) {
  constexpr int NT = kPrivateThreads;
  constexpr int NW = NT / 32;
  constexpr int CHUNK = 128;                 // rows per warp chunk, 4 a lane
  constexpr int STAGE = 32 * NC + 32;        // float4 of one chunk
  extern __shared__ long long smem64[];
  const int ent = num_segments * NC * NLEV;
  long long* blk = smem64;
  int* priv = reinterpret_cast<int*>(smem64 + ent);
  const size_t table_bytes =
      (static_cast<size_t>(ent) * (8 + 4 * NT) + 15) / 16 * 16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float4* stage = reinterpret_cast<float4*>(
                      reinterpret_cast<char*>(smem64) + table_bytes) +
                  warp * 2 * STAGE;
  for (int i = tid; i < ent; i += NT) blk[i] = 0;
  for (int i = tid; i < ent * NT; i += NT) priv[i] = 0;

  float a[NC][NLEV], s[NC][NLEV];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int l = 0; l < NLEV; ++l) {
      a[c][l] = A[l * NC + c];
      s[c][l] = inv_ulp[l * NC + c];
    }
  }
  __syncthreads();

  int* mine = priv + tid;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_slab;
  const long long r1 = min(n, r0 + rows_per_slab);
  int walked = 0;                    // rows since this thread's last flush

  // whole chunks: warp w takes chunks w, w + NW, ...; the next chunk's
  // copies are in flight while this one is summed
  const long long chunks = vec ? (r1 - r0) / CHUNK : 0;
  auto fetch = [&](long long ch, float4* buf) {
    const long long c0 = r0 + ch * CHUNK;
    const float4* xs = reinterpret_cast<const float4*>(x + c0 * NC);
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      copy16_async(buf + q * 32 + lane, xs + q * 32 + lane);
    }
    copy16_async(buf + 32 * NC + lane,
                 reinterpret_cast<const float4*>(ids + c0) + lane);
  };
  if (warp < chunks) fetch(warp, stage);
  commit_async();
  int cur = 0;
  for (long long ch = warp; ch < chunks; ch += NW) {
    if (walked + 4 > flush_rows) {
      flush(mine, blk, ent);
      walked = 0;
    }
    walked += 4;
    if (ch + NW < chunks) fetch(ch + NW, stage + (cur ^ 1) * STAGE);
    commit_async();
    wait_async<1>();                 // this chunk's copies have landed
    __syncwarp();
    const float4* buf = stage + cur * STAGE;
    int g[4];
    float v[4 * NC];                 // lane's rows 4 lane .. 4 lane + 3
    const int4 gi = reinterpret_cast<const int4*>(buf + 32 * NC)[lane];
    g[0] = gi.x; g[1] = gi.y; g[2] = gi.z; g[3] = gi.w;
#pragma unroll
    for (int q = 0; q < NC; ++q) {
      const float4 f = buf[lane * NC + q];
      v[4 * q] = f.x; v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
    __syncwarp();                    // the buffer may be refilled
    cur ^= 1;
    add_rows<NLEV, NC>(mine, g, v, a, s, num_segments);
  }
  wait_async<0>();

  // the rest (a ragged last chunk, or an unaligned input): four rows a
  // thread, scalar loads
  for (long long row = r0 + chunks * CHUNK + 4LL * tid; row < r1;
       row += 4LL * NT) {
    if (walked + 4 > flush_rows) {
      flush(mine, blk, ent);
      walked = 0;
    }
    walked += 4;
    int g[4];
    float v[4 * NC];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const bool in = row + rr < r1;
      g[rr] = in ? ids[row + rr] : -1;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        v[rr * NC + c] = in ? x[(row + rr) * NC + c] : 0.0f;
      }
    }
    add_rows<NLEV, NC>(mine, g, v, a, s, num_segments);
  }
  __syncthreads();

  // fold: warp w sums the slices of entries w, w + NW, ... exactly in int64
  for (int e = warp; e < ent; e += NW) {
    long long sum = 0;
#pragma unroll
    for (int j = 0; j < NW; ++j) sum += priv[e * NT + j * 32 + lane];
    sum = warp_sum(sum);
    if (lane == 0) part[static_cast<long long>(blockIdx.x) * ent + e] =
        sum + blk[e];
  }
}

// ---------------------------------------------------------------------------
// tiled path (every table the private path does not take)
// ---------------------------------------------------------------------------

// Shared memory: int32 k and C tables of `replicas` copies of one group
// tile (warp w adds to copy w % replicas), then the ladder.
template <int NLEV>
__global__ void segment_tiled(
    const int* __restrict__ ids, const float* __restrict__ x,
    const float* __restrict__ A, const float* __restrict__ inv_ulp,
    long long* __restrict__ part, long long n, int ncols, int m,
    int num_segments, int tile, int replicas, long long rows_per_slab,
    int renorm_rows) {
  extern __shared__ int smem[];
  const int lc_count = NLEV * ncols;
  const int ent = lc_count * tile;                 // entries of one copy
  int* sk = smem;                                  // [replicas][ent]
  int* sc = smem + replicas * ent;                 // [replicas][ent]
  float* sA = reinterpret_cast<float*>(sc + replicas * ent);  // [NLEV][ncols]
  float* sI = sA + lc_count;                                  // [NLEV][ncols]

  const int g0 = blockIdx.x * tile;
  const int gt = min(tile, num_segments - g0);     // groups of this tile
  const long long slab = blockIdx.y;
  const long long r0 = slab * rows_per_slab;
  const long long r1 = min(n, r0 + rows_per_slab);
  const int shift = m - 2;
  const int mask = (1 << shift) - 1;
  const int lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < 2 * replicas * ent; i += blockDim.x) {
    smem[i] = 0;
  }
  for (int i = threadIdx.x; i < lc_count; i += blockDim.x) {
    sA[i] = A[i];
    sI[i] = inv_ulp[i];
  }
  __syncthreads();

  int* my_k = sk + ((threadIdx.x >> 5) % replicas) * ent;
  int walked = 0;               // rows walked since the last renorm (uniform)
  for (long long base = r0; base < r1; base += blockDim.x) {
    const long long row = base + threadIdx.x;
    // padding ids (-1), ids of other tiles and rows past the slab: -1
    int g = row < r1 ? ids[row] - g0 : -1;
    if (static_cast<unsigned>(g) >= static_cast<unsigned>(gt)) g = -1;
    const int gw = __shfl_sync(0xffffffffu, g, 0);
    const bool uniform = __all_sync(0xffffffffu, g == gw);
    if (!uniform || gw >= 0) {
      const float* xr = x + row * ncols;
      for (int c = 0; c < ncols; ++c) {
        float r = g >= 0 ? xr[c] : 0.0f;
#pragma unroll
        for (int l = 0; l < NLEV; ++l) {
          int k = extract(r, sA[l * ncols + c], sI[l * ncols + c]);
          int* e = my_k + (l * ncols + c) * tile;
          if (uniform) {        // the whole warp on one group: one add
            k = __reduce_add_sync(0xffffffffu, k);
            if (lane == 0) atomicAdd(e + gw, k);
          } else if (g >= 0 && k != 0) {
            atomicAdd(e + g, k);
          }
        }
      }
    }
    walked += blockDim.x;
    if (walked + static_cast<int>(blockDim.x) > renorm_rows) {
      __syncthreads();
      for (int i = threadIdx.x; i < replicas * ent; i += blockDim.x) {
        const int k = sk[i];
        sk[i] = k & mask;
        sc[i] += k >> shift;     // arithmetic shift: floor division
      }
      __syncthreads();
      walked = 0;
    }
  }
  __syncthreads();

  // fold the copies; part[slab][g][c][l] for the tile's groups
  const long long total_ent = static_cast<long long>(num_segments) * lc_count;
  for (int i = threadIdx.x; i < ent; i += blockDim.x) {
    const int lc = i / tile;
    const int g = i - lc * tile;
    if (g >= gt) continue;
    long long ksum = 0, csum = 0;
    for (int rep = 0; rep < replicas; ++rep) {
      ksum += sk[rep * ent + i];
      csum += sc[rep * ent + i];
    }
    const int l = lc / ncols, c = lc - l * ncols;
    part[slab * total_ent + (static_cast<long long>(g0 + g) * ncols + c) *
                                NLEV + l] = csum * (1LL << shift) + ksum;
  }
}


// ---------------------------------------------------------------------------
// exact reduction over slabs and the canonical split
// ---------------------------------------------------------------------------

__device__ __forceinline__ void write_canonical(long long t, int shift,
                                                long long i, int* out_k,
                                                int* out_c) {
  const long long hi = t >> shift;                 // arithmetic: floor
  out_k[i] = static_cast<int>(t - hi * (1LL << shift));
  out_c[i] = static_cast<int>(hi);
}

// part: (slabs, ent) int64.  With many slabs a warp sums one entry, else a
// thread does.
__global__ void segment_finalize(const long long* __restrict__ part,
                                 int slabs, long long ent, int shift,
                                 int* __restrict__ out_k,
                                 int* __restrict__ out_c) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  if (slabs >= 32) {
    const int lane = threadIdx.x & 31;
    for (long long i = t >> 5; i < ent; i += stride >> 5) {
      long long sum = 0;
#pragma unroll 4
      for (int s = lane; s < slabs; s += 32) sum += part[s * ent + i];
      sum = warp_sum(sum);
      if (lane == 0) write_canonical(sum, shift, i, out_k, out_c);
    }
  } else {
    for (long long i = t; i < ent; i += stride) {
      long long sum = 0;
      for (int s = 0; s < slabs; ++s) sum += part[s * ent + i];
      write_canonical(sum, shift, i, out_k, out_c);
    }
  }
}

// ---------------------------------------------------------------------------
// tiled path, several group tiles: partition by tile, then aggregate
// ---------------------------------------------------------------------------

constexpr int kPartThreads = 512;
constexpr int kScanThreads = 1024;
constexpr int kUnroll = 4;           // rows a thread loads at once

// The partition's int64 words, in this order (3 + 6 * tiles of them; the
// wrapper sizes and reads them: segment_rsum/ops.py::head_words).
struct Head {
  long long* unbucketed;        // [1]: 0 when the rows come in tile order
                                // with none dropped (the buckets are then
                                // ranges of the input)
  unsigned long long* counts;   // [tiles]: rows of each tile
  long long* off;               // [tiles + 1]: bucket offsets
  unsigned long long* cursor;   // [tiles]: next free slot of each bucket
  long long* work_off;          // [tiles + 1]: first work item of each tile
  long long* hot_off;           // [tiles]: first partial of a tile of
                                // several items
  unsigned long long* done;     // [tiles]: finished items of such a tile
};

__device__ __forceinline__ Head head_of(long long* h, int tiles) {
  const long long t = tiles;
  Head r;
  r.unbucketed = h;
  r.counts = reinterpret_cast<unsigned long long*>(h + 1);
  r.off = h + 1 + t;
  r.cursor = reinterpret_cast<unsigned long long*>(h + 2 + 2 * t);
  r.work_off = h + 2 + 3 * t;
  r.hot_off = h + 3 + 4 * t;
  r.done = reinterpret_cast<unsigned long long*>(h + 3 + 5 * t);
  return r;
}

// A row's group tile; -1 for padding and ids outside [0, G).
__device__ __forceinline__ int tile_index(int id, int num_segments,
                                          int tile) {
  return static_cast<unsigned>(id) < static_cast<unsigned>(num_segments)
             ? id / tile : -1;
}

// Runs of lanes with the same tile: a lane's run starts at `start` (the
// run's leader) and holds `len` lanes.  One atomic per run serves sorted
// input (a warp of one tile: one add) and unsorted input (runs of one: a
// lane's own add, on distinct tiles) alike, for a shuffle and a ballot
// (__match_any_sync groups every lane of a tile, but costs up to one pass
// per distinct value, the common case of unsorted input).
struct Run {
  int start, len;
};
__device__ __forceinline__ Run lane_run(int t) {
  const int lane = threadIdx.x & 31;
  const int prev = __shfl_up_sync(0xffffffffu, t, 1);
  const unsigned heads = __ballot_sync(0xffffffffu, lane == 0 || prev != t);
  const unsigned upto = lane == 31 ? 0xffffffffu : (2u << lane) - 1;
  const unsigned after = heads & ~upto;
  Run r;
  r.start = 31 - __clz(heads & upto);
  r.len = (after ? __ffs(after) - 1 : 32) - r.start;
  return r;
}

// Adds the block's rows [r0, r1) to hist[tile] (shared) or, without a
// shared histogram, to the global counts: one add per run of a tile in a
// warp, kUnroll rows a thread at a time (their loads in flight together).
// With kOrder, returns whether a row was dropped or came before the tile
// of the row ahead of it.  Every thread of the block calls it.
template <bool kOrder>
__device__ bool count_rows(const int* __restrict__ ids, long long r0,
                           long long r1, int num_segments, int tile,
                           unsigned* hist, unsigned long long* counts) {
  const int lane = threadIdx.x & 31;
  bool out_of_order = false;
  for (long long base = r0; base < r1; base += kUnroll * blockDim.x) {
    int id[kUnroll], prev[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * blockDim.x + threadIdx.x;
      id[u] = row < r1 ? ids[row] : -1;
      prev[u] = kOrder && row < r1 && row > 0 ? ids[row - 1] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long row = base + u * blockDim.x + threadIdx.x;
      int t = -2;                                  // past the block's rows
      if (row < r1) {
        t = tile_index(id[u], num_segments, tile);
        if (kOrder && (t < 0 || tile_index(prev[u], num_segments, tile) > t)) {
          out_of_order = true;
        }
      }
      const Run run = lane_run(t);
      if (t >= 0 && lane == run.start) {
        if (hist != nullptr) {
          atomicAdd(hist + t, static_cast<unsigned>(run.len));
        } else {
          atomicAdd(counts + t, static_cast<unsigned long long>(run.len));
        }
      }
    }
  }
  return out_of_order;
}

// Rows of each tile (grid: row blocks of rows_per_block; shared memory:
// one unsigned a tile when `local`).  The counts and the flag start at 0.
__global__ void __launch_bounds__(kPartThreads) partition_count(
    const int* __restrict__ ids, long long n, int num_segments, int tile,
    int tiles, long long rows_per_block, int local, long long* head) {
  extern __shared__ unsigned hist[];
  const Head h = head_of(head, tiles);
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  if (local) {
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) hist[i] = 0;
    __syncthreads();
  }
  const bool bad = count_rows<true>(ids, r0, r1, num_segments, tile,
                              local ? hist : nullptr, h.counts);
  if (__syncthreads_or(bad) && threadIdx.x == 0) *h.unbucketed = 1;
  if (local) {
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
      if (hist[i]) {
        atomicAdd(h.counts + i, static_cast<unsigned long long>(hist[i]));
      }
    }
  }
}

// Exclusive scan over the block (kScanThreads threads) of one value a
// thread; `total` gets the sum.
__device__ long long block_scan(long long v, long long* warp_sums,
                                long long* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  long long x = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    if (lane < nw) warp_sums[lane] = w;
  }
  __syncthreads();
  const long long before = warp == 0 ? 0 : warp_sums[warp - 1];
  *total = warp_sums[nw - 1];
  __syncthreads();                   // warp_sums is reused by the next scan
  return before + x - v;
}

__device__ __forceinline__ long long tile_items(long long count,
                                                long long chunk_rows) {
  return count > chunk_rows ? (count + chunk_rows - 1) / chunk_rows : 1;
}

// One block: bucket offsets, the cursors, the work list (at least one item
// a tile, one per chunk_rows of its bucket; item_tile maps each to its
// tile) and the partial slots of tiles of several items; each thread scans
// a contiguous run of tiles.
__global__ void __launch_bounds__(kScanThreads) partition_scan(
    long long* head, int* __restrict__ item_tile, int tiles,
    long long chunk_rows) {
  __shared__ long long warp_sums[32];
  const Head h = head_of(head, tiles);
  const int per = (tiles + blockDim.x - 1) / blockDim.x;
  const int t0 = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int t1 = min(tiles, t0 + per);
  long long rows = 0, items = 0, hot = 0;
  for (int t = t0; t < t1; ++t) {
    const long long c = static_cast<long long>(h.counts[t]);
    const long long k = tile_items(c, chunk_rows);
    rows += c;
    items += k;
    hot += k > 1 ? k : 0;
  }
  long long total_rows, total_items, total_hot;
  long long r = block_scan(rows, warp_sums, &total_rows);
  long long w = block_scan(items, warp_sums, &total_items);
  long long p = block_scan(hot, warp_sums, &total_hot);
  for (int t = t0; t < t1; ++t) {
    const long long c = static_cast<long long>(h.counts[t]);
    const long long k = tile_items(c, chunk_rows);
    h.off[t] = r;
    h.cursor[t] = static_cast<unsigned long long>(r);
    h.work_off[t] = w;
    h.hot_off[t] = p;
    h.done[t] = 0;
    for (long long q = 0; q < k; ++q) item_tile[w + q] = t;
    r += c;
    w += k;
    p += k > 1 ? k : 0;
  }
  if (threadIdx.x == 0) {
    h.off[tiles] = total_rows;
    h.work_off[tiles] = total_items;
  }
}

// Stages a block's rows, stage_rows at a time, in tile order in shared
// memory and writes each tile's run of them to consecutive slots of its
// bucket (slot[t]: the block's next slot in bucket t).  Written straight
// to their slots, the rows of a batch would land one a bucket, each store
// a partly written sector; staged, a batch writes runs of stage_rows /
// tiles rows.  Shared memory after slot: cur[tiles] (the batch's counts,
// then its cursors), delta[tiles] (slot minus staged position), the
// staged ids [stage_rows] and values [stage_rows][ncols].
__device__ void scatter_staged(const int* __restrict__ ids,
                               const float* __restrict__ x, long long r0,
                               long long r1, int ncols, int num_segments,
                               int tile, int tiles, int stage_rows,
                               unsigned* slot, int* __restrict__ bids,
                               float* __restrict__ bx) {
  __shared__ long long warp_sums[32];
  unsigned* cur = slot + tiles;
  int* delta = reinterpret_cast<int*>(cur + tiles);
  int* sid = delta + tiles;
  float* sx = reinterpret_cast<float*>(sid + stage_rows);
  const int lane = threadIdx.x & 31;
  const int per = (tiles + blockDim.x - 1) / blockDim.x;
  const int t0 = min(tiles, static_cast<int>(threadIdx.x) * per);
  const int t1 = min(tiles, t0 + per);
  for (int t = t0; t < t1; ++t) cur[t] = 0;
  __syncthreads();
  for (long long b0 = r0; b0 < r1; b0 += stage_rows) {
    const long long b1 = min(r1, b0 + stage_rows);
    count_rows<false>(ids, b0, b1, num_segments, tile, cur, nullptr);
    __syncthreads();
    // the batch's offsets per tile; each thread scans its own run of tiles
    long long mine = 0;
    for (int t = t0; t < t1; ++t) mine += cur[t];
    long long kept;
    unsigned at = static_cast<unsigned>(block_scan(mine, warp_sums, &kept));
    for (int t = t0; t < t1; ++t) {
      const unsigned c = cur[t];
      delta[t] = static_cast<int>(slot[t]) - static_cast<int>(at);
      slot[t] += c;
      cur[t] = at;
      at += c;
    }
    __syncthreads();
    for (long long base = b0; base < b1; base += kUnroll * blockDim.x) {
      int id[kUnroll];
      float v0[kUnroll];             // each row's first value
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = base + u * blockDim.x + threadIdx.x;
        id[u] = row < b1 ? ids[row] : -1;
        v0[u] = row < b1 ? x[row * ncols] : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long row = base + u * blockDim.x + threadIdx.x;
        const int t = tile_index(id[u], num_segments, tile);
        const Run run = lane_run(t);
        unsigned first = 0;
        if (t >= 0 && lane == run.start) {
          first = atomicAdd(cur + t, static_cast<unsigned>(run.len));
        }
        first = __shfl_sync(0xffffffffu, first, run.start);
        if (t >= 0) {
          const int pos = static_cast<int>(first) + lane - run.start;
          sid[pos] = id[u];
          sx[pos * ncols] = v0[u];
          for (int c = 1; c < ncols; ++c) {
            sx[pos * ncols + c] = x[row * ncols + c];
          }
        }
      }
    }
    __syncthreads();
    const int k = static_cast<int>(kept);
    for (int i = threadIdx.x; i < k; i += blockDim.x) {
      const int id = sid[i];
      bids[i + delta[id / tile]] = id;
    }
    for (int f = threadIdx.x; f < k * ncols; f += blockDim.x) {
      const int i = f / ncols;
      const long long dst = i + delta[sid[i] / tile];
      bx[dst * ncols + (f - i * ncols)] = sx[f];
    }
    __syncthreads();
    for (int t = t0; t < t1; ++t) cur[t] = 0;
    __syncthreads();
  }
}

// Copies each kept row (id and values) into its tile's bucket, unless the
// rows already come in tile order.  Same row blocks as partition_count.
// With `local`, a block counts its rows per tile again, claims its slots
// of each bucket with one atomic a tile, and hands them out with shared
// atomics (one per run of a tile in a warp), through the staging of
// scatter_staged when stage_rows > 0; else the claims go to the global
// cursors.  Slots are int32 (the wrapper takes n < 2^31).
__global__ void __launch_bounds__(kPartThreads) partition_scatter(
    const int* __restrict__ ids, const float* __restrict__ x, long long n,
    int ncols, int num_segments, int tile, int tiles,
    long long rows_per_block, int local, int stage_rows, long long* head,
    int* __restrict__ bids, float* __restrict__ bx) {
  extern __shared__ unsigned slot[];
  const Head h = head_of(head, tiles);
  if (*h.unbucketed == 0) return;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (local) {
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) slot[i] = 0;
    __syncthreads();
    count_rows<false>(ids, r0, r1, num_segments, tile, slot, nullptr);
    __syncthreads();
    for (int i = threadIdx.x; i < tiles; i += blockDim.x) {
      const unsigned c = slot[i];
      if (c) {
        slot[i] = static_cast<unsigned>(atomicAdd(
            h.cursor + i, static_cast<unsigned long long>(c)));
      }
    }
    __syncthreads();
    if (stage_rows > 0) {
      scatter_staged(ids, x, r0, r1, ncols, num_segments, tile, tiles,
                     stage_rows, slot, bids, bx);
      return;
    }
  }
  for (long long base = r0; base < r1; base += blockDim.x) {
    const long long row = base + threadIdx.x;
    const int id = row < r1 ? ids[row] : -1;
    const int t = tile_index(id, num_segments, tile);
    const Run run = lane_run(t);
    long long first = 0;
    if (t >= 0 && lane == run.start) {
      const unsigned c = static_cast<unsigned>(run.len);
      first = local ? static_cast<long long>(atomicAdd(slot + t, c))
                    : static_cast<long long>(atomicAdd(
                          h.cursor + t, static_cast<unsigned long long>(c)));
    }
    first = __shfl_sync(0xffffffffu, first, run.start);
    const long long dst = t >= 0 ? first + (lane - run.start) : -1;
    if (t >= 0) bids[dst] = id;
    if (ncols < 32) {
      if (t >= 0) {
        for (int c = 0; c < ncols; ++c) {
          bx[dst * ncols + c] = x[row * ncols + c];
        }
      }
    } else {                         // the warp copies its rows one by one
      for (int q = 0; q < 32; ++q) {
        const long long d = __shfl_sync(0xffffffffu, dst, q);
        if (d < 0) continue;
        const long long src = base + warp * 32 + q;
        for (int c = lane; c < ncols; c += 32) {
          bx[d * ncols + c] = x[src * ncols + c];
        }
      }
    }
  }
}

// Zeros `count` ints from p (4-byte aligned) with the whole block: 16-byte
// stores between a scalar head and tail.
__device__ void zero_range(int* p, long long count) {
  const long long head = min(
      count,
      static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(p) & 15)) &
                             15) / 4);
  for (long long i = threadIdx.x; i < head; i += blockDim.x) p[i] = 0;
  int4* q = reinterpret_cast<int4*>(p + head);
  const long long vecs = (count - head) / 4;
  for (long long i = threadIdx.x; i < vecs; i += blockDim.x) {
    q[i] = make_int4(0, 0, 0, 0);
  }
  for (long long i = head + 4 * vecs + threadIdx.x; i < count;
       i += blockDim.x) {
    p[i] = 0;
  }
}

// Renormalizes the int32 k of every copy into C (the whole block).
__device__ __forceinline__ void renorm(int* sk, int* sc, int count,
                                       int shift, int mask) {
  __syncthreads();
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int k = sk[i];
    sk[i] = k & mask;
    sc[i] += k >> shift;             // arithmetic shift: floor division
  }
  __syncthreads();
}

// Shared memory: int32 k and C tables of `replicas` copies of one group
// tile, laid out [group][level][column] (warp w adds to copy w % replicas),
// then the ladder [level][column].  The grid is persistent: block b takes
// work items b, b + gridDim.x, ...  No static shared memory: the dynamic
// tables may take all of the block's.
template <int NLEV>
__global__ void __launch_bounds__(kPartThreads, 1) segment_partitioned(
    const int* __restrict__ ids, const float* __restrict__ x,
    const int* __restrict__ bids, const float* __restrict__ bx,
    long long* head, const int* __restrict__ item_tile,
    const float* __restrict__ A,
    const float* __restrict__ inv_ulp, long long* __restrict__ part,
    int* __restrict__ out_k, int* __restrict__ out_c, int ncols, int m,
    int num_segments, int tile, int tiles, int replicas,
    long long chunk_rows, int renorm_rows) {
  extern __shared__ int smem[];
  const int lc_count = NLEV * ncols;               // entries of one group
  const int ent = lc_count * tile;                 // entries of one copy
  int* sk = smem;                                  // [replicas][ent]
  int* sc = smem + replicas * ent;                 // [replicas][ent]
  float* sA = reinterpret_cast<float*>(sc + replicas * ent);
  float* sI = sA + lc_count;
  const Head h = head_of(head, tiles);
  const bool in_place = *h.unbucketed == 0;
  const int* rid = in_place ? ids : bids;
  const float* rx = in_place ? x : bx;
  const int shift = m - 2;
  const int mask = (1 << shift) - 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int* my_k = sk + (warp % replicas) * ent;
  // rows a thread takes per step on the narrow branch: at most kUnroll,
  // and a step of the block within renorm_rows
  const int unroll =
      max(1, min(kUnroll, renorm_rows / static_cast<int>(blockDim.x)));

  for (int i = threadIdx.x; i < lc_count; i += blockDim.x) {
    sA[i] = A[i];
    sI[i] = inv_ulp[i];
  }
  __syncthreads();

  const long long items = h.work_off[tiles];
  for (long long w = blockIdx.x; w < items; w += gridDim.x) {
    const int t = item_tile[w];
    const long long j = w - h.work_off[t];
    const int nitems = static_cast<int>(h.work_off[t + 1] - h.work_off[t]);
    const long long b0 = h.off[t], b1 = h.off[t + 1];
    const long long lo = min(b1, b0 + j * chunk_rows);
    const long long hi = min(b1, lo + chunk_rows);
    const int g0 = t * tile;
    const int gt = min(tile, num_segments - g0);   // groups of this tile
    const int n_ent = gt * lc_count;
    const long long obase = static_cast<long long>(g0) * lc_count;
    if (lo == hi) {                  // an empty tile: zeros, no rows read
      zero_range(out_k + obase, n_ent);
      zero_range(out_c + obase, n_ent);
      continue;                      // the block is uniform: no barrier due
    }
    zero_range(smem, 2 * replicas * ent);
    __syncthreads();
    int walked = 0;                  // rows since the last renorm (uniform)
    if (ncols >= 32) {               // a warp a row, lanes over the columns
      for (long long base = lo; base < hi; base += nw) {
        const long long row = base + warp;
        if (row < hi) {
          const int g = rid[row] - g0;
          if (static_cast<unsigned>(g) < static_cast<unsigned>(gt)) {
            int* e = my_k + g * lc_count;
            const float* xr = rx + row * ncols;
            for (int c = lane; c < ncols; c += 32) {
              float r = xr[c];
#pragma unroll
              for (int l = 0; l < NLEV; ++l) {
                const int k = extract(r, sA[l * ncols + c], sI[l * ncols + c]);
                if (k != 0) atomicAdd(e + l * ncols + c, k);
              }
            }
          }
        }
        walked += nw;
        if (walked + nw > renorm_rows) {
          renorm(sk, sc, replicas * ent, shift, mask);
          walked = 0;
        }
      }
    } else {                         // a thread a row, `unroll` rows a step
      // (their loads in flight together; a step stays within renorm_rows)
      const int step = unroll * blockDim.x;
      for (long long base = lo; base < hi; base += step) {
        int g[kUnroll], gw[kUnroll];
        bool uniform[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const long long row = base + u * blockDim.x + threadIdx.x;
          g[u] = u < unroll && row < hi ? rid[row] - g0 : -1;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (static_cast<unsigned>(g[u]) >= static_cast<unsigned>(gt)) {
            g[u] = -1;
          }
          gw[u] = __shfl_sync(0xffffffffu, g[u], 0);
          uniform[u] = __all_sync(0xffffffffu, g[u] == gw[u]);
        }
        for (int c = 0; c < ncols; ++c) {
          float r[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            r[u] = g[u] >= 0
                       ? rx[(base + u * blockDim.x + threadIdx.x) * ncols + c]
                       : 0.0f;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            if (uniform[u] && gw[u] < 0) continue;   // no row in the tile
#pragma unroll
            for (int l = 0; l < NLEV; ++l) {
              int k = extract(r[u], sA[l * ncols + c], sI[l * ncols + c]);
              int* e = my_k + l * ncols + c;
              if (uniform[u]) {      // the whole warp on one group
                k = __reduce_add_sync(0xffffffffu, k);
                if (lane == 0) atomicAdd(e + gw[u] * lc_count, k);
              } else if (g[u] >= 0 && k != 0) {
                atomicAdd(e + g[u] * lc_count, k);
              }
            }
          }
        }
        walked += step;
        if (walked + step > renorm_rows) {
          renorm(sk, sc, replicas * ent, shift, mask);
          walked = 0;
        }
      }
    }
    __syncthreads();

    // the tile's exact sums in (group, column, level) order
    auto tile_sum = [&](int i) {
      const int g = i / lc_count;
      const int r = i - g * lc_count;
      const int c = r / NLEV;
      const int s = g * lc_count + (r - c * NLEV) * ncols + c;
      long long ksum = 0, csum = 0;
      for (int rep = 0; rep < replicas; ++rep) {
        ksum += sk[rep * ent + s];
        csum += sc[rep * ent + s];
      }
      return csum * (1LL << shift) + ksum;
    };
    if (nitems == 1) {
      for (int i = threadIdx.x; i < n_ent; i += blockDim.x) {
        write_canonical(tile_sum(i), shift, obase + i, out_k, out_c);
      }
    } else {                         // a hot tile: one partial an item
      long long* first = part + h.hot_off[t] * ent;
      long long* mine = first + j * ent;
      for (int i = threadIdx.x; i < n_ent; i += blockDim.x) {
        mine[i] = tile_sum(i);
      }
      // every thread's stores are fenced, and then the block meets, before
      // thread 0 counts the item done: another item that reads the count
      // as the last one then sees all of this partial
      __threadfence();
      __syncthreads();
      unsigned long long prev = 0;
      if (threadIdx.x == 0) prev = atomicAdd(h.done + t, 1ULL);
      const bool last = __syncthreads_or(
          threadIdx.x == 0 &&
          prev == static_cast<unsigned long long>(nitems - 1));
      if (last) {                    // every other item's partial is written
        __threadfence();
        for (int i = threadIdx.x; i < n_ent; i += blockDim.x) {
          long long sum = 0;
          for (int q = 0; q < nitems; ++q) sum += __ldcg(first + q * ent + i);
          write_canonical(sum, shift, obase + i, out_k, out_c);
        }
        if (threadIdx.x == 0) h.done[t] = 0;   // the aggregate may run again
      }
    }
    __syncthreads();                 // the tables are zeroed for the next item
  }
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

// kernel codes: the two paths' kernels (ops.py::PATHS) and the aggregate of
// the tiled path over several group tiles
enum Kernel { kPrivate = 0, kTiled = 1, kPartitioned = 2 };

struct Args {
  const int* ids;
  const float* x;
  const float* A;
  const float* inv_ulp;
  long long* part;
  long long n;
  int ncols, nlev, m, num_segments, tile, replicas, slabs;
  long long rows_per_slab;
  int renorm_rows, threads;
  size_t smem;
  cudaStream_t stream;
  bool launch;          // false: only report resident blocks per SM
  int* blocks_per_sm;
  // several group tiles (kPartitioned)
  const int* bids;
  const float* bx;
  long long* head;
  const int* item_tile;
  int* out_k;
  int* out_c;
  int tiles;
  long long chunk_rows;
  int blocks;
};

template <typename Kernel>
cudaError_t prepare(Kernel kernel, const Args& a, bool max_shared) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(a.smem));
  if (err == cudaSuccess && max_shared) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  if (err == cudaSuccess && !a.launch) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        a.blocks_per_sm, kernel, a.threads, a.smem);
  }
  return err;
}

template <int NLEV, int NC>
cudaError_t run_private(const Args& a) {
  auto kernel = segment_private<NLEV, NC>;
  cudaError_t err = prepare(kernel, a, true);
  if (err != cudaSuccess || !a.launch) return err;
  const int vec = reinterpret_cast<uintptr_t>(a.ids) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  kernel<<<a.slabs, kPrivateThreads, a.smem, a.stream>>>(
      a.ids, a.x, a.A, a.inv_ulp, a.part, a.n, a.num_segments,
      a.rows_per_slab, a.renorm_rows, vec);
  return cudaGetLastError();
}

template <int NLEV>
cudaError_t run_private_nc(const Args& a) {
  switch (a.ncols) {
    case 1: return run_private<NLEV, 1>(a);
    case 2: return run_private<NLEV, 2>(a);
    case 3: return run_private<NLEV, 3>(a);
    case 4: return run_private<NLEV, 4>(a);
    case 5: return run_private<NLEV, 5>(a);
    case 6: return run_private<NLEV, 6>(a);
    case 7: return run_private<NLEV, 7>(a);
    case 8: return run_private<NLEV, 8>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <int NLEV>
cudaError_t run_tiled(const Args& a) {
  auto kernel = segment_tiled<NLEV>;
  cudaError_t err = prepare(kernel, a, false);
  if (err != cudaSuccess || !a.launch) return err;
  const int n_tiles = (a.num_segments + a.tile - 1) / a.tile;
  kernel<<<dim3(n_tiles, a.slabs), a.threads, a.smem, a.stream>>>(
      a.ids, a.x, a.A, a.inv_ulp, a.part, a.n, a.ncols, a.m,
      a.num_segments, a.tile, a.replicas, a.rows_per_slab, a.renorm_rows);
  return cudaGetLastError();
}

template <int NLEV>
cudaError_t run_partitioned(const Args& a) {
  auto kernel = segment_partitioned<NLEV>;
  cudaError_t err = prepare(kernel, a, false);
  if (err != cudaSuccess || !a.launch) return err;
  kernel<<<a.blocks, a.threads, a.smem, a.stream>>>(
      a.ids, a.x, a.bids, a.bx, a.head, a.item_tile, a.A, a.inv_ulp, a.part,
      a.out_k,
      a.out_c, a.ncols, a.m, a.num_segments, a.tile, a.tiles, a.replicas,
      a.chunk_rows, a.renorm_rows);
  return cudaGetLastError();
}

cudaError_t run(int path, const Args& a) {
  if (path == kPrivate) {
    switch (a.nlev) {
      case 1: return run_private_nc<1>(a);
      case 2: return run_private_nc<2>(a);
      case 3: return run_private_nc<3>(a);
      case 4: return run_private_nc<4>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == kTiled) {
    switch (a.nlev) {
      case 1: return run_tiled<1>(a);
      case 2: return run_tiled<2>(a);
      case 3: return run_tiled<3>(a);
      case 4: return run_tiled<4>(a);
      case 5: return run_tiled<5>(a);
      case 6: return run_tiled<6>(a);
      case 7: return run_tiled<7>(a);
      case 8: return run_tiled<8>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  if (path == kPartitioned) {
    switch (a.nlev) {
      case 1: return run_partitioned<1>(a);
      case 2: return run_partitioned<2>(a);
      case 3: return run_partitioned<3>(a);
      case 4: return run_partitioned<4>(a);
      case 5: return run_partitioned<5>(a);
      case 6: return run_partitioned<6>(a);
      case 7: return run_partitioned<7>(a);
      case 8: return run_partitioned<8>(a);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches the private path's kernel, or the tiled path's in one group
// tile (grid: `slabs` blocks), and the slab reduction on `stream`.  part:
// (slabs, G, ncols, nlev) int64 scratch; out_k, out_c: (G, ncols, nlev)
// int32, canonical for a mantissa of m bits.  Returns cudaGetLastError()
// (0 on success).
int segment_rsum_launch(const void* ids, const void* x, const void* A,
                        const void* inv_ulp, void* part, void* out_k,
                        void* out_c, long long n, int ncols, int nlev, int m,
                        int num_segments, int path, int tile, int replicas,
                        int slabs, long long rows_per_slab, int renorm_rows,
                        int threads, long long smem, void* stream) {
  Args a{static_cast<const int*>(ids), static_cast<const float*>(x),
         static_cast<const float*>(A), static_cast<const float*>(inv_ulp),
         static_cast<long long*>(part), n, ncols, nlev, m, num_segments,
         tile, replicas, slabs, rows_per_slab, renorm_rows, threads,
         static_cast<size_t>(smem), static_cast<cudaStream_t>(stream), true,
         nullptr};
  cudaError_t err = run(path, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long ent = static_cast<long long>(num_segments) * ncols * nlev;
  const long long work = slabs >= 32 ? 32 * ent : ent;
  const long long grid = (work + 255) / 256;
  segment_finalize<<<static_cast<unsigned>(grid < 4096 ? grid : 4096), 256,
                     0, a.stream>>>(a.part, slabs, ent, m - 2,
                                    static_cast<int*>(out_k),
                                    static_cast<int*>(out_c));
  return static_cast<int>(cudaGetLastError());
}

// The tiled path over several group tiles, first launch set: zeros the
// flag and the counts of `head` (3 + 6 * tiles int64 words, see Head), then
// partition_count, partition_scan and partition_scatter on `stream`.  Row
// blocks of rows_per_block rows, `blocks` of them; with `local` each keeps
// a shared histogram of 4 * tiles bytes, and with stage_rows > 0 the
// scatter stages that many rows at a time (12 * tiles + 4 * stage_rows *
// (ncols + 1) bytes of shared memory).  item_tile gets each work item's
// tile (at most tiles + n / chunk_rows items); bids (n) and bx (n, ncols)
// get the rows in bucket order unless they already come in tile order.
// Returns cudaGetLastError() (0 on success).
int segment_partition_launch(const void* ids, const void* x, long long n,
                             int ncols, int num_segments, int tile,
                             int tiles, int blocks, long long rows_per_block,
                             long long chunk_rows, int local, int stage_rows,
                             void* head, void* item_tile, void* bids,
                             void* bx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* h = static_cast<long long*>(head);
  const int* id = static_cast<const int*>(ids);
  const size_t smem = local ? 4 * static_cast<size_t>(tiles) : 0;
  const size_t scatter_smem =
      local && stage_rows > 0
          ? smem * 3 + 4 * static_cast<size_t>(stage_rows) * (ncols + 1)
          : smem;
  cudaError_t err = cudaMemsetAsync(
      h, 0, 8 * (1 + static_cast<size_t>(tiles)), s);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(partition_count,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess && scatter_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(partition_scatter,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(scatter_smem));
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_count<<<blocks, kPartThreads, smem, s>>>(
      id, n, num_segments, tile, tiles, rows_per_block, local, h);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_scan<<<1, kScanThreads, 0, s>>>(
      h, static_cast<int*>(item_tile), tiles, chunk_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  partition_scatter<<<blocks, kPartThreads, scatter_smem, s>>>(
      id, static_cast<const float*>(x), n, ncols, num_segments, tile, tiles,
      rows_per_block, local, stage_rows, h, static_cast<int*>(bids),
      static_cast<float*>(bx));
  return static_cast<int>(cudaGetLastError());
}

// The tiled path over several group tiles, last launch: segment_partitioned
// on a persistent grid of `blocks` blocks over the work list that
// segment_partition_launch left in `head` and `item_tile`.  part: int64
// partials of the tiles split over several items (tile * ncols * nlev
// words each); out_k, out_c: (G, ncols, nlev) int32, canonical.  Returns
// cudaGetLastError().
int segment_aggregate_launch(const void* ids, const void* x, const void* A,
                             const void* inv_ulp, void* head,
                             const void* item_tile, const void* bids,
                             const void* bx, void* part,
                             void* out_k, void* out_c, int ncols, int nlev,
                             int m, int num_segments, int tile, int tiles,
                             int replicas, long long chunk_rows,
                             int renorm_rows, int threads, long long smem,
                             int blocks, void* stream) {
  Args a{};
  a.ids = static_cast<const int*>(ids);
  a.x = static_cast<const float*>(x);
  a.A = static_cast<const float*>(A);
  a.inv_ulp = static_cast<const float*>(inv_ulp);
  a.part = static_cast<long long*>(part);
  a.ncols = ncols;
  a.nlev = nlev;
  a.m = m;
  a.num_segments = num_segments;
  a.tile = tile;
  a.replicas = replicas;
  a.renorm_rows = renorm_rows;
  a.threads = threads;
  a.smem = static_cast<size_t>(smem);
  a.stream = static_cast<cudaStream_t>(stream);
  a.launch = true;
  a.bids = static_cast<const int*>(bids);
  a.bx = static_cast<const float*>(bx);
  a.head = static_cast<long long*>(head);
  a.item_tile = static_cast<const int*>(item_tile);
  a.out_k = static_cast<int*>(out_k);
  a.out_c = static_cast<int*>(out_c);
  a.tiles = tiles;
  a.chunk_rows = chunk_rows;
  a.blocks = blocks;
  return static_cast<int>(run(kPartitioned, a));
}

// Resident blocks per SM of one kernel (a Kernel code) at `threads` threads
// and `smem` bytes of dynamic shared memory; 0 on error.
int segment_rsum_blocks_per_sm(int path, int ncols, int nlev, int threads,
                               long long smem) {
  int blocks = 0;
  Args a{};
  a.ncols = ncols;
  a.nlev = nlev;
  a.threads = threads;
  a.smem = static_cast<size_t>(smem);
  a.launch = false;
  a.blocks_per_sm = &blocks;
  return run(path, a) == cudaSuccess ? blocks : 0;
}

const char* segment_rsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
