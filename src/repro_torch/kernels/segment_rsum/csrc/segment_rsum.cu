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
// block's shared memory and the rows are streamed once per group tile.
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
//   block's shared memory (one tile of all G groups when it fits), grid =
//   (tiles, row slabs), int32 (k, C) tables with one copy per warp as far
//   as they fit, so lanes contend only within their warp.  A warp whose
//   32 rows all carry one group of the tile (sorted or clustered input)
//   sums each contribution with __reduce_add_sync (|sum| <= 32 * 2^(W-1)
//   fits int32) and adds it with one atomicAdd, and a warp with no row in
//   the tile skips its rows; any other warp adds lane by lane.  (Grouping
//   the lanes with __match_any_sync instead costs a match per row even
//   when every lane has its own group, the common case for unsorted
//   input.)
// Every path renormalizes or flushes before int32 can overflow, and every
// block writes its slab's exact int64 sums T in (G, ncols, nlev) order; a
// second kernel on the same stream adds the slabs and writes the canonical
// int32 split k = T mod 2^(m-2), C = T >> (m-2).  Integer addition is exact
// and associative and the split is unique, so the bits are those of any
// sequential order.  Per row and level: q = (r + A) - A, r -= q with
// __fadd_rn/__fsub_rn, k = __float2int_rz(q * 2^(m - e)), an exact integer.
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
// dispatch
// ---------------------------------------------------------------------------

enum Path { kPrivate = 0, kTiled = 1 };

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
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launches one path's kernel (grid: `slabs` blocks, times the group tiles
// on the tiled path) and the slab reduction on `stream`.  part: (slabs, G,
// ncols, nlev) int64 scratch; out_k, out_c: (G, ncols, nlev) int32,
// canonical for a mantissa of m bits.  Returns cudaGetLastError() (0 on
// success).
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

// Resident blocks per SM of one path's kernel at `threads` threads and
// `smem` bytes of dynamic shared memory; 0 on error.
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
