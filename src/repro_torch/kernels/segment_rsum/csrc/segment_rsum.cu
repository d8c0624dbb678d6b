// Reproducible GROUPBY (segment RSUM, paper §V) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/segment_rsum/kernel.py::_segment_kernel
// (launcher segment_rsum_pallas_call), the TPU kernel that contracts the
// extracted contributions with a one-hot of the group ids on the MXU.
//
// What bounds it on an H100: at small G it streams the rows once (4 bytes of
// id + 4 bytes per accumulator column), so device-memory bandwidth bounds it
// (3.35 TB/s); the shared-memory atomics that add each row's integer
// contributions into the group table contend heavily when few groups take
// every row.  At large G the table no longer fits one block's shared memory
// and the rows are streamed once per group tile.
//
// Design:
// * grid = (group tiles, row slabs); the TPU's sequential row axis becomes
//   slabs that run in parallel.  Integer addition is exact and associative
//   and the canonical (k, C) decomposition is unique, so per-slab partials
//   reduced afterwards give the same bits as any sequential order;
// * each block keeps int32 (k, C) tables of (nlev, ncols, tile) in shared
//   memory (dynamic shared memory past 48 KB).  When the table is small,
//   each warp gets its own copy (up to one per warp) so that only lanes of
//   one warp contend for an address;
// * per row and level: q = (r + A) - A, r -= q with __fadd_rn/__fsub_rn (no
//   contraction or reassociation), k = __float2int_rz(q * 2^(m - e)) — an
//   exact integer — added with a shared-memory atomicAdd, whose order cannot
//   move a bit;
// * after at most renorm_rows = 2^(30 - (W - 1)) rows walked by the block,
//   every table entry is renormalized in place (k & (2^(m-2) - 1) and
//   C += k >> (m - 2)), so the int32 k never overflows: it stays below
//   2^(m-2) + renorm_rows * 2^(W-1) <= 2^21 + 2^30 < 2^31;
// * the f32 one-hot contraction of the TPU kernel, and its 128-row bound,
//   existed to use the MXU and are not carried over;
// * the block writes its slab's canonical partial (k, C) for its tile; the
//   caller reduces the slabs with exact integer tensor code.
#include <cuda_runtime.h>

namespace {

__global__ void segment_rsum_kernel(
    const int* __restrict__ ids, const float* __restrict__ x,
    const float* __restrict__ A, const float* __restrict__ inv_ulp,
    int* __restrict__ part_k, int* __restrict__ part_c,
    long long n, int ncols, int nlev, int m, int num_segments, int tile,
    int replicas, long long rows_per_slab, int renorm_rows) {
  extern __shared__ int smem[];
  const int lc_count = nlev * ncols;
  const int ent = lc_count * tile;                 // entries of one copy
  int* sk = smem;                                  // [replicas][ent]
  int* sc = smem + replicas * ent;                 // [replicas][ent]
  float* sA = reinterpret_cast<float*>(sc + replicas * ent);  // [nlev][ncols]
  float* sI = sA + lc_count;                                  // [nlev][ncols]

  const int g0 = blockIdx.x * tile;
  const int gt = min(tile, num_segments - g0);     // groups of this tile
  const long long slab = blockIdx.y;
  const long long r0 = slab * rows_per_slab;
  const long long r1 = min(n, r0 + rows_per_slab);
  const int shift = m - 2;
  const int mask = (1 << shift) - 1;

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
    if (row < r1) {
      // padding ids (-1) and ids of other tiles fall outside [0, gt)
      const int g = ids[row] - g0;
      if (static_cast<unsigned>(g) < static_cast<unsigned>(gt)) {
        const float* xr = x + row * ncols;
        for (int c = 0; c < ncols; ++c) {
          float r = xr[c];
          for (int l = 0; l < nlev; ++l) {
            const float a = sA[l * ncols + c];
            const float q = __fsub_rn(__fadd_rn(r, a), a);
            r = __fsub_rn(r, q);
            const int k = __float2int_rz(__fmul_rn(q, sI[l * ncols + c]));
            if (k != 0) {
              atomicAdd(&my_k[(l * ncols + c) * tile + g], k);
            }
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

  // fold the copies and write this slab's canonical partial:
  // part[slab][l][c][g] for the tile's groups
  for (int i = threadIdx.x; i < ent; i += blockDim.x) {
    const int lc = i / tile;
    const int g = i - lc * tile;
    if (g >= gt) continue;
    long long ksum = 0, csum = 0;
    for (int rep = 0; rep < replicas; ++rep) {
      ksum += sk[rep * ent + i];
      csum += sc[rep * ent + i];
    }
    const long long out = (slab * lc_count + lc) * num_segments + g0 + g;
    part_k[out] = static_cast<int>(ksum & mask);
    part_c[out] = static_cast<int>(csum + (ksum >> shift));
  }
}

}  // namespace

extern "C" {

// Launches one grid of (ceil(G / tile), slabs) blocks of `threads` threads
// on `stream`; returns cudaGetLastError() (0 on success).
int segment_rsum_launch(const void* ids, const void* x, const void* A,
                        const void* inv_ulp, void* part_k, void* part_c,
                        long long n, int ncols, int nlev, int m,
                        int num_segments, int tile, int replicas, int slabs,
                        long long rows_per_slab, int renorm_rows, int threads,
                        void* stream) {
  const int n_tiles = (num_segments + tile - 1) / tile;
  const size_t smem = sizeof(int) * 2 * static_cast<size_t>(replicas) *
                          nlev * ncols * tile +
                      sizeof(float) * 2 * static_cast<size_t>(nlev) * ncols;
  cudaError_t err = cudaFuncSetAttribute(
      segment_rsum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  segment_rsum_kernel<<<dim3(n_tiles, slabs), threads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(ids), static_cast<const float*>(x),
      static_cast<const float*>(A), static_cast<const float*>(inv_ulp),
      static_cast<int*>(part_k), static_cast<int*>(part_c), n, ncols, nlev,
      m, num_segments, tile, replicas, rows_per_slab, renorm_rows);
  return static_cast<int>(cudaGetLastError());
}

const char* segment_rsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
