// Flat reproducible sum (RSUM, paper §III-D) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rsum/kernel.py::_rsum_kernel (launcher
// rsum_pallas_call), the TPU kernel that sums extracted integers into
// per-lane VMEM scratch over a sequential grid of row blocks.
//
// What bounds it on an H100: it reads every input float once and does a few
// float and integer operations per level on it, so device-memory bandwidth
// bounds it (n * ncols * 4 bytes over 3.35 TB/s).  To reach that rate an SM
// needs some 15-20 KB of loads in flight (Little's law at 0.6-0.8 us of
// memory latency); one scalar load per thread per step, used at once, keeps
// about 4 KB in flight and leaves the kernel latency-bound.
//
// Design:
// * a grid-stride loop over the flat (n, ncols) row-major input as 16-byte
//   float4 vectors: U independent streaming loads (__ldcs) per thread per
//   step, all issued before any arithmetic (U = 8 up to 2 levels, 4 up to
//   4, else 2: as many as the registers of one resident wave allow);
// * the grid's thread count T is sized so that 4 * T is a multiple of
//   ncols: then vector slot j of a thread always holds the same column, so
//   its extractor ladder A, 2^(m - e) and its int64 level sums sit in
//   registers for the whole loop (NLEV and U are template parameters, every
//   loop unrolls);
// * per level: q = (r + A) - A, r -= q with __fadd_rn/__fsub_rn, and
//   k = __float2int_rz(q * 2^(m - e)) -- an exact integer -- accumulated in
//   int64.  |k| <= 2^(W-1), so no renorm is needed;
// * lanes that hold the same columns are folded with warp shuffles, then one
//   int64 shared-memory atomicAdd per (level, column) and warp, then one
//   global int64 atomicAdd per (level, column) and block;
// * the last block to finish (a ticket counter, after __threadfence) adds
//   the ragged edges (the up to 3 floats before the first 16-byte aligned
//   address and the up to 3 after the last whole vector), writes the
//   canonical int32 split k = T mod 2^(m-2), C = T >> (m-2), and zeroes the
//   sums and the ticket: one launch, no second kernel and no pass over
//   per-block partials, no reduction left to the caller.  Integer addition
//   is exact and associative and the split is unique, so the bits are those
//   of any sequential order.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <int NLEV>
__device__ __forceinline__ void extract_add(float r, const float (&a)[NLEV],
                                            const float (&s)[NLEV],
                                            long long (&acc)[NLEV]) {
#pragma unroll
  for (int l = 0; l < NLEV; ++l) {
    const float q = __fsub_rn(__fadd_rn(r, a[l]), a[l]);
    r = __fsub_rn(r, q);
    acc[l] += __float2int_rz(__fmul_rn(q, s[l]));
  }
}

template <int NLEV>
__device__ __forceinline__ void extract_vec(const float4& v,
                                            const float (&a)[4][NLEV],
                                            const float (&s)[4][NLEV],
                                            long long (&acc)[4][NLEV]) {
  extract_add<NLEV>(v.x, a[0], s[0], acc[0]);
  extract_add<NLEV>(v.y, a[1], s[1], acc[1]);
  extract_add<NLEV>(v.z, a[2], s[2], acc[2]);
  extract_add<NLEV>(v.w, a[3], s[3], acc[3]);
}

// The vectors start `head` floats into x, 16-byte aligned.  sums:
// (NLEV, ncols) int64 and ticket: zero at launch, and zero again when the
// kernel ends.
template <int NLEV, int U>
__global__ void __launch_bounds__(256) rsum_kernel(
    const float* __restrict__ x, const float* __restrict__ A,
    const float* __restrict__ inv_ulp, long long* __restrict__ sums,
    unsigned* __restrict__ ticket, int* __restrict__ out_k,
    int* __restrict__ out_c, long long total, long long nvec, int head,
    int ncols, int shift) {
  extern __shared__ long long red[];               // [NLEV][ncols]
  __shared__ int last;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  for (int i = threadIdx.x; i < NLEV * ncols; i += blockDim.x) red[i] = 0;

  const long long T = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  float a[4][NLEV], s[4][NLEV];
  long long acc[4][NLEV];
  int col[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    col[j] = static_cast<int>((head + 4 * t + j) % ncols);
#pragma unroll
    for (int l = 0; l < NLEV; ++l) {
      a[j][l] = A[l * ncols + col[j]];
      s[j][l] = inv_ulp[l * ncols + col[j]];
      acc[j][l] = 0;
    }
  }

  long long v = t;
  for (; v + (U - 1) * T < nvec; v += U * T) {
    float4 buf[U];
#pragma unroll
    for (int u = 0; u < U; ++u) buf[u] = __ldcs(xv + v + u * T);
#pragma unroll
    for (int u = 0; u < U; ++u) extract_vec<NLEV>(buf[u], a, s, acc);
  }
  for (; v < nvec; v += T) extract_vec<NLEV>(__ldcs(xv + v), a, s, acc);

  // lanes p = ncols / gcd(ncols, 4) apart hold the same four columns
  const int p = ncols / (ncols % 4 == 0 ? 4 : (ncols % 2 == 0 ? 2 : 1));
  const int lane = threadIdx.x & 31;
  if (p < 32) {
    int top = p;                                   // largest p * 2^j < 32
    while (top * 2 < 32) top *= 2;
    for (int off = top; off >= p; off >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int l = 0; l < NLEV; ++l) {
          const long long o = __shfl_down_sync(0xffffffffu, acc[j][l], off);
          if (lane + off < 32) acc[j][l] += o;
        }
      }
    }
  }
  __syncthreads();                                 // red[] is zeroed
  if (p >= 32 || lane < p) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int l = 0; l < NLEV; ++l) {
        atomicAdd(reinterpret_cast<unsigned long long*>(
                      &red[l * ncols + col[j]]),
                  static_cast<unsigned long long>(acc[j][l]));
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NLEV * ncols; i += blockDim.x) {
    atomicAdd(reinterpret_cast<unsigned long long*>(&sums[i]),
              static_cast<unsigned long long>(red[i]));
  }
  // the last block to take a ticket sees every block's sums
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  const long long tail = head + 4 * nvec;
  for (int i = threadIdx.x; i < NLEV * ncols; i += blockDim.x) {
    long long sum = __ldcg(&sums[i]);
    const int lv = i / ncols, c = i - lv * ncols;
    for (long long e = 0; e < total; ++e) {        // the ragged edges
      if (e == head) e = tail;
      if (e >= total) break;
      if (e % ncols != c) continue;
      float r = x[e];
      for (int l = 0; l <= lv; ++l) {
        const float al = A[l * ncols + c];
        const float q = __fsub_rn(__fadd_rn(r, al), al);
        r = __fsub_rn(r, q);
        if (l == lv) {
          sum += __float2int_rz(__fmul_rn(q, inv_ulp[l * ncols + c]));
        }
      }
    }
    const long long hi = sum >> shift;             // arithmetic: floor
    out_k[i] = static_cast<int>(sum - hi * (1LL << shift));
    out_c[i] = static_cast<int>(hi);
    sums[i] = 0;                                   // ready for the next launch
  }
  if (threadIdx.x == 0) *ticket = 0;
}

template <int NLEV, int U>
cudaError_t launch(const float* x, const float* A, const float* inv_ulp,
                   long long* sums, unsigned* ticket, int* out_k,
                   int* out_c, long long total, int ncols, int blocks,
                   int threads, int shift, cudaStream_t stream) {
  const size_t smem = sizeof(long long) * NLEV * static_cast<size_t>(ncols);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rsum_kernel<NLEV, U>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // floats before the first 16-byte aligned address, then whole vectors
  const long long misalign = reinterpret_cast<uintptr_t>(x) % 16 / 4;
  const long long head = misalign ? (4 - misalign < total ? 4 - misalign
                                                          : total)
                                  : 0;
  const long long nvec = (total - head) / 4;
  rsum_kernel<NLEV, U><<<blocks, threads, smem, stream>>>(
      x, A, inv_ulp, sums, ticket, out_k, out_c, total, nvec,
      static_cast<int>(head), ncols, shift);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the reduction on `stream`: `blocks` blocks of `threads`
// threads; blocks * threads * 4 must be a multiple of ncols.  workspace:
// 1 + nlev * ncols int64, zero (and left zero): a ticket counter, then the
// (nlev, ncols) sums.  out_k, out_c: (nlev, ncols) int32,
// canonical for a mantissa of m bits.  Returns cudaGetLastError() (0 on
// success).
int rsum_launch(const void* x, const void* A, const void* inv_ulp,
                void* workspace, void* out_k, void* out_c, long long total,
                int ncols, int nlev, int m, int blocks, int threads,
                void* stream) {
  if ((static_cast<long long>(blocks) * threads * 4) % ncols != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(A);
  const float* sf = static_cast<const float*>(inv_ulp);
  unsigned* ticket = static_cast<unsigned*>(workspace);
  long long* p = static_cast<long long*>(workspace) + 1;
  int* ok = static_cast<int*>(out_k);
  int* oc = static_cast<int*>(out_c);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int sh = m - 2;
#define RSUM_CASE(L, U)                                                     \
  case L:                                                                   \
    return static_cast<int>(launch<L, U>(xf, af, sf, p, ticket, ok, oc,     \
                                         total, ncols, blocks, threads, sh, \
                                         st));
  switch (nlev) {
    RSUM_CASE(1, 8)
    RSUM_CASE(2, 8)
    RSUM_CASE(3, 4)
    RSUM_CASE(4, 4)
    RSUM_CASE(5, 2)
    RSUM_CASE(6, 2)
    RSUM_CASE(7, 2)
    RSUM_CASE(8, 2)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef RSUM_CASE
}

// Resident blocks of `threads` threads per SM for `nlev` levels and `ncols`
// columns (the grid is sized to fill the card once); 0 on error.
int rsum_blocks_per_sm(int nlev, int ncols, int threads) {
  const size_t smem = sizeof(long long) * nlev * static_cast<size_t>(ncols);
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
#define RSUM_OCC(L, U)                                                      \
  case L:                                                                   \
    if (smem > 48 * 1024) {                                                 \
      cudaFuncSetAttribute(rsum_kernel<L, U>,                               \
                           cudaFuncAttributeMaxDynamicSharedMemorySize,     \
                           static_cast<int>(smem));                         \
    }                                                                       \
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(                    \
        &blocks, rsum_kernel<L, U>, threads, smem);                         \
    break;
  switch (nlev) {
    RSUM_OCC(1, 8)
    RSUM_OCC(2, 8)
    RSUM_OCC(3, 4)
    RSUM_OCC(4, 4)
    RSUM_OCC(5, 2)
    RSUM_OCC(6, 2)
    RSUM_OCC(7, 2)
    RSUM_OCC(8, 2)
    default: break;
  }
#undef RSUM_OCC
  return err == cudaSuccess ? blocks : 0;
}

const char* rsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
