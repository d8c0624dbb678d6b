// Flat reproducible sum (RSUM, paper §III-D) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rsum/kernel.py::_rsum_kernel (launcher
// rsum_pallas_call), the TPU kernel that sums extracted integers into
// per-lane VMEM scratch over a sequential grid of row blocks.
//
// What bounds it on an H100: it reads every input float once and does a few
// float and integer operations per level on it, so device-memory bandwidth
// bounds it (n * ncols * 4 bytes over 3.35 TB/s).
//
// Design:
// * a grid-stride loop over the flat (n, ncols) row-major input.  The total
//   thread count is a multiple of ncols (the caller sizes the grid so), so
//   each thread always sees the same column and neighbouring threads read
//   neighbouring floats;
// * per level: q = (r + A) - A, r -= q with __fadd_rn/__fsub_rn, and
//   k = __float2int_rz(q * 2^(m - e)) — an exact integer — accumulated in an
//   int64 register per level.  |k| <= 2^(W-1), so a thread's sum cannot
//   overflow for any n below 2^(64-W) and needs no renorm;
// * lanes ncols apart hold the same column: a warp-shuffle tree over those
//   offsets, then one int64 shared-memory atomicAdd per (level, column) per
//   warp, reduces the block to one int64 partial per (level, column);
// * the caller sums the blocks' partials exactly in int64 and splits the
//   total T into the canonical k = T mod 2^(m-2), C = T >> (m-2).  C fits the
//   int32 table when n * 2^(W-1) < 2^31 * 2^(m-2), which the caller checks.
// The TPU's sequential grid and per-block renorm existed to keep int32
// scratch from overflowing; int64 registers make both unnecessary, and the
// unique canonical decomposition makes the result the same bits.
#include <cuda_runtime.h>

namespace {

template <int NLEV>
__global__ void rsum_kernel(const float* __restrict__ x,
                            const float* __restrict__ A,
                            const float* __restrict__ inv_ulp,
                            long long* __restrict__ partial, long long total,
                            int ncols) {
  extern __shared__ long long red[];               // [NLEV][ncols]
  for (int i = threadIdx.x; i < NLEV * ncols; i += blockDim.x) red[i] = 0;
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int c = static_cast<int>(i % ncols);
  float a[NLEV], s[NLEV];
  long long acc[NLEV];
#pragma unroll
  for (int l = 0; l < NLEV; ++l) {
    a[l] = A[l * ncols + c];
    s[l] = inv_ulp[l * ncols + c];
    acc[l] = 0;
  }
  for (; i < total; i += stride) {
    float r = x[i];
#pragma unroll
    for (int l = 0; l < NLEV; ++l) {
      const float q = __fsub_rn(__fadd_rn(r, a[l]), a[l]);
      r = __fsub_rn(r, q);
      acc[l] += __float2int_rz(__fmul_rn(q, s[l]));
    }
  }

  const int lane = threadIdx.x & 31;
  if (ncols < 32) {
    int top = ncols;                               // largest ncols * 2^j < 32
    while (top * 2 < 32) top *= 2;
    for (int off = top; off >= ncols; off >>= 1) {
#pragma unroll
      for (int l = 0; l < NLEV; ++l) {
        const long long o = __shfl_down_sync(0xffffffffu, acc[l], off);
        if (lane + off < 32) acc[l] += o;
      }
    }
  }
  if (ncols >= 32 || lane < ncols) {
#pragma unroll
    for (int l = 0; l < NLEV; ++l) {
      atomicAdd(reinterpret_cast<unsigned long long*>(&red[l * ncols + c]),
                static_cast<unsigned long long>(acc[l]));
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < NLEV * ncols; j += blockDim.x) {
    partial[static_cast<long long>(blockIdx.x) * NLEV * ncols + j] = red[j];
  }
}

template <int NLEV>
cudaError_t launch(const float* x, const float* A, const float* inv_ulp,
                   long long* partial, long long total, int ncols, int blocks,
                   int threads, cudaStream_t stream) {
  const size_t smem = sizeof(long long) * NLEV * static_cast<size_t>(ncols);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        rsum_kernel<NLEV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  rsum_kernel<NLEV><<<blocks, threads, smem, stream>>>(x, A, inv_ulp, partial,
                                                      total, ncols);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches `blocks` blocks of `threads` threads on `stream`; blocks * threads
// must be a multiple of ncols.  partial: (blocks, nlev, ncols) int64.
// Returns cudaGetLastError() (0 on success).
int rsum_launch(const void* x, const void* A, const void* inv_ulp,
                void* partial, long long total, int ncols, int nlev,
                int blocks, int threads, void* stream) {
  const float* xf = static_cast<const float*>(x);
  const float* af = static_cast<const float*>(A);
  const float* sf = static_cast<const float*>(inv_ulp);
  long long* p = static_cast<long long*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (nlev) {
    case 1: return launch<1>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 2: return launch<2>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 3: return launch<3>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 4: return launch<4>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 5: return launch<5>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 6: return launch<6>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 7: return launch<7>(xf, af, sf, p, total, ncols, blocks, threads, st);
    case 8: return launch<8>(xf, af, sf, p, total, ncols, blocks, threads, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* rsum_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
