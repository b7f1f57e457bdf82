// PQ asymmetric-distance scan for Hopper (sm_90a): DDCopq's screening pass,
//   adist[n, q] = sum_m lut[q, m, codes[n, m]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_lookup.py::pq_lookup
// (body _kernel), which turned the gather into a one-hot x LUT matmul
// because the TPU has no fast gather.  Hopper gathers from shared memory,
// so this is the direct form.  A code outside [0, K) adds nothing, as a
// one-hot row of zeros does in the TPU kernel.  The sum is fp32, in the
// order m = 0..M-1.
//
// Bound.  At the main path's shape (4096 rows x 16 uint8 codes, 16 queries,
// K = 256) one launch must read 64 KB of codes and 256 KB of LUTs and
// write 256 KB: about 0.18 us of HBM time, memory-bound.  In practice the
// launch is latency-bound: every block must stage its queries' LUTs (16 KB
// each) before its first gather.
//
// Design.  One body, templated on the code type (uint8 when K <= 256, as
// the engine stores them, else int32).  One CUDA block per (256 rows x bq
// queries) tile, one row per thread.  The L2-to-shared LUT traffic is
// (row tiles) x (all LUTs) whatever bq is, so the tile keeps 256 rows and
// the launcher splits the queries until the grid holds two blocks per SM
// (bq = 1 at the main shape: 16 x 16 = 256 blocks of 16 KB each, against
// 48 blocks of 96 KB before).  The block's LUTs are staged with cp.async
// (16-byte copies, no registers), and while they are in flight each
// thread loads its row's first 16 codes into registers: one 16-byte load
// at M = 16 uint8, four at int32.  Each thread writes its row's bq
// outputs; at bq = 1 a block owns one 4-byte column of each row, so
// staging the outputs through shared memory would not make the row writes
// longer.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int THREADS = 256;  // one row per thread
constexpr int TQ = 4;         // staged queries accumulated in registers at once
constexpr int PRE = 16;       // codes of a row held in registers

template <class CodeT>
__device__ __forceinline__ void unpack(const uint4& w, int* out);

template <>
__device__ __forceinline__ void unpack<uint8_t>(const uint4& w, int* out) {
  const uint32_t v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = (v[i >> 2] >> (8 * (i & 3))) & 0xff;
}

template <>
__device__ __forceinline__ void unpack<int32_t>(const uint4& w, int* out) {
  out[0] = (int)w.x;
  out[1] = (int)w.y;
  out[2] = (int)w.z;
  out[3] = (int)w.w;
}

// acc[t] += lut_q[t][c] over the nt queries of the register chunk
__device__ __forceinline__ void gather_add(float* acc, const float* lut_j,
                                           int c, int k, int per_q, int nt) {
  if ((unsigned)c >= (unsigned)k) return;
#pragma unroll
  for (int t = 0; t < TQ; ++t)
    if (t < nt) acc[t] += lut_j[t * per_q + c];
}

template <class CodeT>
__global__ void __launch_bounds__(THREADS)
pq_lookup_kernel(const CodeT* __restrict__ codes,
                 const float* __restrict__ lut, float* __restrict__ out,
                 int n, int nq, int m, int k, int bq) {
  extern __shared__ __align__(16) float lut_s[];    // (bq, m, k)
  const int qbase = blockIdx.y * bq;
  const int nqb = min(bq, nq - qbase);
  const int per_q = m * k;
  repro::copy_floats_async(lut_s, lut + (size_t)qbase * per_q, nqb * per_q,
                           threadIdx.x, THREADS);
  repro::cp_async_commit();

  // the row's first PRE codes, loaded while the LUTs are in flight
  constexpr int V = 16 / sizeof(CodeT);             // codes per 16-byte load
  const int row = blockIdx.x * THREADS + threadIdx.x;
  const bool ok = row < n;
  const CodeT* cr = codes + (size_t)row * m;
  const bool vec = (m % V) == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  int pre[PRE];
#pragma unroll
  for (int j = 0; j < PRE; ++j) pre[j] = 0;
  if (ok) {
    if (vec) {
#pragma unroll
      for (int v = 0; v < PRE / V; ++v)
        if (v * V < m)
          unpack<CodeT>(*reinterpret_cast<const uint4*>(cr + v * V),
                        pre + v * V);
    } else {
#pragma unroll
      for (int j = 0; j < PRE; ++j)
        if (j < m) pre[j] = (int)cr[j];
    }
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  if (!ok) return;

  float* o = out + (size_t)row * nq + qbase;
  for (int q0 = 0; q0 < nqb; q0 += TQ) {
    const int nt = min(TQ, nqb - q0);
    const float* lq = lut_s + (size_t)q0 * per_q;
    float acc[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) acc[t] = 0.0f;
#pragma unroll
    for (int j = 0; j < PRE; ++j)
      if (j < m) gather_add(acc, lq + j * k, pre[j], k, per_q, nt);
    for (int j = PRE; j < m; ++j)
      gather_add(acc, lq + j * k, (int)cr[j], k, per_q, nt);
#pragma unroll
    for (int t = 0; t < TQ; ++t)
      if (t < nt) o[q0 + t] = acc[t];
  }
}

template <class CodeT>
int launch(const CodeT* codes, const float* lut, float* out, int n, int nq,
           int m, int k, int bq, cudaStream_t stream) {
  // opt in above 48 KB once per size, so a launch captured into a CUDA
  // graph makes no attribute call
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)bq * m * k * sizeof(float);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_lookup_kernel<CodeT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((n + THREADS - 1) / THREADS, (nq + bq - 1) / bq);
  pq_lookup_kernel<CodeT><<<grid, THREADS, smem, stream>>>(codes, lut, out, n,
                                                           nq, m, k, bq);
  return (int)cudaGetLastError();
}

// The earlier design, kept only so that chip_smoke.py can time the kernel
// above against it on the same card in the same run; the port never calls
// it.  Int32 codes; each block stages the LUTs of bq queries with scalar
// loads before it reads a code, one thread per row, TQ_STAGED queries in
// registers at once.
constexpr int TQ_STAGED = 8;

__global__ void __launch_bounds__(THREADS)
pq_lookup_staged_kernel(const int32_t* __restrict__ codes,
                        const float* __restrict__ lut, float* __restrict__ out,
                        int n, int nq, int m, int k, int bq) {
  extern __shared__ float lut_s[];                  // (bq, m, k)
  const int qbase = blockIdx.y * bq;
  const int nqb = min(bq, nq - qbase);
  const int per_q = m * k;
  const float* src = lut + (size_t)qbase * per_q;
  for (int i = threadIdx.x; i < nqb * per_q; i += THREADS) lut_s[i] = src[i];
  __syncthreads();

  const int row = blockIdx.x * THREADS + threadIdx.x;
  if (row >= n) return;
  const int32_t* cr = codes + (size_t)row * m;
  float* o = out + (size_t)row * nq + qbase;
  for (int q0 = 0; q0 < nqb; q0 += TQ_STAGED) {
    const int nt = min(TQ_STAGED, nqb - q0);
    float acc[TQ_STAGED];
#pragma unroll
    for (int t = 0; t < TQ_STAGED; ++t) acc[t] = 0.0f;
    for (int j = 0; j < m; ++j) {
      const int c = cr[j];
      if ((unsigned)c >= (unsigned)k) continue;
      const float* base = lut_s + (size_t)q0 * per_q + j * k + c;
#pragma unroll
      for (int t = 0; t < TQ_STAGED; ++t)
        if (t < nt) acc[t] += base[t * per_q];
    }
#pragma unroll
    for (int t = 0; t < TQ_STAGED; ++t)
      if (t < nt) o[q0 + t] = acc[t];
  }
}

}  // namespace

// Launch on `stream` with `bq` queries staged per block; the caller sizes
// bq so that bq * m * k floats fit in one block's shared memory.  Each
// returns the cudaError_t of the attribute call or the launch.
extern "C" int pq_lookup_u8_launch(const uint8_t* codes, const float* lut,
                                   float* out, int n, int nq, int m, int k,
                                   int bq, cudaStream_t stream) {
  return launch(codes, lut, out, n, nq, m, k, bq, stream);
}

extern "C" int pq_lookup_i32_launch(const int32_t* codes, const float* lut,
                                    float* out, int n, int nq, int m, int k,
                                    int bq, cudaStream_t stream) {
  return launch(codes, lut, out, n, nq, m, k, bq, stream);
}

extern "C" int pq_lookup_staged_launch(const int32_t* codes, const float* lut,
                                       float* out, int n, int nq, int m,
                                       int k, int bq, cudaStream_t stream) {
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)bq * m * k * sizeof(float);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_lookup_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((n + THREADS - 1) / THREADS, (nq + bq - 1) / bq);
  pq_lookup_staged_kernel<<<grid, THREADS, smem, stream>>>(codes, lut, out, n,
                                                           nq, m, k, bq);
  return (int)cudaGetLastError();
}
