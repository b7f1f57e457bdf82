// PQ asymmetric-distance scan for Hopper (sm_90a): DDCopq's screening pass,
//   adist[n, q] = sum_m lut[q, m, codes[n, m]].
//
// Replaces the Pallas TPU kernel src/repro/kernels/pq_lookup.py::pq_lookup
// (body _kernel), which turned the gather into a one-hot x LUT matmul
// because the TPU has no fast gather.  Hopper gathers from shared memory,
// so this is the direct form: each CUDA block stages the (M, K) LUTs of
// `bq` queries in shared memory (16 KB per query at M = 16, K = 256; the
// Python launcher picks bq from its shared-memory budget, and above 48 KB
// this launcher opts in to dynamic shared memory), and each thread takes
// one row, reads its M codes and accumulates the gathered entries for the
// staged queries, TQ of them at a time in registers.  A code outside [0, K) adds nothing, as a one-hot
// row of zeros does in the TPU kernel.
//
// Bound.  At the main path's shape (4096 rows x 16 codes, 16 queries) one
// launch must read 0.26 MB of codes and 0.26 MB of LUTs and write 0.26 MB:
// memory-bound at well under 1 us of HBM time.  Codes stay int32 as the
// engine stores them; narrowing them to uint8 is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TQ = 8;         // staged queries accumulated in registers at once

__global__ void __launch_bounds__(THREADS)
pq_lookup_kernel(const int32_t* __restrict__ codes,
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
  for (int q0 = 0; q0 < nqb; q0 += TQ) {
    const int nt = min(TQ, nqb - q0);
    float acc[TQ];
#pragma unroll
    for (int t = 0; t < TQ; ++t) acc[t] = 0.0f;
    for (int j = 0; j < m; ++j) {
      const int c = cr[j];
      if ((unsigned)c >= (unsigned)k) continue;
      const float* base = lut_s + (size_t)q0 * per_q + j * k + c;
#pragma unroll
      for (int t = 0; t < TQ; ++t)
        if (t < nt) acc[t] += base[t * per_q];
    }
#pragma unroll
    for (int t = 0; t < TQ; ++t)
      if (t < nt) o[q0 + t] = acc[t];
  }
}

}  // namespace

// Launch on `stream` with `bq` queries staged per block; the caller sizes
// bq so that bq * m * k floats fit in one block's shared memory.
// Returns the cudaError_t of the attribute call or the launch.
extern "C" int pq_lookup_launch(const int32_t* codes, const float* lut,
                                float* out, int n, int nq, int m, int k,
                                int bq, cudaStream_t stream) {
  // opt in above 48 KB once per size, so a launch captured into a CUDA
  // graph makes no attribute call
  static size_t opted_in = 48 * 1024;
  const size_t smem = (size_t)bq * m * k * sizeof(float);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((n + THREADS - 1) / THREADS, (nq + bq - 1) / bq);
  pq_lookup_kernel<<<grid, THREADS, smem, stream>>>(codes, lut, out, n, nq,
                                                    m, k, bq);
  return (int)cudaGetLastError();
}
