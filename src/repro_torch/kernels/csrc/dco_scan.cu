// Staged DCO scan for Hopper (sm_90a): stage-1 partial squared distances
// over the lead dims of a row block, with per-(row, query) freezing against
// tau and a tile-level early exit.
//
// Replaces the Pallas TPU kernel src/repro/kernels/dco_scan.py::dco_scan
// (body _kernel).  Same outputs and the same gating:
//   * a pair entering dim block di is alive iff partial * scales[max(di-1,0)]
//     <= tau (at di = 0 iff tau >= 0); frozen pairs keep their partial;
//   * per dim block, contrib = max(0, |x_b|^2 - 2 x_b.q_b + |q_b|^2) is added
//     to every alive pair (the body's formula, not sum((x-q)^2), so decisions
//     near tau agree with the plain version);
//   * keep = alive at the start of the last dim block
//            & partial * scales[last] <= tau & row < nrows;
//   * counts[row / block_n, q] sums keep, dims[row / block_n, q] sums the
//     dim-block widths over the alive rows below nrows.
//
// Design.  One CUDA block per (BN rows x BQ queries) output tile; lane =
// row, each warp owns QPW queries, so the partial stays in registers across
// the whole dim loop (the TPU kernel kept it resident in VMEM across its
// innermost grid axis).  Each dim block is staged through shared memory in
// TD-wide slices.  When no pair of the tile is alive, __syncthreads_or lets
// the whole block skip the dim block's loads and FMAs.  All arithmetic is
// fp32 FMA: TF32 tensor cores would move screening decisions.
//
// Bound.  At the main path's shape (4096 x 128 rows x dims, 16 queries) one
// launch must read 2.1 MB and write 0.33 MB, under 1 us of HBM time, while
// its 17 MFLOP take 0.25 us at the fp32 FMA peak: memory-bound on paper,
// launch-bound in practice.  This first version is simple, not fast (no
// TMA, no wgmma, no pipelining).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 32;                 // rows per tile: one per lane
constexpr int QPW = 2;                 // queries per warp
constexpr int WARPS = 8;
constexpr int BQ = QPW * WARPS;        // queries per tile
constexpr int THREADS = 32 * WARPS;
constexpr int TD = 32;                 // dims staged per shared-memory step

__global__ void __launch_bounds__(THREADS)
dco_scan_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const float* __restrict__ tau,
                const float* __restrict__ scales,
                const float* __restrict__ widths,
                const int32_t* __restrict__ nrows_ptr,
                float* __restrict__ partial, int8_t* __restrict__ keep,
                int32_t* __restrict__ counts, float* __restrict__ dims,
                int n, int nq, int d1, int block_d, int block_n) {
  __shared__ float xs[BN][TD + 1];
  __shared__ float qs[BQ][TD + 1];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int row0 = blockIdx.x * BN;
  const int qtile = blockIdx.y * BQ;
  const int row = row0 + lane;
  const int nrows = *nrows_ptr;
  const bool row_ok = row < n;
  const bool row_valid = row_ok && row < nrows;

  int qi[QPW];
  bool q_ok[QPW];
  float tq[QPW], acc[QPW], dsum[QPW];
  bool alive[QPW];
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    qi[j] = qtile + warp * QPW + j;
    q_ok[j] = qi[j] < nq;
    tq[j] = q_ok[j] ? tau[qi[j]] : -1.0f;
    acc[j] = 0.0f;
    dsum[j] = 0.0f;
    alive[j] = false;
  }

  const int nd = (d1 + block_d - 1) / block_d;
  for (int di = 0; di < nd; ++di) {
    const float prev = scales[di > 0 ? di - 1 : 0];
    const float width = widths[di];
    int any = 0;
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      alive[j] = row_ok && q_ok[j] && (acc[j] * prev <= tq[j]);
      if (alive[j] && row_valid) dsum[j] += width;
      any |= alive[j];
    }
    if (!__syncthreads_or(any)) continue;   // tile-level early exit

    float xn = 0.0f, dot[QPW], qn[QPW];
#pragma unroll
    for (int j = 0; j < QPW; ++j) dot[j] = qn[j] = 0.0f;
    const int lo = di * block_d;
    const int hi = min(lo + block_d, d1);
    for (int d0 = lo; d0 < hi; d0 += TD) {
      for (int i = threadIdx.x; i < BN * TD; i += THREADS) {
        const int r = i / TD, c = i % TD;
        const int gr = row0 + r, gc = d0 + c;
        xs[r][c] = (gr < n && gc < hi) ? x[(size_t)gr * d1 + gc] : 0.0f;
      }
      for (int i = threadIdx.x; i < BQ * TD; i += THREADS) {
        const int r = i / TD, c = i % TD;
        const int gq = qtile + r, gc = d0 + c;
        qs[r][c] = (gq < nq && gc < hi) ? q[(size_t)gq * d1 + gc] : 0.0f;
      }
      __syncthreads();
      const int w = min(TD, hi - d0);
      for (int c = 0; c < w; ++c) {
        const float xv = xs[lane][c];
        xn = fmaf(xv, xv, xn);
#pragma unroll
        for (int j = 0; j < QPW; ++j) {
          const float qv = qs[warp * QPW + j][c];
          dot[j] = fmaf(xv, qv, dot[j]);
          qn[j] = fmaf(qv, qv, qn[j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < QPW; ++j) {
      const float contrib = (xn - 2.0f * dot[j]) + qn[j];
      if (alive[j]) acc[j] += fmaxf(contrib, 0.0f);
    }
  }

  const float last = scales[nd - 1];
  const bool whole_tile = (block_n % BN) == 0;   // the tile is in one row block
  const int rb = row / block_n;
#pragma unroll
  for (int j = 0; j < QPW; ++j) {
    const bool kp = alive[j] && row_valid && (acc[j] * last <= tq[j]);
    if (row_ok && q_ok[j]) {
      partial[(size_t)row * nq + qi[j]] = acc[j];
      keep[(size_t)row * nq + qi[j]] = kp ? 1 : 0;
    }
    if (whole_tile) {
      int kc = kp ? 1 : 0;
      float ds = dsum[j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        kc += __shfl_xor_sync(0xffffffffu, kc, off);
        ds += __shfl_xor_sync(0xffffffffu, ds, off);
      }
      if (lane == 0 && q_ok[j]) {
        const size_t o = (size_t)(row0 / block_n) * nq + qi[j];
        if (kc) atomicAdd(&counts[o], kc);
        if (ds != 0.0f) atomicAdd(&dims[o], ds);
      }
    } else if (row_ok && q_ok[j]) {
      const size_t o = (size_t)rb * nq + qi[j];
      if (kp) atomicAdd(&counts[o], 1);
      if (dsum[j] != 0.0f) atomicAdd(&dims[o], dsum[j]);
    }
  }
}

}  // namespace

// Launch on `stream`; counts and dims must be zeroed by the caller.  Returns
// the cudaError_t of the launch (0 on success).
extern "C" int dco_scan_launch(const float* x, const float* q,
                               const float* tau, const float* scales,
                               const float* widths, const int32_t* nrows,
                               float* partial, int8_t* keep, int32_t* counts,
                               float* dims, int n, int nq, int d1,
                               int block_d, int block_n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (nq + BQ - 1) / BQ);
  dco_scan_kernel<<<grid, THREADS, 0, stream>>>(
      x, q, tau, scales, widths, nrows, partial, keep, counts, dims, n, nq,
      d1, block_d, block_n);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
