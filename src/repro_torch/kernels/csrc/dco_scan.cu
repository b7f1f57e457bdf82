// Staged DCO scan for Hopper (sm_90a): stage-1 partial squared distances
// over the lead dims of a row block, with per-(row, query) freezing against
// tau and early exit.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dco_scan.py,
// dco_scan (row-major x) and dco_scan_grouped (the PDX vertical layout),
// which share one body, _kernel.  Same outputs and the same gating in both
// CUDA bodies below:
//   * a pair entering dim block di is alive iff partial * scales[max(di-1,0)]
//     <= tau (at di = 0 iff tau >= 0); frozen pairs keep their partial;
//   * per dim block, contrib = max(0, |x_b|^2 - 2 x_b.q_b + |q_b|^2) is added
//     to every alive pair (the body's formula, not sum((x-q)^2), so decisions
//     near tau agree with the plain version);
//   * keep = alive at the start of the last dim block
//            & partial * scales[last] <= tau & row < nrows;
//   * counts[row / block_n, q] sums keep, dims[row / block_n, q] sums the
//     dim-block widths over the alive rows below nrows.
// The layouts:
//   flat     x (N, d1) row-major, dim blocks of block_d: x[row*d1 + lo + c];
//   grouped  x (G, N, dg), one contiguous (N, dg) plane per dim group:
//            x[(g*N + row)*dg + c], q[(g*Q + qi)*dg + c]; nd = G blocks of
//            physical width dg (a ragged last group is zero-padded, and its
//            logical width comes in `widths`).
//
// Flat body (dco_scan_kernel<FlatLayout>).  One CUDA block per (BN rows x
// BQ queries) output tile; lane = row, each warp owns QPW queries, so the
// partial stays in registers across the whole dim loop (the TPU kernel kept
// it resident in VMEM across its innermost grid axis).  Each dim block is
// staged through shared memory in TD-wide slices.  When no pair of the tile
// is alive, __syncthreads_or lets the whole block skip the dim block's loads
// and FMAs.  All arithmetic is fp32 FMA: TF32 tensor cores would move
// screening decisions.  Bound: at the main path's shape (4096 x 128 rows x
// dims, 16 queries) one launch must read 2.1 MB and write 0.33 MB, under
// 1 us of HBM time, while its 17 MFLOP take 0.25 us at the fp32 FMA peak:
// memory-bound on paper, launch-bound in practice.
//
// Grouped body (dco_scan_grouped_kernel).  After group 0 only a few rows of
// a tile keep a live pair (at the PDX main path 339 of 4096), so the flat
// body's all-or-nothing tile skip almost never fires there, and its four
// group rounds each wait for a load.  This body moves the inline path's
// compaction inside the kernel and waits for two loads in all:
//   1. group 0 covers every row of a GBN x GBQ tile, one (row, query) pair
//      per thread with its partial in a register, and the flat body's
//      per-pair arithmetic (sequential fmaf over c), so at G = 1 and dg ==
//      block_d the two agree bit for bit.  The tile's group-0 slice (one
//      contiguous GBN x dg span of the plane), its query slices and every
//      group's scale and width are staged with cp.async (16-byte copies
//      for the slices) before the gating;
//   2. a warp ballot per row then gives the tile's rows with a live pair
//      entering group 1, and only those rows' slices are loaded, for every
//      later group at once (one 128-byte line a row and group at dg = 32),
//      with the later groups' query slices; each later group then computes
//      only its live pairs from shared memory.  With non-decreasing scales
//      (the engine's are constant) a pair never comes back to life, so the
//      staged rows cover every later group; a pair that does (dropping
//      scales) reads its slices from global memory, so the result never
//      depends on the scales' shape;
//   3. every thread writes its own pair at the end: a warp covers two whole
//      16-query rows, 64 contiguous bytes each.
// Small tiles (16 x 16) give 256 blocks at the main shape, two per SM, and
// a shared-memory row stride of dg rounded to an odd multiple of 4 floats
// keeps the 16-byte shared loads free of bank conflicts.  Bound: the bytes
// of group 0's plane, the later planes' live rows, and the outputs; the
// kernel also reads, for a row live entering group 1, the later slices in
// which it is already dead.
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

constexpr int BN = 32;                 // rows per tile: one per lane
constexpr int QPW = 2;                 // queries per warp
constexpr int WARPS = 8;
constexpr int BQ = QPW * WARPS;        // queries per tile
constexpr int THREADS = 32 * WARPS;
constexpr int TD = 32;                 // dims staged per shared-memory step

// Row-major x (n, d1) and q (nq, d1), cut into dim blocks of block_d.
struct FlatLayout {
  int d1, block_d;
  __device__ int blocks() const { return (d1 + block_d - 1) / block_d; }
  __device__ int width(int di) const { return min(block_d, d1 - di * block_d); }
  __device__ size_t x_at(int di, int row, int c, int) const {
    return (size_t)row * d1 + di * block_d + c;
  }
  __device__ size_t q_at(int di, int qi, int c, int) const {
    return (size_t)qi * d1 + di * block_d + c;
  }
};

// PDX vertical x (groups, n, dg) and q (groups, nq, dg): dim block = group.
// Instantiated only for the earlier grouped design (dco_scan_grouped_tiled_
// launch below), kept so that chip_smoke.py can time the grouped body
// against it on the same card in the same run; the port never calls it.
struct GroupedLayout {
  int groups, dg;
  __device__ int blocks() const { return groups; }
  __device__ int width(int) const { return dg; }
  __device__ size_t x_at(int g, int row, int c, int n) const {
    return ((size_t)g * n + row) * dg + c;
  }
  __device__ size_t q_at(int g, int qi, int c, int nq) const {
    return ((size_t)g * nq + qi) * dg + c;
  }
};

template <class Layout>
__global__ void __launch_bounds__(THREADS)
dco_scan_kernel(const float* __restrict__ x, const float* __restrict__ q,
                const float* __restrict__ tau,
                const float* __restrict__ scales,
                const float* __restrict__ widths,
                const int32_t* __restrict__ nrows_ptr,
                float* __restrict__ partial, int8_t* __restrict__ keep,
                int32_t* __restrict__ counts, float* __restrict__ dims,
                int n, int nq, Layout lay, int block_n) {
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

  const int nd = lay.blocks();
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
    const int wd = lay.width(di);
    for (int d0 = 0; d0 < wd; d0 += TD) {
      for (int i = threadIdx.x; i < BN * TD; i += THREADS) {
        const int r = i / TD, c = d0 + i % TD;
        const int gr = row0 + r;
        xs[r][i % TD] = (gr < n && c < wd) ? x[lay.x_at(di, gr, c, n)] : 0.0f;
      }
      for (int i = threadIdx.x; i < BQ * TD; i += THREADS) {
        const int r = i / TD, c = d0 + i % TD;
        const int gq = qtile + r;
        qs[r][i % TD] = (gq < nq && c < wd) ? q[lay.q_at(di, gq, c, nq)] : 0.0f;
      }
      __syncthreads();
      const int w = min(TD, wd - d0);
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

template <class Layout>
int launch(const float* x, const float* q, const float* tau,
           const float* scales, const float* widths, const int32_t* nrows,
           float* partial, int8_t* keep, int32_t* counts, float* dims, int n,
           int nq, Layout lay, int block_n, cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (nq + BQ - 1) / BQ);
  dco_scan_kernel<Layout><<<grid, THREADS, 0, stream>>>(
      x, q, tau, scales, widths, nrows, partial, keep, counts, dims, n, nq,
      lay, block_n);
  return (int)cudaGetLastError();
}

// ---- grouped body ---------------------------------------------------------

constexpr int GBN = 16;                 // rows per tile
constexpr int GBQ = 16;                 // queries per tile
constexpr int GTHREADS = GBN * GBQ;     // one (row, query) pair per thread
constexpr int GWARPS = GTHREADS / 32;
static_assert(32 % GBQ == 0 && GBN <= 32, "a warp covers whole rows");

// Shared-memory row stride of a dg-wide slice: dg rounded up to 4 floats,
// made an odd multiple of 4, so the 8 lanes of a 16-byte-load phase that
// read 8 different rows hit 8 disjoint groups of 4 banks.
__host__ __device__ inline int slice_stride(int dg) {
  const int s = (dg + 3) & ~3;
  return ((s >> 2) & 1) ? s : s + 4;
}

// Dynamic shared memory: the tile's x slices (G x GBN rows), query slices
// (G x GBQ rows), and the G scales and widths.
inline size_t grouped_smem_bytes(int groups, int dg) {
  return (size_t)groups * ((GBN + GBQ) * slice_stride(dg) + 2) *
         sizeof(float);
}

// Stage the dg-wide slices (rows of stride dg in global memory) for the
// (group, row) pairs `take` accepts, row i of group g from src(g, i) to
// dst[(g * rows + i) * S]; groups [g0, g1), rows [0, nr).  16-byte copies
// when `vec` (dg % 4 == 0 and a 16-byte aligned base).
template <class Take, class Src>
__device__ __forceinline__ void stage_slices(float* dst, int S, int rows,
                                             int g0, int g1, int nr, int dg,
                                             bool vec, Take take, Src src) {
  const int w = vec ? dg >> 2 : dg;       // copies per slice
  const int per_g = nr * w;
  for (int i = threadIdx.x; i < (g1 - g0) * per_g; i += GTHREADS) {
    const int g = g0 + i / per_g, rem = i % per_g;
    const int r = rem / w, c = (rem - r * w) * (vec ? 4 : 1);
    if (!take(r)) continue;
    float* d = dst + ((size_t)g * rows + r) * S + c;
    if (vec)
      repro::cp_async16(d, src(g, r) + c);
    else
      repro::cp_async4(d, src(g, r) + c);
  }
}

// max(0, |x|^2 - 2 x.q + |q|^2) over one dg slice, each sum a sequential
// fmaf chain over c = 0..dg-1 (the flat body's order).
__device__ __forceinline__ float clamped_contrib(const float* xr,
                                                 const float* qr, int dg) {
  float xn = 0.0f, dot = 0.0f, qn = 0.0f;
  int c = 0;
  if (((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(qr)) &
       15) == 0) {
    for (; c + 4 <= dg; c += 4) {
      const float4 xv = *reinterpret_cast<const float4*>(xr + c);
      const float4 qv = *reinterpret_cast<const float4*>(qr + c);
      const float xa[4] = {xv.x, xv.y, xv.z, xv.w};
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        xn = fmaf(xa[u], xa[u], xn);
        dot = fmaf(xa[u], qa[u], dot);
        qn = fmaf(qa[u], qa[u], qn);
      }
    }
  }
  for (; c < dg; ++c) {
    xn = fmaf(xr[c], xr[c], xn);
    dot = fmaf(xr[c], qr[c], dot);
    qn = fmaf(qr[c], qr[c], qn);
  }
  return fmaxf((xn - 2.0f * dot) + qn, 0.0f);
}

__global__ void __launch_bounds__(GTHREADS)
dco_scan_grouped_kernel(const float* __restrict__ x,
                        const float* __restrict__ q,
                        const float* __restrict__ tau,
                        const float* __restrict__ scales,
                        const float* __restrict__ widths,
                        const int32_t* __restrict__ nrows_ptr,
                        float* __restrict__ partial,
                        int8_t* __restrict__ keep,
                        int32_t* __restrict__ counts,
                        float* __restrict__ dims, int n, int nq, int G,
                        int dg, int block_n) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t warp_rows_s[GWARPS];  // per warp: its rows still live
  __shared__ int cnt_s[GBQ];
  __shared__ float dim_s[GBQ];
  const int S = slice_stride(dg);
  float* xs = smem;                       // (G, GBN, S) slices of x
  float* qs = xs + (size_t)G * GBN * S;   // (G, GBQ, S) slices of q
  float* sc_s = qs + (size_t)G * GBQ * S; // (G) scales, then (G) widths
  float* wd_s = sc_s + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int r = tid / GBQ, j = tid % GBQ;     // this thread's pair
  const int row0 = blockIdx.x * GBN, qtile = blockIdx.y * GBQ;
  const int nr = min(GBN, n - row0), nqt = min(GBQ, nq - qtile);
  const bool aligned = (dg & 3) == 0;
  const bool vx = aligned && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vq = aligned && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  auto all = [](int) { return true; };
  auto x_src = [&](int g, int i) {
    return x + ((size_t)g * n + row0 + i) * dg;
  };
  auto q_src = [&](int g, int i) {
    return q + ((size_t)g * nq + qtile + i) * dg;
  };

  // group 0's x tile (one contiguous span of plane 0) and query slices,
  // every group's scale and width, in flight during the gating
  stage_slices(xs, S, GBN, 0, 1, nr, dg, vx, all, x_src);
  stage_slices(qs, S, GBQ, 0, 1, nqt, dg, vq, all, q_src);
  for (int g = tid; g < G; g += GTHREADS) {
    repro::cp_async4(sc_s + g, scales + g);
    repro::cp_async4(wd_s + g, widths + g);
  }
  repro::cp_async_commit();

  const int row = row0 + r, qi = qtile + j;
  const int nrows = *nrows_ptr;
  const bool row_ok = r < nr, q_ok = j < nqt;
  const bool row_valid = row_ok && row < nrows;
  const float tq = q_ok ? tau[qi] : -1.0f;
  if (tid < GBQ) {
    cnt_s[tid] = 0;
    dim_s[tid] = 0.0f;
  }
  repro::cp_async_wait<0>();
  __syncthreads();
  float acc = 0.0f, dsum = 0.0f;
  bool alive = row_ok && q_ok && (acc * sc_s[0] <= tq);
  if (alive && row_valid) dsum += wd_s[0];
  if (alive) acc += clamped_contrib(xs + r * S, qs + j * S, dg);

  // the tile's rows with a live pair entering group 1 (a warp ballot per
  // row, then one word for the tile): their slices of every later group,
  // one line a row and group at dg = 32, and the later groups' query
  // slices are loaded at once
  uint32_t staged = 0;
  if (G > 1) {
    alive = row_ok && q_ok && (acc * sc_s[0] <= tq);
    const uint32_t b = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) {
      uint32_t rows = 0;
#pragma unroll
      for (int h = 0; h < 32 / GBQ; ++h)
        if ((b >> (h * GBQ)) & ((1u << GBQ) - 1u)) rows |= 1u << h;
      warp_rows_s[warp] = rows;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < GWARPS; ++w)
      staged |= warp_rows_s[w] << (w * (32 / GBQ));
    if (staged) {
      stage_slices(xs, S, GBN, 1, G, nr, dg, vx,
                   [&](int i) { return ((staged >> i) & 1u) != 0; }, x_src);
      stage_slices(qs, S, GBQ, 1, G, nqt, dg, vq, all, q_src);
      repro::cp_async_commit();
      repro::cp_async_wait<0>();
      __syncthreads();
    }
  }
  for (int g = 1; g < G; ++g) {
    if (g > 1) alive = row_ok && q_ok && (acc * sc_s[g - 1] <= tq);
    if (alive && row_valid) dsum += wd_s[g];
    if (alive) {
      // a pair can come back to life only if the scales drop; its row's
      // slice was not staged then (nor, if no row was, the queries'), and
      // is read from global memory
      const float* xr = ((staged >> r) & 1u) ? xs + ((size_t)g * GBN + r) * S
                                             : x_src(g, r);
      const float* qr = staged ? qs + ((size_t)g * GBQ + j) * S : q_src(g, j);
      acc += clamped_contrib(xr, qr, dg);
    }
  }

  const bool kp = alive && row_valid && (acc * sc_s[G - 1] <= tq);
  if (row_ok && q_ok) {
    partial[(size_t)row * nq + qi] = acc;
    keep[(size_t)row * nq + qi] = kp ? 1 : 0;
  }
  if (block_n % GBN == 0) {               // the tile is in one row block
    int kc = kp ? 1 : 0;
    float ds = dsum;
#pragma unroll
    for (int off = GBQ; off < 32; off <<= 1) {
      kc += __shfl_xor_sync(0xffffffffu, kc, off);
      ds += __shfl_xor_sync(0xffffffffu, ds, off);
    }
    if (lane < GBQ) {
      if (kc) atomicAdd(&cnt_s[j], kc);
      if (ds != 0.0f) atomicAdd(&dim_s[j], ds);
    }
    __syncthreads();
    if (tid < nqt) {
      const size_t o = (size_t)(row0 / block_n) * nq + qtile + tid;
      if (cnt_s[tid]) atomicAdd(&counts[o], cnt_s[tid]);
      if (dim_s[tid] != 0.0f) atomicAdd(&dims[o], dim_s[tid]);
    }
  } else if (row_ok && q_ok) {
    const size_t o = (size_t)(row / block_n) * nq + qi;
    if (kp) atomicAdd(&counts[o], 1);
    if (dsum != 0.0f) atomicAdd(&dims[o], dsum);
  }
}

}  // namespace

// Launch on `stream`; counts and dims must be zeroed by the caller.  Each
// returns the cudaError_t of the launch (0 on success).
extern "C" int dco_scan_launch(const float* x, const float* q,
                               const float* tau, const float* scales,
                               const float* widths, const int32_t* nrows,
                               float* partial, int8_t* keep, int32_t* counts,
                               float* dims, int n, int nq, int d1,
                               int block_d, int block_n, cudaStream_t stream) {
  return launch(x, q, tau, scales, widths, nrows, partial, keep, counts, dims,
                n, nq, FlatLayout{d1, block_d}, block_n, stream);
}

// x (groups, n, dg), q (groups, nq, dg): the PDX layout, one dim block per
// group, through the grouped body.
extern "C" int dco_scan_grouped_launch(const float* x, const float* q,
                                       const float* tau, const float* scales,
                                       const float* widths,
                                       const int32_t* nrows, float* partial,
                                       int8_t* keep, int32_t* counts,
                                       float* dims, int n, int nq, int groups,
                                       int dg, int block_n,
                                       cudaStream_t stream) {
  // opt in above 48 KB once per size, so a launch captured into a CUDA
  // graph makes no attribute call
  static size_t opted_in = 48 * 1024;
  const size_t smem = grouped_smem_bytes(groups, dg);
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        dco_scan_grouped_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  const dim3 grid((n + GBN - 1) / GBN, (nq + GBQ - 1) / GBQ);
  dco_scan_grouped_kernel<<<grid, GTHREADS, smem, stream>>>(
      x, q, tau, scales, widths, nrows, partial, keep, counts, dims, n, nq,
      groups, dg, block_n);
  return (int)cudaGetLastError();
}

// The same layout through the flat body: the earlier grouped design, for
// timing only (see GroupedLayout).
extern "C" int dco_scan_grouped_tiled_launch(
    const float* x, const float* q, const float* tau, const float* scales,
    const float* widths, const int32_t* nrows, float* partial, int8_t* keep,
    int32_t* counts, float* dims, int n, int nq, int groups, int dg,
    int block_n, cudaStream_t stream) {
  return launch(x, q, tau, scales, widths, nrows, partial, keep, counts, dims,
                n, nq, GroupedLayout{groups, dg}, block_n, stream);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
