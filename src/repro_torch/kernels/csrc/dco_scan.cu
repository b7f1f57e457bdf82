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
// Flat body (dco_scan_flat_kernel).  What held the first flat design (the
// tiled body below) back at the main path's shape (4096 rows x 16 queries x
// 128 dims, nd = 1) was fixed cost and serial latency, not work: 128
// blocks on 132 SMs, four global round trips a dim block (32-dim slices,
// scalar loads, a barrier each) and a zero fill of counts and dims before
// every launch, for atomics.  This body:
//   1. covers FBN x FBQ = 32 x 16 tiles with 128 threads, each thread 2
//      rows x 2 queries with their partials in registers across the dim
//      loop.  One pair a thread (16 x 16 tiles, 256 threads) spent its time
//      in shared-memory loads, two 16-byte loads for four FMAs; a 2 x 2
//      block of pairs loads four for sixteen, and 32-row tiles read the
//      queries from L2 half as often;
//   2. stages a dim block's whole tile (the 32 rows' and the 16 queries'
//      block_d-wide slices, 16 KB and 8 KB at block_d = 128) in one cp.async
//      round trip, 16-byte copies when d1 and block_d are multiples of 4.
//      Dim block 0 is in flight during the gating; for a later block the
//      tile-level skip (__syncthreads_or over its live pairs) decides first
//      whether it is loaded at all.  No prefetch of the next dim block: the
//      main path has one;
//   3. keeps the per-pair arithmetic of the tiled and grouped bodies: xn,
//      dot and qn as sequential fmaf chains over c, then
//      max(0, (xn - 2 dot) + qn), so the integer-valued parity stays exact
//      and the grouped body at G = 1 agrees bit for bit.  A thread runs the
//      eight chains of its 2 x 2 pairs side by side, its shared loads one
//      step ahead;
//   4. writes counts and dims without a zero fill: when block_n is a
//      multiple of FBN up to MAX_CLUSTER (8, the portable size) tiles, one
//      thread block cluster covers one row block.  Each block sums its keep
//      counts and dims per query, stores them into rank 0's shared memory
//      (distributed shared memory), and rank 0 adds the cluster's sums in
//      rank order and stores them: the op is the kernel alone.  Any other
//      block_n takes the caller's zero fill and atomics (dco_scan_fill_free
//      says which).  The cluster costs time of its own: the GPCs' sizes
//      likely leave some SMs with two blocks of a launch of 8-block
//      clusters.
// All arithmetic is fp32 FMA: TF32 tensor cores would move screening
// decisions.  Bound: at the main shape one launch must read 2.1 MB and
// write 0.33 MB, 0.73 us of HBM time, while its 17 MFLOP take 0.25 us at
// the fp32 FMA peak: bytes on paper, launch and latency in practice.
//
// Tiled body (dco_scan_kernel<Layout>), the first design of both layouts,
// kept only so that chip_smoke.py can time the flat and grouped bodies
// against it on the same card in the same run (dco_scan_tiled_launch,
// dco_scan_grouped_tiled_launch); the port never calls it.  One CUDA block
// per (BN rows x BQ queries) tile, lane = row, each warp owns QPW queries;
// each dim block staged through shared memory in TD-wide slices.
//
// Grouped body (dco_scan_grouped_kernel).  After group 0 only a few rows of
// a tile keep a live pair (at the PDX main path 339 of 4096), so the tiled
// body's all-or-nothing tile skip almost never fires there, and its four
// group rounds each wait for a load.  This body moves the inline path's
// compaction inside the kernel and waits for two loads in all:
//   1. group 0 covers every row of a GBN x GBQ tile, one (row, query) pair
//      per thread with its partial in a register, and the flat bodies'
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
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"

namespace {

// ---- tiled body (timing only) ----------------------------------------------

constexpr int BN = 32;                 // rows per tile: one per lane
constexpr int QPW = 2;                 // queries per warp
constexpr int WARPS = 8;
constexpr int BQ = QPW * WARPS;        // queries per tile
constexpr int THREADS = 32 * WARPS;
constexpr int TD = 32;                 // dims staged per shared-memory step

// Row-major x (n, d1) and q (nq, d1), cut into dim blocks of block_d.
// Instantiated only for the earlier flat design (dco_scan_tiled_launch).
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
// Instantiated only for the earlier grouped design
// (dco_scan_grouped_tiled_launch).
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
// fmaf chain over c = 0..dg-1 (the flat bodies' order).
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

// ---- flat body -------------------------------------------------------------

constexpr int FBN = 32;                 // rows per tile
constexpr int FBQ = 16;                 // queries per tile
constexpr int RPT = 2;                  // rows per thread: rg, rg + FRG
constexpr int QPT = 2;                  // queries per thread: qg, qg + FQG
constexpr int FRG = FBN / RPT;          // row groups
constexpr int FQG = FBQ / QPT;          // query groups
constexpr int FTHREADS = FRG * FQG;     // 128: each thread 2 x 2 pairs
constexpr int FWARPS = FTHREADS / 32;
constexpr int MAX_CLUSTER = 8;          // the portable cluster size
static_assert(32 % FQG == 0 && FTHREADS % 32 == 0, "a warp covers whole rows");

// Blocks per cluster when one thread block cluster covers a row block of
// block_n rows (block_n a multiple of FBN, at most MAX_CLUSTER tiles): the
// cluster then stores counts and dims.  0 otherwise: the caller zeroes them
// and the kernel adds with atomics.
inline int flat_cluster_size(int block_n) {
  return (block_n % FBN == 0 && block_n / FBN <= MAX_CLUSTER) ? block_n / FBN
                                                              : 0;
}

// Dynamic shared memory: one dim block's x slices (FBN rows) and query
// slices (FBQ rows).
inline size_t flat_smem_bytes(int block_d) {
  return (size_t)(FBN + FBQ) * slice_stride(block_d) * sizeof(float);
}

// Split cluster barrier: arrive, then wait for every thread of the cluster
// (release / acquire unless relaxed).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// Stage the w-wide slices of rows [0, nr), row i from src + i * ld to
// dst + i * S: 16-byte copies when `vec` (src, ld and w multiples of 4
// floats), else 4-byte copies.
__device__ __forceinline__ void stage_rows(float* dst, int S, const float* src,
                                           size_t ld, int nr, int w,
                                           bool vec) {
  const int step = vec ? 4 : 1;
  const int per = w / step;              // copies a row
  for (int i = threadIdx.x; i < nr * per; i += FTHREADS) {
    const int r = i / per, c = (i - r * per) * step;
    if (vec)
      repro::cp_async16(dst + r * S + c, src + r * ld + c);
    else
      repro::cp_async4(dst + r * S + c, src + r * ld + c);
  }
}

// One dim block of a thread's 2 x 2 pairs from shared memory: x rows xr,
// xr + FRG * S and query rows qr, qr + FQG * S, w dims.  Each of the eight
// sums (four dots, two |x|^2, two |q|^2) is one sequential fmaf chain over
// c = 0..w-1, the order of clamped_contrib's; the 16-byte loads run one
// step ahead of the FMAs.
__device__ __forceinline__ void pair_sums(const float* xr, const float* qr,
                                          int S, int w, float (&xn)[RPT],
                                          float (&qn)[QPT],
                                          float (&dot)[RPT][QPT]) {
#pragma unroll
  for (int i = 0; i < RPT; ++i) xn[i] = 0.0f;
#pragma unroll
  for (int k = 0; k < QPT; ++k) qn[k] = 0.0f;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int k = 0; k < QPT; ++k) dot[i][k] = 0.0f;
  auto load = [&](int c, float4 (&xv)[RPT], float4 (&qv)[QPT]) {
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      xv[i] = *reinterpret_cast<const float4*>(xr + i * FRG * S + c);
#pragma unroll
    for (int k = 0; k < QPT; ++k)
      qv[k] = *reinterpret_cast<const float4*>(qr + k * FQG * S + c);
  };
  const int w4 = w & ~3;
  float4 xv[RPT], qv[QPT];
  if (w4) load(0, xv, qv);
#pragma unroll 2
  for (int c = 0; c < w4; c += 4) {
    float4 xw[RPT], qw[QPT];
    load(c + 4 < w4 ? c + 4 : c, xw, qw);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a[4] = {xv[i].x, xv[i].y, xv[i].z, xv[i].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) xn[i] = fmaf(a[u], a[u], xn[i]);
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const float b[4] = {qv[k].x, qv[k].y, qv[k].z, qv[k].w};
#pragma unroll
      for (int u = 0; u < 4; ++u) qn[k] = fmaf(b[u], b[u], qn[k]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        dot[i][k] = fmaf(xv[i].x, qv[k].x, dot[i][k]);
        dot[i][k] = fmaf(xv[i].y, qv[k].y, dot[i][k]);
        dot[i][k] = fmaf(xv[i].z, qv[k].z, dot[i][k]);
        dot[i][k] = fmaf(xv[i].w, qv[k].w, dot[i][k]);
      }
#pragma unroll
    for (int i = 0; i < RPT; ++i) xv[i] = xw[i];
#pragma unroll
    for (int k = 0; k < QPT; ++k) qv[k] = qw[k];
  }
  for (int c = w4; c < w; ++c) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float a = xr[i * FRG * S + c];
      xn[i] = fmaf(a, a, xn[i]);
    }
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const float b = qr[k * FQG * S + c];
      qn[k] = fmaf(b, b, qn[k]);
    }
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int k = 0; k < QPT; ++k)
        dot[i][k] = fmaf(xr[i * FRG * S + c], qr[k * FQG * S + c], dot[i][k]);
  }
}

template <bool kCluster>
__global__ void __launch_bounds__(FTHREADS)
dco_scan_flat_kernel(const float* __restrict__ x, const float* __restrict__ q,
                     const float* __restrict__ tau,
                     const float* __restrict__ scales,
                     const float* __restrict__ widths,
                     const int32_t* __restrict__ nrows_ptr,
                     float* __restrict__ partial, int8_t* __restrict__ keep,
                     int32_t* __restrict__ counts, float* __restrict__ dims,
                     int n, int nq, int d1, int block_d, int block_n) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int cnt_w[FWARPS][FBQ];    // per warp: keep counts per query
  __shared__ float dim_w[FWARPS][FBQ];  // per warp: dims entered per query
  __shared__ int cnt_c[MAX_CLUSTER][FBQ];    // rank 0: each block's sums
  __shared__ float dim_c[MAX_CLUSTER][FBQ];
  // every block of the cluster has started before a remote store (waited on
  // at the end, so the arrival costs nothing)
  if constexpr (kCluster) cluster_arrive_relaxed();

  const int S = slice_stride(block_d);
  float* xs = smem;                     // (FBN, S) x slices of a dim block
  float* qs = smem + FBN * S;           // (FBQ, S) query slices
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rg = tid / FQG, qg = tid % FQG;  // rows rg + i FRG, queries
  const int row0 = blockIdx.x * FBN, qtile = blockIdx.y * FBQ;  // qg + k FQG
  const int nr = min(FBN, n - row0), nqt = min(FBQ, nq - qtile);
  const bool aligned = ((d1 | block_d) & 3) == 0;
  const bool vx = aligned && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const bool vq = aligned && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const int nd = (d1 + block_d - 1) / block_d;
  auto stage = [&](int di) {            // one round trip: x and q slices
    const int lo = di * block_d, w = min(block_d, d1 - lo);
    stage_rows(xs, S, x + (size_t)row0 * d1 + lo, d1, nr, w, vx);
    stage_rows(qs, S, q + (size_t)qtile * d1 + lo, d1, nqt, w, vq);
    repro::cp_async_commit();
  };
  stage(0);                             // in flight during the gating

  const int nrows = *nrows_ptr;
  bool row_ok[RPT], row_valid[RPT], q_ok[QPT];
  float tq[QPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = rg + i * FRG;
    row_ok[i] = r < nr;
    row_valid[i] = row_ok[i] && row0 + r < nrows;
  }
#pragma unroll
  for (int k = 0; k < QPT; ++k) {
    const int j = qg + k * FQG;
    q_ok[k] = j < nqt;
    tq[k] = q_ok[k] ? tau[qtile + j] : -1.0f;
  }
  float acc[RPT][QPT], dsum[RPT][QPT];
  bool alive[RPT][QPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      acc[i][k] = dsum[i][k] = 0.0f;
      alive[i][k] = false;
    }
  for (int di = 0; di < nd; ++di) {
    const float prev = scales[di > 0 ? di - 1 : 0];
    const float width = widths[di];
    bool any = false;
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int k = 0; k < QPT; ++k) {
        alive[i][k] = row_ok[i] && q_ok[k] && (acc[i][k] * prev <= tq[k]);
        if (alive[i][k] && row_valid[i]) dsum[i][k] += width;
        any |= alive[i][k];
      }
    if (di > 0) {
      if (!__syncthreads_or(any)) continue;   // tile-level early exit
      stage(di);
    }
    repro::cp_async_wait<0>();
    __syncthreads();
    if (any) {
      float xn[RPT], qn[QPT], dot[RPT][QPT];
      pair_sums(xs + rg * S, qs + qg * S, S, min(block_d, d1 - di * block_d),
                xn, qn, dot);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int k = 0; k < QPT; ++k)
          if (alive[i][k])
            acc[i][k] += fmaxf((xn[i] - 2.0f * dot[i][k]) + qn[k], 0.0f);
    }
    __syncthreads();                    // the slices are free after this
  }

  const float last = scales[nd - 1];
  const bool spans = !kCluster && block_n % FBN != 0;  // tile in two blocks
  int kc[QPT] = {};
  float ds[QPT] = {};
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      const bool kp = alive[i][k] && row_valid[i] && (acc[i][k] * last <= tq[k]);
      if (!row_ok[i] || !q_ok[k]) continue;
      const int row = row0 + rg + i * FRG, qi = qtile + qg + k * FQG;
      partial[(size_t)row * nq + qi] = acc[i][k];
      keep[(size_t)row * nq + qi] = kp ? 1 : 0;
      if (spans) {
        const size_t o = (size_t)(row / block_n) * nq + qi;
        if (kp) atomicAdd(&counts[o], 1);
        if (dsum[i][k] != 0.0f) atomicAdd(&dims[o], dsum[i][k]);
      }
      kc[k] += kp ? 1 : 0;
      ds[k] += dsum[i][k];
    }
  if (spans) return;
  // the tile lies in one row block: its sums per query, the warp's rows by
  // shuffles, then the warps in order
#pragma unroll
  for (int k = 0; k < QPT; ++k)
#pragma unroll
    for (int off = FQG; off < 32; off <<= 1) {
      kc[k] += __shfl_xor_sync(0xffffffffu, kc[k], off);
      ds[k] += __shfl_xor_sync(0xffffffffu, ds[k], off);
    }
  if (lane < FQG) {
#pragma unroll
    for (int k = 0; k < QPT; ++k) {
      cnt_w[warp][lane + k * FQG] = kc[k];
      dim_w[warp][lane + k * FQG] = ds[k];
    }
  }
  __syncthreads();
  int bc = 0;
  float bd = 0.0f;
  if (tid < FBQ) {
#pragma unroll
    for (int w = 0; w < FWARPS; ++w) {
      bc += cnt_w[w][tid];
      bd += dim_w[w][tid];
    }
  }
  const size_t o = (size_t)(row0 / block_n) * nq + qtile + tid;
  if constexpr (kCluster) {
    // every block stores its sums into rank 0's shared memory; rank 0 adds
    // them in rank order and stores them
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = (int)cluster.block_rank();
    cluster_wait();
    if (tid < FBQ) {
      cluster.map_shared_rank(&cnt_c[0][0], 0)[rank * FBQ + tid] = bc;
      cluster.map_shared_rank(&dim_c[0][0], 0)[rank * FBQ + tid] = bd;
    }
    cluster_arrive();
    cluster_wait();
    if (rank == 0 && tid < nqt) {
      const int csize = (int)cluster.num_blocks();
      int c = 0;
      float d = 0.0f;
      for (int b = 0; b < csize; ++b) {
        c += cnt_c[b][tid];
        d += dim_c[b][tid];
      }
      counts[o] = c;
      dims[o] = d;
    }
  } else if (tid < nqt) {
    if (bc) atomicAdd(&counts[o], bc);
    if (bd != 0.0f) atomicAdd(&dims[o], bd);
  }
}

// Opt in above 48 KB of dynamic shared memory, once per instantiation and
// size, so that a launch captured into a CUDA graph makes no attribute call.
template <bool kCluster>
cudaError_t flat_prepare(size_t smem) {
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        dco_scan_flat_kernel<kCluster>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    opted_in = smem;
  }
  return cudaSuccess;
}

// The cluster launch's configuration: grid, block, shared memory, stream
// and the cluster dimension (attr must outlive cfg's use).
cudaLaunchConfig_t cluster_config(dim3 grid, size_t smem, int csize,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(FTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = csize;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// 1 when dco_scan_launch stores counts and dims itself at this block_n (a
// thread block cluster a row block), 0 when the caller must zero them.
extern "C" int dco_scan_fill_free(int block_n) {
  return flat_cluster_size(block_n) > 0;
}

// Launch on `stream`.  Each launcher returns the cudaError_t of the launch
// (0 on success).  counts and dims must be zeroed by the caller unless
// dco_scan_fill_free(block_n); the grouped and tiled launchers always add
// to them.
extern "C" int dco_scan_launch(const float* x, const float* q,
                               const float* tau, const float* scales,
                               const float* widths, const int32_t* nrows,
                               float* partial, int8_t* keep, int32_t* counts,
                               float* dims, int n, int nq, int d1,
                               int block_d, int block_n, cudaStream_t stream) {
  const int csize = flat_cluster_size(block_n);
  const size_t smem = flat_smem_bytes(block_d);
  const int tiles = (n + FBN - 1) / FBN;
  // a cluster path grid covers whole row blocks (blocks past n add zeros)
  const dim3 grid(csize ? (tiles + csize - 1) / csize * csize : tiles,
                  (nq + FBQ - 1) / FBQ);
  if (csize) {
    cudaError_t e = flat_prepare<true>(smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg =
        cluster_config(grid, smem, csize, stream, &attr);
    e = cudaLaunchKernelEx(&cfg, dco_scan_flat_kernel<true>, x, q, tau,
                           scales, widths, nrows, partial, keep, counts, dims,
                           n, nq, d1, block_d, block_n);
    const cudaError_t last = cudaGetLastError();
    return (int)(e != cudaSuccess ? e : last);
  }
  const cudaError_t e = flat_prepare<false>(smem);
  if (e != cudaSuccess) return (int)e;
  dco_scan_flat_kernel<false><<<grid, FTHREADS, smem, stream>>>(
      x, q, tau, scales, widths, nrows, partial, keep, counts, dims, n, nq,
      d1, block_d, block_n);
  return (int)cudaGetLastError();
}

// How many clusters of the fill-free launch at (block_d, block_n) the card
// holds at once (cudaOccupancyMaxActiveClusters); 0 when block_n takes the
// atomic path, minus the cudaError_t on failure.
extern "C" int dco_scan_max_active_clusters(int block_d, int block_n) {
  const int csize = flat_cluster_size(block_n);
  if (!csize) return 0;
  const size_t smem = flat_smem_bytes(block_d);
  cudaError_t e = flat_prepare<true>(smem);
  if (e != cudaSuccess) return -(int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      cluster_config(dim3(csize), smem, csize, nullptr, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(
      &clusters, (const void*)dco_scan_flat_kernel<true>, &cfg);
  return e != cudaSuccess ? -(int)e : clusters;
}

// The same launch through the tiled body: the earlier flat design, for
// timing only (counts and dims zeroed by the caller).
extern "C" int dco_scan_tiled_launch(const float* x, const float* q,
                                     const float* tau, const float* scales,
                                     const float* widths,
                                     const int32_t* nrows, float* partial,
                                     int8_t* keep, int32_t* counts,
                                     float* dims, int n, int nq, int d1,
                                     int block_d, int block_n,
                                     cudaStream_t stream) {
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

// The same layout through the tiled body: the earlier grouped design, for
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
