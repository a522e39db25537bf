// Fused explicit Runge–Kutta solve of a controlled differential equation
//   dz = f(z) dX(t),  f(z) in R^{H x C}
// forward and backward kernels for NVIDIA Hopper (sm_90a), plain C interface
// (loaded with ctypes by snsde_torch/kernels/fused_cde.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_cde.py:
//   forward  _fused_cde_forward (pallas_call at :364, body _fwd_kernel :320,
//            field _field_forward :184)
//   backward _fused_cde_backward (pallas_call at :505, body _bwd_kernel :385,
//            field _field_bwd :218)
// for the FinalTanh field (relu MLP, any number of inner layers) and the
// SingleHiddenLayer field (tanh, no inner layer), on the euler, midpoint,
// heun (= rk2) and rk4 tableaus. The activation is a template parameter;
// the tableau is a small table in the kernel's arguments (the stage loops
// run rolled, so one kernel serves every tableau).
//
// One field evaluation at a stage state y, for each batch row:
//   h_0 = act(y Win + bin);  h_{l+1} = act(h_l W_l + b_l)
//   O = tanh(h_NI Wout + bout)            [H*C], h-major: O[h*C + c]
//   k[h] = sum_c O[h*C + c] dX/dt[c]      (dX/dt at the stage's time)
// and a step z <- z + dt sum_i b_i k_i with the stage states
// y_i = z + dt sum_j A_ij k_j (every tableau here has one nonzero A_ij a
// stage, at j = i - 1). The TPU kernel does the contraction with one-hot
// matrix products (a lane-layout device); here each thread sums its C
// products directly. The control-derivative stream dx [M, B, NT*C] holds,
// per step, dX/dt at the NT distinct stage times; it is differentiated
// (ddx), so a learned control trains through the kernel.
//
// What bounds it on the H100: at the rk4 shapes (B=1024, 136 steps, H=32)
// the forward does 9.4 GFLOP at C=6 and 44 GFLOP at C=35, about 0.14 and
// 0.65 ms at 67 TFLOP/s fp32 (operations, not bytes, bound it). What held
// the first design back (one 256-thread block per 8 rows, one dependent
// chain of H or HH FMAs per output over scalar shared reads, dWout
// read-modified-written in device memory every stage, every stage
// recomputed twice in the backward) was latency: a stage took ~8,500
// cycles for ~500 cycles of FMA work (PERF.md section 6 has the split).
//
// The design:
// * A cluster of CS CTAs (CS in {1, 2, 4, 8}) runs the whole loop for R
//   batch rows. CTA j owns the state units [j U, j U + nu), U = ceil(H /
//   CS), and their C columns of Wout (a contiguous block, O being h-major):
//   its slice of O, of the contraction k and, in the backward, of dz, dWout
//   and dbout, of the state's and the stages' cotangents. The contraction
//   needs no exchange; each CTA pushes its slice of k into every CTA of the
//   cluster through distributed shared memory, one cluster barrier a
//   stage. The hidden layers are small at the main paths' widths: every
//   CTA computes them in full for its rows (the same code on the same
//   values, so the CTAs agree bit for bit).
// * 512 threads a CTA. The forward products are register tiles (4 rows x
//   2 outputs, or 1 x 1 where that keeps more threads busy) over float4
//   reads along K, each output one FMA chain in ascending k: the order of
//   the plain versions' matrix products, so a relu's input rounds as
//   theirs does. The backward's products through a weight's transpose
//   split their long K over adjacent lanes, summed by a shuffle tree in a
//   fixed order.
// * Backward: dk, dz and the weight gradients of a stage come from the
//   activations the forward pass of the step left; the back product
//   through Wout is a partial per CTA over its own columns, summed in rank
//   order over the cluster (double-buffered: one cluster barrier a stage),
//   as is the control cotangent (once a step). dWout and dbout of the own
//   columns are accumulated in the CTA's shared memory for the whole loop
//   and written once; the hidden layers' gradients are split by rows over
//   the cluster's CTAs (rank 0 owns the biases), one owner an entry. The
//   per-cluster partials are summed by the wrapper in a fixed order: no
//   atomics, runs are bit-reproducible.
// * The backward keeps each stage's hidden activations and O slice where
//   the plan finds room (12 forward-equivalents of work an rk4 step, not
//   15); else it recomputes the stage before reversing it.
// * The next step's rows of dx (and, in the backward, of the state before
//   the step and of gys) are prefetched with cp.async a step ahead.
// * The host plan (cde_plan) weighs levels of what fits a CTA's 227 KB:
//   0 everything in shared memory; 1 the hidden weights read from device
//   memory; 2 the hidden layers' gradients in the cluster's partials in
//   device memory; 3 dWout too; 4 as 3 with the Wout slice read from
//   device memory and the hidden weights back in shared memory; 5 every
//   weight from device memory; 6 as 5 with 4, 2 or 1 rows. Of every level, CS and rows a cluster
//   whose CTA fits, it takes the least estimated time (waves x a stage's
//   FMAs, phases and cluster barriers in a CTA, weighed for what device
//   memory serves).
//   cudaOccupancyMaxActiveClusters must find room for a cluster, else the
//   launch is refused (no fallback).
// Exact fp32 FMA on the CUDA cores (TF32 off).

#include <cooperative_groups.h>

#include <cmath>
#include <map>
#include <mutex>
#include <tuple>

#include "sde_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int CT = 512;  // threads a CTA
constexpr unsigned FULL = 0xffffffffu;
constexpr int LEVELS = 7;  // plan levels (see the head of the file)
constexpr int MAX_STAGES = 4;

struct CdeDims {
  int M, B, H, HH, C, NI;
};

// An explicit tableau (snsde/kernels/fused_cde.py:67-77): stage i evaluates
// at state z + a[i] dt k_{i-1} and stage time t + c_i dt, whose index among
// the nt distinct stage times is t[i]; the step adds dt b[i] k_i.
struct Tab {
  int ns, nt;
  float a[MAX_STAGES], b[MAX_STAGES];
  int t[MAX_STAGES];
};

// method codes of the C interface: 0 euler, 1 midpoint, 2 heun/rk2, 3 rk4
inline bool tableau(int method, Tab* T) {
  switch (method) {
    case 0: *T = Tab{1, 1, {0.f}, {1.f}, {0}}; return true;
    case 1: *T = Tab{2, 2, {0.f, 0.5f}, {0.f, 1.f}, {0, 1}}; return true;
    case 2: *T = Tab{2, 2, {0.f, 1.f}, {0.5f, 0.5f}, {0, 1}}; return true;
    case 3:
      *T = Tab{4, 3, {0.f, 0.5f, 0.5f, 1.f},
               {1.f / 6.f, 1.f / 3.f, 1.f / 3.f, 1.f / 6.f}, {0, 1, 1, 2}};
      return true;
  }
  return false;
}

template <bool RELU>
__device__ __forceinline__ float act(float z) {
  return RELU ? fmaxf(z, 0.f) : tanhf(z);
}

// derivative of the activation from its output h
template <bool RELU>
__device__ __forceinline__ float act_d(float h) {
  return RELU ? (h > 0.f ? 1.f : 0.f) : 1.f - h * h;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// row stride of a float4-read tile: a multiple of 4 floats, not of 32
// (rows at neighbouring k of a column walk fall on distinct banks)
__host__ __device__ inline int ld4(int n) {
  const int r = round4(n);
  return (r & 31) ? r : r + 4;
}

// The plan of a launch: CTAs a cluster, batch rows a cluster, the level
// (what lives in shared memory: hw the hidden weights, hg the hidden
// layers' gradients, og dWout/dbout, ow the Wout/bout slice), and whether
// the backward keeps the step's stage activations.
struct CdePlan {
  int cs, R, level, keep;
  int hw, hg, og, ow;
  long long bytes;
};

__host__ __device__ inline void set_level(CdePlan& p, int level) {
  p.level = level;
  p.hw = level < 1 || level == 4;
  p.hg = level < 2;
  p.og = level < 3;
  p.ow = level < 4;
}

// The shared-memory layout of a CTA, offsets in floats (-1: not there).
// Forward: weights; z [R4][sH]; k of the step's stages [2][NS][R4][sH]
// (double-buffered by step); hidden tiles [2][R4][sHH] (ping-pong); the
// O slice [R4][ldQ]; the step's dx rows [2][R4][NTC4]. Backward: weights;
// the accumulators (dWout slice [HH][ldQ], dbout slice, own rows of dWin
// [U][HH4] and of each W_l [NI][UH][HH4], dbin [HH4], db_l [NI][HH4]); k
// [NS][R4][sH]; hidden tiles [nk][NI+1][R4][sHH] and O slices [nk][R4][ldQ]
// (nk = NS when kept, else 1; dz takes O's place); the own units'
// cotangents of the state and of the stages' k [1+NS][R4][U4]; e0, e1
// [R4][sHH]; the partial dh [2][R4][sHH] and control cotangent
// [2][R4][NTC4]; the prefetched state [2][R4][sH], own gys [2][R4][U4] and
// dx rows [2][R4][NTC4].
struct Layout {
  long long win, bin, wi, bi, wo, bo;
  long long gwo, gbo, gwin, gbin, gwi, gbi;
  long long z, ks, hk, ok, gbar, dks, e0, e1, pd, ddp, gyb, dxb;
  long long total;
};

struct Take {
  long long at = 0;
  __host__ __device__ long long operator()(long long n) {
    const long long o = at;
    at += (n + 3) & ~3LL;
    return o;
  }
};

__host__ __device__ inline Layout cde_layout(const CdeDims& d,
                                             const CdePlan& p, int ns,
                                             int nt, int bwd) {
  Layout L;
  Take take;
  const long long NI = d.NI;
  const long long U = (d.H + p.cs - 1) / p.cs, UH = (d.HH + p.cs - 1) / p.cs;
  const long long sH = ld4(d.H), sHH = ld4(d.HH), ldQ = ld4((int)U * d.C);
  const long long R4 = round4(p.R), NTC4 = round4(nt * d.C);
  const long long H4 = round4(d.H), HH4 = round4(d.HH), U4 = round4((int)U);
  L.win = p.hw ? take(H4 * sHH) : -1;
  L.bin = p.hw ? take(HH4) : -1;
  L.wi = p.hw ? take(NI * HH4 * sHH) : -1;
  L.bi = p.hw ? take(NI * HH4) : -1;
  L.wo = p.ow ? take(HH4 * ldQ) : -1;
  L.bo = p.ow ? take(ldQ) : -1;
  L.gwo = L.gbo = L.gwin = L.gbin = L.gwi = L.gbi = -1;
  L.gbar = L.dks = L.e0 = L.e1 = L.pd = L.ddp = L.gyb = -1;
  if (!bwd) {
    L.z = take(R4 * sH);
    L.ks = take(2 * ns * R4 * sH);
    L.hk = take(2 * R4 * sHH);
    L.ok = take(R4 * ldQ);
    L.dxb = take(2 * R4 * NTC4);
    L.total = take(0);
    return L;
  }
  if (p.og) {
    L.gwo = take(d.HH * ldQ);
    L.gbo = take(ldQ);
  }
  if (p.hg) {
    L.gwin = take(U * HH4);
    L.gbin = take(HH4);
    L.gwi = take(NI * UH * HH4);
    L.gbi = take(NI * HH4);
  }
  const long long nk = p.keep ? ns : 1;
  L.ks = take(ns * R4 * sH);
  L.hk = take(nk * (NI + 1) * R4 * sHH);
  L.ok = take(nk * R4 * ldQ);
  L.gbar = take(R4 * U4);
  L.dks = take(ns * R4 * U4);
  L.e0 = take(R4 * sHH);
  L.e1 = take(R4 * sHH);
  L.pd = take(2 * R4 * sHH);
  L.ddp = take(2 * R4 * NTC4);
  L.z = take(2 * R4 * sH);  // the state before the step, prefetched
  L.gyb = take(2 * R4 * U4);
  L.dxb = take(2 * R4 * NTC4);
  L.total = take(0);
  return L;
}

// ---------------------------------------------------------------------------
// Device helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[r][c] <- src[r * sr + c] for r < nr, c < n, asynchronously (each
// call starts at thread 0: chained calls cost the recurrent kernels 5-12%)
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, size_t sr, int n,
                                          int nr) {
  for (int i = threadIdx.x; i < nr * n; i += CT) {
    const int r = i / n, c = i - r * n;
    cp_async4(dst + r * ld + c, src + r * sr + c);
  }
}

__device__ __forceinline__ void zero_smem(float* s, long long n) {
  for (long long i = threadIdx.x; i < n; i += CT) s[i] = 0.f;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// The cluster's barrier, ordering shared and distributed shared memory at
// cluster scope (far costlier than a CTA's barrier on an H100)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// a cluster of one needs only the block's barrier
__device__ __forceinline__ void cluster_or_block_sync(int cs) {
  if (cs == 1)
    __syncthreads();
  else
    cluster_sync();
}

// Lanes a product's K is split over: the largest power of 2, at most 32
// and at most the K chunks, with items x lanes <= CT.
__device__ __forceinline__ int k_lanes(int items, int chunks) {
  int ks = 1;
  while (ks < 32 && ks * 2 <= chunks && items * ks * 2 <= CT) ks *= 2;
  return ks;
}

// sum over a group of KS adjacent lanes into its first lane, in a fixed
// order (every lane of the warp must call it)
__device__ __forceinline__ float lane_sum(float v, int KS) {
  for (int o = KS >> 1; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  return v;
}

// Y = X W over items of RT rows x NT columns a thread: epi(r, n, sum_{k<K}
// x[r][k] W[k][n]) for r < nr, n < N, where x = X, or with x2 X + alpha
// X2, rows of stride ldx with zero columns up to round4(K) and rows up to
// round4(nr). Each output is one FMA chain over k in ascending order (the
// order of the plain versions' matrix products, so a relu's input rounds
// as theirs does), read as float4 along k. W [K][ldw] in shared memory
// (gw false: zero rows up to round4(K), zero columns up to NT ceil(N / NT),
// ldw a multiple of NT) or in device memory at its own stride (gw:
// guarded scalar reads). No barrier.
template <int RT, int NT, class Epi>
__device__ __forceinline__ void mm_tile(const float* X, const float* X2,
                                        float alpha, bool x2, int ldx, int K,
                                        const float* W, int ldw, bool gw,
                                        int nr, int N, Epi epi) {
  const int NC = (N + NT - 1) / NT, items = ((nr + RT - 1) / RT) * NC;
  const int K4 = round4(K);
  for (int item = threadIdx.x; item < items; item += CT) {
    const int n0 = (item % NC) * NT, r0 = (item / NC) * RT;
    float acc[RT][NT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[i][j] = 0.f;
#pragma unroll 4
    for (int k = 0; k < K4; k += 4) {
      float4 x[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        x[i] = ld_f4(X + (r0 + i) * ldx + k);
        if (x2) {
          const float4 v = ld_f4(X2 + (r0 + i) * ldx + k);
          x[i].x = fmaf(alpha, v.x, x[i].x);
          x[i].y = fmaf(alpha, v.y, x[i].y);
          x[i].z = fmaf(alpha, v.z, x[i].z);
          x[i].w = fmaf(alpha, v.w, x[i].w);
        }
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        float w[NT];
        const float* wr = W + (size_t)(k + kk) * ldw + n0;
        if (gw) {
#pragma unroll
          for (int j = 0; j < NT; ++j)
            w[j] = (k + kk < K && n0 + j < N) ? __ldg(wr + j) : 0.f;
        } else if (NT == 2) {
          const float2 v = *reinterpret_cast<const float2*>(wr);
          w[0] = v.x;
          w[NT - 1] = v.y;
        } else {
#pragma unroll
          for (int j = 0; j < NT; ++j) w[j] = wr[j];
        }
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j)
            acc[i][j] = fmaf(lane4(x[i], kk), w[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
        if (r0 + i < nr && n0 + j < N) epi(r0 + i, n0 + j, acc[i][j]);
  }
}

// Y = X W (mm_tile): the smallest tile of 1 x 1, 1 x 2, 2 x 2 and 4 x 2
// whose items fit one pass of the CTA's threads (4 x 2 when none does):
// every thread busy where the outputs allow, and independent chains
// beside each other where they are few
template <class Epi>
__device__ __forceinline__ void mm(const float* X, const float* X2,
                                   float alpha, bool x2, int ldx, int K,
                                   const float* W, int ldw, bool gw, int nr,
                                   int N, Epi epi) {
  const int n2 = (N + 1) >> 1;
  if (nr * N <= CT)
    mm_tile<1, 1>(X, X2, alpha, x2, ldx, K, W, ldw, gw, nr, N, epi);
  else if (nr * n2 <= CT)
    mm_tile<1, 2>(X, X2, alpha, x2, ldx, K, W, ldw, gw, nr, N, epi);
  else if (((nr + 1) >> 1) * n2 <= CT)
    mm_tile<2, 2>(X, X2, alpha, x2, ldx, K, W, ldw, gw, nr, N, epi);
  else
    mm_tile<4, 2>(X, X2, alpha, x2, ldx, K, W, ldw, gw, nr, N, epi);
}

// Y = E W^T: epi(r, k, sum_{c<Nc} E[r][c] W[k][c]) for r < nr, k < N (a
// back product: rows of W walked contiguously). E rows of stride lde with
// zero columns up to round4(Nc) and rows up to round4(nr); W [N][ldw] in
// shared memory (gw false: zero columns up to round4(Nc), rows up to
// 2 ceil(N / 2) readable) or device memory at its own stride (gw:
// guarded). Items of 4 rows x 2 outputs, the c loop split over adjacent
// lanes (k_lanes) in float4 chunks; no barrier.
template <class Epi>
__device__ __forceinline__ void mm_t(const float* E, int lde, int Nc,
                                     const float* W, int ldw, bool gw,
                                     int nr, int N, Epi epi) {
  const int NC = (N + 1) >> 1, items = ((nr + 3) >> 2) * NC;
  const int C4 = round4(Nc), KS = k_lanes(items, C4 >> 2);
  const int total = items * KS;
  for (int base = 0; base < total; base += CT) {
    const int t = base + threadIdx.x;
    const bool on = t < total;
    const int item = t / KS, ks = t & (KS - 1);
    const int k0 = (item % NC) * 2, r0 = (item / NC) * 4;
    float acc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[i][0] = acc[i][1] = 0.f;
    if (on) {
#pragma unroll 2
      for (int c = ks * 4; c < C4; c += KS * 4) {
        float4 e[4], w[2];
#pragma unroll
        for (int i = 0; i < 4; ++i) e[i] = ld_f4(E + (r0 + i) * lde + c);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float* wr = W + (size_t)(k0 + j) * ldw + c;
          if (gw) {
            const bool ok = k0 + j < N;
            w[j].x = ok && c < Nc ? __ldg(wr) : 0.f;
            w[j].y = ok && c + 1 < Nc ? __ldg(wr + 1) : 0.f;
            w[j].z = ok && c + 2 < Nc ? __ldg(wr + 2) : 0.f;
            w[j].w = ok && c + 3 < Nc ? __ldg(wr + 3) : 0.f;
          } else {
            w[j] = ld_f4(wr);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            float a = fmaf(e[i].x, w[j].x, acc[i][j]);
            a = fmaf(e[i].y, w[j].y, a);
            a = fmaf(e[i].z, w[j].z, a);
            acc[i][j] = fmaf(e[i].w, w[j].w, a);
          }
      }
    }
    // the K lanes' sums, the eight outputs' shuffles of a level side by
    // side
    for (int o = KS >> 1; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          acc[i][j] += __shfl_down_sync(FULL, acc[i][j], o);
    if (on && ks == 0) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (r0 + i < nr && k0 + j < N) epi(r0 + i, k0 + j, acc[i][j]);
    }
  }
}

// A weight gradient: G[k - k0][c] += sum_{r<nr} x[r][k] E[r][c] for the
// owned rows k in [k0, k0 + nk) and c < Nc, x = X (with x2, X + alpha
// X2); with has_gb, also gb[c] += sum_r E[r][c]. An item is 4 rows k x 4
// columns c, so each float4 of E feeds 16 FMAs (rows past nk are summed
// from the tile's neighbouring, finite entries and not stored). E rows of
// stride lde with zero columns up to round4(Nc). G (and gb) in shared
// memory (rows of ldg floats, float4 read-modify-writes) or, with gdev,
// the cluster's partials in device memory (row stride ldg, guarded). One
// thread an entry a phase; no barrier.
__device__ __forceinline__ void grad(const float* X, const float* X2,
                                     float alpha, bool x2, int ldx, int k0,
                                     int nk, const float* E, int lde, int Nc,
                                     float* G, int ldg, float* gb,
                                     bool has_gb, bool gdev, int nr) {
  const int NQ = round4(Nc) >> 2, kitems = ((nk + 3) >> 2) * NQ;
  const int items = kitems + (has_gb ? NQ : 0);
  for (int it = threadIdx.x; it < items; it += CT) {
    if (it >= kitems) {  // the bias
      const int c = (it - kitems) * 4;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float4 e = ld_f4(E + r * lde + c);
        acc.x += e.x;
        acc.y += e.y;
        acc.z += e.z;
        acc.w += e.w;
      }
      float* g = gb + c;
      if (!gdev) {
        float4 v = ld_f4(g);
        v.x += acc.x;
        v.y += acc.y;
        v.z += acc.z;
        v.w += acc.w;
        *reinterpret_cast<float4*>(g) = v;
      } else {
        if (c < Nc) g[0] += acc.x;
        if (c + 1 < Nc) g[1] += acc.y;
        if (c + 2 < Nc) g[2] += acc.z;
        if (c + 3 < Nc) g[3] += acc.w;
      }
      continue;
    }
    const int kr0 = (it / NQ) * 4, c = (it - (it / NQ) * NQ) * 4;
    const int k = k0 + kr0;
    float4 acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int r = 0; r < nr; ++r) {
      const float4 e = ld_f4(E + r * lde + c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = X[r * ldx + k + j];
        if (x2) x = fmaf(alpha, X2[r * ldx + k + j], x);
        acc[j].x = fmaf(x, e.x, acc[j].x);
        acc[j].y = fmaf(x, e.y, acc[j].y);
        acc[j].z = fmaf(x, e.z, acc[j].z);
        acc[j].w = fmaf(x, e.w, acc[j].w);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (kr0 + j >= nk) break;
      float* g = G + (size_t)(kr0 + j) * ldg + c;
      if (!gdev) {
        float4 v = ld_f4(g);
        v.x += acc[j].x;
        v.y += acc[j].y;
        v.z += acc[j].z;
        v.w += acc[j].w;
        *reinterpret_cast<float4*>(g) = v;
      } else {
        if (c < Nc) g[0] += acc[j].x;
        if (c + 1 < Nc) g[1] += acc[j].y;
        if (c + 2 < Nc) g[2] += acc[j].z;
        if (c + 3 < Nc) g[3] += acc[j].w;
      }
    }
  }
}

// The field's weights as the products read them, and the CTA's geometry.
// Shared-memory copies: Win [H4][sHH], bin, W_l [NI][HH4][sHH], b_l
// [NI][HH4], the Wout slice [HH4][ldQ], bout slice; or the tensors in
// device memory at their own strides (the Wout slice from column u0 C).
struct Net {
  const float *win, *bin, *wi, *bi, *wo, *bo;
  int lwin, lwi, swi, sbi, lwo;
  int gwh, gwo;  // hidden / output weights in device memory
  int H, HH, C, NI, cs, rank, u0, nu, h0, nh, nr;
  int sH, sHH, ldQ, NTC4, U4;
};

// the gradient accumulators: shared memory, or the cluster's partials
struct Acc {
  float *wo, *bo, *win, *bin, *wi, *bi;
  int lwo, lwin, lwi, swi, sbi;
  int dev_h, dev_o;
};

// The field's hidden layers and the O slice for the nr rows whose stage
// state is z (with has_kp, z + alpha kp): layer l into tile l % nt of h
// (tiles htile floats apart), O into o [R4][ldQ]. Ends after a barrier.
// Inlined, as every phase function is, into kernels that run the stage
// loop rolled: the tiles' pointers stay known as shared memory (32-bit
// addresses, LDS), and each kernel holds one copy of the code.
template <bool RELU, bool WIDE>
__device__ __forceinline__ void field_forward(const Net n, const float* z,
                                              const float* kp, bool has_kp,
                                              float alpha, float* h, int nt,
                                              int htile, float* o) {
  const int HH = n.HH, sHH = n.sHH;
  const float* bin = n.bin;
  // the first layer
  mm(z, kp, alpha, has_kp, n.sH, n.H, n.win, n.lwin, WIDE && n.gwh, n.nr, HH,
     [&](int r, int j, float a) { h[r * sHH + j] = act<RELU>(a + bin[j]); });
  __syncthreads();
  for (int l = 0; l < n.NI; ++l) {
    // the inner layers
    const float* hin = h + (l % nt) * htile;
    float* hout = h + ((l + 1) % nt) * htile;
    const float* b = n.bi + l * n.sbi;
    mm(hin, hin, 0.f, false, sHH, HH, n.wi + (size_t)l * n.swi, n.lwi,
       WIDE && n.gwh, n.nr, HH, [&](int r, int j, float a) {
         hout[r * sHH + j] = act<RELU>(a + b[j]);
       });
    __syncthreads();
  }
  // the output projection, own columns
  const float* hl = h + (n.NI % nt) * htile;
  const float* bo = n.bo;
  const int ldQ = n.ldQ;
  mm(hl, hl, 0.f, false, sHH, HH, n.wo, n.lwo, WIDE && n.gwo, n.nr,
     n.nu * n.C,
     [&](int r, int q, float a) { o[r * ldQ + q] = tanhf(a + bo[q]); });
  __syncthreads();
}

// k[r][h] = sum_c O[r][(h - u0) C + c] dxt[r][c] for the own units, stored
// into kd ([R4][sH]) of every CTA of the cluster. No barrier.
__device__ __forceinline__ void contract_push(const Net n, const float* o,
                                              const float* dxt, float* kd) {
  const int C = n.C, nu = n.nu;
  for (int i = threadIdx.x; i < n.nr * nu; i += CT) {
    const int r = i / nu, hl = i - r * nu;
    const float* orow = o + r * n.ldQ + hl * C;
    const float* drow = dxt + r * n.NTC4;
    float acc = 0.f;
    for (int c = 0; c < C; ++c) acc = fmaf(orow[c], drow[c], acc);
    const int e = r * n.sH + n.u0 + hl;
    if (n.cs == 1) {
      kd[e] = acc;
    } else {
      cg::cluster_group cl = cg::this_cluster();
      for (int peer = 0; peer < n.cs; ++peer)
        cl.map_shared_rank(kd, peer)[e] = acc;
    }
  }
}

// What the back pass through one field evaluation reads and writes.
struct BwdTiles {
  const float *z, *kp;   // the stage state is z (with has_kp, z + alpha kp)
  int has_kp;
  float alpha;
  const float* h;        // the evaluation's hidden tiles (NI+1, htile apart)
  int htile;
  float* o;              // its O slice [R4][ldQ], overwritten by dz
  const float *dk, *dxt; // the own cotangent of its k [R4][U4]; dx's row
  float* ddt;            // the CTA's partial of the control cotangent
  float *e0, *e1;        // scratch
  float* pd;             // this stage's partial dh (cs > 1)
  float *gbar, *dkp;     // own units: += dy, and (with has_dkp) += ap dy
  int has_dkp;
  float ap;
};

// Back through one field evaluation. Adds the own units' share of the
// control cotangent into ddt, the gradients into the accumulators, the own
// units' dy into gbar and ap dy into dkp. Ends after a barrier; with
// cs > 1 it holds a cluster barrier after the partial dh is written.
template <bool RELU, bool WIDE>
__device__ __forceinline__ void field_backward(const Net n, const Acc g,
                                               const BwdTiles b) {
  const int HH = n.HH, C = n.C, NI = n.NI, nr = n.nr, nu = n.nu;
  const int sH = n.sH, sHH = n.sHH, ldQ = n.ldQ, NTC4 = n.NTC4, U4 = n.U4;
  const int QC = nu * C, tid = threadIdx.x;
  const float* hlast = b.h + NI * b.htile;

  // the control, dd[c] += sum_{h own} dk[h] O[h, c] (h split over lanes)
  {
    const int items = nr * C, KS = k_lanes(items, nu), total = items * KS;
    for (int base = 0; base < total; base += CT) {
      const int t = base + tid;
      const bool on = t < total;
      const int item = t / KS, ks = t & (KS - 1);
      const int r = item / C, c = item - r * C;
      float acc = 0.f;
      if (on)
        for (int hl = ks; hl < nu; hl += KS)
          acc = fmaf(b.dk[r * U4 + hl], b.o[r * ldQ + hl * C + c], acc);
      acc = lane_sum(acc, KS);
      if (on && ks == 0) b.ddt[r * NTC4 + c] += acc;
    }
  }
  __syncthreads();
  // dz = dk dX/dt (1 - O^2) of the own columns, in O's place
  for (int i = tid; i < nr * QC; i += CT) {
    const int r = i / QC, q = i - r * QC, hl = q / C, c = q - hl * C;
    float* op = b.o + r * ldQ + q;
    const float o = *op;
    *op = (b.dk[r * U4 + hl] * b.dxt[r * NTC4 + c]) * (1.f - o * o);
  }
  __syncthreads();

  // dWout and dbout of the own columns; the CTA's partial of the back
  // product through Wout (with cs == 1 the whole of it, taken through the
  // last activation into e0)
  const float* dz = b.o;
  grad(hlast, hlast, 0.f, false, sHH, 0, HH, dz, ldQ, QC, g.wo, g.lwo, g.bo,
       true, WIDE && g.dev_o, nr);
  if (n.cs == 1) {
    float* e0 = b.e0;
    mm_t(dz, ldQ, QC, n.wo, n.lwo, WIDE && n.gwo, nr, HH,
         [&](int r, int k, float a) {
           e0[r * sHH + k] = a * act_d<RELU>(hlast[r * sHH + k]);
         });
    __syncthreads();
  } else {
    float* pd = b.pd;
    mm_t(dz, ldQ, QC, n.wo, n.lwo, WIDE && n.gwo, nr, HH,
         [&](int r, int k, float a) { pd[r * sHH + k] = a; });
    cluster_sync();
    // the cluster's partials in rank order
    cg::cluster_group cl = cg::this_cluster();
    for (int i = tid; i < nr * HH; i += CT) {
      const int r = i / HH, k = i - r * HH, e = r * sHH + k;
      float s = cl.map_shared_rank(b.pd, 0)[e];
      for (int peer = 1; peer < n.cs; ++peer)
        s += cl.map_shared_rank(b.pd, peer)[e];
      b.e0[e] = s * act_d<RELU>(hlast[e]);
    }
    __syncthreads();
  }

  // the inner layers in reverse (own rows of their gradients; rank 0 owns
  // the biases)
  float* ein = b.e0;
  float* eout = b.e1;
  for (int l = NI - 1; l >= 0; --l) {
    const float* hprev = b.h + l * b.htile;
    grad(hprev, hprev, 0.f, false, sHH, n.h0, n.nh, ein, sHH, HH,
         g.wi + (size_t)l * g.swi, g.lwi, g.bi + l * g.sbi, n.rank == 0,
         WIDE && g.dev_h, nr);
    float* eo = eout;
    mm_t(ein, sHH, HH, n.wi + (size_t)l * n.swi, n.lwi, WIDE && n.gwh, nr,
         HH, [&](int r, int k, float a) {
           eo[r * sHH + k] = a * act_d<RELU>(hprev[r * sHH + k]);
         });
    __syncthreads();
    float* t = ein;
    ein = eout;
    eout = t;
  }

  // Win and bin (own rows; the stage state formed as it is read), and the
  // own units' dy = ein Win^T into gbar and the previous stage's k
  // cotangent
  grad(b.z, b.kp, b.alpha, b.has_kp, sH, n.u0, n.nu, ein, sHH, HH, g.win,
       g.lwin, g.bin, n.rank == 0, WIDE && g.dev_h, nr);
  float* gbar = b.gbar;
  float* dkp = b.dkp;
  const bool has_dkp = b.has_dkp;
  const float ap = b.ap;
  mm_t(ein, sHH, HH, n.win + (size_t)n.u0 * n.lwin, n.lwin, WIDE && n.gwh,
       nr, nu, [&](int r, int k, float a) {
         gbar[r * U4 + k] += a;
         if (has_dkp) dkp[r * U4 + k] += ap * a;
       });
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

struct FwdArgs {
  CdeDims d;
  const float *z0, *dx, *dts, *win, *bin, *wi, *bi, *wo, *bo;
  float* ys;
};

struct BwdArgs {
  CdeDims d;
  const float *z0, *ys, *gys, *dx, *dts, *win, *bin, *wi, *bi, *wo, *bo;
  float *ddx, *dz0, *p_win, *p_bin, *p_wi, *p_bi, *p_wo, *p_bo;
};

// the main paths' instance (WIDE false) has everything in shared memory
template <bool WIDE>
__device__ __forceinline__ CdePlan placed(CdePlan p) {
  if (!WIDE) {
    p.hw = p.hg = p.og = p.ow = 1;
  }
  return p;
}

// The CTA's geometry and weights; the shared-memory copies are filled
// (rows and columns past the weights' own stay zero: the caller zeroes
// shared memory first).
__device__ __forceinline__ Net make_net(const CdeDims& d, const CdePlan& p,
                                        const Layout& L, float* s, int nt,
                                        const float* __restrict__ win,
                                        const float* __restrict__ bin,
                                        const float* __restrict__ wi,
                                        const float* __restrict__ bi,
                                        const float* __restrict__ wo,
                                        const float* __restrict__ bo) {
  Net n;
  const int H = d.H, HH = d.HH, C = d.C, NI = d.NI, HC = H * C;
  const int rank = (int)cg::this_cluster().block_rank();
  const int U = (H + p.cs - 1) / p.cs, UH = (HH + p.cs - 1) / p.cs;
  n.H = H;
  n.HH = HH;
  n.C = C;
  n.NI = NI;
  n.cs = p.cs;
  n.rank = rank;
  n.u0 = min(rank * U, H);
  n.nu = min(U, H - n.u0);
  n.h0 = min(rank * UH, HH);
  n.nh = min(UH, HH - n.h0);
  const int row0 = (int)(blockIdx.x / p.cs) * p.R;
  n.nr = min(p.R, d.B - row0);
  n.sH = ld4(H);
  n.sHH = ld4(HH);
  n.ldQ = ld4(U * C);
  n.NTC4 = round4(nt * C);
  n.U4 = round4(U);
  const int sHH = n.sHH, HH4 = round4(HH), QC = n.nu * C;
  if (p.hw) {
    float* swin = s + L.win;
    float* sbin = s + L.bin;
    float* swi = s + L.wi;
    float* sbi = s + L.bi;
    for (int i = threadIdx.x; i < H * HH; i += CT)
      swin[(i / HH) * sHH + i % HH] = win[i];
    for (int i = threadIdx.x; i < HH; i += CT) sbin[i] = bin[i];
    for (int i = threadIdx.x; i < NI * HH * HH; i += CT) {
      const int l = i / (HH * HH), k = (i / HH) % HH, j = i % HH;
      swi[(l * HH4 + k) * sHH + j] = wi[i];
    }
    for (int i = threadIdx.x; i < NI * HH; i += CT)
      sbi[(i / HH) * HH4 + i % HH] = bi[i];
    n.win = swin;
    n.bin = sbin;
    n.wi = swi;
    n.bi = sbi;
    n.lwin = n.lwi = sHH;
    n.swi = HH4 * sHH;
    n.sbi = HH4;
  } else {
    n.win = win;
    n.bin = bin;
    n.wi = wi;
    n.bi = bi;
    n.lwin = n.lwi = HH;
    n.swi = HH * HH;
    n.sbi = HH;
  }
  if (p.ow) {
    float* swo = s + L.wo;
    float* sbo = s + L.bo;
    for (int i = threadIdx.x; i < HH * QC; i += CT) {
      const int k = i / QC, q = i % QC;
      swo[k * n.ldQ + q] = wo[(size_t)k * HC + n.u0 * C + q];
    }
    for (int i = threadIdx.x; i < QC; i += CT) sbo[i] = bo[n.u0 * C + i];
    n.wo = swo;
    n.bo = sbo;
    n.lwo = n.ldQ;
  } else {
    n.wo = wo + n.u0 * C;
    n.bo = bo + n.u0 * C;
    n.lwo = HC;
  }
  n.gwh = !p.hw;
  n.gwo = !p.ow;
  return n;
}

template <bool RELU, bool WIDE>
__global__ void __launch_bounds__(CT)
cde_fwd_kernel(CdeDims d, CdePlan pp, Tab T, const float* __restrict__ z0,
               const float* __restrict__ dx, const float* __restrict__ dts,
               const float* __restrict__ win, const float* __restrict__ bin,
               const float* __restrict__ wi, const float* __restrict__ bi,
               const float* __restrict__ wo, const float* __restrict__ bo,
               float* __restrict__ ys) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const CdePlan p = placed<WIDE>(pp);
  const int NS = T.ns;
  const Layout L = cde_layout(d, p, NS, T.nt, 0);
  zero_smem(smem, L.total);
  __syncthreads();
  const Net n = make_net(d, p, L, smem, T.nt, win, bin, wi, bi, wo, bo);
  const int H = d.H, sH = n.sH, NTC = T.nt * d.C, NTC4 = n.NTC4;
  const int tile = round4(p.R) * sH, dtile = round4(p.R) * NTC4;
  const int row0 = (int)(blockIdx.x / p.cs) * p.R, nr = n.nr;
  const size_t BH = (size_t)d.B * H;
  float* z = smem + L.z;
  float* ks = smem + L.ks;  // [2][NS] tiles
  float* hk = smem + L.hk;
  float* ok = smem + L.ok;
  float* dxb = smem + L.dxb;
  const int htile = round4(p.R) * n.sHH;
  for (int i = threadIdx.x; i < nr * H; i += CT)
    z[(i / H) * sH + i % H] = z0[(size_t)row0 * H + i];
  copy_rows(dxb, NTC4, dx + (size_t)row0 * NTC, NTC, NTC, nr);
  cp_async_commit();
  cp_async_wait_all();
  // every CTA of the cluster is zeroed before a peer stores into it
  cluster_sync();

  for (int u = 0; u < d.M; ++u) {
    const float dt = dts[u];
    const float* dxu = dxb + (u & 1) * dtile;
    if (u + 1 < d.M)
      copy_rows(dxb + ((u + 1) & 1) * dtile, NTC4,
                dx + ((size_t)(u + 1) * d.B + row0) * NTC, NTC, NTC, nr);
    cp_async_commit();
    float* kst = ks + (u & 1) * NS * tile;
#pragma unroll 1
    for (int s = 0; s < NS; ++s) {
      const float* kp = kst + (s > 0 ? s - 1 : 0) * tile;
      field_forward<RELU, WIDE>(n, z, kp, s > 0, T.a[s] * dt, hk, 2, htile,
                                ok);
      // the stage's k, into every CTA of the cluster
      contract_push(n, ok, dxu + T.t[s] * d.C, kst + s * tile);
      cluster_or_block_sync(p.cs);
    }
    // the step's update
    const size_t off = u * BH + (size_t)row0 * H;
    for (int i = threadIdx.x; i < nr * H; i += CT) {
      const int r = i / H, h = i - r * H, e = r * sH + h;
      float v = z[e];
      for (int s = 0; s < NS; ++s)
        if (T.b[s] != 0.f) v = v + (T.b[s] * dt) * kst[s * tile + e];
      z[e] = v;
      if (h >= n.u0 && h < n.u0 + n.nu) ys[off + i] = v;
    }
    cp_async_wait_all();
    __syncthreads();
  }
}

template <bool RELU, bool WIDE>
__global__ void __launch_bounds__(CT)
cde_bwd_kernel(CdeDims d, CdePlan pp, Tab T, const float* __restrict__ z0,
               const float* __restrict__ ys, const float* __restrict__ gys,
               const float* __restrict__ dx, const float* __restrict__ dts,
               const float* __restrict__ win, const float* __restrict__ bin,
               const float* __restrict__ wi, const float* __restrict__ bi,
               const float* __restrict__ wo, const float* __restrict__ bo,
               float* __restrict__ ddx, float* __restrict__ dz0,
               float* __restrict__ p_win, float* __restrict__ p_bin,
               float* __restrict__ p_wi, float* __restrict__ p_bi,
               float* __restrict__ p_wo, float* __restrict__ p_bo) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const CdePlan p = placed<WIDE>(pp);
  const int NS = T.ns;
  const Layout L = cde_layout(d, p, NS, T.nt, 1);
  zero_smem(smem, L.total);
  __syncthreads();
  const Net n = make_net(d, p, L, smem, T.nt, win, bin, wi, bi, wo, bo);
  const int H = d.H, HH = d.HH, C = d.C, NI = d.NI, HC = H * C;
  const int sH = n.sH, ldQ = n.ldQ, NTC = T.nt * C;
  const int NTC4 = n.NTC4, U4 = n.U4, R4 = round4(p.R), tid = threadIdx.x;
  const int tile = R4 * sH, utile = R4 * U4, dtile = R4 * NTC4;
  const int htile = R4 * n.sHH;
  const int cl = (int)(blockIdx.x / p.cs), row0 = cl * p.R, nr = n.nr;
  const int UH = (HH + p.cs - 1) / p.cs;
  const size_t BH = (size_t)d.B * H;
  const int QC = n.nu * C;

  // the accumulators: in shared memory (zeroed above) or the cluster's
  // partials in device memory (zeroed here by their owners)
  Acc g;
  if (p.og) {
    g.wo = smem + L.gwo;
    g.bo = smem + L.gbo;
    g.lwo = ldQ;
  } else {
    g.wo = p_wo + (size_t)cl * HH * HC + n.u0 * C;
    g.bo = p_bo + (size_t)cl * HC + n.u0 * C;
    g.lwo = HC;
    for (int i = tid; i < HH * QC; i += CT)
      g.wo[(size_t)(i / QC) * HC + i % QC] = 0.f;
    for (int i = tid; i < QC; i += CT) g.bo[i] = 0.f;
  }
  const int HH4 = round4(HH);
  if (p.hg) {
    g.win = smem + L.gwin;
    g.bin = smem + L.gbin;
    g.wi = smem + L.gwi;
    g.bi = smem + L.gbi;
    g.lwin = g.lwi = HH4;
    g.swi = UH * HH4;
    g.sbi = HH4;
  } else {
    g.win = p_win + (size_t)cl * H * HH + (size_t)n.u0 * HH;
    g.bin = p_bin + (size_t)cl * HH;
    g.wi = p_wi + (size_t)cl * NI * HH * HH + (size_t)n.h0 * HH;
    g.bi = p_bi + (size_t)cl * NI * HH;
    g.lwin = g.lwi = HH;
    g.swi = HH * HH;
    g.sbi = HH;
    for (int i = tid; i < n.nu * HH; i += CT) g.win[i] = 0.f;
    for (int l = 0; l < NI; ++l)
      for (int i = tid; i < n.nh * HH; i += CT)
        g.wi[(size_t)l * HH * HH + i] = 0.f;
    if (n.rank == 0) {
      for (int i = tid; i < HH; i += CT) g.bin[i] = 0.f;
      for (int i = tid; i < NI * HH; i += CT) g.bi[i] = 0.f;
    }
  }
  g.dev_h = !p.hg;
  g.dev_o = !p.og;

  float* ks = smem + L.ks;    // [NS] tiles
  float* hk = smem + L.hk;    // [nk][NI+1] tiles
  float* ok = smem + L.ok;    // [nk] O slices
  float* zb = smem + L.z;     // [2] the state before the step
  float* gyb = smem + L.gyb;  // [2] own gys rows
  float* dxb = smem + L.dxb;  // [2] dx rows
  float* gbar = smem + L.gbar;
  float* dks = smem + L.dks;  // [NS] own tiles
  float* pd = smem + L.pd;    // [2]
  float* ddp = smem + L.ddp;  // [2]
  const int stile = (NI + 1) * htile, otile = R4 * ldQ;

  // what step u reads, into buffer u & 1
  auto prefetch = [&](int u) {
    const int b = u & 1;
    copy_rows(zb + b * tile, sH,
              (u == 0 ? z0 : ys + (size_t)(u - 1) * BH) + (size_t)row0 * H,
              H, H, nr);
    copy_rows(gyb + b * utile, U4,
              gys + (size_t)u * BH + (size_t)row0 * H + n.u0, H, n.nu, nr);
    copy_rows(dxb + b * dtile, NTC4, dx + ((size_t)u * d.B + row0) * NTC,
              NTC, NTC, nr);
    cp_async_commit();
  };
  prefetch(d.M - 1);
  cp_async_wait_all();
  cluster_sync();

  int par = 0;  // the partial dh's buffer, alternating by stage
  for (int u = d.M - 1; u >= 0; --u) {
    const float dt = dts[u];
    const int b = u & 1;
    const float* z = zb + b * tile;
    const float* dxu = dxb + b * dtile;
    float* ddu = ddp + b * dtile;
    if (u > 0) prefetch(u - 1);
    // the own units' state cotangent takes gys; each stage's k cotangent
    // starts at b_i dt gbar; the control cotangent's partial restarts
    for (int i = tid; i < nr * n.nu; i += CT) {
      const int e = (i / n.nu) * U4 + i % n.nu;
      const float v = gbar[e] + gyb[b * utile + e];
      gbar[e] = v;
      for (int s = 0; s < NS; ++s)
        dks[s * utile + e] = T.b[s] != 0.f ? (T.b[s] * dt) * v : 0.f;
    }
    for (int i = tid; i < nr * NTC; i += CT)
      ddu[(i / NTC) * NTC4 + i % NTC] = 0.f;

    // the stages' activations (each kept, or the last one's) and k, then
    // back through the stages from the last (not kept: each recomputed
    // first); one pass over 2 NS items keeps one copy of the field's code
#pragma unroll 1
    for (int it = 0; it < 2 * NS; ++it) {
      const bool rev = it >= NS;
      const int s = rev ? 2 * NS - 1 - it : it;
      const int slot = p.keep ? s : 0;
      const float* kp = ks + (s > 0 ? s - 1 : 0) * tile;
      const float alpha = T.a[s] * dt;
      if (!rev || (!p.keep && s != NS - 1)) {
        field_forward<RELU, WIDE>(n, z, kp, s > 0, alpha, hk + slot * stile,
                                  NI + 1, htile, ok + slot * otile);
        if (!rev && s < NS - 1) {
          contract_push(n, ok + slot * otile, dxu + T.t[s] * C,
                        ks + s * tile);
          cluster_or_block_sync(p.cs);
        }
      }
      if (!rev) continue;
      BwdTiles t;
      t.z = z;
      t.kp = kp;
      t.has_kp = s > 0;
      t.alpha = alpha;
      t.h = hk + slot * stile;
      t.htile = htile;
      t.o = ok + slot * otile;
      t.dk = dks + s * utile;
      t.dxt = dxu + T.t[s] * C;
      t.ddt = ddu + T.t[s] * C;
      t.e0 = smem + L.e0;
      t.e1 = smem + L.e1;
      t.pd = pd + par * htile;
      t.gbar = gbar;
      t.dkp = dks + (s > 0 ? s - 1 : 0) * utile;
      t.has_dkp = s > 0;
      t.ap = alpha;
      field_backward<RELU, WIDE>(n, g, t);
      par ^= 1;
    }
    // the step's control cotangent: the cluster's partials in rank order,
    // each CTA writing every cs-th entry (the last stage's barrier made
    // every partial complete; a peer overwrites its partial two steps on)
    const size_t offx = ((size_t)u * d.B + row0) * NTC;
    if (p.cs == 1) {
      for (int i = tid; i < nr * NTC; i += CT)
        ddx[offx + i] = ddu[(i / NTC) * NTC4 + i % NTC];
    } else {
      cg::cluster_group clu = cg::this_cluster();
      for (int i = n.rank + p.cs * tid; i < nr * NTC; i += p.cs * CT) {
        const int e = (i / NTC) * NTC4 + i % NTC;
        float v = clu.map_shared_rank(ddu, 0)[e];
        for (int peer = 1; peer < p.cs; ++peer)
          v += clu.map_shared_rank(ddu, peer)[e];
        ddx[offx + i] = v;
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  for (int i = tid; i < nr * n.nu; i += CT) {
    const int r = i / n.nu, hl = i % n.nu;
    dz0[(size_t)(row0 + r) * H + n.u0 + hl] = gbar[r * U4 + hl];
  }
  if (p.og) {
    float* pwo = p_wo + (size_t)cl * HH * HC + n.u0 * C;
    for (int i = tid; i < HH * QC; i += CT)
      pwo[(size_t)(i / QC) * HC + i % QC] = g.wo[(i / QC) * ldQ + i % QC];
    for (int i = tid; i < QC; i += CT)
      p_bo[(size_t)cl * HC + n.u0 * C + i] = g.bo[i];
  }
  if (p.hg) {
    float* pwin = p_win + (size_t)cl * H * HH + (size_t)n.u0 * HH;
    for (int i = tid; i < n.nu * HH; i += CT)
      pwin[i] = g.win[(i / HH) * HH4 + i % HH];
    for (int l = 0; l < NI; ++l) {
      float* pwi = p_wi + ((size_t)cl * NI + l) * HH * HH + (size_t)n.h0 * HH;
      for (int i = tid; i < n.nh * HH; i += CT)
        pwi[i] = g.wi[l * g.swi + (i / HH) * HH4 + i % HH];
    }
    if (n.rank == 0) {
      for (int i = tid; i < HH; i += CT)
        p_bin[(size_t)cl * HH + i] = g.bin[i];
      for (int i = tid; i < NI * HH; i += CT)
        p_bi[(size_t)cl * NI * HH + i] = g.bi[(i / HH) * HH4 + i % HH];
    }
  }
  // no CTA leaves while a peer may still read its shared memory
  cluster_or_block_sync(p.cs);
}

// ---------------------------------------------------------------------------
// The host plan and the launches
// ---------------------------------------------------------------------------

// the lowest level, and a forced cluster size and row count, the host may
// take (fused_cde_force_placement, fused_cde_force_plan; 0: its own)
int g_first_level = 0;
int g_force_cs = 0;
int g_force_rows = 0;

inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

// The plan of a launch of a tableau of ns stages at nt distinct times:
// among every level from g_first_level on, CS (at most H), rows a cluster
// (1 to 8, up to 32 when a test forces it; level 6: 4, 2 or 1) and, in
// the backward, keeping the stage
// activations or not, whose CTA fits the device's shared memory, the one
// of least estimated time: waves of CTAs (one CTA a SM: 512 threads of up
// to 128 registers fill its register file) x a stage's cycles in a CTA
// (rows x the FMAs of one row's field evaluation there, hidden layers in
// full and Wout's share 1 / CS, at 64 a cycle; 300 a phase; 900 a cluster
// barrier, two in the backward), x 1.2 for a backward that recomputes its
// stages, x 2.5 from level 1 on (device memory serving weights or
// accumulators: dWout's read-modify-writes took 40% of the first design's
// sepsis_rk4 backward on an H100, and at H=HH=128 clusters that each read
// the hidden weights from L2 lost to one CTA reading Wout there); ties go
// to fewer waves, the lower level, the smaller CS, keeping, fewer rows. A
// pure function of the shapes (and of what a test forces). When nothing
// fits, the last plan tried, its bytes above the limit (the launch is
// refused).
inline CdePlan cde_plan(const CdeDims& d, int ns, int nt, int backward) {
  const long long limit = (long long)max_optin_smem();
  const double sms = sm_count() > 0 ? sm_count() : 1;
  CdePlan p{}, best{};
  p.bytes = limit + 1;
  double best_cost = -1.0;
  long long best_key = 0;
  for (int level = g_first_level; level < LEVELS; ++level)
    for (int cs = 1; cs <= 8; cs *= 2) {
      if ((g_force_cs && cs != g_force_cs) || (cs > 1 && cs > d.H)) continue;
      for (int i = 0; i < 6; ++i) {
        const int R = level < 6 ? 1 << i : 4 >> i;
        if (R < 1) break;
        if (g_force_rows ? R != g_force_rows : R > 8) continue;
        for (int keep = backward; keep >= 0; --keep) {
          CdePlan q{};
          q.cs = cs;
          q.R = R;
          q.keep = keep;
          set_level(q, level);
          q.bytes = (long long)sizeof(float) *
                    cde_layout(d, q, ns, nt, backward).total;
          if (q.bytes > limit) {
            p = q;
            continue;
          }
          const double waves =
              std::ceil((double)((d.B + R - 1) / R) * cs / sms);
          const double row = (double)d.H * d.HH +
                             (double)d.NI * d.HH * d.HH +
                             (double)d.HH * d.H * d.C / cs;
          const double stage = R * row / 64.0 + 300.0 * (d.NI + 3) +
                               (cs > 1 ? 900.0 * (1 + backward) : 0.0);
          const double cost = waves * stage * (level > 0 ? 2.5 : 1.0) *
                              (backward && !keep ? 1.2 : 1.0);
          const long long key =
              (((long long)waves * LEVELS + level) * 16 + cs) * 2 * 64 +
              (1 - keep) * 64 + R;
          if (best_cost < 0 || cost < best_cost * (1 - 1e-9) ||
              (cost <= best_cost * (1 + 1e-9) && key < best_key)) {
            best_cost = cost;
            best_key = key;
            best = q;
          }
          break;  // the stages kept fit: recomputing them is no better
        }
      }
    }
  return best_cost < 0 ? p : best;
}

// Launch kernel k over clusters of p.cs CTAs, or, without `run`, only
// check the plan: its shared memory is set first, then
// cudaOccupancyMaxActiveClusters must find room for at least one cluster
// (its count in *active when given). An unschedulable plan returns an
// error: there is no quiet fallback to another route.
template <class... Exp, class... Act>
int launch_clusters(void (*k)(Exp...), const CdePlan& p, int B,
                    cudaStream_t s, int* active, bool run, Act... args) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + p.R - 1) / p.R) * p.cs));
  cfg.blockDim = dim3(CT);
  cfg.dynamicSmemBytes = (size_t)p.bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // queried once per device, kernel and plan: it keeps the CUDA runtime's
  // occupancy calculation off the host path of every launch
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, long long, int>, int> seen;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(dev, (const void*)k, p.bytes, p.cs);
  int n = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = seen.find(key);
    if (it != seen.end()) {
      n = it->second;
    } else {
      err = cudaOccupancyMaxActiveClusters(&n, k, &cfg);
      if (err != cudaSuccess) return (int)err;
      seen[key] = n;
    }
  }
  if (active) *active = n;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  if (!run) return 0;
  err = cudaLaunchKernelEx(&cfg, k, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

inline bool valid(const CdeDims& d) {
  return d.M >= 0 && d.B > 0 && d.H > 0 && d.HH > 0 && d.C > 0 && d.NI >= 0;
}

// One launch (or, without `go`, its plan's check) of a method's tableau
// and an activation (act 0 relu: FinalTanh; 1 tanh: SingleHiddenLayer);
// the main paths' level 0 runs its own instance (everything in shared
// memory, as compile-time facts)
int run_fwd(const FwdArgs& a, int method, int act_code, cudaStream_t s,
            int* active, bool go) {
  Tab T;
  if (!tableau(method, &T) || !valid(a.d)) return (int)cudaErrorInvalidValue;
  const CdePlan p = cde_plan(a.d, T.ns, T.nt, 0);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  const bool relu = act_code == 0, wide = p.level > 0;
  auto k = relu ? (wide ? cde_fwd_kernel<true, true>
                        : cde_fwd_kernel<true, false>)
                : (wide ? cde_fwd_kernel<false, true>
                        : cde_fwd_kernel<false, false>);
  return launch_clusters(k, p, a.d.B, s, active, go, a.d, p, T, a.z0, a.dx,
                         a.dts, a.win, a.bin, a.wi, a.bi, a.wo, a.bo, a.ys);
}

int run_bwd(const BwdArgs& a, int method, int act_code, cudaStream_t s,
            int* active, bool go) {
  Tab T;
  if (!tableau(method, &T) || !valid(a.d)) return (int)cudaErrorInvalidValue;
  const CdePlan p = cde_plan(a.d, T.ns, T.nt, 1);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  const bool relu = act_code == 0, wide = p.level > 0;
  auto k = relu ? (wide ? cde_bwd_kernel<true, true>
                        : cde_bwd_kernel<true, false>)
                : (wide ? cde_bwd_kernel<false, true>
                        : cde_bwd_kernel<false, false>);
  return launch_clusters(k, p, a.d.B, s, active, go, a.d, p, T, a.z0, a.ys,
                         a.gys, a.dx, a.dts, a.win, a.bin, a.wi, a.bi, a.wo,
                         a.bo, a.ddx, a.dz0, a.p_win, a.p_bin, a.p_wi, a.p_bi,
                         a.p_wo, a.p_bo);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a launch, in bytes, at its plan
// (above the device's limit when even the last level at one row does not
// fit; -1 for an unknown method).
long long fused_cde_smem_bytes(int B, int H, int HH, int C, int n_inner,
                               int method, int backward) {
  Tab T;
  if (!tableau(method, &T)) return -1;
  const CdeDims d{1, B, H, HH, C, n_inner};
  return cde_plan(d, T.ns, T.nt, backward).bytes;
}

// One field of a launch's plan: 0 the level, 1 batch rows a cluster (the
// leading dimension of the backward's partials is ceil(B / rows)), 2 CTAs
// a cluster, 3 the stage activations kept (backward), 4
// cudaOccupancyMaxActiveClusters of the relu instance (minus the CUDA
// error when the plan cannot be scheduled), 5 shared bytes a CTA; -1 for
// an unknown method.
int fused_cde_plan(int B, int H, int HH, int C, int n_inner, int method,
                   int backward, int field) {
  Tab T;
  if (!tableau(method, &T)) return -1;
  const CdeDims d{1, B, H, HH, C, n_inner};
  const CdePlan p = cde_plan(d, T.ns, T.nt, backward);
  switch (field) {
    case 0: return p.level;
    case 1: return p.R;
    case 2: return p.cs;
    case 3: return p.keep;
    case 5: return (int)p.bytes;
  }
  int active = 0, err;
  if (backward) {
    BwdArgs a = {};
    a.d = d;
    err = run_bwd(a, method, 0, 0, &active, false);
  } else {
    FwdArgs a = {};
    a.d = d;
    err = run_fwd(a, method, 0, 0, &active, false);
  }
  return err ? -err : active;
}

// Make later launches take level `first` or a later one (0: the host's
// own choice). For tests of each level.
int fused_cde_force_placement(int first) {
  if (first < 0 || first >= LEVELS) return (int)cudaErrorInvalidValue;
  g_first_level = first;
  return 0;
}

// Make later launches take clusters of cs CTAs and `rows` batch rows a
// cluster, a power of 2 up to 32 (0: the host's own choice of each). For
// tests of each plan.
int fused_cde_force_plan(int cs, int rows) {
  if ((cs != 0 && cs != 1 && cs != 2 && cs != 4 && cs != 8) || rows < 0 ||
      rows > 32 || (rows & (rows - 1)))
    return (int)cudaErrorInvalidValue;
  g_force_cs = cs;
  g_force_rows = rows;
  return 0;
}

int fused_cde_max_smem() { return max_optin_smem(); }

const char* fused_cde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_cde_fwd(const float* z0, const float* dx, const float* dts,
                  const float* win, const float* bin, const float* wi,
                  const float* bi, const float* wo, const float* bo, float* ys,
                  int M, int B, int H, int HH, int C, int n_inner, int method,
                  int act_code, void* stream) {
  const FwdArgs a{CdeDims{M, B, H, HH, C, n_inner}, z0, dx, dts, win, bin,
                  wi, bi, wo, bo, ys};
  return run_fwd(a, method, act_code, (cudaStream_t)stream, nullptr, true);
}

int fused_cde_bwd(const float* z0, const float* ys, const float* gys,
                  const float* dx, const float* dts, const float* win,
                  const float* bin, const float* wi, const float* bi,
                  const float* wo, const float* bo, float* ddx, float* dz0,
                  float* p_win, float* p_bin, float* p_wi, float* p_bi,
                  float* p_wo, float* p_bo, int M, int B, int H, int HH,
                  int C, int n_inner, int method, int act_code,
                  void* stream) {
  const BwdArgs a{CdeDims{M, B, H, HH, C, n_inner}, z0, ys, gys, dx, dts,
                  win, bin, wi, bi, wo, bo, ddx, dz0, p_win, p_bin, p_wi,
                  p_bi, p_wo, p_bo};
  return run_bwd(a, method, act_code, (cudaStream_t)stream, nullptr, true);
}

}  // extern "C"
