// Device code of the fused SDE kernels' Hopper design (fused_em.cu,
// fused_srk.cu): register-tiled products over a group of a CTA's threads,
// the exchange of a layer's output row over a thread-block cluster,
// asynchronous copies, a cluster's place in the batch and its slices of
// the drift MLP's weights, the cluster launch and the host plan that sizes
// it, and the weight-gradient product that runs after a reverse loop.
//
// Everything here has internal linkage: each source that includes it
// builds into its own library.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>
#include <climits>
#include <cmath>
#include <map>
#include <mutex>
#include <tuple>
#include <vector>

namespace {

namespace cg = cooperative_groups;

constexpr int ET = 512;  // threads a CTA of the solver kernels
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// row stride of a float4-read tile: a multiple of 4 floats, not of 32
// (rows at neighbouring k of a column walk fall on distinct banks)
__host__ __device__ inline int ld4(int n) {
  const int r = round4(n);
  return (r & 31) ? r : r + 4;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// ---------------------------------------------------------------------------
// Copies, barriers, the cluster's exchange
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 bytes, or (bytes 0) a zero fill
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes = 4) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dst[r][c] <- src[r * sr + c] for r < nr, c < n, asynchronously; with
// vec, one contiguous block (ld == sr == n) in 16-byte copies where both
// ends are aligned. (On an H100 at the sepsis shape 16-byte copies cut the
// EM backward recurrence from 1.01 to 0.71 ms and cost its forward 0.344
// -> 0.41 ms, so each kernel takes its own.)
__device__ __forceinline__ void copy_rows(float* dst, int ld,
                                          const float* src, size_t sr, int n,
                                          int nr, bool vec = false) {
  if (vec && ld == n && sr == (size_t)n &&
      ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    const int total = nr * n, q = total >> 2;
    for (int i = threadIdx.x; i < q; i += ET)
      cp_async16(dst + 4 * i, src + 4 * i, 16);
    for (int i = 4 * q + threadIdx.x; i < total; i += ET)
      cp_async4(dst + i, src + i);
    return;
  }
  for (int i = threadIdx.x; i < nr * n; i += ET) {
    const int r = i / n, c = i - r * n;
    cp_async4(dst + r * ld + c, src + r * sr + c);
  }
}

__device__ __forceinline__ void zero_smem(float* s, long long n) {
  for (long long i = threadIdx.x; i < n; i += ET) s[i] = 0.f;
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

// v into entry e of `tile` in every CTA of the cluster (this one's too)
__device__ __forceinline__ void push(int cs, float* tile, int e, float v) {
  if (cs == 1) {
    tile[e] = v;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  for (int peer = 0; peer < cs; ++peer) cl.map_shared_rank(tile, peer)[e] = v;
}

// sum over the cluster's CTAs, in rank order, of entry e of `buf`
__device__ __forceinline__ float peer_sum(int cs, float* buf, int e) {
  cg::cluster_group cl = cg::this_cluster();
  float s = cl.map_shared_rank(buf, 0)[e];
  for (int peer = 1; peer < cs; ++peer) s += cl.map_shared_rank(buf, peer)[e];
  return s;
}

__device__ __forceinline__ float lane4(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

__device__ __forceinline__ float4 ld_f4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// ---------------------------------------------------------------------------
// Products over a group of the CTA's threads
// ---------------------------------------------------------------------------

// The threads [t0, t0 + n) of a CTA (t0 and n multiples of 32), so that
// two products of a phase run side by side on two groups.
struct Grp {
  int t0, n;
};

// Lanes a product's K is split over: the largest power of 2, at most 32
// and at most the K chunks, with items x lanes <= the group's threads.
__device__ __forceinline__ int k_lanes(int items, int chunks, int nt) {
  int ks = 1;
  while (ks < 32 && ks * 2 <= chunks && items * ks * 2 <= nt) ks *= 2;
  return ks;
}

// Y = X W over items of RT rows x NT columns a thread: epi(r, n, sum_{k<K}
// X[r][k] W[k][n]) for r < nr, n < N. X rows of stride ldx with zero
// columns up to round4(K) and rows up to round4(nr). Each output is one FMA
// chain over k in ascending order (the order of the plain versions' matrix
// products, so a relu's input rounds as theirs does), read as float4 along
// k. W [K][ldw] in shared memory (gw false: zero rows up to round4(K),
// zero columns up to NT ceil(N / NT), ldw a multiple of NT) or in device
// memory at its own stride (gw: guarded scalar reads). No barrier.
template <int RT, int NT, class Epi>
__device__ __forceinline__ void mm_tile(Grp g, const float* X, int ldx,
                                        int K, const float* W, int ldw,
                                        bool gw, int nr, int N, Epi epi) {
  const int t = (int)threadIdx.x - g.t0;
  if (t < 0 || t >= g.n) return;
  const int NC = (N + NT - 1) / NT, items = ((nr + RT - 1) / RT) * NC;
  const int K4 = round4(K);
  for (int item = t; item < items; item += g.n) {
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
      for (int i = 0; i < RT; ++i) x[i] = ld_f4(X + (r0 + i) * ldx + k);
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

// Y = X W (mm_tile): tiles of 2 x 2 where their items fit one pass of the
// group's threads, else 4 x 2. Four independent chains a thread, and one
// float2 weight read and two float4 row reads for 16 FMAs: on an H100 at
// the sepsis shape this beat 1 x 1 and 1 x 2 tiles that keep more threads
// busy (0.349 against 0.386 ms a forward launch), the products being bound
// by instruction issue and shared-memory reads, not by the FMA chains.
template <class Epi>
__device__ __forceinline__ void mm(Grp g, const float* X, int ldx, int K,
                                   const float* W, int ldw, bool gw, int nr,
                                   int N, Epi epi) {
  if (((nr + 1) >> 1) * ((N + 1) >> 1) <= g.n)
    mm_tile<2, 2>(g, X, ldx, K, W, ldw, gw, nr, N, epi);
  else
    mm_tile<4, 2>(g, X, ldx, K, W, ldw, gw, nr, N, epi);
}

// Y = E W^T: epi(r, k, sum_{c<Nc} E[r][c] W[k][c]) for r < nr, k < N (a
// back product: rows of W walked contiguously). E rows of stride lde,
// 16-byte aligned, with finite columns up to round4(Nc) and rows up to
// round4(nr); W [N][ldw] in shared memory (gw false: zero columns from Nc
// up to round4(Nc), rows up to 2 ceil(N / 2) readable) or device memory at
// its own stride (gw: guarded). Items of 4 rows x 2 outputs, the c loop
// split over adjacent lanes (k_lanes) in float4 chunks, the lanes' sums
// taken by a shuffle tree in a fixed order; no barrier.
template <class Epi>
__device__ __forceinline__ void mm_t(Grp g, const float* E, int lde, int Nc,
                                     const float* W, int ldw, bool gw,
                                     int nr, int N, Epi epi) {
  const int tl = (int)threadIdx.x - g.t0;
  if (tl < 0 || tl >= g.n) return;
  const int NC = (N + 1) >> 1, items = ((nr + 3) >> 2) * NC;
  const int C4 = round4(Nc), KS = k_lanes(items, C4 >> 2, g.n);
  const int total = items * KS;
  for (int base = 0; base < total; base += g.n) {
    const int t = base + tl;
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

// sum over the CTA of one float per thread (all threads must call it;
// red holds ET / 32 floats)
__device__ __forceinline__ float cta_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(FULL, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < ET / 32; ++k) s += red[k];
  return s;
}

// ---------------------------------------------------------------------------
// An SDE pair's cluster: its rows, its columns, its slices of the weights
// ---------------------------------------------------------------------------

// The drift MLP of a DiffusionField, the y-independent parts precomputed
// outside the kernels, by drift mode (the JAX package's _DRIFT_BY_IO):
//   'embm' (input_option 2/4/6): z1 = s Wy' + a' + xh' (the merged emb)
//   'yy'   (input_option 1/3/5): z1 = s Wy + a (a = tf Wt + b_in)
//   'xt'   (input_option 0):     z1 = xh (= initial_network(X(t)))
//   h_0 = relu(z1);  h_{l+1} = relu(h_l W_l + b_l)
//   z3 = h_NI Wout + bo  (* tanh(s) when geometric);  f = tanh(z3)
// (weights in [in, out] layout), and a diffusion tanh(sigmoid(theta) base
// (* s when mult_y)) whose base is, by noise mode:
//   'precomp' (noise_option 0-6, 11-13, 16, 17): a t-only row gk
//   'elem' (7-10): sqrt, cube, sigmoid or relu of s (elem: the option)
//   'net1' (14/15): s Wn1 + an1 (an1 = tf Wn1_t + bn1, a row)
//   'net2' (18/19): relu(relu(s Wn1 + an1) Wn2 + bn2)
// A kernel instance is compiled for one drift and one noise mode (template
// arguments); mult_y, geometric and the elem option are runtime flags.
enum { DR_EMBM = 0, DR_YY = 1, DR_XT = 2, SDE_DRIFTS = 3 };
enum { NZ_PRE = 0, NZ_ELEM = 1, NZ_NET1 = 2, NZ_NET2 = 3, SDE_NOISES = 4 };

// The initializer of a kernel template K<GW, DR, NZ>'s instances as a
// table [level][drift][noise] (level 1: GW, the weights in device memory)
#define SDE_NZ_ROW(K, GW, DR) \
  {K<GW, DR, NZ_PRE>, K<GW, DR, NZ_ELEM>, K<GW, DR, NZ_NET1>, \
   K<GW, DR, NZ_NET2>}
#define SDE_DR_ROWS(K, GW)                                      \
  {SDE_NZ_ROW(K, GW, DR_EMBM), SDE_NZ_ROW(K, GW, DR_YY), \
   SDE_NZ_ROW(K, GW, DR_XT)}
#define SDE_INSTANCES(K) {SDE_DR_ROWS(K, false), SDE_DR_ROWS(K, true)}

// the modes an instance exists for (and, in mode 'elem', noise_option 7-10)
inline bool sde_modes_valid(int drift, int noise, int elem) {
  return drift >= 0 && drift < SDE_DRIFTS && noise >= 0 &&
         noise < SDE_NOISES &&
         (noise != NZ_ELEM || (elem >= 7 && elem <= 10));
}

__host__ __device__ constexpr bool net_noise(int nz) {
  return nz == NZ_NET1 || nz == NZ_NET2;
}

// A launch's shapes and modes, and its members: K same-configuration
// solves (each with its own weights, y0, control and Brownian streams) in
// one launch, member k on blockIdx.y, each of its tensors lying at k times
// a member's size (csrc/fused_em.cu, fused_srk.cu: the layouts).
struct SdeDims {
  int M, B, H, HH, NI, mult_y, geometric, drift, noise, elem, K;
};

// d with its modes the instance's compile-time ones, so that every branch
// on them in the shared layout and weight code folds away
template <int DR, int NZ>
__device__ __forceinline__ SdeDims with_modes(SdeDims d) {
  d.drift = DR;
  d.noise = NZ;
  return d;
}

// The elementwise noise bases (noise_option 7-10) and their derivatives,
// as the JAX kernel takes them (snsde/kernels/fused_em.py:381-392,
// 424-437): sqrt is 0 where s <= 0 (the reference's nan_to_num), its
// derivative 0 there.
__device__ __forceinline__ float elem_base(int no, float s) {
  if (no == 7) return s > 0.f ? sqrtf(fmaxf(s, 0.f)) : 0.f;
  if (no == 8) return s * s * s;
  if (no == 9) return sigmoid(s);
  return fmaxf(s, 0.f);
}
__device__ __forceinline__ float elem_deriv(int no, float s) {
  if (no == 7) return s > 0.f ? 0.5f * rsqrtf(fmaxf(s, 1e-30f)) : 0.f;
  if (no == 8) return 3.f * s * s;
  if (no == 9) {
    const float g = sigmoid(s);
    return g * (1.f - g);
  }
  return s > 0.f ? 1.f : 0.f;
}

// h_0 = relu(xh) of drift mode 'xt' over the own columns, by the threads
// of group g: epi(r, n, h_0)
template <class Epi>
__device__ __forceinline__ void xt_first(Grp g, const float* xu, int nr,
                                         int nh, Epi epi) {
  const int t = (int)threadIdx.x - g.t0;
  if (t < 0 || t >= g.n) return;
  for (int i = t; i < nr * nh; i += g.n)
    epi(i / nh, i % nh, fmaxf(xu[i], 0.f));
}

// level 0: the weight slices in shared memory; 1: read from device memory
constexpr int SDE_LEVELS = 2;
// threads of a backward's chain group when the recompute runs beside it
// (on an H100 at the EM pair's sepsis shape 128 beat 256 and 64)
constexpr int CHAIN_THREADS = 128;

struct SdePlan {
  int level, cs, R;
  long long bytes;
};

// The widths a CTA's tiles and slices take: own columns U of the H-wide
// layers and UH of the HH-wide ones (multiples of 4), their float4-read
// strides, the strides of a full row, R rounded up to 4
struct SdeGeo {
  int U, UH, lU, lUH, sH, sHH, sW, R4, H4, HH4;
};

__host__ __device__ inline SdeGeo sde_geo(const SdeDims& d, const SdePlan& p) {
  SdeGeo g;
  g.U = round4((d.H + p.cs - 1) / p.cs);
  g.UH = round4((d.HH + p.cs - 1) / p.cs);
  g.lU = ld4(g.U);
  g.lUH = ld4(g.UH);
  g.sH = ld4(d.H);
  g.sHH = ld4(d.HH);
  g.sW = g.sH > g.sHH ? g.sH : g.sHH;
  g.R4 = round4(p.R);
  g.H4 = round4(d.H);
  g.HH4 = round4(d.HH);
  return g;
}

// offsets in floats of a CTA's shared-memory layout, handed out in order,
// each a multiple of 4 floats
struct Take {
  long long at = 0;
  __host__ __device__ long long operator()(long long n) {
    const long long o = at;
    at += (n + 3) & ~3LL;
    return o;
  }
};

// Where the weights sit in shared memory (-1: not there). Weight slices
// (level 0): Wy' [H4][lUH] (not in drift mode 'xt'), W_l [NI][HH4][lUH],
// Wout [HH4][lU], and the noise net's Wn1 and (net2) Wn2 [H4][lU]; the
// bias slices b_l [NI][UH], bo [U] and (net2) bn2 [U] at every level.
struct WtsAt {
  long long wy, wi, bi, wo, bo, wn1, wn2, bn2;
};

__host__ __device__ inline WtsAt take_wts(Take& take, const SdeDims& d,
                                          const SdePlan& p, const SdeGeo& g) {
  WtsAt w;
  w.wy = w.wi = w.wo = w.wn1 = w.wn2 = w.bn2 = -1;
  if (p.level == 0) {
    if (d.drift != DR_XT) w.wy = take((long long)g.H4 * g.lUH);
    w.wi = take((long long)d.NI * g.HH4 * g.lUH);
    w.wo = take((long long)g.HH4 * g.lU);
    if (net_noise(d.noise)) w.wn1 = take((long long)g.H4 * g.lU);
    if (d.noise == NZ_NET2) w.wn2 = take((long long)g.H4 * g.lU);
  }
  w.bi = take((long long)d.NI * g.UH);
  w.bo = take(g.U);
  if (d.noise == NZ_NET2) w.bn2 = take(g.U);
  return w;
}

// The CTA's place: its cluster's rows and its own columns, and its
// member's (k = blockIdx.y) first step km = k M in a stream laid out
// [K][M]
struct Cta {
  int cs, rank, row0, nr, u0, nu, h0, nh, km;
};

// the CTA's member's first batch row in a tensor laid out [K][B]
__device__ __forceinline__ int member_row(const SdeDims& d) {
  return (int)blockIdx.y * d.B;
}

__device__ __forceinline__ Cta make_cta(const SdeDims& d, const SdePlan& p,
                                        const SdeGeo& g) {
  Cta c;
  c.cs = p.cs;
  c.rank = p.cs == 1 ? 0 : (int)cg::this_cluster().block_rank();
  c.row0 = (int)(blockIdx.x / p.cs) * p.R;
  c.nr = min(p.R, d.B - c.row0);
  c.u0 = min(c.rank * g.U, d.H);
  c.nu = min(g.U, d.H - c.u0);
  c.h0 = min(c.rank * g.UH, d.HH);
  c.nh = min(g.UH, d.HH - c.h0);
  c.km = (int)blockIdx.y * d.M;
  return c;
}

// The weights as the products read them: the CTA's column slices in
// shared memory (level 0: rows and columns past the weights' own are zero,
// shared memory being zeroed first), or the tensors in device memory at
// their own strides from the slice's first column; the bias slices in
// shared memory. The noise net's weights (Wn1, Wn2 [H][H], bn2 [H]; null
// in the other noise modes) are sliced by output column as Wout is.
struct Wts {
  const float *wy, *wi, *wo, *bi, *bo, *wn1, *wn2, *bn2;
  int lwy, lwi, swi, lwo, lwn;
};

struct WtsIn {
  const float *wy, *wi, *bi, *wo, *bo, *wn1, *wn2, *bn2;
};

// p + k n: member k's tensor of n floats a member (null stays null)
__device__ __forceinline__ const float* member(const float* p, int k,
                                               size_t n) {
  return p ? p + (size_t)k * n : p;
}

// member k's weights, each tensor [K][...] (a tensor the modes do not take
// is null)
__device__ __forceinline__ WtsIn member_wts(const SdeDims& d, int k,
                                            const WtsIn& in) {
  const size_t H = d.H, HH = d.HH, NI = d.NI;
  return WtsIn{member(in.wy, k, H * HH),   member(in.wi, k, NI * HH * HH),
               member(in.bi, k, NI * HH),  member(in.wo, k, HH * H),
               member(in.bo, k, H),        member(in.wn1, k, H * H),
               member(in.wn2, k, H * H),   member(in.bn2, k, H)};
}

// one [K][N] weight's column slice [c0, c0 + n) into dst [K][ld]
__device__ __forceinline__ void load_slice(float* dst, int ld,
                                           const float* __restrict__ src,
                                           int K, int N, int c0, int n) {
  for (int i = threadIdx.x; i < K * n; i += ET)
    dst[(i / n) * ld + i % n] = src[(size_t)(i / n) * N + c0 + i % n];
}

__device__ __forceinline__ Wts load_wts(const SdeDims& d, const SdePlan& p,
                                        const SdeGeo& g, const Cta& c,
                                        const WtsAt& at, float* s,
                                        const WtsIn& in) {
  const int H = d.H, HH = d.HH, NI = d.NI, nh = c.nh, nu = c.nu;
  Wts w;
  float* sbi = s + at.bi;
  float* sbo = s + at.bo;
  for (int i = threadIdx.x; i < NI * nh; i += ET)
    sbi[(i / nh) * g.UH + i % nh] = in.bi[(i / nh) * HH + c.h0 + i % nh];
  for (int i = threadIdx.x; i < nu; i += ET) sbo[i] = in.bo[c.u0 + i];
  w.bi = sbi;
  w.bo = sbo;
  w.wn1 = w.wn2 = w.bn2 = nullptr;
  w.lwn = 0;
  if (d.noise == NZ_NET2 && in.bn2) {  // (a backward reads no bn2)
    float* sbn = s + at.bn2;
    for (int i = threadIdx.x; i < nu; i += ET) sbn[i] = in.bn2[c.u0 + i];
    w.bn2 = sbn;
  }
  if (p.level == 0) {
    float* swy = s + at.wy;
    float* swi = s + at.wi;
    float* swo = s + at.wo;
    if (d.drift != DR_XT) load_slice(swy, g.lUH, in.wy, H, HH, c.h0, nh);
    for (int i = threadIdx.x; i < NI * HH * nh; i += ET) {
      const int l = i / (HH * nh), k = (i / nh) % HH, n = i % nh;
      swi[((size_t)l * g.HH4 + k) * g.lUH + n] =
          in.wi[((size_t)l * HH + k) * HH + c.h0 + n];
    }
    load_slice(swo, g.lU, in.wo, HH, H, c.u0, nu);
    w.wy = swy;
    w.wi = swi;
    w.wo = swo;
    w.lwy = w.lwi = g.lUH;
    w.swi = g.HH4 * g.lUH;
    w.lwo = g.lU;
    if (net_noise(d.noise)) {
      load_slice(s + at.wn1, g.lU, in.wn1, H, H, c.u0, nu);
      w.wn1 = s + at.wn1;
      w.lwn = g.lU;
    }
    if (d.noise == NZ_NET2) {
      load_slice(s + at.wn2, g.lU, in.wn2, H, H, c.u0, nu);
      w.wn2 = s + at.wn2;
    }
  } else {
    w.wy = in.wy + c.h0;
    w.wi = in.wi + c.h0;
    w.wo = in.wo + c.u0;
    w.lwy = w.lwi = HH;
    w.swi = HH * HH;
    w.lwo = H;
    if (net_noise(d.noise)) {
      w.wn1 = in.wn1 + c.u0;
      w.lwn = H;
    }
    if (d.noise == NZ_NET2) w.wn2 = in.wn2 + c.u0;
  }
  return w;
}

// the main paths' instance (GW false) reads the weight slices from shared
// memory, a compile-time fact
template <bool GW>
__device__ __forceinline__ SdePlan placed(SdePlan p) {
  if (!GW) p.level = 0;
  return p;
}

// ---------------------------------------------------------------------------
// The host side: device limits and cluster launches
// ---------------------------------------------------------------------------

// The most dynamic shared memory one block may opt in to on this device.
inline int max_optin_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

// The launch configuration of kernel k on `ctas` CTAs of ET threads in
// clusters of cs with `bytes` of dynamic shared memory (attr: its one
// attribute, the cluster's size), and cudaOccupancyMaxActiveClusters of it
// in *n: queried once per device, kernel, bytes and cluster size, which
// keeps the CUDA runtime's occupancy calculation off the host path of
// every launch. The kernel's shared-memory limit is set first.
template <class... Exp>
int cluster_config(void (*k)(Exp...), int cs, int ctas, long long bytes,
                   cudaStream_t s, cudaLaunchConfig_t& cfg,
                   cudaLaunchAttribute* attr, int* n, int members = 1) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cfg = {};
  cfg.gridDim = dim3((unsigned)(ctas > 0 ? ctas : cs), (unsigned)members);
  cfg.blockDim = dim3(ET);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  static std::mutex mu;
  static std::map<std::tuple<int, const void*, long long, int>, int> seen;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const auto key = std::make_tuple(dev, (const void*)k, bytes, cs);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) {
    *n = it->second;
    return 0;
  }
  err = cudaOccupancyMaxActiveClusters(n, k, &cfg);
  if (err != cudaSuccess) return (int)err;
  seen[key] = *n;
  return 0;
}

// Launch kernel k on `ctas` CTAs of ET threads in clusters of cs, for
// each of `members` members (gridDim.y), with
// `bytes` of dynamic shared memory, or, without `run`, only check it:
// cudaOccupancyMaxActiveClusters must find room for at least one cluster
// (its count in *active when given). An unschedulable launch returns an
// error: there is no quiet fallback to another route.
template <class... Exp, class... Act>
int launch_clusters(void (*k)(Exp...), int cs, int ctas, int members,
                    long long bytes, cudaStream_t s, int* active, bool run,
                    Act... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  const int e = cluster_config(k, cs, ctas, bytes, s, cfg, attr, &n, members);
  if (e) return e;
  if (active) *active = n;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  if (!run || ctas == 0) return 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The host plan of an SDE pair's launch
// ---------------------------------------------------------------------------

// the lowest level, and a forced cluster size and row count, the host may
// take (the library's force_placement and force_plan entries; 0: its own)
int g_first_level = 0;
int g_force_cs = 0;
int g_force_rows = 0;

// What one step of a launch takes in a CTA: drift MLP evaluations,
// phases (each ended by a barrier), cluster barriers and diffusion
// evaluations
struct StepShape {
  int evals, phases, syncs, nevals;
};

// The plan of a launch: among every level from g_first_level on, CS in
// {1, 2, 4, 8} (at most max(H, HH)) and R in {1, ..., 32} rows a cluster
// whose CTA fits the device's shared memory (bytes(q): its dynamic bytes)
// and whose cluster can be scheduled (active(q):
// cudaOccupancyMaxActiveClusters, 0 when it cannot), the one of least
// estimated time: waves of clusters (the K members' clusters over the
// active ones) x
// the CTAs a full wave puts on an SM, where more than one (they share its
// issue slots: on an H100 at the SRK pair's MuJoCo shape one CTA of 8 rows
// an SM beat two of 4) x a step's cycles in a CTA (R x the FMAs of one
// row's MLP evaluations / CS at 64 a cycle, twice in a backward, whose
// recompute runs beside the chain; 300 a phase; 900 a cluster barrier and,
// in a backward, 300 more a barrier for the partials' sum), x 2.5 at level
// 1 (device memory serving the weights: the factor PR 7's CDE plan
// measured). The noise nets' products (net1: H x H FMAs a row and
// diffusion evaluation, net2: twice that) count as the drift's; their
// instances take clusters of one only (their back products are not split
// over a cluster), so at wide widths their weights go to device memory.
// Ties go to fewer
// waves, the lower level, the smaller CS, fewer rows. A pure function of
// the shapes and modes (and of what a test forces), kept per device. When
// nothing fits, the last plan tried, its bytes above the limit (the launch
// is refused).
template <class Bytes, class Active>
SdePlan sde_plan(const SdeDims& d, int backward, StepShape st, Bytes bytes,
                 Active active) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int, int, int, int,
                             int, int, int>,
                  SdePlan>
      seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const int K = std::max(d.K, 1);
  const auto key =
      std::make_tuple(dev, d.B, d.H, d.HH, d.NI, backward, g_first_level,
                      g_force_cs, g_force_rows, d.drift, d.noise, K);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  const long long limit = (long long)max_optin_smem();
  const double sms = std::max(sm_count(), 1);
  SdePlan last{}, best{};
  last.bytes = limit + 1;
  double best_cost = -1.0;
  long long best_rank = 0;
  const double row =
      ((double)d.H * d.HH + (double)d.NI * d.HH * d.HH + (double)d.HH * d.H) *
          st.evals +
      (d.noise == NZ_NET1 ? 1.0 : d.noise == NZ_NET2 ? 2.0 : 0.0) * d.H *
          d.H * st.nevals;
  for (int level = g_first_level; level < SDE_LEVELS; ++level)
    for (int cs = 1; cs <= 8; cs *= 2) {
      if (g_force_cs ? cs != g_force_cs
                     : (cs > 1 && cs > (d.H > d.HH ? d.H : d.HH)))
        continue;
      if (net_noise(d.noise) && cs > 1) continue;
      for (int R = 1; R <= 32; R *= 2) {
        if (g_force_rows && R != g_force_rows) continue;
        SdePlan q{level, cs, R, 0};
        q.bytes = (long long)sizeof(float) * bytes(q);
        const int n = q.bytes > limit ? 0 : active(q);
        if (n < 1) {
          last = q;
          continue;
        }
        const double clusters = (double)K * ((d.B + R - 1) / R);
        const double waves = std::ceil(clusters / n);
        const double share =
            std::max(1.0, std::min(clusters, (double)n) * cs / sms);
        const double step =
            R * row / cs / 64.0 * (1 + backward) +
            300.0 * st.phases +
            (cs > 1 ? (900.0 + 300.0 * backward) * st.syncs : 0.0);
        const double cost = waves * share * step * (level > 0 ? 2.5 : 1.0);
        const long long rank =
            (((long long)waves * SDE_LEVELS + level) * 16 + cs) * 64 + R;
        if (best_cost < 0 || cost < best_cost * (1 - 1e-9) ||
            (cost <= best_cost * (1 + 1e-9) && rank < best_rank)) {
          best_cost = cost;
          best_rank = rank;
          best = q;
        }
      }
    }
  return seen[key] = best_cost < 0 ? last : best;
}

inline bool sde_valid(const SdeDims& d) {
  return d.M >= 0 && d.B > 0 && d.H > 0 && d.HH > 0 && d.NI >= 0 &&
         d.K >= 1 && d.K <= 65535;
}

inline int sde_ctas(const SdeDims& d, const SdePlan& p) {
  return ((d.B + p.R - 1) / p.R) * p.cs;
}

// a level the host may start from, and a plan a test may force
inline int force_level(int first) {
  if (first < 0 || first >= SDE_LEVELS) return (int)cudaErrorInvalidValue;
  g_first_level = first;
  return 0;
}

inline int force_plan(int cs, int rows) {
  if ((cs != 0 && cs != 1 && cs != 2 && cs != 4 && cs != 8) || rows < 0 ||
      rows > 32 || (rows & (rows - 1)))
    return (int)cudaErrorInvalidValue;
  g_force_cs = cs;
  g_force_rows = rows;
  return 0;
}

// ---------------------------------------------------------------------------
// The weight-gradient product after a reverse loop
// ---------------------------------------------------------------------------

// One product of the weight gradient: p[z][m][c] = sum over the split z's
// n of x(n)[m] e[n][c] for m < rows, c < N, and, with bias, p[z][rows][c]
// = the split's sum of e[n][c] (else that row is 0). x(n) is x0 + n rows
// for n < nb0, x + (n - nb0) rows for n < nb1 and x2 + (n - nb1) rows
// after (each row `rows` floats); e rows N floats. p holds S splits of
// (rows + 1) x N. Member k (blockIdx.z) reads and writes each at k times
// its member stride (m*, in floats). A stream whose bit is set in segm (1:
// x, 2: x2, 4: e) holds a member's rows in segments of `seg` rows, `gap`
// rows apart (the SRK's streams [E][K][M][B]: seg M B, gap K M B): its row
// i is at (i / seg) gap + i % seg.
struct WgJob {
  const float *x0, *x, *x2, *e;
  float* p;
  int rows, N, nb0, nb1, bias;
  long long mx0, mx, mx2, me, mp;
  int segm, seg;
  long long gap;
};

// Column sums of a stream [steps][B][N] by step: out[u][c] = sum_b
// s[u][b][c] (summed in a fixed order); member k's at k ms and k mo, its
// steps in segments of `seg` steps `gap` steps apart when seg > 0.
struct WgSum {
  const float* s;
  float* out;
  int N, steps;
  long long ms, mo;
  int seg;
  long long gap;
};

__device__ __forceinline__ long long seg_row(long long i, int seg,
                                             long long gap) {
  return (i / seg) * gap + i % seg;
}

constexpr int WG_MAX_JOBS = 8, WG_MAX_SUMS = 2;
constexpr int WG_THREADS = 256, WG_BN = 64, WG_BK = 16;
// the least K a split takes: 8 steps of WG_BK
constexpr int WG_MIN_K = 8 * WG_BK;

struct WgArgs {
  WgJob job[WG_MAX_JOBS];
  WgSum sum[WG_MAX_SUMS];
  int njobs, nsums, K, B, kper;
  int tiles[WG_MAX_JOBS + 1];  // prefix sums of the jobs' output tiles
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((size_t)p & 15) == 0;
}

// Tiles of BM x WG_BN outputs (BM = 128 rows where the widths fill them,
// else 64), K in steps of WG_BK staged in shared memory (double-buffered
// with cp.async; on an H100 a ring of 3 or 4 steps was no faster at the
// sepsis shape), BM / 16 x 4 outputs a thread in registers. blockIdx.x
// runs over the jobs' tiles, then over the column sums (one block a step
// and stream); blockIdx.y is the split of K, blockIdx.z the member. A
// fixed order everywhere, no atomics: runs are bit-reproducible, and a
// member's sums are those of a launch of that member alone.
template <int BM>
__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(WgArgs A) {
  constexpr int TM = BM / 16;
  __shared__ __align__(16) float xs[2][WG_BK][BM];
  __shared__ __align__(16) float es[2][WG_BK][WG_BN];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const long long mk = blockIdx.z;
  if (b >= A.tiles[A.njobs]) {  // a column sum: one step of one stream
    if (blockIdx.y != 0) return;
    int si = 0, u = b - A.tiles[A.njobs];
    while (si < A.nsums && u >= A.sum[si].steps) u -= A.sum[si++].steps;
    if (si >= A.nsums) return;
    WgSum S = A.sum[si];
    S.s += mk * S.ms;
    S.out += mk * S.mo;
    float* red = &xs[0][0][0];  // [4][64]
    const int grp = tid >> 6, cl = tid & 63;
    for (int c0 = 0; c0 < S.N; c0 += 64) {
      const int c = c0 + cl;
      float acc = 0.f;
      if (c < S.N) {
        const long long su = S.seg ? seg_row(u, S.seg, S.gap) : u;
        const float* src = S.s + (size_t)su * A.B * S.N + c;
        for (int r = grp; r < A.B; r += 4) acc += src[(size_t)r * S.N];
      }
      red[grp * 64 + cl] = acc;
      __syncthreads();
      if (grp == 0 && c < S.N)
        S.out[(size_t)u * S.N + c] =
            ((red[cl] + red[64 + cl]) + red[128 + cl]) + red[192 + cl];
      __syncthreads();
    }
    return;
  }
  int j = 0;
  while (b >= A.tiles[j + 1]) ++j;
  WgJob J = A.job[j];
  J.x0 += mk * J.mx0;  // (a null segment has stride 0)
  J.x += mk * J.mx;
  J.x2 += mk * J.mx2;
  J.e += mk * J.me;
  J.p += mk * J.mp;
  const int t = b - A.tiles[j], NCt = (J.N + WG_BN - 1) / WG_BN;
  const int c0 = (t % NCt) * WG_BN, m0 = (t / NCt) * BM;
  const int N = J.N, rows = J.rows;
  const int tc = tid % 16, tm = tid / 16;
  const int n0 = blockIdx.y * A.kper, n1 = min(A.K, n0 + A.kper);
  const bool xvec = (rows & 3) == 0 && aligned16(J.x) &&
                    (!J.x0 || aligned16(J.x0)) && (!J.x2 || aligned16(J.x2));
  const bool yvec = (N & 3) == 0 && aligned16(J.e);
  auto row_of = [&](int bit, long long i) {
    return (J.segm & bit) ? seg_row(i, J.seg, J.gap) : i;
  };
  auto xrow = [&](int n) -> const float* {
    return n < J.nb0   ? J.x0 + (size_t)n * rows
           : n < J.nb1 ? J.x + (size_t)row_of(1, n - J.nb0) * rows
                       : J.x2 + (size_t)row_of(2, n - J.nb1) * rows;
  };
  auto load = [&](int buf, int nb) {
    for (int q = tid; q < WG_BK * BM / 4; q += WG_THREADS) {
      const int lr = q / (BM / 4), lc = (q % (BM / 4)) * 4;
      const int n = nb + lr, m = m0 + lc;
      const float* x = n < n1 ? xrow(n) + m : nullptr;
      if (xvec) {
        const bool ok = x && m < rows;
        cp_async16(&xs[buf][lr][lc], ok ? x : J.x, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const bool ok = x && m + jj < rows;
          cp_async4(&xs[buf][lr][lc + jj], ok ? x + jj : J.x, ok ? 4 : 0);
        }
      }
    }
    const int lr = tid / 16, lc = (tid % 16) * 4, n = nb + lr, c = c0 + lc;
    const float* y = J.e + (size_t)row_of(4, n) * N + c;
    if (yvec) {
      const bool ok = n < n1 && c < N;
      cp_async16(&es[buf][lr][lc], ok ? y : J.e, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const bool ok = n < n1 && c + jj < N;
        cp_async4(&es[buf][lr][lc + jj], ok ? y + jj : J.e, ok ? 4 : 0);
      }
    }
  };
  float acc[TM][4], bsum[4];
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    bsum[jj] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][jj] = 0.f;
  }
  const bool own_b = J.bias && m0 == 0 && tm == 0;
  const int nk = n1 > n0 ? (n1 - n0 + WG_BK - 1) / WG_BK : 0;
  if (nk > 0) {
    load(0, n0);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load((kt + 1) & 1, n0 + (kt + 1) * WG_BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int bf = kt & 1;
#pragma unroll
    for (int kk = 0; kk < WG_BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 a = ld_f4(&xs[bf][kk][tm * TM + i]);
        av[i] = a.x;
        av[i + 1] = a.y;
        av[i + 2] = a.z;
        av[i + 3] = a.w;
      }
      const float4 y = ld_f4(&es[bf][kk][tc * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], lane4(y, jj), acc[i][jj]);
      if (own_b)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) bsum[jj] += lane4(y, jj);
    }
    __syncthreads();
  }
  float* pz = J.p + (size_t)blockIdx.y * (rows + 1) * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + tc * 4 + jj;
      if (m < rows && c < N) pz[(size_t)m * N + c] = acc[i][jj];
    }
  }
  if (m0 == 0 && tm == 0)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int c = c0 + tc * 4 + jj;
      if (c < N) pz[(size_t)rows * N + c] = J.bias ? bsum[jj] : 0.f;
    }
}

// rows of the weight-gradient tile: 128 where the widths fill them
inline int wg_rows(int H, int HH) { return (H > 64 || HH > 64) ? 128 : 64; }

// Splits of K for products whose output tiles number `tiles`: about two
// CTAs an SM, each split at least WG_MIN_K rows of K.
inline int wg_splits(long long K, long long tiles) {
  long long s = (2LL * sm_count() + tiles - 1) / (tiles > 0 ? tiles : 1);
  s = std::min(s, K / WG_MIN_K);
  return (int)std::max(s, 1LL);
}

// The weight-gradient products of an SDE backward over K rows of its
// streams: the jobs (Wy' unless the drift is 'xt', each W_l, Wout, then
// the noise net's Wn1 and Wn2 where it has them, in that order), their
// output tiles and the splits of K
struct WgPlan {
  int njobs, S, bm;
  long long tiles;
};

inline long long wg_tiles(int rows, int N, int bm) {
  return (long long)((rows + bm - 1) / bm) * ((N + WG_BN - 1) / WG_BN);
}

inline int noise_jobs(const SdeDims& d) {
  return d.noise == NZ_NET1 ? 1 : d.noise == NZ_NET2 ? 2 : 0;
}

inline WgPlan wg_plan(const SdeDims& d, long long K) {
  WgPlan w;
  const int wy = d.drift != DR_XT, nn = noise_jobs(d);
  w.njobs = wy + d.NI + 1 + nn;
  w.bm = wg_rows(d.H, d.HH);
  w.tiles = wy * wg_tiles(d.H, d.HH, w.bm) +
            d.NI * wg_tiles(d.HH, d.HH, w.bm) + wg_tiles(d.HH, d.H, w.bm) +
            nn * wg_tiles(d.H, d.H, w.bm);
  w.S = wg_splits(K, w.tiles);
  return w;
}

// The drift's jobs of an SDE backward's weight gradient over K rows a
// member: Wy' (x: the states the first layer read, x0 / x / x2 split at
// nb0 and nb1, their member strides m0, m1, m2 floats; e: dz1; not in
// drift mode 'xt'), each W_l (x: hs[l], e: es[l]), Wout (x: hs[NI], e:
// dz3), their split partials one after another from p (Wy' [S][H+1][HH],
// each W_l [S][HH+1][HH], Wout [S][HH+1][H]; the last row of each the bias
// sum, zero for Wy'). dz1, dz3 and each layer of hs and es hold the K
// members' rows (hs and es a layer after another), member k's from row
// k mr, in segments of `seg` rows `gap` rows apart when seg > 0 (the SRK's
// two evaluations). Returns the floats of p they take (a member's;
// set_member_partials sets its stride).
inline long long wg_jobs(const SdeDims& d, const WgPlan& wp, long long K,
                         const float* x0, const float* x, const float* x2,
                         int nb0, int nb1, long long m0, long long m1,
                         long long m2, long long mr, int seg, long long gap,
                         const float* dz1, const float* hs, const float* es,
                         const float* dz3, float* p,
                         std::vector<WgJob>& jobs) {
  const long long lay = (long long)d.K * K * d.HH, mh = mr * d.HH;
  long long off = 0;
  for (int j = d.drift == DR_XT ? 1 : 0; j < d.NI + 2; ++j) {
    WgJob J{};
    if (j == 0)
      J = WgJob{x0, x, x2, dz1, nullptr, d.H, d.HH, nb0, nb1, 0,
                m0, m1, m2, mh, 0, seg ? 4 : 0, seg, gap};
    else if (j <= d.NI)
      J = WgJob{nullptr, hs + (j - 1) * lay, nullptr, es + (j - 1) * lay,
                nullptr, d.HH, d.HH, 0, INT_MAX, 1, 0, mh, 0, mh, 0,
                seg ? 5 : 0, seg, gap};
    else
      J = WgJob{nullptr, hs + d.NI * lay, nullptr, dz3, nullptr, d.HH, d.H,
                0, INT_MAX, 1, 0, mh, 0, mr * d.H, 0, seg ? 5 : 0, seg,
                gap};
    J.p = p + off;
    off += (long long)wp.S * (J.rows + 1) * J.N;
    jobs.push_back(J);
  }
  return off;
}

// The noise net's jobs, their partials from p: Wn1 [S][H+1][H] (x: the
// states each diffusion evaluation read, x0 / x / x2 split at nb0 and nb1,
// member strides m0, m1, m2; e: dn, the cotangent of its output; no bias
// sum: the bias is in the an1 rows), and for net2 Wn2 [S][H+1][H] (x: nh,
// the hidden activations; e: dz2, the cotangent of its output; the last
// row the bias sum). x2, dn, nh and dz2 hold member k's rows from row
// k mr, in segments as wg_jobs's.
inline void wg_noise_jobs(const SdeDims& d, const WgPlan& wp,
                          const float* x0, const float* x, const float* x2,
                          int nb0, int nb1, long long m0, long long m1,
                          long long m2, long long mr, int seg, long long gap,
                          const float* dn, const float* nh, const float* dz2,
                          float* p, std::vector<WgJob>& jobs) {
  if (!net_noise(d.noise)) return;
  const long long mh = mr * d.H;
  jobs.push_back(WgJob{x0, x, x2, dn, p, d.H, d.H, nb0, nb1, 0, m0, m1, m2,
                       mh, 0, seg ? 6 : 0, seg, gap});
  if (d.noise == NZ_NET2)
    jobs.push_back(WgJob{nullptr, nh, nullptr, dz2,
                         p + (long long)wp.S * (d.H + 1) * d.H, d.H, d.H, 0,
                         INT_MAX, 1, 0, mh, 0, mh, 0, seg ? 5 : 0, seg,
                         gap});
}

// Every job's partials at `per` floats a member
inline void set_member_partials(std::vector<WgJob>& jobs, long long per) {
  for (WgJob& J : jobs) J.mp = per;
}

// Launch the jobs, in launches of at most WG_MAX_JOBS, with the column sums
// (at most WG_MAX_SUMS) in the first; B rows a step of the summed streams;
// `members` members (gridDim.z).
inline int run_wgrad_jobs(const std::vector<WgJob>& jobs, const WgSum* sums,
                          int nsums, long long K, int B, const WgPlan& wp,
                          int members, cudaStream_t s) {
  const int kper = (int)(((K + wp.S - 1) / wp.S + WG_BK - 1) / WG_BK * WG_BK);
  for (size_t j0 = 0; j0 < jobs.size(); j0 += WG_MAX_JOBS) {
    WgArgs A{};
    A.njobs = (int)std::min<size_t>(WG_MAX_JOBS, jobs.size() - j0);
    A.K = (int)K;
    A.B = B;
    A.kper = kper;
    A.tiles[0] = 0;
    for (int j = 0; j < A.njobs; ++j) {
      A.job[j] = jobs[j0 + j];
      const long long tm = (A.job[j].rows + wp.bm - 1) / wp.bm;
      const long long tc = (A.job[j].N + WG_BN - 1) / WG_BN;
      A.tiles[j + 1] = A.tiles[j] + (int)(tm * tc);
    }
    A.nsums = j0 == 0 ? nsums : 0;
    int steps = 0;
    for (int i = 0; i < A.nsums; ++i) {
      A.sum[i] = sums[i];
      steps += sums[i].steps;
    }
    const dim3 grid((unsigned)(A.tiles[A.njobs] + steps), (unsigned)wp.S,
                    (unsigned)members);
    if (wp.bm == 128)
      wgrad_kernel<128><<<grid, WG_THREADS, 0, s>>>(A);
    else
      wgrad_kernel<64><<<grid, WG_THREADS, 0, s>>>(A);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// The sums of split partials
// ---------------------------------------------------------------------------

// out[i] = sum over s < S of p[s n + i] for i < n, s in ascending order;
// member k's at k mp and k mo
struct SplitSum {
  const float* p;
  float* out;
  long long n, mp, mo;
  int S;
};

constexpr int SPLIT_MAX = 8, SPLIT_THREADS = 256;

struct SplitArgs {
  SplitSum seg[SPLIT_MAX];
  long long first[SPLIT_MAX + 1];  // prefix sums of the segments' n
  int nseg;
};

// One output a thread over every segment's outputs (blockIdx.y the
// member): each a sum in one fixed order, so a member's result is the one
// a launch of that member alone gives.
__global__ void __launch_bounds__(SPLIT_THREADS)
split_sum_kernel(SplitArgs A) {
  const long long i =
      (long long)blockIdx.x * SPLIT_THREADS + threadIdx.x;
  if (i >= A.first[A.nseg]) return;
  int j = 0;
  while (i >= A.first[j + 1]) ++j;
  const SplitSum G = A.seg[j];
  const long long k = blockIdx.y, o = i - A.first[j];
  const float* p = G.p + k * G.mp + o;
  float acc = 0.f;
  for (int z = 0; z < G.S; ++z) acc += p[(long long)z * G.n];
  G.out[k * G.mo + o] = acc;
}

// Sum the segments (at most SPLIT_MAX a launch) for `members` members.
inline int run_split_sums(const std::vector<SplitSum>& segs, int members,
                          cudaStream_t s) {
  for (size_t j0 = 0; j0 < segs.size(); j0 += SPLIT_MAX) {
    SplitArgs A{};
    A.nseg = (int)std::min<size_t>(SPLIT_MAX, segs.size() - j0);
    A.first[0] = 0;
    for (int j = 0; j < A.nseg; ++j) {
      A.seg[j] = segs[j0 + j];
      A.first[j + 1] = A.first[j] + A.seg[j].n;
    }
    const long long blocks =
        (A.first[A.nseg] + SPLIT_THREADS - 1) / SPLIT_THREADS;
    if (blocks == 0) continue;
    split_sum_kernel<<<dim3((unsigned)blocks, (unsigned)members),
                       SPLIT_THREADS, 0, s>>>(A);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// The sums of a weight gradient's split partials: job j's S splits of
// (rows + 1) x N into w, one job after another ((rows + 1) x N floats
// each: the weight, then its bias sum), `pm` and `wm` floats a member.
inline std::vector<SplitSum> wg_split_sums(const std::vector<WgJob>& jobs,
                                           const WgPlan& wp, float* w,
                                           long long pm, long long wm) {
  std::vector<SplitSum> segs;
  long long off = 0;
  for (const WgJob& J : jobs) {
    const long long n = (long long)(J.rows + 1) * J.N;
    segs.push_back(SplitSum{J.p, w + off, n, pm, wm, wp.S});
    off += n;
  }
  return segs;
}

}  // namespace
