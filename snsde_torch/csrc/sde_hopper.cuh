// Device code of the fused SDE kernels' Hopper design (fused_em.cu; the
// SRK pair is to move onto it): register-tiled products over a group of a
// CTA's threads, the exchange of a layer's output row over a thread-block
// cluster, asynchronous copies, the cluster launch, and the weight-gradient
// product that runs after a reverse loop.
//
// Everything here has internal linkage: each source that includes it
// builds into its own library.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

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
                   cudaLaunchAttribute* attr, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  cfg = {};
  cfg.gridDim = dim3((unsigned)(ctas > 0 ? ctas : cs));
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

// Launch kernel k on `ctas` CTAs of ET threads in clusters of cs, with
// `bytes` of dynamic shared memory, or, without `run`, only check it:
// cudaOccupancyMaxActiveClusters must find room for at least one cluster
// (its count in *active when given). An unschedulable launch returns an
// error: there is no quiet fallback to another route.
template <class... Exp, class... Act>
int launch_clusters(void (*k)(Exp...), int cs, int ctas, long long bytes,
                    cudaStream_t s, int* active, bool run, Act... args) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  const int e = cluster_config(k, cs, ctas, bytes, s, cfg, attr, &n);
  if (e) return e;
  if (active) *active = n;
  if (n < 1) return (int)cudaErrorLaunchOutOfResources;
  if (!run || ctas == 0) return 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, k, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The weight-gradient product after a reverse loop
// ---------------------------------------------------------------------------

// One product of the weight gradient: p[z][m][c] = sum over the split z's
// n of x(n)[m] e[n][c] for m < rows, c < N, and, with bias, p[z][rows][c]
// = the split's sum of e[n][c] (else that row is 0). x(n) is x0 + n rows
// for n < nb0 and x + (n - nb0) rows after (each row `rows` floats); e
// rows N floats. p holds S splits of (rows + 1) x N.
struct WgJob {
  const float *x0, *x, *e;
  float* p;
  int rows, N, nb0, bias;
};

// Column sums of a stream [M][B][N] by step: out[u][c] = sum_b s[u][b][c]
// (summed in a fixed order).
struct WgSum {
  const float* s;
  float* out;
  int N;
};

constexpr int WG_MAX_JOBS = 8, WG_MAX_SUMS = 2;
constexpr int WG_THREADS = 256, WG_BN = 64, WG_BK = 16;
// the least K a split takes: 8 steps of WG_BK
constexpr int WG_MIN_K = 8 * WG_BK;

struct WgArgs {
  WgJob job[WG_MAX_JOBS];
  WgSum sum[WG_MAX_SUMS];
  int njobs, nsums, K, M, B, kper;
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
// and stream); blockIdx.y is the split of K. A fixed order everywhere, no
// atomics: runs are bit-reproducible.
template <int BM>
__global__ void __launch_bounds__(WG_THREADS) wgrad_kernel(WgArgs A) {
  constexpr int TM = BM / 16;
  __shared__ __align__(16) float xs[2][WG_BK][BM];
  __shared__ __align__(16) float es[2][WG_BK][WG_BN];
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  if (b >= A.tiles[A.njobs]) {  // a column sum: one step of one stream
    if (blockIdx.y != 0) return;
    const int q = b - A.tiles[A.njobs], si = q / A.M, u = q - si * A.M;
    if (si >= A.nsums) return;
    const WgSum S = A.sum[si];
    float* red = &xs[0][0][0];  // [4][64]
    const int grp = tid >> 6, cl = tid & 63;
    for (int c0 = 0; c0 < S.N; c0 += 64) {
      const int c = c0 + cl;
      float acc = 0.f;
      if (c < S.N) {
        const float* src = S.s + (size_t)u * A.B * S.N + c;
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
  const WgJob J = A.job[j];
  const int t = b - A.tiles[j], NCt = (J.N + WG_BN - 1) / WG_BN;
  const int c0 = (t % NCt) * WG_BN, m0 = (t / NCt) * BM;
  const int N = J.N, rows = J.rows;
  const int tc = tid % 16, tm = tid / 16;
  const int n0 = blockIdx.y * A.kper, n1 = min(A.K, n0 + A.kper);
  const bool xvec = (rows & 3) == 0 && aligned16(J.x) &&
                    (!J.x0 || aligned16(J.x0));
  const bool yvec = (N & 3) == 0 && aligned16(J.e);
  auto xrow = [&](int n) -> const float* {
    return n < J.nb0 ? J.x0 + (size_t)n * rows
                     : J.x + (size_t)(n - J.nb0) * rows;
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
    const float* y = J.e + (size_t)n * N + c;
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

// Splits of K = M B for products whose output tiles number `tiles`: about
// two CTAs an SM, each split at least WG_MIN_K rows of K.
inline int wg_splits(long long K, long long tiles) {
  long long s = (2LL * sm_count() + tiles - 1) / (tiles > 0 ? tiles : 1);
  s = std::min(s, K / WG_MIN_K);
  return (int)std::max(s, 1LL);
}

}  // namespace
