// Fused GRU and LSTM recurrences over a whole sequence, forward and backward
// kernels for NVIDIA Hopper (sm_90a), plain C interface (loaded with ctypes
// by snsde_torch/kernels/fused_rnn.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_rnn.py:
//   GRU forward   _fused_gru (pallas_call at :312, body _fwd_kernel :80)
//   GRU backward  _fused_gru_bwd (pallas_call at :396, body _bwd_kernel :114)
//   LSTM forward  _lstm_forward (pallas_call at :837, body _lstm_fwd_kernel
//                 :578)
//   LSTM backward _fused_lstm_bwd (pallas_call at :934, body
//                 _lstm_bwd_kernel :616)
// in the modes the plain recurrent baselines and GRUD-full use: the GRU
// from any h0, with or without the per-sample hidden-decay stream hdec
// [L, B, H] (has_dec == 2), and the LSTM from zero (h, c). The input
// projection gi = x W_ih + b_ih [L, B, G*H] is computed outside the
// kernels (one matrix product); gates follow torch's order, (r, z, n) and
// (i, f, g, o):
//   GRU:  h_in = h * hdec_t (or h);  gh = h_in W_hh + b_hh
//         r = sig(gi_r + gh_r), z = sig(gi_z + gh_z),
//         n = tanh(gi_n + r gh_n),  h' = (1 - z) n + z h_in
//   LSTM: g = gi + h W_hh + b_hh;  c' = sig(g_f) c + sig(g_i) tanh(g_g)
//         h' = sig(g_o) tanh(c')
// The TPU kernels pad each gate block to 128 lanes and the sequence to the
// unroll with a `valid` flag row; both are TPU layout devices, so these
// kernels loop over the true L and H. A bidirectional run flips its
// streams outside the kernels, as the JAX package does.
//
// Design, both pairs (G = 3 gates for the GRU, 4 for the LSTM). At H = 128
// W_hh is 192 KB (GRU) and 256 KB (LSTM): it does not fit one block beside
// its tiles, and a weight gradient accumulated inside the recurrence puts
// a sweep over all of dW_hh on every step of the serial chain. So:
//
// * A cluster of CS CTAs (CS in {1, 2, 4, 8}) runs the recurrence for R
//   batch rows (R in {8, 16, 32}). CTA q owns the units [q U, min(H, (q +
//   1) U)), U = ceil(H / CS), and keeps the W_hh columns of their G gates
//   (its slice, [H][G sU], odd row stride) in its shared memory. The host
//   plan (rnn_plan) takes the smallest CS whose slice fits beside the
//   CTA's tiles, and the fewest rows that keep the CTAs within one wave
//   (fewer if they do not fit); where no CS up to 8 fits (H above ~256 for
//   the LSTM, ~320 for the GRU), the slices are read from device memory
//   (L2-resident) with CS = 8.
// * Forward step: each CTA computes its units' gates for the R rows from
//   the full cell input state in its own shared memory, writes hs (and
//   the LSTM's cs, its c kept in shared memory), and stores its part of
//   the next step's input state into every CTA of the cluster
//   (distributed shared memory): the GRU's h times the next step's decay
//   when it has one, the LSTM's h. The state is double-buffered, so one
//   cluster barrier a step suffices. The gi columns (and the GRU's decay
//   of its own units) are prefetched with cp.async two steps ahead.
// * Backward step: the state before the step comes from the hs stream
//   (h0 at the GRU's first step, zero at the LSTM's), so nothing is
//   exchanged for it; it is prefetched a step ahead with cp.async, with
//   the step's gi and ghs (and the LSTM's c, the GRU's decay row). Each
//   CTA recomputes its units' gates, forms their cotangents (written to
//   dgi) and multiplies them by its own columns of W_hh^T into a partial
//   dh [R][H] in its shared memory; after the cluster barrier each CTA
//   sums the CS partials of its own units in rank order (a fixed order:
//   runs are bit-reproducible). The partials are double-buffered: one
//   cluster barrier a step. The GRU adds the direct share gbar z and takes
//   the sum through the decay (its cotangent dhdec) to the state before
//   the step, or to dh0 at the first step.
// * The weight gradient: the gates' h-part is x_t W_hh + b_hh with x_t
//   the cell's input state (GRU: h_{t-1} hdec_t, h_{-1} = h0; LSTM:
//   h_{t-1}, h_{-1} = 0), so dW_hh = sum_t x_t^T dg_t and db_hh = sum dg_t,
//   dg being W_hh's cotangent: the LSTM's dgi itself; for the GRU a second
//   stream dgh that the backward writes beside dgi ([dr, dz, dn r] where
//   dgi has [dr, dz, dn]). That is one parallel [H, L B] x [L B, G H]
//   product over streams already in device memory (rnn_wgrad_kernel,
//   after the recurrence): a tiled fp32 SIMT product, K = L B split over
//   enough CTAs to fill the card, the split partials summed by the wrapper
//   in a fixed order.
// Plain fp32 FMA on the CUDA cores (TF32 off), no atomics.
//
// What bounds it on the H100: at the bench shapes (B = 1024, L = 72) the
// work is small. At H = 32 the GRU forward moves 38 MB (gi in, hs out) and
// does 0.45 GFLOP: ~11 us, bytes; at H = 128 it does 7.2 GFLOP: ~108 us,
// operations. Beyond the bound, each step's product and gate math sit on a
// chain of L dependent steps with a cluster barrier between them, and the
// sweep's shape (B = 64: 8 CTAs on 132 SMs, H = 16) is bound by that
// chain alone.

#include <cooperative_groups.h>

#include <algorithm>
#include <map>
#include <mutex>
#include <tuple>

#include "sde_common.cuh"

namespace {

namespace cg = cooperative_groups;

struct RnnDims {
  int L, B, H;
};

__device__ __forceinline__ void zero_smem(float* s, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += THREADS) s[i] = 0.f;
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// A CTA's share of the units: U (the last CTA may own fewer), padded to sU
// in the shared-memory layouts; rows of h padded to sH (float4 loads).
struct Split {
  int U, sU, sH;
};

__host__ __device__ inline Split split_of(int H, int cs) {
  const int U = (H + cs - 1) / cs;
  return Split{U, round4(U), round4(H)};
}

// Shared memory of a CTA, in floats, for G gates. GRU forward: the cell's
// input state [2][R][sH], the own gi columns of three steps [3][R][3 sU],
// the own units' decay of three steps [3][R][sU], bias [3 sU]. GRU
// backward: h before the step and the step's decay [R][sH] each, the
// step's own gi columns [R][3 sU], the
// step's ghs, the cotangent of the step's output h from the later steps,
// its direct share gbar z in the input's, h before the step and the decay
// [R][sU] each (own units), the gate cotangents [R][3 sU], the partial dh
// [2][R][sH], bias [3 sU]. LSTM forward: h [2][R][sH], the own gi columns
// of three steps [3][R][4 sU], c [R][sU], bias [4 sU]. LSTM backward: h
// before the step [R][sH], the step's own gi columns [R][4 sU], c before
// the step, the step's ghs, the cotangents of the step's output h (from
// the later steps) and c [R][sU] each, the gate cotangents [R][4 sU], the
// partial dh [2][R][sH], bias [4 sU]. Then the slice when it is in shared
// memory.
inline size_t rnn_floats(int G, int H, int cs, int R, int w_smem,
                         int backward) {
  const Split s = split_of(H, cs);
  const size_t rH = (size_t)R * s.sH, rU = (size_t)R * s.sU;
  size_t tiles;
  if (G == 3)
    tiles = backward ? 4 * rH + 11 * rU + 3 * s.sU
                     : 2 * rH + 12 * rU + 3 * s.sU;
  else
    tiles = backward ? 3 * rH + 12 * rU + 4 * s.sU
                     : 2 * rH + 13 * rU + 4 * s.sU;
  return tiles + (w_smem ? (size_t)H * odd(G * s.sU) : 0);
}

inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

struct RnnPlan {
  int cs;      // CTAs per cluster
  int rows;    // batch rows per cluster
  int w_smem;  // 1: the slices in shared memory; 0: read from device memory
  int rpt;     // rows per thread of the per-step products
  size_t bytes;
};

// rows per thread: few enough that the step's (unit, row group) items keep
// most threads busy, enough that they do not outnumber the threads
inline int rows_per_thread(int U, int R) {
  int rpt = 1;
  while (rpt < 8 && U * (R / rpt) > THREADS) rpt *= 2;
  return rpt;
}

inline RnnPlan rnn_plan(int G, int H, int B, int backward) {
  const size_t limit = (size_t)max_optin_smem();
  const int sms = sm_count();
  for (int w_smem = 1; w_smem >= 0; --w_smem)
    for (int cs = w_smem ? 1 : 8; cs <= 8; cs *= 2) {
      int want = 8;
      while (want < 32 && (B + want - 1) / want * cs > sms) want *= 2;
      for (int R = want; R >= 8; R /= 2) {
        const size_t bytes =
            sizeof(float) * rnn_floats(G, H, cs, R, w_smem, backward);
        if (bytes <= limit)
          return RnnPlan{cs, R, w_smem,
                         rows_per_thread(split_of(H, cs).U, R), bytes};
      }
    }
  return RnnPlan{0, 0, 0, 0, 0};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 4 or 16 bytes from device to shared memory, asynchronously; the bytes
// past `bytes` (0 for none) are filled with zeros
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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// dst[r][j][i] <- src[r][j][i] for r < nr, j < m, i < n (row and group
// strides in floats): 16 bytes a copy when v4 (n, the strides and both
// addresses multiples of 4 floats), else 4. Copy i is issued by thread
// (first + i) mod THREADS, so a caller can hand the copies to the threads
// that the step's work leaves idle. Each of a step's calls starts there
// (chained one after another instead, the LSTM's backward recurrence took
// 10-12% longer at B=1024, L=72, H=32 on an H100, the GRU's backward ~5%
// less at the sweep's shape and 4-8% more at H=64 and 128).
__device__ __forceinline__ void copy_rows_async(float* dst, int dr, int dj,
                                                const float* src, size_t sr,
                                                int sj, int nr, int m, int n,
                                                bool v4, int first = 0) {
  const int w = v4 ? 4 : 1, nw = n / w, per = m * nw, total = nr * per;
  for (int i = (threadIdx.x + THREADS - first) % THREADS; i < total;
       i += THREADS) {
    const int r = i / per, j = (i - r * per) / nw;
    const int c = (i - r * per - j * nw) * w;
    float* d = dst + r * dr + j * dj + c;
    const float* s = src + r * sr + (size_t)j * sj + c;
    if (v4)
      cp_async16(d, s, 16);
    else
      cp_async4(d, s);
  }
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return ((size_t)p & 15) == 0;
}

// The CTA's units [u0, u0 + nu) and its cluster's rows [row0, row0 + nr)
struct Geom {
  Split s;
  int u0, nu, row0, nr;
};

__device__ __forceinline__ Geom geom_of(const RnnDims& d, int cs, int R,
                                        int rank) {
  Geom g;
  g.s = split_of(d.H, cs);
  g.u0 = rank * g.s.U;
  g.nu = max(0, min(d.H - g.u0, g.s.U));
  g.row0 = (int)(blockIdx.x / cs) * R;
  g.nr = min(R, d.B - g.row0);
  return g;
}

// The CTA's columns of W_hh [H][G H]: gate gt of own unit ul in row k at
// p[k * ld + gt * gs + ul]
struct WSlice {
  const float* p;
  int ld, gs;
};

template <int G, int WS>
__device__ __forceinline__ WSlice load_slice(float* s,
                                             const float* __restrict__ whh,
                                             int H, const Geom& g) {
  if (!WS) return WSlice{whh + g.u0, G * H, H};
  const int ld = odd(G * g.s.sU), n = G * g.nu;
  for (int i = threadIdx.x; i < H * n; i += THREADS) {
    const int k = i / n, j = i - k * n, gt = j / g.nu, ul = j - gt * g.nu;
    s[k * ld + gt * g.s.sU + ul] = whh[(size_t)k * G * H + gt * H + g.u0 + ul];
  }
  return WSlice{s, ld, g.s.sU};
}

// a cluster of one needs only the block's barrier
__device__ __forceinline__ void cluster_or_block_sync(cg::cluster_group& c,
                                                      int cs) {
  if (cs == 1)
    __syncthreads();
  else
    c.sync();
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[gt][q] = sum_k x[(r0 + q) * sH + k] W[k][gt, ul]: the G gates of own
// unit ul for the RPT rows r0.. of the tile x [R][sH]; x read four k at a
// time (a warp reads one or two rows: broadcasts), each W load feeds RPT
// FMAs. x = h, or with DEC h times dec (the same layout), formed as it is
// read.
template <int G, int RPT, bool DEC = false>
__device__ __forceinline__ void gate_sums(const float* h, int sH, int H,
                                          const WSlice w, int ul, int r0,
                                          float (&acc)[G][RPT],
                                          const float* dec = nullptr) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[g][q] = 0.f;
  const int H4 = H & ~3;
  for (int k = 0; k < H4; k += 4) {
    float4 x[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      x[q] = *reinterpret_cast<const float4*>(h + (r0 + q) * sH + k);
      if (DEC) {
        const float4 v =
            *reinterpret_cast<const float4*>(dec + (r0 + q) * sH + k);
        x[q].x *= v.x;
        x[q].y *= v.y;
        x[q].z *= v.z;
        x[q].w *= v.w;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = w.p + (size_t)(k + kk) * w.ld + ul;
      float wv[G];
#pragma unroll
      for (int g = 0; g < G; ++g) wv[g] = wk[g * w.gs];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float xv = lane(x[q], kk);
#pragma unroll
        for (int g = 0; g < G; ++g) acc[g][q] = fmaf(xv, wv[g], acc[g][q]);
      }
    }
  }
  for (int k = H4; k < H; ++k) {
    const float* wk = w.p + (size_t)k * w.ld + ul;
    float wv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) wv[g] = wk[g * w.gs];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int o = (r0 + q) * sH + k;
      const float xv = DEC ? h[o] * dec[o] : h[o];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g][q] = fmaf(xv, wv[g], acc[g][q]);
    }
  }
}

// acc[q] = sum over own columns (gt, ul) of dg[r0 + q][gt, ul] W[k][gt, ul]:
// the CTA's part of dh for unit k and the RPT rows r0.. (dg [R][G sU],
// read four columns at a time; a thread walks row k of the slice, whose
// odd stride keeps neighbouring threads on distinct banks)
template <int G, int RPT>
__device__ __forceinline__ void back_sums(const float* dg, int sU, int nu,
                                          const WSlice w, int k, int r0,
                                          float (&acc)[RPT]) {
  const int sD = G * sU, nu4 = nu & ~3;
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
  const float* wk = w.p + (size_t)k * w.ld;
#pragma unroll
  for (int gt = 0; gt < G; ++gt) {
    const float* wg = wk + gt * w.gs;
    const float* dgt = dg + gt * sU;
    for (int ul = 0; ul < nu4; ul += 4) {
      const float w0 = wg[ul], w1 = wg[ul + 1], w2 = wg[ul + 2],
                  w3 = wg[ul + 3];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float4 x =
            *reinterpret_cast<const float4*>(dgt + (r0 + q) * sD + ul);
        float a = fmaf(x.x, w0, acc[q]);
        a = fmaf(x.y, w1, a);
        a = fmaf(x.z, w2, a);
        acc[q] = fmaf(x.w, w3, a);
      }
    }
    for (int ul = nu4; ul < nu; ++ul) {
      const float wv = wg[ul];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        acc[q] = fmaf(dgt[(r0 + q) * sD + ul], wv, acc[q]);
    }
  }
}

// ---------------------------------------------------------------------------
// GRU
// ---------------------------------------------------------------------------

template <int RPT, int WS>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
               const float* __restrict__ h0, const float* __restrict__ whh,
               const float* __restrict__ bhh, const float* __restrict__ hdec,
               float* __restrict__ hs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Geom g = geom_of(d, cs, R, (int)cluster.block_rank());
  const int H = d.H, GH = 3 * H, sH = g.s.sH, sU = g.s.sU, tid = threadIdx.x;
  const int tileH = R * sH, tileG = 3 * R * sU, tileU = R * sU;
  const size_t BH = (size_t)d.B * H;
  float* hbuf = smem;              // the cell's input state [2][R][sH], all
  float* gbuf = hbuf + 2 * tileH;  // gi, own columns [3][R][3 sU]
  float* dbuf = gbuf + 3 * tileG;  // the next step's decay, own [3][R][sU]
  float* bias = dbuf + 3 * tileU;  // [3 sU]
  float* rest = bias + 3 * sU;
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<3, WS>(rest, whh, H, g);
  for (int i = tid; i < 3 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // the first step's input state, every unit: h0, decayed
  for (int i = tid; i < g.nr * H; i += THREADS) {
    const int r = i / H, k = i - r * H;
    const size_t o = (size_t)(g.row0 + r) * H + k;
    hbuf[r * sH + k] = hdec ? h0[o] * hdec[o] : h0[o];
  }
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) &&
                  (!hdec || aligned16(hdec));
  // step t's gi columns, and the decay the state after it takes, issued
  // from thread `first` on
  auto prefetch = [&](int t, int first) {
    const int slot = t % 3;
    copy_rows_async(gbuf + slot * tileG, 3 * sU, sU,
                    gi + ((size_t)t * d.B + g.row0) * GH + g.u0, GH, H, g.nr,
                    3, g.nu, v4, first);
    if (hdec && t + 1 < d.L)
      copy_rows_async(dbuf + slot * tileU, sU, 0,
                      hdec + ((size_t)(t + 1) * d.B + g.row0) * H + g.u0, H,
                      0, g.nr, 1, g.nu, v4, first);
  };
  // one copy group a step, empty or not, two steps in flight
  prefetch(0, 0);
  cp_async_commit();
  if (d.L > 1) prefetch(1, 0);
  cp_async_commit();
  cp_async_wait<1>();
  cluster.sync();  // every CTA's state is in place before a peer writes
  // the step's (unit, row group) items; its copies go to the threads after
  const int items = g.nu * (R / RPT), idle = items % THREADS;
  for (int t = 0; t < d.L; ++t) {
    const int cur = t & 1;
    const float* hc = hbuf + cur * tileH;
    float* hn = hbuf + (cur ^ 1) * tileH;
    const float* git = gbuf + (t % 3) * tileG;
    const float* dec = dbuf + (t % 3) * tileU;
    // into the buffers step t - 1 read: all its reads are behind a barrier
    if (t + 2 < d.L) prefetch(t + 2, idle);
    cp_async_commit();
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[3][RPT];
      gate_sums<3, RPT>(hc, sH, H, w, ul, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < g.nr) {
          const float* gr = git + r * 3 * sU + ul;
          const float* bs = bias + ul;
          const float rg = sigmoid(gr[0] + acc[0][q] + bs[0]);
          const float zg = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
          const float ng =
              tanhf(gr[2 * sU] + rg * (acc[2][q] + bs[2 * sU]));
          const int u = g.u0 + ul;
          float h = (1.f - zg) * ng + zg * hc[r * sH + u];
          hs[t * BH + (size_t)(g.row0 + r) * H + u] = h;
          if (hdec && t + 1 < d.L) h *= dec[r * sU + ul];  // next step's
          if (cs == 1)
            hn[r * sH + u] = h;
          else
            for (int peer = 0; peer < cs; ++peer)
              cluster.map_shared_rank(hn, peer)[r * sH + u] = h;
        }
      }
    }
    cp_async_wait<1>();  // step t + 1's rows are in
    cluster_or_block_sync(cluster, cs);
  }
}

template <int RPT, int WS>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
               const float* __restrict__ h0, const float* __restrict__ hs,
               const float* __restrict__ ghs, const float* __restrict__ whh,
               const float* __restrict__ bhh, const float* __restrict__ hdec,
               float* __restrict__ dgi, float* __restrict__ dgh,
               float* __restrict__ dh0, float* __restrict__ dhdec) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Geom g = geom_of(d, cs, R, (int)cluster.block_rank());
  const int H = d.H, GH = 3 * H, sH = g.s.sH, sU = g.s.sU, tid = threadIdx.x;
  const int tileH = R * sH, tileU = R * sU, sD = 3 * sU;
  const size_t BH = (size_t)d.B * H;
  float* hprev = smem;              // h before the step [R][sH], every unit
  float* decb = hprev + tileH;      // the step's decay [R][sH], every unit
  float* gbuf = decb + tileH;       // the step's gi, own columns [R][3 sU]
  float* gsel = gbuf + 3 * tileU;   // the step's ghs, own units [R][sU]
  float* gh = gsel + tileU;         // cotangent of the step's output h from
                                    // the later steps, own units (cs > 1)
  float* dzh = gh + tileU;          // its direct share in the input's, gbar z
  float* hown = dzh + tileU;        // h before the step, own units
  float* down = hown + tileU;       // the step's decay, own units
  float* dg = down + tileU;         // [dr, dz, dn r], own columns [R][3 sU]
  float* pdh = dg + 3 * tileU;      // the CTA's partial dh [2][R][sH]
  float* bias = pdh + 2 * tileH;    // [3 sU]
  float* rest = bias + 3 * sU;
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<3, WS>(rest, whh, H, g);
  for (int i = tid; i < 3 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // what step t reads: its gi and ghs rows, h before it (h0 before the
  // first) and its decay, issued from thread `first` on
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) && aligned16(h0) &&
                  aligned16(hs) && aligned16(ghs) &&
                  (!hdec || aligned16(hdec));
  auto prefetch = [&](int t, int first) {
    const size_t row = (size_t)t * d.B + g.row0;
    copy_rows_async(gbuf, sD, sU, gi + row * GH + g.u0, GH, H, g.nr, 3, g.nu,
                    v4, first);
    copy_rows_async(gsel, sU, 0, ghs + row * H + g.u0, H, 0, g.nr, 1, g.nu,
                    v4, first);
    copy_rows_async(
        hprev, sH, 0, t > 0 ? hs + (row - d.B) * H : h0 + (size_t)g.row0 * H,
        H, 0, g.nr, 1, H, v4, first);
    if (hdec)
      copy_rows_async(decb, sH, 0, hdec + row * H, H, 0, g.nr, 1, H, v4,
                      first);
  };
  prefetch(d.L - 1, 0);
  cp_async_wait_all();
  cluster.sync();
  // the step's items; the copies go to the threads after the back product's
  const int items = g.nu * (R / RPT), back_items = H * (R / RPT);
  const int idle = back_items % THREADS;
  for (int t = d.L - 1; t >= 0; --t) {
    // recompute the own units' gates from the cell's input (h before the
    // step, times its decay); their cotangents
    const size_t ob = ((size_t)t * d.B + g.row0) * GH + g.u0;
    const float* pdl = pdh + ((t + 1) & 1) * tileH;  // the step after's
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[3][RPT];
      if (hdec)
        gate_sums<3, RPT, true>(hprev, sH, H, w, ul, r0, acc, decb);
      else
        gate_sums<3, RPT>(hprev, sH, H, w, ul, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < g.nr) {
          const float* gr = gbuf + r * sD + ul;
          const float* bs = bias + ul;
          const float rg = sigmoid(gr[0] + acc[0][q] + bs[0]);
          const float zg = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
          const float ghn = acc[2][q] + bs[2 * sU];
          const float ng = tanhf(gr[2 * sU] + rg * ghn);
          const int e = r * sU + ul, u = g.u0 + ul;
          const size_t o = (size_t)(g.row0 + r) * H + u;
          // the cotangent of the step's output h: ghs, and the step
          // after's cotangent of its input state through its decay (a
          // cluster of one forms that here from its own partial; the same
          // thread wrote the step after's dzh, hown and down)
          float gb = gsel[e];
          if (cs == 1) {
            if (t + 1 < d.L) {
              float dx = dzh[e] + pdl[r * sH + u];
              if (hdec) {
                dhdec[(t + 1) * BH + o] = dx * hown[e];
                dx *= down[e];
              }
              gb += dx;
            }
          } else {
            gb += gh[e];
          }
          const float dn = gb * (1.f - zg) * (1.f - ng * ng);
          const float dr = dn * ghn * rg * (1.f - rg);
          const float hp = hprev[r * sH + u];
          const float hin = hdec ? hp * decb[r * sH + u] : hp;
          const float dz = gb * (hin - ng) * zg * (1.f - zg);
          float* dgs = dg + r * sD + ul;
          dgs[0] = dr;
          dgs[sU] = dz;
          dgs[2 * sU] = dn * rg;
          float* dgr = dgi + ob + (size_t)r * GH + ul;
          dgr[0] = dr;
          dgr[H] = dz;
          dgr[2 * H] = dn;
          float* dwr = dgh + ob + (size_t)r * GH + ul;
          dwr[0] = dr;
          dwr[H] = dz;
          dwr[2 * H] = dn * rg;
          dzh[e] = gb * zg;
          if (hdec) {
            hown[e] = hp;
            down[e] = decb[r * sH + u];
          }
        }
      }
    }
    __syncthreads();  // dg complete; this step's prefetched rows are read
    if (t > 0) prefetch(t - 1, idle);
    // back through the own columns of W_hh: the partial dh of every unit
    float* pd = pdh + (t & 1) * tileH;
    for (int item = tid; item < back_items; item += THREADS) {
      const int k = item % H, r0 = (item / H) * RPT;
      float acc[RPT];
      back_sums<3, RPT>(dg, sU, g.nu, w, k, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        if (r0 + q < g.nr) pd[(r0 + q) * sH + k] = acc[q];
    }
    if (cs == 1) {
      cp_async_wait_all();
      __syncthreads();
      if (t > 0) continue;
      // the first step's cotangent of its input state, to h0
      for (int i = tid; i < g.nr * H; i += THREADS) {
        const int r = i / H, u = i - r * H, e = r * sU + u;
        const size_t o = (size_t)(g.row0 + r) * H + u;
        float dx = dzh[e] + pd[r * sH + u];
        if (hdec) {
          dhdec[o] = dx * hown[e];
          dx *= down[e];
        }
        dh0[o] = dx;
      }
      break;
    }
    cluster.sync();
    // the own units' cotangent of the step's input state: the direct
    // share, then the cluster's partials in rank order; through the decay
    // to the state before the step
    for (int i = tid; i < g.nr * g.nu; i += THREADS) {
      const int r = i / g.nu, ul = i - r * g.nu, e = r * sU + ul;
      const int u = g.u0 + ul, p = r * sH + u;
      float s = cluster.map_shared_rank(pd, 0)[p];
      for (int peer = 1; peer < cs; ++peer)
        s += cluster.map_shared_rank(pd, peer)[p];
      float dx = dzh[e] + s;
      const size_t o = (size_t)(g.row0 + r) * H + u;
      if (hdec) {
        dhdec[t * BH + o] = dx * hown[e];
        dx *= down[e];
      }
      if (t > 0)
        gh[e] = dx;
      else
        dh0[o] = dx;
    }
    cp_async_wait_all();
    __syncthreads();
  }
  // no CTA leaves while a peer may still read its partials
  cluster_or_block_sync(cluster, cs);
}

// ---------------------------------------------------------------------------
// LSTM (from zero h and c)
// ---------------------------------------------------------------------------

template <int RPT, int WS>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
                const float* __restrict__ whh, const float* __restrict__ bhh,
                float* __restrict__ hs, float* __restrict__ cs_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Geom g = geom_of(d, cs, R, (int)cluster.block_rank());
  const int H = d.H, GH = 4 * H, sH = g.s.sH, sU = g.s.sU, tid = threadIdx.x;
  const int tileH = R * sH, tileG = 4 * R * sU;
  const size_t BH = (size_t)d.B * H;
  float* hbuf = smem;              // h [2][R][sH], every unit of the cluster
  float* gbuf = hbuf + 2 * tileH;  // gi, own columns [3][R][4 sU]
  float* cst = gbuf + 3 * tileG;   // c, own units [R][sU]
  float* bias = cst + R * sU;      // [4 sU]
  float* rest = bias + 4 * sU;
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<4, WS>(rest, whh, H, g);
  for (int i = tid; i < 4 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi);
  auto prefetch_gi = [&](int t, float* dst, int first) {
    copy_rows_async(dst, 4 * sU, sU,
                    gi + ((size_t)t * d.B + g.row0) * GH + g.u0, GH, H, g.nr,
                    4, g.nu, v4, first);
  };
  // one copy group a step, empty or not, two steps in flight
  prefetch_gi(0, gbuf, 0);
  cp_async_commit();
  if (d.L > 1) prefetch_gi(1, gbuf + tileG, 0);
  cp_async_commit();
  cp_async_wait<1>();
  cluster.sync();  // every CTA's h is zeroed before a peer writes into it
  // the step's items; its copies go to the threads after them
  const int items = g.nu * (R / RPT), idle = items % THREADS;
  for (int t = 0; t < d.L; ++t) {
    const int cur = t & 1;
    const float* hc = hbuf + cur * tileH;
    float* hn = hbuf + (cur ^ 1) * tileH;
    const float* git = gbuf + (t % 3) * tileG;
    // into the buffer step t - 1 read: all its reads are behind a barrier
    if (t + 2 < d.L) prefetch_gi(t + 2, gbuf + ((t + 2) % 3) * tileG, idle);
    cp_async_commit();
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[4][RPT];
      gate_sums<4, RPT>(hc, sH, H, w, ul, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < g.nr) {
          const float* gr = git + r * 4 * sU + ul;
          const float* bs = bias + ul;
          const float ig = sigmoid(gr[0] + acc[0][q] + bs[0]);
          const float fg = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
          const float gg = tanhf(gr[2 * sU] + acc[2][q] + bs[2 * sU]);
          const float og = sigmoid(gr[3 * sU] + acc[3][q] + bs[3 * sU]);
          const int e = r * sU + ul, u = g.u0 + ul;
          const float c = fg * cst[e] + ig * gg;
          const float h = og * tanhf(c);
          cst[e] = c;
          if (cs == 1)
            hn[r * sH + u] = h;
          else
            for (int peer = 0; peer < cs; ++peer)
              cluster.map_shared_rank(hn, peer)[r * sH + u] = h;
          const size_t o = t * BH + (size_t)(g.row0 + r) * H + u;
          hs[o] = h;
          if (cs_out) cs_out[o] = c;  // only when a backward will need it
        }
      }
    }
    cp_async_wait<1>();  // step t + 1's rows are in
    cluster_or_block_sync(cluster, cs);
  }
}

template <int RPT, int WS>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
                const float* __restrict__ hs, const float* __restrict__ cs_in,
                const float* __restrict__ ghs, const float* __restrict__ whh,
                const float* __restrict__ bhh, float* __restrict__ dgi) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const Geom g = geom_of(d, cs, R, (int)cluster.block_rank());
  const int H = d.H, GH = 4 * H, sH = g.s.sH, sU = g.s.sU, tid = threadIdx.x;
  const int tileH = R * sH, tileU = R * sU, sD = 4 * sU;
  float* hprev = smem;              // h before the step [R][sH], every unit
  float* gbuf = hprev + tileH;      // the step's gi, own columns [R][4 sU]
  float* cprev = gbuf + 4 * tileU;  // c before the step, own units [R][sU]
  float* gsel = cprev + tileU;      // the step's ghs, own units
  float* gh = gsel + tileU;         // cotangent of the step's output h from
                                    // the later steps, own units (cs > 1)
  float* gc = gh + tileU;           // of its output c (owned like c)
  float* dg = gc + tileU;           // gate cotangents, own columns
  float* pdh = dg + 4 * tileU;      // the CTA's partial dh [2][R][sH]
  float* bias = pdh + 2 * tileH;    // [4 sU]
  float* rest = bias + 4 * sU;
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<4, WS>(rest, whh, H, g);
  for (int i = tid; i < 4 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // what step t reads: its gi and ghs rows, and (h, c) before it (zero
  // before the first step)
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) && aligned16(hs) &&
                  aligned16(cs_in) && aligned16(ghs);
  auto prefetch = [&](int t, int first) {
    const size_t row = (size_t)t * d.B + g.row0;
    copy_rows_async(gbuf, sD, sU, gi + row * GH + g.u0, GH, H, g.nr, 4, g.nu,
                    v4, first);
    copy_rows_async(gsel, sU, 0, ghs + row * H + g.u0, H, 0, g.nr, 1, g.nu,
                    v4, first);
    if (t > 0) {
      copy_rows_async(hprev, sH, 0, hs + (row - d.B) * H, H, 0, g.nr, 1, H,
                      v4, first);
      copy_rows_async(cprev, sU, 0, cs_in + (row - d.B) * H + g.u0, H, 0,
                      g.nr, 1, g.nu, v4, first);
    } else {
      for (int i = tid; i < g.nr * sH; i += THREADS) hprev[i] = 0.f;
      for (int i = tid; i < g.nr * sU; i += THREADS) cprev[i] = 0.f;
    }
  };
  prefetch(d.L - 1, 0);
  cp_async_wait_all();
  cluster.sync();
  // the step's items; the copies go to the threads after the back product's
  const int items = g.nu * (R / RPT), back_items = H * (R / RPT);
  const int idle = back_items % THREADS;
  for (int t = d.L - 1; t >= 0; --t) {
    // recompute the own units' gates from (h, c) before the step; their
    // cotangents
    const size_t ob = ((size_t)t * d.B + g.row0) * GH + g.u0;
    const float* pdl = pdh + ((t + 1) & 1) * tileH;  // zero at the last step
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[4][RPT];
      gate_sums<4, RPT>(hprev, sH, H, w, ul, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < g.nr) {
          const float* gr = gbuf + r * sD + ul;
          const float* bs = bias + ul;
          const float ig = sigmoid(gr[0] + acc[0][q] + bs[0]);
          const float fg = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
          const float gg = tanhf(gr[2 * sU] + acc[2][q] + bs[2 * sU]);
          const float og = sigmoid(gr[3 * sU] + acc[3][q] + bs[3 * sU]);
          const int e = r * sU + ul;
          const float c = cprev[e];
          const float tc = tanhf(fg * c + ig * gg);
          // a cluster of one reads its partial dh of the step after as it is
          const float ghv =
              (cs == 1 ? pdl[r * sH + ul] : gh[e]) + gsel[e];
          const float dc = gc[e] + ghv * og * (1.f - tc * tc);
          const float di = dc * gg * ig * (1.f - ig);
          const float df = dc * c * fg * (1.f - fg);
          const float dgg = dc * ig * (1.f - gg * gg);
          const float dov = ghv * tc * og * (1.f - og);
          gc[e] = dc * fg;
          float* dgs = dg + r * sD + ul;
          dgs[0] = di;
          dgs[sU] = df;
          dgs[2 * sU] = dgg;
          dgs[3 * sU] = dov;
          float* dgr = dgi + ob + (size_t)r * GH + ul;
          dgr[0] = di;
          dgr[H] = df;
          dgr[2 * H] = dgg;
          dgr[3 * H] = dov;
        }
      }
    }
    if (t == 0) break;
    __syncthreads();  // dg complete; this step's prefetched rows are read
    prefetch(t - 1, idle);
    // back through the own columns of W_hh: the partial dh of every unit
    float* pd = pdh + (t & 1) * tileH;
    for (int item = tid; item < back_items; item += THREADS) {
      const int k = item % H, r0 = (item / H) * RPT;
      float acc[RPT];
      back_sums<4, RPT>(dg, sU, g.nu, w, k, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        if (r0 + q < g.nr) pd[(r0 + q) * sH + k] = acc[q];
    }
    if (cs == 1) {
      cp_async_wait_all();
      __syncthreads();
      continue;
    }
    cluster.sync();
    // the own units' dh: the cluster's partials in rank order
    for (int i = tid; i < g.nr * g.nu; i += THREADS) {
      const int r = i / g.nu, ul = i - r * g.nu, o = r * sH + g.u0 + ul;
      float s = cluster.map_shared_rank(pd, 0)[o];
      for (int peer = 1; peer < cs; ++peer)
        s += cluster.map_shared_rank(pd, peer)[o];
      gh[r * sU + ul] = s;
    }
    cp_async_wait_all();
    __syncthreads();
  }
  // no CTA leaves while a peer may still read its partials
  cluster_or_block_sync(cluster, cs);
}

// The weight-gradient product of both pairs: tiles of BM x WG_BN outputs
// (BM = 128 rows of dW_hh where H fills them, else 64), K in steps of
// WG_BK staged in shared memory (double-buffered with cp.async), BM / 16 x
// 4 outputs a thread in registers: per step of K a thread loads BM / 64 +
// 1 float4s from shared memory for 4 BM / 16 FMAs.
constexpr int WG_BN = 64, WG_BK = 16;
// the least K a split takes: 8 steps of WG_BK (at the sweep's L B = 3840,
// 30 splits; 7 splits of 32 steps were slower on the card)
constexpr int WG_MIN_K = 8 * WG_BK;

inline int wgrad_rows(int H) { return H > 64 ? 128 : 64; }

// Splits of K = L B: enough that the output tiles make about two CTAs an
// SM, each split at least WG_MIN_K rows of K.
inline int wgrad_splits(int L, int B, int H, int G) {
  const long long K = (long long)L * B, bm = wgrad_rows(H);
  const long long tiles =
      ((H + bm - 1) / bm) * ((G * H + WG_BN - 1) / WG_BN);
  long long s = (2LL * sm_count() + tiles - 1) / tiles;
  s = std::min(s, K / WG_MIN_K);
  return (int)std::max(s, 1LL);
}

// Split z's partials p[z] [H + 1][N], N = G H: row k < H holds the sum over
// its n of x[n][k] dg[n][c], row H the sum over its n of dg[n][c]; n < K =
// L B runs over (step, row). x[n] is the cell's input state of the step:
// hs[n - B] for n >= B, h0[n] (zero without h0) for n < B, times hdec[n]
// with DEC.
template <int BM, bool DEC>
__global__ void __launch_bounds__(THREADS)
rnn_wgrad_kernel(int K, int B, int H, int G, int kper,
                 const float* __restrict__ h0, const float* __restrict__ hs,
                 const float* __restrict__ hdec, const float* __restrict__ dg,
                 float* __restrict__ p) {
  constexpr int TM = BM / 16;  // rows of the thread's outputs
  __shared__ __align__(16) float xs[2][WG_BK][BM];
  __shared__ __align__(16) float ds[DEC ? 2 : 1][DEC ? WG_BK : 1][BM];
  __shared__ __align__(16) float ys[2][WG_BK][WG_BN];
  const int N = G * H, tid = threadIdx.x, tc = tid % 16, tm = tid / 16;
  const int c0 = blockIdx.x * WG_BN, m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * kper, n1 = min(K, n0 + kper);
  const bool xvec = (H & 3) == 0 && aligned16(hs) && (!h0 || aligned16(h0)) &&
                    (!hdec || aligned16(hdec));
  const bool yvec = (N & 3) == 0 && aligned16(dg);
  auto load = [&](int buf, int nb) {
    for (int q = tid; q < WG_BK * BM / 4; q += THREADS) {
      const int lr = q / (BM / 4), lc = (q % (BM / 4)) * 4;
      const int n = nb + lr, m = m0 + lc;
      const float* x = nullptr;
      if (n < n1)
        x = n >= B ? hs + (size_t)(n - B) * H + m
                   : (h0 ? h0 + (size_t)n * H + m : nullptr);
      const float* dc = DEC && n < n1 ? hdec + (size_t)n * H + m : nullptr;
      if (xvec) {
        const bool ok = x && m < H;
        cp_async16(&xs[buf][lr][lc], ok ? x : hs, ok ? 16 : 0);
        if (DEC) {
          const bool okd = dc && m < H;
          cp_async16(&ds[buf][lr][lc], okd ? dc : hdec, okd ? 16 : 0);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = x && m + j < H;
          cp_async4(&xs[buf][lr][lc + j], ok ? x + j : hs, ok ? 4 : 0);
          if (DEC) {
            const bool okd = dc && m + j < H;
            cp_async4(&ds[buf][lr][lc + j], okd ? dc + j : hdec,
                      okd ? 4 : 0);
          }
        }
      }
    }
    const int lr = tid / 16, lc = (tid % 16) * 4, n = nb + lr, c = c0 + lc;
    const float* y = dg + (size_t)n * N + c;
    if (yvec) {
      const bool ok = n < n1 && c < N;
      cp_async16(&ys[buf][lr][lc], ok ? y : dg, ok ? 16 : 0);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = n < n1 && c + j < N;
        cp_async4(&ys[buf][lr][lc + j], ok ? y + j : dg, ok ? 4 : 0);
      }
    }
  };
  float acc[TM][4], bsum[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    bsum[j] = 0.f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = 0.f;
  }
  const bool own_b = blockIdx.y == 0 && tm == 0;
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
    const int b = kt & 1;
    if (DEC) {  // the cell's input state: h times the step's decay
      for (int i = tid; i < WG_BK * BM; i += THREADS)
        (&xs[b][0][0])[i] *= (&ds[b][0][0])[i];
      __syncthreads();
    }
#pragma unroll
    for (int kk = 0; kk < WG_BK; ++kk) {
      float av[TM];
#pragma unroll
      for (int i = 0; i < TM; i += 4) {
        const float4 a =
            *reinterpret_cast<const float4*>(&xs[b][kk][tm * TM + i]);
        av[i] = a.x;
        av[i + 1] = a.y;
        av[i + 2] = a.z;
        av[i + 3] = a.w;
      }
      const float4 y = *reinterpret_cast<const float4*>(&ys[b][kk][tc * 4]);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i], lane(y, j), acc[i][j]);
      if (own_b)
#pragma unroll
        for (int j = 0; j < 4; ++j) bsum[j] += lane(y, j);
    }
    __syncthreads();
  }
  float* pz = p + (size_t)blockIdx.z * (H + 1) * N;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (m < H && c < N) pz[(size_t)m * N + c] = acc[i][j];
    }
  }
  if (own_b)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (c < N) pz[(size_t)H * N + c] = bsum[j];
    }
}

int rnn_wgrad(const float* h0, const float* hs, const float* hdec,
              const float* dg, float* p, int L, int B, int H, int G,
              cudaStream_t s) {
  if (L <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int K = L * B, S = wgrad_splits(L, B, H, G);
  const int kper = ((K + S - 1) / S + WG_BK - 1) / WG_BK * WG_BK;
  const int bm = wgrad_rows(H);
  const dim3 grid((G * H + WG_BN - 1) / WG_BN, (H + bm - 1) / bm, S);
  auto k = bm == 128 ? (hdec ? rnn_wgrad_kernel<128, true>
                             : rnn_wgrad_kernel<128, false>)
                      : (hdec ? rnn_wgrad_kernel<64, true>
                              : rnn_wgrad_kernel<64, false>);
  k<<<grid, THREADS, 0, s>>>(K, B, H, G, kper, h0, hs, hdec, dg, p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launches: one instantiation per rows-per-thread and slice placement
// ---------------------------------------------------------------------------

struct GruFwdArgs {
  RnnDims d;
  const float *gi, *h0, *whh, *bhh, *hdec;
  float* hs;
};

struct GruBwdArgs {
  RnnDims d;
  const float *gi, *h0, *hs, *ghs, *whh, *bhh, *hdec;
  float *dgi, *dgh, *dh0, *dhdec;
};

struct LstmFwdArgs {
  RnnDims d;
  const float *gi, *whh, *bhh;
  float *hs, *cs;
};

struct LstmBwdArgs {
  RnnDims d;
  const float *gi, *hs, *cs, *ghs, *whh, *bhh;
  float* dgi;
};

// Launch kernel k over clusters of p.cs CTAs, or, without `run`, only
// check the plan: its shared memory is set first, then
// cudaOccupancyMaxActiveClusters must find room for at least one cluster
// (its count in *active when given). An unschedulable plan returns an
// error: there is no quiet fallback to another route.
template <class... Exp, class... Act>
int launch_clusters(void (*k)(Exp...), const RnnPlan& p, int B,
                    cudaStream_t s, int* active, bool run, Act... args) {
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(((B + p.rows - 1) / p.rows) * p.cs));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = p.bytes;
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
  static std::map<std::tuple<int, const void*, size_t, int>, int> seen;
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

template <int RPT, int WS>
struct GruFwd {
  static int run(const GruFwdArgs& a, const RnnPlan& p, cudaStream_t s,
                 int* active, bool go) {
    return launch_clusters(gru_fwd_kernel<RPT, WS>, p, a.d.B, s, active, go,
                           a.d, p.cs, p.rows, a.gi, a.h0, a.whh, a.bhh,
                           a.hdec, a.hs);
  }
};

template <int RPT, int WS>
struct GruBwd {
  static int run(const GruBwdArgs& a, const RnnPlan& p, cudaStream_t s,
                 int* active, bool go) {
    return launch_clusters(gru_bwd_kernel<RPT, WS>, p, a.d.B, s, active, go,
                           a.d, p.cs, p.rows, a.gi, a.h0, a.hs, a.ghs, a.whh,
                           a.bhh, a.hdec, a.dgi, a.dgh, a.dh0, a.dhdec);
  }
};

template <int RPT, int WS>
struct LstmFwd {
  static int run(const LstmFwdArgs& a, const RnnPlan& p, cudaStream_t s,
                 int* active, bool go) {
    return launch_clusters(lstm_fwd_kernel<RPT, WS>, p, a.d.B, s, active, go,
                           a.d, p.cs, p.rows, a.gi, a.whh, a.bhh, a.hs, a.cs);
  }
};

template <int RPT, int WS>
struct LstmBwd {
  static int run(const LstmBwdArgs& a, const RnnPlan& p, cudaStream_t s,
                 int* active, bool go) {
    return launch_clusters(lstm_bwd_kernel<RPT, WS>, p, a.d.B, s, active, go,
                           a.d, p.cs, p.rows, a.gi, a.hs, a.cs, a.ghs, a.whh,
                           a.bhh, a.dgi);
  }
};

// The plan of one launch of G gates, then its kernel instance (rows per
// thread, and the slices in shared or device memory).
template <template <int, int> class Fn, class Args>
int rnn_launch(const Args& a, int G, int backward, cudaStream_t s,
               int* active, bool go) {
  if (a.d.L <= 0 || a.d.B <= 0 || a.d.H <= 0) return (int)cudaErrorInvalidValue;
  const RnnPlan p = rnn_plan(G, a.d.H, a.d.B, backward);
  if (p.bytes == 0) return (int)cudaErrorInvalidValue;
  switch (p.rpt * 2 + p.w_smem) {
    case 2: return Fn<1, 0>::run(a, p, s, active, go);
    case 3: return Fn<1, 1>::run(a, p, s, active, go);
    case 4: return Fn<2, 0>::run(a, p, s, active, go);
    case 5: return Fn<2, 1>::run(a, p, s, active, go);
    case 8: return Fn<4, 0>::run(a, p, s, active, go);
    case 9: return Fn<4, 1>::run(a, p, s, active, go);
    case 16: return Fn<8, 0>::run(a, p, s, active, go);
    case 17: return Fn<8, 1>::run(a, p, s, active, go);
  }
  return (int)cudaErrorInvalidValue;
}

// One field of the plan of a launch with G gates at (H, B): 0 CTAs per
// cluster, 1 batch rows per cluster, 2 the slices in shared memory (1) or
// device memory (0), 3 rows per thread, 4 cudaOccupancyMaxActiveClusters
// (minus the CUDA error when the plan cannot be scheduled), 5 dynamic
// shared bytes per CTA. Fwd and Bwd: the launch's forward and backward.
template <template <int, int> class Fwd, template <int, int> class Bwd,
          class FwdArgs, class BwdArgs>
int plan_field(int G, int H, int B, int backward, int field) {
  const RnnPlan p = rnn_plan(G, H, B, backward);
  switch (field) {
    case 0: return p.cs;
    case 1: return p.rows;
    case 2: return p.w_smem;
    case 3: return p.rpt;
    case 5: return (int)p.bytes;
  }
  int active = 0, err;
  if (backward) {
    BwdArgs a = {};
    a.d = RnnDims{1, B, H};
    err = rnn_launch<Bwd>(a, G, 1, 0, &active, false);
  } else {
    FwdArgs a = {};
    a.d = RnnDims{1, B, H};
    err = rnn_launch<Fwd>(a, G, 0, 0, &active, false);
  }
  return err ? -err : active;
}

}  // namespace

extern "C" {

int fused_gru_max_smem() { return max_optin_smem(); }
int fused_lstm_max_smem() { return max_optin_smem(); }

const char* fused_gru_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of one CTA of a launch, in bytes: the plan never
// exceeds the device's limit (the slices move to device memory instead).
long long fused_gru_smem_bytes(int H, int B, int backward) {
  return (long long)rnn_plan(3, H, B, backward).bytes;
}
long long fused_lstm_smem_bytes(int H, int B, int backward) {
  return (long long)rnn_plan(4, H, B, backward).bytes;
}

// One field of the plan at (H, B) (plan_field)
int fused_gru_plan(int H, int B, int backward, int field) {
  return plan_field<GruFwd, GruBwd, GruFwdArgs, GruBwdArgs>(3, H, B,
                                                           backward, field);
}
int fused_lstm_plan(int H, int B, int backward, int field) {
  return plan_field<LstmFwd, LstmBwd, LstmFwdArgs, LstmBwdArgs>(
      4, H, B, backward, field);
}

// Splits of the weight-gradient product, the leading dimension of its
// partials [splits][H + 1][G H] (dW_hh's rows, then db_hh).
int fused_gru_wgrad_splits(int L, int B, int H) {
  return wgrad_splits(L, B, H, 3);
}
int fused_lstm_wgrad_splits(int L, int B, int H) {
  return wgrad_splits(L, B, H, 4);
}

// hdec may be null (no decay)
int fused_gru_fwd(const float* gi, const float* h0, const float* whh,
                  const float* bhh, const float* hdec, float* hs, int L,
                  int B, int H, void* stream) {
  const GruFwdArgs a{RnnDims{L, B, H}, gi, h0, whh, bhh, hdec, hs};
  return rnn_launch<GruFwd>(a, 3, 0, (cudaStream_t)stream, nullptr, true);
}

// The reverse recurrence: dgi, W_hh's cotangent dgh, dh0 and, with hdec,
// dhdec (the weight gradient is fused_gru_wgrad). hdec and dhdec are null
// together (no decay).
int fused_gru_bwd(const float* gi, const float* h0, const float* hs,
                  const float* ghs, const float* whh, const float* bhh,
                  const float* hdec, float* dgi, float* dgh, float* dh0,
                  float* dhdec, int L, int B, int H, void* stream) {
  const GruBwdArgs a{RnnDims{L, B, H}, gi, h0, hs, ghs, whh, bhh, hdec,
                     dgi, dgh, dh0, dhdec};
  return rnn_launch<GruBwd>(a, 3, 1, (cudaStream_t)stream, nullptr, true);
}

// Partials of (dW_hh, db_hh) [splits][H + 1][3H] from the cell's input
// states (h0, hs, hdec: null for no decay) and dgh
int fused_gru_wgrad(const float* h0, const float* hs, const float* hdec,
                    const float* dgh, float* p, int L, int B, int H,
                    void* stream) {
  return rnn_wgrad(h0, hs, hdec, dgh, p, L, B, H, 3, (cudaStream_t)stream);
}

// cs may be null: the inference-only primal writes no cell-state stream
int fused_lstm_fwd(const float* gi, const float* whh, const float* bhh,
                   float* hs, float* cs, int L, int B, int H, void* stream) {
  const LstmFwdArgs a{RnnDims{L, B, H}, gi, whh, bhh, hs, cs};
  return rnn_launch<LstmFwd>(a, 4, 0, (cudaStream_t)stream, nullptr, true);
}

// The reverse recurrence: dgi only (the weight gradient is fused_lstm_wgrad)
int fused_lstm_bwd(const float* gi, const float* hs, const float* cs,
                   const float* ghs, const float* whh, const float* bhh,
                   float* dgi, int L, int B, int H, void* stream) {
  const LstmBwdArgs a{RnnDims{L, B, H}, gi, hs, cs, ghs, whh, bhh, dgi};
  return rnn_launch<LstmBwd>(a, 4, 1, (cudaStream_t)stream, nullptr, true);
}

// Partials of (dW_hh, db_hh) [splits][H + 1][4H] from hs and dgi (the
// state before the first step is zero)
int fused_lstm_wgrad(const float* hs, const float* dgi, float* p, int L,
                     int B, int H, void* stream) {
  return rnn_wgrad(nullptr, hs, nullptr, dgi, p, L, B, H, 4,
                   (cudaStream_t)stream);
}

}  // extern "C"
