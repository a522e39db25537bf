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
// The LSTM pair has its own design, described above its kernels below: W_hh
// split over a thread-block cluster's shared memory, and the weight
// gradient moved out of the recurrence into a kernel of its own. What
// follows is the GRU pair's.
//
// Design: one thread block per tile of ROWS batch rows runs the whole
// recurrence (CUDA blocks run in no order, unlike the TPU grid). Each step
// is a [ROWS, H] x [H, G*H] product and the gate math; a thread owns unit j
// for RPT rows of the tile and keeps its G*RPT sums in registers, so a
// weight is read once per step and thread group; the backward's W^T
// product mirrors it (a thread owns row k of W_hh for RPT rows of the
// tile). W_hh stays in shared
// memory when it fits (up to H = 128 at 227 KB a block) and is read from
// device memory (L2-resident: at most 3 MB) otherwise. The backward recomputes the gates from the saved hidden (and
// cell) trajectory, step by step in reverse; it writes dgi, and the weight
// gradients as per-block partials that the wrapper sums in a fixed order.
// Each partial entry is owned by one thread for the whole loop (no
// atomics: runs are bit-reproducible); it stays in shared memory when it
// fits beside W_hh, else in the block's slice of the partial in device
// memory, read and written only by its owner. So every H <= 512 runs.
// Plain fp32 FMA on the CUDA cores (TF32 off).
//
// What bounds it on the H100: at the bench shapes (B = 1024, L = 72) the
// work is small. At H = 32 the GRU forward moves 38 MB (gi in, hs out) and
// does 0.45 GFLOP: ~11 us, bytes; at H = 128 it does 7.2 GFLOP: ~108 us,
// operations. Beyond the bound, each step's product and gate math sit on a
// chain of L dependent steps with a block barrier between them, and the
// sweep's shape (B = 64: 8 blocks on 132 SMs, H = 16) is bound by that
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

// W_hh [H][G*H] as the kernels read it: in shared memory (row stride odd,
// so the W^T product of the backward, threads on consecutive rows k, is
// free of bank conflicts) or in device memory (row stride G*H)
struct WView {
  const float* p;
  int ld;
};

__device__ __forceinline__ WView load_whh(float* s, int w_smem,
                                          const float* __restrict__ whh,
                                          int G, int H) {
  const int GH = G * H;
  if (!w_smem) return WView{whh, GH};
  const int ld = odd(GH);
  for (int i = threadIdx.x; i < H * GH; i += THREADS)
    s[(size_t)(i / GH) * ld + i % GH] = whh[i];
  return WView{s, ld};
}

__device__ __forceinline__ void zero_smem(float* s, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += THREADS) s[i] = 0.f;
}

// acc[g][q] = sum_k h[(r0 + q) * sH + k] W[k][g*H + j]: gate g of unit j
// for the RPT rows r0.. of the tile h [ROWS][sH]
template <int G, int RPT>
__device__ __forceinline__ void gate_sums(const float* h, int sH,
                                          const WView w, int H, int j,
                                          int r0, float (&acc)[G][RPT]) {
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[g][q] = 0.f;
  for (int k = 0; k < H; ++k) {
    const float* wk = w.p + (size_t)k * w.ld + j;
    float wv[G];
#pragma unroll
    for (int g = 0; g < G; ++g) wv[g] = wk[g * H];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const float x = h[(r0 + q) * sH + k];
#pragma unroll
      for (int g = 0; g < G; ++g) acc[g][q] = fmaf(x, wv[g], acc[g][q]);
    }
  }
}

// acc[q] = sum_c dg[(r0 + q) * sG + c] W[k][c], c < G*H: the W^T product
// of the backward for unit k and the RPT rows r0.. (a row of W per thread,
// read once per step and thread group, as gate_sums reads a column)
template <int RPT>
__device__ __forceinline__ void back_sums(const float* dg, int sG,
                                          const WView w, int GH, int k,
                                          int r0, float (&acc)[RPT]) {
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
  const float* wk = w.p + (size_t)k * w.ld;
#pragma unroll 4
  for (int c = 0; c < GH; ++c) {
    const float wv = wk[c];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
      acc[q] = fmaf(dg[(r0 + q) * sG + c], wv, acc[q]);
  }
}

// dW[k][c] += sum_r h[r][k] dg[r][c] over the tile's nr rows (entry e owned
// by thread e % THREADS for the whole loop) and db[c] += sum_r dg[r][c].
// When dW is the block's partial in device memory (dw_smem 0), each thread
// first loads the NB entries it owns next, so their latencies overlap.
__device__ __forceinline__ void weight_grads(const float* h, int sH,
                                             const float* dg, int sG, int GH,
                                             int H, float* dw, int dw_smem,
                                             float* db, int nr) {
  constexpr int NB = 8;
  const int n = H * GH;
  auto entry = [&](int e, float acc) {
    const int k = e / GH, c = e % GH;
    for (int r = 0; r < nr; ++r) acc = fmaf(h[r * sH + k], dg[r * sG + c], acc);
    return acc;
  };
  if (dw_smem) {
    for (int e = threadIdx.x; e < n; e += THREADS) dw[e] = entry(e, dw[e]);
  } else {
    for (int e0 = threadIdx.x; e0 < n; e0 += NB * THREADS) {
      float old[NB];
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int e = e0 + u * THREADS;
        old[u] = e < n ? dw[e] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < NB; ++u) {
        const int e = e0 + u * THREADS;
        if (e < n) dw[e] = entry(e, old[u]);
      }
    }
  }
  for (int c = threadIdx.x; c < GH; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += dg[r * sG + c];
    db[c] += s;
  }
}

// Shared memory of each kernel, in floats: the ROWS-row tiles of width H
// (stride odd(H)), the bias (and its gradient), the [ROWS][G*H] tile of
// gate cotangents, W_hh when w_smem, its gradient when dw_smem.
__host__ __device__ inline size_t tile_floats(int H) {
  return (size_t)ROWS * odd(H);
}
inline size_t fwd_floats(int G, int H, int w_smem) {
  return (G == 4 ? 3 : 2) * tile_floats(H) + (size_t)G * H +
         (w_smem ? (size_t)H * odd(G * H) : 0);
}
inline size_t bwd_floats(int G, int H, int w_smem, int dw_smem) {
  return 4 * tile_floats(H) + (size_t)ROWS * odd(G * H) + 2 * (size_t)G * H +
         (w_smem ? (size_t)H * odd(G * H) : 0) +
         (dw_smem ? (size_t)H * G * H : 0);
}

// Where W_hh and dW_hh live: both in shared memory if they fit, else W_hh
// alone (read twice a step in the backward), else neither.
struct Plan {
  int w_smem, dw_smem;
  size_t bytes;
};

inline Plan plan(int G, int H, int backward) {
  const size_t limit = (size_t)max_optin_smem();
  const int cand[3][2] = {{1, 1}, {1, 0}, {0, 0}};
  Plan p{0, 0, 0};
  for (int i = backward ? 0 : 1; i < 3; ++i) {
    p.w_smem = cand[i][0];
    p.dw_smem = cand[i][1];
    p.bytes = sizeof(float) * (backward ? bwd_floats(G, H, p.w_smem, p.dw_smem)
                                        : fwd_floats(G, H, p.w_smem));
    if (p.bytes <= limit) break;
  }
  return p;
}

// rows of the tile per thread: few enough that the H*ROWS/RPT work items
// (unit, row group) of a step keep most threads busy, enough that they do
// not outnumber the threads
inline int rows_per_thread(int H) {
  int rpt = 1;
  while (rpt < ROWS && H * (ROWS / rpt) > THREADS) rpt *= 2;
  return rpt;
}

// ---------------------------------------------------------------------------
// GRU
// ---------------------------------------------------------------------------

template <int RPT>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(RnnDims d, int w_smem, const float* __restrict__ gi,
               const float* __restrict__ h0, const float* __restrict__ whh,
               const float* __restrict__ bhh, const float* __restrict__ hdec,
               float* __restrict__ hs) {
  extern __shared__ float smem[];
  const int H = d.H, GH = 3 * H, sH = odd(H), tid = threadIdx.x;
  const size_t tile = tile_floats(H), BH = (size_t)d.B * H;
  float* hin = smem;              // the cell's input state [2][ROWS][sH]
  float* bias = hin + 2 * tile;   // [3H]
  zero_smem(hin, 2 * tile);
  const WView w = load_whh(bias + GH, w_smem, whh, 3, H);
  for (int i = tid; i < GH; i += THREADS) bias[i] = bhh[i];
  const int row0 = blockIdx.x * ROWS, nr = min(ROWS, d.B - row0);
  __syncthreads();
  for (int i = tid; i < nr * H; i += THREADS) {
    const size_t o = (size_t)row0 * H + i;
    hin[(i / H) * sH + i % H] = hdec ? h0[o] * hdec[o] : h0[o];
  }
  __syncthreads();

  for (int t = 0; t < d.L; ++t) {
    const float* hc = hin + (t & 1) * tile;
    float* hn = hin + ((t + 1) & 1) * tile;
    const float* git = gi + ((size_t)t * d.B + row0) * GH;
    for (int item = tid; item < H * (ROWS / RPT); item += THREADS) {
      const int j = item % H, r0 = (item / H) * RPT;
      float acc[3][RPT];
      gate_sums<3, RPT>(hc, sH, w, H, j, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < nr) {
          const float* g = git + (size_t)r * GH;
          const float rg = sigmoid(g[j] + acc[0][q] + bias[j]);
          const float zg = sigmoid(g[H + j] + acc[1][q] + bias[H + j]);
          const float ng = tanhf(g[2 * H + j] + rg * (acc[2][q] + bias[2 * H + j]));
          float h = (1.f - zg) * ng + zg * hc[r * sH + j];
          const size_t o = t * BH + (size_t)(row0 + r) * H + j;
          hs[o] = h;
          if (hdec && t + 1 < d.L) h *= hdec[o + BH];  // next step's decay
          hn[r * sH + j] = h;
        }
      }
    }
    __syncthreads();
  }
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(RnnDims d, int w_smem, int dw_smem,
               const float* __restrict__ gi, const float* __restrict__ h0,
               const float* __restrict__ hs, const float* __restrict__ ghs,
               const float* __restrict__ whh, const float* __restrict__ bhh,
               const float* __restrict__ hdec, float* __restrict__ dgi,
               float* __restrict__ dh0, float* __restrict__ p_whh,
               float* __restrict__ p_bhh, float* __restrict__ dhdec) {
  extern __shared__ float smem[];
  const int H = d.H, GH = 3 * H, sH = odd(H), sG = odd(GH), tid = threadIdx.x;
  const size_t tile = tile_floats(H), BH = (size_t)d.B * H;
  float* hin = smem;               // the cell's input state [2][ROWS][sH]
  float* gbar = hin + 2 * tile;    // cotangent of the step's output h
  float* dzh = gbar + tile;        // its direct share dh_in = gbar z
  float* dg = dzh + tile;          // gate cotangents [ROWS][sG]
  float* dbs = dg + ROWS * sG;     // db_hh [3H]
  float* bias = dbs + GH;          // [3H]
  float* rest = bias + GH;
  zero_smem(smem, 4 * tile + (size_t)ROWS * sG + GH);  // through dbs
  const WView w = load_whh(rest, w_smem, whh, 3, H);
  for (int i = tid; i < GH; i += THREADS) bias[i] = bhh[i];
  const size_t blk = blockIdx.x;
  float* dw = dw_smem ? rest + (w_smem ? (size_t)H * odd(GH) : 0)
                      : p_whh + blk * H * GH;
  for (int e = tid; e < H * GH; e += THREADS) dw[e] = 0.f;
  const int row0 = blockIdx.x * ROWS, nr = min(ROWS, d.B - row0);
  // the state before step t, and the step's decayed input to the cell
  auto hprev = [&](int t, int r, int k) {
    const size_t o = (size_t)(row0 + r) * H + k;
    return t == 0 ? h0[o] : hs[(t - 1) * BH + o];
  };
  auto cell_in = [&](int t, int r, int k) {
    const float h = hprev(t, r, k);
    return hdec ? h * hdec[t * BH + (size_t)(row0 + r) * H + k] : h;
  };
  __syncthreads();
  const int T = d.L - 1;
  for (int i = tid; i < nr * H; i += THREADS) {
    const int r = i / H, k = i % H;
    hin[r * sH + k] = cell_in(T, r, k);
    gbar[r * sH + k] = ghs[T * BH + (size_t)row0 * H + i];
  }
  __syncthreads();

  for (int t = T; t >= 0; --t) {
    float* hc = hin + ((T - t) & 1) * tile;
    float* hn = hin + ((T - t + 1) & 1) * tile;
    const size_t ob = ((size_t)t * d.B + row0) * GH;
    // recompute the gates; the gate cotangents from gbar
    for (int item = tid; item < H * (ROWS / RPT); item += THREADS) {
      const int j = item % H, r0 = (item / H) * RPT;
      float acc[3][RPT];
      gate_sums<3, RPT>(hc, sH, w, H, j, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < nr) {
          const float* g = gi + ob + (size_t)r * GH;
          const float rg = sigmoid(g[j] + acc[0][q] + bias[j]);
          const float zg = sigmoid(g[H + j] + acc[1][q] + bias[H + j]);
          const float ghn = acc[2][q] + bias[2 * H + j];
          const float ng = tanhf(g[2 * H + j] + rg * ghn);
          const int e = r * sH + j;
          const float gb = gbar[e];
          const float dn_pre = gb * (1.f - zg) * (1.f - ng * ng);
          const float dr_pre = dn_pre * ghn * rg * (1.f - rg);
          const float dz_pre = gb * (hc[e] - ng) * zg * (1.f - zg);
          dg[r * sG + j] = dr_pre;
          dg[r * sG + H + j] = dz_pre;
          dg[r * sG + 2 * H + j] = dn_pre * rg;
          float* dgr = dgi + ob + (size_t)r * GH;
          dgr[j] = dr_pre;
          dgr[H + j] = dz_pre;
          dgr[2 * H + j] = dn_pre;
          dzh[e] = gb * zg;
        }
      }
    }
    __syncthreads();
    weight_grads(hc, sH, dg, sG, GH, H, dw, dw_smem, dbs, nr);
    // back through W_hh and the decay to the state before the step
    for (int item = tid; item < H * (ROWS / RPT); item += THREADS) {
      const int k = item % H, r0 = (item / H) * RPT;
      float acc[RPT];
      back_sums<RPT>(dg, sG, w, GH, k, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q, e = r * sH + k;
        if (r < nr) {
          const float dhin = dzh[e] + acc[q];
          float dprev = dhin;
          const size_t o = (size_t)(row0 + r) * H + k;
          if (hdec) {
            dhdec[t * BH + o] = dhin * hprev(t, r, k);
            dprev = dhin * hdec[t * BH + o];
          }
          if (t > 0) {
            gbar[e] = dprev + ghs[(t - 1) * BH + o];
            hn[e] = cell_in(t - 1, r, k);
          } else {
            dh0[o] = dprev;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int c = tid; c < GH; c += THREADS) p_bhh[blk * GH + c] = dbs[c];
  if (dw_smem)
    for (int e = tid; e < H * GH; e += THREADS) p_whh[blk * H * GH + e] = dw[e];
}

// ---------------------------------------------------------------------------
// LSTM (from zero h and c): W_hh split over a thread-block cluster, and the
// weight gradient in a kernel of its own
// ---------------------------------------------------------------------------
//
// At H = 128 the LSTM's W_hh is 256 KB, above a block's 227 KB, and a
// weight gradient accumulated inside the recurrence puts a sweep over all
// of dW_hh on every step of the serial chain. So:
//
// * A cluster of CS CTAs (CS in {1, 2, 4, 8}) runs the recurrence for R
//   batch rows (R in {8, 16, 32}). CTA q owns the units [q U, min(H, (q +
//   1) U)), U = ceil(H / CS), and keeps the W_hh columns of their four
//   gates (its slice, [H][4 sU], odd row stride) in its shared memory. The
//   host plan (lstm_plan) takes the smallest CS whose slice fits beside
//   the CTA's tiles, and the fewest rows that keep the CTAs within one wave
//   (fewer if they do not fit); where no CS up to 8 fits (H above ~256),
//   the slices are read from device memory (L2-resident) with CS = 8.
// * Forward step: each CTA computes its units' gates for the R rows from
//   the full h in its own shared memory, updates c (kept there) and h,
//   writes hs and cs, and stores its part of the next h into every CTA of
//   the cluster (distributed shared memory). h is double-buffered, so one
//   cluster barrier a step suffices. The gi columns are prefetched with
//   cp.async two steps ahead.
// * Backward step: h before the step comes from the hs stream, so nothing
//   is exchanged for it; it is prefetched a step ahead with cp.async, with
//   c before the step and the step's gi and ghs. Each CTA recomputes its
//   units' gates, forms their cotangents (written to dgi) and multiplies
//   them by its own columns of W_hh^T into a partial dh [R][H] in its
//   shared memory; after the cluster barrier each CTA sums the CS partials
//   of its own units in rank order (a fixed order: runs are
//   bit-reproducible). The partials are double-buffered: one cluster
//   barrier a step.
// * The weight gradient: the gate pre-activation is gi + h W_hh + b_hh, so
//   W_hh's cotangent is exactly dgi: dW_hh = sum_t h_{t-1}^T dgi_t (h_{-1}
//   = 0) and db_hh = sum dgi. That is one parallel [H, L B] x [L B, 4H]
//   product over two streams already in device memory (lstm_wgrad_kernel,
//   after the recurrence): a tiled fp32 SIMT product, K = L B split over
//   enough CTAs to fill the card, the split partials summed by the wrapper
//   in a fixed order.
// Plain fp32 FMA on the CUDA cores (TF32 off), no atomics.

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// A CTA's share of the units: U (the last CTA may own fewer), padded to sU
// in the shared-memory layouts; rows of h padded to sH (float4 loads).
struct LstmSplit {
  int U, sU, sH;
};

__host__ __device__ inline LstmSplit lstm_split(int H, int cs) {
  const int U = (H + cs - 1) / cs;
  return LstmSplit{U, round4(U), round4(H)};
}

// Shared memory of a CTA, in floats. Forward: h [2][R][sH], the own gi
// columns of three steps [3][R][4 sU], c [R][sU], bias [4 sU]. Backward:
// h before the step [R][sH], the step's own gi columns [R][4 sU], c before
// the step, the step's ghs, the cotangents of the step's output h (from
// the later steps) and c [R][sU] each, the gate cotangents [R][4 sU], the
// partial dh [2][R][sH], bias [4 sU]. Then the slice when it is in shared
// memory.
inline size_t lstm_floats(int H, int cs, int R, int w_smem, int backward) {
  const LstmSplit s = lstm_split(H, cs);
  const size_t rH = (size_t)R * s.sH, rU = (size_t)R * s.sU;
  const size_t tiles = backward ? 3 * rH + 12 * rU + 4 * s.sU
                                : 2 * rH + 13 * rU + 4 * s.sU;
  return tiles + (w_smem ? (size_t)H * odd(4 * s.sU) : 0);
}

inline int sm_count() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return v;
}

struct LstmPlan {
  int cs;      // CTAs per cluster
  int rows;    // batch rows per cluster
  int w_smem;  // 1: the slices in shared memory; 0: read from device memory
  int rpt;     // rows per thread of the per-step products
  size_t bytes;
};

// rows per thread: few enough that the step's (unit, row group) items keep
// most threads busy, enough that they do not outnumber the threads
inline int lstm_rpt(int U, int R) {
  int rpt = 1;
  while (rpt < 8 && U * (R / rpt) > THREADS) rpt *= 2;
  return rpt;
}

inline LstmPlan lstm_plan(int H, int B, int backward) {
  const size_t limit = (size_t)max_optin_smem();
  const int sms = sm_count();
  for (int w_smem = 1; w_smem >= 0; --w_smem)
    for (int cs = w_smem ? 1 : 8; cs <= 8; cs *= 2) {
      int want = 8;
      while (want < 32 && (B + want - 1) / want * cs > sms) want *= 2;
      for (int R = want; R >= 8; R /= 2) {
        const size_t bytes =
            sizeof(float) * lstm_floats(H, cs, R, w_smem, backward);
        if (bytes <= limit)
          return LstmPlan{cs, R, w_smem, lstm_rpt(lstm_split(H, cs).U, R),
                          bytes};
      }
    }
  return LstmPlan{0, 0, 0, 0, 0};
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
// addresses multiples of 4 floats), else 4
__device__ __forceinline__ void copy_rows_async(float* dst, int dr, int dj,
                                                const float* src, size_t sr,
                                                int sj, int nr, int m, int n,
                                                bool v4) {
  const int w = v4 ? 4 : 1, nw = n / w, per = m * nw;
  for (int i = threadIdx.x; i < nr * per; i += THREADS) {
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
struct LstmGeom {
  LstmSplit s;
  int u0, nu, row0, nr;
};

__device__ __forceinline__ LstmGeom lstm_geom(const RnnDims& d, int cs,
                                              int R, int rank) {
  LstmGeom g;
  g.s = lstm_split(d.H, cs);
  g.u0 = rank * g.s.U;
  g.nu = max(0, min(d.H - g.u0, g.s.U));
  g.row0 = (int)(blockIdx.x / cs) * R;
  g.nr = min(R, d.B - g.row0);
  return g;
}

// The CTA's columns of W_hh: gate gt of own unit ul in row k at
// p[k * ld + gt * gs + ul]
struct LView {
  const float* p;
  int ld, gs;
};

template <int WS>
__device__ __forceinline__ LView lstm_slice(float* s,
                                            const float* __restrict__ whh,
                                            int H, const LstmGeom& g) {
  if (!WS) return LView{whh + g.u0, 4 * H, H};
  const int ld = odd(4 * g.s.sU), n = 4 * g.nu;
  for (int i = threadIdx.x; i < H * n; i += THREADS) {
    const int k = i / n, j = i - k * n, gt = j / g.nu, ul = j - gt * g.nu;
    s[k * ld + gt * g.s.sU + ul] = whh[(size_t)k * 4 * H + gt * H + g.u0 + ul];
  }
  return LView{s, ld, g.s.sU};
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

// acc[gt][q] = sum_k h[(r0 + q) * sH + k] W[k][gt, ul]: the four gates of
// own unit ul for the RPT rows r0.. of the tile h [R][sH]; h read four k
// at a time (a warp reads one or two rows: broadcasts), each W load feeds
// RPT FMAs
template <int RPT>
__device__ __forceinline__ void lstm_gate_sums(const float* h, int sH, int H,
                                               const LView w, int ul, int r0,
                                               float (&acc)[4][RPT]) {
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int q = 0; q < RPT; ++q) acc[g][q] = 0.f;
  const int H4 = H & ~3;
  for (int k = 0; k < H4; k += 4) {
    float4 x[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q)
      x[q] = *reinterpret_cast<const float4*>(h + (r0 + q) * sH + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float* wk = w.p + (size_t)(k + kk) * w.ld + ul;
      float wv[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) wv[g] = wk[g * w.gs];
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const float xv = lane(x[q], kk);
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[g][q] = fmaf(xv, wv[g], acc[g][q]);
      }
    }
  }
  for (int k = H4; k < H; ++k) {
    const float* wk = w.p + (size_t)k * w.ld + ul;
    float wv[4];
#pragma unroll
    for (int g = 0; g < 4; ++g) wv[g] = wk[g * w.gs];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const float xv = h[(r0 + q) * sH + k];
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[g][q] = fmaf(xv, wv[g], acc[g][q]);
    }
  }
}

// acc[q] = sum over own columns (gt, ul) of dg[r0 + q][gt, ul] W[k][gt, ul]:
// the CTA's part of dh for unit k and the RPT rows r0.. (dg [R][4 sU],
// read four columns at a time; a thread walks row k of the slice, whose
// odd stride keeps neighbouring threads on distinct banks)
template <int RPT>
__device__ __forceinline__ void lstm_back_sums(const float* dg, int sU,
                                               int nu, const LView w, int k,
                                               int r0, float (&acc)[RPT]) {
  const int sD = 4 * sU, nu4 = nu & ~3;
#pragma unroll
  for (int q = 0; q < RPT; ++q) acc[q] = 0.f;
  const float* wk = w.p + (size_t)k * w.ld;
#pragma unroll
  for (int gt = 0; gt < 4; ++gt) {
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

template <int RPT, int WS>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
                const float* __restrict__ whh, const float* __restrict__ bhh,
                float* __restrict__ hs, float* __restrict__ cs_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const LstmGeom g = lstm_geom(d, cs, R, (int)cluster.block_rank());
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
  const LView w = lstm_slice<WS>(rest, whh, H, g);
  for (int i = tid; i < 4 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi);
  auto prefetch_gi = [&](int t, float* dst) {
    copy_rows_async(dst, 4 * sU, sU,
                    gi + ((size_t)t * d.B + g.row0) * GH + g.u0, GH, H, g.nr,
                    4, g.nu, v4);
  };
  // one copy group a step, empty or not, two steps in flight
  prefetch_gi(0, gbuf);
  cp_async_commit();
  if (d.L > 1) prefetch_gi(1, gbuf + tileG);
  cp_async_commit();
  cp_async_wait<1>();
  cluster.sync();  // every CTA's h is zeroed before a peer writes into it
  const int items = g.nu * (R / RPT);
  for (int t = 0; t < d.L; ++t) {
    const int cur = t & 1;
    const float* hc = hbuf + cur * tileH;
    float* hn = hbuf + (cur ^ 1) * tileH;
    const float* git = gbuf + (t % 3) * tileG;
    // into the buffer step t - 1 read: all its reads are behind a barrier
    if (t + 2 < d.L) prefetch_gi(t + 2, gbuf + ((t + 2) % 3) * tileG);
    cp_async_commit();
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[4][RPT];
      lstm_gate_sums<RPT>(hc, sH, H, w, ul, r0, acc);
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
  const LstmGeom g = lstm_geom(d, cs, R, (int)cluster.block_rank());
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
  const LView w = lstm_slice<WS>(rest, whh, H, g);
  for (int i = tid; i < 4 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // what step t reads: its gi and ghs rows, and (h, c) before it (zero
  // before the first step)
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) && aligned16(hs) &&
                  aligned16(cs_in) && aligned16(ghs);
  auto prefetch = [&](int t) {
    const size_t row = (size_t)t * d.B + g.row0;
    copy_rows_async(gbuf, sD, sU, gi + row * GH + g.u0, GH, H, g.nr, 4, g.nu,
                    v4);
    copy_rows_async(gsel, sU, 0, ghs + row * H + g.u0, H, 0, g.nr, 1, g.nu,
                    v4);
    if (t > 0) {
      copy_rows_async(hprev, sH, 0, hs + (row - d.B) * H, H, 0, g.nr, 1, H,
                      v4);
      copy_rows_async(cprev, sU, 0, cs_in + (row - d.B) * H + g.u0, H, 0,
                      g.nr, 1, g.nu, v4);
    } else {
      for (int i = tid; i < g.nr * sH; i += THREADS) hprev[i] = 0.f;
      for (int i = tid; i < g.nr * sU; i += THREADS) cprev[i] = 0.f;
    }
  };
  prefetch(d.L - 1);
  cp_async_wait_all();
  cluster.sync();
  const int items = g.nu * (R / RPT), back_items = H * (R / RPT);
  for (int t = d.L - 1; t >= 0; --t) {
    // recompute the own units' gates from (h, c) before the step; their
    // cotangents
    const size_t ob = ((size_t)t * d.B + g.row0) * GH + g.u0;
    const float* pdl = pdh + ((t + 1) & 1) * tileH;  // zero at the last step
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[4][RPT];
      lstm_gate_sums<RPT>(hprev, sH, H, w, ul, r0, acc);
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
    prefetch(t - 1);
    // back through the own columns of W_hh: the partial dh of every unit
    float* pd = pdh + (t & 1) * tileH;
    for (int item = tid; item < back_items; item += THREADS) {
      const int k = item % H, r0 = (item / H) * RPT;
      float acc[RPT];
      lstm_back_sums<RPT>(dg, sU, g.nu, w, k, r0, acc);
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

// The weight-gradient product: tiles of BM x WG_BN outputs (BM = 128 rows
// of dW_hh where H fills them, else 64), K in steps of WG_BK staged in
// shared memory (double-buffered with cp.async), BM / 16 x 4 outputs a
// thread in registers: per step of K a thread loads BM / 64 + 1 float4s
// from shared memory for 4 BM / 16 FMAs.
constexpr int WG_BN = 64, WG_BK = 16;

inline int wgrad_rows(int H) { return H > 64 ? 128 : 64; }

// Splits of K = L B: enough that the output tiles make about two CTAs an
// SM, each split at least 8 steps of WG_BK.
inline int lstm_wgrad_splits(int L, int B, int H) {
  const long long K = (long long)L * B, bm = wgrad_rows(H);
  const long long tiles = ((H + bm - 1) / bm) * ((4 * H + WG_BN - 1) / WG_BN);
  long long s = (2LL * sm_count() + tiles - 1) / tiles;
  s = std::min(s, K / (8 * WG_BK));
  return (int)std::max(s, 1LL);
}

// Split z's partials: p_whh[z][k][c] = sum over its n of hprev[n][k]
// dgi[n][c], hprev[n] = hs[n - B] (zero for n < B: the first step starts
// from h = 0), and p_bhh[z][c] = sum over its n of dgi[n][c]; n < K = L B
// runs over (step, row).
template <int BM>
__global__ void __launch_bounds__(THREADS)
lstm_wgrad_kernel(int K, int B, int H, int kper, const float* __restrict__ hs,
                  const float* __restrict__ dgi, float* __restrict__ p_whh,
                  float* __restrict__ p_bhh) {
  constexpr int TM = BM / 16;  // rows of the thread's outputs
  __shared__ __align__(16) float xs[2][WG_BK][BM];
  __shared__ __align__(16) float ys[2][WG_BK][WG_BN];
  const int N = 4 * H, tid = threadIdx.x, tc = tid % 16, tm = tid / 16;
  const int c0 = blockIdx.x * WG_BN, m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * kper, n1 = min(K, n0 + kper);
  const bool vec = (H & 3) == 0;
  auto load = [&](int buf, int nb) {
    for (int q = tid; q < WG_BK * BM / 4; q += THREADS) {
      const int lr = q / (BM / 4), lc = (q % (BM / 4)) * 4;
      const int n = nb + lr, m = m0 + lc;
      const bool xrow = n < n1 && n >= B;
      const float* x = hs + (xrow ? (size_t)(n - B) * H + m : 0);
      if (vec) {
        const bool ok = xrow && m < H;
        cp_async16(&xs[buf][lr][lc], ok ? x : hs, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = xrow && m + j < H;
          cp_async4(&xs[buf][lr][lc + j], ok ? x + j : hs, ok ? 4 : 0);
        }
      }
    }
    const int lr = tid / 16, lc = (tid % 16) * 4, n = nb + lr, c = c0 + lc;
    const bool yok = n < n1 && c < N;
    cp_async16(&ys[buf][lr][lc], yok ? dgi + (size_t)n * N + c : dgi,
               yok ? 16 : 0);
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
  const size_t base = (size_t)blockIdx.z * H;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + tm * TM + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (m < H && c < N) p_whh[(base + m) * N + c] = acc[i][j];
    }
  }
  if (own_b)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tc * 4 + j;
      if (c < N) p_bhh[(size_t)blockIdx.z * N + c] = bsum[j];
    }
}

// ---------------------------------------------------------------------------
// Launches: one instantiation per rows-per-thread
// ---------------------------------------------------------------------------

struct GruFwdArgs {
  RnnDims d;
  const float *gi, *h0, *whh, *bhh, *hdec;
  float* hs;
};

struct GruBwdArgs {
  RnnDims d;
  const float *gi, *h0, *hs, *ghs, *whh, *bhh, *hdec;
  float *dgi, *dh0, *p_whh, *p_bhh, *dhdec;
};

template <int RPT>
int gru_fwd(const GruFwdArgs& a, cudaStream_t s) {
  const Plan p = plan(3, a.d.H, 0);
  auto k = gru_fwd_kernel<RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<(a.d.B + ROWS - 1) / ROWS, THREADS, p.bytes, s>>>(
      a.d, p.w_smem, a.gi, a.h0, a.whh, a.bhh, a.hdec, a.hs);
  return (int)cudaGetLastError();
}

template <int RPT>
int gru_bwd(const GruBwdArgs& a, cudaStream_t s) {
  const Plan p = plan(3, a.d.H, 1);
  auto k = gru_bwd_kernel<RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<(a.d.B + ROWS - 1) / ROWS, THREADS, p.bytes, s>>>(
      a.d, p.w_smem, p.dw_smem, a.gi, a.h0, a.hs, a.ghs, a.whh, a.bhh,
      a.hdec, a.dgi, a.dh0, a.p_whh, a.p_bhh, a.dhdec);
  return (int)cudaGetLastError();
}

template <template <int> class Fn, class Args>
int by_rpt(const Args& a, cudaStream_t s) {
  if (a.d.L <= 0 || a.d.B <= 0 || a.d.H <= 0) return (int)cudaErrorInvalidValue;
  switch (rows_per_thread(a.d.H)) {
    case 1: return Fn<1>::run(a, s);
    case 2: return Fn<2>::run(a, s);
    case 4: return Fn<4>::run(a, s);
    case 8: return Fn<8>::run(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <int R> struct GruFwd { static int run(const GruFwdArgs& a, cudaStream_t s) { return gru_fwd<R>(a, s); } };
template <int R> struct GruBwd { static int run(const GruBwdArgs& a, cudaStream_t s) { return gru_bwd<R>(a, s); } };

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
int launch_clusters(void (*k)(Exp...), const LstmPlan& p, int B,
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
struct LstmFwd {
  static int run(const LstmFwdArgs& a, const LstmPlan& p, cudaStream_t s,
                 int* active, bool go) {
    return launch_clusters(lstm_fwd_kernel<RPT, WS>, p, a.d.B, s, active, go,
                           a.d, p.cs, p.rows, a.gi, a.whh, a.bhh, a.hs, a.cs);
  }
};

template <int RPT, int WS>
struct LstmBwd {
  static int run(const LstmBwdArgs& a, const LstmPlan& p, cudaStream_t s,
                 int* active, bool go) {
    return launch_clusters(lstm_bwd_kernel<RPT, WS>, p, a.d.B, s, active, go,
                           a.d, p.cs, p.rows, a.gi, a.hs, a.cs, a.ghs, a.whh,
                           a.bhh, a.dgi);
  }
};

// The plan of one launch, then its kernel instance (rows per thread, and
// the slices in shared or device memory).
template <template <int, int> class Fn, class Args>
int lstm_launch(const Args& a, int backward, cudaStream_t s, int* active,
                bool go) {
  if (a.d.L <= 0 || a.d.B <= 0 || a.d.H <= 0) return (int)cudaErrorInvalidValue;
  const LstmPlan p = lstm_plan(a.d.H, a.d.B, backward);
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

}  // namespace

extern "C" {

int fused_gru_rows_per_block() { return ROWS; }
int fused_lstm_rows_per_block() { return ROWS; }  // the fewest rows a cluster takes
int fused_gru_max_smem() { return max_optin_smem(); }
int fused_lstm_max_smem() { return max_optin_smem(); }

// Dynamic shared memory a launch takes, in bytes: the plan never exceeds
// the device's limit (W_hh and dW_hh move to device memory instead).
long long fused_gru_smem_bytes(int H, int backward) {
  return (long long)plan(3, H, backward).bytes;
}

const char* fused_gru_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// hdec may be null (no decay)
int fused_gru_fwd(const float* gi, const float* h0, const float* whh,
                  const float* bhh, const float* hdec, float* hs, int L,
                  int B, int H, void* stream) {
  const GruFwdArgs a{RnnDims{L, B, H}, gi, h0, whh, bhh, hdec, hs};
  return by_rpt<GruFwd>(a, (cudaStream_t)stream);
}

// hdec and dhdec are null together (no decay)
int fused_gru_bwd(const float* gi, const float* h0, const float* hs,
                  const float* ghs, const float* whh, const float* bhh,
                  const float* hdec, float* dgi, float* dh0, float* p_whh,
                  float* p_bhh, float* dhdec, int L, int B, int H,
                  void* stream) {
  const GruBwdArgs a{RnnDims{L, B, H}, gi, h0, hs, ghs, whh, bhh, hdec,
                     dgi, dh0, p_whh, p_bhh, dhdec};
  return by_rpt<GruBwd>(a, (cudaStream_t)stream);
}

// Dynamic shared memory of one CTA of an LSTM launch, in bytes: the plan
// never exceeds the device's limit (the slices move to device memory
// instead).
long long fused_lstm_smem_bytes(int H, int B, int backward) {
  return (long long)lstm_plan(H, B, backward).bytes;
}

// One field of the LSTM plan at (H, B): 0 CTAs per cluster, 1 batch rows
// per cluster, 2 the slices in shared memory (1) or device memory (0), 3
// rows per thread, 4 cudaOccupancyMaxActiveClusters (minus the CUDA error
// when the plan cannot be scheduled), 5 dynamic shared bytes per CTA.
int fused_lstm_plan(int H, int B, int backward, int field) {
  const LstmPlan p = lstm_plan(H, B, backward);
  switch (field) {
    case 0: return p.cs;
    case 1: return p.rows;
    case 2: return p.w_smem;
    case 3: return p.rpt;
    case 5: return (int)p.bytes;
  }
  int active = 0, err;
  const RnnDims d{1, B, H};
  if (backward)
    err = lstm_launch<LstmBwd>(LstmBwdArgs{d, 0, 0, 0, 0, 0, 0, 0}, 1, 0,
                               &active, false);
  else
    err = lstm_launch<LstmFwd>(LstmFwdArgs{d, 0, 0, 0, 0, 0}, 0, 0, &active,
                               false);
  return err ? -err : active;
}

// Splits of the weight-gradient product, the leading dimension of its
// partials [splits][H][4H] and [splits][4H].
int fused_lstm_wgrad_splits(int L, int B, int H) {
  return lstm_wgrad_splits(L, B, H);
}

// cs may be null: the inference-only primal writes no cell-state stream
int fused_lstm_fwd(const float* gi, const float* whh, const float* bhh,
                   float* hs, float* cs, int L, int B, int H, void* stream) {
  const LstmFwdArgs a{RnnDims{L, B, H}, gi, whh, bhh, hs, cs};
  return lstm_launch<LstmFwd>(a, 0, (cudaStream_t)stream, nullptr, true);
}

// The reverse recurrence: dgi only (the weight gradient is fused_lstm_wgrad)
int fused_lstm_bwd(const float* gi, const float* hs, const float* cs,
                   const float* ghs, const float* whh, const float* bhh,
                   float* dgi, int L, int B, int H, void* stream) {
  const LstmBwdArgs a{RnnDims{L, B, H}, gi, hs, cs, ghs, whh, bhh, dgi};
  return lstm_launch<LstmBwd>(a, 1, (cudaStream_t)stream, nullptr, true);
}

// Partials of dW_hh [splits][H][4H] and db_hh [splits][4H] from hs and dgi
int fused_lstm_wgrad(const float* hs, const float* dgi, float* p_whh,
                     float* p_bhh, int L, int B, int H, void* stream) {
  if (L <= 0 || B <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int K = L * B, S = lstm_wgrad_splits(L, B, H);
  const int kper = ((K + S - 1) / S + WG_BK - 1) / WG_BK * WG_BK;
  const int bm = wgrad_rows(H);
  const dim3 grid((4 * H + WG_BN - 1) / WG_BN, (H + bm - 1) / bm, S);
  auto k = bm == 128 ? lstm_wgrad_kernel<128> : lstm_wgrad_kernel<64>;
  k<<<grid, THREADS, 0, (cudaStream_t)stream>>>(K, B, H, kper, hs, dgi,
                                                p_whh, p_bhh);
  return (int)cudaGetLastError();
}

}  // extern "C"
