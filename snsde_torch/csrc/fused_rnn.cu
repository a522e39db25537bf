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
// Design: one thread block per tile of ROWS batch rows runs the whole
// recurrence (CUDA blocks run in no order, unlike the TPU grid). Each step
// is a [ROWS, H] x [H, G*H] product and the gate math; a thread owns unit j
// for RPT rows of the tile and keeps its G*RPT sums in registers, so a
// weight is read once per step and thread group; the backward's W^T
// product mirrors it (a thread owns row k of W_hh for RPT rows of the
// tile). W_hh stays in shared
// memory when it fits (GRU up to H = 128, LSTM up to H = 64 at 227 KB a
// block) and is read from device memory (L2-resident: at most 4 MB)
// otherwise. The backward recomputes the gates from the saved hidden (and
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

#include "sde_common.cuh"

namespace {

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
// LSTM (from zero h and c)
// ---------------------------------------------------------------------------

template <int RPT>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(RnnDims d, int w_smem, const float* __restrict__ gi,
                const float* __restrict__ whh, const float* __restrict__ bhh,
                float* __restrict__ hs, float* __restrict__ cs) {
  extern __shared__ float smem[];
  const int H = d.H, GH = 4 * H, sH = odd(H), tid = threadIdx.x;
  const size_t tile = tile_floats(H), BH = (size_t)d.B * H;
  float* hbuf = smem;             // h [2][ROWS][sH]
  float* cst = hbuf + 2 * tile;   // c [ROWS][sH], entry owned by its unit's thread
  float* bias = cst + tile;       // [4H]
  zero_smem(smem, 3 * tile);
  const WView w = load_whh(bias + GH, w_smem, whh, 4, H);
  for (int i = tid; i < GH; i += THREADS) bias[i] = bhh[i];
  const int row0 = blockIdx.x * ROWS, nr = min(ROWS, d.B - row0);
  __syncthreads();

  for (int t = 0; t < d.L; ++t) {
    const float* hc = hbuf + (t & 1) * tile;
    float* hn = hbuf + ((t + 1) & 1) * tile;
    const float* git = gi + ((size_t)t * d.B + row0) * GH;
    for (int item = tid; item < H * (ROWS / RPT); item += THREADS) {
      const int j = item % H, r0 = (item / H) * RPT;
      float acc[4][RPT];
      gate_sums<4, RPT>(hc, sH, w, H, j, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < nr) {
          const float* g = git + (size_t)r * GH;
          const float ig = sigmoid(g[j] + acc[0][q] + bias[j]);
          const float fg = sigmoid(g[H + j] + acc[1][q] + bias[H + j]);
          const float gg = tanhf(g[2 * H + j] + acc[2][q] + bias[2 * H + j]);
          const float og = sigmoid(g[3 * H + j] + acc[3][q] + bias[3 * H + j]);
          const int e = r * sH + j;
          const float c = fg * cst[e] + ig * gg;
          const float h = og * tanhf(c);
          cst[e] = c;
          hn[e] = h;
          const size_t o = t * BH + (size_t)(row0 + r) * H + j;
          hs[o] = h;
          if (cs) cs[o] = c;  // only when a backward will need it
        }
      }
    }
    __syncthreads();
  }
}

template <int RPT>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(RnnDims d, int w_smem, int dw_smem,
                const float* __restrict__ gi, const float* __restrict__ hs,
                const float* __restrict__ cs, const float* __restrict__ ghs,
                const float* __restrict__ whh, const float* __restrict__ bhh,
                float* __restrict__ dgi, float* __restrict__ p_whh,
                float* __restrict__ p_bhh) {
  extern __shared__ float smem[];
  const int H = d.H, GH = 4 * H, sH = odd(H), sG = odd(GH), tid = threadIdx.x;
  const size_t tile = tile_floats(H), BH = (size_t)d.B * H;
  float* hbuf = smem;              // h before the step [2][ROWS][sH]
  float* gh = hbuf + 2 * tile;     // cotangent of the step's output h
  float* gc = gh + tile;           // of its output c (owned like c)
  float* dg = gc + tile;           // gate cotangents [ROWS][sG]
  float* dbs = dg + ROWS * sG;     // db_hh [4H]
  float* bias = dbs + GH;          // [4H]
  float* rest = bias + GH;
  zero_smem(smem, 4 * tile + (size_t)ROWS * sG + GH);  // through dbs
  const WView w = load_whh(rest, w_smem, whh, 4, H);
  for (int i = tid; i < GH; i += THREADS) bias[i] = bhh[i];
  const size_t blk = blockIdx.x;
  float* dw = dw_smem ? rest + (w_smem ? (size_t)H * odd(GH) : 0)
                      : p_whh + blk * H * GH;
  for (int e = tid; e < H * GH; e += THREADS) dw[e] = 0.f;
  const int row0 = blockIdx.x * ROWS, nr = min(ROWS, d.B - row0);
  const int T = d.L - 1;
  __syncthreads();
  for (int i = tid; i < nr * H; i += THREADS) {
    const int e = (i / H) * sH + i % H;
    hbuf[e] = T > 0 ? hs[(T - 1) * BH + (size_t)row0 * H + i] : 0.f;
    gh[e] = ghs[T * BH + (size_t)row0 * H + i];
  }
  __syncthreads();

  for (int t = T; t >= 0; --t) {
    float* hc = hbuf + ((T - t) & 1) * tile;
    float* hn = hbuf + ((T - t + 1) & 1) * tile;
    const size_t ob = ((size_t)t * d.B + row0) * GH;
    // recompute the gates from (h, c) before the step; gate cotangents
    for (int item = tid; item < H * (ROWS / RPT); item += THREADS) {
      const int j = item % H, r0 = (item / H) * RPT;
      float acc[4][RPT];
      gate_sums<4, RPT>(hc, sH, w, H, j, r0, acc);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < nr) {
          const float* g = gi + ob + (size_t)r * GH;
          const float ig = sigmoid(g[j] + acc[0][q] + bias[j]);
          const float fg = sigmoid(g[H + j] + acc[1][q] + bias[H + j]);
          const float gg = tanhf(g[2 * H + j] + acc[2][q] + bias[2 * H + j]);
          const float og = sigmoid(g[3 * H + j] + acc[3][q] + bias[3 * H + j]);
          const float c = t > 0 ? cs[(t - 1) * BH + (size_t)(row0 + r) * H + j] : 0.f;
          const float tc = tanhf(fg * c + ig * gg);
          const int e = r * sH + j;
          const float ghv = gh[e];
          const float dc = gc[e] + ghv * og * (1.f - tc * tc);
          const float di = dc * gg * ig * (1.f - ig);
          const float df = dc * c * fg * (1.f - fg);
          const float dgg = dc * ig * (1.f - gg * gg);
          const float dov = ghv * tc * og * (1.f - og);
          gc[e] = dc * fg;
          float* dgs = dg + r * sG;
          dgs[j] = di;
          dgs[H + j] = df;
          dgs[2 * H + j] = dgg;
          dgs[3 * H + j] = dov;
          float* dgr = dgi + ob + (size_t)r * GH;
          dgr[j] = di;
          dgr[H + j] = df;
          dgr[2 * H + j] = dgg;
          dgr[3 * H + j] = dov;
        }
      }
    }
    __syncthreads();
    weight_grads(hc, sH, dg, sG, GH, H, dw, dw_smem, dbs, nr);
    if (t > 0) {
      // back through W_hh to the h before the step; load the step before
      for (int item = tid; item < H * (ROWS / RPT); item += THREADS) {
        const int k = item % H, r0 = (item / H) * RPT;
        float acc[RPT];
        back_sums<RPT>(dg, sG, w, GH, k, r0, acc);
#pragma unroll
        for (int q = 0; q < RPT; ++q) {
          const int r = r0 + q, e = r * sH + k;
          if (r < nr) {
            const size_t o = (size_t)(row0 + r) * H + k;
            gh[e] = acc[q] + ghs[(t - 1) * BH + o];
            hn[e] = t > 1 ? hs[(t - 2) * BH + o] : 0.f;
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

struct LstmFwdArgs {
  RnnDims d;
  const float *gi, *whh, *bhh;
  float *hs, *cs;
};

struct LstmBwdArgs {
  RnnDims d;
  const float *gi, *hs, *cs, *ghs, *whh, *bhh;
  float *dgi, *p_whh, *p_bhh;
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

template <int RPT>
int lstm_fwd(const LstmFwdArgs& a, cudaStream_t s) {
  const Plan p = plan(4, a.d.H, 0);
  auto k = lstm_fwd_kernel<RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<(a.d.B + ROWS - 1) / ROWS, THREADS, p.bytes, s>>>(
      a.d, p.w_smem, a.gi, a.whh, a.bhh, a.hs, a.cs);
  return (int)cudaGetLastError();
}

template <int RPT>
int lstm_bwd(const LstmBwdArgs& a, cudaStream_t s) {
  const Plan p = plan(4, a.d.H, 1);
  auto k = lstm_bwd_kernel<RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  k<<<(a.d.B + ROWS - 1) / ROWS, THREADS, p.bytes, s>>>(
      a.d, p.w_smem, p.dw_smem, a.gi, a.hs, a.cs, a.ghs, a.whh, a.bhh,
      a.dgi, a.p_whh, a.p_bhh);
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
template <int R> struct LstmFwd { static int run(const LstmFwdArgs& a, cudaStream_t s) { return lstm_fwd<R>(a, s); } };
template <int R> struct LstmBwd { static int run(const LstmBwdArgs& a, cudaStream_t s) { return lstm_bwd<R>(a, s); } };

}  // namespace

extern "C" {

int fused_gru_rows_per_block() { return ROWS; }
int fused_lstm_rows_per_block() { return ROWS; }
int fused_gru_max_smem() { return max_optin_smem(); }
int fused_lstm_max_smem() { return max_optin_smem(); }

// Dynamic shared memory a launch takes, in bytes: the plan never exceeds
// the device's limit (W_hh and dW_hh move to device memory instead).
long long fused_gru_smem_bytes(int H, int backward) {
  return (long long)plan(3, H, backward).bytes;
}
long long fused_lstm_smem_bytes(int H, int backward) {
  return (long long)plan(4, H, backward).bytes;
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

// cs may be null: the inference-only primal writes no cell-state stream
int fused_lstm_fwd(const float* gi, const float* whh, const float* bhh,
                   float* hs, float* cs, int L, int B, int H, void* stream) {
  const LstmFwdArgs a{RnnDims{L, B, H}, gi, whh, bhh, hs, cs};
  return by_rpt<LstmFwd>(a, (cudaStream_t)stream);
}

int fused_lstm_bwd(const float* gi, const float* hs, const float* cs,
                   const float* ghs, const float* whh, const float* bhh,
                   float* dgi, float* p_whh, float* p_bhh, int L, int B,
                   int H, void* stream) {
  const LstmBwdArgs a{RnnDims{L, B, H}, gi, hs, cs, ghs, whh, bhh, dgi,
                      p_whh, p_bhh};
  return by_rpt<LstmBwd>(a, (cudaStream_t)stream);
}

}  // extern "C"
