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
// [L, B, H] (has_dec == 2), and the LSTM from zero (h, c); and in the modes
// of the ODE-RNN hybrids (the kernel bodies' has_obs, has_dec == 1 and
// n_ode, fused_rnn.py:95-106, :141-178, :259-297, :596-600, :654-671):
//   GRU mode 1  the observation mask obs [L, B] (GRU-dt):
//               h = obs h' + (1 - obs) h_in, h_in the cell's input state
//   GRU mode 2  mode 1 with a time-only decay row hrow [L, H] (GRU-D):
//               h_in = h hrow_t; its cotangent summed over the batch
//   GRU mode 3  mode 1 with the Euler MLP evolve (ODE-RNN): h_in is h after
//               S substeps x += dt_t f(x), f an MLP of n layers (tanh
//               inner layers, linear output), dt_t = tdif_t / S
//   LSTM mode 1 the same evolve applied to the cell's output h' with a
//               per-row dt [L, B] (ODE-LSTM); c passes through
// (obs may be absent in modes 2 and 3: every step observed); and in the
// modes of the time-aware LSTMs (has_sel, has_tg and kind == "tlstm",
// fused_rnn.py:543-575, :601-606, :661-716):
//   LSTM mode 2 PLSTM's openness sel [L, B, H]: h = sel h' + (1 - sel) h,
//               likewise c (hs and cs hold the blended states)
//   LSTM mode 3 TGLSTM's modifiers tg [L, B, 3H] multiplying the i, f
//               and o gates' sigmoids
//   LSTM mode 4 TLSTM's memory decomposition: c_short = tanh(c W_d +
//               b_d) of every unit of c, c_adj = c - c_short + c_short
//               tel_t (tel [L, B], one elapsed time a row), the gates
//               (f, i, o, a sigmoid candidate) on c_adj. The input
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
// The modes. The mask and the decay row are read from device memory where
// they are used (a row a step; L2-resident). The decay row's cotangent is
// a sum over the batch, whose rows are spread over clusters: each CTA sums
// its rows of its own units in row order into a partial [clusters][L][H],
// which the wrapper sums in cluster order (no atomics). The MLP of the
// evolve reads x of every unit, so every CTA of a cluster runs the whole
// MLP on its full copy of the state (recomputed, not exchanged: at the
// sweep's width the cluster is one CTA, and an exchange would add a
// cluster barrier a layer), its weights read from device memory (L1/L2):
// one output a thread, in a fixed order, so every CTA holds the same bits.
// The backward recomputes the substep states from the step's input state,
// takes the cotangent of every unit (each CTA adds the partials of the
// whole row in rank order, its own units' direct share added by their
// owner), goes back through the substeps, and writes each layer's input
// and output cotangent as streams [L][S][B][width] (each CTA its share of
// the columns); the weight gradients are the same product kernel after
// the loop, one launch a layer, as W_hh's is. A GRU mode's W_hh gradient
// takes the cell's input states from a stream xin [L][B][H] the backward
// writes (modes 2 and 3; mode 1 reads h0 and hs); the LSTM's evolve keeps
// hs (the evolved h, the next cell's input), and its forward writes the
// cell's own output h' as a stream hcell for the backward.
//
// The reduced precisions (the JAX kernels' traj_bf16 and mm_bf16,
// fused_rnn.py:452-521, :991-1057) are instances of the same templates
// with RED = true, the precision a runtime argument (Prec: the operand
// mode and the stream flag). With bf16 streams the streams named at each
// entry are bf16 in device memory, copied synchronously and widened as
// they are staged (copy_rows), and hs, cs, dgi, dsel and dtg are stored
// rounded (st); the carries stay fp32, the backward reads the rounded
// trajectory back (the GRU's h0 handed over rounded), the LSTM backward
// writes its gate cotangents once more in fp32 (dgw) for W_hh's gradient,
// and the LSTM evolve's forward writes hcell at the rounded state (the
// gates a second time), which is what the backward goes back through. In
// the bf16 and bf16x3 operand modes every product, the weight gradients'
// too, rounds or splits its operands (mad: three FMAs a term on the CUDA
// cores). A reduced instance takes one row a thread, so that a quarter
// as many instances build (this source took 137 s in nvcc alone on an
// 8-core H100 host, 91 s with the fp32 instances alone). The fp32
// instances hold none of this code (their loads and stores keep their own
// lines where a shared form changed ptxas's register allocation): their
// outputs are those of the fp32-only source bit for bit, and each of the
// 148 reports the same registers, stack and spills
// (tests/torch_ptxas_compare.py on the two builds' ptxas reports).
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

#include "operand_modes.cuh"
#include "sde_common.cuh"

namespace {

namespace cg = cooperative_groups;

struct RnnDims {
  int L, B, H;
};

// A launch's precision: the products' operand mode (MM_*) and the stream
// flag sb (1: the streams in bf16). The fp32 instances (RED false) read
// neither.
struct Prec {
  int mm, sb;
};

// acc + x w: an fp32 FMA, or in a reduced instance the operands rounded
// or split in operand mode mm (fma3)
template <bool RED>
__device__ __forceinline__ float mad(float x, float w, float acc, int mm) {
  if constexpr (RED) {
    if (mm != MM_F32) return fma3(parts(x, mm == MM_X3), parts(w, mm == MM_X3),
                                  acc);
  }
  return fmaf(x, w, acc);
}

// entry i of a stream (bf16 with bs in a reduced instance), widened; an
// entry written to one
template <bool RED>
__device__ __forceinline__ float ld(const float* p, size_t i, bool bs) {
  if constexpr (RED) return ld_stream(p, i, bs);
  return p[i];
}
template <bool RED>
__device__ __forceinline__ void st(float* p, size_t i, float v, bool bs) {
  if constexpr (RED)
    st_stream(p, i, v, bs);
  else
    p[i] = v;
}

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

// The mode of a launch: 0 the plain modes; GRU 1 obs, 2 obs + row decay,
// 3 obs + evolve; LSTM 1 evolve, 2 sel, 3 tg, 4 TLSTM. The evolve's MLP
// has n layers (H -> HH -> ... -> HH -> H; H -> H when n = 1) and S
// substeps.
struct ModeShape {
  int mode, HH, n, S;
};

// What a mode's kernels read besides the plain inputs (null where unused)
struct ModeArgs {
  const float* obs;   // [L][B] 0/1; null: every step observed
  const float* hrow;  // [L][H], the GRU's time-only decay row
  const float* mlp;   // [W_0 (in x out), b_0 (out), W_1, b_1, ...]
  const float* dts;   // substep sizes: [L] (GRU), [L][B] (LSTM)
  int HH, n, S;
  const float* aux;   // the LSTM's mode stream: sel [L][B][H] (mode 2), tg
                      // [L][B][3H] (3), tel [L][B] (4)
  const float* wd;    // TLSTM's W_d [H][H] (in x out)
  const float* bd;    // and b_d [H]
};

// The mode's own tiles, in floats (sM: the wider of H and HH; sU, sH of
// the plan's split). GRU forward, mode 3, and LSTM forward, mode 1: the
// MLP's two scratch tiles [2][R][sM]. LSTM forward, mode 2: the own sel
// columns of three steps [3][R][sU]; mode 3: the own tg columns
// [3][R][3 sU]; mode 4: c of every unit [2][R][sH] and b_d's own columns
// [sU]. LSTM backward, mode 2: the step's own sel columns and the carry of
// h's cotangent past the cell [R][sU] each; mode 3: the step's own tg
// columns [R][3 sU]; mode 4: c before the step, every unit [R][sH], the
// partial dc [2][R][sH], dzd of the own units [R][sU], b_d [sU].
// GRU backward (a kernel of its own for modes 1-3: the plain backward's
// tiles without the decay's [R][sH], with the rows' decay products [R][sU]):
// mode 2 the cell's input state [R][sH]; mode 3 the substep states
// [S + 1][R][sH], the cotangent of the input state [R][sH], the inner
// layers' activations [n - 1][R][sHH] and two [R][sM] for the layers'
// cotangents. LSTM backward, mode 1: the step's ghs and the cotangent of
// its output, every unit, [R][sH] each, the substep states [S][R][sH], the
// activations and the two cotangent tiles.
inline size_t mode_floats(int G, int H, int cs, int R, int backward,
                          const ModeShape& ms) {
  if (ms.mode == 0) return 0;
  const Split sp = split_of(H, cs);
  if (G == 4 && ms.mode >= 2) {
    const size_t rU = (size_t)R * sp.sU, rS = (size_t)R * sp.sH;
    if (ms.mode == 4)
      return (backward ? 3 * rS + rU : 2 * rS) + sp.sU;
    return (ms.mode == 2 ? 1 : 3) * rU * (backward ? 1 : 3) +
           (backward && ms.mode == 2 ? rU : 0);
  }
  const size_t rH = (size_t)R * round4(H);
  const size_t rM = (size_t)R * round4(std::max(H, ms.HH));
  const size_t acts = (size_t)std::max(ms.n - 1, 0) * R * round4(ms.HH);
  const bool ode = G == 3 ? ms.mode == 3 : ms.mode == 1;
  if (!backward) return ode ? 2 * rM : 0;
  if (G == 4) return (2 + (size_t)ms.S) * rH + acts + 2 * rM;
  if (ms.mode == 2) return rH;
  return ode ? (2 + (size_t)ms.S) * rH + acts + 2 * rM : 0;
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
// partial dh [2][R][sH], bias [4 sU]. Then the mode's tiles (mode_floats),
// then the slice when it is in shared memory (TLSTM's W_d columns [H][sU]
// after W_hh's).
inline size_t rnn_floats(int G, int H, int cs, int R, int w_smem,
                         int backward, const ModeShape& ms) {
  const Split s = split_of(H, cs);
  const size_t rH = (size_t)R * s.sH, rU = (size_t)R * s.sU;
  size_t tiles;
  if (G == 3 && backward && ms.mode != 0)
    tiles = 3 * rH + 11 * rU + 3 * s.sU;
  else if (G == 3)
    tiles = backward ? 4 * rH + 11 * rU + 3 * s.sU
                     : 2 * rH + 12 * rU + 3 * s.sU;
  else
    tiles = backward ? 3 * rH + 12 * rU + 4 * s.sU
                     : 2 * rH + 13 * rU + 4 * s.sU;
  const size_t slices =
      (size_t)H * (odd(G * s.sU) + (G == 4 && ms.mode == 4 ? odd(s.sU) : 0));
  return tiles + mode_floats(G, H, cs, R, backward, ms) +
         (w_smem ? slices : 0);
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

// A cluster size and rows a cluster forced on every later plan (0: the
// host's own choice), for tests of each kind of plan
int g_force_cs = 0, g_force_rows = 0;

inline RnnPlan rnn_plan(int G, int H, int B, int backward,
                        const ModeShape& ms) {
  const size_t limit = (size_t)max_optin_smem();
  const int sms = sm_count();
  for (int w_smem = 1; w_smem >= 0; --w_smem) {
    const int cs_lo = g_force_cs ? g_force_cs : (w_smem ? 1 : 8);
    const int cs_hi = g_force_cs ? g_force_cs : 8;
    for (int cs = cs_lo; cs <= cs_hi; cs *= 2) {
      int want = 8;
      while (want < 32 && (B + want - 1) / want * cs > sms) want *= 2;
      const int r_hi = g_force_rows ? g_force_rows : want;
      const int r_lo = g_force_rows ? g_force_rows : 8;
      for (int R = r_hi; R >= r_lo; R /= 2) {
        const size_t bytes =
            sizeof(float) * rnn_floats(G, H, cs, R, w_smem, backward, ms);
        if (bytes <= limit)
          return RnnPlan{cs, R, w_smem,
                         rows_per_thread(split_of(H, cs).U, R), bytes};
      }
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

// A step's rows of a stream, src entry (off + r sr + j sj + i) to dst[r][j]
// [i], as copy_rows_async lays them out: in an fp32 instance by it, in a
// reduced one synchronously, each entry widened from bf16 (bs) or copied
// from fp32 (a copy's order among the step's work is no matter: every
// buffer it fills is behind the same barriers either way).
template <bool RED>
__device__ __forceinline__ void copy_rows(float* dst, int dr, int dj,
                                          const float* src, size_t off,
                                          size_t sr, int sj, int nr, int m,
                                          int n, bool v4, bool bs,
                                          int first = 0) {
  if constexpr (!RED) {
    copy_rows_async(dst, dr, dj, src + off, sr, sj, nr, m, n, v4, first);
  } else {
    const int per = m * n, total = nr * per;
    for (int i = (threadIdx.x + THREADS - first) % THREADS; i < total;
         i += THREADS) {
      const int r = i / per, j = (i - r * per) / n, c = i - r * per - j * n;
      dst[r * dr + j * dj + c] =
          ld_stream(src, off + r * sr + (size_t)j * sj + c, bs);
    }
  }
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
// read. A reduced instance (RED) takes the operands in operand mode mm,
// and with rnd x rounded to bf16 first.
template <int G, int RPT, bool DEC = false, bool RED = false>
__device__ __forceinline__ void gate_sums(const float* h, int sH, int H,
                                          const WSlice w, int ul, int r0,
                                          float (&acc)[G][RPT],
                                          const float* dec = nullptr,
                                          int mm = MM_F32, bool rnd = false) {
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
        float xv = lane(x[q], kk);
        if (RED && rnd) xv = bf16r(xv);
#pragma unroll
        for (int g = 0; g < G; ++g)
          acc[g][q] = mad<RED>(xv, wv[g], acc[g][q], mm);
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
      float xv = DEC ? h[o] * dec[o] : h[o];
      if (RED && rnd) xv = bf16r(xv);
#pragma unroll
      for (int g = 0; g < G; ++g)
        acc[g][q] = mad<RED>(xv, wv[g], acc[g][q], mm);
    }
  }
}

// acc[q] = sum over own columns (gt, ul) of dg[r0 + q][gt, ul] W[k][gt, ul]:
// the CTA's part of dh for unit k and the RPT rows r0.. (dg [R][G sU],
// read four columns at a time; a thread walks row k of the slice, whose
// odd stride keeps neighbouring threads on distinct banks). A reduced
// instance (RED) takes the operands in operand mode mm.
template <int G, int RPT, bool RED = false>
__device__ __forceinline__ void back_sums(const float* dg, int sU, int nu,
                                          const WSlice w, int k, int r0,
                                          float (&acc)[RPT],
                                          int mm = MM_F32) {
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
        float a = mad<RED>(x.x, w0, acc[q], mm);
        a = mad<RED>(x.y, w1, a, mm);
        a = mad<RED>(x.z, w2, a, mm);
        acc[q] = mad<RED>(x.w, w3, a, mm);
      }
    }
    for (int ul = nu4; ul < nu; ++ul) {
      const float wv = wg[ul];
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        acc[q] = mad<RED>(dgt[(r0 + q) * sD + ul], wv, acc[q], mm);
    }
  }
}

// ---------------------------------------------------------------------------
// The evolve's MLP, shared by the GRU's mode 3 and the LSTM's mode 1. Every
// CTA runs it on its full copy of the state (rows < nr, every unit); one
// output a thread, its sum in a fixed order (the same bits in every CTA).
// Tiles are [R][stride]; dt of row r is dt[r * dstride].
// ---------------------------------------------------------------------------

// Layer i of n maps in_i -> out_i: H -> HH ... HH -> H (H -> H when n = 1)
__host__ __device__ inline int mlp_in(int i, int H, int HH) {
  return i == 0 ? H : HH;
}
__host__ __device__ inline int mlp_out(int i, int n, int H, int HH) {
  return i == n - 1 ? H : HH;
}
// the offset of layer i's W (b follows it) in the packed weights
__host__ __device__ inline size_t mlp_off(int i, int n, int H, int HH) {
  size_t o = 0;
  for (int j = 0; j < i; ++j) {
    const int ow = mlp_out(j, n, H, HH);
    o += (size_t)mlp_in(j, H, HH) * ow + ow;
  }
  return o;
}

// y[r][c] = sum_m a[r][m] M[m][c] (+ bias[c], tanh with `inner`) for r <
// nr, c < nc, m < nm, where M is W [nm][ld] or, with TRANS, W^T (W [nc][ld]).
// A thread takes column c for a group of rg rows (RG: at most), so each
// weight it loads (from L1/L2) feeds every row of the group. Each output's
// sum runs over m in ascending order, whatever the grouping. A reduced
// instance (RED) takes the operands in operand mode mm.
template <bool TRANS, int RG, bool RED = false>
__device__ __forceinline__ void mlp_product_rows(
    const float* a, int as, int nm, float* y, int ys, int nc,
    const float* __restrict__ W, int ld, const float* bias, int nr,
    bool inner, int rg, int mm = MM_F32) {
  const int groups = (nr + rg - 1) / rg;
  for (int i = threadIdx.x; i < nc * groups; i += THREADS) {
    const int c = i % nc, r0 = (i / nc) * rg;
    const int nq = min(rg, nr - r0);
    float acc[RG];
#pragma unroll
    for (int q = 0; q < RG; ++q) acc[q] = 0.f;
    for (int m = 0; m < nm; ++m) {
      const float w =
          __ldg(W + (TRANS ? (size_t)c * ld + m : (size_t)m * ld + c));
#pragma unroll
      for (int q = 0; q < RG; ++q)
        if (RG == 1 || q < nq)
          acc[q] = mad<RED>(a[(r0 + q) * as + m], w, acc[q], mm);
    }
    const float b = bias ? __ldg(bias + c) : 0.f;
#pragma unroll
    for (int q = 0; q < RG; ++q)
      if (RG == 1 || q < nq) {
        const float v = bias ? acc[q] + b : acc[q];
        y[(r0 + q) * ys + c] = inner ? tanhf(v) : v;
      }
  }
}

// mlp_product_rows with the most rows a group (1, 2, 4 or 8) that still
// give the block's threads an item each: one at the sweep's width (a loop
// of its own: the 8-row loop's predicates cost the sweep's evolve 1.5x on
// an H100), 8 at H = 256, where every CTA of a cluster reads the whole MLP
// from L2 (a loop over up to 8 rows, the row count at run time: with 2-4
// instantiations more, the H = 256 forward took 12% longer)
template <bool TRANS, bool RED = false>
__device__ __forceinline__ void mlp_product(const float* a, int as, int nm,
                                            float* y, int ys, int nc,
                                            const float* __restrict__ W,
                                            int ld, const float* bias,
                                            int nr, bool inner,
                                            int mm = MM_F32) {
  int rg = 8;
  while (rg > 1 && nc * ((nr + rg - 1) / rg) < THREADS) rg /= 2;
  if (rg == 1)
    mlp_product_rows<TRANS, 1, RED>(a, as, nm, y, ys, nc, W, ld, bias, nr,
                                    inner, 1, mm);
  else
    mlp_product_rows<TRANS, 8, RED>(a, as, nm, y, ys, nc, W, ld, bias, nr,
                                    inner, rg, mm);
}

// out[r][j] = act(x[r] W[:, j] + b[j]) for r < nr, j < ow (act: tanh on
// the inner layers); b is stored after W
template <bool RED = false>
__device__ __forceinline__ void mlp_layer(const float* x, int xs, int iw,
                                          float* out, int os, int ow,
                                          const float* __restrict__ W,
                                          int nr, bool inner,
                                          int mm = MM_F32) {
  mlp_product<false, RED>(x, xs, iw, out, os, ow, W, ow, W + (size_t)iw * ow,
                          nr, inner, mm);
}

// y = x + dt f(x), one Euler substep (y may be x); t0, t1 scratch [R][sM];
// dt of row r is the stream entry dts[doff + r dstride] (bf16 with dtb in
// a reduced instance)
template <bool RED = false>
__device__ __forceinline__ void mlp_substep(const float* x, float* y, int xs,
                                            float* t0, float* t1, int sM,
                                            const ModeArgs& m, int H, int nr,
                                            size_t doff, int dstride,
                                            int mm = MM_F32,
                                            bool dtb = false) {
  const float* in = x;
  int is = xs, iw = H;
  for (int i = 0; i < m.n; ++i) {
    const int ow = mlp_out(i, m.n, H, m.HH);
    float* out = (i & 1) ? t1 : t0;
    mlp_layer<RED>(in, is, iw, out, sM, ow, m.mlp + mlp_off(i, m.n, H, m.HH),
                   nr, i < m.n - 1, mm);
    __syncthreads();
    in = out;
    is = sM;
    iw = ow;
  }
  for (int i = threadIdx.x; i < nr * H; i += THREADS) {
    const int r = i / H, k = i - r * H;
    y[r * xs + k] = x[r * xs + k] +
                    ld<RED>(m.dts, doff + r * dstride, dtb) * in[r * sM + k];
  }
  __syncthreads();
}

// The columns [c0, c1) of a width this CTA writes to a stream
__device__ __forceinline__ void own_cols(int width, int cs, int rank, int& c0,
                                         int& c1) {
  const int per = (width + cs - 1) / cs;
  c0 = min(width, rank * per);
  c1 = min(width, c0 + per);
}

// Back through one substep x1 = x0 + dt f(x0): dh [R][sH] (the cotangent of
// x1, every unit) becomes x0's. A [n - 1][R][sHH] takes the inner layers'
// activations (recomputed from x0), dz and dx [R][sM] the layers'
// cotangents. Each layer's input and output cotangent rows go to the
// streams acts/dzs (layer i's blocks [K][in_i] and [K][out_i], K = L S B,
// at row krow + r), this CTA's share of the columns. dt as mlp_substep's.
template <bool RED = false>
__device__ __forceinline__ void mlp_back(float* dh, int sH, const float* x0,
                                         float* A, int tA, int sHH,
                                         float* dz, float* dx, int sM,
                                         const ModeArgs& m, int H, int nr,
                                         size_t doff, int dstride,
                                         float* __restrict__ acts,
                                         float* __restrict__ dzs,
                                         size_t krow, size_t K, int cs,
                                         int rank, int mm = MM_F32,
                                         bool dtb = false) {
  const int n = m.n, HH = m.HH;
  for (int i = 0; i + 1 < n; ++i) {
    mlp_layer<RED>(i == 0 ? x0 : A + (i - 1) * tA, i == 0 ? sH : sHH,
                   mlp_in(i, H, HH), A + i * tA, sHH, HH,
                   m.mlp + mlp_off(i, n, H, HH), nr, true, mm);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * H; i += THREADS) {
    const int r = i / H, k = i - r * H;
    dz[r * sM + k] = dh[r * sH + k] * ld<RED>(m.dts, doff + r * dstride, dtb);
  }
  __syncthreads();
  size_t aoff = 0, zoff = 0;
  for (int i = 0; i < n; ++i) {
    aoff += K * mlp_in(i, H, HH);
    zoff += K * mlp_out(i, n, H, HH);
  }
  for (int i = n - 1; i >= 0; --i) {
    const int iw = mlp_in(i, H, HH), ow = mlp_out(i, n, H, HH);
    aoff -= K * iw;
    zoff -= K * ow;
    const float* a = i == 0 ? x0 : A + (i - 1) * tA;
    const int as = i == 0 ? sH : sHH;
    const float* __restrict__ W = m.mlp + mlp_off(i, n, H, HH);
    int c0, c1;
    own_cols(iw, cs, rank, c0, c1);
    for (int q = threadIdx.x; q < nr * (c1 - c0); q += THREADS) {
      const int r = q / (c1 - c0), k = c0 + q - r * (c1 - c0);
      acts[aoff + (krow + r) * iw + k] = a[r * as + k];
    }
    own_cols(ow, cs, rank, c0, c1);
    for (int q = threadIdx.x; q < nr * (c1 - c0); q += THREADS) {
      const int r = q / (c1 - c0), j = c0 + q - r * (c1 - c0);
      dzs[zoff + (krow + r) * ow + j] = dz[r * sM + j];
    }
    // dx = dz W^T
    mlp_product<true, RED>(dz, sM, ow, dx, sM, iw, W, ow, nullptr, nr, false,
                           mm);
    __syncthreads();
    for (int q = threadIdx.x; q < nr * iw; q += THREADS) {
      const int r = q / iw, k = q - r * iw;
      if (i > 0) {
        const float v = a[r * as + k];
        dz[r * sM + k] = dx[r * sM + k] * (1.f - v * v);
      } else {
        dh[r * sH + k] += dx[r * sM + k];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// GRU
// ---------------------------------------------------------------------------

template <int RPT, int WS, int MODE, bool RED>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
               const float* __restrict__ h0, const float* __restrict__ whh,
               const float* __restrict__ bhh, const float* __restrict__ hdec,
               float* __restrict__ hs, ModeArgs m, Prec pr) {
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
  float* evt = bias + 3 * sU;      // mode 3: the MLP's scratch [2][R][sM]
  const int sM = round4(max(H, m.HH));
  float* rest = evt + (MODE == 3 ? 2 * R * sM : 0);
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<3, WS>(rest, whh, H, g);
  for (int i = tid; i < 3 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // the first step's input state, every unit: h0, decayed (mode 3 evolves
  // it at the top of the step)
  for (int i = tid; i < g.nr * H; i += THREADS) {
    const int r = i / H, k = i - r * H;
    const size_t o = (size_t)(g.row0 + r) * H + k;
    if (MODE == 0)
      hbuf[r * sH + k] = hdec ? h0[o] * hdec[o] : h0[o];
    else
      hbuf[r * sH + k] = MODE == 2 ? h0[o] * m.hrow[k] : h0[o];
  }
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) &&
                  (!hdec || aligned16(hdec));
  // step t's gi columns, and the decay the state after it takes, issued
  // from thread `first` on
  auto prefetch = [&](int t, int first) {
    const int slot = t % 3;
    copy_rows<RED>(gbuf + slot * tileG, 3 * sU, sU, gi,
                   ((size_t)t * d.B + g.row0) * GH + g.u0, GH, H, g.nr, 3,
                   g.nu, v4, pr.sb, first);
    if (MODE == 0 && hdec && t + 1 < d.L)
      copy_rows<RED>(dbuf + slot * tileU, sU, 0, hdec,
                     ((size_t)(t + 1) * d.B + g.row0) * H + g.u0, H, 0, g.nr,
                     1, g.nu, v4, false, first);
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
    float* hc = hbuf + cur * tileH;
    float* hn = hbuf + (cur ^ 1) * tileH;
    const float* git = gbuf + (t % 3) * tileG;
    const float* dec = dbuf + (t % 3) * tileU;
    // into the buffers step t - 1 read: all its reads are behind a barrier
    if (t + 2 < d.L) prefetch(t + 2, idle);
    cp_async_commit();
    // the evolve, in place: peers write only the next step's buffer
    if (MODE == 3)
      for (int sub = 0; sub < m.S; ++sub)
        mlp_substep<RED>(hc, hc, sH, evt, evt + R * sM, sM, m, H, g.nr, t, 0,
                         pr.mm);
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[3][RPT];
      gate_sums<3, RPT, false, RED>(hc, sH, H, w, ul, r0, acc, nullptr,
                                    pr.mm);
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
          if (MODE != 0 && m.obs) {  // unobserved: the input state passes
            const float sel = m.obs[(size_t)t * d.B + g.row0 + r];
            h = sel * h + (1.f - sel) * hc[r * sH + u];
          }
          st<RED>(hs, t * BH + (size_t)(g.row0 + r) * H + u, h, pr.sb);
          if (MODE == 0 && hdec && t + 1 < d.L)
            h *= dec[r * sU + ul];  // next step's
          if (MODE == 2 && t + 1 < d.L) h *= m.hrow[(size_t)(t + 1) * H + u];
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

template <int RPT, int WS, bool RED>
__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
               const float* __restrict__ h0, const float* __restrict__ hs,
               const float* __restrict__ ghs, const float* __restrict__ whh,
               const float* __restrict__ bhh, const float* __restrict__ hdec,
               float* __restrict__ dgi, float* __restrict__ dgh,
               float* __restrict__ dh0, float* __restrict__ dhdec, Prec pr) {
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
  // (a reduced instance's h0, hs and ghs in the stream dtype: with bf16
  // streams the state is the rounded trajectory, h0 rounded too)
  auto prefetch = [&](int t, int first) {
    const size_t row = (size_t)t * d.B + g.row0;
    copy_rows<RED>(gbuf, sD, sU, gi, row * GH + g.u0, GH, H, g.nr, 3, g.nu,
                   v4, pr.sb, first);
    copy_rows<RED>(gsel, sU, 0, ghs, row * H + g.u0, H, 0, g.nr, 1, g.nu, v4,
                   pr.sb, first);
    copy_rows<RED>(hprev, sH, 0, t > 0 ? hs : h0,
                   t > 0 ? (row - d.B) * H : (size_t)g.row0 * H, H, 0, g.nr,
                   1, H, v4, pr.sb, first);
    if (hdec)
      copy_rows<RED>(decb, sH, 0, hdec, row * H, H, 0, g.nr, 1, H, v4, false,
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
        gate_sums<3, RPT, true, RED>(hprev, sH, H, w, ul, r0, acc, decb,
                                     pr.mm);
      else
        gate_sums<3, RPT, false, RED>(hprev, sH, H, w, ul, r0, acc, nullptr,
                                      pr.mm);
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
          const size_t og = ob + (size_t)r * GH + ul;
          st<RED>(dgi, og, dr, pr.sb);
          st<RED>(dgi, og + H, dz, pr.sb);
          st<RED>(dgi, og + 2 * H, dn, pr.sb);
          float* dwr = dgh + og;
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
      back_sums<3, RPT, RED>(dg, sU, g.nu, w, k, r0, acc, pr.mm);
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

// The GRU backward in modes 1-3, a kernel of its own so that the plain
// modes' instances stay as they were (their cluster of one skips a barrier
// a step by forming the next step's cotangent in the gate loop, which the
// mask, the row sums and the evolve do not allow): the plain backward's
// reverse recurrence,
// with the observation mask splitting the output's cotangent between the
// cell (obs) and the input state (1 - obs), and the cell's input state
// x_t = h_{t-1} (mode 1), h_{t-1} hrow_t (mode 2) or h_{t-1} evolved
// (mode 3, its substeps recomputed at the top of the step). Every cluster
// size takes the cluster path (a cluster of one reads its own partial):
// after the barrier each CTA forms the cotangent of the input state of
// its own units (modes 1, 2: the direct share and the partials in rank
// order; through the row to h_{t-1}, each CTA summing its rows' dx h into
// its cluster's partial of dhrow) or of every unit (mode 3: the owners'
// direct shares sit in their partials), then back through the substeps.
// Writes dgi, dgh, dh0, the cell's input states xin (modes 2, 3; W_hh's
// weight gradient reads them), dhrow's partials (mode 2) and the MLP's
// streams (mode 3).
template <int RPT, int WS, int MODE, bool RED>
__global__ void __launch_bounds__(THREADS)
gru_bwd_mode_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
                    const float* __restrict__ h0, const float* __restrict__ hs,
                    const float* __restrict__ ghs,
                    const float* __restrict__ whh,
                    const float* __restrict__ bhh, ModeArgs m,
                    float* __restrict__ dgi, float* __restrict__ dgh,
                    float* __restrict__ dh0, float* __restrict__ dhrow,
                    float* __restrict__ xin, float* __restrict__ acts,
                    float* __restrict__ dzs, Prec pr) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const Geom g = geom_of(d, cs, R, rank);
  const int H = d.H, GH = 3 * H, sH = g.s.sH, sU = g.s.sU, tid = threadIdx.x;
  const int tileH = R * sH, tileU = R * sU, sD = 3 * sU;
  const int sHH = round4(m.HH), sM = round4(max(H, m.HH)), tA = R * sHH;
  const size_t BH = (size_t)d.B * H;
  float* hprev = smem;              // h before the step [R][sH], every unit
  float* gbuf = hprev + tileH;      // the step's gi, own columns [R][3 sU]
  float* gsel = gbuf + 3 * tileU;   // the step's ghs, own units [R][sU]
  float* gh = gsel + tileU;         // cotangent of the step's output h from
                                    // the later steps, own units
  float* dzh = gh + tileU;          // its direct share in the input's
  float* hown = dzh + tileU;        // mode 2: h before the step, own units
  float* pdec = hown + tileU;       // mode 2: the rows' dx h, own units
  float* dg = pdec + tileU;         // [dr, dz, dn r], own columns [R][3 sU]
  float* pdh = dg + 3 * tileU;      // the CTA's partial dh [2][R][sH]
  float* bias = pdh + 2 * tileH;    // [3 sU]
  float* tail = bias + 3 * sU;
  // the cell's input state [R][sH]: mode 1 hprev; mode 2 its own tile;
  // mode 3 the last of the substep states [S + 1][R][sH]
  float* subs = tail;
  float* xt = MODE == 1 ? hprev : MODE == 2 ? tail : subs + m.S * tileH;
  float* dhin = subs + (m.S + 1) * tileH;  // mode 3, every unit
  float* A = dhin + tileH;                 // [n - 1][R][sHH]
  float* dzt = A + (m.n - 1) * tA;         // [R][sM]
  float* dxt = dzt + R * sM;               // [R][sM]
  float* rest = MODE == 1 ? tail : MODE == 2 ? tail + tileH : dxt + R * sM;
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<3, WS>(rest, whh, H, g);
  for (int i = tid; i < 3 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) && aligned16(h0) &&
                  aligned16(hs) && aligned16(ghs);
  // what step t reads: its gi and ghs rows, h before it (h0 before the
  // first), issued from thread `first` on (in the stream dtype, as the
  // plain backward's)
  auto prefetch = [&](int t, int first) {
    const size_t row = (size_t)t * d.B + g.row0;
    if constexpr (RED) {
      copy_rows<RED>(gbuf, sD, sU, gi, row * GH + g.u0, GH, H, g.nr, 3, g.nu,
                     v4, pr.sb, first);
      copy_rows<RED>(gsel, sU, 0, ghs, row * H + g.u0, H, 0, g.nr, 1, g.nu,
                     v4, pr.sb, first);
      copy_rows<RED>(hprev, sH, 0, t > 0 ? hs : h0,
                     t > 0 ? (row - d.B) * H : (size_t)g.row0 * H, H, 0,
                     g.nr, 1, H, v4, pr.sb, first);
    } else {
      copy_rows_async(gbuf, sD, sU, gi + row * GH + g.u0, GH, H, g.nr, 3,
                      g.nu, v4, first);
      copy_rows_async(gsel, sU, 0, ghs + row * H + g.u0, H, 0, g.nr, 1, g.nu,
                      v4, first);
      copy_rows_async(hprev, sH, 0,
                      t > 0 ? hs + (row - d.B) * H
                            : h0 + (size_t)g.row0 * H,
                      H, 0, g.nr, 1, H, v4, first);
    }
  };
  prefetch(d.L - 1, 0);
  cp_async_wait_all();
  cluster.sync();
  const int items = g.nu * (R / RPT), back_items = H * (R / RPT);
  const int idle = back_items % THREADS;
  const size_t K = (size_t)d.L * m.S * d.B;  // the MLP streams' rows
  for (int t = d.L - 1; t >= 0; --t) {
    // the cell's input state
    if (MODE == 2) {
      for (int i = tid; i < g.nr * H; i += THREADS) {
        const int r = i / H, k = i - r * H;
        xt[r * sH + k] = hprev[r * sH + k] * m.hrow[(size_t)t * H + k];
      }
      __syncthreads();
    } else if (MODE == 3) {
      for (int i = tid; i < g.nr * H; i += THREADS) {
        const int r = i / H, k = i - r * H;
        subs[r * sH + k] = hprev[r * sH + k];
      }
      __syncthreads();
      for (int sub = 0; sub < m.S; ++sub)
        mlp_substep<RED>(subs + sub * tileH, subs + (sub + 1) * tileH, sH,
                         dzt, dxt, sM, m, H, g.nr, t, 0, pr.mm);
    }
    // the own units' gates and their cotangents
    const size_t ob = ((size_t)t * d.B + g.row0) * GH + g.u0;
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[3][RPT];
      gate_sums<3, RPT, false, RED>(xt, sH, H, w, ul, r0, acc, nullptr,
                                    pr.mm);
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
          const float hin = xt[r * sH + u];
          // the step's output h = sel h' + (1 - sel) h_in
          const float gb = gsel[e] + gh[e];
          const float sel =
              m.obs ? m.obs[(size_t)t * d.B + g.row0 + r] : 1.f;
          const float dhn = gb * sel;
          const float dn = dhn * (1.f - zg) * (1.f - ng * ng);
          const float dr = dn * ghn * rg * (1.f - rg);
          const float dz = dhn * (hin - ng) * zg * (1.f - zg);
          float* dgs = dg + r * sD + ul;
          dgs[0] = dr;
          dgs[sU] = dz;
          dgs[2 * sU] = dn * rg;
          if constexpr (RED) {
            const size_t og = ob + (size_t)r * GH + ul;
            st_stream(dgi, og, dr, pr.sb);
            st_stream(dgi, og + H, dz, pr.sb);
            st_stream(dgi, og + 2 * H, dn, pr.sb);
          } else {
            float* dgr = dgi + ob + (size_t)r * GH + ul;
            dgr[0] = dr;
            dgr[H] = dz;
            dgr[2 * H] = dn;
          }
          float* dwr = dgh + ob + (size_t)r * GH + ul;
          dwr[0] = dr;
          dwr[H] = dz;
          dwr[2 * H] = dn * rg;
          dzh[e] = dhn * zg + gb * (1.f - sel);
          if (MODE != 1) xin[t * BH + o] = hin;
          if (MODE == 2) hown[e] = hprev[r * sH + u];
        }
      }
    }
    __syncthreads();  // dg complete; this step's prefetched rows are read
    if (t > 0) prefetch(t - 1, idle);
    // back through the own columns of W_hh: the partial dh of every unit
    // (mode 3: with the own units' direct share)
    float* pd = pdh + (t & 1) * tileH;
    for (int item = tid; item < back_items; item += THREADS) {
      const int k = item % H, r0 = (item / H) * RPT;
      float acc[RPT];
      back_sums<3, RPT, RED>(dg, sU, g.nu, w, k, r0, acc, pr.mm);
      const bool own = MODE == 3 && k >= g.u0 && k < g.u0 + g.nu;
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        if (r0 + q < g.nr)
          pd[(r0 + q) * sH + k] =
              own ? acc[q] + dzh[(r0 + q) * sU + k - g.u0] : acc[q];
    }
    cluster_or_block_sync(cluster, cs);
    if (MODE != 3) {
      // the own units' cotangent of the step's input state: the direct
      // share, then the cluster's partials in rank order; through the row
      for (int i = tid; i < g.nr * g.nu; i += THREADS) {
        const int r = i / g.nu, ul = i - r * g.nu, e = r * sU + ul;
        const int u = g.u0 + ul, p = r * sH + u;
        float s = cluster.map_shared_rank(pd, 0)[p];
        for (int peer = 1; peer < cs; ++peer)
          s += cluster.map_shared_rank(pd, peer)[p];
        float dx = dzh[e] + s;
        if (MODE == 2) {
          pdec[e] = dx * hown[e];
          dx *= m.hrow[(size_t)t * H + u];
        }
        if (t > 0)
          gh[e] = dx;
        else
          dh0[(size_t)(g.row0 + r) * H + u] = dx;
      }
      if (MODE == 2) {  // the cluster's rows' sum, in row order
        __syncthreads();
        float* dst = dhrow + ((size_t)(blockIdx.x / cs) * d.L + t) * H + g.u0;
        for (int ul = tid; ul < g.nu; ul += THREADS) {
          float s = 0.f;
          for (int r = 0; r < g.nr; ++r) s += pdec[r * sU + ul];
          dst[ul] = s;
        }
      }
    } else {
      // every unit's cotangent of the evolved state, then back through
      // the substeps to h_{t-1}
      for (int i = tid; i < g.nr * H; i += THREADS) {
        const int r = i / H, k = i - r * H, p = r * sH + k;
        float s = cluster.map_shared_rank(pd, 0)[p];
        for (int peer = 1; peer < cs; ++peer)
          s += cluster.map_shared_rank(pd, peer)[p];
        dhin[p] = s;
      }
      __syncthreads();
      for (int sub = m.S - 1; sub >= 0; --sub)
        mlp_back<RED>(dhin, sH, subs + sub * tileH, A, tA, sHH, dzt, dxt, sM,
                      m, H, g.nr, t, 0, acts, dzs,
                      ((size_t)t * m.S + sub) * d.B + g.row0, K, cs, rank,
                      pr.mm);
      for (int i = tid; i < g.nr * g.nu; i += THREADS) {
        const int r = i / g.nu, ul = i - r * g.nu, u = g.u0 + ul;
        const float v = dhin[r * sH + u];
        if (t > 0)
          gh[r * sU + ul] = v;
        else
          dh0[(size_t)(g.row0 + r) * H + u] = v;
      }
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

// Mode 1 (the evolve): the cell's output h' goes to every CTA (and to the
// stream hcell when a backward will run), then after a cluster barrier each
// CTA evolves its full copy in place and writes its own units of hs. Modes
// 2 and 3 read their stream's own columns, prefetched with gi; mode 2's
// blended h is what goes to the peers. Mode 4 keeps c like h, every unit
// in every CTA (double-buffered, each CTA storing its units' c' into every
// peer), for the product c W_d over the CTA's own columns of W_d, held
// beside its W_hh slice by the same plan. A reduced instance with bf16
// streams writes to hcell the cell's output at the rounded state before the
// step (the h and c that the backward reads back from hs and cs), which is
// what the backward recomputes: the forward evaluates the gates a second
// time, on h rounded, and the cell on c rounded.
template <int RPT, int WS, int MODE, bool RED>
__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
                const float* __restrict__ whh, const float* __restrict__ bhh,
                float* __restrict__ hs, float* __restrict__ cs_out,
                ModeArgs m, float* __restrict__ hcell, Prec pr) {
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
  float* evt = bias + 4 * sU;      // mode 1: the MLP's scratch [2][R][sM]
  const int sM = round4(max(H, m.HH));
  // modes 2 and 3: the own sel or tg columns of three steps [3][tileX];
  // mode 4: c [2][R][sH], every unit, and b_d's own columns [sU]
  const int tileX = MODE == 2 ? R * sU : MODE == 3 ? 3 * R * sU : 0;
  float* xbuf = evt + (MODE == 1 ? 2 * R * sM : 0);
  float* cbuf = xbuf + 3 * tileX;
  float* bdo = cbuf + (MODE == 4 ? 2 * tileH : 0);
  float* rest = bdo + (MODE == 4 ? sU : 0);
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<4, WS>(rest, whh, H, g);
  const WSlice wdl =
      MODE == 4 ? load_slice<1, WS>(rest + (size_t)H * odd(4 * sU), m.wd, H, g)
                : w;
  for (int i = tid; i < 4 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  for (int i = tid; MODE == 4 && i < g.nu; i += THREADS)
    bdo[i] = m.bd[g.u0 + i];
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) &&
                  ((MODE != 2 && MODE != 3) || aligned16(m.aux));
  // step t's gi columns (and the mode's stream), into slot t % 3
  auto prefetch = [&](int t, int first) {
    const int slot = t % 3;
    const size_t row = (size_t)t * d.B + g.row0;
    copy_rows<RED>(gbuf + slot * tileG, 4 * sU, sU, gi, row * GH + g.u0, GH,
                   H, g.nr, 4, g.nu, v4, pr.sb, first);
    if (MODE == 2)
      copy_rows<RED>(xbuf + slot * tileX, sU, 0, m.aux, row * H + g.u0, H, 0,
                     g.nr, 1, g.nu, v4, pr.sb, first);
    if (MODE == 3)
      copy_rows<RED>(xbuf + slot * tileX, 3 * sU, sU, m.aux,
                     row * 3 * H + g.u0, 3 * H, H, g.nr, 3, g.nu, v4, pr.sb,
                     first);
  };
  // one copy group a step, empty or not, two steps in flight
  prefetch(0, 0);
  cp_async_commit();
  if (d.L > 1) prefetch(1, 0);
  cp_async_commit();
  cp_async_wait<1>();
  cluster.sync();  // every CTA's h is zeroed before a peer writes into it
  // the step's items; its copies go to the threads after them
  const int items = g.nu * (R / RPT), idle = items % THREADS;
  for (int t = 0; t < d.L; ++t) {
    const int cur = t & 1;
    const float* hc = hbuf + cur * tileH;
    float* hn = hbuf + (cur ^ 1) * tileH;
    const float* cc = cbuf + cur * tileH;
    float* cn = cbuf + (cur ^ 1) * tileH;
    const float* git = gbuf + (t % 3) * tileG;
    const float* xc = xbuf + (t % 3) * tileX;
    // into the buffer step t - 1 read: all its reads are behind a barrier
    if (t + 2 < d.L) prefetch(t + 2, idle);
    cp_async_commit();
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[4][RPT], accd[1][RPT], accr[4][RPT];
      gate_sums<4, RPT, false, RED>(hc, sH, H, w, ul, r0, acc, nullptr,
                                    pr.mm);
      if (MODE == 4)
        gate_sums<1, RPT, false, RED>(cc, sH, H, wdl, ul, r0, accd, nullptr,
                                      pr.mm);
      const bool rounded = RED && MODE == 1 && hcell && pr.sb;
      if (rounded)
        gate_sums<4, RPT, false, RED>(hc, sH, H, w, ul, r0, accr, nullptr,
                                      pr.mm, true);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < g.nr) {
          const float* gr = git + r * 4 * sU + ul;
          const float* bs = bias + ul;
          const int e = r * sU + ul, u = g.u0 + ul;
          float c, h, hr = 0.f;
          if (MODE == 4) {  // gates (f, i, o, candidate) on c_adj
            const float cold = cc[r * sH + u];
            const float csh = tanhf(accd[0][q] + bdo[ul]);
            const float tel =
                ld<RED>(m.aux, (size_t)t * d.B + g.row0 + r, pr.sb);
            const float cadj = cold - csh + csh * tel;
            const float fg = sigmoid(gr[0] + acc[0][q] + bs[0]);
            const float ig = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
            const float og = sigmoid(gr[2 * sU] + acc[2][q] + bs[2 * sU]);
            const float ct = sigmoid(gr[3 * sU] + acc[3][q] + bs[3 * sU]);
            c = fg * cadj + ig * ct;
            h = og * tanhf(c);
          } else {
            float ig = sigmoid(gr[0] + acc[0][q] + bs[0]);
            float fg = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
            const float gg = tanhf(gr[2 * sU] + acc[2][q] + bs[2 * sU]);
            float og = sigmoid(gr[3 * sU] + acc[3][q] + bs[3 * sU]);
            if (MODE == 3) {
              const float* tr = xc + r * 3 * sU + ul;
              ig *= tr[0];
              fg *= tr[sU];
              og *= tr[2 * sU];
            }
            const float cold = cst[e];
            c = fg * cold + ig * gg;
            h = og * tanhf(c);
            if (rounded) {  // hcell's: the cell at the rounded state
              const float ir = sigmoid(gr[0] + accr[0][q] + bs[0]);
              const float fr = sigmoid(gr[sU] + accr[1][q] + bs[sU]);
              const float gq = tanhf(gr[2 * sU] + accr[2][q] + bs[2 * sU]);
              const float orr = sigmoid(gr[3 * sU] + accr[3][q] + bs[3 * sU]);
              hr = orr * tanhf(fr * bf16r(cold) + ir * gq);
            }
            if (MODE == 2) {  // the blend with the state before the step
              const float sel = xc[e];
              h = sel * h + (1.f - sel) * hc[r * sH + u];
              c = sel * c + (1.f - sel) * cold;
            }
            cst[e] = c;
          }
          if (cs == 1) {
            hn[r * sH + u] = h;
            if (MODE == 4) cn[r * sH + u] = c;
          } else {
            for (int peer = 0; peer < cs; ++peer) {
              cluster.map_shared_rank(hn, peer)[r * sH + u] = h;
              if (MODE == 4) cluster.map_shared_rank(cn, peer)[r * sH + u] = c;
            }
          }
          const size_t o = t * BH + (size_t)(g.row0 + r) * H + u;
          if (MODE != 1)
            st<RED>(hs, o, h, pr.sb);
          else if (hcell)
            hcell[o] = rounded ? hr : h;
          // only when a backward will need it
          if (cs_out) st<RED>(cs_out, o, c, pr.sb);
        }
      }
    }
    if (MODE == 1) {  // every unit's h', then its evolve
      cluster_or_block_sync(cluster, cs);
      for (int sub = 0; sub < m.S; ++sub)
        mlp_substep<RED>(hn, hn, sH, evt, evt + R * sM, sM, m, H, g.nr,
                         (size_t)t * d.B + g.row0, 1, pr.mm, pr.sb);
      for (int i = tid; i < g.nr * g.nu; i += THREADS) {
        const int r = i / g.nu, u = g.u0 + i - r * g.nu;
        st<RED>(hs, t * BH + (size_t)(g.row0 + r) * H + u, hn[r * sH + u],
                pr.sb);
      }
    }
    cp_async_wait<1>();  // step t + 1's rows are in
    cluster_or_block_sync(cluster, cs);
  }
}

// Mode 1 (the evolve): at the top of step t each CTA forms the cotangent
// of the step's output (hs[t], every unit: ghs and the partials of the
// step after in rank order), recomputes the substeps from the cell's
// output hcell[t] and goes back through them to the cotangent of h', of
// which the gates take their own units; the MLP's streams as the GRU's.
// Mode 2 recomputes the cell's own (h', c') from the gates, writes dsel =
// gh (h' - h) + gc (c' - c) and passes (1 - sel) of each cotangent by the
// cell (h's share a direct term of the next step's sum). Mode 3 writes dtg
// from the raw sigmoids. Mode 4 recomputes c_short from every unit of c
// before the step, writes dzd (the cotangent of c W_d + b_d) and sums the
// partials of dzd W_d^T over the cluster in rank order, as dh's; the
// weight gradients (W_hh's from hs and dgi, W_d's from cs and dzd) are the
// product kernel's after the loop. A reduced instance reads gi, hs, cs,
// ghs and the mode's stream in the stream dtype (the state before a step
// the rounded trajectory with bf16 streams), writes dgi, dsel and dtg in
// it and, where dgw is not null (bf16 streams), the gate cotangents once
// more in fp32 for W_hh's gradient.
template <int RPT, int WS, int MODE, bool RED>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(RnnDims d, int cs, int R, const float* __restrict__ gi,
                const float* __restrict__ hs, const float* __restrict__ cs_in,
                const float* __restrict__ ghs, const float* __restrict__ whh,
                const float* __restrict__ bhh, float* __restrict__ dgi,
                ModeArgs m, const float* __restrict__ hcell,
                float* __restrict__ acts, float* __restrict__ dzs,
                float* __restrict__ dmode, float* __restrict__ dgw,
                Prec pr) {
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
  // mode 1: the step's ghs and the cotangent of its output, every unit
  // [R][sH] each, the substep states [S][R][sH] (the first is hcell[t]),
  // the inner layers' activations [n - 1][R][sHH], two [R][sM]
  const int sHH = round4(m.HH), sM = round4(max(H, m.HH)), tA = R * sHH;
  float* gfull = bias + 4 * sU;
  float* dho = gfull + tileH;
  float* subs = dho + tileH;
  float* A = subs + m.S * tileH;
  float* dzt = A + (m.n - 1) * tA;
  float* dxt = dzt + R * sM;
  // mode 2: the step's own sel columns, then the carry of h's cotangent
  // past the cell (own units); mode 3: the step's own tg columns [R][3 sU];
  // mode 4: c before the step, every unit [R][sH], the CTA's partial dc
  // [2][R][sH], dzd of the own units [R][sU], b_d's own columns [sU]
  float* xb = bias + 4 * sU;
  float* dhc = xb + tileU;
  float* cfull = xb;
  float* pdc = cfull + tileH;
  float* dzd = pdc + 2 * tileH;
  float* bdo = dzd + tileU;
  float* rest = MODE == 1   ? dxt + R * sM
                : MODE == 2 ? xb + 2 * tileU
                : MODE == 3 ? xb + 3 * tileU
                : MODE == 4 ? bdo + sU
                            : bias + 4 * sU;
  zero_smem(smem, rest - smem);
  __syncthreads();
  const WSlice w = load_slice<4, WS>(rest, whh, H, g);
  const WSlice wdl =
      MODE == 4 ? load_slice<1, WS>(rest + (size_t)H * odd(4 * sU), m.wd, H, g)
                : w;
  for (int i = tid; i < 4 * g.nu; i += THREADS) {
    const int gt = i / g.nu, ul = i - gt * g.nu;
    bias[gt * sU + ul] = bhh[gt * H + g.u0 + ul];
  }
  for (int i = tid; MODE == 4 && i < g.nu; i += THREADS)
    bdo[i] = m.bd[g.u0 + i];
  // what step t reads: its gi and ghs rows, and (h, c) before it (zero
  // before the first step)
  // 16-byte copies when every row segment starts on 16 bytes
  const bool v4 = ((H | g.s.U) & 3) == 0 && aligned16(gi) && aligned16(hs) &&
                  aligned16(cs_in) && aligned16(ghs) &&
                  (MODE != 1 || aligned16(hcell)) &&
                  ((MODE != 2 && MODE != 3) || aligned16(m.aux));
  auto prefetch = [&](int t, int first) {
    const size_t row = (size_t)t * d.B + g.row0;
    const bool sb = pr.sb;
    copy_rows<RED>(gbuf, sD, sU, gi, row * GH + g.u0, GH, H, g.nr, 4, g.nu,
                   v4, sb, first);
    if (MODE != 1) {
      copy_rows<RED>(gsel, sU, 0, ghs, row * H + g.u0, H, 0, g.nr, 1, g.nu,
                     v4, sb, first);
    } else {
      copy_rows<RED>(gfull, sH, 0, ghs, row * H, H, 0, g.nr, 1, H, v4, sb,
                     first);
      copy_rows<RED>(subs, sH, 0, hcell, row * H, H, 0, g.nr, 1, H, v4,
                     false, first);
    }
    if (MODE == 2)
      copy_rows<RED>(xb, sU, 0, m.aux, row * H + g.u0, H, 0, g.nr, 1, g.nu,
                     v4, sb, first);
    if (MODE == 3)
      copy_rows<RED>(xb, 3 * sU, sU, m.aux, row * 3 * H + g.u0, 3 * H, H,
                     g.nr, 3, g.nu, v4, sb, first);
    if (t > 0) {
      copy_rows<RED>(hprev, sH, 0, hs, (row - d.B) * H, H, 0, g.nr, 1, H, v4,
                     sb, first);
      if (MODE == 4)
        copy_rows<RED>(cfull, sH, 0, cs_in, (row - d.B) * H, H, 0, g.nr, 1,
                       H, v4, sb, first);
      else
        copy_rows<RED>(cprev, sU, 0, cs_in, (row - d.B) * H + g.u0, H, 0,
                       g.nr, 1, g.nu, v4, sb, first);
    } else {
      for (int i = tid; i < g.nr * sH; i += THREADS) hprev[i] = 0.f;
      for (int i = tid; i < g.nr * sU; i += THREADS) cprev[i] = 0.f;
      for (int i = tid; MODE == 4 && i < g.nr * sH; i += THREADS)
        cfull[i] = 0.f;
    }
  };
  prefetch(d.L - 1, 0);
  cp_async_wait_all();
  cluster.sync();
  // the step's items; the copies go to the threads after the back product's
  const int items = g.nu * (R / RPT), back_items = H * (R / RPT);
  const int idle = back_items % THREADS;
  const size_t K = (size_t)d.L * m.S * d.B;  // mode 1: the MLP streams' rows
  const int rank = (int)cluster.block_rank();
  for (int t = d.L - 1; t >= 0; --t) {
    const size_t ob = ((size_t)t * d.B + g.row0) * GH + g.u0;
    const float* pdl = pdh + ((t + 1) & 1) * tileH;  // zero at the last step
    const float* pcl = pdc + ((t + 1) & 1) * tileH;  // mode 4, likewise
    if (MODE == 1) {
      // the cotangent of the step's output, every unit: the partials of
      // the step after in rank order, and ghs; back through the evolve
      for (int i = tid; i < g.nr * H; i += THREADS) {
        const int r = i / H, k = i - r * H, p = r * sH + k;
        float s = cluster.map_shared_rank(pdl, 0)[p];
        for (int peer = 1; peer < cs; ++peer)
          s += cluster.map_shared_rank(pdl, peer)[p];
        dho[p] = s + gfull[p];
      }
      __syncthreads();
      const size_t dt = (size_t)t * d.B + g.row0;
      for (int sub = 0; sub + 1 < m.S; ++sub)
        mlp_substep<RED>(subs + sub * tileH, subs + (sub + 1) * tileH, sH,
                         dzt, dxt, sM, m, H, g.nr, dt, 1, pr.mm, pr.sb);
      for (int sub = m.S - 1; sub >= 0; --sub)
        mlp_back<RED>(dho, sH, subs + sub * tileH, A, tA, sHH, dzt, dxt, sM,
                      m, H, g.nr, dt, 1, acts, dzs,
                      ((size_t)t * m.S + sub) * d.B + g.row0, K, cs, rank,
                      pr.mm, pr.sb);
    }
    // recompute the own units' gates from (h, c) before the step; their
    // cotangents
    for (int item = tid; item < items; item += THREADS) {
      const int ul = item % g.nu, r0 = (item / g.nu) * RPT;
      float acc[4][RPT], accd[1][RPT];
      gate_sums<4, RPT, false, RED>(hprev, sH, H, w, ul, r0, acc, nullptr,
                                    pr.mm);
      if (MODE == 4)
        gate_sums<1, RPT, false, RED>(cfull, sH, H, wdl, ul, r0, accd,
                                      nullptr, pr.mm);
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const int r = r0 + q;
        if (r < g.nr) {
          const float* gr = gbuf + r * sD + ul;
          const float* bs = bias + ul;
          const int e = r * sU + ul;
          const size_t orow = (size_t)t * d.B + g.row0 + r;
          // a cluster of one reads its partial dh of the step after as it is
          float ghv =
              MODE == 1 ? dho[r * sH + g.u0 + ul]
                        : (cs == 1 ? pdl[r * sH + ul] : gh[e]) + gsel[e];
          if (MODE == 2) ghv += dhc[e];
          float gcv = gc[e];
          if (MODE == 4 && cs == 1) gcv += pcl[r * sH + ul];
          float d0, d1, d2, d3;
          if (MODE == 4) {
            const float c = cfull[r * sH + g.u0 + ul];
            const float csh = tanhf(accd[0][q] + bdo[ul]);
            const float tel = ld<RED>(m.aux, orow, pr.sb);
            const float cadj = c - csh + csh * tel;
            const float fg = sigmoid(gr[0] + acc[0][q] + bs[0]);
            const float ig = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
            const float og = sigmoid(gr[2 * sU] + acc[2][q] + bs[2 * sU]);
            const float ct = sigmoid(gr[3 * sU] + acc[3][q] + bs[3 * sU]);
            const float tc = tanhf(fg * cadj + ig * ct);
            const float dc = gcv + ghv * og * (1.f - tc * tc);
            d0 = dc * cadj * fg * (1.f - fg);
            d1 = dc * ct * ig * (1.f - ig);
            d2 = ghv * tc * og * (1.f - og);
            d3 = dc * ig * ct * (1.f - ct);
            const float dca = dc * fg;
            const float dz = dca * (tel - 1.f) * (1.f - csh * csh);
            gc[e] = dca;  // the partials of dzd W_d^T join it below
            dzd[e] = dz;
            dmode[orow * H + g.u0 + ul] = dz;
          } else {
            const float si = sigmoid(gr[0] + acc[0][q] + bs[0]);
            const float sf = sigmoid(gr[sU] + acc[1][q] + bs[sU]);
            const float gg = tanhf(gr[2 * sU] + acc[2][q] + bs[2 * sU]);
            const float so = sigmoid(gr[3 * sU] + acc[3][q] + bs[3 * sU]);
            const float* tr = xb + r * 3 * sU + ul;  // mode 3
            const float ig = MODE == 3 ? si * tr[0] : si;
            const float fg = MODE == 3 ? sf * tr[sU] : sf;
            const float og = MODE == 3 ? so * tr[2 * sU] : so;
            const float c = cprev[e];
            const float c2 = fg * c + ig * gg;
            const float tc = tanhf(c2);
            float dcc = 0.f;
            if (MODE == 2) {  // back through the blend
              const float sel = xb[e];
              st<RED>(dmode, orow * H + g.u0 + ul,
                      ghv * (og * tc - hprev[r * sH + g.u0 + ul]) +
                          gcv * (c2 - c),
                      pr.sb);
              dhc[e] = ghv * (1.f - sel);
              dcc = gcv * (1.f - sel);
              ghv *= sel;
              gcv *= sel;
            }
            const float dc = gcv + ghv * og * (1.f - tc * tc);
            if (MODE == 3) {  // the modifiers' cotangents, then the gates'
              const float di = dc * gg, df = dc * c, dov = ghv * tc;
              const size_t ot = orow * 3 * H + g.u0 + ul;
              st<RED>(dmode, ot, di * si, pr.sb);
              st<RED>(dmode, ot + H, df * sf, pr.sb);
              st<RED>(dmode, ot + 2 * H, dov * so, pr.sb);
              d0 = di * tr[0] * si * (1.f - si);
              d1 = df * tr[sU] * sf * (1.f - sf);
              d2 = dc * ig * (1.f - gg * gg);
              d3 = dov * tr[2 * sU] * so * (1.f - so);
            } else {
              d0 = dc * gg * ig * (1.f - ig);
              d1 = dc * c * fg * (1.f - fg);
              d2 = dc * ig * (1.f - gg * gg);
              d3 = ghv * tc * og * (1.f - og);
            }
            gc[e] = MODE == 2 ? dc * fg + dcc : dc * fg;
          }
          float* dgs = dg + r * sD + ul;
          dgs[0] = d0;
          dgs[sU] = d1;
          dgs[2 * sU] = d2;
          dgs[3 * sU] = d3;
          const size_t og = ob + (size_t)r * GH + ul;
          st<RED>(dgi, og, d0, pr.sb);
          st<RED>(dgi, og + H, d1, pr.sb);
          st<RED>(dgi, og + 2 * H, d2, pr.sb);
          st<RED>(dgi, og + 3 * H, d3, pr.sb);
          if (RED && dgw) {
            dgw[og] = d0;
            dgw[og + H] = d1;
            dgw[og + 2 * H] = d2;
            dgw[og + 3 * H] = d3;
          }
        }
      }
    }
    if (t == 0) break;
    __syncthreads();  // dg complete; this step's prefetched rows are read
    prefetch(t - 1, idle);
    // back through the own columns of W_hh (and of W_d): the partial dh
    // (and dc) of every unit
    float* pd = pdh + (t & 1) * tileH;
    float* pc = pdc + (t & 1) * tileH;
    for (int item = tid; item < back_items; item += THREADS) {
      const int k = item % H, r0 = (item / H) * RPT;
      float acc[RPT];
      back_sums<4, RPT, RED>(dg, sU, g.nu, w, k, r0, acc, pr.mm);
#pragma unroll
      for (int q = 0; q < RPT; ++q)
        if (r0 + q < g.nr) pd[(r0 + q) * sH + k] = acc[q];
      if (MODE == 4) {
        back_sums<1, RPT, RED>(dzd, sU, g.nu, wdl, k, r0, acc, pr.mm);
#pragma unroll
        for (int q = 0; q < RPT; ++q)
          if (r0 + q < g.nr) pc[(r0 + q) * sH + k] = acc[q];
      }
    }
    if (cs == 1) {
      cp_async_wait_all();
      __syncthreads();
      continue;
    }
    cluster.sync();
    // the own units' dh (and dc): the cluster's partials in rank order
    // (mode 1 sums every unit's at the top of the next step)
    for (int i = tid; MODE != 1 && i < g.nr * g.nu; i += THREADS) {
      const int r = i / g.nu, ul = i - r * g.nu, o = r * sH + g.u0 + ul;
      float s = cluster.map_shared_rank(pd, 0)[o];
      for (int peer = 1; peer < cs; ++peer)
        s += cluster.map_shared_rank(pd, peer)[o];
      gh[r * sU + ul] = s;
      if (MODE == 4) {
        float sc = cluster.map_shared_rank(pc, 0)[o];
        for (int peer = 1; peer < cs; ++peer)
          sc += cluster.map_shared_rank(pc, peer)[o];
        gc[r * sU + ul] += sc;
      }
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

// Splits of K rows of an [M, K] x [K, N] product: enough that the output
// tiles make about two CTAs an SM, each split at least WG_MIN_K rows of K.
inline int wgrad_splits_k(long long K, int M, int N) {
  const long long bm = wgrad_rows(M);
  const long long tiles = ((M + bm - 1) / bm) * ((N + WG_BN - 1) / WG_BN);
  long long s = (2LL * sm_count() + tiles - 1) / tiles;
  s = std::min(s, K / WG_MIN_K);
  return (int)std::max(s, 1LL);
}

// Splits of K = L B of a G-gate weight gradient
inline int wgrad_splits(int L, int B, int H, int G) {
  return wgrad_splits_k((long long)L * B, H, G * H);
}

// Split z's partials p[z] [H + 1][N]: row k < H holds the sum over its n of
// x[n][k] dg[n][c], row H the sum over its n of dg[n][c]; n < K runs over
// the rows of dg [K][N] (W_hh's gradient: K = L B over (step, row), N = G
// H). x[n] [H] is the cell's input state of the step: hs[n - B] for n >=
// B, h0[n] (zero without h0) for n < B, times hdec[n] with DEC (B = K and
// x = h0: any stream [K][H], as the evolve's layers give them). A reduced
// instance (RED) reads hs and h0 in the stream dtype (bf16 with pr.sb,
// widened as they are staged) and takes the product's operands, x (after
// the decay) and dg, in operand mode pr.mm; the bias sums stay exact.
template <int BM, bool DEC, bool RED>
__global__ void __launch_bounds__(THREADS)
rnn_wgrad_kernel(int K, int B, int H, int N, int kper,
                 const float* __restrict__ h0, const float* __restrict__ hs,
                 const float* __restrict__ hdec, const float* __restrict__ dg,
                 float* __restrict__ p, Prec pr) {
  constexpr int TM = BM / 16;  // rows of the thread's outputs
  __shared__ __align__(16) float xs[2][WG_BK][BM];
  __shared__ __align__(16) float ds[DEC ? 2 : 1][DEC ? WG_BK : 1][BM];
  __shared__ __align__(16) float ys[2][WG_BK][WG_BN];
  const int tid = threadIdx.x, tc = tid % 16, tm = tid / 16;
  const int c0 = blockIdx.x * WG_BN, m0 = blockIdx.y * BM;
  const int n0 = blockIdx.z * kper, n1 = min(K, n0 + kper);
  const bool xvec = (H & 3) == 0 && aligned16(hs) && (!h0 || aligned16(h0)) &&
                    (!hdec || aligned16(hdec));
  const bool yvec = (N & 3) == 0 && aligned16(dg);
  auto load = [&](int buf, int nb) {
    for (int q = tid; q < WG_BK * BM / 4; q += THREADS) {
      const int lr = q / (BM / 4), lc = (q % (BM / 4)) * 4;
      const int n = nb + lr, m = m0 + lc;
      if constexpr (RED) {  // synchronous, widened, zero past the ends
        const float* xb = n >= B ? hs : h0;
        const size_t xo = (size_t)(n >= B ? n - B : n) * H + m;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = n < n1 && m + j < H && xb;
          xs[buf][lr][lc + j] = ok ? ld_stream(xb, xo + j, pr.sb) : 0.f;
          if (DEC)
            ds[buf][lr][lc + j] = ok ? hdec[(size_t)n * H + m + j] : 0.f;
        }
        continue;
      }
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
          acc[i][j] = mad<RED>(av[i], lane(y, j), acc[i][j], pr.mm);
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

// The product over K rows of x [H] and dg [N] into the split partials p
// [splits][H + 1][N] (x as rnn_wgrad_kernel reads it), by the fp32
// instances or, in a reduced precision (pr not (0, 0)), the reduced ones
int rnn_wgrad_k(const float* h0, const float* hs, const float* hdec,
                const float* dg, float* p, int K, int B, int H, int N,
                cudaStream_t s, Prec pr = Prec{0, 0}) {
  if (K <= 0 || B <= 0 || H <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  const int S = wgrad_splits_k(K, H, N);
  const int kper = ((K + S - 1) / S + WG_BK - 1) / WG_BK * WG_BK;
  const int bm = wgrad_rows(H);
  const dim3 grid((N + WG_BN - 1) / WG_BN, (H + bm - 1) / bm, S);
  const bool red = pr.mm != MM_F32 || pr.sb;
  auto k = bm == 128 ? (hdec ? (red ? rnn_wgrad_kernel<128, true, true>
                                    : rnn_wgrad_kernel<128, true, false>)
                             : (red ? rnn_wgrad_kernel<128, false, true>
                                    : rnn_wgrad_kernel<128, false, false>))
                      : (hdec ? (red ? rnn_wgrad_kernel<64, true, true>
                                     : rnn_wgrad_kernel<64, true, false>)
                              : (red ? rnn_wgrad_kernel<64, false, true>
                                     : rnn_wgrad_kernel<64, false, false>));
  k<<<grid, THREADS, 0, s>>>(K, B, H, N, kper, h0, hs, hdec, dg, p, pr);
  return (int)cudaGetLastError();
}

int rnn_wgrad(const float* h0, const float* hs, const float* hdec,
              const float* dg, float* p, int L, int B, int H, int G,
              cudaStream_t s, Prec pr = Prec{0, 0}) {
  if (L <= 0) return (int)cudaErrorInvalidValue;
  return rnn_wgrad_k(h0, hs, hdec, dg, p, L * B, B, H, G * H, s, pr);
}

// The evolve's weight gradients: layer i's product over the K = L S B rows
// of its input stream [K][in_i] and output cotangent [K][out_i] (blocks of
// acts and dzs in layer order, fp32) into its split partials, each layer's
// block of p after the one before ([splits_i][in_i + 1][out_i]); products
// in operand mode mm
int mlp_wgrad(const float* acts, const float* dzs, float* p, int L, int B,
              int H, int HH, int n, int S, cudaStream_t s, int mm = MM_F32) {
  const long long K = (long long)L * S * B;
  if (K <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n; ++i) {
    const int iw = mlp_in(i, H, HH), ow = mlp_out(i, n, H, HH);
    const int err = rnn_wgrad_k(acts, acts, nullptr, dzs, p, (int)K, (int)K,
                                iw, ow, s, Prec{mm, 0});
    if (err) return err;
    p += (size_t)wgrad_splits_k(K, iw, ow) * (iw + 1) * ow;
    acts += K * iw;
    dzs += K * ow;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Launches: one instantiation per rows-per-thread and slice placement
// ---------------------------------------------------------------------------

struct GruFwdArgs {
  RnnDims d;
  const float *gi, *h0, *whh, *bhh, *hdec;
  float* hs;
  ModeArgs m;
  Prec pr;
};

struct GruBwdArgs {
  RnnDims d;
  const float *gi, *h0, *hs, *ghs, *whh, *bhh, *hdec;
  float *dgi, *dgh, *dh0, *dhdec;
  // modes 1-3 (gru_bwd_mode_kernel): null where the mode has none
  float *dhrow, *xin, *acts, *dzs;
  ModeArgs m;
  Prec pr;
};

struct LstmFwdArgs {
  RnnDims d;
  const float *gi, *whh, *bhh;
  float *hs, *cs, *hcell;
  ModeArgs m;
  Prec pr;
};

struct LstmBwdArgs {
  RnnDims d;
  const float *gi, *hs, *cs, *ghs, *whh, *bhh, *hcell;
  float *dgi, *acts, *dzs;
  ModeArgs m;
  float* dmode;  // dsel (mode 2), dtg (3) or dzd (4)
  float* dgw;    // a reduced precision's fp32 gate cotangents, or null
  Prec pr;
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

// Each launcher is a member template of its mode and precision (RED: the
// reduced instances): Fn<MODE, RED>::template At<RPT, WS>::run
template <int MODE, bool RED>
struct GruFwd {
  template <int RPT, int WS>
  struct At {
    static int run(const GruFwdArgs& a, const RnnPlan& p, cudaStream_t s,
                   int* active, bool go) {
      return launch_clusters(gru_fwd_kernel<RPT, WS, MODE, RED>, p, a.d.B, s,
                             active, go, a.d, p.cs, p.rows, a.gi, a.h0,
                             a.whh, a.bhh, a.hdec, a.hs, a.m, a.pr);
    }
  };
};

template <bool RED>
struct GruBwd {
  template <int RPT, int WS>
  struct At {
    static int run(const GruBwdArgs& a, const RnnPlan& p, cudaStream_t s,
                   int* active, bool go) {
      return launch_clusters(gru_bwd_kernel<RPT, WS, RED>, p, a.d.B, s,
                             active, go, a.d, p.cs, p.rows, a.gi, a.h0, a.hs,
                             a.ghs, a.whh, a.bhh, a.hdec, a.dgi, a.dgh, a.dh0,
                             a.dhdec, a.pr);
    }
  };
};

template <int MODE, bool RED>
struct GruBwdMode {
  template <int RPT, int WS>
  struct At {
    static int run(const GruBwdArgs& a, const RnnPlan& p, cudaStream_t s,
                   int* active, bool go) {
      return launch_clusters(gru_bwd_mode_kernel<RPT, WS, MODE, RED>, p,
                             a.d.B, s, active, go, a.d, p.cs, p.rows, a.gi,
                             a.h0, a.hs, a.ghs, a.whh, a.bhh, a.m, a.dgi,
                             a.dgh, a.dh0, a.dhrow, a.xin, a.acts, a.dzs,
                             a.pr);
    }
  };
};

template <int MODE, bool RED>
struct LstmFwd {
  template <int RPT, int WS>
  struct At {
    static int run(const LstmFwdArgs& a, const RnnPlan& p, cudaStream_t s,
                   int* active, bool go) {
      return launch_clusters(lstm_fwd_kernel<RPT, WS, MODE, RED>, p, a.d.B, s,
                             active, go, a.d, p.cs, p.rows, a.gi, a.whh,
                             a.bhh, a.hs, a.cs, a.m, a.hcell, a.pr);
    }
  };
};

template <int MODE, bool RED>
struct LstmBwd {
  template <int RPT, int WS>
  struct At {
    static int run(const LstmBwdArgs& a, const RnnPlan& p, cudaStream_t s,
                   int* active, bool go) {
      return launch_clusters(lstm_bwd_kernel<RPT, WS, MODE, RED>, p, a.d.B, s,
                             active, go, a.d, p.cs, p.rows, a.gi, a.hs, a.cs,
                             a.ghs, a.whh, a.bhh, a.dgi, a.m, a.hcell,
                             a.acts, a.dzs, a.dmode, a.dgw, a.pr);
    }
  };
};

// The plan of one launch of G gates in mode ms, then its kernel instance
// (rows per thread, and the slices in shared or device memory). A reduced
// instance takes one row a thread whatever the plan's rows per thread
// (the plan's work split, one item a row: a quarter of the instances to
// build; its products are not tuned yet).
template <template <int, int> class Fn, bool RED, class Args>
int rnn_launch(const Args& a, int G, int backward, const ModeShape& ms,
               cudaStream_t s, int* active, bool go) {
  if (a.d.L <= 0 || a.d.B <= 0 || a.d.H <= 0) return (int)cudaErrorInvalidValue;
  const RnnPlan p = rnn_plan(G, a.d.H, a.d.B, backward, ms);
  if (p.bytes == 0) return (int)cudaErrorInvalidValue;
  if constexpr (RED) {
    return p.w_smem ? Fn<1, 1>::run(a, p, s, active, go)
                    : Fn<1, 0>::run(a, p, s, active, go);
  } else {
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
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel instance of a mode: the plain modes (0) and the modes each
// pair takes (GRU 1-3, LSTM 1-4)
inline bool valid_mode(int G, const ModeShape& ms) {
  const bool ode = G == 3 ? ms.mode == 3 : ms.mode == 1;
  if (ms.mode < 0 || ms.mode > (G == 3 ? 3 : 4)) return false;
  return !ode || (ms.n >= 1 && ms.S >= 1 && (ms.n == 1 || ms.HH >= 1));
}

template <template <int, bool> class Fn, bool RED, class Args>
int gru_launch(const Args& a, int backward, const ModeShape& ms,
               cudaStream_t s, int* active, bool go) {
  if (!valid_mode(3, ms)) return (int)cudaErrorInvalidValue;
  switch (ms.mode) {
    case 0: return rnn_launch<Fn<0, RED>::template At, RED>(
        a, 3, backward, ms, s, active, go);
    case 1: return rnn_launch<Fn<1, RED>::template At, RED>(
        a, 3, backward, ms, s, active, go);
    case 2: return rnn_launch<Fn<2, RED>::template At, RED>(
        a, 3, backward, ms, s, active, go);
    case 3: return rnn_launch<Fn<3, RED>::template At, RED>(
        a, 3, backward, ms, s, active, go);
  }
  return (int)cudaErrorInvalidValue;
}

template <template <int, bool> class Fn, bool RED, class Args>
int lstm_launch(const Args& a, int backward, const ModeShape& ms,
                cudaStream_t s, int* active, bool go) {
  if (!valid_mode(4, ms)) return (int)cudaErrorInvalidValue;
  switch (ms.mode) {
    case 0: return rnn_launch<Fn<0, RED>::template At, RED>(
        a, 4, backward, ms, s, active, go);
    case 1: return rnn_launch<Fn<1, RED>::template At, RED>(
        a, 4, backward, ms, s, active, go);
    case 2: return rnn_launch<Fn<2, RED>::template At, RED>(
        a, 4, backward, ms, s, active, go);
    case 3: return rnn_launch<Fn<3, RED>::template At, RED>(
        a, 4, backward, ms, s, active, go);
    case 4: return rnn_launch<Fn<4, RED>::template At, RED>(
        a, 4, backward, ms, s, active, go);
  }
  return (int)cudaErrorInvalidValue;
}

// The GRU backward by mode: the plain kernel in mode 0, the mode kernel in
// 1-3
template <bool RED>
int gru_bwd_launch(const GruBwdArgs& a, const ModeShape& ms, cudaStream_t s,
                   int* active, bool go) {
  if (!valid_mode(3, ms)) return (int)cudaErrorInvalidValue;
  switch (ms.mode) {
    case 0: return rnn_launch<GruBwd<RED>::template At, RED>(a, 3, 1, ms, s,
                                                             active, go);
    case 1: return rnn_launch<GruBwdMode<1, RED>::template At, RED>(
        a, 3, 1, ms, s, active, go);
    case 2: return rnn_launch<GruBwdMode<2, RED>::template At, RED>(
        a, 3, 1, ms, s, active, go);
    case 3: return rnn_launch<GruBwdMode<3, RED>::template At, RED>(
        a, 3, 1, ms, s, active, go);
  }
  return (int)cudaErrorInvalidValue;
}

// A launch's precision: 0 for exact fp32 (the fp32 instances), 1 for a
// reduced one (the reduced instances), -1 for none the kernels take
inline int precision_of(const Prec& pr) {
  if (pr.mm < MM_F32 || pr.mm > MM_BF16 || (pr.sb != 0 && pr.sb != 1))
    return -1;
  return pr.mm != MM_F32 || pr.sb;
}

// One field of the plan of a launch with G gates at (H, B) in mode ms: 0
// CTAs per cluster, 1 batch rows per cluster, 2 the slices in shared
// memory (1) or device memory (0), 3 rows per thread, 4
// cudaOccupancyMaxActiveClusters (minus the CUDA error when the plan cannot
// be scheduled), 5 dynamic shared bytes per CTA.
int plan_field(int G, int H, int B, int backward, const ModeShape& ms,
               int field) {
  if (!valid_mode(G, ms)) return -(int)cudaErrorInvalidValue;
  const RnnPlan p = rnn_plan(G, H, B, backward, ms);
  switch (field) {
    case 0: return p.cs;
    case 1: return p.rows;
    case 2: return p.w_smem;
    case 3: return p.rpt;
    case 5: return (int)p.bytes;
  }
  int active = 0, err;
  const RnnDims d{1, B, H};
  const ModeArgs m{nullptr, nullptr, nullptr, nullptr, ms.HH, ms.n, ms.S};
  if (G == 3 && backward) {
    GruBwdArgs a = {};
    a.d = d;
    a.m = m;
    err = gru_bwd_launch<false>(a, ms, 0, &active, false);
  } else if (G == 3) {
    GruFwdArgs a = {};
    a.d = d;
    a.m = m;
    err = gru_launch<GruFwd, false>(a, 0, ms, 0, &active, false);
  } else if (backward) {
    LstmBwdArgs a = {};
    a.d = d;
    a.m = m;
    err = lstm_launch<LstmBwd, false>(a, 1, ms, 0, &active, false);
  } else {
    LstmFwdArgs a = {};
    a.d = d;
    a.m = m;
    err = lstm_launch<LstmFwd, false>(a, 0, ms, 0, &active, false);
  }
  return err ? -err : active;
}

}  // namespace

extern "C" {

// Every entry of a pair takes the launch's mode after its dimensions: the
// mode (0 the plain modes; GRU 1 obs, 2 obs + row decay, 3 obs + evolve;
// LSTM 1 evolve, 2 sel, 3 tg, 4 TLSTM) and the evolve's shape (HH, n
// layers, S substeps; 0 without it). The launches then take the precision
// (mm: the products' operand mode, MM_F32, MM_X3 or MM_BF16; sb: 1 for bf16
// streams): (0, 0) runs the fp32 instances, any other the reduced ones, in
// which the streams named at each entry are bf16 with sb.

int fused_gru_max_smem() { return max_optin_smem(); }
int fused_lstm_max_smem() { return max_optin_smem(); }

const char* fused_gru_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
const char* fused_lstm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Dynamic shared memory of one CTA of a launch, in bytes: the plan never
// exceeds the device's limit (the slices move to device memory instead; 0
// when nothing fits).
long long fused_gru_smem_bytes(int H, int B, int mode, int HH, int n, int S,
                               int backward) {
  return (long long)rnn_plan(3, H, B, backward, ModeShape{mode, HH, n, S})
      .bytes;
}
long long fused_lstm_smem_bytes(int H, int B, int mode, int HH, int n, int S,
                                int backward) {
  return (long long)rnn_plan(4, H, B, backward, ModeShape{mode, HH, n, S})
      .bytes;
}

// One field of the plan at (H, B) in a mode (plan_field)
int fused_gru_plan(int H, int B, int mode, int HH, int n, int S,
                   int backward, int field) {
  return plan_field(3, H, B, backward, ModeShape{mode, HH, n, S}, field);
}
int fused_lstm_plan(int H, int B, int mode, int HH, int n, int S,
                    int backward, int field) {
  return plan_field(4, H, B, backward, ModeShape{mode, HH, n, S}, field);
}

// Force the cluster size (0, 1, 2, 4 or 8) and rows a cluster (0, 8, 16 or
// 32) of every later GRU and LSTM plan; 0 restores the host's own choice.
// Nonzero for a value the kernels do not take.
int fused_gru_force_plan(int cs, int rows) {
  if ((cs & (cs - 1)) || cs < 0 || cs > 8 ||
      !(rows == 0 || rows == 8 || rows == 16 || rows == 32))
    return 1;
  g_force_cs = cs;
  g_force_rows = rows;
  return 0;
}
int fused_lstm_force_plan(int cs, int rows) {
  return fused_gru_force_plan(cs, rows);
}

// Splits of the weight-gradient product, the leading dimension of its
// partials [splits][H + 1][G H] (dW_hh's rows, then db_hh).
int fused_gru_wgrad_splits(int L, int B, int H) {
  return wgrad_splits(L, B, H, 3);
}
int fused_lstm_wgrad_splits(int L, int B, int H) {
  return wgrad_splits(L, B, H, 4);
}
// and of TLSTM's W_d gradient: [splits][H + 1][H]
int fused_lstm_wdgrad_splits(int L, int B, int H) {
  return wgrad_splits(L, B, H, 1);
}

// The GRU forward. hdec [L][B][H] (mode 0) may be null (no decay); obs
// [L][B] (modes 1-3; null in modes 2 and 3: every step observed), the
// decay row hrow [L][H] (mode 2), the evolve's packed mlp (ModeArgs) and
// substep sizes dts [L] (mode 3) are null where the mode has none. Streams
// in the stream dtype: gi and hs.
int fused_gru_fwd(const float* gi, const float* h0, const float* whh,
                  const float* bhh, const float* hdec, const float* obs,
                  const float* hrow, const float* mlp, const float* dts,
                  float* hs, int L, int B, int H, int mode, int HH, int n,
                  int S, int mm, int sb, void* stream) {
  const GruFwdArgs a{RnnDims{L, B, H}, gi, h0, whh, bhh, hdec, hs,
                     ModeArgs{obs, hrow, mlp, dts, HH, n, S}, Prec{mm, sb}};
  const ModeShape ms{mode, HH, n, S};
  switch (precision_of(a.pr)) {
    case 0: return gru_launch<GruFwd, false>(a, 0, ms, (cudaStream_t)stream,
                                             nullptr, true);
    case 1: return gru_launch<GruFwd, true>(a, 0, ms, (cudaStream_t)stream,
                                            nullptr, true);
  }
  return (int)cudaErrorInvalidValue;
}

// The reverse recurrence: dgi, W_hh's cotangent dgh, dh0 (the weight
// gradients are fused_gru_wgrad and fused_gru_mlpgrad); with hdec (mode 0)
// dhdec; the cell's input states xin [L][B][H] (modes 2, 3), dhrow's
// per-cluster partials [clusters][L][H] (mode 2) and the evolve layers'
// input and cotangent streams acts, dzs (mode 3). Null where the mode has
// none. Streams in the stream dtype: gi, h0, hs, ghs and dgi.
int fused_gru_bwd(const float* gi, const float* h0, const float* hs,
                  const float* ghs, const float* whh, const float* bhh,
                  const float* hdec, const float* obs, const float* hrow,
                  const float* mlp, const float* dts, float* dgi, float* dgh,
                  float* dh0, float* dhdec, float* dhrow, float* xin,
                  float* acts, float* dzs, int L, int B, int H, int mode,
                  int HH, int n, int S, int mm, int sb, void* stream) {
  const GruBwdArgs a{RnnDims{L, B, H}, gi, h0, hs, ghs, whh, bhh, hdec,
                     dgi, dgh, dh0, dhdec, dhrow, xin, acts, dzs,
                     ModeArgs{obs, hrow, mlp, dts, HH, n, S}, Prec{mm, sb}};
  const ModeShape ms{mode, HH, n, S};
  switch (precision_of(a.pr)) {
    case 0: return gru_bwd_launch<false>(a, ms, (cudaStream_t)stream,
                                         nullptr, true);
    case 1: return gru_bwd_launch<true>(a, ms, (cudaStream_t)stream, nullptr,
                                        true);
  }
  return (int)cudaErrorInvalidValue;
}

// Partials of (dW_hh, db_hh) [splits][H + 1][3H] from the cell's input
// states (h0, hs, hdec: null for no decay; h0 and hs in the stream dtype)
// and dgh (fp32)
int fused_gru_wgrad(const float* h0, const float* hs, const float* hdec,
                    const float* dgh, float* p, int L, int B, int H, int mm,
                    int sb, void* stream) {
  if (precision_of(Prec{mm, sb}) < 0) return (int)cudaErrorInvalidValue;
  return rnn_wgrad(h0, hs, hdec, dgh, p, L, B, H, 3, (cudaStream_t)stream,
                   Prec{mm, sb});
}

// The evolve's weight gradients from either pair's backward streams
// (mlp_wgrad, fp32): one product kernel, whose entries sit beside the
// GRU's; its products in operand mode mm
int fused_gru_mlpgrad(const float* acts, const float* dzs, float* p, int L,
                      int B, int H, int HH, int n, int S, int mm,
                      void* stream) {
  if (precision_of(Prec{mm, 0}) < 0) return (int)cudaErrorInvalidValue;
  return mlp_wgrad(acts, dzs, p, L, B, H, HH, n, S, (cudaStream_t)stream,
                   mm);
}
// Splits of one evolve layer's product over K rows, in_w -> out_w: its
// partials [splits][in_w + 1][out_w]
int fused_gru_mlp_splits(int K, int in_w, int out_w) {
  return wgrad_splits_k(K, in_w, out_w);
}

// The LSTM forward; the evolve of h' (mode 1) with its packed mlp and dts
// [L][B]; the mode's stream aux: sel [L][B][H] (mode 2), tg [L][B][3H]
// (3), tel [L][B] (4); TLSTM's W_d [H][H] and b_d [H] (4). Null where the
// mode has none. cs and hcell may be null (no backward will run); hcell,
// the cells' own h', is written in mode 1 only (in a reduced precision with
// bf16 streams, the cell's output at the rounded state). Streams in the
// stream dtype: gi, dts (mode 1), aux, hs and cs.
int fused_lstm_fwd(const float* gi, const float* whh, const float* bhh,
                   const float* mlp, const float* dts, const float* aux,
                   const float* wd, const float* bd, float* hs, float* cs,
                   float* hcell, int L, int B, int H, int mode, int HH, int n,
                   int S, int mm, int sb, void* stream) {
  const LstmFwdArgs a{RnnDims{L, B, H}, gi, whh, bhh, hs, cs, hcell,
                      ModeArgs{nullptr, nullptr, mlp, dts, HH, n, S, aux, wd,
                               bd},
                      Prec{mm, sb}};
  const ModeShape ms{mode, HH, n, S};
  switch (precision_of(a.pr)) {
    case 0: return lstm_launch<LstmFwd, false>(a, 0, ms, (cudaStream_t)stream,
                                               nullptr, true);
    case 1: return lstm_launch<LstmFwd, true>(a, 0, ms, (cudaStream_t)stream,
                                              nullptr, true);
  }
  return (int)cudaErrorInvalidValue;
}

// The reverse recurrence: dgi (the weight gradients are fused_lstm_wgrad,
// fused_lstm_wdgrad and fused_gru_mlpgrad), in mode 1 the evolve layers'
// streams, in modes 2-4 dmode: dsel [L][B][H], dtg [L][B][3H] or dzd
// [L][B][H]. The mode's inputs as the forward's. Streams in the stream
// dtype: gi, hs, cs, ghs, dts, aux, dgi, dsel and dtg (hcell, dzd fp32);
// dgw [L][B][4H], the gate cotangents in fp32 for W_hh's gradient, is
// written where it is not null (a reduced precision's).
int fused_lstm_bwd(const float* gi, const float* hs, const float* cs,
                   const float* hcell, const float* ghs, const float* whh,
                   const float* bhh, const float* mlp, const float* dts,
                   const float* aux, const float* wd, const float* bd,
                   float* dgi, float* acts, float* dzs, float* dmode,
                   float* dgw, int L, int B, int H, int mode, int HH, int n,
                   int S, int mm, int sb, void* stream) {
  const LstmBwdArgs a{RnnDims{L, B, H}, gi, hs, cs, ghs, whh, bhh, hcell,
                      dgi, acts, dzs,
                      ModeArgs{nullptr, nullptr, mlp, dts, HH, n, S, aux, wd,
                               bd},
                      dmode, dgw, Prec{mm, sb}};
  const ModeShape ms{mode, HH, n, S};
  switch (precision_of(a.pr)) {
    case 0: return lstm_launch<LstmBwd, false>(a, 1, ms, (cudaStream_t)stream,
                                               nullptr, true);
    case 1: return lstm_launch<LstmBwd, true>(a, 1, ms, (cudaStream_t)stream,
                                              nullptr, true);
  }
  return (int)cudaErrorInvalidValue;
}

// Partials of (dW_hh, db_hh) [splits][H + 1][4H] from hs (in the stream
// dtype) and the fp32 gate cotangents (the state before the first step is
// zero)
int fused_lstm_wgrad(const float* hs, const float* dgi, float* p, int L,
                     int B, int H, int mm, int sb, void* stream) {
  if (precision_of(Prec{mm, sb}) < 0) return (int)cudaErrorInvalidValue;
  return rnn_wgrad(nullptr, hs, nullptr, dgi, p, L, B, H, 4,
                   (cudaStream_t)stream, Prec{mm, sb});
}

// Partials of TLSTM's (dW_d, db_d) [splits][H + 1][H] from the cell states
// cs (in the stream dtype) and dzd (the product kernel with x_t = c_{t-1},
// zero before the first step)
int fused_lstm_wdgrad(const float* cs, const float* dzd, float* p, int L,
                      int B, int H, int mm, int sb, void* stream) {
  if (precision_of(Prec{mm, sb}) < 0) return (int)cudaErrorInvalidValue;
  return rnn_wgrad(nullptr, cs, nullptr, dzd, p, L, B, H, 1,
                   (cudaStream_t)stream, Prec{mm, sb});
}

}  // extern "C"
