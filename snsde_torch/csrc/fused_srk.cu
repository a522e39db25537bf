// Fused SRIW1 stochastic Runge–Kutta solve of a DiffusionField SDE:
// forward, backward recurrence and weight-gradient kernels for NVIDIA
// Hopper (sm_90a), plain C interface (loaded with ctypes by
// snsde_torch/kernels/fused_srk.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_srk.py:
//   forward  _fused_srk_forward (pallas_call at :295, body _fwd_kernel :215,
//            step _srk_step :158)
//   backward _fused_srk_backward (pallas_call at :527, body _bwd_kernel :317)
// for every drift mode ('embm', 'yy', 'xt': an instance each) and noise
// mode ('precomp', 'elem', 'net1', 'net2': an instance each), with or
// without mult_y and geometric, at every width: the modes of fused_em.cu.
//
// Rößler's SRIW1 tableau collapses to two drift MLP evaluations per step,
// f0 = f(t, y) and f1 = f(t + 3/4 dt, H0_1), and four elementwise diffusion
// evaluations g_i = tanh(sigmoid(theta) gk * [state]) at three stage times
// (gk0 at t, gk1 at t + dt/4 for stages 1 and 3, gk2 at t + dt):
//   H1_1 = y + dt/4 f0 + sqrt(dt)/2 g0      H1_2 = y + dt f0 - sqrt(dt) g0
//   H1_3 = y + dt/4 f0 + sqrt(dt) (-5 g0 + 3 g1 + g2/2)
//   H0_1 = y + 3/4 dt f0 + 3/2 (I10/dt) g0
//   y1   = y + dt (f0/3 + 2 f1/3) + sum_i coeff_i(dW, I10, dt) g_i
// with the 1/dt and 1/sqrt(dt) guarded so dt = 0 is an identity step. The
// per-stage control rows (xh0, a0 at t; xh1, a1 at t + 3/4 dt) and gk rows
// are precomputed outside the kernels, as for the EM kernels.
//
// What bounds it on the H100: not bytes or FLOPs. At the MuJoCo shape
// (B=1024, 49 steps, H=HH=32, one inner layer) the forward does ~0.6 GFLOP
// and moves ~32 MB, ~10 us of either. The limit is the chain of 49
// dependent steps, each two MLP evaluations of a few small products with
// barriers between them, over only 1024 independent rows. The first
// design (one 256-thread block per 8 rows, each output one FMA chain over
// scalar shared reads, the streams read inside the step, and in the
// backward every stage recomputed and five weight-gradient accumulators
// read-modified-written inside every step) is the one fused_em.cu retired;
// this one is fused_em.cu's, on its device code (sde_hopper.cuh):
// * A cluster of CS CTAs (CS in {1, 2, 4, 8}) of 512 threads runs the whole
//   loop for R batch rows. CTA j owns a block of each layer's output
//   columns and holds its column slice of Wy', each W_l and Wout; both
//   drift evaluations use the same slices. A layer's output row is pushed
//   into every CTA through distributed shared memory, one cluster barrier a
//   layer (a block barrier for a cluster of one).
// * The products are register tiles, each forward output one FMA chain in
//   ascending k (the plain versions' order, so a relu's input rounds as
//   theirs does). The stages are elementwise on the H columns a CTA owns:
//   f0's output phase goes on to the four diffusion stages and H0_1 there
//   and pushes its slice of H0_1, which f1's first layer needs whole; f1's
//   output phase updates y and pushes its slice.
// * The step's streams (the xh0, xh1, dW, I10 rows, the a0, a1 and gk0-2
//   rows, dt; in the backward also gys and the state before the step) are
//   copied with cp.async a step ahead.
// * Backward: a reverse recurrence running only the dependent chain of
//   step u (dz3 of f1 -> back through f1's Wout, W_l, Wy' -> the four
//   diffusion stages in reverse, g3, g2, g1, g0, elementwise -> dz3 of f0
//   -> back through f0's MLP -> the state's cotangent), the tableau's order
//   f1, g3, g2, g1, g0, f0 of the JAX _bwd_kernel. Beside it, 384 of the
//   CTA's 512 threads rebuild step u-1 from the saved trajectory (f0's
//   layers, H0_1, f1's layers) in the same phases, one barrier serving
//   both. The recurrence writes the activations of both evaluations, their
//   inner cotangents, dz3, H0_1 and the gk rows' cotangents as streams (dz1
//   is dxh0 / dxh1), and one weight-gradient kernel (wgrad_kernel,
//   sde_hopper.cuh) forms dWy', dW_l, dWout and the bias sums over
//   K = 2 M B rows (both evaluations), and the per-step column sums of a0,
//   a1 and gk0-2, after the loop. d theta is a per-CTA partial; the wrapper
//   sums every partial in a fixed order. No atomics: runs are
//   bit-reproducible.
// * The host plan (srk_plan, sde_plan's rule): level 0 the weight slices in
//   shared memory, level 1 the weights read from device memory; CS; R from
//   1 to 32; the least estimated time among the plans that can be placed
//   (a step counts two MLP evaluations); none placed: the launch is
//   refused.
// The noise nets ('net1', 'net2') make each diffusion evaluation one or
// two products on a stage state, so the stages stop being elementwise: in
// the forward, stage 0's net runs beside f0's first layers, stages 1 and
// 2's beside f1's, and stage 3's after f1 (its state needs g1 and g2),
// before the update of y; the forward writes the stage states (nst), the
// nets' outputs (nb) and hidden activations (nh) as streams. The backward
// reads them and reverses g3, g2, g1, g0 with the nets' back products, one
// phase each (two for net2) on all threads, between f1's chain and f0's;
// it writes the nets' output cotangents (dn, dz2), and the weight-gradient
// kernel forms dWn1, dWn2 and dbn2 over K = 4 M B rows (the four stages).
// Their instances run clusters of one CTA (sde_plan). These modes are a
// simple design, not yet made fast.
// On an H100 (PERF.md section 6) this took the backward (recurrence plus
// weight gradient) at the MuJoCo shape from 1.21 to 0.98 ms, and at the
// sepsis shape with H=HH=128 and 256 the forward from 3.5 and 87 ms to 1.6
// and 10.4, the backward from 46 and 224 to 5.4 and 40. The MuJoCo forward
// went from 0.30 to 0.35 ms: its six phases a step cost ~2 K cycles each
// in both designs, and the stream copies add the rest (without them, 0.30).
// Exact fp32 FMA on the CUDA cores (TF32 off).

#include "sde_hopper.cuh"

namespace {

// the SRIW1 y-update weights (snsde/ops/solve.py:_SRK_*)
constexpr float ALPHA0 = 1.f / 3.f, ALPHA1 = 2.f / 3.f;
__constant__ float BETA1[4] = {-1.f, 4.f / 3.f, 2.f / 3.f, 0.f};
__constant__ float BETA2[4] = {-1.f, 4.f / 3.f, -1.f / 3.f, 0.f};
__constant__ float BETA3[4] = {2.f, -4.f / 3.f, -2.f / 3.f, 0.f};
__constant__ float BETA4[4] = {-2.f, 5.f / 3.f, -2.f / 3.f, 1.f};

// The streams' copies: 16-byte where a block is contiguous, issued by the
// threads [T0, ET) that the products leave idle (the forward's upper half,
// the backward's recompute group), off the products' own threads. On an
// H100 at the MuJoCo shape this took the forward from 0.38-0.42 to
// 0.33-0.38 ms and the recurrence from 0.90-0.94 to 0.84-0.86 (16-byte
// copies alone cost the forward: 0.43-0.44); with no copies at all (a
// probe) the forward took 0.30.
constexpr bool FWD_VEC = true, BWD_VEC = true;
constexpr int FWD_COPY_T0 = ET / 2, BWD_COPY_T0 = CHAIN_THREADS;

struct Step {
  float dt, sq, rdt, rsq;  // dt, sqrt(dt), guarded 1/dt and 1/sqrt(dt)
};

__device__ __forceinline__ Step step_of(float dt) {
  Step k;
  k.dt = dt;
  k.sq = sqrtf(dt);
  k.rdt = dt > 0.f ? 1.f / fmaxf(dt, 1e-30f) : 0.f;
  k.rsq = dt > 0.f ? 1.f / fmaxf(k.sq, 1e-30f) : 0.f;
  return k;
}

// coeff_i of the y-update from (dW, I10)
__device__ __forceinline__ void srk_coeffs(float dw, float i10, const Step& k,
                                           float c[4]) {
  const float I11s = 0.5f * (dw * dw - k.dt) * k.rsq;  // I11 / sqrt(dt)
  const float I111r = (dw * dw * dw - 3.f * k.dt * dw) * (k.rdt / 6.f);
  const float I10r = i10 * k.rdt;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = BETA1[i] * dw + BETA2[i] * I11s + BETA3[i] * I10r +
           BETA4[i] * I111r;
}

// The four diffusion stages of one element, given y and f0: stage states
// st (y, H1_1, H1_2, H1_3), bases (the gk row, or elem of the state), raw
// diffusions graw, bounded g, and the second drift stage's state h01. The
// elementwise noise modes only ('precomp', 'elem').
struct Stages {
  float st[4], base[4], graw[4], g[4], h01;
};

__device__ __forceinline__ float noise_g(float state, float gk, float sth,
                                         bool mult_y) {
  return tanhf(sth * (mult_y ? gk * state : gk));
}

// the diffusion's base at a state: the row (gk) or elem of the state
template <int NZ>
__device__ __forceinline__ float pw_base(float state, float gk, int elem) {
  if constexpr (NZ == NZ_ELEM) return elem_base(elem, state);
  return gk;
}

template <int NZ>
__device__ __forceinline__ void noise_eval(Stages& s, int i, float state,
                                           float gk, float sth, bool mult_y,
                                           int elem) {
  const float b = pw_base<NZ>(state, gk, elem);
  s.st[i] = state;
  s.base[i] = b;
  s.graw[i] = mult_y ? b * state : b;
  s.g[i] = noise_g(state, b, sth, mult_y);
}

// H0_1, the state of f1
__device__ __forceinline__ float h01_of(float y, float f0, float g0,
                                        float i10, const Step& k) {
  return y + 0.75f * k.dt * f0 + 1.5f * (i10 * k.rdt) * g0;
}

// the states of stages 1-3 from y, f0 and the g's before them
__device__ __forceinline__ float stage1(float y, float f0, float g0,
                                        const Step& k) {
  return y + 0.25f * k.dt * f0 + 0.5f * k.sq * g0;
}
__device__ __forceinline__ float stage2(float y, float f0, float g0,
                                        const Step& k) {
  return y + k.dt * f0 - k.sq * g0;
}
__device__ __forceinline__ float stage3(float y, float f0, float g0,
                                        float g1, float g2, const Step& k) {
  return y + 0.25f * k.dt * f0 + k.sq * (-5.f * g0 + 3.f * g1 + 0.5f * g2);
}

template <int NZ>
__device__ __forceinline__ Stages srk_stages(float y, float f0, float gk0,
                                             float gk1, float gk2, float i10,
                                             float sth, const Step& k,
                                             bool mult_y, int elem) {
  Stages s;
  noise_eval<NZ>(s, 0, y, gk0, sth, mult_y, elem);
  noise_eval<NZ>(s, 1, stage1(y, f0, s.g[0], k), gk1, sth, mult_y, elem);
  noise_eval<NZ>(s, 2, stage2(y, f0, s.g[0], k), gk2, sth, mult_y, elem);
  noise_eval<NZ>(s, 3, stage3(y, f0, s.g[0], s.g[1], s.g[2], k), gk1, sth,
             mult_y, elem);
  s.h01 = h01_of(y, f0, s.g[0], i10, k);
  return s;
}

// Reverse one diffusion stage given the cotangent dg of its g: adds to the
// theta sum, sets q to the cotangent of its base (the gk row's, summed over
// rows later) and returns the cotangent of its state. gk: the stage's row
// ('precomp': its base).
template <int NZ>
__device__ __forceinline__ float noise_bwd(const Stages& s, int i, float dg,
                                           float gk, float sth, bool mult_y,
                                           int elem, float& th_acc,
                                           float& q) {
  const float g = s.g[i];
  const float dsg = dg * (1.f - g * g);
  th_acc = fmaf(dsg, s.graw[i], th_acc);
  const float dgraw = dsg * sth;
  if constexpr (NZ == NZ_PRE) {
    if (mult_y) {
      q = dgraw * s.st[i];
      return dgraw * gk;
    }
    q = dgraw;
    return 0.f;
  }
  float ds = 0.f;
  q = dgraw;
  if (mult_y) {
    q = dgraw * s.st[i];
    ds = dgraw * s.base[i];
  }
  return ds + q * elem_deriv(elem, s.st[i]);
}

// The tensors of a launch (a forward reads y0 and the streams and writes
// ys, and in the noise nets' modes nst, nb and nh; a backward reads the
// trajectory ys, gys and those streams too and writes the rest). The gk
// rows are the an1 rows in the nets' modes.
struct SrkArgs {
  const float *y0, *ys, *gys, *xh0, *xh1, *dw, *i10, *a0, *a1, *gk0, *gk1,
      *gk2, *dts, *theta, *wy, *wi, *bi, *wo, *bo, *wn1, *wn2, *bn2;
  float *ys_out, *nst, *nbs, *nhs, *dxh, *dy0, *hs, *es, *dz3, *q, *h01,
      *dn, *dz2, *p_th;
};

// The shared-memory layout of a CTA, offsets in floats (-1: not there):
// the weights (take_wts); H0_1 [R4][sH]. Forward: y [R4][sH]; the
// activations [2][R4][sHH] (ping-pong); f0 and the noise update
// sum_i coeff_i g_i, own columns [R4][U]. Backward: y [3][R4][sH] (y_t in
// slot (t + 3) % 3); the activations of two steps and both evaluations
// [2][2][NI+1][R4][sHH]; the inner cotangents [2][R4][sHH]; own-column
// tiles of f0's z3 (two steps), f1's z3, dz3, H0_1's cotangent and the
// state's [R4][U]; with CS > 1 the partials of the back products
// [NI+2][R4][sW]; the reduction's [ET / 32]. The streams of a step, slot
// by slot (forward 2, backward 3): xh0, xh1 [R4][UH], a0, a1 [UH], dW,
// I10 (backward: gys) [R4][U], gk0-2 [3][U], dt [4]. The noise nets'
// (clusters of one CTA): forward, the states of stages 1-3 [3][R4][sH],
// the nets' outputs [4][R4][U], (net2) hidden rows [4][R4][sH] and f1
// [R4][U]; backward, the cotangents of the nets' outputs [2][R4][U] and
// (net2) hidden layers [R4][U], a stage's direct state cotangent, the
// state's, f0's and g0-g2's running cotangents [R4][U] each.
struct SrkLayout {
  WtsAt w;
  long long y, h01, h, e, f0, sn, z30, z31, dz, dh, gbar, pd, nst, ngt, nht,
      f1, tq, tq1, tdir, tdy, tdf0, tdg, xh0, xh1, a0, a1, dw, i10, gy, gk,
      dt, red, total;
};

__host__ __device__ inline SrkLayout srk_layout(const SdeDims& d,
                                                const SdePlan& p, int bwd) {
  const SdeGeo g = sde_geo(d, p);
  const long long NI = d.NI, R4 = g.R4, NS = bwd ? 3 : 2;
  SrkLayout L;
  Take take;
  L.w = take_wts(take, d, p, g);
  L.f0 = L.sn = L.e = L.z30 = L.z31 = L.dz = L.dh = L.gbar = L.pd = L.gy =
      L.red = -1;
  L.nst = L.ngt = L.nht = L.f1 = L.tq = L.tq1 = L.tdir = L.tdy = L.tdf0 =
      L.tdg = -1;
  const bool net = net_noise(d.noise), net2 = d.noise == NZ_NET2;
  const long long ut = R4 * g.U;
  L.h01 = take(R4 * g.sH);
  if (!bwd) {
    L.y = take(R4 * g.sH);
    L.h = take(2 * R4 * g.sHH);
    L.f0 = take(R4 * g.U);
    L.sn = take(R4 * g.U);
    if (net) {
      L.nst = take(3 * R4 * g.sH);
      L.ngt = take(4 * ut);
      L.f1 = take(ut);
    }
    if (net2) L.nht = take(4 * R4 * g.sH);
  } else {
    L.y = take(3 * R4 * g.sH);
    L.h = take(4 * (NI + 1) * R4 * g.sHH);
    L.e = take(2 * R4 * g.sHH);
    L.z30 = take(2 * R4 * g.U);
    L.z31 = take(R4 * g.U);
    L.dz = take(R4 * g.U);
    L.dh = take(R4 * g.U);
    L.gbar = take(R4 * g.U);
    if (p.cs > 1) L.pd = take((NI + 2) * R4 * g.sW);
    if (net) {
      L.tq = take(2 * ut);
      L.tdir = take(ut);
      L.tdy = take(ut);
      L.tdf0 = take(ut);
      L.tdg = take(3 * ut);
    }
    if (net2) L.tq1 = take(ut);
    L.gy = take(NS * R4 * g.U);
    L.red = take(ET / 32);
  }
  L.xh0 = take(NS * R4 * g.UH);
  L.xh1 = take(NS * R4 * g.UH);
  L.a0 = take(NS * g.UH);
  L.a1 = take(NS * g.UH);
  L.dw = take(NS * R4 * g.U);
  L.i10 = take(NS * R4 * g.U);
  L.gk = take(NS * 3 * g.U);
  L.dt = take(NS * 4);
  L.total = take(0);
  return L;
}

// copy_rows (sde_hopper.cuh) issued by the threads [T0, ET) only. A copy,
// not a thread-range parameter of the shared function: on an H100 that
// parameter took the EM backward kernel from 128 registers to 64 with
// spills and its time up ~10%.
template <int T0>
__device__ __forceinline__ void copy_rows_by(float* dst, int ld,
                                             const float* src, size_t sr,
                                             int n, int nr, bool vec) {
  constexpr int NT = ET - T0;
  const int t = (int)threadIdx.x - T0;
  if (t < 0) return;
  if (vec && ld == n && sr == (size_t)n &&
      ((reinterpret_cast<size_t>(dst) | reinterpret_cast<size_t>(src)) &
       15) == 0) {
    const int total = nr * n, q = total >> 2;
    for (int i = t; i < q; i += NT) cp_async16(dst + 4 * i, src + 4 * i, 16);
    for (int i = 4 * q + t; i < total; i += NT) cp_async4(dst + i, src + i);
    return;
  }
  for (int i = t; i < nr * n; i += NT) {
    const int r = i / n, c = i - r * n;
    cp_async4(dst + r * ld + c, src + r * sr + c);
  }
}

// step t's streams, the CTA's rows and own columns, into slot b (the
// backward's also gys), at the kernel's copy width, by its copy threads
// (each stream by a warp of its own instead was slower on an H100: the
// MuJoCo forward 0.345-0.378 against 0.328-0.340 ms)
template <bool BWD, int DR, int NZ>
__device__ __forceinline__ void prefetch_step(const SrkArgs& A,
                                              const SdeDims& d,
                                              const SdeGeo& g, const Cta& c,
                                              const SrkLayout& L, float* s,
                                              int b, int t) {
  constexpr bool vec = BWD ? BWD_VEC : FWD_VEC;
  constexpr int T0 = BWD ? BWD_COPY_T0 : FWD_COPY_T0;
  const size_t rb = (size_t)t * d.B + c.row0;
  const int xt = g.R4 * g.UH, wt = g.R4 * g.U, nh = c.nh, nu = c.nu;
  if (DR != DR_YY) {
    const float* xh0 = A.xh0 + rb * d.HH + c.h0;
    const float* xh1 = A.xh1 + rb * d.HH + c.h0;
    copy_rows_by<T0>(s + L.xh0 + b * xt, nh, xh0, d.HH, nh, c.nr, vec);
    copy_rows_by<T0>(s + L.xh1 + b * xt, nh, xh1, d.HH, nh, c.nr, vec);
  }
  if (DR != DR_XT) {
    const size_t oa = (size_t)t * d.HH + c.h0;
    copy_rows_by<T0>(s + L.a0 + b * g.UH, nh, A.a0 + oa, nh, nh, 1, vec);
    copy_rows_by<T0>(s + L.a1 + b * g.UH, nh, A.a1 + oa, nh, nh, 1, vec);
  }
  const size_t ow = rb * d.H + c.u0;
  copy_rows_by<T0>(s + L.dw + b * wt, nu, A.dw + ow, d.H, nu, c.nr, vec);
  copy_rows_by<T0>(s + L.i10 + b * wt, nu, A.i10 + ow, d.H, nu, c.nr, vec);
  if (BWD)
    copy_rows_by<T0>(s + L.gy + b * wt, nu, A.gys + ow, d.H, nu, c.nr, vec);
  // the gk rows ('precomp'), or the forward's an1 rows (the nets)
  if (NZ == NZ_PRE || (net_noise(NZ) && !BWD)) {
    float* gk = s + L.gk + b * 3 * g.U;
    const size_t o = (size_t)t * d.H + c.u0;
    copy_rows_by<T0>(gk, nu, A.gk0 + o, nu, nu, 1, vec);
    copy_rows_by<T0>(gk + g.U, nu, A.gk1 + o, nu, nu, 1, vec);
    copy_rows_by<T0>(gk + 2 * g.U, nu, A.gk2 + o, nu, nu, 1, vec);
  }
  copy_rows_by<T0>(s + L.dt + 4 * b, 1, A.dts + t, 1, 1, 1, false);
}

// Y = X W (mm) for a product whose epilogue is long (the stages' tanh
// chains): one output a thread where the outputs fit the group's threads
// once, so the epilogues run side by side, else mm's register tiles.
template <class Epi>
__device__ __forceinline__ void mm_ep(Grp g, const float* X, int ldx, int K,
                                      const float* W, int ldw, bool gw,
                                      int nr, int N, Epi epi) {
  if (nr * N <= g.n)
    mm_tile<1, 1>(g, X, ldx, K, W, ldw, gw, nr, N, epi);
  else
    mm(g, X, ldx, K, W, ldw, gw, nr, N, epi);
}

// ---------------------------------------------------------------------------
// The forward kernel
// ---------------------------------------------------------------------------

// Each step: f0's NI + 2 phases (its first layer on y, its inner layers,
// its output with the stages and H0_1), then f1's (its first layer on
// H0_1, its inner layers, its output with the update of y). With a noise
// net (clusters of one CTA), stage 0's net runs beside f0's first layers,
// f0's output forms g0, H0_1 and the states of stages 1 and 2, whose nets
// run beside f1's first layers; f1's output is kept, and after it stage
// 3's state, its net and the update of y take two to three phases more.
template <bool GW, int DR, int NZ>
__global__ void __launch_bounds__(ET)
srk_fwd_kernel(SdeDims dd, SdePlan pp, SrkArgs A) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const SdeDims d = with_modes<DR, NZ>(dd);
  const SdePlan p = placed<GW>(pp);
  const SdeGeo g = sde_geo(d, p);
  const SrkLayout L = srk_layout(d, p, 0);
  zero_smem(s, L.total);
  __syncthreads();
  const Cta c = make_cta(d, p, g);
  const Wts w = load_wts(d, p, g, c, L.w, s,
                         WtsIn{A.wy, A.wi, A.bi, A.wo, A.bo, A.wn1, A.wn2,
                               A.bn2});
  const int H = d.H, HH = d.HH, NI = d.NI, sH = g.sH, sHH = g.sHH;
  const int U = g.U, UH = g.UH, R4 = g.R4, nr = c.nr, row0 = c.row0;
  const int h0 = c.h0, u0 = c.u0, cs = c.cs, nh = c.nh, nu = c.nu;
  const int htile = R4 * sHH, xtile = R4 * UH, wtile = R4 * U;
  float* y = s + L.y;
  float* h01 = s + L.h01;
  float* h = s + L.h;
  float* f0t = s + L.f0;
  float* snt = s + L.sn;
  float* nst = s + L.nst;  // the states of stages 1-3
  float* ngt = s + L.ngt;  // the nets' outputs, stages 0-3
  float* nht = s + L.nht;  // net2's hidden rows, stages 0-3
  float* f1t = s + L.f1;
  const size_t MBH = (size_t)d.M * d.B * H;
  const Grp all{0, ET};
  for (int i = threadIdx.x; i < nr * H; i += ET)
    y[(i / H) * sH + i % H] = A.y0[(size_t)row0 * H + i];
  if (d.M > 0) prefetch_step<false, DR, NZ>(A, d, g, c, L, s, 0, 0);
  cp_async_commit();
  cp_async_wait_all();
  // every CTA of the cluster is zeroed before a peer pushes into it
  cluster_or_block_sync(cs);
  const float sth = sigmoid(A.theta[0]);
  const bool mult_y = d.mult_y, geometric = d.geometric;

  for (int u = 0; u < d.M; ++u) {
    const int b = u & 1;
    if (u + 1 < d.M)
      prefetch_step<false, DR, NZ>(A, d, g, c, L, s, b ^ 1, u + 1);
    cp_async_commit();
    const Step k = step_of(s[L.dt + 4 * b]);
    const float* wu = s + L.dw + b * wtile;
    const float* iu = s + L.i10 + b * wtile;
    const float* gku = s + L.gk + b * 3 * U;
    const size_t ob = (size_t)u * d.B + row0;  // the step's first row
    // a noise net's first layer on stage i's state X (its an1 row: the
    // stage time's), and net2's second layer
    auto net_first = [&](int i, const float* X, const float* an) {
      mm(all, X, sH, H, w.wn1, w.lwn, GW, nr, nu,
         [&](int r, int n, float acc) {
           const float v = acc + an[n];
           if constexpr (NZ == NZ_NET1) {
             ngt[i * wtile + r * U + n] = v;
           } else {
             const float hv = fmaxf(v, 0.f);
             nht[i * R4 * sH + r * sH + u0 + n] = hv;
             A.nhs[i * MBH + (ob + r) * H + u0 + n] = hv;
           }
         });
    };
    auto net_second = [&](int i) {
      mm(all, nht + i * R4 * sH, sH, H, w.wn2, w.lwn, GW, nr, nu,
         [&](int r, int n, float acc) {
           ngt[i * wtile + r * U + n] = fmaxf(acc + w.bn2[n], 0.f);
         });
    };
    // g_i from its net's output at (r, n) and its state
    auto net_g = [&](int i, int ix, float state) {
      const float b0 = ngt[i * wtile + ix];
      return tanhf(sth * (mult_y ? b0 * state : b0));
    };
#pragma unroll
    for (int ev = 0; ev < 2; ++ev) {
      // h_0 = relu(state Wy' + a + xh) ('yy': without xh; 'xt': relu(xh)),
      // own columns, into every CTA
      const float* X = ev ? h01 : y;
      const float* au = s + (ev ? L.a1 : L.a0) + b * UH;
      const float* xu = s + (ev ? L.xh1 : L.xh0) + b * xtile;
      if constexpr (DR == DR_XT) {
        xt_first(all, xu, nr, nh, [&](int r, int n, float v) {
          push(cs, h, r * sHH + h0 + n, v);
        });
      } else {
        mm(all, X, sH, H, w.wy, w.lwy, GW, nr, nh,
           [&](int r, int n, float acc) {
             float v;
             if constexpr (DR == DR_EMBM)
               v = acc + au[n] + xu[r * nh + n];
             else
               v = acc + au[n];
             push(cs, h, r * sHH + h0 + n, fmaxf(v, 0.f));
           });
      }
      if constexpr (net_noise(NZ)) {
        if (ev == 0) {
          net_first(0, y, gku);
        } else {
          net_first(1, nst, gku + U);
          net_first(2, nst + R4 * sH, gku + 2 * U);
        }
      }
      cluster_or_block_sync(cs);
      if constexpr (NZ == NZ_NET2) {
        if (ev == 0) {
          net_second(0);
        } else {
          net_second(1);
          net_second(2);
        }
        if (NI == 0) __syncthreads();
      }
      for (int l = 0; l < NI; ++l) {
        const float* hin = h + (l & 1) * htile;
        float* hout = h + ((l + 1) & 1) * htile;
        const float* bl = w.bi + l * UH;
        mm(all, hin, sHH, HH, w.wi + (size_t)l * w.swi, w.lwi, GW, nr, nh,
           [&](int r, int n, float acc) {
             push(cs, hout, r * sHH + h0 + n, fmaxf(acc + bl[n], 0.f));
           });
        cluster_or_block_sync(cs);
      }
      const float* hl = h + (NI & 1) * htile;
      if (ev == 0 && net_noise(NZ)) {
        // f0, own columns; g0, H0_1 and the states of stages 1 and 2
        mm_ep(all, hl, sHH, HH, w.wo, w.lwo, GW, nr, nu,
              [&](int r, int n, float acc) {
                const int col = u0 + n, ix = r * U + n;
                const float yv = y[r * sH + col];
                float z3 = acc + w.bo[n];
                if (geometric) z3 *= tanhf(yv);
                const float f0 = tanhf(z3);
                const float g0 = net_g(0, ix, yv);
                const float s1 = stage1(yv, f0, g0, k);
                const float s2 = stage2(yv, f0, g0, k);
                f0t[ix] = f0;
                nst[r * sH + col] = s1;
                nst[R4 * sH + r * sH + col] = s2;
                push(cs, h01, r * sH + col,
                     h01_of(yv, f0, g0, iu[r * nu + n], k));
                const size_t o = (ob + r) * H + col;
                A.nst[o] = s1;
                A.nst[MBH + o] = s2;
              });
      } else if (ev == 0) {
        // f0, own columns; the four diffusion stages; H0_1 into every CTA
        mm_ep(all, hl, sHH, HH, w.wo, w.lwo, GW, nr, nu,
              [&](int r, int n, float acc) {
                const int col = u0 + n, ix = r * U + n;
                const float yv = y[r * sH + col];
                float z3 = acc + w.bo[n];
                if (geometric) z3 *= tanhf(yv);
                const float f0 = tanhf(z3);
                const float ii = iu[r * nu + n];
                const Stages st = srk_stages<NZ>(yv, f0, gku[n], gku[U + n],
                                             gku[2 * U + n], ii, sth, k,
                                             mult_y, d.elem);
                float cf[4];
                srk_coeffs(wu[r * nu + n], ii, k, cf);
                f0t[ix] = f0;
                snt[ix] = cf[0] * st.g[0] + cf[1] * st.g[1] +
                          cf[2] * st.g[2] + cf[3] * st.g[3];
                push(cs, h01, r * sH + col, st.h01);
              });
      } else if (net_noise(NZ)) {
        // f1, own columns, kept for the update after stage 3
        mm_ep(all, hl, sHH, HH, w.wo, w.lwo, GW, nr, nu,
              [&](int r, int n, float acc) {
                const int col = u0 + n;
                float z3 = acc + w.bo[n];
                if (geometric) z3 *= tanhf(h01[r * sH + col]);
                f1t[r * U + n] = tanhf(z3);
              });
        cp_async_wait_all();
      } else {
        // f1, own columns, and the step's update of y there, into every CTA
        mm_ep(all, hl, sHH, HH, w.wo, w.lwo, GW, nr, nu,
              [&](int r, int n, float acc) {
                const int col = u0 + n, ix = r * U + n;
                float z3 = acc + w.bo[n];
                if (geometric) z3 *= tanhf(h01[r * sH + col]);
                const float f1 = tanhf(z3);
                const float yn = y[r * sH + col] +
                                 k.dt * (ALPHA0 * f0t[ix] + ALPHA1 * f1) +
                                 snt[ix];
                push(cs, y, r * sH + col, yn);
                A.ys_out[((size_t)u * d.B + row0 + r) * H + col] = yn;
              });
        cp_async_wait_all();
      }
      cluster_or_block_sync(cs);
    }
    if constexpr (net_noise(NZ)) {
      // stage 3's state (g1 and g2 are in), its net, then the update of y
      for (int i = threadIdx.x; i < nr * nu; i += ET) {
        const int r = i / nu, n = i % nu, col = u0 + n, ix = r * U + n;
        const float yv = y[r * sH + col];
        const float s1 = nst[r * sH + col], s2 = nst[R4 * sH + r * sH + col];
        const float s3 = stage3(yv, f0t[ix], net_g(0, ix, yv),
                                net_g(1, ix, s1), net_g(2, ix, s2), k);
        nst[2 * R4 * sH + r * sH + col] = s3;
        A.nst[2 * MBH + (ob + r) * H + col] = s3;
      }
      __syncthreads();
      net_first(3, nst + 2 * R4 * sH, gku + U);
      __syncthreads();
      if constexpr (NZ == NZ_NET2) {
        net_second(3);
        __syncthreads();
      }
      for (int i = threadIdx.x; i < nr * nu; i += ET) {
        const int r = i / nu, n = i % nu, col = u0 + n, ix = r * U + n;
        const float yv = y[r * sH + col];
        float st[4] = {yv, nst[r * sH + col], nst[R4 * sH + r * sH + col],
                       nst[2 * R4 * sH + r * sH + col]};
        float cf[4];
        srk_coeffs(wu[r * nu + n], iu[r * nu + n], k, cf);
        float sn = 0.f;
        const size_t o = (ob + r) * H + col;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sn += cf[j] * net_g(j, ix, st[j]);
          A.nbs[j * MBH + o] = ngt[j * wtile + ix];
        }
        const float yn =
            yv + k.dt * (ALPHA0 * f0t[ix] + ALPHA1 * f1t[ix]) + sn;
        y[r * sH + col] = yn;
        A.ys_out[o] = yn;
      }
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// The backward recurrence
// ---------------------------------------------------------------------------

// Iteration u (from M down to 0) runs the chain of step u (u < M) beside
// the recompute of step u-1 (u >= 1), phase by phase: 2 (NI + 2) phases,
// one barrier each, then the tail. Phase ph = e (NI + 2) + q: the chain
// goes back through evaluation 1 - e (f1 first), q = 0 through Wout,
// 1 <= q <= NI through W_{NI-q}, q = NI + 1 through Wy'; the recompute
// forms evaluation e (f0 first) of step u-1: h_0 (q = 0), h_q
// (1 <= q <= NI), z3 (q = NI + 1; for f0 also H0_1). At the start of f0's
// chain (ph = NI + 2) step u's stages are reversed, elementwise; the tail
// ends the state's cotangent and forms f1's dz3 of step u-1. In drift
// mode 'xt' the chain's last phase of each evaluation has no product. With
// a noise net (clusters of one CTA), the stages' reverse at the start of
// f0's chain is a phase a stage (two for net2), all threads: each stage's
// pointwise part, then its net's back product, whose epilogue goes on to
// the stage before it; the stage values come from the forward's streams.
template <bool GW, int DR, int NZ>
__global__ void __launch_bounds__(ET)
srk_bwd_kernel(SdeDims dd, SdePlan pp, SrkArgs A) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const SdeDims d = with_modes<DR, NZ>(dd);
  const SdePlan p = placed<GW>(pp);
  const SdeGeo g = sde_geo(d, p);
  const SrkLayout L = srk_layout(d, p, 1);
  zero_smem(s, L.total);
  __syncthreads();
  const Cta c = make_cta(d, p, g);
  const Wts w = load_wts(d, p, g, c, L.w, s,
                         WtsIn{A.wy, A.wi, A.bi, A.wo, A.bo, A.wn1, A.wn2,
                               nullptr});
  const int H = d.H, HH = d.HH, NI = d.NI, M = d.M, B = d.B, P = NI + 2;
  const int sH = g.sH, sHH = g.sHH, sW = g.sW, U = g.U, UH = g.UH;
  const int R4 = g.R4, nr = c.nr, row0 = c.row0, h0 = c.h0, u0 = c.u0;
  const int nh = c.nh, nu = c.nu, cs = c.cs, tid = threadIdx.x;
  const int ytile = R4 * sH, htile = R4 * sHH, xtile = R4 * UH;
  const int wtile = R4 * U, ptile = R4 * sW;
  const size_t MB = (size_t)M * B, BH = (size_t)B * H, MBH = MB * H;
  float* yb = s + L.y;
  float* h01 = s + L.h01;
  float* hk = s + L.h;
  float* e = s + L.e;
  float* z30 = s + L.z30;
  float* z31 = s + L.z31;
  float* dz = s + L.dz;
  float* dh = s + L.dh;
  float* gbar = s + L.gbar;
  float* pd = s + L.pd;
  // y_t (t >= -1, y_{-1} = y0) lives in slot (t + 3) % 3, step t's streams
  // in slot t % 3; step t's activations of evaluation ev, layer l, in set
  // t & 1
  auto yslot = [&](int t) { return yb + ((t + 3) % 3) * ytile; };
  auto prefetch_y = [&](int t) {
    copy_rows_by<BWD_COPY_T0>(
        yslot(t), sH,
        (t < 0 ? A.y0 : A.ys + (size_t)t * BH) + (size_t)row0 * H, H, H, nr,
        BWD_VEC);
  };
  auto act = [&](int t, int ev, int l) {
    return hk + (((t & 1) * 2 + ev) * (NI + 1) + l) * htile;
  };
  // the cotangent of layer l's output of evaluation ev at batch row `row`
  // of a step (l = 0: dz1, the stream dxh)
  auto put_e = [&](int ev, int l, size_t row, int k, float v) {
    if (l == 0)
      A.dxh[((size_t)ev * MB + row) * HH + k] = v;
    else
      A.es[(((size_t)(l - 1) * 2 + ev) * MB + row) * HH + k] = v;
  };
  if (M > 0) {
    prefetch_step<true, DR, NZ>(A, d, g, c, L, s, (M - 1) % 3, M - 1);
    prefetch_y(M - 2);
  }
  cp_async_commit();
  cp_async_wait_all();
  cluster_or_block_sync(cs);
  const float sth = sigmoid(A.theta[0]);
  const bool mult_y = d.mult_y, geometric = d.geometric;
  float th_acc = 0.f;

  for (int u = M; u >= 0; --u) {
    const bool chain = u < M, rec = u >= 1;
    if (u >= 2) {
      prefetch_step<true, DR, NZ>(A, d, g, c, L, s, (u - 2) % 3, u - 2);
      prefetch_y(u - 3);
    }
    cp_async_commit();
    const Grp gc = rec ? Grp{0, CHAIN_THREADS} : Grp{0, ET};
    const Grp gr = chain ? Grp{CHAIN_THREADS, ET - CHAIN_THREADS}
                         : Grp{0, ET};
    const float* yu = yslot(u - 1);  // the state before step u
    const float* yv = yslot(u - 2);  // the state before step u-1
    const int su = u % 3, sv = (u + 2) % 3;  // step u's, step u-1's slots
    const size_t oc = (size_t)u * B + row0;       // step u's first row
    const size_t ov = (size_t)(u - 1) * B + row0;  // step u-1's

    for (int ph = 0; ph < 2 * P; ++ph) {
      const int ce = ph < P ? 1 : 0, re = 1 - ce, q = ph < P ? ph : ph - P;
      if (chain && ph > 0 && (q == 0 || cs > 1)) {
        if (q > 0) {
          // the chain's previous partial, summed over the cluster in rank
          // order, through its relu, into the own columns of e
          const int l = NI + 1 - q;
          const float* hm = act(u, ce, l);
          float* eo = e + ((q - 1) & 1) * htile;
          float* part = pd + (q - 1) * ptile;
          for (int i = tid; i < nr * nh; i += ET) {
            const int r = i / nh, k = h0 + i % nh, ix = r * sHH + k;
            const float v = peer_sum(cs, part, r * sW + k);
            const float ev = hm[ix] > 0.f ? v : 0.f;
            eo[ix] = ev;
            put_e(ce, l, oc + r, k, ev);
          }
        } else if constexpr (net_noise(NZ)) {
          // A noise net's stages of step u in reverse (clusters of one CTA,
          // all threads; the forward's stage states nst, outputs nb and
          // hidden rows nh read back): the incoming cotangents and stage 3's
          // pointwise part, then for each stage i = 3..0 its net's back
          // product(s), whose epilogue adds the stage's state cotangent to
          // those of y, f0 and the g's before it and runs stage i-1's
          // pointwise part (after stage 0: f0's output).
          const Grp all{0, ET};
          float* tq = s + L.tq;      // what a net's back product reads
          float* tq1 = s + L.tq1;    // net2's hidden cotangent
          float* tdir = s + L.tdir;  // a stage's state cotangent, direct
          float* tdy = s + L.tdy;    // the state's running cotangent
          float* tdf0 = s + L.tdf0;  // f0's
          float* tdg = s + L.tdg;    // g0's, g1's and g2's
          const int su = u % 3;
          const float* yu = yslot(u - 1);
          const float* wu = s + L.dw + su * wtile;
          const float* iu = s + L.i10 + su * wtile;
          const float* zu = z30 + (u & 1) * wtile;
          const Step k = step_of(s[L.dt + 4 * su]);
          const size_t oc = (size_t)u * B + row0;
          // stage i's pointwise reverse at (r, col) given dg: the theta
          // sum, the cotangent of its net's output (net2: of the second
          // layer's) into tq slot i & 1 and its stream, its state's
          // cotangent outside the net into tdir
          auto stage_pw = [&](int i, int r, int col, float dg) {
            const int ix = r * U + col;
            const size_t o = (oc + r) * H + col;
            const float st =
                i == 0 ? yu[r * sH + col] : A.nst[(i - 1) * MBH + o];
            const float base = A.nbs[i * MBH + o];
            const float graw = mult_y ? base * st : base;
            const float gg = tanhf(sth * graw);
            const float dsg = dg * (1.f - gg * gg);
            th_acc = fmaf(dsg, graw, th_acc);
            const float dgraw = dsg * sth;
            float dbase = dgraw, direct = 0.f;
            if (mult_y) {
              dbase = dgraw * st;
              direct = dgraw * base;
            }
            float v;
            if constexpr (NZ == NZ_NET1) {
              v = dbase;
              A.dn[i * MBH + o] = v;
            } else {
              v = base > 0.f ? dbase : 0.f;
              A.dz2[i * MBH + o] = v;
            }
            tq[(i & 1) * wtile + ix] = v;
            tdir[ix] = direct;
          };
          for (int i = tid; i < nr * nu; i += ET) {
            const int r = i / nu, n = i % nu, ix = r * U + n;
            const float dh01 = dh[ix], gb = gbar[ix], ii = iu[i];
            float cf[4];
            srk_coeffs(wu[i], ii, k, cf);
            // y's, f0's and g0-g2's cotangents from the update and H0_1
            tdy[ix] = gb + dh01;
            tdf0[ix] = gb * (ALPHA0 * k.dt) + 0.75f * k.dt * dh01;
            tdg[ix] = gb * cf[0] + 1.5f * (ii * k.rdt) * dh01;
            tdg[wtile + ix] = gb * cf[1];
            tdg[2 * wtile + ix] = gb * cf[2];
            stage_pw(3, r, n, gb * cf[3]);
          }
          __syncthreads();
      #pragma unroll 1
          for (int si = 3; si >= 0; --si) {
            const float* E = tq + (si & 1) * wtile;
            if constexpr (NZ == NZ_NET2) {
              mm_t(all, E, U, nu, w.wn2, w.lwn, GW, nr, H,
                   [&](int r, int kk, float acc) {
                     const size_t o = si * MBH + (oc + r) * H + kk;
                     const float v = A.nhs[o] > 0.f ? acc : 0.f;
                     tq1[r * U + kk] = v;
                     A.dn[o] = v;
                   });
              __syncthreads();
              E = tq1;
            }
            mm_t(all, E, U, nu, w.wn1, w.lwn, GW, nr, H,
                 [&](int r, int kk, float acc) {
                   const int ix = r * U + kk;
                   const float ds = acc + tdir[ix];
                   const float dy = tdy[ix] + ds;
                   tdy[ix] = dy;
                   // the stage's state: H1_3 = y + dt/4 f0 + sqrt(dt)
                   // (-5 g0 + 3 g1 + g2/2), H1_2 = y + dt f0 - sqrt(dt)
                   // g0, H1_1 = y + dt/4 f0 + sqrt(dt)/2 g0
                   if (si == 3) {
                     tdf0[ix] += 0.25f * k.dt * ds;
                     tdg[ix] -= 5.f * k.sq * ds;
                     tdg[wtile + ix] += 3.f * k.sq * ds;
                     tdg[2 * wtile + ix] += 0.5f * k.sq * ds;
                   } else if (si == 2) {
                     tdf0[ix] += k.dt * ds;
                     tdg[ix] -= k.sq * ds;
                   } else if (si == 1) {
                     tdf0[ix] += 0.25f * k.dt * ds;
                     tdg[ix] += 0.5f * k.sq * ds;
                   }
                   if (si > 0) {
                     stage_pw(si - 1, r, kk, tdg[(si - 1) * wtile + ix]);
                     return;
                   }
                   // f0's output
                   const float y = yu[r * sH + kk], z3l = zu[ix];
                   const float ty = tanhf(y);
                   const float f0 = tanhf(geometric ? z3l * ty : z3l);
                   const float dz3 = tdf0[ix] * (1.f - f0 * f0);
                   float dz3l = dz3, dyo = dy;
                   if (geometric) {
                     dz3l = dz3 * ty;
                     dyo += dz3 * z3l * (1.f - ty * ty);
                   }
                   dz[ix] = dz3l;
                   A.dz3[(oc + r) * H + kk] = dz3l;
                   gbar[ix] = dyo;
                 });
            __syncthreads();
          }
        } else {
          // step u's diffusion stages in reverse (g3, g2, g1, g0) given the
          // state's cotangent and H0_1's, then f0's output
          const float* wu = s + L.dw + su * wtile;
          const float* iu = s + L.i10 + su * wtile;
          const float* gku = s + L.gk + su * 3 * U;
          const float* zu = z30 + (u & 1) * wtile;
          const Step k = step_of(s[L.dt + 4 * su]);
          for (int i = tid; i < nr * nu; i += ET) {
            const int r = i / nu, n = i % nu, ix = r * U + n, col = u0 + n;
            float dh01 = dh[ix];
            if (cs > 1)
              dh01 += peer_sum(cs, pd + (NI + 1) * ptile, r * sW + col);
            const float gb = gbar[ix], y = yu[r * sH + col], z3l = zu[ix];
            const float ty = tanhf(y);
            const float f0 = tanhf(geometric ? z3l * ty : z3l);
            const float g_0 = gku[n], g_1 = gku[U + n], g_2 = gku[2 * U + n];
            const float ii = iu[i];
            const Stages st = srk_stages<NZ>(y, f0, g_0, g_1, g_2, ii, sth, k,
                                         mult_y, d.elem);
            float cf[4];
            srk_coeffs(wu[i], ii, k, cf);
            float df0 = gb * (ALPHA0 * k.dt);
            float dg[4] = {gb * cf[0], gb * cf[1], gb * cf[2], gb * cf[3]};
            float dy = gb;
            // stage f1: H0_1 = y + 3/4 dt f0 + 3/2 (I10/dt) g0
            dy += dh01;
            df0 += 0.75f * k.dt * dh01;
            dg[0] += 1.5f * (ii * k.rdt) * dh01;
            float q0, q1, q2, q3;
            // stage g3: H1_3 = y + dt/4 f0 + sqrt(dt) (-5 g0 + 3 g1 + g2/2)
            float ds =
                noise_bwd<NZ>(st, 3, dg[3], g_1, sth, mult_y, d.elem, th_acc, q3);
            dy += ds;
            df0 += 0.25f * k.dt * ds;
            dg[0] -= 5.f * k.sq * ds;
            dg[1] += 3.f * k.sq * ds;
            dg[2] += 0.5f * k.sq * ds;
            // stage g2: H1_2 = y + dt f0 - sqrt(dt) g0
            ds = noise_bwd<NZ>(st, 2, dg[2], g_2, sth, mult_y, d.elem, th_acc, q2);
            dy += ds;
            df0 += k.dt * ds;
            dg[0] -= k.sq * ds;
            // stage g1: H1_1 = y + dt/4 f0 + sqrt(dt)/2 g0
            ds = noise_bwd<NZ>(st, 1, dg[1], g_1, sth, mult_y, d.elem, th_acc, q1);
            dy += ds;
            df0 += 0.25f * k.dt * ds;
            dg[0] += 0.5f * k.sq * ds;
            // stage g0 (state y)
            dy +=
                noise_bwd<NZ>(st, 0, dg[0], g_0, sth, mult_y, d.elem, th_acc, q0);
            // f0's output
            const float dz3 = df0 * (1.f - f0 * f0);
            float dz3l = dz3;
            if (geometric) {
              dz3l = dz3 * ty;
              dy += dz3 * z3l * (1.f - ty * ty);
            }
            dz[ix] = dz3l;
            const size_t o = (oc + r) * H + col;
            A.dz3[o] = dz3l;
            if constexpr (NZ == NZ_PRE) {
              A.q[o] = q0;
              A.q[MBH + o] = q3 + q1;
              A.q[2 * MBH + o] = q2;
            }
            gbar[ix] = dy;
          }
        }
        __syncthreads();
      }
      if (chain) {
        // the chain's product of this phase
        if (q < NI + 1) {
          const int l = NI - q;  // the cotangent formed: of h_l's input
          const float* E = q == 0 ? dz : e + ((q - 1) & 1) * htile + h0;
          const int lde = q == 0 ? U : sHH, Nc = q == 0 ? nu : nh;
          const float* W = q == 0 ? w.wo : w.wi + (size_t)l * w.swi;
          const int ldw = q == 0 ? w.lwo : w.lwi;
          if (cs == 1) {
            const float* hm = act(u, ce, l);
            float* eo = e + (q & 1) * htile;
            mm_t(gc, E, lde, Nc, W, ldw, GW, nr, HH,
                 [&](int r, int k, float acc) {
                   const int ix = r * sHH + k;
                   const float ev = hm[ix] > 0.f ? acc : 0.f;
                   eo[ix] = ev;
                   put_e(ce, l, oc + r, k, ev);
                 });
          } else {
            float* part = pd + q * ptile;
            mm_t(gc, E, lde, Nc, W, ldw, GW, nr, HH,
                 [&](int r, int k, float acc) { part[r * sW + k] = acc; });
          }
        } else if (DR != DR_XT) {
          // dz1 Wy'^T (own columns): f1's into H0_1's cotangent, f0's into
          // the state's
          const float* E = e + (NI & 1) * htile + h0;
          if (cs == 1) {
            float* to = ce ? dh : gbar;
            mm_t(gc, E, sHH, nh, w.wy, w.lwy, GW, nr, H,
                 [&](int r, int k, float acc) { to[r * U + k] += acc; });
          } else {
            float* part = pd + (NI + 1) * ptile;
            mm_t(gc, E, sHH, nh, w.wy, w.lwy, GW, nr, H,
                 [&](int r, int k, float acc) { part[r * sW + k] = acc; });
          }
        }
      }
      if (rec) {
        // the recompute's product of this phase (step u-1, evaluation re)
        const size_t lay = (size_t)MB * HH;  // one layer of one evaluation
        if (q == 0) {
          const float* X = re ? h01 : yv;
          const float* au = s + (re ? L.a1 : L.a0) + sv * UH;
          const float* xu = s + (re ? L.xh1 : L.xh0) + sv * xtile;
          float* ho = act(u - 1, re, 0);
          float* hso = A.hs + re * lay;
          if constexpr (DR == DR_XT) {
            xt_first(gr, xu, nr, nh, [&](int r, int n, float v) {
              push(cs, ho, r * sHH + h0 + n, v);
              hso[(ov + r) * HH + h0 + n] = v;
            });
          } else {
            mm(gr, X, sH, H, w.wy, w.lwy, GW, nr, nh,
               [&](int r, int n, float acc) {
                 float v;
                 if constexpr (DR == DR_EMBM)
                   v = fmaxf(acc + au[n] + xu[r * nh + n], 0.f);
                 else
                   v = fmaxf(acc + au[n], 0.f);
                 push(cs, ho, r * sHH + h0 + n, v);
                 hso[(ov + r) * HH + h0 + n] = v;
               });
          }
        } else if (q <= NI) {
          const float* bl = w.bi + (q - 1) * UH;
          float* ho = act(u - 1, re, q);
          float* hso = A.hs + ((size_t)q * 2 + re) * lay;
          mm(gr, act(u - 1, re, q - 1), sHH, HH,
             w.wi + (size_t)(q - 1) * w.swi, w.lwi, GW, nr, nh,
             [&](int r, int n, float acc) {
               const float v = fmaxf(acc + bl[n], 0.f);
               push(cs, ho, r * sHH + h0 + n, v);
               hso[(ov + r) * HH + h0 + n] = v;
             });
        } else if (re == 0) {
          // f0's z3, then H0_1 into every CTA
          const float* iv = s + L.i10 + sv * wtile;
          const float* gkv = s + L.gk + sv * 3 * U;
          const Step k = step_of(s[L.dt + 4 * sv]);
          float* zo = z30 + ((u - 1) & 1) * wtile;
          mm_ep(gr, act(u - 1, 0, NI), sHH, HH, w.wo, w.lwo, GW, nr, nu,
                [&](int r, int n, float acc) {
                  const int col = u0 + n;
                  const float z3l = acc + w.bo[n];
                  zo[r * U + n] = z3l;
                  const float y = yv[r * sH + col];
                  const float f0 = tanhf(geometric ? z3l * tanhf(y) : z3l);
                  float b0;  // stage 0's base
                  if constexpr (net_noise(NZ))
                    b0 = A.nbs[(ov + r) * H + col];
                  else
                    b0 = pw_base<NZ>(y, gkv[n], d.elem);
                  const float v = h01_of(y, f0, noise_g(y, b0, sth, mult_y),
                                         iv[r * nu + n], k);
                  push(cs, h01, r * sH + col, v);
                  A.h01[(ov + r) * H + col] = v;
                });
        } else {
          mm(gr, act(u - 1, 1, NI), sHH, HH, w.wo, w.lwo, GW, nr, nu,
             [&](int r, int n, float acc) { z31[r * U + n] = acc + w.bo[n]; });
        }
      }
      cluster_or_block_sync(cs);
    }

    // the state's cotangent (CS > 1: f0's last partial summed), then step
    // u-1's f1 output: back through f1 = tanh(z3 (* tanh(H0_1)))
    const float* gyv = s + L.gy + sv * wtile;
    const float dtv = rec ? s[L.dt + 4 * sv] : 0.f;
    for (int i = tid; i < nr * nu; i += ET) {
      const int r = i / nu, n = i % nu, ix = r * U + n, col = u0 + n;
      float gv = gbar[ix];
      if (cs > 1 && chain)
        gv += peer_sum(cs, pd + (NI + 1) * ptile, r * sW + col);
      if (rec) {
        gv += gyv[i];
        const float z3l = z31[ix], th = tanhf(h01[r * sH + col]);
        const float f1 = tanhf(geometric ? z3l * th : z3l);
        const float dz3 = gv * (ALPHA1 * dtv) * (1.f - f1 * f1);
        const float dz3l = geometric ? dz3 * th : dz3;
        dz[ix] = dz3l;
        dh[ix] = geometric ? dz3 * z3l * (1.f - th * th) : 0.f;
        A.dz3[MBH + (ov + r) * H + col] = dz3l;
      }
      gbar[ix] = gv;
    }
    cp_async_wait_all();
    __syncthreads();
  }

  for (int i = tid; i < nr * nu; i += ET) {
    const int r = i / nu, n = i % nu;
    A.dy0[(size_t)(row0 + r) * H + u0 + n] = gbar[r * U + n];
  }
  // d theta: the CTA's sum through sigmoid'
  const float t = cta_sum(th_acc, s + L.red);
  if (tid == 0) A.p_th[blockIdx.x] = t * sth * (1.f - sth);
  // no CTA leaves while a peer may still read its shared memory
  cluster_or_block_sync(cs);
}

// ---------------------------------------------------------------------------
// The host plan and the launches
// ---------------------------------------------------------------------------

// The instance of a launch: the level's (a compile-time fact: the main
// paths' level 0 reads the weight slices from shared memory) and the drift
// and noise modes'
using SrkKernel = decltype(&srk_fwd_kernel<false, DR_EMBM, NZ_PRE>);

inline SrkKernel srk_kernel(const SdeDims& d, int backward, int level) {
  static const SrkKernel k[2][2][SDE_DRIFTS][SDE_NOISES] = {
      SDE_INSTANCES(srk_fwd_kernel), SDE_INSTANCES(srk_bwd_kernel)};
  return k[backward ? 1 : 0][level ? 1 : 0][d.drift][d.noise];
}

// cudaOccupancyMaxActiveClusters of plan q's kernel (0 when it cannot be
// scheduled)
inline int plan_active(const SdeDims& d, const SdePlan& q, int backward) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  const int e = cluster_config(srk_kernel(d, backward, q.level), q.cs,
                               0, q.bytes, 0, cfg, attr, &n);
  return e ? 0 : n;
}

// The plan of a launch (sde_plan): a step is two MLP evaluations, their
// 2 (NI + 2) phases (and, in the backward, the stages' and the tail's), a
// cluster barrier each, and four diffusion evaluations (a noise net's
// stages: four phases more in the forward, four or eight in the backward).
inline SdePlan srk_plan(const SdeDims& d, int backward) {
  const int P = d.NI + 2;
  const int net = noise_jobs(d);
  const int extra = net ? (backward ? 4 * net : 2 + net) : 0;
  return sde_plan(
      d, backward, StepShape{2, 2 * P + 2 * backward + extra, 2 * P, 4},
      [&](const SdePlan& q) { return srk_layout(d, q, backward).total; },
      [&](const SdePlan& q) { return plan_active(d, q, backward); });
}

inline bool srk_valid(const SdeDims& d) {
  return sde_valid(d) && sde_modes_valid(d.drift, d.noise, d.elem);
}

// One launch (or, without `go`, its plan's check)
int run(const SdeDims& d, const SrkArgs& A, int backward, cudaStream_t s,
        int* active, bool go) {
  if (!srk_valid(d)) return (int)cudaErrorInvalidValue;
  const SdePlan p = srk_plan(d, backward);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  return launch_clusters(srk_kernel(d, backward, p.level), p.cs,
                         sde_ctas(d, p), p.bytes, s, active, go, d, p, A);
}

// The weight gradient over K = 2 M B rows, both evaluations: Wy' over the
// states each first layer read (y0, ys, then H0_1) and dz1 (dxh0 then
// dxh1; not in drift mode 'xt'), each W_l and Wout over the activations and
// cotangents; the per-step column sums of dz1 (da0, da1; not in 'xt') and
// of the gk rows' cotangents (dgk0, dgk1, dgk2; 'precomp'). A noise net's
// over K = 4 M B rows, the four stages, in a second launch: Wn1 over the
// stage states (y0, ys, then nst) and dn, Wn2 over nh and dz2, and the
// column sums of dn by stage and step (dgk [4][M][H]: the an1 rows'
// cotangents, stages 1 and 3 summed by the wrapper).
int run_wgrad(const SdeDims& d, const float* y0, const float* ys,
              const float* h01, const float* dxh, const float* hs,
              const float* es, const float* dz3, const float* q,
              const float* nst, const float* dn, const float* nh,
              const float* dz2, float* p, float* da, float* dgk,
              cudaStream_t s) {
  if (!srk_valid(d)) return (int)cudaErrorInvalidValue;
  const long long MB = (long long)d.M * d.B, K = 2 * MB;
  const WgPlan wp = wg_plan(d, K);
  std::vector<WgJob> jobs;
  const long long off = wg_jobs(d, wp, K, y0, ys, h01, d.B, (int)MB, dxh, hs,
                                es, dz3, p, jobs);
  WgSum sums[WG_MAX_SUMS];
  int ns = 0;
  if (d.drift != DR_XT) sums[ns++] = WgSum{dxh, da, d.HH, 2 * d.M};
  if (d.noise == NZ_PRE) sums[ns++] = WgSum{q, dgk, d.H, 3 * d.M};
  int err = run_wgrad_jobs(jobs, sums, ns, K, d.B, wp, s);
  if (err || !net_noise(d.noise)) return err;
  std::vector<WgJob> njobs;
  wg_noise_jobs(d, wp, y0, ys, nst, d.B, (int)MB, dn, nh, dz2, p + off,
                njobs);
  const WgSum nsum{dn, dgk, d.H, 4 * d.M};
  return run_wgrad_jobs(njobs, &nsum, 1, 4 * MB, d.B, wp, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a launch, in bytes, at its plan
// (above the device's limit when no plan fits).
long long fused_srk_smem_bytes(int B, int H, int HH, int n_inner, int drift,
                               int noise, int backward) {
  if (!sde_modes_valid(drift, noise, 7)) return -1;
  return srk_plan(SdeDims{1, B, H, HH, n_inner, 0, 0, drift, noise, 0},
                  backward)
      .bytes;
}

// One field of a launch's plan: 0 the level, 1 batch rows a cluster, 2
// CTAs a cluster, 3 cudaOccupancyMaxActiveClusters (minus the CUDA error
// when the plan cannot be scheduled), 4 shared bytes a CTA.
int fused_srk_plan(int B, int H, int HH, int n_inner, int drift, int noise,
                   int backward, int field) {
  if (!sde_modes_valid(drift, noise, 7)) return -(int)cudaErrorInvalidValue;
  const SdeDims d{1, B, H, HH, n_inner, 0, 0, drift, noise, 9};
  const SdePlan p = srk_plan(d, backward);
  switch (field) {
    case 0: return p.level;
    case 1: return p.R;
    case 2: return p.cs;
    case 4: return (int)p.bytes;
  }
  int active = 0;
  const int err = run(d, SrkArgs{}, backward, 0, &active, false);
  return err ? -err : active;
}

// The splits of the weight gradient's K at (M, B, H, HH, n_inner) in the
// modes (the leading dimension of its partials).
int fused_srk_wgrad_splits(int M, int B, int H, int HH, int n_inner,
                           int drift, int noise) {
  return wg_plan(SdeDims{M, B, H, HH, n_inner, 0, 0, drift, noise, 0},
                 2LL * M * B).S;
}

// Make later launches take level `first` or a later one (0: the host's
// own choice). For tests of each level.
int fused_srk_force_placement(int first) { return force_level(first); }

// Make later launches take clusters of cs CTAs and `rows` batch rows a
// cluster, a power of 2 up to 32 (0: the host's own choice of each). For
// tests of each plan.
int fused_srk_force_plan(int cs, int rows) { return force_plan(cs, rows); }

int fused_srk_max_smem() { return max_optin_smem(); }

const char* fused_srk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The forward: ys, and in the noise nets' modes the states of stages 1-3
// nst [3][M][B][H], the nets' outputs nb [4][M][B][H] and (net2) hidden
// activations nh [4][M][B][H]. A tensor a mode does not take is null: xh0
// and xh1 in 'yy'; a0, a1 and wy in 'xt'; the gk rows in 'elem' (the an1
// rows in the nets); wn1 (wn2, bn2) outside the nets (net1).
int fused_srk_fwd(const float* y0, const float* xh0, const float* xh1,
                  const float* dw, const float* i10, const float* a0,
                  const float* a1, const float* gk0, const float* gk1,
                  const float* gk2, const float* dts, const float* theta,
                  const float* wy, const float* wi, const float* bi,
                  const float* wo, const float* bo, const float* wn1,
                  const float* wn2, const float* bn2, float* ys, float* nst,
                  float* nb, float* nh, int M, int B, int H, int HH,
                  int n_inner, int mult_y, int geometric, int drift,
                  int noise, int elem, void* stream) {
  SrkArgs A{};
  A.y0 = y0; A.xh0 = xh0; A.xh1 = xh1; A.dw = dw; A.i10 = i10; A.a0 = a0;
  A.a1 = a1; A.gk0 = gk0; A.gk1 = gk1; A.gk2 = gk2; A.dts = dts;
  A.theta = theta; A.wy = wy; A.wi = wi; A.bi = bi; A.wo = wo; A.bo = bo;
  A.wn1 = wn1; A.wn2 = wn2; A.bn2 = bn2;
  A.ys_out = ys; A.nst = nst; A.nbs = nb; A.nhs = nh;
  return run(SdeDims{M, B, H, HH, n_inner, mult_y, geometric, drift, noise,
                     elem},
             A, 0, (cudaStream_t)stream, nullptr, true);
}

// The reverse recurrence: dy0, the per-CTA partials of d theta ([ctas]),
// and the streams of the weight gradient: dxh [2][M][B][HH] (dz1 of f0,
// then f1: the cotangents of xh0 and xh1), hs [NI+1][2][M][B][HH] (h_0..
// h_NI of both evaluations), es [NI][2][M][B][HH] (the cotangents of
// h_1..h_NI's inputs), dz3 [2][M][B][H], h01 [M][B][H] (H0_1, f1's state),
// and by noise mode q [3][M][B][H] (the gk0, gk1 and gk2 rows' cotangents
// by row, 'precomp'), dn [4][M][B][H] (the cotangents of the nets' first
// layers' outputs by stage) and dz2 [4][M][B][H] (of net2's second layers'
// outputs); the nets read the forward's nst, nb and nh.
int fused_srk_bwd(const float* y0, const float* ys, const float* gys,
                  const float* xh0, const float* xh1, const float* dw,
                  const float* i10, const float* a0, const float* a1,
                  const float* gk0, const float* gk1, const float* gk2,
                  const float* dts, const float* theta, const float* wy,
                  const float* wi, const float* bi, const float* wo,
                  const float* bo, const float* wn1, const float* wn2,
                  const float* nst, const float* nb, const float* nh,
                  float* dxh, float* dy0, float* hs, float* es, float* dz3,
                  float* q, float* h01, float* dn, float* dz2, float* p_th,
                  int M, int B, int H, int HH, int n_inner, int mult_y,
                  int geometric, int drift, int noise, int elem,
                  void* stream) {
  SrkArgs A{};
  A.y0 = y0; A.ys = ys; A.gys = gys; A.xh0 = xh0; A.xh1 = xh1; A.dw = dw;
  A.i10 = i10; A.a0 = a0; A.a1 = a1; A.gk0 = gk0; A.gk1 = gk1; A.gk2 = gk2;
  A.dts = dts; A.theta = theta; A.wy = wy; A.wi = wi; A.bi = bi; A.wo = wo;
  A.bo = bo; A.wn1 = wn1; A.wn2 = wn2;
  A.nst = const_cast<float*>(nst); A.nbs = const_cast<float*>(nb);
  A.nhs = const_cast<float*>(nh);
  A.dxh = dxh; A.dy0 = dy0; A.hs = hs; A.es = es; A.dz3 = dz3; A.q = q;
  A.h01 = h01; A.dn = dn; A.dz2 = dz2; A.p_th = p_th;
  return run(SdeDims{M, B, H, HH, n_inner, mult_y, geometric, drift, noise,
                     elem},
             A, 1, (cudaStream_t)stream, nullptr, true);
}

// The weight gradient from the recurrence's streams: the split partials
// p (Wy' [S][H+1][HH] unless the drift is 'xt', each W_l [S][HH+1][HH],
// Wout [S][HH+1][H], then Wn1 and (net2) Wn2 [S][H+1][H], one after
// another; the last row of each the bias sum, zero for Wy' and Wn1), the
// per-step column sums da [2][M][HH] of dxh, and dgk, [3][M][H] of q
// ('precomp') or [4][M][H] of dn by stage (the nets).
int fused_srk_wgrad(const float* y0, const float* ys, const float* h01,
                    const float* dxh, const float* hs, const float* es,
                    const float* dz3, const float* q, const float* nst,
                    const float* dn, const float* nh, const float* dz2,
                    float* p, float* da, float* dgk, int M, int B, int H,
                    int HH, int n_inner, int mult_y, int geometric, int drift,
                    int noise, int elem, void* stream) {
  return run_wgrad(SdeDims{M, B, H, HH, n_inner, mult_y, geometric, drift,
                           noise, elem},
                   y0, ys, h01, dxh, hs, es, dz3, q, nst, dn, nh, dz2, p, da,
                   dgk, (cudaStream_t)stream);
}

}  // extern "C"
