// Fused Euler–Maruyama solve of a DiffusionField SDE: forward, backward
// recurrence and weight-gradient kernels for NVIDIA Hopper (sm_90a), plain
// C interface (loaded with ctypes by snsde_torch/kernels/fused_em.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_em.py:
//   forward  _fused_em_forward (pallas_call at :688, body _fwd_kernel :590)
//   backward _fused_em_backward (pallas_call at :888, body _bwd_kernel :736)
// for drift mode 'embm' (merged emb drift, input_option 2/4/6), noise mode
// 'precomp' (the diffusion magnitude gk[u] depends on t only), with or
// without mult_y and geometric, at every width.
//
// Each step u (the primes are precomputed outside the kernel):
//   z1 = y Wy' + a'[u] + xh'[u];  h_0 = relu(z1)
//   h_{l+1} = relu(h_l W_l + b_l)
//   z3 = h_NI Wout + bo  (* tanh(y) when geometric);  f = tanh(z3)
//   graw = gk[u] (* y when mult_y);  g = tanh(sigmoid(theta) graw)
//   y <- y + f dt[u] + g dW[u]
//
// What bounds it on the H100: not bytes or FLOPs (at the sepsis shape,
// B=1024, 71 steps, H=HH=49, one inner layer, the forward does ~1 GFLOP,
// ~16 us at 67 TFLOP/s fp32) but the chain of 71 dependent steps, each a
// few small products with barriers between them, over 1024 independent
// rows. The first design (one 256-thread block per 8 rows, each output one
// 49-long FMA chain over scalar shared reads, the step's streams read
// inside the step, and in the backward the activations recomputed and three
// weight-gradient accumulators read-modified-written inside every step)
// took 12.2 K cycles a forward step and 42 K a backward step for ~450
// cycles of FMA work (PERF.md section 6 has the split). The design:
// * A cluster of CS CTAs (CS in {1, 2, 4, 8}) runs the whole loop for R
//   batch rows. CTA j owns a block of each layer's output columns (HH-wide
//   layers: [j UH, j UH + nh), H-wide: [j U, j U + nu)) and holds its
//   column slice of every weight; a layer's output row is pushed into every
//   CTA of the cluster through distributed shared memory, one cluster
//   barrier a layer. A cluster of one is one CTA and a block barrier.
// * 512 threads a CTA. The forward products are register tiles (1 x 1 up
//   to 4 x 2, whichever keeps the threads busy) over float4 reads along K,
//   each output one FMA chain in ascending k: the order of the plain
//   versions' matrix products, so a relu's input rounds as theirs does.
//   The backward's products through a weight's transpose split K over
//   adjacent lanes, summed by a shuffle tree in a fixed order; with CS > 1
//   each CTA's product over its own columns is a partial, summed over the
//   cluster in rank order.
// * The step's streams (the next step's xh' and dW rows, a' and gk rows;
//   in the backward also the state before the step and gys) are copied
//   with cp.async into a double buffer a step ahead.
// * Backward: only the dependent chain (dz3 -> back through Wout and the
//   inner layers -> dz1 -> the state's cotangent through Wy'^T) waits on
//   the previous step. The activations of step u-1 are recomputed from
//   the saved trajectory by half of the CTA's threads in the same phases as
//   step u's chain runs on the other half (one barrier serves both). The
//   weight gradients are not accumulated in the loop: the recurrence
//   writes the activations h_0..h_NI, the inner layers' cotangents, dz3 and
//   the gk row's cotangent as streams (dz1 is dxh'), and one weight-gradient
//   kernel (wgrad_kernel, sde_hopper.cuh) forms dWy', dW_l, dWout, the bias
//   sums and the per-step column sums of a' and gk as [K = M B] products
//   after the loop, K split over the card and the splits summed by the
//   wrapper in a fixed order. d theta is a per-CTA partial. No atomics:
//   runs are bit-reproducible.
// * The host plan (em_plan) weighs what fits a CTA's 227 KB: level 0 the
//   weight slices in shared memory, level 1 the weights read from device
//   memory (L2); CS; R from 1 to 32. Of every plan whose CTA fits and
//   whose cluster cudaOccupancyMaxActiveClusters can place, it takes the
//   least estimated time (waves x a step's FMAs, phases and cluster
//   barriers in a CTA, x2.5 for device memory); when none can be placed
//   the launch is refused (no fallback).
// On an H100 (PERF.md section 6) this took the sepsis forward from 12.2 K
// to 8.2 K cycles a step and the backward from 42 K to 21 K, plus the
// weight-gradient kernel (~0.23 ms a launch, 2.5x torch.matmul of its
// products); the steps' phases still cost 2-5 K cycles each for a few
// hundred cycles of FMA work: instruction issue, shared-memory reads and
// barrier latency, not the FMA chains, bound them.
// Exact fp32 FMA on the CUDA cores (TF32 off).

#include <cmath>
#include <vector>

#include "sde_hopper.cuh"

namespace {

struct EmDims {
  int M, B, H, HH, NI, mult_y, geometric;
};

// level 0: the weight slices in shared memory; 1: read from device memory
constexpr int EM_LEVELS = 2;
// threads of the backward's chain group when the recompute runs beside it
// (on an H100 at the sepsis shape 128 beat 256 and 64)
constexpr int CHAIN_THREADS = 128;

struct EmPlan {
  int level, cs, R;
  long long bytes;
};

// The widths a CTA's tiles and slices take
struct EmGeo {
  int U, UH, lU, lUH, sH, sHH, sW, R4, H4, HH4;
};

__host__ __device__ inline EmGeo em_geo(const EmDims& d, const EmPlan& p) {
  EmGeo g;
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

// The shared-memory layout of a CTA, offsets in floats (-1: not there).
// Weight slices (level 0): Wy' [H4][lUH], W_l [NI][HH4][lUH], Wout
// [HH4][lU]; the bias slices b_l [NI][UH] and bo [U] at every level.
// Forward: the state y [R4][sH]; the activations [2][R4][sHH] (ping-pong);
// the streams xh' [2][R4][UH], a' [2][UH], dW [2][R4][U], gk [2][U] (each
// tile's rows at the CTA's own width, nh or nu).
// Backward: y [2][R4][sH] (y_s in slot s & 1); the activations of two
// steps [2][NI+1][R4][sHH]; the inner cotangents [2][R4][sHH]; own-column
// tiles z3, dz3 and the state's cotangent [R4][U]; with CS > 1 the
// partials of the back products [NI+2][R4][sW]; the streams xh', a', dW,
// gys [2][R4][U], gk; the reduction's [ET / 32].
struct EmLayout {
  long long wy, wi, bi, wo, bo, y, h, e, z3, dz, gbar, pd, xh, a, dw, gy, gk,
      red, total;
};

struct Take {
  long long at = 0;
  __host__ __device__ long long operator()(long long n) {
    const long long o = at;
    at += (n + 3) & ~3LL;
    return o;
  }
};

__host__ __device__ inline EmLayout em_layout(const EmDims& d,
                                              const EmPlan& p, int bwd) {
  const EmGeo g = em_geo(d, p);
  const long long NI = d.NI, R4 = g.R4;
  EmLayout L;
  Take take;
  L.wy = L.wi = L.wo = -1;
  if (p.level == 0) {
    L.wy = take((long long)g.H4 * g.lUH);
    L.wi = take(NI * g.HH4 * g.lUH);
    L.wo = take((long long)g.HH4 * g.lU);
  }
  L.bi = take(NI * g.UH);
  L.bo = take(g.U);
  L.e = L.z3 = L.dz = L.gbar = L.pd = L.gy = L.red = -1;
  if (!bwd) {
    L.y = take(R4 * g.sH);
    L.h = take(2 * R4 * g.sHH);
  } else {
    L.y = take(2 * R4 * g.sH);
    L.h = take(2 * (NI + 1) * R4 * g.sHH);
    L.e = take(2 * R4 * g.sHH);
    L.z3 = take(R4 * g.U);
    L.dz = take(R4 * g.U);
    L.gbar = take(R4 * g.U);
    if (p.cs > 1) L.pd = take((NI + 2) * R4 * g.sW);
    L.gy = take(2 * R4 * g.U);
    L.red = take(ET / 32);
  }
  L.xh = take(2 * R4 * g.UH);
  L.a = take(2 * (long long)g.UH);
  L.dw = take(2 * R4 * g.U);
  L.gk = take(2 * (long long)g.U);
  L.total = take(0);
  return L;
}

// The CTA's place: its cluster's rows and its own columns
struct Cta {
  int cs, rank, row0, nr, u0, nu, h0, nh;
};

__device__ __forceinline__ Cta make_cta(const EmDims& d, const EmPlan& p,
                                        const EmGeo& g) {
  Cta c;
  c.cs = p.cs;
  c.rank = p.cs == 1 ? 0 : (int)cg::this_cluster().block_rank();
  c.row0 = (int)(blockIdx.x / p.cs) * p.R;
  c.nr = min(p.R, d.B - c.row0);
  c.u0 = min(c.rank * g.U, d.H);
  c.nu = min(g.U, d.H - c.u0);
  c.h0 = min(c.rank * g.UH, d.HH);
  c.nh = min(g.UH, d.HH - c.h0);
  return c;
}

// The weights as the products read them: the CTA's column slices in
// shared memory (level 0: rows and columns past the weights' own are zero,
// shared memory being zeroed first), or the tensors in device memory at
// their own strides from the slice's first column; the bias slices in
// shared memory.
struct Wts {
  const float *wy, *wi, *wo, *bi, *bo;
  int lwy, lwi, swi, lwo;
};

__device__ __forceinline__ Wts load_wts(const EmDims& d, const EmPlan& p,
                                        const EmGeo& g, const Cta& c,
                                        const EmLayout& L, float* s,
                                        const float* __restrict__ wy,
                                        const float* __restrict__ wi,
                                        const float* __restrict__ bi,
                                        const float* __restrict__ wo,
                                        const float* __restrict__ bo) {
  const int H = d.H, HH = d.HH, NI = d.NI, nh = c.nh, nu = c.nu;
  Wts w;
  float* sbi = s + L.bi;
  float* sbo = s + L.bo;
  for (int i = threadIdx.x; i < NI * nh; i += ET)
    sbi[(i / nh) * g.UH + i % nh] = bi[(i / nh) * HH + c.h0 + i % nh];
  for (int i = threadIdx.x; i < nu; i += ET) sbo[i] = bo[c.u0 + i];
  w.bi = sbi;
  w.bo = sbo;
  if (p.level == 0) {
    float* swy = s + L.wy;
    float* swi = s + L.wi;
    float* swo = s + L.wo;
    for (int i = threadIdx.x; i < H * nh; i += ET)
      swy[(i / nh) * g.lUH + i % nh] =
          wy[(size_t)(i / nh) * HH + c.h0 + i % nh];
    for (int i = threadIdx.x; i < NI * HH * nh; i += ET) {
      const int l = i / (HH * nh), k = (i / nh) % HH, n = i % nh;
      swi[((size_t)l * g.HH4 + k) * g.lUH + n] =
          wi[((size_t)l * HH + k) * HH + c.h0 + n];
    }
    for (int i = threadIdx.x; i < HH * nu; i += ET)
      swo[(i / nu) * g.lU + i % nu] = wo[(size_t)(i / nu) * H + c.u0 + i % nu];
    w.wy = swy;
    w.wi = swi;
    w.wo = swo;
    w.lwy = w.lwi = g.lUH;
    w.swi = g.HH4 * g.lUH;
    w.lwo = g.lU;
  } else {
    w.wy = wy + c.h0;
    w.wi = wi + c.h0;
    w.wo = wo + c.u0;
    w.lwy = w.lwi = HH;
    w.swi = HH * HH;
    w.lwo = H;
  }
  return w;
}

// the main paths' instance (GW false) reads the weight slices from shared
// memory, a compile-time fact
template <bool GW>
__device__ __forceinline__ EmPlan placed(EmPlan p) {
  if (!GW) p.level = 0;
  return p;
}

// ---------------------------------------------------------------------------
// The forward kernel
// ---------------------------------------------------------------------------

template <bool GW>
__global__ void __launch_bounds__(ET)
em_fwd_kernel(EmDims d, EmPlan pp, const float* __restrict__ y0,
              const float* __restrict__ xh, const float* __restrict__ dw,
              const float* __restrict__ a, const float* __restrict__ gk,
              const float* __restrict__ dts, const float* __restrict__ theta,
              const float* __restrict__ wy, const float* __restrict__ wi,
              const float* __restrict__ bi, const float* __restrict__ wo,
              const float* __restrict__ bo, float* __restrict__ ys) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const EmPlan p = placed<GW>(pp);
  const EmGeo g = em_geo(d, p);
  const EmLayout L = em_layout(d, p, 0);
  zero_smem(s, L.total);
  __syncthreads();
  const Cta c = make_cta(d, p, g);
  const Wts w = load_wts(d, p, g, c, L, s, wy, wi, bi, wo, bo);
  const int H = d.H, HH = d.HH, NI = d.NI, sH = g.sH, sHH = g.sHH;
  const int U = g.U, UH = g.UH, R4 = g.R4, nr = c.nr, row0 = c.row0;
  const int h0 = c.h0, u0 = c.u0, cs = c.cs, nh = c.nh, nu = c.nu;
  const int htile = R4 * sHH, xtile = R4 * UH, wtile = R4 * U;
  float* y = s + L.y;
  float* h = s + L.h;
  float* xb = s + L.xh;
  float* ab = s + L.a;
  float* wb = s + L.dw;
  float* gb = s + L.gk;
  const Grp all{0, ET};
  for (int i = threadIdx.x; i < nr * H; i += ET)
    y[(i / H) * sH + i % H] = y0[(size_t)row0 * H + i];
  // step u's streams into slot u & 1
  auto prefetch = [&](int u) {
    const int b = u & 1;
    copy_rows(xb + b * xtile, nh, xh + ((size_t)u * d.B + row0) * HH + h0,
              HH, nh, nr);
    copy_rows(ab + b * UH, nh, a + (size_t)u * HH + h0, nh, nh, 1);
    copy_rows(wb + b * wtile, nu, dw + ((size_t)u * d.B + row0) * H + u0, H,
              nu, nr);
    copy_rows(gb + b * U, nu, gk + (size_t)u * H + u0, nu, nu, 1);
    cp_async_commit();
  };
  if (d.M > 0) prefetch(0);
  cp_async_wait_all();
  // every CTA of the cluster is zeroed before a peer pushes into it
  cluster_or_block_sync(cs);
  const float sth = sigmoid(theta[0]);
  const bool mult_y = d.mult_y, geometric = d.geometric;

  for (int u = 0; u < d.M; ++u) {
    const float dt = __ldg(dts + u);
    const int b = u & 1;
    if (u + 1 < d.M) prefetch(u + 1);
    const float* xu = xb + b * xtile;
    const float* au = ab + b * UH;
    const float* wu = wb + b * wtile;
    const float* gu = gb + b * U;
    // h_0 = relu(y Wy' + a' + xh'), own columns, into every CTA
    mm(all, y, sH, H, w.wy, w.lwy, GW, nr, c.nh,
       [&](int r, int n, float acc) {
         push(cs, h, r * sHH + h0 + n,
              fmaxf(acc + au[n] + xu[r * nh + n], 0.f));
       });
    cluster_or_block_sync(cs);
    for (int l = 0; l < NI; ++l) {
      // the inner layers
      const float* hin = h + (l & 1) * htile;
      float* hout = h + ((l + 1) & 1) * htile;
      const float* bl = w.bi + l * UH;
      mm(all, hin, sHH, HH, w.wi + (size_t)l * w.swi, w.lwi, GW, nr, c.nh,
         [&](int r, int n, float acc) {
           push(cs, hout, r * sHH + h0 + n, fmaxf(acc + bl[n], 0.f));
         });
      cluster_or_block_sync(cs);
    }
    // z3, own columns, and the step's update of y there, into every CTA
    const float* hl = h + (NI & 1) * htile;
    mm(all, hl, sHH, HH, w.wo, w.lwo, GW, nr, c.nu,
       [&](int r, int n, float acc) {
         const int col = u0 + n;
         const float yv = y[r * sH + col];
         float z3 = acc + w.bo[n];
         if (geometric) z3 *= tanhf(yv);
         const float f = tanhf(z3);
         float graw = gu[n];
         if (mult_y) graw *= yv;
         const float gg = tanhf(sth * graw);
         const float yn = yv + f * dt + gg * wu[r * nu + n];
         push(cs, y, r * sH + col, yn);
         ys[((size_t)u * d.B + row0 + r) * H + col] = yn;
       });
    cp_async_wait_all();
    cluster_or_block_sync(cs);
  }
}

// ---------------------------------------------------------------------------
// The backward recurrence
// ---------------------------------------------------------------------------

// Iteration u (from M down to 0) runs the chain of step u (u < M) beside
// the recompute of step u-1's activations (u >= 1), phase by phase (NI + 2
// phases, one barrier each), then step u-1's pointwise part. Phase p of
// the chain goes back through Wout (p = 0), W_{NI-p} (1 <= p <= NI) or Wy'
// (p = NI + 1); phase p of the recompute forms h_0 (p = 0), h_p
// (1 <= p <= NI) or z3 (p = NI + 1).
template <bool GW>
__global__ void __launch_bounds__(ET)
em_bwd_kernel(EmDims d, EmPlan pp, const float* __restrict__ y0,
              const float* __restrict__ ys, const float* __restrict__ gys,
              const float* __restrict__ xh, const float* __restrict__ dw,
              const float* __restrict__ a, const float* __restrict__ gk,
              const float* __restrict__ dts, const float* __restrict__ theta,
              const float* __restrict__ wy, const float* __restrict__ wi,
              const float* __restrict__ bi, const float* __restrict__ wo,
              const float* __restrict__ bo, float* __restrict__ dxh,
              float* __restrict__ dy0, float* __restrict__ hs,
              float* __restrict__ es, float* __restrict__ dz3s,
              float* __restrict__ qs, float* __restrict__ p_th) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const EmPlan p = placed<GW>(pp);
  const EmGeo g = em_geo(d, p);
  const EmLayout L = em_layout(d, p, 1);
  zero_smem(s, L.total);
  __syncthreads();
  const Cta c = make_cta(d, p, g);
  const Wts w = load_wts(d, p, g, c, L, s, wy, wi, bi, wo, bo);
  const int H = d.H, HH = d.HH, NI = d.NI, M = d.M, B = d.B;
  const int sH = g.sH, sHH = g.sHH, sW = g.sW, U = g.U, UH = g.UH;
  const int R4 = g.R4, nr = c.nr, row0 = c.row0, h0 = c.h0, u0 = c.u0;
  const int nh = c.nh, nu = c.nu, cs = c.cs, tid = threadIdx.x;
  const int ytile = R4 * sH, htile = R4 * sHH, hset = (NI + 1) * htile;
  const int xtile = R4 * UH, wtile = R4 * U, ptile = R4 * sW;
  const size_t BH = (size_t)B * H, BHH = (size_t)B * HH;
  float* yb = s + L.y;
  float* hk = s + L.h;
  float* e = s + L.e;
  float* z3 = s + L.z3;
  float* dz = s + L.dz;
  float* gbar = s + L.gbar;
  float* pd = s + L.pd;
  float* xb = s + L.xh;
  float* ab = s + L.a;
  float* wb = s + L.dw;
  float* gyb = s + L.gy;
  float* gb = s + L.gk;
  // y_s (s >= -1, y_{-1} = y0) lives in slot (s + 2) & 1
  auto yslot = [&](int t) { return yb + ((t + 2) & 1) * ytile; };
  auto prefetch_y = [&](int t) {
    copy_rows(yslot(t), sH,
              (t < 0 ? y0 : ys + (size_t)t * BH) + (size_t)row0 * H, H, H,
              nr);
  };
  // step t's streams into slot t & 1
  auto prefetch = [&](int t) {
    const int b = t & 1;
    copy_rows(xb + b * xtile, nh, xh + ((size_t)t * B + row0) * HH + h0, HH,
              nh, nr, true);
    copy_rows(ab + b * UH, nh, a + (size_t)t * HH + h0, nh, nh, 1, true);
    copy_rows(wb + b * wtile, nu, dw + ((size_t)t * B + row0) * H + u0, H,
              nu, nr, true);
    copy_rows(gyb + b * wtile, nu, gys + ((size_t)t * B + row0) * H + u0, H,
              nu, nr, true);
    copy_rows(gb + b * U, nu, gk + (size_t)t * H + u0, nu, nu, 1, true);
  };
  if (M > 0) {
    prefetch(M - 1);
    prefetch_y(M - 2);
    cp_async_commit();
  }
  cp_async_wait_all();
  cluster_or_block_sync(cs);
  const float sth = sigmoid(theta[0]);
  const bool mult_y = d.mult_y, geometric = d.geometric;
  float th_acc = 0.f;

  for (int u = M; u >= 0; --u) {
    const bool chain = u < M, rec = u >= 1;
    if (u >= 2) {
      prefetch(u - 2);
      prefetch_y(u - 3);
    }
    cp_async_commit();
    const Grp gc = rec ? Grp{0, CHAIN_THREADS} : Grp{0, ET};
    const Grp gr = chain ? Grp{CHAIN_THREADS, ET - CHAIN_THREADS}
                         : Grp{0, ET};
    const float* hu = hk + (u & 1) * hset;     // step u's activations
    float* hv = hk + ((u + 1) & 1) * hset;     // step u-1's, recomputed
    const float* yv = yslot(u - 2);            // the state before step u-1
    const int sv = (u + 1) & 1;                // step u-1's stream slot
    const size_t ov = ((size_t)(u - 1) * B + row0);  // its first row
    const size_t oc = ((size_t)u * B + row0);        // step u's first row

    for (int ph = 0; ph < NI + 2; ++ph) {
      // CS > 1: the chain's previous partial, summed over the cluster in
      // rank order, through its relu, into the own columns of e
      if (cs > 1 && chain && ph > 0) {
        const int l = NI + 1 - ph;  // the layer whose cotangent it is
        const float* hm = hu + l * htile;
        float* eo = e + ((ph - 1) & 1) * htile;
        float* part = pd + (ph - 1) * ptile;
        for (int i = tid; i < nr * nh; i += ET) {
          const int r = i / nh, k = h0 + i % nh, ix = r * sHH + k;
          const float v = peer_sum(cs, part, r * sW + k);
          const float ev = hm[ix] > 0.f ? v : 0.f;
          eo[ix] = ev;
          if (l == 0)
            dxh[(oc + r) * HH + k] = ev;
          else
            es[((size_t)(l - 1) * M * B + oc + r) * HH + k] = ev;
        }
        __syncthreads();
      }
      if (chain) {
        // the chain's product of this phase
        if (ph < NI + 1) {
          const int l = NI - ph;  // the cotangent formed: of h_l's input
          const float* E = ph == 0 ? dz : e + ((ph - 1) & 1) * htile + h0;
          const int lde = ph == 0 ? U : sHH, Nc = ph == 0 ? nu : nh;
          const float* W = ph == 0 ? w.wo : w.wi + (size_t)l * w.swi;
          const int ldw = ph == 0 ? w.lwo : w.lwi;
          if (cs == 1) {
            const float* hm = hu + l * htile;
            float* eo = e + (ph & 1) * htile;
            mm_t(gc, E, lde, Nc, W, ldw, GW, nr, HH,
                 [&](int r, int k, float acc) {
                   const int ix = r * sHH + k;
                   const float ev = hm[ix] > 0.f ? acc : 0.f;
                   eo[ix] = ev;
                   if (l == 0)
                     dxh[(oc + r) * HH + k] = ev;
                   else
                     es[((size_t)(l - 1) * M * B + oc + r) * HH + k] = ev;
                 });
          } else {
            float* part = pd + ph * ptile;
            mm_t(gc, E, lde, Nc, W, ldw, GW, nr, HH,
                 [&](int r, int k, float acc) { part[r * sW + k] = acc; });
          }
        } else {
          // dz1 Wy'^T into the state's cotangent (own columns)
          const float* E = e + (NI & 1) * htile + h0;
          if (cs == 1) {
            mm_t(gc, E, sHH, nh, w.wy, w.lwy, GW, nr, H,
                 [&](int r, int k, float acc) { gbar[r * U + k] += acc; });
          } else {
            float* part = pd + ph * ptile;
            mm_t(gc, E, sHH, nh, w.wy, w.lwy, GW, nr, H,
                 [&](int r, int k, float acc) { part[r * sW + k] = acc; });
          }
        }
      }
      if (rec) {
        // the recompute's product of this phase (step u-1)
        if (ph == 0) {
          const float* xu = xb + sv * xtile;
          const float* au = ab + sv * UH;
          mm(gr, yv, sH, H, w.wy, w.lwy, GW, nr, nh,
             [&](int r, int n, float acc) {
               const float v = fmaxf(acc + au[n] + xu[r * nh + n], 0.f);
               push(cs, hv, r * sHH + h0 + n, v);
               hs[(ov + r) * HH + h0 + n] = v;
             });
        } else if (ph <= NI) {
          const float* bl = w.bi + (ph - 1) * UH;
          float* ho = hv + ph * htile;
          float* hso = hs + (size_t)ph * M * BHH;
          mm(gr, hv + (ph - 1) * htile, sHH, HH,
             w.wi + (size_t)(ph - 1) * w.swi, w.lwi, GW, nr, nh,
             [&](int r, int n, float acc) {
               const float v = fmaxf(acc + bl[n], 0.f);
               push(cs, ho, r * sHH + h0 + n, v);
               hso[(ov + r) * HH + h0 + n] = v;
             });
        } else {
          mm(gr, hv + NI * htile, sHH, HH, w.wo, w.lwo, GW, nr, nu,
             [&](int r, int n, float acc) { z3[r * U + n] = acc + w.bo[n]; });
        }
      }
      cluster_or_block_sync(cs);
    }

    // the state's cotangent (CS > 1: the last partial summed), then step
    // u-1's pointwise part: back through y' = y + f dt + g dW
    const float dt = rec ? __ldg(dts + u - 1) : 0.f;
    const float* wu = wb + sv * wtile;
    const float* gyu = gyb + sv * wtile;
    const float* gu = gb + sv * U;
    for (int i = tid; i < nr * nu; i += ET) {
      const int r = i / nu, k = i % nu, ix = r * U + k;
      float gv = gbar[ix];
      if (cs > 1 && chain)
        gv += peer_sum(cs, pd + (NI + 1) * ptile, r * sW + u0 + k);
      if (rec) {
        gv += gyu[i];
        const float y = yv[r * sH + u0 + k];
        const float z3l = z3[ix];
        const float ty = tanhf(y);
        const float f = tanhf(geometric ? z3l * ty : z3l);
        const float graw0 = gu[k];
        const float graw = mult_y ? graw0 * y : graw0;
        const float gg = tanhf(sth * graw);
        const float df = gv * dt, dg = gv * wu[i];
        const float dsg = dg * (1.f - gg * gg);
        th_acc = fmaf(dsg, graw, th_acc);
        const float dgraw = dsg * sth;
        float dbase = dgraw, dy = 0.f;
        if (mult_y) {
          dbase = dgraw * y;
          dy = dgraw * graw0;
        }
        const float dz3 = df * (1.f - f * f);
        float dz3l = dz3;
        if (geometric) {
          dz3l = dz3 * ty;
          dy += dz3 * z3l * (1.f - ty * ty);
        }
        dz[ix] = dz3l;
        const size_t o = (ov + r) * H + u0 + k;
        dz3s[o] = dz3l;
        qs[o] = dbase;
        gv += dy;
      }
      gbar[ix] = gv;
    }
    cp_async_wait_all();
    __syncthreads();
  }

  for (int i = tid; i < nr * nu; i += ET) {
    const int r = i / nu, k = i % nu;
    dy0[(size_t)(row0 + r) * H + u0 + k] = gbar[r * U + k];
  }
  // d theta: the CTA's sum through sigmoid'
  const float t = cta_sum(th_acc, s + L.red);
  if (tid == 0) p_th[blockIdx.x] = t * sth * (1.f - sth);
  // no CTA leaves while a peer may still read its shared memory
  cluster_or_block_sync(cs);
}

// ---------------------------------------------------------------------------
// The host plan and the launches
// ---------------------------------------------------------------------------

// the lowest level, and a forced cluster size and row count, the host may
// take (fused_em_force_placement, fused_em_force_plan; 0: its own)
int g_first_level = 0;
int g_force_cs = 0;
int g_force_rows = 0;

// cudaOccupancyMaxActiveClusters of plan q's kernel (0 when it cannot be
// scheduled)
inline int plan_active(const EmPlan& q, int backward) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0, e;
  if (backward)
    e = cluster_config(q.level ? em_bwd_kernel<true> : em_bwd_kernel<false>,
                       q.cs, 0, q.bytes, 0, cfg, attr, &n);
  else
    e = cluster_config(q.level ? em_fwd_kernel<true> : em_fwd_kernel<false>,
                       q.cs, 0, q.bytes, 0, cfg, attr, &n);
  return e ? 0 : n;
}

// The plan of a launch: among every level from g_first_level on, CS in
// {1, 2, 4, 8} (at most max(H, HH)) and R in {1, ..., 32} rows a cluster
// whose CTA fits the device's shared memory and whose cluster can be
// scheduled, the one of least estimated time: waves of clusters (the
// clusters over cudaOccupancyMaxActiveClusters) x a step's cycles in a
// CTA (R x the FMAs of one row's MLP evaluation / CS at 64 a cycle, twice
// in the backward, whose recompute runs beside the chain; 300 a phase;
// 900 a cluster barrier and, in the backward, 300 more a phase for the
// partials' sum), x 2.5 at level 1 (device memory serving the weights:
// the factor PR 7's CDE plan measured). Ties go to fewer waves, the lower
// level, the smaller CS, fewer rows. A pure function of the shapes (and of
// what a test forces). When nothing fits, the last plan tried, its bytes
// above the limit (the launch is refused).
inline EmPlan em_plan(const EmDims& d, int backward) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int, int, int, int, int, int, int>,
                  EmPlan>
      seen;
  int dev = 0;
  cudaGetDevice(&dev);
  const auto key = std::make_tuple(dev, d.B, d.H, d.HH, d.NI, backward,
                                   g_first_level, g_force_cs, g_force_rows);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = seen.find(key);
  if (it != seen.end()) return it->second;
  const long long limit = (long long)max_optin_smem();
  EmPlan last{}, best{};
  last.bytes = limit + 1;
  double best_cost = -1.0;
  long long best_key = 0;
  const int phases = d.NI + 2 + backward;
  const double row = (double)d.H * d.HH + (double)d.NI * d.HH * d.HH +
                     (double)d.HH * d.H;
  for (int level = g_first_level; level < EM_LEVELS; ++level)
    for (int cs = 1; cs <= 8; cs *= 2) {
      if (g_force_cs ? cs != g_force_cs
                     : (cs > 1 && cs > (d.H > d.HH ? d.H : d.HH)))
        continue;
      for (int R = 1; R <= 32; R *= 2) {
        if (g_force_rows && R != g_force_rows) continue;
        EmPlan q{level, cs, R, 0};
        q.bytes = (long long)sizeof(float) * em_layout(d, q, backward).total;
        const int active = q.bytes > limit ? 0 : plan_active(q, backward);
        if (active < 1) {
          last = q;
          continue;
        }
        const double waves =
            std::ceil((double)((d.B + R - 1) / R) / active);
        const double step =
            R * row / cs / 64.0 * (1 + backward) + 300.0 * phases +
            (cs > 1 ? (900.0 + 300.0 * backward) * (d.NI + 2) : 0.0);
        const double cost = waves * step * (level > 0 ? 2.5 : 1.0);
        const long long key =
            (((long long)waves * EM_LEVELS + level) * 16 + cs) * 64 + R;
        if (best_cost < 0 || cost < best_cost * (1 - 1e-9) ||
            (cost <= best_cost * (1 + 1e-9) && key < best_key)) {
          best_cost = cost;
          best_key = key;
          best = q;
        }
      }
    }
  const EmPlan p = best_cost < 0 ? last : best;
  seen[key] = p;
  return p;
}

inline bool valid(const EmDims& d) {
  return d.M >= 0 && d.B > 0 && d.H > 0 && d.HH > 0 && d.NI >= 0;
}

inline int ctas(const EmDims& d, const EmPlan& p) {
  return ((d.B + p.R - 1) / p.R) * p.cs;
}

struct FwdArgs {
  const float *y0, *xh, *dw, *a, *gk, *dts, *theta, *wy, *wi, *bi, *wo, *bo;
  float* ys;
};

struct BwdArgs {
  const float *y0, *ys, *gys, *xh, *dw, *a, *gk, *dts, *theta, *wy, *wi,
      *bi, *wo, *bo;
  float *dxh, *dy0, *hs, *es, *dz3, *q, *p_th;
};

// One launch (or, without `go`, its plan's check); the main paths' level 0
// runs its own instance (the weight slices in shared memory, a
// compile-time fact)
int run_fwd(const EmDims& d, const FwdArgs& A, cudaStream_t s, int* active,
            bool go) {
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const EmPlan p = em_plan(d, 0);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  auto k = p.level ? em_fwd_kernel<true> : em_fwd_kernel<false>;
  return launch_clusters(k, p.cs, ctas(d, p), p.bytes, s, active, go, d, p,
                         A.y0, A.xh, A.dw, A.a, A.gk, A.dts, A.theta, A.wy,
                         A.wi, A.bi, A.wo, A.bo, A.ys);
}

int run_bwd(const EmDims& d, const BwdArgs& A, cudaStream_t s, int* active,
            bool go) {
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const EmPlan p = em_plan(d, 1);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  auto k = p.level ? em_bwd_kernel<true> : em_bwd_kernel<false>;
  return launch_clusters(k, p.cs, ctas(d, p), p.bytes, s, active, go, d, p,
                         A.y0, A.ys, A.gys, A.xh, A.dw, A.a, A.gk, A.dts,
                         A.theta, A.wy, A.wi, A.bi, A.wo, A.bo, A.dxh, A.dy0,
                         A.hs, A.es, A.dz3, A.q, A.p_th);
}

// The weight-gradient products of a backward: the jobs (Wy', each W_l,
// Wout, in that order) and their output tiles; splits of K = M B
struct WgPlan {
  int njobs, S, bm;
  long long tiles;
};

inline WgPlan wg_plan(const EmDims& d) {
  WgPlan w;
  w.njobs = d.NI + 2;
  w.bm = wg_rows(d.H, d.HH);
  const long long tm_h = (d.H + w.bm - 1) / w.bm,
                  tm_hh = (d.HH + w.bm - 1) / w.bm;
  const long long tc_h = (d.H + WG_BN - 1) / WG_BN,
                  tc_hh = (d.HH + WG_BN - 1) / WG_BN;
  w.tiles = tm_h * tc_hh + d.NI * tm_hh * tc_hh + tm_hh * tc_h;
  w.S = wg_splits((long long)d.M * d.B, w.tiles);
  return w;
}

// floats of job j's split partials [S][rows + 1][N], and where each starts
inline long long wg_job_floats(const EmDims& d, int S, int j) {
  const int rows = j == 0 ? d.H : d.HH, N = j == d.NI + 1 ? d.H : d.HH;
  return (long long)S * (rows + 1) * N;
}

int run_wgrad(const EmDims& d, const float* y0, const float* ys,
              const float* dxh, const float* hs, const float* es,
              const float* dz3, const float* q, float* p, float* da,
              float* dgk, cudaStream_t s) {
  if (!valid(d)) return (int)cudaErrorInvalidValue;
  const WgPlan wp = wg_plan(d);
  const long long K = (long long)d.M * d.B;
  const size_t MBH = (size_t)d.M * d.B * d.HH;
  std::vector<WgJob> jobs;
  long long off = 0;
  for (int j = 0; j < wp.njobs; ++j) {
    WgJob J{};
    if (j == 0) {
      J = WgJob{y0, ys, dxh, nullptr, d.H, d.HH, d.B, 0};
    } else if (j <= d.NI) {
      J = WgJob{hs, hs + (j - 1) * MBH, es + (j - 1) * MBH, nullptr, d.HH,
                d.HH, 0, 1};
    } else {
      J = WgJob{hs, hs + d.NI * MBH, dz3, nullptr, d.HH, d.H, 0, 1};
    }
    J.p = p + off;
    off += wg_job_floats(d, wp.S, j);
    jobs.push_back(J);
  }
  const int kper = (int)(((K + wp.S - 1) / wp.S + WG_BK - 1) / WG_BK * WG_BK);
  // the jobs in launches of at most WG_MAX_JOBS; the column sums in the
  // first
  for (size_t j0 = 0; j0 < jobs.size(); j0 += WG_MAX_JOBS) {
    WgArgs A{};
    A.njobs = (int)std::min<size_t>(WG_MAX_JOBS, jobs.size() - j0);
    A.K = (int)K;
    A.M = d.M;
    A.B = d.B;
    A.kper = kper;
    A.tiles[0] = 0;
    for (int j = 0; j < A.njobs; ++j) {
      A.job[j] = jobs[j0 + j];
      const long long tm = (A.job[j].rows + wp.bm - 1) / wp.bm;
      const long long tc = (A.job[j].N + WG_BN - 1) / WG_BN;
      A.tiles[j + 1] = A.tiles[j] + (int)(tm * tc);
    }
    A.nsums = j0 == 0 ? 2 : 0;
    A.sum[0] = WgSum{dxh, da, d.HH};
    A.sum[1] = WgSum{q, dgk, d.H};
    const dim3 grid((unsigned)(A.tiles[A.njobs] + A.nsums * d.M),
                    (unsigned)wp.S);
    if (wp.bm == 128)
      wgrad_kernel<128><<<grid, WG_THREADS, 0, s>>>(A);
    else
      wgrad_kernel<64><<<grid, WG_THREADS, 0, s>>>(A);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a launch, in bytes, at its plan
// (above the device's limit when no plan fits).
long long fused_em_smem_bytes(int B, int H, int HH, int n_inner,
                              int backward) {
  const EmDims d{1, B, H, HH, n_inner, 0, 0};
  return em_plan(d, backward).bytes;
}

// One field of a launch's plan: 0 the level, 1 batch rows a cluster, 2
// CTAs a cluster, 3 cudaOccupancyMaxActiveClusters (minus the CUDA error
// when the plan cannot be scheduled), 4 shared bytes a CTA; 5 the splits
// of the weight gradient's K (the leading dimension of its partials).
int fused_em_plan(int B, int H, int HH, int n_inner, int backward,
                  int field) {
  const EmDims d{1, B, H, HH, n_inner, 0, 0};
  const EmPlan p = em_plan(d, backward);
  switch (field) {
    case 0: return p.level;
    case 1: return p.R;
    case 2: return p.cs;
    case 4: return (int)p.bytes;
  }
  int active = 0, err;
  if (backward)
    err = run_bwd(d, BwdArgs{}, 0, &active, false);
  else
    err = run_fwd(d, FwdArgs{}, 0, &active, false);
  return err ? -err : active;
}

// The splits of the weight gradient's K = M B at (M, B, H, HH, n_inner).
int fused_em_wgrad_splits(int M, int B, int H, int HH, int n_inner) {
  return wg_plan(EmDims{M, B, H, HH, n_inner, 0, 0}).S;
}

// Make later launches take level `first` or a later one (0: the host's
// own choice). For tests of each level.
int fused_em_force_placement(int first) {
  if (first < 0 || first >= EM_LEVELS) return (int)cudaErrorInvalidValue;
  g_first_level = first;
  return 0;
}

// Make later launches take clusters of cs CTAs and `rows` batch rows a
// cluster, a power of 2 up to 32 (0: the host's own choice of each). For
// tests of each plan.
int fused_em_force_plan(int cs, int rows) {
  if ((cs != 0 && cs != 1 && cs != 2 && cs != 4 && cs != 8) || rows < 0 ||
      rows > 32 || (rows & (rows - 1)))
    return (int)cudaErrorInvalidValue;
  g_force_cs = cs;
  g_force_rows = rows;
  return 0;
}

int fused_em_max_smem() { return max_optin_smem(); }

const char* fused_em_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_em_fwd(const float* y0, const float* xh, const float* dw,
                 const float* a, const float* gk, const float* dts,
                 const float* theta, const float* wy, const float* wi,
                 const float* bi, const float* wo, const float* bo, float* ys,
                 int M, int B, int H, int HH, int n_inner, int mult_y,
                 int geometric, void* stream) {
  const EmDims d{M, B, H, HH, n_inner, mult_y, geometric};
  const FwdArgs A{y0, xh, dw, a, gk, dts, theta, wy, wi, bi, wo, bo, ys};
  return run_fwd(d, A, (cudaStream_t)stream, nullptr, true);
}

// The reverse recurrence: dy0, dxh' (= dz1), the per-CTA partials of
// d theta ([ctas]), and the streams of the weight gradient: hs [NI+1][M][B]
// [HH] (h_0..h_NI), es [NI][M][B][HH] (the cotangents of h_1..h_NI's
// inputs), dz3 [M][B][H] and q [M][B][H] (the gk row's cotangent by row).
int fused_em_bwd(const float* y0, const float* ys, const float* gys,
                 const float* xh, const float* dw, const float* a,
                 const float* gk, const float* dts, const float* theta,
                 const float* wy, const float* wi, const float* bi,
                 const float* wo, const float* bo, float* dxh, float* dy0,
                 float* hs, float* es, float* dz3, float* q, float* p_th,
                 int M, int B, int H, int HH, int n_inner, int mult_y,
                 int geometric, void* stream) {
  const EmDims d{M, B, H, HH, n_inner, mult_y, geometric};
  const BwdArgs A{y0, ys, gys, xh, dw, a, gk, dts, theta, wy, wi, bi, wo, bo,
                  dxh, dy0, hs, es, dz3, q, p_th};
  return run_bwd(d, A, (cudaStream_t)stream, nullptr, true);
}

// The weight gradient from the recurrence's streams: the split partials
// p (Wy' [S][H+1][HH], each W_l [S][HH+1][HH], Wout [S][HH+1][H] one after
// another; the last row of each the bias sum, zero for Wy'), and the
// per-step column sums da [M][HH] of dxh and dgk [M][H] of q.
int fused_em_wgrad(const float* y0, const float* ys, const float* dxh,
                   const float* hs, const float* es, const float* dz3,
                   const float* q, float* p, float* da, float* dgk, int M,
                   int B, int H, int HH, int n_inner, int mult_y,
                   int geometric, void* stream) {
  const EmDims d{M, B, H, HH, n_inner, mult_y, geometric};
  return run_wgrad(d, y0, ys, dxh, hs, es, dz3, q, p, da, dgk,
                   (cudaStream_t)stream);
}

}  // extern "C"
