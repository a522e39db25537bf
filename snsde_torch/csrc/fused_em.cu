// Fused Euler–Maruyama solve of a DiffusionField SDE: forward, backward
// recurrence and weight-gradient kernels for NVIDIA Hopper (sm_90a), plain
// C interface (loaded with ctypes by snsde_torch/kernels/fused_em.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_em.py:
//   forward  _fused_em_forward (pallas_call at :688, body _fwd_kernel :590)
//   backward _fused_em_backward (pallas_call at :888, body _bwd_kernel :736)
// for the whole input_option x noise_option grid of the JAX kernels (the
// modes of snsde/kernels/fused_em.py:_config): drift modes 'embm' (merged
// emb drift, input_option 2/4/6), 'yy' (1/3/5) and 'xt' (0), each an
// instance of the kernels; noise modes 'precomp' (the diffusion magnitude
// gk[u] depends on t only), 'elem' (7-10), 'net1' (14/15) and 'net2'
// (18/19), an instance each too; with or without mult_y and geometric, at
// every width. The latent mode of the JAX kernel (_config's `latent`,
// :234-245; forward :346-352, _latent_u :362-372, backward :467-475) has
// instances of its own (NZ_LAT): a LatentSDE's augmented system, drift
// 'yy', the gk row sigma on the latent lanes and 0 on the KL lane (the
// last, H-1), per-lane rows lat = (theta, mu, mask / sigma):
//   lanes q < H-1:  y_q <- y_q + z3_q dt + gk_q dW_q  (drift linear,
//                   diffusion raw: no tanh, no sigmoid(theta))
//   lane H-1:       y_K <- y_K + 0.5 sum_{q<H-1} u_q^2 dt,
//                   u_q = (z3_q - theta (mu - y_q)) / sigma
// Each CTA pushes its own columns' u_q into every CTA of the cluster; after
// one more cluster barrier the CTA owning the KL lane sums the whole row in
// ascending q, so the rate's bits do not depend on the plan. In the
// reverse loop the KL lane's cotangent gK (the sum of its gys: nothing else
// reaches it) is kept a row in every CTA, and lane q takes
//   dz3_q = gbar_q dt + (gK dt) u_q / sigma,
//   dy_q += (gK dt) u_q theta / sigma,
// the weight gradient being that of 'precomp' over the new dz3. A simple
// design, not yet made fast.
//
// Each step u (the primes are precomputed outside the kernel):
//   z1 = y Wy' + a'[u] + xh'[u] ('embm'), y Wy + a[u] ('yy'), xh[u] ('xt')
//   h_0 = relu(z1);  h_{l+1} = relu(h_l W_l + b_l)
//   z3 = h_NI Wout + bo  (* tanh(y) when geometric);  f = tanh(z3)
//   base = gk[u] ('precomp'), elem(y) ('elem'), y Wn1 + an1[u] ('net1'),
//          relu(relu(y Wn1 + an1[u]) Wn2 + bn2) ('net2')
//   graw = base (* y when mult_y);  g = tanh(sigmoid(theta) graw)
//   y <- y + f dt[u] + g dW[u]
// The noise nets' products run beside the drift's first two layers in the
// same phases, in clusters of one CTA (sde_plan); the forward writes their
// outputs (nb) and hidden activations (nh) as streams, which the backward
// reads instead of recomputing them, and whose cotangents (dn: of the
// first layer's output; dz2: of the second's) the recurrence writes for
// the weight-gradient kernel, which forms dWn1, dWn2 and dbn2 beside the
// drift's weights. These modes are a simple design, not yet made fast.
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
// Exact fp32 FMA on the CUDA cores (TF32 off) by default.
//
// The JAX kernels' reduced-precision modes (_dot :67-107, _mm_mode
// :110-115; traj_bf16, fused_em.py:1108-1118) are runtime arguments
// (SdeDims.mm, .bs) of every forward instance and of the backward's
// reduced instances (em_bwd_kernel<.., RED = true>, launched when either
// is set): the fp32 recurrence's instances hold none of their code, so
// that its registers and spills are those of an fp32-only kernel. The
// reduced products are out of line (mm_mode<true>, mm_t_mode<true>) in
// both kernels (inlined into every reduced backward they cost a fifth
// more build time; the reduced recurrence spills around the calls).
// * operands (mm): every in-kernel product, the weight gradient's and the
//   latent KL rate's (0.5 u^2 through klm, :352; its cotangent :472) too,
//   rounds its operands to bf16 (MM_BF16) or splits them into hi + lo
//   (MM_X3, xh wh + xh wl + xl wh), accumulating in fp32 (sde_hopper.cuh:
//   mm_mode, mm_t_mode, wgrad_kernel<.., true>); in the forward the fp32
//   products sit behind one branch a call site;
// * streams (bs): xh, dW, the trajectory, gys are bf16 in device memory,
//   copied a step ahead in 4-byte pairs and widened into the fp32 tiles
//   (copy_bf16, widen_bf16). The forward's carry stays fp32 and only the
//   written trajectory is rounded (:617); the backward recomputes step k
//   from the rounded state (the trajectory, y0 rounded by the wrapper,
//   :830-836), so the noise nets' streams nb and nh, which it reads
//   instead of recomputing, are those of the rounded state: the forward
//   evaluates the nets a second time there (yr, hnr). The recurrence's
//   streams for the weight gradient stay fp32 (dz1 too: the wrapper
//   rounds the dxh it hands back).

#include "sde_hopper.cuh"

namespace {

// the noise code of the latent instances, past the shared modes' (its
// instances are this source's own: SDE_INSTANCES has no latent axis)
constexpr int NZ_LAT = SDE_NOISES;

__host__ __device__ constexpr bool lat_noise(int nz) { return nz == NZ_LAT; }

// The shared-memory layout of a CTA, offsets in floats (-1: not there):
// the weights (take_wts). Forward: the state y [R4][sH]; the activations
// [2][R4][sHH] (ping-pong); the noise net's output [R4][U] and (net2)
// hidden row [R4][sH]; the streams xh' [2][R4][UH], a' [2][UH], dW
// [2][R4][U], gk (or an1) [2][U] (each tile's rows at the CTA's own width,
// nh or nu).
// Backward: y [2][R4][sH] (y_s in slot s & 1); the activations of two
// steps [2][NI+1][R4][sHH]; the inner cotangents [2][R4][sHH]; own-column
// tiles z3, dz3 and the state's cotangent [R4][U]; with CS > 1 the
// partials of the back products [NI+2][R4][sW]; the noise net's: the
// cotangent of its output [R4][U], (net2) of its hidden layer [R4][U], and
// the state's [R4][U]; the streams xh', a', dW, gys [2][R4][U], gk; the
// reduction's [ET / 32]. The latent instances also take the rows lat
// [3][U] (theta, mu, mask / sigma: own columns); the forward the row of u
// [R4][sH] (every CTA's columns), the backward the KL lane's cotangent
// [R4] and its gys column [2][R4].
// With bf16 streams (bs), the staging area of the bf16 rows (copy_bf16)
// from `stage` on, in pairs (em_stage): dW [R4][bf_pairs(U)], xh
// [R4][bf_pairs(UH)], and in the backward gys [R4][bf_pairs(U)], the
// state [R4][bf_pairs(H)] and the latent KL lane's gys column [R4]; the
// forward of the noise nets also the rounded state yr [R4][sH] and (net2)
// the hidden row at it, hnr [R4][sH].
struct EmLayout {
  WtsAt w;
  long long y, h, e, z3, dz, gbar, pd, gn, hn, tq, tq1, tdy, xh, a, dw, gy,
      gk, red, lat, ut, gkl, gkb, stage, yr, hnr, total;
};

// the staging areas' offsets (in pairs) from the layout's `stage`, one
// pointer kept through the loops: dW 0, xh, gys, the state, the KL column
struct EmStage {
  int x, g, y, k, total;
};

__host__ __device__ inline EmStage em_stage(int R4, int U, int UH, int H) {
  EmStage st;
  st.x = R4 * bf_pairs(U);
  st.g = st.x + R4 * bf_pairs(UH);
  st.y = st.g + R4 * bf_pairs(U);
  st.k = st.y + R4 * bf_pairs(H);
  st.total = st.k + R4;
  return st;
}

__host__ __device__ inline EmLayout em_layout(const SdeDims& d,
                                              const SdePlan& p, int bwd) {
  const SdeGeo g = sde_geo(d, p);
  const long long NI = d.NI, R4 = g.R4;
  EmLayout L;
  Take take;
  L.w = take_wts(take, d, p, g);
  L.e = L.z3 = L.dz = L.gbar = L.pd = L.gy = L.red = -1;
  L.gn = L.hn = L.tq = L.tq1 = L.tdy = -1;
  L.lat = L.ut = L.gkl = L.gkb = -1;
  L.stage = L.yr = L.hnr = -1;
  const bool net = net_noise(d.noise), net2 = d.noise == NZ_NET2;
  const bool lat = lat_noise(d.noise);
  if (lat) L.lat = take(3 * (long long)g.U);
  if (!bwd) {
    L.y = take(R4 * g.sH);
    L.h = take(2 * R4 * g.sHH);
    if (net) L.gn = take(R4 * g.U);
    if (net2) L.hn = take(R4 * g.sH);
    if (lat) L.ut = take(R4 * g.sH);
  } else {
    L.y = take(2 * R4 * g.sH);
    L.h = take(2 * (NI + 1) * R4 * g.sHH);
    L.e = take(2 * R4 * g.sHH);
    L.z3 = take(R4 * g.U);
    L.dz = take(R4 * g.U);
    L.gbar = take(R4 * g.U);
    if (p.cs > 1) L.pd = take((NI + 2) * R4 * g.sW);
    if (net) {
      L.tq = take(R4 * g.U);
      L.tdy = take(R4 * g.U);
    }
    if (net2) L.tq1 = take(R4 * g.U);
    L.gy = take(2 * R4 * g.U);
    L.red = take(ET / 32);
    if (lat) {
      L.gkl = take(R4);
      L.gkb = take(2 * R4);
    }
  }
  L.xh = take(2 * R4 * g.UH);
  L.a = take(2 * (long long)g.UH);
  L.dw = take(2 * R4 * g.U);
  L.gk = take(2 * (long long)g.U);
  if (d.bs) {
    const EmStage st = em_stage(g.R4, g.U, g.UH, d.H);
    L.stage = take(bwd ? st.total : st.g);
    if (!bwd && net) {
      L.yr = take(R4 * g.sH);
      if (net2) L.hnr = take(R4 * g.sH);
    }
  }
  L.total = take(0);
  return L;
}

// the latent rows' own columns into sl [3][U] (member k = blockIdx.y's
// lat [3][H])
__device__ __forceinline__ void load_lat(float* sl, const float* lat,
                                         const SdeDims& d, const Cta& c,
                                         int U) {
  const float* src = lat + (size_t)blockIdx.y * 3 * d.H + c.u0;
  for (int i = threadIdx.x; i < 3 * c.nu; i += ET)
    sl[(i / c.nu) * U + i % c.nu] = src[(size_t)(i / c.nu) * d.H + i % c.nu];
}

// ---------------------------------------------------------------------------
// The forward kernel
// ---------------------------------------------------------------------------

// (__launch_bounds__(ET, 1): with the reduced products' code ptxas took
// the main paths' instances from the parent's 128 registers to 64 and
// spills; one CTA of 512 threads an SM lets it keep 128)
template <bool GW, int DR, int NZ>
__global__ void __launch_bounds__(ET, 1)
em_fwd_kernel(SdeDims dd, SdePlan pp, const float* __restrict__ y0,
              const float* __restrict__ xh, const float* __restrict__ dw,
              const float* __restrict__ a, const float* __restrict__ gk,
              const float* __restrict__ dts, const float* __restrict__ theta,
              const float* __restrict__ wy, const float* __restrict__ wi,
              const float* __restrict__ bi, const float* __restrict__ wo,
              const float* __restrict__ bo, const float* __restrict__ wn1,
              const float* __restrict__ wn2, const float* __restrict__ bn2,
              const float* __restrict__ lat, float* __restrict__ ys,
              float* __restrict__ nbs, float* __restrict__ nhs) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const SdeDims d = with_modes<DR, NZ>(dd);
  const SdePlan p = placed<GW>(pp);
  const SdeGeo g = sde_geo(d, p);
  const EmLayout L = em_layout(d, p, 0);
  zero_smem(s, L.total);
  __syncthreads();
  const Cta c = make_cta(d, p, g);
  const Wts w = load_wts(
      d, p, g, c, L.w, s,
      member_wts(d, (int)blockIdx.y,
                 WtsIn{wy, wi, bi, wo, bo, wn1, wn2, bn2}));
  const int H = d.H, HH = d.HH, NI = d.NI, sH = g.sH, sHH = g.sHH;
  const int U = g.U, UH = g.UH, R4 = g.R4, nr = c.nr, row0 = c.row0;
  const int h0 = c.h0, u0 = c.u0, cs = c.cs, nh = c.nh, nu = c.nu;
  // the member's first step in its streams and its first batch row, held
  // through the loop (formed at each use instead, ptxas gave the backward
  // 64 registers and spills)
  const int km = c.km, kb = member_row(d);
  const int htile = R4 * sHH, xtile = R4 * UH, wtile = R4 * U;
  // the precision: the products' operand mode, and bf16 streams (xh, dW
  // and ys as bf16 in device memory)
  const int mode = d.mm;
  const bool bs = d.bs;
  const __nv_bfloat16* xh16 = reinterpret_cast<const __nv_bfloat16*>(xh);
  const __nv_bfloat16* dw16 = reinterpret_cast<const __nv_bfloat16*>(dw);
  __nv_bfloat16* ys16 = reinterpret_cast<__nv_bfloat16*>(ys);
  float* y = s + L.y;
  float* h = s + L.h;
  float* xb = s + L.xh;
  float* ab = s + L.a;
  float* wb = s + L.dw;
  float* gb = s + L.gk;
  float* gn = s + L.gn;
  float* hn = s + L.hn;
  float* sl = s + L.lat;
  float* ut = s + L.ut;
  unsigned* sw = reinterpret_cast<unsigned*>(s + L.stage);
  float* yr = s + L.yr;
  float* hnr = s + L.hnr;
  const Grp all{0, ET};
  for (int i = threadIdx.x; i < nr * H; i += ET) {
    const float v = y0[(size_t)(kb + row0) * H + i];
    y[(i / H) * sH + i % H] = v;
    if (net_noise(NZ) && bs) yr[(i / H) * sH + i % H] = bf16r(v);
  }
  if constexpr (lat_noise(NZ)) load_lat(sl, lat, d, c, U);
  // step u's first rows in xh and dW
  auto xrow = [&](int u) { return ((size_t)(km + u) * d.B + row0) * HH + h0; };
  auto wrow = [&](int u) { return ((size_t)(km + u) * d.B + row0) * H + u0; };
  // step u's streams into slot u & 1 (those of the instance's modes; bf16
  // ones into their staging areas)
  auto prefetch = [&](int u) {
    const int b = u & 1;
    if (DR != DR_YY) {
      if (bs)
        copy_bf16(sw + em_stage(R4, U, UH, H).x, xh16 + xrow(u), HH, nh, nr);
      else
        copy_rows(xb + b * xtile, nh, xh + xrow(u), HH, nh, nr);
    }
    if (DR != DR_XT)
      copy_rows(ab + b * UH, nh, a + (size_t)(km + u) * HH + h0, nh, nh, 1);
    if (bs)
      copy_bf16(sw, dw16 + wrow(u), H, nu, nr);
    else
      copy_rows(wb + b * wtile, nu, dw + wrow(u), H, nu, nr);
    if (NZ != NZ_ELEM)
      copy_rows(gb + b * U, nu, gk + (size_t)(km + u) * H + u0, nu, nu, 1);
    cp_async_commit();
  };
  // step u's bf16 streams widened into slot u & 1 (after this thread's
  // wait, before the barrier that ends the step)
  auto widen = [&](int u) {
    if (!bs || u >= d.M) return;
    const int b = u & 1;
    if (DR != DR_YY)
      widen_bf16(xb + b * xtile, nh, sw + em_stage(R4, U, UH, H).x,
                 xh16 + xrow(u), HH, nh, nr);
    widen_bf16(wb + b * wtile, nu, sw, dw16 + wrow(u), H, nu, nr);
  };
  // the trajectory's entry o (rounded with bf16 streams)
  auto put_y = [&](size_t o, float v) {
    if (bs)
      ys16[o] = __float2bfloat16_rn(v);
    else
      ys[o] = v;
  };
  if (d.M > 0) prefetch(0);
  cp_async_wait_all();
  widen(0);
  // every CTA of the cluster is zeroed before a peer pushes into it
  cluster_or_block_sync(cs);
  const float sth = sigmoid(theta[blockIdx.y]);
  const bool mult_y = d.mult_y, geometric = d.geometric;

  for (int u = 0; u < d.M; ++u) {
    const float dt = __ldg(dts + u);
    const int b = u & 1;
    if (u + 1 < d.M) prefetch(u + 1);
    const float* xu = xb + b * xtile;
    const float* au = ab + b * UH;
    const float* wu = wb + b * wtile;
    const float* gu = gb + b * U;
    // h_0 = relu(y Wy' + a' + xh') ('yy': without xh'; 'xt': relu(xh)),
    // own columns, into every CTA
    if constexpr (DR == DR_XT) {
      xt_first(all, xu, nr, nh, [&](int r, int n, float v) {
        push(cs, h, r * sHH + h0 + n, v);
      });
    } else {
      mm_mode<true>(mode, all, y, sH, H, w.wy, w.lwy, GW, nr, c.nh,
              [&](int r, int n, float acc) {
                float v;
                if constexpr (DR == DR_EMBM)
                  v = acc + au[n] + xu[r * nh + n];
                else
                  v = acc + au[n];
                push(cs, h, r * sHH + h0 + n, fmaxf(v, 0.f));
              });
    }
    // the noise net's first layer on y (a cluster of one CTA: its own
    // columns are all); with bf16 streams also on the rounded state, whose
    // outputs are the streams the backward reads
    if constexpr (net_noise(NZ)) {
      mm_mode<true>(mode, all, y, sH, H, w.wn1, w.lwn, GW, nr, nu,
              [&](int r, int n, float acc) {
                const float v = acc + gu[n];
                if constexpr (NZ == NZ_NET1) {
                  gn[r * U + n] = v;
                } else {
                  const float hv = fmaxf(v, 0.f);
                  hn[r * sH + u0 + n] = hv;
                  if (!bs)
                    nhs[((size_t)(km + u) * d.B + row0 + r) * H + u0 + n] =
                        hv;
                }
              });
      if (bs)
        mm_mode<true>(mode, all, yr, sH, H, w.wn1, w.lwn, GW, nr, nu,
                [&](int r, int n, float acc) {
                  const float v = acc + gu[n];
                  const size_t o = ((size_t)(km + u) * d.B + row0 + r) * H +
                                   u0 + n;
                  if constexpr (NZ == NZ_NET1) {
                    nbs[o] = v;
                  } else {
                    const float hv = fmaxf(v, 0.f);
                    hnr[r * sH + u0 + n] = hv;
                    nhs[o] = hv;
                  }
                });
    }
    cluster_or_block_sync(cs);
    // net2's second layer, beside the first inner layer (or alone)
    if constexpr (NZ == NZ_NET2) {
      mm_mode<true>(mode, all, hn, sH, H, w.wn2, w.lwn, GW, nr, nu,
              [&](int r, int n, float acc) {
                gn[r * U + n] = fmaxf(acc + w.bn2[n], 0.f);
              });
      if (bs)
        mm_mode<true>(mode, all, hnr, sH, H, w.wn2, w.lwn, GW, nr, nu,
                [&](int r, int n, float acc) {
                  nbs[((size_t)(km + u) * d.B + row0 + r) * H + u0 + n] =
                      fmaxf(acc + w.bn2[n], 0.f);
                });
      if (NI == 0) __syncthreads();
    }
    for (int l = 0; l < NI; ++l) {
      // the inner layers
      const float* hin = h + (l & 1) * htile;
      float* hout = h + ((l + 1) & 1) * htile;
      const float* bl = w.bi + l * UH;
      mm_mode<true>(mode, all, hin, sHH, HH, w.wi + (size_t)l * w.swi, w.lwi, GW,
              nr, c.nh, [&](int r, int n, float acc) {
                push(cs, hout, r * sHH + h0 + n, fmaxf(acc + bl[n], 0.f));
              });
      cluster_or_block_sync(cs);
    }
    // z3, own columns, and the step's update of y there, into every CTA
    const float* hl = h + (NI & 1) * htile;
    if constexpr (lat_noise(NZ)) {
      // the latent lanes: linear drift, raw diffusion; u_q into every CTA
      mm_mode<true>(mode, all, hl, sHH, HH, w.wo, w.lwo, GW, nr, c.nu,
              [&](int r, int n, float acc) {
                const int col = u0 + n;
                if (col == H - 1) return;
                const float yv = y[r * sH + col];
                const float z3 = acc + w.bo[n];
                push(cs, ut, r * sH + col,
                     (z3 - sl[n] * (sl[U + n] - yv)) * sl[2 * U + n]);
                const float yn = yv + z3 * dt + gu[n] * wu[r * nu + n];
                push(cs, y, r * sH + col, yn);
                put_y(((size_t)(km + u) * d.B + row0 + r) * H + col, yn);
              });
      cluster_or_block_sync(cs);
      // the KL lane: its CTA sums the row of u in ascending q (in a
      // reduced mode JAX's product (0.5 u^2) klm: the hi parts summed,
      // then the lo parts)
      const int nk = H - 1 - u0;
      if (nk >= 0 && nk < nu)
        for (int r = threadIdx.x; r < nr; r += ET) {
          const float* ur = ut + r * sH;
          float rate;
          if (mode == MM_F32) {
            float acc = 0.f;
            for (int q = 0; q < H - 1; ++q) acc = fmaf(ur[q], ur[q], acc);
            rate = 0.5f * acc;
          } else {
            float ah = 0.f, al = 0.f;
            for (int q = 0; q < H - 1; ++q) {
              const Parts v = parts(0.5f * ur[q] * ur[q], mode == MM_X3);
              ah += v.h;
              al += v.l;
            }
            rate = ah + al;
          }
          const float yv = y[r * sH + H - 1];
          const float yn = yv + rate * dt + gu[nk] * wu[r * nu + nk];
          push(cs, y, r * sH + H - 1, yn);
          put_y(((size_t)(km + u) * d.B + row0 + r) * H + H - 1, yn);
        }
    } else {
      mm_mode<true>(mode, all, hl, sHH, HH, w.wo, w.lwo, GW, nr, c.nu,
              [&](int r, int n, float acc) {
                const int col = u0 + n;
                const float yv = y[r * sH + col];
                float z3 = acc + w.bo[n];
                if (geometric) z3 *= tanhf(yv);
                const float f = tanhf(z3);
                float base;
                if constexpr (NZ == NZ_PRE)
                  base = gu[n];
                else if constexpr (NZ == NZ_ELEM)
                  base = elem_base(d.elem, yv);
                else
                  base = gn[r * U + n];
                float graw = base;
                if (mult_y) graw *= yv;
                const float gg = tanhf(sth * graw);
                const float yn = yv + f * dt + gg * wu[r * nu + n];
                push(cs, y, r * sH + col, yn);
                const size_t o =
                    ((size_t)(km + u) * d.B + row0 + r) * H + col;
                put_y(o, yn);
                if constexpr (net_noise(NZ)) {
                  if (bs)
                    yr[r * sH + col] = bf16r(yn);
                  else
                    nbs[o] = base;
                }
              });
    }
    cp_async_wait_all();
    widen(u + 1);
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
// (1 <= p <= NI) or z3 (p = NI + 1). In drift mode 'xt' the chain's last
// phase has no product (h_0's input is xh alone). The noise nets' back
// products of step u (net1: through Wn1 in phase 0; net2: through Wn2 in
// phase 0, then Wn1 in phase 1) run on the chain's threads beside its own,
// into the state's cotangent, from the cotangent of the net's output that
// step u's pointwise part left; the forward values come from the forward's
// streams nb and nh. RED: the reduced precisions' instance (the operand
// mode and the stream flag read from d; the reduced products out of
// line); without it exact fp32 streams and products, every reduced branch
// compiled away.
template <bool GW, int DR, int NZ, bool RED = false>
__global__ void __launch_bounds__(ET)
em_bwd_kernel(SdeDims dd, SdePlan pp, const float* __restrict__ y0,
              const float* __restrict__ ys, const float* __restrict__ gys,
              const float* __restrict__ xh, const float* __restrict__ dw,
              const float* __restrict__ a, const float* __restrict__ gk,
              const float* __restrict__ dts, const float* __restrict__ theta,
              const float* __restrict__ wy, const float* __restrict__ wi,
              const float* __restrict__ bi, const float* __restrict__ wo,
              const float* __restrict__ bo, const float* __restrict__ wn1,
              const float* __restrict__ wn2, const float* __restrict__ lat,
              const float* __restrict__ nbs,
              const float* __restrict__ nhs, float* __restrict__ dxh,
              float* __restrict__ dy0, float* __restrict__ hs,
              float* __restrict__ es, float* __restrict__ dz3s,
              float* __restrict__ qs, float* __restrict__ dn,
              float* __restrict__ dz2, float* __restrict__ p_th) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const SdeDims d = with_modes<DR, NZ>(dd);
  const SdePlan p = placed<GW>(pp);
  const SdeGeo g = sde_geo(d, p);
  const EmLayout L = em_layout(d, p, 1);
  zero_smem(s, L.total);
  __syncthreads();
  const Cta c = make_cta(d, p, g);
  const Wts w = load_wts(
      d, p, g, c, L.w, s,
      member_wts(d, (int)blockIdx.y,
                 WtsIn{wy, wi, bi, wo, bo, wn1, wn2, nullptr}));
  const int H = d.H, HH = d.HH, NI = d.NI, M = d.M, B = d.B;
  const int km = c.km, kb = member_row(d);
  const size_t MK = (size_t)d.K * M;  // the steps of a layer's stream
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
  float* tq = s + L.tq;
  float* tq1 = s + L.tq1;
  float* tdy = s + L.tdy;
  float* sl = s + L.lat;
  float* gkl = s + L.gkl;
  float* gkb = s + L.gkb;
  // the precision: the products' operand mode, and bf16 streams (xh, dW,
  // gys and the states, y0 (rounded by the wrapper) and ys, as bf16 in
  // device memory, staged a step ahead and widened)
  const int mode = RED ? d.mm : MM_F32;
  const bool bs = RED && d.bs;
  const __nv_bfloat16* y016 = reinterpret_cast<const __nv_bfloat16*>(y0);
  const __nv_bfloat16* ys16 = reinterpret_cast<const __nv_bfloat16*>(ys);
  const __nv_bfloat16* gys16 = reinterpret_cast<const __nv_bfloat16*>(gys);
  const __nv_bfloat16* xh16 = reinterpret_cast<const __nv_bfloat16*>(xh);
  const __nv_bfloat16* dw16 = reinterpret_cast<const __nv_bfloat16*>(dw);
  // the staging areas (em_stage: dW at 0)
  unsigned* sw = reinterpret_cast<unsigned*>(s + L.stage);
  auto stg = [&](int which) {
    const EmStage st = em_stage(R4, U, UH, H);
    return sw + (which == 0 ? st.x : which == 1 ? st.g : which == 2 ? st.y
                                                                   : st.k);
  };
  if constexpr (lat_noise(NZ)) load_lat(sl, lat, d, c, U);
  // y_s (s >= -1, y_{-1} = y0) lives in slot (s + 2) & 1
  auto yslot = [&](int t) { return yb + ((t + 2) & 1) * ytile; };
  // the state before step t + 1's first row (an offset in y0 or ys)
  auto yrow = [&](int t) {
    return (t < 0 ? (size_t)kb * H : (size_t)(km + t) * BH) +
           (size_t)row0 * H;
  };
  auto prefetch_y = [&](int t) {
    if (bs)
      copy_bf16(stg(2), (t < 0 ? y016 : ys16) + yrow(t), H, H, nr);
    else
      copy_rows(yslot(t), sH, (t < 0 ? y0 : ys) + yrow(t), H, H, nr);
  };
  // step t's first rows in xh, and in dW and gys
  auto xrow = [&](int t) { return ((size_t)(km + t) * B + row0) * HH + h0; };
  auto wrow = [&](int t) { return ((size_t)(km + t) * B + row0) * H + u0; };
  auto krow = [&](int t) { return ((size_t)(km + t) * B + row0) * H + H - 1; };
  // step t's streams into slot t & 1 (those of the instance's modes; bf16
  // ones into their staging areas)
  auto prefetch = [&](int t) {
    const int b = t & 1;
    if (DR != DR_YY) {
      if (bs)
        copy_bf16(stg(0), xh16 + xrow(t), HH, nh, nr);
      else
        copy_rows(xb + b * xtile, nh, xh + xrow(t), HH, nh, nr, true);
    }
    if (DR != DR_XT)
      copy_rows(ab + b * UH, nh, a + (size_t)(km + t) * HH + h0, nh, nh, 1,
                true);
    if (bs) {
      copy_bf16(sw, dw16 + wrow(t), H, nu, nr);
      copy_bf16(stg(1), gys16 + wrow(t), H, nu, nr);
    } else {
      copy_rows(wb + b * wtile, nu, dw + wrow(t), H, nu, nr, true);
      copy_rows(gyb + b * wtile, nu, gys + wrow(t), H, nu, nr, true);
    }
    if (NZ == NZ_PRE || lat_noise(NZ))
      copy_rows(gb + b * U, nu, gk + (size_t)(km + t) * H + u0, nu, nu, 1,
                true);
    // the KL lane's gys column
    if (lat_noise(NZ)) {
      if (bs)
        copy_bf16(stg(3), gys16 + krow(t), H, 1, nr);
      else
        copy_rows(gkb + b * R4, 1, gys + krow(t), H, 1, nr);
    }
  };
  // step t's bf16 streams and the state before step t's (t - 1's row)
  // widened into their slots (after this thread's wait, before the
  // barrier that ends the iteration)
  auto widen = [&](int t) {
    if (!bs) return;
    const int b = t & 1;
    if (DR != DR_YY)
      widen_bf16(xb + b * xtile, nh, stg(0), xh16 + xrow(t), HH, nh, nr);
    widen_bf16(wb + b * wtile, nu, sw, dw16 + wrow(t), H, nu, nr);
    widen_bf16(gyb + b * wtile, nu, stg(1), gys16 + wrow(t), H, nu, nr);
    if (lat_noise(NZ))
      widen_bf16(gkb + b * R4, 1, stg(3), gys16 + krow(t), H, 1, nr);
    widen_bf16(yslot(t - 1), sH, stg(2),
               (t - 1 < 0 ? y016 : ys16) + yrow(t - 1), H, H, nr);
  };
  if (M > 0) {
    prefetch(M - 1);
    prefetch_y(M - 2);
    cp_async_commit();
  }
  cp_async_wait_all();
  if (M > 0) widen(M - 1);
  cluster_or_block_sync(cs);
  const float sth = sigmoid(theta[blockIdx.y]);
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
    // step u-1's first row, step u's
    const size_t ov = ((size_t)(km + u - 1) * B + row0);
    const size_t oc = ((size_t)(km + u) * B + row0);
    // the KL lane's cotangent after step u-1 (read after the phases'
    // barriers)
    if (lat_noise(NZ) && rec)
      for (int r = tid; r < nr; r += ET) gkl[r] += gkb[sv * R4 + r];

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
            es[((size_t)(l - 1) * MK * B + oc + r) * HH + k] = ev;
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
            mm_t_mode<RED>(mode, gc, E, lde, Nc, W, ldw, GW, nr, HH,
                 [&](int r, int k, float acc) {
                   const int ix = r * sHH + k;
                   const float ev = hm[ix] > 0.f ? acc : 0.f;
                   eo[ix] = ev;
                   if (l == 0)
                     dxh[(oc + r) * HH + k] = ev;
                   else
                     es[((size_t)(l - 1) * MK * B + oc + r) * HH + k] = ev;
                 });
          } else {
            float* part = pd + ph * ptile;
            mm_t_mode<RED>(mode, gc, E, lde, Nc, W, ldw, GW, nr, HH,
                      [&](int r, int k, float acc) {
                        part[r * sW + k] = acc;
                      });
          }
        } else if (DR != DR_XT) {
          // dz1 Wy'^T into the state's cotangent (own columns)
          const float* E = e + (NI & 1) * htile + h0;
          if (cs == 1) {
            mm_t_mode<RED>(mode, gc, E, sHH, nh, w.wy, w.lwy, GW, nr, H,
                      [&](int r, int k, float acc) {
                        gbar[r * U + k] += acc;
                      });
          } else {
            float* part = pd + ph * ptile;
            mm_t_mode<RED>(mode, gc, E, sHH, nh, w.wy, w.lwy, GW, nr, H,
                      [&](int r, int k, float acc) {
                        part[r * sW + k] = acc;
                      });
          }
        }
        // the noise net's back products of step u (a cluster of one CTA)
        if constexpr (NZ == NZ_NET1) {
          if (ph == 0)
            mm_t_mode<RED>(mode, gc, tq, U, nu, w.wn1, w.lwn, GW, nr, H,
                      [&](int r, int k, float acc) {
                        tdy[r * U + k] = acc;
                      });
        } else if constexpr (NZ == NZ_NET2) {
          if (ph == 0)
            mm_t_mode<RED>(mode, gc, tq, U, nu, w.wn2, w.lwn, GW, nr, H,
                 [&](int r, int k, float acc) {
                   const size_t o = (oc + r) * H + k;
                   const float v = nhs[o] > 0.f ? acc : 0.f;
                   tq1[r * U + k] = v;
                   dn[o] = v;
                 });
          else if (ph == 1)
            mm_t_mode<RED>(mode, gc, tq1, U, nu, w.wn1, w.lwn, GW, nr, H,
                      [&](int r, int k, float acc) {
                        tdy[r * U + k] = acc;
                      });
        }
      }
      if (rec) {
        // the recompute's product of this phase (step u-1)
        if (ph == 0) {
          const float* xu = xb + sv * xtile;
          const float* au = ab + sv * UH;
          if constexpr (DR == DR_XT) {
            xt_first(gr, xu, nr, nh, [&](int r, int n, float v) {
              push(cs, hv, r * sHH + h0 + n, v);
              hs[(ov + r) * HH + h0 + n] = v;
            });
          } else {
            mm_mode<RED>(mode, gr, yv, sH, H, w.wy, w.lwy, GW, nr, nh,
               [&](int r, int n, float acc) {
                 float v;
                 if constexpr (DR == DR_EMBM)
                   v = fmaxf(acc + au[n] + xu[r * nh + n], 0.f);
                 else
                   v = fmaxf(acc + au[n], 0.f);
                 push(cs, hv, r * sHH + h0 + n, v);
                 hs[(ov + r) * HH + h0 + n] = v;
               });
          }
        } else if (ph <= NI) {
          const float* bl = w.bi + (ph - 1) * UH;
          float* ho = hv + ph * htile;
          float* hso = hs + (size_t)ph * MK * BHH;
          mm_mode<RED>(mode, gr, hv + (ph - 1) * htile, sHH, HH,
             w.wi + (size_t)(ph - 1) * w.swi, w.lwi, GW, nr, nh,
             [&](int r, int n, float acc) {
               const float v = fmaxf(acc + bl[n], 0.f);
               push(cs, ho, r * sHH + h0 + n, v);
               hso[(ov + r) * HH + h0 + n] = v;
             });
        } else {
          mm_mode<RED>(mode, gr, hv + NI * htile, sHH, HH, w.wo, w.lwo, GW, nr,
                  nu, [&](int r, int n, float acc) {
                    z3[r * U + n] = acc + w.bo[n];
                  });
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
      if (DR != DR_XT && cs > 1 && chain)
        gv += peer_sum(cs, pd + (NI + 1) * ptile, r * sW + u0 + k);
      if (net_noise(NZ) && chain) gv += tdy[ix];
      if constexpr (lat_noise(NZ)) {
        if (rec) {
          // back through the raw diffusion and the linear drift, and (the
          // KL lane's cotangent through u_q) the rate
          gv += gyu[i];
          const float y = yv[r * sH + u0 + k];
          const float uq = (z3[ix] - sl[k] * (sl[U + k] - y)) * sl[2 * U + k];
          const float df = gv * dt;
          // the KL lane's cotangent through klm^T in the operand mode
          const float du = one_hot(gkl[r] * dt, mode) * uq;
          const float dz3l = (u0 + k < H - 1 ? df : 0.f) + du * sl[2 * U + k];
          const size_t o = (ov + r) * H + u0 + k;
          dz[ix] = dz3l;
          dz3s[o] = dz3l;
          qs[o] = gv * wu[i];
          gv += du * (sl[k] * sl[2 * U + k]);
        }
      } else if (rec) {
        gv += gyu[i];
        const float y = yv[r * sH + u0 + k];
        const float z3l = z3[ix];
        const float ty = tanhf(y);
        const float f = tanhf(geometric ? z3l * ty : z3l);
        const size_t o = (ov + r) * H + u0 + k;
        float graw0;  // the diffusion's base
        if constexpr (NZ == NZ_PRE)
          graw0 = gu[k];
        else if constexpr (NZ == NZ_ELEM)
          graw0 = elem_base(d.elem, y);
        else
          graw0 = nbs[o];
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
        if constexpr (NZ == NZ_ELEM) dy += dbase * elem_deriv(d.elem, y);
        const float dz3 = df * (1.f - f * f);
        float dz3l = dz3;
        if (geometric) {
          dz3l = dz3 * ty;
          dy += dz3 * z3l * (1.f - ty * ty);
        }
        dz[ix] = dz3l;
        dz3s[o] = dz3l;
        if constexpr (NZ == NZ_PRE) qs[o] = dbase;
        if constexpr (NZ == NZ_NET1) {
          tq[ix] = dbase;
          dn[o] = dbase;
        }
        if constexpr (NZ == NZ_NET2) {
          const float v = graw0 > 0.f ? dbase : 0.f;
          tq[ix] = v;
          dz2[o] = v;
        }
        gv += dy;
      }
      gbar[ix] = gv;
    }
    cp_async_wait_all();
    if (u >= 2) widen(u - 2);
    __syncthreads();
  }

  for (int i = tid; i < nr * nu; i += ET) {
    const int r = i / nu, k = i % nu;
    dy0[(size_t)(kb + row0 + r) * H + u0 + k] = gbar[r * U + k];
  }
  // d theta: the CTA's sum through sigmoid'
  const float t = cta_sum(th_acc, s + L.red);
  if (tid == 0)
    p_th[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = t * sth * (1.f - sth);
  // no CTA leaves while a peer may still read its shared memory
  cluster_or_block_sync(cs);
}

// ---------------------------------------------------------------------------
// The host plan and the launches
// ---------------------------------------------------------------------------

// The instance of a launch: the level's (a compile-time fact: the main
// paths' level 0 reads the weight slices from shared memory) and the drift
// and noise modes'
// (and the latent instances', drift 'yy' only); the backward's also its
// precision class'
using FwdKernel = decltype(&em_fwd_kernel<false, DR_EMBM, NZ_PRE>);
using BwdKernel = decltype(&em_bwd_kernel<false, DR_EMBM, NZ_PRE>);

// SDE_INSTANCES of the backward's reduced instances
#define EM_RED_ROW(GW, DR)                   \
  {em_bwd_kernel<GW, DR, NZ_PRE, true>,      \
   em_bwd_kernel<GW, DR, NZ_ELEM, true>,     \
   em_bwd_kernel<GW, DR, NZ_NET1, true>,     \
   em_bwd_kernel<GW, DR, NZ_NET2, true>}
#define EM_RED_ROWS(GW) \
  {EM_RED_ROW(GW, DR_EMBM), EM_RED_ROW(GW, DR_YY), EM_RED_ROW(GW, DR_XT)}

inline FwdKernel fwd_kernel(const SdeDims& d, int level) {
  static const FwdKernel k[2][SDE_DRIFTS][SDE_NOISES] =
      SDE_INSTANCES(em_fwd_kernel);
  static const FwdKernel kl[2] = {em_fwd_kernel<false, DR_YY, NZ_LAT>,
                                  em_fwd_kernel<true, DR_YY, NZ_LAT>};
  if (lat_noise(d.noise)) return kl[level ? 1 : 0];
  return k[level ? 1 : 0][d.drift][d.noise];
}

inline BwdKernel bwd_kernel(const SdeDims& d, int level) {
  static const BwdKernel k[2][2][SDE_DRIFTS][SDE_NOISES] = {
      SDE_INSTANCES(em_bwd_kernel), {EM_RED_ROWS(false), EM_RED_ROWS(true)}};
  static const BwdKernel kl[2][2] = {
      {em_bwd_kernel<false, DR_YY, NZ_LAT>,
       em_bwd_kernel<true, DR_YY, NZ_LAT>},
      {em_bwd_kernel<false, DR_YY, NZ_LAT, true>,
       em_bwd_kernel<true, DR_YY, NZ_LAT, true>}};
  const int red = d.mm != MM_F32 || d.bs;
  if (lat_noise(d.noise)) return kl[red][level ? 1 : 0];
  return k[red][level ? 1 : 0][d.drift][d.noise];
}

// cudaOccupancyMaxActiveClusters of plan q's kernel (0 when it cannot be
// scheduled)
inline int plan_active(const SdeDims& d, const SdePlan& q, int backward) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0, e;
  if (backward)
    e = cluster_config(bwd_kernel(d, q.level), q.cs, 0, q.bytes, 0, cfg,
                       attr, &n);
  else
    e = cluster_config(fwd_kernel(d, q.level), q.cs, 0, q.bytes, 0, cfg,
                       attr, &n);
  return e ? 0 : n;
}

// The plan of a launch (sde_plan): a step is one MLP evaluation, NI + 2
// phases (and, in the backward, its pointwise part; net2's forward with no
// inner layer one more; the latent forward one more, the KL lane's, with a
// cluster barrier), one cluster barrier a phase, one diffusion evaluation.
inline SdePlan em_plan(const SdeDims& d, int backward) {
  const int lat = !backward && lat_noise(d.noise);
  const int extra = (!backward && d.noise == NZ_NET2 && d.NI == 0) + lat;
  return sde_plan(
      d, backward,
      StepShape{1, d.NI + 2 + backward + extra, d.NI + 2 + lat, 1},
      [&](const SdePlan& q) { return em_layout(d, q, backward).total; },
      [&](const SdePlan& q) { return plan_active(d, q, backward); });
}

// the modes this source's instances take: the shared ones, and the latent
// mode with drift 'yy'
inline bool em_modes_valid(int drift, int noise, int elem) {
  return sde_modes_valid(drift, noise, elem) ||
         (lat_noise(noise) && drift == DR_YY);
}

// the latent mode without mult_y and geometric, on a KL lane and at least
// one latent lane
inline bool em_valid(const SdeDims& d) {
  return sde_valid(d) && em_modes_valid(d.drift, d.noise, d.elem) &&
         (!lat_noise(d.noise) || (!d.mult_y && !d.geometric && d.H >= 2));
}

struct FwdArgs {
  const float *y0, *xh, *dw, *a, *gk, *dts, *theta, *wy, *wi, *bi, *wo, *bo,
      *wn1, *wn2, *bn2, *lat;
  float *ys, *nb, *nh;
};

struct BwdArgs {
  const float *y0, *ys, *gys, *xh, *dw, *a, *gk, *dts, *theta, *wy, *wi,
      *bi, *wo, *bo, *wn1, *wn2, *lat, *nb, *nh;
  float *dxh, *dy0, *hs, *es, *dz3, *q, *dn, *dz2, *p_th, *dtheta;
};

// One launch (or, without `go`, its plan's check)
int run_fwd(const SdeDims& d, const FwdArgs& A, cudaStream_t s, int* active,
            bool go) {
  if (!em_valid(d)) return (int)cudaErrorInvalidValue;
  const SdePlan p = em_plan(d, 0);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  return launch_clusters(fwd_kernel(d, p.level), p.cs, sde_ctas(d, p), d.K,
                         p.bytes, s, active, go, d, p, A.y0, A.xh, A.dw, A.a,
                         A.gk, A.dts, A.theta, A.wy, A.wi, A.bi, A.wo, A.bo,
                         A.wn1, A.wn2, A.bn2, A.lat, A.ys, A.nb, A.nh);
}

int run_bwd(const SdeDims& d, const BwdArgs& A, cudaStream_t s, int* active,
            bool go) {
  if (!em_valid(d)) return (int)cudaErrorInvalidValue;
  const SdePlan p = em_plan(d, 1);
  if (p.bytes > (long long)max_optin_smem())
    return (int)cudaErrorInvalidValue;
  const int ctas = sde_ctas(d, p);
  const int err = launch_clusters(
      bwd_kernel(d, p.level), p.cs, ctas, d.K, p.bytes, s, active, go, d, p,
      A.y0, A.ys, A.gys, A.xh, A.dw, A.a, A.gk, A.dts, A.theta, A.wy, A.wi,
      A.bi, A.wo, A.bo, A.wn1, A.wn2, A.lat, A.nb, A.nh, A.dxh, A.dy0, A.hs,
      A.es,
      A.dz3, A.q, A.dn, A.dz2, A.p_th);
  if (err || !go) return err;
  // d theta of each member: its CTAs' partials summed in a fixed order
  return run_split_sums({SplitSum{A.p_th, A.dtheta, 1, ctas, 1, ctas}}, d.K,
                        s);
}

// The weight gradient over K = M B rows a member: Wy' over the states
// before each step (y0, then ys) and dz1 (not in drift mode 'xt'), each W_l
// and Wout over the activations and cotangents, the noise net's Wn1 over
// the states and dn, Wn2 over nh and dz2, their split partials p summed
// into w; the per-step column sums of dz1 (da; not in 'xt') and of q
// (dgk, 'precomp') or dn (the an1 rows' cotangent, the nets).
int run_wgrad(const SdeDims& d, const float* y0, const float* ys,
              const float* dxh, const float* hs, const float* es,
              const float* dz3, const float* q, const float* dn,
              const float* dz2, const float* nh, float* p, float* w,
              float* da, float* dgk, cudaStream_t s) {
  if (!em_valid(d)) return (int)cudaErrorInvalidValue;
  const long long K = (long long)d.M * d.B, BH = (long long)d.B * d.H;
  const WgPlan wp = wg_plan(d, K);
  std::vector<WgJob> jobs;
  long long per = wg_jobs(d, wp, K, y0, ys, nullptr, d.B, (int)K, BH,
                          K * d.H, 0, K, 0, 0, dxh, hs, es, dz3, p, jobs);
  wg_noise_jobs(d, wp, y0, ys, nullptr, d.B, (int)K, BH, K * d.H, 0, K, 0, 0,
                dn, nh, dz2, p + per, jobs);
  per += (long long)wp.S * (d.H + 1) * d.H * noise_jobs(d);
  set_member_partials(jobs, per);
  const long long KHH = K * d.HH, KH = K * d.H, MHH = (long long)d.M * d.HH,
                  MH = (long long)d.M * d.H;
  WgSum sums[WG_MAX_SUMS];
  int ns = 0;
  if (d.drift != DR_XT)
    sums[ns++] = WgSum{dxh, da, d.HH, d.M, KHH, MHH, 0, 0};
  if (d.noise == NZ_PRE) sums[ns++] = WgSum{q, dgk, d.H, d.M, KH, MH, 0, 0};
  if (net_noise(d.noise))
    sums[ns++] = WgSum{dn, dgk, d.H, d.M, KH, MH, 0, 0};
  const int err = run_wgrad_jobs(jobs, sums, ns, K, d.B, wp, d.K, s, d.mm);
  if (err) return err;
  long long wm = 0;
  for (const WgJob& J : jobs) wm += (long long)(J.rows + 1) * J.N;
  return run_split_sums(wg_split_sums(jobs, wp, w, per, wm), d.K, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one CTA of a launch, in bytes, at its plan
// (above the device's limit when no plan fits); bf16: 1 for bf16 streams.
long long fused_em_smem_bytes(int B, int H, int HH, int n_inner, int drift,
                              int noise, int members, int bf16,
                              int backward) {
  if (!em_modes_valid(drift, noise, 7) || members < 1) return -1;
  const SdeDims d{1,     B,     H,       HH, n_inner, 0, 0,
                  drift, noise, 0, members, 0,       bf16 != 0};
  return em_plan(d, backward).bytes;
}

// One field of a launch's plan over `members` members (bf16: 1 for bf16
// streams): 0 the level, 1 batch rows a cluster, 2 CTAs a cluster, 3
// cudaOccupancyMaxActiveClusters (minus the CUDA error when the plan
// cannot be scheduled), 4 shared bytes a CTA.
int fused_em_plan(int B, int H, int HH, int n_inner, int drift, int noise,
                  int members, int bf16, int backward, int field) {
  if (!em_modes_valid(drift, noise, 7) || members < 1)
    return -(int)cudaErrorInvalidValue;
  const SdeDims d{1,     B,     H,       HH, n_inner, 0, 0,
                  drift, noise, 9, members, 0,       bf16 != 0};
  const SdePlan p = em_plan(d, backward);
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

// The splits of the weight gradient's K = M B at (M, B, H, HH, n_inner)
// in the modes (the leading dimension of its partials).
int fused_em_wgrad_splits(int M, int B, int H, int HH, int n_inner,
                          int drift, int noise) {
  return wg_plan(SdeDims{M, B, H, HH, n_inner, 0, 0, drift, noise, 0, 1},
                 (long long)M * B).S;
}

// Make later launches take level `first` or a later one (0: the host's
// own choice). For tests of each level.
int fused_em_force_placement(int first) { return force_level(first); }

// Make later launches take clusters of cs CTAs and `rows` batch rows a
// cluster, a power of 2 up to 32 (0: the host's own choice of each). For
// tests of each plan.
int fused_em_force_plan(int cs, int rows) { return force_plan(cs, rows); }

int fused_em_max_smem() { return max_optin_smem(); }

const char* fused_em_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The forward of K members: ys, and in the noise nets' modes their
// outputs nb [M][B][H] and (net2) hidden activations nh [M][B][H], each
// [K][...] as every input but dts [M] (member k's weights, y0, xh, dW, a
// and gk at k times a member's size). A tensor a mode does not take is null: xh in 'yy'; a and wy in 'xt'; gk in 'elem'
// (the an1 rows in the nets); wn1 (wn2, bn2) outside the nets (net1); lat
// ([K][3][H]: theta, mu, mask / sigma) outside the latent mode (noise
// NZ_LAT, whose H includes the KL lane). mm: the products' operand mode
// (MM_*); bf16: xh, dW and ys in bf16 (nb and nh then those of the
// rounded state before each step).
int fused_em_fwd(const float* y0, const float* xh, const float* dw,
                 const float* a, const float* gk, const float* dts,
                 const float* theta, const float* wy, const float* wi,
                 const float* bi, const float* wo, const float* bo,
                 const float* wn1, const float* wn2, const float* bn2,
                 const float* lat, float* ys, float* nb, float* nh, int M,
                 int B, int H, int HH,
                 int n_inner, int mult_y, int geometric, int drift, int noise,
                 int elem, int members, int mm, int bf16, void* stream) {
  const SdeDims d{M,     B,     H,    HH,      n_inner, mult_y, geometric,
                  drift, noise, elem, members, mm,      bf16};
  const FwdArgs A{y0, xh, dw,  a,   gk,  dts, theta, wy, wi, bi,
                  wo, bo, wn1, wn2, bn2, lat, ys,    nb, nh};
  return run_fwd(d, A, (cudaStream_t)stream, nullptr, true);
}

// The reverse recurrence of K members (inputs laid out as the forward's):
// dy0, dxh' (= dz1), d theta ([K]: the per-CTA partials p_th [K][ctas]
// summed), and the streams of the weight gradient: hs [NI+1][K][M][B][HH]
// (h_0..h_NI), es [NI][K][M][B][HH] (the cotangents of h_1..h_NI's
// inputs), dz3 [M][B][H], and by noise mode q [M][B][H] (the gk row's
// cotangent by row, 'precomp'), dn [M][B][H] (the cotangent of the noise
// net's first layer's output, the nets) and dz2 [M][B][H] (of its second
// layer's output, net2), each of those [K][...] as dy0 and dxh; the nets
// read the forward's nb and nh, the latent mode its rows lat. mm: the
// products' operand mode; bf16: y0 (rounded), ys, gys, xh and dW in bf16
// (every output fp32).
int fused_em_bwd(const float* y0, const float* ys, const float* gys,
                 const float* xh, const float* dw, const float* a,
                 const float* gk, const float* dts, const float* theta,
                 const float* wy, const float* wi, const float* bi,
                 const float* wo, const float* bo, const float* wn1,
                 const float* wn2, const float* lat, const float* nb,
                 const float* nh,
                 float* dxh, float* dy0, float* hs, float* es, float* dz3,
                 float* q, float* dn, float* dz2, float* p_th, float* dtheta,
                 int M, int B, int H, int HH, int n_inner, int mult_y,
                 int geometric, int drift, int noise, int elem, int members,
                 int mm, int bf16, void* stream) {
  const SdeDims d{M,     B,     H,    HH,      n_inner, mult_y, geometric,
                  drift, noise, elem, members, mm,      bf16};
  const BwdArgs A{y0,  ys,  gys, xh,  dw,  a,   gk, dts, theta, wy,
                  wi,  bi,  wo,  bo,  wn1, wn2, lat, nb, nh,  dxh,
                  dy0, hs,  es,  dz3, q,   dn,  dz2, p_th, dtheta};
  return run_bwd(d, A, (cudaStream_t)stream, nullptr, true);
}

// The weight gradient of K members from the recurrence's streams: the
// split partials p [K][...] (Wy' [S][H+1][HH] unless the drift is 'xt',
// each W_l [S][HH+1][HH], Wout [S][HH+1][H], then Wn1 and (net2) Wn2
// [S][H+1][H], one after another), their sums w [K][...] (the same without
// S; the last row of each the bias sum, zero for Wy' and Wn1), and the
// per-step column sums da [K][M][HH] of dxh and dgk [K][M][H] of q or dn;
// the products in operand mode mm (every tensor fp32: bf16 is unused).
int fused_em_wgrad(const float* y0, const float* ys, const float* dxh,
                   const float* hs, const float* es, const float* dz3,
                   const float* q, const float* dn, const float* dz2,
                   const float* nh, float* p, float* w, float* da,
                   float* dgk, int M, int B, int H, int HH, int n_inner,
                   int mult_y, int geometric, int drift, int noise, int elem,
                   int members, int mm, int bf16, void* stream) {
  (void)bf16;
  const SdeDims d{M,     B,     H,    HH,      n_inner, mult_y, geometric,
                  drift, noise, elem, members, mm,      0};
  return run_wgrad(d, y0, ys, dxh, hs, es, dz3, q, dn, dz2, nh, p, w, da,
                   dgk, (cudaStream_t)stream);
}

}  // extern "C"
