// The fused SRIW1 solve of a DiffusionField in the JAX kernels' reduced
// precisions: forward, backward recurrence and weight-gradient kernels for
// NVIDIA Hopper (sm_90a), plain C interface (loaded with ctypes by
// snsde_torch/kernels/fused_srk.py).
//
// Replaces the reduced-precision modes of the Pallas TPU kernels of
// snsde/kernels/fused_srk.py: _fused_srk_forward (pallas_call at :295) and
// _fused_srk_backward (pallas_call at :527) with cfg["mm_bf16"] (the
// operands of every in-kernel product, SNSDE_FUSED_MATMUL, :703; _dot in
// fused_em.py:67-107) and cfg["traj_bf16"] (bf16 streams,
// SNSDE_FUSED_STREAM, :661-666). The exact-fp32 launches run fused_srk.cu,
// which holds none of this code.
// * operands (mm, runtime): every product of the drift MLP, the noise nets
//   and, in the weight-gradient kernel (wgrad_kernel<BM, true>), of the
//   weight gradients rounds its operands to bf16 (MM_BF16) or splits them
//   into hi + lo (MM_X3: xh wh + xh wl + xl wh), accumulating in fp32;
//   the bias and per-step column sums stay exact.
// * streams (bs, runtime): xh0, xh1, dW, I10, the trajectory and gys are
//   bf16 in device memory, widened as they are read. The forward's carry
//   and its stage states stay fp32 and only the written trajectory is
//   rounded (:230); the backward recomputes each step, the noise nets too,
//   from the rounded state (the trajectory, y0 rounded by the wrapper,
//   :473), and writes the stage states and net2's hidden activations it
//   recomputed (nst, nh) for the weight gradient. Its streams for the
//   weight gradient are fp32 (dz1 too: the wrapper rounds the dxh0 and
//   dxh1 it hands back, :480-481).
// The drift and noise modes, mult_y, geometric and the elem option are
// runtime arguments too (one instance a kernel): the modes' speed is later
// work. The design is sde_reduced.cuh's: a block of RT threads runs the
// whole loop for R batch rows, every tile in shared memory, the weights
// read from device memory, one output a thread. What bounds it is the
// chain of dependent steps, each some twenty phases with a barrier
// between them, and the products' three FMAs and four conversions a term
// on the CUDA cores (bf16 mma is later speed work).

#include "sde_reduced.cuh"

namespace {

// the SRIW1 y-update weights (snsde/ops/solve.py:_SRK_*)
constexpr float ALPHA0 = 1.f / 3.f, ALPHA1 = 2.f / 3.f;
__constant__ float BETA1[4] = {-1.f, 4.f / 3.f, 2.f / 3.f, 0.f};
__constant__ float BETA2[4] = {-1.f, 4.f / 3.f, -1.f / 3.f, 0.f};
__constant__ float BETA3[4] = {2.f, -4.f / 3.f, -2.f / 3.f, 0.f};
__constant__ float BETA4[4] = {-2.f, 5.f / 3.f, -2.f / 3.f, 1.f};

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
  const float I11s = 0.5f * (dw * dw - k.dt) * k.rsq;
  const float I111r = (dw * dw * dw - 3.f * k.dt * dw) * (k.rdt / 6.f);
  const float I10r = i10 * k.rdt;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = BETA1[i] * dw + BETA2[i] * I11s + BETA3[i] * I10r +
           BETA4[i] * I111r;
}

// The tensors of a launch, laid out as fused_srk.cu's (member k's at k
// times a member's size; the backward's streams [E][K][M][B][...]); the
// streams y0 (the backward's), ys, gys, xh0, xh1, dW and I10 bf16 when bs
struct RedArgs {
  const void *y0, *ys, *gys, *xh0, *xh1, *dw, *i10;
  const float *a0, *a1, *gk0, *gk1, *gk2, *dts, *theta, *wy, *wi, *bi, *wo,
      *bo, *wn1, *wn2, *bn2;
  void* ys_out;
  float *dxh, *dy0, *hs, *es, *dz3, *q, *h01, *dn, *dz2, *nst, *nh, *p_th;
};

// a member's weights (device memory) and the launch's modes
struct Net {
  const float *wy, *wi, *bi, *wo, *bo, *wn1, *wn2, *bn2;
  int H, HH, NI, drift, noise, elem, mode;
  bool mult_y, geometric;
  float sth;
};

__device__ __forceinline__ Net net_of(const SdeDims& d, const RedArgs& A,
                                      int k) {
  const WtsIn m = member_wts(
      d, k, WtsIn{A.wy, A.wi, A.bi, A.wo, A.bo, A.wn1, A.wn2, A.bn2});
  Net w;
  w.wy = m.wy; w.wi = m.wi; w.bi = m.bi; w.wo = m.wo; w.bo = m.bo;
  w.wn1 = m.wn1; w.wn2 = m.wn2; w.bn2 = m.bn2;
  w.H = d.H; w.HH = d.HH; w.NI = d.NI; w.drift = d.drift; w.noise = d.noise;
  w.elem = d.elem; w.mode = d.mm; w.mult_y = d.mult_y;
  w.geometric = d.geometric;
  w.sth = sigmoid(A.theta[k]);
  return w;
}

// The shared-memory layout of a block of R rows, offsets in floats: H-wide
// tiles [R][H] (the state, its cotangent, H0_1, f0, f0's and f1's z3, the
// stages' states, bases, net2 hidden rows, raw diffusions and g's, four
// each, the stage cotangents, d f0, the state's running cotangent, H0_1's,
// a stage's, the bases' cotangents, four), HH-wide tiles [R][HH] (both
// evaluations' activations, NI + 1 each), two tiles [R][max(H, HH)] of
// back-product cotangents and one of product outputs, the step's streams
// (xh0, xh1 [R][HH]; dW, I10, gys [R][H]; a0, a1 [HH]; the gk rows [3][H])
// and RT floats for the block's sums.
struct RedLayout {
  long long y, gbar, h01, f0, z30, z31, st, base, hn, graw, g, dgs, df0, dy,
      dh01, ds, dq, hs0, hs1, dzA, dzB, tmp, xh0, xh1, dw, i10, gy, a0, a1,
      gk, red, total;
};

__host__ __device__ inline RedLayout red_layout(const SdeDims& d, int R) {
  const long long T = (long long)R * d.H, TH = (long long)R * d.HH;
  const long long TM = (long long)R * (d.H > d.HH ? d.H : d.HH);
  const long long NI1 = d.NI + 1;
  RedLayout L;
  Take take;
  L.y = take(T);
  L.gbar = take(T);
  L.h01 = take(T);
  L.f0 = take(T);
  L.z30 = take(T);
  L.z31 = take(T);
  L.st = take(4 * T);
  L.base = take(4 * T);
  L.hn = take(4 * T);
  L.graw = take(4 * T);
  L.g = take(4 * T);
  L.dgs = take(4 * T);
  L.df0 = take(T);
  L.dy = take(T);
  L.dh01 = take(T);
  L.ds = take(T);
  L.dq = take(4 * T);
  L.hs0 = take(NI1 * TH);
  L.hs1 = take(NI1 * TH);
  L.dzA = take(TM);
  L.dzB = take(TM);
  L.tmp = take(TM);
  L.xh0 = take(TH);
  L.xh1 = take(TH);
  L.dw = take(T);
  L.i10 = take(T);
  L.gy = take(T);
  L.a0 = take(d.HH);
  L.a1 = take(d.HH);
  L.gk = take(3LL * d.H);
  L.red = take(RT);
  L.total = take(0);
  return L;
}

// One drift MLP evaluation at X [nr][H] (xh [nr][HH] and the a row at its
// stage time): the activations hs [NI + 1][R][HH] (tile stride th), z3
// before the geometric factor, and f (unless null)
__device__ void drift_eval(const Net& w, int nr, const float* X,
                           const float* xh, const float* a, float* hs,
                           long long th, float* z3, float* f, float* tmp) {
  const int H = w.H, HH = w.HH;
  if (w.drift == DR_XT) {
    for (int i = threadIdx.x; i < nr * HH; i += RT) hs[i] = fmaxf(xh[i], 0.f);
  } else {
    red_prod(X, H, H, w.wy, false, nr, HH, tmp, HH, w.mode);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * HH; i += RT) {
      float v = tmp[i] + a[i % HH];
      if (w.drift == DR_EMBM) v += xh[i];
      hs[i] = fmaxf(v, 0.f);
    }
  }
  __syncthreads();
  for (int l = 0; l < w.NI; ++l) {
    red_prod(hs + l * th, HH, HH, w.wi + (size_t)l * HH * HH, false, nr, HH,
             tmp, HH, w.mode);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * HH; i += RT)
      hs[(l + 1) * th + i] = fmaxf(tmp[i] + w.bi[l * HH + i % HH], 0.f);
    __syncthreads();
  }
  red_prod(hs + w.NI * th, HH, HH, w.wo, false, nr, H, tmp, H, w.mode);
  __syncthreads();
  for (int i = threadIdx.x; i < nr * H; i += RT) {
    const float z = tmp[i] + w.bo[i % H];
    z3[i] = z;
    if (f) f[i] = tanhf(w.geometric ? z * tanhf(X[i]) : z);
  }
  __syncthreads();
}

// One diffusion evaluation at the stage state S [nr][H] with its row (the
// gk row, or the noise net's an1 row; unused in 'elem'): its base, net2's
// hidden row hn, the raw diffusion graw and g = tanh(sigmoid(theta) graw)
__device__ void noise_eval(const Net& w, int nr, const float* S,
                           const float* row, float* base, float* hn,
                           float* graw, float* g, float* tmp) {
  const int H = w.H;
  if (net_noise(w.noise)) {
    red_prod(S, H, H, w.wn1, false, nr, H, tmp, H, w.mode);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * H; i += RT) {
      const float v = tmp[i] + row[i % H];
      if (w.noise == NZ_NET1)
        base[i] = v;
      else
        hn[i] = fmaxf(v, 0.f);
    }
    __syncthreads();
    if (w.noise == NZ_NET2) {
      red_prod(hn, H, H, w.wn2, false, nr, H, tmp, H, w.mode);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * H; i += RT)
        base[i] = fmaxf(tmp[i] + w.bn2[i % H], 0.f);
    }
  }
  for (int i = threadIdx.x; i < nr * H; i += RT) {
    const float s = S[i];
    const float b = w.noise == NZ_PRE    ? row[i % H]
                    : w.noise == NZ_ELEM ? elem_base(w.elem, s)
                                         : base[i];
    base[i] = b;
    const float gr = w.mult_y ? b * s : b;
    graw[i] = gr;
    g[i] = tanhf(w.sth * gr);
  }
  __syncthreads();
}

// step u's streams of the block's rows: xh0, xh1, dW, I10 (and gys in the
// backward) widened, the a0, a1 and gk rows
__device__ void load_step(const SdeDims& d, const RedArgs& A,
                          const RedLayout& L, float* s, int k, int row0,
                          int nr, int u, bool bwd) {
  const int H = d.H, HH = d.HH;
  const bool bs = d.bs;
  const size_t ob = ((size_t)k * d.M + u) * d.B + row0;
  for (int i = threadIdx.x; i < nr * HH; i += RT) {
    if (d.drift != DR_YY) {
      s[L.xh0 + i] = ld_stream(A.xh0, ob * HH + i, bs);
      s[L.xh1 + i] = ld_stream(A.xh1, ob * HH + i, bs);
    }
  }
  for (int i = threadIdx.x; i < nr * H; i += RT) {
    s[L.dw + i] = ld_stream(A.dw, ob * H + i, bs);
    s[L.i10 + i] = ld_stream(A.i10, ob * H + i, bs);
    if (bwd) s[L.gy + i] = ld_stream(A.gys, ob * H + i, bs);
  }
  const size_t orow = (size_t)k * d.M + u;
  for (int i = threadIdx.x; i < HH; i += RT) {
    if (d.drift != DR_XT) {
      s[L.a0 + i] = A.a0[orow * HH + i];
      s[L.a1 + i] = A.a1[orow * HH + i];
    }
  }
  for (int i = threadIdx.x; i < H; i += RT) {
    if (d.noise != NZ_ELEM) {
      s[L.gk + i] = A.gk0[orow * H + i];
      s[L.gk + H + i] = A.gk1[orow * H + i];
      s[L.gk + 2 * H + i] = A.gk2[orow * H + i];
    }
  }
}

// The step's stages from y and f0 (the states of stages 1-3 into st's
// tiles 1-3, the evaluations into base, hn, graw, g) and H0_1
__device__ void srk_stages(const Net& w, int nr, const float* y,
                           const float* f0, const Step& k, float* st,
                           float* base, float* hn, float* graw, float* g,
                           float* h01, const float* gk, const float* i10,
                           long long T, float* tmp) {
  const int H = w.H, n = nr * H;
  noise_eval(w, nr, y, gk, base, hn, graw, g, tmp);
  for (int i = threadIdx.x; i < n; i += RT)
    st[T + i] = y[i] + 0.25f * k.dt * f0[i] + 0.5f * k.sq * g[i];
  __syncthreads();
  noise_eval(w, nr, st + T, gk + H, base + T, hn + T, graw + T, g + T, tmp);
  for (int i = threadIdx.x; i < n; i += RT)
    st[2 * T + i] = y[i] + k.dt * f0[i] - k.sq * g[i];
  __syncthreads();
  noise_eval(w, nr, st + 2 * T, gk + 2 * H, base + 2 * T, hn + 2 * T,
             graw + 2 * T, g + 2 * T, tmp);
  for (int i = threadIdx.x; i < n; i += RT)
    st[3 * T + i] =
        y[i] + 0.25f * k.dt * f0[i] +
        k.sq * (-5.f * g[i] + 3.f * g[T + i] + 0.5f * g[2 * T + i]);
  __syncthreads();
  noise_eval(w, nr, st + 3 * T, gk + H, base + 3 * T, hn + 3 * T,
             graw + 3 * T, g + 3 * T, tmp);
  for (int i = threadIdx.x; i < n; i += RT)
    h01[i] = y[i] + 0.75f * k.dt * f0[i] + 1.5f * (i10[i] * k.rdt) * g[i];
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The forward kernel
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(RT)
srk_red_fwd_kernel(SdeDims d, int R, RedArgs A) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const RedLayout L = red_layout(d, R);
  const int k = blockIdx.y, row0 = blockIdx.x * R;
  const int nr = min(R, d.B - row0), H = d.H;
  const long long T = (long long)R * H, TH = (long long)R * d.HH;
  const Net w = net_of(d, A, k);
  float *y = s + L.y, *f0 = s + L.f0, *f1 = s + L.df0, *h01 = s + L.h01;
  float *g = s + L.g, *tmp = s + L.tmp;
  const float* y0 = reinterpret_cast<const float*>(A.y0);
  for (int i = threadIdx.x; i < nr * H; i += RT)
    y[i] = y0[((size_t)k * d.B + row0) * H + i];
  for (int u = 0; u < d.M; ++u) {
    load_step(d, A, L, s, k, row0, nr, u, false);
    __syncthreads();
    const Step st = step_of(A.dts[u]);
    drift_eval(w, nr, y, s + L.xh0, s + L.a0, s + L.hs0, TH, s + L.z30, f0,
               tmp);
    srk_stages(w, nr, y, f0, st, s + L.st, s + L.base, s + L.hn, s + L.graw,
               g, h01, s + L.gk, s + L.i10, T, tmp);
    drift_eval(w, nr, h01, s + L.xh1, s + L.a1, s + L.hs1, TH, s + L.z31, f1,
               tmp);
    const size_t ob = (((size_t)k * d.M + u) * d.B + row0) * H;
    for (int i = threadIdx.x; i < nr * H; i += RT) {
      float c[4];
      srk_coeffs(s[L.dw + i], s[L.i10 + i], st, c);
      float yn = y[i] + st.dt * (ALPHA0 * f0[i] + ALPHA1 * f1[i]);
#pragma unroll
      for (int j = 0; j < 4; ++j) yn = yn + c[j] * g[j * T + i];
      y[i] = yn;
      st_stream(A.ys_out, ob + i, yn, d.bs);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// The backward recurrence kernel
// ---------------------------------------------------------------------------

// Back through one evaluation's MLP from dz3 (tile dz, stride H): the
// cotangents of h_1..h_NI's inputs into es's evaluation `ev` at step u, and
// dz1 (the returned tile, stride HH; the other of dz and spare holds the
// rest)
__device__ float* mlp_back(const SdeDims& d, const Net& w, int nr,
                           float* dz, float* spare, const float* hs,
                           long long th, float* tmp, float* es, int ev,
                           int k, int u, int row0) {
  const int H = w.H, HH = w.HH;
  const size_t KMBH = (size_t)d.K * d.M * d.B * HH;
  const size_t ob = (((size_t)k * d.M + u) * d.B + row0) * HH;
  red_prod(dz, H, H, w.wo, true, nr, HH, tmp, HH, w.mode);
  __syncthreads();
  float* cur = spare;
  for (int i = threadIdx.x; i < nr * HH; i += RT)
    cur[i] = hs[w.NI * th + i] > 0.f ? tmp[i] : 0.f;
  __syncthreads();
  float* nxt = dz;
  for (int l = w.NI - 1; l >= 0; --l) {
    float* e = es + ((size_t)l * 2 + ev) * KMBH + ob;
    for (int i = threadIdx.x; i < nr * HH; i += RT) e[i] = cur[i];
    red_prod(cur, HH, HH, w.wi + (size_t)l * HH * HH, true, nr, HH, tmp, HH,
             w.mode);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * HH; i += RT)
      nxt[i] = hs[l * th + i] > 0.f ? tmp[i] : 0.f;
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  return cur;
}

// Reverse diffusion stage i given its g's cotangent (dgs tile i): adds to
// the theta sum, sets its base's cotangent (dq tile i), writes the nets'
// output cotangents (dn, dz2 at stage i, step u), and leaves the cotangent
// of its state in ds
__device__ void stage_bwd(const SdeDims& d, const Net& w, int nr, int i,
                          const float* S, float* base, float* hn,
                          float* graw, float* g, float* dgs, float* dq,
                          float* ds, float* tmp, float* scratch,
                          const RedArgs& A, size_t ob, long long T,
                          float& th_acc) {
  const int H = w.H, n = nr * H;
  const size_t KMBH = (size_t)d.K * d.M * d.B * H;
  for (int j = threadIdx.x; j < n; j += RT) {
    const float gv = g[i * T + j];
    const float dsg = dgs[i * T + j] * (1.f - gv * gv);
    th_acc = fmaf(dsg, graw[i * T + j], th_acc);
    const float dgraw = dsg * w.sth;
    float db = dgraw, dd = 0.f;
    if (w.mult_y) {
      db = dgraw * S[j];
      dd = dgraw * base[i * T + j];
    }
    dq[i * T + j] = db;
    if (w.noise == NZ_ELEM) dd = dd + db * elem_deriv(w.elem, S[j]);
    ds[j] = dd;
  }
  if (!net_noise(w.noise)) {
    __syncthreads();
    return;
  }
  __syncthreads();
  const float* dn_t = dq + i * T;
  if (w.noise == NZ_NET2) {
    // dz2 = dbase (base > 0); dn = (dz2 Wn2^T) (hn > 0)
    for (int j = threadIdx.x; j < n; j += RT) {
      const float v = base[i * T + j] > 0.f ? dq[i * T + j] : 0.f;
      scratch[j] = v;
      A.dz2[i * KMBH + ob + j] = v;
    }
    __syncthreads();
    red_prod(scratch, H, H, w.wn2, true, nr, H, tmp, H, w.mode);
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += RT)
      scratch[j] = hn[i * T + j] > 0.f ? tmp[j] : 0.f;
    __syncthreads();
    dn_t = scratch;
  }
  for (int j = threadIdx.x; j < n; j += RT) A.dn[i * KMBH + ob + j] = dn_t[j];
  red_prod(dn_t, H, H, w.wn1, true, nr, H, tmp, H, w.mode);
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += RT) ds[j] = ds[j] + tmp[j];
  __syncthreads();
}

__global__ void __launch_bounds__(RT)
srk_red_bwd_kernel(SdeDims d, int R, RedArgs A) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const RedLayout L = red_layout(d, R);
  const int k = blockIdx.y, row0 = blockIdx.x * R;
  const int nr = min(R, d.B - row0), H = d.H, HH = d.HH, n = nr * H;
  const long long T = (long long)R * H, TH = (long long)R * HH;
  const Net w = net_of(d, A, k);
  const bool bs = d.bs;
  float *y = s + L.y, *gbar = s + L.gbar, *h01 = s + L.h01, *f0 = s + L.f0;
  float *z30 = s + L.z30, *z31 = s + L.z31, *st = s + L.st;
  float *base = s + L.base, *hn = s + L.hn, *graw = s + L.graw, *g = s + L.g;
  float *dgs = s + L.dgs, *df0 = s + L.df0, *dy = s + L.dy;
  float *dh01 = s + L.dh01, *ds = s + L.ds, *dq = s + L.dq;
  float *hs0 = s + L.hs0, *hs1 = s + L.hs1, *tmp = s + L.tmp;
  const float *dwu = s + L.dw, *iu = s + L.i10;
  const size_t MBH = (size_t)d.M * d.B * H, KMBH = d.K * MBH;
  const size_t KMBHH = (size_t)d.K * d.M * d.B * HH;
  for (int i = threadIdx.x; i < n; i += RT) gbar[i] = 0.f;
  float th_acc = 0.f;
  for (int u = d.M - 1; u >= 0; --u) {
    load_step(d, A, L, s, k, row0, nr, u, true);
    // the state before the step: y0 (rounded by the wrapper with bf16
    // streams) or the trajectory's entry u - 1
    for (int i = threadIdx.x; i < n; i += RT)
      y[i] = u == 0 ? ld_stream(A.y0, ((size_t)k * d.B + row0) * H + i, bs)
                    : ld_stream(A.ys,
                                (((size_t)k * d.M + u - 1) * d.B + row0) * H +
                                    i,
                                bs);
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += RT) gbar[i] = gbar[i] + s[L.gy + i];
    const Step sp = step_of(A.dts[u]);
    // the step recomputed (the nets too)
    drift_eval(w, nr, y, s + L.xh0, s + L.a0, hs0, TH, z30, f0, tmp);
    srk_stages(w, nr, y, f0, sp, st, base, hn, graw, g, h01, s + L.gk, iu, T,
               tmp);
    drift_eval(w, nr, h01, s + L.xh1, s + L.a1, hs1, TH, z31, nullptr, tmp);
    const size_t ob = ((size_t)k * d.M + u) * d.B * H + (size_t)row0 * H;
    const size_t obh = ((size_t)k * d.M + u) * d.B * HH + (size_t)row0 * HH;
    for (int l = 0; l <= w.NI; ++l)
      for (int i = threadIdx.x; i < nr * HH; i += RT) {
        A.hs[((size_t)l * 2) * KMBHH + obh + i] = hs0[l * TH + i];
        A.hs[((size_t)l * 2 + 1) * KMBHH + obh + i] = hs1[l * TH + i];
      }
    for (int i = threadIdx.x; i < n; i += RT) {
      A.h01[ob + i] = h01[i];
      if (net_noise(w.noise))
        for (int j = 1; j < 4; ++j) A.nst[(j - 1) * KMBH + ob + i] = st[j * T + i];
      if (w.noise == NZ_NET2)
        for (int j = 0; j < 4; ++j) A.nh[j * KMBH + ob + i] = hn[j * T + i];
    }
    // f1: dz3 from df1 = gbar alpha1 dt, back through its MLP, dz1 Wy'^T
    float* dz = s + L.dzA;
    for (int i = threadIdx.x; i < n; i += RT) {
      const float df1 = gbar[i] * (ALPHA1 * sp.dt);
      const float zl = z31[i], fty = tanhf(h01[i]);
      const float f = tanhf(w.geometric ? zl * fty : zl);
      float v = df1 * (1.f - f * f);
      dh01[i] = 0.f;
      if (w.geometric) {
        dh01[i] = v * zl * (1.f - fty * fty);
        v = v * fty;
      }
      dz[i] = v;
      A.dz3[KMBH + ob + i] = v;
    }
    __syncthreads();
    float* dz1 = mlp_back(d, w, nr, dz, s + L.dzB, hs1, TH, tmp, A.es, 1, k,
                          u, row0);
    for (int i = threadIdx.x; i < nr * HH; i += RT)
      A.dxh[KMBHH + obh + i] = dz1[i];
    if (w.drift != DR_XT) {
      red_prod(dz1, HH, HH, w.wy, true, nr, H, tmp, H, w.mode);
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += RT) dh01[i] = dh01[i] + tmp[i];
    }
    __syncthreads();
    // the diffusion stages in reverse, g3, g2, g1, g0
    for (int i = threadIdx.x; i < n; i += RT) {
      float c[4];
      srk_coeffs(dwu[i], iu[i], sp, c);
      const float gb = gbar[i];
      df0[i] = gb * (ALPHA0 * sp.dt) + 0.75f * sp.dt * dh01[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) dgs[j * T + i] = gb * c[j];
      dgs[i] = dgs[i] + 1.5f * (iu[i] * sp.rdt) * dh01[i];
      dy[i] = gb + dh01[i];
    }
    __syncthreads();
    float* scratch = s + L.dzB;
    stage_bwd(d, w, nr, 3, st + 3 * T, base, hn, graw, g, dgs, dq, ds, tmp,
              scratch, A, ob, T, th_acc);
    for (int i = threadIdx.x; i < n; i += RT) {
      const float v = ds[i];
      dy[i] = dy[i] + v;
      df0[i] = df0[i] + 0.25f * sp.dt * v;
      dgs[i] = dgs[i] - 5.f * sp.sq * v;
      dgs[T + i] = dgs[T + i] + 3.f * sp.sq * v;
      dgs[2 * T + i] = dgs[2 * T + i] + 0.5f * sp.sq * v;
    }
    __syncthreads();
    stage_bwd(d, w, nr, 2, st + 2 * T, base, hn, graw, g, dgs, dq, ds, tmp,
              scratch, A, ob, T, th_acc);
    for (int i = threadIdx.x; i < n; i += RT) {
      const float v = ds[i];
      dy[i] = dy[i] + v;
      df0[i] = df0[i] + sp.dt * v;
      dgs[i] = dgs[i] - sp.sq * v;
    }
    __syncthreads();
    stage_bwd(d, w, nr, 1, st + T, base, hn, graw, g, dgs, dq, ds, tmp,
              scratch, A, ob, T, th_acc);
    for (int i = threadIdx.x; i < n; i += RT) {
      const float v = ds[i];
      dy[i] = dy[i] + v;
      df0[i] = df0[i] + 0.25f * sp.dt * v;
      dgs[i] = dgs[i] + 0.5f * sp.sq * v;
    }
    __syncthreads();
    stage_bwd(d, w, nr, 0, y, base, hn, graw, g, dgs, dq, ds, tmp, scratch,
              A, ob, T, th_acc);
    for (int i = threadIdx.x; i < n; i += RT) {
      dy[i] = dy[i] + ds[i];
      if (w.noise == NZ_PRE) {
        A.q[ob + i] = dq[i];
        A.q[KMBH + ob + i] = dq[3 * T + i] + dq[T + i];
        A.q[2 * KMBH + ob + i] = dq[2 * T + i];
      }
    }
    // f0: dz3 from d f0, back through its MLP; the state's cotangent
    for (int i = threadIdx.x; i < n; i += RT) {
      const float zl = z30[i], fty = tanhf(y[i]);
      const float f = tanhf(w.geometric ? zl * fty : zl);
      float v = df0[i] * (1.f - f * f);
      dh01[i] = 0.f;  // here the state's cotangent through f0's tanh(y)
      if (w.geometric) {
        dh01[i] = v * zl * (1.f - fty * fty);
        v = v * fty;
      }
      dz[i] = v;
      A.dz3[ob + i] = v;
    }
    __syncthreads();
    dz1 = mlp_back(d, w, nr, dz, s + L.dzB, hs0, TH, tmp, A.es, 0, k, u,
                   row0);
    for (int i = threadIdx.x; i < nr * HH; i += RT) A.dxh[obh + i] = dz1[i];
    for (int i = threadIdx.x; i < n; i += RT) gbar[i] = dy[i] + dh01[i];
    if (w.drift != DR_XT) {
      red_prod(dz1, HH, HH, w.wy, true, nr, H, tmp, H, w.mode);
      __syncthreads();
      for (int i = threadIdx.x; i < n; i += RT) gbar[i] = gbar[i] + tmp[i];
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < n; i += RT)
    A.dy0[((size_t)k * d.B + row0) * H + i] = gbar[i];
  // d theta: the block's sum through sigmoid'
  const float t = red_block_sum(th_acc, s + L.red);
  if (threadIdx.x == 0)
    A.p_th[(size_t)k * gridDim.x + blockIdx.x] = t * w.sth * (1.f - w.sth);
}

// ---------------------------------------------------------------------------
// The host side
// ---------------------------------------------------------------------------

inline bool red_valid(const SdeDims& d) {
  return sde_valid(d) && sde_modes_valid(d.drift, d.noise, d.elem);
}

inline long long red_bytes(const SdeDims& d, int R) {
  return red_layout(d, R).total * (long long)sizeof(float);
}

// rows a block (0: none fits the device)
inline int srk_red_rows(const SdeDims& d) {
  return red_rows([&](int R) { return red_bytes(d, R); });
}

int run(const SdeDims& d, const RedArgs& A, int backward, float* dtheta,
        cudaStream_t s) {
  if (!red_valid(d)) return (int)cudaErrorInvalidValue;
  const int R = srk_red_rows(d);
  if (!R) return (int)cudaErrorInvalidValue;
  const int blocks = (d.B + R - 1) / R;
  const long long bytes = red_bytes(d, R);
  if (!backward) return red_launch(srk_red_fwd_kernel, blocks, d.K, bytes, s,
                                   d, R, A);
  const int err = red_launch(srk_red_bwd_kernel, blocks, d.K, bytes, s, d, R,
                             A);
  if (err) return err;
  // d theta of each member: its blocks' partials summed in a fixed order
  return run_split_sums({SplitSum{A.p_th, dtheta, 1, blocks, 1, blocks}},
                        d.K, s);
}

// The weight gradient of fused_srk.cu's run_wgrad with the products'
// operands in mode d.mm (wgrad_kernel<BM, true>)
int run_wgrad(const SdeDims& d, const float* y0, const float* ys,
              const float* h01, const float* dxh, const float* hs,
              const float* es, const float* dz3, const float* q,
              const float* nst, const float* dn, const float* nh,
              const float* dz2, float* p, float* w, float* da, float* dgk,
              cudaStream_t s) {
  if (!red_valid(d)) return (int)cudaErrorInvalidValue;
  const long long MB = (long long)d.M * d.B, K = 2 * MB;
  const long long BH = (long long)d.B * d.H, MBH = MB * d.H;
  const int seg = d.K > 1 ? (int)MB : 0, sseg = d.K > 1 ? d.M : 0;
  const long long gap = (long long)d.K * MB, sgap = (long long)d.K * d.M;
  const WgPlan wp = wg_plan(d, K);
  std::vector<WgJob> jobs, njobs;
  long long per = wg_jobs(d, wp, K, y0, ys, h01, d.B, (int)MB, BH, MBH, MBH,
                          MB, seg, gap, dxh, hs, es, dz3, p, jobs);
  wg_noise_jobs(d, wp, y0, ys, nst, d.B, (int)MB, BH, MBH, MBH, MB, seg, gap,
                dn, nh, dz2, p + per, njobs);
  per += (long long)wp.S * (d.H + 1) * d.H * noise_jobs(d);
  set_member_partials(jobs, per);
  set_member_partials(njobs, per);
  const long long M = d.M;
  WgSum sums[WG_MAX_SUMS];
  int ns = 0;
  if (d.drift != DR_XT)
    sums[ns++] =
        WgSum{dxh, da, d.HH, 2 * d.M, MB * d.HH, 2 * M * d.HH, sseg, sgap};
  if (d.noise == NZ_PRE)
    sums[ns++] = WgSum{q, dgk, d.H, 3 * d.M, MBH, 3 * M * d.H, sseg, sgap};
  int err = run_wgrad_jobs(jobs, sums, ns, K, d.B, wp, d.K, s, d.mm);
  if (!err && net_noise(d.noise)) {
    const WgSum nsum{dn, dgk, d.H, 4 * d.M, MBH, 4 * M * d.H, sseg, sgap};
    err = run_wgrad_jobs(njobs, &nsum, 1, 4 * MB, d.B, wp, d.K, s, d.mm);
  }
  if (err) return err;
  jobs.insert(jobs.end(), njobs.begin(), njobs.end());
  long long wm = 0;
  for (const WgJob& J : jobs) wm += (long long)(J.rows + 1) * J.N;
  return run_split_sums(wg_split_sums(jobs, wp, w, per, wm), d.K, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a launch, in bytes (the forward
// and the backward take the same layout; above the device's limit when
// not even one row fits).
long long fused_srk_red_smem_bytes(int B, int H, int HH, int n_inner,
                                   int drift, int noise, int members,
                                   int backward) {
  (void)backward;
  if (!sde_modes_valid(drift, noise, 7) || members < 1) return -1;
  const SdeDims d{1, B, H, HH, n_inner, 0, 0, drift, noise, 7, members, 0, 0};
  const int R = srk_red_rows(d);
  return red_bytes(d, R ? R : 1);
}

// One field of a launch's plan (fused_srk_plan's fields): 0 the level
// (0), 1 batch rows a block, 2 blocks a cluster (1), 3 blocks a member,
// 4 shared bytes a block.
int fused_srk_red_plan(int B, int H, int HH, int n_inner, int drift,
                       int noise, int members, int backward, int field) {
  (void)backward;
  if (!sde_modes_valid(drift, noise, 7) || members < 1)
    return -(int)cudaErrorInvalidValue;
  const SdeDims d{1, B, H, HH, n_inner, 0, 0, drift, noise, 7, members, 0, 0};
  const int R = srk_red_rows(d);
  switch (field) {
    case 0: return 0;
    case 1: return R;
    case 2: return 1;
    case 3: return R ? (B + R - 1) / R : 0;
  }
  return (int)red_bytes(d, R ? R : 1);
}

// The splits of the weight gradient's K at (M, B, H, HH, n_inner) in the
// modes (fused_srk_wgrad_splits').
int fused_srk_red_wgrad_splits(int M, int B, int H, int HH, int n_inner,
                               int drift, int noise) {
  return wg_plan(SdeDims{M, B, H, HH, n_inner, 0, 0, drift, noise, 0, 1, 0,
                         0},
                 2LL * M * B).S;
}

int fused_srk_red_max_smem() { return max_optin_smem(); }

const char* fused_srk_red_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The forward of K members in operand mode mm (MM_*), with bf16 streams
// when bf16: ys [K][M][B][H] (bf16 when bf16); inputs as fused_srk_fwd's
// (xh0, xh1, dw and i10 bf16 when bf16), and bn2 for net2.
int fused_srk_red_fwd(const float* y0, const void* xh0, const void* xh1,
                      const void* dw, const void* i10, const float* a0,
                      const float* a1, const float* gk0, const float* gk1,
                      const float* gk2, const float* dts,
                      const float* theta, const float* wy, const float* wi,
                      const float* bi, const float* wo, const float* bo,
                      const float* wn1, const float* wn2, const float* bn2,
                      void* ys, int M, int B, int H, int HH, int n_inner,
                      int mult_y, int geometric, int drift, int noise,
                      int elem, int members, int mm, int bf16,
                      void* stream) {
  RedArgs A{};
  A.y0 = y0; A.xh0 = xh0; A.xh1 = xh1; A.dw = dw; A.i10 = i10; A.a0 = a0;
  A.a1 = a1; A.gk0 = gk0; A.gk1 = gk1; A.gk2 = gk2; A.dts = dts;
  A.theta = theta; A.wy = wy; A.wi = wi; A.bi = bi; A.wo = wo; A.bo = bo;
  A.wn1 = wn1; A.wn2 = wn2; A.bn2 = bn2; A.ys_out = ys;
  return run(SdeDims{M, B, H, HH, n_inner, mult_y, geometric, drift, noise,
                     elem, members, mm, bf16 != 0},
             A, 0, nullptr, (cudaStream_t)stream);
}

// The reverse recurrence of K members in operand mode mm, with bf16
// streams when bf16 (y0, rounded by the caller, ys, gys, xh0, xh1, dw and
// i10 in bf16): the outputs of fused_srk_bwd (every stream fp32), with the
// noise nets recomputed from the state rather than read from the forward:
// their stage states nst [3][K][M][B][H] and net2's hidden activations nh
// [4][K][M][B][H] are written for the weight gradient; p_th holds
// [K][blocks] partials.
int fused_srk_red_bwd(const void* y0, const void* ys, const void* gys,
                      const void* xh0, const void* xh1, const void* dw,
                      const void* i10, const float* a0, const float* a1,
                      const float* gk0, const float* gk1, const float* gk2,
                      const float* dts, const float* theta, const float* wy,
                      const float* wi, const float* bi, const float* wo,
                      const float* bo, const float* wn1, const float* wn2,
                      const float* bn2, float* dxh, float* dy0, float* hs,
                      float* es, float* dz3, float* q, float* h01, float* dn,
                      float* dz2, float* nst, float* nh, float* p_th,
                      float* dtheta, int M, int B, int H, int HH,
                      int n_inner, int mult_y, int geometric, int drift,
                      int noise, int elem, int members, int mm, int bf16,
                      void* stream) {
  RedArgs A{};
  A.y0 = y0; A.ys = ys; A.gys = gys; A.xh0 = xh0; A.xh1 = xh1; A.dw = dw;
  A.i10 = i10; A.a0 = a0; A.a1 = a1; A.gk0 = gk0; A.gk1 = gk1; A.gk2 = gk2;
  A.dts = dts; A.theta = theta; A.wy = wy; A.wi = wi; A.bi = bi; A.wo = wo;
  A.bo = bo; A.wn1 = wn1; A.wn2 = wn2; A.bn2 = bn2;
  A.dxh = dxh; A.dy0 = dy0; A.hs = hs; A.es = es; A.dz3 = dz3; A.q = q;
  A.h01 = h01; A.dn = dn; A.dz2 = dz2; A.nst = nst; A.nh = nh; A.p_th = p_th;
  return run(SdeDims{M, B, H, HH, n_inner, mult_y, geometric, drift, noise,
                     elem, members, mm, bf16 != 0},
             A, 1, dtheta, (cudaStream_t)stream);
}

// The weight gradient of K members as fused_srk_wgrad's, the products'
// operands in mode mm (every tensor fp32: bf16 is unused).
int fused_srk_red_wgrad(const float* y0, const float* ys, const float* h01,
                        const float* dxh, const float* hs, const float* es,
                        const float* dz3, const float* q, const float* nst,
                        const float* dn, const float* nh, const float* dz2,
                        float* p, float* w, float* da, float* dgk, int M,
                        int B, int H, int HH, int n_inner, int mult_y,
                        int geometric, int drift, int noise, int elem,
                        int members, int mm, int bf16, void* stream) {
  (void)bf16;
  return run_wgrad(SdeDims{M, B, H, HH, n_inner, mult_y, geometric, drift,
                           noise, elem, members, mm, 0},
                   y0, ys, h01, dxh, hs, es, dz3, q, nst, dn, nh, dz2, p, w,
                   da, dgk, (cudaStream_t)stream);
}

}  // extern "C"
