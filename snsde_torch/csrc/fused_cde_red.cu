// The fused explicit Runge–Kutta CDE solve in the JAX kernels' reduced
// precisions: forward and backward kernels for NVIDIA Hopper (sm_90a),
// plain C interface (loaded with ctypes by snsde_torch/kernels/fused_cde.py).
//
// Replaces the reduced-precision modes of the Pallas TPU kernels of
// snsde/kernels/fused_cde.py: _fused_cde_forward (pallas_call at :364) and
// _fused_cde_backward (pallas_call at :505) with cfg["mm_bf16"] (the
// operands of every in-kernel product, SNSDE_FUSED_MATMUL, :697-698; the
// GRU-ODE field's pinned to exact fp32, :691-697) and cfg["traj_bf16"]
// (bf16 streams, SNSDE_FUSED_STREAM, :650-655). The exact-fp32 launches run
// fused_cde.cu, which holds none of this code.
// * operands (mm, runtime; the MLP fields only): every product of the
//   field's MLP and of its weight gradients rounds its operands to bf16
//   (MM_BF16) or splits them into hi + lo (MM_X3), accumulating in fp32,
//   and so do the JAX kernel's one-hot contractions (:200-201 and their
//   transposes :227-229, :445): d through E (each d_c), O Dx through S
//   (each term before the sum over c), dk through S^T (each dk_h) and the
//   control's cotangent through E^T (each term before the sum over h).
// * streams (bs, runtime): the derivative stream dx, the trajectory, gys
//   and ddx are bf16 in device memory; the forward's carry stays fp32 and
//   only the written trajectory is rounded (:343); the backward recomputes
//   each step from the rounded state (z0 rounded by the wrapper, :464).
// The field kind (relu, tanh, gruode) and the tableau are runtime
// arguments (one instance a kernel): their speed is later work. The design
// is sde_reduced.cuh's: a block of RT threads runs the whole loop for R
// batch rows, every tile in shared memory, the weights read from device
// memory, one output a thread; the backward keeps each block's weight
// gradients as partials [K][blocks][P] in device memory (cde_parts'
// order, fused_cde.cu), summed in ascending block order afterwards, so a
// packed member is its solo launch bit for bit. What bounds it is the
// chain of dependent stages and the products' three FMAs and four
// conversions a term on the CUDA cores (bf16 mma is later speed work).

#include "sde_reduced.cuh"

namespace {

// the field kinds (the C interface's act codes)
constexpr int ACT_RELU = 0, ACT_TANH = 1, ACT_GRU = 2;
constexpr int MAX_STAGES = 4;

// the tableau of a method code (0 euler, 1 midpoint, 2 heun/rk2, 3 rk4):
// stage i's state z + a[i] dt k_{i-1}, its distinct stage time t[i], the
// update's weights b (fused_cde.cu's Tab)
struct Tab {
  int ns, nt;
  float a[MAX_STAGES], b[MAX_STAGES];
  int t[MAX_STAGES];
};

inline bool tableau(int method, Tab* T) {
  switch (method) {
    case 0: *T = Tab{1, 1, {0.f}, {1.f}, {0}}; return true;
    case 1: *T = Tab{2, 2, {0.f, 0.5f}, {0.f, 1.f}, {0, 1}}; return true;
    case 2: *T = Tab{2, 2, {0.f, 1.f}, {0.5f, 0.5f}, {0, 1}}; return true;
    case 3:
      *T = Tab{4, 3, {0.f, 0.5f, 0.5f, 1.f},
               {1.f / 6.f, 1.f / 3.f, 1.f / 3.f, 1.f / 6.f}, {0, 1, 1, 2}};
      return true;
  }
  return false;
}

struct CdeDims {
  int M, B, H, HH, C, NI, K, act, mm, bs;
};

// a member's weights (device memory): the MLP's, or the GRU-ODE field's
// gates W [3][H][H C] and b [3][H C] in wo's and bo's places
struct CdeArgs {
  const void *z0, *ys, *gys, *dx;
  const float *dts, *win, *bin, *wi, *bi, *wo, *bo;
  void *ys_out, *ddx;
  float *dz0, *part, *grads;
};

struct CdeWts {
  const float *win, *bin, *wi, *bi, *wo, *bo;
};

// the sizes in floats of a member's weights, in the partials' order
struct CdeParts {
  long long win, bin, wi, bi, wo, bo, total;
};

__host__ __device__ inline CdeParts cde_parts(const CdeDims& d) {
  const bool gru = d.act == ACT_GRU;
  const long long HH = d.HH, HC = (long long)d.H * d.C, G = gru ? 3 : 1;
  CdeParts s;
  s.win = gru ? 0 : (long long)d.H * HH;
  s.bin = gru ? 0 : HH;
  s.wi = gru ? 0 : d.NI * HH * HH;
  s.bi = gru ? 0 : d.NI * HH;
  s.wo = G * HH * HC;
  s.bo = G * HC;
  s.total = s.win + s.bin + s.wi + s.bi + s.wo + s.bo;
  return s;
}

__device__ __forceinline__ CdeWts cde_wts(const CdeDims& d,
                                          const CdeArgs& A, int k) {
  const CdeParts p = cde_parts(d);
  auto at = [&](const float* t, long long n) {
    return t ? t + (size_t)k * n : t;
  };
  return CdeWts{at(A.win, p.win), at(A.bin, p.bin), at(A.wi, p.wi),
             at(A.bi, p.bi),   at(A.wo, p.wo),   at(A.bo, p.bo)};
}

// The shared-memory layout of a block of R rows, offsets in floats: the
// state, its cotangent, a stage's state cotangent [R][H]; the stages'
// states, increments and increments' cotangents [MAX_STAGES][R][H]; the
// MLP's activations [NI + 1][R][HH] or the gates r, u, zh, tanh(r zh)
// [4][R][H C] and their state-expand cotangent [R][H]; O and its
// cotangent [R][H C]; two back-product tiles and
// one of product outputs [R][max(H, HH, H C)]; the step's derivative row
// and its cotangent [R][NT C].
struct RedLayout {
  long long z, gbar, dy, st, ks, dks, hs, gates, gsum, o, dout, dzA, dzB,
      tmp, dx, dd, total;
};

__host__ __device__ inline RedLayout red_layout(const CdeDims& d, int R,
                                                int NT) {
  const long long T = (long long)R * d.H, HC = (long long)d.H * d.C;
  long long W = d.H > d.HH ? d.H : d.HH;
  W = W > HC ? W : HC;
  RedLayout L;
  Take take;
  L.z = take(T);
  L.gbar = take(T);
  L.dy = take(T);
  L.st = take(MAX_STAGES * T);
  L.ks = take(MAX_STAGES * T);
  L.dks = take(MAX_STAGES * T);
  L.hs = d.act == ACT_GRU ? -1 : take((d.NI + 1LL) * R * d.HH);
  L.gates = d.act == ACT_GRU ? take(4 * R * HC) : -1;
  L.gsum = d.act == ACT_GRU ? take(T) : -1;
  L.o = take(R * HC);
  L.dout = take(R * HC);
  L.dzA = take(R * W);
  L.dzB = take(R * W);
  L.tmp = take(R * W);
  L.dx = take((long long)R * NT * d.C);
  L.dd = take((long long)R * NT * d.C);
  L.total = take(0);
  return L;
}

struct Field {
  CdeWts w;
  int H, HH, C, NI, act, mode, R;
  float* tmp;
};

__device__ __forceinline__ float act_of(int act, float z) {
  return act == ACT_RELU ? fmaxf(z, 0.f) : tanhf(z);
}

// derivative of the activation from its output h
__device__ __forceinline__ float act_d(int act, float h) {
  return act == ACT_RELU ? (h > 0.f ? 1.f : 0.f) : 1.f - h * h;
}

// One field evaluation at y [nr][H] against the stage's derivative row d
// (stride ldd): the MLP's activations hs or the gates (aux), O, and k
// [nr][H] (k[h] = sum_c O[h C + c] Dx_c, each product through the one-hot
// contraction in the operand mode)
__device__ void field_eval(const Field& f, int nr, const float* y,
                           const float* d, int ldd, float* aux, float* o,
                           float* kout) {
  const int H = f.H, HH = f.HH, C = f.C, HC = H * C;
  float* tmp = f.tmp;
  if (f.act == ACT_GRU) {
    const long long TC = (long long)f.R * HC;
    for (int gi = 0; gi < 3; ++gi) {
      red_prod(y, H, H, f.w.wo + (size_t)gi * H * HC, false, nr, HC, tmp,
               HC, MM_F32);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * HC; i += RT) {
        const float z = tmp[i] + f.w.bo[gi * HC + i % HC];
        aux[gi * TC + i] = gi == 2 ? z : sigmoid(z);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < nr * HC; i += RT) {
      const int r = i / HC, h = (i % HC) / C;
      const float gv = tanhf(aux[i] * aux[2 * TC + i]);
      aux[3 * TC + i] = gv;
      o[i] = (1.f - aux[TC + i]) * (gv - y[r * H + h]);
    }
  } else {
    const long long TH = (long long)f.R * HH;
    red_prod(y, H, H, f.w.win, false, nr, HH, tmp, HH, f.mode);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * HH; i += RT)
      aux[i] = act_of(f.act, tmp[i] + f.w.bin[i % HH]);
    __syncthreads();
    for (int l = 0; l < f.NI; ++l) {
      red_prod(aux + l * TH, HH, HH, f.w.wi + (size_t)l * HH * HH, false, nr,
               HH, tmp, HH, f.mode);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * HH; i += RT)
        aux[(l + 1) * TH + i] =
            act_of(f.act, tmp[i] + f.w.bi[l * HH + i % HH]);
      __syncthreads();
    }
    red_prod(aux + f.NI * TH, HH, HH, f.w.wo, false, nr, HC, tmp, HC, f.mode);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * HC; i += RT)
      o[i] = tanhf(tmp[i] + f.w.bo[i % HC]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr * H; i += RT) {
    const int r = i / H, h = i % H;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc += one_hot(o[r * HC + h * C + c] * one_hot(d[r * ldd + c], f.mode),
                     f.mode);
    kout[i] = acc;
  }
  __syncthreads();
}

// part[i j] += sum_r X[r][i] E[r][j] (i < I, j < J; the product in the
// operand mode), then part[I J + j] += sum_r E[r][j] when bias
__device__ void red_outer(const float* X, int ldx, int I, const float* E,
                          int lde, int J, int nr, float* part, bool bias,
                          int mode) {
  const bool x3 = mode == MM_X3;
  for (int idx = threadIdx.x; idx < I * J; idx += RT) {
    const int i = idx / J, j = idx - i * J;
    float acc = 0.f;
    for (int r = 0; r < nr; ++r)
      acc = mode == MM_F32
                ? fmaf(X[r * ldx + i], E[r * lde + j], acc)
                : fma3(parts(X[r * ldx + i], x3), parts(E[r * lde + j], x3),
                       acc);
    part[idx] += acc;
  }
  if (bias)
    for (int j = threadIdx.x; j < J; j += RT) {
      float acc = 0.f;
      for (int r = 0; r < nr; ++r) acc += E[r * lde + j];
      part[(size_t)I * J + j] += acc;
    }
}

// Back through one field evaluation at y given dk (aux and O from
// field_eval): the weight gradients into the block's partials `part`, the
// stage's derivative-row cotangent added into dd (stride ldd), and dy
// [nr][H] (the cotangent of y)
__device__ void field_bwd(const Field& f, const CdeParts& P, int nr,
                          const float* y, const float* aux, const float* o,
                          const float* d, int ldd, const float* dk,
                          float* dd, float* dout, float* dzA, float* dzB,
                          float* gsum, float* dy, float* part) {
  const int H = f.H, HH = f.HH, C = f.C, HC = H * C, mode = f.mode;
  float* tmp = f.tmp;
  // dd_c += sum_h oh(oh(dk_h) O[h C + c]); dO = oh(dk_h) oh(d_c)
  for (int i = threadIdx.x; i < nr * C; i += RT) {
    const int r = i / C, c = i % C;
    float acc = 0.f;
    for (int h = 0; h < H; ++h)
      acc += one_hot(one_hot(dk[r * H + h], mode) * o[r * HC + h * C + c],
                     mode);
    dd[r * ldd + c] = dd[r * ldd + c] + acc;
  }
  for (int i = threadIdx.x; i < nr * HC; i += RT) {
    const int r = i / HC, h = (i % HC) / C, c = i % C;
    dout[i] = one_hot(dk[r * H + h], mode) * one_hot(d[r * ldd + c], mode);
  }
  __syncthreads();
  if (f.act == ACT_GRU) {
    const long long TC = (long long)f.R * HC;
    const float *rg = aux, *ug = aux + TC, *zh = aux + 2 * TC,
                *gg = aux + 3 * TC;
    // dzA: dz_r, dzB: dz_u, dout: dz_h (in place), tmp: dgg
    for (int i = threadIdx.x; i < nr * HC; i += RT) {
      const int r = i / HC, h = (i % HC) / C;
      const float dov = dout[i], uv = ug[i], gv = gg[i], rv = rg[i];
      const float dgg = dov * (1.f - uv);
      const float dgate = dgg * (1.f - gv * gv);
      dzA[i] = dgate * zh[i] * rv * (1.f - rv);
      dzB[i] = -dov * (gv - y[r * H + h]) * uv * (1.f - uv);
      dout[i] = dgate * rv;
      tmp[i] = dgg;
    }
    __syncthreads();
    // the state-expand term's cotangent, sum_c dgg[h C + c], into gsum
    for (int i = threadIdx.x; i < nr * H; i += RT) {
      const int r = i / H, h = i % H;
      float acc = 0.f;
      for (int c = 0; c < C; ++c) acc += tmp[r * HC + h * C + c];
      gsum[i] = acc;
    }
    const float* dzs[3] = {dzA, dzB, dout};
    for (int gi = 0; gi < 3; ++gi) {
      red_outer(y, H, H, dzs[gi], HC, HC, nr, part + gi * (long long)H * HC,
                false, MM_F32);
      for (int j = threadIdx.x; j < HC; j += RT) {
        float acc = 0.f;
        for (int r = 0; r < nr; ++r) acc += dzs[gi][r * HC + j];
        part[P.wo + gi * (long long)HC + j] += acc;
      }
    }
    __syncthreads();
    // dy = ((dz_r Wr^T + dz_z Wz^T) + dz_h Wh^T) - gsum, the plain order
    for (int gi = 0; gi < 3; ++gi) {
      red_prod(dzs[gi], HC, HC, f.w.wo + (size_t)gi * H * HC, true, nr, H,
               tmp, H, MM_F32);
      __syncthreads();
      for (int i = threadIdx.x; i < nr * H; i += RT)
        dy[i] = gi == 0   ? tmp[i]
                : gi == 1 ? dy[i] + tmp[i]
                          : (dy[i] + tmp[i]) - gsum[i];
      __syncthreads();
    }
    return;
  }
  const long long TH = (long long)f.R * HH;
  // dzout = dO (1 - O^2)
  for (int i = threadIdx.x; i < nr * HC; i += RT)
    dout[i] = dout[i] * (1.f - o[i] * o[i]);
  __syncthreads();
  red_outer(aux + f.NI * TH, HH, HH, dout, HC, HC, nr, part + P.win + P.bin +
            P.wi + P.bi, true, mode);
  red_prod(dout, HC, HC, f.w.wo, true, nr, HH, tmp, HH, mode);
  __syncthreads();
  float* cur = dzA;
  for (int l = f.NI - 1; l >= 0; --l) {
    for (int i = threadIdx.x; i < nr * HH; i += RT)
      cur[i] = tmp[i] * act_d(f.act, aux[(l + 1) * TH + i]);
    __syncthreads();
    red_outer(aux + l * TH, HH, HH, cur, HH, HH, nr,
              part + P.win + P.bin + (long long)l * HH * HH, false, mode);
    for (int j = threadIdx.x; j < HH; j += RT) {
      float acc = 0.f;
      for (int r = 0; r < nr; ++r) acc += cur[r * HH + j];
      part[P.win + P.bin + P.wi + (long long)l * HH + j] += acc;
    }
    red_prod(cur, HH, HH, f.w.wi + (size_t)l * HH * HH, true, nr, HH, tmp,
             HH, mode);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * HH; i += RT)
    cur[i] = tmp[i] * act_d(f.act, aux[i]);
  __syncthreads();
  red_outer(y, H, H, cur, HH, HH, nr, part, false, mode);
  for (int j = threadIdx.x; j < HH; j += RT) {
    float acc = 0.f;
    for (int r = 0; r < nr; ++r) acc += cur[r * HH + j];
    part[P.win + j] += acc;
  }
  red_prod(cur, HH, HH, f.w.win, true, nr, H, dy, H, mode);
  __syncthreads();
}


// ---------------------------------------------------------------------------
// The kernels
// ---------------------------------------------------------------------------

__device__ __forceinline__ Field field_of(const CdeDims& d, const CdeArgs& A,
                                          int k, int R, float* tmp) {
  Field f;
  f.w = cde_wts(d, A, k);
  f.H = d.H; f.HH = d.HH; f.C = d.C; f.NI = d.NI; f.act = d.act;
  f.mode = d.mm; f.R = R; f.tmp = tmp;
  return f;
}

// the step's derivative row [nr][NT C] widened into dx
__device__ void load_dx(const CdeDims& d, const CdeArgs& A, float* dx, int k,
                        int u, int row0, int nr, int NTC) {
  const size_t o = (((size_t)k * d.M + u) * d.B + row0) * NTC;
  for (int i = threadIdx.x; i < nr * NTC; i += RT)
    dx[i] = ld_stream(A.dx, o + i, d.bs);
}

// The stages of one step from z: their states st[i] and increments ks[i]
// (aux and O left at the last stage)
__device__ void cde_stages(const Field& f, const Tab& T, int nr, float dt,
                           const float* z, float* st, float* ks,
                           const float* dx, int NTC, float* aux, float* o) {
  const long long TT = (long long)f.R * f.H;
  for (int i = 0; i < T.ns; ++i) {
    float* y = st + i * TT;
    for (int j = threadIdx.x; j < nr * f.H; j += RT)
      y[j] = i == 0 ? z[j] : z[j] + (T.a[i] * dt) * ks[(i - 1) * TT + j];
    __syncthreads();
    field_eval(f, nr, y, dx + T.t[i] * f.C, NTC, aux, o, ks + i * TT);
  }
}

__global__ void __launch_bounds__(RT)
cde_red_fwd_kernel(CdeDims d, Tab T, int R, CdeArgs A) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const RedLayout L = red_layout(d, R, T.nt);
  const int k = blockIdx.y, row0 = blockIdx.x * R;
  const int nr = min(R, d.B - row0), H = d.H, NTC = T.nt * d.C;
  const long long TT = (long long)R * H;
  const Field f = field_of(d, A, k, R, s + L.tmp);
  float *z = s + L.z, *st = s + L.st, *ks = s + L.ks;
  float* aux = s + (d.act == ACT_GRU ? L.gates : L.hs);
  const float* z0 = reinterpret_cast<const float*>(A.z0);
  for (int i = threadIdx.x; i < nr * H; i += RT)
    z[i] = z0[((size_t)k * d.B + row0) * H + i];
  for (int u = 0; u < d.M; ++u) {
    load_dx(d, A, s + L.dx, k, u, row0, nr, NTC);
    __syncthreads();
    const float dt = A.dts[u];
    cde_stages(f, T, nr, dt, z, st, ks, s + L.dx, NTC, aux, s + L.o);
    const size_t o = (((size_t)k * d.M + u) * d.B + row0) * H;
    for (int i = threadIdx.x; i < nr * H; i += RT) {
      float v = z[i];
      for (int j = 0; j < T.ns; ++j)
        if (T.b[j] != 0.f) v = v + (T.b[j] * dt) * ks[j * TT + i];
      z[i] = v;
      st_stream(A.ys_out, o + i, v, d.bs);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(RT)
cde_red_bwd_kernel(CdeDims d, Tab T, int R, CdeArgs A) {
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const RedLayout L = red_layout(d, R, T.nt);
  const int k = blockIdx.y, row0 = blockIdx.x * R;
  const int nr = min(R, d.B - row0), H = d.H, NTC = T.nt * d.C;
  const long long TT = (long long)R * H;
  const CdeParts P = cde_parts(d);
  const Field f = field_of(d, A, k, R, s + L.tmp);
  float *z = s + L.z, *gbar = s + L.gbar, *dy = s + L.dy, *st = s + L.st;
  float *ks = s + L.ks, *dks = s + L.dks, *dx = s + L.dx, *dd = s + L.dd;
  float *o = s + L.o;
  float* aux = s + (d.act == ACT_GRU ? L.gates : L.hs);
  float* part = A.part + ((size_t)k * gridDim.x + blockIdx.x) * P.total;
  for (long long i = threadIdx.x; i < P.total; i += RT) part[i] = 0.f;
  for (int i = threadIdx.x; i < nr * H; i += RT) gbar[i] = 0.f;
  for (int u = d.M - 1; u >= 0; --u) {
    load_dx(d, A, dx, k, u, row0, nr, NTC);
    const size_t oy = (((size_t)k * d.M + u) * d.B + row0) * H;
    for (int i = threadIdx.x; i < nr * H; i += RT) {
      z[i] = u == 0 ? ld_stream(A.z0, ((size_t)k * d.B + row0) * H + i,
                                d.bs)
                    : ld_stream(A.ys, oy - (size_t)d.B * H + i, d.bs);
      gbar[i] = gbar[i] + ld_stream(A.gys, oy + i, d.bs);
    }
    for (int i = threadIdx.x; i < nr * NTC; i += RT) dd[i] = 0.f;
    __syncthreads();
    const float dt = A.dts[u];
    cde_stages(f, T, nr, dt, z, st, ks, dx, NTC, aux, o);
    for (int j = 0; j < T.ns; ++j)
      for (int i = threadIdx.x; i < nr * H; i += RT)
        dks[j * TT + i] = T.b[j] != 0.f ? (T.b[j] * dt) * gbar[i] : 0.f;
    __syncthreads();
    for (int j = T.ns - 1; j >= 0; --j) {
      const float* y = st + j * TT;
      field_eval(f, nr, y, dx + T.t[j] * d.C, NTC, aux, o, s + L.dzB);
      field_bwd(f, P, nr, y, aux, o, dx + T.t[j] * d.C, NTC, dks + j * TT,
                dd + T.t[j] * d.C, s + L.dout, s + L.dzA, s + L.dzB,
                s + L.gsum, dy, part);
      for (int i = threadIdx.x; i < nr * H; i += RT) {
        gbar[i] = gbar[i] + dy[i];
        if (j > 0 && T.a[j] != 0.f)
          dks[(j - 1) * TT + i] = dks[(j - 1) * TT + i] + (T.a[j] * dt) * dy[i];
      }
      __syncthreads();
    }
    const size_t od = (((size_t)k * d.M + u) * d.B + row0) * NTC;
    for (int i = threadIdx.x; i < nr * NTC; i += RT)
      st_stream(A.ddx, od + i, dd[i], d.bs);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < nr * H; i += RT)
    A.dz0[((size_t)k * d.B + row0) * H + i] = gbar[i];
}

// ---------------------------------------------------------------------------
// The host side
// ---------------------------------------------------------------------------

inline bool red_valid(const CdeDims& d, int method, Tab* T) {
  return tableau(method, T) && d.M >= 0 && d.B > 0 && d.H > 0 && d.HH > 0 &&
         d.C > 0 && d.NI >= 0 && d.K >= 1 && d.K <= 65535 && d.act >= 0 &&
         d.act <= ACT_GRU && d.mm >= MM_F32 && d.mm <= MM_BF16 &&
         (d.act != ACT_GRU || d.mm == MM_F32) && (d.bs == 0 || d.bs == 1);
}

inline long long red_bytes(const CdeDims& d, int R, int nt) {
  return red_layout(d, R, nt).total * (long long)sizeof(float);
}

inline int cde_red_rows(const CdeDims& d, int nt) {
  return red_rows([&](int R) { return red_bytes(d, R, nt); });
}

int run(const CdeDims& d, int method, const CdeArgs& A, int backward,
        cudaStream_t s) {
  Tab T;
  if (!red_valid(d, method, &T)) return (int)cudaErrorInvalidValue;
  const int R = cde_red_rows(d, T.nt);
  if (!R) return (int)cudaErrorInvalidValue;
  const int blocks = (d.B + R - 1) / R;
  const long long bytes = red_bytes(d, R, T.nt);
  if (!backward)
    return red_launch(cde_red_fwd_kernel, blocks, d.K, bytes, s, d, T, R, A);
  const int err =
      red_launch(cde_red_bwd_kernel, blocks, d.K, bytes, s, d, T, R, A);
  if (err) return err;
  // each member's weight gradients: its blocks' partials summed in
  // ascending block order
  const long long P = cde_parts(d).total;
  return run_split_sums(
      {SplitSum{A.part, A.grads, P, blocks * P, P, blocks}}, d.K, s);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block of a launch, in bytes (the forward
// and the backward take the same layout; -1 for an unknown method or
// field).
long long fused_cde_red_smem_bytes(int B, int H, int HH, int C, int n_inner,
                                   int method, int act_code, int members,
                                   int backward) {
  (void)backward;
  Tab T;
  const CdeDims d{1, B, H, HH, C, n_inner, members, act_code, 0, 0};
  if (!red_valid(d, method, &T)) return -1;
  const int R = cde_red_rows(d, T.nt);
  return red_bytes(d, R ? R : 1, T.nt);
}

// One field of a launch's plan (fused_cde_plan's fields): 0 the level
// (0), 1 batch rows a block (the backward's partials are [members][ceil(B
// / rows)][P]), 2 blocks a cluster (1), 3 stage activations kept (0), 4
// blocks a member, 5 shared bytes a block; -1 for an unknown method or
// field.
int fused_cde_red_plan(int B, int H, int HH, int C, int n_inner, int method,
                       int act_code, int members, int backward, int field) {
  (void)backward;
  Tab T;
  const CdeDims d{1, B, H, HH, C, n_inner, members, act_code, 0, 0};
  if (!red_valid(d, method, &T)) return -1;
  const int R = cde_red_rows(d, T.nt);
  switch (field) {
    case 0: return 0;
    case 1: return R;
    case 2: return 1;
    case 3: return 0;
    case 4: return R ? (B + R - 1) / R : 0;
  }
  return (int)red_bytes(d, R ? R : 1, T.nt);
}

int fused_cde_red_max_smem() { return max_optin_smem(); }

const char* fused_cde_red_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The forward of K members in operand mode mm (MM_*; MM_F32 for the GRU-ODE
// field), with bf16 streams when bf16 (dx and ys in bf16): inputs as
// fused_cde_fwd's, ys [K][M][B][H].
int fused_cde_red_fwd(const float* z0, const void* dx, const float* dts,
                      const float* win, const float* bin, const float* wi,
                      const float* bi, const float* wo, const float* bo,
                      void* ys, int M, int B, int H, int HH, int C,
                      int n_inner, int method, int act_code, int members,
                      int mm, int bf16, void* stream) {
  CdeArgs A{};
  A.z0 = z0; A.dx = dx; A.dts = dts; A.win = win; A.bin = bin; A.wi = wi;
  A.bi = bi; A.wo = wo; A.bo = bo; A.ys_out = ys;
  return run(CdeDims{M, B, H, HH, C, n_inner, members, act_code, mm,
                     bf16 != 0},
             method, A, 0, (cudaStream_t)stream);
}

// The backward of K members in operand mode mm, with bf16 streams when
// bf16 (z0, rounded by the caller, ys, gys, dx and ddx in bf16): ddx, dz0
// and the weight gradients grads [K][P] summed from the partials part
// [K][blocks][P] (fused_cde_bwd's outputs).
int fused_cde_red_bwd(const void* z0, const void* ys, const void* gys,
                      const void* dx, const float* dts, const float* win,
                      const float* bin, const float* wi, const float* bi,
                      const float* wo, const float* bo, void* ddx,
                      float* dz0, float* part, float* grads, int M, int B,
                      int H, int HH, int C, int n_inner, int method,
                      int act_code, int members, int mm, int bf16,
                      void* stream) {
  CdeArgs A{};
  A.z0 = z0; A.ys = ys; A.gys = gys; A.dx = dx; A.dts = dts; A.win = win;
  A.bin = bin; A.wi = wi; A.bi = bi; A.wo = wo; A.bo = bo; A.ddx = ddx;
  A.dz0 = dz0; A.part = part; A.grads = grads;
  return run(CdeDims{M, B, H, HH, C, n_inner, members, act_code, mm,
                     bf16 != 0},
             method, A, 1, (cudaStream_t)stream);
}

}  // extern "C"
