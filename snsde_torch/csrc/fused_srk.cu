// Fused SRIW1 stochastic Runge–Kutta solve of a DiffusionField SDE:
// forward and backward kernels for NVIDIA Hopper (sm_90a), plain C
// interface (loaded with ctypes by snsde_torch/kernels/fused_srk.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_srk.py:
//   forward  _fused_srk_forward (pallas_call at :295, body _fwd_kernel :215,
//            step _srk_step :158)
//   backward _fused_srk_backward (pallas_call at :527, body _bwd_kernel :317)
// for drift mode 'embm' (merged emb drift, input_option 2/4/6) and noise
// mode 'precomp' (the diffusion magnitude depends on t only), with or
// without mult_y and geometric: the modes of fused_em.cu.
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
// are precomputed outside the kernels, as for the EM kernels. The backward
// recomputes every stage of a step from the saved trajectory and reverses
// the tableau in the JAX kernel's order: f1, g3, g2, g1, g0, f0.
//
// What bounds it on the H100: not bytes or FLOPs. At the MuJoCo shape
// (B=1024, 49 steps, H=32) the forward does ~0.6 GFLOP and moves ~32 MB,
// ~10 us of either; the backward ~3x the products and ~51 MB. The limit is
// the chain of dependent steps, each two MLP evaluations of a few
// [rows x H] x [H x H] products with a block barrier after each, over only
// 1024 independent rows. The design is fused_em.cu's: one thread block per
// tile of ROWS batch rows runs the whole time loop, with the weights, the
// state, the stage states and the activations of both MLP evaluations (and,
// in the backward, the weight-gradient accumulators, each entry owned by
// one thread) in shared memory; only the per-step streams touch device
// memory; exact fp32 FMA on the CUDA cores; per-block partials summed by
// the wrapper in a fixed order, so runs are bit-reproducible.

#include "sde_common.cuh"

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
  const float I11s = 0.5f * (dw * dw - k.dt) * k.rsq;  // I11 / sqrt(dt)
  const float I111r = (dw * dw * dw - 3.f * k.dt * dw) * (k.rdt / 6.f);
  const float I10r = i10 * k.rdt;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    c[i] = BETA1[i] * dw + BETA2[i] * I11s + BETA3[i] * I10r +
           BETA4[i] * I111r;
}

// The four diffusion stages of one element, given y and f0: stage states
// st (y, H1_1, H1_2, H1_3), raw diffusions graw, bounded g, and the second
// drift stage's state h01.
struct Stages {
  float st[4], graw[4], g[4], h01;
};

__device__ __forceinline__ void noise_eval(Stages& s, int i, float state,
                                           float gk, float sth, int mult_y) {
  s.st[i] = state;
  s.graw[i] = mult_y ? gk * state : gk;
  s.g[i] = tanhf(sth * s.graw[i]);
}

__device__ __forceinline__ Stages srk_stages(float y, float f0, float gk0,
                                             float gk1, float gk2, float i10,
                                             float sth, const Step& k,
                                             int mult_y) {
  Stages s;
  noise_eval(s, 0, y, gk0, sth, mult_y);
  noise_eval(s, 1, y + 0.25f * k.dt * f0 + 0.5f * k.sq * s.g[0], gk1, sth,
             mult_y);
  noise_eval(s, 2, y + k.dt * f0 - k.sq * s.g[0], gk2, sth, mult_y);
  noise_eval(s, 3,
             y + 0.25f * k.dt * f0 +
                 k.sq * (-5.f * s.g[0] + 3.f * s.g[1] + 0.5f * s.g[2]),
             gk1, sth, mult_y);
  s.h01 = y + 0.75f * k.dt * f0 + 1.5f * (i10 * k.rdt) * s.g[0];
  return s;
}

// Reverse one diffusion stage given the cotangent dg of its g: adds to the
// theta sum, sets q to the cotangent of its gk (summed over rows later)
// and returns the cotangent of its state.
__device__ __forceinline__ float noise_bwd(const Stages& s, int i, float dg,
                                           float gk, float sth, int mult_y,
                                           float& th_acc, float& q) {
  const float g = s.g[i];
  const float dsg = dg * (1.f - g * g);
  th_acc = fmaf(dsg, s.graw[i], th_acc);
  const float dgraw = dsg * sth;
  if (mult_y) {
    q = dgraw * s.st[i];
    return dgraw * gk;
  }
  q = dgraw;
  return 0.f;
}

__host__ __device__ inline size_t fwd_floats(const Dims& d) {
  return weights_floats(d) + 4 * tile_h(d) + (d.n_inner + 1) * tile_hh(d);
}

__host__ __device__ inline size_t bwd_floats(const Dims& d) {
  return weights_floats(d) + grads_floats(d) + 9 * tile_h(d) +
         (2 * d.n_inner + 4) * tile_hh(d) + THREADS / 32;
}

__global__ void __launch_bounds__(THREADS)
fwd_kernel(Dims d, const float* __restrict__ y0,
           const float* __restrict__ xh0, const float* __restrict__ xh1,
           const float* __restrict__ dw, const float* __restrict__ i10,
           const float* __restrict__ a0, const float* __restrict__ a1,
           const float* __restrict__ gk0, const float* __restrict__ gk1,
           const float* __restrict__ gk2, const float* __restrict__ dts,
           const float* __restrict__ theta, const float* __restrict__ wy,
           const float* __restrict__ wi, const float* __restrict__ bi,
           const float* __restrict__ wo, const float* __restrict__ bo,
           float* __restrict__ ys) {
  extern __shared__ float smem[];
  const int H = d.H, HH = d.HH, sH = odd(H), sHH = odd(HH);
  const Weights w = load_weights(smem, d, wy, wi, bi, wo, bo);
  float* sy = smem + weights_floats(d);  // y [ROWS][sH]
  float* s01 = sy + tile_h(d);           // H0_1, the state of f1
  float* sf0 = s01 + tile_h(d);          // f0
  float* sn = sf0 + tile_h(d);           // sum_i coeff_i g_i
  float* hl = sn + tile_h(d);            // activations [NI+1][ROWS][sHH]
  const float* hlast = hl + d.n_inner * ROWS * sHH;

  const int row0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d.B - row0);
  const size_t BH = (size_t)d.B * H, BHH = (size_t)d.B * HH;
  for (int i = threadIdx.x; i < nr * H; i += THREADS)
    sy[(i / H) * sH + i % H] = y0[(size_t)row0 * H + i];
  const float sth = sigmoid(theta[0]);
  __syncthreads();

  for (int u = 0; u < d.M; ++u) {
    const Step k = step_of(dts[u]);
    const size_t off = u * BH + (size_t)row0 * H;
    const size_t offh = u * BHH + (size_t)row0 * HH;
    const size_t uh = (size_t)u * H;

    // f0 = f(t, y) and the four diffusion stages
    mlp_hidden(d, w, sy, a0 + (size_t)u * HH, xh0 + offh, hl, nr);
    for (int i = threadIdx.x; i < nr * H; i += THREADS) {
      const int r = i / H, j = i % H, s = r * sH + j;
      const float y = sy[s];
      float z3 = mlp_out(d, w, hlast, r, j);
      if (d.geometric) z3 *= tanhf(y);
      const float f0 = tanhf(z3);
      const float ii = i10[off + i];
      const Stages st = srk_stages(y, f0, gk0[uh + j], gk1[uh + j],
                                   gk2[uh + j], ii, sth, k, d.mult_y);
      float c[4];
      srk_coeffs(dw[off + i], ii, k, c);
      s01[s] = st.h01;
      sf0[s] = f0;
      sn[s] = c[0] * st.g[0] + c[1] * st.g[1] + c[2] * st.g[2] +
              c[3] * st.g[3];
    }
    __syncthreads();

    // f1 = f(t + 3/4 dt, H0_1) and the update
    mlp_hidden(d, w, s01, a1 + (size_t)u * HH, xh1 + offh, hl, nr);
    for (int i = threadIdx.x; i < nr * H; i += THREADS) {
      const int r = i / H, j = i % H, s = r * sH + j;
      float z3 = mlp_out(d, w, hlast, r, j);
      if (d.geometric) z3 *= tanhf(s01[s]);
      const float f1 = tanhf(z3);
      const float yn =
          sy[s] + k.dt * (ALPHA0 * sf0[s] + ALPHA1 * f1) + sn[s];
      sy[s] = yn;  // only this thread reads or writes (r, j) here
      ys[off + i] = yn;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_kernel(Dims d, const float* __restrict__ y0, const float* __restrict__ ys,
           const float* __restrict__ gys, const float* __restrict__ xh0,
           const float* __restrict__ xh1, const float* __restrict__ dw,
           const float* __restrict__ i10, const float* __restrict__ a0,
           const float* __restrict__ a1, const float* __restrict__ gk0,
           const float* __restrict__ gk1, const float* __restrict__ gk2,
           const float* __restrict__ dts, const float* __restrict__ theta,
           const float* __restrict__ wy, const float* __restrict__ wi,
           const float* __restrict__ bi, const float* __restrict__ wo,
           const float* __restrict__ bo, float* __restrict__ dxh0,
           float* __restrict__ dxh1, float* __restrict__ dy0,
           float* __restrict__ p_wy, float* __restrict__ p_wi,
           float* __restrict__ p_bi, float* __restrict__ p_wo,
           float* __restrict__ p_bo, float* __restrict__ p_a0,
           float* __restrict__ p_a1, float* __restrict__ p_gk0,
           float* __restrict__ p_gk1, float* __restrict__ p_gk2,
           float* __restrict__ p_th) {
  extern __shared__ float smem[];
  const int H = d.H, HH = d.HH, NI = d.n_inner, M = d.M;
  const int sH = odd(H), sHH = odd(HH);
  const Weights w = load_weights(smem, d, wy, wi, bi, wo, bo);
  const Grads gr = zero_grads(smem + weights_floats(d), d);
  float* sy = smem + weights_floats(d) + grads_floats(d);  // y before the step
  float* sg = sy + tile_h(d);    // cotangent of y after the step, then before
  float* sz0 = sg + tile_h(d);   // z3 of f0 before the geometric factor
  float* s01 = sz0 + tile_h(d);  // H0_1
  float* sd = s01 + tile_h(d);   // cotangent of z3 (pre-geometric), f1 or f0
  float* s1 = sd + tile_h(d);    // cotangent of H0_1
  float* sq0 = s1 + tile_h(d);   // cotangents of the gk0, gk1, gk2 rows
  float* sq1 = sq0 + tile_h(d);
  float* sq2 = sq1 + tile_h(d);
  float* hl0 = sq2 + tile_h(d);            // activations of f0 [NI+1][..]
  float* hl1 = hl0 + (NI + 1) * tile_hh(d);  // activations of f1
  float* e0 = hl1 + (NI + 1) * tile_hh(d);   // MLP cotangents, ping-pong
  float* e1 = e0 + tile_hh(d);
  float* red = e1 + tile_hh(d);              // [THREADS / 32]
  const float* hlast0 = hl0 + NI * ROWS * sHH;
  const float* hlast1 = hl1 + NI * ROWS * sHH;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d.B - row0);
  const size_t BH = (size_t)d.B * H, BHH = (size_t)d.B * HH;
  for (int i = tid; i < ROWS * sH; i += THREADS) sg[i] = 0.f;
  const float sth = sigmoid(theta[0]);
  float th_acc = 0.f;
  __syncthreads();

  for (int u = M - 1; u >= 0; --u) {
    const Step k = step_of(dts[u]);
    const float* yprev = (u == 0 ? y0 : ys + (u - 1) * BH) + (size_t)row0 * H;
    const size_t off = u * BH + (size_t)row0 * H;
    const size_t offh = u * BHH + (size_t)row0 * HH;
    const size_t uh = (size_t)u * H;
    const size_t pa = ((size_t)blockIdx.x * M + u) * HH;
    const size_t pg = ((size_t)blockIdx.x * M + u) * H;
    for (int i = tid; i < nr * H; i += THREADS) {
      const int s = (i / H) * sH + i % H;
      sy[s] = yprev[i];
      sg[s] += gys[off + i];
    }
    __syncthreads();

    // recompute f0 and the stages up to H0_1
    mlp_hidden(d, w, sy, a0 + (size_t)u * HH, xh0 + offh, hl0, nr);
    for (int i = tid; i < nr * H; i += THREADS) {
      const int r = i / H, j = i % H, s = r * sH + j;
      const float y = sy[s];
      const float z3l = mlp_out(d, w, hlast0, r, j);
      const float f0 = tanhf(d.geometric ? z3l * tanhf(y) : z3l);
      const Stages st = srk_stages(y, f0, gk0[uh + j], gk1[uh + j],
                                   gk2[uh + j], i10[off + i], sth, k,
                                   d.mult_y);
      sz0[s] = z3l;
      s01[s] = st.h01;
    }
    __syncthreads();

    // recompute f1, and go back through it (df1 = gbar * 2/3 dt)
    mlp_hidden(d, w, s01, a1 + (size_t)u * HH, xh1 + offh, hl1, nr);
    for (int i = tid; i < nr * H; i += THREADS) {
      const int r = i / H, j = i % H, s = r * sH + j;
      const float h = s01[s];
      const float z3l = mlp_out(d, w, hlast1, r, j);
      const float th = tanhf(h);
      const float f1 = tanhf(d.geometric ? z3l * th : z3l);
      const float dz3 = sg[s] * (ALPHA1 * k.dt) * (1.f - f1 * f1);
      sd[s] = d.geometric ? dz3 * th : dz3;
      s1[s] = d.geometric ? dz3 * z3l * (1.f - th * th) : 0.f;
    }
    __syncthreads();
    const float* ein1 = mlp_backward(d, w, gr, s01, hl1, sd, e0, e1, nr);
    spread_dz1(d, w, ein1, p_a1 + pa, dxh1 + offh, s1, nr);
    __syncthreads();

    // the diffusion stages in reverse (g3, g2, g1, g0), then f0's output
    for (int i = tid; i < nr * H; i += THREADS) {
      const int j = i % H, s = (i / H) * sH + j;
      const float y = sy[s], gb = sg[s], dh01 = s1[s], z3l = sz0[s];
      const float ty = tanhf(y);
      const float f0 = tanhf(d.geometric ? z3l * ty : z3l);
      const float g_0 = gk0[uh + j], g_1 = gk1[uh + j], g_2 = gk2[uh + j];
      const float ii = i10[off + i];
      const Stages st = srk_stages(y, f0, g_0, g_1, g_2, ii, sth, k,
                                   d.mult_y);
      float c[4];
      srk_coeffs(dw[off + i], ii, k, c);
      float df0 = gb * (ALPHA0 * k.dt);
      float dg[4] = {gb * c[0], gb * c[1], gb * c[2], gb * c[3]};
      float dy = gb;
      // stage f1: H0_1 = y + 3/4 dt f0 + 3/2 (I10/dt) g0
      dy += dh01;
      df0 += 0.75f * k.dt * dh01;
      dg[0] += 1.5f * (ii * k.rdt) * dh01;
      float q0, q1, q2, q3;
      // stage g3: H1_3 = y + dt/4 f0 + sqrt(dt) (-5 g0 + 3 g1 + g2/2)
      float ds = noise_bwd(st, 3, dg[3], g_1, sth, d.mult_y, th_acc, q3);
      dy += ds;
      df0 += 0.25f * k.dt * ds;
      dg[0] -= 5.f * k.sq * ds;
      dg[1] += 3.f * k.sq * ds;
      dg[2] += 0.5f * k.sq * ds;
      // stage g2: H1_2 = y + dt f0 - sqrt(dt) g0
      ds = noise_bwd(st, 2, dg[2], g_2, sth, d.mult_y, th_acc, q2);
      dy += ds;
      df0 += k.dt * ds;
      dg[0] -= k.sq * ds;
      // stage g1: H1_1 = y + dt/4 f0 + sqrt(dt)/2 g0
      ds = noise_bwd(st, 1, dg[1], g_1, sth, d.mult_y, th_acc, q1);
      dy += ds;
      df0 += 0.25f * k.dt * ds;
      dg[0] += 0.5f * k.sq * ds;
      // stage g0 (state y)
      dy += noise_bwd(st, 0, dg[0], g_0, sth, d.mult_y, th_acc, q0);
      // f0's output
      const float dz3 = df0 * (1.f - f0 * f0);
      float dz3l = dz3;
      if (d.geometric) {
        dz3l = dz3 * ty;
        dy += dz3 * z3l * (1.f - ty * ty);
      }
      sd[s] = dz3l;
      sg[s] = dy;
      sq0[s] = q0;
      sq1[s] = q3 + q1;
      sq2[s] = q2;
    }
    __syncthreads();

    // the gk rows; back through f0's MLP; then a0', xh0' and y
    column_sums(d, sq0, p_gk0 + pg, nr);
    column_sums(d, sq1, p_gk1 + pg, nr);
    column_sums(d, sq2, p_gk2 + pg, nr);
    const float* ein0 = mlp_backward(d, w, gr, sy, hl0, sd, e0, e1, nr);
    spread_dz1(d, w, ein0, p_a0 + pa, dxh0 + offh, sg, nr);
    __syncthreads();
  }

  for (int i = tid; i < nr * H; i += THREADS)
    dy0[(size_t)row0 * H + i] = sg[(i / H) * sH + i % H];
  store_grads(d, gr, p_wy, p_wi, p_bi, p_wo, p_bo);
  // d theta: per-thread sums, one per block, through sigmoid'
  const float s = block_sum(th_acc, red);
  if (tid == 0) p_th[blockIdx.x] = s * sth * (1.f - sth);
}

}  // namespace

extern "C" {

int fused_srk_rows_per_block() { return ROWS; }

// Dynamic shared memory a launch needs, in bytes.
long long fused_srk_smem_bytes(int H, int HH, int n_inner, int backward) {
  const Dims d{0, 0, H, HH, n_inner, 0, 0};
  return (long long)sizeof(float) * (backward ? bwd_floats(d) : fwd_floats(d));
}

// The most dynamic shared memory one block may opt in to on this device.
int fused_srk_max_smem() { return max_optin_smem(); }

const char* fused_srk_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_srk_fwd(const float* y0, const float* xh0, const float* xh1,
                  const float* dw, const float* i10, const float* a0,
                  const float* a1, const float* gk0, const float* gk1,
                  const float* gk2, const float* dts, const float* theta,
                  const float* wy, const float* wi, const float* bi,
                  const float* wo, const float* bo, float* ys, int M, int B,
                  int H, int HH, int n_inner, int mult_y, int geometric,
                  void* stream) {
  const Dims d{M, B, H, HH, n_inner, mult_y, geometric};
  const int smem = (int)(sizeof(float) * fwd_floats(d));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<(B + ROWS - 1) / ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      d, y0, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta, wy, wi, bi,
      wo, bo, ys);
  return (int)cudaGetLastError();
}

int fused_srk_bwd(const float* y0, const float* ys, const float* gys,
                  const float* xh0, const float* xh1, const float* dw,
                  const float* i10, const float* a0, const float* a1,
                  const float* gk0, const float* gk1, const float* gk2,
                  const float* dts, const float* theta, const float* wy,
                  const float* wi, const float* bi, const float* wo,
                  const float* bo, float* dxh0, float* dxh1, float* dy0,
                  float* p_wy, float* p_wi, float* p_bi, float* p_wo,
                  float* p_bo, float* p_a0, float* p_a1, float* p_gk0,
                  float* p_gk1, float* p_gk2, float* p_th, int M, int B,
                  int H, int HH, int n_inner, int mult_y, int geometric,
                  void* stream) {
  const Dims d{M, B, H, HH, n_inner, mult_y, geometric};
  const int smem = (int)(sizeof(float) * bwd_floats(d));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<<<(B + ROWS - 1) / ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      d, y0, ys, gys, xh0, xh1, dw, i10, a0, a1, gk0, gk1, gk2, dts, theta,
      wy, wi, bi, wo, bo, dxh0, dxh1, dy0, p_wy, p_wi, p_bi, p_wo, p_bo, p_a0,
      p_a1, p_gk0, p_gk1, p_gk2, p_th);
  return (int)cudaGetLastError();
}

}  // extern "C"
