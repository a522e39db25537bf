// Fused explicit Runge–Kutta solve of a controlled differential equation
//   dz = f(z) dX(t),  f(z) in R^{H x C}
// forward and backward kernels for NVIDIA Hopper (sm_90a), plain C interface
// (loaded with ctypes by snsde_torch/kernels/fused_cde.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_cde.py:
//   forward  _fused_cde_forward (pallas_call at :364, body _fwd_kernel :320,
//            field _field_forward :184)
//   backward _fused_cde_backward (pallas_call at :505, body _bwd_kernel :385,
//            field _field_bwd :218)
// for the FinalTanh field (relu MLP, any number of inner layers) and the
// SingleHiddenLayer field (tanh, no inner layer), on the euler, midpoint,
// heun (= rk2) and rk4 tableaus. The tableau and the activation are
// template parameters: no branch per element.
//
// One field evaluation at a stage state y, for each batch row:
//   h_0 = act(y Win + bin);  h_{l+1} = act(h_l W_l + b_l)
//   O = tanh(h_NI Wout + bout)            [H*C], h-major: O[h*C + c]
//   k[h] = sum_c O[h*C + c] dX/dt[c]      (dX/dt at the stage's time)
// and a step z <- z + dt sum_i b_i k_i with the stage states
// y_i = z + dt sum_j A_ij k_j. The TPU kernel does the contraction with
// one-hot matrix products (a lane-layout device); here each thread sums
// its C products directly. The control-derivative stream dx [M, B, NT*C]
// holds, per step, dX/dt at the NT distinct stage times; it is
// differentiated (ddx), so a learned control trains through the kernel.
//
// The backward runs the steps in reverse: it recomputes the stage states
// from the saved step states, then reverses the tableau and the field,
// stage by stage from the last. Weight gradients are per-block partials
// that the wrapper sums in a fixed order; each entry is owned by one
// thread for the whole loop (no atomics: runs are bit-reproducible).
//
// What bounds it on the H100: at the rk4 shapes (B=1024, 136 steps, H=32)
// the forward does 9.4 GFLOP at C=6 and 44 GFLOP at C=35, about 0.14 and
// 0.65 ms at 67 TFLOP/s fp32 (operations, not bytes, bound it). The design:
// one thread block per tile of ROWS batch rows runs the whole loop, with the
// weights, the state, the stage values and the [ROWS, H*C] field output in
// shared memory; exact fp32 FMA on the CUDA cores (TF32 off). The output
// projection, the widest product, gives each thread one column q of Wout
// and all ROWS rows in registers, so each weight is read once per
// evaluation. At C=35 Wout alone is 143 KB: the backward keeps Wout in
// shared memory and its gradient dWout (another 143 KB) in a per-block
// partial in device memory, each entry read and written only by the thread
// that owns its column (an L2-resident read-modify-write per stage).
// Wider fields take sde_common.cuh's placements: the other accumulators
// in device memory, then the weights, then fewer batch rows a block, so
// every width the JAX package's gate takes (H*C up to 4096) runs.

#include "sde_common.cuh"

namespace {

struct CdeDims {
  int M, B, H, HH, C, NI;
  int level, w_smem, g_smem, R;  // the placement (sde_common.cuh)
};

// Butcher tableaus (snsde/kernels/fused_cde.py:67-77): stage i evaluates
// at state z + dt sum_j a(i, j) k_j and stage time t + c_i dt, whose index
// among the NT distinct stage times is t(i); the step adds dt b(i) k_i.
struct Euler {
  static constexpr int NS = 1, NT = 1;
  __host__ __device__ static constexpr float a(int, int) { return 0.f; }
  __host__ __device__ static constexpr float b(int) { return 1.f; }
  __host__ __device__ static constexpr int t(int) { return 0; }
};

struct Midpoint {
  static constexpr int NS = 2, NT = 2;
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 0.5f : 0.f;
  }
  __host__ __device__ static constexpr float b(int i) {
    return i == 1 ? 1.f : 0.f;
  }
  __host__ __device__ static constexpr int t(int i) { return i; }
};

struct Heun {
  static constexpr int NS = 2, NT = 2;
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 1.f : 0.f;
  }
  __host__ __device__ static constexpr float b(int) { return 0.5f; }
  __host__ __device__ static constexpr int t(int i) { return i; }
};

struct Rk4 {
  static constexpr int NS = 4, NT = 3;
  __host__ __device__ static constexpr float a(int i, int j) {
    return (i == 1 && j == 0) ? 0.5f
           : (i == 2 && j == 1) ? 0.5f
           : (i == 3 && j == 2) ? 1.f
                                : 0.f;
  }
  __host__ __device__ static constexpr float b(int i) {
    return (i == 0 || i == 3) ? 1.f / 6.f : 1.f / 3.f;
  }
  __host__ __device__ static constexpr int t(int i) {
    return i == 0 ? 0 : (i == 3 ? 2 : 1);
  }
};

// method codes of the C interface: 0 euler, 1 midpoint, 2 heun/rk2, 3 rk4
inline bool stage_counts(int method, int* ns, int* nt) {
  switch (method) {
    case 0: *ns = Euler::NS; *nt = Euler::NT; return true;
    case 1: *ns = Midpoint::NS; *nt = Midpoint::NT; return true;
    case 2: *ns = Heun::NS; *nt = Heun::NT; return true;
    case 3: *ns = Rk4::NS; *nt = Rk4::NT; return true;
  }
  return false;
}

template <bool RELU>
__device__ __forceinline__ float act(float z) {
  return RELU ? fmaxf(z, 0.f) : tanhf(z);
}

// derivative of the activation from its output h
template <bool RELU>
__device__ __forceinline__ float act_d(float h) {
  return RELU ? (h > 0.f ? 1.f : 0.f) : 1.f - h * h;
}

// row stride of Wout in shared memory (odd: the W^T product walks columns)
__host__ __device__ inline int ldo(const CdeDims& d) { return odd(d.H * d.C); }

__host__ __device__ inline size_t cde_weights_floats(const CdeDims& d) {
  const size_t sHH = odd(d.HH);
  return (size_t)d.H * sHH + d.HH + (size_t)d.NI * d.HH * sHH +
         (size_t)d.NI * d.HH + (size_t)d.HH * ldo(d) + (size_t)d.H * d.C;
}

// gradient accumulators kept in shared memory (all but Wout's and bout's)
__host__ __device__ inline size_t cde_grads_floats(const CdeDims& d) {
  return (size_t)d.H * d.HH + d.HH + (size_t)d.NI * d.HH * d.HH +
         (size_t)d.NI * d.HH;
}

// the activations: (NI+1) hidden tiles and the [R][H*C] field output
__host__ __device__ inline size_t cde_act_floats(const CdeDims& d) {
  return (size_t)(d.NI + 1) * d.R * odd(d.HH) + (size_t)d.R * d.H * d.C;
}

__host__ __device__ inline size_t cde_fwd_floats(const CdeDims& d, int ns,
                                                 int nt) {
  return (d.w_smem ? cde_weights_floats(d) : 0) + cde_act_floats(d) +
         (size_t)(2 + ns) * d.R * odd(d.H) + (size_t)d.R * nt * d.C;
}

__host__ __device__ inline size_t cde_bwd_floats(const CdeDims& d, int ns,
                                                 int nt) {
  return (d.w_smem ? cde_weights_floats(d) : 0) +
         (d.g_smem ? cde_grads_floats(d) : 0) + cde_act_floats(d) +
         (size_t)2 * d.R * odd(d.HH) + (size_t)(2 + 3 * ns) * d.R * odd(d.H) +
         (size_t)2 * d.R * nt * d.C;
}

// the lowest placement the host may pick (fused_cde_force_placement)
int g_first_placement = 0;

// The placement of a launch of a tableau of ns stages at nt distinct
// times; its shared bytes
inline size_t cde_plan(CdeDims& d, int ns, int nt, int backward) {
  const size_t limit = (size_t)max_optin_smem();
  if (backward)
    return place(d, [=](const CdeDims& e) { return cde_bwd_floats(e, ns, nt); },
                 g_first_placement, limit);
  return place(d, [=](const CdeDims& e) { return cde_fwd_floats(e, ns, nt); },
               g_first_placement, limit);
}

// weights as the products read them (shared-memory copies at odd row
// strides, or the tensors in device memory at their own): lh is the row
// stride of Win and of each inner layer, lo that of Wout
struct CdeWeights {
  const float *win, *bin, *wi, *bi, *wo, *bo;
  int lh, lo;
};

struct CdeGrads {
  float *win, *bin, *wi, *bi;
};

// The weights: copied into shared memory at s ([in, out] layout in device
// memory; rows padded to an odd stride here), or, without w_smem, read
// where they are.
__device__ __forceinline__
CdeWeights load_cde_weights(float* s, const CdeDims& d,
                            const float* __restrict__ win,
                            const float* __restrict__ bin,
                            const float* __restrict__ wi,
                            const float* __restrict__ bi,
                            const float* __restrict__ wo,
                            const float* __restrict__ bo) {
  const int H = d.H, HH = d.HH, sHH = odd(HH), HC = d.H * d.C, lo = ldo(d);
  if (!d.w_smem) return CdeWeights{win, bin, wi, bi, wo, bo, HH, HC};
  float* swin = s;
  float* sbin = swin + H * sHH;
  float* swi = sbin + HH;
  float* sbi = swi + d.NI * HH * sHH;
  float* swo = sbi + d.NI * HH;
  float* sbo = swo + (size_t)HH * lo;
  for (int i = threadIdx.x; i < H * HH; i += THREADS)
    swin[(i / HH) * sHH + i % HH] = win[i];
  for (int i = threadIdx.x; i < HH; i += THREADS) sbin[i] = bin[i];
  for (int i = threadIdx.x; i < d.NI * HH * HH; i += THREADS)
    swi[(i / HH) * sHH + i % HH] = wi[i];  // rows of all layers stacked
  for (int i = threadIdx.x; i < d.NI * HH; i += THREADS) sbi[i] = bi[i];
  for (int i = threadIdx.x; i < HH * HC; i += THREADS)
    swo[(size_t)(i / HC) * lo + i % HC] = wo[i];
  for (int i = threadIdx.x; i < HC; i += THREADS) sbo[i] = bo[i];
  return CdeWeights{swin, sbin, swi, sbi, swo, sbo, sHH, lo};
}

// The field's hidden layers and its output O for the nr rows of a tile
// whose stage state is y [R][odd(H)]: hl [(NI+1)][R][odd(HH)] and
// ob [R][H*C]. Ends after a barrier. Not inlined (nor are contract and
// field_backward): each is compiled once per activation and placement
// kind and called from every tableau's kernel, which keeps the build of
// the 32 kernels (4 tableaus x 2 activations x forward and backward x the
// main paths' placement and the wide one) short.
template <bool RELU, bool WIDE>
__device__ __noinline__
void field_hidden(const CdeDims dp, const CdeWeights w, const float* y,
                  float* hl, float* ob, int nr) {
  const CdeDims d = placed<WIDE>(dp);
  const int H = d.H, HH = d.HH, sH = odd(H), sHH = odd(HH);
  const int HC = d.H * d.C, tile = d.R * sHH;
  // the weights' row strides (constants of the main paths' placement)
  const int lh = WIDE ? w.lh : sHH, lo = WIDE ? w.lo : ldo(d);
  for (int i = threadIdx.x; i < nr * HH; i += THREADS) {
    const int r = i / HH, j = i % HH;
    hl[r * sHH + j] = act<RELU>(dot_col(y + r * sH, w.win, H, lh, j) +
                                w.bin[j]);
  }
  __syncthreads();
  for (int l = 0; l < d.NI; ++l) {
    const float* hin = hl + l * tile;
    float* hout = hl + (l + 1) * tile;
    const float* W = w.wi + (size_t)l * HH * lh;
    for (int i = threadIdx.x; i < nr * HH; i += THREADS) {
      const int r = i / HH, j = i % HH;
      hout[r * sHH + j] = act<RELU>(dot_col(hin + r * sHH, W, HH, lh, j) +
                                    w.bi[l * HH + j]);
    }
    __syncthreads();
  }
  // the output projection: one column q per thread, every row in registers
  // (rows past nr are not stored; with fewer than ROWS rows a block they
  // read row nr - 1, inside the tile)
  const float* hlast = hl + d.NI * tile;
  int ro[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) ro[r] = (WIDE ? min(r, nr - 1) : r) * sHH;
  for (int q = threadIdx.x; q < HC; q += THREADS) {
    float acc[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
    for (int k = 0; k < HH; ++k) {
      const float wk = w.wo[(size_t)k * lo + q];
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc[r] = fmaf(hlast[ro[r] + k], wk, acc[r]);
    }
    // constant indices only, so acc stays in registers
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < nr) ob[r * HC + q] = tanhf(acc[r] + w.bo[q]);
  }
  __syncthreads();
}

// k [R][odd(H)] = the contraction of O (ob) with the stage's row of the
// control derivative, dxt [R] rows of stride nt*C. Ends after a barrier.
__device__ __noinline__
void contract(const CdeDims d, const float* ob, const float* dxt, int ntc,
              float* k, int nr) {
  const int H = d.H, C = d.C, HC = d.H * d.C, sH = odd(H);
  for (int i = threadIdx.x; i < nr * H; i += THREADS) {
    const int r = i / H, h = i % H;
    float acc = 0.f;
    for (int c = 0; c < C; ++c)
      acc = fmaf(ob[r * HC + h * C + c], dxt[r * ntc + c], acc);
    k[r * sH + h] = acc;
  }
  __syncthreads();
}

// The state of stage s: y = z + sum_j (a(s, j) dt) k_j, for the tile's rows
// (z is the state before the step, k the stage increments so far). No
// barrier.
template <class T>
__device__ __forceinline__
void stage_state(const CdeDims& d, int s, float dt, const float* z,
                 const float* ks, float* y, int nr) {
  const int H = d.H, sH = odd(H);
  for (int i = threadIdx.x; i < nr * H; i += THREADS) {
    const int e = (i / H) * sH + i % H;
    float v = z[e];
#pragma unroll
    for (int j = 0; j < T::NS; ++j)
      if (j < s && T::a(s, j) != 0.f)
        v = v + (T::a(s, j) * dt) * ks[j * d.R * sH + e];
    y[e] = v;
  }
}

__device__ __forceinline__ void zero_smem(float* s, size_t n) {
  for (size_t i = threadIdx.x; i < n; i += THREADS) s[i] = 0.f;
}

template <class T, bool RELU, bool WIDE>
__global__ void __launch_bounds__(THREADS)
cde_fwd_kernel(CdeDims dp, const float* __restrict__ z0,
               const float* __restrict__ dx, const float* __restrict__ dts,
               const float* __restrict__ win, const float* __restrict__ bin,
               const float* __restrict__ wi, const float* __restrict__ bi,
               const float* __restrict__ wo, const float* __restrict__ bo,
               float* __restrict__ ys) {
  extern __shared__ float smem[];
  const CdeDims d = placed<WIDE>(dp);
  const int H = d.H, sH = odd(H), NTC = T::NT * d.C;
  const size_t tile = (size_t)d.R * sH;
  const size_t wf = d.w_smem ? cde_weights_floats(d) : 0;
  const CdeWeights w = load_cde_weights(smem, d, win, bin, wi, bi, wo, bo);
  float* hl = smem + wf;
  float* ob = hl + (d.NI + 1) * d.R * odd(d.HH);
  float* sz = ob + d.R * d.H * d.C;   // state before the step
  float* sy = sz + tile;              // the current stage's state
  float* ks = sy + tile;              // stage increments [NS][R][sH]
  float* dxs = ks + T::NS * tile;     // the step's rows of dx [R][NTC]
  zero_smem(hl, cde_fwd_floats(d, T::NS, T::NT) - wf);
  __syncthreads();

  const int row0 = blockIdx.x * d.R;
  const int nr = min(d.R, d.B - row0);
  const size_t BH = (size_t)d.B * H;
  for (int i = threadIdx.x; i < nr * H; i += THREADS)
    sz[(i / H) * sH + i % H] = z0[(size_t)row0 * H + i];

  for (int u = 0; u < d.M; ++u) {
    const float dt = dts[u];
    const float* dxu = dx + ((size_t)u * d.B + row0) * NTC;
    for (int i = threadIdx.x; i < nr * NTC; i += THREADS) dxs[i] = dxu[i];
#pragma unroll
    for (int s = 0; s < T::NS; ++s) {
      stage_state<T>(d, s, dt, sz, ks, sy, nr);
      __syncthreads();
      field_hidden<RELU, WIDE>(d, w, sy, hl, ob, nr);
      contract(d, ob, dxs + T::t(s) * d.C, NTC, ks + s * tile, nr);
    }
    const size_t off = u * BH + (size_t)row0 * H;
    for (int i = threadIdx.x; i < nr * H; i += THREADS) {
      const int e = (i / H) * sH + i % H;
      float v = sz[e];
#pragma unroll
      for (int s = 0; s < T::NS; ++s)
        if (T::b(s) != 0.f) v = v + (T::b(s) * dt) * ks[s * tile + e];
      sz[e] = v;
      ys[off + i] = v;
    }
    __syncthreads();
  }
}

// Back through one field evaluation (hl, ob as field_hidden left them for
// the stage state y) given dk [R][odd(H)], the cotangent of the stage's
// k: adds the stage's share of the control cotangent into ddt (rows of
// stride ntc at the stage's time), the weight gradients into g (shared
// memory, or the block's partials) and into p_wo, p_bo (this block's
// partials in device memory), and writes dy [R][odd(H)], the cotangent of
// y. Overwrites ob and the
// ping-pong tiles e0, e1. Ends after a barrier.
template <bool RELU, bool WIDE>
__device__ __noinline__
void field_backward(const CdeDims dp, const CdeWeights w, const CdeGrads g,
                    const float* y, const float* dk, const float* dxt,
                    float* ddt, int ntc, const float* hl, float* ob,
                    float* e0, float* e1, float* dy,
                    float* __restrict__ p_wo, float* __restrict__ p_bo,
                    int nr) {
  const CdeDims d = placed<WIDE>(dp);
  const int H = d.H, HH = d.HH, C = d.C, HC = d.H * d.C, NI = d.NI;
  const int sH = odd(H), sHH = odd(HH), tid = threadIdx.x;
  const int lh = WIDE ? w.lh : sHH, lo = WIDE ? w.lo : ldo(d);
  const float* hlast = hl + NI * d.R * sHH;

  // the control: dd[c] += sum_h dk[h] O[h*C + c]
  for (int i = tid; i < nr * C; i += THREADS) {
    const int r = i / C, c = i % C;
    float acc = 0.f;
    for (int h = 0; h < H; ++h)
      acc = fmaf(dk[r * sH + h], ob[r * HC + h * C + c], acc);
    ddt[r * ntc + c] += acc;
  }
  __syncthreads();

  // dzout = dk dX/dt (1 - O^2), in place of O; then Wout's and bout's
  // gradients from the column this thread owns (rows past nr: dz 0, read
  // against row nr - 1 of hlast, inside the tile)
  int ro[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) ro[r] = (WIDE ? min(r, nr - 1) : r) * sHH;
  for (int q = tid; q < HC; q += THREADS) {
    const int h = q / C, c = q % C;
    float dz[ROWS];
    float sb = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      dz[r] = 0.f;
      if (r < nr) {
        const float o = ob[r * HC + q];
        dz[r] = (dk[r * sH + h] * dxt[r * ntc + c]) * (1.f - o * o);
        ob[r * HC + q] = dz[r];
        sb += dz[r];
      }
    }
    p_bo[q] += sb;
    for (int k = 0; k < HH; ++k) {
      float acc = 0.f;
#pragma unroll
      for (int r = 0; r < ROWS; ++r)
        acc = fmaf(hlast[ro[r] + k], dz[r], acc);
      p_wo[(size_t)k * HC + q] += acc;
    }
  }
  __syncthreads();

  // back through Wout and the last activation
  for (int i = tid; i < nr * HH; i += THREADS) {
    const int r = i / HH, k = i % HH;
    const float dh = dot_row(ob + r * HC, w.wo + (size_t)k * lo, HC);
    e0[r * sHH + k] = dh * act_d<RELU>(hlast[r * sHH + k]);
  }
  __syncthreads();

  // inner layers in reverse
  float* ein = e0;
  float* eout = e1;
  for (int l = NI - 1; l >= 0; --l) {
    const float* hprev = hl + l * d.R * sHH;
    const float* W = w.wi + (size_t)l * HH * lh;
    for (int e = tid; e < HH * HH; e += THREADS) {
      const int k = e / HH, c = e % HH;
      float acc = 0.f;
      for (int r = 0; r < nr; ++r)
        acc = fmaf(hprev[r * sHH + k], ein[r * sHH + c], acc);
      g.wi[l * HH * HH + e] += acc;
    }
    for (int c = tid; c < HH; c += THREADS) {
      float sb = 0.f;
      for (int r = 0; r < nr; ++r) sb += ein[r * sHH + c];
      g.bi[l * HH + c] += sb;
    }
    for (int i = tid; i < nr * HH; i += THREADS) {
      const int r = i / HH, k = i % HH;
      const float dh = dot_row(ein + r * sHH, W + (size_t)k * lh, HH);
      eout[r * sHH + k] = dh * act_d<RELU>(hprev[r * sHH + k]);
    }
    __syncthreads();
    float* t = ein; ein = eout; eout = t;
  }

  // the first layer: Win, bin, and the state's cotangent
  for (int e = tid; e < H * HH; e += THREADS) {
    const int k = e / HH, c = e % HH;
    float acc = 0.f;
    for (int r = 0; r < nr; ++r)
      acc = fmaf(y[r * sH + k], ein[r * sHH + c], acc);
    g.win[e] += acc;
  }
  for (int c = tid; c < HH; c += THREADS) {
    float sb = 0.f;
    for (int r = 0; r < nr; ++r) sb += ein[r * sHH + c];
    g.bin[c] += sb;
  }
  for (int i = tid; i < nr * H; i += THREADS) {
    const int r = i / H, k = i % H;
    dy[r * sH + k] = dot_row(ein + r * sHH, w.win + (size_t)k * lh, HH);
  }
  __syncthreads();
}

template <class T, bool RELU, bool WIDE>
__global__ void __launch_bounds__(THREADS)
cde_bwd_kernel(CdeDims dp, const float* __restrict__ z0,
               const float* __restrict__ ys, const float* __restrict__ gys,
               const float* __restrict__ dx, const float* __restrict__ dts,
               const float* __restrict__ win, const float* __restrict__ bin,
               const float* __restrict__ wi, const float* __restrict__ bi,
               const float* __restrict__ wo, const float* __restrict__ bo,
               float* __restrict__ ddx, float* __restrict__ dz0,
               float* __restrict__ p_win, float* __restrict__ p_bin,
               float* __restrict__ p_wi, float* __restrict__ p_bi,
               float* __restrict__ p_wo, float* __restrict__ p_bo) {
  extern __shared__ float smem[];
  const CdeDims d = placed<WIDE>(dp);
  const int H = d.H, HH = d.HH, NI = d.NI, HC = d.H * d.C;
  const int sH = odd(H), sHH = odd(HH), NTC = T::NT * d.C, tid = threadIdx.x;
  const size_t tile = (size_t)d.R * sH;
  const size_t wf = d.w_smem ? cde_weights_floats(d) : 0;
  const CdeWeights w = load_cde_weights(smem, d, win, bin, wi, bi, wo, bo);
  float* rest = smem + wf;
  zero_smem(rest, cde_bwd_floats(d, T::NS, T::NT) - wf);
  // the accumulators of Win, bin and the inner layers: in shared memory
  // (stored to the partials after the loop), or the block's partials
  const size_t blk = blockIdx.x;
  CdeGrads g;
  if (d.g_smem) {
    g.win = rest;                     // [H][HH]
    g.bin = g.win + H * HH;           // [HH]
    g.wi = g.bin + HH;                // [NI][HH][HH]
    g.bi = g.wi + NI * HH * HH;       // [NI][HH]
    rest = g.bi + NI * HH;
  } else {
    g.win = p_win + blk * H * HH;
    g.bin = p_bin + blk * HH;
    g.wi = p_wi + blk * NI * HH * HH;
    g.bi = p_bi + blk * NI * HH;
    for (int e = tid; e < H * HH; e += THREADS) g.win[e] = 0.f;
    for (int e = tid; e < HH; e += THREADS) g.bin[e] = 0.f;
    for (int e = tid; e < NI * HH * HH; e += THREADS) g.wi[e] = 0.f;
    for (int e = tid; e < NI * HH; e += THREADS) g.bi[e] = 0.f;
  }
  float* hl = rest;                   // [NI+1][R][sHH]
  float* ob = hl + (NI + 1) * d.R * sHH;  // [R][HC]
  float* e0 = ob + d.R * HC;          // [R][sHH] each
  float* e1 = e0 + d.R * sHH;
  float* gbar = e1 + d.R * sHH;       // cotangent of the state [R][sH]
  float* dy = gbar + tile;            // a stage state's cotangent
  float* yst = dy + tile;             // stage states [NS][R][sH]
  float* ks = yst + T::NS * tile;     // stage increments [NS][R][sH]
  float* dks = ks + T::NS * tile;     // their cotangents [NS][R][sH]
  float* dxs = dks + T::NS * tile;    // the step's rows of dx [R][NTC]
  float* dd = dxs + d.R * NTC;        // their cotangent [R][NTC]

  // this block's partials of dWout and dbout: entry (k, q) is owned by the
  // thread that owns column q in field_backward
  float* pwo = p_wo + blk * HH * HC;
  float* pbo = p_bo + blk * HC;
  for (int q = tid; q < HC; q += THREADS) {
    pbo[q] = 0.f;
    for (int k = 0; k < HH; ++k) pwo[(size_t)k * HC + q] = 0.f;
  }
  __syncthreads();

  const int row0 = blockIdx.x * d.R;
  const int nr = min(d.R, d.B - row0);
  const size_t BH = (size_t)d.B * H;
  for (int u = d.M - 1; u >= 0; --u) {
    const float dt = dts[u];
    const float* zprev = (u == 0 ? z0 : ys + (u - 1) * BH) + (size_t)row0 * H;
    const size_t off = u * BH + (size_t)row0 * H;
    for (int i = tid; i < nr * H; i += THREADS) {
      const int e = (i / H) * sH + i % H;
      yst[e] = zprev[i];             // stage 0's state is z
      gbar[e] += gys[off + i];
    }
    const size_t offx = ((size_t)u * d.B + row0) * NTC;
    for (int i = tid; i < nr * NTC; i += THREADS) {
      dxs[i] = dx[offx + i];
      dd[i] = 0.f;
    }
    __syncthreads();

    // recompute the stage states and increments
#pragma unroll
    for (int s = 0; s < T::NS; ++s) {
      if (s > 0) {
        stage_state<T>(d, s, dt, yst, ks, yst + s * tile, nr);
        __syncthreads();
      }
      field_hidden<RELU, WIDE>(d, w, yst + s * tile, hl, ob, nr);
      contract(d, ob, dxs + T::t(s) * d.C, NTC, ks + s * tile, nr);
    }

    // reverse through the tableau: dk_i = b_i dt gbar, then each stage
    for (int i = tid; i < nr * H; i += THREADS) {
      const int e = (i / H) * sH + i % H;
#pragma unroll
      for (int s = 0; s < T::NS; ++s)
        dks[s * tile + e] = T::b(s) != 0.f ? (T::b(s) * dt) * gbar[e] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int s = T::NS - 1; s >= 0; --s) {
      // the last stage's activations are still in hl and ob
      if (s != T::NS - 1)
        field_hidden<RELU, WIDE>(d, w, yst + s * tile, hl, ob, nr);
      field_backward<RELU, WIDE>(d, w, g, yst + s * tile, dks + s * tile,
                           dxs + T::t(s) * d.C, dd + T::t(s) * d.C, NTC, hl,
                           ob, e0, e1, dy, pwo, pbo, nr);
      for (int i = tid; i < nr * H; i += THREADS) {
        const int e = (i / H) * sH + i % H;
        const float v = dy[e];
        gbar[e] += v;
#pragma unroll
        for (int j = 0; j < T::NS; ++j)
          if (j < s && T::a(s, j) != 0.f)
            dks[j * tile + e] += (T::a(s, j) * dt) * v;
      }
      __syncthreads();
    }
    for (int i = tid; i < nr * NTC; i += THREADS) ddx[offx + i] = dd[i];
  }

  for (int i = tid; i < nr * H; i += THREADS)
    dz0[(size_t)row0 * H + i] = gbar[(i / H) * sH + i % H];
  if (!d.g_smem) return;
  for (int e = tid; e < H * HH; e += THREADS) p_win[blk * H * HH + e] = g.win[e];
  for (int e = tid; e < HH; e += THREADS) p_bin[blk * HH + e] = g.bin[e];
  for (int e = tid; e < NI * HH * HH; e += THREADS)
    p_wi[blk * NI * HH * HH + e] = g.wi[e];
  for (int e = tid; e < NI * HH; e += THREADS) p_bi[blk * NI * HH + e] = g.bi[e];
}

struct FwdArgs {
  CdeDims d;
  const float *z0, *dx, *dts, *win, *bin, *wi, *bi, *wo, *bo;
  float* ys;
  cudaStream_t stream;
};

struct BwdArgs {
  CdeDims d;
  const float *z0, *ys, *gys, *dx, *dts, *win, *bin, *wi, *bi, *wo, *bo;
  float *ddx, *dz0, *p_win, *p_bin, *p_wi, *p_bi, *p_wo, *p_bo;
  cudaStream_t stream;
};

// the main paths' placement runs its own instance (sde_common.cuh: placed)
template <class T, bool RELU>
int run_fwd(const FwdArgs& a) {
  CdeDims d = a.d;
  const int smem = (int)cde_plan(d, T::NS, T::NT, 0);
  auto k = d.level == 0 ? cde_fwd_kernel<T, RELU, false>
                        : cde_fwd_kernel<T, RELU, true>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(d.B + d.R - 1) / d.R, THREADS, smem, a.stream>>>(
      d, a.z0, a.dx, a.dts, a.win, a.bin, a.wi, a.bi, a.wo, a.bo, a.ys);
  return (int)cudaGetLastError();
}

template <class T, bool RELU>
int run_bwd(const BwdArgs& a) {
  CdeDims d = a.d;
  const int smem = (int)cde_plan(d, T::NS, T::NT, 1);
  auto k = d.level == 0 ? cde_bwd_kernel<T, RELU, false>
                        : cde_bwd_kernel<T, RELU, true>;
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  k<<<(d.B + d.R - 1) / d.R, THREADS, smem, a.stream>>>(
      d, a.z0, a.ys, a.gys, a.dx, a.dts, a.win, a.bin, a.wi, a.bi, a.wo,
      a.bo, a.ddx, a.dz0, a.p_win, a.p_bin, a.p_wi, a.p_bi, a.p_wo, a.p_bo);
  return (int)cudaGetLastError();
}

// One instantiation per (tableau, activation); act 0 is relu (FinalTanh),
// 1 is tanh (SingleHiddenLayer).
template <template <class, bool> class Fn, class Args>
int dispatch(int method, int act_code, const Args& a) {
  const bool relu = act_code == 0;
  switch (method) {
    case 0: return relu ? Fn<Euler, true>::run(a) : Fn<Euler, false>::run(a);
    case 1:
      return relu ? Fn<Midpoint, true>::run(a) : Fn<Midpoint, false>::run(a);
    case 2: return relu ? Fn<Heun, true>::run(a) : Fn<Heun, false>::run(a);
    case 3: return relu ? Fn<Rk4, true>::run(a) : Fn<Rk4, false>::run(a);
  }
  return (int)cudaErrorInvalidValue;
}

template <class T, bool RELU>
struct Fwd {
  static int run(const FwdArgs& a) { return run_fwd<T, RELU>(a); }
};

template <class T, bool RELU>
struct Bwd {
  static int run(const BwdArgs& a) { return run_bwd<T, RELU>(a); }
};

}  // namespace

extern "C" {

// Dynamic shared memory a launch needs, in bytes, at its placement (above
// the device's limit when even one row a block with everything else in
// device memory does not fit; -1 for an unknown method).
long long fused_cde_smem_bytes(int H, int HH, int C, int n_inner, int method,
                               int backward) {
  int ns = 0, nt = 0;
  if (!stage_counts(method, &ns, &nt)) return -1;
  CdeDims d{0, 0, H, HH, C, n_inner};
  return (long long)cde_plan(d, ns, nt, backward);
}

// One field of a launch's plan: 0 the placement (sde_common.cuh), 1 batch
// rows a block (the leading dimension of the backward's partials is
// ceil(B / rows)); -1 for an unknown method.
int fused_cde_plan(int H, int HH, int C, int n_inner, int method,
                   int backward, int field) {
  int ns = 0, nt = 0;
  if (!stage_counts(method, &ns, &nt)) return -1;
  CdeDims d{0, 0, H, HH, C, n_inner};
  cde_plan(d, ns, nt, backward);
  return field == 0 ? d.level : d.R;
}

// Make later launches take placement `first` or a later one (0: the
// host's own choice). For tests of each placement.
int fused_cde_force_placement(int first) {
  if (first < 0 || first >= PLACEMENTS) return (int)cudaErrorInvalidValue;
  g_first_placement = first;
  return 0;
}

int fused_cde_max_smem() { return max_optin_smem(); }

const char* fused_cde_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int fused_cde_fwd(const float* z0, const float* dx, const float* dts,
                  const float* win, const float* bin, const float* wi,
                  const float* bi, const float* wo, const float* bo, float* ys,
                  int M, int B, int H, int HH, int C, int n_inner, int method,
                  int act_code, void* stream) {
  const FwdArgs a{CdeDims{M, B, H, HH, C, n_inner}, z0, dx, dts, win, bin,
                  wi, bi, wo, bo, ys, (cudaStream_t)stream};
  return dispatch<Fwd>(method, act_code, a);
}

int fused_cde_bwd(const float* z0, const float* ys, const float* gys,
                  const float* dx, const float* dts, const float* win,
                  const float* bin, const float* wi, const float* bi,
                  const float* wo, const float* bo, float* ddx, float* dz0,
                  float* p_win, float* p_bin, float* p_wi, float* p_bi,
                  float* p_wo, float* p_bo, int M, int B, int H, int HH,
                  int C, int n_inner, int method, int act_code,
                  void* stream) {
  const BwdArgs a{CdeDims{M, B, H, HH, C, n_inner}, z0, ys, gys, dx, dts,
                  win, bin, wi, bi, wo, bo, ddx, dz0, p_win, p_bin, p_wi,
                  p_bi, p_wo, p_bo, (cudaStream_t)stream};
  return dispatch<Bwd>(method, act_code, a);
}

}  // extern "C"
