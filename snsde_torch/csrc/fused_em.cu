// Fused Euler–Maruyama solve of a DiffusionField SDE: forward and backward
// kernels for NVIDIA Hopper (sm_90a), plain C interface (loaded with ctypes
// by snsde_torch/kernels/fused_em.py).
//
// Replaces the Pallas TPU kernels of snsde/kernels/fused_em.py:
//   forward  _fused_em_forward (pallas_call at :688, body _fwd_kernel :590)
//   backward _fused_em_backward (pallas_call at :888, body _bwd_kernel :736)
// for drift mode 'embm' (merged emb drift, input_option 2/4/6), noise mode
// 'precomp' (the diffusion magnitude gk[u] depends on t only), with or
// without mult_y and geometric.
//
// Each step u (the primes are precomputed outside the kernel):
//   z1 = y Wy' + a'[u] + xh'[u];  h = relu(z1);  h = relu(h W_l + b_l) ...
//   z3 = h Wout + bo  (* tanh(y) when geometric);  f = tanh(z3)
//   graw = gk[u] (* y when mult_y);  g = tanh(sigmoid(theta) graw)
//   y <- y + f dt[u] + g dW[u]
// The backward runs the steps in reverse, recomputes the activations from
// the saved trajectory, and accumulates per-block weight gradients that
// the wrapper sums in a fixed order (no atomics: runs are bit-reproducible).
// The drift MLP's device code is shared with fused_srk.cu (sde_common.cuh).
//
// What bounds it on the H100: not bytes or FLOPs (at B=1024, L=72, H=49 the
// forward moves ~43 MB and does ~1 GFLOP, ~15 us of either) but the chain
// of 71 dependent steps, each three [rows x 49] x [49 x 49] products with a
// block barrier between them, over only 1024 independent rows. The design:
// one thread block per tile of ROWS batch rows runs the whole time loop, so
// the state, the activations and the weights (and, in the backward, the
// weight-gradient accumulators) stay in shared memory for all steps and
// only the per-step streams touch device memory; exact fp32 FMA on the CUDA
// cores (TF32/wgmma would leave the exact-fp32 regime).

#include "sde_common.cuh"

namespace {

__host__ __device__ inline size_t fwd_floats(const Dims& d) {
  return weights_floats(d) + tile_h(d) + (d.n_inner + 1) * tile_hh(d);
}

__host__ __device__ inline size_t bwd_floats(const Dims& d) {
  return weights_floats(d) + grads_floats(d) + 4 * tile_h(d) +
         (d.n_inner + 3) * tile_hh(d) + THREADS / 32;
}

__global__ void __launch_bounds__(THREADS)
fwd_kernel(Dims d, const float* __restrict__ y0, const float* __restrict__ xh,
           const float* __restrict__ dw, const float* __restrict__ a,
           const float* __restrict__ gk, const float* __restrict__ dts,
           const float* __restrict__ theta, const float* __restrict__ wy,
           const float* __restrict__ wi, const float* __restrict__ bi,
           const float* __restrict__ wo, const float* __restrict__ bo,
           float* __restrict__ ys) {
  extern __shared__ float smem[];
  const int H = d.H, HH = d.HH, sH = odd(H), sHH = odd(HH);
  const Weights w = load_weights(smem, d, wy, wi, bi, wo, bo);
  float* sy = smem + weights_floats(d);  // state tile [ROWS][sH]
  float* hl = sy + tile_h(d);            // activations [NI+1][ROWS][sHH]
  const float* hlast = hl + d.n_inner * ROWS * sHH;

  const int row0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d.B - row0);
  const size_t BH = (size_t)d.B * H, BHH = (size_t)d.B * HH;
  for (int i = threadIdx.x; i < nr * H; i += THREADS)
    sy[(i / H) * sH + i % H] = y0[(size_t)row0 * H + i];
  const float sth = sigmoid(theta[0]);
  __syncthreads();

  for (int u = 0; u < d.M; ++u) {
    const float dt = dts[u];
    mlp_hidden(d, w, sy, a + (size_t)u * HH, xh + u * BHH + (size_t)row0 * HH,
               hl, nr);
    const size_t off = u * BH + (size_t)row0 * H;
    for (int i = threadIdx.x; i < nr * H; i += THREADS) {
      const int r = i / H, j = i % H;
      const float y = sy[r * sH + j];
      float z3 = mlp_out(d, w, hlast, r, j);
      if (d.geometric) z3 *= tanhf(y);
      const float f = tanhf(z3);
      float graw = gk[(size_t)u * H + j];
      if (d.mult_y) graw *= y;
      const float g = tanhf(sth * graw);
      const float yn = y + f * dt + g * dw[off + i];
      sy[r * sH + j] = yn;  // only this thread reads or writes (r, j) here
      ys[off + i] = yn;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
bwd_kernel(Dims d, const float* __restrict__ y0, const float* __restrict__ ys,
           const float* __restrict__ gys, const float* __restrict__ xh,
           const float* __restrict__ dw, const float* __restrict__ a,
           const float* __restrict__ gk, const float* __restrict__ dts,
           const float* __restrict__ theta, const float* __restrict__ wy,
           const float* __restrict__ wi, const float* __restrict__ bi,
           const float* __restrict__ wo, const float* __restrict__ bo,
           float* __restrict__ dxh, float* __restrict__ dy0,
           float* __restrict__ p_wy, float* __restrict__ p_wi,
           float* __restrict__ p_bi, float* __restrict__ p_wo,
           float* __restrict__ p_bo, float* __restrict__ p_a,
           float* __restrict__ p_gk, float* __restrict__ p_th) {
  extern __shared__ float smem[];
  const int H = d.H, HH = d.HH, NI = d.n_inner, M = d.M;
  const int sH = odd(H), sHH = odd(HH);
  const Weights w = load_weights(smem, d, wy, wi, bi, wo, bo);
  const Grads gr = zero_grads(smem + weights_floats(d), d);
  float* sy = smem + weights_floats(d) + grads_floats(d);  // y before the step
  float* sg = sy + tile_h(d);              // cotangent of y after the step
  float* sd = sg + tile_h(d);              // cotangent of z3 (pre-geometric)
  float* sq = sd + tile_h(d);              // cotangent of the gk row
  float* hl = sq + tile_h(d);              // h_0..h_NI [NI+1][ROWS][sHH]
  float* e0 = hl + (NI + 1) * tile_hh(d);  // MLP cotangents, ping-pong
  float* e1 = e0 + tile_hh(d);
  float* red = e1 + tile_hh(d);            // [THREADS / 32]
  const float* hlast = hl + NI * ROWS * sHH;

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  const int nr = min(ROWS, d.B - row0);
  const size_t BH = (size_t)d.B * H, BHH = (size_t)d.B * HH;
  for (int i = tid; i < ROWS * sH; i += THREADS) sg[i] = 0.f;
  const float sth = sigmoid(theta[0]);
  float th_acc = 0.f;
  __syncthreads();

  for (int u = M - 1; u >= 0; --u) {
    const float dt = dts[u];
    const float* yprev = (u == 0 ? y0 : ys + (u - 1) * BH) + (size_t)row0 * H;
    const size_t off = u * BH + (size_t)row0 * H;
    const size_t offh = u * BHH + (size_t)row0 * HH;
    for (int i = tid; i < nr * H; i += THREADS) {
      const int s = (i / H) * sH + i % H;
      sy[s] = yprev[i];
      sg[s] += gys[off + i];
    }
    __syncthreads();

    // recompute the drift MLP's activations
    mlp_hidden(d, w, sy, a + (size_t)u * HH, xh + offh, hl, nr);

    // back through the step: y' = y + f dt + g dW
    for (int i = tid; i < nr * H; i += THREADS) {
      const int r = i / H, j = i % H, s = r * sH + j;
      const float y = sy[s], gb = sg[s];
      const float z3l = mlp_out(d, w, hlast, r, j);
      const float ty = tanhf(y);
      const float f = tanhf(d.geometric ? z3l * ty : z3l);
      const float graw0 = gk[(size_t)u * H + j];
      const float graw = d.mult_y ? graw0 * y : graw0;
      const float g = tanhf(sth * graw);
      const float df = gb * dt, dg = gb * dw[off + i];
      const float dsg = dg * (1.f - g * g);
      th_acc = fmaf(dsg, graw, th_acc);
      const float dgraw = dsg * sth;
      float dbase = dgraw, dy = 0.f;
      if (d.mult_y) {
        dbase = dgraw * y;
        dy = dgraw * graw0;
      }
      const float dz3 = df * (1.f - f * f);
      float dz3l = dz3;
      if (d.geometric) {
        dz3l = dz3 * ty;
        dy += dz3 * z3l * (1.f - ty * ty);
      }
      sd[s] = dz3l;
      sq[s] = dbase;
      sg[s] = gb + dy;
    }
    __syncthreads();

    // the gk row; the MLP's weights; then a', xh' and y
    column_sums(d, sq, p_gk + ((size_t)blockIdx.x * M + u) * H, nr);
    const float* ein = mlp_backward(d, w, gr, sy, hl, sd, e0, e1, nr);
    spread_dz1(d, w, ein, p_a + ((size_t)blockIdx.x * M + u) * HH,
               dxh + offh, sg, nr);
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

int fused_em_rows_per_block() { return ROWS; }

// Dynamic shared memory a launch needs, in bytes.
long long fused_em_smem_bytes(int H, int HH, int n_inner, int backward) {
  const Dims d{0, 0, H, HH, n_inner, 0, 0};
  return (long long)sizeof(float) * (backward ? bwd_floats(d) : fwd_floats(d));
}

// The most dynamic shared memory one block may opt in to on this device.
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
  const Dims d{M, B, H, HH, n_inner, mult_y, geometric};
  const int smem = (int)(sizeof(float) * fwd_floats(d));
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  fwd_kernel<<<(B + ROWS - 1) / ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      d, y0, xh, dw, a, gk, dts, theta, wy, wi, bi, wo, bo, ys);
  return (int)cudaGetLastError();
}

int fused_em_bwd(const float* y0, const float* ys, const float* gys,
                 const float* xh, const float* dw, const float* a,
                 const float* gk, const float* dts, const float* theta,
                 const float* wy, const float* wi, const float* bi,
                 const float* wo, const float* bo, float* dxh, float* dy0,
                 float* p_wy, float* p_wi, float* p_bi, float* p_wo,
                 float* p_bo, float* p_a, float* p_gk, float* p_th, int M,
                 int B, int H, int HH, int n_inner, int mult_y, int geometric,
                 void* stream) {
  const Dims d{M, B, H, HH, n_inner, mult_y, geometric};
  const int smem = (int)(sizeof(float) * bwd_floats(d));
  cudaError_t err = cudaFuncSetAttribute(
      bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  bwd_kernel<<<(B + ROWS - 1) / ROWS, THREADS, smem, (cudaStream_t)stream>>>(
      d, y0, ys, gys, xh, dw, a, gk, dts, theta, wy, wi, bi, wo, bo, dxh, dy0,
      p_wy, p_wi, p_bi, p_wo, p_bo, p_a, p_gk, p_th);
  return (int)cudaGetLastError();
}

}  // extern "C"
