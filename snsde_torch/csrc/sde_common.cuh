// Device code shared by the fused SDE solver kernels (fused_em.cu,
// fused_srk.cu): the tile geometry, the placement of the weights and the
// gradient accumulators (shared or device memory), the weights of the
// merged drift MLP, and the MLP's forward and backward over one tile of
// batch rows.
//
// The drift MLP of a DiffusionField in drift mode 'embm' (the merged emb
// drift, input_option 2/4/6), with the y-independent parts precomputed
// outside the kernels:
//   z1 = s Wy' + a' + xh';  h_0 = relu(z1);  h_{l+1} = relu(h_l W_l + b_l)
//   z3 = h_NI Wout + bo  (* tanh(s) when geometric);  f = tanh(z3)
// Weights are in [in, out] layout in device memory. Shared-memory rows use
// an odd stride, so both a row walk (the forward product) and a column
// walk (the W^T products of the backward) are free of bank conflicts.
//
// Placement (the host plan, `place`): the weights, and in the backward
// the weight-gradient accumulators, stay in shared memory beside the
// tiles when they fit, as they do at the main paths' widths. Where they
// do not, the accumulators move first to the block's slice of the
// per-block partials in device memory (each entry still owned by one
// thread for the whole loop: no atomics), then the weights, which the
// products then read from device memory (L2-resident) at their natural
// row strides; last the block takes 4, 2 or 1 batch rows instead of 8, so
// the tiles fit at any width the JAX package trains.
//
// Everything here has internal linkage: each source that includes it
// builds into its own library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int ROWS = 8;       // batch rows per thread block (the most)
constexpr int THREADS = 256;  // threads per block

struct Dims {
  int M, B, H, HH, n_inner, mult_y, geometric;
  // the placement (set by `place`): its level, weights and gradient
  // accumulators in shared memory (1) or device memory (0), R batch rows a
  // block
  int level, w_smem, g_smem, R;
};

__host__ __device__ inline int odd(int n) { return n | 1; }

__host__ __device__ inline size_t weights_floats(const Dims& d) {
  return (size_t)d.H * odd(d.HH) + (size_t)d.n_inner * d.HH * odd(d.HH) +
         (size_t)d.n_inner * d.HH + (size_t)d.HH * odd(d.H) + d.H;
}

// weight-gradient accumulators, unpadded [in, out]
__host__ __device__ inline size_t grads_floats(const Dims& d) {
  return (size_t)d.H * d.HH + (size_t)d.n_inner * d.HH * d.HH +
         (size_t)d.n_inner * d.HH + (size_t)d.HH * d.H + d.H;
}

// what the placement keeps in shared memory
__host__ __device__ inline size_t smem_weights(const Dims& d) {
  return d.w_smem ? weights_floats(d) : 0;
}
__host__ __device__ inline size_t smem_grads(const Dims& d) {
  return d.g_smem ? grads_floats(d) : 0;
}

// a tile of R rows of width H (state-like) or HH (activations)
__host__ __device__ inline size_t tile_h(const Dims& d) {
  return (size_t)d.R * odd(d.H);
}
__host__ __device__ inline size_t tile_hh(const Dims& d) {
  return (size_t)d.R * odd(d.HH);
}

// The placements in the order the host tries them: 0 everything in shared
// memory; 1 the gradient accumulators in device memory; 2 the weights too;
// 3, 4, 5 as 2 with 4, 2 and 1 batch rows a block.
constexpr int PLACEMENTS = 6;

// (D: Dims, or any dims with the same four placement fields)
template <class D>
inline void set_placement(D& d, int level) {
  d.level = level;
  d.g_smem = level < 1;
  d.w_smem = level < 2;
  d.R = level < 3 ? ROWS : ROWS >> (level - 2);
}

// The first placement from `first` on whose shared memory (floats(d)
// floats) fits one block; returns its bytes, above the device's limit
// when none fits (the launch is then refused). The placement is a pure
// function of the shapes and `first`, so the wrapper sizes the per-block
// partials from the same plan.
template <class D, class F>
inline size_t place(D& d, F floats, int first, size_t limit) {
  size_t bytes = 0;
  for (int level = first; level < PLACEMENTS; ++level) {
    set_placement(d, level);
    bytes = sizeof(float) * floats(d);
    if (bytes <= limit) break;
  }
  return bytes;
}

// The placement a kernel instance runs: the host's (WIDE), or the main
// paths' as compile-time constants (everything in shared memory, ROWS rows
// a block), so that instance compiles as it would if no other placement
// existed (shared-memory pointers known as such, constant strides).
template <bool WIDE, class D>
__device__ __forceinline__ D placed(D d) {
  if (!WIDE) {
    d.level = 0;
    d.w_smem = 1;
    d.g_smem = 1;
    d.R = ROWS;
  }
  return d;
}

// weights as the products read them: shared-memory copies at odd row
// strides, or the tensors in device memory at their own; ly is the row
// stride of wy and of each inner layer, lo that of wo
struct Weights {
  const float *wy, *wi, *bi, *wo, *bo;
  int ly, lo;
};

struct Grads {
  float *wy, *wi, *bi, *wo, *bo;
};

// The weights: copied into shared memory at s ([in, out] layout in device
// memory, rows padded to an odd stride here), or, without w_smem, read
// where they are.
__device__ __forceinline__
Weights load_weights(float* s, const Dims& d,
                     const float* __restrict__ wy,
                     const float* __restrict__ wi,
                     const float* __restrict__ bi,
                     const float* __restrict__ wo,
                     const float* __restrict__ bo) {
  const int H = d.H, HH = d.HH, sH = odd(H), sHH = odd(HH);
  if (!d.w_smem) return Weights{wy, wi, bi, wo, bo, HH, H};
  float* swy = s;
  float* swi = swy + H * sHH;
  float* sbi = swi + d.n_inner * HH * sHH;
  float* swo = sbi + d.n_inner * HH;
  float* sbo = swo + HH * sH;
  for (int i = threadIdx.x; i < H * HH; i += THREADS)
    swy[(i / HH) * sHH + i % HH] = wy[i];
  for (int i = threadIdx.x; i < d.n_inner * HH * HH; i += THREADS)
    swi[(i / HH) * sHH + i % HH] = wi[i];  // rows of all layers stacked
  for (int i = threadIdx.x; i < d.n_inner * HH; i += THREADS) sbi[i] = bi[i];
  for (int i = threadIdx.x; i < HH * H; i += THREADS)
    swo[(i / H) * sH + i % H] = wo[i];
  for (int i = threadIdx.x; i < H; i += THREADS) sbo[i] = bo[i];
  return Weights{swy, swi, sbi, swo, sbo, sHH, sH};
}

// Zeroed weight-gradient accumulators: carved out of shared memory at s,
// or, without g_smem, the block's slices of the per-block partials in
// device memory. Entry e of each is owned by thread e % THREADS for the
// whole reverse loop, so no two threads ever add into one entry.
__device__ __forceinline__
Grads zero_grads(float* s, const Dims& d, float* p_wy, float* p_wi,
                 float* p_bi, float* p_wo, float* p_bo) {
  const int H = d.H, HH = d.HH, NI = d.n_inner, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  Grads g;
  if (d.g_smem) {
    g.wy = s;                   // [H][HH]
    g.wi = g.wy + H * HH;       // [NI][HH][HH]
    g.bi = g.wi + NI * HH * HH; // [NI][HH]
    g.wo = g.bi + NI * HH;      // [HH][H]
    g.bo = g.wo + HH * H;       // [H]
  } else {
    g.wy = p_wy + b * H * HH;
    g.wi = p_wi + b * NI * HH * HH;
    g.bi = p_bi + b * NI * HH;
    g.wo = p_wo + b * HH * H;
    g.bo = p_bo + b * H;
  }
  for (int e = tid; e < H * HH; e += THREADS) g.wy[e] = 0.f;
  for (int e = tid; e < NI * HH * HH; e += THREADS) g.wi[e] = 0.f;
  for (int e = tid; e < NI * HH; e += THREADS) g.bi[e] = 0.f;
  for (int e = tid; e < HH * H; e += THREADS) g.wo[e] = 0.f;
  for (int e = tid; e < H; e += THREADS) g.bo[e] = 0.f;
  return g;
}

// Write one block's accumulators to its slot of the per-block partials
// (where they are not there already).
__device__ __forceinline__
void store_grads(const Dims& d, const Grads& g, float* p_wy,
                 float* p_wi, float* p_bi, float* p_wo,
                 float* p_bo) {
  const int H = d.H, HH = d.HH, NI = d.n_inner, tid = threadIdx.x;
  const size_t b = blockIdx.x;
  if (!d.g_smem) return;
  for (int e = tid; e < H * HH; e += THREADS) p_wy[b * H * HH + e] = g.wy[e];
  for (int e = tid; e < NI * HH * HH; e += THREADS)
    p_wi[b * NI * HH * HH + e] = g.wi[e];
  for (int e = tid; e < NI * HH; e += THREADS) p_bi[b * NI * HH + e] = g.bi[e];
  for (int e = tid; e < HH * H; e += THREADS) p_wo[b * HH * H + e] = g.wo[e];
  for (int e = tid; e < H; e += THREADS) p_bo[b * H + e] = g.bo[e];
}

// sum_k act[k] * W[k][j]: a row of activations times column j of W
__device__ __forceinline__ float dot_col(const float* act, const float* W,
                                         int K, int ldw, int j) {
  float acc = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) acc = fmaf(act[k], W[k * ldw + j], acc);
  return acc;
}

// sum_c d[c] * Wk[c]: a row of cotangents times row k of W (W^T product)
__device__ __forceinline__ float dot_row(const float* dr, const float* Wk,
                                         int N) {
  float acc = 0.f;
#pragma unroll 4
  for (int c = 0; c < N; ++c) acc = fmaf(dr[c], Wk[c], acc);
  return acc;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// The hidden activations of the drift MLP for the nr rows of a tile whose
// input state is s [R][odd(H)]: hl[l] ([R][odd(HH)] each, NI+1 of them)
// = h_l. a_u is the step's a' row [HH], xh_u the tile's rows of the
// xh' stream [nr][HH]. Ends after a barrier.
__device__ __forceinline__
void mlp_hidden(const Dims& d, const Weights& w, const float* s,
                const float* __restrict__ a_u,
                const float* __restrict__ xh_u, float* hl,
                int nr) {
  const int H = d.H, HH = d.HH, sH = odd(H), sHH = odd(HH);
  for (int i = threadIdx.x; i < nr * HH; i += THREADS) {
    const int r = i / HH, j = i % HH;
    const float z = dot_col(s + r * sH, w.wy, H, w.ly, j) + a_u[j] + xh_u[i];
    hl[r * sHH + j] = fmaxf(z, 0.f);
  }
  __syncthreads();
  for (int l = 0; l < d.n_inner; ++l) {
    const float* hin = hl + l * tile_hh(d);
    float* hout = hl + (l + 1) * tile_hh(d);
    const float* W = w.wi + (size_t)l * HH * w.ly;
    for (int i = threadIdx.x; i < nr * HH; i += THREADS) {
      const int r = i / HH, j = i % HH;
      const float z = dot_col(hin + r * sHH, W, HH, w.ly, j) +
                      w.bi[l * HH + j];
      hout[r * sHH + j] = fmaxf(z, 0.f);
    }
    __syncthreads();
  }
}

// z3 before the geometric factor, for row r and output column j, from the
// last hidden layer hlast
__device__ __forceinline__ float mlp_out(const Dims& d, const Weights& w,
                                         const float* hlast, int r, int j) {
  return dot_col(hlast + r * odd(d.HH), w.wo, d.HH, w.lo, j) + w.bo[j];
}

// Back through the drift MLP of one evaluation for the nr rows of a tile:
// sd [R][odd(H)] holds the cotangent of z3 before the geometric factor,
// hl the evaluation's hidden activations (as mlp_hidden left them), s its
// input state. Adds the weight gradients into g and returns the cotangent
// of z1 (in e0 or e1), which the caller spreads onto a', xh' and the state
// (through Wy'^T). The caller must have put a barrier between writing sd
// and this call, and must put one after its own use of the result. It may
// run loops over other data between the two without one.
__device__ __forceinline__
const float* mlp_backward(const Dims& d, const Weights& w,
                          const Grads& g, const float* s,
                          const float* hl, const float* sd,
                          float* e0, float* e1, int nr) {
  const int H = d.H, HH = d.HH, NI = d.n_inner, tid = threadIdx.x;
  const int sH = odd(H), sHH = odd(HH);
  const float* hlast = hl + NI * tile_hh(d);
  // Wout, bo; then back through Wout and the last relu
  for (int e = tid; e < HH * H; e += THREADS) {
    const int k = e / H, c = e % H;
    float acc = 0.f;
    for (int r = 0; r < nr; ++r)
      acc = fmaf(hlast[r * sHH + k], sd[r * sH + c], acc);
    g.wo[e] += acc;
  }
  for (int c = tid; c < H; c += THREADS) {
    float sb = 0.f;
    for (int r = 0; r < nr; ++r) sb += sd[r * sH + c];
    g.bo[c] += sb;
  }
  for (int i = tid; i < nr * HH; i += THREADS) {
    const int r = i / HH, k = i % HH;
    const float dh = dot_row(sd + r * sH, w.wo + (size_t)k * w.lo, H);
    e0[r * sHH + k] = hlast[r * sHH + k] > 0.f ? dh : 0.f;
  }
  __syncthreads();

  // inner layers in reverse
  float* ein = e0;
  float* eout = e1;
  for (int l = NI - 1; l >= 0; --l) {
    const float* hprev = hl + l * tile_hh(d);
    const float* W = w.wi + (size_t)l * HH * w.ly;
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
      const float dh = dot_row(ein + r * sHH, W + (size_t)k * w.ly, HH);
      eout[r * sHH + k] = hprev[r * sHH + k] > 0.f ? dh : 0.f;
    }
    __syncthreads();
    float* t = ein; ein = eout; eout = t;
  }

  // ein = cotangent of z1: Wy'
  for (int e = tid; e < H * HH; e += THREADS) {
    const int k = e / HH, c = e % HH;
    float acc = 0.f;
    for (int r = 0; r < nr; ++r)
      acc = fmaf(s[r * sH + k], ein[r * sHH + c], acc);
    g.wy[e] += acc;
  }
  return ein;
}

// The parts of dz1 that belong to the step's a' row (a per-block partial,
// summed by the wrapper) and to the tile's rows of the xh' stream, and
// ds [R][odd(H)] += dz1 Wy'^T (the state's share). No barrier.
__device__ __forceinline__
void spread_dz1(const Dims& d, const Weights& w, const float* ein,
                float* __restrict__ p_a_u,
                float* __restrict__ dxh_u, float* ds, int nr) {
  const int H = d.H, HH = d.HH, sH = odd(H), sHH = odd(HH);
  for (int c = threadIdx.x; c < HH; c += THREADS) {
    float sa = 0.f;
    for (int r = 0; r < nr; ++r) sa += ein[r * sHH + c];
    p_a_u[c] = sa;
  }
  for (int i = threadIdx.x; i < nr * HH; i += THREADS)
    dxh_u[i] = ein[(i / HH) * sHH + i % HH];
  for (int i = threadIdx.x; i < nr * H; i += THREADS) {
    const int r = i / H, k = i % H;
    ds[r * sH + k] += dot_row(ein + r * sHH, w.wy + (size_t)k * w.ly, HH);
  }
}

// column sums over the tile's rows of q [R][odd(H)] into out [H]
__device__ __forceinline__
void column_sums(const Dims& d, const float* q,
                 float* __restrict__ out, int nr) {
  const int sH = odd(d.H);
  for (int c = threadIdx.x; c < d.H; c += THREADS) {
    float s = 0.f;
    for (int r = 0; r < nr; ++r) s += q[r * sH + c];
    out[c] = s;
  }
}

// sum over the block of one float per thread (all threads must call it)
__device__ __forceinline__
float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  for (int k = 0; k < THREADS / 32; ++k) s += red[k];
  return s;
}

// The most dynamic shared memory one block may opt in to on this device.
inline int max_optin_smem() {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return v;
}

}  // namespace
