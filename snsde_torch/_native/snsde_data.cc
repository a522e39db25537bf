// snsde native data-path: host-side preprocessing hot spots.
//
// The reference does these in Python/pandas (slow at dataset scale):
//   * NaN-aware natural cubic spline coefficient fitting — a Python loop
//     per channel (reference controldiffeq/interpolate.py:56-153)
//   * Hermite coefficients with linear NaN fill (torchcde)
//   * per-channel elapsed-time deltas — pandas groupby-cumsum
//     (reference torch-ists/_utils.py:139-149)
//   * PSV record parsing (reference datasets/sepsis.py:42-120)
//
// This library implements them in multithreaded C++ for the host-side
// data pipeline (the device path stays in the CUDA kernels). Exposed via a
// plain C ABI for ctypes binding; no Python headers required. The same
// source as the JAX package's snsde/_native/snsde_data.cc, so both give the
// same bits.
//
// Build: make OUT=path/to/libsnsde_data.so (snsde_torch/data/native.py
// builds it at first use into snsde_torch/_build/)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline bool is_nan(float v) { return std::isnan(v); }

unsigned hw_threads() {
  unsigned n = std::thread::hardware_concurrency();
  return n ? n : 4;
}

template <typename F>
void parallel_for(int64_t n, F&& fn) {
  unsigned nt = std::min<int64_t>(hw_threads(), n);
  if (nt <= 1) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (unsigned t = 0; t < nt; ++t) {
    threads.emplace_back([&] {
      int64_t i;
      while ((i = next.fetch_add(1)) < n) fn(i);
    });
  }
  for (auto& th : threads) th.join();
}

// Thomas solve for the natural-cubic knot-derivative system on a clean
// (no-NaN) sequence of n points. Writes per-interval (a, b, 2c, 3d).
void natural_coeffs_clean(const float* t, const float* x, int n, float* a,
                          float* b, float* two_c, float* three_d) {
  if (n == 2) {
    a[0] = x[0];
    b[0] = (x[1] - x[0]) / (t[1] - t[0]);
    two_c[0] = 0.f;
    three_d[0] = 0.f;
    return;
  }
  std::vector<double> rh(n - 1), diag(n), rhs(n), cp(n), e(n), m(n);
  for (int i = 0; i + 1 < n; ++i) rh[i] = 1.0 / (t[i + 1] - t[i]);
  for (int i = 0; i < n; ++i) diag[i] = 0.0;
  for (int i = 0; i + 1 < n; ++i) {
    diag[i] += rh[i];
    diag[i + 1] += rh[i];
  }
  for (int i = 0; i < n; ++i) diag[i] *= 2.0;
  for (int i = 0; i < n; ++i) rhs[i] = 0.0;
  for (int i = 0; i + 1 < n; ++i) {
    double s = 3.0 * (x[i + 1] - x[i]) * rh[i] * rh[i];
    rhs[i] += s;
    rhs[i + 1] += s;
  }
  // Thomas: upper = lower = rh
  double denom = diag[0];
  cp[0] = rh[0] / denom;
  e[0] = rhs[0] / denom;
  for (int i = 1; i < n; ++i) {
    double low = rh[i - 1];
    denom = diag[i] - low * cp[i - 1];
    cp[i] = (i + 1 < n ? rh[i] : 0.0) / denom;
    e[i] = (rhs[i] - low * e[i - 1]) / denom;
  }
  m[n - 1] = e[n - 1];
  for (int i = n - 2; i >= 0; --i) m[i] = e[i] - cp[i] * m[i + 1];

  for (int i = 0; i + 1 < n; ++i) {
    double r = rh[i];
    double diff = x[i + 1] - x[i];
    a[i] = x[i];
    b[i] = (float)m[i];
    two_c[i] = (float)((6.0 * diff * r - 4.0 * m[i] - 2.0 * m[i + 1]) * r);
    three_d[i] =
        (float)((-6.0 * diff * r + 3.0 * (m[i] + m[i + 1])) * r * r);
  }
}

}  // namespace

extern "C" {

// NaN-aware natural cubic spline over [B, L, C] series (C-contiguous).
// Outputs are [B, L-1, C] each. Missing-value handling mirrors the
// reference: impute endpoints, fit on observed knots, expand coefficients
// to every interval via polynomial shift.
void snsde_natural_cubic_coeffs(const float* x, const float* times,
                                int64_t B, int64_t L, int64_t C, float* a,
                                float* b, float* two_c, float* three_d) {
  parallel_for(B * C, [&](int64_t bc) {
    int64_t bi = bc / C, ci = bc % C;
    std::vector<float> col(L);
    for (int64_t l = 0; l < L; ++l) col[l] = x[(bi * L + l) * C + ci];

    // collect observed
    std::vector<int> obs;
    obs.reserve(L);
    for (int64_t l = 0; l < L; ++l)
      if (!is_nan(col[l])) obs.push_back((int)l);

    auto out_at = [&](float* arr, int64_t l) -> float& {
      return arr[(bi * (L - 1) + l) * C + ci];
    };

    if (obs.empty()) {
      for (int64_t l = 0; l + 1 < L; ++l) {
        out_at(a, l) = out_at(b, l) = out_at(two_c, l) = out_at(three_d, l) =
            0.f;
      }
      return;
    }
    // impute endpoints
    if (is_nan(col[0])) col[0] = col[obs.front()];
    if (is_nan(col[L - 1])) col[L - 1] = col[obs.back()];
    obs.clear();
    for (int64_t l = 0; l < L; ++l)
      if (!is_nan(col[l])) obs.push_back((int)l);

    int n = (int)obs.size();
    std::vector<float> tc(n), xc(n);
    for (int i = 0; i < n; ++i) {
      tc[i] = times[obs[i]];
      xc[i] = col[obs[i]];
    }
    std::vector<float> ca(std::max(n - 1, 1)), cb(std::max(n - 1, 1)),
        cc(std::max(n - 1, 1)), cd(std::max(n - 1, 1));
    natural_coeffs_clean(tc.data(), xc.data(), n, ca.data(), cb.data(),
                         cc.data(), cd.data());

    // expand to every interval
    int j = 0;
    for (int64_t l = 0; l + 1 < L; ++l) {
      float tau = times[l];
      while (j + 1 < n - 1 && tc[j + 1] <= tau) ++j;
      float off = tc[j] - tau;
      float aj = ca[j], bj = cb[j], c2 = cc[j], d3 = cd[j];
      out_at(a, l) = aj + ((0.5f * c2 - d3 * off / 3.f) * off - bj) * off;
      out_at(b, l) = bj + (d3 * off - c2) * off;
      out_at(two_c, l) = c2 - 2.f * d3 * off;
      out_at(three_d, l) = d3;
    }
  });
}

// Hermite cubic with backward differences; NaNs filled by linear
// interpolation with constant extension. Outputs [B, L-1, C] x 4.
void snsde_hermite_coeffs(const float* x, const float* times, int64_t B,
                          int64_t L, int64_t C, float* a, float* b,
                          float* two_c, float* three_d) {
  parallel_for(B * C, [&](int64_t bc) {
    int64_t bi = bc / C, ci = bc % C;
    std::vector<float> col(L);
    for (int64_t l = 0; l < L; ++l) col[l] = x[(bi * L + l) * C + ci];
    // linear fill
    int prev = -1;
    for (int64_t l = 0; l < L; ++l) {
      if (!is_nan(col[l])) {
        if (prev < 0) {
          for (int64_t k = 0; k < l; ++k) col[k] = col[l];  // backfill
        } else if (prev + 1 < (int64_t)l) {
          float t0 = times[prev], t1 = times[l];
          for (int64_t k = prev + 1; k < l; ++k) {
            float w = (times[k] - t0) / (t1 - t0);
            col[k] = col[prev] + w * (col[l] - col[prev]);
          }
        }
        prev = (int)l;
      }
    }
    if (prev < 0) {
      std::fill(col.begin(), col.end(), 0.f);
    } else {
      for (int64_t k = prev + 1; k < L; ++k) col[k] = col[prev];
    }
    auto out_at = [&](float* arr, int64_t l) -> float& {
      return arr[(bi * (L - 1) + l) * C + ci];
    };
    // slopes + m (m_0 = slope_0)
    for (int64_t l = 0; l + 1 < L; ++l) {
      float h = times[l + 1] - times[l];
      float slope = (col[l + 1] - col[l]) / h;
      float m0 =
          (l == 0) ? slope : (col[l] - col[l - 1]) / (times[l] - times[l - 1]);
      float m1 = slope;
      out_at(a, l) = col[l];
      out_at(b, l) = m0;
      out_at(two_c, l) = 2.f * (3.f * slope - 2.f * m0 - m1) / h;
      out_at(three_d, l) = 3.f * (m0 + m1 - 2.f * slope) / (h * h);
    }
  });
}

// Per-channel elapsed time since last observation.
// mask [B, L, C] (1 observed), times [L] -> delta [B, L, C].
void snsde_compute_delta(const float* mask, const float* times, int64_t B,
                         int64_t L, int64_t C, float* delta) {
  parallel_for(B * C, [&](int64_t bc) {
    int64_t bi = bc / C, ci = bc % C;
    float acc = 0.f;
    delta[(bi * L) * C + ci] = 0.f;
    for (int64_t l = 1; l < L; ++l) {
      float dt = times[l] - times[l - 1];
      float prev_obs = mask[(bi * L + l - 1) * C + ci];
      acc = dt + (prev_obs > 0.5f ? 0.f : acc);
      delta[(bi * L + l) * C + ci] = acc;
    }
  });
}

// Seeded per-channel missingness injection (xorshift; never masks index 0).
// In-place on x [B, L, C]: sets dropped entries to NaN.
void snsde_inject_missingness(float* x, int64_t B, int64_t L, int64_t C,
                              float rate, uint64_t seed) {
  int64_t n_drop = (int64_t)(rate * L);
  if (n_drop <= 0) return;
  parallel_for(B * C, [&](int64_t bc) {
    int64_t bi = bc / C, ci = bc % C;
    uint64_t s = seed ^ (0x9E3779B97F4A7C15ULL * (bc + 1));
    auto rnd = [&]() {
      s ^= s << 13;
      s ^= s >> 7;
      s ^= s << 17;
      return s;
    };
    // partial Fisher-Yates over positions 1..L-1
    std::vector<int> idx(L - 1);
    for (int64_t i = 0; i + 1 < L; ++i) idx[i] = (int)i + 1;
    for (int64_t i = 0; i < n_drop && i + 1 < L; ++i) {
      int64_t j = i + (int64_t)(rnd() % (L - 1 - i));
      std::swap(idx[i], idx[j]);
      x[(bi * L + idx[i]) * C + ci] = NAN;
    }
  });
}

// Parse a PSV (pipe-separated) buffer with a header row into a row-major
// float matrix; empty/NaN fields -> NaN. Returns rows parsed; *n_cols set
// from the header. out must have capacity max_rows*max_cols.
int64_t snsde_parse_psv(const char* text, int64_t len, float* out,
                        int64_t max_rows, int64_t max_cols,
                        int64_t* n_cols) {
  int64_t pos = 0;
  // header: count columns
  int64_t cols = 1;
  int64_t line_end = 0;
  while (line_end < len && text[line_end] != '\n') {
    if (text[line_end] == '|') ++cols;
    ++line_end;
  }
  if (cols > max_cols) cols = max_cols;
  *n_cols = cols;
  pos = line_end + 1;

  int64_t row = 0;
  while (pos < len && row < max_rows) {
    int64_t col = 0;
    while (col < cols) {
      // parse one field
      int64_t start = pos;
      while (pos < len && text[pos] != '|' && text[pos] != '\n') ++pos;
      if (pos == start ||
          (pos - start == 3 && strncmp(text + start, "NaN", 3) == 0)) {
        out[row * cols + col] = NAN;
      } else {
        char buf[64];
        int64_t m = std::min<int64_t>(pos - start, 63);
        memcpy(buf, text + start, m);
        buf[m] = 0;
        out[row * cols + col] = strtof(buf, nullptr);
      }
      ++col;
      if (pos < len && text[pos] == '|') ++pos;
      else break;
    }
    while (col < cols) out[row * cols + col++] = NAN;
    while (pos < len && text[pos] != '\n') ++pos;
    ++pos;
    ++row;
  }
  return row;
}

}  // extern "C"
