// Gaussian-process regression + Expected Improvement for the autotuner.
//
// Parity surface: horovod/common/optim/gaussian_process.cc
// (GaussianProcessRegressor: RBF kernel, Cholesky solve, posterior
// mean/std) and the EI acquisition of bayesian_optimization.cc
// (BayesianOptimization::NextSample) — the reference keeps this math
// in native code (Eigen); here it is a dependency-free C++17
// implementation with the same structure: y standardisation, RBF Gram
// matrix with jitter, Cholesky factorisation, two triangular solves
// for alpha, posterior variance via the factor solve, and the
// closed-form EI with the z = imp/sigma split.
//
// The Python twin (obs/gaussian_process.py) remains the executable
// spec; tests/test_native.py cross-checks the two to ~1e-10.

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

// Dense column-ordered lower-triangular Cholesky: A = L L^T, in place
// on a row-major n*n buffer.  Returns false if A is not positive
// definite.
bool cholesky(std::vector<double>& a, int64_t n) {
  for (int64_t j = 0; j < n; ++j) {
    double d = a[j * n + j];
    for (int64_t k = 0; k < j; ++k) d -= a[j * n + k] * a[j * n + k];
    if (d <= 0.0) return false;
    const double l = std::sqrt(d);
    a[j * n + j] = l;
    for (int64_t i = j + 1; i < n; ++i) {
      double s = a[i * n + j];
      for (int64_t k = 0; k < j; ++k) s -= a[i * n + k] * a[j * n + k];
      a[i * n + j] = s / l;
    }
    for (int64_t k = j + 1; k < n; ++k) a[j * n + k] = 0.0;
  }
  return true;
}

// Solve L x = b (forward) in place.
void solve_lower(const std::vector<double>& l, int64_t n,
                 std::vector<double>& b) {
  for (int64_t i = 0; i < n; ++i) {
    double s = b[i];
    for (int64_t k = 0; k < i; ++k) s -= l[i * n + k] * b[k];
    b[i] = s / l[i * n + i];
  }
}

// Solve L^T x = b (backward) in place.
void solve_upper_t(const std::vector<double>& l, int64_t n,
                   std::vector<double>& b) {
  for (int64_t i = n - 1; i >= 0; --i) {
    double s = b[i];
    for (int64_t k = i + 1; k < n; ++k) s -= l[k * n + i] * b[k];
    b[i] = s / l[i * n + i];
  }
}

double rbf(const double* a, const double* b, int64_t d,
           double length_scale, double signal_variance) {
  double d2 = 0.0;
  for (int64_t k = 0; k < d; ++k) {
    const double diff = a[k] - b[k];
    d2 += diff * diff;
  }
  return signal_variance *
         std::exp(-0.5 * d2 / (length_scale * length_scale));
}

double norm_pdf(double z) {
  return std::exp(-0.5 * z * z) / std::sqrt(2.0 * M_PI);
}

double norm_cdf(double z) { return 0.5 * (1.0 + std::erf(z / std::sqrt(2.0))); }

}  // namespace

#pragma GCC visibility push(default)
extern "C" {

// Fit a GP on (xs: n x d, ys: n) and write the posterior (mean, std)
// at (cand: m x d) into out_mu / out_sigma (each m).  Mirrors
// GaussianProcess.fit + .predict in obs/gaussian_process.py: y is
// standardised, the kernel gets `noise` jitter on the diagonal, and
// the posterior is de-standardised.  Returns 0 on success, -1 if the
// Gram matrix is not positive definite.
int hvt_gp_predict(const double* xs, const double* ys, int64_t n, int64_t d,
                   const double* cand, int64_t m, double length_scale,
                   double noise, double signal_variance, double* out_mu,
                   double* out_sigma) {
  // standardise y
  double mean = 0.0;
  for (int64_t i = 0; i < n; ++i) mean += ys[i];
  mean /= static_cast<double>(n);
  double var = 0.0;
  for (int64_t i = 0; i < n; ++i) {
    const double c = ys[i] - mean;
    var += c * c;
  }
  double std_ = std::sqrt(var / static_cast<double>(n));
  if (std_ == 0.0) std_ = 1.0;

  // K + noise I, factor
  std::vector<double> k(static_cast<size_t>(n) * n);
  for (int64_t i = 0; i < n; ++i)
    for (int64_t j = 0; j < n; ++j)
      k[i * n + j] = rbf(xs + i * d, xs + j * d, d, length_scale,
                         signal_variance) +
                     (i == j ? noise : 0.0);
  if (!cholesky(k, n)) return -1;

  // alpha = K^-1 yn via two triangular solves
  std::vector<double> alpha(n);
  for (int64_t i = 0; i < n; ++i) alpha[i] = (ys[i] - mean) / std_;
  solve_lower(k, n, alpha);
  solve_upper_t(k, n, alpha);

  std::vector<double> ks(n);
  for (int64_t c = 0; c < m; ++c) {
    for (int64_t i = 0; i < n; ++i)
      ks[i] = rbf(cand + c * d, xs + i * d, d, length_scale,
                  signal_variance);
    double mu = 0.0;
    for (int64_t i = 0; i < n; ++i) mu += ks[i] * alpha[i];
    // v = L^-1 ks ; var = prior_diag - v.v
    solve_lower(k, n, ks);
    double vv = 0.0;
    for (int64_t i = 0; i < n; ++i) vv += ks[i] * ks[i];
    double v = signal_variance - vv;
    if (v < 1e-12) v = 1e-12;
    out_mu[c] = mu * std_ + mean;
    out_sigma[c] = std::sqrt(v) * std_;
  }
  return 0;
}

// Expected Improvement over candidates given observations; the
// fit+predict+EI pipeline of BayesianOptimizer.suggest in one call.
// Returns 0 on success, -1 on a non-PD Gram matrix.
int hvt_gp_expected_improvement(const double* xs, const double* ys,
                                int64_t n, int64_t d, const double* cand,
                                int64_t m, double length_scale, double noise,
                                double signal_variance, double best_y,
                                double xi, double* out_ei) {
  std::vector<double> mu(m), sigma(m);
  const int rc = hvt_gp_predict(xs, ys, n, d, cand, m, length_scale, noise,
                                signal_variance, mu.data(), sigma.data());
  if (rc != 0) return rc;
  for (int64_t c = 0; c < m; ++c) {
    const double imp = mu[c] - best_y - xi;
    if (sigma[c] < 1e-12) {
      out_ei[c] = 0.0;
      continue;
    }
    const double z = imp / sigma[c];
    out_ei[c] = imp * norm_cdf(z) + sigma[c] * norm_pdf(z);
  }
  return 0;
}

}  // extern "C"
#pragma GCC visibility pop
