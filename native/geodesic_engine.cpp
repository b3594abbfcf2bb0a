// Native CPU geodesic engine for light_path_tracer_tpu.
//
// Role: the host-side counterpart of the JAX compute path — a fast,
// multithreaded float64 oracle for large-sample cross-checks and the CPU
// fallback/benchmark engine. (The reference ships no native code at all:
// its fast tier is Numba-JIT Python, SURVEY.md §2. This is new.)
//
// Physics contract matches the JAX library (and therefore the reference's
// behavior, metrics.py:44-658): reduced 5-D Kerr state
// [r, theta, phi, p_r, p_theta] with conserved (p_t = -E, p_phi = L),
// Bardeen screen->conserved initial conditions, adaptive Dormand-Prince
// 4(5) with FSAL, capture at 1.01 r_+ / escape at 2 r_obs with cubic
// Hermite boundary interpolation, and the Schwarzschild u(phi) orbit
// shortcut. Exposed as a C ABI for ctypes (see
// light_path_tracer_tpu/native.py).
//
// Build: make -C native   (produces libgeodesic.so)

#include <cmath>
#include <cstdint>
#include <algorithm>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kSin2Floor = 1e-15;

struct Vec5 {
  double v[5];
  double &operator[](int i) { return v[i]; }
  double operator[](int i) const { return v[i]; }
};

struct KerrParams {
  double M, a, r_plus, p_t, p_phi;
};

// Contravariant metric pieces shared by the RHS and initial conditions.
struct MetricTerms {
  double g_tt, g_tphi, g_rr, g_thth, g_phiphi;
  double Sigma, Delta, A, sin_th, cos_th, sin2;
};

inline MetricTerms metric_terms(double M, double a, double r, double th) {
  MetricTerms t;
  t.sin_th = std::sin(th);
  t.cos_th = std::cos(th);
  t.sin2 = std::max(t.sin_th * t.sin_th, kSin2Floor);
  const double r2 = r * r, a2 = a * a;
  t.Sigma = r2 + a2 * t.cos_th * t.cos_th;
  t.Delta = r2 - 2.0 * M * r + a2;
  const double ra2 = r2 + a2;
  t.A = ra2 * ra2 - a2 * t.Delta * t.sin2;
  const double SD = t.Sigma * t.Delta;
  t.g_tt = -t.A / SD;
  t.g_tphi = -2.0 * M * a * r / SD;
  t.g_rr = t.Delta / t.Sigma;
  t.g_thth = 1.0 / t.Sigma;
  t.g_phiphi = (t.Delta - a2 * t.sin2) / (SD * t.sin2);
  return t;
}

// Hamilton's equations on the reduced state; hard-zero inside the horizon.
inline Vec5 kerr_rhs(const KerrParams &kp, const Vec5 &y) {
  Vec5 d{};
  const double r = y[0], th = y[1], p_r = y[3], p_th = y[4];
  if (r <= kp.r_plus * 1.001) return d;

  const MetricTerms t = metric_terms(kp.M, kp.a, r, th);
  const double a = kp.a, M = kp.M, a2 = a * a;

  d[0] = t.g_rr * p_r;
  d[1] = t.g_thth * p_th;
  d[2] = t.g_tphi * kp.p_t + t.g_phiphi * kp.p_phi;

  const double dSigma_dr = 2.0 * r;
  const double dDelta_dr = 2.0 * r - 2.0 * M;
  const double dA_dr = 4.0 * r * (r * r + a2) - a2 * dDelta_dr * t.sin2;
  const double SD = t.Sigma * t.Delta, SD2 = SD * SD;
  const double dSD_dr = dSigma_dr * t.Delta + t.Sigma * dDelta_dr;

  const double dg_tt_dr = -(dA_dr * SD - t.A * dSD_dr) / SD2;
  const double dg_tphi_dr = -(2.0 * M * a * (SD - r * dSD_dr)) / SD2;
  const double S2 = t.Sigma * t.Sigma;
  const double dg_rr_dr = (dDelta_dr * t.Sigma - t.Delta * dSigma_dr) / S2;
  const double dg_thth_dr = -dSigma_dr / S2;
  const double den_phi = SD * t.sin2;
  const double dg_phiphi_dr =
      (dDelta_dr * den_phi - (t.Delta - a2 * t.sin2) * dSD_dr * t.sin2) /
      (den_phi * den_phi);

  d[3] = -0.5 * (dg_tt_dr * kp.p_t * kp.p_t +
                 2.0 * dg_tphi_dr * kp.p_t * kp.p_phi +
                 dg_rr_dr * p_r * p_r + dg_thth_dr * p_th * p_th +
                 dg_phiphi_dr * kp.p_phi * kp.p_phi);

  const double sc = t.sin_th * t.cos_th;
  const double dSigma_dth = -2.0 * a2 * sc;
  const double dA_dth = -2.0 * a2 * t.Delta * sc;
  const double dg_tt_dth =
      -(dA_dth * SD - t.A * dSigma_dth * t.Delta) / SD2;
  const double dg_tphi_dth = 2.0 * M * a * r * dSigma_dth / (S2 * t.Delta);
  const double dg_rr_dth = -t.Delta * dSigma_dth / S2;
  const double dg_thth_dth = -dSigma_dth / S2;
  const double num = t.Delta - a2 * t.sin2;
  const double dnum_dth = -2.0 * a2 * sc;
  const double dden_dth = dSigma_dth * t.Delta * t.sin2 + 2.0 * SD * sc;
  const double dg_phiphi_dth =
      (dnum_dth * den_phi - num * dden_dth) / (den_phi * den_phi);

  d[4] = -0.5 * (dg_tt_dth * kp.p_t * kp.p_t +
                 2.0 * dg_tphi_dth * kp.p_t * kp.p_phi +
                 dg_rr_dth * p_r * p_r + dg_thth_dth * p_th * p_th +
                 dg_phiphi_dth * kp.p_phi * kp.p_phi);
  return d;
}

// Bardeen screen angles -> initial reduced state + conserved momenta.
inline bool kerr_init(double M, double a, double r_obs, double alpha,
                      double screen_th, double theta_obs, Vec5 &y,
                      KerrParams &kp) {
  const double th = theta_obs;
  const double sin_th = std::sin(th), cos_th = std::cos(th);
  const double sin2 = std::max(sin_th * sin_th, kSin2Floor);
  const double Sigma = r_obs * r_obs + a * a * cos_th * cos_th;
  const double Delta = r_obs * r_obs - 2.0 * M * r_obs + a * a;
  if (Delta <= 0.0 || Sigma <= 0.0) return false;

  const double E = 1.0;
  const double rho =
      r_obs * std::sin(alpha) * std::sqrt(Sigma) / std::sqrt(Delta);
  const double alpha_s = -rho * std::sin(screen_th);
  const double beta_s = -rho * std::cos(screen_th);
  const double xi = -alpha_s * sin_th;
  const double eta =
      beta_s * beta_s + cos_th * cos_th * (alpha_s * alpha_s - a * a);

  kp.M = M;
  kp.a = a;
  kp.r_plus = M + std::sqrt(M * M - a * a);
  kp.p_t = -E;            // covariant convention, future-directed null
  kp.p_phi = xi * E;

  double Theta = eta * E * E -
                 cos_th * cos_th * (kp.p_phi * kp.p_phi / sin2 -
                                    a * a * E * E);
  Theta = std::max(Theta, 0.0);
  const double p_th_sign = (std::cos(screen_th) > 0.0) ? -1.0 : 1.0;
  const double p_th = p_th_sign * std::sqrt(Theta);

  const MetricTerms t = metric_terms(M, a, r_obs, th);
  const double other = t.g_tt * kp.p_t * kp.p_t +
                       2.0 * t.g_tphi * kp.p_t * kp.p_phi +
                       t.g_thth * p_th * p_th +
                       t.g_phiphi * kp.p_phi * kp.p_phi;
  const double p_r_sq = std::max(-other / t.g_rr, 0.0);

  y[0] = r_obs;
  y[1] = th;
  y[2] = 0.0;
  y[3] = -std::sqrt(p_r_sq);
  y[4] = p_th;
  return true;
}

inline bool all_finite(const Vec5 &y) {
  for (int i = 0; i < 5; ++i)
    if (!std::isfinite(y[i])) return false;
  return true;
}

// Dormand-Prince tableau.
constexpr double A21 = 1.0 / 5.0;
constexpr double A31 = 3.0 / 40.0, A32 = 9.0 / 40.0;
constexpr double A41 = 44.0 / 45.0, A42 = -56.0 / 15.0, A43 = 32.0 / 9.0;
constexpr double A51 = 19372.0 / 6561.0, A52 = -25360.0 / 2187.0,
                 A53 = 64448.0 / 6561.0, A54 = -212.0 / 729.0;
constexpr double A61 = 9017.0 / 3168.0, A62 = -355.0 / 33.0,
                 A63 = 46732.0 / 5247.0, A64 = 49.0 / 176.0,
                 A65 = -5103.0 / 18656.0;
constexpr double B1 = 35.0 / 384.0, B3 = 500.0 / 1113.0, B4 = 125.0 / 192.0,
                 B5 = -2187.0 / 6784.0, B6 = 11.0 / 84.0;
constexpr double E1 = 71.0 / 57600.0, E3 = -71.0 / 16695.0,
                 E4 = 71.0 / 1920.0, E5 = -17253.0 / 339200.0,
                 E6 = 22.0 / 525.0, E7 = -1.0 / 40.0;

inline Vec5 hermite(const Vec5 &y0, const Vec5 &y1, const Vec5 &f0,
                    const Vec5 &f1, double h, double s) {
  const double s2 = s * s, s3 = s2 * s;
  const double h00 = 2 * s3 - 3 * s2 + 1, h10 = s3 - 2 * s2 + s;
  const double h01 = -2 * s3 + 3 * s2, h11 = s3 - s2;
  Vec5 out;
  for (int i = 0; i < 5; ++i)
    out[i] = h00 * y0[i] + h10 * h * f0[i] + h01 * y1[i] + h11 * h * f1[i];
  return out;
}

inline double hermite_frac(double r0, double r1, double f0, double f1,
                           double h, double target, double s) {
  for (int it = 0; it < 4; ++it) {
    const double s2 = s * s, s3 = s2 * s;
    const double p = (2 * s3 - 3 * s2 + 1) * r0 + (s3 - 2 * s2 + s) * h * f0 +
                     (-2 * s3 + 3 * s2) * r1 + (s3 - s2) * h * f1;
    const double dp = (6 * s2 - 6 * s) * r0 + (3 * s2 - 4 * s + 1) * h * f0 +
                      (-6 * s2 + 6 * s) * r1 + (3 * s2 - 2 * s) * h * f1;
    if (std::fabs(dp) < 1e-30) break;
    s = std::clamp(s - (p - target) / dp, 0.0, 1.0);
  }
  return s;
}

struct TraceOut {
  int status;       // 1 escaped, -1 captured, 0 invalid
  double final_alpha;
  int n_half;
};

TraceOut kerr_trace_one(double M, double a, double r_obs, double alpha,
                        double screen_th, double theta_obs,
                        double lambda_max, bool refine, bool hermite_events,
                        int max_steps) {
  TraceOut out{0, NAN, 0};
  Vec5 y;
  KerrParams kp;
  if (!kerr_init(M, a, r_obs, alpha, screen_th, theta_obs, y, kp)) return out;

  const double r_capture = kp.r_plus * 1.01;
  const double r_escape = 2.0 * r_obs;
  const double atol = refine ? 1e-10 : 1e-8;
  const double rtol = refine ? 1e-8 : 1e-6;
  const double h_min = 1e-12;

  Vec5 k1 = kerr_rhs(kp, y), k2, k3, k4, k5, k6, k7, tmp, y5;
  double lam = 0.0;
  double h = std::max(1.0, 0.01 * r_obs);
  int event = 2;  // 2 = max-range

  for (int step = 0; step < max_steps && lam < lambda_max; ++step) {
    h = std::min(h, lambda_max - lam);
    if (h <= 0.0) break;

    auto stage = [&](const double *c, int n, Vec5 &k) {
      const Vec5 *ks[6] = {&k1, &k2, &k3, &k4, &k5, &k6};
      for (int i = 0; i < 5; ++i) {
        double acc = 0.0;
        for (int j = 0; j < n; ++j) acc += c[j] * (*ks[j])[i];
        tmp[i] = y[i] + h * acc;
      }
      k = kerr_rhs(kp, tmp);
    };
    { const double c[] = {A21}; stage(c, 1, k2); }
    { const double c[] = {A31, A32}; stage(c, 2, k3); }
    { const double c[] = {A41, A42, A43}; stage(c, 3, k4); }
    { const double c[] = {A51, A52, A53, A54}; stage(c, 4, k5); }
    { const double c[] = {A61, A62, A63, A64, A65}; stage(c, 5, k6); }
    for (int i = 0; i < 5; ++i)
      y5[i] = y[i] + h * (B1 * k1[i] + B3 * k3[i] + B4 * k4[i] +
                          B5 * k5[i] + B6 * k6[i]);
    k7 = kerr_rhs(kp, y5);

    if (!all_finite(y5) || y5[0] <= 0.0) {
      h *= 0.25;
      if (h < h_min) return out;
      continue;
    }

    double err_sq = 0.0;
    for (int i = 0; i < 5; ++i) {
      const double e = h * (E1 * k1[i] + E3 * k3[i] + E4 * k4[i] +
                            E5 * k5[i] + E6 * k6[i] + E7 * k7[i]);
      const double sc_i =
          atol + rtol * std::max(std::fabs(y[i]), std::fabs(y5[i]));
      err_sq += (e / sc_i) * (e / sc_i);
    }
    const double err = std::sqrt(err_sq / 5.0);

    if (err > 1.0) {
      h *= std::max(0.2, 0.9 * std::pow(err, -0.2));
      if (h < h_min) return out;
      continue;
    }

    const double r_prev = y[0], r_next = y5[0];
    const bool cap = r_prev > r_capture && r_next <= r_capture;
    const bool esc = !cap && r_prev < r_escape && r_next >= r_escape;
    if (cap || esc) {
      const double target = cap ? r_capture : r_escape;
      const double den = r_next - r_prev;
      double s = (den == 0.0)
                     ? 1.0
                     : std::clamp((target - r_prev) / den, 0.0, 1.0);
      if (hermite_events)
        s = hermite_frac(r_prev, r_next, k1[0], k7[0], h, target, s);
      if (hermite_events) {
        y = hermite(y, y5, k1, k7, h, s);
      } else {
        for (int i = 0; i < 5; ++i) y[i] = y[i] + s * (y5[i] - y[i]);
      }
      lam += s * h;
      event = cap ? -1 : 1;
      break;
    }

    y = y5;
    k1 = k7;  // FSAL
    lam += h;
    if (!all_finite(y)) return out;
    h *= (err < 1e-10) ? 5.0 : std::min(5.0, 0.9 * std::pow(err, -0.2));
  }

  // Angle extraction (coordinate-velocity chain rule).
  const double r_f = y[0], th_f = y[1], phi_f = y[2];
  out.n_half = static_cast<int>(std::fabs(phi_f) / M_PI);
  if (event == -1 || r_f <= r_capture * 1.1) {
    out.status = -1;
    return out;
  }
  if (!std::isfinite(r_f) || !std::isfinite(th_f) || !std::isfinite(phi_f)) {
    out.n_half = 0;
    return out;
  }
  const MetricTerms t = metric_terms(M, a, r_f, th_f);
  if (t.Sigma <= 1e-15 || std::fabs(t.Delta) <= 1e-15) return out;
  const double dr = t.Delta / t.Sigma * y[3];
  const double dth = y[4] / t.Sigma;
  const double dphi = t.g_tphi * kp.p_t + t.g_phiphi * kp.p_phi;
  const double sp = std::sin(phi_f), cp = std::cos(phi_f);
  const double vx = t.sin_th * cp * dr + r_f * t.cos_th * cp * dth -
                    r_f * t.sin_th * sp * dphi;
  const double vy = t.sin_th * sp * dr + r_f * t.cos_th * sp * dth +
                    r_f * t.sin_th * cp * dphi;
  const double vz = t.cos_th * dr - r_f * t.sin_th * dth;
  if (!std::isfinite(vx) || !std::isfinite(vy) || !std::isfinite(vz))
    return out;
  const double vm = std::sqrt(vx * vx + vy * vy + vz * vz);
  out.status = 1;
  if (vm < 1e-30) return out;  // escaped but degenerate: alpha stays NaN
  out.final_alpha = std::acos(std::clamp(-vx / vm, -1.0, 1.0));
  return out;
}

TraceOut schw_trace_one(double M, double r_obs, double alpha, double phi_max,
                        double h) {
  TraceOut out{0, NAN, 0};
  const double R_S = 2.0 * M;
  const double f0 = 1.0 - R_S / r_obs;
  if (f0 <= 0.0) return out;
  const double b = r_obs * std::sin(alpha) / std::sqrt(f0);
  if (b == 0.0) return out;
  double u = 1.0 / r_obs;
  const double w_sq = 1.0 / (b * b) - u * u + 2.0 * M * u * u * u;
  if (w_sq < 0.0) return out;
  double w = std::sqrt(w_sq);

  const double u_cap = 1.0 / (R_S * 1.01);
  const double u_esc = 1.0 / (2.0 * r_obs);
  double phi = 0.0;
  int status = 2;

  auto rhs = [M](double u, double w, double &du, double &dw) {
    du = w;
    dw = -u + 3.0 * M * u * u;
  };

  while (phi < phi_max) {
    const double hs = std::min(h, phi_max - phi);
    if (hs <= 0.0) break;
    double k1u, k1w, k2u, k2w, k3u, k3w, k4u, k4w;
    rhs(u, w, k1u, k1w);
    rhs(u + 0.5 * hs * k1u, w + 0.5 * hs * k1w, k2u, k2w);
    rhs(u + 0.5 * hs * k2u, w + 0.5 * hs * k2w, k3u, k3w);
    rhs(u + hs * k3u, w + hs * k3w, k4u, k4w);
    const double un = u + (hs / 6.0) * (k1u + 2 * k2u + 2 * k3u + k4u);
    const double wn = w + (hs / 6.0) * (k1w + 2 * k2w + 2 * k3w + k4w);

    if (u < u_cap && un >= u_cap) {
      const double den = un - u;
      const double s =
          (den == 0.0) ? 1.0 : std::clamp((u_cap - u) / den, 0.0, 1.0);
      phi += s * hs;
      w = w + s * (wn - w);
      u = u_cap;
      status = -1;
      break;
    }
    if (u > u_esc && un <= u_esc) {
      const double den = un - u;
      const double s =
          (den == 0.0) ? 1.0 : std::clamp((u_esc - u) / den, 0.0, 1.0);
      phi += s * hs;
      w = w + s * (wn - w);
      u = u_esc;
      status = 1;
      break;
    }
    u = un;
    w = wn;
    phi += hs;
  }

  const double r_f = 1.0 / u;
  out.n_half = static_cast<int>(std::fabs(phi) / M_PI);
  if (status == -1 || r_f <= R_S * 1.1) {
    out.status = -1;
    return out;
  }
  const double dr_dphi = -w / (u * u);
  const double sp = std::sin(phi), cp = std::cos(phi);
  const double heading =
      std::atan2(dr_dphi * sp + r_f * cp, dr_dphi * cp - r_f * sp);
  out.status = 1;
  out.final_alpha = std::acos(std::clamp(-std::cos(heading), -1.0, 1.0));
  return out;
}

}  // namespace

extern "C" {

// Batch Kerr trace. Outputs: final_alpha (NaN unless escaped), winding,
// status per ray. hermite_events=0 reproduces reference-style linear
// event interpolation.
void kerr_trace_batch(double M, double a, double r_obs, int64_t n,
                      const double *alphas, const double *screen_thetas,
                      double theta_obs, double lambda_max,
                      const uint8_t *refine, int hermite_events,
                      int max_steps, double *out_alpha, int32_t *out_wind,
                      int32_t *out_status) {
#pragma omp parallel for schedule(dynamic, 64)
  for (int64_t i = 0; i < n; ++i) {
    const TraceOut o = kerr_trace_one(
        M, a, r_obs, alphas[i], screen_thetas[i], theta_obs, lambda_max,
        refine && refine[i], hermite_events != 0, max_steps);
    out_alpha[i] = (o.status == 1) ? o.final_alpha : NAN;
    out_wind[i] = o.n_half;
    out_status[i] = o.status;
  }
}

void schwarzschild_trace_batch(double M, double r_obs, int64_t n,
                               const double *alphas, double phi_max,
                               double h, double *out_alpha,
                               int32_t *out_wind, int32_t *out_status) {
#pragma omp parallel for schedule(dynamic, 256)
  for (int64_t i = 0; i < n; ++i) {
    const TraceOut o = schw_trace_one(M, r_obs, alphas[i], phi_max, h);
    out_alpha[i] = (o.status == 1) ? o.final_alpha : NAN;
    out_wind[i] = o.n_half;
    out_status[i] = o.status;
  }
}

int engine_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
