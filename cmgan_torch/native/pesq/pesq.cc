// Wideband PESQ (ITU-T P.862.2 structure) — native scoring library.
//
// The PyTorch port's own copy of cmgan_tpu/native/pesq/pesq.cc, the same
// code (tests/test_torch_pesq.py holds the two builds to 1e-9). Host
// code: it labels the discriminator's batches in GAN training
// (cmgan_torch/train/steps.py:pesq_labels_host), in place of the `pesq`
// C wheel the CMGAN reference depends on. Built with g++ at first use by
// cmgan_torch/metrics/pesq_native.py.
//
// Exported C API:
//   double cmgan_pesq_wb(const double* ref, const double* deg, long n);
//   void   cmgan_pesq_wb_batch(const double* ref, const double* deg,
//                              long batch, long n, double* out);

#include <algorithm>
#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

namespace {

constexpr int kFs = 16000;
constexpr int kFrame = 512;
constexpr int kShift = 256;
constexpr int kNBands = 49;
constexpr double kTargetPower = 1e7;
constexpr double kZwickerExp = 0.23;
constexpr double kLoudnessScale = 0.1866055;
constexpr double kGainCompExp = 0.5;
// Disturbance->MOS mapping fitted per-track against 25 exact ITU wheel
// anchors (see cmgan_tpu/metrics/pesq_ref.py and CALIBRATION.md); must
// stay in lockstep with the numpy spec.
constexpr double kDWeight = 1.41e-05;
constexpr double kDPower = 3.2379832;
constexpr double kDAWeight = 0.4424533;
constexpr double kDAPower = 0.296617;

// 100 Hz high-pass biquad (matches the published P.862.2 WB input SOS).
constexpr double kHpB[3] = {0.9726138984998438, -1.9452277969996876,
                            0.9726138984998438};
constexpr double kHpA[3] = {1.0, -1.9444776577670935, 0.9459779362322813};

// 350-3250 Hz band-pass (level-measurement band).
constexpr double kBpB[5] = {0.17700538222951706, 0.0, -0.3540107644590341,
                            0.0, 0.17700538222951706};
constexpr double kBpA[5] = {1.0, -2.266085202402198, 1.9183268001686336,
                            -0.8538508436231806, 0.21791242519290044};

double bark(double f) { return 7.0 * std::asinh(f / 650.0); }
double bark_inv(double z) { return 650.0 * std::sinh(z / 7.0); }

double hearing_threshold_db(double f_hz) {
  double f = std::max(f_hz, 20.0) / 1000.0;
  return 3.64 * std::pow(f, -0.8) -
         6.5 * std::exp(-0.6 * (f - 3.3) * (f - 3.3)) + 1e-3 * std::pow(f, 4.0);
}

struct Constants {
  std::vector<std::vector<int>> band_bins;  // FFT bins per bark band
  double width_bark[kNBands];
  double abs_thresh[kNBands];
  double zwicker_exp[kNBands];
  double window[kFrame];
  double spec_scale;

  Constants() {
    const int n_bins = kFrame / 2 + 1;
    double z_lo = bark(100.0), z_hi = bark(8000.0);
    std::vector<double> f_edges(kNBands + 1);
    for (int b = 0; b <= kNBands; ++b) {
      double z = z_lo + (z_hi - z_lo) * b / kNBands;
      f_edges[b] = bark_inv(z);
    }
    band_bins.resize(kNBands);
    for (int k = 0; k < n_bins; ++k) {
      double f = static_cast<double>(k) * kFs / kFrame;
      // same semantics as np.digitize(f, f_edges) - 1
      int b = static_cast<int>(std::upper_bound(f_edges.begin(), f_edges.end(), f) -
                               f_edges.begin()) - 1;
      if (b >= 0 && b < kNBands) band_bins[b].push_back(k);
    }
    for (int b = 0; b < kNBands; ++b) {
      width_bark[b] = (z_hi - z_lo) / kNBands;
      double center = 0.5 * (f_edges[b] + f_edges[b + 1]);
      abs_thresh[b] = std::pow(10.0, hearing_threshold_db(center) / 10.0);
      double zc = bark(center);
      zwicker_exp[b] = zc < 4.0 ? kZwickerExp * (1.0 + 0.5 * (4.0 - zc) / 4.0)
                                : kZwickerExp;
    }
    for (int i = 0; i < kFrame; ++i)
      window[i] = 0.5 * (1.0 - std::cos(2.0 * M_PI * i / kFrame));
    double denom = kFrame * 0.375;
    spec_scale = kFrame / (denom * denom);
  }
};

const Constants& constants() {
  static Constants c;
  return c;
}

// In-place iterative radix-2 complex FFT.
void fft(std::vector<std::complex<double>>& a, bool inverse) {
  const size_t n = a.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) std::swap(a[i], a[j]);
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * M_PI / len * (inverse ? 1.0 : -1.0);
    std::complex<double> wl(std::cos(ang), std::sin(ang));
    for (size_t i = 0; i < n; i += len) {
      std::complex<double> w(1.0);
      for (size_t k = 0; k < len / 2; ++k) {
        std::complex<double> u = a[i + k];
        std::complex<double> v = a[i + k + len / 2] * w;
        a[i + k] = u + v;
        a[i + k + len / 2] = u - v;
        w *= wl;
      }
    }
  }
  if (inverse)
    for (auto& x : a) x /= static_cast<double>(n);
}

// Direct-form II transposed IIR (scipy.signal.lfilter semantics).
template <int Order>
void iir_filter(const double* b, const double* a, const double* x, double* y,
                long n) {
  double z[Order] = {0};
  for (long i = 0; i < n; ++i) {
    double xi = x[i];
    double yi = b[0] * xi + z[0];
    for (int k = 0; k < Order - 1; ++k)
      z[k] = b[k + 1] * xi + z[k + 1] - a[k + 1] * yi;
    z[Order - 1] = b[Order] * xi - a[Order] * yi;
    y[i] = yi;
  }
}

void level_align(std::vector<double>& x) {
  std::vector<double> banded(x.size());
  iir_filter<4>(kBpB, kBpA, x.data(), banded.data(), x.size());
  double power = 0.0;
  for (double v : banded) power += v * v;
  power /= static_cast<double>(x.size());
  double scale = std::sqrt(kTargetPower / std::max(power, 1e-20));
  for (double& v : x) v *= scale;
}

long next_pow2(long n) {
  long p = 1;
  while (p < n) p <<= 1;
  return p;
}

// Global delay estimate via envelope cross-correlation.
long crude_align(const std::vector<double>& ref, const std::vector<double>& deg) {
  const long max_delay = std::min<long>(
      kFs / 2, static_cast<long>(std::min(ref.size(), deg.size())) - kFrame);
  if (max_delay <= 0) return 0;
  long n = next_pow2(static_cast<long>(ref.size() + deg.size()));
  std::vector<std::complex<double>> R(n), D(n);
  for (size_t i = 0; i < ref.size(); ++i) R[i] = std::abs(ref[i]);
  for (size_t i = 0; i < deg.size(); ++i) D[i] = std::abs(deg[i]);
  fft(R, false);
  fft(D, false);
  for (long i = 0; i < n; ++i) D[i] *= std::conj(R[i]);
  fft(D, true);
  long best_lag = 0;
  double best = -1e300;
  for (long lag = -max_delay; lag < max_delay; ++lag) {
    long idx = lag >= 0 ? lag : n + lag;
    double v = D[idx].real();
    if (v > best) {
      best = v;
      best_lag = lag;
    }
  }
  return best_lag;
}

// Per-frame bark-band powers: [n_frames][kNBands].
std::vector<std::vector<double>> band_powers(const std::vector<double>& x) {
  const Constants& c = constants();
  long n_frames = (static_cast<long>(x.size()) - kFrame) / kShift + 1;
  if (n_frames < 0) n_frames = 0;
  std::vector<std::vector<double>> out(n_frames,
                                       std::vector<double>(kNBands, 0.0));
  std::vector<std::complex<double>> buf(kFrame);
  std::vector<double> power(kFrame / 2 + 1);
  for (long t = 0; t < n_frames; ++t) {
    for (int i = 0; i < kFrame; ++i)
      buf[i] = std::complex<double>(x[t * kShift + i] * c.window[i], 0.0);
    fft(buf, false);
    for (int k = 0; k <= kFrame / 2; ++k)
      power[k] = std::norm(buf[k]) * c.spec_scale;
    for (int b = 0; b < kNBands; ++b) {
      const auto& bins = c.band_bins[b];
      if (bins.empty()) continue;
      double s = 0.0;
      for (int k : bins) s += power[k];
      out[t][b] = s / bins.size();
    }
  }
  return out;
}

double aggregate(const std::vector<double>& x) {
  const int win = 20, stride = 10;
  std::vector<double> bursts;
  long n = static_cast<long>(x.size());
  if (n < win) {
    double s = 0.0;
    for (double v : x) s += std::pow(v, 6.0);
    bursts.push_back(std::pow(s / std::max<long>(n, 1), 1.0 / 6.0));
  } else {
    long n_bursts = (n - win) / stride + 1;
    for (long i = 0; i < n_bursts; ++i) {
      double s = 0.0;
      for (int k = 0; k < win; ++k) s += std::pow(x[i * stride + k], 6.0);
      bursts.push_back(std::pow(s / win, 1.0 / 6.0));
    }
  }
  double s = 0.0;
  for (double v : bursts) s += v * v;
  return std::sqrt(s / bursts.size());
}

double pesq_wb_impl(const double* ref_in, const double* deg_in, long n) {
  const Constants& c = constants();
  std::vector<double> ref(ref_in, ref_in + n), deg(deg_in, deg_in + n);

  level_align(ref);
  level_align(deg);
  {
    std::vector<double> tmp(n);
    iir_filter<2>(kHpB, kHpA, ref.data(), tmp.data(), n);
    ref.swap(tmp);
    iir_filter<2>(kHpB, kHpA, deg.data(), tmp.data(), n);
    deg.swap(tmp);
  }

  long delay = crude_align(ref, deg);
  if (delay > 0) {
    deg.erase(deg.begin(), deg.begin() + delay);
    ref.resize(deg.size());
  } else if (delay < 0) {
    ref.erase(ref.begin(), ref.begin() - delay);
    deg.resize(ref.size());
  }

  auto p_ref = band_powers(ref);
  auto p_deg = band_powers(deg);
  long n_frames = static_cast<long>(p_ref.size());
  if (n_frames == 0) return 1.0;

  std::vector<double> audible_ref(n_frames, 0.0);
  for (long t = 0; t < n_frames; ++t)
    for (int b = 0; b < kNBands; ++b)
      if (p_ref[t][b] > c.abs_thresh[b])
        audible_ref[t] += p_ref[t][b] * c.width_bark[b];

  // frequency compensation over active frames
  double mean_ref[kNBands] = {0}, mean_deg[kNBands] = {0};
  long n_active = 0;
  for (long t = 0; t < n_frames; ++t) {
    if (audible_ref[t] >= 1e5) {
      ++n_active;
      for (int b = 0; b < kNBands; ++b) {
        mean_ref[b] += p_ref[t][b];
        mean_deg[b] += p_deg[t][b];
      }
    }
  }
  if (n_active == 0) {
    n_active = n_frames;
    for (long t = 0; t < n_frames; ++t)
      for (int b = 0; b < kNBands; ++b) {
        mean_ref[b] += p_ref[t][b];
        mean_deg[b] += p_deg[t][b];
      }
  }
  double band_gain[kNBands];
  for (int b = 0; b < kNBands; ++b) {
    double g = std::pow((mean_deg[b] / n_active + 1000.0) /
                            (mean_ref[b] / n_active + 1000.0),
                        0.2);
    band_gain[b] = std::min(std::max(g, 0.01), 100.0);
  }

  // short-term gain compensation with first-order smoothing
  std::vector<double> h(n_frames);
  double state = 1.0;
  for (long t = 0; t < n_frames; ++t) {
    double e_ref = 0.0, e_deg = 0.0;
    for (int b = 0; b < kNBands; ++b) {
      e_ref += p_ref[t][b] * band_gain[b] * c.width_bark[b];
      e_deg += p_deg[t][b] * c.width_bark[b];
    }
    double gain = std::pow((e_ref + 5e3) / (e_deg + 5e3), kGainCompExp);
    state = 0.8 * state + 0.2 * gain;
    h[t] = std::min(std::max(state, 3e-4), 5.0);
  }

  std::vector<double> d_frame(n_frames), da_frame(n_frames);
  for (long t = 0; t < n_frames; ++t) {
    double d2 = 0.0, da = 0.0;
    for (int b = 0; b < kNBands; ++b) {
      double pr = p_ref[t][b] * band_gain[b];
      double pd = p_deg[t][b] * h[t];
      double ex = c.zwicker_exp[b];
      double scale = kLoudnessScale * std::pow(c.abs_thresh[b] / 0.5, ex);
      double lr = std::max(
          scale * (std::pow(0.5 + 0.5 * pr / c.abs_thresh[b], ex) - 1.0), 0.0);
      double ld = std::max(
          scale * (std::pow(0.5 + 0.5 * pd / c.abs_thresh[b], ex) - 1.0), 0.0);
      double d = ld - lr;
      double mask = 0.25 * std::min(ld, lr);
      double dm = std::abs(d) > mask ? (d > 0 ? d - mask : d + mask) : 0.0;
      double w = c.width_bark[b];
      d2 += (dm * w) * (dm * w);
      double asym = std::pow((pd + 50.0) / (pr + 50.0), 1.2);
      asym = asym < 3.0 ? 0.0 : std::min(asym, 12.0);
      da += std::abs(dm) * asym * w;
    }
    double weight = std::pow((audible_ref[t] + 1e5) / 1e7, 0.04);
    d_frame[t] = std::min(std::sqrt(d2 * kNBands) / weight, 45.0);
    da_frame[t] = std::min(da / weight, 45.0);
  }

  double d_total = aggregate(d_frame);
  double da_total = aggregate(da_frame);
  double raw = 4.5 - kDWeight * std::pow(d_total, kDPower) -
               kDAWeight * std::pow(da_total, kDAPower);
  return 0.999 + 4.0 / (1.0 + std::exp(-1.3669 * raw + 3.8224));
}

}  // namespace

extern "C" {

double cmgan_pesq_wb(const double* ref, const double* deg, long n) {
  if (n <= 0) return 1.0;
  return pesq_wb_impl(ref, deg, n);
}

void cmgan_pesq_wb_batch(const double* ref, const double* deg, long batch,
                         long n, double* out) {
  for (long i = 0; i < batch; ++i)
    out[i] = cmgan_pesq_wb(ref + i * n, deg + i * n, n);
}

}  // extern "C"
