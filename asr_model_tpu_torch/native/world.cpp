// WORLD-style speech analysis: DIO + StoneMask (F0), CheapTrick
// (spectral envelope) and D4C (band aperiodicity), implemented from
// the published algorithms (Morise: "DIO: a fast and accurate
// fundamental frequency estimator"; "CheapTrick, a spectral envelope
// estimator for high-quality speech synthesis", Speech Communication
// 2015; "D4C, a band-aperiodicity estimator for high-quality speech
// synthesis", Speech Communication 2016).
//
// Parity role: the reference's live pitch feature is pyworld's
// dio + stonemask at 10 ms frames (essentials.py:451-455), and its
// latent harmonic/aperiodic features are pyworld's cheaptrick + d4c
// at fft_size=256 (essentials.py:360-373).  This is a from-scratch
// C++ implementation of the same algorithms behind the same API (the
// PyTorch port's copy of asr_model_tpu/native/world.cpp); it is
// validated with
// algorithm-level tests (known-F0 tones, chirps, harmonic-rich signals
// with weak fundamentals, voicing on silence/noise, envelope/
// aperiodicity separation of harmonic vs noise signals) rather than
// bit-parity goldens, since no pyworld output was at hand.
//
// Algorithm (DIO):
//  1. Low-cut the signal (smooth high-pass below 50 Hz) via one FFT.
//  2. For each band with boundary frequency f_b = floor * 2^((i+1)/c):
//     low-pass with a Nuttall-window kernel (cutoff ~ f_b), then
//     extract four interval-based period tracks (negative/positive
//     zero crossings of the signal and of its first difference).
//  3. Per frame: linearly interpolate the four tracks; the band's
//     candidate is their mean, its score the relative std.  Candidates
//     outside [f_b/2, f_b] or [floor, ceil] are rejected.
//  4. Per frame pick the minimum-score candidate, then fix the contour:
//     kill jumps > allowed_range, drop too-short voiced runs, and
//     extend voiced section edges with best-matching candidates from
//     the full band x frame candidate matrix.
//
// Algorithm (StoneMask): refine each voiced frame by the amplitude-
// weighted average of instantaneous frequencies at the first <=6
// harmonics, measured from a Blackman-windowed DFT around the frame
// (two refinement passes).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

// ---------------------------------------------------------------- FFT
// Iterative radix-2 complex FFT (in-place), n a power of two.
void fft(std::vector<double>& re, std::vector<double>& im, bool inverse) {
  const size_t n = re.size();
  for (size_t i = 1, j = 0; i < n; ++i) {
    size_t bit = n >> 1;
    for (; j & bit; bit >>= 1) j ^= bit;
    j ^= bit;
    if (i < j) { std::swap(re[i], re[j]); std::swap(im[i], im[j]); }
  }
  for (size_t len = 2; len <= n; len <<= 1) {
    double ang = 2.0 * kPi / (double)len * (inverse ? 1.0 : -1.0);
    double wr = std::cos(ang), wi = std::sin(ang);
    for (size_t i = 0; i < n; i += len) {
      double cr = 1.0, ci = 0.0;
      for (size_t k = 0; k < len / 2; ++k) {
        double ur = re[i + k], ui = im[i + k];
        double vr = re[i + k + len / 2] * cr - im[i + k + len / 2] * ci;
        double vi = re[i + k + len / 2] * ci + im[i + k + len / 2] * cr;
        re[i + k] = ur + vr;       im[i + k] = ui + vi;
        re[i + k + len / 2] = ur - vr; im[i + k + len / 2] = ui - vi;
        double ncr = cr * wr - ci * wi;
        ci = cr * wi + ci * wr;  cr = ncr;
      }
    }
  }
  if (inverse) {
    for (size_t i = 0; i < n; ++i) { re[i] /= (double)n; im[i] /= (double)n; }
  }
}

size_t next_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

double nuttall(double x) {  // x in [0, 1]
  return 0.355768 - 0.487396 * std::cos(2.0 * kPi * x)
       + 0.144232 * std::cos(4.0 * kPi * x)
       - 0.012604 * std::cos(6.0 * kPi * x);
}

// Linear interpolation of (xs, ys) at query q; clamps to the edges.
double interp1(const std::vector<double>& xs, const std::vector<double>& ys,
               double q) {
  if (xs.empty()) return 0.0;
  if (q <= xs.front()) return ys.front();
  if (q >= xs.back()) return ys.back();
  size_t lo = 0, hi = xs.size() - 1;
  while (hi - lo > 1) {
    size_t mid = (lo + hi) / 2;
    if (xs[mid] <= q) lo = mid; else hi = mid;
  }
  double w = (q - xs[lo]) / (xs[hi] - xs[lo]);
  return ys[lo] + w * (ys[hi] - ys[lo]);
}

// Interval-based period track from one kind of crossing event.
// events: sub-sample event locations (in samples).  Produces per-
// interval F0 values located at interval midpoints (in seconds).
struct IntervalTrack {
  std::vector<double> loc;  // seconds
  std::vector<double> f0;   // Hz
};

IntervalTrack intervals_from_events(const std::vector<double>& ev, int fs) {
  IntervalTrack tr;
  if (ev.size() < 2) return tr;
  tr.loc.reserve(ev.size() - 1);
  tr.f0.reserve(ev.size() - 1);
  for (size_t i = 0; i + 1 < ev.size(); ++i) {
    double interval = ev[i + 1] - ev[i];
    if (interval <= 0.0) continue;
    tr.f0.push_back((double)fs / interval);
    tr.loc.push_back(0.5 * (ev[i] + ev[i + 1]) / (double)fs);
  }
  return tr;
}

// Sub-sample locations of negative-going (sign=+1) or positive-going
// (sign=-1) zero crossings of y.
std::vector<double> zero_crossings(const std::vector<double>& y, int sign) {
  std::vector<double> ev;
  for (size_t k = 0; k + 1 < y.size(); ++k) {
    double a = y[k] * (double)sign, b = y[k + 1] * (double)sign;
    if (a > 0.0 && b <= 0.0)
      ev.push_back((double)k + a / (a - b));
  }
  return ev;
}

struct Candidates {
  // band-major: cand[band][frame], score[band][frame]
  std::vector<std::vector<double>> f0;
  std::vector<std::vector<double>> score;
};

constexpr double kBadScore = 100000.0;

// ------------------------------------------------------------- DIO core
void dio_candidates(const double* x, long long n, int fs,
                    const std::vector<double>& tpos,
                    double f0_floor, double f0_ceil,
                    double channels_in_octave, Candidates* out) {
  const int num_bands =
      (int)std::ceil(channels_in_octave * std::log2(f0_ceil / f0_floor));
  const size_t nf = tpos.size();
  out->f0.assign(num_bands, std::vector<double>(nf, 0.0));
  out->score.assign(num_bands, std::vector<double>(nf, kBadScore));

  // One forward FFT of the low-cut signal; per-band LPF in frequency
  // domain + inverse FFT.
  const size_t fft_n = next_pow2((size_t)n + (size_t)(4.0 * fs / f0_floor) + 2);
  std::vector<double> re(fft_n, 0.0), im(fft_n, 0.0);
  double mean = 0.0;
  for (long long i = 0; i < n; ++i) mean += x[i];
  mean = n > 0 ? mean / (double)n : 0.0;
  for (long long i = 0; i < n; ++i) re[(size_t)i] = x[i] - mean;
  fft(re, im, false);

  // smooth low-cut below 50 Hz (raised cosine 25..50 Hz)
  for (size_t k = 0; k < fft_n; ++k) {
    size_t kk = k <= fft_n / 2 ? k : fft_n - k;
    double f = (double)kk * fs / (double)fft_n;
    double g = f >= 50.0 ? 1.0
             : f <= 25.0 ? 0.0
             : 0.5 - 0.5 * std::cos(kPi * (f - 25.0) / 25.0);
    re[k] *= g;  im[k] *= g;
  }

  for (int b = 0; b < num_bands; ++b) {
    const double boundary =
        f0_floor * std::pow(2.0, (double)(b + 1) / channels_in_octave);
    const int half_avg = (int)std::lround((double)fs / boundary / 2.0);
    const int klen = std::max(4 * half_avg, 4);

    // Nuttall-window LPF kernel, unit DC gain, linear-phase shift
    // compensated by rotating the kernel to start at t=0.
    std::vector<double> kre(fft_n, 0.0), kim(fft_n, 0.0);
    double ksum = 0.0;
    for (int i = 0; i < klen; ++i) ksum += nuttall((double)i / (klen - 1));
    for (int i = 0; i < klen; ++i) {
      double w = nuttall((double)i / (klen - 1)) / ksum;
      // center the kernel at 0 (circular) so the filtered signal is
      // time-aligned with the input
      long long pos = (long long)i - klen / 2;
      size_t idx = (size_t)((pos % (long long)fft_n + (long long)fft_n)
                            % (long long)fft_n);
      kre[idx] += w;
    }
    fft(kre, kim, false);

    std::vector<double> yre(fft_n), yim(fft_n);
    for (size_t k = 0; k < fft_n; ++k) {
      yre[k] = re[k] * kre[k] - im[k] * kim[k];
      yim[k] = re[k] * kim[k] + im[k] * kre[k];
    }
    fft(yre, yim, true);

    std::vector<double> y(yre.begin(), yre.begin() + (size_t)n);
    std::vector<double> dy((size_t)std::max<long long>(n - 1, 0));
    for (size_t k = 0; k + 1 < (size_t)n; ++k) dy[k] = y[k + 1] - y[k];

    IntervalTrack tr[4] = {
        intervals_from_events(zero_crossings(y, +1), fs),   // neg-going
        intervals_from_events(zero_crossings(y, -1), fs),   // pos-going
        intervals_from_events(zero_crossings(dy, +1), fs),  // peaks
        intervals_from_events(zero_crossings(dy, -1), fs),  // dips
    };
    bool usable = true;
    for (auto& t : tr) usable = usable && t.f0.size() >= 2;
    if (!usable) continue;

    for (size_t i = 0; i < nf; ++i) {
      double v[4], avg = 0.0;
      for (int j = 0; j < 4; ++j) {
        v[j] = interp1(tr[j].loc, tr[j].f0, tpos[i]);
        avg += v[j];
      }
      avg *= 0.25;
      if (avg < f0_floor || avg > f0_ceil ||
          avg < boundary * 0.5 || avg > boundary)
        continue;
      double dev = 0.0;
      for (int j = 0; j < 4; ++j) dev += (v[j] - avg) * (v[j] - avg);
      out->f0[b][i] = avg;
      out->score[b][i] = std::sqrt(dev / 3.0) / avg;
    }
  }
}

// Best candidate per frame (minimum relative deviation).
void select_best(const Candidates& c, std::vector<double>* f0,
                 std::vector<double>* score) {
  const size_t nb = c.f0.size(), nf = f0->size();
  for (size_t i = 0; i < nf; ++i) {
    double best = kBadScore, bf = 0.0;
    for (size_t b = 0; b < nb; ++b) {
      if (c.score[b][i] < best) { best = c.score[b][i]; bf = c.f0[b][i]; }
    }
    // a stable period has all four interval estimates in agreement;
    // reject frames whose best relative deviation is still large
    (*f0)[i] = best < 0.12 ? bf : 0.0;
    (*score)[i] = best;
  }
}

// Best candidate at frame i within allowed_range of reference.
double select_near(const Candidates& c, size_t i, double ref,
                   double allowed_range) {
  double best_err = allowed_range, best = 0.0;
  for (size_t b = 0; b < c.f0.size(); ++b) {
    double v = c.f0[b][i];
    if (v <= 0.0) continue;
    double err = std::fabs(v - ref) / ref;
    if (err < best_err) { best_err = err; best = v; }
  }
  return best;
}

void fix_contour(const Candidates& cands, double frame_period,
                 double f0_floor, double allowed_range,
                 std::vector<double>* f0) {
  const size_t nf = f0->size();
  if (nf == 0) return;

  // step 1: kill relative jumps beyond allowed_range
  std::vector<double> s1 = *f0;
  for (size_t i = 1; i < nf; ++i) {
    if ((*f0)[i] <= 0.0 || (*f0)[i - 1] <= 0.0) continue;
    double jump = std::fabs((*f0)[i] - (*f0)[i - 1]) / (*f0)[i];
    if (jump > allowed_range) s1[i] = 0.0;
  }

  // step 2: drop voiced runs shorter than voice_range_minimum
  const int vrm =
      (int)(0.5 + 1000.0 / frame_period / f0_floor) * 2 + 1;
  std::vector<double> s2 = s1;
  size_t i = 0;
  while (i < nf) {
    if (s1[i] <= 0.0) { ++i; continue; }
    size_t j = i;
    while (j < nf && s1[j] > 0.0) ++j;
    if ((int)(j - i) < vrm)
      for (size_t k = i; k < j; ++k) s2[k] = 0.0;
    i = j;
  }

  // steps 3+4: extend voiced sections forward/backward using the
  // candidate matrix (best candidate within allowed_range of the edge)
  std::vector<double> s3 = s2;
  i = 0;
  while (i < nf) {
    if (s2[i] <= 0.0) { ++i; continue; }
    size_t j = i;
    while (j < nf && s2[j] > 0.0) ++j;
    double ref = s3[j - 1];
    for (size_t k = j; k < nf && s2[k] <= 0.0; ++k) {   // forward
      double v = select_near(cands, k, ref, allowed_range);
      if (v <= 0.0) break;
      s3[k] = v;  ref = v;
    }
    ref = s3[i];
    for (size_t k = i; k-- > 0 && s2[k] <= 0.0;) {       // backward
      double v = select_near(cands, k, ref, allowed_range);
      if (v <= 0.0) break;
      s3[k] = v;  ref = v;
    }
    i = j;
  }
  *f0 = s3;
}

// -------------------------------------------------------- StoneMask core
// One instantaneous-frequency refinement pass at frame time tpos.
double refine_once(const double* x, long long n, int fs, double tpos,
                   double f0) {
  if (f0 <= 0.0) return 0.0;
  const int half = (int)(1.5 * fs / f0 + 0.5);
  const int wlen = 2 * half + 1;
  const size_t fft_n = next_pow2((size_t)wlen) * 2;
  const long long center = (long long)std::lround(tpos * fs);
  // a truncated window biases the instantaneous-frequency estimate;
  // keep the DIO value at the signal edges instead of refining there
  if (center - half < 0 || center + half >= n) return 0.0;

  std::vector<double> wre(fft_n, 0.0), wim(fft_n, 0.0);
  std::vector<double> dre(fft_n, 0.0), dim_(fft_n, 0.0);
  std::vector<double> win(wlen), dwin(wlen);
  for (int i = 0; i < wlen; ++i) {
    // Blackman window spanning three periods of f0
    double t = (double)(i - half) * f0 / (1.5 * fs);   // in [-1, 1]
    win[i] = 0.42 + 0.5 * std::cos(kPi * t) + 0.08 * std::cos(2.0 * kPi * t);
  }
  for (int i = 0; i < wlen; ++i) {
    double prev = i > 0 ? win[i - 1] : 0.0;
    double next = i + 1 < wlen ? win[i + 1] : 0.0;
    dwin[i] = -(next - prev) / 2.0;
  }
  for (int i = 0; i < wlen; ++i) {
    long long k = center - half + i;
    double s = (k >= 0 && k < n) ? x[k] : 0.0;
    wre[(size_t)i] = s * win[i];
    dre[(size_t)i] = s * dwin[i];
  }
  fft(wre, wim, false);
  fft(dre, dim_, false);

  const int harmonics = std::min((int)(0.5 * fs / f0), 6);
  if (harmonics < 1) return 0.0;
  double num = 0.0, den = 0.0;
  for (int h = 1; h <= harmonics; ++h) {
    size_t k = (size_t)std::lround(h * f0 / fs * (double)fft_n);
    if (k >= fft_n / 2) break;
    double power = wre[k] * wre[k] + wim[k] * wim[k];
    if (power <= 1e-30) continue;
    // flat-top instantaneous frequency estimator:
    // IF = f_k + Im{X'(k) * conj(X(k))} / |X(k)|^2 * fs / (2*pi)
    double fk = (double)k * fs / (double)fft_n;
    double cross = dre[k] * (-wim[k]) + dim_[k] * wre[k];
    double inst = fk + cross / power * fs / (2.0 * kPi);
    double amp = std::sqrt(power);
    num += inst * amp;
    den += amp * (double)h;
  }
  if (den <= 0.0) return 0.0;
  return num / den;
}

// ===================================================== CheapTrick / D4C
// Shared spectral helpers.  Frequency arrays are one-sided power (or
// group-delay) spectra of length fft_n/2 + 1 over [0, fs/2].

// Mirror the sub-F0 part of the spectrum back onto itself ("DC
// correction", CheapTrick §2.2): for bins with f < f0 add the value
// interpolated at (f0 - f), so the envelope below the fundamental is
// dominated by the mirrored first harmonic instead of window leakage.
void dc_correction(std::vector<double>& p, double f0, int fs, size_t fft_n) {
  const double df = (double)fs / (double)fft_n;
  const size_t half = fft_n / 2;
  const size_t upper = std::min((size_t)(f0 / df) + 1, half);
  std::vector<double> replica(upper);
  for (size_t i = 0; i < upper; ++i) {
    double q = (f0 - (double)i * df) / df;       // in bins
    size_t lo = (size_t)q;
    double w = q - (double)lo;
    size_t hi = std::min(lo + 1, half);
    replica[i] = p[lo] * (1.0 - w) + p[hi] * w;
  }
  for (size_t i = 0; i < upper; ++i) p[i] += replica[i];
}

// Rectangular smoothing of width `width` Hz applied to the piecewise-
// linear spectrum (CheapTrick §2.2 / D4C §2.2): smoothed(f) =
// (1/w) * Int_{f-w/2}^{f+w/2} P, with P mirrored at 0 and fs/2.
// Exact for the piecewise-linear interpolant via the cumulative
// trapezoid integral F (F(-f) = -F(f); beyond fs/2 by reflection).
void linear_smoothing(std::vector<double>& p, double width, int fs,
                      size_t fft_n) {
  const double df = (double)fs / (double)fft_n;
  const size_t half = fft_n / 2;
  const double fmax = (double)half * df;
  std::vector<double> F(half + 1, 0.0);
  for (size_t i = 1; i <= half; ++i)
    F[i] = F[i - 1] + 0.5 * (p[i - 1] + p[i]) * df;

  auto Fat = [&](double f) -> double {   // F on [0, fmax]
    if (f <= 0.0) return 0.0;
    if (f >= fmax) return F[half];
    double q = f / df;
    size_t lo = (size_t)q;
    double w = q - (double)lo;
    // integral over the partial segment [lo*df, f] of the linear piece
    double pa = p[lo], pb = p[lo + 1];
    double seg = (pa + 0.5 * w * (pb - pa)) * (w * df);
    return F[lo] + seg;
  };
  auto Fext = [&](double f) -> double {  // signed, mirrored extension
    if (f < 0.0) return -Fat(-f);
    if (f > fmax) return 2.0 * F[half] - Fat(2.0 * fmax - f);
    return Fat(f);
  };

  std::vector<double> out(half + 1);
  const double hw = width * 0.5;
  for (size_t i = 0; i <= half; ++i) {
    double f = (double)i * df;
    out[i] = (Fext(f + hw) - Fext(f - hw)) / width;
  }
  p = out;
}

// F0-adaptive windowed segment around tpos (seconds): `periods`
// fundamental periods long, Hann (type 0) or Blackman (type 1)
// window, out-of-range samples index-clamped, window-weighted mean
// removed (the papers' DC bias removal).
void windowed_segment(const double* x, long long n, int fs, double f0,
                      double tpos, double periods, int type,
                      std::vector<double>* seg, std::vector<double>* win) {
  const int half = (int)std::lround(0.5 * periods * fs / f0);
  const int wlen = 2 * half + 1;
  seg->assign((size_t)wlen, 0.0);
  win->assign((size_t)wlen, 0.0);
  const long long center = (long long)std::lround(tpos * fs);
  double wsum = 0.0, ssum = 0.0;
  for (int i = 0; i < wlen; ++i) {
    double t = (double)(i - half) * f0 / (0.5 * periods * fs);  // [-1, 1]
    double w = type == 0
        ? 0.5 + 0.5 * std::cos(kPi * t)
        : 0.42 + 0.5 * std::cos(kPi * t) + 0.08 * std::cos(2.0 * kPi * t);
    long long k = center - half + i;
    k = k < 0 ? 0 : (k >= n ? n - 1 : k);
    (*win)[(size_t)i] = w;
    (*seg)[(size_t)i] = x[k] * w;
    wsum += w;
    ssum += (*seg)[(size_t)i];
  }
  const double bias = wsum > 0.0 ? ssum / wsum : 0.0;
  for (int i = 0; i < wlen; ++i) (*seg)[(size_t)i] -= bias * (*win)[(size_t)i];
}

// One-sided power spectrum of a segment zero-padded to fft_n.
void power_spectrum_of(const std::vector<double>& seg, size_t fft_n,
                       std::vector<double>* p) {
  std::vector<double> re(fft_n, 0.0), im(fft_n, 0.0);
  for (size_t i = 0; i < seg.size() && i < fft_n; ++i) re[i] = seg[i];
  fft(re, im, false);
  p->assign(fft_n / 2 + 1, 0.0);
  for (size_t k = 0; k <= fft_n / 2; ++k)
    (*p)[k] = re[k] * re[k] + im[k] * im[k];
}

// ------------------------------------------------------ CheapTrick core
// Spectral envelope of one frame (CheapTrick §2): F0-adaptive Hann
// window of 3 periods -> power spectrum -> sub-F0 mirroring ->
// rectangular smoothing of width (2/3)F0 -> cepstral liftering with
// the sinc smoothing lifter and the (1-2q1)+2q1*cos compensation
// lifter (q1 = -0.15), recovered through exp.
void cheaptrick_frame(const double* x, long long n, int fs, double f0,
                      double tpos, size_t fft_n, double q1, double* out) {
  std::vector<double> seg, win, p;
  windowed_segment(x, n, fs, f0, tpos, 3.0, 0, &seg, &win);
  power_spectrum_of(seg, fft_n, &p);
  dc_correction(p, f0, fs, fft_n);
  linear_smoothing(p, f0 * 2.0 / 3.0, fs, fft_n);
  const double eps = 1e-12;

  // liftering in the quefrency domain on the log spectrum
  std::vector<double> re(fft_n), im(fft_n, 0.0);
  const size_t half = fft_n / 2;
  for (size_t k = 0; k <= half; ++k) re[k] = std::log(p[k] + eps);
  for (size_t k = half + 1; k < fft_n; ++k) re[k] = re[fft_n - k];
  fft(re, im, true);                       // cepstrum (inverse FFT)
  for (size_t i = 1; i <= half; ++i) {
    double q = (double)i / (double)fs;     // quefrency in seconds
    double sl = std::sin(kPi * f0 * q) / (kPi * f0 * q);
    double cl = (1.0 - 2.0 * q1) + 2.0 * q1 * std::cos(2.0 * kPi * q * f0);
    double l = sl * cl;
    re[i] *= l;
    re[fft_n - i] *= l;
    im[i] = im[fft_n - i] = 0.0;
  }
  im[0] = 0.0;
  fft(re, im, false);
  for (size_t k = 0; k <= half; ++k) out[k] = std::exp(re[k]);
}

// ------------------------------------------------------------- D4C core
// Frame "LoveTrain" voicing measure (D4C §2.3): fraction of the
// 100 Hz..4 kHz band power within the 100 Hz..7.9 kHz band of a
// 3-period Blackman-windowed power spectrum — high when the energy
// is harmonic-concentrated (voiced), low for noise-dominated frames.
double d4c_love_train(const double* x, long long n, int fs, double f0,
                      double tpos, size_t fft_n) {
  std::vector<double> seg, win, p;
  windowed_segment(x, n, fs, f0, tpos, 3.0, 1, &seg, &win);
  power_spectrum_of(seg, fft_n, &p);
  const double df = (double)fs / (double)fft_n;
  const size_t half = fft_n / 2;
  const size_t b0 = std::min((size_t)std::ceil(100.0 / df), half);
  const size_t b1 = std::min((size_t)std::ceil(4000.0 / df), half);
  const size_t b2 = std::min((size_t)std::ceil(7900.0 / df), half);
  double low = 0.0, all = 0.0;
  for (size_t k = b0; k <= b2; ++k) {
    all += p[k];
    if (k <= b1) low += p[k];
  }
  return all > 0.0 ? low / all : 0.0;
}

// Spectral centroid numerator Re{conj(X) . FFT{t*x}} of a 4-period
// Blackman-windowed, power-normalized segment (D4C §2.2 GetCentroid).
void d4c_centroid(const double* x, long long n, int fs, double f0,
                  double tpos, size_t fft_n, std::vector<double>* out) {
  std::vector<double> seg, win;
  windowed_segment(x, n, fs, f0, tpos, 4.0, 1, &seg, &win);
  double power = 0.0;
  for (double v : seg) power += v * v;
  const double norm = power > 0.0 ? 1.0 / std::sqrt(power) : 0.0;

  std::vector<double> re(fft_n, 0.0), im(fft_n, 0.0);
  std::vector<double> tre(fft_n, 0.0), tim(fft_n, 0.0);
  for (size_t i = 0; i < seg.size() && i < fft_n; ++i) {
    re[i] = seg[i] * norm;
    tre[i] = seg[i] * norm * (double)(i + 1);
  }
  fft(re, im, false);
  fft(tre, tim, false);
  out->assign(fft_n / 2 + 1, 0.0);
  for (size_t k = 0; k <= fft_n / 2; ++k)
    (*out)[k] = re[k] * tre[k] + im[k] * tim[k];
}

// Temporally static group delay of one frame (D4C §2.2): the summed
// centroids at t -/+ T0/4 over the 4-period smoothed power spectrum,
// band-smoothed at F0/2 with its F0-smoothed trend removed.
void d4c_static_group_delay(const double* x, long long n, int fs,
                            double f0, double tpos, size_t fft_n,
                            std::vector<double>* sgd) {
  std::vector<double> c1, c2, p, seg, win;
  d4c_centroid(x, n, fs, f0, tpos - 0.25 / f0, fft_n, &c1);
  d4c_centroid(x, n, fs, f0, tpos + 0.25 / f0, fft_n, &c2);
  for (size_t k = 0; k < c1.size(); ++k) c1[k] += c2[k];
  dc_correction(c1, f0, fs, fft_n);

  windowed_segment(x, n, fs, f0, tpos, 4.0, 0, &seg, &win);
  power_spectrum_of(seg, fft_n, &p);
  dc_correction(p, f0, fs, fft_n);
  linear_smoothing(p, f0, fs, fft_n);

  sgd->assign(c1.size(), 0.0);
  for (size_t k = 0; k < c1.size(); ++k)
    (*sgd)[k] = c1[k] / (p[k] + 1e-12);
  linear_smoothing(*sgd, f0 * 0.5, fs, fft_n);
  std::vector<double> trend = *sgd;
  linear_smoothing(trend, f0, fs, fft_n);
  for (size_t k = 0; k < sgd->size(); ++k) (*sgd)[k] -= trend[k];
}

// Coarse aperiodicity (dB) at one 3 kHz band boundary (D4C §2.2): a
// Nuttall-windowed segment of the static group delay around the
// boundary is transformed and its sorted power cumulated; a periodic
// (static) group delay concentrates its power in few coefficients, so
// the cumulative share outside the top `boundary` coefficients
// estimates the band's aperiodic power ratio.
double d4c_coarse_aperiodicity(const std::vector<double>& sgd, int fs,
                               size_t fft_n, double boundary_hz) {
  const size_t wlen = fft_n / 8;
  const size_t boundary = (size_t)std::lround((double)fft_n * 8.0
                                              / (double)wlen);  // = 64
  const size_t center =
      (size_t)std::lround(boundary_hz * (double)fft_n / (double)fs);
  const size_t half = wlen / 2;
  std::vector<double> seg(wlen, 0.0);
  for (size_t j = 0; j < wlen; ++j) {
    size_t k = center + j >= half ? center + j - half : 0;
    k = std::min(k, fft_n / 2);
    seg[j] = sgd[k] * nuttall((double)j / (double)(wlen - 1));
  }
  std::vector<double> p;
  power_spectrum_of(seg, fft_n, &p);
  std::sort(p.begin(), p.end());
  for (size_t k = 1; k < p.size(); ++k) p[k] += p[k - 1];
  const size_t m = p.size() - 1;
  if (p[m] <= 0.0 || m <= boundary) return -60.0;
  double ratio = p[m - boundary - 1] / p[m];
  double db = 10.0 * std::log10(std::max(ratio, 1e-6));
  return std::min(std::max(db, -60.0), -1e-7);
}

// WORLD's internal analysis FFT length: 2^(1 + floor(log2(4*fs/floor
// + 1))) == the next power of two at or above 4 periods of floor_f0.
size_t d4c_internal_fft(int fs, double floor_f0) {
  return next_pow2((size_t)(4.0 * fs / floor_f0) + 1);
}

}  // namespace

extern "C" {

// Frame times and F0 (0 = unvoiced); out arrays must hold n_frames
// doubles where n_frames = (long long)(1000.0 * n / fs / frame_period) + 1.
// Returns the number of frames written, or -1 on bad arguments.
long long world_dio(const double* x, long long n, int fs,
                    double frame_period, double f0_floor, double f0_ceil,
                    double channels_in_octave, double allowed_range,
                    double* out_f0, double* out_t) {
  if (!x || n <= 0 || fs <= 0 || frame_period <= 0.0 ||
      f0_floor <= 0.0 || f0_ceil <= f0_floor || !out_f0 || !out_t)
    return -1;
  const long long nf =
      (long long)(1000.0 * (double)n / fs / frame_period) + 1;
  std::vector<double> tpos((size_t)nf);
  for (long long i = 0; i < nf; ++i)
    tpos[(size_t)i] = (double)i * frame_period / 1000.0;

  Candidates cands;
  dio_candidates(x, n, fs, tpos, f0_floor, f0_ceil, channels_in_octave,
                 &cands);
  std::vector<double> f0((size_t)nf, 0.0), score((size_t)nf, kBadScore);
  select_best(cands, &f0, &score);
  fix_contour(cands, frame_period, f0_floor, allowed_range, &f0);

  std::memcpy(out_f0, f0.data(), sizeof(double) * (size_t)nf);
  std::memcpy(out_t, tpos.data(), sizeof(double) * (size_t)nf);
  return nf;
}

// StoneMask refinement: two instantaneous-frequency passes per voiced
// frame; a refinement drifting > 18% from the input estimate (or out of
// a plausible range) keeps the frame unvoiced-safe by zeroing it.
int world_stonemask(const double* x, long long n, int fs,
                    const double* f0, const double* t, long long n_frames,
                    double* out_f0) {
  if (!x || n <= 0 || fs <= 0 || !f0 || !t || n_frames <= 0 || !out_f0)
    return -1;
  for (long long i = 0; i < n_frames; ++i) {
    double cur = f0[i];
    if (cur <= 0.0) { out_f0[i] = 0.0; continue; }
    double r1 = refine_once(x, n, fs, t[i], cur);
    double r2 = r1 > 0.0 ? refine_once(x, n, fs, t[i], r1) : 0.0;
    double refined = r2 > 0.0 ? r2 : r1;
    if (refined <= 0.0 || std::fabs(refined - cur) > 0.18 * cur)
      out_f0[i] = cur;   // keep the DIO estimate when refinement strays
    else
      out_f0[i] = refined;
  }
  return 0;
}

// CheapTrick spectral envelope (pyworld.cheaptrick-shaped): per frame
// writes fft_size/2 + 1 envelope bins to out_sp (frame-major).  A
// frame whose 3-period window would not fit the analysis FFT
// (f0 <= fs*3/(fft_size-3)) and an unvoiced frame (f0 == 0) both use
// the default 500 Hz analysis F0, as the published algorithm does.
int world_cheaptrick(const double* x, long long n, int fs,
                     const double* f0, const double* t, long long n_frames,
                     int fft_size, double q1, double* out_sp) {
  if (!x || n <= 0 || fs <= 0 || !f0 || !t || n_frames <= 0 ||
      fft_size < 32 || (fft_size & (fft_size - 1)) != 0 || !out_sp)
    return -1;
  const double f0_low_limit = (double)fs * 3.0 / ((double)fft_size - 3.0);
  const size_t bins = (size_t)fft_size / 2 + 1;
  for (long long i = 0; i < n_frames; ++i) {
    double cur = f0[i] <= f0_low_limit ? 500.0 : f0[i];
    cheaptrick_frame(x, n, fs, cur, t[i], (size_t)fft_size, q1,
                     out_sp + (size_t)i * bins);
  }
  return 0;
}

// D4C band aperiodicity (pyworld.d4c-shaped): per frame writes
// fft_size/2 + 1 aperiodicity values in [0, 1] to out_ap
// (frame-major).  Coarse estimates at 3 kHz interval boundaries
// (up to min(15 kHz, fs/2 - 3 kHz)) from the temporally static group
// delay are interpolated over frequency on the dB scale between
// -60 dB at 0 Hz and ~0 dB at fs/2.  Unvoiced frames and frames whose
// LoveTrain voicing measure falls at or below `threshold` are fully
// aperiodic (1 - 1e-12), as in the published algorithm.
int world_d4c(const double* x, long long n, int fs,
              const double* f0, const double* t, long long n_frames,
              int fft_size, double threshold, double* out_ap) {
  if (!x || n <= 0 || fs <= 0 || !f0 || !t || n_frames <= 0 ||
      fft_size < 32 || (fft_size & (fft_size - 1)) != 0 || !out_ap)
    return -1;
  const double kFloorF0 = 47.0;
  const size_t fft_n = d4c_internal_fft(fs, kFloorF0);
  const size_t fft_lt = next_pow2((size_t)(3.0 * fs / 40.0) + 1);
  const double interval = 3000.0;
  const int n_ap = std::max(
      (int)(std::min(15000.0, (double)fs / 2.0 - interval) / interval), 1);
  const size_t bins = (size_t)fft_size / 2 + 1;
  const double df_out = (double)fs / (double)fft_size;

  std::vector<double> axis_f(n_ap + 2), axis_db(n_ap + 2);
  axis_f[0] = 0.0;
  axis_f[n_ap + 1] = (double)fs / 2.0;
  for (int b = 0; b < n_ap; ++b) axis_f[b + 1] = interval * (b + 1);

  std::vector<double> sgd;
  for (long long i = 0; i < n_frames; ++i) {
    double* row = out_ap + (size_t)i * bins;
    double cur = std::max(f0[i], kFloorF0);
    bool voiced = f0[i] > 0.0 &&
        d4c_love_train(x, n, fs, cur, t[i], fft_lt) > threshold;
    if (!voiced) {
      for (size_t k = 0; k < bins; ++k) row[k] = 1.0 - 1e-12;
      continue;
    }
    d4c_static_group_delay(x, n, fs, cur, t[i], fft_n, &sgd);
    axis_db[0] = -60.0;
    axis_db[n_ap + 1] = -1e-7;
    for (int b = 0; b < n_ap; ++b)
      axis_db[b + 1] = d4c_coarse_aperiodicity(sgd, fs, fft_n,
                                               interval * (b + 1));
    for (size_t k = 0; k < bins; ++k) {
      double db = interp1(axis_f, axis_db, (double)k * df_out);
      double ap = std::pow(10.0, db / 20.0);
      row[k] = std::min(std::max(ap, 1e-12), 1.0 - 1e-12);
    }
  }
  return 0;
}

}  // extern "C"
