// pint_tpu_torch native host kernels (the JAX package's
// native/src/host_kernels.cpp, carried over unchanged but for these
// comments, so both packages' host libraries compile to the same code).
//
// C++ equivalents of the hot host-side precompute loops, matching the
// Python implementations bit-for-bit in structure (same truncated
// series, same constants) so either path may serve any call:
//
//  - tdb_minus_tt:   Fairhead–Bretagnon 1990 truncated series
//                    (python: pint_tpu_torch/timescales.py::tdb_minus_tt)
//  - itrf_to_gcrs:   Earth-rotation chain bias/precession/nutation/
//                    ERA/GAST/polar-motion
//                    (python: pint_tpu_torch/earth/erfa_lite.py)
//  - cheby_posvel:   SPK type 2/3 Chebyshev record evaluation
//                    (python: pint_tpu_torch/io/spk.py::SPKKernel.posvel)
//
// The reference package leans on native code for exactly these jobs —
// ERFA (C) for earth rotation and time scales, jplephem+numpy (C) for
// ephemeris Chebyshev work (reference: src/pint/erfautils.py,
// src/pint/solar_system_ephemerides.py) — so the TPU build carries
// native host kernels too, per-TOA work being the host-side hot path
// feeding the device TOABatch.
//
// C ABI, called from Python via ctypes (no pybind11 in the build env).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr double TWO_PI = 6.283185307179586476925287;
constexpr double ARCSEC_TO_RAD = TWO_PI / (360.0 * 3600.0);
constexpr double SECS_PER_DAY = 86400.0;
constexpr double OMEGA_EARTH = 7.292115855306589e-5;  // rad/s (IERS)

inline double jc_from_epoch(std::int64_t day, double sec) {
  // Julian centuries since J2000.0 (MJD 51544.5)
  return ((static_cast<double>(day - 51544) - 0.5) + sec / SECS_PER_DAY) /
         36525.0;
}

struct Mat3 {
  double m[3][3];
};

inline Mat3 matmul(const Mat3& a, const Mat3& b) {
  Mat3 r{};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      double s = 0.0;
      for (int k = 0; k < 3; ++k) s += a.m[i][k] * b.m[k][j];
      r.m[i][j] = s;
    }
  return r;
}

inline Mat3 rx(double a) {
  double c = std::cos(a), s = std::sin(a);
  return Mat3{{{1, 0, 0}, {0, c, s}, {0, -s, c}}};
}
inline Mat3 ry(double a) {
  double c = std::cos(a), s = std::sin(a);
  return Mat3{{{c, 0, -s}, {0, 1, 0}, {s, 0, c}}};
}
inline Mat3 rz(double a) {
  double c = std::cos(a), s = std::sin(a);
  return Mat3{{{c, s, 0}, {-s, c, 0}, {0, 0, 1}}};
}

// IAU2000B nutation, table INJECTED from Python at library load
// (pt_set_nut_table below; pint_tpu_torch/native.py::_setup pushes
// erfa_lite._NUT_TERMS so the 77x11 table has exactly one source of
// truth). Row layout: l lp F D Om multipliers then ps pst pc ec ect es
// in 0.1 uas; dpsi = (ps+pst*T) sin + pc cos, deps = (ec+ect*T) cos +
// es sin, plus the fixed planetary-bias offsets [arcsec]. Built-in
// default: the dominant 13 terms (pc/es zero), so a bare dlopen
// without the setter still computes a ~20 mas-class nutation.
std::vector<double> g_nut_table = {
    0, 0, 0, 0, 1, -172064161.0, -174666.0, 0, 92052331.0, 9086.0, 0,
    0, 0, 2, -2, 2, -13170906.0, -1675.0, 0, 5730336.0, -3015.0, 0,
    0, 0, 2, 0, 2, -2276413.0, -234.0, 0, 978459.0, -485.0, 0,
    0, 0, 0, 0, 2, 2074554.0, 207.0, 0, -897492.0, 470.0, 0,
    0, 1, 0, 0, 0, 1475877.0, -3633.0, 0, 73871.0, -184.0, 0,
    0, 1, 2, -2, 2, -516821.0, 1226.0, 0, 224386.0, -677.0, 0,
    1, 0, 0, 0, 0, 711159.0, 73.0, 0, -6750.0, 0.0, 0,
    0, 0, 2, 0, 1, -387298.0, -367.0, 0, 200728.0, 18.0, 0,
    1, 0, 2, 0, 2, -301461.0, -36.0, 0, 129025.0, -63.0, 0,
    0, -1, 2, -2, 2, 215829.0, -494.0, 0, -95929.0, 299.0, 0,
    0, 0, 2, -2, 1, 128227.0, 137.0, 0, -68982.0, -9.0, 0,
    -1, 0, 2, 0, 2, 123457.0, 11.0, 0, -53311.0, 32.0, 0,
    -1, 0, 0, 2, 0, 156994.0, 10.0, 0, -1235.0, 0.0, 0,
};
double g_nut_bias_psi_as = 0.0;  // [arcsec]
double g_nut_bias_eps_as = 0.0;

void nutation(double T, double* dpsi, double* deps) {
  // LINEAR-only Delaunay arguments, as the IAU2000B model prescribes
  // (mirrors erfa_lite._fund_args_nut00b; quadratic terms would move
  // the series ~10 uas off the published model at |T|~0.1)
  const double l = (485868.249036 + 1717915923.2178 * T) * ARCSEC_TO_RAD;
  const double lp = (1287104.79305 + 129596581.0481 * T) * ARCSEC_TO_RAD;
  const double F = (335779.526232 + 1739527262.8478 * T) * ARCSEC_TO_RAD;
  const double D = (1072260.70369 + 1602961601.2090 * T) * ARCSEC_TO_RAD;
  const double Om = (450160.398036 - 6962890.5431 * T) * ARCSEC_TO_RAD;
  double dp = 0.0, de = 0.0;
  const std::size_t n = g_nut_table.size() / 11;
  for (std::size_t j = 0; j < n; ++j) {
    const double* row = g_nut_table.data() + 11 * j;
    const double arg =
        row[0] * l + row[1] * lp + row[2] * F + row[3] * D + row[4] * Om;
    const double s = std::sin(arg), c = std::cos(arg);
    dp += (row[5] + row[6] * T) * s + row[7] * c;
    de += (row[8] + row[9] * T) * c + row[10] * s;
  }
  const double scale = 1e-7 * ARCSEC_TO_RAD;
  *dpsi = dp * scale + g_nut_bias_psi_as * ARCSEC_TO_RAD;
  *deps = de * scale + g_nut_bias_eps_as * ARCSEC_TO_RAD;
}

inline double mean_obliquity(double T) {
  return (84381.406 - 46.836769 * T - 0.0001831 * T * T +
          0.00200340 * T * T * T) *
         ARCSEC_TO_RAD;
}

Mat3 bias_matrix() {
  const double dpsi_b = -0.041775 * ARCSEC_TO_RAD;
  const double deps_b = -0.0068192 * ARCSEC_TO_RAD;
  const double dra0 = -0.0146 * ARCSEC_TO_RAD;
  const double eps0 = 84381.406 * ARCSEC_TO_RAD;
  return matmul(matmul(rx(deps_b), ry(dpsi_b * std::sin(eps0))), rz(-dra0));
}

Mat3 precession_matrix(double T) {
  const double zeta =
      (2306.2181 * T + 0.30188 * T * T + 0.017998 * T * T * T) * ARCSEC_TO_RAD;
  const double z =
      (2306.2181 * T + 1.09468 * T * T + 0.018203 * T * T * T) * ARCSEC_TO_RAD;
  const double theta =
      (2004.3109 * T - 0.42665 * T * T - 0.041833 * T * T * T) * ARCSEC_TO_RAD;
  return matmul(matmul(rz(-z), ry(theta)), rz(-zeta));
}

Mat3 nutation_matrix(double T, double dpsi, double deps) {
  const double eps = mean_obliquity(T);
  return matmul(matmul(rx(-(eps + deps)), rz(-dpsi)), rx(eps));
}

inline double era(std::int64_t ut1_day, double ut1_sec) {
  const double du =
      (static_cast<double>(ut1_day - 51544) - 0.5) + ut1_sec / SECS_PER_DAY;
  // Tu mod 1 carrier: MJD-split epoch has JD fraction 0.5 + sec/day; the
  // +0.5 is required or ERA comes out wrong by exactly pi.
  const double frac = ut1_sec / SECS_PER_DAY + 0.5;
  const double theta =
      TWO_PI * (0.7790572732640 + 0.00273781191135448 * du + frac);
  return std::fmod(theta, TWO_PI);
}

}  // namespace

extern "C" {

// Replace the nutation table (rows of 11 doubles, see g_nut_table)
// and planetary-bias offsets [arcsec]. Called once by the ctypes
// loader with erfa_lite's full IAU2000B table.
void pt_set_nut_table(std::int64_t n_rows, const double* rows,
                      double bias_psi_as, double bias_eps_as) {
  g_nut_table.assign(rows, rows + 11 * n_rows);
  g_nut_bias_psi_as = bias_psi_as;
  g_nut_bias_eps_as = bias_eps_as;
}

// TDB-TT [s] (FB1990-form harmonic series; terms injected from
// timescales.py via pt_set_tdb_terms — single source of truth).
// Built-in default: the 10 leading FB1990 terms + the largest
// T-modulated term.
std::vector<double> g_tdb_terms = {
    0.001656675, 628.3075850, 6.2400580,
    0.000022418, 575.3384885, 4.2969771,
    0.000013840, 1256.6151700, 6.1968992,
    0.000004770, 52.9690965, 0.4444038,
    0.000004677, 606.9776754, 4.0211665,
    0.000002257, 21.3299095, 5.5431320,
    0.000001694, 0.3523118, 5.0251207,
    0.000001556, 1203.6460735, 4.1698465,
    0.000001276, 1414.3495242, 4.2781490,
    0.000001193, 1097.7078770, 6.1798441,
};
std::vector<double> g_tdb_t_terms = {0.0000102, 628.3075850, 4.2490};
double g_tdb_poly[3] = {0.0, 0.0, 0.0};
// first g_tdb_n_t_published T-terms are published physics (secular
// factor uses true T); the rest are fit-derived (secular factor clamps
// to the fit window, like the polynomial). Mirrors timescales.py
// _N_T_TERMS_PUBLISHED / _TDB_T_CLAMP_*.
std::int64_t g_tdb_n_t_published = 1;
double g_tdb_t_clamp_lo = -1e30;
double g_tdb_t_clamp_hi = 1e30;

void pt_set_tdb_terms(std::int64_t n, const double* terms,
                      std::int64_t n_t, const double* t_terms,
                      const double* poly3, std::int64_t n_t_published,
                      double t_clamp_lo, double t_clamp_hi) {
  g_tdb_terms.assign(terms, terms + 3 * n);
  g_tdb_t_terms.assign(t_terms, t_terms + 3 * n_t);
  g_tdb_poly[0] = poly3[0];
  g_tdb_poly[1] = poly3[1];
  g_tdb_poly[2] = poly3[2];
  g_tdb_n_t_published = n_t_published;
  g_tdb_t_clamp_lo = t_clamp_lo;
  g_tdb_t_clamp_hi = t_clamp_hi;
}

void pt_tdb_minus_tt(std::int64_t n, const std::int64_t* tt_day,
                     const double* tt_sec, double* out) {
  const std::size_t n0 = g_tdb_terms.size() / 3;
  const std::size_t n1 = g_tdb_t_terms.size() / 3;
  const std::size_t npub = static_cast<std::size_t>(g_tdb_n_t_published);
  for (std::int64_t i = 0; i < n; ++i) {
    const double T = jc_from_epoch(tt_day[i], tt_sec[i]);
    const double Tc =
        std::min(std::max(T, g_tdb_t_clamp_lo), g_tdb_t_clamp_hi);
    double s = g_tdb_poly[0] + g_tdb_poly[1] * Tc + g_tdb_poly[2] * Tc * Tc;
    for (std::size_t j = 0; j < n0; ++j) {
      const double* t = g_tdb_terms.data() + 3 * j;
      s += t[0] * std::sin(t[1] * T + t[2]);
    }
    for (std::size_t j = 0; j < n1; ++j) {
      const double* t = g_tdb_t_terms.data() + 3 * j;
      s += t[0] * (j < npub ? T : Tc) * std::sin(t[1] * T + t[2]);
    }
    out[i] = s;
  }
}

// Observatory ITRF -> GCRS position [m] and velocity [m/s].
// Epoch conversions (UTC->TT, UT1) and EOP lookups stay in Python so
// leap-second policy lives in exactly one place.
void pt_itrf_to_gcrs(std::int64_t n, const std::int64_t* tt_day,
                     const double* tt_sec, const std::int64_t* ut1_day,
                     const double* ut1_sec, const double* xp, const double* yp,
                     const double* itrf, double* out_pos, double* out_vel) {
  const Mat3 B = bias_matrix();
  for (std::int64_t i = 0; i < n; ++i) {
    const double T = jc_from_epoch(tt_day[i], tt_sec[i]);
    double dpsi, deps;
    nutation(T, &dpsi, &deps);
    // GAST = ERA + GMST-poly + equation of equinoxes (main term)
    const double poly = (0.014506 + 4612.156534 * T + 1.3915817 * T * T -
                         0.00000044 * T * T * T) *
                        ARCSEC_TO_RAD;
    const double ee = dpsi * std::cos(mean_obliquity(T));
    const double theta =
        std::fmod(era(ut1_day[i], ut1_sec[i]) + poly + ee, TWO_PI);
    const Mat3 W = matmul(ry(xp[i]), rx(yp[i]));
    Mat3 c2t = matmul(
        W, matmul(rz(theta), matmul(nutation_matrix(T, dpsi, deps),
                                    matmul(precession_matrix(T), B))));
    // transpose -> ITRF->GCRS; pos = M r
    double p[3];
    for (int r = 0; r < 3; ++r) {
      p[r] = c2t.m[0][r] * itrf[0] + c2t.m[1][r] * itrf[1] +
             c2t.m[2][r] * itrf[2];
    }
    out_pos[3 * i + 0] = p[0];
    out_pos[3 * i + 1] = p[1];
    out_pos[3 * i + 2] = p[2];
    // vel = omega x pos (PN-rate terms ~1e5 x smaller)
    out_vel[3 * i + 0] = -OMEGA_EARTH * p[1];
    out_vel[3 * i + 1] = OMEGA_EARTH * p[0];
    out_vel[3 * i + 2] = 0.0;
  }
}

// SPK type 2/3 Chebyshev evaluation over gathered records.
// rec: (n, rsize) rows [mid, radius, coeffs...]; matches spk.py::posvel.
void pt_cheby_posvel(std::int64_t n, std::int64_t ncoef,
                     std::int64_t data_type, std::int64_t rsize,
                     const double* et, const double* rec, double* out_pos,
                     double* out_vel) {
  // stack buffers: DE kernels use <= 18 coefficients
  double Tp[32], dTp[32];
  for (std::int64_t i = 0; i < n; ++i) {
    const double* r = rec + i * rsize;
    const double mid = r[0], radius = r[1];
    const double s = (et[i] - mid) / radius;
    Tp[0] = 1.0;
    dTp[0] = 0.0;
    if (ncoef > 1) {
      Tp[1] = s;
      dTp[1] = 1.0;
    }
    for (std::int64_t k = 2; k < ncoef; ++k) {
      Tp[k] = 2.0 * s * Tp[k - 1] - Tp[k - 2];
      dTp[k] = 2.0 * Tp[k - 1] + 2.0 * s * dTp[k - 1] - dTp[k - 2];
    }
    for (int axis = 0; axis < 3; ++axis) {
      const double* c = r + 2 + axis * ncoef;
      double pos = 0.0, vel = 0.0;
      for (std::int64_t k = 0; k < ncoef; ++k) {
        pos += c[k] * Tp[k];
        vel += c[k] * dTp[k];
      }
      out_pos[3 * i + axis] = pos;
      out_vel[3 * i + axis] = vel / radius;
    }
    if (data_type == 3) {
      for (int axis = 0; axis < 3; ++axis) {
        const double* c = r + 2 + (3 + axis) * ncoef;
        double vel = 0.0;
        for (std::int64_t k = 0; k < ncoef; ++k) vel += c[k] * Tp[k];
        out_vel[3 * i + axis] = vel;
      }
    }
  }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// FORMAT-1 (tempo2) tim-file parser — the native data loader.
//
// The reference's tim parsing is a pure-Python per-line loop flagged as
// a hot spot for large files (reference: src/pint/toa.py::read_toa_file;
// PINT mitigates it with a pickle cache). Here the fast path lives in
// C++: one pass over the raw buffer producing column arrays plus a
// packed flags blob, mirroring pint_tpu_torch/toa.py::_parse_tempo2_line and
// pint_tpu_torch/mjd.py::parse_mjd_string semantics exactly. Any construct
// that needs stateful Python handling (INCLUDE recursion, TIME/EFAC/
// EQUAD/EMIN/EMAX/SKIP/JUMP/PHASE, princeton/parkes lines before a
// FORMAT 1) returns -1 so the caller falls back to the Python parser.
// ---------------------------------------------------------------------------

extern "C" {

namespace {
struct TimTok {
  const char* p;
  int len;
};

// python str.split() whitespace, full ASCII set: space, \t, \v, \f,
// \x1c-\x1f (file/group/record/unit separators are isspace() in
// python). \r and \n are line terminators, never intra-line here.
inline bool tim_space(char c) {
  return c == ' ' || c == '\t' || c == '\v' || c == '\f' ||
         (c >= '\x1c' && c <= '\x1f');
}

inline bool tok_is_ci(const TimTok& t, const char* kw) {
  int i = 0;
  for (; kw[i]; ++i) {
    if (i >= t.len) return false;
    char c = t.p[i];
    if (c >= 'a' && c <= 'z') c -= 32;
    if (c != kw[i]) return false;
  }
  return i == t.len;
}

// full-token float parse mirroring python float() (toa.py::_is_number):
// underscores allowed only between digits (stripped), hex floats
// rejected; otherwise strtod semantics match python's float grammar.
inline bool tok_float(const TimTok& t, double* out) {
  char tmp[64];
  int m = 0;
  if (t.len <= 0 || t.len >= 64) return false;
  for (int i = 0; i < t.len; ++i) {
    char c = t.p[i];
    if (c == '_') {
      if (i == 0 || i == t.len - 1) return false;
      char a = t.p[i - 1], b = t.p[i + 1];
      if (a < '0' || a > '9' || b < '0' || b > '9') return false;
      continue;  // python float() strips digit-adjacent underscores
    }
    if (c == '(') return false;  // strtod's nan(seq); python rejects
    tmp[m++] = c;
  }
  tmp[m] = 0;
  int s = (m > 0 && (tmp[0] == '+' || tmp[0] == '-')) ? 1 : 0;
  if (s + 1 < m && tmp[s] == '0' && (tmp[s + 1] == 'x' || tmp[s + 1] == 'X'))
    return false;  // python float() has no hex literals
  char* end = nullptr;
  double v = strtod(tmp, &end);
  if (end != tmp + m) return false;
  *out = v;
  return true;
}

// exact decimal MJD -> (int day, f64 seconds-of-day); mirrors
// mjd.py::parse_mjd_string (long double = x86 80-bit, same as numpy
// longdouble, so results are bit-identical for <= 19 frac digits).
inline bool tok_mjd(const TimTok& t, std::int64_t* day, double* sec) {
  int i = 0;
  bool neg = false;
  if (i < t.len && (t.p[i] == '+' || t.p[i] == '-')) {
    neg = t.p[i] == '-';
    ++i;
  }
  if (i >= t.len || t.p[i] < '0' || t.p[i] > '9') return false;
  std::int64_t ipart = 0;
  for (; i < t.len && t.p[i] >= '0' && t.p[i] <= '9'; ++i)
    ipart = ipart * 10 + (t.p[i] - '0');
  long double fsec = 0.0L;
  if (i < t.len && t.p[i] == '.') {
    ++i;
    if (i >= t.len) return false;  // regex requires >=1 frac digit
    long double fi = 0.0L;
    int nd = 0;
    for (; i < t.len && t.p[i] >= '0' && t.p[i] <= '9'; ++i) {
      fi = fi * 10.0L + (t.p[i] - '0');
      ++nd;
    }
    long double p10 = 1.0L;
    for (int k = 0; k < nd; ++k) p10 *= 10.0L;
    fsec = fi * 86400.0L / p10;
  }
  if (i != t.len) return false;
  std::int64_t d = neg ? -ipart : ipart;
  double s = static_cast<double>(fsec);
  if (neg && s > 0.0) {  // "-1.5" -> (-2, 43200): frac counts away from 0
    d -= 1;
    s = 86400.0 - s;
  }
  *day = d;
  *sec = s;
  return true;
}
}  // namespace

// Returns n_toas (>=0) on success; -1 = caller must use the Python
// parser (stateful command / non-FORMAT-1 line); -2 = a capacity was
// exceeded (caller falls back).  flags blob layout per TOA:
// "key\x1Fvalue\x1Ekey\x1Fvalue..." with flag_off[i]..flag_off[i+1]
// delimiting TOA i (flag_off has n+1 entries).
std::int64_t pt_parse_tim_t2(
    const char* buf, std::int64_t nbytes, std::int64_t* day, double* sec,
    double* freq, double* err, std::int32_t* obs_id, char* obs_tab,
    std::int64_t obs_cap, std::int64_t* obs_tab_len, char* flags,
    std::int64_t flags_cap, std::int64_t* flag_off, std::int64_t* n_bad) {
  constexpr int MAXTOK = 96;
  TimTok tok[MAXTOK];
  // small obs string table (unique sites in one tim file are few)
  constexpr int MAXOBS = 128;
  int obs_start[MAXOBS], obs_len[MAXOBS];
  int n_obs = 0;
  std::int64_t obs_used = 0;
  std::int64_t n = 0, bad = 0, fpos = 0;
  bool format1 = false;
  const char* end = buf + nbytes;
  const char* line = buf;
  while (line < end) {
    // universal-newline line split, matching python text mode:
    // \n, \r\n, and bare \r all terminate a line
    const char* eol = line;
    bool high_byte = false;
    while (eol < end && *eol != '\n' && *eol != '\r') {
      if (static_cast<unsigned char>(*eol) >= 0x80) high_byte = true;
      ++eol;
    }
    const char* next_line = eol + 1;
    if (eol < end && *eol == '\r' && eol + 1 < end && eol[1] == '\n')
      next_line = eol + 2;
    // tokenize
    int ntok = 0;
    const char* p = line;
    while (p < eol && ntok < MAXTOK) {
      while (p < eol && tim_space(*p)) ++p;
      if (p >= eol) break;
      const char* q = p;
      while (q < eol && !tim_space(*q)) ++q;
      tok[ntok].p = p;
      tok[ntok].len = static_cast<int>(q - p);
      ++ntok;
      p = q;
    }
    if (p < eol && ntok >= MAXTOK) return -1;  // pathological line: python owns it
    line = next_line;
    if (ntok == 0) continue;
    // comments: '#', or 'C '/'c ' (needs a second token to mirror
    // python's startswith("C ") on the stripped line). Checked BEFORE
    // the non-ASCII bailout so a unicode comment doesn't forfeit the
    // fast path for the whole file.
    if (tok[0].p[0] == '#') continue;
    if (tok[0].len == 1 && (tok[0].p[0] == 'C' || tok[0].p[0] == 'c') &&
        ntok > 1)
      continue;
    // non-ASCII on a DATA line: python owns the file — str.split()
    // honors unicode whitespace and float() honors unicode digits,
    // neither of which this parser mirrors (detected during the
    // newline scan above, no extra pass)
    if (high_byte) return -1;
    // command dispatch (python: head in _COMMANDS)
    if (tok_is_ci(tok[0], "FORMAT")) {
      if (ntok > 1 && tok[1].len == 1 && tok[1].p[0] == '1') format1 = true;
      continue;
    }
    if (tok_is_ci(tok[0], "MODE") || tok_is_ci(tok[0], "INFO") ||
        tok_is_ci(tok[0], "TRACK"))
      continue;
    if (tok_is_ci(tok[0], "END")) break;
    if (tok_is_ci(tok[0], "INCLUDE") || tok_is_ci(tok[0], "TIME") ||
        tok_is_ci(tok[0], "EFAC") || tok_is_ci(tok[0], "EQUAD") ||
        tok_is_ci(tok[0], "EMIN") || tok_is_ci(tok[0], "EMAX") ||
        tok_is_ci(tok[0], "SKIP") || tok_is_ci(tok[0], "NOSKIP") ||
        tok_is_ci(tok[0], "JUMP") || tok_is_ci(tok[0], "PHASE"))
      return -1;  // stateful: python parser owns these
    // TOA line
    if (!format1) return -1;  // princeton/parkes territory
    if (ntok < 5) {
      ++bad;
      continue;
    }
    double f, e;
    std::int64_t d;
    double s;
    if (!tok_float(tok[1], &f) || !tok_mjd(tok[2], &d, &s) ||
        !tok_float(tok[3], &e)) {
      ++bad;
      continue;
    }
    day[n] = d;
    sec[n] = s;
    freq[n] = f;
    err[n] = e;
    // observatory: lowercase, uniquified into obs_tab
    char site[64];
    if (tok[4].len > 63) return -1;  // absurd site name: python owns it
    int slen = tok[4].len;
    for (int i = 0; i < slen; ++i) {
      char c = tok[4].p[i];
      if (c >= 'A' && c <= 'Z') c += 32;
      site[i] = c;
    }
    int oid = -1;
    for (int i = 0; i < n_obs; ++i) {
      if (obs_len[i] == slen) {
        bool eq = true;
        for (int k = 0; k < slen; ++k)
          if (obs_tab[obs_start[i] + k] != site[k]) {
            eq = false;
            break;
          }
        if (eq) {
          oid = i;
          break;
        }
      }
    }
    if (oid < 0) {
      if (n_obs >= MAXOBS || obs_used + slen + 1 > obs_cap) return -2;
      obs_start[n_obs] = static_cast<int>(obs_used);
      obs_len[n_obs] = slen;
      for (int k = 0; k < slen; ++k) obs_tab[obs_used + k] = site[k];
      obs_tab[obs_used + slen] = '\n';
      obs_used += slen + 1;
      oid = n_obs++;
    }
    obs_id[n] = oid;
    // flags (python: _parse_tempo2_line flag loop + setdefault("name"))
    flag_off[n] = fpos;
    bool have_name = false, first_pair = true;
    int i = 5;
    while (i < ntok) {
      double dummy;
      bool is_flag = tok[i].len > 1 && tok[i].p[0] == '-' &&
                     !tok_float(tok[i], &dummy);
      if (tok[i].len == 1 && tok[i].p[0] == '-') is_flag = true;
      if (!is_flag) {
        ++i;
        continue;
      }
      const char* key = tok[i].p + 1;
      int klen = tok[i].len - 1;
      const char* val = nullptr;
      int vlen = 0;
      if (i + 1 < ntok) {
        bool next_is_flag = tok[i + 1].len >= 1 && tok[i + 1].p[0] == '-' &&
                            !tok_float(tok[i + 1], &dummy);
        if (!next_is_flag) {
          val = tok[i + 1].p;
          vlen = tok[i + 1].len;
          i += 2;
        } else {
          ++i;
        }
      } else {
        ++i;
      }
      if (klen == 4 && key[0] == 'n' && key[1] == 'a' && key[2] == 'm' &&
          key[3] == 'e')
        have_name = true;
      if (fpos + klen + vlen + 2 > flags_cap) return -2;
      if (!first_pair) flags[fpos++] = '\x1e';
      first_pair = false;
      for (int k = 0; k < klen; ++k) flags[fpos++] = key[k];
      flags[fpos++] = '\x1f';
      for (int k = 0; k < vlen; ++k) flags[fpos++] = val[k];
    }
    if (!have_name) {  // python: flags.setdefault("name", parts[0])
      if (fpos + tok[0].len + 7 > flags_cap) return -2;
      if (!first_pair) flags[fpos++] = '\x1e';
      const char nm[] = "name";
      for (int k = 0; k < 4; ++k) flags[fpos++] = nm[k];
      flags[fpos++] = '\x1f';
      for (int k = 0; k < tok[0].len; ++k) flags[fpos++] = tok[0].p[k];
    }
    ++n;
  }
  flag_off[n] = fpos;
  *obs_tab_len = obs_used;
  *n_bad = bad;
  return n;
}

}  // extern "C"
