// Bulk TLE catalog parser of astroz_tpu_torch, bound with ctypes
// (native/__init__.py: parse_catalog) and called by the C ABI
// (c_api.cpp: tle_parse).
//
// Counterpart of astroz_tpu/native/tle_parser.cpp, on the columns of
// tle.py's Python parser: fixed-column line pairs, Alpha-5 satellite
// numbers, the assumed-decimal fields, the epoch as python-sgp4's
// (jd, fr) split with the 57-pivot rule, and 2- or 3-line text with
// CRLF and blank lines. Every field is read as the Python parser reads
// it: a decimal is an exact integer over an exact power of ten (one
// correctly rounded division, as float() rounds), and a field that
// float() or int() would refuse skips the record, as iter_tles skips
// it. So both parsers give the same records and the same columns, bit
// for bit (tests/test_torch_native.py).
//
// C ABI: one call parses a whole catalog into caller-allocated SoA
// column arrays (12 f64 columns + satnum int64), returning the count.

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

constexpr double kTwoPi = 6.283185307179586476925286766559;
constexpr double kDeg2Rad = kTwoPi / 360.0;
constexpr double kXpdotp = 1440.0 / kTwoPi;  // rev/day -> rad/min

// column layout (must match tle.py's TleArrays order)
enum Col {
  kEpochJd = 0, kJdsatepoch, kJdsatepochF, kNoKozai, kEcco, kInclo,
  kNodeo, kArgpo, kMo, kBstar, kNdot, kNddot, kNumCols
};

bool is_digit(char c) { return c >= '0' && c <= '9'; }

// exact powers of ten: an integer mantissa over one of them is one
// correctly rounded division
constexpr double kPow10[16] = {
    1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7,
    1e8, 1e9, 1e10, 1e11, 1e12, 1e13, 1e14, 1e15};

// Fixed-point decimal on a fixed-width field. TLE numeric fields are
// "[spaces][+-][digits][.digits]" — parsed manually so the result is
// locale-independent (strtod honors LC_NUMERIC: under a comma-decimal
// locale every '.nnnn' field would fail and the catalog would silently
// come back empty).
bool parse_f64(const char* s, int len, double* out) {
  int i = 0;
  while (i < len && s[i] == ' ') ++i;
  if (i >= len) return false;
  double sign = 1.0;
  if (s[i] == '+' || s[i] == '-') {
    if (s[i] == '-') sign = -1.0;
    ++i;
  }
  // exact integer mantissa / power of ten: both are exactly
  // representable (TLE fields have <= 12 significant digits), so the
  // single division is correctly rounded — bit-identical to a correct
  // strtod under the C locale
  long long mant = 0;
  int frac = 0;
  bool any = false;
  while (i < len && is_digit(s[i])) {
    mant = mant * 10 + (s[i] - '0');
    any = true;
    ++i;
  }
  if (i < len && s[i] == '.') {
    ++i;
    while (i < len && is_digit(s[i])) {
      mant = mant * 10 + (s[i] - '0');
      ++frac;
      any = true;
      ++i;
    }
  }
  while (i < len && s[i] == ' ') ++i;
  if (!any || i != len) return false;
  double v = (double)mant;
  if (frac > 0) v /= (frac < 16) ? kPow10[frac] : std::pow(10.0, frac);
  *out = sign * v;
  return true;
}

// int() of a field: blanks trimmed, an optional sign, then digits.
bool parse_int(const char* s, int len, long long* out) {
  int a = 0, b = len;
  while (a < b && s[a] == ' ') ++a;
  while (b > a && s[b - 1] == ' ') --b;
  bool neg = false;
  if (a < b && (s[a] == '+' || s[a] == '-')) {
    neg = s[a] == '-';
    ++a;
  }
  if (a == b || b - a > 18) return false;
  long long v = 0;
  for (int i = a; i < b; ++i) {
    if (!is_digit(s[i])) return false;
    v = v * 10 + (s[i] - '0');
  }
  *out = neg ? -v : v;
  return true;
}

// An optional integer field (ephemeris type, element number, revolution
// number): blank is 0, anything else must be an int(); the field ends
// at the end of the line.
bool valid_opt_int(const char* line, int line_len, int from, int to) {
  if (to > line_len) to = line_len;
  if (from >= to) return true;
  int a = from, b = to;
  while (a < b && line[a] == ' ') ++a;
  long long v;
  return a == b || parse_int(line + from, to - from, &v);
}

// Alpha-5: leading letter encodes 10..33 (I and O skipped)
bool parse_satnum(const char* s, long long* out) {
  int a = 0;
  while (a < 5 && s[a] == ' ') ++a;
  if (a == 5) return false;
  char c = s[a];
  if (!std::isalpha((unsigned char)c)) return parse_int(s, 5, out);
  c = (char)std::toupper((unsigned char)c);
  if (c == 'I' || c == 'O') return false;
  int hi = c - 'A' + 10;
  if (c > 'I') --hi;
  if (c > 'O') --hi;
  long long rest = 0;
  if (!parse_int(s + a + 1, 4 - a, &rest)) return false;
  *out = (long long)hi * 10000 + rest;
  return true;
}

// float("0." + digits) of a digits-only field (blanks trimmed; blank is
// 0): the digits as an integer over 10^count.
bool parse_fraction(const char* s, int len, double* out) {
  int a = 0, b = len;
  while (a < b && s[a] == ' ') ++a;
  while (b > a && s[b - 1] == ' ') --b;
  if (b - a > 15) return false;
  long long mant = 0;
  for (int k = a; k < b; ++k) {
    if (!is_digit(s[k])) return false;
    mant = mant * 10 + (s[k] - '0');
  }
  *out = (double)mant / kPow10[b - a];
  return true;
}

// TLE "assumed decimal point" field like " 11606-4" -> 0.11606e-4, as
// tle.py's _parse_implied_decimal reads it: an optional leading sign,
// the last sign after it starts the exponent, and the value is
// sign * 0.<mantissa> * 10.0 ** exponent (pow, as Python's float **).
bool parse_implied_decimal(const char* s, int len, double* out) {
  int a = 0, b = len;
  while (a < b && s[a] == ' ') ++a;
  while (b > a && s[b - 1] == ' ') --b;
  *out = 0.0;
  if (a == b) return true;
  double sign = 1.0;
  if (s[a] == '+' || s[a] == '-') {
    if (s[a] == '-') sign = -1.0;
    ++a;
  }
  long long expv = 0;
  int mant_end = b;
  for (int k = b - 1; k >= a; --k) {
    if (s[k] == '+' || s[k] == '-') {
      if (!parse_int(s + k, b - k, &expv)) return false;
      if (!is_digit(s[k + 1])) return false;  // int() takes no blank here
      mant_end = k;
      break;
    }
  }
  int m = a;
  while (m < mant_end && s[m] == ' ') ++m;
  if (m == mant_end) return true;  // blank mantissa: 0.0, unsigned
  double mant;
  if (!parse_fraction(s + a, mant_end - a, &mant)) return false;
  *out = sign * mant * std::pow(10.0, (double)expv);
  return true;
}

bool leap(int y) { return (y % 4 == 0 && y % 100 != 0) || y % 400 == 0; }

const int kDim[12] = {31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31};

void doy_to_md(int year, int doy, int* mon, int* day) {
  int rem = doy;
  int m = 1;
  for (int i = 0; i < 12; ++i) {
    int d = kDim[i] + ((i == 1 && leap(year)) ? 1 : 0);
    if (rem <= d) break;
    rem -= d;
    ++m;
  }
  *mon = m;
  *day = rem;
}

// python-sgp4 jday convention: jd at midnight (half-integer) + fraction
void epoch_to_jd(int epochyr, double epochdays, double* jd, double* fr) {
  int year = epochyr + (epochyr >= 57 ? 1900 : 2000);
  int doy = (int)epochdays;
  double dayfrac = epochdays - doy;
  int mon, day;
  doy_to_md(year, doy, &mon, &day);
  double hours = dayfrac * 24.0;
  int hr = (int)hours;
  double minutes = (hours - hr) * 60.0;
  int mi = (int)minutes;
  double sec = (minutes - mi) * 60.0;
  *jd = 367.0 * year -
        std::floor(7.0 * (year + std::floor((mon + 9) / 12.0)) * 0.25) +
        std::floor(275.0 * mon / 9.0) + day + 1721013.5;
  *fr = (sec + mi * 60.0 + hr * 3600.0) / 86400.0;
}

struct Line {
  const char* p;
  int len;
};

// next non-empty line; trims CR and leading/trailing spaces
bool next_line(const char** cur, const char* end, Line* out) {
  while (*cur < end) {
    const char* nl = (const char*)std::memchr(*cur, '\n', end - *cur);
    const char* stop = nl ? nl : end;
    const char* a = *cur;
    const char* b = stop;
    while (a < b && (a[0] == ' ' || a[0] == '\t')) ++a;
    while (b > a && (b[-1] == '\r' || b[-1] == ' ' || b[-1] == '\t')) --b;
    *cur = nl ? nl + 1 : end;
    if (b > a) {
      out->p = a;
      out->len = (int)(b - a);
      return true;
    }
  }
  return false;
}

bool is_tle_line(const Line& l, char which) {
  return l.len >= 64 && l.p[0] == which && l.p[1] == ' ';
}

}  // namespace

extern "C" {

// Parse a TLE/3LE catalog. Columns are written SoA: cols[c*stride + i].
// Returns the number of satellites parsed (<= max_sats); invalid pairs
// are skipped (reference MultiIterator tolerance, Tle.zig:103-132).
int astroz_parse_catalog(const char* text, long long text_len,
                         double* cols, long long* satnums,
                         long long stride, long long max_sats) {
  const char* cur = text;
  const char* end = text + text_len;
  long long n = 0;
  Line l1{nullptr, 0};
  Line line;
  while (n < max_sats && next_line(&cur, end, &line)) {
    if (is_tle_line(line, '1')) {
      l1 = line;
      continue;
    }
    if (!is_tle_line(line, '2') || l1.p == nullptr) {
      l1 = {nullptr, 0};
      continue;
    }
    const char* a = l1.p;
    const int a_len = l1.len;
    const char* b = line.p;
    l1 = {nullptr, 0};

    long long sn1, sn2;
    if (!parse_satnum(a + 2, &sn1) || !parse_satnum(b + 2, &sn2)) continue;
    if (sn1 != sn2) continue;

    long long epochyr;
    double epochdays, ndot, inclo, nodeo, argpo, mo, no_kozai;
    if (!parse_int(a + 18, 2, &epochyr)) continue;
    if (!parse_f64(a + 20, 12, &epochdays)) continue;
    if (!parse_f64(a + 33, 10, &ndot)) continue;
    double nddot, bstar;
    if (!parse_implied_decimal(a + 44, 8, &nddot)) continue;
    if (!parse_implied_decimal(a + 53, 8, &bstar)) continue;
    if (!(a[62] == ' ' || is_digit(a[62]))) continue;
    if (!valid_opt_int(a, a_len, 64, 68)) continue;

    if (!parse_f64(b + 8, 8, &inclo)) continue;
    if (!parse_f64(b + 17, 8, &nodeo)) continue;
    double ecco;
    if (!parse_fraction(b + 26, 7, &ecco)) continue;
    if (!parse_f64(b + 34, 8, &argpo)) continue;
    if (!parse_f64(b + 43, 8, &mo)) continue;
    if (!parse_f64(b + 52, 11, &no_kozai)) continue;
    if (!valid_opt_int(b, line.len, 63, 68)) continue;

    double jd, fr;
    epoch_to_jd((int)epochyr, epochdays, &jd, &fr);

    satnums[n] = sn1;
    cols[kEpochJd * stride + n] = jd + fr;
    cols[kJdsatepoch * stride + n] = jd;
    cols[kJdsatepochF * stride + n] = fr;
    cols[kNoKozai * stride + n] = no_kozai / kXpdotp;
    cols[kEcco * stride + n] = ecco;
    cols[kInclo * stride + n] = inclo * kDeg2Rad;
    cols[kNodeo * stride + n] = nodeo * kDeg2Rad;
    cols[kArgpo * stride + n] = argpo * kDeg2Rad;
    cols[kMo * stride + n] = mo * kDeg2Rad;
    cols[kBstar * stride + n] = bstar;
    cols[kNdot * stride + n] = ndot / (kXpdotp * 1440.0);
    cols[kNddot * stride + n] = nddot / (kXpdotp * 1440.0 * 1440.0);
    ++n;
  }
  return (int)n;
}

int astroz_native_version() { return 1; }

}  // extern "C"
