// Native AMBER ASCII (mdcrd) fixed-width float decoder.
//
// The classic AMBER text trajectory stores every value as an 8-character
// fixed-width F8.3 field, 10 per line (TrajObject.py:33 in the reference
// reads it through pytraj's compiled cpptraj stack). The pure-numpy reader
// in waterorderlib_tpu/io/mdcrd.py decodes via `S8 -> astype(float32)`,
// which walks a per-element strtod loop at ~60 MB/s — slower than the device
// analysis pipeline consumes frames. This decoder streams the byte body
// once, parsing each 8-char field with integer arithmetic, and is
// bit-identical to strtod for fixed-point fields:
//
//   value = (+/-) mantissa / 10^ndec
//
// with an exact int64 mantissa and an exact power-of-ten double, so the
// IEEE division returns the correctly-rounded double — the same double
// strtod produces — before the final float32 cast.
//
// Any field the fast path cannot prove exact (scientific notation, '*'
// overflow stars, >15 digits) aborts with a negative code and the Python
// caller falls back to the numpy path.
//
// Build: g++ -O3 -shared -fPIC -o libmdcrd.so mdcrdlib.cc
//
// Protocol: f8_decode(data, nbytes, out, capacity) -> n_values (or <0):
//   data/nbytes: raw file body (newlines included, title line excluded)
//   out/capacity: caller-allocated float32 buffer
//   -1 unexpected character, -2 capacity exceeded, -3 trailing partial
//   field, -4 malformed field (no digits / bad layout).

#include <cstdint>
#include <cstring>

namespace {

const double kPow10[16] = {1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,
                           1e8,  1e9,  1e10, 1e11, 1e12, 1e13, 1e14, 1e15};

// Fast path for the canonical F8.3 shape "[spaces][-]d+.ddd" with the dot
// at index 4 (every value sander/pmemd/write_mdcrd emit looks like this).
inline bool parse_f83(const char* p, float* out) {
  if (p[4] != '.') return false;
  int i = 0;
  while (i < 4 && p[i] == ' ') ++i;
  if (i == 4) return false;
  bool neg = false;
  if (p[i] == '-' || p[i] == '+') {
    neg = p[i] == '-';
    if (++i == 4) return false;
  }
  int32_t ip = 0;
  for (; i < 4; ++i) {
    const unsigned d = static_cast<unsigned>(p[i]) - '0';
    if (d > 9) return false;
    ip = ip * 10 + static_cast<int32_t>(d);
  }
  const unsigned d5 = static_cast<unsigned>(p[5]) - '0';
  const unsigned d6 = static_cast<unsigned>(p[6]) - '0';
  const unsigned d7 = static_cast<unsigned>(p[7]) - '0';
  if (d5 > 9 || d6 > 9 || d7 > 9) return false;
  const int32_t mant = ip * 1000 + static_cast<int32_t>(d5 * 100 + d6 * 10 + d7);
  const double v = static_cast<double>(mant) / 1000.0;
  *out = static_cast<float>(neg ? -v : v);
  return true;
}

// Parse one 8-char field (visible chars only). Returns false on anything
// that is not "[spaces][+|-]digits[.digits][spaces]".
inline bool parse_field(const char* p, float* out) {
  if (parse_f83(p, out)) return true;
  int i = 0;
  while (i < 8 && (p[i] == ' ' || p[i] == '\t')) ++i;
  if (i == 8) return false;  // blank field
  bool neg = false;
  if (p[i] == '-' || p[i] == '+') {
    neg = p[i] == '-';
    ++i;
  }
  int64_t mant = 0;
  int ndig = 0, ndec = 0;
  bool seen_dot = false;
  for (; i < 8; ++i) {
    const char c = p[i];
    if (c >= '0' && c <= '9') {
      mant = mant * 10 + (c - '0');
      ++ndig;
      if (seen_dot) ++ndec;
    } else if (c == '.' && !seen_dot) {
      seen_dot = true;
    } else if (c == ' ') {
      // trailing spaces only
      for (; i < 8; ++i)
        if (p[i] != ' ') return false;
      break;
    } else {
      return false;  // 'E', '*', second '.', etc.
    }
  }
  if (ndig == 0 || ndig > 15) return false;
  const double v = static_cast<double>(mant) / kPow10[ndec];
  *out = static_cast<float>(neg ? -v : v);
  return true;
}

}  // namespace

extern "C" long f8_decode(const char* data, long nbytes, float* out,
                          long capacity) {
  char field[8];
  int have = 0;  // carried bytes of a field split across line boundaries
  long n_out = 0;
  long i = 0;
  while (i < nbytes) {
    const char* nl =
        static_cast<const char*>(std::memchr(data + i, '\n', nbytes - i));
    long seg_end = nl ? (nl - data) : nbytes;
    if (seg_end > i && data[seg_end - 1] == '\r') --seg_end;
    // finish a carried field first (only when a line breaks mid-field)
    if (have != 0) {
      for (; have < 8 && i < seg_end; ++have, ++i) field[have] = data[i];
      if (have == 8) {
        have = 0;
        if (n_out >= capacity) return -2;
        if (!parse_field(field, &out[n_out])) return -4;
        ++n_out;
      }
    }
    // bulk: whole 8-byte fields straight from the segment
    const long n_fields = (seg_end - i) / 8;
    if (n_out + n_fields > capacity) return -2;
    for (long k = 0; k < n_fields; ++k, i += 8)
      if (!parse_field(data + i, &out[n_out + k])) return -4;
    n_out += n_fields;
    // stash any trailing partial field (< 8 bytes by construction)
    for (; i < seg_end; ++i) {
      if (have >= 8) return -4;
      field[have++] = data[i];
    }
    i = nl ? (nl - data) + 1 : nbytes;
  }
  if (have != 0) return -3;
  return n_out;
}
