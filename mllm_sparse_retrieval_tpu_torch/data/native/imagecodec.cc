// Image file decoding on the host: JPEG (baseline, extended and
// progressive Huffman, 8-bit) and the pixel half of PNG (unfiltering and
// the conversion to RGB; the Python side parses the chunks and inflates).
//
// The result is the RGB image that Pillow gives for
// Image.open(f).convert("RGB") with libjpeg-turbo's decoding defaults:
// the accurate integer IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2),
// fancy upsampling (jdsample.c h2v1 / h1v2 / h2v2 triangle filters, other
// integral ratios replicated; merged upsampling is not used with fancy
// upsampling on), the fixed-point YCbCr->RGB tables of jdcolor.c
// (SCALEBITS 16), YCCK->CMYK the same way, and Pillow's inverted-CMYK
// ("CMYK;I") conversion to RGB. No EXIF orientation is applied.
//
// C interface (ctypes): every function returns 0 on success, or a
// negative code with a message in err: -1 unsupported feature, -2
// truncated stream, -3 corrupt stream.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Code { kUnsupported = -1, kTruncated = -2, kCorrupt = -3 };

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) {
  throw Fail{code, msg};
}

// zigzag index -> natural index, padded so a corrupt run past 63 lands on
// 63 as libjpeg's jpeg_natural_order does
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- Huffman

const int kLookBits = 9;

struct Huff {
  bool defined = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoff[18];
  uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer code
};

// jdhuff.c jpeg_make_d_derived_tbl
void build_huff(Huff& h, const uint8_t* counts, const uint8_t* vals,
                bool is_dc) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; l++) {
    int n = counts[l - 1];
    if (p + n > 256) fail(kCorrupt, "bad Huffman table");
    while (n--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) {
      huffcode[p++] = code;
      code++;
    }
    if (code >= (1u << si)) fail(kCorrupt, "bad Huffman table");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (counts[l - 1]) {
      h.valoff[l] = p - (int32_t)huffcode[p];
      p += counts[l - 1];
      h.maxcode[l] = (int32_t)huffcode[p - 1];
    } else {
      h.maxcode[l] = -1;
    }
  }
  h.valoff[17] = 0;
  h.maxcode[17] = 0xFFFFF;
  std::memset(h.look, 0, sizeof(h.look));
  p = 0;
  for (int l = 1; l <= kLookBits; l++) {
    for (int i = 1; i <= counts[l - 1]; i++, p++) {
      int lookbits = (int)(huffcode[p] << (kLookBits - l));
      for (int ctr = 1 << (kLookBits - l); ctr > 0; ctr--)
        h.look[lookbits++] = (uint16_t)((l << 8) | vals[p]);
    }
  }
  std::memcpy(h.vals, vals, numsymbols);
  if (is_dc) {
    for (int i = 0; i < numsymbols; i++)
      if (vals[i] > 15) fail(kCorrupt, "bad DC Huffman table");
  }
  h.defined = true;
}

// ------------------------------------------------------------ bit reader

struct Bits {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int nbits = 0;
  bool at_marker = false;  // a marker ends the data: zeros follow

  // Top up to at least 57 bits. Past a marker, zero bits are supplied
  // (libjpeg's rule for a scan that asks for more bits than it holds);
  // running off the end of the file without a marker is a truncation.
  void fill() {
    while (nbits <= 56) {
      uint32_t b = 0;
      if (!at_marker) {
        if (p >= end) fail(kTruncated, "truncated JPEG data");
        b = *p;
        if (b == 0xFF) {
          const uint8_t* q = p + 1;
          while (q < end && *q == 0xFF) q++;
          if (q >= end) fail(kTruncated, "truncated JPEG data");
          if (*q == 0) {
            p = q + 1;
          } else {
            at_marker = true;  // p stays on the marker's first 0xFF
            b = 0;
          }
        } else {
          p++;
        }
      }
      buf |= (uint64_t)b << (56 - nbits);
      nbits += 8;
    }
  }

  inline int get(int n) {  // n in 1..16
    if (nbits < n) fill();
    int v = (int)(buf >> (64 - n));
    buf <<= n;
    nbits -= n;
    return v;
  }

  inline int bit() { return get(1); }

  inline int decode(const Huff& h) {
    if (nbits < 16) fill();
    int v = h.look[buf >> (64 - kLookBits)];
    if (v) {
      int len = v >> 8;
      buf <<= len;
      nbits -= len;
      return v & 0xFF;
    }
    for (int l = kLookBits + 1; l <= 16; l++) {
      int32_t code = (int32_t)(buf >> (64 - l));
      if (code <= h.maxcode[l]) {
        buf <<= l;
        nbits -= l;
        return h.vals[(code + h.valoff[l]) & 0xFF];
      }
    }
    fail(kCorrupt, "corrupt JPEG data: bad Huffman code");
  }

  // discard buffered bits (end of a restart interval or of a scan)
  void reset() {
    buf = 0;
    nbits = 0;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ---------------------------------------------------------------- frame

struct Comp {
  int id = 0, h = 1, v = 1, tq = 0;
  int dw = 0, dh = 0;      // downsampled width and height
  int wb = 0, hb = 0;      // blocks that hold the component's samples
  int bw = 0, bh = 0;      // blocks of the padded MCU grid
  std::vector<int16_t> coef;
  uint16_t q[64];
  bool q_latched = false;
  int coef_bits[64];
  std::vector<uint8_t> plane;  // (wb * 8) x (hb * 8) samples
};

struct Jpeg {
  const uint8_t* data;
  size_t n;
  size_t pos = 0;
  bool have_frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  Comp comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = -1;
  int eobrun = 0;
  long max_pixels = 0;  // larger frames are refused before any allocation
};

inline int u16(const uint8_t* p) { return (p[0] << 8) | p[1]; }

// the next marker byte at or after pos (skipping any bytes that are not
// a marker, as libjpeg's next_marker does)
int next_marker(Jpeg& j) {
  for (;;) {
    while (j.pos < j.n && j.data[j.pos] != 0xFF) j.pos++;
    if (j.pos >= j.n) fail(kTruncated, "truncated JPEG: no EOI marker");
    while (j.pos < j.n && j.data[j.pos] == 0xFF) j.pos++;
    if (j.pos >= j.n) fail(kTruncated, "truncated JPEG: no EOI marker");
    int m = j.data[j.pos++];
    if (m != 0) return m;
  }
}

// a marker segment's payload: [pos, pos + len - 2)
const uint8_t* segment(Jpeg& j, int* len) {
  if (j.pos + 2 > j.n) fail(kTruncated, "truncated JPEG marker segment");
  int l = u16(j.data + j.pos);
  if (l < 2) fail(kCorrupt, "bad JPEG marker length");
  if (j.pos + l > j.n) fail(kTruncated, "truncated JPEG marker segment");
  const uint8_t* s = j.data + j.pos + 2;
  j.pos += l;
  *len = l - 2;
  return s;
}

void read_sof(Jpeg& j, int marker) {
  int len;
  const uint8_t* s = segment(j, &len);
  if (j.have_frame) fail(kCorrupt, "JPEG with two frames");
  if (len < 6) fail(kCorrupt, "bad JPEG frame header");
  int precision = s[0];
  j.height = u16(s + 1);
  j.width = u16(s + 3);
  j.ncomp = s[5];
  if (precision != 8)
    fail(kUnsupported, std::to_string(precision) + "-bit JPEG samples");
  if (j.height == 0)
    fail(kUnsupported, "JPEG whose height is set by a DNL marker");
  if (j.width == 0) fail(kCorrupt, "JPEG of width 0");
  if (j.ncomp != 1 && j.ncomp != 3 && j.ncomp != 4)
    fail(kUnsupported, "JPEG with " + std::to_string(j.ncomp) +
                           " components");
  if (len != 6 + 3 * j.ncomp) fail(kCorrupt, "bad JPEG frame header");
  if ((long)j.width * j.height > j.max_pixels)
    fail(kUnsupported, std::to_string(j.width) + " x " +
                           std::to_string(j.height) +
                           " pixels exceed the limit of " +
                           std::to_string(j.max_pixels));
  j.progressive = marker == 0xC2;
  for (int i = 0; i < j.ncomp; i++) {
    Comp& c = j.comp[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i];
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
      fail(kCorrupt, "bad JPEG sampling factors or table");
    j.hmax = std::max(j.hmax, c.h);
    j.vmax = std::max(j.vmax, c.v);
  }
  j.mcux = (j.width + 8 * j.hmax - 1) / (8 * j.hmax);
  j.mcuy = (j.height + 8 * j.vmax - 1) / (8 * j.vmax);
  for (int i = 0; i < j.ncomp; i++) {
    Comp& c = j.comp[i];
    if (j.hmax % c.h || j.vmax % c.v)
      fail(kUnsupported, "JPEG with fractional sampling ratios");
    c.dw = (int)(((long)j.width * c.h + j.hmax - 1) / j.hmax);
    c.dh = (int)(((long)j.height * c.v + j.vmax - 1) / j.vmax);
    c.wb = (c.dw + 7) / 8;
    c.hb = (c.dh + 7) / 8;
    c.bw = j.mcux * c.h;
    c.bh = j.mcuy * c.v;
    for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
  }
  j.have_frame = true;
}

void read_dht(Jpeg& j) {
  int len;
  const uint8_t* s = segment(j, &len);
  int i = 0;
  while (i < len) {
    if (i + 17 > len) fail(kCorrupt, "bad JPEG Huffman table");
    int tc = s[i] >> 4, th = s[i] & 15;
    if (tc > 1 || th > 3) fail(kCorrupt, "bad JPEG Huffman table");
    const uint8_t* counts = s + i + 1;
    int total = 0;
    for (int l = 0; l < 16; l++) total += counts[l];
    if (total > 256 || i + 17 + total > len)
      fail(kCorrupt, "bad JPEG Huffman table");
    build_huff(tc ? j.ac[th] : j.dc[th], counts, s + i + 17, tc == 0);
    i += 17 + total;
  }
}

void read_dqt(Jpeg& j) {
  int len;
  const uint8_t* s = segment(j, &len);
  int i = 0;
  while (i < len) {
    int pq = s[i] >> 4, tq = s[i] & 15;
    if (tq > 3 || pq > 1) fail(kCorrupt, "bad JPEG quantization table");
    int need = 1 + 64 * (pq + 1);
    if (i + need > len) fail(kCorrupt, "bad JPEG quantization table");
    for (int k = 0; k < 64; k++) {
      int v = pq ? u16(s + i + 1 + 2 * k) : s[i + 1 + k];
      j.qt[tq][kNatural[k]] = (uint16_t)v;
    }
    j.qt_defined[tq] = true;
    i += need;
  }
}

void read_app(Jpeg& j, int marker) {
  int len;
  const uint8_t* s = segment(j, &len);
  // jdmarker.c examine_app0 / examine_app14
  if (marker == 0xE0 && len >= 14 && std::memcmp(s, "JFIF\0", 5) == 0)
    j.jfif = true;
  if (marker == 0xEE && len >= 12 && std::memcmp(s, "Adobe", 5) == 0) {
    j.adobe = true;
    j.adobe_transform = s[11];
  }
}

// ----------------------------------------------------------- scan decode

struct Scan {
  int ns = 0;
  int ci[4];
  int td[4], ta[4];
  int ss = 0, se = 63, ah = 0, al = 0;
};

inline int16_t* block_at(Comp& c, int by, int bx) {
  return &c.coef[((size_t)by * c.bw + bx) * 64];
}

void decode_block(Jpeg& j, Bits& b, const Scan& sc, int k_in_scan,
                  int16_t* blk, int* dc_pred) {
  const Huff& dct = j.dc[sc.td[k_in_scan]];
  const Huff& act = j.ac[sc.ta[k_in_scan]];
  if (!j.progressive) {
    int s = b.decode(dct);
    int diff = s ? extend(b.get(s), s) : 0;
    *dc_pred += diff;
    blk[0] = (int16_t)*dc_pred;
    for (int k = 1; k < 64; k++) {
      int rs = b.decode(act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        int v = extend(b.get(s), s);
        blk[kNatural[k]] = (int16_t)v;
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return;
  }
  // progressive (jdphuff.c)
  if (sc.ss == 0) {
    if (sc.ah == 0) {
      int s = b.decode(dct);
      int diff = s ? extend(b.get(s), s) : 0;
      *dc_pred += diff;
      blk[0] = (int16_t)((unsigned)*dc_pred << sc.al);
    } else {
      if (b.bit()) blk[0] = (int16_t)(blk[0] | (1 << sc.al));
    }
    return;
  }
  if (sc.ah == 0) {  // AC first
    if (j.eobrun > 0) {
      j.eobrun--;
      return;
    }
    for (int k = sc.ss; k <= sc.se; k++) {
      int rs = b.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        int v = extend(b.get(s), s);
        blk[kNatural[k]] = (int16_t)((unsigned)v << sc.al);
      } else {
        if (r == 15) {
          k += 15;
        } else {
          j.eobrun = 1 << r;
          if (r) j.eobrun += b.get(r);
          j.eobrun--;
          break;
        }
      }
    }
    return;
  }
  // AC refinement
  int p1 = 1 << sc.al;
  int m1 = -1 * (1 << sc.al);
  int k = sc.ss;
  if (j.eobrun == 0) {
    for (; k <= sc.se; k++) {
      int rs = b.decode(act);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        s = b.bit() ? p1 : m1;
      } else if (r != 15) {
        j.eobrun = 1 << r;
        if (r) j.eobrun += b.get(r);
        break;
      }
      do {
        int16_t* c = &blk[kNatural[k]];
        if (*c != 0) {
          if (b.bit()) {
            if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
          }
        } else {
          if (--r < 0) break;
        }
        k++;
      } while (k <= sc.se);
      if (s) blk[kNatural[k]] = (int16_t)s;
    }
  }
  if (j.eobrun > 0) {
    for (; k <= sc.se; k++) {
      int16_t* c = &blk[kNatural[k]];
      if (*c != 0) {
        if (b.bit()) {
          if ((*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c + m1);
        }
      }
    }
    j.eobrun--;
  }
}

// consume the RSTn that must follow a restart interval
void read_restart(Jpeg& j, Bits& b, int expect) {
  b.reset();
  j.pos = (size_t)(b.p - j.data);
  int m = next_marker(j);
  if (m != 0xD0 + expect)
    fail(kCorrupt, "corrupt JPEG data: missing restart marker");
  b.p = j.data + j.pos;
  b.at_marker = false;
}

void read_sos(Jpeg& j) {
  int len;
  const uint8_t* s = segment(j, &len);
  if (!j.have_frame) fail(kCorrupt, "JPEG scan before its frame header");
  if (j.comp[0].coef.empty())  // the first scan: a header alone allocates nothing
    for (int i = 0; i < j.ncomp; i++) {
      Comp& c = j.comp[i];
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
  Scan sc;
  sc.ns = s[0];
  if (sc.ns < 1 || sc.ns > 4 || len != 4 + 2 * sc.ns)
    fail(kCorrupt, "bad JPEG scan header");
  for (int i = 0; i < sc.ns; i++) {
    int id = s[1 + 2 * i], t = s[2 + 2 * i];
    int found = -1;
    for (int c = 0; c < j.ncomp; c++)
      if (j.comp[c].id == id) found = c;
    if (found < 0) fail(kCorrupt, "JPEG scan names an unknown component");
    sc.ci[i] = found;
    sc.td[i] = t >> 4;
    sc.ta[i] = t & 15;
    if (sc.td[i] > 3 || sc.ta[i] > 3) fail(kCorrupt, "bad JPEG scan header");
  }
  const uint8_t* t = s + 1 + 2 * sc.ns;
  sc.ss = t[0];
  sc.se = t[1];
  sc.ah = t[2] >> 4;
  sc.al = t[2] & 15;
  if (j.progressive) {
    // jdphuff.c start_pass_phuff_decoder's checks
    bool bad = false;
    if (sc.ss == 0) {
      if (sc.se != 0) bad = true;
    } else {
      if (sc.se < sc.ss || sc.se > 63 || sc.ns != 1) bad = true;
    }
    if (sc.ah != 0 && sc.al != sc.ah - 1) bad = true;
    if (sc.al > 13) bad = true;
    if (bad) fail(kCorrupt, "bad progressive JPEG scan parameters");
    for (int i = 0; i < sc.ns; i++) {
      int* cb = j.comp[sc.ci[i]].coef_bits;
      if (sc.ss != 0 && cb[0] < 0)
        fail(kCorrupt, "progressive JPEG: AC scan before its DC scan");
      for (int k = sc.ss; k <= sc.se; k++) {
        int expected = cb[k] < 0 ? 0 : cb[k];
        if (sc.ah != expected)
          fail(kCorrupt, "bad progressive JPEG successive approximation");
        cb[k] = sc.al;
      }
    }
  } else if (sc.ss != 0 || sc.se != 63 || sc.ah != 0 || sc.al != 0) {
    fail(kCorrupt, "bad sequential JPEG scan parameters");
  }
  for (int i = 0; i < sc.ns; i++) {
    Comp& c = j.comp[sc.ci[i]];
    bool need_dc = !j.progressive || (sc.ss == 0 && sc.ah == 0);
    bool need_ac = !j.progressive || sc.ss != 0;
    if (need_dc && !j.dc[sc.td[i]].defined)
      fail(kUnsupported, "JPEG without its Huffman tables (motion JPEG)");
    if (need_ac && !j.ac[sc.ta[i]].defined)
      fail(kUnsupported, "JPEG without its Huffman tables (motion JPEG)");
    if (!c.q_latched) {  // jdinput.c latch_quant_tables
      if (!j.qt_defined[c.tq])
        fail(kCorrupt, "JPEG without its quantization table");
      std::memcpy(c.q, j.qt[c.tq], sizeof(c.q));
      c.q_latched = true;
    }
  }

  Bits b;
  b.p = j.data + j.pos;
  b.end = j.data + j.n;
  int dc_pred[4] = {0, 0, 0, 0};
  j.eobrun = 0;
  int restarts_to_go = j.restart_interval;
  int next_rst = 0;
  auto before_mcu = [&]() {
    if (!j.restart_interval) return;
    if (restarts_to_go == 0) {
      read_restart(j, b, next_rst);
      next_rst = (next_rst + 1) & 7;
      for (int i = 0; i < 4; i++) dc_pred[i] = 0;
      j.eobrun = 0;
      restarts_to_go = j.restart_interval;
    }
    restarts_to_go--;
  };
  if (sc.ns == 1) {
    Comp& c = j.comp[sc.ci[0]];
    for (int by = 0; by < c.hb; by++)
      for (int bx = 0; bx < c.wb; bx++) {
        before_mcu();
        decode_block(j, b, sc, 0, block_at(c, by, bx), &dc_pred[0]);
      }
  } else {
    for (int my = 0; my < j.mcuy; my++)
      for (int mx = 0; mx < j.mcux; mx++) {
        before_mcu();
        for (int i = 0; i < sc.ns; i++) {
          Comp& c = j.comp[sc.ci[i]];
          for (int v = 0; v < c.v; v++)
            for (int h = 0; h < c.h; h++)
              decode_block(j, b, sc, i,
                           block_at(c, my * c.v + v, mx * c.h + h),
                           &dc_pred[i]);
        }
      }
  }
  // resume at the marker that ends the scan
  j.pos = (size_t)(b.p - j.data);
}

// ------------------------------------------------------------ pixels

uint8_t g_idct_limit[1024];  // jdmaster.c prepare_range_limit_table
uint8_t g_limit_storage[256 * 3];
const uint8_t* g_limit = g_limit_storage + 256;  // clamp of [-256, 511]
int g_cr_r[256], g_cb_b[256];
int32_t g_cr_g[256], g_cb_g[256];

struct TablesInit {
  TablesInit() {
    for (int x = 0; x < 1024; x++) {
      // index: the descaled sample without its level shift, & 1023
      int v = x < 512 ? x : x - 1024;
      v += 128;
      g_idct_limit[x] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
    for (int i = -256; i < 512; i++)
      g_limit_storage[i + 256] = (uint8_t)(i < 0 ? 0 : i > 255 ? 255 : i);
    const int kScale = 16;
    const int32_t kHalf = 1 << (kScale - 1);
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      g_cr_r[i] = (int)((fix(1.40200) * x + kHalf) >> kScale);
      g_cb_b[i] = (int)((fix(1.77200) * x + kHalf) >> kScale);
      g_cr_g[i] = -fix(0.71414) * x;
      g_cb_g[i] = -fix(0.34414) * x + kHalf;
    }
  }
} g_tables_init;

// jidctint.c jpeg_idct_islow. Samples past the clamp range clamp (the
// SIMD code saturates where the C code would wrap; both agree on
// [-512, 511], which holds every sample an encoder writes).
void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
  const int32_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270,
                F0_899 = 7373, F1_175 = 9633, F1_501 = 12299,
                F1_847 = 15137, F1_961 = 16069, F2_053 = 16819,
                F2_562 = 20995, F3_072 = 25172;
  const int kConst = 13, kPass1 = 2;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
        ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
      int dc = (int)((int32_t)ip[0] * qp[0]) * (1 << kPass1);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int32_t)ip[16] * qp[16], z3 = (int32_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = (int32_t)ip[0] * qp[0];
    z3 = (int32_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConst);
    int64_t tmp1 = (z2 - z3) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int32_t)ip[56] * qp[56];
    tmp1 = (int32_t)ip[40] * qp[40];
    tmp2 = (int32_t)ip[24] * qp[24];
    tmp3 = (int32_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = kConst - kPass1;
    const int64_t rnd = (int64_t)1 << (sh - 1);
    wp[0] = (int)((tmp10 + tmp3 + rnd) >> sh);
    wp[56] = (int)((tmp10 - tmp3 + rnd) >> sh);
    wp[8] = (int)((tmp11 + tmp2 + rnd) >> sh);
    wp[48] = (int)((tmp11 - tmp2 + rnd) >> sh);
    wp[16] = (int)((tmp12 + tmp1 + rnd) >> sh);
    wp[40] = (int)((tmp12 - tmp1 + rnd) >> sh);
    wp[24] = (int)((tmp13 + tmp0 + rnd) >> sh);
    wp[32] = (int)((tmp13 - tmp0 + rnd) >> sh);
  }
  auto clamp = [](int64_t x) -> uint8_t {
    // the SIMD path's saturation outside [-512, 511]
    if (x < -512) x = -512;
    if (x > 511) x = 511;
    return g_idct_limit[(int)x & 1023];
  };
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int sh = kConst + kPass1 + 3;
    const int64_t rnd = (int64_t)1 << (sh - 1);
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 &&
        wp[6] == 0 && wp[7] == 0) {
      uint8_t dc = clamp(((int64_t)wp[0] + (1 << (kPass1 + 2))) >>
                         (kPass1 + 3));
      std::memset(op, dc, 8);
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << kConst);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << kConst);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = clamp((tmp10 + tmp3 + rnd) >> sh);
    op[7] = clamp((tmp10 - tmp3 + rnd) >> sh);
    op[1] = clamp((tmp11 + tmp2 + rnd) >> sh);
    op[6] = clamp((tmp11 - tmp2 + rnd) >> sh);
    op[2] = clamp((tmp12 + tmp1 + rnd) >> sh);
    op[5] = clamp((tmp12 - tmp1 + rnd) >> sh);
    op[3] = clamp((tmp13 + tmp0 + rnd) >> sh);
    op[4] = clamp((tmp13 - tmp0 + rnd) >> sh);
  }
}

void component_plane(Comp& c) {
  int stride = c.wb * 8;
  c.plane.assign((size_t)stride * c.hb * 8, 0);
  for (int by = 0; by < c.hb; by++)
    for (int bx = 0; bx < c.wb; bx++)
      idct_islow(block_at(c, by, bx), c.q,
                 &c.plane[(size_t)by * 8 * stride + bx * 8], stride);
}

// one component upsampled to the full image (width x height), jdsample.c
void upsample(const Jpeg& j, const Comp& c, std::vector<uint8_t>& out) {
  const int W = j.width, H = j.height;
  const int stride = c.wb * 8;
  const uint8_t* in = c.plane.data();
  const int hx = j.hmax / c.h, vx = j.vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  out.assign((size_t)W * H, 0);
  auto row = [&](int y) {  // rows past either edge repeat the edge row
    if (y < 0) y = 0;
    if (y >= dh) y = dh - 1;
    return in + (size_t)y * stride;
  };
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&out[(size_t)y * W], row(y), W);
    return;
  }
  std::vector<uint8_t> line(2 * (size_t)dw + 2);
  if (hx == 2 && vx == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; y++) {
      const uint8_t* ip = row(y);
      uint8_t* op = line.data();
      int v = ip[0];
      *op++ = (uint8_t)v;
      *op++ = (uint8_t)((v * 3 + ip[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; x++) {
        v = ip[x] * 3;
        *op++ = (uint8_t)((v + ip[x - 1] + 1) >> 2);
        *op++ = (uint8_t)((v + ip[x + 1] + 2) >> 2);
      }
      v = ip[dw - 1];
      *op++ = (uint8_t)((v * 3 + ip[dw - 2] + 1) >> 2);
      *op++ = (uint8_t)v;
      std::memcpy(&out[(size_t)y * W], line.data(), W);
    }
    return;
  }
  if (hx == 1 && vx == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      const uint8_t* near = row(iy);
      const uint8_t* far = (y & 1) ? row(iy + 1) : row(iy - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* op = &out[(size_t)y * W];
      for (int x = 0; x < W; x++)
        op[x] = (uint8_t)((near[x] * 3 + far[x] + bias) >> 2);
    }
    return;
  }
  if (hx == 2 && vx == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; y++) {
      int iy = y >> 1;
      const uint8_t* i0 = row(iy);
      const uint8_t* i1 = (y & 1) ? row(iy + 1) : row(iy - 1);
      uint8_t* op = line.data();
      int this_sum = i0[0] * 3 + i1[0];
      int next_sum = i0[1] * 3 + i1[1];
      *op++ = (uint8_t)((this_sum * 4 + 8) >> 4);
      *op++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
      int last_sum = this_sum;
      this_sum = next_sum;
      for (int x = 2; x < dw; x++) {
        next_sum = i0[x] * 3 + i1[x];
        *op++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        *op++ = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        last_sum = this_sum;
        this_sum = next_sum;
      }
      *op++ = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
      *op++ = (uint8_t)((this_sum * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)y * W], line.data(), W);
    }
    return;
  }
  // h2v1_upsample, h2v2_upsample and int_upsample: replication
  for (int y = 0; y < H; y++) {
    const uint8_t* ip = row(y / vx);
    uint8_t* op = &out[(size_t)y * W];
    for (int x = 0; x < W; x++) op[x] = ip[x / hx];
  }
}

enum ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

// jdapimin.c default_decompress_parms
ColorSpace color_space(const Jpeg& j) {
  if (j.ncomp == 1) return kGray;
  if (j.ncomp == 3) {
    if (j.jfif) return kYCbCr;
    if (j.adobe) return j.adobe_transform == 0 ? kRGB : kYCbCr;
    int c0 = j.comp[0].id, c1 = j.comp[1].id, c2 = j.comp[2].id;
    if (c0 == 82 && c1 == 71 && c2 == 66) return kRGB;  // 'R', 'G', 'B'
    return kYCbCr;
  }
  if (j.adobe) return j.adobe_transform == 0 ? kCMYK : kYCCK;
  return kCMYK;
}

void parse(Jpeg& j, bool header_only) {
  if (j.n < 2 || j.data[0] != 0xFF || j.data[1] != 0xD8)
    fail(kUnsupported, "not a JPEG file");
  j.pos = 2;
  bool scanned = false;
  for (;;) {
    int m = next_marker(j);
    if (m == 0xD8) fail(kCorrupt, "JPEG with a second SOI marker");
    if (m == 0xD9) {
      if (!scanned) fail(kCorrupt, "JPEG without image data");
      return;
    }
    if (m >= 0xD0 && m <= 0xD7) continue;  // stray RSTn: libjpeg skips it
    int len;
    switch (m) {
      case 0xC0:
      case 0xC1:
      case 0xC2:
        read_sof(j, m);
        if (header_only) return;
        break;
      case 0xC3:
      case 0xC5:
      case 0xC6:
      case 0xC7:
        fail(kUnsupported, "lossless or hierarchical JPEG");
      case 0xC9:
      case 0xCA:
      case 0xCB:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        fail(kUnsupported, "arithmetic-coded JPEG");
      case 0xC8:
      case 0xCC:
        fail(kUnsupported, "arithmetic-coded JPEG");
      case 0xC4:
        read_dht(j);
        break;
      case 0xDB:
        read_dqt(j);
        break;
      case 0xDD: {
        const uint8_t* s = segment(j, &len);
        if (len < 2) fail(kCorrupt, "bad JPEG restart interval");
        j.restart_interval = u16(s);
        break;
      }
      case 0xDA:
        read_sos(j);
        scanned = true;
        break;
      case 0xDC:
        fail(kUnsupported, "JPEG with a DNL marker");
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(j, m);
        } else if (m == 0xFE || (m >= 0xF0 && m <= 0xFD)) {
          segment(j, &len);
        } else {
          fail(kCorrupt, "JPEG with an unknown marker");
        }
    }
  }
}

void jpeg_to_rgb(Jpeg& j, uint8_t* out) {
  if (j.progressive) {
    // jdcoefct.c smoothing_ok: libjpeg smooths the blocks of a progressive
    // image whose first AC coefficients are not fully refined
    for (int i = 0; i < j.ncomp; i++) {
      const int* cb = j.comp[i].coef_bits;
      for (int k = 1; k < 10; k++)
        if (cb[k] != 0)
          fail(kUnsupported,
               "progressive JPEG that is not fully refined (block smoothing)");
    }
  }
  const size_t np = (size_t)j.width * j.height;
  std::vector<uint8_t> planes[4];
  for (int i = 0; i < j.ncomp; i++) {
    component_plane(j.comp[i]);
    upsample(j, j.comp[i], planes[i]);
    j.comp[i].plane.clear();
    j.comp[i].plane.shrink_to_fit();
  }
  ColorSpace cs = color_space(j);
  if (cs == kGray) {
    const uint8_t* y = planes[0].data();
    for (size_t p = 0; p < np; p++) out[3 * p] = out[3 * p + 1] =
        out[3 * p + 2] = y[p];
    return;
  }
  if (cs == kRGB) {
    for (size_t p = 0; p < np; p++)
      for (int c = 0; c < 3; c++) out[3 * p + c] = planes[c][p];
    return;
  }
  if (cs == kYCbCr) {  // jdcolor.c ycc_rgb_convert
    const uint8_t *y = planes[0].data(), *cb = planes[1].data(),
                  *cr = planes[2].data();
    for (size_t p = 0; p < np; p++) {
      int yy = y[p], b = cb[p], r = cr[p];
      out[3 * p] = g_limit[yy + g_cr_r[r]];
      out[3 * p + 1] = g_limit[yy + (int)((g_cb_g[b] + g_cr_g[r]) >> 16)];
      out[3 * p + 2] = g_limit[yy + g_cb_b[b]];
    }
    return;
  }
  // CMYK (or YCCK -> CMYK, jdcolor.c ycck_cmyk_convert), then Pillow's
  // "CMYK;I" unpacking (inverted) and its cmyk2rgb
  for (size_t p = 0; p < np; p++) {
    int c4[4];
    if (cs == kYCCK) {
      int yy = planes[0][p], b = planes[1][p], r = planes[2][p];
      c4[0] = g_limit[255 - (yy + g_cr_r[r])];
      c4[1] = g_limit[255 - (yy + (int)((g_cb_g[b] + g_cr_g[r]) >> 16))];
      c4[2] = g_limit[255 - (yy + g_cb_b[b])];
    } else {
      for (int c = 0; c < 3; c++) c4[c] = planes[c][p];
    }
    c4[3] = planes[3][p];
    int nk = c4[3];  // 255 - (255 - k)
    for (int c = 0; c < 3; c++) {
      int ic = 255 - c4[c];
      int tmp = ic * nk + 128;
      int v = nk - (((tmp >> 8) + tmp) >> 8);
      out[3 * p + c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

// --------------------------------------------------------------- PNG

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Unfilter one (sub-)image of w x h pixels from raw[0..] into rows; returns
// the bytes consumed.
size_t unfilter(const uint8_t* raw, size_t n, int w, int h, int bpp_bits,
                std::vector<uint8_t>& rows, size_t* row_bytes_out) {
  size_t row_bytes = ((size_t)w * bpp_bits + 7) / 8;
  int bpp = std::max(1, bpp_bits / 8);
  *row_bytes_out = row_bytes;
  rows.assign(row_bytes * h, 0);
  if (w == 0 || h == 0) return 0;
  size_t need = (row_bytes + 1) * h;
  if (need > n) fail(kTruncated, "truncated PNG image data");
  std::vector<uint8_t> zero(row_bytes, 0);
  for (int y = 0; y < h; y++) {
    const uint8_t* src = raw + (row_bytes + 1) * y;
    int ft = src[0];
    src++;
    uint8_t* cur = &rows[row_bytes * y];
    const uint8_t* prev = y ? &rows[row_bytes * (y - 1)] : zero.data();
    for (size_t i = 0; i < row_bytes; i++) {
      int a = i >= (size_t)bpp ? cur[i - bpp] : 0;
      int b = prev[i];
      int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
      int x = src[i];
      switch (ft) {
        case 0: break;
        case 1: x += a; break;
        case 2: x += b; break;
        case 3: x += (a + b) >> 1; break;
        case 4: x += paeth(a, b, c); break;
        default: fail(kCorrupt, "corrupt PNG data: bad filter type");
      }
      cur[i] = (uint8_t)x;
    }
  }
  return need;
}

// Pillow's conversion of one PNG sample row to RGB
void png_row_rgb(const uint8_t* row, int w, int depth, int ctype,
                 const uint8_t* pal, int npal, uint8_t* out) {
  auto sample = [&](int x, int ch, int chans) -> int {
    if (depth == 16) return row[(x * chans + ch) * 2];  // the high byte
    if (depth == 8) return row[x * chans + ch];
    int per = 8 / depth;
    int byte = row[x / per];
    int shift = 8 - depth * (x % per + 1);
    return (byte >> shift) & ((1 << depth) - 1);
  };
  for (int x = 0; x < w; x++) {
    uint8_t* o = out + 3 * x;
    switch (ctype) {
      case 0: {
        int v = sample(x, 0, 1);
        if (depth == 16) {  // Pillow's I;16 -> RGB clips at 255
          int lo = row[2 * x + 1];
          int full = (v << 8) | lo;
          v = full > 255 ? 255 : full;
        } else if (depth < 8) {
          v = v * 255 / ((1 << depth) - 1);
        }
        o[0] = o[1] = o[2] = (uint8_t)v;
        break;
      }
      case 2:
        for (int c = 0; c < 3; c++) o[c] = (uint8_t)sample(x, c, 3);
        break;
      case 3: {
        int i = sample(x, 0, 1);
        if (i < npal) {
          o[0] = pal[3 * i];
          o[1] = pal[3 * i + 1];
          o[2] = pal[3 * i + 2];
        } else {
          o[0] = o[1] = o[2] = 0;
        }
        break;
      }
      case 4: {
        int v = sample(x, 0, 2);
        o[0] = o[1] = o[2] = (uint8_t)v;
        break;
      }
      case 6:
        for (int c = 0; c < 3; c++) o[c] = (uint8_t)sample(x, c, 4);
        break;
    }
  }
}

}  // namespace

extern "C" {

int ic_jpeg_size(const uint8_t* data, long n, long max_pixels, int* width,
                 int* height, char* err, int errlen) {
  try {
    Jpeg j;
    j.data = data;
    j.n = (size_t)n;
    j.max_pixels = max_pixels;
    parse(j, true);
    if (!j.have_frame) fail(kCorrupt, "JPEG without a frame header");
    *width = j.width;
    *height = j.height;
    return 0;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return kCorrupt;
  }
}

// out: width * height * 3 bytes, as ic_jpeg_size gave them
int ic_jpeg_decode(const uint8_t* data, long n, long max_pixels, uint8_t* out,
                   char* err, int errlen) {
  try {
    Jpeg j;
    j.data = data;
    j.n = (size_t)n;
    j.max_pixels = max_pixels;
    parse(j, false);
    jpeg_to_rgb(j, out);
    return 0;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return kCorrupt;
  }
}

// raw: the inflated IDAT stream; out: width * height * 3 bytes
int ic_png_pixels(const uint8_t* raw, long n, int width, int height,
                  int depth, int ctype, int interlace, const uint8_t* pal,
                  int npal, uint8_t* out, char* err, int errlen) {
  try {
    int chans = ctype == 0 ? 1 : ctype == 2 ? 3 : ctype == 3 ? 1
                : ctype == 4 ? 2 : 4;
    int bpp_bits = chans * depth;
    std::vector<uint8_t> rows, line((size_t)width * 3);
    size_t row_bytes;
    if (!interlace) {
      unfilter(raw, (size_t)n, width, height, bpp_bits, rows, &row_bytes);
      for (int y = 0; y < height; y++)
        png_row_rgb(&rows[row_bytes * y], width, depth, ctype, pal, npal,
                    out + (size_t)y * width * 3);
      return 0;
    }
    // Adam7
    static const int xs[7] = {0, 4, 0, 2, 0, 1, 0}, ys[7] = {0, 0, 4, 0, 2, 0, 1};
    static const int dx[7] = {8, 8, 4, 4, 2, 2, 1}, dy[7] = {8, 8, 8, 4, 4, 2, 2};
    size_t off = 0;
    for (int pass = 0; pass < 7; pass++) {
      int pw = (width - xs[pass] + dx[pass] - 1) / dx[pass];
      int ph = (height - ys[pass] + dy[pass] - 1) / dy[pass];
      if (pw <= 0 || ph <= 0) continue;
      off += unfilter(raw + off, (size_t)n - off, pw, ph, bpp_bits, rows,
                      &row_bytes);
      std::vector<uint8_t> rgb((size_t)pw * 3);
      for (int y = 0; y < ph; y++) {
        png_row_rgb(&rows[row_bytes * y], pw, depth, ctype, pal, npal,
                    rgb.data());
        int oy = ys[pass] + y * dy[pass];
        for (int x = 0; x < pw; x++) {
          int ox = xs[pass] + x * dx[pass];
          std::memcpy(out + ((size_t)oy * width + ox) * 3, &rgb[3 * x], 3);
        }
      }
    }
    return 0;
  } catch (const Fail& f) {
    set_err(err, errlen, f.msg);
    return f.code;
  } catch (const std::exception& e) {
    set_err(err, errlen, e.what());
    return kCorrupt;
  }
}

}  // extern "C"
