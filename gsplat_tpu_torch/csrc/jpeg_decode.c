/* jpeg_decode: a baseline, extended-sequential and progressive Huffman JPEG
 * decoder in plain C, the port's JPEG path where the JAX package decodes
 * with PIL.
 *
 * Host code (no CUDA), compiled with io_runtime.c into the IO runtime's
 * library by _build.py's host route (the system C compiler, build/host/) and
 * loaded with ctypes (io/jpeg.py, io/native_loader.py). It returns
 * the bytes `np.asarray(PIL.Image.open(path))` gives, PIL being built on
 * libjpeg-turbo at its defaults: each step follows libjpeg-turbo's C code,
 * whose SIMD paths give the same bits.
 *   - progressive files (jdphuff.c): DC first and refinement scans, AC
 *     spectral selection, successive approximation, EOB runs, restart
 *     intervals inside the scans. The coefficients of the whole image are
 *     kept until the file ends and then go through the steps below, as
 *     libjpeg's non-buffered decode reads the whole file before its output
 *     pass. libjpeg smooths the blocks of a progressive image (jdcoefct.c
 *     decompress_smooth_data) where some coefficient's last bits were never
 *     sent; a file whose scans leave any coefficient of a component
 *     incomplete fails with that reason, and a complete one (every encoder's
 *     default script) needs no smoothing;
 *   - the JDCT_ISLOW integer IDCT (jidctint.c jpeg_idct_islow), with its
 *     post-IDCT range-limit table (jdmaster.c prepare_range_limit_table);
 *   - fancy upsampling, on by default, so the merged upsampler never runs
 *     (jdsample.c h2v1_fancy_upsample, h2v2_fancy_upsample and
 *     h1v2_fancy_upsample; plain replication where a chroma row is at most
 *     two samples wide, as jinit_upsampler chooses). The rows above the
 *     first and below the last of a component are copies of those rows
 *     (jdmainct.c's context pointers);
 *   - the table-driven YCbCr -> RGB conversion (jdcolor.c ycc_rgb_convert);
 *   - the colour space libjpeg-turbo infers (jdapimin.c
 *     default_decompress_parms): 3 components: a JFIF APP0 means YCbCr;
 *     else an Adobe APP14 with transform 0 means RGB (no conversion), any
 *     other YCbCr; else component ids 'R', 'G', 'B' mean RGB, anything else
 *     YCbCr. 4 components: an Adobe APP14 with a nonzero transform means
 *     YCCK (jdcolor.c ycck_cmyk_convert), else CMYK; PIL then inverts all
 *     four channels (its "CMYK;I" raw mode, Adobe's convention), so the
 *     result is (H, W, 4).
 * APPn and COM segments are skipped: EXIF orientation is not applied, as
 * PIL's decode does not apply it.
 *
 * Supported: 8-bit samples, 1, 3 or 4 components, sampling 4:4:4, 4:2:2
 * (h2v1), 4:2:0 (h2v2) and 4:4:0 (h1v2) (any factors whose ratio to the
 * largest is 1 or 2 in each direction), interleaved or one scan a
 * component, restart intervals, partial MCUs at the right and bottom
 * edges. Everything else fails with a message: lossless, hierarchical and
 * arithmetic-coded files, 12-bit samples, 2 components, other sampling
 * ratios, DNL, a progressive file whose scans leave a coefficient
 * incomplete or break the progression's rules, and a truncated or corrupt
 * stream (a missing EOI, entropy-coded data that runs past its segment, a
 * bad Huffman code or table, a wrong restart marker).
 *
 * Entry points (plain C ABI):
 *   jpeg_header(data, size, &w, &h, &channels, err, errlen)
 *   jpeg_decode(data, size, out, w, h, channels, err, errlen)
 * both return 0, or 1 with a message in err. out is (h, w, channels) uint8.
 */

#include <setjmp.h>
#include <stdarg.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* zigzag index -> natural (row-major) index, jutils.c jpeg_natural_order */
static const int kNatural[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

#define LOOK_BITS 9

typedef struct {
  int present;
  uint8_t vals[256];
  int32_t maxcode[18];  /* largest code of each length, -1 if none */
  int32_t valoffset[17];
  uint16_t look[1 << LOOK_BITS]; /* (length << 8) | value; length 0: longer */
} huff_t;

typedef struct {
  int id, h, v, tq;
  int dw, dh;      /* downsampled_width, downsampled_height */
  int bw, bh;      /* blocks a row and rows of blocks allocated (whole MCUs) */
  int td, ta;      /* the current scan's table numbers */
  int pred;        /* DC predictor */
  int coded;       /* appeared in a scan */
  int latched;     /* its quantisation table copied at its first scan */
  uint16_t q[64];  /* that table, natural order */
  int coef_bits[64]; /* progressive: the Al of the last scan that coded each
                        coefficient (zigzag order), -1 before any */
  int16_t* coef;   /* bh * bw blocks of 64, natural order */
  uint8_t* plane;  /* (bh * 8) x (bw * 8) samples after the IDCT */
} comp_t;

typedef struct {
  const uint8_t* data;
  const uint8_t* p;
  const uint8_t* end;
  /* entropy-coded data */
  uint32_t buf;
  int nbits;
  int fake;        /* zero bytes fed past the segment's end */
  int at_marker;
  /* frame */
  int sof, W, H, ncomp, hmax, vmax, mcux, mcuy;
  int progressive; /* SOF2 */
  int eobrun;      /* progressive: blocks left in the current EOB run */
  comp_t comp[4];
  uint16_t qt[4][64];
  int qt_present[4];
  huff_t dc[4], ac[4];
  int restart_interval;
  int jfif, adobe, adobe_transform;
  char* err;
  int errlen;
  jmp_buf jb;
} dec_t;

static void fail(dec_t* d, const char* fmt, ...) {
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(d->err, (size_t)d->errlen, fmt, ap);
  va_end(ap);
  longjmp(d->jb, 1);
}

static void free_all(dec_t* d) {
  for (int c = 0; c < 4; ++c) {
    free(d->comp[c].coef);
    free(d->comp[c].plane);
    d->comp[c].coef = NULL;
    d->comp[c].plane = NULL;
  }
}

static void* alloc(dec_t* d, size_t n) {
  void* q = calloc(n, 1);
  if (!q) fail(d, "out of memory (%zu bytes)", n);
  return q;
}

/* ---- markers and segments ---- */

static int byte_at(dec_t* d) {
  if (d->p >= d->end) fail(d, "truncated file (ends before its EOI marker)");
  return *d->p++;
}

static int u16(dec_t* d) {
  const int hi = byte_at(d);
  return (hi << 8) | byte_at(d);
}

/* The next marker code: skips any bytes before an 0xFF (extraneous data,
 * as libjpeg's next_marker skips it) and 0xFF fill bytes. */
static int next_marker(dec_t* d) {
  for (;;) {
    int c = byte_at(d);
    if (c != 0xFF) continue;
    do {
      c = byte_at(d);
    } while (c == 0xFF);
    if (c != 0) return c;
  }
}

/* A segment's payload: [p, p + len) after its 2-byte length. */
static const uint8_t* segment(dec_t* d, int* len) {
  const int n = u16(d);
  if (n < 2 || d->p + (n - 2) > d->end)
    fail(d, "truncated or corrupt marker segment (length %d)", n);
  const uint8_t* s = d->p;
  d->p += n - 2;
  *len = n - 2;
  return s;
}

static void parse_dqt(dec_t* d) {
  int len;
  const uint8_t* s = segment(d, &len);
  int i = 0;
  while (i < len) {
    const int pq = s[i] >> 4, tq = s[i] & 15;
    ++i;
    if (tq > 3 || pq > 1) fail(d, "corrupt quantisation table (DQT %d/%d)", pq, tq);
    if (i + 64 * (pq + 1) > len) fail(d, "truncated quantisation table");
    for (int k = 0; k < 64; ++k) {
      const int v = pq ? (s[i] << 8) | s[i + 1] : s[i];
      i += pq + 1;
      d->qt[tq][kNatural[k]] = (uint16_t)v;
    }
    d->qt_present[tq] = 1;
  }
}

/* jdhuff.c jpeg_make_d_derived_tbl, with a LOOK_BITS lookahead table */
static void parse_dht(dec_t* d) {
  int len;
  const uint8_t* s = segment(d, &len);
  int i = 0;
  while (i < len) {
    if (i + 17 > len) fail(d, "truncated Huffman table");
    const int tc = s[i] >> 4, th = s[i] & 15;
    if (tc > 1 || th > 3) fail(d, "corrupt Huffman table (class %d, id %d)", tc, th);
    const uint8_t* counts = s + i + 1;
    int total = 0;
    for (int l = 0; l < 16; ++l) total += counts[l];
    i += 17;
    if (total > 256 || i + total > len) fail(d, "corrupt Huffman table (%d codes)", total);
    huff_t* t = tc ? &d->ac[th] : &d->dc[th];
    memset(t, 0, sizeof(*t));
    memcpy(t->vals, s + i, (size_t)total);
    if (!tc)
      for (int k = 0; k < total; ++k)
        if (t->vals[k] > 15) fail(d, "corrupt DC Huffman table (symbol %d)", t->vals[k]);
    i += total;
    int code = 0, p = 0;
    int32_t huffcode[256];
    for (int l = 1; l <= 16; ++l) {
      const int n = counts[l - 1];
      if (n) {
        t->valoffset[l] = p - code;
        for (int k = 0; k < n; ++k) huffcode[p++] = code++;
        t->maxcode[l] = code - 1;
        /* no code may be all ones */
        if (code >= (1 << l)) fail(d, "corrupt Huffman table (code lengths)");
      } else {
        t->maxcode[l] = -1;
      }
      code <<= 1;
    }
    t->maxcode[17] = 0x7FFFFFFF;
    p = 0;
    for (int l = 1; l <= LOOK_BITS; ++l)
      for (int k = 0; k < counts[l - 1]; ++k, ++p) {
        const int base = huffcode[p] << (LOOK_BITS - l);
        for (int r = 0; r < (1 << (LOOK_BITS - l)); ++r)
          t->look[base + r] = (uint16_t)((l << 8) | t->vals[p]);
      }
    t->present = 1;
  }
}

static void parse_sof(dec_t* d, int marker) {
  int len;
  const uint8_t* s = segment(d, &len);
  if (d->sof) fail(d, "corrupt file (a second frame header)");
  if (len < 6) fail(d, "truncated frame header");
  const int precision = s[0];
  d->H = (s[1] << 8) | s[2];
  d->W = (s[3] << 8) | s[4];
  d->ncomp = s[5];
  if (precision != 8)
    fail(d, "%d-bit samples are not supported (8-bit JPEG only)", precision);
  if (d->ncomp != 1 && d->ncomp != 3 && d->ncomp != 4)
    fail(d, "%d components are not supported (grayscale, 3-component colour, CMYK or "
            "YCCK only)", d->ncomp);
  if (d->H == 0) fail(d, "a height defined by a DNL marker is not supported");
  if (d->W == 0) fail(d, "corrupt frame header (width 0)");
  if (len < 6 + 3 * d->ncomp) fail(d, "truncated frame header");
  d->hmax = d->vmax = 1;
  for (int c = 0; c < d->ncomp; ++c) {
    comp_t* k = &d->comp[c];
    k->id = s[6 + 3 * c];
    k->h = s[7 + 3 * c] >> 4;
    k->v = s[7 + 3 * c] & 15;
    k->tq = s[8 + 3 * c];
    if (k->h < 1 || k->h > 4 || k->v < 1 || k->v > 4 || k->tq > 3)
      fail(d, "corrupt frame header (component %d sampling %dx%d, table %d)", c, k->h,
           k->v, k->tq);
    if (k->h > d->hmax) d->hmax = k->h;
    if (k->v > d->vmax) d->vmax = k->v;
    for (int i = 0; i < 64; ++i) k->coef_bits[i] = -1;
  }
  for (int c = 0; c < d->ncomp; ++c) {
    comp_t* k = &d->comp[c];
    const int rh = d->hmax / k->h, rv = d->vmax / k->v;
    if (d->ncomp > 1 && (d->hmax % k->h || d->vmax % k->v || rh > 2 || rv > 2))
      fail(d, "sampling factors %dx%d of component %d under a %dx%d maximum are not "
              "supported (4:4:4, 4:2:2, 4:2:0 and 4:4:0 only)", k->h, k->v, c, d->hmax,
           d->vmax);
  }
  d->mcux = (d->W + 8 * d->hmax - 1) / (8 * d->hmax);
  d->mcuy = (d->H + 8 * d->vmax - 1) / (8 * d->vmax);
  d->sof = marker;
  d->progressive = marker == 0xC2;
}

static void parse_app(dec_t* d, int marker) {
  int len;
  const uint8_t* s = segment(d, &len);
  /* jdmarker.c examine_app0 / examine_app14 */
  if (marker == 0xE0 && len >= 14 && memcmp(s, "JFIF", 5) == 0) d->jfif = 1;
  if (marker == 0xEE && len >= 12 && memcmp(s, "Adobe", 5) == 0) {
    d->adobe = 1;
    d->adobe_transform = s[11];
  }
}

/* ---- entropy-coded data ---- */

/* Top the bit buffer up to at least 25 bits (jdhuff.c
 * jpeg_fill_bit_buffer): FF 00 is an FF data byte, FF FF.. fill before a
 * marker; at a marker or the end of the file, zero bytes, counted. */
static void fill(dec_t* d) {
  while (d->nbits <= 24) {
    uint32_t b = 0;
    if (!d->at_marker && d->p < d->end) {
      if (*d->p != 0xFF) {
        b = *d->p++;
      } else {
        const uint8_t* q = d->p + 1;
        while (q < d->end && *q == 0xFF) ++q;
        if (q < d->end && *q == 0) {
          b = 0xFF;
          d->p = q + 1;
        } else {
          d->p = q - 1;  /* at the FF before the marker code (or the end) */
          d->at_marker = 1;
          ++d->fake;
        }
      }
    } else {
      ++d->fake;
    }
    d->buf |= b << (24 - d->nbits);
    d->nbits += 8;
  }
}

static int get_bits(dec_t* d, int n) {
  if (n == 0) return 0;
  if (d->nbits < n) fill(d);
  const int v = (int)(d->buf >> (32 - n));
  d->buf <<= n;
  d->nbits -= n;
  return v;
}

/* jdhuff.h HUFF_EXTEND */
static int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

static int decode_huff(dec_t* d, const huff_t* t) {
  if (d->nbits < 16) fill(d);
  const uint16_t e = t->look[d->buf >> (32 - LOOK_BITS)];
  if (e >> 8) {
    const int l = e >> 8;
    d->buf <<= l;
    d->nbits -= l;
    return e & 0xFF;
  }
  int l = LOOK_BITS + 1;
  int32_t code = (int32_t)(d->buf >> (32 - l));
  while (l <= 16 && code > t->maxcode[l]) {
    ++l;
    code = (int32_t)(d->buf >> (32 - l));
  }
  if (l > 16) fail(d, "corrupt entropy-coded data (a Huffman code longer than 16 bits)");
  d->buf <<= l;
  d->nbits -= l;
  return t->vals[(code + t->valoffset[l]) & 0xFF];
}

static void decode_block(dec_t* d, comp_t* k, int16_t* blk) {
  const int s = decode_huff(d, &d->dc[k->td]);
  const int diff = s ? extend(get_bits(d, s), s) : 0;
  k->pred += diff;
  blk[0] = (int16_t)k->pred;
  const huff_t* ac = &d->ac[k->ta];
  for (int i = 1; i < 64; ++i) {
    const int rs = decode_huff(d, ac);
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      i += r;
      if (i > 63) fail(d, "corrupt entropy-coded data (a run past the block's end)");
      blk[kNatural[i]] = (int16_t)extend(get_bits(d, sz), sz);
    } else {
      if (r != 15) break;
      i += 15;
    }
  }
}

/* ---- progressive scans (jdphuff.c) ---- */

/* decode_mcu_DC_first: the DC difference, shifted up by Al */
static void decode_dc_first(dec_t* d, comp_t* k, int16_t* blk, int al) {
  const int s = decode_huff(d, &d->dc[k->td]);
  k->pred += s ? extend(get_bits(d, s), s) : 0;
  blk[0] = (int16_t)((uint32_t)k->pred << al);
}

/* decode_mcu_DC_refine: one more bit of the DC */
static void decode_dc_refine(dec_t* d, int16_t* blk, int al) {
  if (get_bits(d, 1)) blk[0] = (int16_t)(blk[0] | (1 << al));
}

/* decode_mcu_AC_first: coefficients ss..se (zigzag), shifted up by Al, or
 * one block of an EOB run */
static void decode_ac_first(dec_t* d, comp_t* k, int16_t* blk, int ss, int se, int al) {
  if (d->eobrun > 0) {
    --d->eobrun;
    return;
  }
  const huff_t* ac = &d->ac[k->ta];
  for (int i = ss; i <= se; ++i) {
    const int rs = decode_huff(d, ac);
    const int r = rs >> 4, sz = rs & 15;
    if (sz) {
      i += r;
      if (i > se) fail(d, "corrupt entropy-coded data (a run past the band's end)");
      blk[kNatural[i]] = (int16_t)((uint32_t)extend(get_bits(d, sz), sz) << al);
    } else if (r == 15) {
      i += 15;
    } else {
      d->eobrun = (1 << r) - 1;
      if (r) d->eobrun += get_bits(d, r);
      break;
    }
  }
}

/* A correction bit for nonzero coefficient c: 1 adds 2^Al to its magnitude
 * (unless a bit of that weight is there already) */
static void refine_nonzero(dec_t* d, int16_t* c, int p1) {
  if (get_bits(d, 1) && (*c & p1) == 0) *c = (int16_t)(*c >= 0 ? *c + p1 : *c - p1);
}

/* decode_mcu_AC_refine: the next bit of coefficients ss..se: new ones of
 * magnitude 2^Al where a code places them, a correction bit for every one
 * already nonzero that the band passes over */
static void decode_ac_refine(dec_t* d, comp_t* k, int16_t* blk, int ss, int se, int al) {
  const int p1 = 1 << al;
  int i = ss;
  if (d->eobrun == 0) {
    const huff_t* ac = &d->ac[k->ta];
    for (; i <= se; ++i) {
      const int rs = decode_huff(d, ac);
      int r = rs >> 4, v = 0;
      if (rs & 15) {
        if ((rs & 15) != 1)
          fail(d, "corrupt entropy-coded data (a refinement coefficient of size %d)",
               rs & 15);
        v = get_bits(d, 1) ? p1 : -p1;
      } else if (r != 15) {
        d->eobrun = 1 << r;
        if (r) d->eobrun += get_bits(d, r);
        break;
      }
      /* pass over r zero coefficients (and every nonzero one between them,
       * each with its correction bit) to the one the code names */
      do {
        int16_t* c = blk + kNatural[i];
        if (*c != 0) {
          refine_nonzero(d, c, p1);
        } else if (--r < 0) {
          break;
        }
        ++i;
      } while (i <= se);
      if (v) {
        if (i > se) fail(d, "corrupt entropy-coded data (a run past the band's end)");
        blk[kNatural[i]] = (int16_t)v;
      }
    }
  }
  if (d->eobrun > 0) {
    /* in an EOB run: correction bits for the rest of the band */
    for (; i <= se; ++i)
      if (blk[kNatural[i]] != 0) refine_nonzero(d, blk + kNatural[i], p1);
    --d->eobrun;
  }
}

/* The end of a restart interval or scan: no bit read past the segment,
 * then the bit buffer's padding dropped. */
static void end_interval(dec_t* d) {
  if (d->nbits < 8 * d->fake)
    fail(d, "corrupt or truncated entropy-coded data (it runs past its segment)");
  d->buf = 0;
  d->nbits = 0;
  d->fake = 0;
  d->at_marker = 0;
}

/* A progressive scan's spectral selection and approximation, checked as
 * jdphuff.c start_pass_phuff_decoder checks them, and its components'
 * progression (what libjpeg only warns of fails here) */
static void check_progression(dec_t* d, comp_t** sc, int ns, int ss, int se, int ah,
                              int al) {
  const int dc = ss == 0;
  if ((dc && se != 0) || (!dc && (ss > se || se > 63 || ns != 1)) ||
      (ah != 0 && al != ah - 1) || al > 13)
    fail(d, "corrupt progressive scan header (spectral selection %d..%d, approximation "
            "%d/%d, %d components)", ss, se, ah, al, ns);
  for (int i = 0; i < ns; ++i) {
    comp_t* k = sc[i];
    if (!dc && k->coef_bits[0] < 0)
      fail(d, "corrupt progression (an AC scan of component %d before its DC)", k->id);
    for (int c = ss; c <= se; ++c) {
      const int expected = k->coef_bits[c] < 0 ? 0 : k->coef_bits[c];
      if (ah != expected)
        fail(d, "corrupt progression (coefficient %d of component %d refined from bit %d, "
                "its last scan sent down to bit %d)", c, k->id, ah, k->coef_bits[c]);
      k->coef_bits[c] = al;
    }
  }
}

static void parse_sos(dec_t* d) {
  int len;
  const uint8_t* s = segment(d, &len);
  if (!d->sof) fail(d, "corrupt file (a scan before the frame header)");
  if (len < 1) fail(d, "truncated scan header");
  const int ns = s[0];
  if (ns < 1 || ns > d->ncomp || len < 4 + 2 * ns) fail(d, "corrupt scan header");
  const int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ah = s[3 + 2 * ns] >> 4,
            al = s[3 + 2 * ns] & 15;
  comp_t* sc[4];
  for (int i = 0; i < ns; ++i) {
    const int id = s[1 + 2 * i], tabs = s[2 + 2 * i];
    comp_t* k = NULL;
    for (int c = 0; c < d->ncomp; ++c)
      if (d->comp[c].id == id) k = &d->comp[c];
    if (!k) fail(d, "corrupt scan header (component id %d)", id);
    for (int j = 0; j < i; ++j)
      if (sc[j] == k) fail(d, "corrupt scan header (component %d twice)", id);
    k->td = tabs >> 4;
    k->ta = tabs & 15;
    /* the tables the scan decodes with: both in a sequential scan; a DC
     * first scan's DC table, an AC scan's AC table, none to refine a DC */
    const int need_dc = !d->progressive || (ss == 0 && ah == 0);
    const int need_ac = !d->progressive || ss != 0;
    if (k->td > 3 || k->ta > 3 || (need_dc && !d->dc[k->td].present) ||
        (need_ac && !d->ac[k->ta].present))
      fail(d, "corrupt scan header (Huffman tables %d/%d of component %d not defined)",
           k->td, k->ta, id);
    if (k->coded && !d->progressive)
      fail(d, "component %d in two scans (not a sequential JPEG)", id);
    if (!k->latched) {
      if (!d->qt_present[k->tq])
        fail(d, "corrupt file (quantisation table %d not defined)", k->tq);
      memcpy(k->q, d->qt[k->tq], sizeof(k->q));
      k->latched = 1;
    }
    k->pred = 0;
    k->coded = 1;
    sc[i] = k;
  }
  if (d->progressive)
    check_progression(d, sc, ns, ss, se, ah, al);
  else if (ss != 0 || se != 63 || ah != 0 || al != 0)
    fail(d, "corrupt scan header (spectral selection %d..%d, approximation %d/%d)", ss, se,
         ah, al);

  int nx, ny;
  if (ns == 1) {
    nx = (sc[0]->dw + 7) / 8;
    ny = (sc[0]->dh + 7) / 8;
  } else {
    nx = d->mcux;
    ny = d->mcuy;
  }
  const long total = (long)nx * ny;
  int rst = 0;
  d->buf = 0;
  d->nbits = 0;
  d->fake = 0;
  d->at_marker = 0;
  d->eobrun = 0;
  for (long m = 0; m < total; ++m) {
    if (d->restart_interval && m > 0 && m % d->restart_interval == 0) {
      end_interval(d);
      const int mk = next_marker(d);
      if (mk != 0xD0 + rst)
        fail(d, "corrupt entropy-coded data (expected restart marker RST%d, found 0x%02X)",
             rst, mk);
      rst = (rst + 1) & 7;
      for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
      d->eobrun = 0;
    }
    const int mx = (int)(m % nx), my = (int)(m / nx);
    for (int i = 0; i < ns; ++i) {
      comp_t* k = sc[i];
      const int bx0 = ns == 1 ? mx : mx * k->h, by0 = ns == 1 ? my : my * k->v;
      const int hh = ns == 1 ? 1 : k->h, vv = ns == 1 ? 1 : k->v;
      for (int by = 0; by < vv; ++by)
        for (int bx = 0; bx < hh; ++bx) {
          int16_t* blk = k->coef + ((size_t)(by0 + by) * k->bw + bx0 + bx) * 64;
          if (!d->progressive)
            decode_block(d, k, blk);
          else if (ss == 0)
            ah ? decode_dc_refine(d, blk, al) : decode_dc_first(d, k, blk, al);
          else
            ah ? decode_ac_refine(d, k, blk, ss, se, al) : decode_ac_first(d, k, blk, ss, se, al);
        }
    }
  }
  end_interval(d);
}

/* ---- IDCT: jidctint.c jpeg_idct_islow ---- */

#define CONST_BITS 13
#define PASS1_BITS 2
#define FIX_0_298631336 ((int64_t)2446)
#define FIX_0_390180644 ((int64_t)3196)
#define FIX_0_541196100 ((int64_t)4433)
#define FIX_0_765366865 ((int64_t)6270)
#define FIX_0_899976223 ((int64_t)7373)
#define FIX_1_175875602 ((int64_t)9633)
#define FIX_1_501321110 ((int64_t)12299)
#define FIX_1_847759065 ((int64_t)15137)
#define FIX_1_961570560 ((int64_t)16069)
#define FIX_2_053119869 ((int64_t)16819)
#define FIX_2_562915447 ((int64_t)20995)
#define FIX_3_072711026 ((int64_t)25172)
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n) - 1))) >> (n))

/* The post-IDCT range limit: idct_range_limit[x & 1023] of
 * prepare_range_limit_table, x the sample less its +128 level shift. */
static uint8_t idct_limit(int64_t x) {
  const int i = (int)(x & 1023);
  if (i < 128) return (uint8_t)(i + 128);
  if (i < 512) return 255;
  if (i < 896) return 0;
  return (uint8_t)(i - 896);
}

static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const uint16_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 &&
        ip[48] == 0 && ip[56] == 0) {
      const int dc = (int)(((int64_t)ip[0] * qp[0]) * (1 << PASS1_BITS));
      for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)ip[16] * qp[16], z3 = (int64_t)ip[48] * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = (int64_t)ip[0] * qp[0];
    z3 = (int64_t)ip[32] * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)ip[56] * qp[56];
    tmp1 = (int64_t)ip[40] * qp[40];
    tmp2 = (int64_t)ip[24] * qp[24];
    tmp3 = (int64_t)ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    wp[0] = (int)DESCALE(tmp10 + tmp3, CONST_BITS - PASS1_BITS);
    wp[56] = (int)DESCALE(tmp10 - tmp3, CONST_BITS - PASS1_BITS);
    wp[8] = (int)DESCALE(tmp11 + tmp2, CONST_BITS - PASS1_BITS);
    wp[48] = (int)DESCALE(tmp11 - tmp2, CONST_BITS - PASS1_BITS);
    wp[16] = (int)DESCALE(tmp12 + tmp1, CONST_BITS - PASS1_BITS);
    wp[40] = (int)DESCALE(tmp12 - tmp1, CONST_BITS - PASS1_BITS);
    wp[24] = (int)DESCALE(tmp13 + tmp0, CONST_BITS - PASS1_BITS);
    wp[32] = (int)DESCALE(tmp13 - tmp0, CONST_BITS - PASS1_BITS);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      const uint8_t v = idct_limit(DESCALE((int64_t)wp[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) op[c] = v;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * (-FIX_0_899976223);
    z2 = z2 * (-FIX_2_562915447);
    z3 = z3 * (-FIX_1_961570560);
    z4 = z4 * (-FIX_0_390180644);
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    op[0] = idct_limit(DESCALE(tmp10 + tmp3, sh));
    op[7] = idct_limit(DESCALE(tmp10 - tmp3, sh));
    op[1] = idct_limit(DESCALE(tmp11 + tmp2, sh));
    op[6] = idct_limit(DESCALE(tmp11 - tmp2, sh));
    op[2] = idct_limit(DESCALE(tmp12 + tmp1, sh));
    op[5] = idct_limit(DESCALE(tmp12 - tmp1, sh));
    op[3] = idct_limit(DESCALE(tmp13 + tmp0, sh));
    op[4] = idct_limit(DESCALE(tmp13 - tmp0, sh));
  }
}

/* ---- upsampling (jdsample.c) and colour (jdcolor.c) ---- */

/* Output row y of component k at full width into out (2 * dw + 2 samples
 * at most, of which the first W are used). */
static void upsample_row(const dec_t* d, const comp_t* k, int y, uint8_t* out) {
  const int rh = d->hmax / k->h, rv = d->vmax / k->v;
  const int pw = k->bw * 8, dw = k->dw;
  if (rh == 1 && rv == 1) {
    memcpy(out, k->plane + (size_t)y * pw, (size_t)d->W);
    return;
  }
  const int i = y / rv;
  const uint8_t* in0 = k->plane + (size_t)i * pw;
  if (rv == 2 && (rh == 1 || dw > 2)) {
    /* fancy, with a context row: the one above for the upper output row,
     * below for the lower, the edge rows repeated */
    const int below = y & 1;
    int j = below ? i + 1 : i - 1;
    if (j < 0) j = 0;
    if (j > k->dh - 1) j = k->dh - 1;
    const uint8_t* in1 = k->plane + (size_t)j * pw;
    if (rh == 1) {
      const int bias = below ? 2 : 1;
      for (int x = 0; x < dw; ++x) out[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
      return;
    }
    int thiscolsum = in0[0] * 3 + in1[0];
    int nextcolsum = in0[1] * 3 + in1[1];
    int lastcolsum;
    uint8_t* o = out;
    *o++ = (uint8_t)((thiscolsum * 4 + 8) >> 4);
    *o++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
    lastcolsum = thiscolsum;
    thiscolsum = nextcolsum;
    for (int x = 2; x < dw; ++x) {
      nextcolsum = in0[x] * 3 + in1[x];
      *o++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
      *o++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
      lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
    }
    *o++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
    *o++ = (uint8_t)((thiscolsum * 4 + 7) >> 4);
    return;
  }
  if (rh == 2 && dw > 2) {
    /* h2v1_fancy_upsample */
    uint8_t* o = out;
    *o++ = in0[0];
    *o++ = (uint8_t)((in0[0] * 3 + in0[1] + 2) >> 2);
    for (int x = 1; x < dw - 1; ++x) {
      const int v = in0[x] * 3;
      *o++ = (uint8_t)((v + in0[x - 1] + 1) >> 2);
      *o++ = (uint8_t)((v + in0[x + 1] + 2) >> 2);
    }
    *o++ = (uint8_t)((in0[dw - 1] * 3 + in0[dw - 2] + 1) >> 2);
    *o++ = in0[dw - 1];
    return;
  }
  /* h2v1_upsample / h2v2_upsample: replication (rows too, through i) */
  for (int x = 0; x < dw; ++x) out[2 * x] = out[2 * x + 1] = in0[x];
}

static uint8_t clamp255(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

static void convert(dec_t* d, uint8_t* out) {
  const int W = d->W, H = d->H, nc = d->ncomp;
  if (nc == 1) {
    const comp_t* k = &d->comp[0];
    for (int y = 0; y < H; ++y) memcpy(out + (size_t)y * W, k->plane + (size_t)y * k->bw * 8,
                                       (size_t)W);
    return;
  }
  /* 3 components: RGB, or YCbCr to convert; 4: CMYK, or YCCK whose first
   * three convert (default_decompress_parms) */
  int rgb;
  if (nc == 4) {
    rgb = !(d->adobe && d->adobe_transform != 0);
  } else if (d->jfif) {
    rgb = 0;
  } else if (d->adobe) {
    rgb = d->adobe_transform == 0;
  } else {
    rgb = d->comp[0].id == 'R' && d->comp[1].id == 'G' && d->comp[2].id == 'B';
  }
  /* jdcolor.c build_ycc_rgb_table: SCALEBITS 16, FIX(x) = x * 2^16 + 0.5 */
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  const int64_t one_half = (int64_t)1 << 15;
  const int64_t f_r = (int64_t)(1.40200 * 65536 + 0.5), f_b = (int64_t)(1.77200 * 65536 + 0.5);
  const int64_t f_gr = (int64_t)(0.71414 * 65536 + 0.5), f_gb = (int64_t)(0.34414 * 65536 + 0.5);
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = (int)((f_r * x + one_half) >> 16);
    cb_b[i] = (int)((f_b * x + one_half) >> 16);
    cr_g[i] = -f_gr * x;
    cb_g[i] = -f_gb * x + one_half;
  }
  const size_t rowlen = (size_t)2 * d->W + 64;
  uint8_t* rows = alloc(d, (size_t)nc * rowlen);
  for (int y = 0; y < H; ++y) {
    uint8_t* r[4];
    for (int c = 0; c < nc; ++c) {
      r[c] = rows + c * rowlen;
      upsample_row(d, &d->comp[c], y, r[c]);
    }
    uint8_t* o = out + (size_t)y * W * nc;
    if (nc == 4) {
      /* CMYK, or YCCK -> CMYK (jdcolor.c ycck_cmyk_convert: the YCbCr
       * conversion of the first three subtracted from 255, K as it is),
       * then PIL's CMYK;I inversion of all four */
      for (int x = 0; x < W; ++x) {
        uint8_t* q = o + 4 * x;
        if (rgb) {
          q[0] = r[0][x], q[1] = r[1][x], q[2] = r[2][x];
        } else {
          const int yy = r[0][x], cb = r[1][x], cr = r[2][x];
          q[0] = clamp255(255 - (yy + cr_r[cr]));
          q[1] = clamp255(255 - (yy + (int)((cb_g[cb] + cr_g[cr]) >> 16)));
          q[2] = clamp255(255 - (yy + cb_b[cb]));
        }
        q[3] = r[3][x];
        for (int c = 0; c < 4; ++c) q[c] = (uint8_t)(255 - q[c]);
      }
      continue;
    }
    if (rgb) {
      for (int x = 0; x < W; ++x) o[3 * x] = r[0][x], o[3 * x + 1] = r[1][x], o[3 * x + 2] = r[2][x];
      continue;
    }
    for (int x = 0; x < W; ++x) {
      const int yy = r[0][x], cb = r[1][x], cr = r[2][x];
      o[3 * x] = clamp255(yy + cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + cb_b[cb]);
    }
  }
  free(rows);
}

/* ---- the file ---- */

/* Markers up to the first scan (header) or to EOI (decode). */
static void run(dec_t* d, int header_only) {
  d->p = d->data;
  if (d->end - d->p < 2 || d->p[0] != 0xFF || d->p[1] != 0xD8)
    fail(d, "not a JPEG file (no SOI marker)");
  d->p += 2;
  for (;;) {
    const int m = next_marker(d);
    if (m == 0xC0 || m == 0xC1 || m == 0xC2) {
      parse_sof(d, m);
    } else if (m == 0xC3 || m == 0xCB) {
      fail(d, "lossless JPEG (SOF%d) is not supported", m - 0xC0);
    } else if (m == 0xC5 || m == 0xC6 || m == 0xC7 || m == 0xCD || m == 0xCE || m == 0xCF) {
      fail(d, "hierarchical JPEG (SOF%d) is not supported", m - 0xC0);
    } else if (m == 0xC9 || m == 0xCA || m == 0xCC) {
      fail(d, "arithmetic-coded JPEG (marker 0x%02X) is not supported", m);
    } else if (m == 0xC4) {
      parse_dht(d);
    } else if (m == 0xDB) {
      parse_dqt(d);
    } else if (m == 0xDD) {
      int len;
      const uint8_t* s = segment(d, &len);
      if (len < 2) fail(d, "truncated DRI segment");
      d->restart_interval = (s[0] << 8) | s[1];
    } else if (m == 0xDA) {
      if (!d->sof) fail(d, "corrupt file (a scan before the frame header)");
      if (header_only) return;
      if (!d->comp[0].coef) {
        for (int c = 0; c < d->ncomp; ++c) {
          comp_t* k = &d->comp[c];
          k->dw = (int)(((long)d->W * k->h + d->hmax - 1) / d->hmax);
          k->dh = (int)(((long)d->H * k->v + d->vmax - 1) / d->vmax);
          k->bw = d->mcux * k->h;
          k->bh = d->mcuy * k->v;
          k->coef = alloc(d, (size_t)k->bw * k->bh * 64 * sizeof(int16_t));
        }
      }
      parse_sos(d);
    } else if (m == 0xD9) {
      break;
    } else if (m == 0xDC) {
      fail(d, "a DNL marker is not supported");
    } else if (m >= 0xD0 && m <= 0xD7) {
      fail(d, "corrupt file (restart marker RST%d outside a scan)", m - 0xD0);
    } else if (m == 0xD8) {
      fail(d, "corrupt file (a second SOI marker)");
    } else if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) {
      parse_app(d, m);
    } else if (m == 0x01) {
      continue;  /* TEM: no payload */
    } else {
      int len;
      segment(d, &len);
    }
  }
  if (!d->sof) fail(d, "corrupt file (no frame header before EOI)");
  for (int c = 0; c < d->ncomp; ++c) {
    const comp_t* k = &d->comp[c];
    if (!k->coded) fail(d, "corrupt file (component %d has no scan)", k->id);
    for (int i = 0; d->progressive && i < 64; ++i)
      if (k->coef_bits[i] != 0)
        fail(d, "progressive JPEG whose scans leave coefficient %d of component %d %s: "
                "libjpeg would smooth its blocks (not supported)", i, k->id,
             k->coef_bits[i] < 0 ? "never sent" : "without its last bits");
  }
}

static void init(dec_t* d, const uint8_t* data, size_t size, char* err, int errlen) {
  memset(d, 0, sizeof(*d));
  d->data = data;
  d->end = data + size;
  d->err = err;
  d->errlen = errlen;
  if (errlen > 0) err[0] = 0;
}

int jpeg_header(const uint8_t* data, size_t size, int* width, int* height, int* channels,
                char* err, int errlen) {
  dec_t* d = calloc(1, sizeof(dec_t));
  if (!d) {
    snprintf(err, (size_t)errlen, "out of memory");
    return 1;
  }
  init(d, data, size, err, errlen);
  if (setjmp(d->jb)) {
    free_all(d);
    free(d);
    return 1;
  }
  run(d, 1);
  *width = d->W;
  *height = d->H;
  *channels = d->ncomp;
  free(d);
  return 0;
}

int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                int channels, char* err, int errlen) {
  dec_t* d = calloc(1, sizeof(dec_t));
  if (!d) {
    snprintf(err, (size_t)errlen, "out of memory");
    return 1;
  }
  init(d, data, size, err, errlen);
  if (setjmp(d->jb)) {
    free_all(d);
    free(d);
    return 1;
  }
  run(d, 0);
  if (d->W != width || d->H != height || d->ncomp != channels)
    fail(d, "header mismatch (%dx%dx%d, asked for %dx%dx%d)", d->W, d->H, d->ncomp, width,
         height, channels);
  for (int c = 0; c < d->ncomp; ++c) {
    comp_t* k = &d->comp[c];
    const int pw = k->bw * 8;
    k->plane = alloc(d, (size_t)pw * k->bh * 8);
    for (int by = 0; by < k->bh; ++by)
      for (int bx = 0; bx < k->bw; ++bx)
        idct_islow(k->coef + ((size_t)by * k->bw + bx) * 64, k->q,
                   k->plane + (size_t)by * 8 * pw + bx * 8, pw);
  }
  convert(d, out);
  free_all(d);
  free(d);
  return 0;
}
