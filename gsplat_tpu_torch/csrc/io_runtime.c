/* io_runtime: the port's native IO runtime, in plain C with pthreads.
 *
 * COLMAP binary readers, PNG and JPEG decode, a bilinear resize to float32
 * RGB composited over a background, and a prefetching pool of worker
 * threads that decodes a list of frames ahead of their use. Scene's
 * predecode runs every camera image of a capture through it
 * (scene.py::_predecode_images_native). The C entry points and their
 * results are those of the JAX package's IO library (libjpeg, libpng and
 * zlib behind the same ABI); this file needs nothing beyond libc and
 * pthreads. Host code (no CUDA), built by _build.py's host route together
 * with jpeg_decode.c into build/host/ and loaded with ctypes
 * (io/native_loader.py). io/native_loader.py also holds a plain numpy
 * version of the decode and the resize, which the tests hold this file to.
 *
 * PNG: the file as libpng reads it with the transforms the JAX library
 * asks for (png_set_strip_16, png_set_palette_to_rgb,
 * png_set_expand_gray_1_2_4_to_8, png_set_tRNS_to_alpha,
 * png_set_gray_to_rgb; pngrtran.c png_do_expand_palette, png_do_expand,
 * png_do_gray_to_rgb, png_do_chop): 8-bit RGB, or RGBA where the file has
 * alpha or a tRNS chunk. 16-bit samples keep their high byte; 1, 2 and 4-bit
 * gray scale to 8 bits (x255, x85, x17); a palette expands to RGB, indices
 * past the palette black, entries past a short tRNS opaque; a gray or RGB
 * tRNS key is compared at the file's own depth (masked to it, as
 * png_do_expand masks it) before the strip; Adam7 files de-interlace. The
 * chunk rules are libpng's where they decide whether a file decodes: a bad
 * signature, a missing or invalid IHDR, an invalid chunk name, a CRC error
 * in a critical chunk, an unknown critical chunk, a palette image without
 * PLTE, an IEND before the image data, a bad row filter, a truncated file
 * or a zlib stream that is damaged, ends early or never ends fail; a CRC
 * error in an ancillary chunk drops that chunk, an invalid or misplaced
 * tRNS is ignored, a PLTE after a gray or RGB tRNS cancels it, and nothing
 * after the IDAT chunks the image needs is read. The zlib stream is
 * inflated here (RFC 1950/1951: stored, fixed and dynamic blocks,
 * zlib's rules for incomplete codes, the Adler-32 check); data after its
 * end and decompressed bytes past the image are ignored, as libpng ignores
 * them. One difference: an Adler-32 mismatch always fails here, where
 * libpng only warns if it meets it after the image's last row left zlib's
 * input buffer.
 *
 * JPEG: jpeg_decode.c's decoder (libjpeg-turbo's bits), asked for RGB as
 * the JAX library asks libjpeg for JCS_RGB: a grayscale file comes out
 * replicated to RGB; a CMYK or YCCK file fails (libjpeg refuses that
 * conversion), as does whatever jpeg_decode.c refuses.
 *
 * Compile with -ffp-contract=off: resize_to_float's expression must round
 * once per operation, as the JAX library's does on x86-64.
 */

#include <ctype.h>
#include <pthread.h>
#include <setjmp.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* jpeg_decode.c, compiled into the same library */
int jpeg_header(const uint8_t* data, size_t size, int* width, int* height, int* channels,
                char* err, int errlen);
int jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, int width, int height,
                int channels, char* err, int errlen);

/* ---- COLMAP binary readers ---- */

typedef struct {
  int32_t camera_id;
  int32_t model_id;
  uint64_t width, height;
  double params[12]; /* the most any model takes (FULL_OPENCV, THIN_PRISM_FISHEYE) */
  int32_t num_params;
} ColmapCamera;

typedef struct {
  int32_t image_id;
  double qvec[4];
  double tvec[3];
  int32_t camera_id;
  char name[256];
  uint64_t num_points2d;
} ColmapImageMeta;

/* SIMPLE_PINHOLE .. THIN_PRISM_FISHEYE */
static const int kCameraModelNumParams[] = {3, 4, 4, 5, 8, 8, 12, 5, 4, 5, 12};

typedef struct {
  FILE* f;
  int ok;
} reader_t;

/* n bytes into v (little-endian host), or zeros once a read has failed */
static void rd(reader_t* r, void* v, size_t n) {
  memset(v, 0, n);
  if (r->ok && fread(v, n, 1, r->f) != 1) r->ok = 0;
}

static int32_t rd_i32(reader_t* r) { int32_t v; rd(r, &v, 4); return v; }
static uint64_t rd_u64(reader_t* r) { uint64_t v; rd(r, &v, 8); return v; }
static double rd_f64(reader_t* r) { double v; rd(r, &v, 8); return v; }

static void skip(reader_t* r, uint64_t n) {
  if (r->ok && fseek(r->f, (long)n, SEEK_CUR) != 0) r->ok = 0;
}

/* cameras.bin -> the number of cameras (or -1), out[] filled up to max_out */
int colmap_read_cameras_bin(const char* path, ColmapCamera* out, int max_out) {
  reader_t r = {fopen(path, "rb"), 1};
  if (!r.f) return -1;
  const uint64_t n = rd_u64(&r);
  for (uint64_t i = 0; i < n && r.ok; ++i) {
    ColmapCamera c;
    memset(&c, 0, sizeof c);
    c.camera_id = rd_i32(&r);
    c.model_id = rd_i32(&r);
    c.width = rd_u64(&r);
    c.height = rd_u64(&r);
    const int np = (c.model_id >= 0 && c.model_id < 11) ? kCameraModelNumParams[c.model_id] : 0;
    c.num_params = np;
    for (int p = 0; p < np; ++p) c.params[p] = rd_f64(&r);
    if ((int)i < max_out) out[i] = c;
  }
  fclose(r.f);
  return r.ok ? (int)n : -1;
}

/* images.bin -> the number of images (or -1); each image's 2-D points are
 * skipped over */
int colmap_read_images_bin(const char* path, ColmapImageMeta* out, int max_out) {
  reader_t r = {fopen(path, "rb"), 1};
  if (!r.f) return -1;
  const uint64_t n = rd_u64(&r);
  for (uint64_t i = 0; i < n && r.ok; ++i) {
    ColmapImageMeta m;
    memset(&m, 0, sizeof m);
    m.image_id = rd_i32(&r);
    for (int k = 0; k < 4; ++k) m.qvec[k] = rd_f64(&r);
    for (int k = 0; k < 3; ++k) m.tvec[k] = rd_f64(&r);
    m.camera_id = rd_i32(&r);
    int pos = 0;
    for (;;) {
      char ch;
      rd(&r, &ch, 1);
      if (!r.ok || ch == '\0') break;
      if (pos < 255) m.name[pos++] = ch;
    }
    m.name[pos] = '\0';
    m.num_points2d = rd_u64(&r);
    skip(&r, m.num_points2d * 24); /* (x, y, point3D_id) */
    if ((int)i < max_out) out[i] = m;
  }
  fclose(r.f);
  return r.ok ? (int)n : -1;
}

/* points3D.bin -> xyz (n, 3) float64, rgb (n, 3) uint8, err (n,) float64
 * (err may be null); null xyz asks for the count alone */
int64_t colmap_read_points3d_bin(const char* path, double* xyz, uint8_t* rgb, double* err,
                                 int64_t max_out) {
  reader_t r = {fopen(path, "rb"), 1};
  if (!r.f) return -1;
  const uint64_t n = rd_u64(&r);
  if (!xyz) {
    fclose(r.f);
    return (int64_t)n;
  }
  for (uint64_t i = 0; i < n && r.ok; ++i) {
    (void)rd_u64(&r); /* point id */
    const double x = rd_f64(&r), y = rd_f64(&r), z = rd_f64(&r);
    uint8_t c[3];
    rd(&r, c, 3);
    const double e = rd_f64(&r);
    skip(&r, rd_u64(&r) * 8); /* the track: (image_id, point2D_idx) */
    if ((int64_t)i < max_out) {
      xyz[i * 3 + 0] = x, xyz[i * 3 + 1] = y, xyz[i * 3 + 2] = z;
      rgb[i * 3 + 0] = c[0], rgb[i * 3 + 1] = c[1], rgb[i * 3 + 2] = c[2];
      if (err) err[i] = e;
    }
  }
  fclose(r.f);
  return r.ok ? (int64_t)n : -1;
}

/* ---- inflate (RFC 1950 zlib stream of RFC 1951 deflate blocks) ---- */

#define HLOOK 9 /* bits a table lookup decodes at once */

typedef struct {
  int16_t count[16];         /* codes of each length */
  int16_t symbol[288];       /* symbols in canonical order */
  uint16_t look[1 << HLOOK]; /* next HLOOK bits -> (length << 9) | symbol; 0: slow path */
} huff_t;

typedef struct {
  const uint8_t* in; /* the current piece of input */
  size_t pos, len;
  /* the next piece (a PNG's next IDAT chunk); nonzero: there is none */
  int (*refill)(void* ctx, const uint8_t** in, size_t* len);
  void* ctx;
  uint32_t bitbuf;
  int bitcnt;
  uint8_t* out; /* growable where `grow` */
  size_t outlen, outcap, outmax;
  int grow;
  jmp_buf jb;
} inflate_t;

static void ifail(inflate_t* s) { longjmp(s->jb, 1); }

static int next_byte(inflate_t* s) {
  while (s->pos == s->len) {
    if (!s->refill || s->refill(s->ctx, &s->in, &s->len)) ifail(s);
    s->pos = 0;
  }
  return s->in[s->pos++];
}

static uint32_t bits(inflate_t* s, int n) {
  while (s->bitcnt < n) {
    s->bitbuf |= (uint32_t)next_byte(s) << s->bitcnt;
    s->bitcnt += 8;
  }
  const uint32_t v = s->bitbuf & ((1u << n) - 1);
  s->bitbuf >>= n;
  s->bitcnt -= n;
  return v;
}

static void put(inflate_t* s, uint8_t b) {
  if (s->outlen == s->outcap) {
    if (!s->grow || s->outcap >= s->outmax) ifail(s);
    size_t cap = s->outcap * 2 < s->outmax ? s->outcap * 2 : s->outmax;
    uint8_t* q = realloc(s->out, cap);
    if (!q) ifail(s);
    s->out = q;
    s->outcap = cap;
  }
  s->out[s->outlen++] = b;
}

/* Canonical code from n code lengths: <0 over-subscribed, >0 incomplete
 * (the codes left unused), 0 complete (or no codes at all). */
static int construct(huff_t* h, const uint8_t* length, int n) {
  memset(h, 0, sizeof *h);
  for (int i = 0; i < n; ++i) h->count[length[i]]++;
  if (h->count[0] == n) return 0;
  int left = 1;
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h->count[len];
    if (left < 0) return left;
  }
  int16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = (int16_t)(offs[len] + h->count[len]);
  for (int i = 0; i < n; ++i)
    if (length[i]) h->symbol[offs[length[i]]++] = (int16_t)i;
  /* the table: codes are sent high bit first, so an entry's index is the
   * code reversed */
  int code = 0, index = 0;
  for (int len = 1; len <= HLOOK; ++len) {
    for (int k = 0; k < h->count[len]; ++k, ++code, ++index) {
      int rev = 0;
      for (int b = 0; b < len; ++b) rev |= ((code >> b) & 1) << (len - 1 - b);
      for (int i = rev; i < (1 << HLOOK); i += 1 << len)
        h->look[i] = (uint16_t)((len << 9) | h->symbol[index]);
    }
    code <<= 1;
  }
  return left;
}

static int decode(inflate_t* s, const huff_t* h) {
  /* top up from the current piece only: the next is fetched when a bit of
   * it is needed, as zlib under libpng fetches it */
  while (s->bitcnt < HLOOK && s->pos < s->len) {
    s->bitbuf |= (uint32_t)s->in[s->pos++] << s->bitcnt;
    s->bitcnt += 8;
  }
  if (s->bitcnt >= HLOOK) {
    const uint16_t e = h->look[s->bitbuf & ((1u << HLOOK) - 1)];
    if (e >> 9) {
      s->bitbuf >>= e >> 9;
      s->bitcnt -= e >> 9;
      return e & 511;
    }
  }
  int code = 0, first = 0, index = 0; /* a bit at a time */
  for (int len = 1; len < 16; ++len) {
    code |= (int)bits(s, 1);
    const int count = h->count[len];
    if (code - count < first) return h->symbol[index + (code - first)];
    index += count;
    first += count;
    first <<= 1;
    code <<= 1;
  }
  ifail(s); /* no code of 15 bits or fewer: an incomplete code */
  return -1;
}

static const int16_t kLenBase[29] = {3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
                                     31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const int16_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
                                      2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const int16_t kDistBase[30] = {1,    2,    3,    4,    5,    7,     9,     13,    17,  25,
                                      33,   49,   65,   97,   129,  193,   257,   385,   513, 769,
                                      1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385,
                                      24577};
static const int16_t kDistExtra[30] = {0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
                                       6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

static void codes(inflate_t* s, const huff_t* lencode, const huff_t* distcode) {
  for (;;) {
    int sym = decode(s, lencode);
    if (sym < 256) {
      put(s, (uint8_t)sym);
    } else if (sym == 256) {
      return;
    } else {
      sym -= 257;
      if (sym >= 29) ifail(s); /* invalid literal/length code */
      const int len = kLenBase[sym] + (int)bits(s, kLenExtra[sym]);
      const int dsym = decode(s, distcode);
      if (dsym >= 30) ifail(s); /* invalid distance code */
      const size_t dist = (size_t)kDistBase[dsym] + bits(s, kDistExtra[dsym]);
      if (dist > s->outlen) ifail(s); /* distance too far back */
      for (int k = 0; k < len; ++k) put(s, s->out[s->outlen - dist]);
    }
  }
}

static void stored(inflate_t* s) {
  s->bitbuf >>= s->bitcnt & 7; /* to a byte boundary */
  s->bitcnt -= s->bitcnt & 7;
  const uint32_t len = bits(s, 16), nlen = bits(s, 16);
  if (len != (~nlen & 0xffffu)) ifail(s);
  for (uint32_t k = 0; k < len; ++k) put(s, (uint8_t)(s->bitcnt ? bits(s, 8) : (uint32_t)next_byte(s)));
}

static void fixed(inflate_t* s) {
  huff_t lencode, distcode;
  uint8_t length[288];
  int i = 0;
  for (; i < 144; ++i) length[i] = 8;
  for (; i < 256; ++i) length[i] = 9;
  for (; i < 280; ++i) length[i] = 7;
  for (; i < 288; ++i) length[i] = 8;
  construct(&lencode, length, 288);
  for (i = 0; i < 32; ++i) length[i] = 5; /* 30 and 31 decode, then fail */
  construct(&distcode, length, 32);
  codes(s, &lencode, &distcode);
}

static void dynamic(inflate_t* s) {
  static const uint8_t order[19] = {16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};
  uint8_t length[320];
  huff_t lencode, distcode;
  const int nlen = (int)bits(s, 5) + 257, ndist = (int)bits(s, 5) + 1, ncode = (int)bits(s, 4) + 4;
  if (nlen > 286 || ndist > 30) ifail(s);
  memset(length, 0, sizeof length);
  for (int i = 0; i < ncode; ++i) length[order[i]] = (uint8_t)bits(s, 3);
  if (construct(&lencode, length, 19) != 0) ifail(s); /* the code lengths' code must be complete */
  int i = 0;
  while (i < nlen + ndist) {
    int sym = decode(s, &lencode);
    if (sym < 16) {
      length[i++] = (uint8_t)sym;
      continue;
    }
    int len = 0, rep;
    if (sym == 16) {
      if (i == 0) ifail(s); /* a repeat with no length before it */
      len = length[i - 1];
      rep = 3 + (int)bits(s, 2);
    } else if (sym == 17) {
      rep = 3 + (int)bits(s, 3);
    } else {
      rep = 11 + (int)bits(s, 7);
    }
    if (i + rep > nlen + ndist) ifail(s);
    while (rep--) length[i++] = (uint8_t)len;
  }
  if (length[256] == 0) ifail(s); /* no end-of-block code */
  int err = construct(&lencode, length, nlen);
  /* an incomplete code only where it is a single code of one bit (zlib) */
  if (err && (err < 0 || nlen != lencode.count[0] + lencode.count[1])) ifail(s);
  err = construct(&distcode, length + nlen, ndist);
  if (err && (err < 0 || ndist != distcode.count[0] + distcode.count[1])) ifail(s);
  codes(s, &lencode, &distcode);
}

static uint32_t adler32(const uint8_t* p, size_t n) {
  uint32_t a = 1, b = 0;
  while (n) {
    size_t k = n < 5552 ? n : 5552;
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

/* The zlib stream from s's input into s's output: 0, or -1 if it is
 * damaged, ends early or does not fit. */
static int inflate_run(inflate_t* s) {
  if (setjmp(s->jb)) return -1;
  const int cmf = next_byte(s), flg = next_byte(s);
  /* method 8, a window of at most 32K, the check bits, no preset dictionary */
  if ((cmf & 15) != 8 || (cmf >> 4) > 7 || ((cmf << 8) | flg) % 31 || (flg & 32)) ifail(s);
  int last;
  do {
    last = (int)bits(s, 1);
    const int type = (int)bits(s, 2);
    if (type == 0) stored(s);
    else if (type == 1) fixed(s);
    else if (type == 2) dynamic(s);
    else ifail(s);
  } while (!last);
  s->bitbuf >>= s->bitcnt & 7;
  s->bitcnt -= s->bitcnt & 7;
  uint32_t want = 0;
  for (int k = 0; k < 4; ++k) want = (want << 8) | bits(s, 8);
  if (adler32(s->out, s->outlen) != want) ifail(s);
  return 0;
}

/* A whole zlib stream in memory -> its length in out[cap], or -1 if it is
 * damaged, truncated or longer than cap. */
int64_t io_inflate(const uint8_t* data, size_t size, uint8_t* out, size_t cap) {
  inflate_t* s = calloc(1, sizeof *s);
  if (!s) return -1;
  s->in = data;
  s->len = size;
  s->out = out;
  s->outcap = s->outmax = cap;
  const int64_t n = inflate_run(s) == 0 ? (int64_t)s->outlen : -1;
  free(s);
  return n;
}

/* ---- PNG ---- */

typedef struct {
  int w, h, channels; /* channels 3 (RGB) or 4 (RGBA) */
  uint8_t* pixels;    /* h * w * channels */
} image_t;

static uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

static uint32_t crc_table[256];
static pthread_once_t crc_once = PTHREAD_ONCE_INIT;

static void crc_init(void) {
  for (uint32_t n = 0; n < 256; ++n) {
    uint32_t c = n;
    for (int k = 0; k < 8; ++k) c = c & 1 ? 0xedb88320u ^ (c >> 1) : c >> 1;
    crc_table[n] = c;
  }
}

static uint32_t crc32_of(const uint8_t* p, size_t n) {
  pthread_once(&crc_once, crc_init);
  uint32_t c = 0xffffffffu;
  for (size_t i = 0; i < n; ++i) c = crc_table[(c ^ p[i]) & 255] ^ (c >> 8);
  return c ^ 0xffffffffu;
}

static int chunk_name_ok(const uint8_t* t) {
  for (int i = 0; i < 4; ++i)
    if (!((t[i] >= 'A' && t[i] <= 'Z') || (t[i] >= 'a' && t[i] <= 'z'))) return 0;
  return 1;
}

/* the IDAT chunks the stream runs through: the file and the next header */
typedef struct {
  const uint8_t* data;
  size_t size, next;
} idat_src_t;

/* The IDAT chunk at src->next, its CRC checked: 0, or nonzero where the
 * file ends, the chunk is no IDAT, its name is invalid or its CRC wrong. */
static int next_idat(void* ctx, const uint8_t** in, size_t* len) {
  idat_src_t* src = ctx;
  const size_t at = src->next;
  if (src->size - at < 8) return 1;
  const uint32_t n = be32(src->data + at);
  const uint8_t* name = src->data + at + 4;
  if (n > 0x7fffffffu || !chunk_name_ok(name) || memcmp(name, "IDAT", 4) != 0) return 1;
  if (src->size - at - 8 < (size_t)n + 4) return 1;
  if (crc32_of(name, (size_t)n + 4) != be32(name + 4 + n)) return 1;
  *in = name + 4;
  *len = n;
  src->next = at + 12 + n;
  return 0;
}

/* Adam7: (x0, y0, dx, dy) of each pass's pixels */
static const int kAdam7[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                                 {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};

static int paeth(int a, int b, int c) {
  const int p = a + b - c;
  const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  return (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
}

typedef struct {
  int depth, ctype, out_channels;
  const uint8_t* palette; /* 256 x RGB, zeros past the file's palette */
  const uint8_t* trans_alpha;
  int num_trans;
  uint16_t key[3]; /* the gray or RGB tRNS key, at the file's depth */
} pngfmt_t;

/* one sample of a row at the file's depth */
static int sample(const uint8_t* row, int i, int depth) {
  if (depth == 8) return row[i];
  if (depth == 16) return (row[2 * i] << 8) | row[2 * i + 1];
  const int per = 8 / depth, shift = 8 - depth * (i % per + 1);
  return (row[i / per] >> shift) & ((1 << depth) - 1);
}

/* One unfiltered row's pixels -> 8-bit RGB or RGBA (libpng's transforms). */
static void transform_row(const pngfmt_t* f, const uint8_t* row, int n, uint8_t* out, int stride) {
  const int d = f->depth, oc = f->out_channels;
  for (int x = 0; x < n; ++x, out += stride) {
    if (f->ctype == 3) {
      const int i = sample(row, x, d);
      memcpy(out, f->palette + 3 * i, 3);
      if (oc == 4) out[3] = i < f->num_trans ? f->trans_alpha[i] : 255;
    } else if (f->ctype == 0) {
      const int v = sample(row, x, d);
      const int g = d == 16 ? v >> 8 : d == 8 ? v : v * (255 / ((1 << d) - 1));
      out[0] = out[1] = out[2] = (uint8_t)g;
      if (oc == 4) out[3] = v == f->key[0] ? 0 : 255;
    } else if (f->ctype == 2) {
      int v[3];
      for (int k = 0; k < 3; ++k) v[k] = sample(row, 3 * x + k, d);
      for (int k = 0; k < 3; ++k) out[k] = (uint8_t)(d == 16 ? v[k] >> 8 : v[k]);
      if (oc == 4) out[3] = (v[0] == f->key[0] && v[1] == f->key[1] && v[2] == f->key[2]) ? 0 : 255;
    } else {
      const int c = f->ctype == 4 ? 2 : 4; /* gray+alpha, RGBA */
      for (int k = 0; k < c; ++k) {
        const int v = sample(row, c * x + k, d);
        const uint8_t b = (uint8_t)(d == 16 ? v >> 8 : v);
        if (c == 2 && k == 0) out[0] = out[1] = out[2] = b;
        else out[c == 2 ? 3 : k] = b;
      }
    }
  }
}

/* The PNG file in memory -> out, as libpng reads it (the module comment). */
static int decode_png_mem(const uint8_t* data, size_t size, image_t* out) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || memcmp(data, sig, 8) != 0) return -1;
  uint8_t palette[768], trans_alpha[256];
  memset(palette, 0, sizeof palette);
  memset(trans_alpha, 255, sizeof trans_alpha);
  uint32_t width = 0, height = 0;
  int depth = 0, ctype = 0, interlace = 0, have_ihdr = 0, have_plte = 0, num_palette = 0;
  int trns_valid = 0, num_trans = 0;
  uint16_t key[3] = {0, 0, 0};
  size_t at = 8;
  for (;;) { /* the chunks before the first IDAT */
    if (size - at < 8) return -1;
    const uint32_t n = be32(data + at);
    const uint8_t* name = data + at + 4;
    if (n > 0x7fffffffu || !chunk_name_ok(name)) return -1;
    if (memcmp(name, "IDAT", 4) == 0) {
      if (!have_ihdr || (ctype == 3 && !have_plte)) return -1;
      break;
    }
    if (size - at - 8 < (size_t)n + 4) return -1;
    const uint8_t* body = name + 4;
    const int crc_ok = crc32_of(name, (size_t)n + 4) == be32(body + n);
    const int critical = !(name[0] & 32);
    at += 12 + (size_t)n;
    if (critical && !crc_ok) return -1;
    if (memcmp(name, "IHDR", 4) == 0) {
      if (have_ihdr || n != 13) return -1;
      width = be32(body);
      height = be32(body + 4);
      depth = body[8];
      ctype = body[9];
      interlace = body[12];
      int depth_ok;
      switch (ctype) {
        case 0: depth_ok = depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16; break;
        case 3: depth_ok = depth == 1 || depth == 2 || depth == 4 || depth == 8; break;
        case 2: case 4: case 6: depth_ok = depth == 8 || depth == 16; break;
        default: depth_ok = 0;
      }
      /* libpng's default user limits: 10^6 pixels a side */
      if (!depth_ok || width == 0 || height == 0 || width > 1000000u || height > 1000000u ||
          body[10] != 0 || body[11] != 0 || interlace > 1)
        return -1;
      have_ihdr = 1;
    } else if (!have_ihdr) {
      return -1;
    } else if (memcmp(name, "IEND", 4) == 0) {
      return -1; /* no image data */
    } else if (memcmp(name, "PLTE", 4) == 0) {
      if (have_plte) return -1;
      have_plte = 1;
      if (!(ctype & 2)) continue; /* ignored in a gray image */
      if (n > 768 || n % 3) {
        if (ctype == 3) return -1;
        continue;
      }
      int num = (int)n / 3;
      if (ctype == 3 && num > (1 << depth)) num = 1 << depth;
      if (num == 0) return -1;
      memcpy(palette, body, 3 * (size_t)num);
      num_palette = num;
      if (trns_valid) num_trans = 0; /* a tRNS must follow the PLTE */
    } else if (memcmp(name, "tRNS", 4) == 0) {
      if (trns_valid || !crc_ok) continue;
      if (ctype == 0 && n == 2) {
        key[0] = (uint16_t)((body[0] << 8) | body[1]);
        num_trans = 1;
      } else if (ctype == 2 && n == 6) {
        for (int k = 0; k < 3; ++k) key[k] = (uint16_t)((body[2 * k] << 8) | body[2 * k + 1]);
        num_trans = 1;
      } else if (ctype == 3 && have_plte && n > 0 && (int)n <= num_palette) {
        memcpy(trans_alpha, body, n);
        num_trans = (int)n;
      } else {
        continue; /* invalid, misplaced, or in an image with alpha */
      }
      trns_valid = 1;
    } else if (critical) {
      return -1; /* an unknown critical chunk */
    }
  }
  /* the key at the file's depth, masked as png_do_expand masks it */
  const int mask = depth == 16 ? 0xffff : (1 << depth) - 1;
  for (int k = 0; k < 3; ++k) key[k] = (uint16_t)(key[k] & mask);
  const int channels = ctype == 2 ? 3 : ctype == 4 ? 2 : ctype == 6 ? 4 : 1;
  const int oc = (ctype == 4 || ctype == 6 || num_trans > 0) ? 4 : 3;
  const int bpp = (channels * depth + 7) / 8; /* bytes a filter steps back */
  size_t want = 0;
  const int npass = interlace ? 7 : 1;
  size_t pw[7], ph[7], stride[7];
  for (int p = 0; p < npass; ++p) {
    const int x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    const int dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    pw[p] = width > (uint32_t)x0 ? (width - x0 + dx - 1) / dx : 0;
    ph[p] = height > (uint32_t)y0 ? (height - y0 + dy - 1) / dy : 0;
    stride[p] = (pw[p] * channels * depth + 7) / 8;
    if (pw[p] && ph[p]) want += ph[p] * (stride[p] + 1);
  }

  int rc = -1;
  uint8_t* pixels = NULL;
  uint8_t* prev = NULL;
  inflate_t* s = calloc(1, sizeof *s);
  idat_src_t src = {data, size, at};
  if (!s) goto done;
  s->refill = next_idat;
  s->ctx = &src;
  s->grow = 1;
  s->outcap = want;
  s->outmax = want + ((size_t)1 << 26); /* decompressed bytes past the image: at most 64 MiB */
  s->out = malloc(want);
  if (!s->out || next_idat(&src, &s->in, &s->len) || inflate_run(s) || s->outlen < want) goto done;
  pixels = malloc((size_t)width * height * oc);
  prev = calloc(((size_t)width * channels * depth + 7) / 8 + 1, 1);
  if (!pixels || !prev) goto done;
  const pngfmt_t fmt = {depth, ctype, oc, palette, trans_alpha, num_trans, {key[0], key[1], key[2]}};
  uint8_t* raw = s->out;
  for (int p = 0; p < npass; ++p) {
    if (!pw[p] || !ph[p]) continue;
    const size_t st = stride[p];
    const int x0 = interlace ? kAdam7[p][0] : 0, y0 = interlace ? kAdam7[p][1] : 0;
    const int dx = interlace ? kAdam7[p][2] : 1, dy = interlace ? kAdam7[p][3] : 1;
    memset(prev, 0, st);
    for (size_t r = 0; r < ph[p]; ++r, raw += st + 1) {
      const int ft = raw[0];
      uint8_t* row = raw + 1;
      if (ft > 4) goto done; /* an unknown filter type */
      for (size_t i = 0; i < st; ++i) {
        const int a = i >= (size_t)bpp ? row[i - bpp] : 0, b = prev[i];
        const int c = i >= (size_t)bpp ? prev[i - bpp] : 0;
        switch (ft) {
          case 0: break;
          case 1: row[i] = (uint8_t)(row[i] + a); break;
          case 2: row[i] = (uint8_t)(row[i] + b); break;
          case 3: row[i] = (uint8_t)(row[i] + ((a + b) >> 1)); break;
          default: row[i] = (uint8_t)(row[i] + paeth(a, b, c)); break;
        }
      }
      memcpy(prev, row, st);
      transform_row(&fmt, row, (int)pw[p],
                    pixels + (((size_t)(y0 + r * dy)) * width + x0) * oc, dx * oc);
    }
  }
  out->w = (int)width;
  out->h = (int)height;
  out->channels = oc;
  out->pixels = pixels;
  pixels = NULL;
  rc = 0;
done:
  if (s) free(s->out);
  free(s);
  free(prev);
  free(pixels);
  return rc;
}

/* ---- the image front end ---- */

static uint8_t* read_file(const char* path, size_t* size) {
  FILE* f = fopen(path, "rb");
  if (!f) return NULL;
  size_t cap = 1 << 16, n = 0;
  uint8_t* buf = malloc(cap);
  while (buf) {
    n += fread(buf + n, 1, cap - n, f);
    if (n < cap) break;
    uint8_t* q = realloc(buf, cap * 2);
    if (!q) {
      free(buf);
      buf = NULL;
      break;
    }
    buf = q;
    cap *= 2;
  }
  const int bad = ferror(f);
  fclose(f);
  if (bad) {
    free(buf);
    return NULL;
  }
  *size = n;
  return buf;
}

static int decode_png(const char* path, image_t* out) {
  size_t n;
  uint8_t* data = read_file(path, &n);
  if (!data) return -1;
  const int rc = decode_png_mem(data, n, out);
  free(data);
  return rc;
}

static int decode_jpeg(const char* path, image_t* out) {
  size_t n;
  uint8_t* data = read_file(path, &n);
  if (!data) return -1;
  char err[256];
  int w, h, c, rc = -1;
  uint8_t* px = NULL;
  if (jpeg_header(data, n, &w, &h, &c, err, sizeof err) || (c != 1 && c != 3)) goto done;
  px = malloc((size_t)w * h * 3);
  if (!px || jpeg_decode(data, n, px, w, h, c, err, sizeof err)) goto done;
  if (c == 1) /* gray replicated to RGB, in place from the end */
    for (size_t i = (size_t)w * h; i-- > 0;) px[3 * i] = px[3 * i + 1] = px[3 * i + 2] = px[i];
  out->w = w;
  out->h = h;
  out->channels = 3;
  out->pixels = px;
  px = NULL;
  rc = 0;
done:
  free(px);
  free(data);
  return rc;
}

static int has_suffix(const char* s, const char* suf) {
  const size_t n = strlen(s), k = strlen(suf);
  if (n < k) return 0;
  for (size_t i = 0; i < k; ++i)
    if (tolower((unsigned char)s[n - k + i]) != suf[i]) return 0;
  return 1;
}

/* PNG or JPEG by the path's suffix (any case); the first bytes decide
 * only where the suffix is neither */
static int decode_any(const char* path, image_t* out) {
  if (has_suffix(path, ".png")) return decode_png(path, out);
  if (has_suffix(path, ".jpg") || has_suffix(path, ".jpeg")) return decode_jpeg(path, out);
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  uint8_t magic[4] = {0, 0, 0, 0};
  const size_t got = fread(magic, 1, 4, f);
  fclose(f);
  if (got >= 4 && magic[0] == 0x89 && magic[1] == 'P') return decode_png(path, out);
  if (got >= 2 && magic[0] == 0xFF && magic[1] == 0xD8) return decode_jpeg(path, out);
  return -1;
}

/* Bilinear resize (pixel centres, edge rows and columns clamped), float32
 * in [0, 1], RGBA composited over bg: the JAX library's expression in its
 * order. */
static void resize_to_float(const image_t* src, int dst_w, int dst_h, const float* bg,
                            float* dst) {
  const float sx = (float)src->w / dst_w;
  const float sy = (float)src->h / dst_h;
  const int c = src->channels;
  for (int y = 0; y < dst_h; ++y) {
    const float fy = (y + 0.5f) * sy - 0.5f;
    const int y0 = fy < 0 ? 0 : (int)fy;
    const int y1 = y0 + 1 < src->h ? y0 + 1 : src->h - 1;
    float wy = fy - y0;
    if (wy < 0) wy = 0;
    for (int x = 0; x < dst_w; ++x) {
      const float fx = (x + 0.5f) * sx - 0.5f;
      const int x0 = fx < 0 ? 0 : (int)fx;
      const int x1 = x0 + 1 < src->w ? x0 + 1 : src->w - 1;
      float wx = fx - x0;
      if (wx < 0) wx = 0;
      float px[4] = {0, 0, 0, 255.0f};
      for (int k = 0; k < c; ++k) {
        const float v00 = src->pixels[((size_t)y0 * src->w + x0) * c + k];
        const float v01 = src->pixels[((size_t)y0 * src->w + x1) * c + k];
        const float v10 = src->pixels[((size_t)y1 * src->w + x0) * c + k];
        const float v11 = src->pixels[((size_t)y1 * src->w + x1) * c + k];
        px[k] = (v00 * (1 - wx) + v01 * wx) * (1 - wy) + (v10 * (1 - wx) + v11 * wx) * wy;
      }
      float* o = dst + ((size_t)y * dst_w + x) * 3;
      if (c == 4) {
        const float a = px[3] / 255.0f;
        for (int k = 0; k < 3; ++k) o[k] = (px[k] / 255.0f) * a + bg[k] * (1.0f - a);
      } else {
        for (int k = 0; k < 3; ++k) o[k] = px[k] / 255.0f;
      }
    }
  }
}

/* Decode `path`, resize to (w, h) and write float32 RGB into out: 0 or -1. */
int decode_image_f32(const char* path, int w, int h, const float* bg, float* out) {
  image_t img = {0, 0, 0, NULL};
  if (decode_any(path, &img)) return -1;
  resize_to_float(&img, w, h, bg, out);
  free(img.pixels);
  return 0;
}

/* The source's size (a full decode): 0 or -1. */
int image_size(const char* path, int* w, int* h) {
  image_t img = {0, 0, 0, NULL};
  if (decode_any(path, &img)) return -1;
  *w = img.w;
  *h = img.h;
  free(img.pixels);
  return 0;
}

/* ---- the prefetching loader: a pool of workers decoding queued indices ---- */

typedef struct {
  char** paths;
  int n, w, h;
  float bg[3];
  size_t frame_elems;
  pthread_mutex_t mu;
  pthread_cond_t cv;
  float** ready;   /* decoded frames not yet fetched */
  int* pending;    /* queued or decoding requests of each index: get waits on them */
  uint8_t* failed; /* decode errors, reported to get once as -2 */
  int* queue;      /* a ring of requested indices */
  size_t qhead, qlen, qcap;
  pthread_t* workers;
  int nworkers, stop;
} Loader;

static void finish_pending(Loader* L, int idx) { /* with mu held */
  if (L->pending[idx] > 0) L->pending[idx]--;
}

static void* worker(void* arg) {
  Loader* L = arg;
  for (;;) {
    pthread_mutex_lock(&L->mu);
    while (!L->stop && L->qlen == 0) pthread_cond_wait(&L->cv, &L->mu);
    if (L->stop) {
      pthread_mutex_unlock(&L->mu);
      return NULL;
    }
    const int idx = L->queue[L->qhead];
    L->qhead = (L->qhead + 1) % L->qcap;
    L->qlen--;
    if (L->ready[idx]) { /* a duplicate of a frame already decoded */
      finish_pending(L, idx);
      pthread_cond_broadcast(&L->cv);
      pthread_mutex_unlock(&L->mu);
      continue;
    }
    pthread_mutex_unlock(&L->mu);
    float* buf = malloc(L->frame_elems * sizeof(float));
    const int ok = buf && decode_image_f32(L->paths[idx], L->w, L->h, L->bg, buf) == 0;
    pthread_mutex_lock(&L->mu);
    if (ok) {
      free(L->ready[idx]);
      L->ready[idx] = buf;
    } else {
      free(buf);
      L->failed[idx] = 1;
    }
    finish_pending(L, idx);
    pthread_cond_broadcast(&L->cv);
    pthread_mutex_unlock(&L->mu);
  }
}

static void loader_free(Loader* L) {
  for (int i = 0; i < L->n; ++i) {
    if (L->paths) free(L->paths[i]);
    if (L->ready) free(L->ready[i]);
  }
  free(L->paths);
  free(L->ready);
  free(L->pending);
  free(L->failed);
  free(L->queue);
  free(L->workers);
  pthread_cond_destroy(&L->cv);
  pthread_mutex_destroy(&L->mu);
  free(L);
}

Loader* loader_create(const char** paths, int n, int w, int h, const float* bg, int threads) {
  Loader* L = calloc(1, sizeof *L);
  if (!L) return NULL;
  pthread_mutex_init(&L->mu, NULL);
  pthread_cond_init(&L->cv, NULL);
  L->n = n;
  L->w = w;
  L->h = h;
  memcpy(L->bg, bg, sizeof L->bg);
  L->frame_elems = (size_t)w * h * 3;
  if (threads < 1) threads = 1;
  L->paths = calloc((size_t)n + 1, sizeof *L->paths);
  L->ready = calloc((size_t)n + 1, sizeof *L->ready);
  L->pending = calloc((size_t)n + 1, sizeof *L->pending);
  L->failed = calloc((size_t)n + 1, 1);
  L->qcap = 64;
  L->queue = malloc(L->qcap * sizeof *L->queue);
  L->workers = calloc((size_t)threads, sizeof *L->workers);
  if (!L->paths || !L->ready || !L->pending || !L->failed || !L->queue || !L->workers) {
    loader_free(L);
    return NULL;
  }
  for (int i = 0; i < n; ++i)
    if (!(L->paths[i] = strdup(paths[i]))) {
      loader_free(L);
      return NULL;
    }
  for (int i = 0; i < threads; ++i) {
    if (pthread_create(&L->workers[i], NULL, worker, L) != 0) break;
    L->nworkers++;
  }
  if (L->nworkers == 0) {
    loader_free(L);
    return NULL;
  }
  return L;
}

/* Queue indices for the workers (the order they will be used in); an index
 * outside the list is dropped. 0, or -1 out of memory. */
int loader_prefetch(Loader* L, const int* indices, int n) {
  pthread_mutex_lock(&L->mu);
  for (int i = 0; i < n; ++i) {
    const int idx = indices[i];
    if (idx < 0 || idx >= L->n) continue;
    if (L->qlen == L->qcap) { /* grow the ring, its contents in order */
      int* q = malloc(2 * L->qcap * sizeof *q);
      if (!q) {
        pthread_mutex_unlock(&L->mu);
        pthread_cond_broadcast(&L->cv);
        return -1;
      }
      for (size_t k = 0; k < L->qlen; ++k) q[k] = L->queue[(L->qhead + k) % L->qcap];
      free(L->queue);
      L->queue = q;
      L->qhead = 0;
      L->qcap *= 2;
    }
    L->queue[(L->qhead + L->qlen++) % L->qcap] = idx;
    L->pending[idx]++;
  }
  pthread_mutex_unlock(&L->mu);
  pthread_cond_broadcast(&L->cv);
  return 0;
}

/* The frame of idx into out, dropped from the cache: 0; -2 if a worker
 * failed to decode it; for an index no request is pending on, a decode on
 * this thread (0 or -1). A queued or decoding frame is waited for, not
 * decoded twice. */
int loader_get(Loader* L, int idx, float* out) {
  if (idx < 0 || idx >= L->n) return -1;
  pthread_mutex_lock(&L->mu);
  for (;;) {
    if (L->ready[idx]) {
      memcpy(out, L->ready[idx], L->frame_elems * sizeof(float));
      free(L->ready[idx]);
      L->ready[idx] = NULL;
      pthread_mutex_unlock(&L->mu);
      return 0;
    }
    if (L->failed[idx]) {
      L->failed[idx] = 0;
      pthread_mutex_unlock(&L->mu);
      return -2;
    }
    if (!L->pending[idx] || L->stop) break;
    pthread_cond_wait(&L->cv, &L->mu);
  }
  pthread_mutex_unlock(&L->mu);
  return decode_image_f32(L->paths[idx], L->w, L->h, L->bg, out);
}

/* Stop the workers (requests still queued are dropped; a decode under way
 * finishes), join them and free the loader. */
void loader_destroy(Loader* L) {
  pthread_mutex_lock(&L->mu);
  L->stop = 1;
  pthread_mutex_unlock(&L->mu);
  pthread_cond_broadcast(&L->cv);
  for (int i = 0; i < L->nworkers; ++i) pthread_join(L->workers[i], NULL);
  loader_free(L);
}
