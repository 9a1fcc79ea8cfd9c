// Native runtime components: OpenMP CPU bilateral oracle + PNG/EXR codecs.
//
// The counterpart of the reference's native host components: the
// OpenMP CPU bilateral path (reference src/main.cpp:1732-1921) and the
// vendored lodepng/tinyexr codecs (reference src/main.cpp:13-14, 190-229).
// Exposed as a plain C ABI consumed via ctypes (utils/native.py); the Python
// codecs in utils/png.py / utils/exr.py are the behavioral spec and fallback.
//
// Build: make -C native  (produces libidf_native.so)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// memory
// ---------------------------------------------------------------------------

void idf_free(void* p) { std::free(p); }

// ---------------------------------------------------------------------------
// CPU bilateral (the RunOnCPU oracle, reference src/main.cpp:1732-1921)
// ---------------------------------------------------------------------------

// img/out: HxWx4 float32 RGBA. Semantics follow CpuBilateralParams:
// inclusive window [-radius, radius], fused single-exp weight, optional
// blue-channel bug (blue excluded from the color distance), RGB-only
// accumulation with alpha forced to 1, a radius-wide zeroed border when
// skip_border (loop bounds y,x in [radius, dim-radius] inclusive), and
// clamp-to-edge taps.
void idf_cpu_bilateral(const float* img, float* out, int h, int w, int radius,
                       float sigma_spatial, float sigma_color, int blue_bug,
                       int skip_border, int force_alpha_one, int threads) {
  const float inv_ss2 = -0.5f / (sigma_spatial * sigma_spatial);
  const float inv_sc2 = -0.5f / (sigma_color * sigma_color);
  const int y0 = skip_border ? radius : 0;
  const int y1 = skip_border ? h - radius : h - 1;  // inclusive
  const int x0 = skip_border ? radius : 0;
  const int x1 = skip_border ? w - radius : w - 1;

  std::memset(out, 0, sizeof(float) * 4u * h * w);

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 4) num_threads(threads)
#endif
  for (int y = y0; y <= y1; ++y) {
    for (int x = x0; x <= x1; ++x) {
      const float* c = img + 4l * (y * (long)w + x);
      float wr = 0.f, wg = 0.f, wb = 0.f, norm = 0.f;
      for (int i = -radius; i <= radius; ++i) {
        const int yy = std::min(std::max(y + i, 0), h - 1);
        const float si = (float)(i * i);
        for (int j = -radius; j <= radius; ++j) {
          const int xx = std::min(std::max(x + j, 0), w - 1);
          const float* t = img + 4l * (yy * (long)w + xx);
          const float dr = c[0] - t[0];
          const float dg = c[1] - t[1];
          float ssd = dr * dr + dg * dg;
          if (!blue_bug) {
            const float db = c[2] - t[2];
            ssd += db * db;
          }
          const float wgt =
              std::exp((si + (float)(j * j)) * inv_ss2 + ssd * inv_sc2);
          wr += t[0] * wgt;
          wg += t[1] * wgt;
          wb += t[2] * wgt;
          norm += wgt;
        }
      }
      float* o = out + 4l * (y * (long)w + x);
      o[0] = wr / norm;
      o[1] = wg / norm;
      o[2] = wb / norm;
      o[3] = force_alpha_one ? 1.0f : c[3];
    }
  }
}

// ---------------------------------------------------------------------------
// PNG codec (lodepng role; RGBA8 only like the reference's usage)
// ---------------------------------------------------------------------------

namespace {

uint32_t rd32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) |
         ((uint32_t)p[2] << 8) | p[3];
}

void wr32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back((x >> 24) & 0xff);
  v.push_back((x >> 16) & 0xff);
  v.push_back((x >> 8) & 0xff);
  v.push_back(x & 0xff);
}

void put_chunk(std::vector<uint8_t>& out, const char tag[4],
               const uint8_t* data, size_t n) {
  wr32(out, (uint32_t)n);
  size_t tag_pos = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + n);
  uint32_t crc = crc32(0, out.data() + tag_pos, (uInt)(n + 4));
  wr32(out, crc);
}

bool zlib_inflate(const uint8_t* src, size_t n, std::vector<uint8_t>& dst) {
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = const_cast<Bytef*>(src);
  zs.avail_in = (uInt)n;
  std::vector<uint8_t> buf(1 << 18);
  int ret;
  do {
    zs.next_out = buf.data();
    zs.avail_out = (uInt)buf.size();
    ret = inflate(&zs, Z_NO_FLUSH);
    if (ret != Z_OK && ret != Z_STREAM_END) {
      inflateEnd(&zs);
      return false;
    }
    dst.insert(dst.end(), buf.data(), buf.data() + (buf.size() - zs.avail_out));
    // Continue while the stream isn't finished and this call filled the whole
    // output buffer: decompressed bytes can still be pending inside zlib even
    // after the last input byte is consumed, so gating on avail_in would
    // spuriously fail exactly when input runs out on a full output buffer.
  } while (ret != Z_STREAM_END && zs.avail_out == 0);
  inflateEnd(&zs);
  return ret == Z_STREAM_END;
}

void zlib_deflate(const uint8_t* src, size_t n, int level,
                  std::vector<uint8_t>& dst) {
  uLongf bound = compressBound((uLong)n);
  dst.resize(bound);
  compress2(dst.data(), &bound, src, (uLong)n, level);
  dst.resize(bound);
}

int paeth(int a, int b, int c) {
  int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b),
      pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

}  // namespace

// Decode a PNG byte stream to RGBA8. Returns 0 on success; *out is malloc'd
// (caller frees with idf_free). Supports bit depth 8, color types 0/2/3/4/6,
// no interlace -- the same subset as utils/png.py.
int idf_png_decode(const uint8_t* data, size_t size, uint8_t** out, int* out_w,
                   int* out_h) {
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (size < 8 || std::memcmp(data, sig, 8) != 0) return 1;
  size_t pos = 8;
  uint32_t w = 0, h = 0;
  int bitdepth = 0, colortype = -1;
  std::vector<uint8_t> idat, palette, trns;
  while (pos + 12 <= size) {
    uint32_t len = rd32(data + pos);
    const uint8_t* tag = data + pos + 4;
    const uint8_t* body = data + pos + 8;
    if (pos + 12 + len > size) return 2;
    if (!std::memcmp(tag, "IHDR", 4)) {
      w = rd32(body);
      h = rd32(body + 4);
      bitdepth = body[8];
      colortype = body[9];
      if (body[12] != 0) return 3;  // interlace unsupported
      if (bitdepth != 8) return 4;
    } else if (!std::memcmp(tag, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!std::memcmp(tag, "tRNS", 4)) {
      trns.assign(body, body + len);
    } else if (!std::memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!std::memcmp(tag, "IEND", 4)) {
      break;
    }
    pos += 12 + len;
  }
  if (!w || !h) return 5;
  int channels;
  switch (colortype) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return 6;
  }
  std::vector<uint8_t> raw;
  if (!zlib_inflate(idat.data(), idat.size(), raw)) return 7;
  const size_t stride = (size_t)w * channels;
  if (raw.size() < h * (stride + 1)) return 8;

  std::vector<uint8_t> rec(h * stride);
  const int bpp = channels;
  for (uint32_t y = 0; y < h; ++y) {
    const uint8_t f = raw[y * (stride + 1)];
    const uint8_t* row = raw.data() + y * (stride + 1) + 1;
    uint8_t* cur = rec.data() + y * stride;
    const uint8_t* prior = y ? rec.data() + (y - 1) * stride : nullptr;
    for (size_t x = 0; x < stride; ++x) {
      const int a = x >= (size_t)bpp ? cur[x - bpp] : 0;
      const int b = prior ? prior[x] : 0;
      const int c = (prior && x >= (size_t)bpp) ? prior[x - bpp] : 0;
      int pred = 0;
      switch (f) {
        case 0: pred = 0; break;
        case 1: pred = a; break;
        case 2: pred = b; break;
        case 3: pred = (a + b) >> 1; break;
        case 4: pred = paeth(a, b, c); break;
        default: return 9;
      }
      cur[x] = (uint8_t)(row[x] + pred);
    }
  }

  uint8_t* rgba = (uint8_t*)std::malloc((size_t)w * h * 4);
  if (!rgba) return 10;
  for (size_t i = 0; i < (size_t)w * h; ++i) {
    const uint8_t* px = rec.data() + i * channels;
    uint8_t* o = rgba + i * 4;
    switch (colortype) {
      case 0: o[0] = o[1] = o[2] = px[0]; o[3] = 255; break;
      case 2: o[0] = px[0]; o[1] = px[1]; o[2] = px[2]; o[3] = 255; break;
      case 4: o[0] = o[1] = o[2] = px[0]; o[3] = px[1]; break;
      case 6: std::memcpy(o, px, 4); break;
      case 3: {
        const size_t idx = px[0];
        if (idx * 3 + 2 < palette.size()) {
          o[0] = palette[idx * 3];
          o[1] = palette[idx * 3 + 1];
          o[2] = palette[idx * 3 + 2];
        } else {
          o[0] = o[1] = o[2] = 0;
        }
        o[3] = idx < trns.size() ? trns[idx] : 255;
        break;
      }
    }
  }
  *out = rgba;
  *out_w = (int)w;
  *out_h = (int)h;
  return 0;
}

// Encode RGBA8 to PNG (color type 6). Returns 0; *out malloc'd (idf_free).
// Per-row adaptive None/Sub/Up filtering, like utils/png.py.
int idf_png_encode(const uint8_t* rgba, int w, int h, int level, uint8_t** out,
                   size_t* out_size) {
  const size_t stride = (size_t)w * 4;
  std::vector<uint8_t> lines;
  lines.reserve(h * (stride + 1));
  std::vector<uint8_t> cand0(stride), cand1(stride), cand2(stride);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = rgba + y * stride;
    const uint8_t* prior = y ? rgba + (y - 1) * stride : nullptr;
    long s0 = 0, s1 = 0, s2 = 0;
    for (size_t x = 0; x < stride; ++x) {
      const uint8_t left = x >= 4 ? row[x - 4] : 0;
      const uint8_t up = prior ? prior[x] : 0;
      cand0[x] = row[x];
      cand1[x] = (uint8_t)(row[x] - left);
      cand2[x] = (uint8_t)(row[x] - up);
      s0 += cand0[x] < 128 ? cand0[x] : 256 - cand0[x];
      s1 += cand1[x] < 128 ? cand1[x] : 256 - cand1[x];
      s2 += cand2[x] < 128 ? cand2[x] : 256 - cand2[x];
    }
    int f = 0;
    const std::vector<uint8_t>* best = &cand0;
    if (s1 < s0 || s2 < s0) {
      if (s1 <= s2) { f = 1; best = &cand1; }
      else { f = 2; best = &cand2; }
    }
    lines.push_back((uint8_t)f);
    lines.insert(lines.end(), best->begin(), best->end());
  }
  std::vector<uint8_t> compressed;
  zlib_deflate(lines.data(), lines.size(), level, compressed);

  std::vector<uint8_t> png;
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  png.insert(png.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = (w >> 24) & 0xff; ihdr[1] = (w >> 16) & 0xff;
  ihdr[2] = (w >> 8) & 0xff; ihdr[3] = w & 0xff;
  ihdr[4] = (h >> 24) & 0xff; ihdr[5] = (h >> 16) & 0xff;
  ihdr[6] = (h >> 8) & 0xff; ihdr[7] = h & 0xff;
  ihdr[8] = 8; ihdr[9] = 6; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  put_chunk(png, "IHDR", ihdr, 13);
  put_chunk(png, "IDAT", compressed.data(), compressed.size());
  put_chunk(png, "IEND", nullptr, 0);

  uint8_t* buf = (uint8_t*)std::malloc(png.size());
  if (!buf) return 1;
  std::memcpy(buf, png.data(), png.size());
  *out = buf;
  *out_size = png.size();
  return 0;
}

// ---------------------------------------------------------------------------
// EXR codec (tinyexr role; scanline HALF/FLOAT, NONE/ZIPS/ZIP)
// ---------------------------------------------------------------------------

namespace {

float half_to_float(uint16_t hbits) {
  uint32_t sign = (uint32_t)(hbits >> 15) << 31;
  uint32_t exp = (hbits >> 10) & 0x1f;
  uint32_t man = hbits & 0x3ff;
  uint32_t fbits;
  if (exp == 0) {
    if (man == 0) {
      fbits = sign;
    } else {  // subnormal
      int e = -1;
      do { man <<= 1; ++e; } while (!(man & 0x400));
      fbits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((man & 0x3ff) << 13);
    }
  } else if (exp == 31) {
    fbits = sign | 0x7f800000u | (man << 13);
  } else {
    fbits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  std::memcpy(&f, &fbits, 4);
  return f;
}

uint16_t float_to_half(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  uint32_t sign = (x >> 16) & 0x8000;
  int32_t exp = (int32_t)((x >> 23) & 0xff) - 127 + 15;
  uint32_t man = x & 0x7fffff;
  if (exp <= 0) {
    if (exp < -10) return (uint16_t)sign;
    man |= 0x800000;
    uint32_t shift = 14 - exp;
    uint32_t half_man = man >> shift;
    // round to nearest even
    uint32_t rem = man & ((1u << shift) - 1), halfway = 1u << (shift - 1);
    if (rem > halfway || (rem == halfway && (half_man & 1))) ++half_man;
    return (uint16_t)(sign | half_man);
  }
  if (exp >= 31) {
    if (((x >> 23) & 0xff) == 255 && man) return (uint16_t)(sign | 0x7e00);
    return (uint16_t)(sign | 0x7c00);  // inf / overflow
  }
  uint32_t half = sign | (exp << 10) | (man >> 13);
  // round to nearest even on the dropped 13 bits
  uint32_t rem = man & 0x1fff;
  if (rem > 0x1000 || (rem == 0x1000 && (half & 1))) ++half;
  return (uint16_t)half;
}

// OpenEXR ZIP reorder: predictor then split-interleave (see utils/exr.py).
void exr_zip_predecode(std::vector<uint8_t>& buf) {
  for (size_t i = 1; i < buf.size(); ++i)
    buf[i] = (uint8_t)(buf[i] + buf[i - 1] - 128);
  std::vector<uint8_t> tmp(buf.size());
  const size_t half = (buf.size() + 1) / 2;
  size_t a = 0, b = half, o = 0;
  while (o < buf.size()) {
    tmp[o++] = buf[a++];
    if (o < buf.size()) tmp[o++] = buf[b++];
  }
  buf.swap(tmp);
}

void exr_zip_preencode(std::vector<uint8_t>& buf) {
  std::vector<uint8_t> tmp(buf.size());
  const size_t half = (buf.size() + 1) / 2;
  size_t a = 0, b = half;
  for (size_t i = 0; i < buf.size(); ++i) {
    if ((i & 1) == 0) tmp[a++] = buf[i];
    else tmp[b++] = buf[i];
  }
  for (size_t i = tmp.size(); i-- > 1;)
    tmp[i] = (uint8_t)(tmp[i] - tmp[i - 1] + 128 + 256);
  buf.swap(tmp);
}

struct ExrChannel {
  std::string name;
  int ptype;  // 0 uint, 1 half, 2 float
};

}  // namespace

// Decode a scanline EXR to HxWx4 float32 RGBA (missing alpha -> 1). Returns 0
// on success; *out malloc'd. Same subset as utils/exr.py.
int idf_exr_decode(const uint8_t* data, size_t size, float** out, int* out_w,
                   int* out_h) {
  if (size < 8) return 1;
  int32_t magic;
  std::memcpy(&magic, data, 4);
  if (magic != 20000630) return 1;
  uint32_t version;
  std::memcpy(&version, data + 4, 4);
  if (version & (0x200 | 0x800 | 0x1000)) return 2;  // tiled/deep/multipart

  size_t pos = 8;
  std::vector<ExrChannel> channels;
  int compression = -1;
  int32_t xmin = 0, ymin = 0, xmax = -1, ymax = -1;
  int line_order = 0;

  auto read_str = [&](size_t& p) -> std::string {
    std::string s;
    while (p < size && data[p]) s.push_back((char)data[p++]);
    ++p;
    return s;
  };

  // Every file-provided size/offset below is untrusted: bound-check before
  // use (a fuzzed/truncated EXR must fail with an error code, never read or
  // write out of bounds).
  while (pos < size) {
    std::string name = read_str(pos);
    if (name.empty()) break;
    std::string type = read_str(pos);
    if (pos + 4 > size) return 2;
    int32_t asize;
    std::memcpy(&asize, data + pos, 4);
    pos += 4;
    if (asize < 0 || (size_t)asize > size - pos) return 2;
    const uint8_t* body = data + pos;
    pos += asize;
    if (name == "channels") {
      size_t cp = 0;
      while (cp < (size_t)asize && body[cp]) {
        std::string cname;
        while (cp < (size_t)asize && body[cp]) cname.push_back((char)body[cp++]);
        ++cp;
        if (cp + 16 > (size_t)asize) return 2;  // truncated channel entry
        int32_t ptype;
        std::memcpy(&ptype, body + cp, 4);
        cp += 16;
        if (ptype < 0 || ptype > 2) return 2;
        channels.push_back({cname, ptype});
      }
    } else if (name == "compression") {
      if (asize < 1) return 2;
      compression = body[0];
    } else if (name == "dataWindow") {
      if (asize < 16) return 2;
      std::memcpy(&xmin, body, 4);
      std::memcpy(&ymin, body + 4, 4);
      std::memcpy(&xmax, body + 8, 4);
      std::memcpy(&ymax, body + 12, 4);
    } else if (name == "lineOrder") {
      if (asize < 1) return 2;
      line_order = body[0];
      (void)line_order;  // placement uses the absolute block-header y
    }
  }
  if (compression != 0 && compression != 2 && compression != 3) return 3;
  const int64_t w64 = (int64_t)xmax - xmin + 1, h64 = (int64_t)ymax - ymin + 1;
  if (w64 <= 0 || h64 <= 0 || w64 * h64 > (int64_t)1 << 29) return 4;
  const int w = (int)w64, h = (int)h64;
  const int lines_per_block = compression == 3 ? 16 : 1;
  const int nblocks = (h + lines_per_block - 1) / lines_per_block;

  size_t row_bytes = 0;
  for (auto& c : channels) row_bytes += (size_t)w * (c.ptype == 1 ? 2 : 4);

  if ((size_t)8 * nblocks > size - pos) return 2;  // truncated offset table
  std::vector<int64_t> offsets(nblocks);
  std::memcpy(offsets.data(), data + pos, 8 * nblocks);

  float* rgba = (float*)std::malloc(sizeof(float) * 4u * w * h);
  if (!rgba) return 5;
  for (size_t i = 0; i < (size_t)w * h; ++i) {
    rgba[i * 4 + 0] = rgba[i * 4 + 1] = rgba[i * 4 + 2] = 0.f;
    rgba[i * 4 + 3] = 1.f;
  }
  for (int b = 0; b < nblocks; ++b) {
    if (offsets[b] < 0 || (uint64_t)offsets[b] + 8 > size) {
      std::free(rgba);
      return 6;
    }
    const uint8_t* blk = data + offsets[b];
    int32_t y0;
    uint32_t bsize;
    std::memcpy(&y0, blk, 4);
    std::memcpy(&bsize, blk + 4, 4);
    y0 -= ymin;
    if (y0 < 0 || y0 >= h || bsize > size - (size_t)offsets[b] - 8) {
      std::free(rgba);
      return 6;
    }
    const int nlines = std::min(lines_per_block, h - y0);
    const size_t expected = row_bytes * nlines;
    std::vector<uint8_t> rawbuf;
    const uint8_t* raw;
    if (compression == 0 || bsize >= expected) {
      if (expected > size - (size_t)offsets[b] - 8) {
        std::free(rgba);
        return 6;
      }
      raw = blk + 8;
    } else {
      if (!zlib_inflate(blk + 8, bsize, rawbuf)) { std::free(rgba); return 6; }
      if (rawbuf.size() != expected) { std::free(rgba); return 7; }
      exr_zip_predecode(rawbuf);
      raw = rawbuf.data();
    }
    size_t bp = 0;
    for (int line = 0; line < nlines; ++line) {
      // lineOrder only orders blocks within the file; header y is absolute.
      int y = y0 + line;
      for (auto& c : channels) {
        const size_t nb = (size_t)w * (c.ptype == 1 ? 2 : 4);
        int ci = -1;
        if (c.name == "R") ci = 0;
        else if (c.name == "G") ci = 1;
        else if (c.name == "B") ci = 2;
        else if (c.name == "A") ci = 3;
        if (ci >= 0) {
          float* dst = rgba + 4l * y * w;
          if (c.ptype == 1) {
            const uint16_t* src = (const uint16_t*)(raw + bp);
            for (int x = 0; x < w; ++x) dst[4 * x + ci] = half_to_float(src[x]);
          } else if (c.ptype == 2) {
            const float* src = (const float*)(raw + bp);
            for (int x = 0; x < w; ++x) dst[4 * x + ci] = src[x];
          }
        }
        bp += nb;
      }
    }
  }
  *out = rgba;
  *out_w = w;
  *out_h = h;
  return 0;
}

// Encode HxWx4 float32 RGBA as a scanline EXR (channels A,B,G,R; FLOAT or
// HALF; ZIP(3)/ZIPS(2)/NONE(0)). Returns 0; *out malloc'd.
int idf_exr_encode(const float* rgba, int w, int h, int as_half,
                   int compression, uint8_t** out, size_t* out_size) {
  if (compression != 0 && compression != 2 && compression != 3) return 1;
  const int lines_per_block = compression == 3 ? 16 : 1;
  const int nblocks = (h + lines_per_block - 1) / lines_per_block;
  const int ptype = as_half ? 1 : 2;
  const size_t chan_bytes = as_half ? 2 : 4;

  std::vector<uint8_t> header;
  auto put = [&](const void* p, size_t n) {
    header.insert(header.end(), (const uint8_t*)p, (const uint8_t*)p + n);
  };
  auto put_str = [&](const char* s) { put(s, std::strlen(s) + 1); };
  auto put_attr = [&](const char* name, const char* type,
                      const std::vector<uint8_t>& body) {
    put_str(name);
    put_str(type);
    int32_t n = (int32_t)body.size();
    put(&n, 4);
    put(body.data(), body.size());
  };

  int32_t magic = 20000630;
  uint32_t version = 2;
  put(&magic, 4);
  put(&version, 4);

  std::vector<uint8_t> chlist;
  const char* names[4] = {"A", "B", "G", "R"};
  for (int c = 0; c < 4; ++c) {
    const char* n = names[c];
    chlist.insert(chlist.end(), (const uint8_t*)n, (const uint8_t*)n + 2);
    int32_t vals[4] = {ptype, 0, 1, 1};
    chlist.insert(chlist.end(), (const uint8_t*)vals, (const uint8_t*)vals + 16);
  }
  chlist.push_back(0);
  put_attr("channels", "chlist", chlist);
  put_attr("compression", "compression", {(uint8_t)compression});
  std::vector<uint8_t> box(16);
  int32_t bw[4] = {0, 0, w - 1, h - 1};
  std::memcpy(box.data(), bw, 16);
  put_attr("dataWindow", "box2i", box);
  put_attr("displayWindow", "box2i", box);
  put_attr("lineOrder", "lineOrder", {0});
  std::vector<uint8_t> f4(4);
  float one = 1.0f;
  std::memcpy(f4.data(), &one, 4);
  put_attr("pixelAspectRatio", "float", f4);
  std::vector<uint8_t> v2f(8, 0);
  put_attr("screenWindowCenter", "v2f", v2f);
  put_attr("screenWindowWidth", "float", f4);
  header.push_back(0);

  // channel source index in RGBA order for A,B,G,R
  const int src_idx[4] = {3, 2, 1, 0};
  std::vector<std::vector<uint8_t>> payloads(nblocks);
  std::vector<int32_t> block_y(nblocks);
  for (int b = 0; b < nblocks; ++b) {
    const int y0 = b * lines_per_block;
    const int nlines = std::min(lines_per_block, h - y0);
    std::vector<uint8_t> rawbuf;
    rawbuf.reserve(nlines * 4 * chan_bytes * w);
    for (int line = 0; line < nlines; ++line) {
      const float* row = rgba + 4l * (y0 + line) * w;
      for (int c = 0; c < 4; ++c) {
        const int si = src_idx[c];
        if (as_half) {
          for (int x = 0; x < w; ++x) {
            uint16_t hv = float_to_half(row[4 * x + si]);
            rawbuf.push_back(hv & 0xff);
            rawbuf.push_back(hv >> 8);
          }
        } else {
          for (int x = 0; x < w; ++x) {
            const uint8_t* p = (const uint8_t*)&row[4 * x + si];
            rawbuf.insert(rawbuf.end(), p, p + 4);
          }
        }
      }
    }
    block_y[b] = y0;
    if (compression == 0) {
      payloads[b].swap(rawbuf);
    } else {
      std::vector<uint8_t> pre = rawbuf;
      exr_zip_preencode(pre);
      std::vector<uint8_t> comp;
      zlib_deflate(pre.data(), pre.size(), 6, comp);
      if (comp.size() >= rawbuf.size()) payloads[b].swap(rawbuf);
      else payloads[b].swap(comp);
    }
  }

  const size_t table_pos = header.size() + 8u * nblocks;
  std::vector<int64_t> offsets(nblocks);
  size_t p = table_pos;
  for (int b = 0; b < nblocks; ++b) {
    offsets[b] = (int64_t)p;
    p += 8 + payloads[b].size();
  }

  std::vector<uint8_t> file;
  file.reserve(p);
  file.insert(file.end(), header.begin(), header.end());
  file.insert(file.end(), (const uint8_t*)offsets.data(),
              (const uint8_t*)offsets.data() + 8u * nblocks);
  for (int b = 0; b < nblocks; ++b) {
    int32_t y0 = block_y[b];
    uint32_t sz = (uint32_t)payloads[b].size();
    file.insert(file.end(), (const uint8_t*)&y0, (const uint8_t*)&y0 + 4);
    file.insert(file.end(), (const uint8_t*)&sz, (const uint8_t*)&sz + 4);
    file.insert(file.end(), payloads[b].begin(), payloads[b].end());
  }

  uint8_t* buf = (uint8_t*)std::malloc(file.size());
  if (!buf) return 2;
  std::memcpy(buf, file.data(), file.size());
  *out = buf;
  *out_size = file.size();
  return 0;
}

int idf_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Threaded frame loader (native data-loader for the streaming pipeline)
// ---------------------------------------------------------------------------
//
// Decodes animation frames on background threads with bounded lookahead so
// host-side decode overlaps both device compute and host->HBM transfer -- the
// reference does its decoding serially up front (LoadImages,
// src/main.cpp:1390-1396); this is the production-streaming version.

#include <atomic>
#include <condition_variable>
#include <mutex>
#include <thread>

namespace {

struct LoadedFrame {
  std::vector<float> rgba;  // HxWx4
  int w = 0, h = 0;
  int status = -1;  // -1 pending, 0 ok, >0 error
};

struct Loader {
  std::vector<std::string> paths;
  std::vector<LoadedFrame> frames;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_done;
  std::condition_variable cv_slot;
  std::atomic<int> next_job{0};
  int lookahead = 4;
  int released = 0;  // frames [0, released) freed; decode window stays bounded
  bool stopping = false;

  static bool ends_with(const std::string& s, const char* suf) {
    size_t n = std::strlen(suf);
    return s.size() >= n && s.compare(s.size() - n, n, suf) == 0;
  }

  void work() {
    for (;;) {
      int idx = next_job.fetch_add(1);
      if (idx >= (int)paths.size()) return;
      {
        // bound the decode window: wait until idx < released + lookahead
        std::unique_lock<std::mutex> lk(mu);
        cv_slot.wait(lk, [&] { return stopping || idx < released + lookahead; });
        if (stopping) return;
      }
      LoadedFrame f;
      std::vector<uint8_t> blob;
      FILE* fp = std::fopen(paths[idx].c_str(), "rb");
      if (!fp) {
        f.status = 100;
      } else {
        std::fseek(fp, 0, SEEK_END);
        long n = std::ftell(fp);
        std::fseek(fp, 0, SEEK_SET);
        blob.resize(n);
        if ((long)std::fread(blob.data(), 1, n, fp) != n) f.status = 101;
        std::fclose(fp);
      }
      if (f.status == -1) {
        if (ends_with(paths[idx], ".exr")) {
          float* px = nullptr;
          int rc = idf_exr_decode(blob.data(), blob.size(), &px, &f.w, &f.h);
          if (rc == 0) {
            f.rgba.assign(px, px + 4l * f.w * f.h);
            idf_free(px);
            f.status = 0;
          } else {
            f.status = rc;
          }
        } else {
          uint8_t* px = nullptr;
          int rc = idf_png_decode(blob.data(), blob.size(), &px, &f.w, &f.h);
          if (rc == 0) {
            f.rgba.resize(4l * f.w * f.h);
            const float k = 1.0f / 255.0f;  // LDR semantics, src/main.cpp:1125-1128
            for (long i = 0; i < 4l * f.w * f.h; ++i) f.rgba[i] = px[i] * k;
            idf_free(px);
            f.status = 0;
          } else {
            f.status = rc;
          }
        }
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        frames[idx] = std::move(f);
      }
      cv_done.notify_all();
    }
  }
};

}  // namespace

extern "C" void* idf_loader_create(const char** paths, int n, int lookahead, int threads) {
  auto* L = new Loader();
  L->paths.assign(paths, paths + n);
  L->frames.resize(n);
  L->lookahead = std::max(1, lookahead);
  int nt = std::max(1, std::min(threads, n));
  for (int i = 0; i < nt; ++i) L->workers.emplace_back(&Loader::work, L);
  return L;
}

// Blocks until frame idx is decoded. Returns its status (0 = ok) and points
// *data at loader-owned memory, valid until idf_loader_release(idx).
extern "C" int idf_loader_get(void* handle, int idx, const float** data, int* w, int* h) {
  auto* L = (Loader*)handle;
  std::unique_lock<std::mutex> lk(L->mu);
  if (idx < 0 || idx >= (int)L->frames.size()) return 200;
  if (idx < L->released) return 201;  // already released (gets must be monotonic)
  L->cv_done.wait(lk, [&] { return L->frames[idx].status != -1; });
  const LoadedFrame& f = L->frames[idx];
  *data = f.rgba.data();
  *w = f.w;
  *h = f.h;
  return f.status;
}

// Frees frames up to and including idx, advancing the decode window.
extern "C" void idf_loader_release(void* handle, int idx) {
  auto* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    for (int i = L->released; i <= idx && i < (int)L->frames.size(); ++i)
      L->frames[i].rgba = std::vector<float>();
    L->released = std::max(L->released, idx + 1);
  }
  L->cv_slot.notify_all();
}

extern "C" void idf_loader_destroy(void* handle) {
  auto* L = (Loader*)handle;
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stopping = true;
  }
  L->cv_slot.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}
