// Native frame-decode runtime for pmv_tpu.
//
// The reference's ingest hot path is OpenCV's C++ imread inside its producer
// thread (reference Frame.cpp:33, OdometryPipeline.cpp:216). This library is
// the framework's equivalent: a from-scratch PNG decoder (zlib inflate +
// scanline unfiltering + grayscale conversion) exposed through a C ABI and
// driven from Python via ctypes. ctypes releases the GIL for the call, so
// the Python-side prefetch pool gets true multi-core decode.
//
// Supported: 8-bit PNG, color types 0 (gray), 2 (RGB), 3 (palette),
// 4 (gray+alpha), 6 (RGBA), non-interlaced. Grayscale conversion uses the
// BGR2GRAY weights the reference inherits from OpenCV:
// 0.299 R + 0.587 G + 0.114 B.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

struct Reader {
  const uint8_t* p;
  size_t n;
  size_t off = 0;
  bool ok = true;

  uint32_t u32() {
    if (off + 4 > n) { ok = false; return 0; }
    uint32_t v = (uint32_t(p[off]) << 24) | (uint32_t(p[off + 1]) << 16) |
                 (uint32_t(p[off + 2]) << 8) | uint32_t(p[off + 3]);
    off += 4;
    return v;
  }
};

int paeth(int a, int b, int c) {
  int pp = a + b - c;
  int pa = pp > a ? pp - a : a - pp;
  int pb = pp > b ? pp - b : b - pp;
  int pc = pp > c ? pp - c : c - pp;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// Decode an 8-bit PNG into float32 grayscale [0,255]. Returns 0 on success.
//  -1 io error, -2 not a png / unsupported, -3 buffer too small, -4 zlib.
int fl_decode_gray(const char* path, float* out, int max_pixels,
                   int* out_h, int* out_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long sz = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::vector<uint8_t> buf(sz);
  if (fread(buf.data(), 1, sz, f) != (size_t)sz) { fclose(f); return -1; }
  fclose(f);

  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  if (sz < 8 || memcmp(buf.data(), sig, 8) != 0) return -2;

  uint32_t W = 0, H = 0;
  int bit_depth = 0, color_type = 0, interlace = 0;
  std::vector<uint8_t> idat;
  std::vector<uint8_t> palette;  // rgb triples

  size_t off = 8;
  while (off + 8 <= (size_t)sz) {
    Reader r{buf.data(), (size_t)sz, off};
    uint32_t len = r.u32();
    if (!r.ok || off + 12 + len > (size_t)sz) break;
    const uint8_t* tag = buf.data() + off + 4;
    const uint8_t* body = buf.data() + off + 8;
    if (!memcmp(tag, "IHDR", 4) && len >= 13) {
      Reader h{body, len, 0};
      W = h.u32();
      H = h.u32();
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
    } else if (!memcmp(tag, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + len);
    } else if (!memcmp(tag, "PLTE", 4)) {
      palette.assign(body, body + len);
    } else if (!memcmp(tag, "IEND", 4)) {
      break;
    }
    off += 12 + len;
  }
  if (!W || !H || bit_depth != 8 || interlace != 0) return -2;
  int channels;
  switch (color_type) {
    case 0: channels = 1; break;
    case 2: channels = 3; break;
    case 3: channels = 1; break;
    case 4: channels = 2; break;
    case 6: channels = 4; break;
    default: return -2;
  }
  if ((long)W * H > max_pixels) return -3;

  size_t stride = (size_t)W * channels;
  std::vector<uint8_t> raw((stride + 1) * H);
  uLongf raw_len = raw.size();
  if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK)
    return -4;

  std::vector<uint8_t> prev(stride, 0), cur(stride);
  int bpp = channels;
  for (uint32_t y = 0; y < H; y++) {
    const uint8_t* row = raw.data() + y * (stride + 1);
    int filter = row[0];
    const uint8_t* src = row + 1;
    switch (filter) {
      case 0:
        memcpy(cur.data(), src, stride);
        break;
      case 1:
        for (size_t x = 0; x < stride; x++) {
          int a = x >= (size_t)bpp ? cur[x - bpp] : 0;
          cur[x] = uint8_t(src[x] + a);
        }
        break;
      case 2:
        for (size_t x = 0; x < stride; x++) cur[x] = uint8_t(src[x] + prev[x]);
        break;
      case 3:
        for (size_t x = 0; x < stride; x++) {
          int a = x >= (size_t)bpp ? cur[x - bpp] : 0;
          cur[x] = uint8_t(src[x] + ((a + prev[x]) >> 1));
        }
        break;
      case 4:
        for (size_t x = 0; x < stride; x++) {
          int a = x >= (size_t)bpp ? cur[x - bpp] : 0;
          int c = x >= (size_t)bpp ? prev[x - bpp] : 0;
          cur[x] = uint8_t(src[x] + paeth(a, prev[x], c));
        }
        break;
      default:
        return -2;
    }
    float* dst = out + (size_t)y * W;
    switch (color_type) {
      case 0:
      case 4:  // gray (+alpha ignored)
        for (uint32_t x = 0; x < W; x++) dst[x] = float(cur[x * channels]);
        break;
      case 2:
      case 6:  // rgb(a)
        for (uint32_t x = 0; x < W; x++) {
          const uint8_t* px = &cur[x * channels];
          dst[x] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
        }
        break;
      case 3:  // palette
        for (uint32_t x = 0; x < W; x++) {
          uint8_t idx = cur[x];
          if ((size_t)idx * 3 + 2 < palette.size()) {
            const uint8_t* px = &palette[idx * 3];
            dst[x] = 0.299f * px[0] + 0.587f * px[1] + 0.114f * px[2];
          } else {
            dst[x] = 0.f;
          }
        }
        break;
    }
    prev.swap(cur);
  }
  *out_h = (int)H;
  *out_w = (int)W;
  return 0;
}

}  // extern "C"
