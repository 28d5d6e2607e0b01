// Baseline JPEG decode and encode, and a threaded MJPEG frame decoder, for
// the PyTorch port's host I/O (aicamera_tpu_torch/utils/jpeg.py,
// utils/video_io.py). Plain C interface, loaded with ctypes.CDLL, which
// releases the GIL for the length of every call.
//
// The arithmetic is libjpeg-turbo's, as OpenCV drives it
// (cv2.imdecode(..., IMREAD_COLOR) and cv2.imencode(".jpg", ...) at their
// defaults), so that the results are bitwise equal:
//
//  decode: sequential Huffman (SOF0/SOF1), 8-bit, 1 or 3 components,
//    sampling factors up to 2x2, restart intervals, interleaved and
//    non-interleaved scans; the ISLOW integer IDCT (jidctint.c, CONST_BITS
//    13, PASS1_BITS 2, the post-IDCT range-limit table); fancy upsampling
//    (jdsample.c: h2v1, h1v2, h2v2 with their biases and edge replication;
//    box replication where turbo takes it); the fixed-point YCbCr->BGR
//    tables (jdcolor.c); the EXIF orientation tag is returned for the
//    caller to apply, as imdecode does.
//  encode (4:2:0, or gray): quality scaling of the standard tables
//    (jcparam.c), the RGB->YCC tables (jccolor.c), edge replication to the
//    MCU and h2v2 downsampling with alternating bias (jcsample.c, jcprepct.c),
//    the ISLOW FDCT (jfdctint.c), turbo's reciprocal quantizer
//    (jcdctmgr.c), dummy edge blocks (jccoefct.c), the standard Huffman
//    tables and a JFIF APP0 header (jcmarker.c).
//
// Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
// CMYK/YCCK files are refused with an error code (see jpeg_error_name).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <unistd.h>

namespace {

enum Err {
    OK = 0,
    E_NOT_JPEG = -1,
    E_TRUNCATED = -2,
    E_PROGRESSIVE = -3,
    E_ARITHMETIC = -4,
    E_LOSSLESS = -5,
    E_HIERARCHICAL = -6,
    E_PRECISION = -7,
    E_CMYK = -8,
    E_COMPONENTS = -9,
    E_SAMPLING = -10,
    E_TABLES = -11,
    E_CORRUPT = -12,
    E_NO_FRAME = -13,
    E_IO = -14,
    E_SIZE = -15,
    E_TOO_LARGE = -16,
    E_MEMORY = -17,
};

// OpenCV's CV_IO_MAX_IMAGE_PIXELS default: larger frames are refused before
// anything is allocated for them.
constexpr int64_t kMaxPixels = (int64_t)1 << 30;

const int kZigzag[64 + 16] = {  // jpeg_natural_order, with the safety tail
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------- decoding

constexpr int kLookahead = 9;

struct HuffTable {
    bool present = false;
    // codes up to kLookahead bits: (length << 8) | value, 0 = a longer
    // code; longer ones by the canonical maxcode/valoffset walk (jdhuff.c)
    uint16_t lut[1 << kLookahead];
    int32_t maxcode[18];
    int32_t valoffset[17];
    uint8_t vals[256];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int td = 0, ta = 0;
    int bw = 0, bh = 0;             // blocks allocated (the MCU grid)
    int dw = 0, dh = 0;             // downsampled width, height in samples
    std::vector<int16_t> coef;      // bw * bh blocks of 64, natural order
    int dc_pred = 0;
};

struct Decoder {
    const uint8_t* data = nullptr;
    size_t size = 0, pos = 0;
    uint16_t qt[4][64] = {};        // natural order
    bool qt_present[4] = {};
    HuffTable dc[4], ac[4];
    int width = 0, height = 0, ncomp = 0, max_h = 1, max_v = 1;
    bool frame = false, jfif = false, adobe = false;
    int adobe_transform = -1, orientation = 1, restart_interval = 0;
    Component comp[4];
    // bit reader
    uint64_t bits = 0;
    int nbits = 0;
    bool hit_marker = false;
};

int read_u16(Decoder& d, int& out) {
    if (d.pos + 2 > d.size) return E_TRUNCATED;
    out = (d.data[d.pos] << 8) | d.data[d.pos + 1];
    d.pos += 2;
    return OK;
}

void build_huff(HuffTable& t, const uint8_t* counts, const uint8_t* vals) {
    t.present = true;
    memset(t.lut, 0, sizeof(t.lut));
    int code = 0, k = 0;
    for (int len = 1; len <= 16; ++len) {
        int n = counts[len - 1];
        t.valoffset[len] = k - code;
        for (int i = 0; i < n; ++i, ++k) {
            t.vals[k] = vals[k];
            if (len <= kLookahead) {
                int shift = kLookahead - len;
                int start = code << shift;
                if (start + (1 << shift) <= (1 << kLookahead)) {
                    uint16_t e = (uint16_t)((len << 8) | vals[k]);
                    for (int j = 0; j < (1 << shift); ++j) t.lut[start + j] = e;
                }
            }
            ++code;
        }
        t.maxcode[len] = n ? code - 1 : -1;
        code <<= 1;
    }
    t.maxcode[17] = 0x7FFFFFFF;  // ends the walk on a bad code
}

int parse_exif(Decoder& d, const uint8_t* p, int len) {
    // p points past "Exif\0\0": a TIFF header and IFD0
    if (len < 8) return OK;
    bool le = p[0] == 'I' && p[1] == 'I';
    bool be = p[0] == 'M' && p[1] == 'M';
    if (!le && !be) return OK;
    auto u16 = [&](int o) -> int {
        return le ? (p[o] | (p[o + 1] << 8)) : ((p[o] << 8) | p[o + 1]);
    };
    auto u32 = [&](int o) -> uint32_t {
        return le ? (uint32_t)(p[o] | (p[o + 1] << 8) | (p[o + 2] << 16) |
                               ((uint32_t)p[o + 3] << 24))
                  : (uint32_t)(((uint32_t)p[o] << 24) | (p[o + 1] << 16) |
                               (p[o + 2] << 8) | p[o + 3]);
    };
    uint32_t ifd = u32(4);
    if (ifd + 2 > (uint32_t)len) return OK;
    int n = u16(ifd);
    for (int i = 0; i < n; ++i) {
        uint32_t e = ifd + 2 + 12 * i;
        if (e + 12 > (uint32_t)len) break;
        if (u16(e) == 0x0112 && u16(e + 2) == 3) {
            int o = u16(e + 8);
            if (o >= 1 && o <= 8) d.orientation = o;
        }
    }
    return OK;
}

inline void fill_bits(Decoder& d) {
    while (d.nbits <= 48) {
        uint32_t byte = 0;
        if (!d.hit_marker && d.pos < d.size) {
            byte = d.data[d.pos];
            if (byte == 0xFF) {
                uint8_t next = d.pos + 1 < d.size ? d.data[d.pos + 1] : 0;
                if (next == 0x00) {
                    d.pos += 2;
                } else {
                    d.hit_marker = true;  // feed zeros, as libjpeg does
                    byte = 0;
                }
            } else {
                d.pos += 1;
            }
        }
        d.bits |= (uint64_t)byte << (56 - d.nbits);
        d.nbits += 8;
    }
}

inline int extend(int v, int s) {
    return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

// One block's coefficients, the bit buffer in locals: every symbol is
// decoded from at least 32 buffered bits (a code of up to 16 and as many
// extra bits).
int decode_block(Decoder& d, Component& c, int16_t* blk) {
    const HuffTable& dct = d.dc[c.td];
    const HuffTable& act = d.ac[c.ta];
    uint64_t bits = d.bits;
    int nbits = d.nbits;
    auto refill = [&]() {
        if (nbits < 32) {
            d.bits = bits;
            d.nbits = nbits;
            fill_bits(d);
            bits = d.bits;
            nbits = d.nbits;
        }
    };
    auto symbol = [&](const HuffTable& t) -> int {
        uint16_t e = t.lut[bits >> (64 - kLookahead)];
        int len = e >> 8;
        if (len) {
            bits <<= len;
            nbits -= len;
            return e & 0xFF;
        }
        for (len = kLookahead + 1; len <= 16; ++len)
            if ((int32_t)(bits >> (64 - len)) <= t.maxcode[len]) break;
        if (len > 16) return -1;
        int code = (int)(bits >> (64 - len));
        bits <<= len;
        nbits -= len;
        return t.vals[(t.valoffset[len] + code) & 0xFF];
    };
    auto take = [&](int n) -> int {
        if (n == 0) return 0;
        int v = (int)(bits >> (64 - n));
        bits <<= n;
        nbits -= n;
        return extend(v, n);
    };
    refill();
    int s = symbol(dct);
    if (s < 0 || s > 15) return E_CORRUPT;
    c.dc_pred += take(s);
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; ++k) {
        refill();
        int rs = symbol(act);
        if (rs < 0) return E_CORRUPT;
        int r = rs >> 4, sz = rs & 15;
        if (sz) {
            k += r;
            blk[kZigzag[k]] = (int16_t)take(sz);
        } else {
            if (r != 15) break;
            k += 15;
        }
    }
    d.bits = bits;
    d.nbits = nbits;
    return OK;
}

// Align to the next byte and consume an RSTn marker (libjpeg resyncs the
// same way on valid files).
void process_restart(Decoder& d) {
    d.bits = 0;
    d.nbits = 0;
    d.hit_marker = false;
    while (d.pos + 1 < d.size) {
        if (d.data[d.pos] == 0xFF && d.data[d.pos + 1] >= 0xD0 &&
            d.data[d.pos + 1] <= 0xD7) {
            d.pos += 2;
            break;
        }
        if (d.data[d.pos] == 0xFF && d.data[d.pos + 1] != 0x00 &&
            d.data[d.pos + 1] != 0xFF)
            break;  // some other marker: leave it for the parser
        ++d.pos;
    }
}

void skip_to_marker(Decoder& d) {
    // after a scan: step back over bytes read ahead, find the next marker
    d.bits = 0;
    d.nbits = 0;
    d.hit_marker = false;
    while (d.pos + 1 < d.size) {
        if (d.data[d.pos] == 0xFF && d.data[d.pos + 1] != 0x00 &&
            !(d.data[d.pos + 1] >= 0xD0 && d.data[d.pos + 1] <= 0xD7) &&
            d.data[d.pos + 1] != 0xFF)
            return;
        ++d.pos;
    }
}

int decode_scan(Decoder& d) {
    int len;
    if (read_u16(d, len)) return E_TRUNCATED;
    size_t end = d.pos + len - 2;
    if (end > d.size || !d.frame) return E_TRUNCATED;
    int ns = d.data[d.pos++];
    if (ns < 1 || ns > 4) return E_CORRUPT;
    if (d.pos + 2 * ns + 3 > end) return E_TRUNCATED;
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
        int cid = d.data[d.pos++], tt = d.data[d.pos++];
        Component* c = nullptr;
        for (int j = 0; j < d.ncomp; ++j)
            if (d.comp[j].id == cid) c = &d.comp[j];
        if (!c) return E_CORRUPT;
        c->td = tt >> 4;
        c->ta = tt & 15;
        if (c->td > 3 || c->ta > 3 || !d.dc[c->td].present ||
            !d.ac[c->ta].present)
            return E_TABLES;
        sc[i] = c;
    }
    int ss = d.data[d.pos], se = d.data[d.pos + 1], ahal = d.data[d.pos + 2];
    if (ss != 0 || se != 63 || ahal != 0) return E_PROGRESSIVE;
    d.pos = end;
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    d.bits = 0;
    d.nbits = 0;
    d.hit_marker = false;

    int restarts_left = d.restart_interval;
    auto restart = [&]() {
        if (d.restart_interval) {
            if (restarts_left == 0) {
                process_restart(d);
                for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
                restarts_left = d.restart_interval;
            }
            --restarts_left;
        }
    };
    if (ns == 1) {
        Component& c = *sc[0];
        int bw = (c.dw + 7) / 8, bh = (c.dh + 7) / 8;
        for (int by = 0; by < bh; ++by)
            for (int bx = 0; bx < bw; ++bx) {
                restart();
                int16_t* blk = &c.coef[((size_t)by * c.bw + bx) * 64];
                int rc = decode_block(d, c, blk);
                if (rc) return rc;
            }
    } else {
        int mx = (d.width + 8 * d.max_h - 1) / (8 * d.max_h);
        int my = (d.height + 8 * d.max_v - 1) / (8 * d.max_v);
        for (int y = 0; y < my; ++y)
            for (int x = 0; x < mx; ++x) {
                restart();
                for (int i = 0; i < ns; ++i) {
                    Component& c = *sc[i];
                    for (int v = 0; v < c.v; ++v)
                        for (int h = 0; h < c.h; ++h) {
                            size_t bi = (size_t)(y * c.v + v) * c.bw +
                                        (x * c.h + h);
                            int rc = decode_block(d, c, &c.coef[bi * 64]);
                            if (rc) return rc;
                        }
                }
            }
    }
    skip_to_marker(d);
    return OK;
}

int parse_frame(Decoder& d, bool headers_only) {
    int len;
    if (read_u16(d, len)) return E_TRUNCATED;
    if (d.pos + len - 2 > d.size || len < 8) return E_TRUNCATED;
    const uint8_t* p = d.data + d.pos;
    if (p[0] != 8) return E_PRECISION;
    d.height = (p[1] << 8) | p[2];
    d.width = (p[3] << 8) | p[4];
    d.ncomp = p[5];
    if (d.width <= 0 || d.height <= 0) return E_SIZE;
    if ((int64_t)d.width * d.height > kMaxPixels) return E_TOO_LARGE;
    if (d.ncomp == 4) return E_CMYK;
    if (d.ncomp != 1 && d.ncomp != 3) return E_COMPONENTS;
    if (len < 8 + 3 * d.ncomp) return E_TRUNCATED;
    d.max_h = d.max_v = 1;
    for (int i = 0; i < d.ncomp; ++i) {
        Component& c = d.comp[i];
        c.id = p[6 + 3 * i];
        c.h = p[7 + 3 * i] >> 4;
        c.v = p[7 + 3 * i] & 15;
        c.tq = p[8 + 3 * i];
        if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2 || c.tq > 3)
            return E_SAMPLING;
        d.max_h = c.h > d.max_h ? c.h : d.max_h;
        d.max_v = c.v > d.max_v ? c.v : d.max_v;
    }
    int mx = (d.width + 8 * d.max_h - 1) / (8 * d.max_h);
    int my = (d.height + 8 * d.max_v - 1) / (8 * d.max_v);
    for (int i = 0; i < d.ncomp; ++i) {
        Component& c = d.comp[i];
        if (d.ncomp == 1) {  // one component: sampling factors are moot
            c.h = c.v = 1;
            d.max_h = d.max_v = 1;
            mx = (d.width + 7) / 8;
            my = (d.height + 7) / 8;
        }
        c.dw = (int)(((long)d.width * c.h + d.max_h - 1) / d.max_h);
        c.dh = (int)(((long)d.height * c.v + d.max_v - 1) / d.max_v);
        c.bw = mx * c.h;
        c.bh = my * c.v;
        if (!headers_only) c.coef.assign((size_t)c.bw * c.bh * 64, 0);
    }
    d.pos += len - 2;
    d.frame = true;
    return OK;
}

int parse(Decoder& d, bool headers_only) {
    if (d.size < 4 || d.data[0] != 0xFF || d.data[1] != 0xD8)
        return E_NOT_JPEG;
    d.pos = 2;
    while (true) {
        // find a marker
        while (d.pos < d.size && d.data[d.pos] != 0xFF) ++d.pos;
        while (d.pos < d.size && d.data[d.pos] == 0xFF) ++d.pos;
        if (d.pos >= d.size) return d.frame ? OK : E_TRUNCATED;
        int m = d.data[d.pos++];
        if (m == 0xD9) return d.frame ? OK : E_NO_FRAME;     // EOI
        if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
        switch (m) {
        case 0xC0: case 0xC1: {
            if (d.frame) return E_CORRUPT;
            int rc = parse_frame(d, headers_only);
            if (rc) return rc;
            break;
        }
        case 0xC2: case 0xC6: return E_PROGRESSIVE;
        case 0xC3: case 0xC7: return E_LOSSLESS;
        case 0xC5: return E_HIERARCHICAL;
        case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        case 0xCC:
            return E_ARITHMETIC;
        case 0xC4: {  // DHT
            int len;
            if (read_u16(d, len)) return E_TRUNCATED;
            size_t end = d.pos + len - 2;
            if (end > d.size) return E_TRUNCATED;
            while (d.pos + 17 <= end) {
                int tc = d.data[d.pos] >> 4, th = d.data[d.pos] & 15;
                const uint8_t* counts = d.data + d.pos + 1;
                int total = 0;
                for (int i = 0; i < 16; ++i) total += counts[i];
                if (tc > 1 || th > 3 || total > 256 ||
                    d.pos + 17 + total > end)
                    return E_TABLES;
                build_huff(tc ? d.ac[th] : d.dc[th], counts,
                           d.data + d.pos + 17);
                d.pos += 17 + total;
            }
            d.pos = end;
            break;
        }
        case 0xDB: {  // DQT
            int len;
            if (read_u16(d, len)) return E_TRUNCATED;
            size_t end = d.pos + len - 2;
            if (end > d.size) return E_TRUNCATED;
            while (d.pos < end) {
                int pq = d.data[d.pos] >> 4, tq = d.data[d.pos] & 15;
                if (tq > 3) return E_TABLES;
                ++d.pos;
                for (int i = 0; i < 64; ++i) {
                    int v;
                    if (pq) {
                        if (d.pos + 2 > end) return E_TRUNCATED;
                        v = (d.data[d.pos] << 8) | d.data[d.pos + 1];
                        d.pos += 2;
                    } else {
                        if (d.pos + 1 > end) return E_TRUNCATED;
                        v = d.data[d.pos++];
                    }
                    d.qt[tq][kZigzag[i]] = (uint16_t)v;
                }
                d.qt_present[tq] = true;
            }
            d.pos = end;
            break;
        }
        case 0xDD: {  // DRI
            int len, ri;
            if (read_u16(d, len) || read_u16(d, ri)) return E_TRUNCATED;
            if (len != 4) return E_CORRUPT;
            d.restart_interval = ri;
            break;
        }
        case 0xDA: {  // SOS
            if (headers_only) return d.frame ? OK : E_NO_FRAME;
            int rc = decode_scan(d);
            if (rc) return rc;
            break;
        }
        default: {  // APPn, COM, DNL and the rest: skip, reading APP0/1/14
            int len;
            if (read_u16(d, len)) return E_TRUNCATED;
            if (len < 2 || d.pos + len - 2 > d.size) return E_TRUNCATED;
            const uint8_t* p = d.data + d.pos;
            int n = len - 2;
            if (m == 0xE0 && n >= 5 && !memcmp(p, "JFIF\0", 5)) d.jfif = true;
            if (m == 0xE1 && n >= 6 && !memcmp(p, "Exif\0\0", 6))
                parse_exif(d, p + 6, n - 6);
            if (m == 0xEE && n >= 12 && !memcmp(p, "Adobe", 5)) {
                d.adobe = true;
                d.adobe_transform = p[11];
            }
            d.pos += n;
            break;
        }
        }
    }
}

// ISLOW inverse DCT (jidctint.c)
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
#define DESCALE(x, n) (((x) + ((int64_t)1 << ((n)-1))) >> (n))

struct RangeLimit {
    uint8_t post[1024];  // indexed by (x & 1023), x the centred IDCT output
    RangeLimit() {
        for (int v = 0; v < 1024; ++v) {
            int x = v < 512 ? v : v - 1024;
            int s = x + 128;
            post[v] = (uint8_t)(s < 0 ? 0 : s > 255 ? 255 : s);
        }
    }
};
const RangeLimit kRange;

void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                int stride) {
    int ws[64];
    for (int c = 0; c < 8; ++c) {
        const int16_t* ip = in + c;
        const uint16_t* qp = q + c;
        int* wp = ws + c;
        if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 &&
            ip[40] == 0 && ip[48] == 0 && ip[56] == 0) {
            int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
            for (int r = 0; r < 8; ++r) wp[8 * r] = dc;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = ip[16] * qp[16];
        z3 = ip[48] * qp[48];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        z2 = ip[0] * qp[0];
        z3 = ip[32] * qp[32];
        t0 = (z2 + z3) * (1 << CONST_BITS);
        t1 = (z2 - z3) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = ip[56] * qp[56];
        t1 = ip[40] * qp[40];
        t2 = ip[24] * qp[24];
        t3 = ip[8] * qp[8];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        wp[0] = (int)DESCALE(t10 + t3, CONST_BITS - PASS1_BITS);
        wp[56] = (int)DESCALE(t10 - t3, CONST_BITS - PASS1_BITS);
        wp[8] = (int)DESCALE(t11 + t2, CONST_BITS - PASS1_BITS);
        wp[48] = (int)DESCALE(t11 - t2, CONST_BITS - PASS1_BITS);
        wp[16] = (int)DESCALE(t12 + t1, CONST_BITS - PASS1_BITS);
        wp[40] = (int)DESCALE(t12 - t1, CONST_BITS - PASS1_BITS);
        wp[24] = (int)DESCALE(t13 + t0, CONST_BITS - PASS1_BITS);
        wp[32] = (int)DESCALE(t13 - t0, CONST_BITS - PASS1_BITS);
    }
    for (int r = 0; r < 8; ++r) {
        const int* wp = ws + 8 * r;
        uint8_t* op = out + (size_t)r * stride;
        if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 &&
            wp[5] == 0 && wp[6] == 0 && wp[7] == 0) {
            uint8_t v = kRange.post[(int)DESCALE((int64_t)wp[0],
                                                 PASS1_BITS + 3) & 1023];
            for (int i = 0; i < 8; ++i) op[i] = v;
            continue;
        }
        int64_t z1, z2, z3, z4, z5, t0, t1, t2, t3, t10, t11, t12, t13;
        z2 = wp[2];
        z3 = wp[6];
        z1 = (z2 + z3) * FIX_0_541196100;
        t2 = z1 + z3 * (-FIX_1_847759065);
        t3 = z1 + z2 * FIX_0_765366865;
        t0 = ((int64_t)wp[0] + wp[4]) * (1 << CONST_BITS);
        t1 = ((int64_t)wp[0] - wp[4]) * (1 << CONST_BITS);
        t10 = t0 + t3;
        t13 = t0 - t3;
        t11 = t1 + t2;
        t12 = t1 - t2;
        t0 = wp[7];
        t1 = wp[5];
        t2 = wp[3];
        t3 = wp[1];
        z1 = t0 + t3;
        z2 = t1 + t2;
        z3 = t0 + t2;
        z4 = t1 + t3;
        z5 = (z3 + z4) * FIX_1_175875602;
        t0 = t0 * FIX_0_298631336;
        t1 = t1 * FIX_2_053119869;
        t2 = t2 * FIX_3_072711026;
        t3 = t3 * FIX_1_501321110;
        z1 = z1 * (-FIX_0_899976223);
        z2 = z2 * (-FIX_2_562915447);
        z3 = z3 * (-FIX_1_961570560);
        z4 = z4 * (-FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        t0 += z1 + z3;
        t1 += z2 + z4;
        t2 += z2 + z3;
        t3 += z1 + z4;
        const int n = CONST_BITS + PASS1_BITS + 3;
        op[0] = kRange.post[(int)DESCALE(t10 + t3, n) & 1023];
        op[7] = kRange.post[(int)DESCALE(t10 - t3, n) & 1023];
        op[1] = kRange.post[(int)DESCALE(t11 + t2, n) & 1023];
        op[6] = kRange.post[(int)DESCALE(t11 - t2, n) & 1023];
        op[2] = kRange.post[(int)DESCALE(t12 + t1, n) & 1023];
        op[5] = kRange.post[(int)DESCALE(t12 - t1, n) & 1023];
        op[3] = kRange.post[(int)DESCALE(t13 + t0, n) & 1023];
        op[4] = kRange.post[(int)DESCALE(t13 - t0, n) & 1023];
    }
}

struct YccTables {
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    YccTables() {
        const int S = 16;
        const int64_t half = (int64_t)1 << (S - 1);
        auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = (int)((fix(1.40200) * x + half) >> S);
            cb_b[i] = (int)((fix(1.77200) * x + half) >> S);
            cr_g[i] = (-fix(0.71414)) * x;
            cb_g[i] = (-fix(0.34414)) * x + half;
        }
    }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) {
    return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
}

// Upsample one component plane (dw x dh valid samples, row stride `ps`)
// to full resolution rows [0, H) x [0, W) into `out` (W x H).
void upsample(const Component& c, const uint8_t* plane, int ps, int hx,
              int vx, int W, int H, uint8_t* out) {
    auto row_at = [&](int r) {  // rows past the edges replicate them
        r = r < 0 ? 0 : r >= c.dh ? c.dh - 1 : r;
        return plane + (size_t)r * ps;
    };
    if (hx == 1 && vx == 1) {
        for (int y = 0; y < H; ++y)
            memcpy(out + (size_t)y * W, plane + (size_t)y * ps, W);
        return;
    }
    bool fancy_h2 = hx == 2 && c.dw > 2;
    if (hx == 2 && vx == 1 && fancy_h2) {           // h2v1_fancy_upsample
        std::vector<uint8_t> row(2 * c.dw);
        for (int y = 0; y < H; ++y) {
            const uint8_t* in = plane + (size_t)y * ps;
            int n = c.dw;
            row[0] = in[0];
            row[1] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
            for (int i = 1; i < n - 1; ++i) {
                int v = in[i] * 3;
                row[2 * i] = (uint8_t)((v + in[i - 1] + 1) >> 2);
                row[2 * i + 1] = (uint8_t)((v + in[i + 1] + 2) >> 2);
            }
            row[2 * n - 2] = (uint8_t)((in[n - 1] * 3 + in[n - 2] + 1) >> 2);
            row[2 * n - 1] = in[n - 1];
            memcpy(out + (size_t)y * W, row.data(), W);
        }
        return;
    }
    if (hx == 2 && vx == 2 && fancy_h2) {           // h2v2_fancy_upsample
        std::vector<int> sum(c.dw);
        std::vector<uint8_t> row(2 * c.dw);
        for (int y = 0; y < H; ++y) {
            int r = y >> 1, far = (y & 1) ? r + 1 : r - 1;
            const uint8_t* near_row = row_at(r);
            const uint8_t* far_row = row_at(far);
            for (int i = 0; i < c.dw; ++i)
                sum[i] = near_row[i] * 3 + far_row[i];
            int n = c.dw;
            row[0] = (uint8_t)((sum[0] * 4 + 8) >> 4);
            row[1] = (uint8_t)((sum[0] * 3 + sum[1] + 7) >> 4);
            for (int i = 1; i < n - 1; ++i) {
                row[2 * i] = (uint8_t)((sum[i] * 3 + sum[i - 1] + 8) >> 4);
                row[2 * i + 1] = (uint8_t)((sum[i] * 3 + sum[i + 1] + 7) >> 4);
            }
            row[2 * n - 2] = (uint8_t)((sum[n - 1] * 3 + sum[n - 2] + 8) >> 4);
            row[2 * n - 1] = (uint8_t)((sum[n - 1] * 4 + 7) >> 4);
            memcpy(out + (size_t)y * W, row.data(), W);
        }
        return;
    }
    if (hx == 1 && vx == 2) {                       // h1v2_fancy_upsample
        for (int y = 0; y < H; ++y) {
            int r = y >> 1, far = (y & 1) ? r + 1 : r - 1, bias = (y & 1) + 1;
            uint8_t* o = out + (size_t)y * W;
            const uint8_t *near_row = row_at(r), *far_row = row_at(far);
            for (int i = 0; i < W; ++i)
                o[i] = (uint8_t)((near_row[i] * 3 + far_row[i] + bias) >> 2);
        }
        return;
    }
    for (int y = 0; y < H; ++y) {                   // box replication
        const uint8_t* in = plane + (size_t)(y / vx) * ps;
        uint8_t* o = out + (size_t)y * W;
        for (int i = 0; i < W; ++i) o[i] = in[i / hx];
    }
}

int decode_into(Decoder& d, uint8_t* bgr) {
    const int W = d.width, H = d.height;
    std::vector<uint8_t> full[3];
    for (int ci = 0; ci < d.ncomp; ++ci) {
        Component& c = d.comp[ci];
        if (!d.qt_present[c.tq]) return E_TABLES;
        int ps = c.bw * 8;
        std::vector<uint8_t> plane((size_t)ps * c.bh * 8);
        for (int by = 0; by < c.bh; ++by)
            for (int bx = 0; bx < c.bw; ++bx)
                idct_islow(&c.coef[((size_t)by * c.bw + bx) * 64],
                           d.qt[c.tq], &plane[(size_t)by * 8 * ps + bx * 8],
                           ps);
        int hx = d.max_h / c.h, vx = d.max_v / c.v;
        if (hx * c.h != d.max_h || vx * c.v != d.max_v) return E_SAMPLING;
        full[ci].resize((size_t)W * H);
        upsample(c, plane.data(), ps, hx, vx, W, H, full[ci].data());
    }
    size_t n = (size_t)W * H;
    if (d.ncomp == 1) {
        const uint8_t* g = full[0].data();
        for (size_t i = 0; i < n; ++i)
            bgr[3 * i] = bgr[3 * i + 1] = bgr[3 * i + 2] = g[i];
        return OK;
    }
    bool rgb;
    if (d.jfif) rgb = false;
    else if (d.adobe) rgb = d.adobe_transform == 0;
    else rgb = d.comp[0].id == 'R' && d.comp[1].id == 'G' &&
               d.comp[2].id == 'B';
    const uint8_t *p0 = full[0].data(), *p1 = full[1].data(),
                  *p2 = full[2].data();
    if (rgb) {
        for (size_t i = 0; i < n; ++i) {
            bgr[3 * i] = p2[i];
            bgr[3 * i + 1] = p1[i];
            bgr[3 * i + 2] = p0[i];
        }
        return OK;
    }
    for (size_t i = 0; i < n; ++i) {
        int y = p0[i], cb = p1[i], cr = p2[i];
        bgr[3 * i + 2] = clamp255(y + kYcc.cr_r[cr]);
        bgr[3 * i + 1] =
            clamp255(y + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
        bgr[3 * i] = clamp255(y + kYcc.cb_b[cb]);
    }
    return OK;
}

// ---------------------------------------------------------------- encoding

const uint8_t kStdLumaQ[64] = {  // natural order (jcparam.c)
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcLumaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcChromaVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct EncTable {
    uint16_t code[256];
    uint8_t size[256];
    EncTable(const uint8_t* bits, const uint8_t* vals) {
        memset(code, 0, sizeof(code));
        memset(size, 0, sizeof(size));
        int c = 0, k = 0;
        for (int len = 1; len <= 16; ++len) {
            for (int i = 0; i < bits[len - 1]; ++i, ++k) {
                code[vals[k]] = (uint16_t)c++;
                size[vals[k]] = (uint8_t)len;
            }
            c <<= 1;
        }
    }
};

struct BitWriter {  // writes after the headers already in `out`
    std::vector<uint8_t>& out;
    size_t pos;
    uint64_t acc = 0;
    int n = 0;
    explicit BitWriter(std::vector<uint8_t>& o) : out(o), pos(o.size()) {}
    void reserve(size_t extra) {
        if (pos + extra > out.size()) out.resize(2 * (pos + extra));
    }
    inline void put(uint32_t bits, int len) {
        acc = (acc << len) | (bits & ((1u << len) - 1));
        n += len;
        while (n >= 8) {
            uint8_t b = (uint8_t)(acc >> (n - 8));
            out[pos++] = b;
            if (b == 0xFF) out[pos++] = 0;  // byte stuffing
            n -= 8;
        }
    }
    void flush() {  // pad with 1 bits, drop the rest (jchuff.c flush_bits)
        put(0x7F, 7);
        acc = 0;
        n = 0;
        out.resize(pos);
    }
};

// 32-bit lanes, as turbo's SIMD FDCT: 8-bit samples keep every product
// inside them (DCTELEM is 16-bit in turbo's SIMD build)
#define DESCALE32(x, n) (((x) + (1 << ((n)-1))) >> (n))
void fdct_islow(int16_t* data) {
    int16_t* p = data;
    for (int r = 0; r < 8; ++r, p += 8) {
        int32_t t0 = p[0] + p[7], t7 = p[0] - p[7], t1 = p[1] + p[6],
                t6 = p[1] - p[6], t2 = p[2] + p[5], t5 = p[2] - p[5],
                t3 = p[3] + p[4], t4 = p[3] - p[4];
        int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        p[0] = (int16_t)((t10 + t11) * (1 << PASS1_BITS));
        p[4] = (int16_t)((t10 - t11) * (1 << PASS1_BITS));
        int32_t z1 = (t12 + t13) * (int32_t)FIX_0_541196100;
        p[2] = (int16_t)DESCALE32(z1 + t13 * (int32_t)FIX_0_765366865,
                                CONST_BITS - PASS1_BITS);
        p[6] = (int16_t)DESCALE32(z1 + t12 * (-(int32_t)FIX_1_847759065),
                                CONST_BITS - PASS1_BITS);
        z1 = t4 + t7;
        int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
        int32_t z5 = (z3 + z4) * (int32_t)FIX_1_175875602;
        t4 = t4 * (int32_t)FIX_0_298631336;
        t5 = t5 * (int32_t)FIX_2_053119869;
        t6 = t6 * (int32_t)FIX_3_072711026;
        t7 = t7 * (int32_t)FIX_1_501321110;
        z1 = z1 * (-(int32_t)FIX_0_899976223);
        z2 = z2 * (-(int32_t)FIX_2_562915447);
        z3 = z3 * (-(int32_t)FIX_1_961570560);
        z4 = z4 * (-(int32_t)FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        p[7] = (int16_t)DESCALE32(t4 + z1 + z3, CONST_BITS - PASS1_BITS);
        p[5] = (int16_t)DESCALE32(t5 + z2 + z4, CONST_BITS - PASS1_BITS);
        p[3] = (int16_t)DESCALE32(t6 + z2 + z3, CONST_BITS - PASS1_BITS);
        p[1] = (int16_t)DESCALE32(t7 + z1 + z4, CONST_BITS - PASS1_BITS);
    }
    for (int c = 0; c < 8; ++c) {
        int16_t* q = data + c;
        int32_t t0 = q[0] + q[56], t7 = q[0] - q[56], t1 = q[8] + q[48],
                t6 = q[8] - q[48], t2 = q[16] + q[40], t5 = q[16] - q[40],
                t3 = q[24] + q[32], t4 = q[24] - q[32];
        int32_t t10 = t0 + t3, t13 = t0 - t3, t11 = t1 + t2, t12 = t1 - t2;
        q[0] = (int16_t)DESCALE32(t10 + t11, PASS1_BITS);
        q[32] = (int16_t)DESCALE32(t10 - t11, PASS1_BITS);
        int32_t z1 = (t12 + t13) * (int32_t)FIX_0_541196100;
        q[16] = (int16_t)DESCALE32(z1 + t13 * (int32_t)FIX_0_765366865,
                                 CONST_BITS + PASS1_BITS);
        q[48] = (int16_t)DESCALE32(z1 + t12 * (-(int32_t)FIX_1_847759065),
                                 CONST_BITS + PASS1_BITS);
        z1 = t4 + t7;
        int32_t z2 = t5 + t6, z3 = t4 + t6, z4 = t5 + t7;
        int32_t z5 = (z3 + z4) * (int32_t)FIX_1_175875602;
        t4 = t4 * (int32_t)FIX_0_298631336;
        t5 = t5 * (int32_t)FIX_2_053119869;
        t6 = t6 * (int32_t)FIX_3_072711026;
        t7 = t7 * (int32_t)FIX_1_501321110;
        z1 = z1 * (-(int32_t)FIX_0_899976223);
        z2 = z2 * (-(int32_t)FIX_2_562915447);
        z3 = z3 * (-(int32_t)FIX_1_961570560);
        z4 = z4 * (-(int32_t)FIX_0_390180644);
        z3 += z5;
        z4 += z5;
        q[56] = (int16_t)DESCALE32(t4 + z1 + z3, CONST_BITS + PASS1_BITS);
        q[40] = (int16_t)DESCALE32(t5 + z2 + z4, CONST_BITS + PASS1_BITS);
        q[24] = (int16_t)DESCALE32(t6 + z2 + z3, CONST_BITS + PASS1_BITS);
        q[8] = (int16_t)DESCALE32(t7 + z1 + z4, CONST_BITS + PASS1_BITS);
    }
}

struct Divisor {  // jcdctmgr.c compute_reciprocal, 16-bit DCTELEM
    uint16_t recip, corr;
    int shift;
    explicit Divisor(int divisor) {
        if (divisor == 1) {
            recip = 1;
            corr = 0;
            shift = -16;
            return;
        }
        int b = 31 - __builtin_clz((unsigned)divisor);  // flss - 1
        int r = 16 + b;
        uint32_t fq = (uint32_t)(((uint64_t)1 << r) / divisor);
        uint32_t fr = (uint32_t)(((uint64_t)1 << r) % divisor);
        uint32_t c = divisor / 2;
        if (fr == 0) {
            fq >>= 1;
            r--;
        } else if (fr <= (uint32_t)divisor / 2u) {
            c++;
        } else {
            fq++;
        }
        recip = (uint16_t)fq;
        corr = (uint16_t)c;
        shift = r - 16;
    }
    int16_t apply(int16_t v) const {
        int t = v < 0 ? -v : v;
        uint32_t product = (uint32_t)(uint16_t)(t + corr) * recip;
        product >>= shift + 16;
        int16_t q = (int16_t)product;
        return v < 0 ? (int16_t)-q : q;
    }
};

void put_u16(std::vector<uint8_t>& o, int v) {
    o.push_back((uint8_t)(v >> 8));
    o.push_back((uint8_t)v);
}

void emit_dqt(std::vector<uint8_t>& o, int id, const int* q) {
    o.push_back(0xFF); o.push_back(0xDB);
    put_u16(o, 67);
    o.push_back((uint8_t)id);
    for (int i = 0; i < 64; ++i) o.push_back((uint8_t)q[kZigzag[i]]);
}

void emit_dht(std::vector<uint8_t>& o, int cls_id, const uint8_t* bits,
              const uint8_t* vals) {
    int total = 0;
    for (int i = 0; i < 16; ++i) total += bits[i];
    o.push_back(0xFF); o.push_back(0xC4);
    put_u16(o, 2 + 1 + 16 + total);
    o.push_back((uint8_t)cls_id);
    for (int i = 0; i < 16; ++i) o.push_back(bits[i]);
    for (int i = 0; i < total; ++i) o.push_back(vals[i]);
}

inline int nbits_of(int v) {
    unsigned a = (unsigned)(v < 0 ? -v : v);
    return a ? 32 - __builtin_clz(a) : 0;
}

void encode_block(BitWriter& bw, const int16_t* coef, int& last_dc,
                  const EncTable& dct, const EncTable& act) {
    int diff = coef[0] - last_dc;
    last_dc = coef[0];
    int n = nbits_of(diff);
    bw.put(dct.code[n], dct.size[n]);
    if (n) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff), n);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
        int v = coef[k];   // zigzag order
        if (v == 0) { ++run; continue; }
        while (run > 15) {
            bw.put(act.code[0xF0], act.size[0xF0]);
            run -= 16;
        }
        int s = nbits_of(v);
        int sym = (run << 4) | s;
        bw.put(act.code[sym], act.size[sym]);
        bw.put((uint32_t)(v < 0 ? v - 1 : v), s);
        run = 0;
    }
    if (run > 0) bw.put(act.code[0], act.size[0]);
}

// Encode an (h, w, channels) BGR (3) frame at `quality` as 4:2:0 (luma
// 2x2, chroma 1x1), or a gray (1) frame.
int encode(const uint8_t* img, int w, int h, int channels, int quality,
           std::vector<uint8_t>& o) {
    if (w <= 0 || h <= 0 || w > 65535 || h > 65535) return E_SIZE;
    if (channels != 1 && channels != 3) return E_COMPONENTS;
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int qtab[2][64];
    for (int i = 0; i < 64; ++i) {
        for (int t = 0; t < 2; ++t) {
            long v = ((long)(t ? kStdChromaQ[i] : kStdLumaQ[i]) * scale + 50)
                     / 100;
            qtab[t][i] = (int)(v <= 0 ? 1 : v > 255 ? 255 : v);
        }
    }
    const int nc = channels == 3 ? 3 : 1;
    const int sh = nc == 3 ? 2 : 1, sv = sh, max_h = sh, max_v = sv;

    // colour conversion to full-resolution planes (jccolor.c)
    std::vector<uint8_t> full[3];
    for (int c = 0; c < nc; ++c) full[c].resize((size_t)w * h);
    if (nc == 1) {
        memcpy(full[0].data(), img, (size_t)w * h);
    } else {
        static int64_t tab[8 * 256];
        static std::once_flag once;
        std::call_once(once, [] {
            auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
            const int64_t half = (int64_t)1 << 15, off = (int64_t)128 << 16;
            for (int i = 0; i < 256; ++i) {
                tab[i] = fix(0.29900) * i;
                tab[i + 256] = fix(0.58700) * i;
                tab[i + 512] = fix(0.11400) * i + half;
                tab[i + 768] = (-fix(0.16874)) * i;
                tab[i + 1024] = (-fix(0.33126)) * i;
                tab[i + 1280] = fix(0.50000) * i + off + half - 1;
                tab[i + 1536] = (-fix(0.41869)) * i;
                tab[i + 1792] = (-fix(0.08131)) * i;
            }
        });
        const size_t n = (size_t)w * h;
        for (size_t i = 0; i < n; ++i) {
            int b = img[3 * i], g = img[3 * i + 1], r = img[3 * i + 2];
            full[0][i] = (uint8_t)((tab[r] + tab[g + 256] + tab[b + 512]) >> 16);
            full[1][i] = (uint8_t)((tab[r + 768] + tab[g + 1024] +
                                    tab[b + 1280]) >> 16);
            full[2][i] = (uint8_t)((tab[r + 1280] + tab[g + 1536] +
                                    tab[b + 1792]) >> 16);
        }
    }
    // components: luma (sh, sv), chroma (1, 1)
    struct Comp { int h, v, dw, dh, bw, bh, pw, ph; std::vector<uint8_t> p; };
    Comp comp[3];
    int mx = (w + 8 * max_h - 1) / (8 * max_h);
    int my = (h + 8 * max_v - 1) / (8 * max_v);
    for (int c = 0; c < nc; ++c) {
        Comp& k = comp[c];
        k.h = c == 0 ? sh : 1;
        k.v = c == 0 ? sv : 1;
        k.dw = (int)(((long)w * k.h + max_h - 1) / max_h);
        k.dh = (int)(((long)h * k.v + max_v - 1) / max_v);
        k.bw = (k.dw + 7) / 8;   // width_in_blocks
        k.bh = (k.dh + 7) / 8;
        int hx = max_h / k.h, vx = max_v / k.v;
        k.pw = k.bw * 8;
        k.ph = my * k.v * 8;     // downsampled rows, padded to the iMCU rows
        k.p.assign((size_t)k.pw * k.ph, 0);
        // the input, edge-replicated to what the downsampler reads
        int in_w = k.pw * hx;
        int in_rows = ((h + max_v - 1) / max_v) * max_v;
        int out_rows = in_rows / vx;
        std::vector<uint8_t> row0(in_w), row1(in_w);
        auto src_row = [&](int y, std::vector<uint8_t>& dst) {
            if (y >= h) y = h - 1;
            const uint8_t* s = &full[c][(size_t)y * w];
            memcpy(dst.data(), s, w);
            for (int x = w; x < in_w; ++x) dst[x] = s[w - 1];
        };
        for (int oy = 0; oy < out_rows; ++oy) {
            uint8_t* o = &k.p[(size_t)oy * k.pw];
            if (hx == 1 && vx == 1) {
                src_row(oy, row0);
                memcpy(o, row0.data(), k.pw);
            } else {  // h2v2_downsample
                src_row(2 * oy, row0);
                src_row(2 * oy + 1, row1);
                int bias = 1;
                for (int x = 0; x < k.pw; ++x) {
                    o[x] = (uint8_t)((row0[2 * x] + row0[2 * x + 1] +
                                      row1[2 * x] + row1[2 * x + 1] + bias) >> 2);
                    bias ^= 3;
                }
            }
        }
        for (int oy = out_rows; oy < k.ph; ++oy)   // pad to the iMCU height
            memcpy(&k.p[(size_t)oy * k.pw], &k.p[(size_t)(out_rows - 1) * k.pw],
                   k.pw);
    }

    // headers (jcmarker.c)
    o.clear();
    o.reserve((size_t)w * h / 2 + 1024);
    o.push_back(0xFF); o.push_back(0xD8);
    const uint8_t jfif[] = {0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                            0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
    o.insert(o.end(), jfif, jfif + sizeof(jfif));
    emit_dqt(o, 0, qtab[0]);
    if (nc == 3) emit_dqt(o, 1, qtab[1]);
    o.push_back(0xFF); o.push_back(0xC0);
    put_u16(o, 8 + 3 * nc);
    o.push_back(8);
    put_u16(o, h);
    put_u16(o, w);
    o.push_back((uint8_t)nc);
    for (int c = 0; c < nc; ++c) {
        o.push_back((uint8_t)(c + 1));
        o.push_back((uint8_t)((comp[c].h << 4) | comp[c].v));
        o.push_back((uint8_t)(c ? 1 : 0));
    }
    emit_dht(o, 0x00, kDcLumaBits, kDcLumaVals);
    emit_dht(o, 0x10, kAcLumaBits, kAcLumaVals);
    if (nc == 3) {
        emit_dht(o, 0x01, kDcChromaBits, kDcChromaVals);
        emit_dht(o, 0x11, kAcChromaBits, kAcChromaVals);
    }
    o.push_back(0xFF); o.push_back(0xDA);
    put_u16(o, 6 + 2 * nc);
    o.push_back((uint8_t)nc);
    for (int c = 0; c < nc; ++c) {
        o.push_back((uint8_t)(c + 1));
        o.push_back((uint8_t)(c ? 0x11 : 0x00));
    }
    o.push_back(0); o.push_back(63); o.push_back(0);

    static const EncTable dcl(kDcLumaBits, kDcLumaVals),
        acl(kAcLumaBits, kAcLumaVals), dcc(kDcChromaBits, kDcChromaVals),
        acc(kAcChromaBits, kAcChromaVals);
    std::vector<Divisor> div[2];
    for (int t = 0; t < 2; ++t)
        for (int i = 0; i < 64; ++i) div[t].emplace_back(qtab[t][i] << 3);

    BitWriter bw(o);
    int last_dc[3] = {0, 0, 0};
    int16_t blk[64], coef[64];
    auto block = [&](int c, int by, int bx, int16_t* out) {
        const Comp& k = comp[c];
        for (int y = 0; y < 8; ++y) {
            const uint8_t* s = &k.p[(size_t)(by * 8 + y) * k.pw + bx * 8];
            for (int x = 0; x < 8; ++x) blk[y * 8 + x] = (int16_t)(s[x] - 128);
        }
        fdct_islow(blk);
        const std::vector<Divisor>& dv = div[c ? 1 : 0];
        for (int k = 0; k < 64; ++k) {   // quantized, in zigzag order
            int i = kZigzag[k];
            out[k] = dv[i].apply(blk[i]);
        }
    };
    // interleaved MCUs; dummy blocks past the edges (jccoefct.c): zero AC,
    // the DC of the block to the left, or of the last block of the block
    // row above within the MCU
    int16_t mcu_dc[2][2];
    for (int y = 0; y < my; ++y)
        for (int x = 0; x < mx; ++x)
            for (int c = 0; c < nc; ++c) {
                const Comp& k = comp[c];
                for (int v = 0; v < k.v; ++v) {
                    int by = y * k.v + v;
                    for (int hh = 0; hh < k.h; ++hh) {
                        int bx = x * k.h + hh;
                        if (by < k.bh && bx < k.bw) {
                            block(c, by, bx, coef);
                        } else {
                            memset(coef, 0, sizeof(coef));
                            coef[0] = by < k.bh ? mcu_dc[v][hh - 1]
                                                : mcu_dc[v - 1][k.h - 1];
                        }
                        mcu_dc[v][hh] = coef[0];
                        bw.reserve(1024);   // a block's most, stuffed
                        encode_block(bw, coef, last_dc[c],
                                     c ? dcc : dcl, c ? acc : acl);
                    }
                }
            }
    bw.flush();
    o.push_back(0xFF); o.push_back(0xD9);
    return OK;
}

}  // namespace

// ------------------------------------------------ the threaded MJPEG reader

namespace {

// No exception leaves the library: an allocation that fails is an error
// code, on the caller's thread and on the reader's workers alike.
template <class T, class F>
T guarded(T on_error, F&& f) {
    try {
        return f();
    } catch (...) {
        return on_error;
    }
}

int decode_frame(const uint8_t* data, size_t size, uint8_t* bgr, int w,
                 int h) {
    return guarded(int(E_MEMORY), [&] {
        Decoder d;
        d.data = data;
        d.size = size;
        int rc = parse(d, false);
        if (rc) return rc;
        if (d.width != w || d.height != h) return int(E_SIZE);
        return decode_into(d, bgr);
    });
}

// Frames of a file (offsets and sizes from the container's index) decoded
// by `n_threads` workers into a ring of `depth` frames: each worker claims
// the next frame index, waits for its slot to be free, and decodes with no
// lock held; the consumer copies frames out in order.
struct MjpegReader {
    int fd = -1, w = 0, h = 0, depth = 0;
    std::vector<int64_t> offsets;
    std::vector<int32_t> sizes;
    std::vector<uint8_t> ring;
    std::vector<int64_t> slot_frame;   // the frame a slot holds, -1 if none
    int64_t next = 0, consumed = 0, n = 0;
    int error = 0;
    int64_t error_frame = -1;
    bool stop = false;
    std::mutex mu;
    std::condition_variable cv;
    std::vector<std::thread> workers;

    size_t frame_bytes() const { return (size_t)w * h * 3; }

    void work() {
        std::vector<uint8_t> buf;
        while (true) {
            int64_t i;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv.wait(lk, [&] {
                    return stop || error || next >= n || next < consumed + depth;
                });
                if (stop || error || next >= n) return;
                i = next++;
            }
            if (!guarded(false, [&] { buf.resize(sizes[i]); return true; })) {
                std::lock_guard<std::mutex> lk(mu);
                if (!error) {
                    error = E_MEMORY;
                    error_frame = i;
                }
                slot_frame[i % depth] = i;
                cv.notify_all();
                continue;
            }
            ssize_t got = pread(fd, buf.data(), sizes[i], offsets[i]);
            int rc = got == sizes[i]
                         ? decode_frame(buf.data(), buf.size(),
                                        &ring[(size_t)(i % depth) * frame_bytes()],
                                        w, h)
                         : E_IO;
            {
                std::lock_guard<std::mutex> lk(mu);
                if (rc && !error) {
                    error = rc;
                    error_frame = i;
                }
                slot_frame[i % depth] = i;
            }
            cv.notify_all();
        }
    }

    int read(uint8_t* out, int k) {
        int got = 0;
        while (got < k) {
            int64_t idx;
            {
                std::unique_lock<std::mutex> lk(mu);
                idx = consumed;
                if (idx >= n) break;
                cv.wait(lk, [&] {
                    return error || slot_frame[idx % depth] == idx;
                });
                if (error && (error_frame <= idx ||
                              slot_frame[idx % depth] != idx))
                    return error;
            }
            memcpy(out + (size_t)got * frame_bytes(),
                   &ring[(size_t)(idx % depth) * frame_bytes()], frame_bytes());
            {
                std::lock_guard<std::mutex> lk(mu);
                slot_frame[idx % depth] = -1;
                consumed++;
            }
            cv.notify_all();
            ++got;
        }
        return got;
    }

    void close() {
        {
            std::lock_guard<std::mutex> lk(mu);
            stop = true;
        }
        cv.notify_all();
        for (auto& t : workers) t.join();
        workers.clear();
        if (fd >= 0) ::close(fd);
        fd = -1;
    }
};

}  // namespace

extern "C" {

// Header of a JPEG: width, height, components, EXIF orientation (1-8).
// Returns 0 or a negative error code.
int jpeg_info(const uint8_t* data, int64_t size, int* w, int* h, int* ncomp,
              int* orientation) {
    return guarded(int(E_MEMORY), [&] {
        Decoder d;
        d.data = data;
        d.size = (size_t)size;
        int rc = parse(d, true);    // the markers up to the first scan
        if (rc) return rc;
        *w = d.width;
        *h = d.height;
        *ncomp = d.ncomp;
        *orientation = d.orientation;
        return 0;
    });
}

// Decode to (h, w, 3) uint8 BGR, gray replicated, orientation not applied.
int jpeg_decode(const uint8_t* data, int64_t size, uint8_t* bgr, int w,
                int h) {
    return decode_frame(data, (size_t)size, bgr, w, h);
}

// Encode an (h, w, channels) uint8 frame (BGR or gray) into `out`; returns
// the byte count, an error code (-1..-999), or -(1000 + bytes needed) when
// `capacity` is too small.
int64_t jpeg_encode(const uint8_t* img, int w, int h, int channels,
                    int quality, uint8_t* out, int64_t capacity) {
    return guarded((int64_t)E_MEMORY, [&] {
        std::vector<uint8_t> o;
        int rc = encode(img, w, h, channels, quality, o);
        if (rc) return (int64_t)rc;
        if ((int64_t)o.size() > capacity) return -(int64_t)o.size() - 1000;
        memcpy(out, o.data(), o.size());
        return (int64_t)o.size();
    });
}

void* mj_open(const char* path, const int64_t* offsets, const int32_t* sizes,
              int64_t n, int w, int h, int n_threads, int depth) {
    int fd = ::open(path, O_RDONLY);
    if (fd < 0) return nullptr;
    MjpegReader* r = nullptr;
    try {
        r = new MjpegReader();
        r->fd = fd;
        r->w = w;
        r->h = h;
        r->n = n;
        r->depth = depth < 1 ? 1 : depth;
        r->offsets.assign(offsets, offsets + n);
        r->sizes.assign(sizes, sizes + n);
        r->ring.resize((size_t)r->depth * r->frame_bytes());
        r->slot_frame.assign(r->depth, -1);
        for (int t = 0; t < (n_threads < 1 ? 1 : n_threads); ++t)
            r->workers.emplace_back([r] { r->work(); });
        return (void*)r;
    } catch (...) {
        if (r) {
            r->close();   // joins the workers started, closes fd
            delete r;
        } else {
            ::close(fd);
        }
        return (void*)nullptr;
    }
}

int mj_read(void* handle, uint8_t* out, int k) {
    return static_cast<MjpegReader*>(handle)->read(out, k);
}

void mj_close(void* handle) {
    auto* r = static_cast<MjpegReader*>(handle);
    r->close();
    delete r;
}

}  // extern "C"
