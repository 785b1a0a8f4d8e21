// MPEG-4 part 2 (ISO/IEC 14496-2) video decoder: the port's own, for the
// frames that the JAX package reads through cv2, whose FFMPEG capture
// decodes them with ffmpeg's "mpeg4" decoder. The target is that decoder's
// output bit for bit, so where the standard leaves room (the inverse DCT,
// the handling of the frame edge, the rounding of each half- and
// quarter-pel average, which frames a skipped VOP yields) this file does
// what ffmpeg does.
//
// Decoded: the Simple and Advanced Simple profiles' rectangular, progressive,
// 8-bit 4:2:0 tools. I-, P- and B-VOPs; MCBPC, CBPY, DQUANT; intra DC by
// the DC-size VLCs or, past intra_dc_vlc_thr, as a coefficient; the intra
// and inter TCOEF VLCs with the three escapes; AC/DC prediction with the
// zigzag and alternate scans; H.263 and MPEG quantisation with default or
// loaded matrices (MPEG's inter mismatch control); ffmpeg's simple inverse
// DCT, or for a stream that carries XviD's signature XviD's (ffmpeg's x86
// ff_xvid_idct_sse2, whose 16-bit saturating sums this file reproduces);
// 1MV and 4MV with the median predictor, f_code ranges, unrestricted
// MVs over the edge of the macroblock-aligned picture, half-pel luma and
// chroma prediction with vop_rounding_type; quarter-pel luma prediction
// (the 8-tap filter mirrored at the block's edge, 16x16 and 8x8) with
// ffmpeg's chroma vectors; B-VOPs' direct (with TRB/TRD from the time
// codes; 8x8 prediction in a quarter-pel stream), interpolated, backward
// and forward macroblocks, DBQUANT, and the macroblocks skipped where the
// co-located one was not coded; video packets after resync markers, header
// extension included; VOPs with vop_coded 0, which yield no frame; packed
// bitstreams (below); the one-byte units XviD's and DivX's codecs store for
// a frame they hold back, which ffmpeg skips where the stream is signed.
//
// Refused, with an error that names ROADMAP.md queue A9 (err code 2):
// interlaced VOLs, sprites and GMC (S-VOPs), data partitioning and
// reversible VLCs, the short video header (H.263), shapes other than
// rectangular, not_8_bit, newpred, scalability, reduced resolution, the
// complexity estimation header, and the streams for which ffmpeg applies
// an encoder's bug workarounds: XviD builds of 32 and below, and a bare
// XVID, XVIX, RMP4, ZMP4 or SIPP fourcc without a signature, which ffmpeg
// takes for XviD build 0; DivX before 5, DivX 5.01 build 20020416 and
// quarter-pel DivX streams (without XviD's signature beside DivX's: with
// it ffmpeg drops DivX's); old libavcodec builds; the XVIX and UMP4 tags.
//
// A decoder opened with headers_only reads each VOP only as far as
// vop_coded and decodes no macroblock: it gives the frames ffmpeg's decoder
// returns, in its order, without their pixels (data/mpeg4.py
// output_frames: the frame count and the timestamps), by the same rule as
// the full decode. Of the tools above it refuses only the short video
// header and the Studio and scalable layers, whose VOP headers it does not
// read. Both read a packed bitstream as ffmpeg does: with
// DivX's packed flag (user data "DivX...p") the second VOP of a unit, if
// it is an I- or B-VOP, is kept and decoded in place of the next unit; a
// unit of at most 19 bytes (a DivX N-VOP) takes it without the flag; any
// other second VOP is passed over. (ffmpeg looks for that VOP from where
// its decode of the first one stopped, and keeps it only if more than 7
// bytes follow; here it is looked for from the first VOP's start code.)
//
// C interface (ctypes, data/mpeg4.py):
//   void* m4v_open(const char* fourcc, int headers_only);
//   void  m4v_close(void* h);
//   int   m4v_send(void* h, const uint8_t* unit, long n, long long tag,
//                  int* ready, char* err, int err_cap);
//   int   m4v_flush(void* h, int* ready);
//   int   m4v_size(void* h, int* width, int* height);
//   int   m4v_receive(void* h, uint8_t* y, int y_pitch, uint8_t* u,
//                     uint8_t* v, int c_pitch, long long* tag,
//                     long long* props);
//   int   m4v_low_delay(void* h);
//   void  m4v_colour(void* h, int* matrix, int* full_range);
//   void  m4v_idct(int xvid, const int16_t* coefs, int* out);
// m4v_send decodes one access unit (any VOS, VO, VOL, GOV and user data
// headers, then one VOP) and sets *ready to the number of frames now ready
// for output (0 or 1), in the order ffmpeg outputs them: a B-VOP at once,
// an I- or P-VOP when the next one arrives (or at once in a low-delay
// stream). m4v_flush ends the stream: the last reference of a stream that
// is not low delay, or the last frame again where a low-delay stream ends
// with a VOP of vop_coded 0. m4v_receive copies the ready frame's Y, U and
// V planes (width x height, and ceil(width / 2) x ceil(height / 2)) into
// the caller's buffers (not with y null, as a headers_only decoder must
// call it) and gives back the tag of the unit it came from and that of the
// unit whose packet properties ffmpeg gives it: its own, but the last
// unit's for the frame m4v_flush returns after a VOP of vop_coded 0 (its
// skipped_last_frame). m4v_colour gives the matrix_coefficients (2 where
// none was sent) and the video_range of the last visual object header's
// video_signal_type. m4v_low_delay says whether the stream returns each
// VOP at once. m4v_idct gives the inverse DCT of 64 coefficients in raster
// order, XviD's or the simple one, before clipping. Calls return 0, or 1
// for a malformed stream and 2 for a refused tool, with the message in
// err.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{1, msg}; }
[[noreturn]] void refuse(const std::string& what) {
  throw Error{2, what + " is not decoded by auformer_torch's MPEG-4 part 2 "
                        "decoder; ROADMAP.md queue A9 (frame decoding) lists "
                        "it"};
}

// ---- bit reader --------------------------------------------------------

class Bits {
 public:
  Bits(const uint8_t* p, size_t n) : p_(p), n_(n), bits_(8 * n), pos_(0) {}
  uint32_t show(int k) const {  // k <= 32
    if (k == 0) return 0;
    size_t byte = pos_ >> 3;
    uint64_t v = 0;
    if (byte + 8 <= n_) {
      for (int i = 0; i < 8; ++i) v = v << 8 | p_[byte + i];
    } else {
      for (int i = 0; i < 8; ++i)
        v = v << 8 | (byte + i < n_ ? p_[byte + i] : 0);
    }
    v <<= pos_ & 7;
    return (uint32_t)(v >> (64 - k));
  }
  void skip(int k) { pos_ += k; }
  uint32_t get(int k) {
    if (pos_ + k > bits_) fail("a VOP runs past the end of its unit");
    uint32_t v = show(k);
    pos_ += k;
    return v;
  }
  int get1() { return (int)get(1); }
  int sget(int k) {  // two's complement
    int v = (int)get(k);
    return v >= (1 << (k - 1)) ? v - (1 << k) : v;
  }
  void marker(const char* where) {
    if (!get1()) fail(std::string("a marker bit is missing ") + where);
  }
  size_t pos() const { return pos_; }
  void seek(size_t pos) { pos_ = pos; }
  long left() const { return (long)bits_ - (long)pos_; }
  void align() { pos_ = (pos_ + 7) & ~(size_t)7; }
  void check() const {
    if (pos_ > bits_) fail("a VOP runs past the end of its unit");
  }

 private:
  const uint8_t* p_;
  size_t n_, bits_, pos_;
};

// ---- VLC tables (ISO/IEC 14496-2 Annex B; H.263 for MCBPC, CBPY, MVD) ---

struct Vlc {
  int maxlen = 0;
  std::vector<int16_t> sym;
  std::vector<uint8_t> len;
  // codes[i] = {code, length} of symbol i (length 0: no code)
  void build(const uint16_t (*codes)[2], int n) {
    maxlen = 0;
    for (int i = 0; i < n; ++i) maxlen = std::max<int>(maxlen, codes[i][1]);
    sym.assign((size_t)1 << maxlen, -1);
    len.assign((size_t)1 << maxlen, 0);
    for (int i = 0; i < n; ++i) {
      int l = codes[i][1];
      if (!l) continue;
      uint32_t first = (uint32_t)codes[i][0] << (maxlen - l);
      for (uint32_t k = 0; k < (1u << (maxlen - l)); ++k) {
        sym[first + k] = (int16_t)i;
        len[first + k] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t v = b.show(maxlen);
    if (!len[v]) fail(std::string("an invalid ") + what + " code");
    b.skip(len[v]);
    return sym[v];
  }
};

const uint16_t kIntraMcbpc[9][2] = {{1, 1}, {1, 3}, {2, 3}, {3, 3}, {1, 4},
                                    {1, 6}, {2, 6}, {3, 6}, {1, 9}};
// index: type * 4 + cbpc; types inter, intra, inter+q, intra+q, inter4v,
// stuffing (20)
const uint16_t kInterMcbpc[21][2] = {
    {1, 1}, {3, 4}, {2, 4}, {5, 6}, {3, 5}, {4, 8}, {3, 8},
    {3, 7}, {3, 3}, {7, 7}, {6, 7}, {5, 9}, {4, 6}, {4, 9},
    {3, 9}, {2, 9}, {2, 3}, {5, 7}, {4, 7}, {5, 8}, {1, 9}};
const uint16_t kCbpy[16][2] = {{3, 4}, {5, 5}, {4, 5}, {9, 4}, {3, 5}, {7, 4},
                               {2, 6}, {11, 4}, {2, 5}, {3, 6}, {5, 4},
                               {10, 4}, {4, 4}, {8, 4}, {6, 4}, {3, 2}};
const uint16_t kMvd[33][2] = {
    {1, 1},   {1, 2},   {1, 3},   {1, 4},   {3, 6},   {5, 7},   {4, 7},
    {3, 7},   {11, 9},  {10, 9},  {9, 9},   {17, 10}, {16, 10}, {15, 10},
    {14, 10}, {13, 10}, {12, 10}, {11, 10}, {10, 10}, {9, 10},  {8, 10},
    {7, 10},  {6, 10},  {5, 10},  {4, 10},  {7, 11},  {6, 11},  {5, 11},
    {4, 11},  {3, 11},  {2, 11},  {3, 12},  {2, 12}};
const uint16_t kDcLuma[13][2] = {{3, 3}, {3, 2}, {2, 2}, {2, 3}, {1, 3},
                                 {1, 4}, {1, 5}, {1, 6}, {1, 7}, {1, 8},
                                 {1, 9}, {1, 10}, {1, 11}};
const uint16_t kDcChroma[13][2] = {{3, 2}, {2, 2}, {1, 2}, {1, 3}, {1, 4},
                                   {1, 5}, {1, 6}, {1, 7}, {1, 8}, {1, 9},
                                   {1, 10}, {1, 11}, {1, 12}};
const uint16_t kBType[4][2] = {{1, 1}, {1, 2}, {1, 3}, {1, 4}};

// TCOEF: 102 (run, level, last) codes and the escape (Tables B-16, B-17)
const uint16_t kIntraTcoef[103][2] = {
    {0x2, 2},   {0x6, 3},   {0xf, 4},   {0xd, 5},   {0xc, 5},   {0x15, 6},
    {0x13, 6},  {0x12, 6},  {0x17, 7},  {0x1f, 8},  {0x1e, 8},  {0x1d, 8},
    {0x25, 9},  {0x24, 9},  {0x23, 9},  {0x21, 9},  {0x21, 10}, {0x20, 10},
    {0xf, 10},  {0xe, 10},  {0x7, 11},  {0x6, 11},  {0x20, 11}, {0x21, 11},
    {0x50, 12}, {0x51, 12}, {0x52, 12}, {0xe, 4},   {0x14, 6},  {0x16, 7},
    {0x1c, 8},  {0x20, 9},  {0x1f, 9},  {0xd, 10},  {0x22, 11}, {0x53, 12},
    {0x55, 12}, {0xb, 5},   {0x15, 7},  {0x1e, 9},  {0xc, 10},  {0x56, 12},
    {0x11, 6},  {0x1b, 8},  {0x1d, 9},  {0xb, 10},  {0x10, 6},  {0x22, 9},
    {0xa, 10},  {0xd, 6},   {0x1c, 9},  {0x8, 10},  {0x12, 7},  {0x1b, 9},
    {0x54, 12}, {0x14, 7},  {0x1a, 9},  {0x57, 12}, {0x19, 8},  {0x9, 10},
    {0x18, 8},  {0x23, 11}, {0x17, 8},  {0x19, 9},  {0x18, 9},  {0x7, 10},
    {0x58, 12}, {0x7, 4},   {0xc, 6},   {0x16, 8},  {0x17, 9},  {0x6, 10},
    {0x5, 11},  {0x4, 11},  {0x59, 12}, {0xf, 6},   {0x16, 9},  {0x5, 10},
    {0xe, 6},   {0x4, 10},  {0x11, 7},  {0x24, 11}, {0x10, 7},  {0x25, 11},
    {0x13, 7},  {0x5a, 12}, {0x15, 8},  {0x5b, 12}, {0x14, 8},  {0x13, 8},
    {0x1a, 8},  {0x15, 9},  {0x14, 9},  {0x13, 9},  {0x12, 9},  {0x11, 9},
    {0x26, 11}, {0x27, 11}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7}};
const int8_t kIntraLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21,
    22, 23, 24, 25, 26, 27, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 1, 2, 3, 4, 5, 1,
    2, 3, 4, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1,
    2, 3, 4, 5, 6, 7, 8, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1};
const int8_t kIntraRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5,
    5, 5, 6, 6, 6, 7, 7, 7, 8, 8, 9, 9, 10, 11, 12, 13, 14, 0, 0, 0, 0, 0, 0,
    0, 0, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 8, 9, 10, 11, 12, 13, 14,
    15, 16, 17, 18, 19, 20};
const uint16_t kInterTcoef[103][2] = {
    {0x2, 2},   {0xf, 4},   {0x15, 6},  {0x17, 7},  {0x1f, 8},  {0x25, 9},
    {0x24, 9},  {0x21, 10}, {0x20, 10}, {0x7, 11},  {0x6, 11},  {0x20, 11},
    {0x6, 3},   {0x14, 6},  {0x1e, 8},  {0xf, 10},  {0x21, 11}, {0x50, 12},
    {0xe, 4},   {0x1d, 8},  {0xe, 10},  {0x51, 12}, {0xd, 5},   {0x23, 9},
    {0xd, 10},  {0xc, 5},   {0x22, 9},  {0x52, 12}, {0xb, 5},   {0xc, 10},
    {0x53, 12}, {0x13, 6},  {0xb, 10},  {0x54, 12}, {0x12, 6},  {0xa, 10},
    {0x11, 6},  {0x9, 10},  {0x10, 6},  {0x8, 10},  {0x16, 7},  {0x55, 12},
    {0x15, 7},  {0x14, 7},  {0x1c, 8},  {0x1b, 8},  {0x21, 9},  {0x20, 9},
    {0x1f, 9},  {0x1e, 9},  {0x1d, 9},  {0x1c, 9},  {0x1b, 9},  {0x1a, 9},
    {0x22, 11}, {0x23, 11}, {0x56, 12}, {0x57, 12}, {0x7, 4},   {0x19, 9},
    {0x5, 11},  {0xf, 6},   {0x4, 11},  {0xe, 6},   {0xd, 6},   {0xc, 6},
    {0x13, 7},  {0x12, 7},  {0x11, 7},  {0x10, 7},  {0x1a, 8},  {0x19, 8},
    {0x18, 8},  {0x17, 8},  {0x16, 8},  {0x15, 8},  {0x14, 8},  {0x13, 8},
    {0x18, 9},  {0x17, 9},  {0x16, 9},  {0x15, 9},  {0x14, 9},  {0x13, 9},
    {0x12, 9},  {0x11, 9},  {0x7, 10},  {0x6, 10},  {0x5, 10},  {0x4, 10},
    {0x24, 11}, {0x25, 11}, {0x26, 11}, {0x27, 11}, {0x58, 12}, {0x59, 12},
    {0x5a, 12}, {0x5b, 12}, {0x5c, 12}, {0x5d, 12}, {0x5e, 12}, {0x5f, 12},
    {0x3, 7}};
const int8_t kInterLevel[102] = {
    1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 1, 2, 3, 4, 5, 6, 1, 2, 3, 4, 1, 2,
    3, 1, 2, 3, 1, 2, 3, 1, 2, 3, 1, 2, 1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 3, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1};
const int8_t kInterRun[102] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3,
    4, 4, 4, 5, 5, 5, 6, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 12, 13, 14, 15,
    16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 0, 0, 0, 1, 1, 2, 3, 4, 5, 6,
    7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25,
    26, 27, 28, 29, 30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40};

struct RunLevel {
  Vlc vlc;
  const int8_t* run;
  const int8_t* level;
  int last;  // first index of the last = 1 codes
  int max_level[2][64];
  int max_run[2][65];
  void init(const uint16_t (*codes)[2], const int8_t* r, const int8_t* l,
            int first_last) {
    vlc.build(codes, 103);
    run = r;
    level = l;
    last = first_last;
    std::memset(max_level, 0, sizeof max_level);
    std::memset(max_run, 0, sizeof max_run);
    for (int i = 0; i < 102; ++i) {
      int k = i >= last;
      max_level[k][r[i]] = std::max<int>(max_level[k][r[i]], l[i]);
      max_run[k][l[i]] = std::max<int>(max_run[k][l[i]], r[i]);
    }
  }
};

const uint8_t kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};
const uint8_t kAltHorizontal[64] = {
    0,  1,  2,  3,  8,  9,  16, 17, 10, 11, 4,  5,  6,  7,  15, 14,
    13, 12, 19, 18, 24, 25, 32, 33, 26, 27, 20, 21, 22, 23, 28, 29,
    30, 31, 34, 35, 40, 41, 48, 49, 42, 43, 36, 37, 38, 39, 44, 45,
    46, 47, 50, 51, 56, 57, 58, 59, 52, 53, 54, 55, 60, 61, 62, 63};
const uint8_t kAltVertical[64] = {
    0,  8,  16, 24, 1,  9,  2,  10, 17, 25, 32, 40, 48, 56, 57, 49,
    41, 33, 26, 18, 3,  11, 4,  12, 19, 27, 34, 42, 50, 58, 35, 43,
    51, 59, 20, 28, 5,  13, 6,  14, 21, 29, 36, 44, 52, 60, 37, 45,
    53, 61, 22, 30, 7,  15, 23, 31, 38, 46, 54, 62, 39, 47, 55, 63};
const uint8_t kDefaultIntraMatrix[64] = {
    8,  17, 18, 19, 21, 23, 25, 27, 17, 18, 19, 21, 23, 25, 27, 28,
    20, 21, 22, 23, 24, 26, 28, 30, 21, 22, 23, 24, 26, 28, 30, 32,
    22, 23, 24, 26, 28, 30, 32, 35, 23, 24, 26, 28, 30, 32, 35, 38,
    25, 26, 28, 30, 32, 35, 38, 41, 27, 28, 30, 32, 35, 38, 41, 45};
const uint8_t kDefaultInterMatrix[64] = {
    16, 17, 18, 19, 20, 21, 22, 23, 17, 18, 19, 20, 21, 22, 23, 24,
    18, 19, 20, 21, 22, 23, 24, 25, 19, 20, 21, 22, 23, 24, 26, 27,
    20, 21, 22, 23, 25, 26, 27, 28, 21, 22, 23, 24, 26, 27, 28, 30,
    22, 23, 24, 26, 27, 28, 30, 31, 23, 24, 25, 27, 28, 30, 31, 33};
const uint8_t kYDcScale[32] = {0,  8,  8,  8,  8,  10, 12, 14, 16, 17, 18,
                               19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                               30, 31, 32, 34, 36, 38, 40, 42, 44, 46};
const uint8_t kCDcScale[32] = {0,  8,  8,  8,  8,  9,  9,  10, 10, 11, 11,
                               12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17,
                               17, 18, 18, 19, 20, 21, 22, 23, 24, 25};
const uint8_t kDcThreshold[8] = {99, 13, 15, 17, 19, 21, 23, 0};

struct Tables {
  Vlc intra_mcbpc, inter_mcbpc, cbpy, mvd, dc_luma, dc_chroma, btype;
  RunLevel intra, inter;
  Tables() {
    intra_mcbpc.build(kIntraMcbpc, 9);
    inter_mcbpc.build(kInterMcbpc, 21);
    cbpy.build(kCbpy, 16);
    mvd.build(kMvd, 33);
    dc_luma.build(kDcLuma, 13);
    dc_chroma.build(kDcChroma, 13);
    btype.build(kBType, 4);
    intra.init(kIntraTcoef, kIntraRun, kIntraLevel, 67);
    inter.init(kInterTcoef, kInterRun, kInterLevel, 58);
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---- ffmpeg's simple inverse DCT (simple_idct_template.c, 8-bit) ---------

constexpr int W1 = 22725, W2 = 21407, W3 = 19266, W4 = 16383, W5 = 12873,
              W6 = 8867, W7 = 4520;
constexpr int ROW_SHIFT = 11, COL_SHIFT = 20;

inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

void idct_row(int16_t* row) {
  if (!(row[1] | row[2] | row[3] | row[4] | row[5] | row[6] | row[7])) {
    int16_t dc = (int16_t)(uint16_t)((unsigned)row[0] << 3);
    for (int i = 0; i < 8; ++i) row[i] = dc;
    return;
  }
  unsigned a0 = (unsigned)(W4 * row[0]) + (1u << (ROW_SHIFT - 1));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += (unsigned)(W2 * row[2]);
  a1 += (unsigned)(W6 * row[2]);
  a2 -= (unsigned)(W6 * row[2]);
  a3 -= (unsigned)(W2 * row[2]);
  unsigned b0 = (unsigned)(W1 * row[1]) + (unsigned)(W3 * row[3]);
  unsigned b1 = (unsigned)(W3 * row[1]) - (unsigned)(W7 * row[3]);
  unsigned b2 = (unsigned)(W5 * row[1]) - (unsigned)(W1 * row[3]);
  unsigned b3 = (unsigned)(W7 * row[1]) - (unsigned)(W5 * row[3]);
  if (row[4] | row[5] | row[6] | row[7]) {
    a0 += (unsigned)(W4 * row[4] + W6 * row[6]);
    a1 += (unsigned)(-W4 * row[4] - W2 * row[6]);
    a2 += (unsigned)(-W4 * row[4] + W2 * row[6]);
    a3 += (unsigned)(W4 * row[4] - W6 * row[6]);
    b0 += (unsigned)(W5 * row[5] + W7 * row[7]);
    b1 += (unsigned)(-W1 * row[5] - W5 * row[7]);
    b2 += (unsigned)(W7 * row[5] + W3 * row[7]);
    b3 += (unsigned)(W3 * row[5] - W1 * row[7]);
  }
  row[0] = (int16_t)((int)(a0 + b0) >> ROW_SHIFT);
  row[7] = (int16_t)((int)(a0 - b0) >> ROW_SHIFT);
  row[1] = (int16_t)((int)(a1 + b1) >> ROW_SHIFT);
  row[6] = (int16_t)((int)(a1 - b1) >> ROW_SHIFT);
  row[2] = (int16_t)((int)(a2 + b2) >> ROW_SHIFT);
  row[5] = (int16_t)((int)(a2 - b2) >> ROW_SHIFT);
  row[3] = (int16_t)((int)(a3 + b3) >> ROW_SHIFT);
  row[4] = (int16_t)((int)(a3 - b3) >> ROW_SHIFT);
}

// the column pass; out[k] is the k-th output row of this column
void idct_col(const int16_t* col, int out[8]) {
  unsigned a0 = (unsigned)(W4 * (col[0] + ((1 << (COL_SHIFT - 1)) / W4)));
  unsigned a1 = a0, a2 = a0, a3 = a0;
  a0 += (unsigned)(W2 * col[16]);
  a1 += (unsigned)(W6 * col[16]);
  a2 += (unsigned)(-W6 * col[16]);
  a3 += (unsigned)(-W2 * col[16]);
  unsigned b0 = (unsigned)(W1 * col[8]);
  unsigned b1 = (unsigned)(W3 * col[8]);
  unsigned b2 = (unsigned)(W5 * col[8]);
  unsigned b3 = (unsigned)(W7 * col[8]);
  b0 += (unsigned)(W3 * col[24]);
  b1 += (unsigned)(-W7 * col[24]);
  b2 += (unsigned)(-W1 * col[24]);
  b3 += (unsigned)(-W5 * col[24]);
  if (col[32]) {
    a0 += (unsigned)(W4 * col[32]);
    a1 += (unsigned)(-W4 * col[32]);
    a2 += (unsigned)(-W4 * col[32]);
    a3 += (unsigned)(W4 * col[32]);
  }
  if (col[40]) {
    b0 += (unsigned)(W5 * col[40]);
    b1 += (unsigned)(-W1 * col[40]);
    b2 += (unsigned)(W7 * col[40]);
    b3 += (unsigned)(W3 * col[40]);
  }
  if (col[48]) {
    a0 += (unsigned)(W6 * col[48]);
    a1 += (unsigned)(-W2 * col[48]);
    a2 += (unsigned)(W2 * col[48]);
    a3 += (unsigned)(-W6 * col[48]);
  }
  if (col[56]) {
    b0 += (unsigned)(W7 * col[56]);
    b1 += (unsigned)(-W5 * col[56]);
    b2 += (unsigned)(W3 * col[56]);
    b3 += (unsigned)(-W1 * col[56]);
  }
  out[0] = (int)(a0 + b0) >> COL_SHIFT;
  out[1] = (int)(a1 + b1) >> COL_SHIFT;
  out[2] = (int)(a2 + b2) >> COL_SHIFT;
  out[3] = (int)(a3 + b3) >> COL_SHIFT;
  out[4] = (int)(a3 - b3) >> COL_SHIFT;
  out[5] = (int)(a2 - b2) >> COL_SHIFT;
  out[6] = (int)(a1 - b1) >> COL_SHIFT;
  out[7] = (int)(a0 - b0) >> COL_SHIFT;
}

void simple_idct(int16_t* block, int out[64]) {  // out[8 * row + col]
  for (int i = 0; i < 8; ++i) idct_row(block + 8 * i);
  int col[8];
  for (int i = 0; i < 8; ++i) {
    idct_col(block + i, col);
    for (int k = 0; k < 8; ++k) out[8 * k + i] = col[k];
  }
}

// ---- XviD's inverse DCT (ffmpeg's xvididct.c, x86/xvididct.asm) ---------
//
// ffmpeg decodes a stream that carries XviD's signature with it. On x86
// (cv2's build) that is ff_xvid_idct_sse2: the rows by 32-bit multiply-adds
// with a rounder per row, packed to 16 bits with saturation; the columns
// in 16-bit lanes, each sum and difference saturating (paddsw, psubsw) and
// each product the high half of a 16x16-bit one (pmulhw, tan3 as tan3 - 1
// plus the input). It equals ff_xvid_idct (the C version) wherever no
// sum passes 16 bits, and differs where one does; both were held against
// libavcodec's own on random blocks through its AVDCT interface.

const int kXvidTab[4][7] = {{22725, 21407, 19266, 16384, 12873, 8867, 4520},
                            {31521, 29692, 26722, 22725, 17855, 12299, 6270},
                            {29692, 27969, 25172, 21407, 16819, 11585, 5906},
                            {26722, 25172, 22654, 19266, 15137, 10426, 5315}};
// the table and rounder of each row (rows 0 and 4 share a table, as do
// 1 and 7, 2 and 6, 3 and 5)
const int kXvidRowTab[8] = {0, 1, 2, 3, 0, 3, 2, 1};
const int kXvidRounder[8] = {65536, 3597, 2260, 1203, 0, 120, 512, 512};

inline int16_t sat16(int v) {
  return (int16_t)(v > 32767 ? 32767 : v < -32768 ? -32768 : v);
}
inline int16_t adds(int16_t a, int16_t b) { return sat16(a + b); }
inline int16_t subs(int16_t a, int16_t b) { return sat16(a - b); }
inline int16_t mulhi(int16_t a, int16_t b) { return (int16_t)((a * b) >> 16); }

void xvid_idct_row(int16_t* in, int row) {
  const int* t = kXvidTab[kXvidRowTab[row]];
  const uint32_t c1 = t[0], c2 = t[1], c3 = t[2], c4 = t[3], c5 = t[4],
                 c6 = t[5], c7 = t[6];
  const uint32_t x0 = in[0], x1 = in[1], x2 = in[2], x3 = in[3], x4 = in[4],
                 x5 = in[5], x6 = in[6], x7 = in[7];
  const uint32_t rnd = kXvidRounder[row];
  uint32_t a0 = c4 * x0 + c2 * x2 + c4 * x4 + c6 * x6 + rnd;
  uint32_t a1 = c4 * x0 + c6 * x2 - c4 * x4 - c2 * x6 + rnd;
  uint32_t a2 = c4 * x0 - c6 * x2 - c4 * x4 + c2 * x6 + rnd;
  uint32_t a3 = c4 * x0 - c2 * x2 + c4 * x4 - c6 * x6 + rnd;
  uint32_t b0 = c1 * x1 + c3 * x3 + c5 * x5 + c7 * x7;
  uint32_t b1 = c3 * x1 - c7 * x3 - c1 * x5 - c5 * x7;
  uint32_t b2 = c5 * x1 - c1 * x3 + c7 * x5 + c3 * x7;
  uint32_t b3 = c7 * x1 - c5 * x3 + c3 * x5 - c1 * x7;
  in[0] = sat16((int32_t)(a0 + b0) >> 11);
  in[1] = sat16((int32_t)(a1 + b1) >> 11);
  in[2] = sat16((int32_t)(a2 + b2) >> 11);
  in[3] = sat16((int32_t)(a3 + b3) >> 11);
  in[4] = sat16((int32_t)(a3 - b3) >> 11);
  in[5] = sat16((int32_t)(a2 - b2) >> 11);
  in[6] = sat16((int32_t)(a1 - b1) >> 11);
  in[7] = sat16((int32_t)(a0 - b0) >> 11);
}

void xvid_idct_col(const int16_t* in, int out[8]) {  // out[k]: row k
  const int16_t x0 = in[0], x1 = in[8], x2 = in[16], x3 = in[24],
                x4 = in[32], x5 = in[40], x6 = in[48], x7 = in[56];
  const int16_t tan1 = 0x32EC, tan2 = 0x6A0A, tan3m1 = (int16_t)0xAB0E,
                sqrt2 = 0x5A82;
  int16_t tm35 = subs(adds(mulhi(x3, tan3m1), x3), x5);
  int16_t tp35 = adds(adds(mulhi(x5, tan3m1), x5), x3);
  int16_t tp17 = adds(mulhi(x7, tan1), x1);
  int16_t tm17 = subs(mulhi(x1, tan1), x7);
  int16_t t1 = subs(tp17, tp35), b3 = subs(tm17, tm35);
  int16_t b0 = adds(tp35, tp17), t2 = adds(tm35, tm17);
  int16_t d = mulhi(subs(t1, t2), sqrt2), e = mulhi(adds(t2, t1), sqrt2);
  int16_t b1 = adds(e, e), b2 = adds(d, d);
  int16_t tp26 = adds(mulhi(x6, tan2), x2), tm26 = subs(mulhi(x2, tan2), x6);
  int16_t tm04 = subs(x0, x4), tp04 = adds(x4, x0);
  int16_t a0 = adds(tp26, tp04), a3 = subs(tp04, tp26);
  int16_t a1 = adds(tm04, tm26), a2 = subs(tm04, tm26);
  out[0] = adds(b0, a0) >> 6;
  out[7] = subs(a0, b0) >> 6;
  out[1] = adds(b1, a1) >> 6;
  out[6] = subs(a1, b1) >> 6;
  out[2] = adds(b2, a2) >> 6;
  out[5] = subs(a2, b2) >> 6;
  out[3] = adds(b3, a3) >> 6;
  out[4] = subs(a3, b3) >> 6;
}

void xvid_idct(int16_t* block, int out[64]) {
  for (int i = 0; i < 8; ++i) xvid_idct_row(block + 8 * i, i);
  int col[8];
  for (int i = 0; i < 8; ++i) {
    xvid_idct_col(block + i, col);
    for (int k = 0; k < 8; ++k) out[8 * k + i] = col[k];
  }
}

// idct_put and idct_add of the stream's inverse DCT (put_pixels_clamped,
// add_pixels_clamped)
void idct_put(int16_t* block, uint8_t* dst, int stride, bool xvid) {
  int out[64];
  (xvid ? xvid_idct : simple_idct)(block, out);
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < 8; ++i) dst[k * stride + i] = clip8(out[8 * k + i]);
}

void idct_add(int16_t* block, uint8_t* dst, int stride, bool xvid) {
  int out[64];
  (xvid ? xvid_idct : simple_idct)(block, out);
  for (int k = 0; k < 8; ++k)
    for (int i = 0; i < 8; ++i)
      dst[k * stride + i] = clip8(dst[k * stride + i] + out[8 * k + i]);
}

// ---- pictures ------------------------------------------------------------

enum MbKind : uint8_t { MB_INTRA = 0, MB_16X16 = 1, MB_8X8 = 2 };

struct Picture {
  std::vector<uint8_t> y, u, v;   // macroblock-aligned planes
  std::vector<int16_t> mv_base;   // motion_val: (2 mb_h + 1) x b8_stride x 2
  int16_t* mv = nullptr;          // block (0, 0) of mv_base
  std::vector<uint8_t> kind;      // MbKind per macroblock
  std::vector<uint8_t> skip;      // not_coded per macroblock (P-VOPs)
  long long tag = 0;
};

struct Vol {
  bool seen = false;
  int vo_type = 0, ver_id = 1;
  bool control = false, low_delay = false;
  int resolution = 1, time_bits = 1;
  int width = 0, height = 0;
  bool mpeg_quant = false, quarter_sample = false;
  uint8_t intra_matrix[64], inter_matrix[64];  // raster order
  bool resync_disable = true;
};

// half-pel prediction ops (ffmpeg's hpeldsp, C semantics)
enum Op { PUT = 0, PUT_NO_RND = 1, AVG = 2 };

class Decoder {
 public:
  Decoder(const char* fourcc, bool headers_only)
      : fourcc_(fourcc ? fourcc : ""), headers_only_(headers_only) {}

  int send(const uint8_t* data, size_t n, long long tag);  // frames ready
  int flush();
  bool size(int* w, int* h) const {
    if (!vol_.seen) return false;
    *w = vol_.width;
    *h = vol_.height;
    return true;
  }
  bool receive(uint8_t* y, int yp, uint8_t* u, uint8_t* v, int cp,
               long long* tag, long long* props);
  bool low_delay() const { return vol_.low_delay; }
  // the colour matrix and range the frames carry: the last visual object
  // header's video_signal_type, as ffmpeg keeps it
  void colour(int* matrix, int* full_range) const {
    *matrix = matrix_;
    *full_range = full_range_;
  }

 private:
  // stream state
  std::string fourcc_;
  bool headers_only_;
  int matrix_ = 2, full_range_ = 0;
  bool divx_packed_ = false;      // user data "DivX...p"
  std::vector<uint8_t> pending_;  // a packed unit's second VOP
  size_t vop_at_ = 0;             // start code of the unit's VOP
  Vol vol_;
  int mb_w_ = 0, mb_h_ = 0, mb_num_ = 0, b8_stride_ = 0, mb_stride_ = 0;
  int lavc_build_ = -1, xvid_build_ = -1, divx_version_ = -1,
      divx_build_ = -1;
  bool xvid_idct_ = false;  // XviD's inverse DCT in place of the simple one
  bool picture_seen_ = false;
  // frame store: refs_[0] last, refs_[1] next (ffmpeg's last_picture and
  // next_picture), plus the B-VOP picture
  Picture pics_[3];
  Picture* last_ = nullptr;
  Picture* next_ = nullptr;
  Picture* cur_ = nullptr;
  Picture* out_ = nullptr;     // the frame ready for output
  bool out_last_props_ = false;  // out_ has the last unit's properties
  long long last_tag_ = 0;        // the tag of the last unit sent
  bool decoded_ = false;       // the last unit's VOP was decoded
  bool skipped_last_ = false;  // the last VOP had vop_coded 0
  // time codes
  int time_base_ = 0, last_time_base_ = 0;
  long long time_ = 0, last_non_b_time_ = 0;
  int pp_time_ = 0, pb_time_ = 0;
  // VOP state
  int pict_type_ = 0;  // 0 I, 1 P, 2 B
  int qscale_ = 1, f_code_ = 1, b_code_ = 1, no_rounding_ = 0;
  int intra_dc_threshold_ = 99;
  int mb_x_ = 0, mb_y_ = 0, resync_mb_x_ = 0, resync_mb_y_ = 0;
  bool first_slice_line_ = true;
  // prediction arrays of the current VOP (ffmpeg's layout)
  std::vector<int16_t> dc_base_, ac_base_;
  int16_t* dc_[3] = {nullptr, nullptr, nullptr};
  int16_t* ac_[3] = {nullptr, nullptr, nullptr};  // 16 values per block
  std::vector<int8_t> qscale_table_;
  int last_mv_[2][2] = {{0, 0}, {0, 0}};  // B-VOP predictors [dir][xy]
  int16_t block_[6][64];
  int last_index_[6];
  bool ac_pred_ = false;
  int mv_[2][4][2];  // [dir][block][xy] of the current macroblock
  bool four_mv_[2] = {false, false};

  void parse_headers(const uint8_t* data, size_t n, long long tag);
  void vol_header(Bits& b);
  void user_data(const uint8_t* p, size_t n);
  void check_workarounds();
  void alloc(int width, int height);
  void vop(Bits& b, long long tag);
  void decode_vop_data(Bits& b);
  bool resync_here(Bits& b, int mb_index, bool b_skip);
  void clean_buffers();
  void set_qscale(int q) { qscale_ = std::min(31, std::max(1, q)); }
  int prefix_length() const {
    return pict_type_ == 0   ? 16
           : pict_type_ == 1 ? f_code_ + 15
                             : std::max(std::max(f_code_, b_code_), 2) + 15;
  }
  int decode_motion(Bits& b, int pred, int f_code);
  void pred_motion(int block, int* px, int* py);
  int16_t* mv_at(Picture* p, int block) {
    return p->mv + 2 * block_index(block);
  }
  int block_index(int n) const {  // luma blocks 0-3 of (mb_x_, mb_y_)
    return b8_stride_ * (2 * mb_y_ + (n >> 1)) + 2 * mb_x_ + (n & 1);
  }
  int16_t* dc_val(int n) {
    return n < 4 ? dc_[0] + block_index(n)
                 : dc_[n - 3] + mb_y_ * mb_stride_ + mb_x_;
  }
  int16_t* ac_val(int n) {
    return n < 4 ? ac_[0] + 16 * block_index(n)
                 : ac_[n - 3] + 16 * (mb_y_ * mb_stride_ + mb_x_);
  }
  int dc_wrap(int n) const { return n < 4 ? b8_stride_ : mb_stride_; }
  int pred_dc(int n, int level, int* dir);
  void pred_ac(int16_t* block, int n, int dir);
  void decode_block(Bits& b, int n, bool coded, bool intra,
                    bool use_intra_dc_vlc);
  void decode_mb(Bits& b);
  void clean_intra_entries();
  void reconstruct(bool intra);
  void motion(int dir, Op op);
  void chroma_4mv(Picture* ref, int sum_x, int sum_y, Op op);
  void qpel_block(uint8_t* dst, int stride, const uint8_t* ref, int rstride,
                  int ew, int eh, int sx, int sy, int n, int dxy, Op op);
  void mc_block(uint8_t* dst, int stride, const uint8_t* ref, int rstride,
                int ew, int eh, int sx, int sy, int w, int h, int dxy, Op op);
  void update_motion_val(bool intra, bool skipped);
};

// ---- headers -------------------------------------------------------------

void Decoder::user_data(const uint8_t* p, size_t n) {
  std::string s(reinterpret_cast<const char*>(p), std::min<size_t>(n, 255));
  s = s.substr(0, s.find('\0'));
  int ver = 0, ver2 = 0, ver3 = 0, build = 0;
  char last = 0;
  int e = std::sscanf(s.c_str(), "DivX%dBuild%d%c", &ver, &build, &last);
  if (e < 2) e = std::sscanf(s.c_str(), "DivX%db%d%c", &ver, &build, &last);
  if (e >= 2) {
    divx_version_ = ver;
    divx_build_ = build;
    divx_packed_ = e == 3 && last == 'p';
  }
  if (std::sscanf(s.c_str(), "FFmpe%*[^b]b%d", &build) == 1 ||
      std::sscanf(s.c_str(), "FFmpeg v%d.%d.%d / libavcodec build: %d", &ver,
                  &ver2, &ver3, &build) == 4) {
    lavc_build_ = build;
  } else if (std::sscanf(s.c_str(), "Lavc%d.%d.%d", &ver, &ver2, &ver3) ==
             3) {
    if (ver <= 0xFF && ver2 <= 0xFF && ver3 <= 0xFF)
      lavc_build_ = (ver << 16) + (ver2 << 8) + ver3;
  } else if (s == "ffmpeg") {
    lavc_build_ = 4600;
  }
  if (std::sscanf(s.c_str(), "XviD%d", &build) == 1) xvid_build_ = build;
}

void Decoder::check_workarounds() {
  // ff_mpeg4_workaround_bugs, which ffmpeg runs before each VOP: it keys
  // encoder bug workarounds and XviD's inverse DCT off these signatures.
  // The inverse DCT is reproduced; a stream that any workaround acts on is
  // refused.
  if (xvid_build_ == -1 && divx_version_ == -1 && lavc_build_ == -1) {
    static const char* xvid_tags[] = {"XVID", "XVIX", "RMP4", "ZMP4", "SIPP"};
    for (const char* t : xvid_tags)
      if (strncasecmp(fourcc_.c_str(), t, 4) == 0 && fourcc_.size() == 4)
        refuse("an MPEG-4 stream tagged " + fourcc_ +
               " without an encoder's signature (ffmpeg takes it for XviD "
               "build 0 and applies that build's bug workarounds)");
    if (strncasecmp(fourcc_.c_str(), "DIVX", 4) == 0 && vol_.vo_type == 0 &&
        !vol_.control)
      refuse("a DIVX-tagged stream that ffmpeg decodes as DivX 4");
  }
  if (xvid_build_ >= 0 && divx_version_ >= 0)
    divx_version_ = divx_build_ = -1;  // XviD's own DivX signature
  if (strncasecmp(fourcc_.c_str(), "XVIX", 4) == 0 ||
      strncasecmp(fourcc_.c_str(), "UMP4", 4) == 0)
    refuse("an MPEG-4 stream tagged " + fourcc_);
  if (xvid_build_ >= 0 && xvid_build_ <= 32)
    refuse("an MPEG-4 stream of XviD build " + std::to_string(xvid_build_) +
           " (ffmpeg applies its DC clipping, edge and quarter-pel chroma "
           "bug workarounds to builds of 32 and below)");
  // DivX: FF_BUG_DIRECT_BLOCKSIZE and FF_BUG_QPEL_CHROMA(2) act on
  // quarter-pel streams, FF_BUG_EDGE on DivX 4, the padding bug on one
  // build; FF_BUG_HPEL_CHROMA only on interlaced ones, refused above
  if (divx_version_ >= 0 &&
      (divx_version_ < 500 || vol_.quarter_sample ||
       (divx_version_ == 501 && divx_build_ == 20020416)))
    refuse("a DivX-written MPEG-4 stream that ffmpeg decodes with bug "
           "workarounds (DivX before 5, quarter-pel, or 5.01 build "
           "20020416)");
  if (lavc_build_ >= 0) {
    unsigned b = (unsigned)lavc_build_;
    bool iedge = (b & 0xFF) >= 100 && b > 3621476 && b < 3752552 &&
                 (b < 3752037 || b > 3752191);
    if (b <= 4712 || iedge)
      refuse("an MPEG-4 stream of a libavcodec build that ffmpeg decodes with "
             "bug workarounds");
  }
  xvid_idct_ = xvid_build_ >= 0;  // idct_algo auto becomes FF_IDCT_XVID
}

void Decoder::vol_header(Bits& b) {
  Vol v;
  v.seen = true;
  b.get1();                          // random_accessible_vol
  v.vo_type = (int)b.get(8);
  if (v.vo_type == 0x12 /* fine granularity scalable */ && !headers_only_)
    refuse("a fine granularity scalable VOL");
  if (b.get1()) {                    // is_object_layer_identifier
    v.ver_id = (int)b.get(4);
    b.get(3);                        // vo_priority
  }
  if (b.get(4) == 15) b.get(16);     // aspect ratio, extended PAR
  if ((v.control = b.get1())) {      // vol_control_parameters
    if (b.get(2) != 1 && !headers_only_)
      refuse("a chroma format other than 4:2:0");
    v.low_delay = b.get1();
    if (b.get1()) {                  // vbv_parameters
      b.get(15); b.marker("in the VBV parameters");
      b.get(15); b.marker("in the VBV parameters");
      b.get(15); b.marker("in the VBV parameters");
      b.get(3); b.get(11); b.marker("in the VBV parameters");
      b.get(15); b.marker("in the VBV parameters");
    }
  } else {
    // ffmpeg: the Simple and Advanced Simple object types are low delay
    v.low_delay = picture_seen_ ? vol_.low_delay
                                : (v.vo_type == 1 || v.vo_type == 17);
  }
  int shape = (int)b.get(2);
  if (shape != 0 && !headers_only_) refuse("a non-rectangular VOL shape");
  if (shape == 3 && v.ver_id != 1) b.get(4);  // video_object_layer_shape_ext
  b.marker("before vop_time_increment_resolution");
  v.resolution = (int)b.get(16);
  if (!v.resolution) fail("vop_time_increment_resolution 0");
  int bits = 0;
  while ((1 << bits) < v.resolution) ++bits;  // av_log2(res - 1) + 1
  v.time_bits = std::max(bits, 1);
  if (headers_only_) {  // the VOPs' times are all the output rule reads
    vol_ = v;
    return;
  }
  b.marker("after vop_time_increment_resolution");
  if (b.get1()) b.get(v.time_bits);  // fixed_vop_rate
  b.marker("before video_object_layer_width");
  v.width = (int)b.get(13);
  b.marker("before video_object_layer_height");
  v.height = (int)b.get(13);
  b.marker("after video_object_layer_height");
  if (v.width <= 0 || v.height <= 0) fail("a VOL of size 0");
  if (b.get1()) refuse("an interlaced VOL");
  b.get1();                                   // obmc_disable
  int sprite = (int)(v.ver_id == 1 ? b.get1() : b.get(2));
  if (sprite) refuse("sprites and global motion compensation (S-VOPs)");
  if (b.get1()) refuse("not_8_bit (a quantiser precision or bit depth "
                       "other than 5 and 8)");
  if ((v.mpeg_quant = b.get1())) {            // quant_type
    std::memcpy(v.intra_matrix, kDefaultIntraMatrix, 64);
    std::memcpy(v.inter_matrix, kDefaultInterMatrix, 64);
    for (uint8_t* m : {v.intra_matrix, v.inter_matrix}) {
      if (!b.get1()) continue;                // load_*_quant_mat
      int last = 0, i = 0;
      for (; i < 64; ++i) {
        int x = (int)b.get(8);
        if (!x) break;
        last = x;
        m[kZigzag[i]] = (uint8_t)x;
      }
      if (i == 0) fail("a loaded quantiser matrix that starts with 0");
      for (; i < 64; ++i) m[kZigzag[i]] = (uint8_t)last;
    }
  }
  v.quarter_sample = v.ver_id != 1 && b.get1();
  if (!b.get1()) refuse("the complexity estimation header");
  v.resync_disable = b.get1();
  if (b.get1()) refuse("data partitioning and reversible VLCs");
  if (v.ver_id != 1) {
    if (b.get1()) refuse("newpred");
    if (b.get1()) refuse("reduced resolution VOPs");
  }
  if (b.get1()) refuse("scalability");
  b.check();
  if (vol_.seen && (v.width != vol_.width || v.height != vol_.height))
    refuse("a change of frame size within a stream");
  vol_ = v;
  if (mb_w_ == 0) alloc(v.width, v.height);
}

void Decoder::alloc(int width, int height) {
  mb_w_ = (width + 15) / 16;
  mb_h_ = (height + 15) / 16;
  mb_num_ = mb_w_ * mb_h_;
  b8_stride_ = 2 * mb_w_ + 1;
  mb_stride_ = mb_w_ + 1;
  for (Picture& p : pics_) {
    p.y.assign((size_t)mb_w_ * 16 * mb_h_ * 16, 0);
    p.u.assign((size_t)mb_w_ * 8 * mb_h_ * 8, 0);
    p.v.assign(p.u.size(), 0);
    p.mv_base.assign((size_t)(2 * mb_h_ + 2) * b8_stride_ * 2 + 2, 0);
    p.mv = p.mv_base.data() + 2 * (b8_stride_ + 1);
    p.kind.assign(mb_num_, MB_INTRA);
    p.skip.assign(mb_num_, 0);
  }
  size_t y_size = (size_t)b8_stride_ * (2 * mb_h_ + 1);
  size_t c_size = (size_t)mb_stride_ * (mb_h_ + 1);
  dc_base_.assign(y_size + 2 * c_size + 2 * b8_stride_, 1024);
  ac_base_.assign(16 * (y_size + 2 * c_size + 2 * b8_stride_), 0);
  dc_[0] = dc_base_.data() + b8_stride_ + 1;
  dc_[1] = dc_base_.data() + y_size + mb_stride_ + 1;
  dc_[2] = dc_[1] + c_size;
  ac_[0] = ac_base_.data() + 16 * (b8_stride_ + 1);
  ac_[1] = ac_base_.data() + 16 * (y_size + mb_stride_ + 1);
  ac_[2] = ac_[1] + 16 * c_size;
  qscale_table_.assign(mb_num_, 0);
}

int Decoder::send(const uint8_t* data, size_t n, long long tag) {
  out_ = nullptr;
  out_last_props_ = decoded_ = false;
  last_tag_ = tag;
  // a packed bitstream as ffmpeg reads it (ff_h263_decode_frame,
  // ff_mpeg4_frame_end; header comment)
  if (divx_packed_ && !pending_.empty()) {
    for (size_t i = 0; i + 3 < n; ++i) {
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
        if (data[i + 3] == 0xB0) pending_.clear();  // a new sequence
        break;
      }
    }
  }
  size_t from = 0;
  if (!pending_.empty() && (divx_packed_ || n <= 19 /* MAX_NVOP_SIZE */)) {
    std::vector<uint8_t> kept;
    kept.swap(pending_);
    parse_headers(kept.data(), kept.size(), tag);
  } else {
    pending_.clear();
    parse_headers(data, n, tag);
    from = vop_at_ + 4;
  }
  if (divx_packed_ && decoded_ && n > from + 7) {
    for (size_t i = from; i + 4 < n; ++i) {
      if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1 &&
          data[i + 3] == 0xB6) {
        if (!(data[i + 4] & 0x40)) pending_.assign(data + i, data + n);
        break;
      }
    }
  }
  return out_ ? 1 : 0;
}

void Decoder::parse_headers(const uint8_t* data, size_t n, long long tag) {
  // start codes 00 00 01 xx; each header runs to the next one
  std::vector<size_t> starts;
  for (size_t i = 0; i + 3 < n; ++i) {
    if (data[i] == 0 && data[i + 1] == 0 && data[i + 2] == 1) {
      starts.push_back(i + 3);
      i += 2;
    }
  }
  vop_at_ = n;
  if (starts.empty() && n > 0) {
    if (n >= 3 && data[0] == 0 && data[1] == 0 && (data[2] & 0xFC) == 0x80)
      refuse("the short video header (H.263)");
    // a one-byte unit of a signed stream: the frame XviD's and DivX's
    // codecs store where they hold one back, which ffmpeg skips
    if (n == 1 && (xvid_build_ >= 0 || divx_version_ >= 0 ||
                   strncasecmp(fourcc_.c_str(), "QMP4", 4) == 0))
      return;
    fail("an access unit without a start code");
  }
  for (size_t k = 0; k < starts.size(); ++k) {
    size_t s = starts[k];
    size_t e = k + 1 < starts.size() ? starts[k + 1] - 3 : n;
    uint8_t code = data[s];
    const uint8_t* body = data + s + 1;
    size_t len = e > s + 1 ? e - s - 1 : 0;
    if (code >= 0x20 && code <= 0x2F) {
      Bits b(body, len);
      vol_header(b);
    } else if (code == 0xB2) {
      user_data(body, len);
    } else if (code == 0xB6) {
      // ffmpeg decodes the unit's first VOP and reads nothing after it
      if (!vol_.seen) fail("a VOP before any VOL header");
      if (!headers_only_) check_workarounds();
      vop_at_ = s - 3;
      Bits b(body, len);
      vop(b, tag);
      return;
    } else if (code == 0xB5) {
      // visual object (6.2.2): video_signal_type's range and colour
      // description, which ffmpeg gives the frames and cv2 converts by
      Bits b(body, len);
      if (b.left() >= 8) {
        if (b.get1()) b.get(7);  // visual_object_verid, priority
        int type = (int)b.get(4);
        if ((type == 1 || type == 2) && b.left() >= 1 && b.get1() && b.left() >= 5) {
          b.get(3);  // video_format
          full_range_ = b.get1();
          if (b.get1() && b.left() >= 24) {  // colour_description
            b.get(16);                      // primaries, transfer
            matrix_ = (int)b.get(8);
          }
        }
      }
    } else if (code <= 0x1F || code == 0xB0 || code == 0xB1 || code == 0xB3) {
      // VO, VOS, end of VOS, GOV: nothing the pixels need
      if (code == 0xB0 && len >= 1 && body[0] >= 0xE1 && body[0] <= 0xE8)
        refuse("the Simple Studio profile");
    } else if (code >= 0x40 && code <= 0x5F) {
      refuse("FGS/scalable layers");
    } else if ((code & 0xFC) == 0x80 || (code >= 0x80 && code <= 0x83)) {
      refuse("the short video header (H.263)");
    }
  }
}

// ---- VOPs ----------------------------------------------------------------

void Decoder::vop(Bits& b, long long tag) {
  int type = (int)b.get(2);
  if (type == 3 && !headers_only_) refuse("sprite (S-) VOPs");
  if (type == 2 && vol_.low_delay && !vol_.control) vol_.low_delay = false;
  int time_incr = 0;
  while (b.get1()) {
    if (++time_incr > 1000) fail("a runaway modulo_time_base");
  }
  b.marker("before vop_time_increment");
  int time_increment = (int)b.get(vol_.time_bits);
  if (type != 2) {
    last_time_base_ = time_base_;
    time_base_ += time_incr;
    time_ = (long long)time_base_ * vol_.resolution + time_increment;
    pp_time_ = (int)(time_ - last_non_b_time_);
    last_non_b_time_ = time_;
  } else {
    time_ = (long long)(last_time_base_ + time_incr) * vol_.resolution +
            time_increment;
    pb_time_ = (int)(pp_time_ - (last_non_b_time_ - time_));
  }
  b.marker("before vop_coded");
  pict_type_ = type;
  if (!b.get1()) {  // vop_coded 0: ffmpeg returns no frame for it
    skipped_last_ = true;
    return;
  }
  skipped_last_ = false;
  if (type == 2 &&
      (pp_time_ <= pb_time_ || pp_time_ <= pp_time_ - pb_time_ ||
       pp_time_ <= 0))
    return;  // ffmpeg skips a B-VOP whose times do not fit
  if (!headers_only_) {
    no_rounding_ = type == 1 ? b.get1() : 0;
    intra_dc_threshold_ = kDcThreshold[b.get(3)];
    int q = (int)b.get(5);
    if (!q) fail("vop_quant 0");
    qscale_ = q;
    if (type != 0) {
      f_code_ = (int)b.get(3);
      if (!f_code_) fail("vop_fcode_forward 0");
    }
    if (type == 2) {
      b_code_ = (int)b.get(3);
      if (!b_code_) fail("vop_fcode_backward 0");
    }
    b.check();
  }
  // references (ffmpeg's last_picture / next_picture), rotated before an
  // I- or P-VOP is decoded
  if (type == 2) {
    if (!last_ || !next_) return;  // a B-VOP without both references
    cur_ = &pics_[2];
  } else {
    cur_ = &pics_[0] == next_ ? &pics_[1] : &pics_[0];
    last_ = next_;
    next_ = cur_;
    if (type == 1 && !last_ && !headers_only_)
      fail("a P-VOP without a reference VOP");
  }
  cur_->tag = tag;
  picture_seen_ = decoded_ = true;
  if (!headers_only_) decode_vop_data(b);
  // output: a B-VOP or a low-delay stream's VOP at once, else the
  // previous reference
  if (type == 2 || vol_.low_delay)
    out_ = cur_;
  else if (last_)
    out_ = last_;
}

int Decoder::flush() {
  out_ = nullptr;
  if (!vol_.low_delay && next_) {
    out_ = next_;
    next_ = nullptr;
  } else if (skipped_last_ && cur_ && picture_seen_) {
    out_ = cur_;  // a stream that ends with vop_coded 0: the last again
    cur_ = nullptr;
  }
  out_last_props_ = skipped_last_;
  skipped_last_ = false;
  return out_ ? 1 : 0;
}

bool Decoder::receive(uint8_t* y, int yp, uint8_t* u, uint8_t* v, int cp,
                      long long* tag, long long* props) {
  if (!out_) return false;
  *tag = out_->tag;
  *props = out_last_props_ ? last_tag_ : out_->tag;
  if (y) {
    int w = vol_.width, h = vol_.height, cw = (w + 1) / 2, ch = (h + 1) / 2;
    int ys = mb_w_ * 16, cs = mb_w_ * 8;
    for (int r = 0; r < h; ++r)
      std::memcpy(y + (size_t)r * yp, out_->y.data() + (size_t)r * ys, w);
    for (int r = 0; r < ch; ++r) {
      std::memcpy(u + (size_t)r * cp, out_->u.data() + (size_t)r * cs, cw);
      std::memcpy(v + (size_t)r * cp, out_->v.data() + (size_t)r * cs, cw);
    }
  }
  out_ = nullptr;
  return true;
}

void Decoder::clean_buffers() {
  // ff_mpeg4_clean_buffers: the AC predictors above and left of a new
  // video packet, and the B-VOP MV predictors
  long l_xy = (long)(2 * mb_y_ - 1) * b8_stride_ + 2 * mb_x_ - 1;
  long c_xy = (long)(mb_y_ - 1) * mb_stride_ + mb_x_ - 1;
  std::memset(ac_[0] + 16 * l_xy, 0,
              sizeof(int16_t) * 16 * (2 * b8_stride_ + 1));
  std::memset(ac_[1] + 16 * c_xy, 0, sizeof(int16_t) * 16 * (mb_stride_ + 1));
  std::memset(ac_[2] + 16 * c_xy, 0, sizeof(int16_t) * 16 * (mb_stride_ + 1));
  std::memset(last_mv_, 0, sizeof last_mv_);
}

// Whether a video packet header starts here (before macroblock mb_index):
// stuffing to the byte boundary ('0' then '1's), the resync marker, and a
// macroblock_number; consumes the header when it names mb_index. A marker
// that names a later macroblock is left for later when this one is a
// B-VOP macroblock that takes no bits (b_skip).
bool Decoder::resync_here(Bits& b, int mb_index, bool b_skip) {
  size_t pos = b.pos();
  int stuff = 8 - (int)(pos & 7);
  uint32_t want = (1u << (stuff - 1)) - 1;  // 0 then stuff-1 ones
  if (b.left() < stuff + 17 || b.show(stuff) != want) return false;
  b.skip(stuff);
  int zeros = 0;
  while (zeros < 32 && b.left() > 0 && !b.show(1)) {
    b.skip(1);
    ++zeros;
  }
  if (zeros != prefix_length() || b.left() <= 0) {
    b.seek(pos);
    return false;
  }
  b.skip(1);
  int bits = 0;
  while ((1 << bits) < mb_num_) ++bits;
  int mb = (int)b.get(std::max(bits, 1));
  if (mb != mb_index) {
    if (mb > mb_index && b_skip) {
      b.seek(pos);
      return false;
    }
    fail("a video packet that does not start at the next macroblock");
  }
  int q = (int)b.get(5);
  if (q) qscale_ = q;
  if (b.get1()) {  // header_extension_code: read and ignored, as ffmpeg does
    while (b.get1()) {
    }
    b.marker("in a video packet header");
    b.get(vol_.time_bits);
    b.marker("in a video packet header");
    b.get(2);  // vop_coding_type
    b.get(3);  // intra_dc_vlc_thr
    if (pict_type_ != 0) b.get(3);
    if (pict_type_ == 2) b.get(3);
  }
  return true;
}

void Decoder::decode_vop_data(Bits& b) {
  std::fill(cur_->kind.begin(), cur_->kind.end(), MB_INTRA);
  std::fill(cur_->skip.begin(), cur_->skip.end(), 0);
  mb_x_ = mb_y_ = 0;
  resync_mb_x_ = resync_mb_y_ = 0;
  first_slice_line_ = true;
  clean_buffers();
  for (int mb = 0; mb < mb_num_; ++mb) {
    mb_x_ = mb % mb_w_;
    mb_y_ = mb / mb_w_;
    bool b_skip = pict_type_ == 2 && next_->skip[mb];
    if (mb > 0 && resync_here(b, mb, b_skip)) {
      resync_mb_x_ = mb_x_;
      resync_mb_y_ = mb_y_;
      first_slice_line_ = true;
      clean_buffers();
    }
    if (resync_mb_x_ == mb_x_ && resync_mb_y_ + 1 == mb_y_)
      first_slice_line_ = false;
    decode_mb(b);
  }
  b.check();
}

// ---- motion vectors ------------------------------------------------------

int Decoder::decode_motion(Bits& b, int pred, int f_code) {
  int code = tables().mvd.read(b, "motion vector");
  if (code == 0) return pred;
  int sign = b.get1();
  int shift = f_code - 1;
  int val = code;
  if (shift) {
    val = (val - 1) << shift;
    val |= (int)b.get(shift);
    val++;
  }
  if (sign) val = -val;
  val += pred;
  int bits = 5 + f_code;  // sign_extend(val, 5 + f_code)
  val = (int)((unsigned)val << (32 - bits)) >> (32 - bits);
  return val;
}

static inline int mid_pred(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

void Decoder::pred_motion(int block, int* px, int* py) {
  // ff_h263_pred_motion
  static const int off[4] = {2, 1, 1, -1};
  int wrap = b8_stride_;
  int16_t* mv = mv_at(cur_, block);
  int16_t* A = mv - 2;
  if (first_slice_line_ && block < 3) {
    if (block == 0) {
      if (mb_x_ == resync_mb_x_) {
        *px = *py = 0;
      } else if (mb_x_ + 1 == resync_mb_x_) {
        int16_t* C = mv + 2 * (off[block] - wrap);
        if (mb_x_ == 0) {
          *px = C[0];
          *py = C[1];
        } else {
          *px = mid_pred(A[0], 0, C[0]);
          *py = mid_pred(A[1], 0, C[1]);
        }
      } else {
        *px = A[0];
        *py = A[1];
      }
    } else if (block == 1) {
      if (mb_x_ + 1 == resync_mb_x_) {
        int16_t* C = mv + 2 * (off[block] - wrap);
        *px = mid_pred(A[0], 0, C[0]);
        *py = mid_pred(A[1], 0, C[1]);
      } else {
        *px = A[0];
        *py = A[1];
      }
    } else {
      int16_t* B = mv - 2 * wrap;
      int16_t* C = mv + 2 * (off[block] - wrap);
      if (mb_x_ == resync_mb_x_) A[0] = A[1] = 0;
      *px = mid_pred(A[0], B[0], C[0]);
      *py = mid_pred(A[1], B[1], C[1]);
    }
  } else {
    int16_t* B = mv - 2 * wrap;
    int16_t* C = mv + 2 * (off[block] - wrap);
    *px = mid_pred(A[0], B[0], C[0]);
    *py = mid_pred(A[1], B[1], C[1]);
  }
}

void Decoder::update_motion_val(bool intra, bool skipped) {
  // ff_h263_update_motion_val (I- and P-VOPs)
  int mb = mb_y_ * mb_w_ + mb_x_;
  cur_->skip[mb] = skipped;
  if (!four_mv_[0]) {
    int x = intra ? 0 : mv_[0][0][0], y = intra ? 0 : mv_[0][0][1];
    for (int n = 0; n < 4; ++n) {
      int16_t* m = mv_at(cur_, n);
      m[0] = (int16_t)x;
      m[1] = (int16_t)y;
    }
  }
}

// ---- intra prediction ----------------------------------------------------

int Decoder::pred_dc(int n, int level, int* dir) {
  // ff_mpeg4_pred_dc
  int scale = n < 4 ? kYDcScale[qscale_] : kCDcScale[qscale_];
  int wrap = dc_wrap(n);
  int16_t* dc = dc_val(n);
  int a = dc[-1], b = dc[-1 - wrap], c = dc[-wrap];
  if (first_slice_line_ && n != 3) {
    if (n != 2) b = c = 1024;
    if (n != 1 && mb_x_ == resync_mb_x_) b = a = 1024;
  }
  if (mb_x_ == resync_mb_x_ && mb_y_ == resync_mb_y_ + 1) {
    if (n == 0 || n == 4 || n == 5) b = 1024;
  }
  int pred;
  if (std::abs(a - b) < std::abs(b - c)) {
    pred = c;
    *dir = 1;
  } else {
    pred = a;
    *dir = 0;
  }
  pred = (pred + (scale >> 1)) / scale;
  level += pred;
  int ret = level;
  level *= scale;
  if (level & ~2047) level = level < 0 ? 0 : 2047;
  dc[0] = (int16_t)level;
  return ret;
}

void Decoder::pred_ac(int16_t* block, int n, int dir) {
  // ff_mpeg4_pred_ac
  int16_t* ac = ac_val(n);
  int16_t* ac1 = ac;
  if (ac_pred_) {
    if (dir == 0) {
      int xy = mb_y_ * mb_w_ + mb_x_ - 1;
      ac -= 16;
      if (mb_x_ == 0 || qscale_ == qscale_table_[xy] || n == 1 || n == 3) {
        for (int i = 1; i < 8; ++i) block[i << 3] += ac[i];
      } else {
        int q = qscale_table_[xy];
        for (int i = 1; i < 8; ++i) {
          int a = ac[i] * q;
          block[i << 3] += (a >= 0 ? a + (qscale_ >> 1) : a - (qscale_ >> 1)) /
                           qscale_;
        }
      }
    } else {
      int xy = (mb_y_ - 1) * mb_w_ + mb_x_;
      ac -= 16 * dc_wrap(n);
      if (mb_y_ == 0 || qscale_ == qscale_table_[xy] || n == 2 || n == 3) {
        for (int i = 1; i < 8; ++i) block[i] += ac[i + 8];
      } else {
        int q = qscale_table_[xy];
        for (int i = 1; i < 8; ++i) {
          int a = ac[i + 8] * q;
          block[i] += (a >= 0 ? a + (qscale_ >> 1) : a - (qscale_ >> 1)) /
                      qscale_;
        }
      }
    }
  }
  for (int i = 1; i < 8; ++i) ac1[i] = block[i << 3];
  for (int i = 1; i < 8; ++i) ac1[8 + i] = block[i];
}

void Decoder::clean_intra_entries() {
  int xy = block_index(0), wrap = b8_stride_;
  dc_[0][xy] = dc_[0][xy + 1] = dc_[0][xy + wrap] = dc_[0][xy + 1 + wrap] =
      1024;
  std::memset(ac_[0] + 16 * xy, 0, 32 * sizeof(int16_t));
  std::memset(ac_[0] + 16 * (xy + wrap), 0, 32 * sizeof(int16_t));
  int c = mb_y_ * mb_stride_ + mb_x_;
  dc_[1][c] = dc_[2][c] = 1024;
  std::memset(ac_[1] + 16 * c, 0, 16 * sizeof(int16_t));
  std::memset(ac_[2] + 16 * c, 0, 16 * sizeof(int16_t));
}

// ---- blocks --------------------------------------------------------------

void Decoder::decode_block(Bits& b, int n, bool coded, bool intra,
                           bool use_intra_dc_vlc) {
  // mpeg4_decode_block
  const Tables& t = tables();
  int16_t* block = block_[n];
  int dc_pred_dir = 0;
  int i, qmul, qadd;
  const uint8_t* scan;
  const RunLevel* rl;
  if (intra) {
    if (use_intra_dc_vlc) {
      int code = (n < 4 ? t.dc_luma : t.dc_chroma).read(b, "DC size");
      int level = 0;
      if (code) {
        level = (int)b.get(code);
        if (!(level >> (code - 1))) level -= (1 << code) - 1;
        if (code > 8) b.marker("after a DC coefficient");
      }
      block[0] = (int16_t)pred_dc(n, level, &dc_pred_dir);
      i = 0;
    } else {
      i = -1;
      pred_dc(n, 0, &dc_pred_dir);
    }
    rl = &t.intra;
    scan = ac_pred_ ? (dc_pred_dir == 0 ? kAltVertical : kAltHorizontal)
                    : kZigzag;
    qmul = 1;
    qadd = 0;
    if (!coded) goto not_coded;
  } else {
    i = -1;
    if (!coded) {
      last_index_[n] = -1;
      return;
    }
    rl = &t.inter;
    scan = kZigzag;
    if (vol_.mpeg_quant) {
      qmul = 1;
      qadd = 0;
    } else {
      qmul = qscale_ << 1;
      qadd = (qscale_ - 1) | 1;
    }
  }
  for (;;) {
    int code = rl->vlc.read(b, "TCOEF");
    int run, level, last;
    if (code == 102) {  // escape
      if (b.show(1)) {
        if (b.show(2) == 3) {  // third escape: fixed length
          b.skip(2);
          last = b.get1();
          run = (int)b.get(6);
          b.marker("in a third escape");
          level = b.sget(12);
          b.marker("in a third escape");
          level = level > 0 ? level * qmul + qadd : level * qmul - qadd;
          if ((unsigned)(level + 2048) > 4095) level = level < 0 ? -2048 : 2047;
          i += run + 1;
        } else {  // second escape: run offset
          b.skip(2);
          int c2 = rl->vlc.read(b, "TCOEF");
          if (c2 == 102) fail("an escape inside a second escape");
          last = c2 >= rl->last;
          run = rl->run[c2] + rl->max_run[last][rl->level[c2]] + 1;
          level = rl->level[c2] * qmul + qadd;
          if (b.get1()) level = -level;
          i += run + 1;
        }
      } else {  // first escape: level offset
        b.skip(1);
        int c1 = rl->vlc.read(b, "TCOEF");
        if (c1 == 102) fail("an escape inside a first escape");
        last = c1 >= rl->last;
        run = rl->run[c1];
        level = (rl->level[c1] + rl->max_level[last][run]) * qmul + qadd;
        if (b.get1()) level = -level;
        i += run + 1;
      }
    } else {
      last = code >= rl->last;
      run = rl->run[code];
      level = rl->level[code] * qmul + qadd;
      if (b.get1()) level = -level;
      i += run + 1;
    }
    if (i > 63) fail("a block of more than 64 coefficients");
    block[scan[i]] = (int16_t)level;
    if (last) break;
  }
not_coded:
  if (intra) {
    if (!use_intra_dc_vlc) {
      block[0] = (int16_t)pred_dc(n, block[0], &dc_pred_dir);
      if (i < 0) i = 0;
    }
    pred_ac(block, n, dc_pred_dir);
    if (ac_pred_) i = 63;
  }
  last_index_[n] = i;
}

// ---- macroblocks ---------------------------------------------------------

void Decoder::decode_mb(Bits& b) {
  // mpeg4_decode_mb
  const Tables& t = tables();
  static const int quant_tab[4] = {-1, -2, 1, 2};
  int mb = mb_y_ * mb_w_ + mb_x_;
  std::memset(block_, 0, sizeof block_);
  four_mv_[0] = four_mv_[1] = false;
  int cbpc, cbpy, cbp;
  bool intra = false;
  if (pict_type_ == 1) {
    do {
      if (b.get1()) {  // not_coded
        mv_[0][0][0] = mv_[0][0][1] = 0;
        for (int k = 0; k < 6; ++k) last_index_[k] = -1;
        cur_->kind[mb] = MB_16X16;
        qscale_table_[mb] = (int8_t)qscale_;
        update_motion_val(false, true);
        reconstruct(false);
        return;
      }
      cbpc = t.inter_mcbpc.read(b, "MCBPC");
    } while (cbpc == 20);
    bool dquant = cbpc & 8;
    intra = cbpc & 4;
    if (!intra) {
      cbpy = t.cbpy.read(b, "CBPY") ^ 0x0F;
      cbp = (cbpc & 3) | (cbpy << 2);
      if (dquant) set_qscale(qscale_ + quant_tab[b.get(2)]);
      if (!(cbpc & 16)) {
        cur_->kind[mb] = MB_16X16;
        int px, py;
        pred_motion(0, &px, &py);
        mv_[0][0][0] = decode_motion(b, px, f_code_);
        mv_[0][0][1] = decode_motion(b, py, f_code_);
      } else {
        cur_->kind[mb] = MB_8X8;
        four_mv_[0] = true;
        for (int k = 0; k < 4; ++k) {
          int px, py;
          pred_motion(k, &px, &py);
          int16_t* m = mv_at(cur_, k);
          mv_[0][k][0] = decode_motion(b, px, f_code_);
          mv_[0][k][1] = decode_motion(b, py, f_code_);
          m[0] = (int16_t)mv_[0][k][0];
          m[1] = (int16_t)mv_[0][k][1];
        }
      }
      qscale_table_[mb] = (int8_t)qscale_;
      for (int k = 0; k < 6; ++k) {
        decode_block(b, k, cbp & 32, false, false);
        cbp += cbp;
      }
      update_motion_val(false, false);
      reconstruct(false);
      return;
    }
    // an intra macroblock in a P-VOP: fall through with cbpc and dquant
    ac_pred_ = b.get1();
    cbpy = t.cbpy.read(b, "CBPY");
    cbp = (cbpc & 3) | (cbpy << 2);
    bool use_dc_vlc = qscale_ < intra_dc_threshold_;
    if (dquant) set_qscale(qscale_ + quant_tab[b.get(2)]);
    cur_->kind[mb] = MB_INTRA;
    qscale_table_[mb] = (int8_t)qscale_;
    for (int k = 0; k < 6; ++k) {
      decode_block(b, k, cbp & 32, true, use_dc_vlc);
      cbp += cbp;
    }
    update_motion_val(true, false);
    reconstruct(true);
    return;
  }
  if (pict_type_ == 2) {
    if (mb_x_ == 0) std::memset(last_mv_, 0, sizeof last_mv_);
    qscale_table_[mb] = (int8_t)qscale_;
    if (next_->skip[mb]) {  // skipped in the future reference: skip here
      for (int k = 0; k < 6; ++k) last_index_[k] = -1;
      for (int d = 0; d < 2; ++d)
        for (int k = 0; k < 4; ++k) mv_[d][k][0] = mv_[d][k][1] = 0;
      motion(0, PUT);
      return;
    }
    int modb1 = b.get1(), type;  // 0 direct, 1 interpolate, 2 back, 3 fwd
    cbp = 0;
    int mx = 0, my = 0;
    if (modb1) {
      type = 0;
    } else {
      int modb2 = b.get1();
      type = t.btype.read(b, "MB_TYPE");
      if (!modb2) cbp = (int)b.get(6);
      if (type != 0 && cbp && b.get1()) set_qscale(qscale_ + b.get1() * 4 - 2);
    }
    qscale_table_[mb] = (int8_t)qscale_;
    bool fwd = false, bwd = false;
    if (type != 0) {
      if (type == 1 || type == 3) {
        fwd = true;
        mx = decode_motion(b, last_mv_[0][0], f_code_);
        my = decode_motion(b, last_mv_[0][1], f_code_);
        last_mv_[0][0] = mv_[0][0][0] = mx;
        last_mv_[0][1] = mv_[0][0][1] = my;
      }
      if (type == 1 || type == 2) {
        bwd = true;
        mx = decode_motion(b, last_mv_[1][0], b_code_);
        my = decode_motion(b, last_mv_[1][1], b_code_);
        last_mv_[1][0] = mv_[1][0][0] = mx;
        last_mv_[1][1] = mv_[1][0][1] = my;
      }
    } else {
      if (!modb1) {
        mx = decode_motion(b, 0, 1);
        my = decode_motion(b, 0, 1);
      }
      fwd = bwd = true;
      // ff_mpeg4_set_direct_mv
      int pp = (uint16_t)pp_time_, pb = (uint16_t)pb_time_;
      bool eight = next_->kind[mb] == MB_8X8;
      for (int k = 0; k < (eight ? 4 : 1); ++k) {
        int16_t* p = mv_at(next_, k);
        for (int c = 0; c < 2; ++c) {
          int pv = p[c], d = c ? my : mx;
          int f = pv * pb / pp + d;
          mv_[0][k][c] = f;
          mv_[1][k][c] = d ? f - pv : pv * (pb - pp) / pp;
        }
      }
      // a quarter-pel stream predicts even a 16x16 co-located macroblock's
      // direct vectors as four 8x8 blocks (without FF_BUG_DIRECT_BLOCKSIZE)
      if (!eight && vol_.quarter_sample)
        for (int d = 0; d < 2; ++d)
          for (int k = 1; k < 4; ++k)
            for (int c = 0; c < 2; ++c) mv_[d][k][c] = mv_[d][0][c];
      four_mv_[0] = four_mv_[1] = eight || vol_.quarter_sample;
    }
    for (int k = 0; k < 6; ++k) {
      decode_block(b, k, cbp & 32, false, false);
      cbp += cbp;
    }
    if (fwd) motion(0, PUT);
    if (bwd) motion(1, fwd ? AVG : PUT);
    reconstruct(false);
    return;
  }
  // I-VOP
  do {
    cbpc = t.intra_mcbpc.read(b, "MCBPC");
  } while (cbpc == 8);
  bool dquant = cbpc & 4;
  ac_pred_ = b.get1();
  cbpy = t.cbpy.read(b, "CBPY");
  cbp = (cbpc & 3) | (cbpy << 2);
  bool use_dc_vlc = qscale_ < intra_dc_threshold_;
  if (dquant) set_qscale(qscale_ + quant_tab[b.get(2)]);
  cur_->kind[mb] = MB_INTRA;
  qscale_table_[mb] = (int8_t)qscale_;
  for (int k = 0; k < 6; ++k) {
    decode_block(b, k, cbp & 32, true, use_dc_vlc);
    cbp += cbp;
  }
  update_motion_val(true, false);
  reconstruct(true);
}

// ---- reconstruction ------------------------------------------------------

static void dequant_h263_intra(int16_t* block, int n, int qscale) {
  // dct_unquantize_h263_intra_c (raster order: all nonzero coefficients)
  int qmul = qscale << 1, qadd = (qscale - 1) | 1;
  block[0] = (int16_t)(block[0] * (n < 4 ? kYDcScale[qscale] : kCDcScale[qscale]));
  for (int i = 1; i < 64; ++i) {
    int level = block[i];
    if (level)
      block[i] = (int16_t)(level < 0 ? level * qmul - qadd : level * qmul + qadd);
  }
}

// MPEG dequantisation as ffmpeg's x86 dct_unquantize_mpeg2_{intra,inter}
// (no AV_CODEC_FLAG_BITEXACT) computes it: 16-bit products (pmullw), an
// arithmetic shift for intra and a logical one for inter, where the C
// reference works in int; the two agree until a product passes 16 bits.
static void dequant_mpeg_intra(int16_t* block, int n, int qscale,
                               const uint8_t* matrix) {
  int q = qscale << 1;
  block[0] = (int16_t)(block[0] * (n < 4 ? kYDcScale[qscale] : kCDcScale[qscale]));
  for (int i = 1; i < 64; ++i) {
    int level = block[i];
    if (level) {
      uint16_t a = (uint16_t)std::abs(level);
      uint16_t qm = (uint16_t)(q * matrix[i]);
      int16_t v = (int16_t)(uint16_t)(a * qm) >> 4;
      block[i] = (int16_t)(level < 0 ? -v : v);
    }
  }
}

static void dequant_mpeg_inter(int16_t* block, int qscale,
                               const uint8_t* matrix) {
  // with MPEG's mismatch control: the sum's parity toggles block[63]
  int q = qscale << 1, sum = -1;
  for (int i = 0; i < 64; ++i) {
    int level = block[i];
    if (level) {
      uint16_t a = (uint16_t)std::abs(level);
      uint16_t qm = (uint16_t)(q * matrix[i]);
      uint16_t v = (uint16_t)((uint16_t)(2 * a * qm) + qm) >> 5;
      level = level < 0 ? -(int)v : (int)v;
      block[i] = (int16_t)level;
      sum += level;
    }
  }
  block[63] ^= sum & 1;
}

void Decoder::reconstruct(bool intra) {
  int ys = mb_w_ * 16, cs = mb_w_ * 8;
  uint8_t* dy = cur_->y.data() + (size_t)mb_y_ * 16 * ys + mb_x_ * 16;
  uint8_t* du = cur_->u.data() + (size_t)mb_y_ * 8 * cs + mb_x_ * 8;
  uint8_t* dv = cur_->v.data() + (size_t)mb_y_ * 8 * cs + mb_x_ * 8;
  auto dst = [&](int n) -> uint8_t* {
    return n < 4 ? dy + (n >> 1) * 8 * ys + (n & 1) * 8 : n == 4 ? du : dv;
  };
  if (!intra) {
    if (pict_type_ == 1) {
      motion(0, no_rounding_ ? PUT_NO_RND : PUT);
    }
    for (int n = 0; n < 6; ++n) {
      if (last_index_[n] < 0) continue;
      if (vol_.mpeg_quant) dequant_mpeg_inter(block_[n], qscale_, vol_.inter_matrix);
      idct_add(block_[n], dst(n), n < 4 ? ys : cs, xvid_idct_);
    }
    clean_intra_entries();
  } else {
    for (int n = 0; n < 6; ++n) {
      if (vol_.mpeg_quant)
        dequant_mpeg_intra(block_[n], n, qscale_, vol_.intra_matrix);
      else
        dequant_h263_intra(block_[n], n, qscale_);
      idct_put(block_[n], dst(n), n < 4 ? ys : cs, xvid_idct_);
    }
  }
}

void Decoder::mc_block(uint8_t* dst, int stride, const uint8_t* ref,
                       int rstride, int ew, int eh, int sx, int sy, int w,
                       int h, int dxy, Op op) {
  // the (w + 1) x (h + 1) window at (sx, sy), coordinates clamped to the
  // edge (ffmpeg's emulated_edge_mc), then the half-pel average
  uint8_t win[17 * 17];
  int ww = w + 1, wh = h + 1;
  if (sx >= 0 && sy >= 0 && sx + ww <= ew && sy + wh <= eh) {
    for (int r = 0; r < wh; ++r)
      std::memcpy(win + r * ww, ref + (size_t)(sy + r) * rstride + sx, ww);
  } else {
    for (int r = 0; r < wh; ++r) {
      int yy = std::min(std::max(sy + r, 0), eh - 1);
      const uint8_t* row = ref + (size_t)yy * rstride;
      for (int c = 0; c < ww; ++c)
        win[r * ww + c] = row[std::min(std::max(sx + c, 0), ew - 1)];
    }
  }
  for (int r = 0; r < h; ++r) {
    const uint8_t* a = win + r * ww;
    const uint8_t* b2 = a + ww;
    uint8_t* d = dst + (size_t)r * stride;
    for (int c = 0; c < w; ++c) {
      int v;
      switch (dxy) {
        case 0: v = a[c]; break;
        // ffmpeg's x86 put_no_rnd_pixels8_{x2,y2} (hpeldsp.asm, taken
        // without AV_CODEC_FLAG_BITEXACT) take pavgb of the left pixel, or
        // of the odd rows, less one with unsigned saturation: the exact
        // (a + b) >> 1 but where that pixel is 0. The 16-wide ones are
        // exact. (Both held against cv2 on frames with black regions.)
        case 1:
          if (op != PUT_NO_RND)
            v = (a[c] + a[c + 1] + 1) >> 1;
          else if (w == 16)
            v = (a[c] + a[c + 1]) >> 1;
          else
            v = (std::max(a[c] - 1, 0) + a[c + 1] + 1) >> 1;
          break;
        case 2:
          if (op != PUT_NO_RND)
            v = (a[c] + b2[c] + 1) >> 1;
          else if (w == 16)
            v = (a[c] + b2[c]) >> 1;
          else if (r & 1)
            v = (std::max(a[c] - 1, 0) + b2[c] + 1) >> 1;
          else
            v = (a[c] + std::max(b2[c] - 1, 0) + 1) >> 1;
          break;
        default:
          v = op == PUT_NO_RND
                  ? (a[c] + a[c + 1] + b2[c] + b2[c + 1] + 1) >> 2
                  : (a[c] + a[c + 1] + b2[c] + b2[c + 1] + 2) >> 2;
      }
      d[c] = op == AVG ? (uint8_t)((d[c] + v + 1) >> 1) : (uint8_t)v;
    }
  }
}

// MPEG-4's 8-tap half-sample filter at output sample c of a line of n + 1
// samples (n = 8 or 16) a step apart, the taps past either end mirrored
// back into it, as mpeg4_qpel{8,16}_{h,v}_lowpass compute it (qpeldsp.c);
// rnd 0 rounds halves down (the put_no_rnd ops)
static inline int qpel_tap(const uint8_t* s, int step, int n, int c,
                           int rnd) {
  auto at = [&](int i) {
    i = i < 0 ? -1 - i : i > n ? 2 * n + 1 - i : i;
    return (int)s[i * step];
  };
  int v = 20 * (at(c) + at(c + 1)) - 6 * (at(c - 1) + at(c + 2)) +
          3 * (at(c - 2) + at(c + 3)) - (at(c - 3) + at(c + 4));
  return clip8((v + 15 + rnd) >> 5);
}

void Decoder::qpel_block(uint8_t* dst, int stride, const uint8_t* ref,
                         int rstride, int ew, int eh, int sx, int sy, int n,
                         int dxy, Op op) {
  // ffmpeg's {put,put_no_rnd,avg}_qpel{16,8}_mcXY_c on the (n + 1) x
  // (n + 1) window at (sx, sy), coordinates clamped to the edge
  // (emulated_edge_mc): the horizontal filter, averaged with the full
  // sample left or right of it at a quarter x, then the vertical one
  // over its n + 1 rows, averaged with the row above or below at a
  // quarter y. The steps between round as the op does (put_no_rnd: down);
  // avg averages the prediction into dst with rounding.
  uint8_t win[17 * 17], hh[17 * 16], pred[16 * 16];
  const int w1 = n + 1;
  if (sx >= 0 && sy >= 0 && sx + w1 <= ew && sy + w1 <= eh) {
    for (int r = 0; r < w1; ++r)
      std::memcpy(win + r * w1, ref + (size_t)(sy + r) * rstride + sx, w1);
  } else {
    for (int r = 0; r < w1; ++r) {
      int yy = std::min(std::max(sy + r, 0), eh - 1);
      const uint8_t* row = ref + (size_t)yy * rstride;
      for (int c = 0; c < w1; ++c)
        win[r * w1 + c] = row[std::min(std::max(sx + c, 0), ew - 1)];
    }
  }
  const int x = dxy & 3, y = dxy >> 2, rnd = op != PUT_NO_RND;
  auto avg2 = [rnd](int a, int b) { return (a + b + rnd) >> 1; };
  // the horizontal stage of row r, column c
  auto horizontal = [&](int r, int c) -> int {
    const uint8_t* row = win + r * w1;
    if (x == 0) return row[c];
    int h = qpel_tap(row, 1, n, c, rnd);
    return x == 2 ? h : avg2(row[c + (x == 3)], h);
  };
  if (y == 0) {
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) pred[r * n + c] = (uint8_t)horizontal(r, c);
  } else {
    for (int r = 0; r < w1; ++r)
      for (int c = 0; c < n; ++c) hh[r * n + c] = (uint8_t)horizontal(r, c);
    for (int r = 0; r < n; ++r)
      for (int c = 0; c < n; ++c) {
        int v = qpel_tap(hh + c, n, n, r, rnd);
        pred[r * n + c] =
            (uint8_t)(y == 2 ? v : avg2(hh[(r + (y == 3)) * n + c], v));
      }
  }
  for (int r = 0; r < n; ++r) {
    uint8_t* d = dst + (size_t)r * stride;
    for (int c = 0; c < n; ++c)
      d[c] = op == AVG ? (uint8_t)((d[c] + pred[r * n + c] + 1) >> 1)
                       : pred[r * n + c];
  }
}

void Decoder::chroma_4mv(Picture* ref, int sum_x, int sum_y, Op op) {
  // chroma_4mv_motion: one chroma vector from the sum of the four luma
  // ones (in half-pels), with H.263's rounding (ff_h263_round_chroma)
  static const uint8_t round_tab[16] = {0, 0, 0, 1, 1, 1, 1, 1,
                                        1, 1, 1, 1, 1, 1, 2, 2};
  int cs = mb_w_ * 8, ew = mb_w_ * 8, eh = mb_h_ * 8;
  int mx = round_tab[sum_x & 0xf] + ((sum_x >> 3) & ~1);
  int my = round_tab[sum_y & 0xf] + ((sum_y >> 3) & ~1);
  int dxy = ((my & 1) << 1) | (mx & 1);
  mx >>= 1;
  my >>= 1;
  int sx = mb_x_ * 8 + mx, sy = mb_y_ * 8 + my;
  sx = std::min(std::max(sx, -8), vol_.width >> 1);
  if (sx == (vol_.width >> 1)) dxy &= ~1;
  sy = std::min(std::max(sy, -8), vol_.height >> 1);
  if (sy == (vol_.height >> 1)) dxy &= ~2;
  size_t at = (size_t)mb_y_ * 8 * cs + mb_x_ * 8;
  mc_block(cur_->u.data() + at, cs, ref->u.data(), cs, ew, eh, sx, sy, 8, 8,
           dxy, op);
  mc_block(cur_->v.data() + at, cs, ref->v.data(), cs, ew, eh, sx, sy, 8, 8,
           dxy, op);
}

void Decoder::motion(int dir, Op op) {
  // ff_mpv_motion for MV_TYPE_16X16 (mpeg_motion, or qpel_motion in a
  // quarter-pel stream) and MV_TYPE_8X8 (hpel_motion or the quarter-pel
  // blocks, and chroma_4mv_motion)
  Picture* ref = dir == 0 ? last_ : next_;
  int ys = mb_w_ * 16, cs = mb_w_ * 8;
  int ew = mb_w_ * 16, eh = mb_h_ * 16;  // h_edge_pos, v_edge_pos
  uint8_t* dy = cur_->y.data() + (size_t)mb_y_ * 16 * ys + mb_x_ * 16;
  uint8_t* du = cur_->u.data() + (size_t)mb_y_ * 8 * cs + mb_x_ * 8;
  uint8_t* dv = cur_->v.data() + (size_t)mb_y_ * 8 * cs + mb_x_ * 8;
  const bool qpel = vol_.quarter_sample;
  if (!four_mv_[dir]) {
    int mx = mv_[dir][0][0], my = mv_[dir][0][1];
    int uvdxy, ux, uy;
    if (qpel) {
      int dxy = ((my & 3) << 2) | (mx & 3);
      qpel_block(dy, ys, ref->y.data(), ys, ew, eh, mb_x_ * 16 + (mx >> 2),
                 mb_y_ * 16 + (my >> 2), 16, dxy, op);
      // qpel_motion's chroma vector: halved toward zero, then to a
      // half-pel with the odd quarter kept
      int cx = mx / 2, cy = my / 2;
      cx = (cx >> 1) | (cx & 1);
      cy = (cy >> 1) | (cy & 1);
      uvdxy = (cx & 1) | ((cy & 1) << 1);
      ux = mb_x_ * 8 + (cx >> 1);
      uy = mb_y_ * 8 + (cy >> 1);
    } else {
      int dxy = ((my & 1) << 1) | (mx & 1);
      int sx = mb_x_ * 16 + (mx >> 1), sy = mb_y_ * 16 + (my >> 1);
      mc_block(dy, ys, ref->y.data(), ys, ew, eh, sx, sy, 16, 16, dxy, op);
      uvdxy = dxy | (my & 2) | ((mx & 2) >> 1);
      ux = sx >> 1;
      uy = sy >> 1;
    }
    mc_block(du, cs, ref->u.data(), cs, ew >> 1, eh >> 1, ux, uy, 8, 8, uvdxy,
             op);
    mc_block(dv, cs, ref->v.data(), cs, ew >> 1, eh >> 1, ux, uy, 8, 8, uvdxy,
             op);
    return;
  }
  int sum_x = 0, sum_y = 0;
  for (int k = 0; k < 4; ++k) {
    int mx = mv_[dir][k][0], my = mv_[dir][k][1];
    int shift = qpel ? 2 : 1, frac = qpel ? 3 : 1;
    int sx = mb_x_ * 16 + (k & 1) * 8 + (mx >> shift);
    int sy = mb_y_ * 16 + (k >> 1) * 8 + (my >> shift);
    int fx = mx & frac, fy = my & frac;
    sx = std::min(std::max(sx, -16), vol_.width);
    if (sx == vol_.width) fx = 0;
    sy = std::min(std::max(sy, -16), vol_.height);
    if (sy == vol_.height) fy = 0;
    uint8_t* d = dy + (k >> 1) * 8 * ys + (k & 1) * 8;
    if (qpel) {
      qpel_block(d, ys, ref->y.data(), ys, ew, eh, sx, sy, 8, fy << 2 | fx,
                 op);
      sum_x += mx / 2;  // to half-pels, toward zero
      sum_y += my / 2;
    } else {
      mc_block(d, ys, ref->y.data(), ys, ew, eh, sx, sy, 8, 8, fy << 1 | fx,
               op);
      sum_x += mx;
      sum_y += my;
    }
  }
  chroma_4mv(ref, sum_x, sum_y, op);
}

int fill_err(const Error& e, char* err, int cap) {
  if (err && cap > 0) std::snprintf(err, cap, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

void* m4v_open(const char* fourcc, int headers_only) {
  try {
    tables();
    return new Decoder(fourcc, headers_only != 0);
  } catch (...) {
    return nullptr;
  }
}

void m4v_close(void* h) { delete static_cast<Decoder*>(h); }

int m4v_send(void* h, const uint8_t* unit, long n, long long tag, int* ready,
             char* err, int err_cap) {
  try {
    *ready = static_cast<Decoder*>(h)->send(unit, (size_t)n, tag);
    return 0;
  } catch (const Error& e) {
    *ready = 0;
    return fill_err(e, err, err_cap);
  } catch (const std::exception& e) {
    *ready = 0;
    return fill_err(Error{1, e.what()}, err, err_cap);
  }
}

int m4v_flush(void* h, int* ready) {
  *ready = static_cast<Decoder*>(h)->flush();
  return 0;
}

int m4v_size(void* h, int* width, int* height) {
  return static_cast<Decoder*>(h)->size(width, height) ? 0 : 1;
}

int m4v_receive(void* h, uint8_t* y, int y_pitch, uint8_t* u, uint8_t* v,
                int c_pitch, long long* tag, long long* props) {
  return static_cast<Decoder*>(h)->receive(y, y_pitch, u, v, c_pitch, tag,
                                           props)
             ? 0
             : 1;
}

int m4v_low_delay(void* h) { return static_cast<Decoder*>(h)->low_delay(); }

void m4v_colour(void* h, int* matrix, int* full_range) {
  static_cast<Decoder*>(h)->colour(matrix, full_range);
}

void m4v_idct(int xvid, const int16_t* coefs, int* out) {
  int16_t block[64];
  std::memcpy(block, coefs, sizeof block);
  (xvid ? xvid_idct : simple_idct)(block, out);
}

}  // extern "C"
