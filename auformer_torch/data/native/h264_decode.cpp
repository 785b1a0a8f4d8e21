// H.264 (ITU-T H.264 | ISO/IEC 14496-10) video decoder: the port's own, for
// the frames that the JAX package reads through cv2, whose FFMPEG capture
// decodes them with ffmpeg's "h264" decoder. H.264 defines its decoding
// process exactly (the inverse transforms, the interpolation, the weighted
// prediction, the deblocking filter), so a conforming decoder's planes are
// ffmpeg's bit for bit; this file follows the standard's clauses, named
// beside each stage, and ffmpeg's choices only where the standard leaves
// them to the decoder (the order and timing of the output).
//
// Decoded: progressive, 8-bit, 4:2:0 streams with CAVLC entropy coding and
// flat scaling: the Baseline profile without FMO and ASO, the Main profile
// with entropy_coding_mode_flag 0, the High profile with CAVLC. That is SPS
// and PPS (with the VUI down to matrix_coefficients and the bitstream
// restriction), several slices per picture, I, P and B slices; I_NxN with
// the 4x4 and 8x8 transforms, I_16x16 and I_PCM; P and B partitions down to
// 4x4, P_Skip, B_Skip and the direct modes (spatial and temporal, under
// direct_8x8_inference); constrained intra prediction; quarter-pel luma and
// eighth-pel chroma motion compensation; explicit and implicit weighted
// prediction; reference list initialisation and modification (short and
// long term), the sliding window and memory management operations 1-6; the
// picture order count of types 0 and 2; the deblocking filter with its
// slice-level controls; the SPS's cropping.
//
// Refused, with an error that names ROADMAP.md queue A9 (err code 2): CABAC
// (entropy_coding_mode_flag 1), scaling matrices in the SPS or PPS, field
// pictures and MBAFF (frame_mbs_only_flag 0), slice groups (FMO), SP and SI
// slices, chroma_format_idc other than 1, bit depths above 8,
// qpprime_y_zero_transform_bypass, redundant pictures, data partitioning,
// arbitrary slice order, a gap in frame_num, picture order count type 1, a
// decode that does not begin with an IDR picture. A stream that does not
// decode raises too (err code 1): no macroblock is concealed.
//
// C interface (ctypes, data/h264.py):
//   void* h264_open(void);
//   void  h264_close(void* h);
//   int   h264_send(void* h, const uint8_t* unit, long n, long long tag,
//                   int* ready, char* err, int err_cap);
//   int   h264_flush(void* h, int* ready, char* err, int err_cap);
//   int   h264_size(void* h, int* width, int* height, int* matrix,
//                   int* full_range);
//   int   h264_receive(void* h, uint8_t* y, int y_pitch, uint8_t* u,
//                      uint8_t* v, int c_pitch, long long* tag);
// h264_send decodes one access unit (Annex B: start codes, any SPS and PPS
// in band, the slices of one picture) and sets *ready to the number of
// frames now ready for output. Frames leave as ffmpeg's decoder lets them
// leave: once more decoded pictures wait than the SPS's
// max_num_reorder_frames (else the level's DPB size), each picture decoded releases the waiting one of smallest
// picture order count that comes before the next IDR picture or memory
// management operation 5. h264_flush ends the stream and releases the rest
// in the same way. h264_size gives the next ready frame's cropped size, the
// matrix_coefficients of its SPS's VUI (2, unspecified, where the VUI does
// not give one) and its video_full_range_flag; h264_receive
// copies its Y, U and V planes (width x height, and ceil(width / 2) x
// ceil(height / 2)) into the caller's buffers and gives back the tag of the
// unit it came from. Calls return 0, or 1 for a malformed stream and 2 for
// a refused tool, with the message in err.

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{1, msg}; }
[[noreturn]] void refuse(const std::string& what) {
  throw Error{2, what + " is not decoded by auformer_torch's H.264 decoder; "
                        "ROADMAP.md queue A9 (frame decoding) lists it"};
}

inline int clip3(int lo, int hi, int v) { return v < lo ? lo : (v > hi ? hi : v); }
inline uint8_t clip1(int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); }
inline int median(int a, int b, int c) {
  return std::max(std::min(a, b), std::min(std::max(a, b), c));
}

// ---- bit reader over an RBSP (7.2: more_rbsp_data, Exp-Golomb 9.1) ------

class Bits {
 public:
  Bits() = default;
  // data: the RBSP with 8 bytes of zero padding after its n bytes
  void reset(const uint8_t* data, size_t n) {
    p_ = data;
    pos_ = 0;
    // the rbsp_stop_one_bit: the last 1 bit of the last nonzero byte
    size_t k = n;
    while (k > 0 && p_[k - 1] == 0) --k;
    if (k == 0) {
      end_ = 0;
    } else {
      int b = 0;
      while (!((p_[k - 1] >> b) & 1)) ++b;
      end_ = 8 * (k - 1) + (7 - b);
    }
    size_ = 8 * n;
  }
  uint32_t show(int k) const {  // 1 <= k <= 32
    size_t byte = pos_ >> 3;
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) v = v << 8 | p_[byte + i];
    v <<= pos_ & 7;
    return (uint32_t)(v >> (64 - k));
  }
  void skip(int k) { pos_ += k; }
  uint32_t u(int k) {
    if (k == 0) return 0;
    if (pos_ + k > size_) fail("a syntax element runs past the end of its NAL unit");
    uint32_t v = show(k);
    pos_ += k;
    return v;
  }
  int u1() { return (int)u(1); }
  uint32_t ue() {
    if (pos_ >= size_) fail("a syntax element runs past the end of its NAL unit");
    uint32_t w = show(32);
    if (w == 0) fail("an Exp-Golomb code of more than 32 bits");
    int zeros = __builtin_clz(w);
    if (zeros >= 16) {
      pos_ += zeros;
      return u(zeros + 1) - 1;
    }
    pos_ += 2 * zeros + 1;
    if (pos_ > size_) fail("a syntax element runs past the end of its NAL unit");
    return (w >> (31 - 2 * zeros)) - 1;
  }
  int se() {
    uint32_t k = ue();
    return (k & 1) ? (int)((k + 1) >> 1) : -(int)(k >> 1);
  }
  int te(int range) {  // 9.1.2: range is the largest value
    if (range > 1) return (int)ue();
    return !u1();
  }
  bool more_rbsp_data() const { return pos_ < end_; }
  bool aligned() const { return (pos_ & 7) == 0; }
  void check() const {
    if (pos_ > size_) fail("a syntax element runs past the end of its NAL unit");
  }

 private:
  const uint8_t* p_ = nullptr;
  size_t pos_ = 0, end_ = 0, size_ = 0;
};

// ---- CAVLC tables (9.2, Tables 9-5, 9-7, 9-8, 9-9, 9-10) ---------------

// coeff_token: length and code of (TotalCoeff, TrailingOnes) at index
// 4 * TotalCoeff + TrailingOnes, for 0 <= nC < 2, 2 <= nC < 4, 4 <= nC < 8
const uint8_t kCoeffTokenLen[3][4 * 17] = {
    {1,  0,  0,  0,  6,  2,  0,  0,  8,  6,  3,  0,  9,  8,  7,  5,  10,
     9,  8,  6,  11, 10, 9,  7,  13, 11, 10, 8,  13, 13, 11, 9,  13, 13,
     13, 10, 14, 14, 13, 11, 14, 14, 14, 13, 15, 15, 14, 14, 15, 15, 15,
     14, 16, 15, 15, 15, 16, 16, 16, 15, 16, 16, 16, 16, 16, 16, 16, 16},
    {2,  0,  0,  0,  6,  2,  0,  0,  6,  5,  3,  0,  7,  6,  6,  4,  8,
     6,  6,  4,  8,  7,  7,  5,  9,  8,  8,  6,  11, 9,  9,  6,  11, 11,
     11, 7,  12, 11, 11, 9,  12, 12, 12, 11, 12, 12, 12, 11, 13, 13, 13,
     12, 13, 13, 13, 13, 13, 14, 13, 13, 14, 14, 14, 13, 14, 14, 14, 14},
    {4,  0,  0,  0,  6,  4,  0,  0,  6,  5,  4,  0,  6,  5,  5,  4,  7,
     5,  5,  4,  7,  5,  5,  4,  7,  6,  6,  4,  7,  6,  6,  4,  8,  7,
     7,  5,  8,  8,  7,  6,  9,  8,  8,  7,  9,  9,  8,  8,  9,  9,  9,
     8,  10, 9,  9,  9,  10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10, 10},
};
const uint8_t kCoeffTokenBits[3][4 * 17] = {
    {1,  0,  0,  0, 5,  1,  0,  0,  7,  4,  1,  0,  7,  6,  5,  3,  7,
     6,  5,  3,  7, 6,  5,  4,  15, 6,  5,  4,  11, 14, 5,  4,  8,  10,
     13, 4,  15, 14, 9, 4,  11, 10, 13, 12, 15, 14, 9,  12, 11, 10, 13,
     8,  15, 1,  9, 12, 11, 14, 13, 8,  7,  10, 9,  12, 4,  6,  5,  8},
    {3,  0,  0,  0,  11, 2,  0,  0,  7,  7,  3,  0,  7,  10, 9,  5,  7,
     6,  5,  4,  4,  6,  5,  6,  7,  6,  5,  8,  15, 6,  5,  4,  11, 14,
     13, 4,  15, 10, 9,  4,  11, 14, 13, 12, 8,  10, 9,  8,  15, 14, 13,
     12, 11, 10, 9,  12, 7,  11, 6,  8,  9,  8,  10, 1,  7,  6,  5,  4},
    {15, 0,  0,  0,  15, 14, 0,  0,  11, 15, 13, 0,  8,  12, 14, 12, 15,
     10, 11, 11, 11, 8,  9,  10, 9,  14, 13, 9,  8,  10, 9,  8,  15, 14,
     13, 13, 11, 14, 10, 12, 15, 10, 13, 12, 11, 14, 9,  12, 8,  10, 13,
     8,  13, 7,  9,  12, 9,  12, 11, 10, 5,  8,  7,  6,  1,  4,  3,  2},
};
// nC == -1 (chroma DC, 4:2:0)
const uint8_t kChromaDcTokenLen[4 * 5] = {2, 0, 0, 0, 6, 1, 0, 0, 6, 6,
                                          3, 0, 6, 7, 7, 6, 6, 8, 8, 7};
const uint8_t kChromaDcTokenBits[4 * 5] = {1, 0, 0, 0, 7, 1, 0, 0, 4, 6,
                                           1, 0, 3, 3, 2, 5, 2, 3, 2, 0};
// total_zeros for 4x4 blocks by TotalCoeff 1..15, value 0..16-TotalCoeff
const uint8_t kTotalZerosLen[15][16] = {
    {1, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9, 9},
    {3, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 6, 6, 6, 6},
    {4, 3, 3, 3, 4, 4, 3, 3, 4, 5, 5, 6, 5, 6},
    {5, 3, 4, 4, 3, 3, 3, 4, 3, 4, 5, 5, 5},
    {4, 4, 4, 3, 3, 3, 3, 3, 4, 5, 4, 5},
    {6, 5, 3, 3, 3, 3, 3, 3, 4, 3, 6},
    {6, 5, 3, 3, 3, 2, 3, 4, 3, 6},
    {6, 4, 5, 3, 2, 2, 3, 3, 6},
    {6, 6, 4, 2, 2, 3, 2, 5},
    {5, 5, 3, 2, 2, 2, 4},
    {4, 4, 3, 3, 1, 3},
    {4, 4, 2, 1, 3},
    {3, 3, 1, 2},
    {2, 2, 1},
    {1, 1},
};
const uint8_t kTotalZerosBits[15][16] = {
    {1, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 3, 2, 1},
    {7, 6, 5, 4, 3, 5, 4, 3, 2, 3, 2, 3, 2, 1, 0},
    {5, 7, 6, 5, 4, 3, 4, 3, 2, 3, 2, 1, 1, 0},
    {3, 7, 5, 4, 6, 5, 4, 3, 3, 2, 2, 1, 0},
    {5, 4, 3, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 7, 6, 5, 4, 3, 2, 1, 1, 0},
    {1, 1, 5, 4, 3, 3, 2, 1, 1, 0},
    {1, 1, 1, 3, 3, 2, 2, 1, 0},
    {1, 0, 1, 3, 2, 1, 1, 1},
    {1, 0, 1, 3, 2, 1, 1},
    {0, 1, 1, 2, 1, 3},
    {0, 1, 1, 1, 1},
    {0, 1, 1, 1},
    {0, 1, 1},
    {0, 1},
};
// total_zeros of the 2x2 chroma DC by TotalCoeff 1..3
const uint8_t kChromaDcZerosLen[3][4] = {{1, 2, 3, 3}, {1, 2, 2}, {1, 1}};
const uint8_t kChromaDcZerosBits[3][4] = {{1, 1, 1, 0}, {1, 1, 0}, {1, 0}};
// run_before by zerosLeft 1..6 and > 6
const uint8_t kRunLen[7][16] = {
    {1, 1},          {1, 2, 2},          {2, 2, 2, 2},
    {2, 2, 2, 3, 3}, {2, 2, 3, 3, 3, 3}, {2, 3, 3, 3, 3, 3, 3},
    {3, 3, 3, 3, 3, 3, 3, 4, 5, 6, 7, 8, 9, 10, 11},
};
const uint8_t kRunBits[7][16] = {
    {1, 0},          {1, 1, 0},          {3, 2, 1, 0},
    {3, 2, 1, 1, 0}, {3, 2, 3, 2, 1, 0}, {3, 0, 1, 3, 2, 5, 4},
    {7, 6, 5, 4, 3, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1},
};

// coded_block_pattern of me(v), chroma_format_idc 1 (Table 9-4)
const uint8_t kIntraCbp[48] = {47, 31, 15, 0,  23, 27, 29, 30, 7,  11, 13, 14,
                               39, 43, 45, 46, 16, 3,  5,  10, 12, 19, 21, 26,
                               28, 35, 37, 42, 44, 1,  2,  4,  8,  17, 18, 20,
                               24, 6,  9,  22, 25, 32, 33, 34, 36, 40, 38, 41};
const uint8_t kInterCbp[48] = {0,  16, 1,  2,  4,  8,  32, 3,  5,  10, 12, 15,
                               47, 7,  11, 13, 14, 6,  9,  31, 35, 37, 42, 44,
                               33, 34, 36, 40, 39, 43, 45, 46, 17, 18, 20, 24,
                               19, 21, 26, 28, 23, 27, 29, 30, 22, 25, 38, 41};

// zig-zag scans (8.5.6, Tables 8-13 and 8-14), raster index row * n + col
const uint8_t kZigzag4[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kZigzag8[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

// normAdjust4x4 and normAdjust8x8 (8.5.9), flat weightScale 16
const int kNorm4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                          {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
const int kNorm8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                          {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                          {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
// QPc by qPI 30..51 (Table 8-15)
const uint8_t kChromaQp[22] = {29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36,
                               36, 37, 37, 37, 38, 38, 38, 39, 39, 39, 39};
inline int chroma_qp(int qp, int offset) {
  int q = clip3(0, 51, qp + offset);
  return q < 30 ? q : kChromaQp[q - 30];
}

// deblocking (Tables 8-16, 8-17)
const uint8_t kAlpha[52] = {0,   0,   0,   0,   0,   0,   0,   0,   0,   0,  0,
                            0,   0,   0,   0,   0,   4,   4,   5,   6,   7,  8,
                            9,   10,  12,  13,  15,  17,  20,  22,  25,  28, 32,
                            36,  40,  45,  50,  56,  63,  71,  80,  90,  101, 113,
                            127, 144, 162, 182, 203, 226, 255, 255};
const uint8_t kBeta[52] = {0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  0,  0,
                           0, 0, 0, 2, 2, 2,  3,  3,  3,  3,  4,  4,  4,
                           6, 6, 7, 7, 8, 8,  9,  9,  10, 10, 11, 11, 12,
                           12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
const uint8_t kTc0[52][3] = {
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 0},   {0, 0, 0},    {0, 0, 0},
    {0, 0, 0},   {0, 0, 0},   {0, 0, 1},   {0, 0, 1},    {0, 0, 1},
    {0, 0, 1},   {0, 1, 1},   {0, 1, 1},   {1, 1, 1},    {1, 1, 1},
    {1, 1, 1},   {1, 1, 1},   {1, 1, 2},   {1, 1, 2},    {1, 1, 2},
    {1, 1, 2},   {1, 2, 3},   {1, 2, 3},   {2, 2, 3},    {2, 2, 4},
    {2, 3, 4},   {2, 3, 4},   {3, 3, 5},   {3, 4, 6},    {3, 4, 6},
    {4, 5, 7},   {4, 5, 8},   {4, 6, 9},   {5, 7, 10},   {6, 8, 11},
    {6, 8, 13},  {7, 10, 14}, {8, 11, 16}, {9, 12, 18},  {10, 13, 20},
    {11, 15, 23}, {13, 17, 25}};

// a VLC as a lookup on its longest code: symbol and length of each prefix
struct Vlc {
  int maxlen = 0;
  std::vector<uint16_t> sym;
  std::vector<uint8_t> len;
  void build(const uint8_t* lens, const uint8_t* bits, int n) {
    maxlen = 0;
    for (int i = 0; i < n; ++i) maxlen = std::max<int>(maxlen, lens[i]);
    sym.assign((size_t)1 << maxlen, 0);
    len.assign((size_t)1 << maxlen, 0);
    for (int i = 0; i < n; ++i) {
      int l = lens[i];
      if (!l) continue;
      uint32_t first = (uint32_t)bits[i] << (maxlen - l);
      for (uint32_t k = 0; k < (1u << (maxlen - l)); ++k) {
        sym[first + k] = (uint16_t)i;
        len[first + k] = (uint8_t)l;
      }
    }
  }
  int read(Bits& b, const char* what) const {
    uint32_t v = b.show(maxlen);
    int l = len[v];
    if (!l) fail(std::string("an invalid ") + what + " code");
    b.skip(l);
    b.check();
    return sym[v];
  }
};

struct Tables {
  Vlc coeff_token[3], chroma_dc_token, total_zeros[15], chroma_dc_zeros[3],
      run_before[7];
  int blk_x[16], blk_y[16];
  Tables() {
    for (int t = 0; t < 3; ++t)
      coeff_token[t].build(kCoeffTokenLen[t], kCoeffTokenBits[t], 4 * 17);
    chroma_dc_token.build(kChromaDcTokenLen, kChromaDcTokenBits, 4 * 5);
    for (int t = 0; t < 15; ++t)
      total_zeros[t].build(kTotalZerosLen[t], kTotalZerosBits[t], 16 - t);
    for (int t = 0; t < 3; ++t)
      chroma_dc_zeros[t].build(kChromaDcZerosLen[t], kChromaDcZerosBits[t], 4 - t);
    for (int t = 0; t < 7; ++t)
      run_before[t].build(kRunLen[t], kRunBits[t], t < 6 ? t + 2 : 15);
    for (int i = 0; i < 16; ++i) {  // luma4x4BlkIdx -> 4x4 position (6.4.3)
      blk_x[i] = (i & 1) + ((i >> 2) & 1) * 2;
      blk_y[i] = ((i >> 1) & 1) + ((i >> 3) & 1) * 2;
    }
  }
};

const Tables& tables() {
  static const Tables t;
  return t;
}

// ---- parameter sets (7.3.2.1, 7.3.2.2) ---------------------------------

struct Sps {
  bool valid = false;
  int profile = 0, level = 0;
  int chroma_format = 1, bit_depth_luma = 8, bit_depth_chroma = 8;
  int bypass = 0, scaling = 0;
  int log2_max_frame_num = 4, poc_type = 0, log2_max_poc_lsb = 4;
  int max_num_ref_frames = 0, gaps_allowed = 0;
  int mb_w = 0, mb_h = 0, frame_mbs_only = 1, direct_8x8 = 0;
  int crop_l = 0, crop_r = 0, crop_t = 0, crop_b = 0;
  int matrix = 2, full_range = 0;
  int num_reorder = -1;
};

struct Pps {
  bool valid = false;
  int sps_id = 0, cabac = 0, bottom_field_poc = 0, slice_groups = 1;
  int num_ref_idx_default[2] = {1, 1};
  int weighted_pred = 0, weighted_bipred = 0, pic_init_qp = 26;
  int chroma_qp_offset[2] = {0, 0};
  int deblock_ctrl = 0, constrained_intra = 0, redundant_pic_cnt = 0;
  int transform_8x8 = 0, scaling = 0;
};

const int kHighProfiles[] = {100, 110, 122, 244, 44, 83, 86, 118, 128, 138, 139, 134, 135};

void skip_scaling_list(Bits& b, int size) {
  int last = 8, next = 8;
  for (int j = 0; j < size; ++j) {
    if (next != 0) next = (last + b.se() + 256) % 256;
    last = next == 0 ? last : next;
  }
}

// MaxDpbFrames for a frame size in macroblocks (Table A-1: MaxDpbMbs)
int max_dpb_frames(int level, int frame_mbs) {
  struct { int level, mbs; } const t[] = {
      {9, 396},     {10, 396},    {11, 900},    {12, 2376},   {13, 2376},
      {20, 2376},   {21, 4752},   {22, 8100},   {30, 8100},   {31, 18000},
      {32, 20480},  {40, 32768},  {41, 32768},  {42, 34816},  {50, 110400},
      {51, 184320}, {52, 184320}};
  int mbs = 184320;
  for (auto& e : t)
    if (e.level == level) mbs = e.mbs;
  return std::max(1, std::min(mbs / std::max(frame_mbs, 1), 16));
}

Sps parse_sps(Bits& b, int* id) {
  Sps s;
  s.profile = (int)b.u(8);
  b.u(8);  // constraint_set flags, reserved_zero_2bits
  s.level = (int)b.u(8);
  *id = (int)b.ue();
  if (*id > 31) fail("seq_parameter_set_id out of range");
  if (std::find(std::begin(kHighProfiles), std::end(kHighProfiles), s.profile) !=
      std::end(kHighProfiles)) {
    s.chroma_format = (int)b.ue();
    if (s.chroma_format == 3) b.u1();  // separate_colour_plane_flag
    s.bit_depth_luma = 8 + (int)b.ue();
    s.bit_depth_chroma = 8 + (int)b.ue();
    s.bypass = b.u1();
    s.scaling = b.u1();
    if (s.scaling)
      for (int i = 0; i < (s.chroma_format != 3 ? 8 : 12); ++i)
        if (b.u1()) skip_scaling_list(b, i < 6 ? 16 : 64);
  }
  s.log2_max_frame_num = (int)b.ue() + 4;
  if (s.log2_max_frame_num > 16) fail("log2_max_frame_num out of range");
  s.poc_type = (int)b.ue();
  if (s.poc_type == 0) {
    s.log2_max_poc_lsb = (int)b.ue() + 4;
    if (s.log2_max_poc_lsb > 16) fail("log2_max_pic_order_cnt_lsb out of range");
  } else if (s.poc_type == 1) {
    s.valid = true;  // refused when a slice activates it
    return s;
  } else if (s.poc_type != 2) {
    fail("pic_order_cnt_type out of range");
  }
  s.max_num_ref_frames = (int)b.ue();
  s.gaps_allowed = b.u1();
  s.mb_w = (int)b.ue() + 1;
  s.mb_h = (int)b.ue() + 1;
  s.frame_mbs_only = b.u1();
  if (!s.frame_mbs_only) b.u1();  // mb_adaptive_frame_field_flag
  s.direct_8x8 = b.u1();
  if (b.u1()) {
    s.crop_l = (int)b.ue();
    s.crop_r = (int)b.ue();
    s.crop_t = (int)b.ue();
    s.crop_b = (int)b.ue();
  }
  if (s.mb_w > 1024 || s.mb_h > 1024) fail("a picture of more than 16384 samples a side");
  if (b.u1()) {  // vui_parameters_present_flag (E.1.1)
    if (b.u1()) {  // aspect_ratio_info_present_flag
      if (b.u(8) == 255) b.u(32);
    }
    if (b.u1()) b.u1();  // overscan
    if (b.u1()) {        // video_signal_type_present_flag
      b.u(3);
      s.full_range = b.u1();
      if (b.u1()) {  // colour_description_present_flag
        b.u(8);
        b.u(8);
        s.matrix = (int)b.u(8);
      }
    }
    if (b.u1()) {  // chroma_loc_info_present_flag
      b.ue();
      b.ue();
    }
    if (b.u1()) {  // timing_info_present_flag
      b.u(32);
      b.u(32);
      b.u1();
    }
    int nal_hrd = b.u1(), vcl_hrd = 0;
    auto hrd = [&]() {
      int cpb_cnt = (int)b.ue() + 1;
      b.u(8);
      for (int i = 0; i < cpb_cnt; ++i) {
        b.ue();
        b.ue();
        b.u1();
      }
      b.u(20);
    };
    if (nal_hrd) hrd();
    vcl_hrd = b.u1();
    if (vcl_hrd) hrd();
    if (nal_hrd || vcl_hrd) b.u1();  // low_delay_hrd_flag
    b.u1();                          // pic_struct_present_flag
    if (b.u1()) {                    // bitstream_restriction_flag
      b.u1();
      b.ue();
      b.ue();
      b.ue();
      b.ue();
      s.num_reorder = (int)b.ue();
      b.ue();  // max_dec_frame_buffering
    }
  }
  s.valid = true;
  return s;
}

Pps parse_pps(Bits& b, int* id) {
  Pps p;
  *id = (int)b.ue();
  if (*id > 255) fail("pic_parameter_set_id out of range");
  p.sps_id = (int)b.ue();
  p.cabac = b.u1();
  p.bottom_field_poc = b.u1();
  p.slice_groups = (int)b.ue() + 1;
  if (p.slice_groups > 1) {
    p.valid = true;  // refused when a slice activates it
    return p;
  }
  p.num_ref_idx_default[0] = (int)b.ue() + 1;
  p.num_ref_idx_default[1] = (int)b.ue() + 1;
  if (p.num_ref_idx_default[0] > 32 || p.num_ref_idx_default[1] > 32)
    fail("num_ref_idx_default_active out of range");
  p.weighted_pred = b.u1();
  p.weighted_bipred = (int)b.u(2);
  p.pic_init_qp = 26 + b.se();
  b.se();  // pic_init_qs_minus26
  p.chroma_qp_offset[0] = p.chroma_qp_offset[1] = b.se();
  p.deblock_ctrl = b.u1();
  p.constrained_intra = b.u1();
  p.redundant_pic_cnt = b.u1();
  if (b.more_rbsp_data()) {
    p.transform_8x8 = b.u1();
    p.scaling = b.u1();
    if (p.scaling)
      for (int i = 0; i < 6 + 2 * p.transform_8x8; ++i)
        if (b.u1()) skip_scaling_list(b, i < 6 ? 16 : 64);
    p.chroma_qp_offset[1] = b.se();
  }
  p.valid = true;
  return p;
}

// ---- pictures -----------------------------------------------------------

struct Picture {
  int id = 0;  // unique per decoded picture: what "the same reference
               // picture" compares (deblocking, temporal direct)
  int mb_w = 0, mb_h = 0;
  std::vector<uint8_t> plane[3];  // Y (16 mb_w wide), U and V (8 mb_w)
  int poc = 0, frame_num = 0, long_term_idx = 0;
  bool ref_short = false, ref_long = false, held = false;
  bool reset = false;  // an IDR picture or one with an MMCO 5
  long long tag = 0;
  int matrix = 2, full_range = 0;
  int crop_x = 0, crop_y = 0, out_w = 0, out_h = 0;
  // motion per 4x4 block of the picture (raster over its 4x4 grid): the
  // vector (quarter-pel), the reference index and the referenced
  // picture's id (-1 where the list is not used)
  std::vector<int16_t> mv[2];
  std::vector<int8_t> ref[2];
  std::vector<int> ref_pic[2];
  std::vector<uint8_t> intra;  // per macroblock

  void alloc(int w, int h) {
    if (mb_w == w && mb_h == h) return;
    mb_w = w;
    mb_h = h;
    plane[0].assign((size_t)256 * w * h, 0);
    plane[1].assign((size_t)64 * w * h, 128);
    plane[2].assign((size_t)64 * w * h, 128);
    for (int l = 0; l < 2; ++l) {
      mv[l].assign((size_t)32 * w * h, 0);
      ref[l].assign((size_t)16 * w * h, -1);
      ref_pic[l].assign((size_t)16 * w * h, -1);
    }
    intra.assign((size_t)w * h, 0);
  }
  bool is_ref() const { return ref_short || ref_long; }
};

struct SliceHdr {
  int type = 2;  // 0 P, 1 B, 2 I
  int first_mb = 0, pps_id = 0, frame_num = 0, idr = 0, nal_ref_idc = 0;
  int poc_lsb = 0, delta_bottom = 0;
  int direct_spatial = 0;
  int num_ref[2] = {0, 0};
  std::vector<std::pair<int, int>> mods[2];
  int luma_log2 = 0, chroma_log2 = 0, explicit_wp = 0, implicit_wp = 0;
  int lw[2][32], lo[2][32], cw[2][32][2], co[2][32][2];
  int long_term_ref = 0, adaptive = 0;
  std::vector<std::array<int, 3>> mmco;
  int qp = 26, deblock_idc = 0, alpha_off = 0, beta_off = 0;
  int chroma_qp_offset[2] = {0, 0};
  Picture* list[2][32];
  int implicit_w0[32][32];  // w0 of implicit bi-prediction by (ref0, ref1)
  int dsf[32];              // temporal direct DistScaleFactor by ref0
};

struct MbInfo {
  int slice = -1;  // index into the picture's slices; -1: not decoded yet
  uint8_t intra = 0, skip = 0, pcm = 0, inxn = 0, t8 = 0;
  int qp = 0;            // QPY; 0 for I_PCM (8.7.2.2)
  uint8_t tc[24];        // TotalCoeff per luma 4x4 (raster), then Cb, Cr 2x2
  uint16_t nz = 0;       // luma 4x4 blocks with coefficients (deblocking)
  int8_t ipred[16];      // Intra4x4PredMode per 4x4 (raster), 8x8's x4
};

// the macroblock being decoded: its coefficients, before scaling
struct MbCoeffs {
  int luma[16][16];      // per 4x4 (raster) by raster position
  int luma8[4][64];      // per 8x8 by raster position
  int dc[16];            // Intra16x16DCLevel, raster over the blocks
  int cdc[2][4];
  int cac[2][4][16];
  uint16_t luma_coded = 0;  // 4x4 (or 8x8 via bit of its first 4x4)
  uint8_t cac_coded[2] = {0, 0};
  bool dc_coded = false, cdc_coded = false;
};

// partitions of a P or B macroblock (Tables 7-13, 7-14)
enum { kL0 = 1, kL1 = 2, kBi = 3 };
enum { kShape16x16, kShape16x8, kShape8x16, kShape8x8, kShapeDirect };
struct MbTypeInfo {
  int shape, pred[2];
};
const MbTypeInfo kPTypes[5] = {{kShape16x16, {kL0, 0}},
                               {kShape16x8, {kL0, kL0}},
                               {kShape8x16, {kL0, kL0}},
                               {kShape8x8, {0, 0}},
                               {kShape8x8, {0, 0}}};
const MbTypeInfo kBTypes[23] = {
    {kShapeDirect, {0, 0}},     {kShape16x16, {kL0, 0}},
    {kShape16x16, {kL1, 0}},    {kShape16x16, {kBi, 0}},
    {kShape16x8, {kL0, kL0}},   {kShape8x16, {kL0, kL0}},
    {kShape16x8, {kL1, kL1}},   {kShape8x16, {kL1, kL1}},
    {kShape16x8, {kL0, kL1}},   {kShape8x16, {kL0, kL1}},
    {kShape16x8, {kL1, kL0}},   {kShape8x16, {kL1, kL0}},
    {kShape16x8, {kL0, kBi}},   {kShape8x16, {kL0, kBi}},
    {kShape16x8, {kL1, kBi}},   {kShape8x16, {kL1, kBi}},
    {kShape16x8, {kBi, kL0}},   {kShape8x16, {kBi, kL0}},
    {kShape16x8, {kBi, kL1}},   {kShape8x16, {kBi, kL1}},
    {kShape16x8, {kBi, kBi}},   {kShape8x16, {kBi, kBi}},
    {kShape8x8, {0, 0}}};
// sub-macroblock types: partitions (w, h in 4x4 units), prediction; pred 0
// is direct
struct SubInfo {
  int w, h, pred;
};
const SubInfo kPSub[4] = {{2, 2, kL0}, {2, 1, kL0}, {1, 2, kL0}, {1, 1, kL0}};
const SubInfo kBSub[13] = {{2, 2, 0},   {2, 2, kL0}, {2, 2, kL1}, {2, 2, kBi},
                           {2, 1, kL0}, {1, 2, kL0}, {2, 1, kL1}, {1, 2, kL1},
                           {2, 1, kBi}, {1, 2, kBi}, {1, 1, kL0}, {1, 1, kL1},
                           {1, 1, kBi}};

struct Nb {
  bool avail;
  int ref, x, y;
};

// ---- scaling and inverse transforms (8.5.12, 8.5.13) --------------------

// the 4x4 block's scaled coefficients d of its levels c (raster), with d[0]
// = dc instead where the DC was scaled apart (Intra16x16, chroma)
void scale4(const int* c, int qp, bool has_dc, int dc, int* d) {
  const int m = qp % 6, q6 = qp / 6;
  for (int k = 0; k < 16; ++k) {
    int i = k >> 2, j = k & 3;
    int ls = 16 * kNorm4[m][(i & 1) == 0 && (j & 1) == 0 ? 0 : (i & 1) && (j & 1) ? 1 : 2];
    d[k] = qp >= 24 ? (c[k] * ls) << (q6 - 4) : (c[k] * ls + (1 << (3 - q6))) >> (4 - q6);
  }
  if (has_dc) d[0] = dc;
}

void scale8(const int* c, int qp, int* d) {
  const int m = qp % 6, q6 = qp / 6;
  for (int k = 0; k < 64; ++k) {
    int i = k >> 3, j = k & 7;
    int v = (i & 3) == 0 && (j & 3) == 0                                ? 0
            : (i & 1) && (j & 1)                                        ? 1
            : (i & 3) == 2 && (j & 3) == 2                              ? 2
            : ((i & 3) == 0 && (j & 1)) || ((i & 1) && (j & 3) == 0)    ? 3
            : ((i & 3) == 0 && (j & 3) == 2) || ((i & 3) == 2 && (j & 3) == 0) ? 4
                                                                        : 5;
    int ls = 16 * kNorm8[m][v];
    d[k] = qp >= 36 ? (c[k] * ls) << (q6 - 6) : (c[k] * ls + (1 << (5 - q6))) >> (6 - q6);
  }
}

// rows, then columns; (x + 32) >> 6 added to the prediction and clipped
void idct4_add(uint8_t* dst, int pitch, const int* d) {
  int f[16];
  for (int i = 0; i < 4; ++i) {
    const int* r = d + 4 * i;
    int e0 = r[0] + r[2], e1 = r[0] - r[2], e2 = (r[1] >> 1) - r[3], e3 = r[1] + (r[3] >> 1);
    f[4 * i] = e0 + e3;
    f[4 * i + 1] = e1 + e2;
    f[4 * i + 2] = e1 - e2;
    f[4 * i + 3] = e0 - e3;
  }
  for (int j = 0; j < 4; ++j) {
    int g0 = f[j] + f[8 + j], g1 = f[j] - f[8 + j], g2 = (f[4 + j] >> 1) - f[12 + j],
        g3 = f[4 + j] + (f[12 + j] >> 1);
    int h[4] = {g0 + g3, g1 + g2, g1 - g2, g0 - g3};
    for (int i = 0; i < 4; ++i) {
      uint8_t* p = dst + i * pitch + j;
      *p = clip1(*p + ((h[i] + 32) >> 6));
    }
  }
}

inline void idct8_1d(const int* in, int stride, int* out, int ostride) {
  const int d0 = in[0], d1 = in[stride], d2 = in[2 * stride], d3 = in[3 * stride],
            d4 = in[4 * stride], d5 = in[5 * stride], d6 = in[6 * stride], d7 = in[7 * stride];
  int e0 = d0 + d4, e1 = -d3 + d5 - d7 - (d7 >> 1), e2 = d0 - d4,
      e3 = d1 + d7 - d3 - (d3 >> 1), e4 = (d2 >> 1) - d6, e5 = -d1 + d7 + d5 + (d5 >> 1),
      e6 = d2 + (d6 >> 1), e7 = d3 + d5 + d1 + (d1 >> 1);
  int f0 = e0 + e6, f1 = e1 + (e7 >> 2), f2 = e2 + e4, f3 = e3 + (e5 >> 2), f4 = e2 - e4,
      f5 = (e3 >> 2) - e5, f6 = e0 - e6, f7 = e7 - (e1 >> 2);
  out[0] = f0 + f7;
  out[ostride] = f2 + f5;
  out[2 * ostride] = f4 + f3;
  out[3 * ostride] = f6 + f1;
  out[4 * ostride] = f6 - f1;
  out[5 * ostride] = f4 - f3;
  out[6 * ostride] = f2 - f5;
  out[7 * ostride] = f0 - f7;
}

void idct8_add(uint8_t* dst, int pitch, const int* d) {
  int g[64], h[64];
  for (int i = 0; i < 8; ++i) idct8_1d(d + 8 * i, 1, g + 8 * i, 1);
  for (int j = 0; j < 8; ++j) idct8_1d(g + j, 8, h + j, 8);
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      uint8_t* p = dst + i * pitch + j;
      *p = clip1(*p + ((h[8 * i + j] + 32) >> 6));
    }
}

// ---- the decoder --------------------------------------------------------

class Decoder {
 public:
  int send(const uint8_t* unit, size_t n, long long tag);
  int flush();
  const Picture* ready() const { return out_.empty() ? nullptr : out_.front(); }
  void pop() {
    out_.front()->held = false;
    out_.pop_front();
  }

 private:
  // stream state
  Sps sps_[32];
  Pps pps_[256];
  const Sps* sps = nullptr;  // active
  const Pps* pps = nullptr;
  std::vector<std::unique_ptr<Picture>> pool_;
  std::vector<Picture*> delayed_;  // decoded, not yet output (decode order)
  std::deque<Picture*> out_;       // output, not yet received
  bool have_ref_state_ = false;
  int prev_ref_frame_num_ = 0, prev_frame_num_ = 0, prev_frame_num_offset_ = 0;
  int prev_poc_msb_ = 0, prev_poc_lsb_ = 0;
  int max_long_term_idx_ = -1;  // -1: no long-term frame indices
  int serial_ = 0;
  std::vector<uint8_t> rbsp_;
  // the picture being decoded
  Picture* cur_ = nullptr;
  long long tag_ = 0;
  int frame_num_offset_ = 0, mmco5_ = 0;
  std::vector<SliceHdr> slices_;
  std::vector<MbInfo> mbs_;
  int mb_w = 0, mb_h = 0, w4 = 0;
  // the macroblock being decoded
  int slice_ = -1;
  SliceHdr* s_ = nullptr;
  int addr_ = 0, mbx_ = 0, mby_ = 0, qp_ = 0;
  uint16_t done_ = 0;  // its 4x4 blocks whose motion is known (raster)
  MbCoeffs co_;

  void nal(const uint8_t* p, size_t n);
  void slice(Bits& b, int nal_type, int ref_idc);
  void parse_header(Bits& b, SliceHdr& s, int nal_type, int ref_idc);
  void start_picture(const SliceHdr& s);
  void finish_picture();
  void build_lists(SliceHdr& s);
  void output_one();
  int reorder_depth() const;
  int frame_num_wrap(const Picture* p) const {
    int max = 1 << sps->log2_max_frame_num;
    return p->frame_num > cur_->frame_num ? p->frame_num - max : p->frame_num;
  }
  // slice data (7.3.4) and macroblocks (7.3.5)
  void slice_data(Bits& b);
  void skip_mb();
  void macroblock(Bits& b);
  void intra_mb(Bits& b, int type);
  void pcm_mb(Bits& b);
  void inter_mb(Bits& b, int type);
  void residual(Bits& b, int cbp, bool i16, bool t8);
  int residual_block(Bits& b, int nc, int max_coeff, int* scan_out);
  int nc_luma(int bx, int by) const;
  int nc_chroma(int comp, int bx, int by) const;
  void begin_mb(int addr);
  // motion (8.4.1)
  Nb nb(int list, int gx, int gy) const;
  void mvpred(int list, int ref, int gx, int gy, int pw, int shape, int part, int* mx,
              int* my) const;
  void set_motion(int gx, int gy, int pw, int ph, int list, int ref, int mx, int my);
  void direct(int b8_first, int b8_last);
  void pskip_motion();
  // prediction and reconstruction (8.3, 8.4.2, 8.5)
  void mc(int gx, int gy, int pw, int ph);
  void intra4x4(int blk, int mode, bool avA, bool avB, bool avC, bool avD);
  void intra8x8(int b8, int mode, bool avA, bool avB, bool avC, bool avD);
  void intra16x16(int mode, bool avA, bool avB, bool avD);
  void intra_chroma(int mode, bool avA, bool avB, bool avD);
  void add_luma_residual(bool i16, bool t8);
  void add_chroma_residual();
  bool intra_avail(int addr) const;
  bool mb_avail(int addr) const { return addr >= 0 && mbs_[addr].slice == slice_; }
  // deblocking (8.7)
  void deblock();
};

// Annex B: the NAL units of the unit, each after its start code
int Decoder::send(const uint8_t* unit, size_t n, long long tag) {
  tag_ = tag;
  size_t i = 0;
  auto next_start = [&](size_t from) {
    for (size_t k = from; k + 2 < n; ++k)
      if (unit[k] == 0 && unit[k + 1] == 0 && unit[k + 2] == 1) return k;
    return n;
  };
  i = next_start(0);
  while (i < n) {
    size_t s = i + 3;
    size_t e = next_start(s);
    size_t end = e;
    while (end > s && unit[end - 1] == 0) --end;  // trailing_zero_8bits
    if (end > s) nal(unit + s, end - s);
    i = e;
  }
  if (cur_) finish_picture();
  return (int)out_.size();
}

int Decoder::flush() {
  if (cur_) finish_picture();
  while (!delayed_.empty()) output_one();
  return (int)out_.size();
}

void Decoder::nal(const uint8_t* p, size_t n) {
  if (p[0] & 0x80) fail("a NAL unit with forbidden_zero_bit set");
  int ref_idc = (p[0] >> 5) & 3, type = p[0] & 31;
  if (type != 1 && type != 5 && type != 7 && type != 8) {
    if (type >= 2 && type <= 4) refuse("data partitioning (NAL unit types 2-4)");
    return;  // SEI, delimiters, end of sequence, filler, extensions
  }
  // the RBSP: emulation_prevention_three_byte removed (7.4.1)
  rbsp_.resize(n + 16);
  size_t m = 0;
  int zeros = 0;
  for (size_t k = 1; k < n; ++k) {
    if (zeros >= 2 && p[k] == 3) {
      zeros = 0;
      continue;
    }
    zeros = p[k] == 0 ? zeros + 1 : 0;
    rbsp_[m++] = p[k];
  }
  std::fill(rbsp_.begin() + m, rbsp_.begin() + m + 16, 0);
  Bits b;
  b.reset(rbsp_.data(), m);
  int id;
  if (type == 7) {
    Sps s = parse_sps(b, &id);
    sps_[id] = s;
  } else if (type == 8) {
    Pps q = parse_pps(b, &id);
    pps_[id] = q;
  } else {
    slice(b, type, ref_idc);
  }
}

void Decoder::parse_header(Bits& b, SliceHdr& s, int nal_type, int ref_idc) {
  s.first_mb = (int)b.ue();
  int type = (int)b.ue();
  if (type > 9) fail("slice_type out of range");
  type %= 5;
  if (type == 3 || type == 4) refuse("SP and SI slices");
  s.type = type == 0 ? 0 : (type == 1 ? 1 : 2);
  s.pps_id = (int)b.ue();
  if (s.pps_id > 255 || !pps_[s.pps_id].valid) fail("a slice whose PPS was not seen");
  const Pps& p = pps_[s.pps_id];
  if (p.sps_id > 31 || !sps_[p.sps_id].valid) fail("a slice whose SPS was not seen");
  const Sps& q = sps_[p.sps_id];
  if (p.cabac) refuse("CABAC (entropy_coding_mode_flag 1)");
  if (p.slice_groups > 1) refuse("slice groups (FMO)");
  if (q.poc_type == 1) refuse("picture order count type 1");
  if (q.chroma_format != 1) refuse("chroma_format_idc " + std::to_string(q.chroma_format));
  if (q.bit_depth_luma != 8 || q.bit_depth_chroma != 8) refuse("a bit depth above 8");
  if (q.bypass) refuse("qpprime_y_zero_transform_bypass");
  if (q.scaling || p.scaling) refuse("scaling matrices");
  if (!q.frame_mbs_only) refuse("field pictures and MBAFF (frame_mbs_only_flag 0)");
  if (cur_ && sps != &q) fail("two SPSs in one picture");
  sps = &q;
  pps = &p;
  s.nal_ref_idc = ref_idc;
  s.idr = nal_type == 5;
  s.frame_num = (int)b.u(q.log2_max_frame_num);
  if (s.idr) b.ue();  // idr_pic_id
  if (q.poc_type == 0) {
    s.poc_lsb = (int)b.u(q.log2_max_poc_lsb);
    if (p.bottom_field_poc) s.delta_bottom = b.se();
  }
  if (p.redundant_pic_cnt && b.ue() > 0) refuse("redundant pictures");
  if (s.type == 1) s.direct_spatial = b.u1();
  s.num_ref[0] = s.type != 2 ? p.num_ref_idx_default[0] : 0;
  s.num_ref[1] = s.type == 1 ? p.num_ref_idx_default[1] : 0;
  if (s.type != 2 && b.u1()) {  // num_ref_idx_active_override_flag
    s.num_ref[0] = (int)b.ue() + 1;
    if (s.type == 1) s.num_ref[1] = (int)b.ue() + 1;
  }
  if (s.num_ref[0] > 32 || s.num_ref[1] > 32) fail("num_ref_idx_active out of range");
  for (int l = 0; l < (s.type == 2 ? 0 : s.type == 0 ? 1 : 2); ++l) {
    if (b.u1()) {  // ref_pic_list_modification_flag (7.3.3.1)
      for (;;) {
        int op = (int)b.ue();
        if (op == 3) break;
        if (op > 2) fail("modification_of_pic_nums_idc out of range");
        s.mods[l].push_back({op, (int)b.ue()});
        if (s.mods[l].size() > 33) fail("too many reference list modifications");
      }
    }
  }
  s.explicit_wp = (p.weighted_pred && s.type == 0) || (p.weighted_bipred == 1 && s.type == 1);
  s.implicit_wp = p.weighted_bipred == 2 && s.type == 1;
  if (s.explicit_wp) {  // pred_weight_table (7.3.3.2)
    s.luma_log2 = (int)b.ue();
    s.chroma_log2 = (int)b.ue();
    if (s.luma_log2 > 7 || s.chroma_log2 > 7) fail("log2_weight_denom out of range");
    for (int l = 0; l < (s.type == 1 ? 2 : 1); ++l)
      for (int i = 0; i < s.num_ref[l]; ++i) {
        s.lw[l][i] = 1 << s.luma_log2;
        s.lo[l][i] = 0;
        if (b.u1()) {
          s.lw[l][i] = b.se();
          s.lo[l][i] = b.se();
        }
        for (int c = 0; c < 2; ++c) {
          s.cw[l][i][c] = 1 << s.chroma_log2;
          s.co[l][i][c] = 0;
        }
        if (b.u1())
          for (int c = 0; c < 2; ++c) {
            s.cw[l][i][c] = b.se();
            s.co[l][i][c] = b.se();
          }
      }
  }
  if (ref_idc) {  // dec_ref_pic_marking (7.3.3.3)
    if (s.idr) {
      b.u1();  // no_output_of_prior_pics_flag
      s.long_term_ref = b.u1();
    } else {
      s.adaptive = b.u1();
      if (s.adaptive)
        for (;;) {
          int op = (int)b.ue();
          if (op == 0) break;
          if (op > 6) fail("memory_management_control_operation out of range");
          std::array<int, 3> m{op, 0, 0};
          if (op == 1 || op == 3) m[1] = (int)b.ue();  // difference_of_pic_nums_minus1
          if (op == 2) m[1] = (int)b.ue();             // long_term_pic_num
          if (op == 3 || op == 6) m[2] = (int)b.ue();  // long_term_frame_idx
          if (op == 4) m[1] = (int)b.ue();             // max_long_term_frame_idx_plus1
          s.mmco.push_back(m);
          if (s.mmco.size() > 66) fail("too many memory management operations");
        }
    }
  }
  s.qp = p.pic_init_qp + b.se();
  if (s.qp < 0 || s.qp > 51) fail("slice QP out of range");
  if (p.deblock_ctrl) {
    s.deblock_idc = (int)b.ue();
    if (s.deblock_idc > 2) fail("disable_deblocking_filter_idc out of range");
    if (s.deblock_idc != 1) {
      s.alpha_off = 2 * b.se();
      s.beta_off = 2 * b.se();
      if (s.alpha_off < -12 || s.alpha_off > 12 || s.beta_off < -12 || s.beta_off > 12)
        fail("slice deblocking offsets out of range");
    }
  }
  s.chroma_qp_offset[0] = p.chroma_qp_offset[0];
  s.chroma_qp_offset[1] = p.chroma_qp_offset[1];
}

void Decoder::slice(Bits& b, int nal_type, int ref_idc) {
  slices_.emplace_back();
  SliceHdr& s = slices_.back();
  parse_header(b, s, nal_type, ref_idc);
  if (!cur_) {
    start_picture(s);
  } else {
    const SliceHdr& f = slices_.front();
    if (s.frame_num != f.frame_num || s.idr != f.idr || s.poc_lsb != f.poc_lsb ||
        (s.nal_ref_idc != 0) != (f.nal_ref_idc != 0))
      fail("the slices of one access unit belong to different pictures");
    if (slices_.size() > 1 && s.first_mb <= slices_[slices_.size() - 2].first_mb)
      refuse("arbitrary slice order (ASO)");
  }
  if (s.first_mb >= mb_w * mb_h) fail("first_mb_in_slice out of range");
  build_lists(s);
  slice_ = (int)slices_.size() - 1;
  s_ = &s;
  slice_data(b);
}

void Decoder::start_picture(const SliceHdr& s) {
  const Sps& q = *sps;
  if (!s.idr && !have_ref_state_)
    refuse("a stream or a seek that does not begin with an IDR picture (open GOPs, recovery points)");
  if (s.idr) {
    for (auto& p : pool_) p->ref_short = p->ref_long = false;
    max_long_term_idx_ = -1;
    prev_ref_frame_num_ = 0;
    prev_poc_msb_ = prev_poc_lsb_ = 0;
    prev_frame_num_offset_ = 0;
    prev_frame_num_ = 0;
    if (s.frame_num != 0) fail("an IDR picture with frame_num other than 0");
  } else if (s.frame_num != prev_ref_frame_num_ &&
             s.frame_num != (prev_ref_frame_num_ + 1) % (1 << q.log2_max_frame_num)) {
    refuse("a gap in frame_num");
  }
  if (mb_w != q.mb_w || mb_h != q.mb_h) {
    if (!s.idr) fail("a picture size change without an IDR picture");
    mb_w = q.mb_w;
    mb_h = q.mb_h;
    w4 = 4 * mb_w;
  }
  // picture order count (8.2.1)
  int poc;
  if (q.poc_type == 0) {
    int max_lsb = 1 << q.log2_max_poc_lsb, lsb = s.poc_lsb, msb;
    if (lsb < prev_poc_lsb_ && prev_poc_lsb_ - lsb >= max_lsb / 2)
      msb = prev_poc_msb_ + max_lsb;
    else if (lsb > prev_poc_lsb_ && lsb - prev_poc_lsb_ > max_lsb / 2)
      msb = prev_poc_msb_ - max_lsb;
    else
      msb = prev_poc_msb_;
    int top = msb + lsb;
    poc = std::min(top, top + s.delta_bottom);
    if (s.nal_ref_idc) {  // the previous reference picture's, for the next
      prev_poc_msb_ = msb;
      prev_poc_lsb_ = lsb;
    }
  } else {
    int max = 1 << q.log2_max_frame_num;
    frame_num_offset_ = s.idr ? 0
                        : prev_frame_num_ > s.frame_num ? prev_frame_num_offset_ + max
                                                        : prev_frame_num_offset_;
    poc = s.idr ? 0 : 2 * (frame_num_offset_ + s.frame_num) - (s.nal_ref_idc ? 0 : 1);
  }
  // a buffer that holds neither a reference nor a frame waiting for output
  Picture* pic = nullptr;
  for (auto& p : pool_)
    if (!p->is_ref() && !p->held) {
      pic = p.get();
      break;
    }
  if (!pic) {
    if (pool_.size() > 40) fail("more than 40 pictures held at once");
    pool_.emplace_back(new Picture());
    pic = pool_.back().get();
  }
  pic->alloc(mb_w, mb_h);
  pic->id = ++serial_;
  pic->poc = poc;
  pic->frame_num = s.frame_num;
  pic->ref_short = pic->ref_long = false;
  pic->held = true;
  pic->tag = tag_;
  pic->matrix = q.matrix;
  pic->full_range = q.full_range;
  pic->crop_x = 2 * q.crop_l;
  pic->crop_y = 2 * q.crop_t;
  pic->out_w = 16 * mb_w - 2 * (q.crop_l + q.crop_r);
  pic->out_h = 16 * mb_h - 2 * (q.crop_t + q.crop_b);
  if (pic->out_w <= 0 || pic->out_h <= 0) fail("the SPS crops the whole picture");
  std::fill(pic->intra.begin(), pic->intra.end(), 0);
  cur_ = pic;
  mmco5_ = 0;
  mbs_.assign((size_t)mb_w * mb_h, MbInfo());
}

// reference picture lists: initialisation (8.2.4.2) and modification
// (8.2.4.3), then the weights that depend on them
void Decoder::build_lists(SliceHdr& s) {
  std::vector<Picture*> st, lt;
  for (auto& p : pool_) {
    if (p.get() == cur_) continue;
    if (p->ref_short) st.push_back(p.get());
    if (p->ref_long) lt.push_back(p.get());
  }
  std::sort(lt.begin(), lt.end(),
            [](Picture* a, Picture* b) { return a->long_term_idx < b->long_term_idx; });
  std::vector<Picture*> init[2];
  if (s.type == 0) {
    std::sort(st.begin(), st.end(), [this](Picture* a, Picture* b) {
      return frame_num_wrap(a) > frame_num_wrap(b);
    });
    init[0] = st;
    init[0].insert(init[0].end(), lt.begin(), lt.end());
  } else if (s.type == 1) {
    std::vector<Picture*> before, after;
    for (Picture* p : st) (p->poc < cur_->poc ? before : after).push_back(p);
    std::sort(before.begin(), before.end(), [](Picture* a, Picture* b) { return a->poc > b->poc; });
    std::sort(after.begin(), after.end(), [](Picture* a, Picture* b) { return a->poc < b->poc; });
    init[0] = before;
    init[0].insert(init[0].end(), after.begin(), after.end());
    init[0].insert(init[0].end(), lt.begin(), lt.end());
    init[1] = after;
    init[1].insert(init[1].end(), before.begin(), before.end());
    init[1].insert(init[1].end(), lt.begin(), lt.end());
    if (init[1].size() > 1 && init[1] == init[0]) std::swap(init[1][0], init[1][1]);
  }
  int max_frame_num = 1 << sps->log2_max_frame_num;
  for (int l = 0; l < 2; ++l) {
    int n = s.num_ref[l];
    std::vector<Picture*> list(n + 1, nullptr);
    for (int i = 0; i < n && i < (int)init[l].size(); ++i) list[i] = init[l][i];
    int pred = cur_->frame_num, idx = 0;
    for (auto& m : s.mods[l]) {
      if (idx >= n) fail("more reference list modifications than entries");
      Picture* pic = nullptr;
      if (m.first < 2) {
        int d = m.second + 1;
        if (d > max_frame_num) fail("abs_diff_pic_num out of range");
        int no_wrap = m.first == 0 ? pred - d : pred + d;
        if (no_wrap < 0) no_wrap += max_frame_num;
        if (no_wrap >= max_frame_num) no_wrap -= max_frame_num;
        pred = no_wrap;
        int pic_num = no_wrap > cur_->frame_num ? no_wrap - max_frame_num : no_wrap;
        for (Picture* p : st)
          if (frame_num_wrap(p) == pic_num) pic = p;
      } else {
        for (Picture* p : lt)
          if (p->long_term_idx == m.second) pic = p;
      }
      if (!pic) fail("a reference list modification names a picture that is not a reference");
      for (int c = n; c > idx; --c) list[c] = list[c - 1];
      list[idx++] = pic;
      int k = idx;
      for (int c = idx; c <= n; ++c)
        if (list[c] != pic) list[k++] = list[c];
    }
    for (int i = 0; i < 32; ++i) s.list[l][i] = i < n ? list[i] : nullptr;
  }
  if (s.type == 1) {
    Picture* p1 = s.list[1][0];
    for (int i = 0; i < s.num_ref[0]; ++i) {
      Picture* p0 = s.list[0][i];
      s.dsf[i] = 256;
      if (p0 && p1) {
        int td = clip3(-128, 127, p1->poc - p0->poc);
        if (td && !p0->ref_long) {
          int tb = clip3(-128, 127, cur_->poc - p0->poc);
          int tx = (16384 + std::abs(td / 2)) / td;
          s.dsf[i] = clip3(-1024, 1023, (tb * tx + 32) >> 6);
        }
      }
      for (int j = 0; j < s.num_ref[1]; ++j) {
        Picture* q1 = s.list[1][j];
        int w0 = 32;
        if (p0 && q1 && !p0->ref_long && !q1->ref_long) {
          int td = clip3(-128, 127, q1->poc - p0->poc);
          if (td) {
            int tb = clip3(-128, 127, cur_->poc - p0->poc);
            int tx = (16384 + std::abs(td / 2)) / td;
            int dsf = clip3(-1024, 1023, (tb * tx + 32) >> 6);
            if ((dsf >> 2) >= -64 && (dsf >> 2) <= 128) w0 = 64 - (dsf >> 2);
          }
        }
        s.implicit_w0[i][j] = w0;
      }
    }
  }
}

// ffmpeg's choice of the next frame out (h264_select_output_frame): the
// smallest POC among the delayed pictures from the first up to the next
// IDR picture or memory management operation 5
void Decoder::output_one() {
  size_t best = 0;
  for (size_t i = 1; i < delayed_.size() && !delayed_[i]->reset; ++i)
    if (delayed_[i]->poc < delayed_[best]->poc) best = i;
  out_.push_back(delayed_[best]);
  delayed_.erase(delayed_.begin() + (long)best);
}

// the pictures that wait before one is output: the VUI's
// max_num_reorder_frames, else the DPB size, which any stream keeps to
// (data/bitstream.py h264_output_frames takes the same)
int Decoder::reorder_depth() const {
  return sps->num_reorder >= 0 ? sps->num_reorder : max_dpb_frames(sps->level, mb_w * mb_h);
}

void Decoder::finish_picture() {
  deblock();
  const SliceHdr& s = slices_.front();
  const Sps& q = *sps;
  Picture* c = cur_;
  // reference marking (8.2.5)
  if (s.nal_ref_idc) {
    bool long_term = false;
    if (s.idr) {
      if (s.long_term_ref) {
        long_term = true;
        c->long_term_idx = 0;
        max_long_term_idx_ = 0;
      }
    } else if (s.adaptive) {
      int cur_pic_num = c->frame_num;
      auto short_by_num = [&](int pic_num) -> Picture* {
        for (auto& p : pool_)
          if (p.get() != c && p->ref_short && frame_num_wrap(p.get()) == pic_num) return p.get();
        return nullptr;
      };
      auto drop_long_idx = [&](int idx, Picture* keep) {
        for (auto& p : pool_)
          if (p.get() != keep && p->ref_long && p->long_term_idx == idx) p->ref_long = false;
      };
      for (auto& m : s.mmco) {
        switch (m[0]) {
          case 1:
            if (Picture* p = short_by_num(cur_pic_num - (m[1] + 1))) p->ref_short = false;
            break;
          case 2:
            for (auto& p : pool_)
              if (p.get() != c && p->ref_long && p->long_term_idx == m[1]) p->ref_long = false;
            break;
          case 3: {
            Picture* p = short_by_num(cur_pic_num - (m[1] + 1));
            if (!p) break;
            drop_long_idx(m[2], p);
            p->ref_short = false;
            p->ref_long = true;
            p->long_term_idx = m[2];
            break;
          }
          case 4:
            max_long_term_idx_ = m[1] - 1;
            for (auto& p : pool_)
              if (p.get() != c && p->ref_long && p->long_term_idx > max_long_term_idx_)
                p->ref_long = false;
            break;
          case 5:
            for (auto& p : pool_)
              if (p.get() != c) p->ref_short = p->ref_long = false;
            max_long_term_idx_ = -1;
            mmco5_ = 1;
            break;
          case 6:
            drop_long_idx(m[2], c);
            long_term = true;
            c->long_term_idx = m[2];
            break;
        }
      }
    } else {  // sliding window (8.2.5.3)
      int n_short = 0, n_long = 0;
      Picture* oldest = nullptr;
      for (auto& p : pool_) {
        if (p.get() == c) continue;
        if (p->ref_short) {
          ++n_short;
          if (!oldest || frame_num_wrap(p.get()) < frame_num_wrap(oldest)) oldest = p.get();
        }
        if (p->ref_long) ++n_long;
      }
      if (n_short + n_long >= std::max(q.max_num_ref_frames, 1) && oldest)
        oldest->ref_short = false;
    }
    c->ref_long = long_term;
    c->ref_short = !long_term;
  }
  // the state the next picture's frame_num and POC derive from
  if (mmco5_) {
    // 8.2.1: after memory_management_control_operation 5 the picture's
    // order count is taken relative to itself (its TopFieldOrderCnt less
    // the smaller of its two), and frame_num to 0
    c->frame_num = 0;
    prev_poc_msb_ = 0;
    prev_poc_lsb_ = q.poc_type == 0 && s.delta_bottom < 0 ? -s.delta_bottom : 0;
    c->poc = 0;
    prev_frame_num_offset_ = 0;
    prev_frame_num_ = 0;
    if (s.nal_ref_idc) prev_ref_frame_num_ = 0;
  } else {
    prev_frame_num_offset_ = frame_num_offset_;
    prev_frame_num_ = s.frame_num;
    if (s.nal_ref_idc) prev_ref_frame_num_ = s.frame_num;
  }
  have_ref_state_ = true;
  // output: one frame for each picture decoded, once more than the
  // reorder depth wait
  c->reset = s.idr || mmco5_;
  delayed_.push_back(c);
  if ((int)delayed_.size() > reorder_depth()) output_one();
  cur_ = nullptr;
  slices_.clear();
}

// ---- slice data and macroblock parsing (7.3.4, 7.3.5) -------------------

void Decoder::slice_data(Bits& b) {
  const int total = mb_w * mb_h;
  int addr = s_->first_mb;
  qp_ = s_->qp;
  for (;;) {
    if (s_->type != 2) {
      int run = (int)b.ue();
      if (run > total - addr) fail("mb_skip_run runs past the end of the picture");
      for (int k = 0; k < run; ++k) {
        begin_mb(addr++);
        skip_mb();
      }
      if (run > 0 && !b.more_rbsp_data()) break;
    }
    if (addr >= total) fail("a slice runs past the end of the picture");
    begin_mb(addr++);
    macroblock(b);
    if (!b.more_rbsp_data()) break;
  }
}

void Decoder::begin_mb(int addr) {
  if (mbs_[addr].slice >= 0) fail("a macroblock decoded twice");
  addr_ = addr;
  mbx_ = addr % mb_w;
  mby_ = addr / mb_w;
  MbInfo& m = mbs_[addr];
  m = MbInfo();
  m.slice = slice_;
  std::memset(m.tc, 0, sizeof(m.tc));
  std::memset(m.ipred, -1, sizeof(m.ipred));
  done_ = 0;
}

void Decoder::skip_mb() {
  MbInfo& m = mbs_[addr_];
  m.skip = 1;
  m.qp = qp_;
  if (s_->type == 0) {
    pskip_motion();
    mc(4 * mbx_, 4 * mby_, 4, 4);
  } else {
    direct(0, 3);
    int step = sps->direct_8x8 ? 2 : 1;
    for (int y = 0; y < 4; y += step)
      for (int x = 0; x < 4; x += step) mc(4 * mbx_ + x, 4 * mby_ + y, step, step);
  }
}

void Decoder::macroblock(Bits& b) {
  int t = (int)b.ue();
  if (s_->type == 2) {
    intra_mb(b, t);
  } else if (s_->type == 0) {
    if (t < 5)
      inter_mb(b, t);
    else
      intra_mb(b, t - 5);
  } else {
    if (t < 23)
      inter_mb(b, t);
    else
      intra_mb(b, t - 23);
  }
}

bool Decoder::intra_avail(int addr) const {
  return mb_avail(addr) && (!pps->constrained_intra || mbs_[addr].intra);
}

void Decoder::intra_mb(Bits& b, int t) {
  if (t > 25) fail("mb_type out of range");
  MbInfo& m = mbs_[addr_];
  m.intra = 1;
  cur_->intra[addr_] = 1;
  for (int y = 0; y < 4; ++y)
    for (int x = 0; x < 4; ++x) {
      int i = (4 * mby_ + y) * w4 + 4 * mbx_ + x;
      for (int l = 0; l < 2; ++l) {
        cur_->ref[l][i] = -1;
        cur_->ref_pic[l][i] = -1;
        cur_->mv[l][2 * i] = cur_->mv[l][2 * i + 1] = 0;
      }
    }
  if (t == 25) {
    pcm_mb(b);
    return;
  }
  const int left = mbx_ > 0 ? addr_ - 1 : -1, top = mby_ > 0 ? addr_ - mb_w : -1;
  const int topright = mby_ > 0 && mbx_ + 1 < mb_w ? addr_ - mb_w + 1 : -1;
  const int topleft = mby_ > 0 && mbx_ > 0 ? addr_ - mb_w - 1 : -1;
  const bool avA = intra_avail(left), avB = intra_avail(top), avC = intra_avail(topright),
             avD = intra_avail(topleft);
  const bool i16 = t != 0;
  bool t8 = false;
  int cbp, pred16 = 0;
  int modes[16];
  if (!i16) {
    m.inxn = 1;
    if (pps->transform_8x8) t8 = b.u1();
    const Tables& T = tables();
    // Intra4x4PredMode / Intra8x8PredMode prediction (8.3.1.1, 8.3.2.1)
    auto neighbour_mode = [&](int bx, int by, bool is_left, bool* dc) -> int {
      if (bx >= 0 && by >= 0) return m.ipred[by * 4 + bx];
      int a = is_left ? left : top;
      if (!mb_avail(a) || (!mbs_[a].intra && pps->constrained_intra)) {
        *dc = true;
        return 2;
      }
      const MbInfo& n = mbs_[a];
      if (!n.inxn) return 2;
      return is_left ? n.ipred[by * 4 + 3] : n.ipred[12 + bx];
    };
    int nblk = t8 ? 4 : 16;
    for (int k = 0; k < nblk; ++k) {
      int bx = t8 ? 2 * (k & 1) : T.blk_x[k], by = t8 ? 2 * (k >> 1) : T.blk_y[k];
      bool dc = false;
      int ma = neighbour_mode(bx > 0 ? bx - 1 : -1, by, true, &dc);
      int mb = neighbour_mode(bx, by > 0 ? by - 1 : -1, false, &dc);
      int pred = dc ? 2 : std::min(ma, mb);
      int mode = pred;
      if (!b.u1()) {
        int rem = (int)b.u(3);
        mode = rem < pred ? rem : rem + 1;
      }
      modes[k] = mode;
      if (t8) {
        for (int y = 0; y < 2; ++y)
          for (int x = 0; x < 2; ++x) m.ipred[(by + y) * 4 + bx + x] = (int8_t)mode;
      } else {
        m.ipred[by * 4 + bx] = (int8_t)mode;
      }
    }
  } else {
    pred16 = (t - 1) % 4;
  }
  int chroma_mode = (int)b.ue();
  if (chroma_mode > 3) fail("intra_chroma_pred_mode out of range");
  if (!i16) {
    uint32_t code = b.ue();
    if (code > 47) fail("coded_block_pattern out of range");
    cbp = kIntraCbp[code];
  } else {
    cbp = (((t - 1) / 4) % 3) << 4 | (t >= 13 ? 15 : 0);
  }
  m.t8 = t8;
  if (cbp || i16) {
    int dqp = b.se();
    if (dqp < -26 || dqp > 25) fail("mb_qp_delta out of range");
    qp_ = (qp_ + dqp + 52) % 52;
  }
  m.qp = qp_;
  residual(b, cbp, i16, t8);
  // reconstruction: each block's prediction reads the ones before it
  if (i16) {
    intra16x16(pred16, avA, avB, avD);
    add_luma_residual(true, false);
  } else if (t8) {
    for (int k = 0; k < 4; ++k) {
      intra8x8(k, modes[k], avA, avB, avC, avD);
      if (co_.luma_coded & (1 << (4 * k))) {
        int d[64];
        scale8(co_.luma8[k], qp_, d);
        idct8_add(cur_->plane[0].data() + (size_t)(16 * mby_ + 8 * (k >> 1)) * 16 * mb_w +
                      16 * mbx_ + 8 * (k & 1),
                  16 * mb_w, d);
      }
    }
  } else {
    const Tables& T = tables();
    for (int k = 0; k < 16; ++k) {
      intra4x4(k, modes[k], avA, avB, avC, avD);
      int bx = T.blk_x[k], by = T.blk_y[k];
      if (co_.luma_coded & (1 << (by * 4 + bx))) {
        int d[16];
        scale4(co_.luma[by * 4 + bx], qp_, false, 0, d);
        idct4_add(cur_->plane[0].data() + (size_t)(16 * mby_ + 4 * by) * 16 * mb_w +
                      16 * mbx_ + 4 * bx,
                  16 * mb_w, d);
      }
    }
  }
  intra_chroma(chroma_mode, avA, avB, avD);
  add_chroma_residual();
}

void Decoder::pcm_mb(Bits& b) {
  MbInfo& m = mbs_[addr_];
  m.pcm = 1;
  m.qp = 0;
  m.nz = 0xFFFF;
  std::memset(m.tc, 16, sizeof(m.tc));
  while (!b.aligned())
    if (b.u1()) fail("a pcm_alignment_zero_bit is 1");
  const int yp = 16 * mb_w, cp = 8 * mb_w;
  uint8_t* y = cur_->plane[0].data() + (size_t)16 * mby_ * yp + 16 * mbx_;
  for (int r = 0; r < 16; ++r)
    for (int c = 0; c < 16; ++c) y[r * yp + c] = (uint8_t)b.u(8);
  for (int k = 1; k < 3; ++k) {
    uint8_t* p = cur_->plane[k].data() + (size_t)8 * mby_ * cp + 8 * mbx_;
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) p[r * cp + c] = (uint8_t)b.u(8);
  }
}

void Decoder::inter_mb(Bits& b, int t) {
  MbInfo& m = mbs_[addr_];
  const bool is_b = s_->type == 1;
  const MbTypeInfo ti = is_b ? kBTypes[t] : kPTypes[t];
  const bool ref0 = !is_b && t == 4;  // P_8x8ref0
  int ref[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
  int mvd[2][16][2];
  std::memset(mvd, 0, sizeof(mvd));
  int sub[4] = {0, 0, 0, 0};
  const int gx0 = 4 * mbx_, gy0 = 4 * mby_;
  auto read_ref = [&](int l) {
    int r = b.te(s_->num_ref[l] - 1);
    if (r >= s_->num_ref[l]) fail("ref_idx out of range");
    return r;
  };
  bool small = false;  // a sub-macroblock partition smaller than 8x8
  if (ti.shape == kShapeDirect) {
    direct(0, 3);
  } else if (ti.shape == kShape8x8) {
    for (int i = 0; i < 4; ++i) {
      sub[i] = (int)b.ue();
      if (sub[i] >= (is_b ? 13 : 4)) fail("sub_mb_type out of range");
    }
    auto si = [&](int i) { return is_b ? kBSub[sub[i]] : kPSub[sub[i]]; };
    for (int l = 0; l < 2; ++l)
      for (int i = 0; i < 4; ++i)
        if ((si(i).pred & (1 << l)) && s_->num_ref[l] > 1 && !ref0) ref[l][i] = read_ref(l);
    for (int l = 0; l < 2; ++l)
      for (int i = 0; i < 4; ++i)
        if (si(i).pred & (1 << l)) {
          int n = (2 / si(i).w) * (2 / si(i).h);
          for (int j = 0; j < n; ++j) {
            mvd[l][4 * i + j][0] = b.se();
            mvd[l][4 * i + j][1] = b.se();
          }
        }
    for (int i = 0; i < 4; ++i) {
      SubInfo u = si(i);
      if (u.pred == 0) {
        if (!sps->direct_8x8) small = true;
        direct(i, i);
        continue;
      }
      if (u.w * u.h < 4) small = true;
      int n = (2 / u.w) * (2 / u.h);
      for (int j = 0; j < n; ++j) {
        int gx = gx0 + 2 * (i & 1) + (u.w == 1 ? (j & 1) : 0);
        int gy = gy0 + 2 * (i >> 1) + (u.h == 1 ? (u.w == 1 ? j >> 1 : j) : 0);
        for (int l = 0; l < 2; ++l) {
          if (u.pred & (1 << l)) {
            int mx, my;
            mvpred(l, ref[l][i], gx, gy, u.w, kShape8x8, 0, &mx, &my);
            set_motion(gx, gy, u.w, u.h, l, ref[l][i], mx + mvd[l][4 * i + j][0],
                       my + mvd[l][4 * i + j][1]);
          } else {
            set_motion(gx, gy, u.w, u.h, l, -1, 0, 0);
          }
        }
        for (int y = 0; y < u.h; ++y)
          for (int x = 0; x < u.w; ++x) done_ |= 1 << ((gy - gy0 + y) * 4 + gx - gx0 + x);
      }
    }
  } else {
    int parts = ti.shape == kShape16x16 ? 1 : 2;
    for (int l = 0; l < 2; ++l)
      for (int p = 0; p < parts; ++p)
        if ((ti.pred[p] & (1 << l)) && s_->num_ref[l] > 1) ref[l][p] = read_ref(l);
    for (int l = 0; l < 2; ++l)
      for (int p = 0; p < parts; ++p)
        if (ti.pred[p] & (1 << l)) {
          mvd[l][p][0] = b.se();
          mvd[l][p][1] = b.se();
        }
    for (int p = 0; p < parts; ++p) {
      int pw = ti.shape == kShape8x16 ? 2 : 4, ph = ti.shape == kShape16x8 ? 2 : 4;
      int gx = gx0 + (ti.shape == kShape8x16 ? 2 * p : 0);
      int gy = gy0 + (ti.shape == kShape16x8 ? 2 * p : 0);
      for (int l = 0; l < 2; ++l) {
        if (ti.pred[p] & (1 << l)) {
          int mx, my;
          mvpred(l, ref[l][p], gx, gy, pw, ti.shape, p, &mx, &my);
          set_motion(gx, gy, pw, ph, l, ref[l][p], mx + mvd[l][p][0], my + mvd[l][p][1]);
        } else {
          set_motion(gx, gy, pw, ph, l, -1, 0, 0);
        }
      }
      for (int y = 0; y < ph; ++y)
        for (int x = 0; x < pw; ++x) done_ |= 1 << ((gy - gy0 + y) * 4 + gx - gx0 + x);
    }
  }
  uint32_t code = b.ue();
  if (code > 47) fail("coded_block_pattern out of range");
  int cbp = kInterCbp[code];
  bool t8 = false;
  if ((cbp & 15) && pps->transform_8x8 && !small &&
      (ti.shape != kShapeDirect || sps->direct_8x8))
    t8 = b.u1();
  m.t8 = t8;
  if (cbp) {
    int dqp = b.se();
    if (dqp < -26 || dqp > 25) fail("mb_qp_delta out of range");
    qp_ = (qp_ + dqp + 52) % 52;
  }
  m.qp = qp_;
  residual(b, cbp, false, t8);
  // prediction, partition by partition, then the residual
  if (ti.shape == kShape16x16) {
    mc(gx0, gy0, 4, 4);
  } else if (ti.shape == kShape16x8) {
    mc(gx0, gy0, 4, 2);
    mc(gx0, gy0 + 2, 4, 2);
  } else if (ti.shape == kShape8x16) {
    mc(gx0, gy0, 2, 4);
    mc(gx0 + 2, gy0, 2, 4);
  } else {
    for (int i = 0; i < 4; ++i) {
      int x0 = gx0 + 2 * (i & 1), y0 = gy0 + 2 * (i >> 1);
      SubInfo u = ti.shape == kShapeDirect ? SubInfo{2, 2, 0}
                                           : (is_b ? kBSub[sub[i]] : kPSub[sub[i]]);
      if (u.pred == 0) u.w = u.h = sps->direct_8x8 ? 2 : 1;
      for (int y = 0; y < 2; y += u.h)
        for (int x = 0; x < 2; x += u.w) mc(x0 + x, y0 + y, u.w, u.h);
    }
  }
  add_luma_residual(false, t8);
  add_chroma_residual();
}

// ---- residual (7.3.5.3, 9.2) --------------------------------------------

int Decoder::residual_block(Bits& b, int nc, int max_coeff, int* out) {
  const Tables& T = tables();
  int sym;
  if (nc == -1) {
    sym = T.chroma_dc_token.read(b, "coeff_token");
  } else if (nc < 8) {
    sym = T.coeff_token[nc < 2 ? 0 : nc < 4 ? 1 : 2].read(b, "coeff_token");
  } else {
    int c = (int)b.u(6);
    if (c == 3) {
      sym = 0;
    } else {
      int total = (c >> 2) + 1, t1 = c & 3;
      if (t1 > total) fail("an invalid coeff_token code");
      sym = 4 * total + t1;
    }
  }
  const int total = sym >> 2, t1 = sym & 3;
  for (int k = 0; k < max_coeff; ++k) out[k] = 0;
  if (total == 0) return 0;
  if (total > max_coeff) fail("more coefficients than the block holds");
  int level[16];
  int suffix_len = total > 10 && t1 < 3 ? 1 : 0;
  for (int i = 0; i < total; ++i) {
    if (i < t1) {
      level[i] = b.u1() ? -1 : 1;
      continue;
    }
    uint32_t w = b.show(32);
    if (w == 0) fail("a level_prefix of more than 31 bits");
    int prefix = __builtin_clz(w);
    b.skip(prefix + 1);
    b.check();
    int code = std::min(15, prefix) << suffix_len;
    if (suffix_len > 0 || prefix >= 14) {
      int size = prefix == 14 && suffix_len == 0 ? 4 : prefix >= 15 ? prefix - 3 : suffix_len;
      code += (int)b.u(size);
    }
    if (prefix >= 15 && suffix_len == 0) code += 15;
    if (prefix >= 16) code += (1 << (prefix - 3)) - 4096;
    if (i == t1 && t1 < 3) code += 2;
    level[i] = code & 1 ? (-code - 1) >> 1 : (code + 2) >> 1;
    if (suffix_len == 0) suffix_len = 1;
    if (std::abs(level[i]) > (3 << (suffix_len - 1)) && suffix_len < 6) ++suffix_len;
  }
  int zeros = 0;
  if (total < max_coeff) {
    zeros = nc == -1 ? T.chroma_dc_zeros[total - 1].read(b, "total_zeros")
                     : T.total_zeros[total - 1].read(b, "total_zeros");
    if (total + zeros > max_coeff) fail("total_zeros past the end of the block");
  }
  int run[16];
  for (int i = 0; i < total - 1; ++i) {
    run[i] = zeros > 0 ? T.run_before[std::min(zeros, 7) - 1].read(b, "run_before") : 0;
    if (run[i] > zeros) fail("run_before past total_zeros");
    zeros -= run[i];
  }
  run[total - 1] = zeros;
  int pos = -1;
  for (int i = total - 1; i >= 0; --i) {
    pos += run[i] + 1;
    out[pos] = level[i];
  }
  return total;
}

int Decoder::nc_luma(int bx, int by) const {
  const MbInfo& m = mbs_[addr_];
  int na = -1, nb = -1;
  if (bx > 0)
    na = m.tc[by * 4 + bx - 1];
  else if (mbx_ > 0 && mb_avail(addr_ - 1))
    na = mbs_[addr_ - 1].tc[by * 4 + 3];
  if (by > 0)
    nb = m.tc[(by - 1) * 4 + bx];
  else if (mby_ > 0 && mb_avail(addr_ - mb_w))
    nb = mbs_[addr_ - mb_w].tc[12 + bx];
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  return na >= 0 ? na : nb >= 0 ? nb : 0;
}

int Decoder::nc_chroma(int c, int bx, int by) const {
  const MbInfo& m = mbs_[addr_];
  const int base = 16 + 4 * c;
  int na = -1, nb = -1;
  if (bx > 0)
    na = m.tc[base + by * 2];
  else if (mbx_ > 0 && mb_avail(addr_ - 1))
    na = mbs_[addr_ - 1].tc[base + by * 2 + 1];
  if (by > 0)
    nb = m.tc[base + bx];
  else if (mby_ > 0 && mb_avail(addr_ - mb_w))
    nb = mbs_[addr_ - mb_w].tc[base + 2 + bx];
  if (na >= 0 && nb >= 0) return (na + nb + 1) >> 1;
  return na >= 0 ? na : nb >= 0 ? nb : 0;
}

void Decoder::residual(Bits& b, int cbp, bool i16, bool t8) {
  const Tables& T = tables();
  MbInfo& m = mbs_[addr_];
  co_.luma_coded = 0;
  co_.cac_coded[0] = co_.cac_coded[1] = 0;
  co_.dc_coded = co_.cdc_coded = false;
  int scan[16];
  if (i16) {
    int total = residual_block(b, nc_luma(0, 0), 16, scan);
    for (int k = 0; k < 16; ++k) co_.dc[kZigzag4[k]] = scan[k];
    co_.dc_coded = total > 0;
  }
  for (int b8 = 0; b8 < 4; ++b8) {
    if (t8) std::memset(co_.luma8[b8], 0, sizeof(co_.luma8[b8]));
    for (int i4 = 0; i4 < 4; ++i4) {
      int blk = 4 * b8 + i4, bx = T.blk_x[blk], by = T.blk_y[blk], r = by * 4 + bx;
      if (!t8) std::memset(co_.luma[r], 0, sizeof(co_.luma[r]));
      if (!(cbp & (1 << b8))) continue;
      int total;
      if (t8) {
        total = residual_block(b, nc_luma(bx, by), 16, scan);
        for (int k = 0; k < 16; ++k)
          if (scan[k]) co_.luma8[b8][kZigzag8[4 * k + i4]] = scan[k];
        if (total) co_.luma_coded |= 1 << (4 * b8);
      } else if (i16) {
        total = residual_block(b, nc_luma(bx, by), 15, scan);
        for (int k = 0; k < 15; ++k) co_.luma[r][kZigzag4[k + 1]] = scan[k];
        if (total) co_.luma_coded |= 1 << r;
      } else {
        total = residual_block(b, nc_luma(bx, by), 16, scan);
        for (int k = 0; k < 16; ++k) co_.luma[r][kZigzag4[k]] = scan[k];
        if (total) co_.luma_coded |= 1 << r;
      }
      m.tc[r] = (uint8_t)total;
    }
  }
  // the deblocking filter's "contains non-zero transform coefficients":
  // per 8x8 block under the 8x8 transform (8.7.2.1)
  uint16_t nz = 0;
  for (int r = 0; r < 16; ++r)
    if (m.tc[r]) nz |= 1 << r;
  if (t8) {
    uint16_t nz8 = 0;
    for (int b8 = 0; b8 < 4; ++b8)
      if (co_.luma_coded & (1 << (4 * b8))) {
        int x = 2 * (b8 & 1), y = 2 * (b8 >> 1);
        nz8 |= (uint16_t)((1 << (y * 4 + x)) | (1 << (y * 4 + x + 1)) | (1 << (y * 4 + x + 4)) |
                          (1 << (y * 4 + x + 5)));
      }
    nz = nz8;
  }
  m.nz = nz;
  std::memset(co_.cdc, 0, sizeof(co_.cdc));
  std::memset(co_.cac, 0, sizeof(co_.cac));
  if (cbp >> 4) {
    for (int c = 0; c < 2; ++c) {
      int total = residual_block(b, -1, 4, scan);
      for (int k = 0; k < 4; ++k) co_.cdc[c][k] = scan[k];
      if (total) co_.cdc_coded = true;
    }
  }
  if ((cbp >> 4) & 2) {
    for (int c = 0; c < 2; ++c)
      for (int blk = 0; blk < 4; ++blk) {
        int total = residual_block(b, nc_chroma(c, blk & 1, blk >> 1), 15, scan);
        for (int k = 0; k < 15; ++k) co_.cac[c][blk][kZigzag4[k + 1]] = scan[k];
        m.tc[16 + 4 * c + blk] = (uint8_t)total;
        if (total) co_.cac_coded[c] |= 1 << blk;
      }
  }
}

// ---- motion vectors (8.4.1) ---------------------------------------------

// the motion of the 4x4 block at (gx, gy) of the picture's 4x4 grid as a
// neighbour of the current partition (6.4.11.7): unavailable outside the
// picture, in another slice, or later in decoding order; an intra block or
// a list the block does not use gives reference -1 and vector 0
Nb Decoder::nb(int list, int gx, int gy) const {
  if (gx < 0 || gy < 0 || gx >= w4) return {false, -1, 0, 0};
  int addr = (gy >> 2) * mb_w + (gx >> 2);
  if (addr == addr_) {
    if (!(done_ & (1 << ((gy & 3) * 4 + (gx & 3))))) return {false, -1, 0, 0};
  } else if (addr > addr_ || mbs_[addr].slice != slice_) {
    return {false, -1, 0, 0};
  } else if (mbs_[addr].intra) {
    return {true, -1, 0, 0};
  }
  int i = gy * w4 + gx;
  int r = cur_->ref[list][i];
  if (r < 0) return {true, -1, 0, 0};
  return {true, r, cur_->mv[list][2 * i], cur_->mv[list][2 * i + 1]};
}

void Decoder::mvpred(int list, int ref, int gx, int gy, int pw, int shape, int part,
                     int* mx, int* my) const {
  Nb a = nb(list, gx - 1, gy), b = nb(list, gx, gy - 1), c = nb(list, gx + pw, gy - 1);
  if (!c.avail) c = nb(list, gx - 1, gy - 1);
  // directional prediction of 16x8 and 8x16 partitions (8.4.1.3)
  if (shape == kShape16x8) {
    if (part == 0 && b.ref == ref) {
      *mx = b.x, *my = b.y;
      return;
    }
    if (part == 1 && a.ref == ref) {
      *mx = a.x, *my = a.y;
      return;
    }
  } else if (shape == kShape8x16) {
    if (part == 0 && a.ref == ref) {
      *mx = a.x, *my = a.y;
      return;
    }
    if (part == 1 && c.ref == ref) {
      *mx = c.x, *my = c.y;
      return;
    }
  }
  // median (8.4.1.3.1)
  if (!b.avail && !c.avail && a.avail) b = c = a;
  int matches = (a.ref == ref) + (b.ref == ref) + (c.ref == ref);
  if (matches == 1) {
    const Nb& n = a.ref == ref ? a : b.ref == ref ? b : c;
    *mx = n.x, *my = n.y;
    return;
  }
  *mx = median(a.x, b.x, c.x);
  *my = median(a.y, b.y, c.y);
}

void Decoder::set_motion(int gx, int gy, int pw, int ph, int list, int ref, int mx, int my) {
  int id = -1;
  if (ref >= 0) {
    Picture* p = s_->list[list][ref];
    if (!p) fail("a reference index names a picture that is not in its list");
    id = p->id;
    if (mx < -32768 || mx > 32767 || my < -32768 || my > 32767)
      fail("a motion vector out of range");
  }
  for (int y = 0; y < ph; ++y)
    for (int x = 0; x < pw; ++x) {
      int i = (gy + y) * w4 + gx + x;
      cur_->ref[list][i] = (int8_t)ref;
      cur_->ref_pic[list][i] = id;
      cur_->mv[list][2 * i] = (int16_t)(ref >= 0 ? mx : 0);
      cur_->mv[list][2 * i + 1] = (int16_t)(ref >= 0 ? my : 0);
    }
}

// P_Skip (8.4.1.1)
void Decoder::pskip_motion() {
  const int gx = 4 * mbx_, gy = 4 * mby_;
  Nb a = nb(0, gx - 1, gy), b = nb(0, gx, gy - 1);
  int mx = 0, my = 0;
  if (a.avail && b.avail && !(a.ref == 0 && a.x == 0 && a.y == 0) &&
      !(b.ref == 0 && b.x == 0 && b.y == 0))
    mvpred(0, 0, gx, gy, 4, kShape16x16, 0, &mx, &my);
  set_motion(gx, gy, 4, 4, 0, 0, mx, my);
  set_motion(gx, gy, 4, 4, 1, -1, 0, 0);
  done_ = 0xFFFF;
}

// B_Skip, B_Direct_16x16 and direct 8x8 sub-macroblocks b8_first..b8_last:
// spatial (8.4.1.2.2) or temporal (8.4.1.2.3) direct prediction
void Decoder::direct(int b8_first, int b8_last) {
  const int gx0 = 4 * mbx_, gy0 = 4 * mby_;
  Picture* col = s_->list[1][0];
  if (!col) fail("a direct prediction without a list 1 reference");
  // the co-located 4x4 block's motion: list 0's, else list 1's
  auto colocated = [&](int x, int y, int* ref, int* mvx, int* mvy, int* pic) {
    if (sps->direct_8x8) {  // the 8x8 block's corner
      x = x < 2 ? 0 : 3;
      y = y < 2 ? 0 : 3;
    }
    int i = (gy0 + y) * w4 + gx0 + x;
    int l = col->ref[0][i] >= 0 ? 0 : 1;
    *ref = col->ref[l][i];
    *mvx = col->mv[l][2 * i];
    *mvy = col->mv[l][2 * i + 1];
    *pic = col->ref_pic[l][i];
  };
  if (s_->direct_spatial) {
    int ref[2], mv[2][2] = {{0, 0}, {0, 0}};
    for (int l = 0; l < 2; ++l) {
      Nb a = nb(l, gx0 - 1, gy0), b = nb(l, gx0, gy0 - 1), c = nb(l, gx0 + 4, gy0 - 1);
      if (!c.avail) c = nb(l, gx0 - 1, gy0 - 1);
      // MinPositive over A, B and C
      unsigned r = std::min({(unsigned)a.ref, (unsigned)b.ref, (unsigned)c.ref});
      ref[l] = r > 31 ? -1 : (int)r;
    }
    bool zero = ref[0] < 0 && ref[1] < 0;
    if (zero) {
      ref[0] = ref[1] = 0;
    } else {
      for (int l = 0; l < 2; ++l)
        if (ref[l] >= 0) mvpred(l, ref[l], gx0, gy0, 4, kShape16x16, 0, &mv[l][0], &mv[l][1]);
    }
    for (int b8 = b8_first; b8 <= b8_last; ++b8)
      for (int k = 0; k < 4; ++k) {
        int x = 2 * (b8 & 1) + (k & 1), y = 2 * (b8 >> 1) + (k >> 1);
        bool col_zero = false;
        if (!zero && !col->ref_long) {
          int r, mx, my, pic;
          colocated(x, y, &r, &mx, &my, &pic);
          col_zero = r == 0 && mx >= -1 && mx <= 1 && my >= -1 && my <= 1;
        }
        for (int l = 0; l < 2; ++l) {
          if (ref[l] < 0) {
            set_motion(gx0 + x, gy0 + y, 1, 1, l, -1, 0, 0);
          } else if (zero || (ref[l] == 0 && col_zero)) {
            set_motion(gx0 + x, gy0 + y, 1, 1, l, ref[l], 0, 0);
          } else {
            set_motion(gx0 + x, gy0 + y, 1, 1, l, ref[l], mv[l][0], mv[l][1]);
          }
        }
        done_ |= 1 << (y * 4 + x);
      }
    return;
  }
  for (int b8 = b8_first; b8 <= b8_last; ++b8)
    for (int k = 0; k < 4; ++k) {
      int x = 2 * (b8 & 1) + (k & 1), y = 2 * (b8 >> 1) + (k >> 1);
      int r, mx, my, pic;
      colocated(x, y, &r, &mx, &my, &pic);
      int ref0 = 0;
      if (r < 0) {  // an intra co-located block
        mx = my = 0;
      } else {
        ref0 = -1;
        for (int i = 0; i < s_->num_ref[0]; ++i)
          if (s_->list[0][i] && s_->list[0][i]->id == pic) {
            ref0 = i;
            break;
          }
        if (ref0 < 0) fail("temporal direct: the co-located block's reference is not in list 0");
      }
      int dsf = s_->dsf[ref0];
      int m0x = (dsf * mx + 128) >> 8, m0y = (dsf * my + 128) >> 8;
      set_motion(gx0 + x, gy0 + y, 1, 1, 0, ref0, m0x, m0y);
      set_motion(gx0 + x, gy0 + y, 1, 1, 1, 0, m0x - mx, m0y - my);
      done_ |= 1 << (y * 4 + x);
    }
}

// ---- inter prediction (8.4.2) -------------------------------------------

// luma sample interpolation (8.4.2.2.1) of a w x h block whose full-sample
// position is (xi, yi) and fraction (fx, fy), into dst (pitch 16)
void luma_mc(const uint8_t* plane, int pw, int ph, int xi, int yi, int fx, int fy, int w, int h,
             uint8_t* dst) {
  // the samples from (xi - 2, yi - 2), coordinates clamped into the picture
  uint8_t win[21 * 21];
  const int ws = w + 5;
  for (int y = 0; y < h + 5; ++y) {
    const uint8_t* row = plane + (size_t)clip3(0, ph - 1, yi - 2 + y) * pw;
    int x0 = xi - 2;
    if (x0 >= 0 && x0 + ws <= pw) {
      std::memcpy(win + y * ws, row + x0, ws);
    } else {
      for (int x = 0; x < ws; ++x) win[y * ws + x] = row[clip3(0, pw - 1, x0 + x)];
    }
  }
  const uint8_t* g = win + 2 * ws + 2;  // G, the full sample of (0, 0)
  auto tap = [](int a, int b, int c, int d, int e, int f) {
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
  };
  // b1 (horizontal half sample, unclipped) at (x + 1/2, y)
  auto b1 = [&](int x, int y) {
    const uint8_t* p = g + y * ws + x;
    return tap(p[-2], p[-1], p[0], p[1], p[2], p[3]);
  };
  // h1 (vertical) at (x, y + 1/2)
  auto h1 = [&](int x, int y) {
    const uint8_t* p = g + y * ws + x;
    return tap(p[-2 * ws], p[-ws], p[0], p[ws], p[2 * ws], p[3 * ws]);
  };
  auto j1 = [&](int x, int y) {
    return tap(b1(x, y - 2), b1(x, y - 1), b1(x, y), b1(x, y + 1), b1(x, y + 2), b1(x, y + 3));
  };
  auto half = [](int v) { return (int)clip1((v + 16) >> 5); };
  for (int y = 0; y < h; ++y)
    for (int x = 0; x < w; ++x) {
      int v;
      const int G = g[y * ws + x];
      switch (fy * 4 + fx) {
        case 0: v = G; break;
        case 1: v = (G + half(b1(x, y)) + 1) >> 1; break;                  // a
        case 2: v = half(b1(x, y)); break;                                 // b
        case 3: v = (g[y * ws + x + 1] + half(b1(x, y)) + 1) >> 1; break;  // c
        case 4: v = (G + half(h1(x, y)) + 1) >> 1; break;                  // d
        case 5: v = (half(b1(x, y)) + half(h1(x, y)) + 1) >> 1; break;     // e
        case 6: v = (half(b1(x, y)) + clip1((j1(x, y) + 512) >> 10) + 1) >> 1; break;  // f
        case 7: v = (half(b1(x, y)) + half(h1(x + 1, y)) + 1) >> 1; break;  // g
        case 8: v = half(h1(x, y)); break;                                  // h
        case 9: v = (half(h1(x, y)) + clip1((j1(x, y) + 512) >> 10) + 1) >> 1; break;  // i
        case 10: v = clip1((j1(x, y) + 512) >> 10); break;                              // j
        case 11: v = (clip1((j1(x, y) + 512) >> 10) + half(h1(x + 1, y)) + 1) >> 1; break;  // k
        case 12: v = (g[(y + 1) * ws + x] + half(h1(x, y)) + 1) >> 1; break;  // n
        case 13: v = (half(h1(x, y)) + half(b1(x, y + 1)) + 1) >> 1; break;   // p
        case 14: v = (clip1((j1(x, y) + 512) >> 10) + half(b1(x, y + 1)) + 1) >> 1; break;  // q
        default: v = (half(h1(x + 1, y)) + half(b1(x, y + 1)) + 1) >> 1; break;  // r
      }
      dst[y * 16 + x] = (uint8_t)v;
    }
}

// chroma sample interpolation (8.4.2.2.2), eighth-sample bilinear
void chroma_mc(const uint8_t* plane, int pw, int ph, int xi, int yi, int fx, int fy, int w,
               int h, uint8_t* dst) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* r0 = plane + (size_t)clip3(0, ph - 1, yi + y) * pw;
    const uint8_t* r1 = plane + (size_t)clip3(0, ph - 1, yi + y + 1) * pw;
    for (int x = 0; x < w; ++x) {
      int xa = clip3(0, pw - 1, xi + x), xb = clip3(0, pw - 1, xi + x + 1);
      dst[y * 8 + x] = (uint8_t)(((8 - fx) * (8 - fy) * r0[xa] + fx * (8 - fy) * r0[xb] +
                                  (8 - fx) * fy * r1[xa] + fx * fy * r1[xb] + 32) >>
                                 6);
    }
  }
}

// the prediction of the partition of pw x ph 4x4 blocks at (gx, gy), from
// the motion stored there, with the slice's weighted prediction (8.4.2.3)
void Decoder::mc(int gx, int gy, int pw, int ph) {
  const int i = gy * w4 + gx;
  const int r[2] = {cur_->ref[0][i], cur_->ref[1][i]};
  const int w = 4 * pw, h = 4 * ph, x = 4 * gx, y = 4 * gy;
  const int yp = 16 * mb_w, cp = 8 * mb_w, yh = 16 * mb_h, ch = 8 * mb_h;
  uint8_t pl[2][256], pc[2][2][64];
  for (int l = 0; l < 2; ++l) {
    if (r[l] < 0) continue;
    Picture* ref = s_->list[l][r[l]];
    int mx = cur_->mv[l][2 * i], my = cur_->mv[l][2 * i + 1];
    luma_mc(ref->plane[0].data(), yp, yh, x + (mx >> 2), y + (my >> 2), mx & 3, my & 3, w, h,
            pl[l]);
    for (int c = 0; c < 2; ++c)
      chroma_mc(ref->plane[1 + c].data(), cp, ch, x / 2 + (mx >> 3), y / 2 + (my >> 3), mx & 7,
                my & 7, w / 2, h / 2, pc[l][c]);
  }
  if (r[0] < 0 && r[1] < 0) fail("an inter partition without a reference");
  const bool bi = r[0] >= 0 && r[1] >= 0;
  const int l1 = r[0] >= 0 ? 0 : 1;  // the list of a one-list prediction
  // weights: w0, w1, o0, o1, logWD per component (0 luma, 1 Cb, 2 Cr)
  int wt[3][2], of[3][2], lwd[3];
  int mode = s_->explicit_wp ? 1 : (s_->implicit_wp && bi) ? 2 : 0;
  if (mode == 1) {
    for (int k = 0; k < 3; ++k) {
      lwd[k] = k ? s_->chroma_log2 : s_->luma_log2;
      for (int l = 0; l < 2; ++l) {
        if (r[l] < 0) {
          wt[k][l] = of[k][l] = 0;
          continue;
        }
        wt[k][l] = k ? s_->cw[l][r[l]][k - 1] : s_->lw[l][r[l]];
        of[k][l] = k ? s_->co[l][r[l]][k - 1] : s_->lo[l][r[l]];
      }
    }
  } else if (mode == 2) {
    int w0 = s_->implicit_w0[r[0]][r[1]];
    for (int k = 0; k < 3; ++k) {
      lwd[k] = 5;
      wt[k][0] = w0;
      wt[k][1] = 64 - w0;
      of[k][0] = of[k][1] = 0;
    }
  }
  auto combine = [&](int k, const uint8_t* p0, const uint8_t* p1, int sp, uint8_t* dst, int dp,
                     int bw, int bh) {
    for (int yy = 0; yy < bh; ++yy)
      for (int xx = 0; xx < bw; ++xx) {
        int a = p0 ? p0[yy * sp + xx] : 0, b = p1 ? p1[yy * sp + xx] : 0, v;
        if (mode == 0) {
          v = bi ? (a + b + 1) >> 1 : (p0 ? a : b);
        } else if (bi) {
          v = ((a * wt[k][0] + b * wt[k][1] + (1 << lwd[k])) >> (lwd[k] + 1)) +
              ((of[k][0] + of[k][1] + 1) >> 1);
        } else {
          int s = p0 ? a : b, ww = wt[k][l1], oo = of[k][l1];
          v = lwd[k] >= 1 ? ((s * ww + (1 << (lwd[k] - 1))) >> lwd[k]) + oo : s * ww + oo;
        }
        dst[yy * dp + xx] = clip1(v);
      }
  };
  combine(0, r[0] >= 0 ? pl[0] : nullptr, r[1] >= 0 ? pl[1] : nullptr, 16,
          cur_->plane[0].data() + (size_t)y * yp + x, yp, w, h);
  for (int c = 0; c < 2; ++c)
    combine(1 + c, r[0] >= 0 ? pc[0][c] : nullptr, r[1] >= 0 ? pc[1][c] : nullptr, 8,
            cur_->plane[1 + c].data() + (size_t)(y / 2) * cp + x / 2, cp, w / 2, h / 2);
}

// ---- intra prediction (8.3) ---------------------------------------------

// the directional modes of Intra_4x4 (n = 4) and Intra_8x8 (n = 8) on the
// neighbouring samples: t[x] = p[x, -1] for x in 0..2n-1, l[y] = p[-1, y],
// tl = p[-1, -1] (8.3.1.2, 8.3.2.2.2-10)
void intra_nxn(int n, int mode, const int* t, const int* l, int tl, bool has_top,
               bool has_left, uint8_t* dst, int pitch) {
  auto P = [&](int x, int y) -> int {  // p[x, y] with x or y equal to -1
    if (y < 0) return x < 0 ? tl : t[x];
    return l[y];
  };
  const int last = 2 * n - 1, zmax = 2 * n - 3;
  for (int y = 0; y < n; ++y)
    for (int x = 0; x < n; ++x) {
      int v = 0;
      switch (mode) {
        case 0: v = t[x]; break;
        case 1: v = l[y]; break;
        case 2: {
          int s = 0;
          if (has_top && has_left) {
            for (int k = 0; k < n; ++k) s += t[k] + l[k];
            v = (s + n) >> (n == 4 ? 3 : 4);
          } else if (has_left) {
            for (int k = 0; k < n; ++k) s += l[k];
            v = (s + n / 2) >> (n == 4 ? 2 : 3);
          } else if (has_top) {
            for (int k = 0; k < n; ++k) s += t[k];
            v = (s + n / 2) >> (n == 4 ? 2 : 3);
          } else {
            v = 128;
          }
          break;
        }
        case 3:  // Diagonal_Down_Left
          v = x == n - 1 && y == n - 1 ? (t[last - 1] + 3 * t[last] + 2) >> 2
                                       : (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2;
          break;
        case 4:  // Diagonal_Down_Right
          if (x > y)
            v = (P(x - y - 2, -1) + 2 * P(x - y - 1, -1) + P(x - y, -1) + 2) >> 2;
          else if (x < y)
            v = (P(-1, y - x - 2) + 2 * P(-1, y - x - 1) + P(-1, y - x) + 2) >> 2;
          else
            v = (P(0, -1) + 2 * tl + P(-1, 0) + 2) >> 2;
          break;
        case 5: {  // Vertical_Right
          int z = 2 * x - y;
          if (z >= 0 && !(z & 1))
            v = (P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 1) >> 1;
          else if (z >= 0)
            v = (P(x - (y >> 1) - 2, -1) + 2 * P(x - (y >> 1) - 1, -1) + P(x - (y >> 1), -1) + 2) >> 2;
          else if (z == -1)
            v = (P(-1, 0) + 2 * tl + P(0, -1) + 2) >> 2;
          else
            v = (P(-1, y - 2 * x - 1) + 2 * P(-1, y - 2 * x - 2) + P(-1, y - 2 * x - 3) + 2) >> 2;
          break;
        }
        case 6: {  // Horizontal_Down
          int z = 2 * y - x;
          if (z >= 0 && !(z & 1))
            v = (P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 1) >> 1;
          else if (z >= 0)
            v = (P(-1, y - (x >> 1) - 2) + 2 * P(-1, y - (x >> 1) - 1) + P(-1, y - (x >> 1)) + 2) >> 2;
          else if (z == -1)
            v = (P(-1, 0) + 2 * tl + P(0, -1) + 2) >> 2;
          else
            v = (P(x - 2 * y - 1, -1) + 2 * P(x - 2 * y - 2, -1) + P(x - 2 * y - 3, -1) + 2) >> 2;
          break;
        }
        case 7:  // Vertical_Left
          if (!(y & 1))
            v = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1;
          else
            v = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1] + t[x + (y >> 1) + 2] + 2) >> 2;
          break;
        default: {  // Horizontal_Up
          int z = x + 2 * y;
          if (z < zmax && !(z & 1))
            v = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1;
          else if (z < zmax)
            v = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1] + l[y + (x >> 1) + 2] + 2) >> 2;
          else if (z == zmax)
            v = (l[n - 2] + 3 * l[n - 1] + 2) >> 2;
          else
            v = l[n - 1];
          break;
        }
      }
      dst[y * pitch + x] = (uint8_t)v;
    }
}

// which samples a mode reads: 1 top, 2 left, 4 top-left (DC reads what
// it finds)
const int kNeeds[9] = {1, 2, 0, 1, 7, 7, 7, 1, 2};

void Decoder::intra4x4(int blk, int mode, bool avA, bool avB, bool avC, bool avD) {
  const Tables& T = tables();
  const int bx = T.blk_x[blk], by = T.blk_y[blk];
  const int pitch = 16 * mb_w;
  uint8_t* dst = cur_->plane[0].data() + (size_t)(16 * mby_ + 4 * by) * pitch + 16 * mbx_ + 4 * bx;
  const bool left = bx > 0 || avA, top = by > 0 || avB;
  const bool tl = bx > 0 && by > 0 ? true : bx == 0 && by == 0 ? avD : bx == 0 ? avA : avB;
  bool tr;
  if (by == 0) {
    tr = bx < 3 ? avB : avC;
  } else if (bx == 3) {
    tr = false;
  } else {  // inside the macroblock: decoded already if earlier in z-order
    int nx = bx + 1, ny = by - 1;
    int idx = 4 * ((ny >> 1) * 2 + (nx >> 1)) + (ny & 1) * 2 + (nx & 1);
    tr = idx < blk;
  }
  int need = kNeeds[mode];
  if (((need & 1) && !top) || ((need & 2) && !left) || ((need & 4) && !tl))
    fail("an Intra_4x4 mode whose neighbouring samples are not available");
  int t[8] = {0}, l[4] = {0}, c = 0;
  if (top)
    for (int k = 0; k < 8; ++k) t[k] = k < 4 || tr ? dst[-pitch + k] : dst[-pitch + 3];
  if (left)
    for (int k = 0; k < 4; ++k) l[k] = dst[k * pitch - 1];
  if (tl) c = dst[-pitch - 1];
  intra_nxn(4, mode, t, l, c, top, left, dst, pitch);
}

void Decoder::intra8x8(int b8, int mode, bool avA, bool avB, bool avC, bool avD) {
  const int bx = b8 & 1, by = b8 >> 1;
  const int pitch = 16 * mb_w;
  uint8_t* dst = cur_->plane[0].data() + (size_t)(16 * mby_ + 8 * by) * pitch + 16 * mbx_ + 8 * bx;
  const bool left = bx > 0 || avA, top = by > 0 || avB;
  const bool tl = bx > 0 && by > 0 ? true : bx == 0 && by == 0 ? avD : bx == 0 ? avA : avB;
  const bool tr = by == 0 ? (bx == 0 ? avB : avC) : bx == 0;
  int need = kNeeds[mode];
  if (((need & 1) && !top) || ((need & 2) && !left) || ((need & 4) && !tl))
    fail("an Intra_8x8 mode whose neighbouring samples are not available");
  int t[16] = {0}, l[8] = {0}, c = 0;
  if (top)
    for (int k = 0; k < 16; ++k) t[k] = k < 8 || tr ? dst[-pitch + k] : dst[-pitch + 7];
  if (left)
    for (int k = 0; k < 8; ++k) l[k] = dst[k * pitch - 1];
  if (tl) c = dst[-pitch - 1];
  // reference sample filtering (8.3.2.2.1)
  int ft[16], fl[8], fc = c;
  if (top) {
    ft[0] = tl ? (c + 2 * t[0] + t[1] + 2) >> 2 : (3 * t[0] + t[1] + 2) >> 2;
    for (int k = 1; k < 15; ++k) ft[k] = (t[k - 1] + 2 * t[k] + t[k + 1] + 2) >> 2;
    ft[15] = (t[14] + 3 * t[15] + 2) >> 2;
  }
  if (tl) {
    if (top && left)
      fc = (t[0] + 2 * c + l[0] + 2) >> 2;
    else if (top)
      fc = (3 * c + t[0] + 2) >> 2;
    else if (left)
      fc = (3 * c + l[0] + 2) >> 2;
  }
  if (left) {
    fl[0] = tl ? (c + 2 * l[0] + l[1] + 2) >> 2 : (3 * l[0] + l[1] + 2) >> 2;
    for (int k = 1; k < 7; ++k) fl[k] = (l[k - 1] + 2 * l[k] + l[k + 1] + 2) >> 2;
    fl[7] = (l[6] + 3 * l[7] + 2) >> 2;
  }
  intra_nxn(8, mode, ft, fl, fc, top, left, dst, pitch);
}

void Decoder::intra16x16(int mode, bool avA, bool avB, bool avD) {
  const int pitch = 16 * mb_w;
  uint8_t* dst = cur_->plane[0].data() + (size_t)16 * mby_ * pitch + 16 * mbx_;
  static const int need[4] = {1, 2, 0, 7};
  if (((need[mode] & 1) && !avB) || ((need[mode] & 2) && !avA) || ((need[mode] & 4) && !avD))
    fail("an Intra_16x16 mode whose neighbouring samples are not available");
  int t[16], l[16];
  for (int k = 0; k < 16; ++k) {
    t[k] = avB ? dst[-pitch + k] : 0;
    l[k] = avA ? dst[k * pitch - 1] : 0;
  }
  int dc = 128;
  if (mode == 2) {
    int s = 0;
    for (int k = 0; k < 16; ++k) s += (avB ? t[k] : 0) + (avA ? l[k] : 0);
    dc = avA && avB ? (s + 16) >> 5 : avA || avB ? (s + 8) >> 4 : 128;
  }
  int a = 0, bb = 0, cc = 0;
  if (mode == 3) {
    int c = dst[-pitch - 1], H = 0, V = 0;
    for (int k = 0; k < 8; ++k) {
      H += (k + 1) * (t[8 + k] - (6 - k >= 0 ? t[6 - k] : c));
      V += (k + 1) * (l[8 + k] - (6 - k >= 0 ? l[6 - k] : c));
    }
    a = 16 * (l[15] + t[15]);
    bb = (5 * H + 32) >> 6;
    cc = (5 * V + 32) >> 6;
  }
  for (int y = 0; y < 16; ++y)
    for (int x = 0; x < 16; ++x) {
      int v = mode == 0 ? t[x] : mode == 1 ? l[y] : mode == 2 ? dc
              : clip1((a + bb * (x - 7) + cc * (y - 7) + 16) >> 5);
      dst[y * pitch + x] = (uint8_t)v;
    }
}

void Decoder::intra_chroma(int mode, bool avA, bool avB, bool avD) {
  // modes: 0 DC, 1 horizontal, 2 vertical, 3 plane (8.3.4)
  static const int need[4] = {0, 2, 1, 7};
  if (((need[mode] & 1) && !avB) || ((need[mode] & 2) && !avA) || ((need[mode] & 4) && !avD))
    fail("an intra chroma mode whose neighbouring samples are not available");
  const int pitch = 8 * mb_w;
  for (int c = 0; c < 2; ++c) {
    uint8_t* dst = cur_->plane[1 + c].data() + (size_t)8 * mby_ * pitch + 8 * mbx_;
    int t[8], l[8];
    for (int k = 0; k < 8; ++k) {
      t[k] = avB ? dst[-pitch + k] : 0;
      l[k] = avA ? dst[k * pitch - 1] : 0;
    }
    if (mode == 0) {
      for (int blk = 0; blk < 4; ++blk) {
        int xo = 4 * (blk & 1), yo = 4 * (blk >> 1);
        int st = 0, sl = 0;
        for (int k = 0; k < 4; ++k) {
          st += t[xo + k];
          sl += l[yo + k];
        }
        int v;
        if ((xo == 0 && yo == 0) || (xo > 0 && yo > 0)) {
          v = avA && avB ? (st + sl + 4) >> 3 : avA ? (sl + 2) >> 2 : avB ? (st + 2) >> 2 : 128;
        } else if (xo > 0) {
          v = avB ? (st + 2) >> 2 : avA ? (sl + 2) >> 2 : 128;
        } else {
          v = avA ? (sl + 2) >> 2 : avB ? (st + 2) >> 2 : 128;
        }
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) dst[(yo + y) * pitch + xo + x] = (uint8_t)v;
      }
      continue;
    }
    int a = 0, bb = 0, cc = 0;
    if (mode == 3) {
      int corner = dst[-pitch - 1], H = 0, V = 0;
      for (int k = 0; k < 4; ++k) {
        H += (k + 1) * (t[4 + k] - (2 - k >= 0 ? t[2 - k] : corner));
        V += (k + 1) * (l[4 + k] - (2 - k >= 0 ? l[2 - k] : corner));
      }
      a = 16 * (l[7] + t[7]);
      bb = (34 * H + 32) >> 6;
      cc = (34 * V + 32) >> 6;
    }
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x) {
        int v = mode == 1 ? l[y] : mode == 2 ? t[x]
                : clip1((a + bb * (x - 3) + cc * (y - 3) + 16) >> 5);
        dst[y * pitch + x] = (uint8_t)v;
      }
  }
}

// ---- residual reconstruction (8.5) --------------------------------------

void Decoder::add_luma_residual(bool i16, bool t8) {
  const int pitch = 16 * mb_w;
  uint8_t* base = cur_->plane[0].data() + (size_t)16 * mby_ * pitch + 16 * mbx_;
  if (t8) {
    for (int b8 = 0; b8 < 4; ++b8) {
      if (!(co_.luma_coded & (1 << (4 * b8)))) continue;
      int d[64];
      scale8(co_.luma8[b8], qp_, d);
      idct8_add(base + 8 * (b8 >> 1) * pitch + 8 * (b8 & 1), pitch, d);
    }
    return;
  }
  int dcy[16] = {0};
  if (i16 && co_.dc_coded) {  // 8.5.10: Hadamard, then scaling
    int f[16], g[16];
    const int* c = co_.dc;
    for (int i = 0; i < 4; ++i) {
      const int* r = c + 4 * i;
      f[4 * i] = r[0] + r[1] + r[2] + r[3];
      f[4 * i + 1] = r[0] + r[1] - r[2] - r[3];
      f[4 * i + 2] = r[0] - r[1] - r[2] + r[3];
      f[4 * i + 3] = r[0] - r[1] + r[2] - r[3];
    }
    for (int j = 0; j < 4; ++j) {
      g[j] = f[j] + f[4 + j] + f[8 + j] + f[12 + j];
      g[4 + j] = f[j] + f[4 + j] - f[8 + j] - f[12 + j];
      g[8 + j] = f[j] - f[4 + j] - f[8 + j] + f[12 + j];
      g[12 + j] = f[j] - f[4 + j] + f[8 + j] - f[12 + j];
    }
    const int ls = 16 * kNorm4[qp_ % 6][0], q6 = qp_ / 6;
    for (int k = 0; k < 16; ++k)
      dcy[k] = qp_ >= 36 ? (g[k] * ls) << (q6 - 6) : (g[k] * ls + (1 << (5 - q6))) >> (6 - q6);
  }
  for (int r = 0; r < 16; ++r) {
    bool coded = co_.luma_coded & (1 << r);
    if (!coded && !(i16 && dcy[r])) continue;
    int d[16];
    scale4(co_.luma[r], qp_, i16, dcy[r], d);
    idct4_add(base + 4 * (r >> 2) * pitch + 4 * (r & 3), pitch, d);
  }
}

void Decoder::add_chroma_residual() {
  const int pitch = 8 * mb_w;
  for (int c = 0; c < 2; ++c) {
    const int qpc = chroma_qp(qp_, s_->chroma_qp_offset[c]);
    int dcc[4] = {0, 0, 0, 0};
    if (co_.cdc_coded) {  // 8.5.11
      const int* v = co_.cdc[c];
      int f[4] = {v[0] + v[1] + v[2] + v[3], v[0] - v[1] + v[2] - v[3],
                  v[0] + v[1] - v[2] - v[3], v[0] - v[1] - v[2] + v[3]};
      const int ls = 16 * kNorm4[qpc % 6][0];
      for (int k = 0; k < 4; ++k) dcc[k] = ((f[k] * ls) << (qpc / 6)) >> 5;
    }
    uint8_t* base = cur_->plane[1 + c].data() + (size_t)8 * mby_ * pitch + 8 * mbx_;
    for (int blk = 0; blk < 4; ++blk) {
      if (!(co_.cac_coded[c] & (1 << blk)) && !dcc[blk]) continue;
      int d[16];
      scale4(co_.cac[c][blk], qpc, true, dcc[blk], d);
      idct4_add(base + 4 * (blk >> 1) * pitch + 4 * (blk & 1), pitch, d);
    }
  }
}

// ---- deblocking filter (8.7) --------------------------------------------

// one line of samples across an edge: q[0] is q0, q[-step] is p0
template <bool kChroma>
inline void filter_line(uint8_t* q, int step, int bs, int alpha, int beta, int tc0) {
  const int p0 = q[-step], p1 = q[-2 * step], q0 = q[0], q1 = q[step];
  if (!(std::abs(p0 - q0) < alpha && std::abs(p1 - p0) < beta && std::abs(q1 - q0) < beta))
    return;
  if (bs < 4) {
    if (kChroma) {
      int tc = tc0 + 1;
      int d = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
      q[-step] = clip1(p0 + d);
      q[0] = clip1(q0 - d);
      return;
    }
    const int p2 = q[-3 * step], q2 = q[2 * step];
    const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
    int tc = tc0 + (ap < beta) + (aq < beta);
    int d = clip3(-tc, tc, (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3);
    q[-step] = clip1(p0 + d);
    q[0] = clip1(q0 - d);
    if (ap < beta) q[-2 * step] = (uint8_t)(p1 + clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - (p1 << 1)) >> 1));
    if (aq < beta) q[step] = (uint8_t)(q1 + clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - (q1 << 1)) >> 1));
    return;
  }
  if (kChroma) {
    q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
    q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
    return;
  }
  const int p2 = q[-3 * step], q2 = q[2 * step], p3 = q[-4 * step], q3 = q[3 * step];
  const int ap = std::abs(p2 - p0), aq = std::abs(q2 - q0);
  const bool near = std::abs(p0 - q0) < ((alpha >> 2) + 2);
  if (ap < beta && near) {
    q[-step] = (uint8_t)((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3);
    q[-2 * step] = (uint8_t)((p2 + p1 + p0 + q0 + 2) >> 2);
    q[-3 * step] = (uint8_t)((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3);
  } else {
    q[-step] = (uint8_t)((2 * p1 + p0 + q1 + 2) >> 2);
  }
  if (aq < beta && near) {
    q[0] = (uint8_t)((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3);
    q[step] = (uint8_t)((p0 + q0 + q1 + q2 + 2) >> 2);
    q[2 * step] = (uint8_t)((2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3);
  } else {
    q[0] = (uint8_t)((2 * q1 + q0 + p1 + 2) >> 2);
  }
}

void Decoder::deblock() {
  const int yp = 16 * mb_w, cp = 8 * mb_w;
  // bS 1 test (8.7.2.1) as ffmpeg's check_mv makes it: the referenced
  // pictures and vectors of the blocks i (p) and j (q)
  auto mv_differ = [&](int i, int j, int lists) -> int {
    const int* rp0 = &cur_->ref_pic[0][0];
    const int* rp1 = &cur_->ref_pic[1][0];
    const int16_t* m0 = cur_->mv[0].data();
    const int16_t* m1 = cur_->mv[1].data();
    auto far = [](const int16_t* a, int ia, const int16_t* b, int ib) {
      return std::abs(a[2 * ia] - b[2 * ib]) >= 4 || std::abs(a[2 * ia + 1] - b[2 * ib + 1]) >= 4;
    };
    int v = rp0[i] != rp0[j];
    if (!v && rp0[i] != -1) v = far(m0, i, m0, j);
    if (lists == 2) {
      if (!v) v = rp1[i] != rp1[j] || far(m1, i, m1, j);
      if (v) {
        if (rp0[i] != rp1[j] || rp1[i] != rp0[j]) return 1;
        return far(m0, i, m1, j) || far(m1, i, m0, j);
      }
    }
    return v;
  };
  for (int addr = 0; addr < mb_w * mb_h; ++addr) {
    const MbInfo& q = mbs_[addr];
    if (q.slice < 0) fail("a picture whose macroblocks are not all decoded");
    const SliceHdr& s = slices_[q.slice];
    if (s.deblock_idc == 1) continue;
    const int mx = addr % mb_w, my = addr / mb_w;
    const int lists = s.type == 1 ? 2 : 1;
    for (int dir = 0; dir < 2; ++dir) {  // vertical edges, then horizontal
      const int naddr = dir == 0 ? addr - 1 : addr - mb_w;
      const bool has_n = (dir == 0 ? mx > 0 : my > 0) &&
                         (s.deblock_idc != 2 || mbs_[naddr].slice == q.slice);
      for (int e = has_n ? 0 : 1; e < 4; ++e) {
        if (e & 1 && q.t8) continue;
        const MbInfo& p = e == 0 ? mbs_[naddr] : q;
        int bs[4];
        bool any = false;
        for (int k = 0; k < 4; ++k) {
          // the 4x4 blocks on each side, as indices of the 4x4 grid
          int qx = dir == 0 ? e : k, qy = dir == 0 ? k : e;
          int qi = (4 * my + qy) * w4 + 4 * mx + qx;
          int pi = dir == 0 ? qi - 1 : qi - w4;
          int pr = dir == 0 ? (e == 0 ? qy * 4 + 3 : qy * 4 + qx - 1)
                            : (e == 0 ? 12 + qx : (qy - 1) * 4 + qx);
          if (p.intra || q.intra)
            bs[k] = e == 0 ? 4 : 3;
          else if ((q.nz >> (qy * 4 + qx) & 1) || (p.nz >> pr & 1))
            bs[k] = 2;
          else
            bs[k] = mv_differ(pi, qi, lists);
          any |= bs[k] != 0;
        }
        if (!any) continue;
        // luma
        {
          const int qpav = (p.qp + q.qp + 1) >> 1;
          const int ia = clip3(0, 51, qpav + s.alpha_off), ib = clip3(0, 51, qpav + s.beta_off);
          const int alpha = kAlpha[ia], beta = kBeta[ib];
          uint8_t* base = cur_->plane[0].data() + (size_t)16 * my * yp + 16 * mx;
          for (int i = 0; i < 16; ++i) {
            int b = bs[i >> 2];
            if (!b) continue;
            uint8_t* qs = dir == 0 ? base + i * yp + 4 * e : base + 4 * e * yp + i;
            filter_line<false>(qs, dir == 0 ? 1 : yp, b, alpha, beta, b < 4 ? kTc0[ia][b - 1] : 0);
          }
        }
        // chroma: the edges 0 and 2 of luma are chroma's 0 and 4
        if (e & 1) continue;
        for (int c = 0; c < 2; ++c) {
          const int qpav = (chroma_qp(p.qp, s.chroma_qp_offset[c]) +
                            chroma_qp(q.qp, s.chroma_qp_offset[c]) + 1) >> 1;
          const int ia = clip3(0, 51, qpav + s.alpha_off), ib = clip3(0, 51, qpav + s.beta_off);
          const int alpha = kAlpha[ia], beta = kBeta[ib];
          uint8_t* base = cur_->plane[1 + c].data() + (size_t)8 * my * cp + 8 * mx;
          for (int i = 0; i < 8; ++i) {
            int b = bs[i >> 1];
            if (!b) continue;
            uint8_t* qs = dir == 0 ? base + i * cp + 2 * e : base + 2 * e * cp + i;
            filter_line<true>(qs, dir == 0 ? 1 : cp, b, alpha, beta, b < 4 ? kTc0[ia][b - 1] : 0);
          }
        }
      }
    }
  }
}

int fill_err(const Error& e, char* err, int cap) {
  if (err && cap > 0) std::snprintf(err, (size_t)cap, "%s", e.msg.c_str());
  return e.code;
}

}  // namespace

extern "C" {

void* h264_open(void) {
  try {
    tables();
    return new Decoder();
  } catch (...) {
    return nullptr;
  }
}

void h264_close(void* h) { delete static_cast<Decoder*>(h); }

int h264_send(void* h, const uint8_t* unit, long n, long long tag, int* ready, char* err,
              int err_cap) {
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

int h264_flush(void* h, int* ready, char* err, int err_cap) {
  try {
    *ready = static_cast<Decoder*>(h)->flush();
    return 0;
  } catch (const Error& e) {
    *ready = 0;
    return fill_err(e, err, err_cap);
  }
}

int h264_size(void* h, int* width, int* height, int* matrix, int* full_range) {
  const Picture* p = static_cast<Decoder*>(h)->ready();
  if (!p) return 1;
  *width = p->out_w;
  *height = p->out_h;
  *matrix = p->matrix;
  *full_range = p->full_range;
  return 0;
}

int h264_receive(void* h, uint8_t* y, int y_pitch, uint8_t* u, uint8_t* v, int c_pitch,
                 long long* tag) {
  Decoder* d = static_cast<Decoder*>(h);
  const Picture* p = d->ready();
  if (!p) return 1;
  const int yp = 16 * p->mb_w, cp = 8 * p->mb_w;
  for (int r = 0; r < p->out_h; ++r)
    std::memcpy(y + (size_t)r * y_pitch, p->plane[0].data() + (size_t)(p->crop_y + r) * yp + p->crop_x,
                p->out_w);
  const int cw = (p->out_w + 1) / 2, ch = (p->out_h + 1) / 2;
  for (int r = 0; r < ch; ++r) {
    size_t off = (size_t)(p->crop_y / 2 + r) * cp + p->crop_x / 2;
    std::memcpy(u + (size_t)r * c_pitch, p->plane[1].data() + off, cw);
    std::memcpy(v + (size_t)r * c_pitch, p->plane[2].data() + off, cw);
  }
  *tag = p->tag;
  d->pop();
  return 0;
}

}  // extern "C"
