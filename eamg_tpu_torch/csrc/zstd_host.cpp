// Zstandard frames (RFC 8878) on the host: the decoder of
// eamg_tpu_torch/utils/zstd.py, for the chunks of an Orbax checkpoint (a
// flagship tree is tens of MB of Huffman-coded literals). Built with g++
// at first use (utils/zstd.py::_lib, through utils/native.py); a plain C
// interface bound with ctypes.
//
// eamg_zstd_decompress(src, n, dst, cap, &out) decodes every frame of src
// into dst: 0 on success (out = the bytes written), 1 when dst is too
// small (out = a size to try next), 2 for bytes it does not read.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <vector>

namespace {

struct Bad : std::runtime_error {
  Bad() : std::runtime_error("zstd") {}
};
struct Full : std::runtime_error {
  Full() : std::runtime_error("full") {}
};

inline uint64_t load64(const uint8_t* p, size_t avail) {
  uint64_t v = 0;
  std::memcpy(&v, p, avail < 8 ? avail : 8);
  return v;
}

// little-endian bits, least significant first (FSE table descriptions)
struct Forward {
  const uint8_t* d;
  size_t n, bit;
  uint32_t read(int k) {
    const size_t i = bit >> 3;
    if (i >= n) throw Bad();
    const uint64_t v = load64(d + i, n - i) >> (bit & 7);
    bit += k;
    return (uint32_t)(v & ((1ull << k) - 1));
  }
  size_t byte_end() const { return (bit + 7) >> 3; }
};

// a backward bitstream: read from the end mark down, zeros past the start
struct Backward {
  const uint8_t* d;
  size_t n;
  int64_t left;
  Backward(const uint8_t* p, size_t len) : d(p), n(len) {
    if (len == 0 || p[len - 1] == 0) throw Bad();
    int hb = 7;
    while (!(p[len - 1] >> hb)) --hb;
    left = (int64_t)(len - 1) * 8 + hb;
  }
  uint64_t peek_at(int64_t p, int k) const {
    uint64_t v;
    if (p >= 0) {
      const size_t i = (size_t)(p >> 3);
      v = load64(d + i, n - i) >> (p & 7);
    } else {
      v = -p >= 64 ? 0 : load64(d, n) << (-p);
    }
    return v & ((k >= 64) ? ~0ull : ((1ull << k) - 1));
  }
  uint32_t read(int k) {
    left -= k;
    return (uint32_t)peek_at(left, k);
  }
};

struct Fse {
  std::vector<uint16_t> sym;
  std::vector<uint8_t> bits;
  std::vector<int32_t> base;
  int log = 0;
};

size_t fse_header(const uint8_t* d, size_t n, size_t pos, int max_log,
                  int* log_out, std::vector<int>* probs) {
  Forward br{d, n, pos * 8};
  const int log = (int)br.read(4) + 5;
  if (log > max_log) throw Bad();
  int remaining = 1 << log;
  probs->clear();
  while (remaining > 0) {
    if (probs->size() > 255) throw Bad();
    int bits = 0;
    while ((remaining + 1) >> bits) ++bits;
    const int low = (1 << (bits - 1)) - 1;
    const int threshold = (1 << bits) - 1 - (remaining + 1);
    int val = (int)br.read(bits);
    if ((val & low) < threshold) {
      br.bit -= 1;
      val &= low;
    } else if (val > low) {
      val -= threshold;
    }
    const int prob = val - 1;
    remaining -= prob < 0 ? -prob : prob;
    probs->push_back(prob);
    if (prob == 0) {
      while (true) {
        const int repeat = (int)br.read(2);
        for (int i = 0; i < repeat; ++i) probs->push_back(0);
        if (repeat != 3) break;
      }
    }
  }
  if (remaining != 0) throw Bad();
  *log_out = log;
  return br.byte_end();
}

Fse fse_table(int log, const std::vector<int>& probs) {
  const int size = 1 << log;
  Fse t;
  t.log = log;
  t.sym.assign(size, 0);
  t.bits.assign(size, 0);
  t.base.assign(size, 0);
  std::vector<int> nxt(probs.size(), 0);
  int high = size;
  for (size_t s = 0; s < probs.size(); ++s) {
    if (probs[s] == -1) {
      t.sym[--high] = (uint16_t)s;
      nxt[s] = 1;
    } else {
      nxt[s] = probs[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < probs.size(); ++s)
    for (int i = 0; i < probs[s]; ++i) {
      t.sym[pos] = (uint16_t)s;
      do pos = (pos + step) & mask;
      while (pos >= high);
    }
  if (pos != 0) throw Bad();
  for (int i = 0; i < size; ++i) {
    const int d = nxt[t.sym[i]]++;
    int hb = 31;
    while (!((d >> hb) & 1)) --hb;
    t.bits[i] = (uint8_t)(log - hb);
    t.base[i] = (d << t.bits[i]) - size;
  }
  return t;
}

Fse rle_table(uint8_t s) {
  Fse t;
  t.sym = {s};
  t.bits = {0};
  t.base = {0};
  t.log = 0;
  return t;
}

const int LL_DEFAULT[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2,
                            2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int ML_DEFAULT[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int OF_DEFAULT[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                            1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};
const uint32_t LL_BASE[36] = {0,    1,    2,     3,     4,     5,    6,
                              7,    8,    9,     10,    11,    12,   13,
                              14,   15,   16,    18,    20,    22,   24,
                              28,   32,   40,    48,    64,    128,  256,
                              512,  1024, 2048,  4096,  8192,  16384,
                              32768, 65536};
const uint8_t LL_BITS[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3,
                             4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t ML_BASE[53] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,
    17, 18, 19, 20, 21, 22, 23, 24, 25, 26,  27,  28,  29,  30,
    31, 32, 33, 34, 35, 37, 39, 41, 43, 47,  51,  59,  67,  83,
    99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t ML_BITS[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4,
                             5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

const Fse& predefined(int which) {
  static const Fse ll = fse_table(6, std::vector<int>(LL_DEFAULT,
                                                      LL_DEFAULT + 36));
  static const Fse of = fse_table(5, std::vector<int>(OF_DEFAULT,
                                                      OF_DEFAULT + 29));
  static const Fse ml = fse_table(6, std::vector<int>(ML_DEFAULT,
                                                      ML_DEFAULT + 53));
  return which == 0 ? ll : which == 1 ? of : ml;
}

struct Huffman {
  std::vector<uint8_t> sym, nbits;
  int max_bits = 0;
};

size_t huffman_weights(const uint8_t* d, size_t n, size_t pos,
                       std::vector<int>* weights) {
  if (pos >= n) throw Bad();
  const int head = d[pos++];
  weights->clear();
  if (head >= 128) {
    const int k = head - 127;
    if (pos + (k + 1) / 2 > n) throw Bad();
    for (int i = 0; i < k; ++i) {
      const uint8_t b = d[pos + i / 2];
      weights->push_back(i % 2 ? (b & 15) : (b >> 4));
    }
    return pos + (k + 1) / 2;
  }
  const size_t end = pos + head;
  if (end > n) throw Bad();
  int log;
  std::vector<int> probs;
  const size_t start = fse_header(d, end, pos, 6, &log, &probs);
  const Fse t = fse_table(log, probs);
  if (start >= end) throw Bad();
  Backward br(d + start, end - start);
  uint32_t s1 = br.read(log), s2 = br.read(log);
  while (weights->size() < 255) {
    weights->push_back(t.sym[s1]);
    s1 = t.base[s1] + br.read(t.bits[s1]);
    if (br.left < 0) {
      weights->push_back(t.sym[s2]);
      break;
    }
    weights->push_back(t.sym[s2]);
    s2 = t.base[s2] + br.read(t.bits[s2]);
    if (br.left < 0) {
      weights->push_back(t.sym[s1]);
      break;
    }
  }
  return end;
}

Huffman huffman_table(std::vector<int> weights) {
  uint32_t total = 0;
  for (int w : weights)
    if (w) total += 1u << (w - 1);
  if (total == 0) throw Bad();
  int max_bits = 0;
  while (total >> max_bits) ++max_bits;
  const uint32_t last = (1u << max_bits) - total;
  if (last & (last - 1)) throw Bad();
  int lw = 0;
  while (last >> lw) ++lw;
  weights.push_back(lw);
  if (max_bits > 11) throw Bad();
  Huffman h;
  h.max_bits = max_bits;
  h.sym.assign(1u << max_bits, 0);
  h.nbits.assign(1u << max_bits, 0);
  size_t pos = 0;
  for (int w = 1; w <= max_bits; ++w)
    for (size_t s = 0; s < weights.size(); ++s) {
      if (weights[s] != w) continue;
      const int nb = max_bits + 1 - w;
      const size_t span = (size_t)1 << (max_bits - nb);
      if (pos + span > h.sym.size()) throw Bad();
      std::memset(&h.sym[pos], (int)s, span);
      std::memset(&h.nbits[pos], nb, span);
      pos += span;
    }
  return h;
}

void huffman_stream(const uint8_t* d, size_t n, const Huffman& h,
                    size_t count, uint8_t* out) {
  Backward br(d, n);
  const int mb = h.max_bits;
  for (size_t i = 0; i < count; ++i) {
    br.left -= mb;
    const uint32_t k = (uint32_t)br.peek_at(br.left, mb);
    out[i] = h.sym[k];
    br.left += mb - h.nbits[k];
  }
  if (br.left != 0) throw Bad();
}

struct Frame {
  uint8_t* out;
  size_t cap, len = 0;
  bool have_huffman = false;
  Huffman huffman;
  Fse tables[3];
  bool have[3] = {false, false, false};
  uint32_t rep[3] = {1, 4, 8};
  std::vector<uint8_t> lits;

  void put(const uint8_t* p, size_t k) {
    if (len + k > cap) throw Full();
    std::memcpy(out + len, p, k);
    len += k;
  }
};

size_t literals(const uint8_t* d, size_t n, size_t pos, Frame& fr) {
  if (pos >= n) throw Bad();
  const uint8_t b0 = d[pos];
  const int kind = b0 & 3, fmt = (b0 >> 2) & 3;
  if (kind < 2) {
    size_t size;
    if (fmt == 0 || fmt == 2) {
      size = b0 >> 3;
      pos += 1;
    } else if (fmt == 1) {
      if (pos + 2 > n) throw Bad();
      size = (b0 >> 4) + ((size_t)d[pos + 1] << 4);
      pos += 2;
    } else {
      if (pos + 3 > n) throw Bad();
      size = (b0 >> 4) + ((size_t)d[pos + 1] << 4) +
             ((size_t)d[pos + 2] << 12);
      pos += 3;
    }
    if (kind == 0) {
      if (pos + size > n) throw Bad();
      fr.lits.assign(d + pos, d + pos + size);
      return pos + size;
    }
    if (pos >= n) throw Bad();
    fr.lits.assign(size, d[pos]);
    return pos + 1;
  }
  const int n_head = fmt < 2 ? 3 : fmt == 2 ? 4 : 5;
  if (pos + n_head > n) throw Bad();
  uint64_t h = 0;
  for (int i = 0; i < n_head; ++i) h |= (uint64_t)d[pos + i] << (8 * i);
  const int bits = n_head == 3 ? 10 : n_head == 4 ? 14 : 18;
  const size_t regen = (h >> 4) & ((1u << bits) - 1);
  const size_t comp = (h >> (4 + bits)) & ((1u << bits) - 1);
  pos += n_head;
  const size_t end = pos + comp;
  if (end > n) throw Bad();
  if (kind == 2) {
    std::vector<int> weights;
    pos = huffman_weights(d, end, pos, &weights);
    fr.huffman = huffman_table(weights);
    fr.have_huffman = true;
  } else if (!fr.have_huffman) {
    throw Bad();
  }
  fr.lits.resize(regen);
  if (fmt == 0) {
    huffman_stream(d + pos, end - pos, fr.huffman, regen, fr.lits.data());
    return end;
  }
  if (pos + 6 > end) throw Bad();
  const size_t sizes[3] = {(size_t)d[pos] | ((size_t)d[pos + 1] << 8),
                           (size_t)d[pos + 2] | ((size_t)d[pos + 3] << 8),
                           (size_t)d[pos + 4] | ((size_t)d[pos + 5] << 8)};
  pos += 6;
  const size_t per = (regen + 3) / 4;
  if (3 * per > regen) throw Bad();
  size_t at = 0;
  for (int i = 0; i < 4; ++i) {
    const size_t size = i < 3 ? sizes[i] : end - pos;
    const size_t count = i < 3 ? per : regen - 3 * per;
    if (pos + size > end) throw Bad();
    huffman_stream(d + pos, size, fr.huffman, count, fr.lits.data() + at);
    pos += size;
    at += count;
  }
  return end;
}

size_t seq_table(const uint8_t* d, size_t n, size_t pos, int mode,
                 int which, Frame& fr, int max_log) {
  if (mode == 0) {
    fr.tables[which] = predefined(which);
  } else if (mode == 1) {
    if (pos >= n) throw Bad();
    fr.tables[which] = rle_table(d[pos++]);
  } else if (mode == 2) {
    int log;
    std::vector<int> probs;
    pos = fse_header(d, n, pos, max_log, &log, &probs);
    fr.tables[which] = fse_table(log, probs);
  } else if (!fr.have[which]) {
    throw Bad();
  }
  fr.have[which] = true;
  return pos;
}

void sequences(const uint8_t* d, size_t pos, size_t end, Frame& fr) {
  const std::vector<uint8_t>& lits = fr.lits;
  if (pos >= end) throw Bad();
  const uint8_t b0 = d[pos];
  if (b0 == 0) {
    fr.put(lits.data(), lits.size());
    return;
  }
  size_t count;
  if (b0 < 128) {
    count = b0;
    pos += 1;
  } else if (b0 < 255) {
    if (pos + 2 > end) throw Bad();
    count = ((size_t)(b0 - 128) << 8) + d[pos + 1];
    pos += 2;
  } else {
    if (pos + 3 > end) throw Bad();
    count = d[pos + 1] + ((size_t)d[pos + 2] << 8) + 0x7F00;
    pos += 3;
  }
  if (pos >= end) throw Bad();
  const uint8_t modes = d[pos++];
  pos = seq_table(d, end, pos, modes >> 6, 0, fr, 9);
  pos = seq_table(d, end, pos, (modes >> 4) & 3, 1, fr, 8);
  pos = seq_table(d, end, pos, (modes >> 2) & 3, 2, fr, 9);
  const Fse &ll_t = fr.tables[0], &of_t = fr.tables[1], &ml_t = fr.tables[2];
  if (pos >= end) throw Bad();
  Backward br(d + pos, end - pos);
  uint32_t ll_s = br.read(ll_t.log), of_s = br.read(of_t.log),
           ml_s = br.read(ml_t.log);
  uint32_t* rep = fr.rep;
  size_t lit = 0;
  for (size_t i = 0; i < count; ++i) {
    const int of_code = of_t.sym[of_s], ll_code = ll_t.sym[ll_s],
              ml_code = ml_t.sym[ml_s];
    if (of_code > 31 || ll_code > 35 || ml_code > 52) throw Bad();
    const uint32_t value = (1u << of_code) + br.read(of_code);
    const size_t ml = ML_BASE[ml_code] + br.read(ML_BITS[ml_code]);
    const size_t ll = LL_BASE[ll_code] + br.read(LL_BITS[ll_code]);
    uint32_t offset;
    if (value > 3) {
      offset = value - 3;
      rep[2] = rep[1];
      rep[1] = rep[0];
      rep[0] = offset;
    } else {
      const int idx = (int)value - 1 + (ll == 0);
      if (idx == 0) {
        offset = rep[0];
      } else {
        offset = idx < 3 ? rep[idx] : rep[0] - 1;
        if (offset == 0) throw Bad();
        if (idx == 1) {
          rep[1] = rep[0];
        } else {
          rep[2] = rep[1];
          rep[1] = rep[0];
        }
        rep[0] = offset;
      }
    }
    if (lit + ll > lits.size()) throw Bad();
    fr.put(lits.data() + lit, ll);
    lit += ll;
    if (offset > fr.len) throw Bad();
    if (fr.len + ml > fr.cap) throw Full();
    uint8_t* dst = fr.out + fr.len;
    const uint8_t* src = dst - offset;
    if (offset >= ml) {
      std::memcpy(dst, src, ml);
    } else {
      for (size_t j = 0; j < ml; ++j) dst[j] = src[j];
    }
    fr.len += ml;
    if (i + 1 < count) {
      ll_s = ll_t.base[ll_s] + br.read(ll_t.bits[ll_s]);
      ml_s = ml_t.base[ml_s] + br.read(ml_t.bits[ml_s]);
      of_s = of_t.base[of_s] + br.read(of_t.bits[of_s]);
    }
  }
  if (br.left != 0) throw Bad();
  fr.put(lits.data() + lit, lits.size() - lit);
}

size_t frame(const uint8_t* d, size_t n, size_t pos, uint8_t* out,
             size_t cap, size_t* len) {
  if (pos >= n) throw Bad();
  const uint8_t fhd = d[pos++];
  const int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1,
            checksum = (fhd >> 2) & 1, dict_flag = fhd & 3;
  if ((fhd & 8) || dict_flag) throw Bad();
  if (!single) pos += 1;
  const int nf = fcs_flag == 0 ? single : fcs_flag == 1 ? 2
                                      : fcs_flag == 2 ? 4 : 8;
  int64_t size = -1;
  if (nf) {
    if (pos + nf > n) throw Bad();
    uint64_t v = 0;
    for (int i = 0; i < nf; ++i) v |= (uint64_t)d[pos + i] << (8 * i);
    size = (int64_t)v + (nf == 2 ? 256 : 0);
  }
  pos += nf;
  Frame fr;
  fr.out = out;
  fr.cap = cap;
  while (true) {
    if (pos + 3 > n) throw Bad();
    const uint32_t h = d[pos] | (d[pos + 1] << 8) | (d[pos + 2] << 16);
    const int last = h & 1, kind = (h >> 1) & 3;
    const size_t bsize = h >> 3;
    pos += 3;
    if (kind == 0) {
      if (pos + bsize > n) throw Bad();
      fr.put(d + pos, bsize);
      pos += bsize;
    } else if (kind == 1) {
      if (pos >= n) throw Bad();
      if (fr.len + bsize > fr.cap) throw Full();
      std::memset(fr.out + fr.len, d[pos], bsize);
      fr.len += bsize;
      pos += 1;
    } else if (kind == 2) {
      const size_t end = pos + bsize;
      if (end > n) throw Bad();
      const size_t p = literals(d, end, pos, fr);
      sequences(d, p, end, fr);
      pos = end;
    } else {
      throw Bad();
    }
    if (last) break;
  }
  if (size >= 0 && (size_t)size != fr.len) throw Bad();
  *len = fr.len;
  return pos + 4 * checksum;
}

}  // namespace

extern "C" int eamg_zstd_decompress(const uint8_t* src, size_t n,
                                    uint8_t* dst, size_t cap,
                                    size_t* out) {
  size_t pos = 0, len = 0;
  try {
    while (pos < n) {
      if (pos + 4 > n) throw Bad();
      const uint32_t magic = src[pos] | (src[pos + 1] << 8) |
                             (src[pos + 2] << 16) | ((uint32_t)src[pos + 3]
                                                     << 24);
      if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
        if (pos + 8 > n) throw Bad();
        const uint32_t skip = src[pos + 4] | (src[pos + 5] << 8) |
                              (src[pos + 6] << 16) |
                              ((uint32_t)src[pos + 7] << 24);
        pos += 8 + (size_t)skip;
        continue;
      }
      if (magic != 0xFD2FB528u) throw Bad();
      size_t got = 0;
      pos = frame(src, n, pos + 4, dst + len, cap - len, &got);
      len += got;
    }
  } catch (const Full&) {
    *out = 2 * cap + 1024;
    return 1;
  } catch (const std::exception&) {
    return 2;
  }
  *out = len;
  return 0;
}
