// Native JPEG entropy decoder: the per-block Huffman / run-length /
// successive-approximation scan loop of utils/jpeg.py, in C++.
//
// The Python decoder is fully vectorised EXCEPT the entropy-coded scan walk
// (an inherently serial bitstream), which costs seconds per megapixel
// texture in pure Python — the data-loader hot spot when a glTF asset pack
// ships dozens of JPEG textures. The reference decodes images natively via
// the Rust `image` crate (src/gltf_loader.rs:128-184); this
// is the equivalent native component. Marker parsing, dequantisation,
// zig-zag, IDCT and color conversion stay in (vectorised) Python — only the
// serial scan loop moves here, mirroring jpeg.py::_block_first /
// _block_refine_ac / _decode_scan exactly (ITU T.81 §F.2.2, §G.1.2).
//
// Build: make -C csrc  (produces libjpeg_scan.so; jpeg.py falls back to the
// Python loop when the library is missing).

#include <cstdint>
#include <cstring>
#include <memory>
#include <vector>

namespace {

struct Huff {
  // 16-bit peek LUT for O(1) decode (same construction as jpeg.py)
  std::vector<uint8_t> sym, len;
  // false when the DHT's counts overflow the canonical code space — a
  // corrupt/adversarial table would otherwise memset past the 64 KiB LUTs
  // (heap corruption); the caller rejects the scan like any bad code.
  bool build(const uint8_t* counts, const uint8_t* syms) {
    sym.assign(1 << 16, 0);
    len.assign(1 << 16, 0);
    uint64_t code = 0;
    int k = 0;
    for (int L = 1; L <= 16; ++L) {
      for (int i = 0; i < counts[L - 1]; ++i) {
        uint64_t lo = code << (16 - L);
        uint64_t hi = lo + (1ull << (16 - L));
        if (hi > (1ull << 16)) return false;
        std::memset(sym.data() + lo, syms[k], hi - lo);
        std::memset(len.data() + lo, L, hi - lo);
        ++k;
        ++code;
      }
      code <<= 1;
    }
    return true;
  }
};

struct BitReader {
  const uint8_t* buf;
  int64_t n;
  int64_t pos = 0;
  uint64_t acc = 0;
  int nbits = 0;
  inline void fill(int need) {
    while (nbits < need) {
      uint8_t b = pos < n ? buf[pos] : 0;
      ++pos;
      acc = ((acc << 8) | b) & 0xFFFFFFFFFFull;
      nbits += 8;
    }
  }
  inline int peek16() {
    fill(16);
    return (int)((acc >> (nbits - 16)) & 0xFFFF);
  }
  inline void skip(int k) { nbits -= k; }
  inline int read(int k) {
    if (!k) return 0;
    fill(k);
    int v = (int)((acc >> (nbits - k)) & ((1u << k) - 1));
    nbits -= k;
    return v;
  }
  inline void reset_to(int64_t p) {
    pos = p;
    acc = 0;
    nbits = 0;
  }
};

inline int extend(int v, int s) {  // T.81 F.2.2.1
  return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v;
}

struct ScanCtx {
  int eobrun = 0;
};

// First-pass band decode (baseline full band or progressive first scan).
// Returns 0 / -1 on a bad Huffman code.
int block_first(BitReader& br, int32_t* row, const Huff& dc, const Huff& ac,
                int& pred, int ss, int se, int al, ScanCtx& st) {
  if (st.eobrun > 0) {
    --st.eobrun;
    return 0;
  }
  int k = ss;
  if (ss == 0) {
    int p16 = br.peek16();
    int ln = dc.len[p16];
    if (!ln) return -1;
    br.skip(ln);
    int s = dc.sym[p16];
    // DC magnitude category is <= 16 bits (T.81 F.1.2.1.1); a corrupt DHT
    // can deliver any byte, and read(s > 31) would be UB in the mask shift
    if (s > 16) return -1;
    int diff = s ? extend(br.read(s), s) : 0;
    pred += diff;
    row[0] = pred << al;
    k = 1;
  }
  while (k <= se) {
    int p16 = br.peek16();
    int ln = ac.len[p16];
    if (!ln) return -1;
    br.skip(ln);
    int rs = ac.sym[p16];
    int r = rs >> 4, s = rs & 15;
    if (s == 0) {
      if (r == 15) {  // ZRL
        k += 16;
        continue;
      }
      st.eobrun = (1 << r) - 1;  // EOBn: this block + 2^r-1 more
      if (r) st.eobrun += br.read(r);
      break;
    }
    k += r;
    if (k > 63) break;  // corrupt stream; tolerate like the Python path
    row[k] = extend(br.read(s), s) << al;
    ++k;
  }
  return 0;
}

// AC successive-approximation refinement (T.81 §G.1.2.3).
int block_refine_ac(BitReader& br, int32_t* row, const Huff& ac, int ss,
                    int se, int al, ScanCtx& st) {
  const int32_t p1 = 1 << al;
  const int32_t m1 = -(1 << al);
  int k = ss;
  if (st.eobrun == 0) {
    while (k <= se) {
      int p16 = br.peek16();
      int ln = ac.len[p16];
      if (!ln) return -1;
      br.skip(ln);
      int rs = ac.sym[p16];
      int r = rs >> 4, s = rs & 15;
      int32_t newval = 0;
      if (s == 0) {
        if (r < 15) {  // EOBn
          st.eobrun = 1 << r;
          if (r) st.eobrun += br.read(r);
          break;
        }
        // r == 15: ZRL — pass 16 zero-history coefficients
      } else {  // s == 1 per spec
        newval = br.read(1) ? p1 : m1;
      }
      while (k <= se) {  // advance, correcting nonzero-history coeffs
        if (row[k] != 0) {
          if (br.read(1) && (row[k] & p1) == 0)
            row[k] += row[k] >= 0 ? p1 : m1;
        } else {
          if (r == 0) break;
          --r;
        }
        ++k;
      }
      if (newval && k <= se) row[k] = newval;
      ++k;
    }
  }
  if (st.eobrun > 0) {  // EOB run: correction bits only
    for (; k <= se; ++k) {
      if (row[k] != 0) {
        if (br.read(1) && (row[k] & p1) == 0)
          row[k] += row[k] >= 0 ? p1 : m1;
      }
    }
    --st.eobrun;
  }
  return 0;
}

}  // namespace

extern "C" {

// One scan over the component coefficient grids (the body of
// jpeg.py::_decode_scan). `tables`: per scan component 2*(16 counts + 256
// symbols) bytes, DC table then AC table. `coef`: per component pointer to
// its [grid_h, grid_w, 64] int32 grid; `grid_w` its row stride in blocks.
// Interleaved MCU order when ncomp > 1, raster block order (bw x bh) when
// ncomp == 1. Returns 0, or -1 on a bad Huffman code.
int jpeg_decode_scan(const uint8_t* ent, int64_t ent_len,
                     const int64_t* rst_off, int32_t n_rst,
                     int32_t restart_interval, const uint8_t* tables,
                     int32_t ncomp, const int32_t* comp_h,
                     const int32_t* comp_v, int32_t mcus_x, int32_t mcus_y,
                     int32_t bw, int32_t bh, int32_t ss, int32_t se,
                     int32_t ah, int32_t al, int32_t** coef,
                     const int32_t* grid_w) {
  std::vector<Huff> dcs((size_t)ncomp), acs((size_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    const uint8_t* t = tables + (size_t)c * 2 * 272;
    if (!dcs[c].build(t, t + 16) || !acs[c].build(t + 272, t + 272 + 16))
      return -1;  // overfull DHT: reject like a bad Huffman code
  }
  BitReader br{ent, ent_len};
  ScanCtx st;
  int preds[8] = {0};
  const bool refine = ah != 0;
  auto resync = [&](int64_t j) {
    br.reset_to(j < n_rst ? rst_off[j] : ent_len);
    std::memset(preds, 0, sizeof(preds));
    st.eobrun = 0;
  };

  if (ncomp == 1) {  // non-interleaved: one block per MCU
    const int64_t units = (int64_t)bw * bh;
    for (int64_t u = 0; u < units; ++u) {
      if (restart_interval && u && u % restart_interval == 0)
        resync(u / restart_interval - 1);
      int32_t* row =
          coef[0] + ((u / bw) * (int64_t)grid_w[0] + (u % bw)) * 64;
      int rc = 0;
      if (refine) {
        if (ss == 0) {
          if (br.read(1)) row[0] |= (int32_t)1 << al;
        } else {
          rc = block_refine_ac(br, row, acs[0], ss, se, al, st);
        }
      } else {
        rc = block_first(br, row, dcs[0], acs[0], preds[0], ss, se, al, st);
      }
      if (rc) return rc;
    }
    return 0;
  }

  const int64_t n_mcus = (int64_t)mcus_x * mcus_y;
  for (int64_t m = 0; m < n_mcus; ++m) {
    if (restart_interval && m && m % restart_interval == 0)
      resync(m / restart_interval - 1);
    const int64_t my = m / mcus_x, mx = m % mcus_x;
    for (int c = 0; c < ncomp; ++c) {
      for (int v = 0; v < comp_v[c]; ++v) {
        for (int h = 0; h < comp_h[c]; ++h) {
          int32_t* row = coef[c] + (((my * comp_v[c] + v) *
                                     (int64_t)grid_w[c]) +
                                    (mx * comp_h[c] + h)) *
                                       64;
          int rc = 0;
          if (refine) {  // interleaved refinement = DC only
            if (br.read(1)) row[0] |= (int32_t)1 << al;
          } else {
            rc = block_first(br, row, dcs[c], acs[c], preds[c], ss, se, al,
                             st);
          }
          if (rc) return rc;
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
