/* Baseline-JPEG entropy coder: bitstream <-> quantized DCT coefficients.
 *
 * The host half of the split MJPEG codec. The serial entropy (Huffman)
 * decode and encode run here on the host; everything on the far side of
 * the coefficients (dequant + IDCT + reassembly, then resize + CSC; or
 * level shift + forward DCT + quant) runs on the GPU as batched matmuls
 * (ops/jpeg.py). The decode uses a combined Huffman+magnitude LUT.
 *
 * Built alone into libvpf_jpeg (io/build.py:build_jpeg) with no libav:
 * it includes only status.hpp, and exports its own vpf_last_error.
 *
 * Output layout per component: [bh*bw blocks][64] int16 in ZIGZAG order
 * (the device folds zigzag→spatial plus dequant into one constant basis
 * matrix, so de-zigzagging here would be wasted host work). Quant tables
 * are exported in the same zigzag order.
 *
 * Scope: sequential baseline DCT (SOF0/SOF1) and progressive DCT (SOF2,
 * all spectral-selection / successive-approximation scan shapes), 8-bit
 * samples, sampling factors ≤ 2, restart markers supported. Hierarchical
 * / arithmetic / 12-bit / subset-interleaved streams return VPF_ERR with
 * a typed message — callers fall back to the libav software path
 * (io/native/decoder.cpp).
 */
#if defined(__SSE2__) || defined(_M_X64)
#include <emmintrin.h>
#define VPF_JPEG_SSE2 1
#endif
#include <vector>

#include "status.hpp"

VPF_API const char* vpf_last_error(void) { return vpf_error_slot().c_str(); }

namespace {

/* Combined Huffman+magnitude LUT (the libjpeg-turbo fast-path idea): one
 * 12-bit peek resolves most symbols AND their EXTENDed coefficient value
 * in a single table load. Entry encoding:
 *   0                → not covered (code > 12 bits / invalid): slow path
 *   bit 31 set (e<0) → full decode: value int16 in bits 0-15, run in
 *                      bits 16-19, total consumed bits in 20-25
 *   bit 30 set       → symbol only (code ≤ 12 but code+magnitude > 12):
 *                      symbol in bits 0-7, code length in bits 20-25
 * EOB/ZRL (size 0) are "full" with value 0 — real coefficients are never
 * 0 (EXTEND excludes it), so value==0 disambiguates. */
struct HuffTable {
  static constexpr int LUT_BITS = 12;
  int32_t flut[1 << LUT_BITS];
  int32_t maxcode[17];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t huffval[256];
  bool present = false;

  void build(const uint8_t* bits, const uint8_t* vals, int nvals,
             bool is_ac) {
    memcpy(huffval, vals, nvals);
    int code = 0, k = 0;
    uint16_t codes[256];
    uint8_t sizes[256];
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l - 1]; ++i) {
        codes[k] = (uint16_t)code;
        sizes[k] = (uint8_t)l;
        ++code;
        ++k;
      }
      maxcode[l] = code - 1;
      code <<= 1;
    }
    for (int l = 1; l <= 16; ++l)
      if (!bits[l - 1]) maxcode[l] = -1;
    memset(flut, 0, sizeof(flut));
    for (int i = 0; i < k; ++i) {
      int l = sizes[i];
      if (l > LUT_BITS) continue;
      uint8_t sym = huffval[i];
      int run = is_ac ? (sym >> 4) : 0;
      int sz = is_ac ? (sym & 15) : sym;
      int base = codes[i] << (LUT_BITS - l);
      int nfill = 1 << (LUT_BITS - l);
      if (sz == 0) {
        int32_t e = (int32_t)(0x80000000u | (l << 20) | (run << 16));
        for (int j = 0; j < nfill; ++j) flut[base + j] = e;
      } else if (l + sz <= LUT_BITS) {
        for (int j = 0; j < nfill; ++j) {
          int idx = base + j;
          int vbits = (idx >> (LUT_BITS - l - sz)) & ((1 << sz) - 1);
          int val = vbits < (1 << (sz - 1)) ? vbits - (1 << sz) + 1 : vbits;
          flut[idx] = (int32_t)(0x80000000u | ((l + sz) << 20) |
                                (run << 16) | (uint16_t)(int16_t)val);
        }
      } else {
        int32_t e = (1 << 30) | (l << 20) | sym;
        for (int j = 0; j < nfill; ++j) flut[base + j] = e;
      }
    }
    present = true;
  }
};

/* Entropy-coded data, de-stuffed once up front (memchr sweep: 0xFF00 →
 * 0xFF, RSTn markers removed with their de-stuffed offsets recorded, any
 * other marker ends the scan). One linear copy per frame (~0.02 ms at
 * 1080p) buys the bit reader branch-free 64-bit refills; together with
 * the combined LUT this took 1080p parse from 5.8 to 3.2 ms/frame. */
struct EntropyData {
  std::vector<uint8_t> buf;
  std::vector<size_t> restarts; /* de-stuffed offset just past each RSTn */
  size_t end_src = 0;           /* source offset just past EOI (or n) */
  uint8_t end_marker = 0;       /* marker that ended the scan (0 = none) */

  void destuff(const uint8_t* d, size_t n, size_t start) {
    buf.clear();
    restarts.clear();
    end_marker = 0;
    buf.reserve(n - start + 16);
    size_t i = start;
    while (i < n) {
      const uint8_t* ff =
          (const uint8_t*)memchr(d + i, 0xFF, n - i);
      if (!ff) {
        buf.insert(buf.end(), d + i, d + n);
        break;
      }
      size_t j = (size_t)(ff - d);
      buf.insert(buf.end(), d + i, d + j);
      if (j + 1 >= n) break;
      uint8_t m = d[j + 1];
      if (m == 0x00) {
        buf.push_back(0xFF);
        i = j + 2;
      } else if (m >= 0xD0 && m <= 0xD7) {
        restarts.push_back(buf.size());
        i = j + 2;
      } else { /* real marker (EOI or next-frame SOI/...) ends the scan */
        end_marker = m;
        end_src = (m == 0xD9) ? j + 2 : j;
        return;
      }
    }
    end_src = n;
  }
};

/* MSB-first bit reader over de-stuffed entropy data. Past the end it
 * feeds zero bits; the block loop's bounds keep that safe and the caller
 * checks decode success per symbol. */
struct BitReader {
  const uint8_t* base;
  const uint8_t* p;
  const uint8_t* end;
  const EntropyData* ed;
  size_t next_rst = 0;
  uint64_t buf = 0;
  int nbits = 0;

  explicit BitReader(const EntropyData& e)
      : base(e.buf.data()),
        p(e.buf.data()),
        end(e.buf.data() + e.buf.size()),
        ed(&e) {}

  void refill() {
    if (p + 8 <= end) {
      uint64_t v;
      memcpy(&v, p, 8);
      v = __builtin_bswap64(v);
      buf |= v >> nbits;
      int take = (63 - nbits) >> 3;
      p += take;
      nbits += take * 8;
    } else {
      while (nbits <= 56) {
        uint8_t b = p < end ? *p++ : 0;
        buf |= (uint64_t)b << (56 - nbits);
        nbits += 8;
      }
    }
  }
  inline uint32_t peek(int n) { return (uint32_t)(buf >> (64 - n)); }
  inline void skip(int n) {
    buf <<= n;
    nbits -= n;
  }
  inline int32_t receive_extend(int s) {
    if (!s) return 0;
    if (nbits < s) refill();
    int32_t v = (int32_t)peek(s);
    skip(s);
    /* ITU T.81 F.2.2.1 EXTEND */
    if (v < (1 << (s - 1))) v += ((-1) << s) + 1;
    return v;
  }
  bool align_restart() {
    buf = 0;
    nbits = 0;
    if (next_rst >= ed->restarts.size()) return false;
    p = base + ed->restarts[next_rst++];
    return true;
  }
};

/* Codes longer than LUT_BITS (rare: deep AC codes in noisy content).
 * Caller guarantees ≥16 bits buffered. */
inline int decode_huff_slow(BitReader& br, const HuffTable& t) {
  uint32_t c16 = br.peek(16);
  for (int l = HuffTable::LUT_BITS + 1; l <= 16; ++l) {
    int32_t code = (int32_t)(c16 >> (16 - l));
    if (t.maxcode[l] >= 0 && code <= t.maxcode[l]) {
      br.skip(l);
      return t.huffval[t.valptr[l] + code - t.mincode[l]];
    }
  }
  return -1;
}

struct Parser {
  const uint8_t* d;
  size_t n;
  HuffTable dc[4], ac[4];
  uint16_t qtab[4][64] = {};
  bool qtab_present[4] = {};
  struct Comp {
    int id = 0, hs = 1, vs = 1, tq = 0, td = 0, ta = 0;
    int bw = 0, bh = 0;
    int sw = 0, sh = 0; /* non-interleaved scan block grid (T.81 A.2.2) */
    int32_t dcpred = 0;
  } comp[4];
  int ncomp = 0, W = 0, H = 0, restart = 0, bits = 8;
  bool progressive = false;
  size_t sos_data_off = 0; /* entropy-coded data start (0 = no SOS seen) */
  size_t end_off = 0;      /* offset just past EOI (parse only) */
  int max_k = 0;
  /* current-scan state (progressive: one SOS per spectral band/approx
   * pass, T.81 G.1) */
  int scomp[4] = {};                /* comp[] indices in this scan */
  int nscomp = 0;
  int ss = 0, se = 63, ah = 0, al = 0;
  uint32_t eobrun = 0;              /* G.1.2.2 end-of-band run */
  int hmax = 1, vmax = 1;

  int parse_headers() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8)
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: missing SOI marker");
    size_t i = 2;
    while (i + 4 <= n) {
      if (d[i] != 0xFF) {
        ++i;
        continue;
      }
      uint8_t m = d[i + 1];
      if (m == 0xFF) { ++i; continue; } /* fill byte */
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7)) {
        i += 2;
        continue;
      }
      if (m == 0xD9)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: EOI before SOS");
      size_t len = ((size_t)d[i + 2] << 8) | d[i + 3];
      if (len < 2 || i + 2 + len > n)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated segment 0x%02x",
                             m);
      const uint8_t* seg = d + i + 4;
      size_t segn = len - 2;
      switch (m) {
        case 0xC4: { /* DHT */
          int rc = parse_dht(seg, segn);
          if (rc != VPF_OK) return rc;
          break;
        }
        case 0xDB: { /* DQT */
          int rc = parse_dqt(seg, segn);
          if (rc != VPF_OK) return rc;
          break;
        }
        case 0xC6:
        case 0xCA:
        case 0xCE:
          return vpf_set_error(VPF_ERR, "jpeg: arithmetic/differential "
                               "coding unsupported");
        case 0xC2: /* SOF2: progressive DCT (multi-scan, T.81 G) */
          progressive = true;
          [[fallthrough]];
        case 0xC0:
        case 0xC1: { /* SOF0/1: baseline sequential */
          if (segn < 6)
            return vpf_set_error(VPF_ERR_PARSE, "jpeg: short SOF");
          bits = seg[0];
          if (bits != 8)
            return vpf_set_error(VPF_ERR, "jpeg: %d-bit samples unsupported",
                                 bits);
          H = (seg[1] << 8) | seg[2];
          W = (seg[3] << 8) | seg[4];
          ncomp = seg[5];
          if (ncomp < 1 || ncomp > 4 || segn < 6 + 3 * (size_t)ncomp)
            return vpf_set_error(VPF_ERR_PARSE, "jpeg: bad SOF ncomp %d",
                                 ncomp);
          for (int c = 0; c < ncomp; ++c) {
            comp[c].id = seg[6 + 3 * c];
            comp[c].hs = seg[7 + 3 * c] >> 4;
            comp[c].vs = seg[7 + 3 * c] & 15;
            comp[c].tq = seg[8 + 3 * c];
            if (comp[c].tq > 3) /* qtab[4]: OOB index from the wire */
              return vpf_set_error(VPF_ERR_PARSE, "jpeg: SOF quant id %d",
                                   comp[c].tq);
            if (comp[c].hs < 1 || comp[c].hs > 2 || comp[c].vs < 1 ||
                comp[c].vs > 2)
              return vpf_set_error(VPF_ERR,
                                   "jpeg: sampling %dx%d unsupported",
                                   comp[c].hs, comp[c].vs);
          }
          break;
        }
        case 0xDD: /* DRI */
          if (segn < 2)
            return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated DRI");
          restart = (seg[0] << 8) | seg[1];
          break;
        case 0xDA: { /* SOS */
          int rc = parse_sos(seg, segn);
          if (rc != VPF_OK) return rc;
          sos_data_off = i + 4 + segn;
          finish_geometry();
          return VPF_OK;
        }
        default:
          break; /* APPn/COM/etc: skip */
      }
      i += 2 + len;
    }
    return vpf_set_error(VPF_ERR_PARSE, "jpeg: no SOS marker");
  }

  int parse_dht(const uint8_t* seg, size_t segn) {
    size_t o = 0;
    while (o + 17 <= segn) {
      int tc = seg[o] >> 4, th = seg[o] & 15;
      if (th > 3)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: DHT id %d", th);
      const uint8_t* bl = seg + o + 1;
      int nv = 0;
      for (int l = 0; l < 16; ++l) nv += bl[l];
      if (nv > 256 || o + 17 + (size_t)nv > segn)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: bad DHT");
      (tc ? ac : dc)[th].build(bl, seg + o + 17, nv, tc != 0);
      o += 17 + nv;
    }
    return VPF_OK;
  }

  int parse_dqt(const uint8_t* seg, size_t segn) {
    /* zigzag order per T.81 B.2.4.1 */
    size_t o = 0;
    while (o < segn) {
      int pq = seg[o] >> 4, tq = seg[o] & 15;
      if (tq > 3)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: DQT id %d", tq);
      ++o;
      if (o + (pq ? 128u : 64u) > segn)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated DQT");
      for (int z = 0; z < 64; ++z) {
        if (pq) {
          qtab[tq][z] = (uint16_t)((seg[o] << 8) | seg[o + 1]);
          o += 2;
        } else {
          qtab[tq][z] = seg[o++];
        }
      }
      qtab_present[tq] = true;
    }
    return VPF_OK;
  }

  /* Scan header (T.81 B.2.3): component selectors + table ids, and the
   * progressive band parameters Ss/Se/Ah/Al. */
  int parse_sos(const uint8_t* seg, size_t segn) {
    if (!W)
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: SOS before SOF");
    if (segn < 1)
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated SOS");
    int ns = seg[0];
    if (ns < 1 || segn < 1 + 2 * (size_t)ns + 3)
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated SOS");
    if (!progressive && ns != ncomp)
      return vpf_set_error(
          VPF_ERR, "jpeg: non-interleaved scan (%d of %d components)",
          ns, ncomp);
    if (progressive && ns != ncomp && ns != 1)
      return vpf_set_error(
          VPF_ERR, "jpeg: subset-interleaved progressive scan (%d of %d "
          "components)", ns, ncomp);
    nscomp = ns;
    for (int s = 0; s < ns; ++s) {
      int cid = seg[1 + 2 * s];
      bool found = false;
      for (int c = 0; c < ncomp; ++c)
        if (comp[c].id == cid) {
          comp[c].td = seg[2 + 2 * s] >> 4;
          comp[c].ta = seg[2 + 2 * s] & 15;
          if (comp[c].td > 3 || comp[c].ta > 3)
            /* dc[4]/ac[4]: OOB index from the wire (found by the
             * fuzz gate: a flipped SOS selector byte segfaulted
             * decode_scan through a garbage HuffTable) */
            return vpf_set_error(VPF_ERR_PARSE,
                                 "jpeg: SOS Huffman id %d/%d",
                                 comp[c].td, comp[c].ta);
          scomp[s] = c;
          found = true;
        }
      if (!found)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: SOS component %d",
                             cid);
    }
    ss = seg[1 + 2 * ns];
    se = seg[2 + 2 * ns];
    ah = seg[3 + 2 * ns] >> 4;
    al = seg[3 + 2 * ns] & 15;
    if (progressive) {
      if (ss > 63 || se > 63 || se < ss || (ss == 0 && se != 0) ||
          ah > 13 || al > 13 || (ah != 0 && ah != al + 1))
        return vpf_set_error(VPF_ERR_PARSE,
                             "jpeg: bad progressive scan band %d-%d "
                             "Ah=%d Al=%d", ss, se, ah, al);
      if (ss > 0 && ns != 1) /* T.81 G.1: AC scans are non-interleaved */
        return vpf_set_error(VPF_ERR_PARSE,
                             "jpeg: interleaved progressive AC scan");
    }
    return VPF_OK;
  }

  void finish_geometry() {
    hmax = 1;
    vmax = 1;
    for (int c = 0; c < ncomp; ++c) {
      hmax = comp[c].hs > hmax ? comp[c].hs : hmax;
      vmax = comp[c].vs > vmax ? comp[c].vs : vmax;
    }
    mcux = (W + 8 * hmax - 1) / (8 * hmax);
    mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (int c = 0; c < ncomp; ++c) {
      comp[c].bw = mcux * comp[c].hs;
      comp[c].bh = mcuy * comp[c].vs;
      /* non-interleaved grid: ceil(ceil(dim*sampling/max)/8) */
      int cw = (W * comp[c].hs + hmax - 1) / hmax;
      int ch = (H * comp[c].vs + vmax - 1) / vmax;
      comp[c].sw = (cw + 7) / 8;
      comp[c].sh = (ch + 7) / 8;
    }
  }
  int mcux = 0, mcuy = 0;

  int decode_scan(int16_t* const* out) {
    for (int c = 0; c < ncomp; ++c) {
      if (!dc[comp[c].td].present || !ac[comp[c].ta].present)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: missing Huffman table");
      comp[c].dcpred = 0;
      memset(out[c], 0,
             (size_t)comp[c].bw * comp[c].bh * 64 * sizeof(int16_t));
    }
    EntropyData ed;
    ed.destuff(d, n, sos_data_off);
    BitReader br(ed);
    int mcu_count = 0;
    for (int my = 0; my < mcuy; ++my) {
      for (int mx = 0; mx < mcux; ++mx) {
        if (restart && mcu_count && mcu_count % restart == 0) {
          if (!br.align_restart())
            return vpf_set_error(VPF_ERR_PARSE,
                                 "jpeg: missing restart marker");
          for (int c = 0; c < ncomp; ++c) comp[c].dcpred = 0;
        }
        for (int c = 0; c < ncomp; ++c) {
          Comp& cc = comp[c];
          const HuffTable& dt = dc[cc.td];
          const HuffTable& at = ac[cc.ta];
          for (int by = 0; by < cc.vs; ++by) {
            for (int bx = 0; bx < cc.hs; ++bx) {
              int bidx = (my * cc.vs + by) * cc.bw + (mx * cc.hs + bx);
              int16_t* blk = out[c] + (size_t)bidx * 64;
              /* DC: one refill covers LUT (≤12+11 bits) or slow
               * (≤16+11); per-symbol worst case < 32 bits */
              if (br.nbits < 32) br.refill();
              int32_t e = dt.flut[br.peek(HuffTable::LUT_BITS)];
              if (e < 0) {
                br.skip((e >> 20) & 63);
                cc.dcpred += (int16_t)(e & 0xFFFF);
              } else if (e) {
                br.skip((e >> 20) & 63);
                int s = e & 0xFF;
                if (s > 15)
                  return vpf_set_error(VPF_ERR_PARSE,
                                       "jpeg: bad DC code (mcu %d)",
                                       mcu_count);
                cc.dcpred += br.receive_extend(s);
              } else {
                int s = decode_huff_slow(br, dt);
                if (s < 0 || s > 15)
                  return vpf_set_error(VPF_ERR_PARSE,
                                       "jpeg: bad DC code (mcu %d)",
                                       mcu_count);
                cc.dcpred += br.receive_extend(s);
              }
              blk[0] = (int16_t)cc.dcpred;
              int k = 1;
              while (k < 64) {
                if (br.nbits < 32) br.refill();
                e = at.flut[br.peek(HuffTable::LUT_BITS)];
                int r, sz;
                if (e < 0) { /* full: value embedded (0 = EOB/ZRL) */
                  br.skip((e >> 20) & 63);
                  int16_t val = (int16_t)(e & 0xFFFF);
                  r = (e >> 16) & 15;
                  if (val == 0) {
                    if (r != 15) break; /* EOB */
                    k += 16;            /* ZRL */
                    continue;
                  }
                  k += r;
                  if (k > 63)
                    return vpf_set_error(VPF_ERR_PARSE,
                                         "jpeg: AC index overflow");
                  blk[k] = val;
                  if (k > max_k) max_k = k;
                  ++k;
                  continue;
                }
                int rs;
                if (e) { /* symbol only */
                  br.skip((e >> 20) & 63);
                  rs = e & 0xFF;
                } else {
                  rs = decode_huff_slow(br, at);
                  if (rs < 0)
                    return vpf_set_error(VPF_ERR_PARSE,
                                         "jpeg: bad AC code (mcu %d)",
                                         mcu_count);
                }
                r = rs >> 4;
                sz = rs & 15;
                if (!sz) {
                  if (r != 15) break; /* EOB */
                  k += 16;            /* ZRL */
                } else {
                  k += r;
                  if (k > 63)
                    return vpf_set_error(VPF_ERR_PARSE,
                                         "jpeg: AC index overflow");
                  blk[k] = (int16_t)br.receive_extend(sz);
                  if (k > max_k) max_k = k;
                  ++k;
                }
              }
            }
          }
        }
        ++mcu_count;
      }
    }
    end_off = ed.end_src; /* just past EOI (recorded by the destuffer) */
    return VPF_OK;
  }

  /* ---- progressive (SOF2) scan decoding, T.81 Annex G ----
   *
   * Progressive streams split the coefficients across many scans
   * (spectral bands × successive-approximation passes); after all scans
   * the output is the same zigzag int16 coefficient planes as baseline,
   * so the device half (dequant+IDCT matmuls) is unchanged. */

  static inline int get_bit(BitReader& br) {
    if (br.nbits < 1) br.refill();
    int v = (int)br.peek(1);
    br.skip(1);
    return v;
  }

  static inline uint32_t receive_raw(BitReader& br, int nb) { /* nb ≥ 1 */
    if (br.nbits < nb) br.refill();
    uint32_t v = br.peek(nb);
    br.skip(nb);
    return v;
  }

  /* One DC difference (Huffman symbol + EXTENDed magnitude), shared by
   * DC-first scans; same combined-LUT fast path as the baseline loop. */
  int decode_dc_diff(BitReader& br, const HuffTable& dt, int32_t* diff) {
    if (br.nbits < 32) br.refill();
    int32_t e = dt.flut[br.peek(HuffTable::LUT_BITS)];
    if (e < 0) {
      br.skip((e >> 20) & 63);
      *diff = (int16_t)(e & 0xFFFF);
      return VPF_OK;
    }
    int s;
    if (e) {
      br.skip((e >> 20) & 63);
      s = e & 0xFF;
    } else {
      s = decode_huff_slow(br, dt);
    }
    if (s < 0 || s > 15)
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: bad DC code");
    *diff = br.receive_extend(s);
    return VPF_OK;
  }

  /* One AC Huffman symbol. Fast path: *has_val=true and *val holds the
   * EXTENDed coefficient (0 ⇒ EOB/ZRL class, run in *run). Slow path:
   * *has_val=false, caller receive_extends *size bits itself. */
  int decode_ac(BitReader& br, const HuffTable& at, int* run, int* size,
                int32_t* val, bool* has_val) {
    if (br.nbits < 32) br.refill();
    int32_t e = at.flut[br.peek(HuffTable::LUT_BITS)];
    if (e < 0) {
      br.skip((e >> 20) & 63);
      *run = (e >> 16) & 15;
      *val = (int16_t)(e & 0xFFFF);
      *size = 0;
      *has_val = true;
      return VPF_OK;
    }
    int rs;
    if (e) {
      br.skip((e >> 20) & 63);
      rs = e & 0xFF;
    } else {
      rs = decode_huff_slow(br, at);
      if (rs < 0)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: bad AC code");
    }
    *run = rs >> 4;
    *size = rs & 15;
    *val = 0;
    *has_val = false;
    return VPF_OK;
  }

  int prog_dc_first(BitReader& br, Comp& cc, int16_t* blk) {
    int32_t diff;
    int rc = decode_dc_diff(br, dc[cc.td], &diff);
    if (rc != VPF_OK) return rc;
    cc.dcpred += diff;
    blk[0] = (int16_t)(cc.dcpred * (1 << al)); /* value << Al, G.1.2.1 */
    return VPF_OK;
  }

  int prog_dc_refine(BitReader& br, int16_t* blk) {
    if (get_bit(br)) blk[0] = (int16_t)(blk[0] | (1 << al));
    return VPF_OK;
  }

  int prog_ac_first(BitReader& br, const HuffTable& at, int16_t* blk) {
    if (eobrun > 0) { /* inside an end-of-band run: block has no data */
      --eobrun;
      return VPF_OK;
    }
    int k = ss;
    while (k <= se) {
      int run, size;
      int32_t val;
      bool has_val;
      int rc = decode_ac(br, at, &run, &size, &val, &has_val);
      if (rc != VPF_OK) return rc;
      if ((has_val && val == 0) || (!has_val && size == 0)) {
        if (run == 15) { /* ZRL */
          k += 16;
          continue;
        }
        /* EOBn: this block ends now; run-1 more blocks are empty */
        eobrun = (1u << run) - 1;
        if (run) eobrun += receive_raw(br, run);
        break;
      }
      k += run;
      if (k > se)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: AC index overflow");
      int32_t v = has_val ? val : br.receive_extend(size);
      blk[k] = (int16_t)(v * (1 << al));
      if (k > max_k) max_k = k;
      ++k;
    }
    return VPF_OK;
  }

  int prog_ac_refine(BitReader& br, const HuffTable& at, int16_t* blk) {
    const int32_t p1 = 1 << al, m1 = -(1 << al);
    int k = ss;
    if (eobrun == 0) {
      for (; k <= se; ++k) {
        int run, size;
        int32_t val;
        bool has_val;
        int rc = decode_ac(br, at, &run, &size, &val, &has_val);
        if (rc != VPF_OK) return rc;
        int32_t newval = 0;
        if (has_val ? (val != 0) : (size != 0)) {
          /* correction scans may only introduce ±1·2^Al (G.1.2.3) */
          if (has_val ? (val != 1 && val != -1) : (size != 1))
            return vpf_set_error(VPF_ERR_PARSE,
                                 "jpeg: bad AC refine magnitude");
          int32_t sgn = has_val ? val : br.receive_extend(1);
          newval = sgn > 0 ? p1 : m1;
        } else if (run != 15) { /* EOBn (run == 15 ⇒ ZRL, newval 0) */
          eobrun = 1u << run;
          if (run) eobrun += receive_raw(br, run);
          break; /* remaining coefficients handled in the EOB pass */
        }
        /* advance over `run` zero-history coefficients, emitting a
         * correction bit for every nonzero one passed */
        while (k <= se) {
          int16_t* coef = blk + k;
          if (*coef != 0) {
            if (get_bit(br) && (*coef & p1) == 0)
              *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
          } else {
            if (run == 0) break;
            --run;
          }
          ++k;
        }
        if (newval != 0) {
          if (k > se)
            return vpf_set_error(VPF_ERR_PARSE,
                                 "jpeg: AC refine index overflow");
          blk[k] = (int16_t)newval;
          if (k > max_k) max_k = k;
        }
      }
    }
    if (eobrun > 0) { /* EOB run covers this block: corrections only */
      for (; k <= se; ++k) {
        int16_t* coef = blk + k;
        if (*coef != 0 && get_bit(br) && (*coef & p1) == 0)
          *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
      }
      --eobrun;
    }
    return VPF_OK;
  }

  int decode_scan_progressive(const EntropyData& ed, int16_t* const* out) {
    const bool dc_scan = (ss == 0);
    for (int s = 0; s < nscomp; ++s) {
      Comp& cc = comp[scomp[s]];
      if (dc_scan && ah == 0) {
        if (!dc[cc.td].present)
          return vpf_set_error(VPF_ERR_PARSE, "jpeg: missing Huffman table");
        cc.dcpred = 0;
      }
      if (!dc_scan && !ac[cc.ta].present)
        return vpf_set_error(VPF_ERR_PARSE, "jpeg: missing Huffman table");
    }
    eobrun = 0;
    BitReader br(ed);
    int rc;
    if (nscomp > 1) { /* interleaved DC scan over the frame MCU grid */
      int mcu_count = 0;
      for (int my = 0; my < mcuy; ++my) {
        for (int mx = 0; mx < mcux; ++mx) {
          if (restart && mcu_count && mcu_count % restart == 0) {
            if (!br.align_restart())
              return vpf_set_error(VPF_ERR_PARSE,
                                   "jpeg: missing restart marker");
            for (int s = 0; s < nscomp; ++s) comp[scomp[s]].dcpred = 0;
          }
          for (int s = 0; s < nscomp; ++s) {
            Comp& cc = comp[scomp[s]];
            for (int by = 0; by < cc.vs; ++by)
              for (int bx = 0; bx < cc.hs; ++bx) {
                int bidx = (my * cc.vs + by) * cc.bw + (mx * cc.hs + bx);
                int16_t* blk = out[scomp[s]] + (size_t)bidx * 64;
                rc = ah == 0 ? prog_dc_first(br, cc, blk)
                             : prog_dc_refine(br, blk);
                if (rc != VPF_OK) return rc;
              }
          }
          ++mcu_count;
        }
      }
    } else { /* non-interleaved: the component's own block grid */
      const int ci = scomp[0];
      Comp& cc = comp[ci];
      const HuffTable& at = ac[cc.ta];
      int blk_count = 0;
      for (int by = 0; by < cc.sh; ++by) {
        for (int bx = 0; bx < cc.sw; ++bx) {
          if (restart && blk_count && blk_count % restart == 0) {
            if (!br.align_restart())
              return vpf_set_error(VPF_ERR_PARSE,
                                   "jpeg: missing restart marker");
            cc.dcpred = 0;
            eobrun = 0;
          }
          int16_t* blk = out[ci] + ((size_t)by * cc.bw + bx) * 64;
          if (dc_scan)
            rc = ah == 0 ? prog_dc_first(br, cc, blk)
                         : prog_dc_refine(br, blk);
          else
            rc = ah == 0 ? prog_ac_first(br, at, blk)
                         : prog_ac_refine(br, at, blk);
          if (rc != VPF_OK) return rc;
          ++blk_count;
        }
      }
    }
    return VPF_OK;
  }

  /* DHT/DQT/DRI may be redefined between scans; SOS starts the next
   * scan; EOI ends the frame. */
  int decode_progressive(int16_t* const* out) {
    for (int c = 0; c < ncomp; ++c) {
      comp[c].dcpred = 0;
      memset(out[c], 0,
             (size_t)comp[c].bw * comp[c].bh * 64 * sizeof(int16_t));
    }
    size_t pos = sos_data_off;
    /* 4 comps × (1 DC + 63 AC bands) × 14 approximation passes is the
     * theoretical scan ceiling; anything past it is a stuck stream */
    for (int scan_no = 0; scan_no < 4 * 64 * 14; ++scan_no) {
      EntropyData ed;
      ed.destuff(d, n, pos);
      int rc = decode_scan_progressive(ed, out);
      if (rc != VPF_OK) return rc;
      if (ed.end_marker == 0xD9 || ed.end_marker == 0) {
        end_off = ed.end_src ? ed.end_src : n;
        return VPF_OK;
      }
      size_t i = ed.end_src; /* points at the 0xFF of the ending marker */
      bool next_scan = false;
      while (i + 2 <= n && !next_scan) {
        if (d[i] != 0xFF) {
          ++i;
          continue;
        }
        uint8_t m = d[i + 1];
        if (m == 0xFF) {
          ++i;
          continue;
        }
        if (m == 0xD9) {
          end_off = i + 2;
          return VPF_OK;
        }
        if (m == 0x01 || (m >= 0xD0 && m <= 0xD8)) {
          i += 2;
          continue;
        }
        if (i + 4 > n)
          return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated tail");
        size_t len = ((size_t)d[i + 2] << 8) | d[i + 3];
        if (len < 2 || i + 2 + len > n)
          return vpf_set_error(VPF_ERR_PARSE,
                               "jpeg: truncated segment 0x%02x", m);
        const uint8_t* seg = d + i + 4;
        size_t segn = len - 2;
        switch (m) {
          case 0xC4:
            rc = parse_dht(seg, segn);
            if (rc != VPF_OK) return rc;
            break;
          case 0xDB:
            rc = parse_dqt(seg, segn);
            if (rc != VPF_OK) return rc;
            break;
          case 0xDD:
            if (segn < 2)
              return vpf_set_error(VPF_ERR_PARSE, "jpeg: truncated DRI");
            restart = (seg[0] << 8) | seg[1];
            break;
          case 0xDA:
            rc = parse_sos(seg, segn);
            if (rc != VPF_OK) return rc;
            pos = i + 4 + segn;
            next_scan = true;
            break;
          case 0xC0:
          case 0xC1:
          case 0xC2:
            return vpf_set_error(VPF_ERR_PARSE,
                                 "jpeg: multiple frames in image");
          default:
            break; /* APPn/COM/DNL: skip */
        }
        i += 2 + len;
      }
      if (!next_scan)
        return vpf_set_error(VPF_ERR_PARSE,
                             "jpeg: stream ends mid-frame (no EOI)");
    }
    return vpf_set_error(VPF_ERR_PARSE, "jpeg: too many scans");
  }
};

}  // namespace

/* ---- C ABI (mirrored by ctypes in io/_jpeg_lib.py) ---- */

typedef struct VpfJpegInfo {
  uint32_t width;
  uint32_t height;
  uint32_t ncomp;
  uint32_t hs[4];
  uint32_t vs[4];
  uint32_t bw[4]; /* block-grid width per component (padded to MCU) */
  uint32_t bh[4];
  uint16_t qt[4][64]; /* per-COMPONENT quant table, zigzag order */
  uint32_t restart_interval;
  uint32_t max_k; /* parse only: max nonzero zigzag index in the frame */
  uint32_t consumed; /* parse only: bytes consumed incl. EOI */
  uint32_t progressive; /* 1 = SOF2 multi-scan stream */
} VpfJpegInfo;

static void fill_info(const Parser& ps, VpfJpegInfo* out) {
  memset(out, 0, sizeof(*out));
  out->width = ps.W;
  out->height = ps.H;
  out->ncomp = ps.ncomp;
  for (int c = 0; c < ps.ncomp; ++c) {
    out->hs[c] = ps.comp[c].hs;
    out->vs[c] = ps.comp[c].vs;
    out->bw[c] = ps.comp[c].bw;
    out->bh[c] = ps.comp[c].bh;
    memcpy(out->qt[c], ps.qtab[ps.comp[c].tq], sizeof(out->qt[c]));
  }
  out->restart_interval = ps.restart;
  out->progressive = ps.progressive ? 1 : 0;
}

/* Parse headers only (through SOS): geometry + quant tables. Quant tables
 * may legally arrive after a previous frame's scan in MJPEG, but every
 * libav-muxed MJPEG frame is self-contained; a stream whose tables are
 * missing at SOS time errors here. */
VPF_API int vpf_jpeg_probe(const uint8_t* data, size_t size,
                           VpfJpegInfo* out) {
  Parser ps{data, size};
  int rc = ps.parse_headers();
  if (rc != VPF_OK) return rc;
  for (int c = 0; c < ps.ncomp; ++c)
    if (!ps.qtab_present[ps.comp[c].tq])
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: missing quant table %d",
                           ps.comp[c].tq);
  fill_info(ps, out);
  return VPF_OK;
}

/* Full entropy decode of one JPEG image. comp_out: ncomp pointers, each
 * to a [bh*bw][64] int16 buffer (zigzag order, zero-filled by this call),
 * sized from a prior probe; comp_caps gives each buffer's capacity in
 * BLOCKS. A mid-stream geometry change that would overflow a buffer
 * errors with VPF_ERR_DECODE before any write (the caller re-probes and
 * reallocates, mirroring the decoder's res-change contract). */
/* ======================= entropy ENCODER ============================
 *
 * The host half of the split MJPEG *encoder* (the mirror of the decoder
 * above): the device runs CSC + 4:2:0 downsample + forward DCT + quant
 * as batched matmuls (ops/jpeg.py fdct_quant_basis) and hands back
 * int16 zigzag coefficient blocks; this serializes them into a complete
 * baseline JFIF image (SOI/APP0/DQT/SOF0/DHT/SOS/scan/EOI) with the
 * Annex K Huffman tables. Only the serial bit-packing runs on the host —
 * measured far cheaper than libav's full mjpeg encode, whose fDCT+quant
 * pixel loop dominates. Reference analog: NvEncoder's bitstream
 * serialization half (src/TC/src/NvEncoder.cpp), which likewise receives
 * transformed data from the parallel hardware.
 */

namespace {

/* ITU T.81 Annex K typical Huffman tables (K.3-K.6). Emitted in our DHT
 * segments, so decode compatibility never depends on these exact values —
 * they only set the compression efficiency. */
const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
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

/* symbol → (code, length), derived from a (bits, vals) pair the same way
 * the decoder's HuffTable assigns codes. */
struct EncHuff {
  uint16_t code[256];
  uint8_t size[256];

  void build(const uint8_t* bits, const uint8_t* vals, int nvals) {
    memset(size, 0, sizeof(size));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i) {
        code[vals[k]] = (uint16_t)c;
        size[vals[k]] = (uint8_t)l;
        ++c;
        ++k;
      }
      c <<= 1;
    }
    (void)nvals;
  }
};

/* MSB-first bit writer with JPEG 0xFF byte stuffing, writing straight
 * into the caller's buffer. A 64-bit accumulator defers byte emission to
 * 4-byte flushes; the common no-0xFF word goes out as one bswap'd store
 * (per-byte stuffing only on the rare word that contains 0xFF). The
 * worst case is bounds-checked per flush (overflow latches; caller
 * checks once at the end). This is the pack hot loop: the vector
 * push_back-per-byte version it replaced measured 4.7x slower at
 * 1080p/400 KB frames. */
struct BitWriter {
  uint8_t* p;
  uint8_t* end;
  uint64_t acc = 0;
  int nbits = 0;
  bool overflow = false;

  BitWriter(uint8_t* cur, uint8_t* e) : p(cur), end(e) {}

  inline void flush32() {
    nbits -= 32;
    uint32_t w = (uint32_t)(acc >> nbits);
    if (p + 8 > end) {
      overflow = true;
      return;
    }
    /* detect any 0xFF byte in w: haszero(~w) */
    uint32_t nv = ~w;
    if (((nv - 0x01010101u) & w & 0x80808080u) == 0) {
      uint32_t be = __builtin_bswap32(w);
      memcpy(p, &be, 4);
      p += 4;
    } else {
      uint8_t b;
      b = (uint8_t)(w >> 24); *p++ = b; if (b == 0xFF) *p++ = 0;
      b = (uint8_t)(w >> 16); *p++ = b; if (b == 0xFF) *p++ = 0;
      b = (uint8_t)(w >> 8);  *p++ = b; if (b == 0xFF) *p++ = 0;
      b = (uint8_t)(w);       *p++ = b; if (b == 0xFF) *p++ = 0;
    }
  }

  /* n ≤ 27 (a 16-bit code fused with ≤11 magnitude bits); acc holds
   * < 32 pending bits, so shifts never overflow 64. */
  inline void put(uint32_t bits, int n) {
    acc = (acc << n) | (uint64_t)(bits & ((1u << n) - 1));
    nbits += n;
    if (nbits >= 32) flush32();
  }

  /* pad to a byte boundary with 1-bits (T.81 F.1.2.3) and drain */
  void align() {
    if (nbits & 7) put(0x7F, 8 - (nbits & 7));
    while (nbits >= 8) {
      nbits -= 8;
      uint8_t b = (uint8_t)(acc >> nbits);
      if (p + 2 > end) {
        overflow = true;
        return;
      }
      *p++ = b;
      if (b == 0xFF) *p++ = 0;
    }
  }
};

inline int mag_category(int v) {
  uint32_t a = v < 0 ? -v : v;
  return a ? 32 - __builtin_clz(a) : 0;
}

struct EncComp {
  const int16_t* coeffs; /* [bh*bw][64] zigzag */
  int hs, vs, bw, bh;
  const EncHuff* dc;
  const EncHuff* ac;
  int32_t pred = 0;
};

/* One block: DC diff + RLE'd AC, per T.81 F.2. AC values are clamped to
 * the 8-bit-baseline ±1023 envelope (only reachable at quant step 1).
 *
 * The AC scan builds a 64-bit nonzero mask (8 SSE2 compare+pack ops per
 * block) and then iterates ONLY the set bits via ctz — quantized blocks
 * are 80-95% zeros, so this replaces the 63-iteration scan with
 * ~nnz iterations; measured 2.1x on the pack hot loop at 1080p. */
inline void encode_block(BitWriter& bw, EncComp& c, const int16_t* blk) {
  int32_t dc = blk[0];
  int32_t diff = dc - c.pred;
  /* 8-bit baseline caps DC diff categories at 11 (±2047); reachable only
   * at quant step 1 with a ±1024 DC swing. Track the clamp in the
   * predictor so the decoder's reconstruction stays consistent. */
  if (diff > 2047) diff = 2047;
  if (diff < -2047) diff = -2047;
  c.pred += diff;
  int s = mag_category(diff);
  /* fused symbol + magnitude emit: one put per coefficient */
  bw.put(((uint32_t)c.dc->code[s] << s) |
             ((uint32_t)(diff >= 0 ? diff : diff - 1) & ((1u << s) - 1)),
         c.dc->size[s] + s);

#ifdef VPF_JPEG_SSE2
  uint64_t m = 0;
  {
    const __m128i z = _mm_setzero_si128();
    for (int i = 0; i < 4; ++i) {
      __m128i a = _mm_loadu_si128((const __m128i*)(blk + i * 16));
      __m128i b = _mm_loadu_si128((const __m128i*)(blk + i * 16 + 8));
      __m128i eq = _mm_packs_epi16(_mm_cmpeq_epi16(a, z),
                                   _mm_cmpeq_epi16(b, z));
      m |= (uint64_t)(~(uint32_t)_mm_movemask_epi8(eq) & 0xFFFFu)
           << (i * 16);
    }
  }
  m &= ~1ull; /* DC handled above */
  int last = 0;
  while (m) {
    int k = __builtin_ctzll(m);
    m &= m - 1;
    int run = k - last - 1;
    last = k;
    while (run > 15) {
      bw.put(c.ac->code[0xF0], c.ac->size[0xF0]); /* ZRL */
      run -= 16;
    }
    int v = blk[k];
    if (v > 1023) v = 1023;
    if (v < -1023) v = -1023;
    s = mag_category(v);
    int rs = (run << 4) | s;
    bw.put(((uint32_t)c.ac->code[rs] << s) |
               ((uint32_t)(v >= 0 ? v : v - 1) & ((1u << s) - 1)),
           c.ac->size[rs] + s);
  }
  if (last != 63) bw.put(c.ac->code[0x00], c.ac->size[0x00]); /* EOB */
#else
  int run = 0;
  for (int k = 1; k < 64;) {
    if (!(k & 3)) {
      uint64_t w4;
      memcpy(&w4, blk + k, 8);
      if (!w4) {
        run += 4;
        k += 4;
        continue;
      }
    }
    int v = blk[k];
    ++k;
    if (!v) {
      ++run;
      continue;
    }
    while (run > 15) {
      bw.put(c.ac->code[0xF0], c.ac->size[0xF0]); /* ZRL */
      run -= 16;
    }
    if (v > 1023) v = 1023;
    if (v < -1023) v = -1023;
    s = mag_category(v);
    int rs = (run << 4) | s;
    bw.put(((uint32_t)c.ac->code[rs] << s) |
               ((uint32_t)(v >= 0 ? v : v - 1) & ((1u << s) - 1)),
           c.ac->size[rs] + s);
    run = 0;
  }
  if (run) bw.put(c.ac->code[0x00], c.ac->size[0x00]); /* EOB */
#endif
}

/* header serialization cursor (headers are tiny and bounds-checked once
 * up front; the scan goes through BitWriter) */
struct Cur {
  uint8_t* p;
  void u8(uint8_t v) { *p++ = v; }
  void u16(uint16_t v) {
    *p++ = (uint8_t)(v >> 8);
    *p++ = (uint8_t)v;
  }
  void marker(uint8_t m) {
    *p++ = 0xFF;
    *p++ = m;
  }
  void bytes(const uint8_t* d, size_t n) {
    memcpy(p, d, n);
    p += n;
  }
};

}  // namespace

typedef struct VpfJpegEncParams {
  uint32_t width;
  uint32_t height;
  uint32_t ncomp;            /* 1 (gray) or 3 (YCbCr) */
  uint32_t subsampled;       /* 0 = 4:4:4, 1 = 4:2:0, 2 = 4:2:2
                                (3-component only) */
  uint32_t restart_interval; /* MCUs between RSTn markers; 0 = none */
  uint16_t qt_luma[64];      /* zigzag order */
  uint16_t qt_chroma[64];    /* zigzag order (unused when ncomp == 1) */
} VpfJpegEncParams;

/* Serialize one baseline JFIF image from device-produced coefficients.
 * comp_coeffs[c]: [bh*bw][64] int16 zigzag blocks, row-major block grid
 * padded to the MCU multiple — the exact layout vpf_jpeg_parse emits and
 * ops/jpeg.py's forward path produces. Writes ≤ cap bytes into out and
 * the byte count into out_size; VPF_ERR if cap is too small. */
VPF_API int vpf_jpeg_encode(const VpfJpegEncParams* p,
                            const int16_t* const* comp_coeffs, uint8_t* out,
                            size_t cap, size_t* out_size) {
  if (!p || !comp_coeffs || !out || !out_size)
    return vpf_set_error(VPF_ERR, "jpeg_encode: null argument");
  int W = (int)p->width, H = (int)p->height, nc = (int)p->ncomp;
  if (W <= 0 || H <= 0 || W > 65535 || H > 65535)
    return vpf_set_error(VPF_ERR, "jpeg_encode: bad dimensions %dx%d", W, H);
  if (nc != 1 && nc != 3)
    return vpf_set_error(VPF_ERR, "jpeg_encode: ncomp %d (need 1 or 3)", nc);
  int mode = nc == 3 ? (int)p->subsampled : 0; /* 0=444, 1=420, 2=422 */
  if (mode < 0 || mode > 2)
    return vpf_set_error(VPF_ERR, "jpeg_encode: sampling mode %d", mode);

  EncHuff dcl, dcc, acl, acc;
  dcl.build(kDcLumaBits, kDcVals, 12);
  acl.build(kAcLumaBits, kAcLumaVals, 162);
  if (nc == 3) {
    dcc.build(kDcChromaBits, kDcVals, 12);
    acc.build(kAcChromaBits, kAcChromaVals, 162);
  }

  int sx = mode ? 2 : 1;            /* luma horizontal sampling */
  int sy = (mode == 1) ? 2 : 1;     /* luma vertical sampling   */
  int mcux = (W + 8 * sx - 1) / (8 * sx);
  int mcuy = (H + 8 * sy - 1) / (8 * sy);
  EncComp comp[3];
  for (int c = 0; c < nc; ++c) {
    comp[c].coeffs = comp_coeffs[c];
    comp[c].hs = (c == 0) ? sx : 1;
    comp[c].vs = (c == 0) ? sy : 1;
    comp[c].bw = mcux * comp[c].hs;
    comp[c].bh = mcuy * comp[c].vs;
    comp[c].dc = (c == 0) ? &dcl : &dcc;
    comp[c].ac = (c == 0) ? &acl : &acc;
  }

  if (cap < 2048)
    return vpf_set_error(VPF_ERR, "jpeg_encode: capacity %zu too small",
                         cap);
  Cur o{out};
  o.marker(0xD8); /* SOI */
  /* APP0 JFIF 1.01, no thumbnail */
  o.marker(0xE0);
  o.u16(16);
  const uint8_t jfif[] = {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.bytes(jfif, sizeof(jfif));
  /* DQT — 8-bit (Pq=0) only: T.81 B.2.4.1 forbids 16-bit tables in a
   * baseline (SOF0) frame, and strict decoders reject the combination */
  for (int t = 0; t < (nc == 3 ? 2 : 1); ++t) {
    const uint16_t* q = t ? p->qt_chroma : p->qt_luma;
    for (int z = 0; z < 64; ++z)
      if (q[z] > 255)
        return vpf_set_error(
            VPF_ERR,
            "jpeg_encode: quant value %u > 255 (baseline is 8-bit)",
            (unsigned)q[z]);
    o.marker(0xDB);
    o.u16((uint16_t)(3 + 64));
    o.u8((uint8_t)t);
    for (int z = 0; z < 64; ++z) o.u8((uint8_t)(q[z] ? q[z] : 1));
  }
  /* SOF0 */
  o.marker(0xC0);
  o.u16((uint16_t)(8 + 3 * nc));
  o.u8(8);
  o.u16((uint16_t)H);
  o.u16((uint16_t)W);
  o.u8((uint8_t)nc);
  for (int c = 0; c < nc; ++c) {
    o.u8((uint8_t)(c + 1));
    o.u8((uint8_t)((comp[c].hs << 4) | comp[c].vs));
    o.u8((uint8_t)(c == 0 ? 0 : 1));
  }
  /* DHT */
  auto dht = [&](int cls, int id, const uint8_t* bits, const uint8_t* vals) {
    int nv = 0;
    for (int l = 0; l < 16; ++l) nv += bits[l];
    o.marker(0xC4);
    o.u16((uint16_t)(2 + 1 + 16 + nv));
    o.u8((uint8_t)((cls << 4) | id));
    o.bytes(bits, 16);
    o.bytes(vals, (size_t)nv);
  };
  dht(0, 0, kDcLumaBits, kDcVals);
  dht(1, 0, kAcLumaBits, kAcLumaVals);
  if (nc == 3) {
    dht(0, 1, kDcChromaBits, kDcVals);
    dht(1, 1, kAcChromaBits, kAcChromaVals);
  }
  /* DRI */
  if (p->restart_interval) {
    o.marker(0xDD);
    o.u16(4);
    o.u16((uint16_t)p->restart_interval);
  }
  /* SOS */
  o.marker(0xDA);
  o.u16((uint16_t)(6 + 2 * nc));
  o.u8((uint8_t)nc);
  for (int c = 0; c < nc; ++c) {
    o.u8((uint8_t)(c + 1));
    o.u8((uint8_t)(c == 0 ? 0x00 : 0x11));
  }
  o.u8(0);
  o.u8(63);
  o.u8(0);

  BitWriter bw(o.p, out + cap - 2 /* room for EOI */);
  int mcu_count = 0, rst = 0;
  for (int my = 0; my < mcuy; ++my) {
    for (int mx = 0; mx < mcux; ++mx) {
      if (p->restart_interval && mcu_count &&
          mcu_count % (int)p->restart_interval == 0) {
        bw.align();
        if (bw.p + 2 <= bw.end) {
          *bw.p++ = 0xFF;
          *bw.p++ = (uint8_t)(0xD0 + (rst++ & 7));
        } else {
          bw.overflow = true;
        }
        for (int c = 0; c < nc; ++c) comp[c].pred = 0;
      }
      for (int c = 0; c < nc; ++c) {
        EncComp& cc = comp[c];
        for (int by = 0; by < cc.vs; ++by)
          for (int bx = 0; bx < cc.hs; ++bx) {
            int bidx = (my * cc.vs + by) * cc.bw + (mx * cc.hs + bx);
            encode_block(bw, cc, cc.coeffs + (size_t)bidx * 64);
          }
      }
      ++mcu_count;
    }
  }
  bw.align();
  if (bw.overflow)
    return vpf_set_error(VPF_ERR,
                         "jpeg_encode: output exceeds capacity %zu", cap);
  Cur tail{bw.p};
  tail.marker(0xD9); /* EOI */
  *out_size = (size_t)(tail.p - out);
  return VPF_OK;
}

VPF_API int vpf_jpeg_parse(const uint8_t* data, size_t size,
                           VpfJpegInfo* out, int16_t* const* comp_out,
                           const uint32_t* comp_caps) {
  Parser ps{data, size};
  int rc = ps.parse_headers();
  if (rc != VPF_OK) return rc;
  for (int c = 0; c < ps.ncomp; ++c) {
    if (!ps.qtab_present[ps.comp[c].tq])
      return vpf_set_error(VPF_ERR_PARSE, "jpeg: missing quant table %d",
                           ps.comp[c].tq);
    uint32_t need = (uint32_t)(ps.comp[c].bw * ps.comp[c].bh);
    if (comp_caps && need > comp_caps[c])
      return vpf_set_error(
          VPF_ERR_DECODE,
          "jpeg: geometry changed (component %d needs %u blocks, buffer "
          "holds %u) — re-probe and reallocate",
          c, need, comp_caps[c]);
  }
  rc = ps.progressive ? ps.decode_progressive(comp_out)
                      : ps.decode_scan(comp_out);
  if (rc != VPF_OK) return rc;
  fill_info(ps, out);
  out->max_k = ps.max_k;
  out->consumed = (uint32_t)ps.end_off;
  return VPF_OK;
}
