// Baseline JPEG entropy coder: the host half of the tpujpeg encoder.
//
// The device computes the quality-independent analysis (YCbCr, 8x8 DCTs,
// activity field — kernels/jpeg_enc.py); the host quantizes per quality and
// this file turns quantized coefficient planes into a JFIF bytestream with
// two-pass OPTIMIZED Huffman tables (histogram -> canonical length-limited
// codes -> emit), the same always-optimize choice jpegli-style encoders
// make.  Role parity: the bit-writing half of the reference's zenjpeg crate
// (reference: crates/codec-compare/src/encoders/zenjpeg.rs:10-58).
//
// All coefficient and quantization-table inputs are in ZIGZAG order.
// Interleaved single-scan baseline (SOF0), 3 components, no restarts.

#include <cstdint>
#include <cstring>

namespace {

struct BitWriter {
    uint8_t* buf;
    size_t cap;
    size_t pos;
    uint32_t bitbuf;   // pending bits, MSB-aligned within the low `nbits`
    int nbits;
    bool overflow;
    size_t stuffed;    // 0x00 bytes inserted after 0xFF in entropy data

    void put_byte(uint8_t b) {
        if (pos >= cap) { overflow = true; return; }
        buf[pos++] = b;
    }

    void put_bits(uint32_t code, int size) {
        // Accumulate into a 32-bit buffer; spill full bytes with FF stuffing.
        bitbuf = (bitbuf << size) | (code & ((1u << size) - 1u));
        nbits += size;
        while (nbits >= 8) {
            uint8_t b = uint8_t((bitbuf >> (nbits - 8)) & 0xFF);
            put_byte(b);
            if (b == 0xFF) { put_byte(0x00); ++stuffed; }
            nbits -= 8;
        }
    }

    void flush() {
        if (nbits > 0) {
            uint8_t b = uint8_t(
                ((bitbuf << (8 - nbits)) | ((1u << (8 - nbits)) - 1u)) & 0xFF);
            put_byte(b);
            if (b == 0xFF) { put_byte(0x00); ++stuffed; }
            nbits = 0;
        }
        bitbuf = 0;
    }
};

struct HuffTable {
    uint8_t bits[17];      // bits[l] = number of codes of length l
    uint8_t huffval[256];
    int nval;
    uint16_t code[256];    // per symbol
    uint8_t size[256];
};

// Optimal length-limited Huffman construction, ITU T.81 Annex K.2
// (Figures K.1-K.3): merge-by-frequency with the reserved symbol 256 so no
// real symbol gets the all-ones code, then fold code lengths down to 16.
void build_optimal_table(const uint32_t* freq_in, HuffTable* t) {
    uint32_t freq[257];
    int codesize[257];
    int others[257];
    std::memcpy(freq, freq_in, 256 * sizeof(uint32_t));
    freq[256] = 1;
    for (int i = 0; i < 257; ++i) { codesize[i] = 0; others[i] = -1; }

    for (;;) {
        int c1 = -1, c2 = -1;
        uint32_t v = 0xFFFFFFFFu;
        for (int i = 0; i <= 256; ++i)
            if (freq[i] && freq[i] <= v) { v = freq[i]; c1 = i; }
        v = 0xFFFFFFFFu;
        for (int i = 0; i <= 256; ++i)
            if (freq[i] && freq[i] <= v && i != c1) { v = freq[i]; c2 = i; }
        if (c2 < 0) break;  // one tree left
        freq[c1] += freq[c2];
        freq[c2] = 0;
        for (codesize[c1]++; others[c1] >= 0; codesize[c1]++) c1 = others[c1];
        others[c1] = c2;
        for (codesize[c2]++; others[c2] >= 0; codesize[c2]++) c2 = others[c2];
    }

    int bits[33];
    std::memset(bits, 0, sizeof(bits));
    for (int i = 0; i <= 256; ++i)
        if (codesize[i]) bits[codesize[i] > 32 ? 32 : codesize[i]]++;

    // Limit code lengths to 16 (Figure K.3).
    for (int i = 32; i > 16; --i) {
        while (bits[i] > 0) {
            int j = i - 2;
            while (bits[j] == 0) --j;
            bits[i] -= 2;
            bits[i - 1] += 1;
            bits[j + 1] += 2;
            bits[j] -= 1;
        }
    }
    // Remove the reserved symbol's code from the longest used length.
    int i = 16;
    while (i > 0 && bits[i] == 0) --i;
    if (i > 0) bits[i]--;

    std::memset(t->bits, 0, sizeof(t->bits));
    for (int l = 1; l <= 16; ++l) t->bits[l] = uint8_t(bits[l]);

    // Symbols sorted by (code length, symbol value); the reserved 256 is
    // excluded.
    t->nval = 0;
    for (int l = 1; l <= 32; ++l)
        for (int s = 0; s < 256; ++s)
            if (codesize[s] == l) t->huffval[t->nval++] = uint8_t(s);

    // Canonical code assignment.
    std::memset(t->size, 0, sizeof(t->size));
    uint16_t code = 0;
    int k = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int n = 0; n < t->bits[l]; ++n) {
            uint8_t sym = t->huffval[k++];
            t->code[sym] = code++;
            t->size[sym] = uint8_t(l);
        }
        code <<= 1;
    }
}

inline int magnitude_bits(int v) {
    int a = v < 0 ? -v : v;
    int n = 0;
    while (a) { ++n; a >>= 1; }
    return n;
}

struct Component {
    const int16_t* coeffs;  // (by * bx * 64), zigzag
    uint32_t by, bx;
    int h_blocks_per_mcu, v_blocks_per_mcu;
    int dc_tbl, ac_tbl;     // 0 = luma, 1 = chroma
    int pred;
};

// One walk over the interleaved MCU scan.  When emitting, `dc`/`ac` carry
// code tables and `bw` receives bits; when counting, only the freq arrays
// are touched.
void scan_pass(Component* comps, int ncomp, uint32_t mcus_y, uint32_t mcus_x,
               uint32_t* dc_freq /*2x256 or null*/, uint32_t* ac_freq,
               const HuffTable* dc_tabs, const HuffTable* ac_tabs,
               BitWriter* bw) {
    for (int c = 0; c < ncomp; ++c) comps[c].pred = 0;
    for (uint32_t my = 0; my < mcus_y; ++my) {
        for (uint32_t mx = 0; mx < mcus_x; ++mx) {
            for (int c = 0; c < ncomp; ++c) {
                Component& co = comps[c];
                for (int v = 0; v < co.v_blocks_per_mcu; ++v) {
                    for (int h = 0; h < co.h_blocks_per_mcu; ++h) {
                        uint32_t byi = my * co.v_blocks_per_mcu + v;
                        uint32_t bxi = mx * co.h_blocks_per_mcu + h;
                        const int16_t* blk =
                            co.coeffs + (size_t(byi) * co.bx + bxi) * 64;

                        int diff = int(blk[0]) - co.pred;
                        co.pred = blk[0];
                        int nb = magnitude_bits(diff);
                        if (dc_freq) {
                            dc_freq[co.dc_tbl * 256 + nb]++;
                        } else {
                            const HuffTable& dt = dc_tabs[co.dc_tbl];
                            bw->put_bits(dt.code[nb], dt.size[nb]);
                            if (nb) {
                                int bitsv = diff < 0 ? diff - 1 : diff;
                                bw->put_bits(uint32_t(bitsv), nb);
                            }
                        }

                        int run = 0;
                        for (int k2 = 1; k2 < 64; ++k2) {
                            int val = blk[k2];
                            if (val == 0) { ++run; continue; }
                            while (run > 15) {
                                if (ac_freq) ac_freq[co.ac_tbl * 256 + 0xF0]++;
                                else {
                                    const HuffTable& at = ac_tabs[co.ac_tbl];
                                    bw->put_bits(at.code[0xF0], at.size[0xF0]);
                                }
                                run -= 16;
                            }
                            int sz = magnitude_bits(val);
                            int sym = (run << 4) | sz;
                            if (ac_freq) {
                                ac_freq[co.ac_tbl * 256 + sym]++;
                            } else {
                                const HuffTable& at = ac_tabs[co.ac_tbl];
                                bw->put_bits(at.code[sym], at.size[sym]);
                                int bitsv = val < 0 ? val - 1 : val;
                                bw->put_bits(uint32_t(bitsv), sz);
                            }
                            run = 0;
                        }
                        if (run > 0) {
                            if (ac_freq) ac_freq[co.ac_tbl * 256 + 0x00]++;
                            else {
                                const HuffTable& at = ac_tabs[co.ac_tbl];
                                bw->put_bits(at.code[0x00], at.size[0x00]);
                            }
                        }
                    }
                }
            }
        }
    }
}

void put_marker(BitWriter* bw, uint8_t m) {
    bw->put_byte(0xFF);
    bw->put_byte(m);
}

void put_u16(BitWriter* bw, uint16_t v) {
    bw->put_byte(uint8_t(v >> 8));
    bw->put_byte(uint8_t(v & 0xFF));
}

void put_dht(BitWriter* bw, const HuffTable& t, int tclass, int id) {
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += t.bits[l];
    put_marker(bw, 0xC4);
    put_u16(bw, uint16_t(2 + 1 + 16 + n));
    bw->put_byte(uint8_t((tclass << 4) | id));
    for (int l = 1; l <= 16; ++l) bw->put_byte(t.bits[l]);
    for (int i = 0; i < n; ++i) bw->put_byte(t.huffval[i]);
}

// The progressive AC scan script (after the interleaved DC scan):
// Y AC 1-5; Cb AC 1-63; Cr AC 1-63; Y AC 6-63 — luma low-freq first.
// comp indexes {Y, Cb, Cr}; tab is the optimized AC table id.  Shared by
// the encoder's stats+emit passes and the scan-stats oracle so the script
// (and the python size model mirroring it) cannot drift between copies.
struct ProgAcScan { int comp, ss, se, tab; };
constexpr ProgAcScan kProgAcScans[4] = {
    {0, 1, 5, 0}, {1, 1, 63, 1}, {2, 1, 63, 1}, {0, 6, 63, 2},
};

// SOI + container APP (JFIF or Adobe-transform-0) + the two DQTs — shared
// by the baseline and progressive encoders so the bytes cannot drift.
void emit_container(BitWriter* bw, int app_mode,
                    const uint16_t* qtab_luma_zz,
                    const uint16_t* qtab_chroma_zz) {
    put_marker(bw, 0xD8);  // SOI
    if (app_mode == 1) {
        // Adobe APP14, transform 0: decoders leave the 3 channels as-is.
        put_marker(bw, 0xEE);
        put_u16(bw, 14);
        const uint8_t adobe[5] = {'A', 'd', 'o', 'b', 'e'};
        for (uint8_t b : adobe) bw->put_byte(b);
        put_u16(bw, 100);                  // DCTEncodeVersion
        put_u16(bw, 0);                    // flags0
        put_u16(bw, 0);                    // flags1
        bw->put_byte(0);                   // transform: none
    } else {
        // APP0 JFIF 1.1, 1:1 aspect, no thumbnail.
        put_marker(bw, 0xE0);
        put_u16(bw, 16);
        const uint8_t jfif[5] = {'J', 'F', 'I', 'F', 0};
        for (uint8_t b : jfif) bw->put_byte(b);
        bw->put_byte(1); bw->put_byte(1);  // version 1.1
        bw->put_byte(0);                   // units: aspect only
        put_u16(bw, 1); put_u16(bw, 1);    // density
        bw->put_byte(0); bw->put_byte(0);  // thumbnail
    }
    for (int i = 0; i < 2; ++i) {          // DQT
        put_marker(bw, 0xDB);
        put_u16(bw, 2 + 1 + 64);
        bw->put_byte(uint8_t(i));          // 8-bit precision, table id i
        const uint16_t* q = i == 0 ? qtab_luma_zz : qtab_chroma_zz;
        for (int k = 0; k < 64; ++k)
            bw->put_byte(uint8_t(q[k] > 255 ? 255 : (q[k] < 1 ? 1 : q[k])));
    }
}

}  // namespace

extern "C" {

// Returns bytes written, or -1 on buffer overflow / bad args.
// Coefficients and qtables are zigzag-order; subsampling: 0=4:4:4, 1=4:2:0.
// For 4:2:0, by_y/bx_y must be even and by_c = by_y/2, bx_c = bx_y/2.
// app_mode: 0 = JFIF APP0 (channels are YCbCr); 1 = Adobe APP14 with
// transform 0 (channels pass through undecoded — the container for the
// XYB colorspace mode, whose channels must not get the YCbCr inverse).
// subsampling codes: 0 = 4:4:4, 1 = 4:2:0, 2 = 4:2:2 (h2v1), 3 = 4:4:0 (h1v2).
int64_t ce_jpeg_encode_baseline2(
    uint16_t width, uint16_t height, int subsampling,
    const int16_t* y_coeffs, const int16_t* cb_coeffs, const int16_t* cr_coeffs,
    uint32_t by_y, uint32_t bx_y, uint32_t by_c, uint32_t bx_c,
    const uint16_t* qtab_luma_zz, const uint16_t* qtab_chroma_zz,
    uint8_t* out, size_t out_cap, int app_mode) {
    if (!y_coeffs || !cb_coeffs || !cr_coeffs || !out) return -1;
    int sh = (subsampling == 1 || subsampling == 2) ? 2 : 1;
    int sv = (subsampling == 1 || subsampling == 3) ? 2 : 1;
    if (by_y != by_c * sv || bx_y != bx_c * sh) return -1;

    Component comps[3] = {
        {y_coeffs, by_y, bx_y, sh, sv, 0, 0, 0},
        {cb_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
        {cr_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
    };
    uint32_t mcus_y = by_c, mcus_x = bx_c;  // chroma is 1 block per MCU

    // Pass 1: symbol statistics.
    uint32_t dc_freq[2 * 256], ac_freq[2 * 256];
    std::memset(dc_freq, 0, sizeof(dc_freq));
    std::memset(ac_freq, 0, sizeof(ac_freq));
    scan_pass(comps, 3, mcus_y, mcus_x, dc_freq, ac_freq, nullptr, nullptr,
              nullptr);

    HuffTable dc_tabs[2], ac_tabs[2];
    for (int i = 0; i < 2; ++i) {
        build_optimal_table(dc_freq + i * 256, &dc_tabs[i]);
        build_optimal_table(ac_freq + i * 256, &ac_tabs[i]);
    }

    BitWriter bw{out, out_cap, 0, 0, 0, false, 0};

    emit_container(&bw, app_mode, qtab_luma_zz, qtab_chroma_zz);

    put_marker(&bw, 0xC0);                // SOF0 baseline
    put_u16(&bw, uint16_t(8 + 3 * 3));
    bw.put_byte(8);                       // precision
    put_u16(&bw, height);
    put_u16(&bw, width);
    bw.put_byte(3);
    const int ids[3] = {1, 2, 3};
    for (int c = 0; c < 3; ++c) {
        bw.put_byte(uint8_t(ids[c]));
        int hh = comps[c].h_blocks_per_mcu, vv = comps[c].v_blocks_per_mcu;
        bw.put_byte(uint8_t((hh << 4) | vv));
        bw.put_byte(uint8_t(c == 0 ? 0 : 1));
    }

    put_dht(&bw, dc_tabs[0], 0, 0);
    put_dht(&bw, ac_tabs[0], 1, 0);
    put_dht(&bw, dc_tabs[1], 0, 1);
    put_dht(&bw, ac_tabs[1], 1, 1);

    put_marker(&bw, 0xDA);                // SOS
    put_u16(&bw, uint16_t(6 + 2 * 3));
    bw.put_byte(3);
    for (int c = 0; c < 3; ++c) {
        bw.put_byte(uint8_t(ids[c]));
        int t = c == 0 ? 0 : 1;
        bw.put_byte(uint8_t((t << 4) | t));
    }
    bw.put_byte(0); bw.put_byte(63); bw.put_byte(0);  // Ss, Se, Ah/Al

    scan_pass(comps, 3, mcus_y, mcus_x, nullptr, nullptr, dc_tabs, ac_tabs,
              &bw);
    bw.flush();
    put_marker(&bw, 0xD9);                // EOI

    if (bw.overflow) return -1;
    return int64_t(bw.pos);
}

}  // extern "C"

namespace {

// --- Progressive (spectral selection, Ah=Al=0) -----------------------------

struct AcScanState {
    uint32_t eobrun = 0;
};

inline void flush_eobrun(AcScanState* st, uint32_t* freq, const HuffTable* tab,
                         BitWriter* bw) {
    if (st->eobrun == 0) return;
    uint32_t r = st->eobrun;
    int n = 0;
    while ((r >> (n + 1)) != 0) ++n;  // n = floor(log2(r))
    int sym = n << 4;
    if (freq) {
        freq[sym]++;
    } else {
        bw->put_bits(tab->code[sym], tab->size[sym]);
        if (n) bw->put_bits(r - (1u << n), n);
    }
    st->eobrun = 0;
}

// One non-interleaved AC scan over blocks [0, by_ni) x [0, bx_ni) of a
// (by, bx, 64) zigzag plane, band [ss, se].  T.81 G.1.2.2.
void ac_scan(const int16_t* coeffs, uint32_t bx /*padded*/, uint32_t by_ni,
             uint32_t bx_ni, int ss, int se, uint32_t* freq,
             const HuffTable* tab, BitWriter* bw) {
    AcScanState st;
    for (uint32_t byi = 0; byi < by_ni; ++byi) {
        for (uint32_t bxi = 0; bxi < bx_ni; ++bxi) {
            const int16_t* blk = coeffs + (size_t(byi) * bx + bxi) * 64;
            int last_nz = -1;
            for (int k = se; k >= ss; --k)
                if (blk[k] != 0) { last_nz = k; break; }
            if (last_nz < 0) {
                if (++st.eobrun == 0x7FFF) flush_eobrun(&st, freq, tab, bw);
                continue;
            }
            flush_eobrun(&st, freq, tab, bw);
            int run = 0;
            for (int k = ss; k <= last_nz; ++k) {
                int v = blk[k];
                if (v == 0) { ++run; continue; }
                while (run > 15) {
                    if (freq) freq[0xF0]++;
                    else bw->put_bits(tab->code[0xF0], tab->size[0xF0]);
                    run -= 16;
                }
                int sz = magnitude_bits(v);
                int sym = (run << 4) | sz;
                if (freq) {
                    freq[sym]++;
                } else {
                    bw->put_bits(tab->code[sym], tab->size[sym]);
                    int bitsv = v < 0 ? v - 1 : v;
                    bw->put_bits(uint32_t(bitsv), sz);
                }
                run = 0;
            }
            if (last_nz < se) {
                if (++st.eobrun == 0x7FFF) flush_eobrun(&st, freq, tab, bw);
            }
        }
    }
    flush_eobrun(&st, freq, tab, bw);
}

// Interleaved DC-only scan (Ss=Se=0), same MCU walk as baseline.
void dc_scan(Component* comps, int ncomp, uint32_t mcus_y, uint32_t mcus_x,
             uint32_t* dc_freq, const HuffTable* dc_tabs, BitWriter* bw) {
    for (int c = 0; c < ncomp; ++c) comps[c].pred = 0;
    for (uint32_t my = 0; my < mcus_y; ++my)
        for (uint32_t mx = 0; mx < mcus_x; ++mx)
            for (int c = 0; c < ncomp; ++c) {
                Component& co = comps[c];
                for (int v = 0; v < co.v_blocks_per_mcu; ++v)
                    for (int h = 0; h < co.h_blocks_per_mcu; ++h) {
                        uint32_t byi = my * co.v_blocks_per_mcu + v;
                        uint32_t bxi = mx * co.h_blocks_per_mcu + h;
                        const int16_t* blk =
                            co.coeffs + (size_t(byi) * co.bx + bxi) * 64;
                        int diff = int(blk[0]) - co.pred;
                        co.pred = blk[0];
                        int nb = magnitude_bits(diff);
                        if (dc_freq) {
                            dc_freq[co.dc_tbl * 256 + nb]++;
                        } else {
                            const HuffTable& dt = dc_tabs[co.dc_tbl];
                            bw->put_bits(dt.code[nb], dt.size[nb]);
                            if (nb) {
                                int bitsv = diff < 0 ? diff - 1 : diff;
                                bw->put_bits(uint32_t(bitsv), nb);
                            }
                        }
                    }
            }
}

void put_sos(BitWriter* bw, int ncomp, const int* comp_ids, const int* td,
             const int* ta, int ss, int se) {
    put_marker(bw, 0xDA);
    put_u16(bw, uint16_t(6 + 2 * ncomp));
    bw->put_byte(uint8_t(ncomp));
    for (int c = 0; c < ncomp; ++c) {
        bw->put_byte(uint8_t(comp_ids[c]));
        bw->put_byte(uint8_t((td[c] << 4) | ta[c]));
    }
    bw->put_byte(uint8_t(ss));
    bw->put_byte(uint8_t(se));
    bw->put_byte(0);  // Ah=Al=0 (spectral selection only)
}

}  // namespace

extern "C" {

// Progressive (SOF2, spectral-selection) variant of
// ce_jpeg_encode_baseline2.  Scan script: interleaved DC; Y AC 1-5;
// Cb AC 1-63; Cr AC 1-63; Y AC 6-63 — the classic luma-low-freq-first
// ordering.  Optimized Huffman tables are built over all scans sharing a
// table.  true_h/true_w are the unpadded image dims (non-interleaved
// scans cover ceil(dim/8) blocks, not the padded MCU grid).
int64_t ce_jpeg_encode_progressive(
    uint16_t width, uint16_t height, int subsampling,
    const int16_t* y_coeffs, const int16_t* cb_coeffs, const int16_t* cr_coeffs,
    uint32_t by_y, uint32_t bx_y, uint32_t by_c, uint32_t bx_c,
    const uint16_t* qtab_luma_zz, const uint16_t* qtab_chroma_zz,
    uint8_t* out, size_t out_cap, int app_mode) {
    if (!y_coeffs || !cb_coeffs || !cr_coeffs || !out) return -1;
    int sh = (subsampling == 1 || subsampling == 2) ? 2 : 1;
    int sv = (subsampling == 1 || subsampling == 3) ? 2 : 1;
    if (by_y != by_c * sv || bx_y != bx_c * sh) return -1;

    Component comps[3] = {
        {y_coeffs, by_y, bx_y, sh, sv, 0, 0, 0},
        {cb_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
        {cr_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
    };
    uint32_t mcus_y = by_c, mcus_x = bx_c;

    // Non-interleaved AC block counts from the true dims.
    uint32_t ny_y = (uint32_t(height) + 7) / 8;
    uint32_t nx_y = (uint32_t(width) + 7) / 8;
    uint32_t ny_c = sv == 2 ? ((uint32_t(height) + 1) / 2 + 7) / 8 : ny_y;
    uint32_t nx_c = sh == 2 ? ((uint32_t(width) + 1) / 2 + 7) / 8 : nx_y;

    // Progressive allows 4 AC tables; give each band its own optimized
    // statistics: 0 = Y low band, 1 = chroma, 2 = Y high band.
    uint32_t dc_freq[2 * 256], ac_freq[3 * 256];
    std::memset(dc_freq, 0, sizeof(dc_freq));
    std::memset(ac_freq, 0, sizeof(ac_freq));

    const int16_t* cptr[3] = {y_coeffs, cb_coeffs, cr_coeffs};
    const uint32_t cbx[3] = {bx_y, bx_c, bx_c};
    const uint32_t cny[3] = {ny_y, ny_c, ny_c};
    const uint32_t cnx[3] = {nx_y, nx_c, nx_c};

    // Stats pass over every scan.
    dc_scan(comps, 3, mcus_y, mcus_x, dc_freq, nullptr, nullptr);
    for (const ProgAcScan& s : kProgAcScans)
        ac_scan(cptr[s.comp], cbx[s.comp], cny[s.comp], cnx[s.comp], s.ss,
                s.se, ac_freq + s.tab * 256, nullptr, nullptr);

    HuffTable dc_tabs[2], ac_tabs[3];
    for (int i = 0; i < 2; ++i)
        build_optimal_table(dc_freq + i * 256, &dc_tabs[i]);
    for (int i = 0; i < 3; ++i)
        build_optimal_table(ac_freq + i * 256, &ac_tabs[i]);

    BitWriter bw{out, out_cap, 0, 0, 0, false, 0};
    emit_container(&bw, app_mode, qtab_luma_zz, qtab_chroma_zz);
    put_marker(&bw, 0xC2);  // SOF2 progressive
    put_u16(&bw, uint16_t(8 + 3 * 3));
    bw.put_byte(8);
    put_u16(&bw, height);
    put_u16(&bw, width);
    bw.put_byte(3);
    const int ids[3] = {1, 2, 3};
    for (int c = 0; c < 3; ++c) {
        bw.put_byte(uint8_t(ids[c]));
        bw.put_byte(uint8_t((comps[c].h_blocks_per_mcu << 4) |
                            comps[c].v_blocks_per_mcu));
        bw.put_byte(uint8_t(c == 0 ? 0 : 1));
    }
    put_dht(&bw, dc_tabs[0], 0, 0);
    put_dht(&bw, ac_tabs[0], 1, 0);
    put_dht(&bw, dc_tabs[1], 0, 1);
    put_dht(&bw, ac_tabs[1], 1, 1);
    put_dht(&bw, ac_tabs[2], 1, 2);

    // Scan 1: interleaved DC.
    {
        const int td[3] = {0, 1, 1}, ta[3] = {0, 0, 0};
        put_sos(&bw, 3, ids, td, ta, 0, 0);
        dc_scan(comps, 3, mcus_y, mcus_x, nullptr, dc_tabs, &bw);
        bw.flush();
    }
    for (const ProgAcScan& s : kProgAcScans) {
        const int cid[1] = {s.comp + 1};
        const int td[1] = {0}, ta[1] = {s.tab};
        put_sos(&bw, 1, cid, td, ta, s.ss, s.se);
        ac_scan(cptr[s.comp], cbx[s.comp], cny[s.comp], cnx[s.comp], s.ss,
                s.se, nullptr, &ac_tabs[s.tab], &bw);
        bw.flush();
    }
    put_marker(&bw, 0xD9);
    if (bw.overflow) return -1;
    return int64_t(bw.pos);
}

// Exact baseline-scan statistics: the test oracle for the device-side rate
// accounting (kernels/jpeg_rate.py).  Writes the two-pass symbol histograms
// (dc_freq/ac_freq, each 2 table classes x 256 bins), the entropy-coded
// scan byte count (flush-padded, EXCLUDING headers/EOI), and the number of
// 0x00 bytes stuffed after 0xFF — the one term histograms cannot predict.
// Uses a scratch buffer internally; returns 0 on success, -1 on bad args.
int64_t ce_jpeg_scan_stats(
    int subsampling,
    const int16_t* y_coeffs, const int16_t* cb_coeffs, const int16_t* cr_coeffs,
    uint32_t by_y, uint32_t bx_y, uint32_t by_c, uint32_t bx_c,
    uint32_t* dc_freq_out /*2*256*/, uint32_t* ac_freq_out /*2*256*/,
    uint8_t* scratch, size_t scratch_cap,
    int64_t* scan_bytes_out, int64_t* stuffed_out) {
    if (!y_coeffs || !cb_coeffs || !cr_coeffs || !dc_freq_out || !ac_freq_out ||
        !scratch || !scan_bytes_out || !stuffed_out)
        return -1;
    int sh = (subsampling == 1 || subsampling == 2) ? 2 : 1;
    int sv = (subsampling == 1 || subsampling == 3) ? 2 : 1;
    if (by_y != by_c * sv || bx_y != bx_c * sh) return -1;

    Component comps[3] = {
        {y_coeffs, by_y, bx_y, sh, sv, 0, 0, 0},
        {cb_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
        {cr_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
    };
    std::memset(dc_freq_out, 0, 2 * 256 * sizeof(uint32_t));
    std::memset(ac_freq_out, 0, 2 * 256 * sizeof(uint32_t));
    scan_pass(comps, 3, by_c, bx_c, dc_freq_out, ac_freq_out, nullptr,
              nullptr, nullptr);

    HuffTable dc_tabs[2], ac_tabs[2];
    for (int i = 0; i < 2; ++i) {
        build_optimal_table(dc_freq_out + i * 256, &dc_tabs[i]);
        build_optimal_table(ac_freq_out + i * 256, &ac_tabs[i]);
    }
    BitWriter bw{scratch, scratch_cap, 0, 0, 0, false, 0};
    scan_pass(comps, 3, by_c, bx_c, nullptr, nullptr, dc_tabs, ac_tabs, &bw);
    bw.flush();
    if (bw.overflow) return -1;
    *scan_bytes_out = int64_t(bw.pos);
    *stuffed_out = int64_t(bw.stuffed);
    return 0;
}

// Progressive analog of ce_jpeg_scan_stats: histograms per table class
// (2 DC + 3 AC: Y low band, chroma, Y high band), total entropy-coded
// bytes over all 5 scans (each flush-padded), and total stuffed bytes.
int64_t ce_jpeg_scan_stats_progressive(
    uint16_t width, uint16_t height, int subsampling,
    const int16_t* y_coeffs, const int16_t* cb_coeffs, const int16_t* cr_coeffs,
    uint32_t by_y, uint32_t bx_y, uint32_t by_c, uint32_t bx_c,
    uint32_t* dc_freq_out /*2*256*/, uint32_t* ac_freq_out /*3*256*/,
    uint8_t* scratch, size_t scratch_cap,
    int64_t* scan_bytes_out, int64_t* stuffed_out) {
    if (!y_coeffs || !cb_coeffs || !cr_coeffs || !dc_freq_out || !ac_freq_out ||
        !scratch || !scan_bytes_out || !stuffed_out)
        return -1;
    int sh = (subsampling == 1 || subsampling == 2) ? 2 : 1;
    int sv = (subsampling == 1 || subsampling == 3) ? 2 : 1;
    if (by_y != by_c * sv || bx_y != bx_c * sh) return -1;

    Component comps[3] = {
        {y_coeffs, by_y, bx_y, sh, sv, 0, 0, 0},
        {cb_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
        {cr_coeffs, by_c, bx_c, 1, 1, 1, 1, 0},
    };
    uint32_t ny_y = (uint32_t(height) + 7) / 8;
    uint32_t nx_y = (uint32_t(width) + 7) / 8;
    uint32_t ny_c = sv == 2 ? ((uint32_t(height) + 1) / 2 + 7) / 8 : ny_y;
    uint32_t nx_c = sh == 2 ? ((uint32_t(width) + 1) / 2 + 7) / 8 : nx_y;

    const int16_t* cptr[3] = {y_coeffs, cb_coeffs, cr_coeffs};
    const uint32_t cbx[3] = {bx_y, bx_c, bx_c};
    const uint32_t cny[3] = {ny_y, ny_c, ny_c};
    const uint32_t cnx[3] = {nx_y, nx_c, nx_c};

    std::memset(dc_freq_out, 0, 2 * 256 * sizeof(uint32_t));
    std::memset(ac_freq_out, 0, 3 * 256 * sizeof(uint32_t));
    dc_scan(comps, 3, by_c, bx_c, dc_freq_out, nullptr, nullptr);
    for (const ProgAcScan& s : kProgAcScans)
        ac_scan(cptr[s.comp], cbx[s.comp], cny[s.comp], cnx[s.comp], s.ss,
                s.se, ac_freq_out + s.tab * 256, nullptr, nullptr);

    HuffTable dc_tabs[2], ac_tabs[3];
    for (int i = 0; i < 2; ++i)
        build_optimal_table(dc_freq_out + i * 256, &dc_tabs[i]);
    for (int i = 0; i < 3; ++i)
        build_optimal_table(ac_freq_out + i * 256, &ac_tabs[i]);

    BitWriter bw{scratch, scratch_cap, 0, 0, 0, false, 0};
    dc_scan(comps, 3, by_c, bx_c, nullptr, dc_tabs, &bw);
    bw.flush();
    for (const ProgAcScan& s : kProgAcScans) {
        ac_scan(cptr[s.comp], cbx[s.comp], cny[s.comp], cnx[s.comp], s.ss,
                s.se, nullptr, &ac_tabs[s.tab], &bw);
        bw.flush();
    }
    if (bw.overflow) return -1;
    *scan_bytes_out = int64_t(bw.pos);
    *stuffed_out = int64_t(bw.stuffed);
    return 0;
}

// Original entry point (JFIF container).
int64_t ce_jpeg_encode_baseline(
    uint16_t width, uint16_t height, int subsampling,
    const int16_t* y_coeffs, const int16_t* cb_coeffs, const int16_t* cr_coeffs,
    uint32_t by_y, uint32_t bx_y, uint32_t by_c, uint32_t bx_c,
    const uint16_t* qtab_luma_zz, const uint16_t* qtab_chroma_zz,
    uint8_t* out, size_t out_cap) {
    return ce_jpeg_encode_baseline2(
        width, height, subsampling, y_coeffs, cb_coeffs, cr_coeffs,
        by_y, bx_y, by_c, bx_c, qtab_luma_zz, qtab_chroma_zz,
        out, out_cap, 0);
}

}  // extern "C"
