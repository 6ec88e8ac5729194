"""Device-side rate accounting for the tpujpeg baseline entropy coder.

The exact-size path of the device-resident R-D sweep previously fetched
every quality's quantized coefficient planes back to the host
((blocks, 64) int16 — ~0.8 MB per 512px quality) and entropy-coded them
there; that fetch and the host Huffman pass dominated the whole ladder.  The observation that removes it: for a two-pass
optimized-Huffman baseline scan (native/jpeg_entropy.cpp), the DC-category
and AC-(run,size) symbol HISTOGRAMS fully determine

  * the optimized Huffman code lengths (the tables are BUILT from these
    histograms — running the same ITU T.81 K.2 construction on the host
    reproduces the coder's tables bit-for-bit), and
  * the appended-bit total: a DC symbol ``s`` carries exactly ``s`` extra
    bits and an AC symbol carries ``sym & 15`` (ZRL 0xF0 and EOB 0x00
    carry none).

So the exact entropy-coded bit count needs only (2x16 + 2x256) counters
per quality off the device — ~200x less data than the coefficients.  The
histograms are computed on device with run-lengths from a cumulative max
over zigzag positions and a (16, N) @ (N, 16) one-hot matmul (symbol
split into run/size nibbles), all exact integer counts in f32.

The ONE term histograms cannot predict is JFIF 0xFF byte stuffing (a 0x00
is inserted after each 0xFF scan byte), which depends on actual bit
patterns; it is estimated at the empirically calibrated scan_bytes / 368
(optimized Huffman codes make 0xFF rarer than the uniform-byte 1/256:
measured stuffed/scan = 0.00272 mean, 0.0016-0.0040 p10-p90 over the
synthetic corpus x q30-98 x 420/444), leaving file sizes exact to ~±0.15%.
tests/test_jpeg_rate.py pins the bit-exactness of everything else against
the C++ coder's own stats export (``ce_jpeg_scan_stats``).

Role parity: the reference gets file sizes for free because its codecs
run on host (crates/codec-iter/src/eval.rs:151-167); this module is what
keeps the device-resident ladder's R-D curves honest without paying host
coefficient traffic.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "PACKED_STATS_WIDTH",
    "PACKED_STATS_WIDTH_PROGRESSIVE",
    "build_rate_stats",
    "build_ladder_rate_stats",
    "build_progressive_ladder_rate_stats",
    "t81_code_sizes",
    "scan_bits_from_hists",
    "baseline_size_estimate",
    "progressive_size_estimate",
    "progressive_size_estimates_from_packed",
    "size_estimates_from_packed",
]


# -- device half --------------------------------------------------------------


def _category(v_abs):
    """JPEG magnitude category (bit length) via exact integer compares."""
    import jax.numpy as jnp

    c = jnp.zeros(v_abs.shape, jnp.int32)
    for j in range(15):
        c = c + (v_abs >= (1 << j)).astype(jnp.int32)
    return c


def _dc_hist(dc_plane, sv: int, sh: int):
    """16-bin histogram of DC difference categories, in the interleaved
    MCU traversal order of the scan (jpeg_entropy.cpp scan_pass: block
    (my*sv+v, mx*sh+h) for MCU (my, mx)) so the prediction chain matches
    the coder exactly."""
    import jax.numpy as jnp

    by, bx = dc_plane.shape
    d4 = dc_plane.astype(jnp.int32).reshape(by // sv, sv, bx // sh, sh)
    seq = jnp.transpose(d4, (0, 2, 1, 3)).reshape(-1)
    diff = jnp.concatenate([seq[:1], seq[1:] - seq[:-1]])
    cat = _category(jnp.abs(diff))
    oh = (cat[:, None] == jnp.arange(16, dtype=jnp.int32)[None, :])
    return jnp.sum(oh.astype(jnp.float32), axis=0)  # (16,)


def _run_size_hist(band_abs, lo_pos: int, hi_pos: int):
    """256-bin (run<<4 | size) histogram + ZRL count for one coefficient
    band occupying zigzag positions [lo_pos, hi_pos] of each block, with
    run lengths counted from position lo_pos - 1.

    Run lengths come from a cumulative max of nonzero positions along the
    zigzag axis; the histogram itself is a (16, N) @ (N, 16) bf16 one-hot
    matmul (run nibble x size nibble), exact 0/1 products accumulated in
    f32.  Shared by the baseline scan (_ac_hist: band 1..63) and the
    progressive band scans (_ac_band_stats).  Returns (hist (256,), nz).
    """
    import jax
    import jax.numpy as jnp

    n = band_abs.shape[0]
    length = hi_pos - lo_pos + 1
    # f32 accumulation is integer-exact only below 2^24 per bin; a bin's
    # count is bounded by the band position total.  512px ladders sit ~60x
    # under this; a >16 MP plane must be tiled before rate accounting.
    if n * length >= (1 << 24):
        raise ValueError(
            f"rate-statistics plane too large for exact f32 counts "
            f"({n} blocks x {length} positions >= 2^24); tile the image"
        )
    nz = band_abs > 0
    pos = jnp.arange(lo_pos, hi_pos + 1, dtype=jnp.int32)
    marked = jnp.where(nz, pos[None, :], lo_pos - 1)
    prev_inc = jax.lax.cummax(marked, axis=1)
    prev = jnp.concatenate(
        [jnp.full((n, 1), lo_pos - 1, jnp.int32), prev_inc[:, :-1]], axis=1
    )
    run = pos[None, :] - prev - 1                     # valid where nz
    zrl = jnp.sum(jnp.where(nz, run >> 4, 0).astype(jnp.float32))
    sz = _category(band_abs)
    hi = jnp.where(nz, run & 15, 0)
    lo = jnp.where(nz, sz, 0)
    nib = jnp.arange(16, dtype=jnp.int32)
    oh_hi = ((hi[..., None] == nib) & nz[..., None]).astype(jnp.bfloat16)
    oh_lo = (lo[..., None] == nib).astype(jnp.bfloat16)
    h = jax.lax.dot_general(
        oh_hi.reshape(-1, 16),
        oh_lo.reshape(-1, 16),
        (((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
    )                                                  # (16 run, 16 size)
    hist = h.reshape(256)
    return hist + (jnp.arange(256) == 0xF0) * zrl, nz


def _ac_hist(coefs_zz):
    """256-bin histogram of baseline AC (run<<4 | size) symbols, including
    ZRL (0xF0) and EOB (0x00), over all blocks of one plane."""
    import jax.numpy as jnp

    q = jnp.abs(coefs_zz.reshape(-1, 64).astype(jnp.int32))
    ac = q[:, 1:]                                     # (N, 63)
    hist, _ = _run_size_hist(ac, 1, 63)
    eob = jnp.sum((ac[:, -1] == 0).astype(jnp.float32))
    return hist + (jnp.arange(256) == 0x00) * eob


def build_rate_stats(subsampling: str = "420"):
    """Rate-statistics function for one quality's quantized planes.

    Returns fn(cy (byY, bxY, 64), ccb, ccr (byC, bxC, 64), zigzag,
    integer-valued f32 or int) -> dict of
      dc_y (16,), dc_c (16,), ac_y (256,), ac_c (256,)  f32 counts.
    vmap over a leading quality axis to cover a whole ladder.  Cb and Cr
    keep separate DC prediction chains but share the chroma tables, as the
    coder does (Component.dc_tbl/ac_tbl = 1 for both).
    """
    if subsampling not in ("420", "444", "422", "440"):
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    sh = 2 if subsampling in ("420", "422") else 1
    sv = 2 if subsampling in ("420", "440") else 1

    def stats(cy, ccb, ccr) -> Dict[str, "object"]:
        return {
            "dc_y": _dc_hist(cy[:, :, 0], sv, sh),
            "dc_c": _dc_hist(ccb[:, :, 0], 1, 1) + _dc_hist(ccr[:, :, 0], 1, 1),
            "ac_y": _ac_hist(cy),
            "ac_c": _ac_hist(ccb) + _ac_hist(ccr),
        }

    return stats


def _ac_band_stats(coefs_zz, ny: int, nx: int, ss: int, se: int):
    """256-bin symbol histogram for one non-interleaved progressive AC
    scan (T.81 G.1.2.2): band [ss, se] over the true (ny, nx) block
    subgrid, with in-band run-size symbols, ZRL, and EOBRUN symbols
    (n<<4 for a run of 2^n..2^(n+1)-1 end-of-band blocks, 0x7FFF cap).

    EOB runs span blocks: a coded block whose band ends in zeros joins the
    following all-zero-band blocks into one run, flushed by the next coded
    block or scan end.  Run lengths come from an exclusive cumsum of
    per-block contributions differenced at flush points via a cummax of
    the cumsum masked to coded blocks — no gathers.
    """
    import jax
    import jax.numpy as jnp

    q = jnp.abs(coefs_zz[:ny, :nx].reshape(-1, 64).astype(jnp.int32))
    band = q[:, ss : se + 1]                      # (B, L)

    # In-band (run, size) symbols — the baseline-scan machinery with the
    # run base at ss-1.
    hist, nz = _run_size_hist(band, ss, se)
    has_nz = jnp.any(nz, axis=1)                  # (B,) coded blocks
    bins = jnp.arange(256)

    # EOB runs.  contribution c[b]: 1 for an all-zero band, 1 for a coded
    # block whose band ends in zeros (its trailing EOB joins the run).
    ends_zero = band[:, -1] == 0
    c = jnp.where(has_nz, ends_zero, True).astype(jnp.int32)
    cum = jnp.cumsum(c)
    excl = jnp.concatenate([jnp.zeros(1, jnp.int32), cum[:-1]])  # E[b]
    neg = jnp.int32(-(1 << 30))
    f = jnp.where(has_nz, excl, neg)
    fmax = jax.lax.cummax(f)
    prev_e = jnp.concatenate([jnp.full(1, neg, jnp.int32), fmax[:-1]])
    runs = jnp.where(has_nz, excl - jnp.maximum(prev_e, 0), 0)
    any_coded = jnp.any(has_nz)
    end_run = cum[-1] - jnp.where(any_coded, jnp.maximum(fmax[-1], 0), 0)
    runs = jnp.concatenate([runs, end_run[None]])

    # EOBRUN(32767) symbols from the 0x7FFF cap, then log2 buckets for the
    # remainders (exact threshold compares; rem < 32768 -> n <= 14).
    n_full = jnp.sum((runs // 32767).astype(jnp.float32))
    rem = runs % 32767
    nbits = jnp.zeros(rem.shape, jnp.int32)
    for j in range(1, 15):
        nbits = nbits + (rem >= (1 << j)).astype(jnp.int32)
    kbins = jnp.arange(15, dtype=jnp.int32)
    counts = jnp.sum(
        ((nbits[:, None] == kbins) & (rem > 0)[:, None]).astype(jnp.float32),
        axis=0,
    )
    eob_syms = jnp.zeros(256).at[kbins << 4].add(counts)
    eob_syms = eob_syms + (bins == 0xE0) * n_full
    return hist + eob_syms


#: Layout of one quality's packed rate statistics:
#: [dc_y (16) | dc_c (16) | ac_y (256) | ac_c (256)] = 544 f32 counts.
PACKED_STATS_WIDTH = 544

#: Progressive layout: [dc_y 16 | dc_c 16 | ac_y_low 256 | ac_cb 256 |
#: ac_cr 256 | ac_y_high 256] = 1056 (Cb and Cr are separate scans that
#: share a table, so their histograms stay separate for per-scan bits).
PACKED_STATS_WIDTH_PROGRESSIVE = 1056


@functools.lru_cache(maxsize=16)
def build_ladder_rate_stats(subsampling: str = "420"):
    """Jitted rate statistics over a whole quality ladder: fn(cy (n_q, byY,
    bxY, 64), ccb, ccr) -> (n_q, 544) f32, the four histograms packed into
    ONE array so the whole ladder's statistics cost a single device->host
    fetch (each fetch pays a full device round trip).  Cached
    so repeated ladders reuse the compiled program (per coefficient
    shape); unpack with ``size_estimates_from_packed``."""
    import jax
    import jax.numpy as jnp

    stats = build_rate_stats(subsampling)

    def packed(cy, ccb, ccr):
        st = stats(cy, ccb, ccr)
        return jnp.concatenate(
            [st["dc_y"], st["dc_c"], st["ac_y"], st["ac_c"]], axis=-1
        )

    return jax.jit(jax.vmap(packed))


def size_estimates_from_packed(
    packed: np.ndarray, app_mode: int = 0
) -> list:
    """Byte-size estimates for a ladder's packed (n_q, 544) statistics."""
    packed = np.asarray(packed)
    return [
        baseline_size_estimate(
            row[:16], row[16:32], row[32:288], row[288:544], app_mode=app_mode
        )
        for row in packed
    ]


@functools.lru_cache(maxsize=16)
def build_progressive_ladder_rate_stats(
    height: int, width: int, subsampling: str = "420"
):
    """Progressive analog of build_ladder_rate_stats: fn(cy, ccb, ccr with
    a leading quality axis) -> (n_q, 1056) f32 packed histograms.  The
    non-interleaved AC scans cover ceil(dim/8) blocks of the TRUE image
    dims (the padded MCU grid rows/cols beyond them are sliced off), which
    is why the builder is keyed on (height, width)."""
    import jax
    import jax.numpy as jnp

    if subsampling not in ("420", "444", "422", "440"):
        raise ValueError(f"unsupported subsampling {subsampling!r}")
    sh = 2 if subsampling in ("420", "422") else 1
    sv = 2 if subsampling in ("420", "440") else 1
    ny_y = (height + 7) // 8
    nx_y = (width + 7) // 8
    ny_c = ((height + 1) // 2 + 7) // 8 if sv == 2 else ny_y
    nx_c = ((width + 1) // 2 + 7) // 8 if sh == 2 else nx_y

    def packed(cy, ccb, ccr):
        return jnp.concatenate(
            [
                _dc_hist(cy[:, :, 0], sv, sh),
                _dc_hist(ccb[:, :, 0], 1, 1) + _dc_hist(ccr[:, :, 0], 1, 1),
                _ac_band_stats(cy, ny_y, nx_y, 1, 5),
                _ac_band_stats(ccb, ny_c, nx_c, 1, 63),
                _ac_band_stats(ccr, ny_c, nx_c, 1, 63),
                _ac_band_stats(cy, ny_y, nx_y, 6, 63),
            ],
            axis=-1,
        )

    return jax.jit(jax.vmap(packed))


def _progressive_ac_extra_bits() -> np.ndarray:
    """Appended bits per progressive AC symbol: size for (run, size>0),
    0 for ZRL, n for EOBRUN symbols (n<<4)."""
    sym = np.arange(256, dtype=np.int64)
    lo = sym & 15
    hi = sym >> 4
    return np.where(lo > 0, lo, np.where(sym == 0xF0, 0, hi))


def progressive_size_estimate(
    dc_y: np.ndarray,
    dc_c: np.ndarray,
    ac_y_low: np.ndarray,
    ac_cb: np.ndarray,
    ac_cr: np.ndarray,
    ac_y_high: np.ndarray,
    app_mode: int = 0,
) -> int:
    """Estimated .jpg size for the SOF2 spectral-selection scan script
    (ce_jpeg_encode_progressive): interleaved DC; Y 1-5; Cb 1-63; Cr 1-63;
    Y 6-63.  Tables: 2 DC + 3 AC (Y low / chroma shared by Cb+Cr / Y
    high); every scan is flush-padded separately.  Exact except stuffing
    (calibrated scan/368)."""
    dc_extra = np.arange(16, dtype=np.int64)
    ac_extra = _progressive_ac_extra_bits()

    def dfreq(h16):
        out = np.zeros(256, dtype=np.int64)
        out[:16] = np.asarray(np.rint(h16), dtype=np.int64)
        return out

    f_dc_y, f_dc_c = dfreq(dc_y), dfreq(dc_c)
    f_low = np.asarray(np.rint(ac_y_low), dtype=np.int64)
    f_cb = np.asarray(np.rint(ac_cb), dtype=np.int64)
    f_cr = np.asarray(np.rint(ac_cr), dtype=np.int64)
    f_high = np.asarray(np.rint(ac_y_high), dtype=np.int64)

    s_dc0, n_dc0 = t81_code_sizes(f_dc_y)
    s_dc1, n_dc1 = t81_code_sizes(f_dc_c)
    s_ac0, n_ac0 = t81_code_sizes(f_low)
    s_ac1, n_ac1 = t81_code_sizes(f_cb + f_cr)
    s_ac2, n_ac2 = t81_code_sizes(f_high)

    scan_bits = [
        int((f_dc_y[:16] * (s_dc0[:16] + dc_extra)).sum())
        + int((f_dc_c[:16] * (s_dc1[:16] + dc_extra)).sum()),
        int((f_low * (s_ac0 + ac_extra)).sum()),
        int((f_cb * (s_ac1 + ac_extra)).sum()),
        int((f_cr * (s_ac1 + ac_extra)).sum()),
        int((f_high * (s_ac2 + ac_extra)).sum()),
    ]
    scan_bytes = sum((b + 7) // 8 for b in scan_bits)
    nsyms = n_dc0 + n_dc1 + n_ac0 + n_ac1 + n_ac2
    app = 16 if app_mode == 1 else 18
    # SOI, APP, 2xDQT, SOF2 (19), 5 DHT, SOS 3-comp (14) + 4x SOS 1-comp
    # (10 each), EOI.
    header = 2 + app + 2 * 69 + 19 + (5 * 21 + nsyms) + 14 + 4 * 10 + 2
    stuffed = int(round(scan_bytes / 368.0))
    return header + scan_bytes + stuffed


def progressive_size_estimates_from_packed(
    packed: np.ndarray, app_mode: int = 0
) -> list:
    """Byte-size estimates for a ladder's packed (n_q, 1056) progressive
    statistics."""
    packed = np.asarray(packed)
    return [
        progressive_size_estimate(
            row[:16], row[16:32], row[32:288], row[288:544],
            row[544:800], row[800:1056], app_mode=app_mode,
        )
        for row in packed
    ]


# -- host half ----------------------------------------------------------------


def t81_code_sizes(freq256: np.ndarray) -> Tuple[np.ndarray, int]:
    """Optimal length-limited Huffman code sizes, ITU T.81 Annex K.2.

    Exact port of native/jpeg_entropy.cpp build_optimal_table (including
    its tie-breaking: the HIGHEST index among minimal nonzero frequencies
    wins each merge, via the ``<=`` scan) so the host reproduces the
    entropy coder's tables bit-for-bit from fetched histograms.  Returns
    (size per symbol — 0 for absent symbols, number of coded symbols).
    """
    import heapq

    freq = [0] * 257
    for i, f in enumerate(np.asarray(freq256, dtype=np.int64)):
        freq[i] = int(f)
    freq[256] = 1  # reserved: keeps the all-ones code unused
    codesize = [0] * 257
    others = [-1] * 257

    # The C++ scans pick the minimal nonzero frequency, ties resolved to
    # the HIGHEST index (its `<=` keeps updating); the merged tree keeps
    # c1's index and frequency slot.  A heap keyed (freq, -index) pops in
    # exactly that order.
    heap = [(f, -i) for i, f in enumerate(freq) if f]
    heapq.heapify(heap)
    while len(heap) > 1:
        f1, ni1 = heapq.heappop(heap)
        f2, ni2 = heapq.heappop(heap)
        c1, c2 = -ni1, -ni2
        heapq.heappush(heap, (f1 + f2, ni1))
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1

    bits = np.zeros(33, dtype=np.int64)
    for i in range(257):
        if codesize[i]:
            bits[min(int(codesize[i]), 32)] += 1

    # Limit code lengths to 16 (Figure K.3).
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while i > 0 and bits[i] == 0:
        i -= 1
    if i > 0:
        bits[i] -= 1  # drop the reserved symbol from the longest length

    # Canonical size assignment: symbols ordered by (pre-limit codesize,
    # symbol value), filling the adjusted per-length counts.
    cs = np.asarray(codesize[:256])
    idx = np.flatnonzero(cs > 0)
    order = idx[np.argsort(cs[idx], kind="stable")].tolist()
    sizes = np.zeros(256, dtype=np.int64)
    k = 0
    for l in range(1, 17):
        for _ in range(int(bits[l])):
            sizes[order[k]] = l
            k += 1
    return sizes, len(order)


def scan_bits_from_hists(
    dc_y: np.ndarray, dc_c: np.ndarray, ac_y: np.ndarray, ac_c: np.ndarray
) -> Tuple[int, int]:
    """(exact entropy-coded scan bits, total DHT symbol count) for a
    baseline interleaved scan with optimized tables built from these
    histograms.  Appended bits are derivable from the histograms alone:
    DC symbol s carries s bits, AC symbol carries (sym & 15)."""
    bits = 0
    nsyms = 0
    dc_extra = np.arange(16, dtype=np.int64)
    ac_extra = np.arange(256, dtype=np.int64) & 15
    for freq16, freq256 in ((dc_y, ac_y), (dc_c, ac_c)):
        dfreq = np.zeros(256, dtype=np.int64)
        dfreq[:16] = np.asarray(np.rint(freq16), dtype=np.int64)
        sizes_dc, n_dc = t81_code_sizes(dfreq)
        afreq = np.asarray(np.rint(freq256), dtype=np.int64)
        sizes_ac, n_ac = t81_code_sizes(afreq)
        bits += int((dfreq[:16] * (sizes_dc[:16] + dc_extra)).sum())
        bits += int((afreq * (sizes_ac + ac_extra)).sum())
        nsyms += n_dc + n_ac
    return bits, nsyms


def baseline_size_estimate(
    dc_y: np.ndarray,
    dc_c: np.ndarray,
    ac_y: np.ndarray,
    ac_c: np.ndarray,
    app_mode: int = 0,
) -> int:
    """Estimated total .jpg byte size from device rate statistics.

    Exact except for 0xFF byte stuffing, estimated at the calibrated
    scan_bytes/368 (module docstring).  Header accounting mirrors
    ce_jpeg_encode_baseline2 byte for byte: SOI 2, APP0 18 (JFIF) /
    APP14 16 (Adobe), 2 DQT x 69, SOF0 19, 4 DHT x (21 + n_symbols),
    SOS 14, scan, EOI 2.
    """
    bits, nsyms = scan_bits_from_hists(dc_y, dc_c, ac_y, ac_c)
    scan_bytes = (bits + 7) // 8
    app = 16 if app_mode == 1 else 18
    header = 2 + app + 2 * 69 + 19 + (4 * 21 + nsyms) + 14
    stuffed = int(round(scan_bytes / 368.0))
    return header + scan_bytes + stuffed + 2
