/* Native FLAC frame encoder: the port's copy of the JAX package's
 * fish_speech_tpu/native/flac_encode.c, the hot path of
 * audio/transcode.encode_flac.
 *
 * It implements the numpy encoder's subset (fixed predictors 0-4 chosen by
 * min sum|res|, rice partition order 0 with the same k refinement,
 * constant/verbatim fallbacks, same frame headers and CRCs), so its output
 * is byte-for-byte the Python encoder's output; the numpy encoder builds
 * Python field lists per sample and runs at about 0.8 Msamples/s.
 *
 * Python keeps the container work (STREAMINFO, MD5) and falls back to the
 * numpy path when no C compiler is there (audio/transcode.py
 * `encode_flac`). The library is built at first use into build/native/ at
 * the root of the checkout (native/__init__.py), not beside this source.
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* ------------------------------------------------------------------ */
/* bit writer (MSB-first), byte-aligned flush per frame                 */
/* ------------------------------------------------------------------ */

typedef struct {
    uint8_t *buf;
    int64_t cap;
    int64_t byte;  /* next byte index */
    uint64_t acc;  /* bit accumulator, MSB-aligned within `fill` bits */
    int fill;      /* bits currently in acc (< 8 after flush) */
    int overflow;
} BitWriter;

static void bw_init(BitWriter *bw, uint8_t *buf, int64_t cap) {
    bw->buf = buf; bw->cap = cap; bw->byte = 0;
    bw->acc = 0; bw->fill = 0; bw->overflow = 0;
}

static inline void bw_put(BitWriter *bw, uint64_t val, int nbits) {
    /* nbits <= 57 per call keeps acc within 64 bits; callers split. */
    bw->acc = (bw->acc << nbits) | (nbits >= 64 ? val : (val & ((1ULL << nbits) - 1)));
    bw->fill += nbits;
    while (bw->fill >= 8) {
        if (bw->byte >= bw->cap) { bw->overflow = 1; bw->fill = 0; return; }
        bw->buf[bw->byte++] = (uint8_t)(bw->acc >> (bw->fill - 8));
        bw->fill -= 8;
    }
}

static inline void bw_put_zeros(BitWriter *bw, int64_t n) {
    while (n > 32) { bw_put(bw, 0, 32); n -= 32; }
    if (n > 0) bw_put(bw, 0, (int)n);
}

static void bw_align(BitWriter *bw) {
    if (bw->fill) bw_put(bw, 0, 8 - bw->fill);
}

/* ------------------------------------------------------------------ */
/* CRCs: frame-header CRC-8 poly 0x07, frame CRC-16 poly 0x8005         */
/* ------------------------------------------------------------------ */

static uint8_t crc8_table[256];
static uint16_t crc16_table[256];
static int crc_ready = 0;

static void crc_init(void) {
    if (crc_ready) return;
    for (int i = 0; i < 256; i++) {
        unsigned c = (unsigned)i;
        for (int b = 0; b < 8; b++) c = (c & 0x80u) ? ((c << 1) ^ 0x07u) : (c << 1);
        crc8_table[i] = (uint8_t)(c & 0xFFu);
        unsigned d = (unsigned)i << 8;
        for (int b = 0; b < 8; b++) d = (d & 0x8000u) ? ((d << 1) ^ 0x8005u) : (d << 1);
        crc16_table[i] = (uint16_t)(d & 0xFFFFu);
    }
    crc_ready = 1;
}

static uint8_t crc8_buf(const uint8_t *p, int64_t n) {
    uint8_t c = 0;
    for (int64_t i = 0; i < n; i++) c = crc8_table[c ^ p[i]];
    return c;
}

static uint16_t crc16_buf(const uint8_t *p, int64_t n) {
    uint16_t c = 0;
    for (int64_t i = 0; i < n; i++)
        c = (uint16_t)(crc16_table[((c >> 8) ^ p[i]) & 0xFF] ^ (uint16_t)(c << 8));
    return c;
}

/* ------------------------------------------------------------------ */
/* encoder pieces mirroring transcode.py exactly                        */
/* ------------------------------------------------------------------ */

/* FLAC UTF-8-style coded frame number; returns byte count */
static int utf8_number(uint64_t n, uint8_t *out) {
    if (n < 0x80) { out[0] = (uint8_t)n; return 1; }
    static const int lead_bits[] = {11, 16, 21, 26, 31};
    static const uint8_t prefix[] = {0xC0, 0xE0, 0xF0, 0xF8, 0xFC};
    for (int j = 0; j < 5; j++) {
        if (n < (1ULL << lead_bits[j])) {
            int n_cont = (lead_bits[j] - 6) / 5;
            out[0] = (uint8_t)(prefix[j] | (n >> (6 * n_cont)));
            for (int i = 0; i < n_cont; i++)
                out[1 + i] = (uint8_t)(0x80 | ((n >> (6 * (n_cont - 1 - i))) & 0x3F));
            return 1 + n_cont;
        }
    }
    return -1;
}

/* rice parameter exactly as _rice_fields: zigzag mean -> floor(log2) ->
 * refine over [k-1, k+2] by exact total bits (strict improvement wins) */
static int rice_k(const uint64_t *u, int64_t n, int64_t *total_nbits,
                  int64_t *max_nbits) {
    /* exact parity with numpy: zigzag residuals of 16-bit audio are
     * < 2^21, so the integer sum is exact in uint64 (numpy's pairwise
     * double sum of these integers is exact too), and one double divide
     * matches np.mean bit-for-bit */
    uint64_t s = 0;
    for (int64_t i = 0; i < n; i++) s += u[i];
    double mean = (double)s / (double)(n > 0 ? n : 1);
    if (mean < 0.1) mean = 0.1;
    int k = 0;
    if (mean >= 1.0) {
        k = (int)floor(log2(mean));
        if (k < 0) k = 0;
        if (k > 30) k = 30;
    }
    int lo = k - 1 < 0 ? 0 : k - 1;
    int hi = k + 2 > 30 ? 30 : k + 2;
    int best_k = lo;
    int64_t best_bits = -1;
    for (int kk = lo; kk <= hi; kk++) {
        int64_t bits = 0;
        for (int64_t i = 0; i < n; i++) bits += (int64_t)(u[i] >> kk);
        bits += n * (1 + kk);
        if (best_bits < 0 || bits < best_bits) { best_k = kk; best_bits = bits; }
    }
    int64_t mx = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t nb = (int64_t)(u[i] >> best_k) + 1 + best_k;
        if (nb > mx) mx = nb;
    }
    *total_nbits = best_bits;
    *max_nbits = mx;
    return best_k;
}

/* one channel of one frame */
static void encode_subframe(const int64_t *x, int64_t n, BitWriter *bw,
                            int64_t *res, uint64_t *u) {
    const int bps = 16;
    const uint64_t mask = (1ULL << bps) - 1;

    int constant = n > 0;
    for (int64_t i = 1; i < n && constant; i++)
        if (x[i] != x[0]) constant = 0;
    if (constant) {
        bw_put(bw, 0, 1);
        bw_put(bw, 0x00, 6);
        bw_put(bw, 0, 1);
        bw_put(bw, (uint64_t)x[0] & mask, bps);
        return;
    }

    /* best fixed order 0..4 by min sum|res| (strict <, ascending order;
     * |res| < 2^21 so the int64 cost sum is exact, matching the Python
     * float() of an exact integer) */
    int best_o = 0;
    int64_t best_cost = -1;
    for (int o = 0; o <= 4; o++) {
        if (n <= o) break;
        /* o-th difference into res */
        for (int64_t i = 0; i < n; i++) res[i] = x[i];
        int64_t m = n;
        for (int d = 0; d < o; d++) {
            for (int64_t i = 0; i + 1 < m; i++) res[i] = res[i + 1] - res[i];
            m--;
        }
        int64_t cost = 0;
        for (int64_t i = 0; i < m; i++)
            cost += res[i] < 0 ? -res[i] : res[i];
        if (best_cost < 0 || cost < best_cost) { best_cost = cost; best_o = o; }
    }
    /* recompute best residual */
    for (int64_t i = 0; i < n; i++) res[i] = x[i];
    int64_t m = n;
    for (int d = 0; d < best_o; d++) {
        for (int64_t i = 0; i + 1 < m; i++) res[i] = res[i + 1] - res[i];
        m--;
    }
    for (int64_t i = 0; i < m; i++)  /* zigzag */
        u[i] = ((uint64_t)res[i] << 1) ^ (uint64_t)(res[i] >> 63);

    int64_t total_nbits, max_nbits;
    int k = rice_k(u, m, &total_nbits, &max_nbits);
    int64_t est = (int64_t)best_o * bps + total_nbits;

    if (est >= n * bps || max_nbits > 60) {
        bw_put(bw, 0, 1);
        bw_put(bw, 0x01, 6);
        bw_put(bw, 0, 1);
        for (int64_t i = 0; i < n; i++)
            bw_put(bw, (uint64_t)x[i] & mask, bps);
        return;
    }

    bw_put(bw, 0, 1);
    bw_put(bw, (uint64_t)(0x08 | best_o), 6);
    bw_put(bw, 0, 1);
    for (int i = 0; i < best_o; i++)
        bw_put(bw, (uint64_t)x[i] & mask, bps);
    bw_put(bw, 0x0, 2);  /* rice method */
    bw_put(bw, 0x0, 4);  /* partition order 0 */
    bw_put(bw, (uint64_t)k, 4);
    for (int64_t i = 0; i < m; i++) {
        int64_t q = (int64_t)(u[i] >> k);
        bw_put_zeros(bw, q);
        bw_put(bw, (1ULL << k) | (u[i] & ((1ULL << k) - 1)), 1 + k);
    }
}

/* ------------------------------------------------------------------ */
/* public entry                                                         */
/* ------------------------------------------------------------------ */

/* audio: interleaved int16, n_total samples x n_ch channels.
 * Writes all FLAC frames (headers + subframes + CRCs) into out.
 * Returns bytes written, -1 on out_cap overflow, -2 on bad args. */
int64_t fs_flac_encode_frames(const int16_t *audio, int64_t n_total,
                              int32_t n_ch, int32_t block_size,
                              int32_t sample_rate, uint8_t *out,
                              int64_t out_cap) {
    (void)sample_rate; /* frame header uses the STREAMINFO sr code */
    if (n_total < 0 || n_ch < 1 || n_ch > 8 || block_size < 1) return -2;
    crc_init();

    int64_t scratch_n = block_size;
    /* grow-only thread-local scratch: x / res / u, one block each */
    static __thread int64_t *xbuf = 0;
    static __thread int64_t *resbuf = 0;
    static __thread uint64_t *ubuf = 0;
    static __thread int64_t scratch_cap = 0;
    if (scratch_cap < scratch_n) {
        if (xbuf) { free(xbuf); free(resbuf); free(ubuf); }
        xbuf = (int64_t *)malloc(sizeof(int64_t) * scratch_n);
        resbuf = (int64_t *)malloc(sizeof(int64_t) * scratch_n);
        ubuf = (uint64_t *)malloc(sizeof(uint64_t) * scratch_n);
        if (!xbuf || !resbuf || !ubuf) return -2;
        scratch_cap = scratch_n;
    }

    int64_t pos = 0;
    uint64_t f_idx = 0;
    for (int64_t start = 0; start < n_total; start += block_size, f_idx++) {
        int64_t bs = n_total - start;
        if (bs > block_size) bs = block_size;

        uint8_t hdr[24];
        int h = 0;
        hdr[h++] = 0xFF; hdr[h++] = 0xF8;
        hdr[h++] = (uint8_t)((0x7 << 4) | 0x0);
        hdr[h++] = (uint8_t)(((n_ch - 1) << 4) | (0x4 << 1));
        int un = utf8_number(f_idx, hdr + h);
        if (un < 0) return -2;
        h += un;
        hdr[h++] = (uint8_t)(((bs - 1) >> 8) & 0xFF);
        hdr[h++] = (uint8_t)((bs - 1) & 0xFF);
        hdr[h] = crc8_buf(hdr, h); h++;

        if (pos + h > out_cap) return -1;
        memcpy(out + pos, hdr, (size_t)h);
        int64_t frame_start = pos;
        pos += h;

        BitWriter bw;
        bw_init(&bw, out + pos, out_cap - pos);
        for (int c = 0; c < n_ch; c++) {
            for (int64_t i = 0; i < bs; i++)
                xbuf[i] = (int64_t)audio[(start + i) * n_ch + c];
            encode_subframe(xbuf, bs, &bw, resbuf, ubuf);
            if (bw.overflow) return -1;
        }
        bw_align(&bw);
        if (bw.overflow) return -1;
        pos += bw.byte;

        uint16_t c16 = crc16_buf(out + frame_start, pos - frame_start);
        if (pos + 2 > out_cap) return -1;
        out[pos++] = (uint8_t)(c16 >> 8);
        out[pos++] = (uint8_t)(c16 & 0xFF);
    }
    return pos;
}
