/* The benchmark's JPEG entropy coder: one baseline sequential scan of
 * given quantised coefficients, Huffman-coded with the tables it is given,
 * 0x00 stuffed after every 0xFF, a restart marker between restart
 * intervals. Built and loaded by perfbench/packer.py. */
#include <stdint.h>

typedef struct {
    uint8_t *out;
    int64_t pos, cap;
    uint64_t acc;
    int nbits;
} Writer;

static void put(Writer *w, uint32_t v, int n) {
    w->acc = (w->acc << n) | (v & ((1u << n) - 1u));
    w->nbits += n;
    while (w->nbits >= 8) {
        uint8_t b = (uint8_t)(w->acc >> (w->nbits - 8));
        w->nbits -= 8;
        if (w->pos + 2 > w->cap) {
            w->pos = w->cap + 1;
            return;
        }
        w->out[w->pos++] = b;
        if (b == 0xFF) w->out[w->pos++] = 0;
    }
}

static void align(Writer *w) {
    if (w->nbits) put(w, 0x7F, 8 - w->nbits);
}

static int bits_of(int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
        n++;
        a >>= 1;
    }
    return n;
}

static void put_value(Writer *w, uint32_t code, int len, int v, int size) {
    put(w, code, len);
    if (size) put(w, (uint32_t)(v < 0 ? v + (1 << size) - 1 : v), size);
}

/* coefs: int16 [n_blocks][64] zigzag, in scan order; table: 0 (luma) or 1
 * (chroma) a block; comp: the component of a block (< 4); seg_blocks: the
 * blocks of a restart interval (0: one interval); code, len: [4][256], the
 * DC and AC tables of luma, then of chroma. Writes into out (capacity
 * cap) and returns the bytes written, or -1 where they do not fit;
 * *symbols gets the Huffman symbols coded. */
int64_t pb_pack_scan(const int16_t *coefs, const uint8_t *table, const uint8_t *comp,
                     int64_t n_blocks, int64_t seg_blocks, const int32_t *code,
                     const int32_t *len, uint8_t *out, int64_t cap, int64_t *symbols) {
    Writer w = {out, 0, cap, 0, 0};
    int pred[4] = {0, 0, 0, 0};
    int64_t nsym = 0, seg = 0;
    for (int64_t b = 0; b < n_blocks; b++) {
        if (seg_blocks && b && b % seg_blocks == 0) {
            align(&w);
            if (w.pos + 2 > w.cap) return -1;
            w.out[w.pos++] = 0xFF;
            w.out[w.pos++] = (uint8_t)(0xD0 + seg % 8);
            seg++;
            pred[0] = pred[1] = pred[2] = pred[3] = 0;
        }
        const int16_t *c = coefs + 64 * b;
        const int32_t *dcc = code + 512 * table[b], *dcl = len + 512 * table[b];
        const int32_t *acc = dcc + 256, *acl = dcl + 256;
        int diff = c[0] - pred[comp[b]];
        pred[comp[b]] = c[0];
        int s = bits_of(diff);
        if (!dcl[s]) return -1;
        put_value(&w, (uint32_t)dcc[s], dcl[s], diff, s);
        nsym++;
        int run = 0;
        for (int k = 1; k < 64; k++) {
            int v = c[k];
            if (!v) {
                run++;
                continue;
            }
            while (run > 15) {
                put(&w, (uint32_t)acc[0xF0], acl[0xF0]);
                nsym++;
                run -= 16;
            }
            s = bits_of(v);
            int sym = run * 16 + s;
            if (!acl[sym]) return -1;
            put_value(&w, (uint32_t)acc[sym], acl[sym], v, s);
            nsym++;
            run = 0;
        }
        if (run) {
            put(&w, (uint32_t)acc[0], acl[0]);
            nsym++;
        }
    }
    align(&w);
    *symbols = nsym;
    return w.pos > w.cap ? -1 : w.pos;
}
