// Native COCO RLE codec (host data path).
//
// C++ replacement for the hot host-side loops of the RLE pipeline — the
// reference links against pycocotools' C implementation (`pycocotools.mask`)
// and computes run boundaries on GPU (sam3/train/masks_ops.py:160-250);
// this library plays the same role for the TPU build: the train/eval data
// path decodes thousands of RLE masks per epoch and the prediction dumper
// encodes every predicted mask, so these run in C instead of per-run Python.
//
// Format: pycocotools-compatible — column-major runs, first run counts
// zeros, varint string with 6-bit chars offset by 48 and delta coding of
// every count against the one two positions back (rleToString/rleFrString).
//
// Build: g++ -O3 -shared -fPIC rle.cpp -o librle.so   (done lazily by
// sam3_lora_tpu/native/__init__.py, cached next to this file).

#include <cstdint>
#include <cstring>

extern "C" {

// mask (column-major flat, 0/1 uint8, length `total`) -> counts.
// Returns number of counts written (<= total + 1).
int64_t rle_encode_counts(const uint8_t* flat, int64_t total, int64_t* counts) {
    int64_t n = 0;
    uint8_t val = 0;  // first run counts zeros
    int64_t run = 0;
    for (int64_t i = 0; i < total; ++i) {
        if (flat[i] != val) {
            counts[n++] = run;
            run = 0;
            val = flat[i];
        }
        ++run;
    }
    counts[n++] = run;
    return n;
}

// counts -> column-major flat mask (caller zeroes `out`, length `total`).
void rle_decode_counts(const int64_t* counts, int64_t n, uint8_t* out,
                       int64_t total) {
    int64_t pos = 0;
    uint8_t val = 0;
    for (int64_t i = 0; i < n && pos < total; ++i) {
        int64_t c = counts[i];
        if (c > total - pos) c = total - pos;
        if (val) memset(out + pos, 1, (size_t)c);
        pos += c;
        val ^= 1;
    }
}

// counts -> varint string (chars '0'+). Returns string length.
// `out` must hold >= 8 * n chars.
int64_t rle_counts_to_string(const int64_t* counts, int64_t n, char* out) {
    int64_t m = 0;
    for (int64_t i = 0; i < n; ++i) {
        int64_t x = counts[i];
        if (i > 2) x -= counts[i - 2];
        bool more = true;
        while (more) {
            int64_t c = x & 0x1f;
            x >>= 5;
            more = (c & 0x10) ? (x != -1) : (x != 0);
            if (more) c |= 0x20;
            out[m++] = (char)(c + 48);
        }
    }
    return m;
}

// varint string -> counts. Returns number of counts (<= len).
int64_t rle_string_to_counts(const char* s, int64_t len, int64_t* counts) {
    int64_t n = 0, i = 0;
    while (i < len) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        int64_t c = 0;
        while (more && i < len) {
            c = (int64_t)s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
        }
        if (!more && (c & 0x10)) x |= -1ll << (5 * k);
        if (n > 2) x += counts[n - 2];
        counts[n++] = x;
    }
    return n;
}

// Fused decode: varint string -> flat mask (zeroed by caller). Avoids the
// intermediate counts round-trip for the dataset hot path.
void rle_string_decode(const char* s, int64_t len, uint8_t* out, int64_t total) {
    int64_t pos = 0, i = 0, prev2 = 0, prev1 = 0, idx = 0;
    uint8_t val = 0;
    while (i < len && pos < total) {
        int64_t x = 0;
        int k = 0;
        bool more = true;
        int64_t c = 0;
        while (more && i < len) {
            c = (int64_t)s[i] - 48;
            x |= (c & 0x1f) << (5 * k);
            more = (c & 0x20) != 0;
            ++i;
            ++k;
        }
        if (!more && (c & 0x10)) x |= -1ll << (5 * k);
        if (idx > 2) x += prev2;
        prev2 = prev1;
        prev1 = x;
        ++idx;
        int64_t run = x;
        if (run > total - pos) run = total - pos;
        if (run > 0) {
            if (val) memset(out + pos, 1, (size_t)run);
            pos += run;
        }
        val ^= 1;
    }
}

// Area-average downsample of an (h, w) float mask to (out, out) with 0.5
// threshold — the GT mask-loss path (validate_sam3_lora.py:463-533) when
// h, w are exact multiples of out.
void downsample_mask_exact(const float* in, int64_t h, int64_t w, int64_t out,
                           float* dst) {
    int64_t fy = h / out, fx = w / out;
    float inv = 1.0f / (float)(fy * fx);
    for (int64_t oy = 0; oy < out; ++oy) {
        for (int64_t ox = 0; ox < out; ++ox) {
            float acc = 0.f;
            for (int64_t dy = 0; dy < fy; ++dy) {
                const float* row = in + (oy * fy + dy) * w + ox * fx;
                for (int64_t dx = 0; dx < fx; ++dx) acc += row[dx];
            }
            dst[oy * out + ox] = (acc * inv) > 0.5f ? 1.0f : 0.0f;
        }
    }
}

}  // extern "C"
