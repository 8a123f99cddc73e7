// TIFF codec kernels: LZW and PackBits decompression.
//
// The framework owns its GeoTIFF I/O (no rasterio/GDAL in the image);
// these are the hot byte-stream decoders behind neilpy_tpu_torch/io/geotiff.py
// for compressed rasters (LZW is the most common DEM compression in the
// wild; parity target: the reference's rasterio-backed imread,
// reference neilpy/neilpy.py:114-158).  Pure-Python fallbacks live in
// neilpy_tpu_torch/io/tiff_codec.py.
//
// Built at first use by neilpy_tpu_torch/_host_build.py (g++).

#include <cstdint>
#include <cstring>

extern "C" {

// TIFF-flavour LZW (TIFF 6.0 spec, section 13): MSB-first bit packing,
// ClearCode=256, EOI=257, first table entry 258, 9->12 bit codes with
// the TIFF "early change" (width bumps one code earlier than GIF).
// Returns bytes written, or -1 on malformed input / dst overflow.
long lzw_decode(const uint8_t* src, long src_len,
                uint8_t* dst, long dst_cap) {
    static const int CLEAR = 256, EOI = 257, MAXCODE = 4096;
    // Table as (prefix link, tail byte, length); first-byte cache lets
    // us emit strings by walking links backwards into dst.
    int16_t prefix[MAXCODE];
    uint8_t tail[MAXCODE];
    uint8_t first[MAXCODE];
    int32_t length[MAXCODE];
    for (int i = 0; i < 256; ++i) {
        prefix[i] = -1; tail[i] = (uint8_t)i;
        first[i] = (uint8_t)i; length[i] = 1;
    }
    int next = 258, width = 9;
    uint32_t bitbuf = 0;
    int bits = 0;
    long si = 0, di = 0;
    int prev = -1;

    while (true) {
        while (bits < width) {
            if (si >= src_len) return di;  // stream exhausted == done
            bitbuf = (bitbuf << 8) | src[si++];
            bits += 8;
        }
        bits -= width;
        int code = (int)((bitbuf >> bits) & ((1u << width) - 1));
        if (code == EOI) return di;
        // Output already full: stop, tolerating whatever trails (a
        // misaligned EOI from sloppy writers) — matches the Python
        // fallback's while(out_len < expected) semantics and libtiff.
        if (di >= dst_cap) return di;
        if (code == CLEAR) {
            next = 258; width = 9; prev = -1;
            continue;
        }
        if (prev < 0) {
            if (code >= 256) return -1;
            if (di >= dst_cap) return -1;
            dst[di++] = (uint8_t)code;
            prev = code;
        } else {
            int emit;
            uint8_t kfirst;
            if (code < next) {
                emit = code;
                kfirst = first[code];
            } else if (code == next) {  // KwKwK case
                emit = prev;
                kfirst = first[prev];
            } else {
                return -1;
            }
            long n = length[emit] + (code == next ? 1 : 0);
            long end = di + n;
            if (end > dst_cap) {
                // final string truncated by a full output buffer:
                // store only in-capacity bytes (the backward walk
                // emits the tail first; the KwKwK tail byte at end-1
                // is always beyond capacity here), then stop —
                // matches the Python fallback's
                // while(out_len < expected) and libtiff's tolerance
                // of sloppy writers
                long w = di + length[emit];
                int c = emit;
                while (c >= 0) {
                    --w;
                    if (w < dst_cap) dst[w] = tail[c];
                    c = prefix[c];
                }
                return dst_cap;
            }
            if (code == next) dst[end - 1] = kfirst;
            long w = di + length[emit];
            int c = emit;
            while (c >= 0) { dst[--w] = tail[c]; c = prefix[c]; }
            di = end;
            if (next < MAXCODE) {
                prefix[next] = (int16_t)prev;
                tail[next] = kfirst;
                first[next] = first[prev];
                length[next] = length[prev] + 1;
                ++next;
            }
            prev = code;
            // TIFF early change: bump width when the NEXT code would
            // not fit, one entry before the table actually fills.
            if (next == (1 << width) - 1 && width < 12) ++width;
        }
    }
}

// PackBits (Apple / TIFF 6.0 section 9). Returns bytes written or -1.
long packbits_decode(const uint8_t* src, long src_len,
                     uint8_t* dst, long dst_cap) {
    long si = 0, di = 0;
    while (si < src_len && di < dst_cap) {
        int8_t n = (int8_t)src[si++];
        if (n >= 0) {
            long cnt = (long)n + 1;
            if (si + cnt > src_len) cnt = src_len - si;
            if (di + cnt > dst_cap) cnt = dst_cap - di;
            std::memcpy(dst + di, src + si, (size_t)cnt);
            si += cnt; di += cnt;
        } else if (n != -128) {
            long cnt = 1 - (long)n;
            if (si >= src_len) break;
            if (di + cnt > dst_cap) cnt = dst_cap - di;
            std::memset(dst + di, src[si++], (size_t)cnt);
            di += cnt;
        }
    }
    return di;
}

}  // extern "C"
