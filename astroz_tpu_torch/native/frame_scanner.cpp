// Bulk telemetry frame scanner of astroz_tpu_torch (CCSDS 133.0-B space
// packets, VITA 49 VRT packets), a copy of
// astroz_tpu/native/frame_scanner.cpp.
//
// io/parsers.py's byte-level resync walk (on a malformed frame advance
// one byte and rescan) is O(bytes) interpreter work on garbage-heavy
// streams; this scanner performs the same walk natively and returns SoA
// (offset, length) tables, leaving per-frame field extraction to
// Python. Validation mirrors Ccsds.parse / Vita49.parse exactly so the
// two paths accept identical frame sets (tests/test_torch_native.py).
//
// Built into the port's one native library (native/__init__.py); plain
// C ABI for ctypes.

#include <cstdint>
#include <cstring>

namespace {

inline uint16_t be16(const unsigned char* p) {
    return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

inline uint32_t be32(const unsigned char* p) {
    return (static_cast<uint32_t>(p[0]) << 24) |
           (static_cast<uint32_t>(p[1]) << 16) |
           (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// CCSDS: 6-byte primary header; total = 6 + data_length + 1.
// Mirrors Ccsds.parse (io/ccsds.py): the only length-independent
// validation is buffer coverage (any header bit pattern is legal).
inline long long ccsds_frame_len(const unsigned char* p, long long avail) {
    if (avail < 6) return -1;
    const long long total = 6 + static_cast<long long>(be16(p + 4)) + 1;
    if (total > avail) return -1;
    return total;
}

// VITA49: 4-byte header word; size field in 32-bit words. Mirrors
// Vita49.parse (io/vita49.py): size_words != 0, buffer coverage, and
// payload_end >= off for the declared prologue fields. All 16 packet
// types are valid enum values, so no type check is needed.
inline long long vita49_frame_len(const unsigned char* p, long long avail) {
    if (avail < 4) return -1;
    const uint32_t hdr = be32(p);
    const uint32_t ptype = (hdr >> 28) & 0xF;
    if (ptype > 0x7) return -1;  // PacketType enum covers 0x0..0x7
    const bool has_class = (hdr >> 27) & 1;
    const bool has_trailer = (hdr >> 26) & 1;
    const uint32_t tsi = (hdr >> 22) & 0x3;
    const uint32_t tsf = (hdr >> 20) & 0x3;
    const long long size_words = hdr & 0xFFFF;
    if (size_words == 0) return -1;
    const long long total = size_words * 4;
    if (total > avail) return -1;
    long long off = 4;
    // stream id present for types 1, 3, 4, 5, 6, 7
    if (ptype == 1 || ptype >= 3) off += 4;
    if (has_class) off += 8;
    if (tsi != 0) off += 4;
    if (tsf != 0) off += 8;
    const long long payload_end = total - (has_trailer ? 4 : 0);
    if (payload_end < off) return -1;
    return total;
}

typedef long long (*frame_len_fn)(const unsigned char*, long long);

// Shared scan loop replicating io/parsers.py iter_frames: with a sync
// pattern, find each occurrence and parse the frame that follows (on
// failure advance one byte past the position AFTER the pattern and
// rescan); without one, attempt a parse at every position, advancing
// one byte on failure.
long long scan(frame_len_fn frame_len, const unsigned char* data,
               long long n, const unsigned char* sync, long long sync_len,
               long long* offsets, long long* lengths,
               long long max_frames) {
    long long count = 0;
    long long pos = 0;
    while (pos < n && count < max_frames) {
        if (sync_len > 0) {
            const void* hit = nullptr;
            if (n - pos >= sync_len)
                hit = memmem(data + pos, static_cast<size_t>(n - pos),
                             sync, static_cast<size_t>(sync_len));
            if (hit == nullptr) break;
            pos = static_cast<const unsigned char*>(hit) - data + sync_len;
        }
        const long long len = frame_len(data + pos, n - pos);
        if (len < 0) {
            pos += 1;
            continue;
        }
        offsets[count] = pos;
        lengths[count] = len;
        ++count;
        pos += len > 0 ? len : 1;
    }
    return count;
}

}  // namespace

extern "C" {

long long astroz_scan_ccsds(const unsigned char* data, long long n,
                            const unsigned char* sync, long long sync_len,
                            long long* offsets, long long* lengths,
                            long long max_frames) {
    return scan(ccsds_frame_len, data, n, sync, sync_len, offsets,
                lengths, max_frames);
}

long long astroz_scan_vita49(const unsigned char* data, long long n,
                             const unsigned char* sync, long long sync_len,
                             long long* offsets, long long* lengths,
                             long long max_frames) {
    return scan(vita49_frame_len, data, n, sync, sync_len, offsets,
                lengths, max_frames);
}

}  // extern "C"
