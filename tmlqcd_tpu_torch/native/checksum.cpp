// SciDAC / DML checksum of per-site binary records, in host C++.
//
// Each site's bytes get a CRC-32 (IEEE 802.3, polynomial 0xEDB88320: zlib's
// crc32); the site of global lexicographic rank n contributes its CRC rotated
// left by n % 29 to suma and by n % 31 to sumb, and the contributions xor
// together (reference: io/dml.c `DML_checksum_accum`).  This is the hot host
// loop of checkpoint and propagator I/O at production volumes (32^3 x 64 =
// 2M sites of 1152 bytes).
//
// Built with `g++ -O3 -shared -fPIC` at first use by
// tmlqcd_tpu_torch/native/__init__.py and loaded with ctypes.

#include <cstddef>
#include <cstdint>

namespace {

struct Crc32Table {
    uint32_t t[256];
    Crc32Table() {
        for (uint32_t i = 0; i < 256; ++i) {
            uint32_t c = i;
            for (int k = 0; k < 8; ++k)
                c = (c & 1u) ? 0xEDB88320u ^ (c >> 1) : (c >> 1);
            t[i] = c;
        }
    }
};
const Crc32Table kCrc;

inline uint32_t crc32_bytes(const uint8_t* p, size_t n) {
    uint32_t c = 0xFFFFFFFFu;
    for (size_t i = 0; i < n; ++i)
        c = kCrc.t[(c ^ p[i]) & 0xFFu] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

inline uint32_t rotl32(uint32_t x, uint32_t s) {
    s &= 31u;
    return s ? ((x << s) | (x >> (32u - s))) : x;
}

}  // namespace

extern "C" {

// Checksum of `nsites` consecutive sites of `site_bytes` each, the first of
// global rank `rank0`, xor-accumulated into *suma / *sumb (zero them first,
// or chain disjoint site ranges).
void tm_scidac_checksum(const uint8_t* data, uint64_t site_bytes, uint64_t nsites,
                        uint64_t rank0, uint32_t* suma, uint32_t* sumb) {
    uint32_t a = *suma, b = *sumb;
    for (uint64_t s = 0; s < nsites; ++s) {
        uint32_t crc = crc32_bytes(data + s * site_bytes, site_bytes);
        uint64_t rank = rank0 + s;
        a ^= rotl32(crc, (uint32_t)(rank % 29u));
        b ^= rotl32(crc, (uint32_t)(rank % 31u));
    }
    *suma = a;
    *sumb = b;
}

}  // extern "C"
