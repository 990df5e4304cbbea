// CRC32C (Castagnoli) of a host buffer: the shuffle frame checksum.
//
// Host code only: nvcc builds it like the kernel sources into its own
// shared library with a plain C interface, so the port has the frame
// format's checksum on a machine without the google_crc32c package
// (shuffle/ipc.py takes that package first, then this library, and never
// zlib's CRC-32, which is another polynomial).  The format is the JAX
// package's: blaze_tpu/shuffle/ipc.py frames carry CRC32C of the payload.
//
// Reflected polynomial 0x82F63B78, initial value and final xor 0xFFFFFFFF,
// so crc32c("123456789") = 0xE3069283.  Slicing-by-8: eight 256-entry
// tables, built once when the library is loaded, fold eight bytes per
// step; the head and tail go a byte at a time.  Portable C++, no
// instruction-set flags.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kPoly = 0x82F63B78u;

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c >> 1) ^ ((c & 1u) ? kPoly : 0u);
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; ++i) {
      for (int s = 1; s < 8; ++s) {
        uint32_t prev = t[s - 1][i];
        t[s][i] = (prev >> 8) ^ t[0][prev & 0xFFu];
      }
    }
  }
};

const Tables kTables;

}  // namespace

// CRC32C of n bytes at data, continuing from a previous result `crc`
// (0 to start).
extern "C" uint32_t blaze_crc32c(const unsigned char* data, long long n,
                                 uint32_t crc) {
  const uint32_t(*t)[256] = kTables.t;
  uint32_t c = ~crc;
  while (n > 0 && (reinterpret_cast<uintptr_t>(data) & 7u)) {
    c = (c >> 8) ^ t[0][(c ^ *data++) & 0xFFu];
    --n;
  }
  while (n >= 8) {
    uint32_t lo, hi;
    std::memcpy(&lo, data, 4);
    std::memcpy(&hi, data + 4, 4);
    lo ^= c;  // little-endian host (x86-64)
    c = t[7][lo & 0xFFu] ^ t[6][(lo >> 8) & 0xFFu] ^
        t[5][(lo >> 16) & 0xFFu] ^ t[4][lo >> 24] ^
        t[3][hi & 0xFFu] ^ t[2][(hi >> 8) & 0xFFu] ^
        t[1][(hi >> 16) & 0xFFu] ^ t[0][hi >> 24];
    data += 8;
    n -= 8;
  }
  while (n-- > 0) c = (c >> 8) ^ t[0][(c ^ *data++) & 0xFFu];
  return ~c;
}
