// Blosc1 frames with the zstd codec, written and read without libblosc.
//
// The product metric is the chunked compression ratio of blosc-zstd with
// the byte shuffle (c-blosc 1.x, the library numcodecs wraps). A machine
// that has libzstd but no libblosc can still compute it exactly: a blosc1
// zstd frame is a 16-byte header, one 4-byte start per block, and per
// block a 4-byte length and the zstd frame of the (byte-shuffled) block,
// or the block stored raw where zstd does not shrink it. This source
// writes those frames the way blosc_compress_ctx does (the same block
// size, the same level mapping, the same raw-store and memcpy rules), so
// they are byte-equal to libblosc's over the same libzstd, and reads
// zstd and memcpyed frames back. It links only libzstd.so.1.
//
// C interface, bound with ctypes (compression/blosc1.py):
//   exaspim_blosc1_encode      one frame (destsize >= nbytes + 16)
//   exaspim_blosc1_decode      one zstd or memcpyed frame
//   exaspim_blosc1_chunked_cratio  the chunk-grid walk over a thread pool
//   exaspim_blosc1_zstd_version    ZSTD_versionString()

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

extern "C" {
// Prototypes for libzstd.so.1 (zstd.h need not be installed).
typedef struct ZSTD_CCtx_s ZSTD_CCtx;
size_t ZSTD_compressBound(size_t srcSize);
ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
size_t ZSTD_compressCCtx(ZSTD_CCtx* cctx, void* dst, size_t dstCapacity,
                         const void* src, size_t srcSize, int level);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
unsigned ZSTD_isError(size_t code);
int ZSTD_maxCLevel(void);
const char* ZSTD_versionString(void);
}

namespace {

// blosc.h / blosc.c (c-blosc 1.x) constants.
constexpr uint8_t kVersionFormat = 2;      // BLOSC_VERSION_FORMAT
constexpr uint8_t kZstdVersionFormat = 1;  // BLOSC_ZSTD_VERSION_FORMAT
constexpr uint8_t kZstdFormat = 4;         // BLOSC_ZSTD_FORMAT
constexpr uint8_t kDoShuffle = 0x1;        // BLOSC_DOSHUFFLE
constexpr uint8_t kMemcpyed = 0x2;         // BLOSC_MEMCPYED
constexpr uint8_t kDoBitshuffle = 0x4;     // BLOSC_DOBITSHUFFLE
constexpr uint8_t kDontSplit = 0x10;       // zstd blocks are never split
constexpr int64_t kMaxOverhead = 16;       // BLOSC_MAX_OVERHEAD
constexpr int64_t kMinBufferSize = 128;    // MIN_BUFFERSIZE
constexpr int64_t kL1 = 32 * 1024;         // L1
constexpr int64_t kMaxTypesize = 255;      // BLOSC_MAX_TYPESIZE
constexpr int64_t kMaxBufferSize = INT32_MAX - kMaxOverhead;

// Error codes of the C interface.
constexpr int64_t kErrArgs = -1;
constexpr int64_t kErrMemory = -2;
constexpr int64_t kErrFrame = -3;       // truncated or inconsistent frame
constexpr int64_t kErrCompressor = -4;  // a compressor other than zstd
constexpr int64_t kErrBitshuffle = -5;
constexpr int64_t kErrZstd = -6;

struct CCtxFree {
  void operator()(ZSTD_CCtx* c) const { ZSTD_freeCCtx(c); }
};
using CCtx = std::unique_ptr<ZSTD_CCtx, CCtxFree>;

void put32(uint8_t* p, int64_t v) {
  const uint32_t u = static_cast<uint32_t>(v);
  p[0] = u & 0xff;
  p[1] = (u >> 8) & 0xff;
  p[2] = (u >> 16) & 0xff;
  p[3] = (u >> 24) & 0xff;
}

int64_t get32(const uint8_t* p) {
  return static_cast<int32_t>(static_cast<uint32_t>(p[0]) |
                              (static_cast<uint32_t>(p[1]) << 8) |
                              (static_cast<uint32_t>(p[2]) << 16) |
                              (static_cast<uint32_t>(p[3]) << 24));
}

// compute_blocksize for zstd (an HCR codec, never split) and no forced
// block size.
int64_t blocksize_for(int clevel, int64_t typesize, int64_t nbytes) {
  if (nbytes < typesize) return 1;
  int64_t bs = nbytes;
  if (nbytes >= kL1) {
    bs = kL1 * 2;  // HCR codecs: twice the block of the fast ones
    switch (clevel) {
      case 0: bs /= 4; break;
      case 1: bs /= 2; break;
      case 2: break;
      case 3: bs *= 2; break;
      case 4: case 5: bs *= 4; break;
      case 6: case 7: case 8: bs *= 8; break;
      default: bs *= 16; break;  // 9: x8, and x2 again for HCR codecs
    }
  }
  if (bs > nbytes) bs = nbytes;
  if (bs > typesize) bs = bs / typesize * typesize;
  return bs;
}

// blosc's zstd level: 2 * clevel - 1, and zstd's maximum at clevel 9.
int zstd_level(int clevel) {
  return clevel < 9 ? clevel * 2 - 1 : ZSTD_maxCLevel();
}

// Byte shuffle of one block: byte j of element i goes to j * n + i; the
// bytes past the last whole element are copied as they are.
void shuffle(int64_t typesize, int64_t size, const uint8_t* src,
             uint8_t* dst) {
  const int64_t n = size / typesize;
  for (int64_t j = 0; j < typesize; ++j)
    for (int64_t i = 0; i < n; ++i) dst[j * n + i] = src[i * typesize + j];
  std::memcpy(dst + n * typesize, src + n * typesize, size - n * typesize);
}

void unshuffle(int64_t typesize, int64_t size, const uint8_t* src,
               uint8_t* dst) {
  const int64_t n = size / typesize;
  for (int64_t j = 0; j < typesize; ++j)
    for (int64_t i = 0; i < n; ++i) dst[i * typesize + j] = src[j * n + i];
  std::memcpy(dst + n * typesize, src + n * typesize, size - n * typesize);
}

// blosc_c for one unsplit zstd block at dest + ntbytes: its 4-byte length,
// then the zstd frame, or the block raw when zstd does not shrink it.
// Returns the bytes written, 0 when the block does not fit (the frame is
// then memcpyed), or an error code.
int64_t compress_block(ZSTD_CCtx* cctx, int level, int64_t bsize,
                       const uint8_t* block, uint8_t* dest, int64_t ntbytes,
                       int64_t maxbytes) {
  ntbytes += 4;
  int64_t maxout = bsize;
  if (ntbytes + maxout > maxbytes) {
    maxout = maxbytes - ntbytes;
    if (maxout <= 0) return 0;
  }
  uint8_t* out = dest + ntbytes;
  size_t code = ZSTD_compressCCtx(cctx, out, static_cast<size_t>(maxout),
                                  block, static_cast<size_t>(bsize), level);
  int64_t cbytes = ZSTD_isError(code) ? 0 : static_cast<int64_t>(code);
  if (cbytes == 0 || cbytes == bsize) {
    if (ntbytes + bsize > maxbytes) return 0;
    std::memcpy(out, block, static_cast<size_t>(bsize));
    cbytes = bsize;
  }
  put32(dest + ntbytes - 4, cbytes);
  return 4 + cbytes;
}

int64_t encode(ZSTD_CCtx* cctx, const uint8_t* src, int64_t nbytes,
               int64_t typesize, int clevel, int doshuffle, uint8_t* dest,
               int64_t destsize, std::vector<uint8_t>* scratch) {
  if (nbytes < 0 || nbytes > kMaxBufferSize || typesize <= 0 ||
      destsize < kMaxOverhead || clevel < 0 || clevel > 9 ||
      (doshuffle != 0 && doshuffle != 1) || (nbytes > 0 && !src) || !dest)
    return kErrArgs;
  if (typesize > kMaxTypesize) typesize = 1;
  const int64_t blocksize = blocksize_for(clevel, typesize, nbytes);
  const int64_t leftover = nbytes % blocksize;
  const int64_t nblocks = nbytes / blocksize + (leftover > 0 ? 1 : 0);

  uint8_t flags = kDontSplit | static_cast<uint8_t>(kZstdFormat << 5);
  if (doshuffle) flags |= kDoShuffle;
  bool memcpyed = clevel == 0 || nbytes < kMinBufferSize;
  dest[0] = kVersionFormat;
  dest[1] = kZstdVersionFormat;
  dest[3] = static_cast<uint8_t>(typesize);
  put32(dest + 4, nbytes);
  put32(dest + 8, blocksize);

  int64_t ntbytes = 0;
  if (!memcpyed) {
    const int level = zstd_level(clevel);
    const bool shuf = doshuffle && typesize > 1;
    if (shuf) scratch->resize(static_cast<size_t>(blocksize));
    ntbytes = kMaxOverhead + 4 * nblocks;
    if (ntbytes > destsize) memcpyed = true;  // no room for the starts
    for (int64_t j = 0; j < nblocks && !memcpyed; ++j) {
      put32(dest + kMaxOverhead + 4 * j, ntbytes);
      const int64_t bsize =
          (j == nblocks - 1 && leftover > 0) ? leftover : blocksize;
      const uint8_t* block = src + j * blocksize;
      if (shuf) {
        shuffle(typesize, bsize, block, scratch->data());
        block = scratch->data();
      }
      const int64_t c = compress_block(cctx, level, bsize, block, dest,
                                       ntbytes, destsize);
      if (c < 0) return c;
      if (c == 0) {  // incompressible: copy the whole buffer instead
        ntbytes = 0;
        break;
      }
      ntbytes += c;
    }
    if (ntbytes == 0) memcpyed = true;
  }
  if (memcpyed) {
    flags |= kMemcpyed;
    if (nbytes + kMaxOverhead > destsize) {
      ntbytes = 0;
    } else {
      if (nbytes > 0)
        std::memcpy(dest + kMaxOverhead, src, static_cast<size_t>(nbytes));
      ntbytes = kMaxOverhead + nbytes;
    }
  }
  dest[2] = flags;
  put32(dest + 12, ntbytes);
  return ntbytes;
}

CCtx& thread_cctx() {
  thread_local CCtx cctx(ZSTD_createCCtx());
  return cctx;
}

}  // namespace

extern "C" int64_t exaspim_blosc1_encode(const void* src, int64_t nbytes,
                                         int64_t typesize, int clevel,
                                         int doshuffle, void* dest,
                                         int64_t destsize) {
  CCtx& cctx = thread_cctx();
  if (!cctx) return kErrMemory;
  std::vector<uint8_t> scratch;
  return encode(cctx.get(), static_cast<const uint8_t*>(src), nbytes,
                typesize, clevel, doshuffle, static_cast<uint8_t*>(dest),
                destsize, &scratch);
}

// Decodes one frame into dest (destsize >= the header's nbytes); returns
// nbytes or an error code. Zstd frames (split or not, shuffled or not,
// raw-stored blocks) and memcpyed frames of any compressor decode.
extern "C" int64_t exaspim_blosc1_decode(const void* src_v, int64_t srcsize,
                                         void* dest_v, int64_t destsize) {
  const uint8_t* src = static_cast<const uint8_t*>(src_v);
  uint8_t* dest = static_cast<uint8_t*>(dest_v);
  if (!src || srcsize < kMaxOverhead) return kErrFrame;
  const uint8_t flags = src[2];
  int64_t typesize = src[3];
  const int64_t nbytes = get32(src + 4);
  const int64_t blocksize = get32(src + 8);
  const int64_t ctbytes = get32(src + 12);
  if (nbytes < 0 || ctbytes > srcsize || ctbytes < kMaxOverhead ||
      typesize == 0)
    return kErrFrame;
  if (nbytes > destsize || (nbytes > 0 && !dest)) return kErrArgs;
  if (flags & kMemcpyed) {
    if (kMaxOverhead + nbytes > ctbytes) return kErrFrame;
    if (nbytes > 0)
      std::memcpy(dest, src + kMaxOverhead, static_cast<size_t>(nbytes));
    return nbytes;
  }
  if ((flags >> 5) != kZstdFormat) return kErrCompressor;
  if (flags & kDoBitshuffle) return kErrBitshuffle;
  if (nbytes == 0) return 0;
  if (blocksize <= 0) return kErrFrame;
  const int64_t leftover = nbytes % blocksize;
  const int64_t nblocks = nbytes / blocksize + (leftover > 0 ? 1 : 0);
  if (kMaxOverhead + 4 * nblocks > ctbytes) return kErrFrame;
  const bool shuf = (flags & kDoShuffle) && typesize > 1;
  const bool dont_split = flags & kDontSplit;
  std::vector<uint8_t> tmp(static_cast<size_t>(blocksize));
  for (int64_t j = 0; j < nblocks; ++j) {
    const bool last = j == nblocks - 1 && leftover > 0;
    const int64_t bsize = last ? leftover : blocksize;
    const int64_t nsplits = (!dont_split && !last) ? typesize : 1;
    const int64_t neblock = bsize / nsplits;
    int64_t pos = get32(src + kMaxOverhead + 4 * j);
    uint8_t* out = shuf ? tmp.data() : dest + j * blocksize;
    for (int64_t k = 0; k < nsplits; ++k) {
      if (pos < 0 || pos + 4 > ctbytes) return kErrFrame;
      const int64_t cbytes = get32(src + pos);
      pos += 4;
      if (cbytes < 0 || pos + cbytes > ctbytes) return kErrFrame;
      if (cbytes == neblock) {
        std::memcpy(out + k * neblock, src + pos, static_cast<size_t>(cbytes));
      } else {
        size_t got = ZSTD_decompress(out + k * neblock,
                                     static_cast<size_t>(neblock), src + pos,
                                     static_cast<size_t>(cbytes));
        if (ZSTD_isError(got) || static_cast<int64_t>(got) != neblock)
          return kErrZstd;
      }
      pos += cbytes;
    }
    if (shuf) unshuffle(typesize, bsize, tmp.data(), dest + j * blocksize);
  }
  return nbytes;
}

// Chunked compression ratio of a C-order uint16 volume: every chunk of the
// grid (edge chunks ragged) is gathered contiguous and framed as
// exaspim_blosc1_encode frames it; the ratio is the total uncompressed over
// the total framed bytes. n_threads <= 0: one thread per core. Returns a
// negative code on failure.
extern "C" double exaspim_blosc1_chunked_cratio(
    const uint16_t* img, int64_t sz, int64_t sy, int64_t sx, int64_t cz,
    int64_t cy, int64_t cx, int clevel, int doshuffle, int n_threads) {
  if (!img || sz <= 0 || sy <= 0 || sx <= 0 || cz <= 0 || cy <= 0 || cx <= 0)
    return static_cast<double>(kErrArgs);
  struct Job {
    int64_t z, y, x;
  };
  std::vector<Job> jobs;
  for (int64_t z = 0; z < sz; z += cz)
    for (int64_t y = 0; y < sy; y += cy)
      for (int64_t x = 0; x < sx; x += cx) jobs.push_back({z, y, x});

  const unsigned hw = std::thread::hardware_concurrency();
  size_t workers = n_threads > 0 ? static_cast<size_t>(n_threads)
                                 : (hw ? hw : 4);
  workers = std::min(workers, jobs.size());

  std::atomic<size_t> next{0};
  std::atomic<int64_t> total_c{0}, total_u{0};
  std::atomic<int64_t> failed{0};
  auto worker = [&]() {
    CCtx cctx(ZSTD_createCCtx());
    if (!cctx) {
      failed.store(kErrMemory);
      return;
    }
    const size_t max_elems = static_cast<size_t>(cz * cy * cx);
    std::vector<uint16_t> chunk(max_elems);
    std::vector<uint8_t> dest(max_elems * sizeof(uint16_t) + kMaxOverhead);
    std::vector<uint8_t> scratch;
    for (;;) {
      const size_t i = next.fetch_add(1);
      if (i >= jobs.size() || failed.load()) return;
      const Job& j = jobs[i];
      const int64_t nz = std::min(cz, sz - j.z);
      const int64_t ny = std::min(cy, sy - j.y);
      const int64_t nx = std::min(cx, sx - j.x);
      uint16_t* dst = chunk.data();
      for (int64_t z = 0; z < nz; ++z) {
        const uint16_t* plane = img + (j.z + z) * sy * sx;
        for (int64_t y = 0; y < ny; ++y) {
          std::memcpy(dst, plane + (j.y + y) * sx + j.x,
                      static_cast<size_t>(nx) * sizeof(uint16_t));
          dst += nx;
        }
      }
      const int64_t nbytes = nz * ny * nx * 2;
      const int64_t c =
          encode(cctx.get(), reinterpret_cast<const uint8_t*>(chunk.data()),
                 nbytes, 2, clevel, doshuffle, dest.data(),
                 nbytes + kMaxOverhead, &scratch);
      if (c <= 0) {
        failed.store(c < 0 ? c : kErrFrame);
        return;
      }
      total_c.fetch_add(c);
      total_u.fetch_add(nbytes);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(workers);
  for (size_t t = 0; t < workers; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  if (failed.load()) return static_cast<double>(failed.load());
  return static_cast<double>(total_u.load()) /
         static_cast<double>(total_c.load());
}

extern "C" const char* exaspim_blosc1_zstd_version(void) {
  return ZSTD_versionString();
}
