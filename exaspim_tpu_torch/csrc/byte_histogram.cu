// 256-bin byte histograms for the entropy proxy, in two entries that share
// the histogram core of byte_histogram.cuh:
//
//   byte_histogram_rows:   (rows, len) uint8 -> f32 (rows, 256),
//                          counts[r, v] = #{i : data[r, i] == v};
//   byte_histogram_chunks: (B, Z, Y, X) int32 counts -> f32 (B, nc, 2, 256),
//                          the lo and hi byte histograms of the z-delta of
//                          every c^3 chunk, taken from the volume itself.
//
// Replaces exaspim_tpu/compression/proxy.py:58 _histogram_pallas_call (its
// pl.pallas_call at :92). The TPU kernel avoids scatter by comparing each
// VMEM tile against a 256-bin iota; in the JAX package the chunk walk, the
// z-delta and the byte split (proxy.py:35-49, :144-168) are XLA fusions
// around it. On Hopper the second entry does all of it in one pass: the
// reference's chunk grid (trailing partial chunks dropped; the wrapper
// shrinks the chunk to fit), the z-delta with the uint16 wrap ((v[z] -
// v[z-1]) & 0xFFFF, the chunk's first plane kept as is) in registers, and
// both byte planes counted at once, so the volume is read once and no plane
// is ever written.
//
// Layout of a launch: one thread-block cluster per row (or chunk), rows
// along grid.x (no 65,535-row limit), 1 to 8 blocks a cluster (a row: one
// per 128 KB; a chunk: about two blocks per SM over the launch). Each
// block counts its share in shared memory (byte_histogram.cuh: the row
// entry's counters take any bytes in the same time, the chunk entry's are
// the fastest on z-delta planes), the cluster sums its blocks' totals
// through distributed shared memory in rank order and writes f32 counts.
// A row's share is its 16-byte-aligned body, as uint4 loads split over the
// blocks; the unaligned head and tail (at most 15 bytes each, any base
// pointer and any length) are counted byte by byte by block 0. A chunk's
// share is a run of its z planes; each thread walks z down (y, x) columns,
// four x at a time (int4) where the chunk's rows are 16-byte aligned, one
// at a time elsewhere (odd extents, a misaligned base).
//
// What bounds it on an H100: bytes. The validation batch's 64 planes of
// 64^3 are 16.8 MB (5.0 us at 3.35 TB/s); the same batch as int32 counts
// through the chunk entry 33.5 MB (10.0 us). The counting is 3 issued
// instructions a byte (byte extract, address, shared atomic), below that.

#include <algorithm>

#include "byte_histogram.cuh"
#include "smem_attr.cuh"

namespace {

using namespace bhist;

// Per-thread loads kept in flight before counting.
constexpr int UNROLL = 8;
// A row's share of a block: 128 KB (two blocks a 64^3 plane). Smaller
// shares pay the counters' zeroing, totals and cluster barriers more often.
constexpr long long ROW_SHARE = 128 * 1024;
// The counters of each entry (byte_histogram.cuh): rows take any bytes,
// chunks only z-delta planes.
constexpr Counters ROW_COUNTERS = LANES;
constexpr Counters CHUNK_COUNTERS = WARP_COPIES;

template <int S>
__device__ __forceinline__ void add_vec(uint32_t* h, const uint4& w) {
  add_word<S>(h, w.x);
  add_word<S>(h, w.y);
  add_word<S>(h, w.z);
  add_word<S>(h, w.w);
}

template <int S>
__global__ void __launch_bounds__(THREADS)
    byte_histogram_rows_kernel(const uint8_t* data, long long len,
                               float* out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* h = smem;
  uint32_t* part = smem + counter_words(S);
  cg::cluster_group cluster = cg::this_cluster();
  const long long cs = cluster.num_blocks();
  const long long r = cluster.block_rank();
  const long long row = blockIdx.x / cs;
  zero<S>(h);
  __syncthreads();

  const uint8_t* p = data + row * len;
  long long head = (long long)((16 - ((uintptr_t)p & 15)) & 15);
  if (head > len) head = len;
  const long long nvec = (len - head) / 16;
  const long long tail = head + nvec * 16;
  const uint4* v = reinterpret_cast<const uint4*>(p + head);
  const long long v1 = nvec * (r + 1) / cs;
  long long i = nvec * r / cs + threadIdx.x;
  for (; i + (UNROLL - 1) * THREADS < v1; i += UNROLL * THREADS) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) w[u] = __ldg(v + i + u * THREADS);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) add_vec<S>(h, w[u]);
  }
  for (; i < v1; i += THREADS) add_vec<S>(h, __ldg(v + i));
  if (r == 0) {
    for (long long j = threadIdx.x; j < head; j += THREADS) add<S>(h, p[j]);
    for (long long j = tail + threadIdx.x; j < len; j += THREADS)
      add<S>(h, p[j]);
  }
  __syncthreads();
  part[threadIdx.x] = bin_total<S>(h, threadIdx.x);
  cluster_write<1>(part, out + row * 256);
}

// V voxels of one chunk row, loaded together (V = 4: one int4).
template <int V>
struct Voxels {
  int v[V];
};

template <int V>
__device__ __forceinline__ Voxels<V> load(const int* p) {
  Voxels<V> r;
  if (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    r.v[0] = q.x;
    r.v[1] = q.y;
    r.v[2] = q.z;
    r.v[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r.v[k] = __ldg(p + k);
  }
  return r;
}

// The z-delta of V voxels against the plane above, wrapped to uint16, into
// the lo and hi histograms.
template <int S, int V>
__device__ __forceinline__ void add_delta(uint32_t* lo, uint32_t* hi,
                                          const Voxels<V>& cur,
                                          const Voxels<V>& prev) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const uint32_t d = ((uint32_t)cur.v[k] - (uint32_t)prev.v[k]) & 0xFFFFu;
    add<S>(lo, d & 0xFFu);
    add<S>(hi, d >> 8);
  }
}

template <int S, int V>
__global__ void __launch_bounds__(THREADS)
    byte_histogram_chunks_kernel(const int* vols, int Z, int Y, int X, int c,
                                 int nz, int ny, int nx, float* out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* lo = smem;
  uint32_t* hi = smem + counter_words(S);
  uint32_t* part = hi + counter_words(S);
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int r = (int)cluster.block_rank();
  const long long chunk = blockIdx.x / cs;
  zero<S>(lo);
  zero<S>(hi);
  __syncthreads();

  long long t = chunk;
  const int ix = (int)(t % nx);
  t /= nx;
  const int iy = (int)(t % ny);
  t /= ny;
  const int iz = (int)(t % nz);
  const long long b = t / nz;
  const long long plane = (long long)Y * X;
  const int* base = vols + (b * Z + (long long)iz * c) * plane +
                    (long long)iy * c * X + (long long)ix * c;
  const int z0 = c * r / cs, z1 = c * (r + 1) / cs;
  const int per_row = c / V;
  for (int q = threadIdx.x; q < c * per_row; q += THREADS) {
    const int y = q / per_row;
    const int* col = base + (long long)y * X + (q - y * per_row) * V;
    Voxels<V> prev = {};  // the chunk's first plane is kept as is
    if (z0 > 0) prev = load<V>(col + (z0 - 1) * plane);
    int z = z0;
    for (; z + UNROLL <= z1; z += UNROLL) {
      Voxels<V> w[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) w[u] = load<V>(col + (z + u) * plane);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        add_delta<S, V>(lo, hi, w[u], prev);
        prev = w[u];
      }
    }
    for (; z < z1; ++z) {
      const Voxels<V> w = load<V>(col + z * plane);
      add_delta<S, V>(lo, hi, w, prev);
      prev = w;
    }
  }
  __syncthreads();
  part[threadIdx.x] = bin_total<S>(lo, threadIdx.x);
  part[256 + threadIdx.x] = bin_total<S>(hi, threadIdx.x);
  cluster_write<2>(part, out + chunk * 512);
}

cudaError_t rows(const uint8_t* data, long long n, long long len, float* out,
                 cudaStream_t s) {
  const int cs = pow2_at_most((len + ROW_SHARE - 1) / ROW_SHARE);
  constexpr size_t smem = smem_bytes(ROW_COUNTERS, 1);
  static unsigned long long done = 0;
  const cudaError_t ok =
      allow_smem(byte_histogram_rows_kernel<ROW_COUNTERS>, smem, done);
  if (ok != cudaSuccess) return ok;
  return launch(byte_histogram_rows_kernel<ROW_COUNTERS>, n * cs, cs, smem, s,
                data, len, out);
}

// A chunk's cluster: about two blocks per SM over the launch (a validation
// batch's 32 chunks of 64^3 take 8 blocks each, the 256^3 pair's 128 take
// 2), at most one block per z plane.
template <int V>
cudaError_t chunks(const int* vols, long long b, int Z, int Y, int X, int c,
                   float* out, cudaStream_t s) {
  const long long n = b * (Z / c) * (Y / c) * (X / c);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int cs = pow2_at_most(std::min<long long>(2LL * sms / n, c));
  constexpr size_t smem = smem_bytes(CHUNK_COUNTERS, 2);
  static unsigned long long done = 0;  // per instance V
  e = allow_smem(byte_histogram_chunks_kernel<CHUNK_COUNTERS, V>, smem, done);
  if (e != cudaSuccess) return e;
  return launch(byte_histogram_chunks_kernel<CHUNK_COUNTERS, V>, n * cs, cs,
                smem, s, vols, Z, Y, X, c, Z / c, Y / c, X / c, out);
}

}  // namespace

// C entry points, bound with ctypes by exaspim_tpu_torch/compression/
// proxy.py, which allocates ``out`` and checks shapes and types. Each makes
// one launch on ``stream``, does not synchronise, and returns the
// cudaError_t of the launch. Rows count into lane columns, chunks into
// per-warp copies (byte_histogram.cuh).
//
// data: (rows, len) uint8, contiguous, any alignment; out: (rows, 256) f32.
extern "C" int byte_histogram_rows(const void* data, long long n,
                                   long long len, void* out, void* stream) {
  if (n <= 0 || n * MAX_CLUSTER > 0x7FFFFFFFLL || len < 0)
    return (int)cudaErrorInvalidValue;
  return (int)rows(static_cast<const uint8_t*>(data), n, len,
                   static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

// vols: (b, Z, Y, X) int32, contiguous; chunk: the edge, already shrunk to
// at most min(Z, Y, X); out: (b, (Z/c)(Y/c)(X/c), 2, 256) f32, the chunks
// in (z, y, x) order, lo histogram before hi.
extern "C" int byte_histogram_chunks(const void* vols, long long b, int Z,
                                     int Y, int X, int chunk, void* out,
                                     void* stream) {
  if (b <= 0 || chunk <= 0 || chunk > Z || chunk > Y || chunk > X)
    return (int)cudaErrorInvalidValue;
  const long long blocks = b * (long long)(Z / chunk) * (Y / chunk) *
                           (X / chunk) * MAX_CLUSTER;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const int* v = static_cast<const int*>(vols);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = chunk % 4 == 0 && X % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(vols) % 16 == 0;
  return (int)(vec ? chunks<4>(v, b, Z, Y, X, chunk, o, s)
                   : chunks<1>(v, b, Z, Y, X, chunk, o, s));
}
