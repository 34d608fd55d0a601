// Predicate-on-packed scan (B1), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel repro/kernels/scan_filter.py:scan_filter_pallas
// (body _kernel / _group_scan).  Codes are bit-packed at `width` bits
// (1..30) into 32-bit words; 32 consecutive rows occupy exactly `width`
// words from a word boundary.  For each group of 32 rows the kernel tests
// lo <= code <= hi (optionally negated) and writes one validity word;
// rows >= `rows` are never valid.
//
// Bound on this card: bytes.  Per row it reads width/32 of a word and
// writes one bit, and does a handful of integer operations, so the least
// time is (packed words + bitset words) * 4 B over the memory rate.
//
// Design: one warp per 32-row group.  Lane j extracts code j from the
// group's `width` words (a straddling code ORs in the next word), tests
// it, and __ballot_sync assembles the 32 outcomes into the output word, so
// no lane loops over j and a warp's reads fall in one contiguous
// width*4-byte window.  `width` is a runtime argument, not a template
// parameter: one instantiation covers every width.  The node index is
// grid dimension y, so one launch covers all nodes of the node-stacked
// cluster.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__global__ void scan_filter_kernel(const uint32_t* __restrict__ words,
                                   uint32_t* __restrict__ out,
                                   long long groups, long long rows,
                                   int width, int lo, int hi, int negate) {
  const long long g =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (g >= groups) return;  // g is uniform across the warp: all lanes leave
  const int lane = threadIdx.x & 31;
  const long long node = blockIdx.y;
  const uint32_t* w = words + (node * groups + g) * width;
  const int bit = lane * width;
  const int wi = bit >> 5;
  const int off = bit & 31;
  uint32_t v = __ldg(w + wi) >> off;
  // off + width > 32 implies off > 0, so the shift below is < 32
  if (off + width > 32) v |= __ldg(w + wi + 1) << (32 - off);
  const int code = (int)(v & ((1u << width) - 1u));
  bool ok = code >= lo && code <= hi;
  if (negate) ok = !ok;
  ok = ok && (g * 32 + lane < rows);
  const uint32_t bits = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) out[node * groups + g] = bits;
}

}  // namespace

// words: (nodes, groups * width) uint32; out: (nodes, groups) uint32.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int repro_scan_filter(const void* words, void* out, int nodes,
                                 long long groups, long long rows, int width,
                                 int lo, int hi, int negate, void* stream) {
  if (nodes == 0 || groups == 0) return 0;
  const dim3 grid(
      (unsigned)((groups + kWarpsPerBlock - 1) / kWarpsPerBlock),
      (unsigned)nodes);
  scan_filter_kernel<<<grid, kWarpsPerBlock * 32, 0,
                       (cudaStream_t)stream>>>(
      (const uint32_t*)words, (uint32_t*)out, groups, rows, width, lo, hi,
      negate);
  return (int)cudaGetLastError();
}
