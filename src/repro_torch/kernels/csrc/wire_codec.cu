// Elias–Fano wire codec (B3), CUDA C++ for sm_90a.
//
// Replaces the TPU kernels of repro/kernels/wire_codec.py: the lane
// kernels _mask_fold_kernel, _mask_unfold_kernel, _lower_pack_kernel and
// _lower_unpack_kernel (launched through _row_call) and the jnp code around
// them in ef_encode / ef_decode.  Each entry point below computes the whole
// function that repro.kernels.ops.{mask_fold, mask_unfold, ef_encode,
// ef_decode} computes, and is bit-identical to the plain version in
// repro_torch/kernels/ref.py.
//
// Packed request row (uint32 words; l, uw, lw from compression.ef_params):
//   [ upper: uw words | lower: lw words | mask: ceil(cap/32) words ]
// Slot j of a row holds key k_j under mask bit m_j.  Valid keys of a row
// are ascending.  off_j = clamp(k_j - base, 0, domain - 1); hi_j = off_j >> l
// is at most 15; valid slot j sets upper bit hi_j + j; its low part
// off_j & (2^l - 1) is packed at width l from bit j * l.
//
// Bound on this card: bytes.  Encode reads the mask byte of every slot and
// the key of every valid one and writes the row; decode reads the words it
// needs and writes 5 B per slot; fold/unfold move 1 B per column and one
// bit.  A slot costs a handful of integer operations, so the design aims at
// few instructions per byte and wide, coalesced accesses.
//
// Design.  Every kernel is a grid-stride loop of blocks resident on the
// whole card (grid = SMs x blocks an SM can hold), so any number of rows
// launches once and no grid dimension caps the rows.
//  * ef_encode: a block takes a tile of kTile = 4096 slots (128 upper
//    words, 128 l lower words and 128 mask words; a tile starts on a word
//    of every stream).  A thread loads the mask bytes of 16 slots (one
//    16-byte load) and the keys of the valid ones only.  The low parts go
//    to shared memory; each upper bit is an atomicOr into the tile's 128
//    shared upper words, which also take the 15 slots before the tile (the
//    halo: hi <= 15), so every output word is written by one block alone,
//    the same in any order.  Then a thread builds whole lower words, each
//    the OR of the <= ceil(32/l) + 1 low parts that overlap it, and every
//    word is one coalesced 4-byte store.  A tile whose mask is all zero
//    reads no keys and writes zero words.  Tiles past ceil(cap/32) words
//    write only their upper words (hi spills up to 15 bits past the last
//    slot).
//  * ef_decode: a per-row pass (one block per row) scans the zero counts of
//    the upper words with a block prefix sum until it has met the first 15
//    zeros, and records H[v] = (position of zero v+1) - v, the number of
//    keys with high part <= v; it reads no word past the 15th zero.  The
//    main pass holds a row's 15 markers in registers and takes 4,096-slot
//    tiles, 512 slots a warp: lane i stores the mask bytes of 16 slots
//    (one 16-byte store) and the keys of 4 slots at a time (four 16-byte
//    stores), so each store of a warp covers 512 contiguous bytes.  A
//    valid slot j decodes hi_j = #{v : H[v] <= j} and its low part (across
//    the word straddle); a masked slot reads nothing more.
//  * mask_fold: a thread packs 16 bool bytes (one 16-byte load) into 16
//    bits with byte arithmetic; lane pairs join two halves into a word.
//    mask_unfold: a thread expands 16 bits into 16 bytes, one 16-byte
//    store.
// The encoder and the 16-byte variants store with __stcs (evict-first):
// no kernel reads its output back, and at the exchange shapes it exceeds
// the 50 MB L2.
// Alignment: the 16-byte loads and stores need rows that start on 16
// bytes.  The wrapper checks that (a column count that is a multiple of
// 16, and 16-byte aligned pointers) and otherwise launches the scalar
// variant of the same kernel (template argument kVec = false), which
// reads and writes one element at a time.  Output word rows are never
// assumed aligned (a q4_sj row is an odd 4,980,737 words): words are
// stored one at a time, coalesced across the warp.
// Shifts by 32 are undefined in C: a low part that straddles words has a
// non-zero bit offset sh, so the shift 32 - sh is below 32; l <= 27.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // threads of every tile kernel
constexpr int kTile = 4096;             // slots of an encoder tile
constexpr int kTileWords = kTile / 32;  // upper / mask words of a tile
constexpr int kDecTile = 16 * kThreads; // slots of a decoder tile (kVec)
constexpr int kZeroThreads = 1024;      // threads of the per-row zero scan
constexpr int kZeroWords = 16;          // words a zero-scan thread reads
constexpr int kMarkers = 15;            // EF_UNIVERSE - 1
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ long long clamp_off(int key, long long base,
                                               long long domain) {
  long long off = (long long)key - base;
  off = off < 0 ? 0 : off;
  return off > domain - 1 ? domain - 1 : off;
}

// 4 bool bytes (little-endian in x) -> 4 bits, byte i -> bit i.  Each byte
// becomes 0 or 1; the multiply moves byte i's bit to bit 28 + i, and the
// sixteen partial products land on distinct bits, so nothing carries.
__device__ __forceinline__ uint32_t bits4(uint32_t x) {
  return ((__vcmpne4(x, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

__device__ __forceinline__ uint32_t bits16(uint4 v) {
  return bits4(v.x) | bits4(v.y) << 4 | bits4(v.z) << 8 | bits4(v.w) << 12;
}

// 4 bits -> 4 bool bytes: bit i moves to bit 8 i (no carries, as above).
__device__ __forceinline__ uint32_t bytes4(uint32_t nib) {
  return ((nib & 0xfu) * 0x00204081u) & 0x01010101u;
}

// The 16 mask bytes of slots [j, j + 16) of one row, zero past `cap`.
template <bool kVec>
__device__ __forceinline__ uint4 load_mask16(const uint8_t* __restrict__ m,
                                             long long j, long long cap) {
  if (kVec) {  // cap % 16 == 0 and an aligned row: all 16 or none
    return j < cap ? __ldg(reinterpret_cast<const uint4*>(m + j))
                   : make_uint4(0, 0, 0, 0);
  }
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (j + i < cap) w[i >> 2] |= (uint32_t)__ldg(m + j + i) << (8 * (i & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Walks the (row, tile) pairs of a rows x tiles grid in row-major order,
// from `start` in steps of `step`, with no division per step.  The codec
// kernels give every block tiles of every row this way: a launch's rows
// may differ widely in work (q4_sj: 8 dense rows among 64).
struct TileWalk {
  long long row, tile, dr, dt, tiles;
  __device__ TileWalk(long long start, long long step, long long tiles_)
      : row(start / tiles_), tile(start % tiles_), dr(step / tiles_),
        dt(step % tiles_), tiles(tiles_) {}
  __device__ void next() {
    row += dr;
    tile += dt;
    if (tile >= tiles) {
      tile -= tiles;
      ++row;
    }
  }
};

// ---------------------------------------------------------------------------
// ef_encode
// ---------------------------------------------------------------------------

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ef_encode_kernel(const int* __restrict__ keys,
                 const uint8_t* __restrict__ mask,
                 const long long* __restrict__ base,
                 uint32_t* __restrict__ out, long long rows, long long cap,
                 long long domain, int l, long long uw, long long lw,
                 long long row_words, long long tiles) {
  __shared__ __align__(16) uint32_t lo_s[kTile];
  __shared__ uint32_t up_s[kTileWords];
  const int t = threadIdx.x;
  const long long mw = (cap + 31) >> 5;
  const uint32_t lmask = (1u << l) - 1u;
  if (t < kTileWords) up_s[t] = 0;

  TileWalk at(blockIdx.x, gridDim.x, tiles);
  uint4 next = make_uint4(0, 0, 0, 0);
  if (at.row < rows)
    next = load_mask16<kVec>(mask + at.row * cap, at.tile * kTile + 16 * t,
                             cap);
  while (at.row < rows) {
    const long long row = at.row, tile = at.tile;
    const long long s0 = tile * kTile;          // first slot of the tile
    const long long j = s0 + 16 * t;            // this thread's 16 slots
    const uint32_t bits = bits16(next);
    // the next tile's mask bytes are in flight while this one is built
    at.next();
    if (at.row < rows)
      next = load_mask16<kVec>(mask + at.row * cap,
                               at.tile * kTile + 16 * t, cap);
    const int* k = keys + row * cap;
    const uint8_t* m = mask + row * cap;
    const long long b = __ldg(base + row);
    // the halo: slots s0 - 15 .. s0 - 1 may set bits of this tile's words
    bool halo = false;
    long long hpos = 0;
    if (t < kMarkers && s0 > 0) {
      const long long jh = s0 - kMarkers + t;
      if (jh < cap && __ldg(m + jh)) {
        hpos = (clamp_off(__ldg(k + jh), b, domain) >> l) + jh - s0;
        halo = hpos >= 0;
      }
    }
    // barrier: the previous tile's reads of lo_s are done (up_s was zeroed
    // by the thread that read each word)
    const int any = __syncthreads_or(bits != 0);
    if (halo) atomicOr(&up_s[hpos >> 5], 1u << (hpos & 31));
    if (any) {
      uint32_t lo[16];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        int kv[4] = {0, 0, 0, 0};
        if ((bits >> (4 * q)) & 0xfu) {
          if (kVec) {  // keys are read only where a mask byte is set
            const int4 v = __ldg(reinterpret_cast<const int4*>(k + j + 4 * q));
            kv[0] = v.x; kv[1] = v.y; kv[2] = v.z; kv[3] = v.w;
          } else {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              if ((bits >> (4 * q + i)) & 1u) kv[i] = __ldg(k + j + 4 * q + i);
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int s = 4 * q + i;
          lo[s] = 0;
          if ((bits >> s) & 1u) {
            const long long off = clamp_off(kv[i], b, domain);
            lo[s] = (uint32_t)off & lmask;
            const long long pos = (off >> l) + 16 * t + s;  // tile-relative
            if (pos < kTile) atomicOr(&up_s[pos >> 5], 1u << (pos & 31));
          }
        }
      }
      if (l) {
#pragma unroll
        for (int s = 0; s < 16; s += 4)
          *reinterpret_cast<uint4*>(&lo_s[16 * t + s]) =
              make_uint4(lo[s], lo[s + 1], lo[s + 2], lo[s + 3]);
      }
    }
    __syncthreads();

    uint32_t* o = out + row * row_words;
    if (t < kTileWords) {
      const long long g = tile * kTileWords + t;
      if (g < uw) __stcs(o + g, up_s[t]);
      up_s[t] = 0;
    }
    // mask words: lanes 2w and 2w + 1 hold the two halves of word w
    const uint32_t hi16 = __shfl_down_sync(kFull, bits, 1);
    if (!(t & 1)) {
      const long long g = tile * kTileWords + (t >> 1);
      if (g < mw) __stcs(o + uw + lw + g, bits | hi16 << 16);
    }
    if (l) {
      const long long w0 = tile * kTileWords * l;   // first lower word
      const int nw = kTileWords * l;
      for (int kk = t; kk < nw && w0 + kk < lw; kk += kThreads) {
        uint32_t w = 0;
        if (any) {
          const int bit0 = 32 * kk;
          for (int s = bit0 / l; s < kTile && s * l < bit0 + 32; ++s) {
            const int sh = s * l - bit0;   // -l < sh < 32
            w |= sh >= 0 ? lo_s[s] << sh : lo_s[s] >> -sh;
          }
        }
        __stcs(o + uw + w0 + kk, w);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// ef_decode
// ---------------------------------------------------------------------------

// One block per row: H[row, v] for the first 15 zeros of the upper words.
// A chunk is kZeroWords consecutive words a thread (their zero counts
// summed, then a block prefix sum), so a dense row's scan takes few
// chunks.
__global__ void __launch_bounds__(kZeroThreads)
ef_zeros_kernel(const uint32_t* __restrict__ words, int* __restrict__ H,
                long long uw, long long row_words) {
  __shared__ int warp_incl[kZeroThreads / 32];
  const long long row = blockIdx.x;
  const uint32_t* up = words + row * row_words;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // a well-formed row always has 15 zeros; a malformed one decodes hi = 0
  if (threadIdx.x < kMarkers) H[row * kMarkers + threadIdx.x] = 0x7fffffff;
  int seen = 0;  // zeros before this chunk, the same in every thread
  for (long long c0 = 0; c0 < uw; c0 += (long long)kZeroThreads * kZeroWords) {
    const long long w0 = c0 + (long long)threadIdx.x * kZeroWords;
    uint32_t x[kZeroWords];
    int z = 0;
#pragma unroll
    for (int k = 0; k < kZeroWords; ++k) {
      x[k] = w0 + k < uw ? __ldg(up + w0 + k) : kFull;
      z += 32 - __popc(x[k]);
    }
    int incl = z;
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    if (lane == 31) warp_incl[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      int s = lane < nwarps ? warp_incl[lane] : 0;
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, s, o);
        if (lane >= o) s += t;
      }
      if (lane < nwarps) warp_incl[lane] = s;
    }
    __syncthreads();
    int before = seen + (warp ? warp_incl[warp - 1] : 0) + incl - z;
#pragma unroll
    for (int k = 0; k < kZeroWords; ++k) {
      // word w0 + k holds zeros number before+1 .. before+zk (1-based)
      const int zk = 32 - __popc(x[k]);
      for (int v = before + 1; v <= before + zk && v <= kMarkers; ++v) {
        uint32_t inv = ~x[k];
        for (int r = v - 1 - before; r > 0; --r) inv &= inv - 1;
        const int pos = __ffs(inv) - 1;
        H[row * kMarkers + v - 1] = (int)((w0 + k) * 32 + pos) - (v - 1);
      }
      before += zk;
    }
    seen += warp_incl[nwarps - 1];
    __syncthreads();  // warp_incl is rewritten by the next chunk
    if (seen >= kMarkers) break;
  }
}

// The key of valid slot j of a row (hi from the markers in registers).
__device__ __forceinline__ int decode_key(const uint32_t* __restrict__ lower,
                                          const int (&h)[kMarkers],
                                          long long b, int l, uint32_t lmask,
                                          long long j) {
  int hi = 0;
#pragma unroll
  for (int v = 0; v < kMarkers; ++v) hi += h[v] <= j;
  uint32_t lo = 0;
  if (l) {
    const long long bit = j * l;
    const long long wk = bit >> 5;
    const int sh = (int)(bit & 31);
    lo = __ldg(lower + wk) >> sh;
    if (sh + l > 32) lo |= __ldg(lower + wk + 1) << (32 - sh);
    lo &= lmask;
  }
  return (int)(b + (((long long)hi << l) | lo));
}

// kVec (cap % 16 == 0, aligned rows): a warp takes 512 slots; lane i stores
// the mask bytes of slots 16 i .. 16 i + 15 (one 16-byte store) and the
// keys of slots 4 i + 128 k .. + 3 for k < 4 (four 16-byte stores), so
// every store of the warp covers 512 contiguous bytes.  Otherwise a thread
// takes 4 slots and stores them one at a time.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
ef_decode_kernel(const uint32_t* __restrict__ words,
                 const long long* __restrict__ base,
                 const int* __restrict__ H, int* __restrict__ keys,
                 uint8_t* __restrict__ mask, long long rows, long long cap,
                 int l, long long uw, long long lw, long long row_words) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const uint32_t lmask = (1u << l) - 1u;
  // a tile is kDecTile slots (kVec, 512 a warp) or 4 a thread
  const long long tile_slots = kVec ? kDecTile : 4 * kThreads;
  long long row = -1, b = 0;
  int h[kMarkers];  // the row's markers, in registers
  for (TileWalk at(blockIdx.x, gridDim.x, (cap + tile_slots - 1) / tile_slots);
       at.row < rows; at.next()) {
    if (at.row != row) {
      row = at.row;
#pragma unroll
      for (int q = 0; q < kMarkers; ++q) h[q] = __ldg(H + row * kMarkers + q);
      b = __ldg(base + row);
    }
    const uint32_t* w = words + row * row_words;
    const uint32_t* mw = w + uw + lw;
    int* krow = keys + row * cap;
    uint8_t* mrow = mask + row * cap;
    if (kVec) {
      const long long c0 = at.tile * kDecTile + 512 * (t >> 5);
      const long long jm = c0 + 16 * lane;
      if (jm < cap) {
        const uint32_t b16 = __ldg(mw + (jm >> 5)) >> (jm & 31);
        __stcs(reinterpret_cast<uint4*>(mrow + jm),
               make_uint4(bytes4(b16), bytes4(b16 >> 4), bytes4(b16 >> 8),
                          bytes4(b16 >> 12)));
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const long long j = c0 + 128 * k + 4 * lane;
        if (j >= cap) break;
        const uint32_t nib = (__ldg(mw + (j >> 5)) >> (j & 31)) & 0xfu;
        int kv[4] = {0, 0, 0, 0};
#pragma unroll
        for (int i = 0; i < 4; ++i)  // a masked slot reads nothing more
          if ((nib >> i) & 1u)
            kv[i] = decode_key(w + uw, h, b, l, lmask, j + i);
        __stcs(reinterpret_cast<int4*>(krow + j),
               make_int4(kv[0], kv[1], kv[2], kv[3]));
      }
    } else {
      const long long j = at.tile * tile_slots + 4 * t;
      if (j >= cap) continue;
      const uint32_t nib = (__ldg(mw + (j >> 5)) >> (j & 31)) & 0xfu;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (j + i < cap) {
          const bool v = (nib >> i) & 1u;
          krow[j + i] = v ? decode_key(w + uw, h, b, l, lmask, j + i) : 0;
          mrow[j + i] = v;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// mask_fold / mask_unfold
// ---------------------------------------------------------------------------

// kVec: cols % 16 == 0, aligned rows.  Item c of a row is its 16-byte chunk
// c (two chunks a word; the last one is empty when cols % 32 == 16), so the
// lanes of a pair hold the two halves of one word.  Otherwise: item c is
// word c, read byte by byte.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mask_fold_kernel(const uint8_t* __restrict__ mask, uint32_t* __restrict__ out,
                 long long rows, long long cols, long long words) {
  const long long per_row = kVec ? 2 * words : words;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint8_t* m = mask + row * cols;
    uint32_t* o = out + row * words;
    // a warp-uniform trip count: every lane takes part in the shuffle
    for (long long c0 = (long long)blockIdx.x * kThreads + (threadIdx.x & ~31);
         c0 < per_row; c0 += stride) {
      const long long c = c0 + (threadIdx.x & 31);
      if (kVec) {
        uint32_t bits = 0;
        if (c < per_row && 16 * c < cols)
          bits = bits16(__ldg(reinterpret_cast<const uint4*>(m + 16 * c)));
        const uint32_t hi16 = __shfl_down_sync(kFull, bits, 1);
        if (c < per_row && !(c & 1)) __stcs(o + (c >> 1), bits | hi16 << 16);
      } else if (c < per_row) {
        uint32_t w = 0;
        for (int b = 0; b < 32; ++b) {
          const long long col = 32 * c + b;
          if (col < cols && __ldg(m + col)) w |= 1u << b;
        }
        o[c] = w;
      }
    }
  }
}

// kVec: n % 16 == 0, aligned rows: item c of a row is its 16-byte output
// chunk c, bits 16 (c % 2) .. + 15 of word c / 2.  Otherwise: item c is
// byte c.
template <bool kVec>
__global__ void __launch_bounds__(kThreads)
mask_unfold_kernel(const uint32_t* __restrict__ words,
                   uint8_t* __restrict__ out, long long rows,
                   long long in_words, long long n) {
  const long long per_row = kVec ? n / 16 : n;
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
    const uint32_t* w = words + row * in_words;
    uint8_t* o = out + row * n;
    for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x;
         c < per_row; c += stride) {
      if (kVec) {
        const uint32_t b = __ldg(w + (c >> 1)) >> (16 * (c & 1));
        __stcs(reinterpret_cast<uint4*>(o + 16 * c),
                    make_uint4(bytes4(b), bytes4(b >> 4), bytes4(b >> 8),
                               bytes4(b >> 12)));
      } else {
        o[c] = (__ldg(w + (c >> 5)) >> (c & 31)) & 1u;
      }
    }
  }
}

// Blocks of `kernel` resident on the whole card at once.
template <typename Kernel>
long long resident_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  return (long long)sms * (per_sm > 0 ? per_sm : 1);
}

// Launch `kernel` with the blocks resident on the card, at most one for
// each of `rows` x `per_row` items of work.  flat: one dimension of blocks
// that walk the (row, item) pairs (TileWalk); else rows in y (at most
// 65,535; the kernels stride over the rest) and a row's blocks in x.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, bool flat, long long rows, long long per_row,
           void* stream, Args... args) {
  const long long resident = resident_blocks(kernel);
  dim3 grid;
  if (flat) {
    grid.x = (unsigned)(rows * per_row < resident ? rows * per_row
                                                  : resident);
  } else {
    long long gy = rows < 65535 ? rows : 65535;
    gy = gy < resident ? gy : resident;
    const long long gx = resident / gy < per_row ? resident / gy : per_row;
    grid = dim3((unsigned)(gx > 0 ? gx : 1), (unsigned)gy);
  }
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

}  // namespace

// All pointers are device pointers on the current device; each function
// launches on `stream` and returns the cudaError_t of its launches.  `vec`
// selects the 16-byte variant; the caller sets it only where the comment
// of each kernel says its rows are aligned.

// mask: (rows, cols) bool -> out: (rows, words) uint32, words = ceil(cols/32)
extern "C" int repro_mask_fold(const void* mask, void* out, long long rows,
                               long long cols, long long words, int vec,
                               void* stream) {
  if (rows == 0 || words == 0) return 0;
  const long long per_row = ceil_div(vec ? 2 * words : words, kThreads);
  const auto* m = (const uint8_t*)mask;
  auto* o = (uint32_t*)out;
  return vec ? launch(mask_fold_kernel<true>, false, rows, per_row, stream,
                      m, o, rows, cols, words)
             : launch(mask_fold_kernel<false>, false, rows, per_row, stream,
                      m, o, rows, cols, words);
}

// words: (rows, in_words) uint32 -> out: (rows, n) bool
extern "C" int repro_mask_unfold(const void* words, void* out, long long rows,
                                 long long in_words, long long n, int vec,
                                 void* stream) {
  if (rows == 0 || n == 0) return 0;
  const long long per_row = ceil_div(vec ? n / 16 : n, kThreads);
  const auto* w = (const uint32_t*)words;
  auto* o = (uint8_t*)out;
  return vec ? launch(mask_unfold_kernel<true>, false, rows, per_row, stream,
                      w, o, rows, in_words, n)
             : launch(mask_unfold_kernel<false>, false, rows, per_row, stream,
                      w, o, rows, in_words, n);
}

// keys: (rows, cap) int32, mask: (rows, cap) bool, base: (rows,) int64
// -> out: (rows, uw + lw + ceil(cap/32)) uint32
extern "C" int repro_ef_encode(const void* keys, const void* mask,
                               const void* base, void* out, long long rows,
                               long long cap, long long domain, int l,
                               long long uw, long long lw, int vec,
                               void* stream) {
  if (rows == 0) return 0;
  const long long row_words = uw + lw + ceil_div(cap, 32);
  const long long tiles = ceil_div(uw, kTileWords);
  const auto* k = (const int*)keys;
  const auto* m = (const uint8_t*)mask;
  const auto* b = (const long long*)base;
  auto* o = (uint32_t*)out;
  return vec ? launch(ef_encode_kernel<true>, true, rows, tiles, stream, k,
                      m, b, o, rows, cap, domain, l, uw, lw, row_words, tiles)
             : launch(ef_encode_kernel<false>, true, rows, tiles, stream, k,
                      m, b, o, rows, cap, domain, l, uw, lw, row_words, tiles);
}

// The first pass of ef_decode alone: words (rows, row_words) uint32 ->
// markers (rows, 15) int32, H[v] = the number of keys with hi <= v.
extern "C" int repro_ef_zeros(const void* words, void* markers,
                              long long rows, long long uw,
                              long long row_words, void* stream) {
  if (rows == 0) return 0;
  ef_zeros_kernel<<<(unsigned)rows, kZeroThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, (int*)markers, uw, row_words);
  return (int)cudaGetLastError();
}

// words: (rows, row_words) uint32, base: (rows,) int64, scratch: (rows, 15)
// int32 -> keys: (rows, cap) int32, mask: (rows, cap) bool
extern "C" int repro_ef_decode(const void* words, const void* base,
                               void* scratch, void* keys, void* mask,
                               long long rows, long long cap, int l,
                               long long uw, long long lw, long long row_words,
                               int vec, void* stream) {
  if (rows == 0) return 0;
  const int err = repro_ef_zeros(words, scratch, rows, uw, row_words, stream);
  if (err) return err;
  const long long tiles = ceil_div(cap, kDecTile);
  const auto* w = (const uint32_t*)words;
  const auto* b = (const long long*)base;
  const auto* H = (const int*)scratch;
  auto* k = (int*)keys;
  auto* m = (uint8_t*)mask;
  return vec ? launch(ef_decode_kernel<true>, true, rows, tiles, stream, w,
                      b, H, k, m, rows, cap, l, uw, lw, row_words)
             : launch(ef_decode_kernel<false>, true, rows, tiles, stream, w,
                      b, H, k, m, rows, cap, l, uw, lw, row_words);
}
