// Masked per-slot multi-aggregate int64 sums, in one pass over the rows.
//
// Replaces ballista_tpu/ops/pallas_agg.py:fused_masked_sums (the Pallas
// kernel `_fused_limb_sums`): out[t, a] = sum of contribution a of row i
// over the rows i with row_slot[i] == t. Rows whose slot lies outside
// [0, T) add nothing; the aggregate planner gives dead rows slot == T.
//
// A contribution row is described, not materialised: a data column (int64
// or int32, or none for a row of ones) and a validity column (one byte per
// row, or none), whose product is formed in registers. The matrix entry
// `masked_slot_sums` describes row a of an int64[A, n] matrix as a data
// column without validity; `masked_slot_sums_rows` takes the descriptors
// from its caller, and lets a count over a validity column ride the sum
// that reads the same column. Both run the same two kernels.
//
// Exactness: sums are unsigned 64-bit adds, which wrap mod 2^64. Two's
// complement makes that exact for signed int64 sums whose total fits. A
// decimal sum that may pass int64 (a "wide" sum) is described twice over
// its one column, in the half-word read modes: HI adds v >> 32 (signed),
// LO adds v & (2^32 - 1). Each half's sum over fewer than 2^31 rows fits
// int64, and the caller joins them, (sum HI) * 2^32 + (sum LO), exactly.
//
// Bound: bytes. A live row needs its 4-byte slot and, per column, its data
// element and validity byte; a dead row needs its slot only. On an H100
// (3.35 TB/s) a dense call over n rows of A int64 columns is bound by
// (4 + 8 A) n bytes, a sparse call by 4 n bytes plus the 32-byte sectors
// that hold live rows. The outputs are tiny and never the limit. The
// card's 64 integer lanes per multiprocessor are the second limit: twelve
// compare-and-add pairs per value cost more than the value's load.
//
// Design (`slot_sums_tiles<TR, HALVES>`): no atomic operation in the row
// loop. A launch without half-word rows takes the HALVES = false instance,
// in which every read is WHOLE at compile time. A block walks tiles of
// TILE rows. A tile's slots are copied once into shared memory with
// 16-byte asynchronous copies, one tile ahead of the tile being summed
// (two buffers, one barrier per tile). Each warp owns one described
// column (and, where there are fewer columns than 8, one of S interleaved
// shares of the tile's rows): a lane takes two neighbouring
// rows at a time, so an int64 column is read with 16-byte loads, four of
// them in flight per lane, through the streaming path (`__ldcs`) so that
// the columns do not evict the slots. Dead rows stay free: a lane first
// marks which of its pairs hold a live row, loads only those, and takes its
// next four live pairs per round whichever chunks they lie in, so a sparse
// tile costs one round of loads and a dead one none; a tile in which every
// pair is live is walked chunk by chunk with the warp's loads side by side.
// Where the accumulators live depends on T:
//   T <= 4, `TR == T`: in registers, by an unrolled compare-and-add against
//     every t (registers cannot be indexed at run time, hence the template).
//     Measured on the card, above T = 4 this costs more integer
//     instructions than the card has lanes for beside the loads.
//   T > 4, `TR == 0`: in shared memory, one column of T cells for every
//     lane of every warp (cell t of lane l at [32 t + l]: no bank conflict,
//     no other lane ever touches it), so a value costs one load, add and
//     store whatever T is. Taken whenever warps x T x 32 cells (twice that
//     with fused counts) fit the shared memory the device grants a block
//     on request, 227 KB on an H100: T = 64 fits with 8 warps.
// Slots below 0 or at T and above match no accumulator. At the end of the
// block's rows every accumulator is summed over the warp by 64-bit
// shuffles, lane 0 adds it into the block's shared output cells, and one
// global atomic add per non-zero cell follows.
// Alignment: lane pairs are laid over the rows so that every 16-byte load
// is aligned for its column (a column that starts on an odd 8-byte address
// pairs rows (2p - 1, 2p)); the first and the last tile, which hold the
// rows without a partner and the rows past n, take scalar loads. The slot
// copies start at the 16-byte boundary below the tile.
//
// What fits neither (`slot_sums_matched`, T in the hundreds or thousands):
// accumulators in shared memory, one private copy of the output cells per
// warp whenever 8 copies fit, else one per block. A lane takes one row; the
// lanes of a warp that hold the same slot find each other with
// `__match_any_sync`, sum their values with the hardware warp reduction
// (three limbs of at most 27 bits, so no carry is lost) and their leader
// alone adds the total: a plain add into the warp's private copy, a
// shared-memory atomic add into a block-wide one.
//
// The output is zeroed by a memset on the launch's stream inside the entry
// points (a call's first launch zeroes all of it), so a call is one memset
// node and one kernel per launch and the caller allocates with torch.empty.

#include <cstdint>
#include <map>
#include <utility>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_ROWS = 16;        // described rows per launch
constexpr int REGISTER_T = 4;       // most slots summed in registers
constexpr int TILE = 2048;          // rows per tile
constexpr int CHUNK = 64;           // rows a warp takes per load: 32 pairs
constexpr int CHUNKS = TILE / CHUNK;
constexpr int UNROLL = 4;           // loads in flight per lane
constexpr int SLOT_BUF = TILE + 4;  // a tile, the row before it, alignment
constexpr int STAGES = 2;           // slot buffers: one tile ahead
constexpr unsigned FULL = 0xffffffffu;
constexpr int SHARED_BLOCK = 256;   // threads of a slot_sums_matched block
constexpr int SHARED_UNROLL = 4;

typedef unsigned long long u64;

// What one launch sums: up to MAX_ROWS described rows. Row a adds
// data * valid into output sum_cell[a] and, where count_cell[a] >= 0, valid
// itself into output count_cell[a] (a sum and the count over the same
// validity column read it once). Outputs are numbered 0 .. outputs - 1
// within the launch; out_col gives each one's column of `out`.
struct Rows {
  const void* data[MAX_ROWS];            // null: every contribution is 1
  const unsigned char* valid[MAX_ROWS];  // null: every row is valid
  int width[MAX_ROWS];                   // bytes per data element: 8, 4 or 0
  int half[MAX_ROWS];                    // WHOLE, HI or LO of each value
  int sum_cell[MAX_ROWS];
  int count_cell[MAX_ROWS];
  int out_col[2 * MAX_ROWS];
  int outputs;
};

// the part of a value a row adds: all of it, or one half of its 64 bits
enum Half { WHOLE = 0, HI = 1, LO = 2 };
__device__ __forceinline__ long long half_of(long long v, int half) {
  return half == WHOLE ? v : half == HI ? (v >> 32) : (v & 0xffffffffLL);
}

// contribution of one row, scalar loads; `ok` is the row's validity
__device__ __forceinline__ long long contribution(const void* data, int width,
                                                  int half,
                                                  const unsigned char* valid,
                                                  int64_t i, int& ok) {
  long long v = 1;
  if (width == 8) {
    v = half_of(__ldcs(static_cast<const long long*>(data) + i), half);
  } else if (width == 4) {
    v = half_of(__ldcs(static_cast<const int*>(data) + i), half);
  }
  ok = valid == nullptr || __ldcs(valid + i) != 0;
  return ok ? v : 0;
}

template <int T>
__device__ __forceinline__ void accumulate(u64 (&acc)[T], u64 (&cnt)[T],
                                           int s, long long v, int ok) {
#pragma unroll
  for (int t = 0; t < T; ++t) {
    if (s == t) {
      acc[t] += static_cast<u64>(v);
      cnt[t] += ok;
    }
  }
}

// Copies the slots of rows [wb, wb + SLOT_BUF) into `buf`; rows outside
// [0, n) become -1. row_slot + wb is 16-byte aligned by construction.
__device__ __forceinline__ void stage_slots(
    int32_t* buf, const int32_t* __restrict__ row_slot, int64_t wb,
    int64_t n) {
  for (int j = threadIdx.x; j < SLOT_BUF / 4; j += blockDim.x) {
    const int64_t e = wb + 4 * j;
    if (e >= 0 && e + 3 < n) {
      __pipeline_memcpy_async(buf + 4 * j, row_slot + e, 16);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int64_t r = e + q;
        buf[4 * j + q] = (r >= 0 && r < n) ? row_slot[r] : -1;
      }
    }
  }
  __pipeline_commit();
}

// TR > 0: T == TR accumulators in registers. TR == 0: T at run time, the
// accumulators in shared memory, a column of T for every lane.
// HALVES: a launch with half-word rows; without, the read mode is WHOLE
// at compile time and the instance is the plain one
template <int TR, bool HALVES>
__global__ void slot_sums_tiles(const int32_t* __restrict__ row_slot,
                                const Rows rows, int64_t n, int T, int A,
                                int S, int fused, int ldo,
                                u64* __restrict__ out) {
  __shared__ __align__(16) int32_t slots[STAGES][SLOT_BUF];
  __shared__ u64 static_cells[TR * 2 * MAX_ROWS + 1];
  extern __shared__ u64 dynamic[];  // TR == 0: lane columns, then cells

  if (TR > 0) T = TR;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int a = warp / S;      // this warp's aggregate
  const int share = warp % S;  // and its share of each tile's chunks
  // a warp's lane columns: T sums and, in a launch with fused counts, T
  // counts, 32 lanes wide
  const int depth = fused ? 2 * T : T;
  u64* cells = TR > 0 ? static_cells
                      : dynamic + (blockDim.x >> 5) * depth * 32;
  for (int c = threadIdx.x; c < T * rows.outputs; c += blockDim.x) {
    cells[c] = 0ULL;
  }
  const bool counts = rows.count_cell[a] >= 0;

  u64 acc[TR > 0 ? TR : 1];
  u64 cnt[TR > 0 ? TR : 1];
  u64* column = dynamic + warp * depth * 32 + lane;  // sum t at column[32 t]
  if (TR > 0) {
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      acc[t] = 0ULL;
      cnt[t] = 0ULL;
    }
  } else {
    for (int t = 0; t < depth; ++t) column[32 * t] = 0ULL;
  }
  // adds value v of a row with slot s, and its validity where that counts
  auto add = [&](int s, long long v, int ok) {
    if (TR > 0) {
      accumulate<(TR > 0 ? TR : 1)>(acc, cnt, s, v, ok);
    } else if (static_cast<unsigned>(s) < static_cast<unsigned>(T)) {
      column[32 * s] += static_cast<u64>(v);
      if (counts) column[32 * (T + s)] += static_cast<u64>(ok);
    }
  };

  const void* data = rows.data[a];
  const unsigned char* valid = rows.valid[a];
  const int width = rows.width[a];
  const int half = HALVES ? rows.half[a] : WHOLE;
  // rows are taken in pairs (2p - odd, 2p - odd + 1), aligned for `data`
  const int odd = width == 8 ? (reinterpret_cast<uintptr_t>(data) >> 3) & 1
                : width == 4 ? (reinterpret_cast<uintptr_t>(data) >> 2) & 1
                             : 0;
  const bool valid_pairs =
      valid != nullptr && (reinterpret_cast<uintptr_t>(valid) & 1) == odd;
  // the slot window of a tile starts `back` rows before the tile, at the
  // 16-byte boundary at or below the row before the tile
  const int back =
      1 + ((((reinterpret_cast<uintptr_t>(row_slot) >> 2) & 3) + 3) & 3);

  const int64_t tiles = (n / 2 + 1 + TILE / 2 - 1) / (TILE / 2);
  // Tile k of this block lives in buffer k % STAGES. Every iteration
  // commits one copy group (an empty one past the last tile), so waiting
  // for all but the newest STAGES - 2 groups means tile k has landed; the
  // barrier that publishes it also says that tile k - 1, whose buffer the
  // new copies overwrite, has been summed by every warp.
  int64_t tile = blockIdx.x;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    const int64_t ahead = tile + static_cast<int64_t>(k) * gridDim.x;
    if (ahead < tiles) {
      stage_slots(slots[k], row_slot, ahead * TILE - back, n);
    } else {
      __pipeline_commit();
    }
  }
  for (int p = 0; tile < tiles; tile += gridDim.x, p = (p + 1) % STAGES) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();
    const int64_t ahead = tile + static_cast<int64_t>(STAGES - 1) * gridDim.x;
    if (ahead < tiles) {
      stage_slots(slots[(p + STAGES - 1) % STAGES], row_slot,
                  ahead * TILE - back, n);
    } else {
      __pipeline_commit();
    }
    const int32_t* buf = slots[p];
    const int64_t r0 = tile * TILE;
    // buf[j] is the slot of row r0 - back + j; this lane's first row of
    // chunk c is r0 + c * CHUNK + 2 * lane - odd
    const int lane_off = back + 2 * lane - odd;
    const bool interior = r0 > 0 && r0 + TILE < n;
    if (interior) {
      // bit j of `todo`: this lane's pair in the warp's j-th chunk of the
      // tile holds a live row. A round takes UNROLL pairs per lane: in a
      // dense tile chunk after chunk, else each lane's next live pairs,
      // so that a sparse tile costs one round of loads.
      unsigned todo = 0u, all_chunks = 0u;
      for (int j = 0, c = share; c < CHUNKS; ++j, c += S) {
        all_chunks |= 1u << j;
        const int s0 = buf[c * CHUNK + lane_off];
        const int s1 = buf[c * CHUNK + lane_off + 1];
        if (static_cast<unsigned>(s0) < static_cast<unsigned>(T) ||
            static_cast<unsigned>(s1) < static_cast<unsigned>(T)) {
          todo |= 1u << j;
        }
      }
      // one round: the pairs at tile offsets at[u], where need[u]
      auto round = [&](const int (&at)[UNROLL], const bool (&need)[UNROLL]) {
        long long x[UNROLL], y[UNROLL];
        int okx[UNROLL], oky[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          okx[u] = 1;
          oky[u] = 1;
        }
        if (width == 8) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            x[u] = 0;
            y[u] = 0;
            if (need[u]) {
              const longlong2 v = __ldcs(reinterpret_cast<const longlong2*>(
                  static_cast<const long long*>(data) + r0 + at[u]));
              x[u] = v.x;
              y[u] = v.y;
            }
          }
        } else if (width == 4) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            x[u] = 0;
            y[u] = 0;
            if (need[u]) {
              const int2 v = __ldcs(reinterpret_cast<const int2*>(
                  static_cast<const int*>(data) + r0 + at[u]));
              x[u] = v.x;
              y[u] = v.y;
            }
          }
        } else {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            x[u] = 1;
            y[u] = 1;
          }
        }
        if (half != WHOLE) {
          // a wide sum's half: one warp-uniform branch per round
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            x[u] = half_of(x[u], half);
            y[u] = half_of(y[u], half);
          }
        }
        if (valid_pairs) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (need[u]) {
              const unsigned short v = __ldcs(
                  reinterpret_cast<const unsigned short*>(valid + r0 + at[u]));
              okx[u] = (v & 0x00ffu) != 0;
              oky[u] = (v & 0xff00u) != 0;
            }
          }
        } else if (valid != nullptr) {
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            if (need[u]) {
              const unsigned char v0 = __ldcs(valid + r0 + at[u]);
              const unsigned char v1 = __ldcs(valid + r0 + at[u] + 1);
              okx[u] = v0 != 0;
              oky[u] = v1 != 0;
            }
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (need[u]) {
            add(buf[back + at[u]], okx[u] ? x[u] : 0, okx[u]);
            add(buf[back + at[u] + 1], oky[u] ? y[u] : 0, oky[u]);
          }
        }
      };
      if (__all_sync(FULL, todo == all_chunks)) {
        // every lane needs every chunk: in step, chunk after chunk
        for (int c = share; c < CHUNKS; c += UNROLL * S) {
          int at[UNROLL];
          bool need[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            need[u] = c + u * S < CHUNKS;
            at[u] = (c + u * S) * CHUNK + 2 * lane - odd;
          }
          round(at, need);
        }
      } else {
        while (__any_sync(FULL, todo != 0u)) {
          int at[UNROLL];
          bool need[UNROLL];
#pragma unroll
          for (int u = 0; u < UNROLL; ++u) {
            need[u] = todo != 0u;
            at[u] = (share + (__ffs(todo) - 1) * S) * CHUNK + 2 * lane - odd;
            todo &= todo - 1u;
          }
          round(at, need);
        }
      }
    } else {
      // first and last tile: rows before 0 and past n - 1 are staged dead
      for (int c = share; c < CHUNKS; c += S) {
        const int s0 = buf[c * CHUNK + lane_off];
        const int s1 = buf[c * CHUNK + lane_off + 1];
        const int64_t i0 = r0 + c * CHUNK + 2 * lane - odd;
        int ok = 0;
        if (static_cast<unsigned>(s0) < static_cast<unsigned>(T)) {
          const long long v =
              contribution(data, width, half, valid, i0, ok);
          add(s0, v, ok);
        }
        if (static_cast<unsigned>(s1) < static_cast<unsigned>(T)) {
          const long long v =
              contribution(data, width, half, valid, i0 + 1, ok);
          add(s1, v, ok);
        }
      }
    }
  }

  __syncthreads();  // cells are zeroed
  auto fold = [&](int cell, int t, u64 v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    if (lane == 0 && v != 0ULL) atomicAdd(&cells[t * rows.outputs + cell], v);
  };
  if (TR > 0) {
#pragma unroll
    for (int t = 0; t < TR; ++t) {
      fold(rows.sum_cell[a], t, acc[t]);
      if (counts) fold(rows.count_cell[a], t, cnt[t]);
    }
  } else {
    for (int t = 0; t < T; ++t) {
      fold(rows.sum_cell[a], t, column[32 * t]);
      if (counts) fold(rows.count_cell[a], t, column[32 * (T + t)]);
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < T * rows.outputs; c += blockDim.x) {
    const u64 v = cells[c];
    if (v != 0ULL) {
      atomicAdd(out + (c / rows.outputs) * ldo + rows.out_col[c % rows.outputs],
                v);
    }
  }
}

__global__ void slot_sums_matched(const int32_t* __restrict__ row_slot,
                                  const Rows rows, int64_t n, int T, int A,
                                  int privatised, int ldo,
                                  u64* __restrict__ out) {
  extern __shared__ u64 shared_cells[];
  const int cells = T * rows.outputs;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int copies = privatised ? warps : 1;
  for (int c = threadIdx.x; c < copies * cells; c += blockDim.x) {
    shared_cells[c] = 0ULL;
  }
  __syncthreads();
  u64* mine = shared_cells + (privatised ? warp * cells : 0);

  const int64_t step = static_cast<int64_t>(gridDim.x) * warps * 32 *
                       SHARED_UNROLL;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * warps + warp) * 32 *
                      SHARED_UNROLL;
       base < n; base += step) {
    int s[SHARED_UNROLL];
#pragma unroll
    for (int u = 0; u < SHARED_UNROLL; ++u) {
      const int64_t i = base + u * 32 + lane;
      s[u] = i < n ? __ldcs(row_slot + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < SHARED_UNROLL; ++u) {
      const bool live = static_cast<unsigned>(s[u]) < static_cast<unsigned>(T);
      const unsigned live_mask = __ballot_sync(FULL, live);
      if (live_mask == 0u) continue;
      if (live) {
        const int64_t i = base + u * 32 + lane;
        const unsigned peers = __match_any_sync(live_mask, s[u]);
        const bool leader = lane == __ffs(peers) - 1;
        u64* cell = mine + s[u] * rows.outputs;
        // the peers' sum of v, added to `where` by their leader
        auto add = [&](u64* where, u64 v) {
          // limbs of 27, 27 and 10 bits: 32 of them sum below 2^32
          const unsigned l0 = __reduce_add_sync(
              peers, static_cast<unsigned>(v & 0x7ffffffULL));
          const unsigned l1 = __reduce_add_sync(
              peers, static_cast<unsigned>((v >> 27) & 0x7ffffffULL));
          const unsigned l2 =
              __reduce_add_sync(peers, static_cast<unsigned>(v >> 54));
          const u64 total = static_cast<u64>(l0) +
                            (static_cast<u64>(l1) << 27) +
                            (static_cast<u64>(l2) << 54);
          if (leader && total != 0ULL) {
            if (privatised) {
              *where += total;
            } else {
              atomicAdd(where, total);
            }
          }
        };
        for (int a0 = 0; a0 < A; a0 += 4) {
          u64 v[4];
          int ok[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            v[k] = a0 + k < A
                       ? static_cast<u64>(contribution(
                             rows.data[a0 + k], rows.width[a0 + k],
                             rows.half[a0 + k], rows.valid[a0 + k], i, ok[k]))
                       : 0ULL;
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (a0 + k < A) {
              add(cell + rows.sum_cell[a0 + k], v[k]);
              if (rows.count_cell[a0 + k] >= 0) {
                add(cell + rows.count_cell[a0 + k], static_cast<u64>(ok[k]));
              }
            }
          }
        }
      }
      __syncwarp();
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < cells; c += blockDim.x) {
    u64 v = 0ULL;
    for (int w = 0; w < copies; ++w) v += shared_cells[w * cells + c];
    if (v != 0ULL) {
      atomicAdd(out + (c / rows.outputs) * ldo + rows.out_col[c % rows.outputs],
                v);
    }
  }
}

// warps of a slot_sums_tiles block: one per aggregate, times S shares
// of the rows where there are fewer than 8 aggregates
inline int row_shares(int A) { return A >= 8 ? 1 : (8 + A - 1) / A; }

inline bool fused(const Rows& rows, int A) {
  for (int a = 0; a < A; ++a) {
    if (rows.count_cell[a] >= 0) return true;
  }
  return false;
}

// shared memory of a slot_sums_tiles<0, *> block beyond its static part
inline size_t column_bytes(const Rows& rows, int T, int A) {
  const size_t warps = A * row_shares(A);
  const size_t depth = fused(rows, A) ? 2 * T : T;
  return (warps * depth * 32 + static_cast<size_t>(T) * rows.outputs) *
         sizeof(u64);
}
constexpr size_t STATIC_BYTES = STAGES * SLOT_BUF * sizeof(int32_t) + 64;

template <int TR, bool HALVES>
cudaError_t launch_tiles(const int32_t* row_slot, const Rows& rows, int64_t n,
                         int T, int A, int ldo, u64* out, int sms,
                         int smem_limit, cudaStream_t stream) {
  const int S = row_shares(A);
  const int threads = A * S * 32;
  const size_t smem = TR > 0 ? 0 : column_bytes(rows, T, A);
  cudaError_t err = cudaSuccess;
  if (smem + STATIC_BYTES > 48 * 1024) {
    err = cudaFuncSetAttribute(slot_sums_tiles<TR, HALVES>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_limit - static_cast<int>(STATIC_BYTES));
    if (err != cudaSuccess) return err;
  }
  // blocks of this shape an SM holds: asked once per shape and thread
  thread_local std::map<std::pair<int, size_t>, int> resident;
  int& per_sm = resident[{threads, smem}];
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, slot_sums_tiles<TR, HALVES>, threads, smem);
    if (err != cudaSuccess) return err;
  }
  const int64_t tiles = (n / 2 + 1 + TILE / 2 - 1) / (TILE / 2);
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > tiles) grid = tiles;
  slot_sums_tiles<TR, HALVES>
      <<<static_cast<int>(grid), threads, smem, stream>>>(
          row_slot, rows, n, T, A, S, fused(rows, A), ldo, out);
  return cudaGetLastError();
}

cudaError_t launch_matched(const int32_t* row_slot, const Rows& rows,
                           int64_t n, int T, int A, int ldo, u64* out, int sms,
                           int smem_limit, cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(T) * rows.outputs * sizeof(u64);
  const int warps = SHARED_BLOCK / 32;
  const int privatised = cells * warps <= static_cast<size_t>(smem_limit);
  const size_t smem = privatised ? cells * warps : cells;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(slot_sums_matched,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_limit);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, slot_sums_matched, SHARED_BLOCK, smem);
  if (err != cudaSuccess) return err;
  const int64_t rows_per_block = SHARED_BLOCK * SHARED_UNROLL;
  int64_t grid = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  const int64_t blocks = (n + rows_per_block - 1) / rows_per_block;
  if (grid > blocks) grid = blocks;
  slot_sums_matched<<<static_cast<int>(grid), SHARED_BLOCK, smem, stream>>>(
      row_slot, rows, n, T, A, privatised, ldo, out);
  return cudaGetLastError();
}

// launch_tiles<T> for T in [1, TR]: one kernel instance per such T
template <int TR, bool HALVES>
cudaError_t launch_registers(const int32_t* row_slot, const Rows& rows,
                             int64_t n, int T, int A, int ldo, u64* out,
                             int sms, int smem_limit, cudaStream_t stream) {
  if (T == TR) {
    return launch_tiles<TR, HALVES>(row_slot, rows, n, T, A, ldo, out, sms,
                                    smem_limit, stream);
  }
  if constexpr (TR > 1) {
    return launch_registers<TR - 1, HALVES>(row_slot, rows, n, T, A, ldo, out,
                                            sms, smem_limit, stream);
  }
  return cudaErrorInvalidValue;
}

template <bool HALVES>
cudaError_t launch_tiled(const int32_t* row_slot, const Rows& rows, int64_t n,
                         int T, int A, int ldo, u64* out, int sms,
                         int smem_limit, cudaStream_t stream) {
  if (T <= REGISTER_T) {
    return launch_registers<REGISTER_T, HALVES>(row_slot, rows, n, T, A, ldo,
                                                out, sms, smem_limit, stream);
  }
  return launch_tiles<0, HALVES>(row_slot, rows, n, T, A, ldo, out, sms,
                                 smem_limit, stream);
}

// Zeroes the whole T x ldo output first where `zero` says so (a call's
// first launch), then sums `rows` into their columns of it.
cudaError_t launch(const int32_t* row_slot, const Rows& rows, int64_t n, int T,
                   int A, int ldo, int zero, u64* out, int sms, int smem_limit,
                   cudaStream_t stream) {
  if (zero) {
    const cudaError_t err = cudaMemsetAsync(
        out, 0, sizeof(u64) * static_cast<size_t>(T) * ldo, stream);
    if (err != cudaSuccess) return err;
  }
  if (T <= REGISTER_T || column_bytes(rows, T, A) + STATIC_BYTES <=
                             static_cast<size_t>(smem_limit)) {
    bool halves = false;
    for (int a = 0; a < A; ++a) halves = halves || rows.half[a] != WHOLE;
    return halves ? launch_tiled<true>(row_slot, rows, n, T, A, ldo, out, sms,
                                       smem_limit, stream)
                  : launch_tiled<false>(row_slot, rows, n, T, A, ldo, out,
                                        sms, smem_limit, stream);
  }
  return launch_matched(row_slot, rows, n, T, A, ldo, out, sms, smem_limit,
                        stream);
}

}  // namespace

// Every entry returns a cudaError_t as int (0 on success). The launches go
// to `stream`; nothing synchronises. `out` is the call's whole output, T
// rows of `ldo` sums; an entry zeroes all of it on `stream` first where
// `zero` is not 0, and adds its sums into their columns. 1 <= A <= 16,
// n >= 1 and 8 * T * (outputs of the launch) <= smem_limit are the caller's
// to keep.

// Multiprocessors of the current device and the most shared memory one of
// its blocks may ask for.
extern "C" int masked_slot_sums_limits(int* sms, int* smem_limit) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(smem_limit,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  }
  return static_cast<int>(err);
}

// Contributions held as A rows of an int64 matrix, n elements apart; their
// sums go to columns col0 .. col0 + A - 1.
extern "C" int masked_slot_sums(const void* row_slot, const void* contribs,
                                long long n, int T, int A, int col0, void* out,
                                int ldo, int zero, int sms, int smem_limit,
                                void* stream) {
  Rows rows;
  for (int a = 0; a < A; ++a) {
    rows.data[a] = static_cast<const long long*>(contribs) + a * n;
    rows.valid[a] = nullptr;
    rows.width[a] = 8;
    rows.half[a] = WHOLE;
    rows.sum_cell[a] = a;
    rows.count_cell[a] = -1;
    rows.out_col[a] = col0 + a;
  }
  rows.outputs = A;
  return static_cast<int>(launch(
      static_cast<const int32_t*>(row_slot), rows, n, T, A, ldo, zero,
      static_cast<u64*>(out), sms, smem_limit,
      static_cast<cudaStream_t>(stream)));
}

// Contributions described by columns. `desc` holds five values per row:
// the data column's address (0 for a row of ones), the validity column's
// address (bytes; 0 for all valid), the bytes per data element (8 or 4)
// plus 256 times the half-word read mode (WHOLE, HI or LO), the output
// column of the sum of data * valid, and the output column of the sum of
// valid itself (negative for none).
extern "C" int masked_slot_sums_rows(const void* row_slot,
                                     const long long* desc, long long n,
                                     int T, int A, void* out, int ldo,
                                     int zero, int sms, int smem_limit,
                                     void* stream) {
  Rows rows;
  rows.outputs = 0;
  for (int a = 0; a < A; ++a) {
    const long long* d = desc + 5 * a;
    rows.data[a] = reinterpret_cast<const void*>(d[0]);
    rows.valid[a] = reinterpret_cast<const unsigned char*>(d[1]);
    rows.width[a] = d[0] == 0 ? 0 : static_cast<int>(d[2] & 0xff);
    rows.half[a] = static_cast<int>(d[2] >> 8);
    rows.out_col[rows.outputs] = static_cast<int>(d[3]);
    rows.sum_cell[a] = rows.outputs++;
    rows.count_cell[a] = -1;
    if (d[4] >= 0) {
      rows.out_col[rows.outputs] = static_cast<int>(d[4]);
      rows.count_cell[a] = rows.outputs++;
    }
  }
  return static_cast<int>(launch(
      static_cast<const int32_t*>(row_slot), rows, n, T, A, ldo, zero,
      static_cast<u64*>(out), sms, smem_limit,
      static_cast<cudaStream_t>(stream)));
}
