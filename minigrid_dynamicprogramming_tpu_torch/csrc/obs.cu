// The rollout step's observation checksum (parallel/lanes.py:
// obs_checksum_lanes): for each lane the egocentric view of obs_lanes (the
// view's cells from the agent's position and direction, cells outside the
// grid a grey wall, a state only on doors, the visibility sweep, the
// carried object at the agent's cell), each visible cell's obj + color +
// state summed, and the lanes' sums added into the step's int64 slot
// out[*t].  Integer sums are exact in any order, so the blocks add theirs
// with one atomic each; the caller zeroes the slots once, before the
// rollout's first step.
//
// It replaces no TPU kernel: JAX's observation (parallel/lanes.py:
// obs_image_lanes) is plain code that XLA fuses into the step's program.
// In the port the same plain code is about 340 PyTorch operators a step,
// each a kernel over (view*view, B) int32 and int64 intermediates, and
// took 62% of the rollout's graphed step.
//
// What bounds it on an H100: bytes.  A lane reads three u8 planes of its
// grid (HW cells each, lane-major: cell c of lane b at c * B + b) and five
// scalars, which the step has just written, and writes nothing but the
// one slot: at DoorKey-8x8 and 65536 lanes, 12.6 MB of planes and 0.9 MB
// of scalars, 4 µs at 3.35 TB/s.  The design reads each of those bytes
// once, coalesced, and keeps everything else in registers:
//
// * One thread a lane, 128 lanes a block.  Where the grid has at most 64
//   cells (every DoorKey up to 8x8), the block first stages its lanes'
//   columns of the three planes in shared memory: each thread loads four
//   lanes of one cell from each plane as one 32-bit word (a warp reads 128
//   contiguous bytes of a plane), and stores them as four words, one a
//   lane, obj | color << 8 | state << 16 (one 16-byte store).  A cell of
//   lane l then sits at word c * 128 + l, so the view's scattered reads
//   hit 32 distinct banks a warp whatever cells the lanes look at.
//   Larger grids (16x16 holds 256 cells, 49 of them in view) read the
//   view's cells from device memory (the L2, where the step left them).
// * The visibility sweep is the plain version's, row by row from the
//   agent's row away from it: each view row a 64-bit bitboard of its
//   see-through cells, grown left and right by the same doubling fill
//   (_spread), and its reach handed to the next row.  Only the pending
//   row's bits are kept, so a row's visible cells are summed as soon as
//   its sweep ends.  see_through_walls makes every cell visible.
// * The view's width is a template parameter for 7, DoorKey's and every
//   BabyAI level's, so the 49 cells unroll into straight-line code; a
//   second instance takes it at run time, up to 63 (a row must fit a
//   bitboard with its sign bit clear, as in the plain version).
// * The block's lanes' sums meet by warp shuffles and shared memory; one
//   64-bit atomic add a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// core/constants.py: the wire format's objects, colours and door states.
constexpr uint32_t kObjEmpty = 1;
constexpr uint32_t kObjWall = 2;
constexpr uint32_t kObjDoor = 4;
constexpr uint32_t kColorGrey = 5;
constexpr uint32_t kStateClosed = 1;

constexpr int kMaxView = 63;
constexpr int kLanes = 128;        // lanes (threads) a block
constexpr int kStagedCells = 64;   // the most cells a staged grid has: 32 KB
constexpr int kWarps = kLanes / 32;

// A cell as one word: obj | color << 8 | state << 16.
__device__ __forceinline__ uint32_t pack(uint32_t obj, uint32_t color, uint32_t state) {
  return obj | (color << 8) | (state << 16);
}

__device__ __forceinline__ uint32_t obj_of(uint32_t w) { return w & 0xff; }

// The wire format's state: a door's, else 0.
__device__ __forceinline__ uint32_t state_of(uint32_t w) {
  return obj_of(w) == kObjDoor ? (w >> 16) & 0xff : 0;
}

__device__ __forceinline__ uint32_t value_of(uint32_t w) {
  return obj_of(w) + ((w >> 8) & 0xff) + state_of(w);
}

__device__ __forceinline__ uint64_t see_bit(uint32_t w) {
  const uint32_t obj = obj_of(w);
  const bool blocked = obj == kObjWall || (obj == kObjDoor && state_of(w) >= kStateClosed);
  return blocked ? 0ull : 1ull;
}

// parallel/lanes.py:_spread, in 64-bit registers.
template <bool kUp>
__device__ __forceinline__ uint64_t spread(uint64_t row, uint64_t see_row, int v) {
  uint64_t run = see_row;
  for (int k = 1;; k *= 2) {
    row |= kUp ? ((row & run) << k) : ((row & run) >> k);
    if (2 * k >= v) return row;
    run &= kUp ? (run >> k) : (run << k);
  }
}

template <int kView, bool kStaged>
__global__ void __launch_bounds__(kLanes)
obs_checksum_kernel(const uint8_t* __restrict__ grid_obj, const uint8_t* __restrict__ grid_color,
                    const uint8_t* __restrict__ grid_state, const int32_t* __restrict__ agent_x,
                    const int32_t* __restrict__ agent_y, const int32_t* __restrict__ agent_dir,
                    const uint8_t* __restrict__ carrying_obj,
                    const uint8_t* __restrict__ carrying_color, int64_t* __restrict__ out,
                    const int64_t* __restrict__ t, int B, int H, int W, int view,
                    int see_through_walls, int wide_loads) {
  __shared__ uint32_t cells[kStaged ? kStagedCells * kLanes : 1];
  __shared__ int warp_sums[kWarps];
  const int v = kView ? kView : view;
  const int hw = H * W;
  const int b0 = blockIdx.x * kLanes;
  const int lanes = min(kLanes, B - b0);
  const int l = threadIdx.x;

  if constexpr (kStaged) {
    if (wide_loads) {
      // 32 four-lane words a cell; lanes is a multiple of 4 here.
      const int quads = lanes >> 2;
      for (int i = l; i < hw * (kLanes / 4); i += kLanes) {
        const int c = i / (kLanes / 4), q = i % (kLanes / 4);
        if (q >= quads) continue;
        const size_t at = static_cast<size_t>(c) * B + b0 + 4 * q;
        const uint32_t o = __ldg(reinterpret_cast<const uint32_t*>(grid_obj + at));
        const uint32_t k = __ldg(reinterpret_cast<const uint32_t*>(grid_color + at));
        const uint32_t s = __ldg(reinterpret_cast<const uint32_t*>(grid_state + at));
        uint4 four;
        four.x = pack(o & 0xff, k & 0xff, s & 0xff);
        four.y = pack((o >> 8) & 0xff, (k >> 8) & 0xff, (s >> 8) & 0xff);
        four.z = pack((o >> 16) & 0xff, (k >> 16) & 0xff, (s >> 16) & 0xff);
        four.w = pack(o >> 24, k >> 24, s >> 24);
        *reinterpret_cast<uint4*>(&cells[c * kLanes + 4 * q]) = four;
      }
    } else {
      for (int i = l; i < hw * kLanes; i += kLanes) {
        const int c = i / kLanes, j = i % kLanes;
        if (j >= lanes) continue;
        const size_t at = static_cast<size_t>(c) * B + b0 + j;
        cells[i] = pack(grid_obj[at], grid_color[at], grid_state[at]);
      }
    }
    __syncthreads();
  }

  uint32_t sum = 0;
  if (l < lanes) {
    const int b = b0 + l;
    const int hs = v / 2;
    const int ax = agent_x[b], ay = agent_y[b], d = agent_dir[b];
    // obs_lanes: wy(u) = ay + py*u + qy, wx(t) = ax + px*t + qx, with
    // (u, t) = (vx, vy) facing +-x, (vy, vx) facing +-y.
    const bool horiz = d % 2 == 0;
    const int sgn = (d == 0 || d == 1) ? 1 : -1;
    const int py = horiz ? sgn : -sgn;
    const int qy = ay + (horiz ? -sgn * hs : sgn * (v - 1));
    const int px = -sgn;
    const int qx = ax + sgn * (horiz ? v - 1 : hs);

    // View cell (vy, vx) as a word; outside the grid a grey wall.
    auto cell = [&](int vy, int vx) -> uint32_t {
      const int wy = py * (horiz ? vx : vy) + qy;
      const int wx = px * (horiz ? vy : vx) + qx;
      if (wx < 0 || wx >= W || wy < 0 || wy >= H) return pack(kObjWall, kColorGrey, 0);
      const int c = wy * W + wx;
      if constexpr (kStaged) {
        return cells[c * kLanes + l];
      } else {
        const size_t at = static_cast<size_t>(c) * B + b;
        return pack(__ldg(grid_obj + at), __ldg(grid_color + at), __ldg(grid_state + at));
      }
    };

    const uint64_t row_mask = (1ull << v) - 1;
    const uint64_t not_last = row_mask ^ (1ull << (v - 1));
    const uint64_t not_first = row_mask ^ 1ull;
    uint64_t pending = 1ull << hs;  // the agent's cell
    uint32_t words[kView ? kView : 1];
#pragma unroll
    for (int vy = v - 1; vy >= 0; --vy) {
      uint64_t see = 0;
#pragma unroll
      for (int vx = 0; vx < v; ++vx) {
        const uint32_t w = cell(vy, vx);
        if constexpr (kView != 0) words[vx] = w;
        see |= see_bit(w) << vx;
      }
      uint64_t row = spread<true>(pending, see, v) & row_mask;
      const uint64_t cond1 = row & see & not_last;
      row = spread<false>(row, see, v);
      const uint64_t cond2 = row & see & not_first;
      pending = cond1 | ((cond1 << 1) & row_mask) | cond2 | (cond2 >> 1);
      const uint64_t vis = see_through_walls ? row_mask : row;
#pragma unroll
      for (int vx = 0; vx < v; ++vx) {
        uint32_t w;
        if constexpr (kView != 0) {
          w = words[vx];
        } else {
          w = cell(vy, vx);
        }
        sum += static_cast<uint32_t>((vis >> vx) & 1) * value_of(w);
      }
    }
    // The agent's cell, always visible, shows what it carries, with no
    // state: an empty hand shows colour 0.
    const uint32_t held = carrying_obj[b];
    sum += held + (held == kObjEmpty ? 0u : carrying_color[b]);
    sum -= value_of(cell(v - 1, hs));
  }

  // The block's sum: at most 128 lanes x 63 x 63 cells x 17, within 32 bits.
#pragma unroll
  for (int off = 16; off; off >>= 1) sum += __shfl_down_sync(0xffffffffu, sum, off);
  if (l % 32 == 0) warp_sums[l / 32] = static_cast<int>(sum);
  __syncthreads();
  if (l == 0) {
    unsigned long long total = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) total += static_cast<unsigned int>(warp_sums[i]);
    atomicAdd(reinterpret_cast<unsigned long long*>(out + *t), total);
  }
}

template <int kView, bool kStaged>
void launch(const void* obj, const void* color, const void* state, const void* ax,
            const void* ay, const void* dir, const void* cobj, const void* ccolor, void* out,
            const void* t, int B, int H, int W, int view, int see_through, int wide,
            cudaStream_t stream) {
  obs_checksum_kernel<kView, kStaged><<<(B + kLanes - 1) / kLanes, kLanes, 0, stream>>>(
      static_cast<const uint8_t*>(obj), static_cast<const uint8_t*>(color),
      static_cast<const uint8_t*>(state), static_cast<const int32_t*>(ax),
      static_cast<const int32_t*>(ay), static_cast<const int32_t*>(dir),
      static_cast<const uint8_t*>(cobj), static_cast<const uint8_t*>(ccolor),
      static_cast<int64_t*>(out), static_cast<const int64_t*>(t), B, H, W, view, see_through,
      wide);
}

}  // namespace

// Adds the observation checksum of B lanes into out[*t] on `stream`: the
// planes (H*W, B) u8, the agent's x, y and direction (B,) i32, what it
// carries (B,) u8, out int64, t one int64, all on the card.  The instance
// is the one for a view of 7 at view == 7, else the one for a view given
// at run time; the planes are staged where H*W <= 64 (kStagedCells).
// Returns the launch's cudaError_t (0 = ok).
extern "C" int obs_checksum_launch(const void* obj, const void* color, const void* state,
                                   const void* ax, const void* ay, const void* dir,
                                   const void* cobj, const void* ccolor, void* out,
                                   const void* t, int B, int H, int W, int view,
                                   int see_through, void* stream) {
  if (B < 0 || H < 1 || W < 1 || view < 1 || view > kMaxView) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const bool staged = H * W <= kStagedCells;
  // Four lanes a 32-bit load: B and the planes' addresses multiples of 4.
  const uintptr_t addr = reinterpret_cast<uintptr_t>(obj) | reinterpret_cast<uintptr_t>(color) |
                         reinterpret_cast<uintptr_t>(state);
  const int wide = (B % 4 == 0 && addr % 4 == 0) ? 1 : 0;
#define OBS_ARGS obj, color, state, ax, ay, dir, cobj, ccolor, out, t, B, H, W, view, see_through, wide, s
  if (view == 7) {
    staged ? launch<7, true>(OBS_ARGS) : launch<7, false>(OBS_ARGS);
  } else {
    staged ? launch<0, true>(OBS_ARGS) : launch<0, false>(OBS_ARGS);
  }
#undef OBS_ARGS
  return static_cast<int>(cudaGetLastError());
}
