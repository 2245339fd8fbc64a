// DoorKey's layout generator (envs/doorkey.py:generate on a CUDA device):
// from the five draws of the plain generator, made in its order before the
// launch (the split column, the agent's rank, its direction, the door's
// row, the key's rank), one launch writes the whole batch-first EnvState
// of B layouts: the outer walls, the goal at (W-2, H-2), the split wall
// with the locked yellow door at (split, door row), the agent at the
// (rank+1)-th free cell left of the wall in row-major order, facing the
// drawn direction, and the yellow key at the (rank+1)-th such cell that the
// agent does not hold; every other field is core/state.py:new_state's blank.
// Its layouts are the plain generator's, bit for bit.
//
// It replaces no TPU kernel: JAX's generator is plain code that XLA fuses
// into its caller's program.  In the port the same plain code
// (envs/doorkey.py:generate_plain over ops/grid.py) is about 180 PyTorch
// operators a call: a select over every plane for each wall, door and
// placement, and an int64 running count over every cell for each rank.
// On an H100, inside the regen rollout's step graph at 65536 layouts, it
// took 1.77 ms of the 1.85 ms step.
//
// What bounds it on an H100: the bytes it writes.  A DoorKey-8x8 layout is
// 1146 B (five u8 and two int32 planes of 64 cells, aux and mission, the
// scalars) against 18 B of draws read; 65536 layouts are 75 MB, 22 µs at
// 3.35 TB/s.  The design:
//
// * A block of 128 layouts.  First each thread computes its layout's
//   placements into shared memory, three integers: the split column, the
//   door's cell and the key's cell.  It writes the layout's scalars itself
//   (a warp's stores are contiguous).
// * Then the block writes each field as one contiguous span of its
//   layouts (128 x H x W bytes for a u8 plane) in 16-byte words, each
//   word's cells computed from the placements, so every store is
//   coalesced and no plane is staged.  The obj, colour and state planes
//   come from one pass over the cells; the constant planes, aux and the
//   mission are filled.
// * A rank is ops/grid.py:sample_mask_pos's: min(int64(u * float(count)),
//   max(count - 1, 0)), the product one float32 multiply rounded to
//   nearest (no contraction).  The split is drawn from [2, W-2), so the
//   free cells left of the wall are the columns 1 .. split-1 of the rows
//   1 .. H-2 (the goal at column W-2 and the door at the split lie right of
//   them): the (r+1)-th is at row 1 + r / (split-1), column
//   1 + r % (split-1), and the key's rank skips the agent's cell.  An
//   empty set places nothing (ok False): the agent keeps (-1, -1) and
//   direction -1.
// * The grid's size is given at run time: one instance serves DoorKey
//   5x5 to 16x16.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// core/constants.py: objects, colours and door states.
constexpr uint32_t kObjEmpty = 1;
constexpr uint32_t kObjWall = 2;
constexpr uint32_t kObjDoor = 4;
constexpr uint32_t kObjKey = 5;
constexpr uint32_t kObjGoal = 8;
constexpr uint32_t kColorGreen = 1;
constexpr uint32_t kColorYellow = 4;
constexpr uint32_t kColorGrey = 5;
constexpr uint32_t kStateLocked = 2;

constexpr int kLayouts = 128;  // layouts (threads) a block

}  // namespace

// One launch's arguments, mirrored by envs/doorkey.py:_GenArgs: the
// EnvState's fields in its order, batch-first, each 16-byte aligned, then
// the five draws, (B,) each.
struct GenArgs {
  uint8_t* grid_obj;  // (B, H, W)
  uint8_t* grid_color;
  uint8_t* grid_state;
  uint8_t* contains_obj;
  uint8_t* contains_color;
  int32_t* marks;  // (B, H, W)
  int32_t* vmarks;
  int32_t* agent_pos;  // (B, 2): x, y
  int32_t* agent_dir;  // (B,)
  uint8_t* carrying_obj;
  uint8_t* carrying_color;
  uint8_t* carrying_contains_obj;
  uint8_t* carrying_contains_color;
  int32_t* carrying_marks;
  int32_t* step_count;
  uint8_t* terminated;  // bool
  uint8_t* truncated;
  int32_t* aux;      // (B, n_aux)
  int32_t* mission;  // (B, n_mission)
  const int32_t* split;  // randint(2, W - 2): the wall's column
  const float* agent_u;  // rand: the agent's rank
  const int32_t* dir;    // randint(0, 4): the agent's direction
  const int32_t* door;   // randint(1, W - 2): the door's row
  const float* key_u;    // rand: the key's rank
  int32_t B, H, W, n_aux, n_mission;
};

namespace {

// ops/grid.py:sample_mask_pos's rank of u among count cells.
__device__ __forceinline__ int rank_of(float u, int count) {
  const long long r = static_cast<long long>(__fmul_rn(u, static_cast<float>(count)));
  const long long top = count > 0 ? count - 1 : 0;
  return static_cast<int>(r < top ? r : top);
}

// Bytes [0, n) of p (16-byte aligned) set to the repeated byte of
// `pattern` by the block's threads, 16 bytes a store.
__device__ __forceinline__ void fill(uint8_t* p, size_t n, uint32_t pattern) {
  const uint4 v = make_uint4(pattern, pattern, pattern, pattern);
  uint4* q = reinterpret_cast<uint4*>(p);
  const size_t words = n / 16;
  for (size_t i = threadIdx.x; i < words; i += kLayouts) q[i] = v;
  const size_t tail = n % 16;  // only in the last block
  if (threadIdx.x < tail) p[n - tail + threadIdx.x] = static_cast<uint8_t>(pattern);
}

__global__ void __launch_bounds__(kLayouts) doorkey_gen_kernel(const GenArgs a) {
  __shared__ int s_split[kLayouts], s_door[kLayouts], s_key[kLayouts];
  const int b0 = blockIdx.x * kLayouts;
  const int nb = min(kLayouts, a.B - b0);
  const int H = a.H, W = a.W, hw = H * W;

  // The placements, a thread a layout, and the layout's scalars.
  if (threadIdx.x < nb) {
    const int t = threadIdx.x, b = b0 + t;
    const int split = a.split[b];
    const int cols = split - 1;
    const int count = cols * (H > 2 ? H - 2 : 0);  // free cells left of the wall
    int ax = -1, ay = -1, adir = -1, key = -1;
    if (count > 0) {
      const int ra = rank_of(a.agent_u[b], count);
      ax = 1 + ra % cols;
      ay = 1 + ra / cols;
      adir = a.dir[b];
      if (count > 1) {
        int rk = rank_of(a.key_u[b], count - 1);
        rk += rk >= ra;  // the agent's cell is not free
        key = (1 + rk / cols) * W + 1 + rk % cols;
      }
    }
    const int door_row = a.door[b];
    s_split[t] = split;
    s_door[t] = door_row >= 0 && door_row < H ? door_row * W + split : -1;
    s_key[t] = key;
    reinterpret_cast<int2*>(a.agent_pos)[b] = make_int2(ax, ay);
    a.agent_dir[b] = adir;
    a.carrying_obj[b] = kObjEmpty;
    a.carrying_color[b] = 0;
    a.carrying_contains_obj[b] = kObjEmpty;
    a.carrying_contains_color[b] = 0;
    a.carrying_marks[b] = 0;
    a.step_count[b] = 0;
    a.terminated[b] = 0;
    a.truncated[b] = 0;
  }
  __syncthreads();

  // The obj, colour and state planes of the block's layouts, 16 cells a
  // word.  Later objects cover earlier ones, as the plain generator paints
  // them: the border walls, the goal, the split wall, the door, the key.
  const size_t base = static_cast<size_t>(b0) * hw;
  const int n_cells = nb * hw;
  const int goal = H >= 2 ? (H - 2) * W + (W - 2) : -1;
  for (int i = threadIdx.x; i * 16 < n_cells; i += kLayouts) {
    const int o = i * 16;
    int l = o / hw, c = o - l * hw;
    int y = c / W, x = c - y * W;
    int split = s_split[l], door = s_door[l], key = s_key[l];
    uint32_t obj[4], col[4], st[4];
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      uint32_t code = kObjEmpty, color = 0, state = 0;
      if (c == key) {
        code = kObjKey, color = kColorYellow;
      } else if (c == door) {
        code = kObjDoor, color = kColorYellow, state = kStateLocked;
      } else if (x == split) {
        code = kObjWall, color = kColorGrey;
      } else if (c == goal) {
        code = kObjGoal, color = kColorGreen;
      } else if (x == 0 || y == 0 || x == W - 1 || y == H - 1) {
        code = kObjWall, color = kColorGrey;
      }
      const int k = j / 4, sh = 8 * (j % 4);
      obj[k] = (j % 4 ? obj[k] : 0u) | code << sh;
      col[k] = (j % 4 ? col[k] : 0u) | color << sh;
      st[k] = (j % 4 ? st[k] : 0u) | state << sh;
      if (++x == W) x = 0, ++y;
      if (++c == hw) {
        c = 0, y = 0;
        if (++l < nb) split = s_split[l], door = s_door[l], key = s_key[l];
      }
    }
    if (o + 16 <= n_cells) {
      *reinterpret_cast<uint4*>(a.grid_obj + base + o) = make_uint4(obj[0], obj[1], obj[2], obj[3]);
      *reinterpret_cast<uint4*>(a.grid_color + base + o) = make_uint4(col[0], col[1], col[2], col[3]);
      *reinterpret_cast<uint4*>(a.grid_state + base + o) = make_uint4(st[0], st[1], st[2], st[3]);
    } else {  // the last block's last cells
      for (int j = 0; o + j < n_cells; ++j) {
        const int sh = 8 * (j % 4);
        a.grid_obj[base + o + j] = static_cast<uint8_t>(obj[j / 4] >> sh);
        a.grid_color[base + o + j] = static_cast<uint8_t>(col[j / 4] >> sh);
        a.grid_state[base + o + j] = static_cast<uint8_t>(st[j / 4] >> sh);
      }
    }
  }

  // The fields the layout leaves blank.
  const size_t cells = static_cast<size_t>(nb) * hw;
  fill(a.contains_obj + base, cells, kObjEmpty * 0x01010101u);
  fill(a.contains_color + base, cells, 0);
  fill(reinterpret_cast<uint8_t*>(a.marks + base), 4 * cells, 0);
  fill(reinterpret_cast<uint8_t*>(a.vmarks + base), 4 * cells, 0);
  fill(reinterpret_cast<uint8_t*>(a.aux + static_cast<size_t>(b0) * a.n_aux),
       4 * static_cast<size_t>(nb) * a.n_aux, 0);
  fill(reinterpret_cast<uint8_t*>(a.mission + static_cast<size_t>(b0) * a.n_mission),
       4 * static_cast<size_t>(nb) * a.n_mission, 0);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// Writes B DoorKey layouts on `stream` (see the top of this file; the
// pointers and sizes in *args, all on the card).  Returns the launch's
// cudaError_t (0 = ok).
extern "C" int doorkey_gen_launch(const GenArgs* args, void* stream) {
  const GenArgs& a = *args;
  if (a.B < 0 || a.H < 1 || a.W < 1 || a.n_aux < 0 || a.n_mission < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* fields[] = {a.grid_obj, a.grid_color, a.grid_state, a.contains_obj,
                          a.contains_color, a.marks, a.vmarks, a.agent_pos, a.aux, a.mission};
  for (const void* p : fields) {
    if (!aligned16(p)) return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (a.B == 0) return 0;
  const int blocks = (a.B + kLayouts - 1) / kLayouts;
  doorkey_gen_kernel<<<blocks, kLayouts, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// sizeof(GenArgs), which the caller's mirror of it must match.
extern "C" int gen_args_bytes() { return static_cast<int>(sizeof(GenArgs)); }
