// The rollout step's transition, autoreset and write-back (parallel/lanes.py:
// step_lanes_kernel): for each lane the core MDP step of step_lanes
// (turns, forward into an empty, floor, goal, lava or open-door cell, pickup,
// drop, toggle: unlock with the matching key, open or close, open a box),
// the goal's and lava's termination, truncation at the step limit, and,
// where the lane is done, its fresh layout copied over it (_select_pool and
// _select_lanes), all on the carry in place.  The lanes' done, terminated
// and won counts are added into the step's int64 slots (integer sums are
// exact in any order: one atomic a block and counter); the per-lane reward
// goes to a buffer that the caller sums as the plain path does.
//
// It replaces no TPU kernel: JAX's step is plain code that XLA fuses into
// the scan's program.  In the port the same plain code is about 230 PyTorch
// operators a step (selects and compares on (B,) tensors, an out-of-place
// scatter of every plane it writes, a select over every field for the
// autoreset and a copy of every field back into the carry), and took 84%
// of the rollout's graphed step.
//
// What bounds it on an H100: bytes.  A lane reads its action and 18 B of
// scalars, one byte of each plane at the cell in front of it (a 32-byte
// sector each, shared only with lanes that face the same cell), and writes
// 14 B back (its direction, step count, reward and done flags); the front
// cell is written only where the action changed it.  A lane that is done reads its fresh layout (three
// u8 planes of H*W cells, more where the family keeps boxes, marks, aux or
// a mission, and the scalars) and writes it over its own.  At DoorKey-8x8
// and 65536 lanes, about one in 640 done a step, that is 8.7 MB a step, 2.6
// µs at 3.35 TB/s (chip_smoke.py:step_bytes).  The design:
//
// * One thread a lane, 128 lanes a block, lane-major as the carry is: cell
//   c of lane b at c * B + b, so a warp's scalar loads and stores are
//   coalesced.
// * In place: only the front cell's bytes that change are stored, and a
//   done lane stores its fresh fields and nothing of the step.  Fields the
//   family never changes (the env record's no_boxes, no_marks,
//   fixed_mission, fixed_aux) are neither read nor written.
// * A done lane's fresh layout is copied by its whole warp, one done lane
//   after another, a thread an element, every load of a round before its
//   stores: one lane copying its own H*W cells of a lane-major pool waited
//   for each cell's sector in turn, and held the whole launch (0.064 ms at
//   the pool cell's shape; 0.012 from a batch-first batch, whose cells
//   share sectors).
// * The fresh layouts are lane-major rounds (R, n, B) ("pool": round
//   reset_count % R; "cached": R = 1), or this step's batch-first
//   generated batch (B, n) ("regen"), read where it lies: a template
//   parameter picks the addressing.
// * The reward is success_reward's float32 arithmetic, rounded as
//   PyTorch rounds it, with no contraction into a fused multiply-add.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// core/constants.py: objects, door states and actions.
constexpr uint32_t kObjEmpty = 1;
constexpr uint32_t kObjWall = 2;
constexpr uint32_t kObjFloor = 3;
constexpr uint32_t kObjDoor = 4;
constexpr uint32_t kObjKey = 5;
constexpr uint32_t kObjBall = 6;
constexpr uint32_t kObjBox = 7;
constexpr uint32_t kObjGoal = 8;
constexpr uint32_t kObjLava = 9;
constexpr uint32_t kStateOpen = 0;
constexpr uint32_t kStateClosed = 1;
constexpr uint32_t kStateLocked = 2;
constexpr int kActLeft = 0;
constexpr int kActRight = 1;
constexpr int kActForward = 2;
constexpr int kActPickup = 3;
constexpr int kActDrop = 4;
constexpr int kActToggle = 5;

// StepArgs.flags: the fields the family never changes, and the fresh
// layouts' order.
constexpr int kNoBoxes = 1;       // contains_obj, contains_color
constexpr int kNoMarks = 2;       // marks, vmarks
constexpr int kFixedMission = 4;  // mission
constexpr int kFixedAux = 8;      // aux
constexpr int kBatchFirst = 16;   // fresh is (B, n), not rounds of (n, B)

constexpr int kLanes = 128;  // lanes (threads) a block

}  // namespace

// parallel/lanes.py:LaneState's fields, in its order (_FIELDS).
struct LaneFields {
  uint8_t* grid_obj;
  uint8_t* grid_color;
  uint8_t* grid_state;
  uint8_t* contains_obj;
  uint8_t* contains_color;
  int32_t* marks;
  int32_t* vmarks;
  int32_t* agent_x;
  int32_t* agent_y;
  int32_t* agent_dir;
  uint8_t* carrying_obj;
  uint8_t* carrying_color;
  uint8_t* carrying_contains_obj;
  uint8_t* carrying_contains_color;
  int32_t* carrying_marks;
  int32_t* step_count;
  uint8_t* terminated;
  uint8_t* truncated;
  int32_t* aux;
  int32_t* mission;
};

// One launch's arguments, mirrored by parallel/lanes.py:_StepArgs.
struct StepArgs {
  LaneFields cur;    // the carry: planes (H*W, B), scalars (B,), aux, mission (n, B)
  LaneFields fresh;  // rounds (R, n, B), or batch-first (B, n) with agent_x/_y in agent_pos (B, 2)
  const void* actions;  // actions[*t * action_row + b], int32 or int64
  const int64_t* t;     // the step's slot
  int32_t* reset_count;  // (B,)
  float* reward;         // (B,), written
  int64_t* dones;        // (T,): slot *t gains the step's counts
  int64_t* wins;
  int64_t* ends;
  int64_t action_row;  // B for (T, B) actions, 0 for one step's (B,)
  int32_t action_bytes;
  int32_t B, H, W, max_steps, rounds, n_aux, n_mission, flags;
};

namespace {

// torch's remainder, the sign of the divisor.
__device__ __forceinline__ int mod4(int x) {
  const int m = x % 4;
  return m < 0 ? m + 4 : m;
}

// kN fresh fields of n elements a lane into the carry's lane b, the warp's
// threads over the elements, two a thread a round: every load of a round
// is issued before its stores, so a round waits for memory once.  Lane-
// major rounds read an element's own sector, a batch-first batch 32
// neighbouring elements a warp.
template <bool kBF, int kN, typename T>
__device__ __forceinline__ void copy_fresh(T* const (&dst)[kN], T* const (&src)[kN], int n, int b,
                                           int B, int r, int lane) {
  for (int k0 = lane; k0 < n; k0 += 64) {
    T v[2][kN];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 32 * h;
      const int64_t from = kBF ? int64_t(b) * n + k : (int64_t(r) * n + k) * B + b;
#pragma unroll
      for (int p = 0; p < kN; ++p) v[h][p] = k < n ? src[p][from] : T(0);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 32 * h;
#pragma unroll
      for (int p = 0; p < kN; ++p) {
        if (k < n) dst[p][int64_t(k) * B + b] = v[h][p];
      }
    }
  }
}

// Lane b's fresh layout, round r, over its fields but the family's fixed
// ones: called by every thread of a warp (``lane`` its index there).  The
// scalars go one a thread, loaded first and stored last; batch-first,
// agent_pos (B, 2) holds x at 2b and y at 2b + 1 (agent_y = agent_x + 1).
template <bool kBF>
__device__ __forceinline__ void reset_lane(const StepArgs& a, int b, int r, int lane) {
  const LaneFields& d = a.cur;
  const LaneFields& s = a.fresh;
  const int B = a.B, hw = a.H * a.W;
  const int64_t at = kBF ? int64_t(b) : int64_t(r) * B + b;
  const int64_t pos = kBF ? 2 * int64_t(b) : at;
  int32_t v = 0;
  switch (lane) {
    case 0: v = s.agent_x[pos]; break;
    case 1: v = s.agent_y[pos]; break;
    case 2: v = s.agent_dir[at]; break;
    case 3: v = s.carrying_obj[at]; break;
    case 4: v = s.carrying_color[at]; break;
    case 5: v = s.carrying_contains_obj[at]; break;
    case 6: v = s.carrying_contains_color[at]; break;
    case 7: v = s.carrying_marks[at]; break;
    case 8: v = s.step_count[at]; break;
    case 9: v = s.terminated[at]; break;
    case 10: v = s.truncated[at]; break;
    default: break;
  }
  copy_fresh<kBF, 3>({d.grid_obj, d.grid_color, d.grid_state},
                     {s.grid_obj, s.grid_color, s.grid_state}, hw, b, B, r, lane);
  if (!(a.flags & kNoBoxes)) {
    copy_fresh<kBF, 2>({d.contains_obj, d.contains_color}, {s.contains_obj, s.contains_color}, hw,
                       b, B, r, lane);
  }
  if (!(a.flags & kNoMarks)) {
    copy_fresh<kBF, 2>({d.marks, d.vmarks}, {s.marks, s.vmarks}, hw, b, B, r, lane);
  }
  if (!(a.flags & kFixedAux)) copy_fresh<kBF, 1>({d.aux}, {s.aux}, a.n_aux, b, B, r, lane);
  if (!(a.flags & kFixedMission)) {
    copy_fresh<kBF, 1>({d.mission}, {s.mission}, a.n_mission, b, B, r, lane);
  }
  const auto u8 = static_cast<uint8_t>(v);
  switch (lane) {
    case 0: d.agent_x[b] = v; break;
    case 1: d.agent_y[b] = v; break;
    case 2: d.agent_dir[b] = v; break;
    case 3: d.carrying_obj[b] = u8; break;
    case 4: d.carrying_color[b] = u8; break;
    case 5: d.carrying_contains_obj[b] = u8; break;
    case 6: d.carrying_contains_color[b] = u8; break;
    case 7: d.carrying_marks[b] = v; break;
    case 8: d.step_count[b] = v; break;
    case 9: d.terminated[b] = u8; break;
    case 10: d.truncated[b] = u8; break;
    default: break;
  }
}

// One lane's step (parallel/lanes.py:step_lanes, rule for rule).  Sets the
// lane's done, terminated and won flags; a done lane stores only its reset
// count, and sets ``round``, the pool's round its fresh layout comes from.
__device__ __forceinline__ void step_lane(const StepArgs& a, int b, bool& done, bool& term,
                                          bool& win, int& round) {
  const LaneFields& s = a.cur;
  const int B = a.B, W = a.W, H = a.H;
  const bool boxes = !(a.flags & kNoBoxes), marks = !(a.flags & kNoMarks);
  const int64_t at_t = *a.t * a.action_row + b;
  const int action = a.action_bytes == 8
                         ? static_cast<int>(static_cast<const int64_t*>(a.actions)[at_t])
                         : static_cast<const int32_t*>(a.actions)[at_t];

  const int ax = s.agent_x[b], ay = s.agent_y[b], dir = s.agent_dir[b];
  const int step_count = s.step_count[b] + 1;
  const int dx = dir == 0 ? 1 : (dir == 2 ? -1 : 0);
  const int dy = dir == 1 ? 1 : (dir == 3 ? -1 : 0);
  const int fx = ax + dx, fy = ay + dy;
  const bool inb = fx >= 0 && fx < W && fy >= 0 && fy < H;
  const int64_t at = (int64_t(fy) * W + fx) * B + b;  // read and written only in bounds

  // The front cell; out of bounds a wall with nothing in it.
  uint32_t fwd_obj = kObjWall, fwd_color = 0, fwd_state = 0;
  uint32_t fwd_contains = kObjEmpty, fwd_contains_color = 0;
  int32_t fwd_marks = 0;
  if (inb) {
    fwd_obj = s.grid_obj[at];
    fwd_color = s.grid_color[at];
    fwd_state = s.grid_state[at];
    if (boxes) {
      fwd_contains = s.contains_obj[at];
      fwd_contains_color = s.contains_color[at];
    }
    if (marks) fwd_marks = s.marks[at];
  }

  const bool is_left = action == kActLeft, is_right = action == kActRight;
  const bool is_forward = action == kActForward, is_pickup = action == kActPickup;
  const bool is_drop = action == kActDrop, is_toggle = action == kActToggle;
  const int new_dir = is_left ? mod4(dir + 3) : (is_right ? mod4(dir + 1) : dir);

  const bool fwd_is_empty = fwd_obj == kObjEmpty;
  const bool fwd_is_door = fwd_obj == kObjDoor;
  const bool can_enter = fwd_is_empty || fwd_obj == kObjFloor || fwd_obj == kObjGoal ||
                         fwd_obj == kObjLava || (fwd_is_door && fwd_state == kStateOpen);
  const bool moved = is_forward && can_enter && inb;
  const bool hit_goal = is_forward && fwd_obj == kObjGoal;
  term = hit_goal || (is_forward && fwd_obj == kObjLava);
  // ops/step.py:success_reward: 1 - 0.9 * (step_count / max_steps) in
  // float32, each operation rounded to nearest.
  const float reward =
      hit_goal ? __fsub_rn(1.0f, __fmul_rn(static_cast<float>(0.9),
                                           __fdiv_rn(static_cast<float>(step_count),
                                                     static_cast<float>(a.max_steps))))
               : 0.0f;

  const uint32_t held = s.carrying_obj[b], held_color = s.carrying_color[b];
  const bool not_carrying = held == kObjEmpty;
  const bool can_pickup = fwd_obj == kObjKey || fwd_obj == kObjBall || fwd_obj == kObjBox;
  const bool do_pickup = is_pickup && can_pickup && not_carrying && inb;
  const bool do_drop = is_drop && fwd_is_empty && !not_carrying && inb;
  const bool key_matches = held == kObjKey && held_color == fwd_color;
  const bool do_unlock = is_toggle && fwd_is_door && fwd_state == kStateLocked && key_matches;
  const bool do_flip = is_toggle && fwd_is_door && fwd_state != kStateLocked;
  const bool do_open_box = is_toggle && fwd_obj == kObjBox && inb;

  const bool trunc = step_count >= a.max_steps;
  done = term || trunc;
  win = term && reward > 0.0f;
  a.reward[b] = reward;

  if (done) {
    // _select_pool / _select_lanes: the lane takes its fresh layout (the
    // warp copies it), the pool's round reset_count % R after this reset.
    const int resets = a.reset_count[b] + 1;
    a.reset_count[b] = resets;
    round = resets % a.rounds;
    return;
  }

  // The front cell, where the action changed it (in bounds: a door flips
  // only in bounds, as out of bounds the front is a wall).
  if (do_pickup || do_drop || do_open_box || do_unlock || do_flip) {
    const uint32_t new_door_state =
        do_unlock ? kStateOpen : (fwd_state == kStateOpen ? kStateClosed : kStateOpen);
    const uint32_t held_contains = s.carrying_contains_obj[b];
    const uint32_t held_contains_color = s.carrying_contains_color[b];
    uint32_t obj, color, state, contains, contains_color;
    int32_t mark;
    if (do_pickup) {
      obj = kObjEmpty, color = 0, state = 0, contains = kObjEmpty, contains_color = 0, mark = 0;
    } else if (do_drop) {
      obj = held, color = held_color, state = 0, contains = held_contains,
      contains_color = held_contains_color, mark = s.carrying_marks[b];
    } else if (do_open_box) {
      obj = fwd_contains, color = fwd_contains_color, state = 0, contains = kObjEmpty,
      contains_color = 0, mark = 0;
    } else {
      obj = fwd_obj, color = fwd_color, state = new_door_state, contains = fwd_contains,
      contains_color = fwd_contains_color, mark = fwd_marks;
    }
    s.grid_obj[at] = static_cast<uint8_t>(obj);
    s.grid_color[at] = static_cast<uint8_t>(color);
    s.grid_state[at] = static_cast<uint8_t>(state);
    if (boxes) {
      s.contains_obj[at] = static_cast<uint8_t>(contains);
      s.contains_color[at] = static_cast<uint8_t>(contains_color);
    }
    if (marks) s.marks[at] = mark;
  }
  if (do_pickup) {
    s.carrying_obj[b] = static_cast<uint8_t>(fwd_obj);
    s.carrying_color[b] = static_cast<uint8_t>(fwd_color);
    s.carrying_contains_obj[b] = static_cast<uint8_t>(fwd_contains);
    s.carrying_contains_color[b] = static_cast<uint8_t>(fwd_contains_color);
    s.carrying_marks[b] = fwd_marks;
  } else if (do_drop) {
    s.carrying_obj[b] = kObjEmpty;
    s.carrying_color[b] = 0;
    s.carrying_contains_obj[b] = kObjEmpty;
    s.carrying_contains_color[b] = 0;
    s.carrying_marks[b] = 0;
  }
  if (moved) {
    s.agent_x[b] = fx;
    s.agent_y[b] = fy;
  }
  s.agent_dir[b] = new_dir;
  s.step_count[b] = step_count;
  s.terminated[b] = 0;  // not done: neither terminated nor truncated
  s.truncated[b] = 0;
}

template <bool kBF>
__global__ void __launch_bounds__(kLanes) step_kernel(const StepArgs a) {
  const int b = blockIdx.x * kLanes + threadIdx.x;
  const int lane = threadIdx.x % 32;
  bool done = false, term = false, win = false;
  int round = 0;
  if (b < a.B) step_lane(a, b, done, term, win, round);
  // The warp's done lanes, one at a time, each copied by all 32 threads.
  for (unsigned pending = __ballot_sync(0xffffffffu, done); pending; pending &= pending - 1) {
    const int src = __ffs(pending) - 1;
    reset_lane<kBF>(a, b - lane + src, __shfl_sync(0xffffffffu, round, src), lane);
  }
  const int n_done = __syncthreads_count(done);
  const int n_term = __syncthreads_count(term);
  const int n_win = __syncthreads_count(win);
  if (threadIdx.x == 0) {
    const int64_t t = *a.t;
    auto add = [t](int64_t* slots, int n) {
      using u64 = unsigned long long;
      if (n) atomicAdd(reinterpret_cast<u64*>(slots + t), static_cast<u64>(n));
    };
    add(a.dones, n_done);
    add(a.ends, n_term);
    add(a.wins, n_win);
  }
}

}  // namespace

// Steps B lanes once on `stream`, in place (see the top of this file; the
// pointers and sizes in *args, all on the card).  Returns the launch's
// cudaError_t (0 = ok).
extern "C" int step_lanes_launch(const StepArgs* args, void* stream) {
  const StepArgs& a = *args;
  if (a.B < 0 || a.H < 1 || a.W < 1 || a.rounds < 1 || a.n_aux < 0 || a.n_mission < 0 ||
      (a.action_bytes != 4 && a.action_bytes != 8)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int blocks = (a.B + kLanes - 1) / kLanes;
  if (a.flags & kBatchFirst) {
    step_kernel<true><<<blocks, kLanes, 0, s>>>(a);
  } else {
    step_kernel<false><<<blocks, kLanes, 0, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

// sizeof(StepArgs), which the caller's mirror of it must match.
extern "C" int step_args_bytes() { return static_cast<int>(sizeof(StepArgs)); }
