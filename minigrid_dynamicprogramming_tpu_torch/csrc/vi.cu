// Batched value iteration over the restricted DP domain (dp/tabular.py):
// states (config c, dir d, cell), config = carry bit + 3-state door digits.
//
// Replaces minigrid_dynamicprogramming_tpu/dp/pallas_vi.py:_vi_kernel (the
// VMEM-resident Pallas kernel).  Equal bit for bit to the plain version,
// dp/tabular.py:vi_values: gamma * max(x_i) == max(gamma * x_i) exactly,
// because rounding a product is monotone.
//
// What bounds it on an H100: instructions.  Per layout V is C*4*H*W floats
// (6 KB for DoorKey-8x8 at one door, 18 KB at two), so it lives in shared
// memory for every sweep, double-buffered, and device memory is touched
// only to load the per-layout masks and store V once.  What is left is the
// instruction stream of the sweep, so the design keeps it short:
//
// * Each thread owns one cell of one layout, with all four directions,
//   and a fixed share of the configs (the carry pairs p = g, g + G, ...
//   of its group g), for the whole run.  A block holds `lpb` layouts of
//   G * HW threads each; the wrapper picks lpb and G (dp/cuda_vi.py:
//   vi_plan).  Stay, left and right of all four directions come from the
//   four values the thread loads for its cell, so a state update reads
//   about two floats of shared memory (its own and the front cell's).
// * Everything that depends on the cell alone is computed once, before
//   the first sweep, and kept in registers: the goal and key flags, the
//   door slot in front, and walkability for every config as one bit mask
//   per direction (lava folded in: forward onto lava is worth 0, so it
//   never wins the max).  A mask holds at most 64 configs (D <= 3); for
//   more, walkability is one byte per state in shared memory, each byte
//   read only by the thread that wrote it.
// * The grid's width and height are template parameters for the DoorKey
//   sizes (5, 6, 8, 16; 0 = given at run time), so every offset from the
//   thread's own state to the states it reads is an immediate of the
//   load: the sweep loop moves one pointer.
// * The sweep loop walks the thread's configs in carry pairs (c even,
//   c + 1): the pickup candidate of c is V at c + 1, which the thread has
//   just loaded.  It has no division and no byte loads; only threads that
//   face a door take the branch that reads the toggle table (C*D int32 in
//   shared memory).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kMaxThreads = 1024;
// cell_flags bits, per (d, cell), as vi_masks packs them:
constexpr uint8_t kGoalFront = 1;  // the front cell is the goal
constexpr uint8_t kLavaFront = 2;  // the front cell is lava
constexpr uint8_t kKeyFront = 4;   // the front cell holds the key

// Walkability per config: kWalkBits = 32 or 64 keeps it as a bit mask in
// registers (C <= kWalkBits), 0 as bytes in shared memory (any C).
int walk_bits(int C) { return C <= 32 ? 32 : C <= 64 ? 64 : 0; }

// A block's shared memory: two V buffers and the toggle table for each of
// its lpb layouts, then their walkability bytes where C > 64.
size_t shared_bytes(int C, int D, int HW, int lpb) {
  const size_t S = static_cast<size_t>(C) * 4 * HW;
  return lpb * (2 * S * sizeof(float) + C * D * sizeof(int32_t) +
                (walk_bits(C) ? 0 : S));
}

// kWalkBits: see walk_bits.  kH, kW: the grid's size, or 0 for sizes given
// at run time.
template <int kWalkBits, int kH, int kW>
__global__ void __launch_bounds__(kMaxThreads)
vi_kernel(const uint8_t* __restrict__ walk_front,  // (B, C, 4, HW) 0/1
          const uint8_t* __restrict__ cell_flags,  // (B, 4, HW) k*Front bits
          const int8_t* __restrict__ door_slot,    // (B, 4, HW) front slot, -1
          const int32_t* __restrict__ toggle_cfg,  // (B, C, D)
          float* __restrict__ v_out,               // (B, C, 4, HW)
          int B, int C, int D, int H_, int W_, int lpb, int G, float gamma,
          int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = kW ? kW : W_;
  const int HW = kW ? kH * kW : H_ * W_;
  const int slab = 4 * HW;  // states per config
  const int S = C * slab;   // states per layout
  // The thread's layout slot, group and cell: divisions here only.
  const int per_layout = G * HW;
  const int l = threadIdx.x / per_layout;
  const int g = (threadIdx.x - l * per_layout) / HW;
  const int cell = threadIdx.x - l * per_layout - g * HW;
  const int b = blockIdx.x * lpb + l;
  const bool active = b < B;
  float* cur = reinterpret_cast<float*>(smem) + l * S;
  float* nxt = cur + lpb * S;
  int32_t* tog0 = reinterpret_cast<int32_t*>(
      reinterpret_cast<float*>(smem) + 2 * lpb * S);
  int32_t* tog = tog0 + l * C * D;
  // Walkability bytes (C, 4, HW) of the layout, where no mask holds C bits.
  uint8_t* s_walk = reinterpret_cast<uint8_t*>(tog0 + lpb * C * D) + l * S;
  using Mask = typename std::conditional<kWalkBits == 64, uint64_t, uint32_t>::type;
  // Offsets from V(c, 0, cell) to V(c, d, cell) and to its front state.
  const int step[4] = {1, W, -1, -W};

  // Per-direction data of the cell.
  int slot[4];
  Mask walk[4];
  bool goal[4], key[4];
  bool door = false;  // the cell faces a door in some direction
  if (active) {
    const size_t mb = static_cast<size_t>(b) * slab + cell;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint8_t f = cell_flags[mb + d * HW];
      goal[d] = f & kGoalFront;
      key[d] = f & kKeyFront;
      slot[d] = door_slot[mb + d * HW];
      door |= slot[d] >= 0;
      const uint8_t* wf = walk_front + static_cast<size_t>(b) * S + d * HW + cell;
      Mask m = 0;
      if (kWalkBits && !(f & kLavaFront)) {
        for (int c = 0; c < C; ++c) {
          if (wf[c * slab]) m |= Mask(1) << c;
        }
      }
      walk[d] = m;
      for (int c = 2 * g; c < C; c += 2 * G) {
        cur[c * slab + d * HW + cell] = 0.f;
        cur[(c + 1) * slab + d * HW + cell] = 0.f;
        if (!kWalkBits) {
          s_walk[c * slab + d * HW + cell] = wf[c * slab] && !(f & kLavaFront);
          s_walk[(c + 1) * slab + d * HW + cell] =
              wf[(c + 1) * slab] && !(f & kLavaFront);
        }
      }
    }
    for (int i = g * HW + cell; i < C * D; i += per_layout) {
      tog[i] = toggle_cfg[static_cast<size_t>(b) * C * D + i];
    }
  }
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    if (active) {
      for (int c = 2 * g; c < C; c += 2 * G) {
        const float* pc = cur + c * slab + cell;  // V(c, 0, cell)
        float* pn = nxt + c * slab + cell;
        float a[4], e[4];  // V at (c, d, cell) and (c + 1, d, cell)
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          a[d] = pc[d * HW];
          e[d] = pc[slab + d * HW];
        }
        const uint8_t* pw = s_walk + c * slab + cell;  // walk(c, 0, cell)
        float q0[4], q1[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const Mask wc = kWalkBits ? walk[d] >> c : 0;
          const bool w0 = kWalkBits ? (wc & 1) != 0 : pw[d * HW] != 0;
          const bool w1 = kWalkBits ? (wc & 2) != 0 : pw[slab + d * HW] != 0;
          // Carry 0 (config c): stay, left, right, forward, pickup.
          q0[d] = fmaxf(a[d], fmaxf(a[(d + 3) & 3], a[(d + 1) & 3]));
          if (w0) q0[d] = fmaxf(q0[d], pc[d * HW + step[d]]);
          if (key[d]) q0[d] = fmaxf(q0[d], e[d]);
          // Carry 1 (config c + 1): the same without pickup.
          q1[d] = fmaxf(e[d], fmaxf(e[(d + 3) & 3], e[(d + 1) & 3]));
          if (w1) q1[d] = fmaxf(q1[d], pc[slab + d * HW + step[d]]);
        }
        if (door) {
          // toggle: the config after toggling the faced door.
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (slot[d] >= 0) {
              q0[d] = fmaxf(q0[d], cur[tog[c * D + slot[d]] * slab + d * HW + cell]);
              q1[d] = fmaxf(q1[d], cur[tog[(c + 1) * D + slot[d]] * slab + d * HW + cell]);
            }
          }
        }
        // One discounted step; stepping onto the goal pays 1 and ends.
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          pn[d * HW] = goal[d] ? 1.f : gamma * q0[d];
          pn[slab + d * HW] = goal[d] ? 1.f : gamma * q1[d];
        }
      }
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  if (active) {
    float* out = v_out + static_cast<size_t>(b) * S;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      for (int c = 2 * g; c < C; c += 2 * G) {
        out[c * slab + d * HW + cell] = cur[c * slab + d * HW + cell];
        out[(c + 1) * slab + d * HW + cell] = cur[(c + 1) * slab + d * HW + cell];
      }
    }
  }
}

template <int kWalkBits, int kH, int kW>
int launch(const void* walk_front, const void* cell_flags,
           const void* door_slot, const void* toggle_cfg, void* v_out, int B,
           int C, int D, int H, int W, int lpb, int G, float gamma,
           int n_sweeps, cudaStream_t stream) {
  const size_t smem = shared_bytes(C, D, H * W, lpb);
  const auto kernel = vi_kernel<kWalkBits, kH, kW>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0) return 0;
  kernel<<<(B + lpb - 1) / lpb, lpb * G * H * W, smem, stream>>>(
      static_cast<const uint8_t*>(walk_front),
      static_cast<const uint8_t*>(cell_flags),
      static_cast<const int8_t*>(door_slot),
      static_cast<const int32_t*>(toggle_cfg), static_cast<float*>(v_out), B,
      C, D, H, W, lpb, G, gamma, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}

// The DoorKey sizes get their own instance; others take sizes at run time.
template <int kWalkBits>
int launch_sized(const void* walk_front, const void* cell_flags,
                 const void* door_slot, const void* toggle_cfg, void* v_out,
                 int B, int C, int D, int H, int W, int lpb, int G,
                 float gamma, int n_sweeps, cudaStream_t stream) {
#define VI_LAUNCH(h, w)                                                     \
  launch<kWalkBits, h, w>(walk_front, cell_flags, door_slot, toggle_cfg, v_out, \
                     B, C, D, H, W, lpb, G, gamma, n_sweeps, stream)
  if (H == W) {
    switch (W) {
      case 5: return VI_LAUNCH(5, 5);
      case 6: return VI_LAUNCH(6, 6);
      case 8: return VI_LAUNCH(8, 8);
      case 16: return VI_LAUNCH(16, 16);
      default: break;
    }
  }
  return VI_LAUNCH(0, 0);
#undef VI_LAUNCH
}

}  // namespace

extern "C" size_t vi_shared_bytes(int C, int D, int HW, int lpb) {
  return shared_bytes(C, D, HW, lpb);
}

// Launches on `stream` with lpb layouts per block and G thread groups per
// layout (lpb * G * H * W <= 1024 threads, G <= C / 2).  Returns the
// cudaError_t of the launch (0 = ok).
extern "C" int vi_launch(const void* walk_front, const void* cell_flags,
                         const void* door_slot, const void* toggle_cfg,
                         void* v_out, int B, int C, int D, int H, int W,
                         int lpb, int G, float gamma, int n_sweeps,
                         void* stream) {
  if (C % 2 || lpb < 1 || G < 1 || 2 * G > C ||
      lpb * G * H * W > kMaxThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
#define VI_LAUNCH_BITS(bits)                                                 \
  launch_sized<bits>(walk_front, cell_flags, door_slot, toggle_cfg, v_out, B, \
                     C, D, H, W, lpb, G, gamma, n_sweeps, s)
  switch (walk_bits(C)) {
    case 32: return VI_LAUNCH_BITS(32);
    case 64: return VI_LAUNCH_BITS(64);
    default: return VI_LAUNCH_BITS(0);
  }
#undef VI_LAUNCH_BITS
}
