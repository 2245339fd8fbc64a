// Batched value iteration over the key-position DP domain
// (dp/tabular_key.py): states (key-loc k, door config c, dir d, cell) with
// k in {cell 0..HW-1, CARRIED = HW} and c a bitmask of opened doors.
//
// Replaces minigrid_dynamicprogramming_tpu/dp/pallas_vi.py:_key_vi_kernel.
// Within 1e-6 of the plain version, dp/tabular_key.py:key_vi_values (the
// terminals are applied after the max, which is exact because they pay 1
// and every discounted branch is below 1).
//
// What bounds it on an H100: the memory traffic of V, not arithmetic.  V per
// DoorKey-8x8 layout is K*C*4*HW floats = 133 KB, so a double buffer does
// not fit the 227 KB of shared memory a block may use.  This first version
// keeps the double buffer in device memory (out and a scratch buffer that
// the wrapper allocates), one thread block per layout with the sweep loop
// inside and a barrier between sweeps; a layout's two buffers (266 KB) stay
// in L1/L2 while its block runs.  The TPU kernel's dense (4, K, HW) one-hot
// key-front and drop masks become index predicates computed here, and its
// f32 masks become bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// cell_flags bits, per (d, cell):
constexpr uint8_t kGoalFront = 1;    // the front cell is the goal
constexpr uint8_t kLavaFront = 2;    // the front cell is lava
constexpr uint8_t kTargetFront = 4;  // the front cell holds the target
constexpr uint8_t kDropFront = 8;    // the key may be dropped in front
// cfg_flags bits, per (c, d, cell):
constexpr uint8_t kWalkFront = 1;    // in bounds, walkable, door open
constexpr uint8_t kClosedFront = 2;  // faces a closed door
constexpr uint8_t kUnlockFront = 4;  // faces a locked door the key opens
constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
key_vi_kernel(const uint8_t* __restrict__ cell_flags,  // (B, 4, HW)
              const uint8_t* __restrict__ cfg_flags,   // (B, C, 4, HW)
              const uint8_t* __restrict__ door_bit,    // (B, 4, HW) front door's bit
              float* v_out,      // (B, K, C, 4, HW)
              float* v_scratch,  // (B, K, C, 4, HW)
              int C, int H, int W, float gamma, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int HW = H * W;
  const int CARRIED = HW;
  const int slab = 4 * HW;      // states per (k, c)
  const int kslab = C * slab;   // states per k
  const int S = (HW + 1) * kslab;
  uint8_t* s_cell = smem;
  uint8_t* s_cfg = s_cell + slab;
  uint8_t* s_bit = s_cfg + kslab;

  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    s_cell[i] = cell_flags[b * slab + i];
    s_bit[i] = door_bit[b * slab + i];
  }
  for (int i = threadIdx.x; i < kslab; i += blockDim.x) {
    s_cfg[i] = cfg_flags[b * kslab + i];
  }
  // Start in the buffer that makes the last sweep land in v_out.
  float* cur = ((n_sweeps & 1) ? v_scratch : v_out) + b * S;
  float* nxt = ((n_sweeps & 1) ? v_out : v_scratch) + b * S;
  for (int i = threadIdx.x; i < S; i += blockDim.x) cur[i] = 0.f;
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int cell = s % HW;
      const int d = (s / HW) & 3;
      const int kc = s / slab;
      const int c = kc % C;
      const int k = kc / C;
      const int x = cell % W + (d == 0 ? 1 : d == 2 ? -1 : 0);
      const int y = cell / W + (d == 1 ? 1 : d == 3 ? -1 : 0);
      const int front = (x >= 0 && x < W && y >= 0 && y < H) ? y * W + x : -1;
      const int dh = d * HW + cell;
      const float* vkc = cur + kc * slab;
      const uint8_t f = s_cell[dh];
      const uint8_t g = s_cfg[c * slab + dh];
      // stay (done, failed actions) and left/right.
      float q = fmaxf(vkc[dh], fmaxf(vkc[((d + 3) & 3) * HW + cell],
                                     vkc[((d + 1) & 3) * HW + cell]));
      // forward: blocked by the key lying in front; lava is worth 0.
      if ((g & kWalkFront) && k != front && !(f & kLavaFront)) {
        q = fmaxf(q, vkc[d * HW + front]);
      }
      // pickup: the key in front moves to the CARRIED row.
      if (k == front) q = fmaxf(q, cur[CARRIED * kslab + c * slab + dh]);
      // drop: the carried key lands on the front cell.
      if (k == CARRIED && (f & kDropFront)) {
        q = fmaxf(q, cur[front * kslab + c * slab + dh]);
      }
      // toggle: a closed door always opens, a locked one only if carried.
      if ((g & kClosedFront) || ((g & kUnlockFront) && k == CARRIED)) {
        q = fmaxf(q, cur[k * kslab + (c | s_bit[dh]) * slab + dh]);
      }
      q = gamma * q;
      // terminals: stepping onto the goal, picking up the target.
      if ((f & kGoalFront) || ((f & kTargetFront) && k != CARRIED)) q = 1.f;
      nxt[s] = q;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

}  // namespace

extern "C" size_t key_vi_shared_bytes(int C, int HW) {
  return static_cast<size_t>(C + 2) * 4 * HW;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int key_vi_launch(const void* cell_flags, const void* cfg_flags,
                             const void* door_bit, void* v_out,
                             void* v_scratch, int B, int C, int H, int W,
                             float gamma, int n_sweeps, void* stream) {
  const size_t smem = key_vi_shared_bytes(C, H * W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        key_vi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0) return 0;
  key_vi_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cell_flags),
      static_cast<const uint8_t*>(cfg_flags),
      static_cast<const uint8_t*>(door_bit), static_cast<float*>(v_out),
      static_cast<float*>(v_scratch), C, H, W, gamma, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}
