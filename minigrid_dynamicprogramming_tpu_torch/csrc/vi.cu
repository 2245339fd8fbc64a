// Batched value iteration over the restricted DP domain (dp/tabular.py):
// states (config c, dir d, cell), config = carry bit + 3-state door digits.
//
// Replaces minigrid_dynamicprogramming_tpu/dp/pallas_vi.py:_vi_kernel (the
// VMEM-resident Pallas kernel).  Equal bit for bit to the plain version,
// dp/tabular.py:vi_values: gamma * max(x_i) == max(gamma * x_i) exactly,
// because rounding a product is monotone.
//
// What bounds it on an H100: operations.  Per layout V is C*4*H*W floats
// (6 KB for DoorKey-8x8 at one door, 18 KB at two), so it lives in shared
// memory for every sweep, double-buffered, and device memory is touched
// only to load the per-layout masks and store V once.  One thread block
// per layout; its threads loop over the states with a barrier between
// sweeps.  The TPU kernel's dense (C, C, 4, HW) f32 toggle table becomes a
// per-(config, door slot) index lookup (the toggle sum was one-hot), and
// the f32 masks become bytes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint8_t kGoalFront = 1;  // the front cell is the goal
constexpr uint8_t kLavaFront = 2;  // the front cell is lava
constexpr uint8_t kKeyFront = 4;   // the front cell holds the key
constexpr int kThreads = 256;

// Raster offset of the front cell for direction d (0 +x, 1 +y, 2 -x, 3 -y).
__device__ __forceinline__ int front_step(int d, int W) {
  return d == 0 ? 1 : d == 1 ? W : d == 2 ? -1 : -W;
}

__global__ void __launch_bounds__(kThreads)
vi_kernel(const uint8_t* __restrict__ walk_front,  // (B, C, 4, HW) 0/1
          const uint8_t* __restrict__ cell_flags,  // (B, 4, HW) k*Front bits
          const int8_t* __restrict__ door_slot,    // (B, 4, HW) front slot, -1
          const int32_t* __restrict__ toggle_cfg,  // (B, C, D)
          float* __restrict__ v_out,               // (B, C, 4, HW)
          int C, int D, int HW, int W, float gamma, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = C * 4 * HW;  // states per layout
  const int slab = 4 * HW;   // states per config
  float* cur = reinterpret_cast<float*>(smem);
  float* nxt = cur + S;
  int32_t* s_tog = reinterpret_cast<int32_t*>(nxt + S);
  uint8_t* s_walk = reinterpret_cast<uint8_t*>(s_tog + C * D);
  uint8_t* s_flags = s_walk + S;
  int8_t* s_slot = reinterpret_cast<int8_t*>(s_flags + slab);

  const size_t b = blockIdx.x;
  for (int i = threadIdx.x; i < S; i += blockDim.x) {
    cur[i] = 0.f;
    s_walk[i] = walk_front[b * S + i];
  }
  for (int i = threadIdx.x; i < slab; i += blockDim.x) {
    s_flags[i] = cell_flags[b * slab + i];
    s_slot[i] = door_slot[b * slab + i];
  }
  for (int i = threadIdx.x; i < C * D; i += blockDim.x) {
    s_tog[i] = toggle_cfg[b * C * D + i];
  }
  __syncthreads();

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const int cell = s % HW;
      const int d = (s / HW) & 3;
      const int c = s / slab;
      const int dh = d * HW + cell;  // (d, cell) within a config's slab
      const float* vc = cur + c * slab;
      const float v_cd = vc[dh];
      const uint8_t f = s_flags[dh];
      // stay (drop/done) and left/right.
      float q = fmaxf(v_cd, fmaxf(vc[((d + 3) & 3) * HW + cell],
                                  vc[((d + 1) & 3) * HW + cell]));
      // forward: a walkable front cell is always in bounds; lava is worth 0.
      if (s_walk[s] && !(f & kLavaFront)) q = fmaxf(q, vc[dh + front_step(d, W)]);
      // pickup: carry bit 0 -> 1 when facing the key.
      if (!(c & 1) && (f & kKeyFront)) q = fmaxf(q, cur[(c + 1) * slab + dh]);
      // toggle: the config after toggling the faced door.
      const int slot = s_slot[dh];
      if (slot >= 0) q = fmaxf(q, cur[s_tog[c * D + slot] * slab + dh]);
      // one discounted step; stepping onto the goal pays 1 and ends.
      nxt[s] = (f & kGoalFront) ? 1.f : gamma * q;
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
  for (int i = threadIdx.x; i < S; i += blockDim.x) v_out[b * S + i] = cur[i];
}

}  // namespace

extern "C" size_t vi_shared_bytes(int C, int D, int HW) {
  const size_t S = static_cast<size_t>(C) * 4 * HW;
  return 2 * S * sizeof(float) + C * D * sizeof(int32_t) + S + 2 * 4 * HW;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int vi_launch(const void* walk_front, const void* cell_flags,
                         const void* door_slot, const void* toggle_cfg,
                         void* v_out, int B, int C, int D, int H, int W,
                         float gamma, int n_sweeps, void* stream) {
  const int HW = H * W;
  const size_t smem = vi_shared_bytes(C, D, HW);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        vi_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0) return 0;
  vi_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(walk_front),
      static_cast<const uint8_t*>(cell_flags),
      static_cast<const int8_t*>(door_slot),
      static_cast<const int32_t*>(toggle_cfg), static_cast<float*>(v_out), C,
      D, HW, W, gamma, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}
