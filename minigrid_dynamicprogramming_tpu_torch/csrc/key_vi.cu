// Batched value iteration over the key-position DP domain
// (dp/tabular_key.py): states (key-loc k, door config c, dir d, cell) with
// k in {cell 0..HW-1, CARRIED = HW} and c a bitmask of opened doors.
//
// Replaces minigrid_dynamicprogramming_tpu/dp/pallas_vi.py:_key_vi_kernel.
// Within 1e-6 of the plain version, dp/tabular_key.py:key_vi_values (the
// terminals are applied after the max, which is exact because they pay 1
// and every discounted branch is below 1).
//
// What bounds it on an H100: where V lives.  V per DoorKey-8x8 layout is
// K*C*4*HW floats = 133 KB, so a double buffer does not fit the 227 KB of
// shared memory one block may use, and 512 layouts' buffers (136 MB) do
// not fit the 50 MB L2 either.  Two routes, chosen from the shape alone
// (dp/cuda_vi.py:key_vi_route):
//
// * cluster (key_vi_cluster_kernel): one thread-block cluster of n CTAs
//   per layout.  The K key-location rows of both V buffers are split over
//   the CTAs (the first K % n take one row more), so V stays in shared
//   memory for the whole run and goes to device memory once, at the end.
//   Each thread owns one cell, with all four directions, and a fixed
//   share of the CTA's (config, row) items, those of its group g; its
//   cell's flags stay in registers for the whole run.  Stay, left, right,
//   forward and toggle read the thread's own CTA; only pickup (the
//   CARRIED row, read once per config) and drop (row `front` from the
//   CARRIED row, loaded at the start of the sweep so that its latency
//   hides behind the other rows) may read a peer's shared memory, through
//   distributed shared memory.  The sweep loop of the other rows holds
//   stay, turns, forward and pickup only: the CARRIED row is a loop of
//   its own, and the toggle of a closed door a second pass that only
//   threads facing one run.  The grid's size is a template parameter for
//   the DoorKey sizes, so the offsets to the states a thread reads are
//   immediates.  One cluster barrier per sweep; the last one also ends
//   every remote read before any CTA exits.
// * global (key_vi_global_kernel): V too large for a cluster of 8, e.g.
//   DoorKey-16x16 (2.1 MB per layout).  The double buffer lives in device
//   memory (out and a scratch buffer the wrapper allocates), one block per
//   layout with a barrier between sweeps.
//
// Both compute the TPU kernel's dense (4, K, HW) one-hot key-front and
// drop masks as index predicates, and take its f32 masks as bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

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

constexpr int kGlobalThreads = 512;
constexpr int kCtaThreads = 256;  // threads of a cluster CTA, at most
constexpr int kCtasPerSm = 3;     // resident CTAs the registers must allow

// The cluster route's row split: the first K % n CTAs take one row more.
__device__ int row_begin(int rank, int K, int n) {
  return rank * (K / n) + (rank < K % n ? rank : K % n);
}
__device__ int row_owner(int k, int K, int n) {
  const int q = K / n, rem = K % n;
  return k < rem * (q + 1) ? k / (q + 1) : rem + (k - rem * (q + 1)) / q;
}
// Each of a CTA's two V buffers holds ceil(K / n) key rows; then the
// packed flags.
size_t cluster_shared_bytes(int C, int HW, int n) {
  const int K = HW + 1;
  const size_t rows = (K + n - 1) / n;
  return 2 * rows * C * 4 * HW * sizeof(float) + C * HW * sizeof(uint32_t);
}

// A float of CTA `rank`'s shared memory, at the address `addr` has in this
// CTA's (distributed shared memory: mapa, then ld.shared::cluster, with
// 32-bit addresses in place of the generic 64-bit ones).
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  return remote;
}
__device__ __forceinline__ float load_cluster(uint32_t remote) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote) : "memory");
  return v;
}
__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The loads of one item (k = row0 + j, c) of a row other than CARRIED:
// V(k, c, d, cell) for the four directions, and the candidate that moves
// the agent or the key, per direction: V(k, c, d, front) if the agent can
// step forward, the CARRIED row's value if the key lies in front (pickup;
// then forward is blocked), else 0, which never wins the max (V >= 0).
__device__ __forceinline__ void load_item(const float* pv, int j, uint32_t gc,
                                          const int* fj, const float* pick,
                                          int HW, const int* step, float* v,
                                          float* ahead) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    v[d] = pv[d * HW];
    const bool key_front = j == fj[d];
    ahead[d] = key_front ? pick[d] : 0.f;
    if (((gc >> (8 * d)) & kWalkFront) && !key_front) ahead[d] = pv[d * HW + step[d]];
  }
}

// One CTA of a cluster of n per layout, G * HW threads: (group g, cell) =
// divmod(thread, HW).  The CTA's key rows but CARRIED give the items
// (config c, local row j), in the order c * ngen + j; group g takes items
// g, g + G, ...  The CARRIED row, the last CTA's last, gives group g the
// configs G - 1 - g, 2G - 1 - g, ... (the last groups have the fewest
// other items).  kH, kW: the grid's size, or 0 for sizes given at run
// time.
template <int kH, int kW>
__global__ void __launch_bounds__(kCtaThreads, kCtasPerSm)
key_vi_cluster_kernel(const uint8_t* __restrict__ cell_flags,  // (B, 4, HW)
                      const uint8_t* __restrict__ cfg_flags,   // (B, C, 4, HW)
                      const uint8_t* __restrict__ door_bit,    // (B, 4, HW)
                      float* __restrict__ v_out,  // (B, K, C, 4, HW)
                      int C, int H_, int W_, float gamma, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / n;
  const int H = kH ? kH : H_;
  const int W = kW ? kW : W_;
  const int HW = H * W;
  const int K = HW + 1;
  const int CARRIED = HW;
  const int slab = 4 * HW;     // states per (k, c)
  const int kslab = C * slab;  // states per k
  const int row0 = row_begin(rank, K, n);
  const int nrows = row_begin(rank + 1, K, n) - row0;
  const int mrows = (K + n - 1) / n;  // rows held by every CTA's buffers
  const bool last = rank == n - 1;    // holds CARRIED, as its last row
  const int ngen = nrows - last;      // rows other than CARRIED
  const int car_row = CARRIED - row_begin(n - 1, K, n);
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + mrows * kslab;
  uint32_t* s_cfg = reinterpret_cast<uint32_t*>(buf1 + mrows * kslab);

  // The thread's group and cell: divisions here only, never in a sweep.
  const int G = blockDim.x / HW;
  const int g = threadIdx.x / HW;
  const int cell = threadIdx.x - g * HW;
  // Offsets from V(k, c, 0, cell) to its front state in direction d.
  const int step[4] = {1, W, -1, -W};

  // cfg_flags packed per (c, cell), one byte per direction.
  for (int i = threadIdx.x; i < C * HW; i += blockDim.x) {
    const int c = i / HW;
    const uint8_t* p = cfg_flags + b * kslab + c * slab + (i - c * HW);
    s_cfg[i] = p[0] | p[HW] << 8 | p[2 * HW] << 16 | static_cast<uint32_t>(p[3 * HW]) << 24;
  }
  for (int i = threadIdx.x; i < nrows * kslab; i += blockDim.x) buf0[i] = 0.f;

  // Per-direction data of the cell, kept for the whole run.
  const int x = cell % W, y = cell / W;
  int fj[4];      // the front cell's local row here, or -1 (also off the grid)
  int bit[4];     // config bit of the door in front
  int drop_off[4], drop_rank[4];  // V(front, 0, d, cell): offset, and CTA
  const int c_car = G - 1 - g;    // the group's first CARRIED config
  bool goal[4], term[4], drop[4];
  uint32_t no_lava = ~0u;  // clears a direction's walk bit where lava is in front
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int fx = x + (d == 0 ? 1 : d == 2 ? -1 : 0);
    const int fy = y + (d == 1 ? 1 : d == 3 ? -1 : 0);
    const int fr = (fx >= 0 && fx < W && fy >= 0 && fy < H) ? fy * W + fx : -1;
    fj[d] = fr >= row0 && fr < row0 + ngen ? fr - row0 : -1;
    const uint8_t f = cell_flags[b * slab + d * HW + cell];
    bit[d] = door_bit[b * slab + d * HW + cell];
    goal[d] = f & kGoalFront;
    // Terminal in every row but CARRIED: the goal, or the target picked up.
    term[d] = f & (kGoalFront | kTargetFront);
    drop[d] = (f & kDropFront) && fr >= 0;
    if (f & kLavaFront) no_lava &= ~(static_cast<uint32_t>(kWalkFront) << (8 * d));
    drop_rank[d] = drop[d] ? row_owner(fr, K, n) : 0;
    drop_off[d] = drop[d] ? (fr - row_begin(drop_rank[d], K, n)) * kslab + d * HW + cell : 0;
  }
  cluster.sync();  // zeroed V and the packed flags, in every CTA
  constexpr uint32_t kClosedAll = kClosedFront * 0x01010101u;
  bool closed_any = false;  // the cell faces a closed door in some config
  for (int c = 0; c < C; ++c) closed_any |= (s_cfg[c * HW + cell] & kClosedAll) != 0;

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    float* cur = (sweep & 1) ? buf1 : buf0;
    float* nxt = (sweep & 1) ? buf0 : buf1;
    // drop reads row `front` of another CTA, mostly: the loads for the
    // group's first CARRIED config go out first, and land while the group
    // works through the other rows.
    uint32_t drop_at[4];  // V(front, 0, d, cell) in its CTA
    float dropped[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      drop_at[d] = map_rank(shared_addr(cur + drop_off[d]), drop_rank[d]);
      dropped[d] = last && c_car < C && drop[d]
                       ? load_cluster(drop_at[d] + 4 * c_car * slab) : 0.f;
    }
    // V(CARRIED, 0, 0, cell), on the last CTA.
    const uint32_t car = map_rank(shared_addr(cur + car_row * kslab + cell), n - 1);
    // The rows other than CARRIED: stay, turns, forward and pickup.  j -=
    // ngen carries the group's stride into the next config.
    int j = g;
    for (int c = 0; c < C; ++c, j -= ngen) {
      if (j >= ngen) continue;
      const uint32_t gc = s_cfg[c * HW + cell] & no_lava;
      float pick[4];  // V(CARRIED, c, d, cell), for the row k == front
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        pick[d] = fj[d] >= 0 ? load_cluster(car + 4 * (c * slab + d * HW)) : 0.f;
      }
      const float* pv = cur + j * kslab + c * slab + cell;  // V(k, c, 0, cell)
      float* pn = nxt + j * kslab + c * slab + cell;
      for (; j < ngen; j += G, pv += G * kslab, pn += G * kslab) {
        float v[4], ahead[4];
        load_item(pv, j, gc, fj, pick, HW, step, v, ahead);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          // stay (done, failed actions), left/right, and forward or pickup;
          // terminals: stepping onto the goal, picking up the target.
          const float q = fmaxf(fmaxf(v[d], ahead[d]), fmaxf(v[(d + 3) & 3], v[(d + 1) & 3]));
          pn[d * HW] = term[d] ? 1.f : gamma * q;
        }
      }
    }
    if (last) {
      // The CARRIED row: no pickup and no target; drop and unlock.
      for (int c = c_car; c < C; c += G) {
        const uint32_t gc = s_cfg[c * HW + cell] & no_lava;
        const float* pv = cur + ngen * kslab + c * slab + cell;
        float v[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) v[d] = pv[d * HW];
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          const uint32_t gd = gc >> (8 * d);
          float q = fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3]));
          if (gd & kWalkFront) q = fmaxf(q, pv[d * HW + step[d]]);
          if (gd & (kClosedFront | kUnlockFront)) {
            q = fmaxf(q, pv[((c | bit[d]) - c) * slab + d * HW]);
          }
          // drop: the carried key lands on the front cell, row `front`.
          if (drop[d]) {
            q = fmaxf(q, c == c_car ? dropped[d] : load_cluster(drop_at[d] + 4 * c * slab));
          }
          nxt[ngen * kslab + c * slab + d * HW + cell] = goal[d] ? 1.f : gamma * q;
        }
      }
    }
    if (closed_any) {
      // toggle of a closed door, in the rows other than CARRIED:
      // max(V', gamma * V(c | bit)), which equals the toggle inside the
      // max because rounding gamma * x is monotone.
      j = g;
      for (int c = 0; c < C; ++c, j -= ngen) {
        const uint32_t gc = s_cfg[c * HW + cell];
        for (; j < ngen; j += G) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (((gc >> (8 * d)) & kClosedFront) && !term[d]) {
              const int s = j * kslab + c * slab + d * HW + cell;
              nxt[s] = fmaxf(nxt[s], gamma * cur[s + ((c | bit[d]) - c) * slab]);
            }
          }
        }
      }
    }
    // Every CTA's nxt is complete before any reads it as cur; the last
    // barrier also ends every remote read before any CTA exits.
    cluster.sync();
  }
  const float* fin = (n_sweeps & 1) ? buf1 : buf0;
  float* out = v_out + (b * K + row0) * kslab;
  for (int i = threadIdx.x; i < nrows * kslab; i += blockDim.x) out[i] = fin[i];
}

__global__ void __launch_bounds__(kGlobalThreads)
key_vi_global_kernel(const uint8_t* __restrict__ cell_flags,  // (B, 4, HW)
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

// The DoorKey sizes that fit a cluster get their own instance; others take
// sizes at run time.
using ClusterKernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*,
                               float*, int, int, int, float, int);
ClusterKernel cluster_kernel(int H, int W) {
  if (H == W && W == 5) return key_vi_cluster_kernel<5, 5>;
  if (H == W && W == 6) return key_vi_cluster_kernel<6, 6>;
  if (H == W && W == 8) return key_vi_cluster_kernel<8, 8>;
  return key_vi_cluster_kernel<0, 0>;
}

cudaLaunchConfig_t cluster_config(int B, int HW, int n, int G, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * n);
  cfg.blockDim = dim3(G * HW);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace

// --- cluster route ---------------------------------------------------------

// A CTA's shared memory, for the wrapper's and the tests' checks.
extern "C" size_t key_vi_cluster_shared_bytes(int C, int HW, int n) {
  return cluster_shared_bytes(C, HW, n);
}

// How many clusters of n CTAs of G * H * W threads can be resident at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
extern "C" int key_vi_cluster_occupancy(int C, int H, int W, int n, int G) {
  const size_t smem = cluster_shared_bytes(C, H * W, n);
  const auto kernel = cluster_kernel(H, W);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n, H * W, n, G, smem, 0, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// Launches on `stream` with clusters of n CTAs (1 <= n <= 8, n <= K) of
// G * H * W <= 256 threads; returns the cudaError_t of the launch (0 = ok).
extern "C" int key_vi_cluster_launch(const void* cell_flags,
                                     const void* cfg_flags,
                                     const void* door_bit, void* v_out, int B,
                                     int C, int H, int W, int n, int G,
                                     float gamma, int n_sweeps, void* stream) {
  const int HW = H * W;
  if (n < 1 || n > 8 || n > HW + 1 || G < 1 || G * HW > kCtaThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = cluster_shared_bytes(C, HW, n);
  const auto kernel = cluster_kernel(H, W);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(
      B, HW, n, G, smem, static_cast<cudaStream_t>(stream), &attr);
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(cell_flags),
      static_cast<const uint8_t*>(cfg_flags),
      static_cast<const uint8_t*>(door_bit), static_cast<float*>(v_out), C, H,
      W, gamma, n_sweeps));
}

// --- global route ----------------------------------------------------------

extern "C" size_t key_vi_global_shared_bytes(int C, int HW) {
  return static_cast<size_t>(C + 2) * 4 * HW;
}

// Launches on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int key_vi_global_launch(const void* cell_flags,
                                    const void* cfg_flags,
                                    const void* door_bit, void* v_out,
                                    void* v_scratch, int B, int C, int H,
                                    int W, float gamma, int n_sweeps,
                                    void* stream) {
  const size_t smem = key_vi_global_shared_bytes(C, H * W);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        key_vi_global_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (B == 0) return 0;
  key_vi_global_kernel<<<B, kGlobalThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(cell_flags),
      static_cast<const uint8_t*>(cfg_flags),
      static_cast<const uint8_t*>(door_bit), static_cast<float*>(v_out),
      static_cast<float*>(v_scratch), C, H, W, gamma, n_sweeps);
  return static_cast<int>(cudaGetLastError());
}
