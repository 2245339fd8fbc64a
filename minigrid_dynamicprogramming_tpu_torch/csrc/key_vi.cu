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
// not fit the 50 MB L2 either.  Three routes, chosen from the shape alone
// (dp/cuda_vi.py:key_vi_route):
//
// * cluster (key_vi_cluster_kernel): one thread-block cluster of n <= 8
//   CTAs per layout.  The K key-location rows of both V buffers are split
//   over the CTAs (the first K % n take one row more), so V stays in shared
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
//   every remote read before any CTA exits.  Three CTAs an SM.
// * wide (key_vi_wide_kernel): V too large for a cluster of 8 but not for
//   one of 16 (above the portable limit, so the kernel allows a
//   non-portable cluster size), e.g. KeyCorridorS3R2 at six door slots
//   (1.29 MB a layout) and DoorKey-16x16 (2.11 MB).  One CTA an SM, so a
//   CTA takes up to 1024 threads, G groups of HW, to keep warps in flight
//   through the shared-memory latency.  Scattered 4-byte remote
//   (distributed shared memory) loads proved slow at this size: they queue
//   at the one SM that holds the CARRIED row, and the thread waits for
//   each.  So this route reads nothing remotely; all it sends are stores,
//   which do not stall the thread:
//   - the HW rows other than CARRIED are split over the first n - 1 CTAs
//     (the first HW % (n - 1) take one more); the last CTA, the hub, holds
//     the CARRIED row alone, in one of its buffers' row slots;
//   - pickup: the hub sends each new V(CARRIED, c, d, cell) (two configs
//     in one store) to the CTA that owns row front(cell, d), into a table
//     of 4 * C values per row, read there in the next sweep;
//   - drop: a CTA sends each new V(k, c, d, cell) whose cell faces k and
//     may take the key to the hub's drop table (another of its row slots),
//     read there in the next sweep;
//   both tables are double-buffered by sweep parity.  A CTA walks its
//   (row, config) items config-major, item i = c * rows + j, in rounds of
//   G: group g takes item r * G + g in round r.  A round's common path
//   is stay, turns and forward; the rare candidates (the key in front,
//   taken from the pickup table, and a closed door in front) and the drop
//   store sit behind one bit test of the thread's key rows and one mask
//   test of the config's flags.  Where the double buffer
//   fits (KeyCorridorS3R2) each round writes the next buffer.  Where it
//   does not (DoorKey-16x16), V is swept in place, and that is still the
//   Jacobi update: every read sees the previous sweep's value, because
//   - the hub's CARRIED row and drop table each take two row slots,
//     swapped every sweep, and the hub reads only its own slots;
//   - a round holds its G items' new values in registers, then a CTA
//     barrier, then writes them.  An item reads its own slab (stay,
//     turns, forward), its CTA's pickup table and, for a closed door,
//     slab (k, c | bit) of the same row, whose index is never below its
//     own.  So a round reads no slab that an earlier round wrote, and its
//     own reads end at its barrier before its writes;
//   - one cluster barrier ends the sweep: the tables sent in a sweep are
//     complete before the next reads them, and a table is written again
//     only after the sweep that read it has ended.
//   dp/cuda_vi.py mirrors this plan and tests/test_torch_cuda_vi.py checks
//   that no read sees a value written in the same sweep.
// * grid (key_vi_grid_resident_kernel, key_vi_grid_streamed_kernel): V too
//   large for a cluster of 16, e.g. DoorKey-16x16 at two door slots (4.2
//   MB a layout), KeyCorridorS3R3 at seven (5.0 MB), DoorKey-8x8 at seven
//   (8.5 MB), 19x19 grids, LockedRoom (134 MB).  A layout is split over n
//   CTAs, one an SM, that are not a cluster: they exchange values through
//   device memory.  The launch is persistent and cooperative: the resident
//   CTAs form groups of n, and group q walks layouts q, q + groups, ...
//   (a cooperative launch fails, rather than deadlocks, where the grid is
//   more than the card can hold at once).  One barrier a sweep, over the
//   group's n CTAs only: an arrival counter per group in device memory
//   (the wrapper zeroes it for each launch); a CTA's threads meet at a CTA
//   barrier, then one thread releases their writes with its arrival
//   (fence.acq_rel.gpu, then a relaxed add) and spins on an acquire load
//   until the counter reaches n times the barriers so far, as CUTLASS's
//   GenericBarrier does, and the threads meet again.  So every write of a
//   sweep is seen by every CTA of the group after the barrier; a value
//   another CTA wrote is read with ld.global.cg besides (L2, never an L1
//   line).  Two modes, from the shape alone:
//   - resident, where a CTA can hold at least one key row (all C configs)
//     and the packed flags, and the K rows need at most 128 CTAs: the rows
//     are split over the n CTAs (the first K % n take one more; CARRIED is
//     the last CTA's last row) and stay in its shared memory for every
//     sweep of a layout, going to v_out once at the end.  A CTA walks its
//     (row, config) items config-major in rounds of G, as the wide route
//     does, the CARRIED row among them.  Pickups and drops go through two
//     tables in device memory per group, each (C, 4, HW) floats and
//     double-buffered by sweep parity, so they stay in L2: the CARRIED
//     row's items write each new V(CARRIED, c, d, cell) to the pickup
//     table, read in the next sweep by the item of row front(cell, d); an
//     item of row k writes each new V(k, c, d, cell) whose cell faces k and
//     may drop the key there to the drop table, read in the next sweep by
//     the CARRIED row.  V is swept in place (a double buffer would halve
//     the rows a CTA holds and about double n, so fewer layouts a wave),
//     and that is still the Jacobi update, for the wide route's reason: an
//     item reads its own slab, its own row's slab (k, c | bit) of no lower
//     index, and the tables of the previous sweep; a round holds its new
//     values in registers until a CTA barrier has ended its reads.  A
//     thread loads the table values of its next round's item during the
//     current round, so that their trip to L2 does not stall each round.
//     The first sweep reads no table: V starts at 0, and 0 never wins the
//     max.
//   - streamed, where a row does not fit (KeyCorridorS4R3 and larger at
//     seven door slots, LockedRoom): V double-buffered in device memory,
//     v_out and one scratch layout per group, so that the last sweep lands
//     in v_out; each layout's K * C (row, config) slabs split over the n
//     CTAs.  Each thread keeps its cell's flags in registers, loops over
//     its slabs and decodes each slab's (k, c) once: no division per state.
//     A slab issues the loads of all its candidates before it uses any (a
//     candidate the state lacks is 0), so it waits for one trip to memory;
//     two slabs at a time would spill registers.  The first sweep reads
//     nothing.
//   dp/cuda_vi.py mirrors both plans and tests/test_torch_cuda_vi.py checks
//   them, as for the wide route.
//
// All of them compute the TPU kernel's dense (4, K, HW) one-hot key-front
// and drop masks as index predicates, and take its f32 masks as bytes.

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

constexpr int kCtaThreads = 256;  // threads of a cluster CTA, at most
constexpr int kCtasPerSm = 3;     // resident CTAs the registers must allow
constexpr int kWideThreads = 1024;  // threads of a wide CTA, at most
constexpr int kWideCluster = 16;    // CTAs of a wide cluster, at most
constexpr int kWideRows = 32;       // rows of a wide CTA, at most (a bit each)
constexpr int kGridThreads = 1024;  // threads of a grid CTA, at most
constexpr int kGridRows = 32;       // rows of a resident grid CTA, at most (a bit each)
constexpr uint32_t kClosedAnyDir = kClosedFront * 0x01010101u;

// The row split of the cluster route (K rows over n CTAs) and of the wide
// route (HW rows over n - 1): the first K % n CTAs take one row more.
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
// The wide route: ceil(HW / (n - 1)) row slots (at least 2, in place 4,
// for the hub's CARRIED row and drop table), twice or, in place, once;
// the packed flags; two pickup tables of 4 * C floats a row.
__host__ __device__ int wide_slots(int HW, int n, bool in_place) {
  const int rows = (HW + n - 2) / (n - 1);
  return rows > (in_place ? 4 : 2) ? rows : (in_place ? 4 : 2);
}
size_t wide_shared_bytes(int C, int HW, int n, bool in_place) {
  const size_t rows = (HW + n - 2) / (n - 1);
  return (in_place ? 1 : 2) * static_cast<size_t>(wide_slots(HW, n, in_place)) * C * 4 * HW *
             sizeof(float) +
         C * HW * sizeof(uint32_t) + 2 * rows * 4 * C * sizeof(float);
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
__device__ __forceinline__ void store_cluster(uint32_t remote, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;" :: "r"(remote), "f"(v) : "memory");
}
__device__ __forceinline__ void store_cluster2(uint32_t remote, float a, float b) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" :: "r"(remote), "f"(a), "f"(b)
               : "memory");
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

// The config bit of the door in direction d, byte d of `bits`.
__device__ __forceinline__ int door(uint32_t bits, int d) {
  return static_cast<int>((bits >> (8 * d)) & 0xffu);
}

// The front cell of `cell` in direction d, or -1 off the grid.
__device__ __forceinline__ int front_cell(int cell, int d, int H, int W) {
  const int x = cell % W + (d == 0 ? 1 : d == 2 ? -1 : 0);
  const int y = cell / W + (d == 1 ? 1 : d == 3 ? -1 : 0);
  return (x >= 0 && x < W && y >= 0 && y < H) ? y * W + x : -1;
}

// One CTA of a cluster of n <= 16 per layout, G * HW threads: (group g,
// cell) = divmod(thread, HW); sizes given at run time.  kInPlace: one V
// buffer swept in place; else two.  See the top of the file.
template <bool kInPlace>
__global__ void __launch_bounds__(kWideThreads, 1)
key_vi_wide_kernel(const uint8_t* __restrict__ cell_flags,  // (B, 4, HW)
                   const uint8_t* __restrict__ cfg_flags,   // (B, C, 4, HW)
                   const uint8_t* __restrict__ door_bit,    // (B, 4, HW)
                   float* __restrict__ v_out,  // (B, K, C, 4, HW)
                   int C, int H, int W, float gamma, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.x / n;
  const int HW = H * W;
  const int K = HW + 1;
  const int slab = 4 * HW;     // states per (k, c)
  const int kslab = C * slab;  // states per k
  const int m = n - 1;         // CTAs of the rows other than CARRIED
  const bool hub = rank == m;  // the CARRIED row's CTA
  const int row0 = hub ? HW : row_begin(rank, HW, m);
  const int ngen = hub ? 0 : row_begin(rank + 1, HW, m) - row0;
  const int mrows = (HW + m - 1) / m;  // rows of the largest CTA
  const int slots = wide_slots(HW, n, kInPlace);
  const int ptab = mrows * 4 * C;  // floats of a pickup table
  float* buf0 = reinterpret_cast<float*>(smem);
  float* buf1 = buf0 + slots * kslab;  // double-buffered only
  uint32_t* s_cfg = reinterpret_cast<uint32_t*>(buf0 + (kInPlace ? 1 : 2) * slots * kslab);
  float* s_pick = reinterpret_cast<float*>(s_cfg + C * HW);  // 2 x (mrows, 4, C)

  const int G = blockDim.x / HW;
  const int g = threadIdx.x / HW;
  const int cell = threadIdx.x - g * HW;
  const int step[4] = {1, W, -1, -W};

  for (int i = threadIdx.x; i < C * HW; i += blockDim.x) {
    const int c = i / HW;
    const uint8_t* p = cfg_flags + b * kslab + c * slab + (i - c * HW);
    s_cfg[i] = p[0] | p[HW] << 8 | p[2 * HW] << 16 | static_cast<uint32_t>(p[3 * HW]) << 24;
  }
  // V, the hub's tables and the pickup tables start at 0.
  for (int i = threadIdx.x; i < (kInPlace ? 1 : 2) * slots * kslab; i += blockDim.x) buf0[i] = 0.f;
  for (int i = threadIdx.x; i < 2 * ptab; i += blockDim.x) s_pick[i] = 0.f;

  // Per-direction data of the cell, packed: byte d of `bits` is the door
  // bit in front; bit d of `goal`, `term` and `drop` the flags.
  int fj[4];  // the front cell's local row here, or -1 (also off the grid)
  uint32_t key_rows = 0;  // bit j: the cell faces local row j's cell
  uint32_t bits = 0, goal = 0, term = 0, drop = 0;
  uint32_t no_lava = ~0u;  // clears a direction's walk bit where lava is in front
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int fr = front_cell(cell, d, H, W);
    fj[d] = fr >= row0 && fr < row0 + ngen ? fr - row0 : -1;
    if (fj[d] >= 0) key_rows |= 1u << fj[d];
    const uint8_t f = cell_flags[b * slab + d * HW + cell];
    bits |= static_cast<uint32_t>(door_bit[b * slab + d * HW + cell]) << (8 * d);
    goal |= (f & kGoalFront ? 1u : 0u) << d;
    term |= (f & (kGoalFront | kTargetFront) ? 1u : 0u) << d;
    drop |= ((f & kDropFront) && fr >= 0 ? 1u : 0u) << d;
    if (f & kLavaFront) no_lava &= ~(static_cast<uint32_t>(kWalkFront) << (8 * d));
  }
  // The group's first item g = c0 * ngen + j0, and the stride G = dc *
  // ngen + dj: divisions here only, never in a sweep.
  const int rounds = (ngen * C + G - 1) / G;
  const int dc = ngen ? G / ngen : 0;
  const int dj = G - dc * ngen;
  const int c0 = ngen ? g / ngen : C;
  const int j0 = g - c0 * ngen;
  cluster.sync();  // zeroed V and tables, and the packed flags, in every CTA

  for (int sweep = 0; sweep < n_sweeps; ++sweep) {
    const int odd = sweep & 1;
    float* cur = kInPlace || !odd ? buf0 : buf1;
    float* nxt = kInPlace || odd ? buf0 : buf1;
    // The hub's CARRIED row and drop table, current and next: slots 0 and
    // 1 of each buffer, or in place slots 0-1 and 2-3, swapped each sweep.
    float* car_cur = kInPlace ? buf0 + odd * kslab : cur;
    float* car_nxt = kInPlace ? buf0 + (1 - odd) * kslab : nxt;
    const float* dt_cur = kInPlace ? buf0 + (2 + odd) * kslab : cur + kslab;
    float* dt_nxt = kInPlace ? buf0 + (3 - odd) * kslab : nxt + kslab;
    const float* pick_cur = s_pick + odd * ptab;
    float* pick_nxt = s_pick + (1 - odd) * ptab;
    if (hub) {
      // The CARRIED row: no pickup and no target; drop (from the drop
      // table) and unlock.  Each new value goes to the pickup table of
      // the CTA that owns row front(cell, d), two configs in one store.
      uint32_t pick_at[4];  // where V(CARRIED, 0, d, cell) goes
      uint32_t on_grid = 0;  // bit d: the front cell is on the grid
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int fr = front_cell(cell, d, H, W);
        on_grid |= (fr >= 0 ? 1u : 0u) << d;
        const int owner = row_owner(fr < 0 ? 0 : fr, HW, m);
        const int j = (fr < 0 ? 0 : fr) - row_begin(owner, HW, m);
        pick_at[d] = map_rank(shared_addr(pick_nxt + (j * 4 + d) * C), owner);
      }
      for (int c = 2 * g; c < C; c += 2 * G) {
        const bool pair = c + 1 < C;
        float out[2][4];
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          if (t == 1 && !pair) break;
          const int cc = c + t;
          const uint32_t gc = s_cfg[cc * HW + cell] & no_lava;
          const float* pv = car_cur + cc * slab + cell;
          float v[4];
#pragma unroll
          for (int d = 0; d < 4; ++d) v[d] = pv[d * HW];
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            const uint32_t gd = gc >> (8 * d);
            float q = fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3]));
            if (gd & kWalkFront) q = fmaxf(q, pv[d * HW + step[d]]);
            if (gd & (kClosedFront | kUnlockFront)) {
              q = fmaxf(q, pv[((cc | door(bits, d)) - cc) * slab + d * HW]);
            }
            // drop: the carried key lands on the front cell, row `front`.
            if ((drop >> d) & 1) q = fmaxf(q, dt_cur[cc * slab + d * HW + cell]);
            out[t][d] = (goal >> d) & 1 ? 1.f : gamma * q;
            car_nxt[cc * slab + d * HW + cell] = out[t][d];
          }
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          if (!((on_grid >> d) & 1)) continue;
          if (pair) {
            store_cluster2(pick_at[d] + 4 * c, out[0][d], out[1][d]);
          } else {
            store_cluster(pick_at[d] + 4 * c, out[0][d]);
          }
        }
      }
    }
    // The other rows, config-major, in rounds of G items: stay, turns,
    // forward or pickup (from this CTA's pickup table), and the toggle of
    // a closed door.  A state whose cell faces its key row k and may drop
    // the key there goes to the hub's drop table too.
    const uint32_t dt_at = map_rank(shared_addr(dt_nxt + cell), m);
    int j = j0, c = c0;
    for (int r = 0; r < rounds; ++r) {
      const bool active = c < C;
      float out[4];
      if (active) {
        const uint32_t gc = s_cfg[c * HW + cell] & no_lava;
        const float* pv = cur + j * kslab + c * slab + cell;  // V(k, c, 0, cell)
        float v[4], q[4];
#pragma unroll
        for (int d = 0; d < 4; ++d) v[d] = pv[d * HW];
        // stay (done, failed actions), left/right and forward.
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          q[d] = fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3]));
          if ((gc >> (8 * d)) & kWalkFront) q[d] = fmaxf(q[d], pv[d * HW + step[d]]);
        }
        // The rare cases, off the common path: the key lies in front
        // (pickup in place of forward), a closed door lies in front.
        const bool key_here = (key_rows >> j) & 1;
        if (key_here) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (j == fj[d]) {
              q[d] = fmaxf(fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3])),
                           pick_cur[(j * 4 + d) * C + c]);
            }
          }
        }
        if (gc & kClosedAnyDir) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if ((gc >> (8 * d)) & kClosedFront) {
              q[d] = fmaxf(q[d], pv[((c | door(bits, d)) - c) * slab + d * HW]);
            }
          }
        }
        // terminals: stepping onto the goal, picking up the target.
#pragma unroll
        for (int d = 0; d < 4; ++d) out[d] = (term >> d) & 1 ? 1.f : gamma * q[d];
        if (key_here) {
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            if (j == fj[d] && (drop >> d) & 1) store_cluster(dt_at + 4 * (c * slab + d * HW), out[d]);
          }
        }
      }
      // In place, the round's reads end before its writes.
      if (kInPlace) __syncthreads();
      if (active) {
        float* pn = nxt + j * kslab + c * slab + cell;
#pragma unroll
        for (int d = 0; d < 4; ++d) pn[d * HW] = out[d];
      }
      j += dj;
      c += dc;
      if (j >= ngen) {
        j -= ngen;
        ++c;
      }
    }
    // Every table sent in this sweep is complete before the next reads
    // it; the last barrier also ends every remote store before any CTA
    // exits.
    cluster.sync();
  }
  const int odd = n_sweeps & 1;
  const float* fin = kInPlace || !odd ? buf0 : buf1;
  if (hub) {
    const float* car_fin = kInPlace ? buf0 + odd * kslab : fin;
    float* out = v_out + (b * K + HW) * kslab;
    for (int i = threadIdx.x; i < kslab; i += blockDim.x) out[i] = car_fin[i];
  } else {
    float* out = v_out + (b * K + row0) * kslab;
    for (int i = threadIdx.x; i < ngen * kslab; i += blockDim.x) out[i] = fin[i];
  }
}

// A resident grid CTA's shared memory: ceil(K / n) key rows of V, swept in
// place, then the packed flags.
size_t grid_shared_bytes(int C, int HW, int n) {
  const size_t rows = (HW + 1 + n - 1) / n;
  return rows * C * 4 * HW * sizeof(float) + C * HW * sizeof(uint32_t);
}

// The group barrier of the grid route: wait for the `target`-th arrival
// of the group's n CTAs at `count` (target = n times the barriers so far).
// The CTA's threads meet; one thread releases the CTA's writes with the
// arrival (fence.acq_rel, then a relaxed add that returns nothing) and
// acquires the others' by spinning on an acquire load, as CUTLASS's
// GenericBarrier does; then the threads meet again.
__device__ __forceinline__ void group_barrier(uint32_t* count, uint32_t target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    asm volatile("fence.acq_rel.gpu;\n\tred.relaxed.gpu.global.add.u32 [%0], 1;" :: "l"(count)
                 : "memory");
    uint32_t seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
    } while (seen < target);
  }
  __syncthreads();
}

// cfg_flags of layout b packed per (c, cell), one byte per direction.
__device__ __forceinline__ void pack_cfg(const uint8_t* cfg_flags, size_t b, int C, int HW,
                                         uint32_t* s_cfg) {
  const int slab = 4 * HW;
  for (int i = threadIdx.x; i < C * HW; i += blockDim.x) {
    const int c = i / HW;
    const uint8_t* p = cfg_flags + (b * C + c) * slab + (i - c * HW);
    s_cfg[i] = p[0] | p[HW] << 8 | p[2 * HW] << 16 | static_cast<uint32_t>(p[3 * HW]) << 24;
  }
}

// The table values that item (j, c) of a resident grid CTA reads in a
// sweep, one a direction, 0 where it reads none (0 never wins the max):
// for a row other than CARRIED (j < ngen), the pickup where the cell faces
// the row's cell; for the CARRIED row, the drops.  `at`: (c, 0, cell).
__device__ __forceinline__ void table_reads(const float* pick_cur, const float* drop_cur, int at,
                                            int HW, int j, int ngen, uint32_t key_rows,
                                            const int (&fj)[4], uint32_t drop, float (&t)[4]) {
  const bool car = j >= ngen;
  const bool key_here = !car && ((key_rows >> j) & 1);
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    t[d] = 0.f;
    if (car ? (drop >> d) & 1 : key_here && j == fj[d]) {
      t[d] = __ldcg((car ? drop_cur : pick_cur) + at + d * HW);
    }
  }
}

// One CTA of a group of n per layout, resident mode, G * HW threads:
// (group g, cell) = divmod(thread, HW); V of its rows in shared memory,
// swept in place.  `tables`: per group, the pickup table twice, then the
// drop table twice, each (C, 4, HW).  `count`: an arrival counter per
// group, zero at launch.  See the top of the file.
__global__ void __launch_bounds__(kGridThreads, 1)
key_vi_grid_resident_kernel(const uint8_t* __restrict__ cell_flags,  // (B, 4, HW)
                            const uint8_t* __restrict__ cfg_flags,   // (B, C, 4, HW)
                            const uint8_t* __restrict__ door_bit,    // (B, 4, HW)
                            float* __restrict__ v_out,  // (B, K, C, 4, HW)
                            float* tables,              // (groups, 4, C, 4, HW)
                            uint32_t* count,            // (groups,)
                            int B, int C, int H, int W, int n, float gamma, int n_sweeps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rank = blockIdx.x % n;
  const int grp = blockIdx.x / n;
  const int groups = gridDim.x / n;
  const int HW = H * W;
  const int K = HW + 1;
  const int slab = 4 * HW;     // states per (k, c)
  const int kslab = C * slab;  // states per k
  const int row0 = row_begin(rank, K, n);
  const int nrows = row_begin(rank + 1, K, n) - row0;
  const int ngen = row0 + nrows == K ? nrows - 1 : nrows;  // rows other than CARRIED
  const int mrows = (K + n - 1) / n;
  float* sv = reinterpret_cast<float*>(smem);  // (mrows, C, 4, HW)
  uint32_t* s_cfg = reinterpret_cast<uint32_t*>(sv + mrows * kslab);
  float* pick = tables + static_cast<size_t>(grp) * 4 * kslab;  // 2 x (C, 4, HW)
  float* drop_tab = pick + 2 * kslab;                           // 2 x (C, 4, HW)
  uint32_t* my_count = count + grp;

  const int G = blockDim.x / HW;
  const int g = threadIdx.x / HW;
  const int cell = threadIdx.x - g * HW;
  const int step[4] = {1, W, -1, -W};
  // The rows the cell faces, from the geometry alone.
  int fj[4];              // the front cell's local row here, or -1 (also off the grid)
  uint32_t key_rows = 0;  // bit j: the cell faces local row j's cell
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int fr = front_cell(cell, d, H, W);
    fj[d] = fr >= row0 && fr < row0 + ngen ? fr - row0 : -1;
    if (fj[d] >= 0) key_rows |= 1u << fj[d];
  }
  // The group's first item g = c0 * nrows + j0, and the stride G = dc *
  // nrows + dj: divisions here only, never in a sweep.
  const int rounds = (nrows * C + G - 1) / G;
  const int dc = G / nrows;
  const int dj = G - dc * nrows;
  const int c0 = g / nrows;
  const int j0 = g - c0 * nrows;
  uint32_t barriers = 0;

  for (int b = grp; b < B; b += groups) {
    pack_cfg(cfg_flags, b, C, HW, s_cfg);
    for (int i = threadIdx.x; i < nrows * kslab; i += blockDim.x) sv[i] = 0.f;
    // Per-direction data of the cell, packed: byte d of `bits` is the door
    // bit in front; bit d of `goal`, `term` and `drop` the flags.
    uint32_t bits = 0, goal = 0, term = 0, drop = 0;
    uint32_t no_lava = ~0u;  // clears a direction's walk bit where lava is in front
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      const uint8_t f = cell_flags[b * slab + d * HW + cell];
      bits |= static_cast<uint32_t>(door_bit[b * slab + d * HW + cell]) << (8 * d);
      goal |= (f & kGoalFront ? 1u : 0u) << d;
      term |= (f & (kGoalFront | kTargetFront) ? 1u : 0u) << d;
      drop |= ((f & kDropFront) && front_cell(cell, d, H, W) >= 0 ? 1u : 0u) << d;
      if (f & kLavaFront) no_lava &= ~(static_cast<uint32_t>(kWalkFront) << (8 * d));
    }
    __syncthreads();  // zeroed V and the packed flags

    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      const int odd = sweep & 1;
      const bool first = sweep == 0;  // V is 0: no table is read
      const float* pick_cur = pick + odd * kslab;
      float* pick_nxt = pick + (1 - odd) * kslab;
      const float* drop_cur = drop_tab + odd * kslab;
      float* drop_nxt = drop_tab + (1 - odd) * kslab;
      int j = j0, c = c0;
      // The table values of the thread's item, each loaded a round ahead so
      // that its latency hides behind the round before.
      float tab[4] = {0.f, 0.f, 0.f, 0.f};
      if (!first && c < C) {
        table_reads(pick_cur, drop_cur, c * slab + cell, HW, j, ngen, key_rows, fj, drop, tab);
      }
      for (int r = 0; r < rounds; ++r) {
        const bool active = c < C;
        // The next round's item.
        int jn = j + dj, cn = c + dc;
        if (jn >= nrows) {
          jn -= nrows;
          ++cn;
        }
        float out[4];
        if (active) {
          const uint32_t gc = s_cfg[c * HW + cell] & no_lava;
          float* pv = sv + j * kslab + c * slab + cell;  // V(k, c, 0, cell)
          const int at = c * slab + cell;  // (c, 0, cell) in a table
          float v[4], q[4];
#pragma unroll
          for (int d = 0; d < 4; ++d) v[d] = pv[d * HW];
          // stay (done, failed actions), left/right and forward.
#pragma unroll
          for (int d = 0; d < 4; ++d) {
            q[d] = fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3]));
            if ((gc >> (8 * d)) & kWalkFront) q[d] = fmaxf(q[d], pv[d * HW + step[d]]);
          }
          if (j < ngen) {
            // The rare cases, off the common path: the key lies in front
            // (pickup in place of forward), a closed door lies in front.
            const bool key_here = (key_rows >> j) & 1;
            if (key_here) {
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                if (j == fj[d]) q[d] = fmaxf(fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3])), tab[d]);
              }
            }
            if (gc & kClosedAnyDir) {
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                if ((gc >> (8 * d)) & kClosedFront) {
                  q[d] = fmaxf(q[d], pv[((c | door(bits, d)) - c) * slab + d * HW]);
                }
              }
            }
            // terminals: stepping onto the goal, picking up the target.
#pragma unroll
            for (int d = 0; d < 4; ++d) out[d] = (term >> d) & 1 ? 1.f : gamma * q[d];
            if (key_here) {
#pragma unroll
              for (int d = 0; d < 4; ++d) {
                if (j == fj[d] && (drop >> d) & 1) __stcg(drop_nxt + at + d * HW, out[d]);
              }
            }
          } else {
            // The CARRIED row: no pickup and no target; unlock, and drop
            // (the carried key lands on the front cell, row `front`).
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              if ((gc >> (8 * d)) & (kClosedFront | kUnlockFront)) {
                q[d] = fmaxf(q[d], pv[((c | door(bits, d)) - c) * slab + d * HW]);
              }
              q[d] = fmaxf(q[d], tab[d]);
              out[d] = (goal >> d) & 1 ? 1.f : gamma * q[d];
              __stcg(pick_nxt + at + d * HW, out[d]);
            }
          }
        }
        if (!first && cn < C) {
          table_reads(pick_cur, drop_cur, cn * slab + cell, HW, jn, ngen, key_rows, fj, drop, tab);
        }
        // The round's reads end before its writes.
        __syncthreads();
        if (active) {
          float* pn = sv + j * kslab + c * slab + cell;
#pragma unroll
          for (int d = 0; d < 4; ++d) pn[d * HW] = out[d];
        }
        j = jn;
        c = cn;
      }
      // The tables written in this sweep are complete before the next reads
      // them, and a table is written again only after the sweep that read
      // it has ended, in every CTA of the group.
      barriers += n;
      group_barrier(my_count, barriers);
    }
    float* out = v_out + (b * K + row0) * static_cast<size_t>(kslab);
    for (int i = threadIdx.x; i < nrows * kslab; i += blockDim.x) out[i] = sv[i];
    __syncthreads();  // before the next layout overwrites V
  }
}

// One CTA of a group of n per layout, streamed mode: G groups of T =
// min(HW, kGridThreads) threads, (group g, first cell) = divmod(thread, T);
// a thread takes cells cell0, cell0 + T, ... and, for each, the CTA's slabs
// g, g + G, ...  V double-buffered in device memory: sweep s writes v_out
// where n_sweeps - 1 - s is even, else the group's scratch layout.
__global__ void __launch_bounds__(kGridThreads, 1)
key_vi_grid_streamed_kernel(const uint8_t* __restrict__ cell_flags,  // (B, 4, HW)
                            const uint8_t* __restrict__ cfg_flags,   // (B, C, 4, HW)
                            const uint8_t* __restrict__ door_bit,    // (B, 4, HW)
                            float* v_out,      // (B, K, C, 4, HW)
                            float* v_scratch,  // (groups, K, C, 4, HW)
                            uint32_t* count,   // (groups,)
                            int B, int C, int H, int W, int n, float gamma, int n_sweeps) {
  const int rank = blockIdx.x % n;
  const int grp = blockIdx.x / n;
  const int groups = gridDim.x / n;
  const int HW = H * W;
  const int K = HW + 1;
  const int CARRIED = HW;
  const int slab = 4 * HW;     // states per (k, c)
  const int kslab = C * slab;  // states per k
  const size_t S = static_cast<size_t>(K) * kslab;
  const int s0 = row_begin(rank, K * C, n);  // the CTA's slabs k * C + c
  const int ns = row_begin(rank + 1, K * C, n) - s0;
  const int T = HW < kGridThreads ? HW : kGridThreads;
  const int G = blockDim.x / T;
  const int g = threadIdx.x / T;
  const int cell0 = threadIdx.x - g * T;
  const int step[4] = {1, W, -1, -W};
  // The group's first slab g = k0 * C + c0 after s0, and the stride G = dk
  // * C + dc: divisions here only, never in a sweep.
  const int k0 = (s0 + g) / C, c0 = (s0 + g) - k0 * C;
  const int dk = G / C, dc = G - (G / C) * C;
  float* scratch = v_scratch + grp * S;
  uint32_t* my_count = count + grp;
  uint32_t barriers = 0;

  for (int b = grp; b < B; b += groups) {
    float* out = v_out + b * S;
    for (int sweep = 0; sweep < n_sweeps; ++sweep) {
      const bool first = sweep == 0;  // V is 0: nothing is read
      const float* cur = (n_sweeps - sweep) & 1 ? scratch : out;
      float* nxt = (n_sweeps - 1 - sweep) & 1 ? scratch : out;
      for (int cell = cell0; cell < HW; cell += T) {
        int fr[4];  // the front cell, or -1 off the grid
        uint32_t bits = 0, goal = 0, term = 0, drop = 0, no_lava = ~0u;
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          fr[d] = front_cell(cell, d, H, W);
          const uint8_t f = cell_flags[b * slab + d * HW + cell];
          bits |= static_cast<uint32_t>(door_bit[b * slab + d * HW + cell]) << (8 * d);
          goal |= (f & kGoalFront ? 1u : 0u) << d;
          term |= (f & (kGoalFront | kTargetFront) ? 1u : 0u) << d;
          drop |= ((f & kDropFront) && fr[d] >= 0 ? 1u : 0u) << d;
          if (f & kLavaFront) no_lava &= ~(static_cast<uint32_t>(kWalkFront) << (8 * d));
        }
        int k = k0, c = c0;
        for (int i = g; i < ns; i += G) {
          const size_t at = static_cast<size_t>(k) * kslab + c * slab + cell;  // (k, c, 0, cell)
          const bool car = k == CARRIED;
          float res[4];
          if (first) {
#pragma unroll
            for (int d = 0; d < 4; ++d) res[d] = ((car ? goal : term) >> d) & 1 ? 1.f : 0.f;
          } else {
            const uint8_t* pc = cfg_flags + (b * C + c) * static_cast<size_t>(slab) + cell;
            const uint32_t gc = (pc[0] | pc[HW] << 8 | pc[2 * HW] << 16 |
                                 static_cast<uint32_t>(pc[3 * HW]) << 24) & no_lava;
            // Every candidate's load goes out before any is used, so a slab
            // waits for one round trip to memory, not one a candidate; a
            // candidate the state lacks is 0, which never wins the max.
            const float* pv = cur + at;
            float v[4], ahead[4], tog[4], dropped[4];
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              const uint32_t gd = gc >> (8 * d);
              v[d] = __ldcg(pv + d * HW);
              // forward, or pickup (the CARRIED row's value) where the key
              // lies in front.
              ahead[d] = !car && k == fr[d]
                             ? __ldcg(cur + static_cast<size_t>(CARRIED - k) * kslab + at + d * HW)
                         : gd & kWalkFront ? __ldcg(pv + d * HW + step[d]) : 0.f;
              // toggle: a closed door; in the CARRIED row a locked one too.
              tog[d] = gd & (car ? kClosedFront | kUnlockFront : kClosedFront)
                           ? __ldcg(pv + ((c | door(bits, d)) - c) * slab + d * HW) : 0.f;
              // drop: from the CARRIED row onto row `front`.
              dropped[d] = car && (drop >> d) & 1
                               ? __ldcg(cur + static_cast<size_t>(fr[d]) * kslab + c * slab + d * HW + cell)
                               : 0.f;
            }
#pragma unroll
            for (int d = 0; d < 4; ++d) {
              const float q = fmaxf(fmaxf(v[d], fmaxf(v[(d + 3) & 3], v[(d + 1) & 3])),
                                    fmaxf(ahead[d], fmaxf(tog[d], dropped[d])));
              res[d] = ((car ? goal : term) >> d) & 1 ? 1.f : gamma * q;
            }
          }
#pragma unroll
          for (int d = 0; d < 4; ++d) nxt[at + d * HW] = res[d];
          c += dc;
          k += dk;
          if (c >= C) {
            c -= C;
            ++k;
          }
        }
      }
      // Every CTA's slabs of this sweep are written before any reads them,
      // and a buffer is written again only after the sweep that read it has
      // ended, in every CTA of the group.
      barriers += n;
      group_barrier(my_count, barriers);
    }
    if (n_sweeps == 0) {
      for (int i = threadIdx.x; i < ns; i += blockDim.x) {
        float* p = out + static_cast<size_t>(s0 + i) * slab;
        for (int s = 0; s < slab; ++s) p[s] = 0.f;
      }
    }
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

using WideKernel = ClusterKernel;
WideKernel wide_kernel(bool in_place) {
  return in_place ? key_vi_wide_kernel<true> : key_vi_wide_kernel<false>;
}

// A cluster of 16 is above the portable limit: allow it, then the shared
// memory, in that order.
cudaError_t wide_attributes(WideKernel kernel, size_t smem) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
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

// --- wide route ------------------------------------------------------------

extern "C" size_t key_vi_wide_shared_bytes(int C, int HW, int n, int in_place) {
  return wide_shared_bytes(C, HW, n, in_place != 0);
}

// How many clusters of n CTAs of G * H * W threads can be resident at once
// (cudaOccupancyMaxActiveClusters); a negative cudaError_t on failure.
extern "C" int key_vi_wide_occupancy(int C, int H, int W, int n, int G, int in_place) {
  const size_t smem = wide_shared_bytes(C, H * W, n, in_place != 0);
  const auto kernel = wide_kernel(in_place != 0);
  cudaError_t e = wide_attributes(kernel, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(n, H * W, n, G, smem, 0, &attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// Launches on `stream` with clusters of n CTAs (2 <= n <= 16, n <= K, at
// most 32 rows a CTA) of G * H * W <= 1024 threads, V in place where in_place is nonzero; returns
// the cudaError_t of the launch (0 = ok).
extern "C" int key_vi_wide_launch(const void* cell_flags, const void* cfg_flags,
                                  const void* door_bit, void* v_out, int B, int C,
                                  int H, int W, int n, int G, int in_place,
                                  float gamma, int n_sweeps, void* stream) {
  const int HW = H * W;
  if (n < 2 || n > kWideCluster || n > HW + 1 || (HW + n - 2) / (n - 1) > kWideRows || G < 1 ||
      G * HW > kWideThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = wide_shared_bytes(C, HW, n, in_place != 0);
  const auto kernel = wide_kernel(in_place != 0);
  const cudaError_t e = wide_attributes(kernel, smem);
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

// --- grid route ------------------------------------------------------------

namespace {

using GridKernel = void (*)(const uint8_t*, const uint8_t*, const uint8_t*, float*, float*,
                            uint32_t*, int, int, int, int, int, float, int);

GridKernel grid_kernel(bool resident) {
  return resident ? key_vi_grid_resident_kernel : key_vi_grid_streamed_kernel;
}

size_t grid_smem(int C, int HW, int n, bool resident) {
  return resident ? grid_shared_bytes(C, HW, n) : 0;
}

}  // namespace

extern "C" size_t key_vi_grid_shared_bytes(int C, int HW, int n, int resident) {
  return grid_smem(C, HW, n, resident != 0);
}

// How many CTAs of `threads` threads the current card holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor times its SMs); a negative
// cudaError_t on failure.
extern "C" int key_vi_grid_occupancy(int C, int H, int W, int n, int threads, int resident) {
  const size_t smem = grid_smem(C, H * W, n, resident != 0);
  const GridKernel kernel = grid_kernel(resident != 0);
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return -static_cast<int>(e);
  int per_sm = 0, dev = 0, sms = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

// Launches, cooperatively, `groups` groups of n CTAs of `threads` threads on
// `stream`.  Resident (nonzero `resident`): 1 <= n <= K, at most 32 rows a
// CTA, threads = G * H * W; `scratch` holds the group's pickup and drop
// tables, (groups, 4, C, 4, HW) floats.  Streamed: 1 <= n <= K * C,
// threads = G * min(H * W, 1024); `scratch` one layout of V per group.
// `count`: groups zeroed arrival counters.  Returns the cudaError_t of the
// launch (0 = ok); a grid the card cannot hold at once is refused
// (cudaErrorCooperativeLaunchTooLarge), never run.
extern "C" int key_vi_grid_launch(const void* cell_flags, const void* cfg_flags,
                                  const void* door_bit, void* v_out, void* scratch, void* count,
                                  int B, int C, int H, int W, int n, int threads, int groups,
                                  int resident, float gamma, int n_sweeps, void* stream) {
  const int HW = H * W;
  const int K = HW + 1;
  const int T = resident ? HW : (HW < kGridThreads ? HW : kGridThreads);
  const bool ok = resident ? n >= 1 && n <= K && (K + n - 1) / n <= kGridRows
                           : n >= 1 && n <= K * C;
  if (!ok || groups < 1 || threads < T || threads > kGridThreads || threads % T != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = grid_smem(C, HW, n, resident != 0);
  const GridKernel kernel = grid_kernel(resident != 0);
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  if (B == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * n);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const uint8_t*>(cell_flags),
      static_cast<const uint8_t*>(cfg_flags), static_cast<const uint8_t*>(door_bit),
      static_cast<float*>(v_out), static_cast<float*>(scratch), static_cast<uint32_t*>(count), B,
      C, H, W, n, gamma, n_sweeps));
}
