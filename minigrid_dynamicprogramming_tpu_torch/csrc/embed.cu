// The ObsEncoder's embedding lookups (models/nets.py:EmbedKernel on a CUDA
// device): the three plane tables over the (B, V, V, 3) uint8 image, the
// direction table and the mission's position-weighted code bag, forward in
// one launch and backward in two.
//
// It replaces no TPU kernel: JAX's OneHotEmbed
// (minigrid_dynamicprogramming_tpu/models/nets.py) is a one-hot matmul that
// XLA lowers on its own.  In the port the same lookups were nn.Embedding:
// gathers written in float32, then a cat and a cast to the compute dtype
// (for the mission an 805 MB float32 (B, 48, 32) tensor at the learner's
// 131072 rows, and its bf16 copy); their backward sorted the millions of
// indices (6.4M a plane) to sum them into at most 64 rows, with float
// atomics.  On an H100 that took 0.89 s of a 1.33 s PPO update.
//
// What bounds it on an H100: bytes.  At 131072 rows and a 7x7 view the
// forward reads the uint8 image (19.3 MB) and the int32 codes (25.2 MB)
// and writes the bf16 plane features (308 MB) and the bag (8.4 MB); the
// backward reads about as much.  That is about 0.72 GB a minibatch step,
// 0.22 ms at 3.35 TB/s.  The tables are at most 4.6 KB.  The design:
//
// * Forward, a block of kFwdRows rows: the tables are staged in shared
//   memory, each value rounded once from its float32 table to the compute
//   dtype T.  A plane's 8 features are one 16-byte word in bf16 (two in
//   float32), and the image's byte i is plane i % 3 of cell i / 3, so word
//   i of the (B, V, V, 24) output is one table word picked by image byte
//   i / words-a-plane: every load and store is coalesced.  The direction's
//   16 features are 2 (4) words a row.  The bag takes a warp a row, a lane
//   a feature, its codes broadcast by shuffles: each product tok x pos is
//   rounded to T, the 48 products are summed in float32 in slot order and
//   the sum rounded once, where nn's composition rounds.
// * Backward, no sort and no float atomics.  A block owns a contiguous
//   span of kGradRows rows and writes one partial sum per table entry
//   to scratch; a second launch sums the partials in block order.  In the
//   partial launch blockIdx.y picks the block's work:
//   - 0: the planes and the direction.  A thread takes the same quad (4
//     features: 8 bytes in bf16, 16 in float32) of each cell it visits, so
//     its plane and features never change, and keeps its own accumulators
//     (vocabulary x 4) in a column of shared memory that no other thread
//     touches: one load, add and store a value, no conflict, no atomic.
//     The direction, 4 x 4 accumulators a thread, in registers under a
//     predicate.  Then each entry is the sum of its column's threads in
//     thread order.
//   - 1: the mission.  A warp a row, a lane a feature: code_pos's gradient
//     g x tok (rounded to T) in 48 registers a lane, the code table's
//     gradient g x pos (rounded to T) at the row's code in the warp's own
//     copy of the table in shared memory (a lane's column its own).  Then
//     the warps' copies are summed in warp order.
//   code_pos's sum over all rows is rounded once to T at the end, as
//   autograd's sum_to_size of a T product is.  Every sum is float32 in a
//   fixed order, so the gradients are the same from run to run.
// * The view, the batch and the mission vocabulary are given at run time; the compute dtype (bf16 or float32)
//   is a template parameter.  Ids are clamped to their vocabulary, the
//   direction's too (nn.Embedding refuses one outside it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 3;
constexpr int kPlaneFeatures = 8;
constexpr int kPlaneRows = 16 + 8 + 4;  // nets.py:PLANE_VOCABS, one table after another
constexpr int kDirs = 4;
constexpr int kDirFeatures = 16;
constexpr int kSlots = 48;  // core/state.py:MISSION_SLOTS
constexpr int kCodeFeatures = 32;
// Partial sums a backward block: the plane tables, the direction table,
// then the code table (vocab x 32) and code_pos (48 x 32).
constexpr int kFixedEntries = kPlaneRows * kPlaneFeatures + kDirs * kDirFeatures;

constexpr int kFwdThreads = 256;
constexpr int kFwdRows = 128;  // rows a forward block
constexpr int kGradRows = 128;  // rows a backward block owns
constexpr int kGradThreads = 192;  // a multiple of 32 and of a cell's 6 quads
constexpr int kGradWarps = kGradThreads / 32;
constexpr int kQuadAcc = 16 * 4;  // a thread's plane accumulators: the largest vocabulary x 4
constexpr int kSumCols = 32;  // entries a block of the summing launch
constexpr int kSumGroups = 16;  // runs of blocks it sums side by side
constexpr int kUnroll = 4;  // loads a thread starts before it uses them

__device__ __forceinline__ int plane_vocab(int p) { return p == 0 ? 16 : (p == 1 ? 8 : 4); }
__device__ __forceinline__ int plane_offset(int p) { return p == 0 ? 0 : (p == 1 ? 16 : 24); }
__device__ __forceinline__ int clamp_id(int id, int vocab) { return min(max(id, 0), vocab - 1); }

// The compute dtype's rounding, loads and stores.
template <typename T>
struct Dt;

template <>
struct Dt<float> {
  using Quad = uint4;  // 4 features
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float to_float(float x) { return x; }
  static __device__ __forceinline__ float from_float(float x) { return x; }
  static __device__ __forceinline__ void unpack(const uint4 q, float v[4]) {
    v[0] = __uint_as_float(q.x);
    v[1] = __uint_as_float(q.y);
    v[2] = __uint_as_float(q.z);
    v[3] = __uint_as_float(q.w);
  }
};

template <>
struct Dt<__nv_bfloat16> {
  using Quad = uint2;
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ void unpack(const uint2 q, float v[4]) {
    v[0] = __uint_as_float(q.x << 16);
    v[1] = __uint_as_float(q.x & 0xffff0000u);
    v[2] = __uint_as_float(q.y << 16);
    v[3] = __uint_as_float(q.y & 0xffff0000u);
  }
};

}  // namespace

// One forward launch's arguments, mirrored by models/nets.py:_FwdArgs.
struct FwdArgs {
  const uint8_t* image;  // (B, cells, 3), contiguous
  const int32_t* direction;  // (B,), element stride dir_stride
  const int32_t* mission;  // (B, 48), element strides mission_row, mission_slot
  const float* plane_w0;  // (16, 8)
  const float* plane_w1;  // (8, 8)
  const float* plane_w2;  // (4, 8)
  const float* dir_w;  // (4, 16)
  const float* code_w;  // (vocab, 32)
  const float* pos_w;  // (48, 32)
  void* planes;  // (B, cells, 24) T, 16-byte aligned
  void* dir_out;  // (B, 16) T, 16-byte aligned
  void* bag;  // (B, 32) T
  int64_t dir_stride, mission_row, mission_slot;
  int32_t B, cells, vocab;
};

// One backward's arguments (both launches), mirrored by models/nets.py:_GradArgs.
struct GradArgs {
  const uint8_t* image;
  const int32_t* direction;
  const int32_t* mission;
  const void* g_planes;  // (B, cells, 24) T, contiguous, 16-byte aligned
  const void* g_dir;  // (B, 16) T, row stride g_dir_row (elements), 16-byte aligned rows
  const void* g_bag;  // (B, 32) T, row stride g_bag_row
  const float* code_w;
  const float* pos_w;
  float* partials;  // (blocks, entries)
  float* grad_plane0;  // (16, 8)
  float* grad_plane1;  // (8, 8)
  float* grad_plane2;  // (4, 8)
  float* grad_dir;  // (4, 16)
  float* grad_code;  // (vocab, 32)
  float* grad_pos;  // (48, 32)
  int64_t dir_stride, mission_row, mission_slot, g_dir_row, g_bag_row;
  int32_t B, cells, vocab;
};

namespace {

// The tables staged for the forward: the planes' and the direction's in T,
// code_pos's and the codes' as float32 values rounded to T.
template <typename T>
__device__ __forceinline__ void stage_tables(const FwdArgs& a, T* s_plane, T* s_dir, float* s_pos,
                                             float* s_tok) {
  for (int i = threadIdx.x; i < kPlaneRows * kPlaneFeatures; i += blockDim.x) {
    const int row = i / kPlaneFeatures, f = i % kPlaneFeatures;
    const float* w = row < 16 ? a.plane_w0 + row * kPlaneFeatures
                     : row < 24 ? a.plane_w1 + (row - 16) * kPlaneFeatures
                                : a.plane_w2 + (row - 24) * kPlaneFeatures;
    s_plane[i] = Dt<T>::from_float(w[f]);
  }
  for (int i = threadIdx.x; i < kDirs * kDirFeatures; i += blockDim.x) {
    s_dir[i] = Dt<T>::from_float(a.dir_w[i]);
  }
  for (int i = threadIdx.x; i < kSlots * kCodeFeatures; i += blockDim.x) {
    s_pos[i] = Dt<T>::round(a.pos_w[i]);
  }
  for (int i = threadIdx.x; i < a.vocab * kCodeFeatures; i += blockDim.x) {
    s_tok[i] = Dt<T>::round(a.code_w[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads) embed_kernel(const FwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_plane = reinterpret_cast<T*>(smem);  // 28 x 8
  T* s_dir = s_plane + kPlaneRows * kPlaneFeatures;  // 4 x 16
  float* s_pos = reinterpret_cast<float*>(s_dir + kDirs * kDirFeatures);  // 48 x 32
  float* s_tok = s_pos + kSlots * kCodeFeatures;  // vocab x 32
  stage_tables<T>(a, s_plane, s_dir, s_pos, s_tok);
  __syncthreads();

  const int tid = threadIdx.x;
  const int r0 = blockIdx.x * kFwdRows;
  const int rows = min(kFwdRows, a.B - r0);

  // The plane features: word i of the block's rows is word i % kWords of
  // the table row picked by image byte i / kWords.
  constexpr int kWords = kPlaneFeatures * sizeof(T) / 16;
  const uint4* tab = reinterpret_cast<const uint4*>(s_plane);
  const uint8_t* img = a.image + static_cast<int64_t>(r0) * a.cells * kPlanes;
  uint4* out = reinterpret_cast<uint4*>(a.planes) + static_cast<int64_t>(r0) * a.cells * kPlanes * kWords;
  const int n = rows * a.cells * kPlanes * kWords;
  for (int i0 = tid; i0 < n; i0 += kUnroll * kFwdThreads) {
    int ids[kUnroll];  // a batch's image bytes loaded before any store
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kFwdThreads;
      ids[u] = i < n ? __ldg(img + i / kWords) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = i0 + u * kFwdThreads;
      if (i < n) {
        const int p = (i / kWords) % kPlanes;
        out[i] = tab[(plane_offset(p) + min(ids[u], plane_vocab(p) - 1)) * kWords + i % kWords];
      }
    }
  }

  // The direction's features.
  constexpr int kDirWords = kDirFeatures * sizeof(T) / 16;
  const uint4* dtab = reinterpret_cast<const uint4*>(s_dir);
  uint4* dout = reinterpret_cast<uint4*>(a.dir_out) + static_cast<int64_t>(r0) * kDirWords;
  for (int i = tid; i < rows * kDirWords; i += kFwdThreads) {
    const int d = clamp_id(a.direction[static_cast<int64_t>(r0 + i / kDirWords) * a.dir_stride], kDirs);
    dout[i] = dtab[d * kDirWords + i % kDirWords];
  }

  // The bag: a warp a row, a lane a feature.
  const int lane = tid & 31;
  T* bag = static_cast<T*>(a.bag);
  for (int r = tid >> 5; r < rows; r += kFwdThreads / 32) {
    const int64_t b = r0 + r;
    const int32_t* m = a.mission + b * a.mission_row;
    const int lo = m[lane * a.mission_slot];
    const int hi = lane < kSlots - 32 ? m[(32 + lane) * a.mission_slot] : 0;
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int code = clamp_id(__shfl_sync(0xffffffffu, s < 32 ? lo : hi, s & 31), a.vocab);
      acc += Dt<T>::round(__fmul_rn(s_tok[code * kCodeFeatures + lane], s_pos[s * kCodeFeatures + lane]));
    }
    bag[b * kCodeFeatures + lane] = Dt<T>::from_float(acc);
  }
}

// Backward, blockIdx.y == 0: the planes' and the direction's partial sums
// of the block's rows.
template <typename T>
__device__ __forceinline__ void grad_planes_dir(const GradArgs& a, float* sm, int r0, int rows,
                                                float* part) {
  using Quad = typename Dt<T>::Quad;
  const int tid = threadIdx.x;
  // Quad j of a cell is features 4 (j % 2) .. +3 of plane j / 2; a thread
  // visits quad tid % 6 of cells tid / 6, + 32, + 64, ...
  const int p = (tid % 6) / 2;
  const int vocab = plane_vocab(p);
  float* acc = sm + tid;  // acc[(id * 4 + c) * kGradThreads]: this thread's column
  for (int k = 0; k < kQuadAcc; ++k) acc[k * kGradThreads] = 0.f;
  const Quad* g = reinterpret_cast<const Quad*>(a.g_planes) + static_cast<int64_t>(r0) * a.cells * 6;
  const uint8_t* img = a.image + static_cast<int64_t>(r0) * a.cells * kPlanes;
  const int n = rows * a.cells * 6;
  for (int q0 = tid, e0 = tid / 6; q0 < n; q0 += kUnroll * kGradThreads, e0 += kUnroll * kGradThreads / 6) {
    Quad gq[kUnroll];  // a batch's loads before any sum
    int ids[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int q = q0 + u * kGradThreads, e = e0 + u * kGradThreads / 6;
      if (q < n) {
        gq[u] = __ldg(g + q);
        ids[u] = min(static_cast<int>(__ldg(img + e * kPlanes + p)), vocab - 1);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (q0 + u * kGradThreads < n) {
        float v[4];
        Dt<T>::unpack(gq[u], v);
        float* x = acc + ids[u] * 4 * kGradThreads;
#pragma unroll
        for (int c = 0; c < 4; ++c) x[c * kGradThreads] += v[c];
      }
    }
  }
  __syncthreads();
  for (int o = tid; o < kPlaneRows * kPlaneFeatures; o += kGradThreads) {
    const int row = o / kPlaneFeatures, f = o % kPlaneFeatures;
    const int pp = row < 16 ? 0 : (row < 24 ? 1 : 2);
    const float* x = sm + ((row - plane_offset(pp)) * 4 + f % 4) * kGradThreads + 2 * pp + f / 4;
    float s = 0.f;
    for (int t = 0; t < kGradThreads; t += 6) s += x[t];
    part[o] = s;
  }

  // The direction: 4 quads a row; a thread takes quad tid % 4 of rows
  // tid / 4, + 48, ...
  float d_acc[kDirs][4];
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
#pragma unroll
    for (int c = 0; c < 4; ++c) d_acc[d][c] = 0.f;
  }
  const T* gd = static_cast<const T*>(a.g_dir);
  for (int r = tid / 4; r < rows; r += kGradThreads / 4) {
    const int64_t b = r0 + r;
    const int dir = clamp_id(a.direction[b * a.dir_stride], kDirs);
    float v[4];
    Dt<T>::unpack(reinterpret_cast<const Quad*>(gd + b * a.g_dir_row)[tid % 4], v);
#pragma unroll
    for (int d = 0; d < kDirs; ++d) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (dir == d) d_acc[d][c] += v[c];
      }
    }
  }
  __syncthreads();  // the plane sums have read the accumulators
#pragma unroll
  for (int d = 0; d < kDirs; ++d) {
#pragma unroll
    for (int c = 0; c < 4; ++c) sm[(d * 4 + c) * kGradThreads + tid] = d_acc[d][c];
  }
  __syncthreads();
  for (int o = tid; o < kDirs * kDirFeatures; o += kGradThreads) {
    const int d = o / kDirFeatures, f = o % kDirFeatures;
    const float* x = sm + (d * 4 + f % 4) * kGradThreads + f / 4;
    float s = 0.f;
    for (int t = 0; t < kGradThreads; t += 4) s += x[t];
    part[kPlaneRows * kPlaneFeatures + o] = s;
  }
}

// Backward, blockIdx.y == 1: the code table's and code_pos's partial sums
// of the block's rows.
template <typename T>
__device__ __forceinline__ void grad_mission(const GradArgs& a, float* sm, int r0, int rows,
                                             float* part) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int width = max(a.vocab, kSlots) * kCodeFeatures;  // a warp's copy
  float* s_pos = sm;  // 48 x 32, rounded to T
  float* s_tok = s_pos + kSlots * kCodeFeatures;  // vocab x 32, rounded to T
  float* s_acc = s_tok + a.vocab * kCodeFeatures;  // kGradWarps x width
  for (int i = tid; i < kSlots * kCodeFeatures; i += kGradThreads) s_pos[i] = Dt<T>::round(a.pos_w[i]);
  for (int i = tid; i < a.vocab * kCodeFeatures; i += kGradThreads) s_tok[i] = Dt<T>::round(a.code_w[i]);
  for (int i = tid; i < kGradWarps * width; i += kGradThreads) s_acc[i] = 0.f;
  __syncthreads();

  float* mine = s_acc + warp * width;
  float pos_acc[kSlots];
#pragma unroll
  for (int s = 0; s < kSlots; ++s) pos_acc[s] = 0.f;
  const T* gb = static_cast<const T*>(a.g_bag);
  for (int r = warp; r < rows; r += kGradWarps) {
    const int64_t b = r0 + r;
    const float g = Dt<T>::to_float(gb[b * a.g_bag_row + lane]);
    const int32_t* m = a.mission + b * a.mission_row;
    const int lo = m[lane * a.mission_slot];
    const int hi = lane < kSlots - 32 ? m[(32 + lane) * a.mission_slot] : 0;
#pragma unroll
    for (int s = 0; s < kSlots; ++s) {
      const int code = clamp_id(__shfl_sync(0xffffffffu, s < 32 ? lo : hi, s & 31), a.vocab);
      pos_acc[s] += Dt<T>::round(__fmul_rn(g, s_tok[code * kCodeFeatures + lane]));
      mine[code * kCodeFeatures + lane] += Dt<T>::round(__fmul_rn(g, s_pos[s * kCodeFeatures + lane]));
    }
  }
  __syncthreads();
  float* code_part = part + kFixedEntries;
  for (int o = tid; o < a.vocab * kCodeFeatures; o += kGradThreads) {
    float s = 0.f;
    for (int w = 0; w < kGradWarps; ++w) s += s_acc[w * width + o];
    code_part[o] = s;
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < kSlots; ++s) mine[s * kCodeFeatures + lane] = pos_acc[s];
  __syncthreads();
  float* pos_part = code_part + a.vocab * kCodeFeatures;
  for (int o = tid; o < kSlots * kCodeFeatures; o += kGradThreads) {
    float s = 0.f;
    for (int w = 0; w < kGradWarps; ++w) s += s_acc[w * width + o];
    pos_part[o] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kGradThreads) embed_grad_kernel(const GradArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int r0 = blockIdx.x * kGradRows;
  const int rows = min(kGradRows, a.B - r0);
  float* part = a.partials +
                static_cast<int64_t>(blockIdx.x) * (kFixedEntries + (a.vocab + kSlots) * kCodeFeatures);
  if (blockIdx.y == 0) {
    grad_planes_dir<T>(a, sm, r0, rows, part);
  } else {
    grad_mission<T>(a, sm, r0, rows, part);
  }
}

// The partials summed over the blocks: kSumGroups runs of consecutive
// blocks side by side, each in block order, then the runs in order.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumGroups) embed_grad_sum_kernel(const GradArgs a,
                                                                               int blocks) {
  __shared__ float s_run[kSumGroups][kSumCols];
  const int entries = kFixedEntries + (a.vocab + kSlots) * kCodeFeatures;
  const int col = threadIdx.x % kSumCols, run = threadIdx.x / kSumCols;
  const int o = blockIdx.x * kSumCols + col;
  float acc = 0.f;
  if (o < entries) {
    const int per = (blocks + kSumGroups - 1) / kSumGroups;
    const int b1 = min(blocks, (run + 1) * per);
    const float* x = a.partials + o;
#pragma unroll 8
    for (int b = run * per; b < b1; ++b) acc += x[static_cast<int64_t>(b) * entries];
  }
  s_run[run][col] = acc;
  __syncthreads();
  if (run != 0 || o >= entries) return;
  float s = s_run[0][col];
  for (int r = 1; r < kSumGroups; ++r) s += s_run[r][col];
  const int code0 = kFixedEntries, pos0 = code0 + a.vocab * kCodeFeatures;
  if (o < 128) {
    a.grad_plane0[o] = s;
  } else if (o < 192) {
    a.grad_plane1[o - 128] = s;
  } else if (o < 224) {
    a.grad_plane2[o - 192] = s;
  } else if (o < code0) {
    a.grad_dir[o - 224] = s;
  } else if (o < pos0) {
    a.grad_code[o - code0] = s;
  } else {
    a.grad_pos[o - pos0] = Dt<T>::round(s);
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

size_t fwd_shared_bytes(int vocab, int elem) {
  return static_cast<size_t>(kPlaneRows * kPlaneFeatures + kDirs * kDirFeatures) * elem +
         static_cast<size_t>(kSlots + vocab) * kCodeFeatures * sizeof(float);
}

size_t grad_shared_bytes(int vocab) {
  const size_t planes = static_cast<size_t>(kQuadAcc) * kGradThreads * sizeof(float);
  const size_t mission = (static_cast<size_t>(kSlots + vocab) +
                          static_cast<size_t>(kGradWarps) * (vocab > kSlots ? vocab : kSlots)) *
                         kCodeFeatures * sizeof(float);
  return planes > mission ? planes : mission;
}

// Shared memory beyond 48 KB needs the kernel's attribute, set before
// each launch (a host call that a stream capture allows).
template <typename K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
cudaError_t launch_forward(const FwdArgs& a, cudaStream_t s) {
  const size_t bytes = fwd_shared_bytes(a.vocab, sizeof(T));
  cudaError_t e = allow_shared(embed_kernel<T>, bytes);
  if (e != cudaSuccess) return e;
  embed_kernel<T><<<(a.B + kFwdRows - 1) / kFwdRows, kFwdThreads, bytes, s>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_backward(const GradArgs& a, cudaStream_t s) {
  const size_t bytes = grad_shared_bytes(a.vocab);
  cudaError_t e = allow_shared(embed_grad_kernel<T>, bytes);
  if (e != cudaSuccess) return e;
  const int blocks = (a.B + kGradRows - 1) / kGradRows;
  embed_grad_kernel<T><<<dim3(blocks, 2), kGradThreads, bytes, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int entries = kFixedEntries + (a.vocab + kSlots) * kCodeFeatures;
  embed_grad_sum_kernel<T><<<(entries + kSumCols - 1) / kSumCols, kSumCols * kSumGroups, 0, s>>>(
      a, blocks);
  return cudaGetLastError();
}

}  // namespace

// The forward: T is bf16 where `bf16` is 1, float32 where it is 0.
extern "C" int embed_launch(const FwdArgs* args, int bf16, void* stream) {
  const FwdArgs& a = *args;
  if (a.B < 0 || a.cells < 1 || a.vocab < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(a.planes) || !aligned16(a.dir_out)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (a.B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_forward<__nv_bfloat16>(a, s) : launch_forward<float>(a, s));
}

// The backward's two launches: the partial sums into `partials`
// (embed_grad_scratch(B, vocab) floats), then their sums into the six
// gradients.
extern "C" int embed_grad_launch(const GradArgs* args, int bf16, void* stream) {
  const GradArgs& a = *args;
  if (a.B < 0 || a.cells < 1 || a.vocab < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int quad = bf16 ? 8 : 16;
  if (!aligned16(a.g_planes) || reinterpret_cast<uintptr_t>(a.g_dir) % quad != 0 ||
      (a.g_dir_row * (bf16 ? 2 : 4)) % quad != 0) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  if (a.B == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(bf16 ? launch_backward<__nv_bfloat16>(a, s) : launch_backward<float>(a, s));
}

// Floats of a backward's scratch for B rows: a partial sum of each of the
// gradients' entries, in order, for each block of kGradRows rows.
extern "C" int embed_grad_scratch(int B, int vocab) {
  return (B + kGradRows - 1) / kGradRows * (kFixedEntries + (vocab + kSlots) * kCodeFeatures);
}

// sizeof(FwdArgs) and sizeof(GradArgs), which the caller's mirrors must match.
extern "C" int embed_args_bytes() { return static_cast<int>(sizeof(FwdArgs)); }
extern "C" int embed_grad_args_bytes() { return static_cast<int>(sizeof(GradArgs)); }
