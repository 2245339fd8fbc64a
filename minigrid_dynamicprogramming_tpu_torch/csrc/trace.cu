// Stamps that time the spans inside a captured CUDA graph
// (utils/profiling.py: graph_span, GraphStamps).
//
// It replaces no TPU kernel.  A CUDA graph's replay reaches torch.profiler
// as one launch of many anonymous kernels, so the parts of a captured step
// (parallel/lanes.py: the transition, the select, the observation, the
// generator) are timed by the device itself: a span's entry captures
// stamp_open, which writes the device's nanosecond clock (%globaltimer)
// into the span's slot, and its exit stamp_close, which adds the time
// since to the slot's sum and one to its count.  The kernels of one stream
// run in order, so the two stamps bracket the span's kernels on every
// replay, and the sums are read once, after the replays, with no
// synchronise between them.
//
// What bounds it: the launch.  Each stamp is one thread that touches 24
// bytes; its cost is a graph node's, about a microsecond of device time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<int64_t>(t);
}

// slots: (start ns, summed ns, count) per slot, int64.
__global__ void stamp_open(int64_t* slots, int slot) { slots[3 * slot] = global_ns(); }

__global__ void stamp_close(int64_t* slots, int slot) {
  int64_t* s = slots + 3 * slot;
  s[1] += global_ns() - s[0];
  s[2] += 1;
}

}  // namespace

// One stamp on `stream`: stamp_close if `close`, else stamp_open.
// Returns the launch's cudaError_t.
extern "C" int trace_stamp(int64_t* slots, int slot, int close, cudaStream_t stream) {
  if (close) {
    stamp_close<<<1, 1, 0, stream>>>(slots, slot);
  } else {
    stamp_open<<<1, 1, 0, stream>>>(slots, slot);
  }
  return static_cast<int>(cudaGetLastError());
}

// The number of nodes of a captured graph, into *count.
extern "C" int trace_graph_nodes(cudaGraph_t graph, size_t* count) {
  return static_cast<int>(cudaGraphGetNodes(graph, nullptr, count));
}
