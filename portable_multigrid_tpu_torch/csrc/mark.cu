// Span marker: one thread that stamps the device's clock into a slot.
//
// Replaces no TPU kernel: the JAX package's V-cycle runs inside one jitted
// program and places no span in it.  The port replays its V-cycle from one
// CUDA graph (solvers/vcycle.py GraphedVCycle), where host ranges run only
// at capture; a traced graph holds one marker at the entry and one at the
// exit of each device span (utils/profiling.py SpanPlan), so the split of a
// replay into levels and phases is read on the device's own clock.
//
// The buffer is int64 [2, capacity]: row 0 the stamp of each slot's last
// run, row 1 a sum per slot.  Slot k adds the nanoseconds since slot k - 1
// stamped, the interval that ends at this marker; slot 0, the first of a
// replay, counts replays instead.  Kernels of one stream run in order, so
// the intervals of a replay tile it from its first marker to its last.
//
// What bounds it: the launch.  One thread reads %globaltimer and writes
// three int64 values; a marker in a graph costs about a kernel node's
// dispatch, a few microseconds.
#include <cuda_runtime.h>

__global__ void pmg_span_marker(long long* stamps, long long* sums, int slot) {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  if (slot == 0) {
    sums[0] += 1;
  } else {
    sums[slot] += t - stamps[slot - 1];
  }
  stamps[slot] = t;
}

extern "C" int pmg_mark(long long* buffer, int capacity, int slot,
                        void* stream) {
  if (slot < 0 || slot >= capacity) return (int)cudaErrorInvalidValue;
  pmg_span_marker<<<1, 1, 0, (cudaStream_t)stream>>>(buffer,
                                                      buffer + capacity, slot);
  return (int)cudaGetLastError();
}
