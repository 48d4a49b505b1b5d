// The device mark of the port's tracer (utils/tracing.py): one thread that
// reads the card's nanosecond clock and adds the time since the last mark
// to the phase the mark closes.
//
// Launched on the search's stream between two of its kernels, so the stream
// runs it after the kernels before it end and before those after it start;
// recorded in a CUDA graph, it runs at the same point of every replay and
// adds into the same buffer, so the phases sum over every replay with no
// host sync. %globaltimer is the card's clock in ns, the same on every SM.
//
// state (int64): [0] the last mark's time, [1] runs (marks that close
// nothing), [2 + p] the ns of phase p.

#include <cuda_runtime.h>

namespace {

__global__ void trace_stamp_kernel(unsigned long long* state, int close) {
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (close >= 0) {
        state[2 + close] += now - state[0];
    } else {
        state[1] += 1;
    }
    state[0] = now;
}

}  // namespace

extern "C" int trace_stamp(void* state, int close, void* stream) {
    trace_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (unsigned long long*)state, close);
    return (int)cudaGetLastError();
}
