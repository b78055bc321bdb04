// IF and WHILE nodes for CUDA graphs captured from a stream: the counterpart
// of torch.cuda.CUDAGraph.begin_capture_to_if_node /
// end_capture_to_conditional_node (and of a WHILE node, which torch does not
// offer), which the card's PyTorch build lacks. utils/graphs.py calls these
// through ctypes while a StepGraph is being captured.
//
// graph_if_begin: on `stream` (capturing), create a conditional handle in the
// graph being captured, capture a one-thread kernel that sets the handle from
// the bool at `pred` (negated when `negate`), add an IF node after the
// stream's current dependencies and make it the stream's only dependency,
// then start capturing `body_stream` into the node's body graph. Work issued
// on `body_stream` until graph_if_end runs only when the handle is 1 at
// replay. Needs CUDA 12.4 or later (conditional nodes from stream capture).
//
// graph_while_begin / graph_while_end: the same with a WHILE node, whose body
// runs again for as long as its handle is 1 at the body's end (a trip).
// Its trip counter is the int64 at `counter`: the begin kernel sets it to 0
// and the handle to `pred && 0 < cap`; graph_while_end captures, as the
// body's last kernel, one that adds 1 to it and sets the handle to
// `pred && counter < cap` from the flag the body wrote.

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred,
                              int negate) {
  unsigned int v = pred[0] != 0 ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? v ^ 1u : v);
}

// Create a handle in the graph `s` is capturing, capture `set` (a one-thread
// kernel launch on `s` that sets the handle), add a conditional node of
// `type` after the stream's dependencies, make it the only one, and start
// capturing `body_stream` into the node's body graph.
template <typename SetFn>
static int begin_conditional(cudaStream_t s, void* body_stream, cudaGraphConditionalNodeType type,
                             unsigned long long* handle_out, SetFn set) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set(handle);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = type;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  if (handle_out) *handle_out = (unsigned long long)handle;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeRelaxed);
}

extern "C" int graph_if_begin(void* stream, void* body_stream, const void* pred, int negate) {
  cudaStream_t s = (cudaStream_t)stream;
  return begin_conditional(s, body_stream, cudaGraphCondTypeIf, nullptr,
                           [&](cudaGraphConditionalHandle h) {
                             set_if_kernel<<<1, 1, 0, s>>>(h, (const unsigned char*)pred, negate);
                           });
}

// A WHILE node's handle from its flag and trip counter: `first` starts the
// count at 0, else it goes up by one (the trip that just ended).
__global__ void set_while_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred,
                                 long long* counter, long long cap, int first) {
  long long c = first ? 0 : counter[0] + 1;
  counter[0] = c;
  cudaGraphSetConditional(handle, (pred[0] != 0 && c < cap) ? 1u : 0u);
}

extern "C" int graph_while_begin(void* stream, void* body_stream, const void* pred,
                                 void* counter, long long cap, unsigned long long* handle) {
  cudaStream_t s = (cudaStream_t)stream;
  return begin_conditional(s, body_stream, cudaGraphCondTypeWhile, handle,
                           [&](cudaGraphConditionalHandle h) {
                             set_while_kernel<<<1, 1, 0, s>>>(h, (const unsigned char*)pred,
                                                              (long long*)counter, cap, 1);
                           });
}

// One more execution of the node whose body this is captured into (an IF
// node's execution, a WHILE node's trip): a one-thread kernel adding 1 to counts[slot] (a StepGraph's launch count,
// utils/graphs.py::counting).
__global__ void count_if_kernel(unsigned long long* counts, int slot) {
  atomicAdd(counts + slot, 1ull);
}

extern "C" int graph_if_count(void* stream, void* counts, int slot) {
  count_if_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)counts, slot);
  return (int)cudaGetLastError();
}

// End the body capture that graph_if_begin started on `body_stream`; the
// body graph's node count (an inner conditional node counts as one) into
// *n_nodes.
extern "C" int graph_if_end(void* body_stream, unsigned long long* n_nodes) {
  cudaGraph_t body;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)body_stream, &body);
  if (e != cudaSuccess) return (int)e;
  size_t n = 0;
  e = cudaGraphGetNodes(body, nullptr, &n);
  *n_nodes = (unsigned long long)n;
  return (int)e;
}

// End a WHILE body that graph_while_begin started on `body_stream`: capture
// the kernel that counts the trip and sets `handle` again from the flag at
// `pred` and the counter, then end the capture as graph_if_end does.
extern "C" int graph_while_end(void* body_stream, unsigned long long handle, const void* pred,
                               void* counter, long long cap, unsigned long long* n_nodes) {
  set_while_kernel<<<1, 1, 0, (cudaStream_t)body_stream>>>(
      (cudaGraphConditionalHandle)handle, (const unsigned char*)pred, (long long*)counter, cap, 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) {
    cudaGraph_t body;
    cudaStreamEndCapture((cudaStream_t)body_stream, &body);  // leave no capture open
    return (int)e;
  }
  return graph_if_end(body_stream, n_nodes);
}

// The node count of the graph `stream` is capturing (its top level: a
// conditional node counts as one) into *n_nodes.
extern "C" int graph_capture_nodes(void* stream, unsigned long long* n_nodes) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph;
  cudaError_t e = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, nullptr, &graph,
                                           nullptr, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;
  size_t n = 0;
  e = cudaGraphGetNodes(graph, nullptr, &n);
  *n_nodes = (unsigned long long)n;
  return (int)e;
}

// A non-blocking stream of its own for body captures (never one of the
// streams PyTorch hands out, which a capture may already hold).
extern "C" int graph_stream_create(void** out) {
  cudaStream_t s;
  cudaError_t e = cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking);
  *out = (void*)s;
  return (int)e;
}

// Spans (utils/graphs.py::span): stamps of the card's %globaltimer (ns) in
// the same int64 buffer as the node counters. The open stamp writes the
// time into counts[open]; the close stamp adds now - counts[open] to
// counts[total] and 1 to counts[count], and with a ring (a StepGraph's
// top-level span) also writes (open, now) into entry counts[count] mod
// ring_len of it (the replay's number). Each is a one-thread kernel node, so
// a span may sit inside IF and WHILE bodies.
__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return (long long)t;
}

__global__ void span_open_kernel(long long* counts, int open) { counts[open] = global_ns(); }

__global__ void span_close_kernel(long long* counts, int open, int total, int count,
                                  long long* ring, int ring_len) {
  long long t = global_ns();
  long long o = counts[open];
  long long n = counts[count];
  counts[total] += t - o;
  counts[count] = n + 1;
  if (ring != nullptr) {
    int r = (int)(n % ring_len);
    ring[2 * r] = o;
    ring[2 * r + 1] = t;
  }
}

extern "C" int graph_span_open(void* stream, void* counts, int open) {
  span_open_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)counts, open);
  return (int)cudaGetLastError();
}

extern "C" int graph_span_close(void* stream, void* counts, int open, int total, int count,
                                void* ring, int ring_len) {
  span_close_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)counts, open, total, count,
                                                       (long long*)ring, ring_len);
  return (int)cudaGetLastError();
}

// The clock's calibration (utils/graphs.py::calibrate): %globaltimer into
// out[0] by one thread, between two host clock reads around a synchronize.
__global__ void clock_stamp_kernel(long long* out) { out[0] = global_ns(); }

extern "C" int graph_clock_stamp(void* stream, void* out) {
  clock_stamp_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out);
  return (int)cudaGetLastError();
}

// %globaltimer's resolution: one thread reads it until it has changed `steps`
// times (or `spins` reads went by) -> out[0] the smallest change seen (ns),
// out[1] the changes seen, out[2] the reads made.
__global__ void clock_step_kernel(long long* out, int steps, long long spins) {
  long long last = global_ns(), best = -1, seen = 0, reads = 0;
  while (seen < steps && reads < spins) {
    long long t = global_ns();
    ++reads;
    if (t != last) {
      long long d = t - last;
      if (best < 0 || d < best) best = d;
      last = t;
      ++seen;
    }
  }
  out[0] = best;
  out[1] = seen;
  out[2] = reads;
}

extern "C" int graph_clock_step(void* stream, void* out, int steps, long long spins) {
  clock_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((long long*)out, steps, spins);
  return (int)cudaGetLastError();
}
