// IF nodes for CUDA graphs captured from a stream: the counterpart of
// torch.cuda.CUDAGraph.begin_capture_to_if_node / end_capture_to_conditional_node,
// which the card's PyTorch build lacks. utils/graphs.py calls these through
// ctypes while a StepGraph is being captured.
//
// graph_if_begin: on `stream` (capturing), create a conditional handle in the
// graph being captured, capture a one-thread kernel that sets the handle from
// the bool at `pred` (negated when `negate`), add an IF node after the
// stream's current dependencies and make it the stream's only dependency,
// then start capturing `body_stream` into the node's body graph. Work issued
// on `body_stream` until graph_if_end runs only when the handle is 1 at
// replay. Needs CUDA 12.4 or later (conditional nodes from stream capture).

#include <cuda_runtime.h>

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const unsigned char* pred,
                              int negate) {
  unsigned int v = pred[0] != 0 ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? v ^ 1u : v);
}

extern "C" int graph_if_begin(void* stream, void* body_stream, const void* pred, int negate) {
  cudaStream_t s = (cudaStream_t)stream;
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
  set_if_kernel<<<1, 1, 0, s>>>(handle, (const unsigned char*)pred, negate);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, cudaStreamCaptureModeRelaxed);
}

// One more execution of the node whose body this is captured into: a
// one-thread kernel adding 1 to counts[slot] (a StepGraph's launch count,
// utils/graphs.py::counting).
__global__ void count_if_kernel(unsigned long long* counts, int slot) {
  atomicAdd(counts + slot, 1ull);
}

extern "C" int graph_if_count(void* stream, void* counts, int slot) {
  count_if_kernel<<<1, 1, 0, (cudaStream_t)stream>>>((unsigned long long*)counts, slot);
  return (int)cudaGetLastError();
}

// End the body capture that graph_if_begin started on `body_stream`; the
// body graph's node count (an inner IF node counts as one) into *n_nodes.
extern "C" int graph_if_end(void* body_stream, unsigned long long* n_nodes) {
  cudaGraph_t body;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)body_stream, &body);
  if (e != cudaSuccess) return (int)e;
  size_t n = 0;
  e = cudaGraphGetNodes(body, nullptr, &n);
  *n_nodes = (unsigned long long)n;
  return (int)e;
}

// The node count of the graph `stream` is capturing (its top level: an IF
// node counts as one) into *n_nodes.
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
