// A WHILE conditional node for a CUDA graph under stream capture.
//
// The unfused peel (repro_torch/exec/peel.py) captures its trip loop into
// one CUDA graph: one trip is the body of a WHILE node whose condition the
// device computes before the first trip and again at the end of each.
// PyTorch 2.11 cannot capture a conditional node, so this file adds the
// node through the CUDA runtime, with a plain C interface for ctypes:
//
//   graph_while_begin(capture, pred, body, mode, handle): on the capturing
//     stream `capture`, create a conditional handle in the graph being
//     captured, capture a one-thread kernel that sets it from the device
//     bool at `pred` (the loop's first condition), add a WHILE node after
//     it, make the node the capture's only dependency, and start capturing
//     stream `body` into the node's body graph in capture mode `mode` (a
//     cudaStreamCaptureMode, the outer capture's).  Writes the handle to
//     `*handle`.  Work launched on `body` until graph_while_end is the body.
//   graph_while_end(body, handle, pred): capture, at the end of the body,
//     the kernel that sets `handle` from the device bool at `pred` (the
//     next trip's condition; none when `pred` is null), then end the
//     body's capture.
//
// Nothing here launches anything outside a capture.  Needs a CUDA 12.4+
// runtime and driver (graph_while_versions reports both).

#include <cuda_runtime.h>

namespace {

__global__ void set_handle(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

cudaError_t capture_deps(cudaStream_t s, cudaGraph_t* graph, const cudaGraphNode_t** deps,
                         size_t* ndeps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorStreamCaptureUnmatched;
}

}  // namespace

extern "C" {

int graph_while_versions(int* runtime, int* driver) {
  cudaError_t err = cudaRuntimeGetVersion(runtime);
  if (err != cudaSuccess) return err;
  return cudaDriverGetVersion(driver);
}

int graph_while_begin(void* capture, const void* pred, void* body, int mode,
                      unsigned long long* handle_out) {
  const cudaStream_t s = static_cast<cudaStream_t>(capture);
  cudaGraph_t graph;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
  cudaError_t err;
  if ((err = capture_deps(s, &graph, &deps, &ndeps)) != cudaSuccess) return err;

  cudaGraphConditionalHandle handle;
  if ((err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0)) != cudaSuccess) return err;
  set_handle<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = capture_deps(s, &graph, &deps, &ndeps)) != cudaSuccess) return err;

  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeWhile;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
#endif
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *handle_out = handle;
  return cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body),
                                       params.conditional.phGraph_out[0], nullptr, nullptr, 0,
                                       static_cast<cudaStreamCaptureMode>(mode));
}

int graph_while_end(void* body, unsigned long long handle, const void* pred) {
  const cudaStream_t s = static_cast<cudaStream_t>(body);
  cudaError_t launched = cudaSuccess;
  if (pred) {  // null: abandon the body (its caller reports its own error)
    set_handle<<<1, 1, 0, s>>>(handle, static_cast<const bool*>(pred));
    launched = cudaGetLastError();
  }
  cudaGraph_t graph;  // the WHILE node's body graph, owned by the node
  const cudaError_t ended = cudaStreamEndCapture(s, &graph);
  return launched != cudaSuccess ? launched : ended;
}

const char* graph_while_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
