// Data-dependent branches inside a CUDA-graph capture: the JAX package's
// lax.switch and lax.cond (aicamera_tpu/runtime/pipeline.py:628-630, the
// ReID bucket; :109 and :121, the capacity-bucketed scan) as conditional
// nodes, so that a captured chunk step decides its branches on the device
// and the host reads nothing.
//
// A branch site with n bodies becomes, in the graph being captured on the
// parent stream:
//
//   set kernel (reads the int32 index on the device, sets the handle)
//     -> SWITCH node of n bodies -> (the rest)
//
// The SWITCH node runs body j when the index is j, and none when the index
// is outside [0, n); a body sees every write made before the site and the
// node after the site sees the taken body's writes. Each body is captured
// on a body stream into a graph of its own (aicam_branch_body_begin/end)
// and added to the node's body graph for it as one child-graph node; a body
// may hold kernels, device copies and memsets only (no host nodes, no
// events, no read back to the host). A capture that fails leaves that body
// graph empty and the parent capture whole.
//
// Plain C interface (ctypes), no PyTorch headers. Every function returns a
// cudaError_t (0 on success). Needs CUDA 12.8 or later (SWITCH nodes), on
// the host and the device alike.

#include <cuda_runtime.h>

namespace {

// One thread: the site's handle <- its index (a negative index is out of
// range as an unsigned value too).
__global__ void set_branch(cudaGraphConditionalHandle handle,
                           const int* index) {
  cudaGraphSetConditional(handle, static_cast<unsigned int>(*index));
}

}  // namespace

extern "C" {

// Adds a branch site to the graph that `parent` is capturing: the set
// kernel, then one SWITCH node of n bodies. Writes the body graphs to
// bodies[0..n) (fill them with aicam_branch_body_begin/end) and makes the
// node the parent stream's capture dependency.
int aicam_branch_begin(void* parent, int n, const void* index,
                       void** bodies) {
  if (n < 1) return cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(parent);
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph,
                                             &deps, &n_deps);
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) {
    return cudaErrorStreamCaptureImplicit;
  }
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return err;
  set_branch<<<1, 1, 0, stream>>>(handle, static_cast<const int*>(index));
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // the set kernel is now the stream's dependency
  err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps,
                                 &n_deps);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeSwitch;
  params.conditional.size = static_cast<unsigned int>(n);
  cudaGraphNode_t node = nullptr;
  err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (err != cudaSuccess) return err;
  for (int j = 0; j < n; ++j) bodies[j] = params.conditional.phGraph_out[j];
  return cudaStreamUpdateCaptureDependencies(stream, &node, 1,
                                             cudaStreamSetCaptureDependencies);
}

// Creates a non-blocking stream on `device` for capturing bodies (not one
// of PyTorch's pooled streams, one of which a capture may be using).
int aicam_branch_stream(int device, void** out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t stream = nullptr;
  err = cudaStreamCreateWithFlags(&stream, cudaStreamNonBlocking);
  *out = stream;
  return err;
}

// Starts capturing `stream` into a graph of its own (one body).
int aicam_branch_body_begin(void* stream) {
  return cudaStreamBeginCapture(static_cast<cudaStream_t>(stream),
                                cudaStreamCaptureModeGlobal);
}

// Ends the body's capture. With `body` given (one of a SWITCH node's body
// graphs), adds the captured graph to it as one child-graph node and
// writes the captured graph's node count to *nodes; with `body` null (the
// body raised), drops it. The captured graph is destroyed either way (the child
// node holds a copy).
int aicam_branch_body_end(void* stream, void* body,
                          unsigned long long* nodes) {
  cudaGraph_t child = nullptr;
  cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream),
                                         &child);
  if (err == cudaSuccess && body != nullptr) {
    size_t n = 0;
    err = cudaGraphGetNodes(child, nullptr, &n);
    *nodes = n;
    if (err == cudaSuccess) {
      cudaGraphNode_t node = nullptr;
      err = cudaGraphAddChildGraphNode(&node, static_cast<cudaGraph_t>(body),
                                       nullptr, 0, child);
    }
  }
  if (child != nullptr) cudaGraphDestroy(child);
  return err;
}

const char* aicam_branch_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
