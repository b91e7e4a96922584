// Conditional nodes for CUDA graphs captured from PyTorch streams.
//
// vlgp_tpu runs its data-dependent branches and loop exits on the device
// with lax.cond and lax.while_loop (vlgp_tpu/ops/spd.py:252-256, :957;
// vlgp_tpu/ops/ichol.py:151-158; vlgp_tpu/models/vlgp.py:249-260,
// :277-284, :486-497).  The port records them into a CUDA graph as IF
// nodes (CUDA 12.4+), driven from ops/control.py:
//
//   vlgp_cond_handle  creates a conditional handle in the graph that
//                     `stream` is capturing, and captures a one-thread
//                     kernel that sets it from a device bool (or its
//                     negation) when the graph runs;
//   vlgp_if_begin     adds an IF node on that handle after the stream's
//                     current capture dependencies, makes the node the
//                     stream's only dependency, and starts capturing
//                     `body_stream` into the node's body graph;
//   vlgp_if_end       ends the body's capture.
//
// The handle is set by a kernel of the same graph, so the branch is decided
// on the device at replay: a skipped body costs one conditional node and
// launches nothing.  torch 2.11 (the card's build) has no Python binding
// for IF nodes (CUDAGraph.begin_capture_to_if_node came later), which is
// why the port carries these three calls.  Memory that a body allocates
// comes from the private pool that ops/control.py routes `body_stream` to.
//
// What bounds it: nothing of note; the set kernel is one thread.  Each
// entry point returns a cudaError_t (0 on success; cudaErrorIllegalState
// when `stream` is not capturing).

#include "ns_common.cuh"

namespace {

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const unsigned char* pred, int negate) {
  unsigned int value = pred[0] != 0;
  cudaGraphSetConditional(handle, negate ? !value : value);
}

cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* ndeps) {
  cudaStreamCaptureStatus status;
  unsigned long long id;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, nullptr, ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, graph, deps, ndeps);
#endif
  if (err != cudaSuccess) return err;
  return status == cudaStreamCaptureStatusActive ? cudaSuccess : cudaErrorIllegalState;
}

}  // namespace

extern "C" {

int vlgp_cond_handle(void* stream, const unsigned char* pred, int negate,
                     unsigned long long* handle_out) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphConditionalHandle handle;
  err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (err != cudaSuccess) return (int)err;
  set_conditional_kernel<<<1, 1, 0, s>>>(handle, pred, negate);
  *handle_out = (unsigned long long)handle;
  return (int)cudaGetLastError();
}

int vlgp_if_begin(void* stream, const unsigned long long* handle, void* body_stream,
                  int mode) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t ndeps;
  cudaError_t err = capture_info(s, &graph, &deps, &ndeps);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = (cudaGraphConditionalHandle)*handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  err = cudaGraphAddNode(&node, graph, deps, nullptr, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                            cudaStreamSetCaptureDependencies);
#else
  err = cudaGraphAddNode(&node, graph, deps, ndeps, &params);
  if (err != cudaSuccess) return (int)err;
  err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return (int)err;
  return (int)cudaStreamBeginCaptureToGraph((cudaStream_t)body_stream,
                                            params.conditional.phGraph_out[0], nullptr,
                                            nullptr, 0, (cudaStreamCaptureMode)mode);
}

int vlgp_if_end(void* body_stream) {
  cudaGraph_t body;
  return (int)cudaStreamEndCapture((cudaStream_t)body_stream, &body);
}

}  // extern "C"
