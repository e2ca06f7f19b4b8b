// Conditional WHILE nodes in a CUDA graph being captured: the port's
// counterpart of lax.while_loop under jax.jit (robot_mpcs_tpu/solver/
// al_ilqr.py:750, 818, 890), so that a whole solve, or a whole fleet step,
// is one graph whose loops test their flag on the device.
//
// A plain C interface, loaded with ctypes (ops/graph_cond.py), modelled on
// at::cuda::CUDAGraph::begin_capture_to_if_node /
// end_capture_to_conditional_node with the node's kind set to WHILE:
//
//   graph_cond_while_begin(stream, flag, body_stream, &handle, &body)
//       on a stream that is capturing: a one-thread kernel sets a new
//       conditional handle from *flag (a bool on the device), a WHILE node
//       on that handle is added after it, and body_stream starts capturing
//       into the node's body graph;
//   graph_cond_while_end(body_stream, handle, flag, &nodes)
//       a one-thread kernel at the end of the body sets the handle from
//       *flag again (the loop's test), and the body's capture ends;
//   graph_cond_abort(body_stream)
//       ends the body's capture after a failure, whatever its state.
//
// The node runs its body while the handle is non-zero: zero times when the
// flag is false at entry, as lax.while_loop does. What the body allocates is
// the caller's business (ops/graph_cond.py routes it to a memory pool).
// The work is a handful of graph API calls at capture time and one
// one-thread kernel per loop test at run time: latency, not bytes or
// operations, is all it costs.

#include <cuda_runtime.h>

#if CUDART_VERSION < 12040
#error "conditional WHILE nodes that nest need CUDA 12.4 or newer"
#endif

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

}  // namespace

extern "C" {

// The CUDA runtime this library was built with and the driver's version
// (CUDA_VERSION-style integers, 12040 for 12.4).
int graph_cond_versions(int* runtime, int* driver) {
    cudaError_t err = cudaRuntimeGetVersion(runtime);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDriverGetVersion(driver);
}

int graph_cond_while_begin(void* stream_ptr, const void* flag, void* body_stream_ptr,
                           unsigned long long* handle_out, void** body_out) {
    cudaStream_t stream = (cudaStream_t)stream_ptr;
    cudaStream_t body_stream = (cudaStream_t)body_stream_ptr;
    cudaStreamCaptureStatus status;
    unsigned long long id = 0;
    cudaGraph_t graph = nullptr;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, nullptr, &n_deps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
#endif
    if (err != cudaSuccess) return (int)err;
    if (status != cudaStreamCaptureStatusActive) return (int)cudaErrorStreamCaptureImplicit;

    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return (int)err;
    // the loop's first test: the setter is captured into the enclosing graph
    set_condition<<<1, 1, 0, stream>>>(handle, (const bool*)flag);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
#if CUDART_VERSION >= 13000
    err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, nullptr, &n_deps);
#else
    err = cudaStreamGetCaptureInfo(stream, &status, &id, &graph, &deps, &n_deps);
#endif
    if (err != cudaSuccess) return (int)err;

    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = handle;
    params.conditional.type = cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
    if (err != cudaSuccess) return (int)err;
    cudaGraph_t body = params.conditional.phGraph_out[0];
    // the enclosing capture goes on after the node
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(stream, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(stream, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) return (int)err;
    err = cudaStreamBeginCaptureToGraph(body_stream, body, nullptr, nullptr, 0,
                                        cudaStreamCaptureModeThreadLocal);
    if (err != cudaSuccess) return (int)err;
    *handle_out = (unsigned long long)handle;
    *body_out = (void*)body;
    return 0;
}

int graph_cond_while_end(void* body_stream_ptr, unsigned long long handle, const void* flag,
                         unsigned long long* nodes_out) {
    cudaStream_t body_stream = (cudaStream_t)body_stream_ptr;
    // the loop's test after each trip
    set_condition<<<1, 1, 0, body_stream>>>((cudaGraphConditionalHandle)handle, (const bool*)flag);
    cudaError_t launch = cudaGetLastError();
    cudaGraph_t body = nullptr;
    cudaError_t err = cudaStreamEndCapture(body_stream, &body);
    if (launch != cudaSuccess) return (int)launch;
    if (err != cudaSuccess) return (int)err;
    size_t n = 0;
    err = cudaGraphGetNodes(body, nullptr, &n);
    *nodes_out = (unsigned long long)n;
    return (int)err;
}

int graph_cond_abort(void* body_stream_ptr) {
    cudaStream_t body_stream = (cudaStream_t)body_stream_ptr;
    cudaStreamCaptureStatus status;
    cudaError_t err = cudaStreamIsCapturing(body_stream, &status);
    if (err == cudaSuccess && status != cudaStreamCaptureStatusNone) {
        cudaGraph_t body = nullptr;
        cudaStreamEndCapture(body_stream, &body);
    }
    cudaGetLastError();  // clear what the failed capture left
    return 0;
}

// Nodes at the top level of a graph (a conditional node counts as one).
int graph_cond_count_nodes(void* graph, unsigned long long* nodes_out) {
    size_t n = 0;
    cudaError_t err = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
    *nodes_out = (unsigned long long)n;
    return (int)err;
}

}  // extern "C"
