// CUDA graph conditional nodes under stream capture: IF and WHILE nodes whose
// bodies are captured from PyTorch ops.  It replaces no Pallas kernel: it is
// the port's `lax.cond` / `lax.while_loop` inside a captured step
// (eskf_lio_torch/utils/graphs.py; the JAX package's are at
// eskf_lio_tpu/map/voxel_map.py:615 and eskf_lio_tpu/models/registration.py:298).
// PyTorch 2.11 has no public call for these nodes, so they are made here with
// the CUDA runtime (CUDA 12.4 or later).
//
// A conditional node is added to the graph that a stream is capturing, after
// the stream's current dependencies; its body graph is then captured from a
// second stream (cudaStreamBeginCaptureToGraph).  The node's condition is set
// on the device by `graph_cond_set_kernel`, one thread reading a bool that
// earlier work in the same graph wrote (for a WHILE node, also the last work
// of its body): bound by its launch, ~2 us, nothing to move.  Every entry
// point returns cudaGetLastError() or the failing call's error.
//
// `graph_cond_stamp` launches the tracer's stamp (eskf_lio_torch/utils/
// profiling.py): one thread reads %globaltimer and writes (tag, ns) into a
// ring of (tag, ns) pairs at a cursor on the device that it advances itself,
// so that a replay of a graph holding stamps needs no host read.  Launched
// only for a step built with a tracer; bound by its launch, like the
// condition kernel.

#include <cuda_runtime.h>

namespace {

__global__ void graph_cond_set_kernel(cudaGraphConditionalHandle handle, const bool* pred) {
    cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

__global__ void graph_cond_stamp_kernel(long long* ring, unsigned long long* cursor, long long tag,
                                        unsigned long long mask) {
    unsigned long long ns;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
    const unsigned long long i = *cursor & mask;
    ring[2 * i] = tag;
    ring[2 * i + 1] = static_cast<long long>(ns);
    *cursor += 1;
}

}  // namespace

extern "C" {

const char* graph_cond_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int graph_cond_runtime_version() { return CUDART_VERSION; }

// A new conditional handle of the graph that `stream` is capturing.
int graph_cond_handle_create(void* stream, unsigned long long* handle_out) {
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(
        static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr, nullptr, nullptr);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(
        static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr, nullptr);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
    cudaGraphConditionalHandle handle;
    err = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
    if (err != cudaSuccess) return err;
    *handle_out = static_cast<unsigned long long>(handle);
    return cudaSuccess;
}

// Capture, on `stream`, the kernel that sets `handle` from the bool at `pred`.
int graph_cond_set(unsigned long long handle, const void* pred, void* stream) {
    graph_cond_set_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<cudaGraphConditionalHandle>(handle), static_cast<const bool*>(pred));
    return cudaGetLastError();
}

// Launch, on `stream`, the stamp of `tag` into `ring` (mask + 1 pairs) at
// `cursor`.
int graph_cond_stamp(void* ring, void* cursor, long long tag, unsigned long long mask, void* stream) {
    graph_cond_stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<long long*>(ring), static_cast<unsigned long long*>(cursor), tag, mask);
    return cudaGetLastError();
}

// Add a conditional node (kind 0: IF, 1: WHILE) on `handle` to the graph
// that `stream` is capturing, after the stream's dependencies; the stream's
// later work depends on the node.  Returns the node's (empty) body graph.
int graph_cond_add_node(void* stream, unsigned long long handle, int kind, void** body_out) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
    const cudaGraphNode_t* deps = nullptr;
    size_t n_deps = 0;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, nullptr, &n_deps);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &graph, &deps, &n_deps);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
    cudaGraphNodeParams params = {};
    params.type = cudaGraphNodeTypeConditional;
    params.conditional.handle = static_cast<cudaGraphConditionalHandle>(handle);
    params.conditional.type = kind == 0 ? cudaGraphCondTypeIf : cudaGraphCondTypeWhile;
    params.conditional.size = 1;
    cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
    err = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
#else
    err = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
#endif
    if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
    err = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
    err = cudaStreamUpdateCaptureDependencies(s, &node, 1, cudaStreamSetCaptureDependencies);
#endif
    if (err != cudaSuccess) return err;
    *body_out = static_cast<void*>(params.conditional.phGraph_out[0]);
    return cudaSuccess;
}

// Begin capturing `stream` into the body graph `body` in thread-local capture
// mode, as the step's own capture (utils/graphs.py).
int graph_cond_begin_body(void* stream, void* body) {
    return cudaStreamBeginCaptureToGraph(
        static_cast<cudaStream_t>(stream), static_cast<cudaGraph_t>(body),
        nullptr, nullptr, 0, cudaStreamCaptureModeThreadLocal);
}

// End the body capture begun by graph_cond_begin_body; the number of
// nodes the body holds, and of those the number of each type: `by_type[t]`
// for cudaGraphNodeType t < n_types, and `by_type[n_types]` the nodes whose
// type the runtime does not report (the body's own nodes, not those of a
// body nested in it).  CUDA 12.9's runtime answers cudaErrorUnknown for a
// conditional node nested in a body (on an H100); that answer is counted,
// not returned.
int graph_cond_end_body(void* stream, size_t* n_nodes, size_t* by_type, int n_types) {
    cudaGraph_t graph;
    cudaError_t err = cudaStreamEndCapture(static_cast<cudaStream_t>(stream), &graph);
    if (err != cudaSuccess) return err;
    err = cudaGraphGetNodes(graph, nullptr, n_nodes);
    if (err != cudaSuccess || *n_nodes == 0) return err;
    cudaGraphNode_t* nodes = new cudaGraphNode_t[*n_nodes];
    size_t n = *n_nodes;
    err = cudaGraphGetNodes(graph, nodes, &n);
    for (size_t i = 0; err == cudaSuccess && i < n; ++i) {
        cudaGraphNodeType type;
        if (cudaGraphNodeGetType(nodes[i], &type) != cudaSuccess) {
            cudaGetLastError();  // a query's answer, not an error of the capture
            ++by_type[n_types];
        } else if (static_cast<int>(type) < n_types) {
            ++by_type[type];
        }
    }
    delete[] nodes;
    return err;
}

// The number of nodes in the graph that `stream` is capturing.
int graph_cond_captured_nodes(void* stream, size_t* n_nodes) {
    cudaStreamCaptureStatus status;
    cudaGraph_t graph;
#if CUDART_VERSION >= 13000
    cudaError_t err = cudaStreamGetCaptureInfo(
        static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr, nullptr, nullptr);
#else
    cudaError_t err = cudaStreamGetCaptureInfo(
        static_cast<cudaStream_t>(stream), &status, nullptr, &graph, nullptr, nullptr);
#endif
    if (err != cudaSuccess) return err;
    if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
    return cudaGraphGetNodes(graph, nullptr, n_nodes);
}

}  // extern "C"
