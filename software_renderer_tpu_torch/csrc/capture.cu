// The device nodes of the CUDA graph a stream is capturing into: the
// count behind the layer map of a captured frame (utils/profiling.py).
#include <cuda_runtime.h>

#include <vector>

// Writes to *out how many nodes the graph that `stream` is capturing into
// holds (-1 when the stream is not capturing): all of them, or with
// `typed` only its kernel, memcpy and memset nodes, the nodes a profiler's
// device trace shows (one API call per node).
extern "C" int sr_capture_nodes(void* stream, int typed, int* out) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
#if CUDART_VERSION >= 12000
  cudaError_t err = cudaStreamGetCaptureInfo((cudaStream_t)stream, &status,
                                             nullptr, &graph);
#else
  cudaError_t err = cudaStreamGetCaptureInfo_v2((cudaStream_t)stream,
                                                &status, nullptr, &graph);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive || graph == nullptr) {
    *out = -1;
    return cudaSuccess;
  }
  size_t n = 0;
  err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  if (!typed) {
    *out = (int)n;
    return cudaSuccess;
  }
  std::vector<cudaGraphNode_t> nodes(n);
  if (n) {
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
    if (err != cudaSuccess) return err;
  }
  int count = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    count += type == cudaGraphNodeTypeKernel ||
             type == cudaGraphNodeTypeMemcpy ||
             type == cudaGraphNodeTypeMemset;
  }
  *out = count;
  return cudaSuccess;
}
