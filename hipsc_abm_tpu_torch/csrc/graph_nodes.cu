// The nodes of a captured CUDA graph, counted by kind.
//
// Replaces no TPU kernel and launches none: a host query of a graph that
// PyTorch captured (`torch.cuda.CUDAGraph(keep_graph=True).raw_cuda_graph()`),
// made once per capture, so that the work a replay launches (kernel, memcpy
// and memset nodes; ROADMAP E4's launches per step) is known apart from the
// timing marks that tracing adds (event-record nodes).

#include <cuda_runtime.h>

#include <vector>

// counts[0..4]: kernel, memcpy, memset, event-record and every other node.
extern "C" int hipsc_graph_nodes(void* graph, long long* counts) {
  cudaGraph_t g = (cudaGraph_t)graph;
  size_t n = 0;
  cudaError_t rc = cudaGraphGetNodes(g, nullptr, &n);
  if (rc != cudaSuccess) return (int)rc;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0) {
    rc = cudaGraphGetNodes(g, nodes.data(), &n);
    if (rc != cudaSuccess) return (int)rc;
  }
  for (int k = 0; k < 5; ++k) counts[k] = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    rc = cudaGraphNodeGetType(nodes[i], &type);
    if (rc != cudaSuccess) return (int)rc;
    switch (type) {
      case cudaGraphNodeTypeKernel: ++counts[0]; break;
      case cudaGraphNodeTypeMemcpy: ++counts[1]; break;
      case cudaGraphNodeTypeMemset: ++counts[2]; break;
      case cudaGraphNodeTypeEventRecord: ++counts[3]; break;
      default: ++counts[4]; break;
    }
  }
  return (int)cudaSuccess;
}
