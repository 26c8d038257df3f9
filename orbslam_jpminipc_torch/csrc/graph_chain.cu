// A chain of captured CUDA graphs, some of them behind a branch that the
// device decides, as ONE executable graph: the counterpart of a `lax.cond`
// inside the reference's single XLA program.
//
// A chain is a list of links. A link is either one graph, run always, or a
// branch: a predicate byte in device memory and a graph for each of its two
// values. Each graph is added as a child graph; an
// optional device-to-device copy after it moves its outputs to where the
// rest of the chain reads them, so both arms of a branch can hand over the
// same result. A branch is a one-thread kernel that reads the predicate and
// sets the handles of its IF nodes (cudaGraphSetConditional), then an IF
// node for each arm, the true arm's first. Links follow one another in list
// order.
//
// The host launches the whole chain with one cudaGraphLaunch and never reads
// the predicate, so it never waits for the device.
//
// Plain C interface for ctypes (utils/graph_chain.py). Every function
// returns a cudaError_t as int; 0 is success.

#include <cuda_runtime.h>

extern "C" {

struct ChainArm {
  void* graph;       // cudaGraph_t
  void* copy_dst;    // after the graph: copy copy_bytes from copy_src to
  const void* copy_src;  // copy_dst (device memory), when copy_bytes > 0
  unsigned long long copy_bytes;
};

struct ChainLink {
  const unsigned char* pred;  // device byte; null: on_true runs always
  ChainArm on_true;
  ChainArm on_false;
};

}  // extern "C"

// Sets the IF handle of the true arm to pred != 0, that of the false arm
// to its negation.
__global__ void chain_branch_kernel(cudaGraphConditionalHandle on_true,
                                    cudaGraphConditionalHandle on_false,
                                    const unsigned char* pred) {
  const unsigned int v = pred[0] != 0 ? 1u : 0u;
  cudaGraphSetConditional(on_true, v);
  cudaGraphSetConditional(on_false, 1u - v);
}

// Adds `arm` to `graph` after `dep` (null: no dependency); the last node
// added in *last.
static cudaError_t add_arm(cudaGraph_t graph, cudaGraphNode_t dep, const ChainArm& arm,
                           cudaGraphNode_t* last) {
  cudaGraphNode_t child;
  cudaError_t err = cudaGraphAddChildGraphNode(&child, graph, dep ? &dep : nullptr,
                                               dep ? 1 : 0,
                                               static_cast<cudaGraph_t>(arm.graph));
  if (err != cudaSuccess) return err;
  *last = child;
  if (arm.copy_bytes == 0) return cudaSuccess;
  cudaGraphNode_t copy;
  err = cudaGraphAddMemcpyNode1D(&copy, graph, &child, 1, arm.copy_dst, arm.copy_src,
                                 static_cast<size_t>(arm.copy_bytes),
                                 cudaMemcpyDeviceToDevice);
  if (err != cudaSuccess) return err;
  *last = copy;
  return cudaSuccess;
}

// An IF node after `dep` whose body is `arm`; the IF node in *node.
static cudaError_t add_if(cudaGraph_t graph, cudaGraphNode_t dep,
                          cudaGraphConditionalHandle handle, const ChainArm& arm,
                          cudaGraphNode_t* node) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = cudaGraphCondTypeIf;
  p.conditional.size = 1;
  cudaError_t err = cudaGraphAddNode(node, graph, &dep, 1, &p);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t last;
  return add_arm(p.conditional.phGraph_out[0], nullptr, arm, &last);
}

extern "C" int graph_chain_build(const ChainLink* links, int n_links, int device,
                                 void** exec_out, void** graph_out) {
  *exec_out = nullptr;
  *graph_out = nullptr;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraph_t graph;
  err = cudaGraphCreate(&graph, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaGraphNode_t tail = nullptr;
  for (int i = 0; i < n_links && err == cudaSuccess; ++i) {
    const ChainLink& link = links[i];
    if (link.pred == nullptr) {
      err = add_arm(graph, tail, link.on_true, &tail);
      continue;
    }
    if (link.on_true.graph == nullptr || link.on_false.graph == nullptr) {
      err = cudaErrorInvalidValue;   // a branch has a graph on each arm
      break;
    }
    cudaGraphConditionalHandle h_true, h_false;
    err = cudaGraphConditionalHandleCreate(&h_true, graph, 0, 0);
    if (err == cudaSuccess) err = cudaGraphConditionalHandleCreate(&h_false, graph, 0, 0);
    if (err != cudaSuccess) break;
    const unsigned char* pred = link.pred;
    void* args[] = {&h_true, &h_false, &pred};
    cudaKernelNodeParams k = {};
    k.func = reinterpret_cast<void*>(chain_branch_kernel);
    k.gridDim = dim3(1);
    k.blockDim = dim3(1);
    k.kernelParams = args;
    cudaGraphNode_t set;
    err = cudaGraphAddKernelNode(&set, graph, tail ? &tail : nullptr, tail ? 1 : 0, &k);
    if (err != cudaSuccess) break;
    cudaGraphNode_t if_true, if_false;
    err = add_if(graph, set, h_true, link.on_true, &if_true);
    if (err == cudaSuccess) err = add_if(graph, if_true, h_false, link.on_false, &if_false);
    tail = if_false;
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, graph, 0);
  if (err != cudaSuccess) {
    cudaGraphDestroy(graph);
    return static_cast<int>(err);
  }
  *exec_out = exec;
  *graph_out = graph;
  return 0;
}

extern "C" int graph_chain_launch(void* exec, void* stream) {
  return static_cast<int>(
      cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream)));
}

extern "C" int graph_chain_destroy(void* exec, void* graph) {
  cudaError_t err = cudaSuccess;
  if (exec != nullptr) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return static_cast<int>(err);
}

extern "C" const char* graph_chain_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
