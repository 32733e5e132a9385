// cond_graph: a CUDA graph of IF conditional nodes in a chain, each running
// a graph body (a piece that torch captured as its own CUDA graph) where a
// device bool holds when the chain reaches it, and counting how often each
// body ran. It carries a loop whose units decide on the card whether they
// run (albedo_tpu_torch/utils/graphs.py replay_while, the L-BFGS fits):
// torch 2.11 has no conditional nodes of its own.
//
// Each node is switched by a one-thread kernel that reads its bool into the
// node's handle and adds 1 to its run count; the chain runs in order, so a
// bool that an earlier body writes is read after it is written.

#include <cuda_runtime.h>

namespace {

// The switch of one conditional node: the node runs its body where *pred
// holds, and the body's run is counted.
__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle, const bool* pred, int* runs) {
  const bool on = *pred;
  if (on) *runs += 1;
  cudaGraphSetConditional(handle, on ? 1u : 0u);
}

}  // namespace

// A graph of n conditional nodes in a chain, node i running the graph
// bodies[i] (cloned) where the device bool preds[i] holds when the chain
// reaches it, and adding 1 to runs[i] (int32, device) each time it does.
// Writes the instantiated graph, uploaded on `stream`, and the graph to
// *exec_out, *graph_out. Returns a cudaError_t (0 = built).
extern "C" int cond_graph_build(int n, void* const* bodies, void* const* preds, int* runs, void* stream,
                                void** exec_out, void** graph_out) {
  cudaGraph_t parent = nullptr;
  cudaError_t e = cudaGraphCreate(&parent, 0);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNode_t prev = nullptr;
  for (int i = 0; i < n && e == cudaSuccess; ++i) {
    cudaGraphConditionalHandle handle;
    e = cudaGraphConditionalHandleCreate(&handle, parent, 0, cudaGraphCondAssignDefault);
    if (e != cudaSuccess) break;
    const bool* pred = (const bool*)preds[i];
    int* count = runs + i;
    void* args[] = {&handle, &pred, &count};
    cudaKernelNodeParams kp = {};
    kp.func = (void*)set_conditional_kernel;
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t set_node;
    e = cudaGraphAddKernelNode(&set_node, parent, prev ? &prev : nullptr, prev ? 1 : 0, &kp);
    if (e != cudaSuccess) break;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    cudaGraphNode_t cond_node;
    e = cudaGraphAddNode(&cond_node, parent, &set_node, 1, &cp);
    if (e != cudaSuccess) break;
    cudaGraphNode_t child;
    e = cudaGraphAddChildGraphNode(&child, cp.conditional.phGraph_out[0], nullptr, 0, (cudaGraph_t)bodies[i]);
    prev = cond_node;
  }
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, parent, 0);
  if (e == cudaSuccess) {
    e = cudaGraphUpload(exec, (cudaStream_t)stream);  // its first launch then costs what the others do
    if (e != cudaSuccess) cudaGraphExecDestroy(exec);
  }
  if (e != cudaSuccess) {
    cudaGraphDestroy(parent);
    return (int)e;
  }
  *exec_out = exec;
  *graph_out = parent;
  return 0;
}

extern "C" int cond_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch((cudaGraphExec_t)exec, (cudaStream_t)stream);
}

extern "C" int cond_graph_destroy(void* exec, void* graph) {
  cudaError_t e = cudaGraphExecDestroy((cudaGraphExec_t)exec);
  cudaError_t f = cudaGraphDestroy((cudaGraph_t)graph);
  return (int)(e != cudaSuccess ? e : f);
}

// The number of nodes of graph `graph` (a piece torch captured) in *n.
extern "C" int cond_graph_nodes(void* graph, size_t* n) {
  return (int)cudaGraphGetNodes((cudaGraph_t)graph, nullptr, n);
}
