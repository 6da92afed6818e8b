// The fused dispatch's device-side round loop: CUDA-graph conditional
// nodes around the round and flag-check bodies that PyTorch captured.
//
// Counterpart of the reference's megaloop (src/repro/core/controller.py,
// `megaloop`: a jitted lax.while_loop whose cond stops at done | over |
// i == k and whose body checks the flags under a lax.cond at every
// check_every-th round).  PyTorch 2.11 captures a graph but exposes no
// conditional node, so this helper assembles them with the runtime's graph
// API, from two graphs that PyTorch captured and kept uninstantiated:
//
//   round: one round on the controller's buffers, the copy-back, i += 1,
//          done = over = 0, at = (r0 + i) % check_every == 0, running = i < k
//   check: the termination flags -> done, over, running &= ~(done | over)
//
// The dispatch is one WHILE node on `running` whose body is a round,
// round -> set(h2, at) -> IF h2 { check } -> set(h, running), so one launch
// runs a whole dispatch and stops on the card where the reference's loop
// stops.  `set` is a one-thread kernel that copies a device
// bool into a node's condition handle: the predicates never leave the
// card.  The bodies are child-graph nodes (clones of PyTorch's graphs):
// their addresses are those of the controller's buffers and of PyTorch's
// private memory pools, which the caller keeps alive with the graphs.
// Nothing here allocates device memory, copies or synchronizes.
//
// Bound: none of the work is this file's; a round adds two setter kernels
// and two conditional-node evaluations on the device.
#include <cuda_runtime.h>

#include <vector>

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

namespace {

int failed_step = 0;  // the step of the last failed build, for the error message
#define STEP(n, call) (failed_step = (n), (call))

// the kernel node set(handle, pred) in `graph` after `deps`
cudaError_t add_setter(cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n_deps,
                       cudaGraphConditionalHandle handle, const bool* pred,
                       cudaGraphNode_t* setter) {
  void* args[] = {&handle, &pred};
  cudaKernelNodeParams kp = {};
  kp.func = reinterpret_cast<void*>(set_condition);
  kp.gridDim = dim3(1);
  kp.blockDim = dim3(1);
  kp.kernelParams = args;
  return STEP(2, cudaGraphAddKernelNode(setter, graph, deps, n_deps, &kp));
}

// set(handle, pred) after `deps`, then a conditional node of `type` (IF or
// WHILE) on that handle; returns the node, its (empty) body graph and the
// handle
cudaError_t add_conditional(cudaGraph_t graph, const cudaGraphNode_t* deps, size_t n_deps,
                            const bool* pred, cudaGraphConditionalNodeType type,
                            cudaGraphNode_t* node, cudaGraph_t* body,
                            cudaGraphConditionalHandle* handle) {
  cudaError_t err = STEP(1, cudaGraphConditionalHandleCreate(handle, graph, 0, 0));
  if (err != cudaSuccess) return err;
  cudaGraphNode_t setter;
  if ((err = add_setter(graph, deps, n_deps, *handle, pred, &setter)) != cudaSuccess) return err;
  cudaGraphNodeParams cp = {};
  cp.type = cudaGraphNodeTypeConditional;
  cp.conditional.handle = *handle;
  cp.conditional.type = type;
  cp.conditional.size = 1;
  err = STEP(3, cudaGraphAddNode(node, graph, &setter, 1, &cp));
  if (err != cudaSuccess) return err;
  *body = cp.conditional.phGraph_out[0];
  return cudaSuccess;
}

// the WHILE body's round: round -> set(h, at) -> IF h { check }; returns
// its last node
cudaError_t add_round(cudaGraph_t body, cudaGraph_t round, cudaGraph_t check,
                      const bool* at, cudaGraphNode_t* last) {
  cudaGraphNode_t body_round, body_check;
  cudaGraph_t inner;
  cudaGraphConditionalHandle handle;
  cudaError_t err = STEP(4, cudaGraphAddChildGraphNode(&body_round, body, nullptr, 0, round));
  if (err != cudaSuccess) return err;
  err = add_conditional(body, &body_round, 1, at, cudaGraphCondTypeIf, last, &inner, &handle);
  if (err != cudaSuccess) return err;
  return STEP(5, cudaGraphAddChildGraphNode(&body_check, inner, nullptr, 0, check));
}

// census[]: nodes, kernels, memcpys, memsets, conditionals, child graphs,
// empties, other; a child graph's nodes are counted too
cudaError_t count(cudaGraph_t graph, int* census) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  if (err != cudaSuccess) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  if (n > 0 && (err = cudaGraphGetNodes(graph, nodes.data(), &n)) != cudaSuccess) return err;
  for (cudaGraphNode_t node : nodes) {
    cudaGraphNodeType type;
    if ((err = cudaGraphNodeGetType(node, &type)) != cudaSuccess) return err;
    census[0] += 1;
    switch (type) {
      case cudaGraphNodeTypeKernel: census[1] += 1; break;
      case cudaGraphNodeTypeMemcpy: census[2] += 1; break;
      case cudaGraphNodeTypeMemset: census[3] += 1; break;
      case cudaGraphNodeTypeConditional: census[4] += 1; break;
      case cudaGraphNodeTypeGraph: {
        census[5] += 1;
        cudaGraph_t child;
        if ((err = cudaGraphChildGraphNodeGetGraph(node, &child)) != cudaSuccess) return err;
        if ((err = count(child, census)) != cudaSuccess) return err;
        break;
      }
      case cudaGraphNodeTypeEmpty: census[6] += 1; break;
      default: census[7] += 1;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Builds, instantiates and uploads (on `stream`) the dispatch graph over
// the captured graphs `round_graph` and `check_graph` (cudaGraph_t), with
// the device bools `running` and `at` as the predicates:
//
//   set(h, running) -> WHILE h { round -> set(h2, at) -> IF h2 { check }
//                                -> set(h, running) }
//
// so one launch runs every round of a dispatch.  Writes the executable
// graph to *exec_out, and to census the node census (8 ints each, see
// `count`) of the round graph and of the check graph.  Returns a CUDA error
// code (0 on success).
extern "C" int dispatch_graph_build(void* round_graph, void* check_graph, const void* running,
                                    const void* at, void* stream, void** exec_out,
                                    int* census) {
  cudaGraph_t round = static_cast<cudaGraph_t>(round_graph);
  cudaGraph_t check = static_cast<cudaGraph_t>(check_graph);
  const bool* run_flag = static_cast<const bool*>(running);
  const bool* at_flag = static_cast<const bool*>(at);
  for (int i = 0; i < 16; ++i) census[i] = 0;
  // this library's runtime binds the current device's primary context
  // (PyTorch's) before any graph call: a conditional handle needs it
  cudaError_t err = STEP(8, cudaFree(nullptr));
  if (err != cudaSuccess) return err;
  cudaGraph_t top;
  if ((err = STEP(9, cudaGraphCreate(&top, 0))) != cudaSuccess) return err;
  cudaGraphNode_t node, last;
  cudaGraph_t body;
  cudaGraphConditionalHandle handle;
  err = add_conditional(top, nullptr, 0, run_flag, cudaGraphCondTypeWhile, &node, &body,
                        &handle);
  if (err == cudaSuccess) err = add_round(body, round, check, at_flag, &last);
  if (err == cudaSuccess) err = add_setter(body, &last, 1, handle, run_flag, &node);
  // the census of the two captured bodies; it is informational, so a
  // failure only marks it (-1)
  if (err == cudaSuccess) {
    for (int g = 0; g < 2; ++g) {
      if (count(g == 0 ? round : check, census + 8 * g) != cudaSuccess) census[8 * g] = -1;
    }
  }
  cudaGraphExec_t exec = nullptr;
  if (err == cudaSuccess) err = STEP(7, cudaGraphInstantiate(&exec, top, 0));
  cudaGraphDestroy(top);
  if (err == cudaSuccess) err = STEP(6, cudaGraphUpload(exec, static_cast<cudaStream_t>(stream)));
  if (err != cudaSuccess) {
    if (exec != nullptr) cudaGraphExecDestroy(exec);
    return err;
  }
  *exec_out = exec;
  return cudaSuccess;
}

// One replay of the dispatch graph on `stream`.
extern "C" int dispatch_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

extern "C" int dispatch_graph_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

extern "C" const char* dispatch_graph_error(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The step at which the last build failed: 1 condition handle, 2 setter
// kernel node, 3 conditional node, 4 and 5 the round and check child
// graphs, 6 the upload, 7 instantiation, 8 the runtime's context, 9 the
// graph.
extern "C" int dispatch_graph_failed_step() { return failed_step; }
