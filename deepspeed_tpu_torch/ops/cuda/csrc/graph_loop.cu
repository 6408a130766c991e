// A loop with early exit inside one CUDA graph (sm_90a, CUDA >= 12.4).
//
// The counterpart of the JAX engine's `jax.lax.while_loop` in its multi-step
// scheduler (deepspeed_tpu/inference/ragged.py `_get_dev_sched`): up to k
// iterations of one body, each run only while a predicate the previous
// iteration left on the device is true, with no host round trip between
// them. It replaces no Pallas kernel and computes nothing itself.
//
// The caller captures three graphs (prologue, body, epilogue) with PyTorch's
// own capture, so PyTorch's allocator places their tensors in a graph pool
// as for any graph, and hands their cudaGraph_t here. This file composes
//
//   prologue -> [set c1 <- *pred] -> IF c1 { body } -> [set c2 <- *pred]
//            -> IF c2 { body } -> ... (k times) -> epilogue
//
// where each IF is a conditional graph node whose body graph holds the
// captured body as a child graph, and each `set` is a one-thread kernel
// node that copies the bool at `pred` into that node's condition. The
// body updates `pred` itself, so once it is false every later IF skips its
// body: the skipped iterations launch nothing.
//
// The body, prologue and epilogue graphs are cloned into the composed graph,
// which is instantiated once; the caller keeps the captured graphs' owners
// alive, since their pool holds the tensors the body reads and writes.

#include <cuda_runtime.h>

namespace {

__global__ void set_condition(cudaGraphConditionalHandle handle, const bool* pred) {
  cudaGraphSetConditional(handle, *pred ? 1u : 0u);
}

#define LOOP_CHECK(expr)                     \
  do {                                       \
    cudaError_t e_ = (expr);                 \
    if (e_ != cudaSuccess) {                 \
      cudaGraphDestroy(root);                \
      return (int)e_;                        \
    }                                        \
  } while (0)

}  // namespace

// Compose and instantiate the loop graph; *exec_out receives the
// cudaGraphExec_t. Returns a cudaError_t (0 on success).
extern "C" int dstpu_loop_graph_create(void* prologue, void* body, void* epilogue,
                                       const void* pred, int k, int device,
                                       void** exec_out) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaGraph_t root = nullptr;
  err = cudaGraphCreate(&root, 0);
  if (err != cudaSuccess) return (int)err;
  cudaGraphNode_t prev = nullptr, node = nullptr;
  LOOP_CHECK(cudaGraphAddChildGraphNode(&prev, root, nullptr, 0,
                                        static_cast<cudaGraph_t>(prologue)));
  const bool* pred_ptr = static_cast<const bool*>(pred);
  for (int i = 0; i < k; ++i) {
    cudaGraphConditionalHandle handle;
    LOOP_CHECK(cudaGraphConditionalHandleCreate(&handle, root, 0, 0));
    cudaKernelNodeParams kp = {};
    void* args[] = {&handle, &pred_ptr};
    kp.func = reinterpret_cast<void*>(set_condition);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    LOOP_CHECK(cudaGraphAddKernelNode(&node, root, &prev, 1, &kp));
    prev = node;
    cudaGraphNodeParams cp = {};
    cp.type = cudaGraphNodeTypeConditional;
    cp.conditional.handle = handle;
    cp.conditional.type = cudaGraphCondTypeIf;
    cp.conditional.size = 1;
    LOOP_CHECK(cudaGraphAddNode(&node, root, &prev, 1, &cp));
    prev = node;
    cudaGraphNode_t inner;
    LOOP_CHECK(cudaGraphAddChildGraphNode(&inner, cp.conditional.phGraph_out[0], nullptr, 0,
                                          static_cast<cudaGraph_t>(body)));
  }
  LOOP_CHECK(cudaGraphAddChildGraphNode(&node, root, &prev, 1,
                                        static_cast<cudaGraph_t>(epilogue)));
  cudaGraphExec_t exec = nullptr;
  LOOP_CHECK(cudaGraphInstantiate(&exec, root, 0));
  cudaGraphDestroy(root);
  *exec_out = exec;
  return 0;
}

extern "C" int dstpu_loop_graph_launch(void* exec, void* stream) {
  return (int)cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                              static_cast<cudaStream_t>(stream));
}

extern "C" int dstpu_loop_graph_destroy(void* exec) {
  return (int)cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}
