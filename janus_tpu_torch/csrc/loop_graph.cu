// The decode loops' lax.while_loop on the card: a CUDA graph whose WHILE
// node (a conditional node, CUDA 12.4+) repeats a captured decode step
// while the loop's condition holds, the condition decided on the device.
//
// The JAX package compiles each decode loop (the recognizer's greedy search,
// janus_tpu/models/asr.py:546-562; the TTS AR loop, janus_tpu/models/
// tts.py:393-412) into a lax.while_loop whose condition, (step < max) &
// ~all(done), XLA tests on the device before every step. Here:
//
//   head: loop_condition(add = 0)        sets the node's handle
//   WHILE handle != 0:
//     the step (a child graph: the step PyTorch captured)
//     tail: loop_condition(add = 1)      trips += 1, sets the handle
//
// loop_condition is one warp: each lane reads a stride of the done flags,
// the warp votes, and lane 0 writes the trip count and calls
// cudaGraphSetConditional with (trips < limit) & any(!done). Nothing is read
// back by the host: one graph launch runs the whole loop, and trips (int32,
// on the device) says how many steps ran. The caller zeroes trips and sets
// done before the launch (the prefill's work), so a lane done at the prefill
// runs no step, as the while_loop's first test runs none.
//
// A synthesis runs the prompt's prefill before the loop and the vocoder
// after it: jt_loop_create takes those two graphs too (either may be null),
// cloned as child nodes before the head and after the WHILE node, so that
// one launch runs the whole program, as the JAX package jits it into one.
//
// The stream's chunk (the JAX package's lax.scan of n steps, which runs
// every step whatever done says) is a chain: the step's graph cloned n
// times in sequence, no condition (jt_chain_create).
//
// Plain C interface (ctypes): jt_loop_create builds and instantiates the
// graph around a cudaGraph_t (the step, cloned into the node's body),
// jt_chain_create the chain, jt_loop_launch launches either on a stream,
// jt_loop_destroy frees it; jt_loop_condition launches loop_condition
// alone, outside any graph, writing the value it would set (to hold it
// against its plain version).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 32;

// the while_loop's condition into `handle`: with `add`, after a step, the
// trip count first advances by one. `out` (optional) receives the value
// set, for a test outside a graph (handle 0: no node to set).
__global__ void __launch_bounds__(LANES)
loop_condition(const bool* __restrict__ done, int batch,
               int* __restrict__ trips, int limit, int add,
               cudaGraphConditionalHandle handle, int* __restrict__ out) {
  bool live = false;
  for (int i = threadIdx.x; i < batch; i += LANES) live |= !done[i];
  live = __any_sync(0xffffffffu, live);
  if (threadIdx.x == 0) {
    const int t = *trips + add;
    *trips = t;
    const unsigned go = (live && t < limit) ? 1u : 0u;
    if (handle) cudaGraphSetConditional(handle, go);
    if (out) *out = static_cast<int>(go);
  }
}

struct Loop {
  cudaGraph_t graph = nullptr;
  cudaGraphExec_t exec = nullptr;
};

void destroy(Loop* loop) {
  if (loop->exec) cudaGraphExecDestroy(loop->exec);
  if (loop->graph) cudaGraphDestroy(loop->graph);
  delete loop;
}

cudaError_t add_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                          const cudaGraphNode_t* deps, size_t ndeps,
                          void** args) {
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_condition);
  p.gridDim = dim3(1);
  p.blockDim = dim3(LANES);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// step: a cudaGraph_t (cloned: the caller keeps its own); done: [batch]
// bool; trips: one int32 on the device; limit >= 1, the most steps a launch
// runs; before, after: graphs (cloned; null for none) run before the head
// and after the loop. *out receives the loop, to launch and destroy.
int jt_loop_create(void* step, const void* done, int batch, void* trips,
                   int limit, void* before, void* after, void** out) {
  if (step == nullptr || done == nullptr || trips == nullptr || batch < 1 ||
      limit < 1 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Loop* loop = new Loop();
  cudaGraphConditionalHandle handle = 0;
  cudaError_t err = cudaGraphCreate(&loop->graph, 0);
  if (err == cudaSuccess)
    err = cudaGraphConditionalHandleCreate(&handle, loop->graph, 0, 0);
  const bool* d = static_cast<const bool*>(done);
  int* t = static_cast<int*>(trips);
  int* none = nullptr;
  int zero = 0, one = 1;
  void* head_args[] = {&d, &batch, &t, &limit, &zero, &handle, &none};
  void* tail_args[] = {&d, &batch, &t, &limit, &one, &handle, &none};
  cudaGraphNode_t first = nullptr, head = nullptr, node = nullptr,
                  body = nullptr, tail = nullptr, last = nullptr;
  if (err == cudaSuccess && before != nullptr)
    err = cudaGraphAddChildGraphNode(&first, loop->graph, nullptr, 0,
                                     static_cast<cudaGraph_t>(before));
  if (err == cudaSuccess)
    err = add_condition(&head, loop->graph, first ? &first : nullptr,
                        first ? 1 : 0, head_args);
  cudaGraphNodeParams cond = {};
  if (err == cudaSuccess) {
    cond.type = cudaGraphNodeTypeConditional;
    cond.conditional.handle = handle;
    cond.conditional.type = cudaGraphCondTypeWhile;
    cond.conditional.size = 1;
    err = cudaGraphAddNode(&node, loop->graph, &head, 1, &cond);
  }
  if (err == cudaSuccess) {
    cudaGraph_t inner = cond.conditional.phGraph_out[0];
    err = cudaGraphAddChildGraphNode(&body, inner, nullptr, 0,
                                     static_cast<cudaGraph_t>(step));
    if (err == cudaSuccess)
      err = add_condition(&tail, inner, &body, 1, tail_args);
  }
  if (err == cudaSuccess && after != nullptr)
    err = cudaGraphAddChildGraphNode(&last, loop->graph, &node, 1,
                                     static_cast<cudaGraph_t>(after));
  if (err == cudaSuccess)
    err = cudaGraphInstantiate(&loop->exec, loop->graph, 0);
  if (err != cudaSuccess) {
    destroy(loop);
    cudaGetLastError();
    return static_cast<int>(err);
  }
  *out = loop;
  return 0;
}

// step: a cudaGraph_t (cloned n times: the caller keeps its own); n >= 1.
// *out receives the chain, to launch and destroy as a loop.
int jt_chain_create(void* step, int n, void** out) {
  if (step == nullptr || n < 1 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Loop* chain = new Loop();
  cudaError_t err = cudaGraphCreate(&chain->graph, 0);
  cudaGraphNode_t prev = nullptr, node = nullptr;
  for (int i = 0; i < n && err == cudaSuccess; ++i) {
    err = cudaGraphAddChildGraphNode(&node, chain->graph,
                                     prev ? &prev : nullptr, prev ? 1 : 0,
                                     static_cast<cudaGraph_t>(step));
    prev = node;
  }
  if (err == cudaSuccess)
    err = cudaGraphInstantiate(&chain->exec, chain->graph, 0);
  if (err != cudaSuccess) {
    destroy(chain);
    cudaGetLastError();
    return static_cast<int>(err);
  }
  *out = chain;
  return 0;
}

int jt_loop_launch(void* loop, void* stream) {
  if (loop == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGraphLaunch(static_cast<Loop*>(loop)->exec,
                                          static_cast<cudaStream_t>(stream)));
}

int jt_loop_destroy(void* loop) {
  if (loop != nullptr) destroy(static_cast<Loop*>(loop));
  return 0;
}

// the condition alone, outside a graph: trips += add, *go = (trips < limit)
// & any(!done)
int jt_loop_condition(const void* done, int batch, void* trips, int limit,
                      int add, void* go, void* stream) {
  if (done == nullptr || trips == nullptr || go == nullptr || batch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  loop_condition<<<1, LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bool*>(done), batch, static_cast<int*>(trips), limit,
      add, 0, static_cast<int*>(go));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
