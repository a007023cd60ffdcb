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
//     the step (its own nodes and edges)
//     tail: loop_condition(add = 1)      trips += 1, sets the handle
//
// loop_condition is one warp: each lane reads a stride of the done flags,
// the warp votes, and lane 0 writes the trip count and calls
// cudaGraphSetConditional with (trips < limit) & any(!done). Nothing is read
// back by the host: one graph launch runs the whole loop, and trips (int32,
// on the device) says how many steps ran. The caller zeroes trips and sets
// done before the launch (the prefill's work), so a lane done at the
// prefill runs no step, as the while_loop's first test runs none.
//
// The body holds the step's own nodes, not a child graph node: copy_graph
// copies a captured cudaGraph_t's nodes into the target graph, kernel
// nodes through the driver API (PyTorch's, cuBLAS's and cuFFT's kernels
// alike) with their launch attributes (cluster dimensions, priority), and
// every edge with its data, so that the programmatic edges of the step
// (the mixed linears start before the kernel before them ends) stay
// programmatic. A node type a conditional body refuses (host, event,
// memory allocation, conditional) is refused at construction:
// jt_refused_node_type says which.
//
// A synthesis runs the prompt's prefill before the loop and the vocoder
// after it: jt_loop_create copies those two graphs too (either may be
// null) before the head and after the WHILE node, so that one launch runs
// the whole program, as the JAX package jits it into one. Given two
// events, it also puts an event record node between the prefill and the
// head and one between the WHILE node and the vocoder (none in the body),
// so that timing events bound the launch's three parts; jt_loop_marks
// points those nodes at other events for the next launches.
//
// The stream's chunk (the JAX package's lax.scan of n steps, which runs
// every step whatever done says) is a chain: the step's nodes copied n
// times in sequence, no condition (jt_chain_create).
//
// Bound: the condition reads the done flags and the trip count and writes
// the count (batch + 8 bytes). What the loop costs beyond its steps is the
// card's: the kernels of a conditional body run later than the same nodes
// in a graph launched from the host (PERF.md, PR 21), whether the body
// holds a child graph or the step's own nodes; an IF node costs about
// what a WHILE iteration does, so several steps an iteration, each behind
// an IF node, gain nothing. Fewer kernels a step is what shortens it.
//
// Plain C interface (ctypes): jt_loop_create builds and instantiates the
// loop around a cudaGraph_t (the step, copied into the body),
// jt_chain_create the chain, jt_loop_launch launches either on a stream,
// jt_loop_destroy frees it; jt_loop_marks repoints a loop's boundary
// event nodes; jt_loop_condition launches loop_condition
// alone, outside any graph, writing the value it would set (to hold it
// against its plain version); jt_graph_census and jt_loop_census count a
// graph's nodes and edges, programmatic edges apart.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <unordered_map>
#include <unordered_set>
#include <vector>

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
  // the WHILE node's body (owned by the node; none for a chain)
  cudaGraph_t body = nullptr;
  // the event record nodes before the head and after the WHILE node
  cudaGraphNode_t mark_begin = nullptr, mark_end = nullptr;
};

void destroy(Loop* loop) {
  if (loop->exec) cudaGraphExecDestroy(loop->exec);
  if (loop->graph) cudaGraphDestroy(loop->graph);
  delete loop;
}

// the node type copy_graph last refused (-1: none)
thread_local int refused_type = -1;

// the driver's kernel-node calls, which take every kernel a capture holds
// (the runtime's own take only the kernels its module registered)
struct Driver {
  CUresult (*get)(CUgraphNode, CUDA_KERNEL_NODE_PARAMS*) = nullptr;
  CUresult (*add)(CUgraphNode*, CUgraph, const CUgraphNode*, size_t,
                  const CUDA_KERNEL_NODE_PARAMS*) = nullptr;
  CUresult (*attributes)(CUgraphNode, CUgraphNode) = nullptr;
};

template <typename F>
bool driver_entry(const char* name, F* fn) {
  void* p = nullptr;
  cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      name, &p, 12000, cudaEnableDefault, &q);
#else
  const cudaError_t err =
      cudaGetDriverEntryPoint(name, &p, cudaEnableDefault, &q);
#endif
  cudaGetLastError();
  if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return false;
  *fn = reinterpret_cast<F>(p);
  return true;
}

const Driver* driver() {
  static const Driver* d = [] {
    static Driver x;
    const bool ok = driver_entry("cuGraphKernelNodeGetParams", &x.get) &&
                    driver_entry("cuGraphAddKernelNode", &x.add) &&
                    driver_entry("cuGraphKernelNodeCopyAttributes",
                                 &x.attributes);
    return ok ? &x : nullptr;
  }();
  return d;
}

// one node of another graph into `dst` after `deps`: its parameters, and
// for a kernel its launch attributes; a child graph node as a child graph
// node (cloned); any other type refused
cudaError_t copy_node(cudaGraphNode_t node, cudaGraph_t dst,
                      const cudaGraphNode_t* deps, size_t ndeps,
                      cudaGraphNode_t* out) {
  cudaGraphNodeType type;
  cudaError_t err = cudaGraphNodeGetType(node, &type);
  if (err != cudaSuccess) return err;
  switch (type) {
    case cudaGraphNodeTypeKernel: {
      const Driver* d = driver();
      if (d == nullptr) return cudaErrorNotSupported;
      CUDA_KERNEL_NODE_PARAMS p;
      memset(&p, 0, sizeof(p));
      CUresult r = d->get(node, &p);
      if (r == CUDA_SUCCESS) r = d->add(out, dst, deps, ndeps, &p);
      if (r == CUDA_SUCCESS) r = d->attributes(*out, node);
      return static_cast<cudaError_t>(r);
    }
    case cudaGraphNodeTypeMemcpy: {
      cudaMemcpy3DParms p;
      memset(&p, 0, sizeof(p));
      err = cudaGraphMemcpyNodeGetParams(node, &p);
      if (err == cudaSuccess)
        err = cudaGraphAddMemcpyNode(out, dst, deps, ndeps, &p);
      return err;
    }
    case cudaGraphNodeTypeMemset: {
      cudaMemsetParams p;
      memset(&p, 0, sizeof(p));
      err = cudaGraphMemsetNodeGetParams(node, &p);
      if (err == cudaSuccess)
        err = cudaGraphAddMemsetNode(out, dst, deps, ndeps, &p);
      return err;
    }
    case cudaGraphNodeTypeEmpty:
      return cudaGraphAddEmptyNode(out, dst, deps, ndeps);
    case cudaGraphNodeTypeGraph: {
      cudaGraph_t child = nullptr;
      err = cudaGraphChildGraphNodeGetGraph(node, &child);
      if (err == cudaSuccess)
        err = cudaGraphAddChildGraphNode(out, dst, deps, ndeps, child);
      return err;
    }
    default:
      refused_type = static_cast<int>(type);
      return cudaErrorNotSupported;
  }
}

// every node and edge (with its data) of `src` into `dst`: src's roots
// depend on `entry` (nodes of dst); `exit` receives the copies of src's
// sinks (`entry` itself for an empty src)
cudaError_t copy_graph(cudaGraph_t src, cudaGraph_t dst,
                       const std::vector<cudaGraphNode_t>& entry,
                       std::vector<cudaGraphNode_t>* exit) {
  size_t n = 0, m = 0;
  cudaError_t err = cudaGraphGetNodes(src, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (err == cudaSuccess && n) err = cudaGraphGetNodes(src, nodes.data(), &n);
  if (err == cudaSuccess)
    err = cudaGraphGetEdges_v2(src, nullptr, nullptr, nullptr, &m);
  std::vector<cudaGraphNode_t> from(m), to(m);
  std::vector<cudaGraphEdgeData> data(m);
  if (err == cudaSuccess && m)
    err = cudaGraphGetEdges_v2(src, from.data(), to.data(), data.data(), &m);
  if (err != cudaSuccess) return err;
  std::unordered_set<cudaGraphNode_t> has_in(to.begin(), to.end());
  std::unordered_set<cudaGraphNode_t> has_out(from.begin(), from.end());
  std::unordered_map<cudaGraphNode_t, cudaGraphNode_t> copy;
  std::vector<cudaGraphNode_t> sinks;
  for (cudaGraphNode_t node : nodes) {
    const bool root = has_in.count(node) == 0;
    cudaGraphNode_t made = nullptr;
    err = copy_node(node, dst, root && !entry.empty() ? entry.data() : nullptr,
                    root ? entry.size() : 0, &made);
    if (err != cudaSuccess) return err;
    copy[node] = made;
    if (has_out.count(node) == 0) sinks.push_back(made);
  }
  // one edge a call: given several edges at once, the driver gave every
  // one of them the first edge's data (CUDA 12.8 on the H100), which made
  // all of them programmatic
  for (size_t i = 0; i < m && err == cudaSuccess; ++i)
    err = cudaGraphAddDependencies_v2(dst, &copy[from[i]], &copy[to[i]],
                                      &data[i], 1);
  if (err != cudaSuccess) return err;
  *exit = n ? sinks : entry;
  return cudaSuccess;
}

cudaError_t add_condition(cudaGraphNode_t* node, cudaGraph_t graph,
                          const std::vector<cudaGraphNode_t>& deps,
                          void** args) {
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(loop_condition);
  p.gridDim = dim3(1);
  p.blockDim = dim3(LANES);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph,
                                deps.empty() ? nullptr : deps.data(),
                                deps.size(), &p);
}

int finish(Loop* loop, cudaError_t err, void** out) {
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

// out[8] (see jt_graph_census) of `graph` and its child graphs; the first
// error, if any
cudaError_t census(cudaGraph_t graph, long long* c) {
  size_t n = 0, m = 0;
  cudaError_t err = cudaGraphGetNodes(graph, nullptr, &n);
  std::vector<cudaGraphNode_t> nodes(n);
  if (err == cudaSuccess && n)
    err = cudaGraphGetNodes(graph, nodes.data(), &n);
  for (size_t i = 0; i < n && err == cudaSuccess; ++i) {
    cudaGraphNodeType type = cudaGraphNodeTypeCount;
    err = cudaGraphNodeGetType(nodes[i], &type);
    c[0] += 1;
    c[1] += type == cudaGraphNodeTypeKernel;
    c[2] += type == cudaGraphNodeTypeMemcpy;
    c[3] += type == cudaGraphNodeTypeMemset;
    c[5] += type == cudaGraphNodeTypeConditional;
    if (err == cudaSuccess && type == cudaGraphNodeTypeGraph) {
      c[4] += 1;
      cudaGraph_t child = nullptr;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err == cudaSuccess) err = census(child, c);
    }
  }
  if (err == cudaSuccess)
    err = cudaGraphGetEdges_v2(graph, nullptr, nullptr, nullptr, &m);
  std::vector<cudaGraphNode_t> from(m), to(m);
  std::vector<cudaGraphEdgeData> data(m);
  if (err == cudaSuccess && m)
    err = cudaGraphGetEdges_v2(graph, from.data(), to.data(), data.data(), &m);
  c[6] += static_cast<long long>(m);
  for (const cudaGraphEdgeData& e : data)
    c[7] += e.type == cudaGraphDependencyTypeProgrammatic;
  return err;
}

}  // namespace

extern "C" {

const char* jt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// the cudaGraphNodeType of the node the last refused build could not copy
// (-1: none)
int jt_refused_node_type() { return refused_type; }

// step: a cudaGraph_t (copied: the caller keeps its own); done: [batch]
// bool; trips: one int32 on the device; limit >= 1, the most steps a launch
// runs; before, after: graphs (copied; null for none) run before the head
// and after the loop; mark_begin, mark_end: cudaEvent_t (both or neither
// null) recorded before the head and after the WHILE node. *out receives
// the loop, to launch and destroy.
int jt_loop_create(void* step, const void* done, int batch, void* trips,
                   int limit, void* before, void* after, void* mark_begin,
                   void* mark_end, void** out) {
  if (step == nullptr || done == nullptr || trips == nullptr || batch < 1 ||
      limit < 1 || out == nullptr || (mark_begin == nullptr) !=
      (mark_end == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  refused_type = -1;
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
  std::vector<cudaGraphNode_t> at;
  if (err == cudaSuccess && before != nullptr)
    err = copy_graph(static_cast<cudaGraph_t>(before), loop->graph, {}, &at);
  if (err == cudaSuccess && mark_begin != nullptr) {
    err = cudaGraphAddEventRecordNode(
        &loop->mark_begin, loop->graph, at.empty() ? nullptr : at.data(),
        at.size(), static_cast<cudaEvent_t>(mark_begin));
    at = {loop->mark_begin};
  }
  cudaGraphNode_t head = nullptr, node = nullptr, tail = nullptr;
  if (err == cudaSuccess)
    err = add_condition(&head, loop->graph, at, head_args);
  cudaGraphNodeParams cond = {};
  if (err == cudaSuccess) {
    cond.type = cudaGraphNodeTypeConditional;
    cond.conditional.handle = handle;
    cond.conditional.type = cudaGraphCondTypeWhile;
    cond.conditional.size = 1;
    err = cudaGraphAddNode(&node, loop->graph, &head, 1, &cond);
  }
  if (err == cudaSuccess) {
    loop->body = cond.conditional.phGraph_out[0];
    err = copy_graph(static_cast<cudaGraph_t>(step), loop->body, {}, &at);
  }
  if (err == cudaSuccess)
    err = add_condition(&tail, loop->body, at, tail_args);
  std::vector<cudaGraphNode_t> loop_exit = {node};
  if (err == cudaSuccess && mark_end != nullptr) {
    err = cudaGraphAddEventRecordNode(&loop->mark_end, loop->graph, &node, 1,
                                      static_cast<cudaEvent_t>(mark_end));
    loop_exit = {loop->mark_end};
  }
  if (err == cudaSuccess && after != nullptr)
    err = copy_graph(static_cast<cudaGraph_t>(after), loop->graph, loop_exit,
                     &at);
  return finish(loop, err, out);
}

// the loop's boundary event record nodes (a loop made with marks) record
// `mark_begin` and `mark_end` in the launches after this call
int jt_loop_marks(void* loop, void* mark_begin, void* mark_end) {
  Loop* l = static_cast<Loop*>(loop);
  if (l == nullptr || l->mark_begin == nullptr || mark_begin == nullptr ||
      mark_end == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaGraphExecEventRecordNodeSetEvent(
      l->exec, l->mark_begin, static_cast<cudaEvent_t>(mark_begin));
  if (err == cudaSuccess)
    err = cudaGraphExecEventRecordNodeSetEvent(
        l->exec, l->mark_end, static_cast<cudaEvent_t>(mark_end));
  return static_cast<int>(err);
}

// step: a cudaGraph_t (copied n times: the caller keeps its own); n >= 1.
// *out receives the chain, to launch and destroy as a loop.
int jt_chain_create(void* step, int n, void** out) {
  if (step == nullptr || n < 1 || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  refused_type = -1;
  Loop* chain = new Loop();
  cudaError_t err = cudaGraphCreate(&chain->graph, 0);
  std::vector<cudaGraphNode_t> at;
  for (int i = 0; i < n && err == cudaSuccess; ++i)
    err = copy_graph(static_cast<cudaGraph_t>(step), chain->graph, at, &at);
  return finish(chain, err, out);
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

// out[8]: nodes, kernel nodes, memcpy nodes, memset nodes, child graph
// nodes, conditional nodes, edges, programmatic edges of `graph` and,
// recursively, of its child graphs
int jt_graph_census(void* graph, long long* out) {
  if (graph == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < 8; ++i) out[i] = 0;
  return static_cast<int>(census(static_cast<cudaGraph_t>(graph), out));
}

// the census of a loop's WHILE body (a chain: its graph)
int jt_loop_census(void* loop, long long* out) {
  if (loop == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Loop* l = static_cast<Loop*>(loop);
  for (int i = 0; i < 8; ++i) out[i] = 0;
  return static_cast<int>(census(l->body ? l->body : l->graph, out));
}

}  // extern "C"
