// The interpreter's shared declarations: the graph of a symbol JSON
// program, the op table over ATen, the device a C caller asked for, and
// the attention kernels' launch counters.
#ifndef MXT_NATIVE_RT_RUNTIME_H_
#define MXT_NATIVE_RT_RUNTIME_H_

#include <ATen/ATen.h>
#include <ATen/core/grad_mode.h>

#include <map>
#include <optional>
#include <stdexcept>
#include <string>
#include <utility>
#include <vector>

#include "container.h"

namespace mxt_rt {

// An error an op raises; the C entry points turn it (and ATen's c10::Error)
// into -1 and MXGetLastError's text.
struct RtError : std::runtime_error {
  explicit RtError(const std::string& m) : std::runtime_error(m) {}
};

// ---- attrs, parsed as ops/registry.py parses them ------------------------
struct Attrs {
  const std::map<std::string, std::string>* m = nullptr;
  std::string op;
  bool has(const std::string& k) const;
  std::string str(const std::string& k, const std::string& def) const;
  double f(const std::string& k, double def) const;
  int64_t i(const std::string& k, int64_t def) const;
  bool b(const std::string& k, bool def) const;
  // base.parse_shape: "(1, 2)", "[1,2]", "3"; "None"/"" give nothing
  std::optional<std::vector<int64_t>> shape(const std::string& k) const;
  int64_t required_i(const std::string& k) const;
};

// ---- the graph -------------------------------------------------------------
struct Node {
  std::string op;  // "null" for a variable
  std::string name;
  std::map<std::string, std::string> attrs;
  std::vector<std::pair<int, int>> inputs;  // (node, output)
};

// The data-parallel plan of a train artifact's program over `n`
// positions: the "dp" entry beside "nodes", parallel/dp.py's decisions as
// export_artifact.py wrote them (the runtime derives none of them).
constexpr int kNoBatch = -1;      // a value the same at every position
constexpr int kUnknownAxis = -2;  // shapes that do not say
struct DPPlan {
  int n = 1;                           // positions (1: no plan)
  std::vector<std::string> forms;      // per node: "" (variable), "local",
                                       // "dp" or "global"
  std::vector<std::vector<int>> axes;  // per node output: its batch axis
};

struct Graph {
  std::vector<Node> nodes;                 // topological order
  std::vector<std::pair<int, int>> heads;  // the outputs
  DPPlan dp;
};

bool parse_graph(const std::string& json, Graph* g, std::string* err);

struct OpOut {
  std::vector<at::Tensor> outputs;
  // new values of the inputs at these positions (auxiliary states)
  std::vector<std::pair<size_t, at::Tensor>> new_aux;
};

struct OpCtx {
  bool is_train = false;
  at::Device device = at::kCPU;
  std::optional<at::Generator> gen;  // stochastic ops draw here (their device's)
};

// Runs every node over the positions, position p on ctxs[p]'s device (a
// one-position run where the program has no data-parallel plan). `vars[p]`
// maps variable names to position p's tensors (an undefined tensor for an
// input the program does not read) and takes its new auxiliary states.
// Returns vals[node][p]: each node's outputs at each position, freed after
// their last use unless `keep` holds (node, output).
std::vector<std::vector<std::vector<at::Tensor>>> run_graph(
    const Graph& g, std::vector<std::map<std::string, at::Tensor>>* vars,
    const std::vector<OpCtx>& ctxs,
    const std::vector<std::pair<int, int>>& keep);

// ---- the data-parallel forms (dp.cc) ------------------------------------------
// `t` on device `d`: itself where it lies there, else a copy
at::Tensor to_pos(const at::Tensor& t, const at::Device& d);
// The refusal of a plan whose node needs a form this runtime lacks (empty
// when it runs every node).
std::string dp_plan_refusal(const Graph& g);
// Node i over the positions (in[p]: its inputs at position p) in its form
// from g.dp, "local" where the program has no plan: a "local" node at each
// position on its block, a "dp" node in its data-parallel form
// (BatchNorm's global statistics, SoftmaxOutput's global count), a
// "global" node once at position 0 on the batch joined from every position.
std::vector<OpOut> run_node(const Graph& g, int i,
                            const std::vector<std::vector<at::Tensor>>& in,
                            const std::vector<OpCtx>& ctxs);
// The batch axis of node `node`'s output k (kNoBatch where the program has
// no plan); raises where the plan does not say.
int batch_axis(const Graph& g, int node, int k);

// ---- ops --------------------------------------------------------------------
// raises naming an op the runtime lacks
OpOut run_op(const Node& n, const std::vector<at::Tensor>& in,
             const OpCtx& ctx);
// positions of the inputs of op `op` that carry integer ids (exempt from
// a compute_dtype cast, as executor.py's _INDEX_ARG_POSITIONS)
std::vector<size_t> index_arg_positions(const std::string& op);
bool op_is_stochastic(const Node& n);
// SoftmaxOutput (ops/loss.py) whose gradient divides by `denom` (loss.py's
// denom: a number or a tensor, a data-parallel step's global count) when
// it is given, else as its normalization says
at::Tensor softmax_output(const Attrs& a, const at::Tensor& data,
                          const at::Tensor& label, const c10::IValue& denom);

// ---- attention (attention.cc) ----------------------------------------------
at::Tensor flash_attention(const at::Tensor& q, const at::Tensor& k,
                           const at::Tensor& v, bool causal, double sm_scale);
at::Tensor multi_head_attention(const at::Tensor& x, const at::Tensor& w_in,
                                const at::Tensor& w_out, int64_t heads,
                                bool causal);

// ---- devices ------------------------------------------------------------------
// dev_type 1 is the CPU, 2 cuda:dev_id; any other (the JAX package's TPU
// included) is the default device: the card, or the CPU under
// MXNET_DEFAULT_CONTEXT=cpu. False with `err` when that device is absent.
bool resolve_device(int dev_type, int dev_id, at::Device* out,
                    std::string* err);

at::ScalarType dtype_by_name(const std::string& name, bool* ok);
at::ScalarType dtype_by_flag(int flag, bool* ok);

// ---- kernel launch counters -----------------------------------------------------
void count_launch(const char* kernel);

}  // namespace mxt_rt

#endif  // MXT_NATIVE_RT_RUNTIME_H_
