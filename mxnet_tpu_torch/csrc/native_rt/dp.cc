// The forms a node takes in a train artifact's step over N positions: the
// counterpart of parallel/dp.py's DPGraph, which graph.cc's run_graph
// calls node by node over contiguous blocks of the batch (a program
// without a plan runs every node "local" at its one position). The
// program's "dp" entry holds DPGraph's decisions
// (export_artifact.py ran it at the global and the per-position batch);
// this file reads them and derives none:
//   local  - the op at each position on its block;
//   dp     - the op's data-parallel form: BatchNorm sums its per-channel
//            sums and sums of squares over the positions (autograd flows
//            back through the sum), SoftmaxOutput divides by the global
//            count under normalization 'batch' or 'valid';
//   global - the op once, at position 0, on the batch joined from every
//            position (Dropout's masks are then the one-position step's),
//            each position given its block of every output.
// The exchanges are collectives.psum's: position 0 sums the positions'
// values in position order and every position reads the sum on its own
// device, so a step computes what dp.py's computes, op for op.
#include "runtime.h"

namespace mxt_rt {
namespace {

using Vec = std::vector<at::Tensor>;
using DPForm = std::vector<OpOut> (*)(const Node&, const std::vector<Vec>&,
                                      const std::vector<OpCtx>&);

// collectives.psum over every position
Vec psum(const Vec& xs, const std::vector<OpCtx>& ctxs) {
  at::Tensor total = xs[0];
  for (size_t p = 1; p < xs.size(); ++p)
    total = total + to_pos(xs[p], ctxs[0].device);
  Vec out;
  for (const auto& c : ctxs) out.push_back(to_pos(total, c.device));
  return out;
}

Attrs attrs_of(const Node& n) {
  Attrs a;
  a.m = &n.attrs;
  a.op = n.op;
  return a;
}

std::vector<OpOut> local(const Node& n, const std::vector<Vec>& in,
                         const std::vector<OpCtx>& ctxs) {
  std::vector<OpOut> out;
  for (size_t p = 0; p < in.size(); ++p) out.push_back(run_op(n, in[p], ctxs[p]));
  return out;
}

// dp.py _batch_norm_dp: the JAX package's one-pass statistics over the
// global batch
std::vector<OpOut> batch_norm_dp(const Node& n, const std::vector<Vec>& in,
                                 const std::vector<OpCtx>& ctxs) {
  Attrs a = attrs_of(n);
  if (a.b("use_global_stats", false) || !ctxs[0].is_train)
    return local(n, in, ctxs);
  const size_t P = in.size();
  for (const auto& ins : in)
    if (ins.size() < 5) throw RtError("op " + n.op + " takes 5 inputs");
  const at::Tensor& x0 = in[0][0];
  const int64_t nd = x0.dim();
  const int64_t ax = ((a.i("axis", 1) % nd) + nd) % nd;
  std::vector<int64_t> red, bshape;
  for (int64_t i = 0; i < nd; ++i) {
    if (i != ax) red.push_back(i);
    bshape.push_back(i == ax ? x0.size(ax) : 1);
  }
  const double count =
      static_cast<double>(x0.numel() / x0.size(ax)) * static_cast<double>(P);
  Vec parts;
  for (const auto& ins : in)
    parts.push_back(at::stack({at::sum(ins[0], red, false, at::kFloat),
                               at::sum(at::square(ins[0].to(at::kFloat)), red)}));
  Vec sums = psum(parts, ctxs);
  const double m = a.f("momentum", 0.9);
  const double eps = a.f("eps", 1e-3);
  const bool fix_gamma = a.b("fix_gamma", true);
  std::vector<OpOut> out(P);
  for (size_t p = 0; p < P; ++p) {
    const at::Tensor& x = in[p][0];
    at::Tensor gamma = fix_gamma ? at::ones_like(in[p][1]) : in[p][1];
    const at::Tensor& beta = in[p][2];
    at::Tensor mean = sums[p][0] / count;
    at::Tensor var = at::clamp_min(sums[p][1] / count - at::square(mean), 0.0);
    auto dt = x.scalar_type();
    at::Tensor inv =
        at::rsqrt(var.reshape(bshape).to(at::kFloat) + eps).to(dt);
    at::Tensor y = (x - mean.reshape(bshape).to(dt)) * inv *
                       gamma.reshape(bshape).to(dt) +
                   beta.reshape(bshape).to(dt);
    out[p].outputs = {y, mean.to(dt), var.to(dt)};
    out[p].new_aux = {{3, in[p][3] * m + mean.detach() * (1 - m)},
                      {4, in[p][4] * m + var.detach() * (1 - m)}};
  }
  return out;
}

// dp.py _softmax_output_dp: the gradient over the global batch ('batch')
// or the global count of the labels it does not ignore ('valid')
std::vector<OpOut> softmax_output_dp(const Node& n, const std::vector<Vec>& in,
                                     const std::vector<OpCtx>& ctxs) {
  Attrs a = attrs_of(n);
  const std::string norm = a.str("normalization", "null");
  if (norm == "null") return local(n, in, ctxs);
  const size_t P = in.size();
  for (const auto& ins : in)
    if (ins.size() < 2 || !ins[1].defined())
      throw RtError("op " + n.op + " (node '" + n.name + "') needs its label");
  std::vector<OpOut> out(P);
  if (norm == "batch") {
    const double denom = static_cast<double>(in[0][0].size(0) * P);
    for (size_t p = 0; p < P; ++p)
      out[p].outputs = {softmax_output(a, in[p][0], in[p][1], denom)};
    return out;
  }
  const auto ignore = static_cast<int64_t>(a.f("ignore_label", -1.0));
  const bool multi = a.b("multi_output", false);
  const bool use_ignore = a.b("use_ignore", false);
  Vec counts;
  for (const auto& ins : in) {
    at::Tensor lab = ins[1].detach().to(at::kLong);
    if (!multi) lab = lab.reshape({-1});
    counts.push_back(use_ignore
                         ? (lab != ignore).to(ins[0].scalar_type()).sum()
                         : at::full({}, static_cast<double>(lab.numel()),
                                    ins[0].options()));
  }
  Vec denoms = psum(counts, ctxs);
  for (size_t p = 0; p < P; ++p)
    out[p].outputs = {softmax_output(a, in[p][0], in[p][1],
                                     at::clamp_min(denoms[p], 1.0))};
  return out;
}

// the data-parallel form of op `op` (dp.py's DP_FORMS that this runtime's
// op table has), or null
DPForm dp_form(const std::string& op) {
  if (op == "BatchNorm" || op == "BatchNorm_v1") return batch_norm_dp;
  if (op == "SoftmaxOutput" || op == "Softmax") return softmax_output_dp;
  return nullptr;
}

// dp.py DPGraph._global
std::vector<OpOut> global(const Graph& g, int i, const std::vector<Vec>& in,
                          const std::vector<OpCtx>& ctxs) {
  const Node& n = g.nodes[i];
  const size_t P = in.size();
  const at::Device dev0 = ctxs[0].device;
  Vec joined;
  for (size_t k = 0; k < n.inputs.size(); ++k) {
    int a = batch_axis(g, n.inputs[k].first, n.inputs[k].second);
    if (a == kNoBatch) {
      joined.push_back(in[0][k]);
      continue;
    }
    Vec parts;
    for (size_t p = 0; p < P; ++p) parts.push_back(to_pos(in[p][k], dev0));
    joined.push_back(at::cat(parts, a));
  }
  OpOut once = run_op(n, joined, ctxs[0]);
  std::vector<OpOut> out(P);
  for (size_t p = 0; p < P; ++p) {
    for (size_t k = 0; k < once.outputs.size(); ++k) {
      at::Tensor o = once.outputs[k];
      int a = batch_axis(g, i, static_cast<int>(k));
      if (a != kNoBatch) {
        int64_t size = o.size(a) / static_cast<int64_t>(P);
        o = o.narrow(a, static_cast<int64_t>(p) * size, size);
      }
      out[p].outputs.push_back(to_pos(o, ctxs[p].device));
    }
    for (const auto& na : once.new_aux)
      out[p].new_aux.push_back({na.first, to_pos(na.second, ctxs[p].device)});
  }
  return out;
}

}  // namespace

at::Tensor to_pos(const at::Tensor& t, const at::Device& d) {
  return t.device() == d ? t : t.to(d);
}

std::string dp_plan_refusal(const Graph& g) {
  for (size_t i = 0; i < g.nodes.size(); ++i) {
    const Node& n = g.nodes[i];
    const std::string& f = g.dp.forms[i];
    if (n.op == "null") continue;
    if (f != "local" && f != "dp" && f != "global")
      return ".mxa: node '" + n.name + "' (op " + n.op +
             ") has no form in the data-parallel plan";
    if (f == "dp" && !dp_form(n.op))
      return ".mxa: op " + n.op + " (node '" + n.name + "') needs a "
             "data-parallel form the native runtime lacks";
  }
  return "";
}

int batch_axis(const Graph& g, int node, int k) {
  if (g.dp.axes.empty()) return kNoBatch;
  int a = g.dp.axes[node].at(k);
  if (a == kUnknownAxis)
    throw RtError("data-parallel step: the plan does not say where the batch "
                  "of node '" + g.nodes[node].name + "' output " +
                  std::to_string(k) + " lies");
  return a;
}

std::vector<OpOut> run_node(const Graph& g, int i, const std::vector<Vec>& in,
                            const std::vector<OpCtx>& ctxs) {
  const Node& n = g.nodes[i];
  static const std::string kLocal = "local";
  const std::string& form = g.dp.forms.empty() ? kLocal : g.dp.forms[i];
  if (form == "local") return local(n, in, ctxs);
  if (form == "global") return global(g, i, in, ctxs);
  if (DPForm f = dp_form(n.op)) return f(n, in, ctxs);
  throw RtError("op " + n.op + " (node '" + n.name + "'): no data-parallel "
                "form in the native runtime");
}

}  // namespace mxt_rt
