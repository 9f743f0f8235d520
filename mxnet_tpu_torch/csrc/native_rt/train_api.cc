// MXTrainNative*: a whole training step from a kind="train" .mxa artifact,
// with no Python in the process (the JAX package's
// mxnet_tpu/src/c_predict_pjrt.cc:1441-1769 has the same ten entry points,
// roles, input order, t counter from t0, per-step lr, SaveParams wire and
// outputs). The step is the port's fused step (parallel/spmd.py
// SPMDTrainer._forward_backward and _apply_rule), eager, one op at a time:
// the forward over the program with the parameters as autograd leaves
// (cast to compute_dtype where the fused step casts them), the loss
// outputs seeded with ones and the others with zeros, libtorch's C++
// autograd for the gradients, the auxiliary states and then each
// parameter and its slots updated in place on the device (the
// counterpart of the JAX step's donation). The rules are
// parallel/fused_opt.py's, with its slot order and arithmetic in its order:
// SGD (with or without momentum; ccSGD under its rule), NAG, Adam, AdaGrad,
// RMSProp (plain, one slot; centered, three), AdaDelta and Ftrl; any other
// optimizer fails at create naming it, as fused_opt.make_rule refuses it.
// A stochastic graph draws on its device from a generator seeded with
// seed + t, so a replay is deterministic.
//
// An artifact with num_devices N > 1 (export_train_artifact(num_devices=N))
// trains over N positions from the one file: the batch inputs cut into N
// contiguous blocks, every node run as the program's data-parallel plan
// says (dp.cc), each position's gradients taken and summed in position
// order, and the rule applied once to the one set of parameters and slots
// every position reads. Positions lie on the CPU where the caller asks for
// it, else position p on cuda:(p mod the cards visible): on one card every
// position is cuda:0 (ROADMAP.md C41; the JAX package's runtime needs N
// devices).
#include <ATen/CPUGeneratorImpl.h>
#include <torch/csrc/autograd/autograd.h>

#include <cmath>
#include <cstring>
#include <memory>
#include <mutex>
#include <set>

#include "runtime.h"

#define MXT_DLL extern "C" __attribute__((visibility("default")))

typedef unsigned int mx_uint;
typedef float mx_float;
typedef void* TrainNativeHandle;

namespace mxt_rt {
namespace {

struct TrainArg {
  std::string name;
  std::string role;  // param | state | aux | data | label | lr | t
  std::vector<int64_t> shape;
  std::vector<uint32_t> shape_u32;
  at::ScalarType dtype = at::kFloat;
  int64_t n_elem = 1;
  bool batch = false;  // "sharding": "batch": cut along axis 0
};

struct Rule {
  // SGD, NAG, Adam, AdaGrad, RMSProp, AdaDelta or Ftrl
  std::string name;
  double momentum = 0, beta1 = 0.9, beta2 = 0.999, eps = 1e-8;
  double gamma1 = 0.9, gamma2 = 0.9, clip_weights = 0, rho = 0.9;
  double lamda1 = 0.01, beta = 1.0;
  bool centered = false;
  double rescale = 1.0, clip = -1.0, wd = 0.0;
  std::map<std::string, double> lr_mult, wd_mult;

  // fused_opt.py's nslot of each rule
  int nslot() const {
    if (name == "SGD" || name == "NAG") return momentum != 0 ? 1 : 0;
    if (name == "RMSProp") return centered ? 3 : 1;
    if (name == "AdaGrad") return 1;
    return 2;  // Adam, AdaDelta, Ftrl
  }

  // fused_opt.py _Rule.step_lr: Adam's bias correction folded into the
  // step size on the host in double precision
  double step_lr(double lr, int t) const {
    if (name != "Adam") return lr;
    double coef1 = 1.0 - std::pow(beta1, t);
    double coef2 = 1.0 - std::pow(beta2, t);
    return lr * std::sqrt(coef2) / coef1;
  }

  // fused_opt.py _grad: rescaled, clipped when the clip is positive
  at::Tensor grad(const at::Tensor& g0) const {
    at::Tensor g = g0 * rescale;
    if (clip > 0) g = at::clamp(g, -clip, clip);
    return g;
  }

  // optimizer_ops.py _prep_grad: the same, with the weight decay added
  at::Tensor prep(const at::Tensor& g0, const at::Tensor& w, double wd_n) const {
    return grad(g0) + wd_n * w;
  }

  // each rule of fused_opt.py, its arithmetic in its order
  void apply(at::Tensor& w, const at::Tensor& g0, std::vector<at::Tensor>& st,
             const at::Tensor& lr, double wd_n) const {
    if (name == "Adam") {
      at::Tensor g = prep(g0, w, wd_n);
      at::Tensor mean = beta1 * st[0] + (1 - beta1) * g;
      at::Tensor var = beta2 * st[1] + (1 - beta2) * at::square(g);
      at::Tensor new_w = w - lr * mean / (at::sqrt(var) + eps);
      st[0].copy_(mean);
      st[1].copy_(var);
      w.copy_(new_w);
    } else if (name == "SGD") {
      at::Tensor g = prep(g0, w, wd_n);
      if (momentum != 0) {
        at::Tensor m = momentum * st[0] - lr * g;
        at::Tensor new_w = w + m;
        st[0].copy_(m);
        w.copy_(new_w);
      } else {
        w.copy_(w - lr * g);
      }
    } else if (name == "NAG") {
      at::Tensor g = grad(g0);
      if (momentum != 0) {
        at::Tensor m = st[0] * momentum;
        g = g + wd_n * w;
        m = m + g;
        g = g + momentum * m;
        st[0].copy_(m);
        w.copy_(w + -lr * g);
      } else {
        w.copy_(w + -lr * (g + wd_n * w));
      }
    } else if (name == "AdaGrad") {
      at::Tensor g = grad(g0);
      at::Tensor hist = st[0] + g * g;
      st[0].copy_(hist);
      w.copy_(w + -lr * (g / at::sqrt(hist + eps) + wd_n * w));
    } else if (name == "RMSProp") {
      at::Tensor g = prep(g0, w, wd_n);
      at::Tensor new_n = (1 - gamma1) * at::square(g) + gamma1 * st[0];
      at::Tensor new_w;
      if (centered) {
        at::Tensor new_g = (1 - gamma1) * g + gamma1 * st[1];
        at::Tensor new_delta =
            gamma2 * st[2] - lr * g / at::sqrt(new_n - at::square(new_g) + eps);
        new_w = w + new_delta;
        st[0].copy_(new_n);
        st[1].copy_(new_g);
        st[2].copy_(new_delta);
      } else {
        new_w = w - lr * g / at::sqrt(new_n + eps);
        st[0].copy_(new_n);
      }
      if (clip_weights != 0) new_w = at::clamp(new_w, -clip_weights, clip_weights);
      w.copy_(new_w);
    } else if (name == "AdaDelta") {
      at::Tensor g = grad(g0);
      at::Tensor ag = st[0] * rho + (1.0 - rho) * g * g;
      at::Tensor cur = at::sqrt(st[1] + eps) / at::sqrt(ag + eps) * g;
      at::Tensor ad = st[1] * rho + (1.0 - rho) * cur * cur;
      st[0].copy_(ag);
      st[1].copy_(ad);
      w.copy_(w - cur - wd_n * w);
    } else {  // Ftrl
      at::Tensor g = grad(g0);
      at::Tensor z = st[0], n = st[1];
      at::Tensor zv = z + (g - (at::sqrt(n + g * g) - at::sqrt(n)) / lr * w);
      at::Tensor nv = n + g * g;
      z.copy_(zv);
      n.copy_(nv);
      w.copy_((at::sign(zv) * lamda1 - zv) / ((beta + at::sqrt(nv)) / lr + wd_n) *
              (at::abs(zv) > lamda1).to(zv.scalar_type()));
    }
  }
};

struct Trainer {
  Graph graph;
  at::Device device = at::kCPU;   // position 0's, where the state lives
  std::vector<at::Device> pos;    // each position's device
  std::vector<TrainArg> args;     // flat order: carry, inputs, lr, t
  std::vector<TrainArg> outputs;  // flat order: carry, then "out"
  size_t n_carry = 0;
  std::vector<std::string> pnames, anames;
  std::map<std::string, at::Tensor> params, auxs;
  std::map<std::string, std::vector<at::Tensor>> states;
  std::vector<int> input_idx;     // arg index of each settable input
  std::vector<at::Tensor> input_vals;
  std::vector<char> loss_flags;
  std::vector<at::Tensor> outs;   // the last step's "out" outputs
  Rule rule;
  std::optional<at::ScalarType> compute_dtype;
  std::set<std::string> cast_exempt;
  bool stochastic = false;
  std::optional<at::Generator> gen;  // a CUDA trainer's generator
  int64_t seed = 0;
  int32_t t = 1;
  bool has_run = false;
  bool broken = false;
};

bool parse_train_arg(const JVal& j, TrainArg* s) {
  const JVal* n = j.get("name");
  const JVal* role = j.get("role");
  const JVal* shp = j.get("shape");
  const JVal* dt = j.get("dtype");
  if (!n || !role || !shp || !dt) return false;
  s->name = n->str;
  s->role = role->str;
  if (!json_shape(*shp, &s->shape, &s->shape_u32, &s->n_elem)) return false;
  const JVal* shard = j.get("sharding");
  if (shard && shard->kind == JVal::STR) {
    if (shard->str != "rep" && shard->str != "batch") return false;
    s->batch = shard->str == "batch";
  }
  bool ok = false;
  s->dtype = dtype_by_name(dt->str, &ok);
  return ok;
}

double num_or(const JVal* o, const char* k, double def) {
  if (!o) return def;
  const JVal* v = o->get(k);
  return v && v->kind == JVal::NUM ? v->num : def;
}

int create(const char* bytes, size_t size, TrainNativeHandle* out) {
  Artifact art;
  std::string err;
  if (!read_artifact(bytes, size, &art, &err)) return fail(err);
  const JVal& m = art.manifest;
  const JVal* jkind = m.get("kind");
  if (!jkind || jkind->str != "train")
    return fail(".mxa: not a train artifact (kind != \"train\"); use "
                "MXPredCreateFromFile for predict artifacts");
  auto tr = std::make_unique<Trainer>();
  if (!parse_graph(art.program, &tr->graph, &err)) return fail(err);
  const JVal* jnd = m.get("num_devices");
  const int n_dev =
      jnd && jnd->kind == JVal::NUM ? static_cast<int>(jnd->num) : 1;
  if (n_dev < 1) return fail(".mxa: num_devices must be at least 1");
  if (n_dev > 1) {
    if (tr->graph.dp.n != n_dev)
      return fail(".mxa: num_devices=" + std::to_string(n_dev) +
                  " but the program carries no data-parallel plan over " +
                  std::to_string(n_dev) + " positions (export it with "
                  "export_train_artifact(num_devices=" +
                  std::to_string(n_dev) + "))");
    std::string why = dp_plan_refusal(tr->graph);
    if (!why.empty()) return fail(why);
  }
  const JVal* jargs = m.get("args");
  const JVal* jouts = m.get("outputs");
  if (!jargs || !jouts || jargs->kind != JVal::ARR || jouts->kind != JVal::ARR)
    return fail(".mxa: train manifest missing args/outputs");
  for (const auto& j : jargs->arr) {
    TrainArg a;
    if (!parse_train_arg(j, &a)) return fail(".mxa: bad train arg spec");
    tr->args.push_back(std::move(a));
  }
  for (const auto& j : jouts->arr) {
    TrainArg a;
    if (!parse_train_arg(j, &a)) return fail(".mxa: bad train output spec");
    tr->outputs.push_back(std::move(a));
  }
  const JVal* jt0 = m.get("t0");
  tr->t = jt0 && jt0->kind == JVal::NUM ? static_cast<int32_t>(jt0->num) : 1;
  const JVal* jseed = m.get("seed");
  tr->seed = jseed && jseed->kind == JVal::NUM ? static_cast<int64_t>(jseed->num) : 0;
  const JVal* jloss = m.get("loss_outputs");
  if (jloss && jloss->kind == JVal::ARR)
    for (const auto& f : jloss->arr)
      tr->loss_flags.push_back(f.kind == JVal::BOOL && f.b);

  // the rule
  const JVal* jopt = m.get("optimizer");
  const JVal* jop = m.get("optimizer_params");
  std::string opt = jopt && jopt->kind == JVal::STR ? jopt->str : "";
  if (opt == "ccSGD") opt = "SGD";
  static const std::set<std::string> kRules = {"SGD", "NAG", "Adam", "AdaGrad",
                                               "RMSProp", "AdaDelta", "Ftrl"};
  if (!kRules.count(opt))
    return fail(".mxa: optimizer '" + opt + "' has no fused rule (supported: "
                "SGD/ccSGD, NAG, Adam, AdaGrad, RMSProp, AdaDelta, Ftrl)");
  if (!jop || jop->kind != JVal::OBJ)
    return fail(".mxa: train manifest missing optimizer_params");
  tr->rule.name = opt;
  tr->rule.momentum = num_or(jop, "momentum", 0.0);
  tr->rule.beta1 = num_or(jop, "beta1", 0.9);
  tr->rule.beta2 = num_or(jop, "beta2", 0.999);
  tr->rule.eps = num_or(jop, "eps", 1e-8);
  tr->rule.gamma1 = num_or(jop, "gamma1", 0.9);
  tr->rule.gamma2 = num_or(jop, "gamma2", 0.9);
  tr->rule.centered = num_or(jop, "centered", 0.0) != 0;
  tr->rule.clip_weights = num_or(jop, "clip_weights", 0.0);
  tr->rule.rho = num_or(jop, "rho", 0.9);
  tr->rule.lamda1 = num_or(jop, "lamda1", 0.01);
  tr->rule.beta = num_or(jop, "beta", 1.0);
  tr->rule.rescale = num_or(jop, "rescale_grad", 1.0);
  tr->rule.clip = num_or(jop, "clip_gradient", -1.0);
  tr->rule.wd = num_or(jop, "wd", 0.0);
  for (const char* k : {"lr_mult", "wd_mult"}) {
    const JVal* mult = jop->get(k);
    if (mult && mult->kind == JVal::OBJ)
      for (const auto& kv : mult->obj)
        (strcmp(k, "lr_mult") == 0 ? tr->rule.lr_mult : tr->rule.wd_mult)
            [kv.first] = kv.second.num;
  }
  const JVal* jns = m.get("nslot");
  if (jns && jns->kind == JVal::NUM && static_cast<int>(jns->num) != tr->rule.nslot())
    return fail(".mxa: nslot does not match the rule's slots");
  const JVal* jcd = m.get("compute_dtype");
  if (jcd && jcd->kind == JVal::STR && jcd->str != "float32") {
    bool ok = false;
    at::ScalarType t = dtype_by_name(jcd->str, &ok);
    if (!ok) return fail(".mxa: unsupported compute_dtype " + jcd->str);
    tr->compute_dtype = t;
  }

  // carry prefix: param/state/aux args, mirrored by the outputs' prefix
  for (const auto& a : tr->args) {
    if (a.role == "param" || a.role == "state" || a.role == "aux")
      ++tr->n_carry;
    else
      break;
  }
  size_t n_state_outs = 0;
  for (const auto& o : tr->outputs)
    if (o.role == "param" || o.role == "state" || o.role == "aux") ++n_state_outs;
  if (n_state_outs != tr->n_carry)
    return fail(".mxa: carry mismatch (outputs carry " +
                std::to_string(n_state_outs) + " args " +
                std::to_string(tr->n_carry) + ")");
  for (size_t i = 0; i < tr->n_carry; ++i)
    if (tr->outputs[i].name != tr->args[i].name)
      return fail(".mxa: carry order mismatch at slot " + std::to_string(i));
  if (tr->outputs.size() - n_state_outs != tr->graph.heads.size())
    return fail(".mxa: the manifest's outputs do not match the program's heads");

  // validate the blob against the manifest before anything is allocated
  std::vector<const HostArray*> init(tr->n_carry, nullptr);
  for (size_t i = 0; i < tr->n_carry; ++i) {
    const TrainArg& a = tr->args[i];
    std::string key = (a.role == "param" ? "arg:" + a.name
                       : a.role == "aux" ? "aux:" + a.name
                                         : "state:" + a.name);
    auto it = art.by_name.find(key);
    if (it == art.by_name.end())
      return fail(".mxa: initial value '" + key + "' missing from blob");
    const HostArray& h = *it->second;
    if (h.none) return fail(".mxa: '" + key + "' is a none record");
    if (h.dtype != kF32 || a.dtype != at::kFloat)
      return fail(".mxa: dtype mismatch for '" + key + "'");
    if (h.data.size() != static_cast<size_t>(a.n_elem) * 4)
      return fail(".mxa: shape mismatch for '" + key + "' (blob record holds " +
                  std::to_string(h.data.size()) + " bytes, manifest wants " +
                  std::to_string(static_cast<size_t>(a.n_elem) * 4) + ")");
    if (a.batch)
      return fail(".mxa: carried arg '" + a.name +
                  "' is sharded; only replicated carry is supported");
    init[i] = &h;
  }
  // sharded inputs and outputs must split evenly over the positions
  for (const auto* rows : {&tr->args, &tr->outputs})
    for (const auto& a : *rows)
      if (a.batch && (a.shape.empty() || a.shape[0] % n_dev != 0))
        return fail(std::string(".mxa: sharded ") +
                    (rows == &tr->args ? "arg '" : "output '") + a.name +
                    "' batch dim does not divide num_devices");

  if (!resolve_device(0, 0, &tr->device, &err)) return fail(err);
  for (int p = 0; p < n_dev; ++p)
    tr->pos.push_back(tr->device.is_cuda()
                          ? at::Device(at::kCUDA, static_cast<c10::DeviceIndex>(
                                                      p % at::getNumGPUs()))
                          : tr->device);
  auto f32 = at::TensorOptions().dtype(at::kFloat).device(tr->device);
  for (size_t i = 0; i < tr->n_carry; ++i) {
    const TrainArg& a = tr->args[i];
    at::Tensor host = at::empty(a.shape, at::TensorOptions().dtype(at::kFloat));
    memcpy(host.data_ptr(), init[i]->data.data(), init[i]->data.size());
    at::Tensor dev = host.to(tr->device);
    if (a.role == "param") {
      tr->pnames.push_back(a.name);
      tr->params[a.name] = dev;
    } else if (a.role == "aux") {
      tr->anames.push_back(a.name);
      tr->auxs[a.name] = dev;
    } else {
      size_t colon = a.name.rfind(':');
      tr->states[a.name.substr(0, colon)].push_back(dev);
    }
  }
  for (const auto& n : tr->pnames)
    if (static_cast<int>(tr->states[n].size()) != tr->rule.nslot())
      return fail(".mxa: parameter '" + n + "' lacks its optimizer slots");
  for (size_t i = tr->n_carry; i < tr->args.size(); ++i) {
    const TrainArg& a = tr->args[i];
    if (a.role != "data" && a.role != "label") continue;
    tr->input_idx.push_back(static_cast<int>(i));
    tr->input_vals.push_back(at::zeros(a.shape, f32));
    if (a.role == "label") tr->cast_exempt.insert(a.name);
  }
  // index-like inputs (token ids) keep float32 under a compute_dtype, and
  // the graph's draws make it stochastic
  for (const auto& n : tr->graph.nodes) {
    if (n.op == "null") continue;
    if (op_is_stochastic(n)) tr->stochastic = true;
    for (size_t pos : index_arg_positions(n.op))
      if (pos < n.inputs.size() && tr->graph.nodes[n.inputs[pos].first].op == "null")
        tr->cast_exempt.insert(tr->graph.nodes[n.inputs[pos].first].name);
  }
  *out = tr.release();
  return 0;
}

// One step over the trainer's positions (one, or the data-parallel plan's
// N): the SPMDTrainer step's forward, backward and rule, with each
// position's gradients summed in position order (collectives.psum)
void step(Trainer* tr, float lr_in) {
  // this step's learning rate as a float32 device scalar (SPMDTrainer._lr)
  at::Tensor lr = at::full({}, tr->rule.step_lr(static_cast<double>(lr_in), tr->t),
                           at::TensorOptions().dtype(at::kFloat).device(tr->device));
  const size_t P = tr->pos.size();
  // per position, its own leaf of every parameter (dp.py's replicas)
  std::vector<std::map<std::string, at::Tensor>> leaves(P), vars(P);
  for (size_t p = 0; p < P; ++p)
    for (const auto& n : tr->pnames)
      leaves[p][n] = to_pos(tr->params[n], tr->pos[p]).detach().requires_grad_(true);
  auto cast = [&](const std::string& name, const at::Tensor& t) {
    if (tr->compute_dtype && !tr->cast_exempt.count(name) &&
        t.scalar_type() == at::kFloat)
      return t.to(*tr->compute_dtype);
    return t;
  };
  std::vector<std::vector<at::Tensor>> outs_pp;
  std::vector<at::Tensor> xs, grads;
  {
    at::AutoGradMode grad_on(true);
    std::vector<OpCtx> ctxs(P);
    for (size_t p = 0; p < P; ++p) {
      for (const auto& kv : leaves[p]) vars[p][kv.first] = cast(kv.first, kv.second);
      for (size_t i = 0; i < tr->input_idx.size(); ++i) {
        const TrainArg& a = tr->args[tr->input_idx[i]];
        at::Tensor v = tr->input_vals[i];
        if (a.batch) {
          const int64_t size = v.size(0) / static_cast<int64_t>(P);
          v = v.narrow(0, static_cast<int64_t>(p) * size, size).contiguous();
        }
        vars[p][a.name] = cast(a.name, to_pos(v, tr->pos[p]));
      }
      for (const auto& kv : tr->auxs) vars[p][kv.first] = to_pos(kv.second, tr->pos[p]);
      ctxs[p].is_train = true;
      ctxs[p].device = tr->pos[p];
    }
    if (tr->stochastic) {
      uint64_t seed = static_cast<uint64_t>(tr->seed + tr->t);
      if (tr->device.is_cuda()) {
        // the card draws from a CUDA generator of the trainer's own (a
        // clone of the device's default, so the process's stays as it
        // was), reseeded every step
        if (!tr->gen)
          tr->gen = at::globalContext()
                        .defaultGenerator(at::Device(
                            at::kCUDA, tr->device.has_index() ? tr->device.index() : 0))
                        .clone();
        std::lock_guard<std::mutex> lock(tr->gen->mutex());
        tr->gen->set_current_seed(seed);
        ctxs[0].gen = *tr->gen;
      } else {
        ctxs[0].gen = at::make_generator<at::CPUGeneratorImpl>(seed);
      }
    }
    auto vals = run_graph(tr->graph, &vars, ctxs, {});
    outs_pp.resize(P);
    for (size_t p = 0; p < P; ++p)
      for (const auto& h : tr->graph.heads)
        outs_pp[p].push_back(vals[h.first][p][h.second]);
    std::vector<at::Tensor> ys, seeds;
    for (const auto& outs : outs_pp)
      for (size_t k = 0; k < outs.size(); ++k)
        if (outs[k].requires_grad()) {
          bool loss = k < tr->loss_flags.size() && tr->loss_flags[k];
          ys.push_back(outs[k]);
          seeds.push_back(at::full_like(outs[k], loss ? 1.0 : 0.0));
        }
    for (size_t p = 0; p < P; ++p)
      for (const auto& n : tr->pnames) xs.push_back(leaves[p][n]);
    if (!ys.empty() && !xs.empty())
      grads = torch::autograd::grad(ys, xs, seeds, std::nullopt, false, true);
    else
      grads.assign(xs.size(), at::Tensor());
    at::NoGradGuard no_grad;
    for (const auto& n : tr->anames) tr->auxs[n].copy_(vars[0][n]);
  }
  at::NoGradGuard no_grad;
  const size_t n_par = tr->pnames.size();
  for (size_t i = 0; i < n_par; ++i) {
    const std::string& n = tr->pnames[i];
    at::Tensor& w = tr->params[n];
    at::Tensor g;
    for (size_t p = 0; p < P; ++p) {
      const at::Tensor& gp = grads[p * n_par + i];
      at::Tensor part = gp.defined() ? gp : at::zeros_like(leaves[p][n]);
      g = p == 0 ? part : g + to_pos(part, tr->device);
    }
    g = g.to(w.scalar_type());
    double lm = tr->rule.lr_mult.count(n) ? tr->rule.lr_mult[n] : 1.0;
    double wm = tr->rule.wd_mult.count(n) ? tr->rule.wd_mult[n] : 1.0;
    tr->rule.apply(w, g, tr->states[n], lr * lm, tr->rule.wd * wm);
  }
  // the outputs over the global batch, joined along their batch axes
  tr->outs.clear();
  for (size_t k = 0; k < outs_pp[0].size(); ++k) {
    const auto& h = tr->graph.heads[k];
    int a = batch_axis(tr->graph, h.first, h.second);
    if (a == kNoBatch) {
      tr->outs.push_back(outs_pp[0][k].detach());
      continue;
    }
    std::vector<at::Tensor> parts;
    for (size_t p = 0; p < P; ++p)
      parts.push_back(to_pos(outs_pp[p][k].detach(), tr->device));
    tr->outs.push_back(at::cat(parts, a));
  }
  tr->t += 1;
}

#define API_BEGIN() try {
#define API_END()                                   \
  }                                                 \
  catch (const c10::Error& e) {                     \
    return fail(e.what_without_backtrace());        \
  }                                                 \
  catch (const std::exception& e) {                 \
    return fail(e.what());                          \
  }                                                 \
  return 0;

}  // namespace
}  // namespace mxt_rt

using namespace mxt_rt;

MXT_DLL int MXTrainNativeCreateFromFile(const char* artifact_path,
                                        TrainNativeHandle* out) {
  API_BEGIN();
  std::vector<char> bytes;
  std::string err;
  if (!read_file(artifact_path, &bytes, &err)) return fail(err);
  return create(bytes.data(), bytes.size(), out);
  API_END();
}

MXT_DLL int MXTrainNativeNumInputs(TrainNativeHandle h, mx_uint* out) {
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  *out = static_cast<mx_uint>(tr->input_idx.size());
  return 0;
}

MXT_DLL int MXTrainNativeInputInfo(TrainNativeHandle h, mx_uint index,
                                   const char** name, const char** role,
                                   const mx_uint** shape, mx_uint* ndim) {
  auto* tr = static_cast<Trainer*>(h);
  if (!tr || index >= tr->input_idx.size()) return fail("bad input index");
  const TrainArg& a = tr->args[tr->input_idx[index]];
  *name = a.name.c_str();
  *role = a.role.c_str();
  *shape = a.shape_u32.data();
  *ndim = static_cast<mx_uint>(a.shape_u32.size());
  return 0;
}

MXT_DLL int MXTrainNativeSetInput(TrainNativeHandle h, const char* key,
                                  const mx_float* data, mx_uint size) {
  API_BEGIN();
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  for (size_t i = 0; i < tr->input_idx.size(); ++i) {
    const TrainArg& a = tr->args[tr->input_idx[i]];
    if (a.name != key) continue;
    if (a.dtype != at::kFloat)
      return fail("MXTrainNativeSetInput is float32; input '" + a.name +
                  "' is not float32 in the artifact");
    if (size != static_cast<mx_uint>(a.n_elem))
      return fail("MXTrainNativeSetInput: size mismatch for '" + a.name + "'");
    tr->input_vals[i].copy_(at::from_blob(const_cast<mx_float*>(data), a.shape,
                                          at::TensorOptions().dtype(at::kFloat)));
    return 0;
  }
  return fail(std::string("unknown train input '") + key + "'");
  API_END();
}

MXT_DLL int MXTrainNativeStep(TrainNativeHandle h, mx_float lr) {
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  if (tr->broken)
    return fail("the carried state is gone (a previous step failed); "
                "recreate the trainer");
  try {
    step(tr, lr);
  } catch (const c10::Error& e) {
    tr->broken = true;  // a step may have updated part of the state
    return fail(e.what_without_backtrace());
  } catch (const std::exception& e) {
    tr->broken = true;
    return fail(e.what());
  }
  tr->has_run = true;
  return 0;
}

MXT_DLL int MXTrainNativeNumOutputs(TrainNativeHandle h, mx_uint* out) {
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  *out = static_cast<mx_uint>(tr->outputs.size() - tr->n_carry);
  return 0;
}

MXT_DLL int MXTrainNativeOutputInfo(TrainNativeHandle h, mx_uint index,
                                    const char** name, int* is_loss,
                                    const mx_uint** shape, mx_uint* ndim) {
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  size_t i = tr->n_carry + index;
  if (i >= tr->outputs.size()) return fail("output index out of range");
  const TrainArg& a = tr->outputs[i];
  *name = a.name.c_str();
  *is_loss = index < tr->loss_flags.size() && tr->loss_flags[index] ? 1 : 0;
  *shape = a.shape_u32.data();
  *ndim = static_cast<mx_uint>(a.shape_u32.size());
  return 0;
}

MXT_DLL int MXTrainNativeGetOutput(TrainNativeHandle h, mx_uint index,
                                   mx_float* data, mx_uint size) {
  API_BEGIN();
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  if (!tr->has_run) return fail("call MXTrainNativeStep first");
  if (index >= tr->outs.size()) return fail("output index out of range");
  const at::Tensor& t = tr->outs[index];
  if (size != static_cast<mx_uint>(t.numel()))
    return fail("MXTrainNativeGetOutput: size mismatch");
  // the C contract is float32 (a bfloat16 compute_dtype's outputs too),
  // copied from the device into the caller's buffer
  at::from_blob(data, t.sizes(), at::TensorOptions().dtype(at::kFloat))
      .copy_(t);
  API_END();
}

MXT_DLL int MXTrainNativeSaveParams(TrainNativeHandle h, const char* path) {
  API_BEGIN();
  auto* tr = static_cast<Trainer*>(h);
  if (!tr) return fail("null trainer");
  if (tr->broken) return fail("carried state is gone (a step failed); cannot save");
  std::vector<std::string> names;
  std::vector<std::vector<int64_t>> shapes;
  std::vector<at::Tensor> hosts;
  for (size_t i = 0; i < tr->n_carry; ++i) {
    const TrainArg& a = tr->args[i];
    if (a.role != "param" && a.role != "aux") continue;
    const at::Tensor& t = a.role == "param" ? tr->params[a.name] : tr->auxs[a.name];
    names.push_back((a.role == "param" ? "arg:" : "aux:") + a.name);
    shapes.push_back(a.shape);
    hosts.push_back(t.to(at::kCPU, at::kFloat).contiguous());
  }
  std::vector<const float*> data;
  for (const auto& t : hosts) data.push_back(t.data_ptr<float>());
  std::string err;
  if (!write_params_f32(path, names, shapes, data, &err)) return fail(err);
  API_END();
}

MXT_DLL int MXTrainNativeFree(TrainNativeHandle h) {
  API_BEGIN();
  delete static_cast<Trainer*>(h);
  API_END();
}
