// The op table over ATen. Each op copies the port's Python op (ops/*.py)
// line for line, so a program run here gives the port's executor's values:
// on the CPU bit for bit (the same ATen kernels in the same order).
// SoftmaxOutput's gradient is the port's (softmax minus one-hot, times
// grad_scale, the head gradient ignored) through a C++ autograd Function,
// and BatchNorm's moving statistics come back as new auxiliary states.
// An op the table lacks raises, naming it.
#include <torch/csrc/autograd/custom_function.h>

#include <cmath>
#include <functional>
#include <limits>
#include <unordered_map>

#include "runtime.h"

namespace mxt_rt {

namespace {

using torch::autograd::AutogradContext;
using torch::autograd::variable_list;
using Vec = std::vector<at::Tensor>;
using Fn = std::function<OpOut(const Node&, const Attrs&, const Vec&,
                               const OpCtx&)>;

OpOut one(at::Tensor t) {
  OpOut o;
  o.outputs.push_back(std::move(t));
  return o;
}

void need(const Attrs& a, const Vec& in, size_t n) {
  if (in.size() < n)
    throw RtError("op " + a.op + " takes " + std::to_string(n) +
                  " inputs, got " + std::to_string(in.size()));
}

std::vector<int64_t> shape_or(const Attrs& a, const std::string& k,
                              std::vector<int64_t> def) {
  auto s = a.shape(k);
  return s && !s->empty() ? *s : def;
}

// ---- reductions (ops/reduce.py) ------------------------------------------
std::vector<int64_t> reduce_axes(const Attrs& a, int64_t ndim) {
  auto axis = a.shape("axis");
  bool exclude = a.b("exclude", false);
  std::vector<int64_t> axes;
  if (!axis || axis->empty()) {
    if (!exclude)
      for (int64_t d = 0; d < ndim; ++d) axes.push_back(d);
  } else {
    std::vector<char> on(ndim, 0);
    for (int64_t d : *axis) on[((d % ndim) + ndim) % ndim] = 1;
    for (int64_t d = 0; d < ndim; ++d)
      if (on[d] != exclude) axes.push_back(d);
  }
  if (axes.empty())  // an empty set reduces over everything
    for (int64_t d = 0; d < ndim; ++d) axes.push_back(d);
  return axes;
}

// ---- Reshape (ops/matrix.py mx_reshape) ---------------------------------------
std::vector<int64_t> mx_reshape(std::vector<int64_t> src,
                                std::vector<int64_t> target, bool reverse) {
  int64_t total = 1;
  for (int64_t d : src) total *= d;
  if (reverse) {
    std::reverse(src.begin(), src.end());
    std::reverse(target.begin(), target.end());
  }
  std::vector<int64_t> out;
  size_t si = 0;
  auto at_src = [&](size_t k) -> int64_t {
    if (k >= src.size()) throw RtError("Reshape: target codes overrun the input shape");
    return src[k];
  };
  for (size_t i = 0; i < target.size(); ++i) {
    int64_t t = target[i];
    if (t == 0) {
      out.push_back(at_src(si++));
    } else if (t == -1) {
      out.push_back(-1);
      ++si;
    } else if (t == -2) {
      for (; si < src.size(); ++si) out.push_back(src[si]);
    } else if (t == -3) {
      out.push_back(at_src(si) * at_src(si + 1));
      si += 2;
    } else if (t == -4) {
      if (i + 2 >= target.size()) throw RtError("Reshape: -4 needs two dims");
      int64_t d1 = target[i + 1], d2 = target[i + 2], cur = at_src(si);
      if (d1 == -1) d1 = cur / d2;
      if (d2 == -1) d2 = cur / d1;
      out.push_back(d1);
      out.push_back(d2);
      ++si;
      i += 2;
    } else {
      out.push_back(t);
      ++si;
    }
  }
  auto neg = std::find(out.begin(), out.end(), -1);
  if (neg != out.end()) {
    int64_t known = 1;
    if (out.size() > 1)
      for (int64_t d : out)
        if (d != -1) known *= d;
    *neg = total / std::max<int64_t>(known, 1);
  }
  if (reverse) std::reverse(out.begin(), out.end());
  return out;
}

// ---- SoftmaxOutput (ops/loss.py) ---------------------------------------------------
at::Tensor softmax_fwd(const at::Tensor& data, bool multi, bool preserve) {
  if (multi) return at::softmax(data, 1);
  if (preserve) return at::softmax(data, -1);
  return at::softmax(data.reshape({data.size(0), -1}), -1).reshape(data.sizes());
}

at::Tensor minus_onehot(const at::Tensor& p, const at::Tensor& lab, int64_t dim,
                        double on, double off) {
  int64_t n = p.size(dim);
  at::Tensor idx = lab.clamp(0, n - 1).unsqueeze(dim);
  at::Tensor grad = off != 0.0 ? p - off : p.clone();
  at::Tensor hit = at::where(((lab >= 0) & (lab < n)).unsqueeze(dim),
                             p.gather(dim, idx) - on, grad.gather(dim, idx));
  return grad.scatter(dim, idx, hit);
}

struct SoftmaxAttrs {
  double grad_scale, ignore_label, smooth;
  bool multi, use_ignore, preserve, out_grad;
  std::string norm;
  // loss.py's denom: a given count (a number or a tensor) in place of
  // norm's, or None
  c10::IValue denom;
};

// `grad` over the count it divides by: s.denom where given, else the
// normalization's (the batch under 'batch', the labels not ignored where
// `by_valid`)
at::Tensor normalize(const at::Tensor& grad, const at::Tensor& valid,
                     int64_t batch, bool by_valid, const SoftmaxAttrs& s) {
  if (s.denom.isTensor()) return grad / s.denom.toTensor();
  if (s.denom.isDouble()) return grad / s.denom.toDouble();
  if (s.norm == "batch") return grad / static_cast<double>(batch);
  if (by_valid) return grad / at::clamp_min(valid.sum(), 1.0);
  return grad;
}

// the head's gradient
at::Tensor softmax_grad(const at::Tensor& p, const at::Tensor& label,
                        const SoftmaxAttrs& s) {
  int64_t ignore = static_cast<int64_t>(s.ignore_label);
  at::Tensor grad;
  if (s.multi) {
    at::Tensor lab = label.to(at::kLong);
    grad = minus_onehot(p, lab, 1, 1.0, 0.0);
    at::Tensor valid = s.use_ignore ? (lab != ignore).to(p.scalar_type())
                                    : at::ones(lab.sizes(), p.options());
    grad = normalize(grad * valid.unsqueeze(1), valid, p.size(0),
                     s.norm != "null", s);
  } else {
    at::Tensor flat = p.reshape({p.size(0), -1});
    int64_t nclass = flat.size(1);
    at::Tensor lab = label.reshape({-1}).to(at::kLong);
    if (s.smooth != 0.0)
      grad = minus_onehot(flat, lab, 1,
                          (1 - s.smooth) + s.smooth / nclass,
                          s.smooth / nclass);
    else
      grad = minus_onehot(flat, lab, 1, 1.0, 0.0);
    at::Tensor valid = s.use_ignore ? (lab != ignore).to(p.scalar_type())
                                    : at::ones(lab.sizes(), p.options());
    grad = normalize(grad * valid.unsqueeze(1), valid, p.size(0),
                     s.norm == "valid", s);
    grad = grad.reshape(p.sizes());
  }
  return grad * s.grad_scale;
}

struct SoftmaxOutputFn : public torch::autograd::Function<SoftmaxOutputFn> {
  static at::Tensor forward(AutogradContext* ctx, at::Tensor data,
                            at::Tensor label, SoftmaxAttrs s) {
    at::Tensor p = softmax_fwd(data, s.multi, s.preserve);
    ctx->save_for_backward({p, label});
    ctx->saved_data["denom"] = s.denom;
    ctx->saved_data["grad_scale"] = s.grad_scale;
    ctx->saved_data["ignore_label"] = s.ignore_label;
    ctx->saved_data["smooth"] = s.smooth;
    ctx->saved_data["multi"] = s.multi;
    ctx->saved_data["use_ignore"] = s.use_ignore;
    ctx->saved_data["preserve"] = s.preserve;
    ctx->saved_data["out_grad"] = s.out_grad;
    ctx->saved_data["norm"] = s.norm;
    return p;
  }
  static variable_list backward(AutogradContext* ctx, variable_list g) {
    auto saved = ctx->get_saved_variables();
    SoftmaxAttrs s;
    s.grad_scale = ctx->saved_data["grad_scale"].toDouble();
    s.ignore_label = ctx->saved_data["ignore_label"].toDouble();
    s.smooth = ctx->saved_data["smooth"].toDouble();
    s.multi = ctx->saved_data["multi"].toBool();
    s.use_ignore = ctx->saved_data["use_ignore"].toBool();
    s.preserve = ctx->saved_data["preserve"].toBool();
    s.out_grad = ctx->saved_data["out_grad"].toBool();
    s.norm = ctx->saved_data["norm"].toStringRef();
    s.denom = ctx->saved_data["denom"];
    at::Tensor grad = softmax_grad(saved[0], saved[1], s);
    if (s.out_grad) grad = grad * g[0];
    return {grad, at::Tensor(), at::Tensor()};
  }
};

// ---- Pooling helpers (ops/nn.py) --------------------------------------------------
at::Tensor pad_spatial(const at::Tensor& x,
                       const std::vector<std::pair<int64_t, int64_t>>& pads,
                       double value) {
  std::vector<int64_t> flat;
  bool any = false;
  for (auto it = pads.rbegin(); it != pads.rend(); ++it) {
    flat.push_back(it->first);
    flat.push_back(it->second);
    any = any || it->first || it->second;
  }
  return any ? at::constant_pad_nd(x, flat, value) : x;
}

at::Tensor window_sum(const at::Tensor& x, std::vector<int64_t> kernel,
                      std::vector<int64_t> stride) {
  size_t nd = kernel.size();
  if (nd == 1) {
    kernel.push_back(1);
    stride.push_back(1);
    return window_sum(x.unsqueeze(-1), kernel, stride).squeeze(-1);
  }
  if (nd == 2)
    return at::avg_pool2d(x, kernel, stride, {0, 0}, false, true, 1);
  return at::avg_pool3d(x, kernel, stride, {0, 0, 0}, false, true, 1);
}

at::Tensor to_nchw(const at::Tensor& x) { return x.permute({0, 3, 1, 2}); }
at::Tensor to_nhwc(const at::Tensor& x) { return x.permute({0, 2, 3, 1}); }

bool layout_nhwc(const Attrs& a, size_t nd) {
  std::string layout = a.str("layout", "None");
  if (layout == "None" || layout.empty() || layout == "NCW" ||
      layout == "NCHW" || layout == "NCDHW")
    return false;
  if (layout == "NHWC") {
    if (nd != 2) throw RtError(a.op + ": layout=NHWC is 2-d only");
    return true;
  }
  throw RtError(a.op + ": unsupported layout " + layout);
}

// ---- the table ------------------------------------------------------------------------
std::unordered_map<std::string, Fn>& table() {
  static std::unordered_map<std::string, Fn> t;
  return t;
}

void reg(std::initializer_list<const char*> names, Fn fn) {
  for (const char* n : names) table()[n] = fn;
}

using Bin = std::function<at::Tensor(const at::Tensor&, const at::Tensor&)>;
using Un = std::function<at::Tensor(const at::Tensor&)>;
using Sc = std::function<at::Tensor(const at::Tensor&, double)>;

void reg_bin(std::initializer_list<const char*> names, Bin f) {
  reg(names, [f](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
    need(a, in, 2);
    return one(f(in[0], in[1]));
  });
}

void reg_un(std::initializer_list<const char*> names, Un f) {
  reg(names, [f](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
    need(a, in, 1);
    return one(f(in[0]));
  });
}

// the scalar in x's dtype, as elemwise.py's _scalar (an integer input
// truncates it)
double scalar_of(const Attrs& a, const at::Tensor& x) {
  double s = a.f("scalar", std::nan(""));
  if (std::isnan(s) && !a.has("scalar"))
    throw RtError("op " + a.op + ": required attr 'scalar' missing");
  return x.is_floating_point() ? s : static_cast<double>(static_cast<int64_t>(s));
}

void reg_sc(std::initializer_list<const char*> names, Sc f) {
  reg(names, [f](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
    need(a, in, 1);
    return one(f(in[0], scalar_of(a, in[0])));
  });
}

bool build_table() {
  // ---- binary and broadcast (ops/elemwise.py)
  reg_bin({"elemwise_add", "_plus", "_Plus", "broadcast_add", "broadcast_plus"},
          [](const at::Tensor& x, const at::Tensor& y) { return x + y; });
  reg_bin({"elemwise_sub", "_minus", "_Minus", "_sub", "broadcast_sub",
           "broadcast_minus"},
          [](const at::Tensor& x, const at::Tensor& y) { return x - y; });
  reg_bin({"elemwise_mul", "_mul", "_Mul", "broadcast_mul"},
          [](const at::Tensor& x, const at::Tensor& y) { return x * y; });
  reg_bin({"elemwise_div", "_div", "_Div", "broadcast_div"},
          [](const at::Tensor& x, const at::Tensor& y) { return x / y; });
  // ---- scalar: the forms the graph passes fold scalar chains into
  reg_sc({"_plus_scalar", "_PlusScalar"},
         [](const at::Tensor& x, double s) { return x + s; });
  reg_sc({"_minus_scalar", "_MinusScalar"},
         [](const at::Tensor& x, double s) { return x - s; });
  reg_sc({"_mul_scalar", "_MulScalar"},
         [](const at::Tensor& x, double s) { return x * s; });
  reg_sc({"_div_scalar", "_DivScalar"},
         [](const at::Tensor& x, double s) { return x / s; });
  // ---- unary
  reg_un({"square"}, [](const at::Tensor& x) { return at::square(x); });
  reg_un({"sqrt"}, [](const at::Tensor& x) { return at::sqrt(x); });
  reg_un({"_copy", "identity"}, [](const at::Tensor& x) { return x.clone(); });
  reg_un({"Flatten", "flatten"},
         [](const at::Tensor& x) { return x.reshape({x.size(0), -1}); });
  // ---- reductions (ops/reduce.py)
  reg({"mean"}, [](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
    need(a, in, 1);
    return one(at::mean(in[0], reduce_axes(a, in[0].dim()),
                        a.b("keepdims", false)));
  });

  // ---- shapes (ops/matrix.py)
  reg({"Reshape", "reshape"},
      [](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
        need(a, in, 1);
        const at::Tensor& x = in[0];
        auto target = a.shape("shape");
        if (!target || target->empty()) {
          auto ts = a.shape("target_shape");
          if (ts && !ts->empty()) return one(x.reshape(*ts));
          throw RtError("Reshape: shape required");
        }
        return one(x.reshape(mx_reshape(x.sizes().vec(), *target,
                                        a.b("reverse", false))));
      });

  // ---- layers (ops/nn.py)
  reg({"FullyConnected"}, [](const Node&, const Attrs& a, const Vec& in,
                             const OpCtx&) {
    bool no_bias = a.b("no_bias", false);
    need(a, in, no_bias ? 2 : 3);
    const at::Tensor& data = in[0];
    at::Tensor x = a.b("flatten", true) ? data.reshape({data.size(0), -1}) : data;
    at::Tensor out = at::matmul(x, in[1].t());
    if (!no_bias) out = out + in[2];
    return one(out);
  });
  reg({"Activation"}, [](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
    need(a, in, 1);
    std::string t = a.str("act_type", "");
    const at::Tensor& x = in[0];
    if (t == "relu") return one(at::relu(x));
    if (t == "sigmoid") return one(at::sigmoid(x));
    if (t == "tanh") return one(at::tanh(x));
    if (t == "softrelu") return one(at::softplus(x));
    if (t == "softsign") return one(x / (x.abs() + 1));
    throw RtError("Activation: unknown act_type " + t);
  });
  reg({"Convolution", "Convolution_v1"}, [](const Node&, const Attrs& a,
                                            const Vec& in, const OpCtx&) {
    bool no_bias = a.b("no_bias", false);
    need(a, in, no_bias ? 2 : 3);
    auto kernel = a.shape("kernel");
    if (!kernel || kernel->empty()) throw RtError("Convolution: kernel required");
    size_t nd = kernel->size();
    auto stride = shape_or(a, "stride", std::vector<int64_t>(nd, 1));
    auto dilate = shape_or(a, "dilate", std::vector<int64_t>(nd, 1));
    auto pad = shape_or(a, "pad", std::vector<int64_t>(nd, 0));
    int64_t groups = a.i("num_group", 1);
    bool nhwc = layout_nhwc(a, nd);
    at::Tensor data = nhwc ? to_nchw(in[0]) : in[0];
    at::Tensor weight = nhwc ? to_nchw(in[1]) : in[1];
    at::Tensor out;
    if (nd == 1) out = at::conv1d(data, weight, {}, stride, pad, dilate, groups);
    else if (nd == 2) out = at::conv2d(data, weight, {}, stride, pad, dilate, groups);
    else if (nd == 3) out = at::conv3d(data, weight, {}, stride, pad, dilate, groups);
    else throw RtError("Convolution: kernel of rank " + std::to_string(nd));
    if (!no_bias) {
      std::vector<int64_t> bshape = {1, -1};
      for (size_t i = 0; i < nd; ++i) bshape.push_back(1);
      out = out + in[2].reshape(bshape);
    }
    return one(nhwc ? to_nhwc(out) : out);
  });
  reg({"Pooling", "Pooling_v1"}, [](const Node&, const Attrs& a, const Vec& in,
                                    const OpCtx&) {
    need(a, in, 1);
    at::Tensor x = in[0];
    size_t nd = x.dim() - 2;
    bool nhwc = layout_nhwc(a, nd);
    if (nhwc) x = to_nchw(x);
    std::vector<int64_t> spatial(x.sizes().begin() + 2, x.sizes().end());
    std::vector<int64_t> kernel, stride;
    std::vector<std::pair<int64_t, int64_t>> pads;
    if (a.b("global_pool", false)) {
      kernel = spatial;
      stride.assign(nd, 1);
      pads.assign(nd, {0, 0});
    } else {
      kernel = shape_or(a, "kernel", {});
      if (kernel.size() != nd) throw RtError("Pooling: kernel required");
      stride = shape_or(a, "stride", std::vector<int64_t>(nd, 1));
      auto pad = shape_or(a, "pad", std::vector<int64_t>(nd, 0));
      bool full = a.str("pooling_convention", "valid") == "full";
      for (size_t i = 0; i < nd; ++i) {
        int64_t extra = 0;
        if (full) {
          int64_t h = spatial[i];
          int64_t num = h + 2 * pad[i] - kernel[i];
          // python's -(-num // s): ceil division with floor semantics
          int64_t q = num >= 0 ? (num + stride[i] - 1) / stride[i]
                               : -((-num) / stride[i]);
          int64_t out_full = q + 1;
          extra = std::max<int64_t>(
              0, (out_full - 1) * stride[i] + kernel[i] - h - 2 * pad[i]);
        }
        pads.push_back({pad[i], pad[i] + extra});
      }
    }
    std::string pt = a.str("pool_type", "max");
    at::Tensor out;
    if (pt == "max") {
      double low = x.is_floating_point()
                       ? -std::numeric_limits<double>::infinity()
                       : static_cast<double>(std::numeric_limits<int64_t>::min());
      at::Tensor xp = pad_spatial(x, pads, low);
      if (nd == 1) out = at::max_pool1d(xp, kernel, stride);
      else if (nd == 2) out = at::max_pool2d(xp, kernel, stride);
      else out = at::max_pool3d(xp, kernel, stride);
    } else if (pt == "avg" || pt == "sum") {
      out = window_sum(pad_spatial(x, pads, 0), kernel, stride);
      if (pt == "avg") {
        std::vector<int64_t> oshape = {1, 1};
        oshape.insert(oshape.end(), spatial.begin(), spatial.end());
        at::Tensor ones = at::ones(oshape, x.options());
        out = out / window_sum(pad_spatial(ones, pads, 0), kernel, stride);
      }
    } else {
      throw RtError("Pooling: unknown pool_type " + pt);
    }
    return one(nhwc ? to_nhwc(out) : out);
  });
  reg({"BatchNorm", "BatchNorm_v1"}, [](const Node&, const Attrs& a,
                                        const Vec& in, const OpCtx& ctx) {
    need(a, in, 5);
    const at::Tensor& x = in[0];
    at::Tensor gamma = in[1], beta = in[2];
    const at::Tensor& mmean = in[3];
    const at::Tensor& mvar = in[4];
    int64_t ax = ((a.i("axis", 1) % x.dim()) + x.dim()) % x.dim();
    std::vector<int64_t> red, bshape;
    for (int64_t i = 0; i < x.dim(); ++i) {
      if (i != ax) red.push_back(i);
      bshape.push_back(i == ax ? x.size(ax) : 1);
    }
    if (a.b("fix_gamma", true)) gamma = at::ones_like(beta);
    at::Tensor mean, var, new_mean, new_var;
    if (ctx.is_train && !a.b("use_global_stats", false)) {
      mean = at::mean(x, red, false, at::kFloat);
      at::Tensor ex2 = at::mean(at::square(x.to(at::kFloat)), red);
      var = at::clamp_min(ex2 - at::square(mean), 0.0);
      double m = a.f("momentum", 0.9);
      new_mean = mmean * m + mean.detach() * (1 - m);
      new_var = mvar * m + var.detach() * (1 - m);
    } else {
      mean = mmean;
      var = mvar;
      new_mean = mmean;
      new_var = mvar;
    }
    auto dt = x.scalar_type();
    at::Tensor inv =
        at::rsqrt(var.reshape(bshape).to(at::kFloat) + a.f("eps", 1e-3)).to(dt);
    at::Tensor out = (x - mean.reshape(bshape).to(dt)) * inv *
                         gamma.reshape(bshape).to(dt) +
                     beta.reshape(bshape).to(dt);
    OpOut o;
    o.outputs = {out, mean.to(dt), var.to(dt)};
    o.new_aux = {{3, new_mean}, {4, new_var}};
    return o;
  });
  reg({"Dropout"}, [](const Node&, const Attrs& a, const Vec& in, const OpCtx& ctx) {
    need(a, in, 1);
    const at::Tensor& x = in[0];
    double p = a.f("p", 0.5);
    if (!(ctx.is_train || a.str("mode", "training") == "always") || p <= 0.0) {
      OpOut o;
      o.outputs = {x, at::ones_like(x)};
      return o;
    }
    if (!ctx.gen)
      throw RtError("Dropout draws its mask and was given no generator");
    double keep = 1.0 - p;
    // drawn on the tensor's device from the step's generator (seed + t):
    // the card's masks are not the CPU's, nor the JAX bits (ROADMAP.md C34)
    at::Tensor u = at::rand(x.sizes(), *ctx.gen,
                            at::TensorOptions().dtype(at::kFloat).device(x.device()));
    at::Tensor mask = (u < keep).to(x.scalar_type()) / keep;
    OpOut o;
    o.outputs = {x * mask, mask};
    return o;
  });
  reg({"Embedding"}, [](const Node&, const Attrs& a, const Vec& in, const OpCtx&) {
    need(a, in, 2);
    const at::Tensor& weight = in[1];
    int64_t n = weight.size(0);
    at::Tensor idx = in[0].detach().to(at::kLong);
    idx = at::where(idx < 0, idx + n, idx);
    at::Tensor valid = (idx >= 0) & (idx < n);
    at::Tensor out = at::embedding(weight, idx.clamp(0, n - 1));
    return one(at::where(valid.unsqueeze(-1), out,
                         std::numeric_limits<double>::quiet_NaN()));
  });
  reg({"SoftmaxOutput", "Softmax"}, [](const Node&, const Attrs& a,
                                       const Vec& in, const OpCtx&) {
    need(a, in, 2);
    return one(softmax_output(a, in[0], in[1], c10::IValue()));
  });
  // ---- attention (attention.cc)
  reg({"_contrib_MultiHeadAttention"}, [](const Node&, const Attrs& a,
                                          const Vec& in, const OpCtx&) {
    need(a, in, 3);
    return one(multi_head_attention(in[0], in[1], in[2], a.required_i("num_heads"),
                                    a.b("causal", true)));
  });
  reg({"_contrib_FlashAttention"}, [](const Node&, const Attrs& a, const Vec& in,
                                      const OpCtx&) {
    need(a, in, 3);
    double scale = a.f("sm_scale", -1.0);
    if (scale <= 0) scale = 1.0 / std::sqrt(static_cast<double>(in[0].size(-1)));
    return one(flash_attention(in[0], in[1], in[2], a.b("causal", false), scale));
  });
  return true;
}

const bool g_table_built = build_table();

}  // namespace

OpOut run_op(const Node& n, const std::vector<at::Tensor>& in,
             const OpCtx& ctx) {
  (void)g_table_built;
  auto it = table().find(n.op);
  if (it == table().end())
    throw RtError("op '" + n.op + "' (node '" + n.name +
                  "') is not in the native runtime's op table");
  Attrs a;
  a.m = &n.attrs;
  a.op = n.op;
  return it->second(n, a, in, ctx);
}

std::vector<size_t> index_arg_positions(const std::string& op) {
  if (op == "Embedding" || op == "one_hot") return {0};
  if (op == "take" || op == "batch_take" || op == "gather_nd" ||
      op == "scatter_nd" || op == "pick" || op == "choose_element_0index" ||
      op == "fill_element_0index")
    return {1};
  return {};
}

bool op_is_stochastic(const Node& n) { return n.op == "Dropout"; }

at::Tensor softmax_output(const Attrs& a, const at::Tensor& data,
                          const at::Tensor& label, const c10::IValue& denom) {
  SoftmaxAttrs s;
  s.grad_scale = a.f("grad_scale", 1.0);
  s.ignore_label = a.f("ignore_label", -1.0);
  s.smooth = a.f("smooth_alpha", 0.0);
  s.multi = a.b("multi_output", false);
  s.use_ignore = a.b("use_ignore", false);
  s.preserve = a.b("preserve_shape", false);
  s.out_grad = a.b("out_grad", false);
  s.norm = a.str("normalization", "null");
  s.denom = denom;
  at::Tensor lab = label.defined() ? label : at::zeros({0}, data.options());
  return SoftmaxOutputFn::apply(data, lab, s);
}

}  // namespace mxt_rt
