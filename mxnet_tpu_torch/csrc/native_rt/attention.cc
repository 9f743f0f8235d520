// Attention: _contrib_MultiHeadAttention and _contrib_FlashAttention as
// ops/attention.py computes them. A CUDA tensor goes through the port's
// hand-written kernels (csrc/flash_fwd.cu, flash_bwd_dkv.cu, flash_bwd_dq.cu;
// flash_wide.cu past head_dim 256) through the extern "C" entry points
// their libraries export, linked with an rpath when the runtime is built
// against a CUDA torch (MXT_NATIVE_KERNELS). A CPU tensor takes the plain
// ATen version, the twin of _flash_forward_plain/_flash_backward_plain.
// Nothing falls back: a CUDA tensor reaches its kernel or the call fails.
// The backward is a C++ autograd Function that saves (q, k, v, out, lse)
// and runs K2a and K2b, as the Python _FlashAttention does.
#include <torch/csrc/autograd/custom_function.h>

#include <atomic>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <mutex>

#include "runtime.h"

#ifdef MXT_NATIVE_KERNELS
extern "C" {
int mxt_flash_fwd(const void*, const void*, const void*, void*, void*, int, int,
                  int, int, int, float, int, int, void*);
const char* mxt_flash_fwd_error_string(int);
int mxt_flash_bwd_dkv(const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, int, int, int,
                      int, int, float, int, int, void*);
const char* mxt_flash_bwd_dkv_error_string(int);
int mxt_flash_bwd_dq(const void*, const void*, const void*, const void*,
                     const void*, const void*, void*, int, int, int, int, int,
                     float, int, int, void*);
const char* mxt_flash_bwd_dq_error_string(int);
int mxt_flash_wide_fwd(const void*, const void*, const void*, void*, void*, int,
                       int, int, int, int, float, int, int, void*);
const char* mxt_flash_wide_fwd_error_string(int);
int mxt_flash_wide_bwd_dkv(const void*, const void*, const void*, const void*,
                           const void*, const void*, void*, void*, int, int,
                           int, int, int, float, int, int, void*);
const char* mxt_flash_wide_bwd_dkv_error_string(int);
int mxt_flash_wide_bwd_dq(const void*, const void*, const void*, const void*,
                          const void*, const void*, void*, int, int, int, int,
                          int, float, int, int, void*);
const char* mxt_flash_wide_bwd_dq_error_string(int);
}
#endif

namespace mxt_rt {

namespace {

constexpr double kNegInf = -1e30;
constexpr int64_t kFlashMaxD = 256;          // ops/attention.py FLASH_MAX_D
constexpr int64_t kFlashMaxS = 16 * 65535;   // FLASH_MAX_S

// ---- launch counters: one per kernel, bumped where it launches ------------
const char* const kKernels[] = {"flash_fwd",      "flash_bwd_dkv",
                                "flash_bwd_dq",   "flash_wide_fwd",
                                "flash_wide_bwd_dkv", "flash_wide_bwd_dq"};
constexpr int kNumKernels = 6;
std::atomic<long long> g_launches[kNumKernels];

int kernel_index(const char* name) {
  for (int i = 0; i < kNumKernels; ++i)
    if (strcmp(kKernels[i], name) == 0) return i;
  return -1;
}

int dtype_code(at::ScalarType t) {
  if (t == at::kFloat) return 0;
  if (t == at::kBFloat16) return 1;
  if (t == at::kHalf) return 2;
  return -1;
}

// ---- plain versions (CPU tensors) ---------------------------------------------
std::pair<at::Tensor, at::Tensor> forward_plain(const at::Tensor& q,
                                                const at::Tensor& k,
                                                const at::Tensor& v,
                                                bool causal, double sm_scale) {
  int64_t sq = q.size(2), sk = k.size(2);
  int64_t block_k = std::min<int64_t>(256, sk);
  at::Tensor qf = q.to(at::kFloat), kf = k.to(at::kFloat), vf = v.to(at::kFloat);
  auto f32 = q.options().dtype(at::kFloat);
  at::Tensor m = at::full({q.size(0), q.size(1), q.size(2)}, kNegInf, f32);
  at::Tensor l = at::zeros_like(m);
  at::Tensor acc = at::zeros(q.sizes(), f32);
  at::Tensor qi = at::arange(sq, q.options().dtype(at::kLong));
  for (int64_t start = 0; start < sk; start += block_k) {
    at::Tensor kb = kf.slice(2, start, start + block_k);
    at::Tensor vb = vf.slice(2, start, start + block_k);
    at::Tensor s = at::einsum("bhqd,bhkd->bhqk", {qf, kb}) * sm_scale;
    if (causal) {
      at::Tensor ki = at::arange(kb.size(2), qi.options()) + start;
      s = at::where(qi.unsqueeze(1) >= ki.unsqueeze(0), s, kNegInf);
    }
    at::Tensor m_new = at::maximum(m, s.amax(-1));
    at::Tensor p = at::exp(s - m_new.unsqueeze(-1));
    at::Tensor corr = at::exp(m - m_new);
    l = l * corr + p.sum(-1);
    acc = acc * corr.unsqueeze(-1) + at::einsum("bhqk,bhkd->bhqd", {p, vb});
    m = m_new;
  }
  l = at::clamp_min(l, 1e-30);
  return {acc / l.unsqueeze(-1), m + at::log(l)};
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> backward_plain(
    const at::Tensor& q, const at::Tensor& k, const at::Tensor& v,
    const at::Tensor& out, const at::Tensor& lse, const at::Tensor& g,
    bool causal, double sm_scale) {
  int64_t sq = q.size(2), sk = k.size(2);
  int64_t block_k = std::min<int64_t>(256, sk);
  at::Tensor qf = q.to(at::kFloat), kf = k.to(at::kFloat), vf = v.to(at::kFloat);
  at::Tensor gf = g.to(at::kFloat);
  at::Tensor delta = (out.to(at::kFloat) * gf).sum(-1);
  at::Tensor qi = at::arange(sq, q.options().dtype(at::kLong));
  at::Tensor dq = at::zeros(qf.sizes(), qf.options());
  std::vector<at::Tensor> dks, dvs;
  for (int64_t start = 0; start < sk; start += block_k) {
    at::Tensor kb = kf.slice(2, start, start + block_k);
    at::Tensor vb = vf.slice(2, start, start + block_k);
    at::Tensor s = at::einsum("bhqd,bhkd->bhqk", {qf, kb}) * sm_scale;
    if (causal) {
      at::Tensor ki = at::arange(kb.size(2), qi.options()) + start;
      s = at::where(qi.unsqueeze(1) >= ki.unsqueeze(0), s, kNegInf);
    }
    at::Tensor p = at::exp(s - lse.unsqueeze(-1));
    dvs.push_back(at::einsum("bhqk,bhqd->bhkd", {p, gf}));
    at::Tensor dp = at::einsum("bhqd,bhkd->bhqk", {gf, vb});
    at::Tensor ds = p * (dp - delta.unsqueeze(-1)) * sm_scale;
    dq = dq + at::einsum("bhqk,bhkd->bhqd", {ds, kb});
    dks.push_back(at::einsum("bhqk,bhqd->bhkd", {ds, qf}));
  }
  at::Tensor dk = at::cat(dks, 2), dv = at::cat(dvs, 2);
  return {dq.to(q.scalar_type()), dk.to(k.scalar_type()), dv.to(v.scalar_type())};
}

// ---- the kernels (CUDA tensors) -----------------------------------------------------
void check_flash(const at::Tensor& q, const at::Tensor& k, const at::Tensor& v) {
  if (q.dim() != 4 || k.dim() != 4 || v.dim() != 4)
    throw RtError("flash attention wants (B, H, S, D) q/k/v");
  if (k.size(0) != q.size(0) || k.size(1) != q.size(1) ||
      k.size(3) != q.size(3) || !v.sizes().equals(k.sizes()))
    throw RtError("flash attention: k/v do not match q");
  if (dtype_code(q.scalar_type()) < 0 || k.scalar_type() != q.scalar_type() ||
      v.scalar_type() != q.scalar_type())
    throw RtError("flash kernel takes float32, bfloat16 or float16 q/k/v of "
                  "one dtype");
  int64_t d = q.size(3);
  if (d % 8 || d < 8)
    throw RtError("flash kernel takes a head_dim that is a multiple of 8, got " +
                  std::to_string(d));
  int64_t bh = q.size(0) * q.size(1);
  if (!(q.size(2) >= 1 && q.size(2) <= kFlashMaxS && k.size(2) >= 1 &&
        k.size(2) <= kFlashMaxS && bh >= 1 && bh < (int64_t{1} << 31)))
    throw RtError("flash kernel: empty or oversized problem");
  if (q.device() != k.device() || q.device() != v.device())
    throw RtError("flash attention: q/k/v on different devices");
  if (!q.is_contiguous() || !k.is_contiguous() || !v.is_contiguous())
    throw RtError("flash kernel takes contiguous q/k/v");
}

at::Tensor aligned16(const at::Tensor& x) {
  return reinterpret_cast<uintptr_t>(x.data_ptr()) % 16 == 0 ? x : x.clone();
}

#ifdef MXT_NATIVE_KERNELS
// A launch's code: 0, or the kernel library's error; the test hook
// MXTPU_NATIVE_FAIL_KERNEL=<kernel> makes that kernel's launch be refused
// by the kernel itself (it is handed a K pointer off its 16-byte alignment)
bool forced_failure(const char* kernel) {
  const char* f = getenv("MXTPU_NATIVE_FAIL_KERNEL");
  return f && strcmp(f, kernel) == 0;
}

void launched(const char* kernel, int code, const char* (*err)(int)) {
  if (code != 0)
    throw RtError(std::string("CUDA kernel ") + kernel +
                  " failed to launch: " + err(code) + " (error " +
                  std::to_string(code) + ")");
  count_launch(kernel);
}
#endif

std::pair<at::Tensor, at::Tensor> forward_cuda(at::Tensor q, at::Tensor k,
                                               at::Tensor v, bool causal,
                                               double sm_scale) {
  check_flash(q, k, v);
#ifdef MXT_NATIVE_KERNELS
  q = aligned16(q);
  k = aligned16(k);
  v = aligned16(v);
  int b = q.size(0), h = q.size(1), sq = q.size(2), sk = k.size(2),
      d = q.size(3);
  auto f32 = q.options().dtype(at::kFloat);
  at::Tensor out = at::empty(q.sizes(), f32);
  at::Tensor lse = at::empty({b, h, sq}, f32);
  c10::DeviceGuard guard(q.device());
  bool wide = d > kFlashMaxD;
  const char* name = wide ? "flash_wide_fwd" : "flash_fwd";
  const char* kp = static_cast<const char*>(k.data_ptr()) +
                   (forced_failure(name) ? 4 : 0);
  int code = (wide ? mxt_flash_wide_fwd : mxt_flash_fwd)(
      q.data_ptr(), kp, v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, sq,
      sk, d, static_cast<float>(sm_scale), causal ? 1 : 0,
      dtype_code(q.scalar_type()), nullptr);
  launched(name, code,
           wide ? mxt_flash_wide_fwd_error_string : mxt_flash_fwd_error_string);
  return {out, lse};
#else
  (void)causal;
  (void)sm_scale;
  throw RtError("flash attention on " + q.device().str() +
                ": this runtime was built against a torch without CUDA, so "
                "the port's kernels are not linked");
#endif
}

std::tuple<at::Tensor, at::Tensor, at::Tensor> backward_cuda(
    at::Tensor q, at::Tensor k, at::Tensor v, const at::Tensor& out,
    const at::Tensor& lse, at::Tensor g, bool causal, double sm_scale) {
  check_flash(q, k, v);
  if (!g.sizes().equals(q.sizes()) || g.scalar_type() != q.scalar_type() ||
      !g.is_contiguous())
    throw RtError("flash backward takes a contiguous output gradient of q's "
                  "shape and dtype");
#ifdef MXT_NATIVE_KERNELS
  int b = q.size(0), h = q.size(1), sq = q.size(2), sk = k.size(2),
      d = q.size(3);
  at::Tensor delta = (out.to(at::kFloat) * g.to(at::kFloat)).sum(-1);
  q = aligned16(q);
  k = aligned16(k);
  v = aligned16(v);
  g = aligned16(g);
  auto f32 = q.options().dtype(at::kFloat);
  at::Tensor dq = at::empty(q.sizes(), f32);
  at::Tensor dk = at::empty(k.sizes(), f32);
  at::Tensor dv = at::empty(k.sizes(), f32);
  int code_t = dtype_code(q.scalar_type());
  c10::DeviceGuard guard(q.device());
  bool wide = d > kFlashMaxD;
  const char* dkv_name = wide ? "flash_wide_bwd_dkv" : "flash_bwd_dkv";
  const char* dq_name = wide ? "flash_wide_bwd_dq" : "flash_bwd_dq";
  const char* kp = static_cast<const char*>(k.data_ptr());
  int code = (wide ? mxt_flash_wide_bwd_dkv : mxt_flash_bwd_dkv)(
      q.data_ptr(), kp + (forced_failure(dkv_name) ? 4 : 0), v.data_ptr(),
      g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
      dv.data_ptr(), b, h, sq, sk, d, static_cast<float>(sm_scale),
      causal ? 1 : 0, code_t, nullptr);
  launched(dkv_name, code,
           wide ? mxt_flash_wide_bwd_dkv_error_string
                : mxt_flash_bwd_dkv_error_string);
  code = (wide ? mxt_flash_wide_bwd_dq : mxt_flash_bwd_dq)(
      q.data_ptr(), kp + (forced_failure(dq_name) ? 4 : 0), v.data_ptr(),
      g.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq,
      sk, d, static_cast<float>(sm_scale), causal ? 1 : 0, code_t, nullptr);
  launched(dq_name, code,
           wide ? mxt_flash_wide_bwd_dq_error_string
                : mxt_flash_bwd_dq_error_string);
  return {dq.to(q.scalar_type()), dk.to(k.scalar_type()), dv.to(v.scalar_type())};
#else
  (void)out;
  (void)lse;
  (void)causal;
  (void)sm_scale;
  throw RtError("flash attention backward on " + q.device().str() +
                ": the port's kernels are not linked into this runtime");
#endif
}

std::pair<at::Tensor, at::Tensor> flash_forward(const at::Tensor& q,
                                                const at::Tensor& k,
                                                const at::Tensor& v,
                                                bool causal, double sm_scale) {
  if (q.device().is_cuda()) return forward_cuda(q, k, v, causal, sm_scale);
  if (q.device().is_cpu()) return forward_plain(q, k, v, causal, sm_scale);
  throw RtError("flash attention: no implementation on " + q.device().str());
}

using torch::autograd::AutogradContext;
using torch::autograd::variable_list;

struct FlashAttentionFn : public torch::autograd::Function<FlashAttentionFn> {
  static at::Tensor forward(AutogradContext* ctx, at::Tensor q, at::Tensor k,
                            at::Tensor v, bool causal, double sm_scale) {
    auto res = flash_forward(q, k, v, causal, sm_scale);
    at::Tensor out = res.first.to(q.scalar_type());
    ctx->save_for_backward({q, k, v, out, res.second});
    ctx->saved_data["causal"] = causal;
    ctx->saved_data["sm_scale"] = sm_scale;
    return out;
  }
  static variable_list backward(AutogradContext* ctx, variable_list grads) {
    auto s = ctx->get_saved_variables();
    bool causal = ctx->saved_data["causal"].toBool();
    double scale = ctx->saved_data["sm_scale"].toDouble();
    at::Tensor g = grads[0].contiguous();
    std::tuple<at::Tensor, at::Tensor, at::Tensor> d;
    if (s[0].device().is_cuda())
      d = backward_cuda(s[0], s[1], s[2], s[3], s[4], g, causal, scale);
    else if (s[0].device().is_cpu())
      d = backward_plain(s[0], s[1], s[2], s[3], s[4], g, causal, scale);
    else
      throw RtError("flash attention: no implementation on " +
                    s[0].device().str());
    return {std::get<0>(d), std::get<1>(d), std::get<2>(d), at::Tensor(),
            at::Tensor()};
  }
};

}  // namespace

void count_launch(const char* kernel) {
  int i = kernel_index(kernel);
  if (i >= 0) g_launches[i] += 1;
}

at::Tensor flash_attention(const at::Tensor& q, const at::Tensor& k,
                           const at::Tensor& v, bool causal, double sm_scale) {
  return FlashAttentionFn::apply(q, k, v, causal, sm_scale);
}

at::Tensor multi_head_attention(const at::Tensor& x, const at::Tensor& w_in,
                                const at::Tensor& w_out, int64_t heads,
                                bool causal) {
  if (x.dim() != 3) throw RtError("MultiHeadAttention wants (batch, seq, model)");
  int64_t bsz = x.size(0), seq = x.size(1), model = x.size(2);
  int64_t hd = model / heads;
  at::Tensor qkv = at::matmul(x, w_in.t());
  auto parts = qkv.split(model, -1);
  auto split_heads = [&](const at::Tensor& t) {
    return t.reshape({bsz, seq, heads, hd}).transpose(1, 2).contiguous();
  };
  double scale = 1.0 / std::sqrt(static_cast<double>(hd));
  at::Tensor out = flash_attention(split_heads(parts[0]), split_heads(parts[1]),
                                   split_heads(parts[2]), causal, scale);
  out = out.transpose(1, 2).contiguous().reshape({bsz, seq, model});
  return at::matmul(out, w_out.t());
}

}  // namespace mxt_rt

// The launch count of one kernel of the runtime ("flash_fwd",
// "flash_bwd_dkv", "flash_bwd_dq", "flash_wide_fwd", "flash_wide_bwd_dkv",
// "flash_wide_bwd_dq"), read for tests; `reset` sets it to 0 after the
// read. -1 for an unknown name.
extern "C" __attribute__((visibility("default"))) long long
mxtpu_native_kernel_launches(const char* name, int reset) {
  int i = mxt_rt::kernel_index(name);
  if (i < 0) return -1;
  long long n = reset ? mxt_rt::g_launches[i].exchange(0)
                      : mxt_rt::g_launches[i].load();
  return n;
}
