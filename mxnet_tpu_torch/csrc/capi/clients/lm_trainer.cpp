// A C++ trainer over the cpp-package header (mxnet_cpp.hpp) with no Python
// of its own: binds a training symbol read from JSON on a context, loads
// its initial parameters, and runs steps of forward, backward and the
// executor's SGD update (MXExecutorSGDUpdate) on one fixed batch.
//
//   lm_trainer SYMBOL.json INIT.params DATA.f32 LABEL.f32 B T STEPS LR DEV
//              GRADS.params
//
// DATA.f32 and LABEL.f32 hold B*T float32 token ids. DEV is the context's
// type ("gpu", "tpu" or "cpu"). The client writes step 1's gradients of
// every parameter to GRADS.params (the .params format, through the C
// NDArray API), prints "LOSS <step> <mean cross-entropy>" for the first
// and the last step (which read the output back) and "STEP_MS <mean>"
// over the steps between them, up to a read of the data argument after
// them (which waits for the card).
//
// The same source built as a shared library exposes lmt_create, lmt_step,
// lmt_save_grads, lmt_sync and lmt_free, so a host process can drive the steps one
// by one (and count the kernels each one launches).
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <vector>

#include "c_array.h"
#include "mxnet_cpp.hpp"

namespace mx = mxnet::cpp;

namespace {

struct Trainer {
  mx::Symbol net;
  std::unique_ptr<mx::Executor> exec;
  std::vector<float> data, label;
};

std::unique_ptr<Trainer> g_trainer;

std::string slurp(const char* path) {
  std::ifstream f(path, std::ios::binary);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

std::vector<float> read_floats(const char* path) {
  std::string s = slurp(path);
  std::vector<float> v(s.size() / 4);
  std::copy(s.data(), s.data() + v.size() * 4,
            reinterpret_cast<char*>(v.data()));
  return v;
}

// mean -log p(label) over the B*T rows of the SoftmaxOutput probabilities
double cross_entropy(const std::vector<float>& prob,
                     const std::vector<float>& label) {
  size_t rows = label.size(), classes = prob.size() / rows;
  double sum = 0;
  for (size_t r = 0; r < rows; ++r) {
    float p = prob[r * classes + static_cast<size_t>(label[r])];
    sum -= std::log(std::max(p, 1e-30f));
  }
  return sum / rows;
}

}  // namespace

extern "C" {

// Bind and load. Returns 0, or -1 with the message on stderr.
int lmt_create(const char* symbol_path, const char* params_path,
               const char* data_path, const char* label_path, int batch,
               int seq, const char* dev_type) {
  try {
    auto t = std::make_unique<Trainer>();
    t->net = mx::Symbol::FromJSON(slurp(symbol_path));
    mx_uint b = static_cast<mx_uint>(batch), s = static_cast<mx_uint>(seq);
    t->exec = std::make_unique<mx::Executor>(t->net.SimpleBind(
        mx::Context(dev_type, 0), {{"data", {b, s}}, {"softmax_label", {b, s}}}));
    t->exec->LoadParams(params_path);
    t->data = read_floats(data_path);
    t->label = read_floats(label_path);
    if (t->data.size() != t->label.size() ||
        t->data.size() != static_cast<size_t>(batch) * seq)
      throw std::runtime_error("data/label files do not hold B*T floats");
    g_trainer = std::move(t);
    return 0;
  } catch (const std::exception& e) {
    g_trainer.reset();
    std::fprintf(stderr, "lmt_create: %s\n", e.what());
    return -1;
  }
}

// One step: set the batch, forward, backward, SGD update at lr. With
// want_loss the step's output is read back and its cross-entropy written
// to *loss. Returns 0, or -1 with the message on stderr.
int lmt_step(float lr, int want_loss, double* loss) {
  Trainer* t = g_trainer.get();
  if (!t) return -1;
  try {
    t->exec->SetArg("data", t->data);
    t->exec->SetArg("softmax_label", t->label);
    t->exec->Forward(true);
    if (want_loss) *loss = cross_entropy(t->exec->GetOutput(0), t->label);
    t->exec->Backward();
    t->exec->SGDUpdate(lr);
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "lmt_step: %s\n", e.what());
    return -1;
  }
}

// The gradients of every argument but data and label, flat, as a .params
// file (keys "grad:<name>") written by the C NDArray API.
int lmt_save_grads(const char* path) {
  Trainer* t = g_trainer.get();
  if (!t) return -1;
  try {
    std::vector<NDArrayHandle> arrays;
    std::vector<std::string> keys;
    for (const auto& name : t->net.ListArguments()) {
      if (name == "data" || name == "softmax_label") continue;
      std::vector<float> g = t->exec->GetGrad(name);
      mx_uint size = static_cast<mx_uint>(g.size());
      NDArrayHandle h = nullptr;
      mx::Check(MXNDArrayCreateEx(&size, 1, 1, 0, 0, 0, &h),
                "MXNDArrayCreateEx");
      mx::Check(MXNDArraySyncCopyFromCPU(h, g.data(), g.size()),
                "MXNDArraySyncCopyFromCPU");
      arrays.push_back(h);
      keys.push_back("grad:" + name);
    }
    std::vector<const char*> key_ptrs;
    for (const auto& k : keys) key_ptrs.push_back(k.c_str());
    int rc = MXNDArraySave(path, static_cast<mx_uint>(arrays.size()),
                           arrays.data(), key_ptrs.data());
    for (auto h : arrays) MXNDArrayFree(h);
    mx::Check(rc, "MXNDArraySave");
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "lmt_save_grads: %s\n", e.what());
    return -1;
  }
}

// Read the (small) data argument back: a copy to the host that waits for
// every step queued on the card.
int lmt_sync() {
  Trainer* t = g_trainer.get();
  if (!t) return -1;
  try {
    t->exec->GetArg("data");
    return 0;
  } catch (const std::exception& e) {
    std::fprintf(stderr, "lmt_sync: %s\n", e.what());
    return -1;
  }
}

void lmt_free() { g_trainer.reset(); }

}  // extern "C"

int main(int argc, char** argv) {
  if (argc < 11) {
    std::fprintf(stderr,
                 "usage: %s SYMBOL PARAMS DATA LABEL B T STEPS LR DEV GRADS\n",
                 argv[0]);
    return 2;
  }
  int batch = std::atoi(argv[5]), seq = std::atoi(argv[6]);
  int steps = std::atoi(argv[7]);
  float lr = static_cast<float>(std::atof(argv[8]));
  if (lmt_create(argv[1], argv[2], argv[3], argv[4], batch, seq, argv[9]))
    return 1;
  if (steps < 3) return 2;
  auto t0 = std::chrono::steady_clock::now(), t1 = t0;
  for (int s = 1; s <= steps; ++s) {
    if (s == 2) t0 = std::chrono::steady_clock::now();
    if (s == steps) {
      if (lmt_sync()) return 1;
      t1 = std::chrono::steady_clock::now();
    }
    double loss = 0;
    bool report = s == 1 || s == steps;
    if (lmt_step(lr, report, &loss)) return 1;
    if (report) std::printf("LOSS %d %.9g\n", s, loss);
    if (s == 1 && lmt_save_grads(argv[10])) return 1;
  }
  double ms = std::chrono::duration<double, std::milli>(t1 - t0).count();
  std::printf("STEP_MS %.6f\n", ms / (steps - 2));
  lmt_free();
  return 0;
}
