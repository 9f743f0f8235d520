// Threaded dependency engine — host-side rebuild of the reference's async
// scheduler (reference: src/engine/threaded_engine.{h,cc} ThreadedVar /
// OprBlock wait counters, src/engine/threaded_engine_perdevice.cc worker
// pools; interface include/mxnet/engine.h:75-250).
//
// The device-side op stream is the accelerator's own queue, so this engine
// schedules HOST work: data-pipeline stages, checkpoint writes, kvstore
// server handlers, custom-python-op callbacks. Semantics match the
// reference's var model: an op runs once every const (read) var grants it
// shared access and every mutable (write) var grants it exclusive access;
// completion releases dependents in FIFO order per var.
//
// Not a translation: the reference threads a linked list of
// VersionedVarBlocks through object pools; here each Var owns a deque of
// pending grants behind a mutex (host-side throughput is bounded by Python
// callbacks, not by the scheduler), and priorities use a two-level queue
// (reference: FnProperty kCPUPrioritized, engine.h:59-70).

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace mxt {

typedef void (*OpFn)(void* arg);

struct Opr;

// One scheduling grant on a var: an op waiting to read or write it.
struct Pending {
  Opr* opr;
  bool write;
};

struct Var {
  std::mutex mu;
  std::deque<Pending> queue;  // ops not yet granted, FIFO
  int running_reads = 0;      // granted, incomplete reads
  bool writing = false;       // granted, incomplete write
};

struct Opr {
  OpFn fn;
  void* arg;
  std::vector<Var*> const_vars;
  std::vector<Var*> mutable_vars;
  int priority;
  std::atomic<int> wait;  // deps not yet granted + 1 (reference: OprBlock::wait)
};

class Engine {
 public:
  explicit Engine(int num_workers) : stop_(false), outstanding_(0) {
    if (num_workers < 1) num_workers = 1;
    for (int i = 0; i < num_workers; ++i)
      workers_.emplace_back([this] { WorkerLoop(); });
  }

  ~Engine() {
    {
      std::unique_lock<std::mutex> lk(qmu_);
      stop_ = true;
    }
    qcv_.notify_all();
    for (auto& t : workers_) t.join();
    // free any vars the owner leaked
  }

  Var* NewVar() { return new Var(); }

  // Push an op. Grants are requested in order; the op dispatches when wait
  // hits zero (reference: ThreadedEngine::Push threaded_engine.cc:258-281).
  void Push(OpFn fn, void* arg, Var** cvars, int nc, Var** mvars, int nm,
            int priority) {
    Opr* op = new Opr();
    op->fn = fn;
    op->arg = arg;
    // Deduplicate (reference: Engine::DeduplicateVarHandle, engine.h:231):
    // repeated vars, and any var in both lists, count once — as a write
    // (a read grant alongside a queued write on the same var would deadlock
    // the op against itself).
    op->mutable_vars.assign(mvars, mvars + nm);
    std::sort(op->mutable_vars.begin(), op->mutable_vars.end());
    op->mutable_vars.erase(
        std::unique(op->mutable_vars.begin(), op->mutable_vars.end()),
        op->mutable_vars.end());
    op->const_vars.assign(cvars, cvars + nc);
    std::sort(op->const_vars.begin(), op->const_vars.end());
    op->const_vars.erase(
        std::unique(op->const_vars.begin(), op->const_vars.end()),
        op->const_vars.end());
    op->const_vars.erase(
        std::remove_if(op->const_vars.begin(), op->const_vars.end(),
                       [&](Var* v) {
                         return std::binary_search(op->mutable_vars.begin(),
                                                   op->mutable_vars.end(), v);
                       }),
        op->const_vars.end());
    op->priority = priority;
    op->wait.store(
        static_cast<int>(op->const_vars.size() + op->mutable_vars.size()) + 1,
        std::memory_order_relaxed);
    outstanding_.fetch_add(1, std::memory_order_relaxed);
    for (Var* v : op->const_vars) AppendRead(v, op);
    for (Var* v : op->mutable_vars) AppendWrite(v, op);
    Satisfy(op);  // the +1 sentinel
  }

  // Block until every op that reads or writes `v` at push time has finished:
  // push a no-op writer and wait on it (reference: Engine::WaitForVar
  // engine.h:172 pushes a read op; a writer also drains earlier readers,
  // which matches WaitToWrite and is strictly stronger for WaitToRead).
  void WaitForVar(Var* v) {
    Waiter w;
    Var* mv[1] = {v};
    Push(&Engine::WaitFn, &w, nullptr, 0, mv, 1, 1);
    std::unique_lock<std::mutex> lk(w.mu);
    w.cv.wait(lk, [&] { return w.done; });
  }

  void WaitAll() {
    std::unique_lock<std::mutex> lk(done_mu_);
    done_cv_.wait(lk, [&] {
      return outstanding_.load(std::memory_order_acquire) == 0;
    });
  }

  // Delete var once all its pending ops drain: push a writer that frees it.
  void DeleteVar(Var* v) {
    Var* mv[1] = {v};
    Push(&Engine::DeleteVarFn, v, nullptr, 0, mv, 1, 0);
  }

  int64_t Outstanding() const {
    return outstanding_.load(std::memory_order_acquire);
  }

 private:
  struct Waiter {
    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
  };
  static void WaitFn(void* arg) {
    Waiter* w = static_cast<Waiter*>(arg);
    std::unique_lock<std::mutex> lk(w->mu);
    w->done = true;
    w->cv.notify_all();
  }
  static void DeleteVarFn(void*) {}

  void AppendRead(Var* v, Opr* op) {
    bool grant = false;
    {
      std::unique_lock<std::mutex> lk(v->mu);
      if (!v->writing && v->queue.empty()) {
        v->running_reads++;
        grant = true;
      } else {
        v->queue.push_back({op, false});
      }
    }
    if (grant) Satisfy(op);
  }

  void AppendWrite(Var* v, Opr* op) {
    bool grant = false;
    {
      std::unique_lock<std::mutex> lk(v->mu);
      if (!v->writing && v->running_reads == 0 && v->queue.empty()) {
        v->writing = true;
        grant = true;
      } else {
        v->queue.push_back({op, true});
      }
    }
    if (grant) Satisfy(op);
  }

  // A granted dependency; dispatch when the counter drains
  // (reference: OprBlock::decr_wait, threaded_engine.h:44-58).
  void Satisfy(Opr* op) {
    if (op->wait.fetch_sub(1, std::memory_order_acq_rel) == 1) Enqueue(op);
  }

  void Enqueue(Opr* op) {
    {
      std::unique_lock<std::mutex> lk(qmu_);
      if (op->priority > 0)
        prio_queue_.push_back(op);
      else
        queue_.push_back(op);
    }
    qcv_.notify_one();
  }

  // Completion walks each var's queue granting successors (reference:
  // ThreadedVar::CompleteReadDependency / CompleteWriteDependency,
  // threaded_engine.cc:83-168).
  void CompleteRead(Var* v) {
    Opr* granted = nullptr;
    {
      std::unique_lock<std::mutex> lk(v->mu);
      v->running_reads--;
      if (v->running_reads == 0 && !v->queue.empty() && v->queue.front().write) {
        granted = v->queue.front().opr;
        v->queue.pop_front();
        v->writing = true;
      }
    }
    if (granted) Satisfy(granted);
  }

  void CompleteWrite(Var* v) {
    std::vector<Opr*> granted;
    {
      std::unique_lock<std::mutex> lk(v->mu);
      v->writing = false;
      if (!v->queue.empty() && v->queue.front().write) {
        granted.push_back(v->queue.front().opr);
        v->queue.pop_front();
        v->writing = true;
      } else {
        while (!v->queue.empty() && !v->queue.front().write) {
          granted.push_back(v->queue.front().opr);
          v->queue.pop_front();
          v->running_reads++;
        }
      }
    }
    for (Opr* op : granted) Satisfy(op);
  }

  void WorkerLoop() {
    for (;;) {
      Opr* op = nullptr;
      {
        std::unique_lock<std::mutex> lk(qmu_);
        qcv_.wait(lk, [&] {
          return stop_ || !prio_queue_.empty() || !queue_.empty();
        });
        if (stop_ && prio_queue_.empty() && queue_.empty()) return;
        if (!prio_queue_.empty()) {
          op = prio_queue_.front();
          prio_queue_.pop_front();
        } else {
          op = queue_.front();
          queue_.pop_front();
        }
      }
      if (op->fn) op->fn(op->arg);
      bool delete_var = (op->fn == &Engine::DeleteVarFn);
      for (Var* v : op->const_vars) CompleteRead(v);
      for (Var* v : op->mutable_vars) {
        if (delete_var) {
          delete v;  // sole mutable var; nothing can follow a delete writer
        } else {
          CompleteWrite(v);
        }
      }
      delete op;
      if (outstanding_.fetch_sub(1, std::memory_order_acq_rel) == 1) {
        std::unique_lock<std::mutex> lk(done_mu_);
        done_cv_.notify_all();
      }
    }
  }

  std::vector<std::thread> workers_;
  std::mutex qmu_;
  std::condition_variable qcv_;
  std::deque<Opr*> queue_;
  std::deque<Opr*> prio_queue_;
  bool stop_;
  std::atomic<int64_t> outstanding_;
  std::mutex done_mu_;
  std::condition_variable done_cv_;
};

}  // namespace mxt

extern "C" {

void* mxt_engine_create(int num_workers) { return new mxt::Engine(num_workers); }
void mxt_engine_destroy(void* h) { delete static_cast<mxt::Engine*>(h); }
void* mxt_engine_new_var(void* h) {
  return static_cast<mxt::Engine*>(h)->NewVar();
}
void mxt_engine_delete_var(void* h, void* v) {
  static_cast<mxt::Engine*>(h)->DeleteVar(static_cast<mxt::Var*>(v));
}
void mxt_engine_push(void* h, mxt::OpFn fn, void* arg, void** cvars, int nc,
                     void** mvars, int nm, int priority) {
  static_cast<mxt::Engine*>(h)->Push(
      fn, arg, reinterpret_cast<mxt::Var**>(cvars), nc,
      reinterpret_cast<mxt::Var**>(mvars), nm, priority);
}
void mxt_engine_wait_for_var(void* h, void* v) {
  static_cast<mxt::Engine*>(h)->WaitForVar(static_cast<mxt::Var*>(v));
}
void mxt_engine_wait_all(void* h) { static_cast<mxt::Engine*>(h)->WaitAll(); }
long long mxt_engine_outstanding(void* h) {
  return static_cast<mxt::Engine*>(h)->Outstanding();
}

}  // extern "C"
