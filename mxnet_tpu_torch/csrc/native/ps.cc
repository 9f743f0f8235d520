// Native parameter-server transport — rebuild of the reference's distributed
// KVStore backbone (reference: ps-lite ZPush/ZPull consumed by
// src/kvstore/kvstore_dist.h:88-133; server aggregation logic
// src/kvstore/kvstore_dist_server.h:136-219 — sync mode merges pushes from
// all workers then applies the updater, async applies per push; barrier via
// ps::Postoffice, kvstore_dist.h:144-146).
//
// The port's copy of the JAX package's transport (mxnet_tpu/src/ps.cc), with
// the same wire, byte for byte. The server runs on the host (its weights are
// CPU tensors); the workers hand it gradients at the boundary of the fused
// step's CUDA graphs.
//
// Transport: plain TCP, one connection per worker, blocking RPCs framed as
//   [uint32 type][int32 key][uint64 nbytes][payload]
// float32 payloads (the reference also ships flattened fp32 buffers,
// kvstore_dist.h:95). Multi-server sharding is done caller-side: the Python
// KVStore assigns key -> server by hash, one RecClient per server.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <fcntl.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <memory>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace mxt {

enum MsgType : uint32_t {
  kPush = 1,
  kPull = 2,
  kResp = 3,
  kBarrier = 4,
  kCommand = 6,
  kStop = 7,
  kPushPull = 8,
  kInit = 9,         // direct weight overwrite: no merge, no optimizer —
                     // elastic reconfiguration re-seeds server state from the
                     // survivors' rollback snapshot through this
  kRejectEpoch = 10, // response: request carried a stale membership epoch
  kRefused = 11,     // response: the command handler declined the command
                     // (a registry command at a server not hosting it)
};

// Reserved-negative-key split (cluster observability plane): keys in
// (kPersistentKeyMax, 0) are single-shot diagnostic slots erased after one
// pull (stats/membership publishes); keys <= kPersistentKeyMax are
// persistent per-rank telemetry slots overwritten in place and pulled by
// any number of observers. Mirrored by kvstore.py TELEMETRY_KEY_BASE.
constexpr int kPersistentKeyMax = -(1 << 20);

#pragma pack(push, 1)
struct MsgHeader {
  uint32_t type;
  int32_t key;
  uint64_t req_id;  // echoed in the response: one connection carries many
                    // outstanding RPCs (ps-lite is an async message stream;
                    // blocking per-connection RPCs head-of-line-deadlock BSP
                    // rounds across keys)
  uint64_t nbytes;
  int64_t mepoch;   // membership epoch (elastic training): the client stamps
                    // its current epoch on every request; once the server is
                    // in elastic mode a mismatch is answered kRejectEpoch so
                    // no traffic from a departed membership view can land.
                    // 0 always matches a non-elastic server.
  // Trace identity (cluster observability plane): every request carries the
  // sending worker's rank and its training step at send time, so server-side
  // per-key push/pull handling can be attributed to the worker step that
  // caused it. rank -1 = unidentified (loopback publishers, probes, the
  // registry's broadcast clients) — never recorded. Trailing fields:
  // aggregate inits that stop at mepoch zero rank/step_id, and a zero rank
  // would masquerade as worker 0, so every raw header build must set rank
  // explicitly (Send() stamps it; mxt_ps_probe sets -1).
  int32_t rank;
  int64_t step_id;
};
#pragma pack(pop)

static bool ReadAll(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n) {
    ssize_t k = ::read(fd, p, n);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

static bool WriteAll(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n) {
    ssize_t k = ::write(fd, p, n);
    if (k <= 0) return false;
    p += k;
    n -= static_cast<size_t>(k);
  }
  return true;
}

// Server-side updater callback: (key, grad, weight, n) — mutates weight in
// place. Registered from the hosting process (Python server runs the real
// pickled optimizer through this hook, reference kvstore_server.py:36-44).
typedef void (*UpdaterFn)(int key, const float* grad, float* weight,
                          uint64_t n);
// Command callback: arbitrary control strings from workers (reference:
// KVStoreDistServer::CommandHandle, kvstore_dist_server.h:121-134 — carries
// the pickled optimizer and sync-mode switches). Returns 0 to acknowledge;
// anything else answers kRefused, so the sender's probe fails at once and
// it tries the next candidate instead of taking the ack as served.
typedef int (*CommandFn)(const char* cmd, uint64_t len);

class PSServer {
 public:
  PSServer(int port, int num_workers, bool sync)
      : num_workers_(num_workers), sync_(sync) {
    listen_fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    int one = 1;
    setsockopt(listen_fd_, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (bind(listen_fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) !=
            0 ||
        listen(listen_fd_, 128) != 0) {
      failed_ = true;
      return;
    }
    accept_thread_ = std::thread([this] { AcceptLoop(); });
  }

  ~PSServer() { Stop(); }

  void SetUpdater(UpdaterFn fn) { updater_ = fn; }
  void SetCommandHandler(CommandFn fn) { cmd_handler_ = fn; }

  void Stop() {
    bool expected = false;
    if (!stopping_.compare_exchange_strong(expected, true)) return;
    // wake every blocked conn thread (sync-push/pull/barrier waits check
    // stopping_ in their predicates but need the notify to re-evaluate)
    {
      std::unique_lock<std::mutex> lk(mu_);
      for (auto& kv : entries_) kv.second->cv.notify_all();
    }
    {
      std::unique_lock<std::mutex> lk(barrier_mu_);
      barrier_cv_.notify_all();
    }
    ::shutdown(listen_fd_, SHUT_RDWR);
    ::close(listen_fd_);
    if (accept_thread_.joinable()) accept_thread_.join();
    std::vector<std::thread> conns;
    {
      std::unique_lock<std::mutex> lk(mu_);
      conns.swap(conn_threads_);
    }
    for (auto& t : conns) t.join();
  }

  // Block until a worker sends kStop (reference: KVStoreDistServer::Run
  // blocks in Executor::Start, kvstore_dist_server.h:33).
  void WaitStopped() {
    std::unique_lock<std::mutex> lk(stop_mu_);
    stop_cv_.wait(lk, [&] { return stop_requested_; });
  }

  bool failed() const { return failed_; }

  // Per-rank trace attribution snapshot, serialized as flat doubles
  // (exact to 2^53 — a direct C call, not the float32 wire):
  //   [rank, last_step, last_mepoch, pushes, pulls, barriers, inits] x N
  // Returns the number of doubles written (<= cap; ranks past the cap are
  // dropped — pass 7 * max_expected_ranks).
  int TraceStats(double* out, int cap) {
    std::unique_lock<std::mutex> lk(tmu_);
    int n = 0;
    for (auto& kv : trace_) {
      if (n + 7 > cap) break;
      const RankTrace& t = kv.second;
      out[n++] = static_cast<double>(kv.first);
      out[n++] = static_cast<double>(t.last_step);
      out[n++] = static_cast<double>(t.last_mepoch);
      out[n++] = static_cast<double>(t.pushes);
      out[n++] = static_cast<double>(t.pulls);
      out[n++] = static_cast<double>(t.barriers);
      out[n++] = static_cast<double>(t.inits);
    }
    return n;
  }

 private:
  struct RankTrace {
    int64_t last_step = 0;
    int64_t last_mepoch = 0;
    uint64_t pushes = 0;
    uint64_t pulls = 0;
    uint64_t barriers = 0;
    uint64_t inits = 0;
  };

  struct Entry {
    std::mutex mu;
    std::condition_variable cv;
    std::vector<float> weight;
    std::vector<float> merged;
    int pending = 0;    // pushes merged so far this round
    int64_t version = 0;  // bumped when a sync round commits
    bool inited = false;
  };

  void AcceptLoop() {
    for (;;) {
      int fd = ::accept(listen_fd_, nullptr, nullptr);
      if (fd < 0) return;
      int one = 1;
      setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::unique_lock<std::mutex> lk(mu_);
      if (stopping_) {
        ::close(fd);
        return;
      }
      conn_threads_.emplace_back([this, fd] { ConnLoop(fd); });
    }
  }

  Entry* GetEntry(int key) {
    std::unique_lock<std::mutex> lk(mu_);
    auto& e = entries_[key];
    if (!e) e.reset(new Entry());
    return e.get();
  }

  // First push for a key initializes the weight (reference: kv.init goes
  // through the same DataHandle path, kvstore_dist_server.h:149-160).
  // Returns false when the push's membership epoch is stale, or when a
  // membership reconfiguration flushed the partial BSP round this push was
  // merged into: the contribution was discarded, and the caller answers
  // kRejectEpoch so the worker rolls back instead of believing its
  // gradient landed.
  bool HandlePush(int key, Entry* e, const float* data, uint64_t n,
                  int64_t mepoch) {
    std::unique_lock<std::mutex> lk(e->mu);
    // flush_gen_ is captured FIRST, before the epoch gate: a Reconfigure()
    // racing this push (it stores epoch_/flush_gen_ under mu_, not e->mu)
    // either bumps flush_gen_ before this read — then the wait below (or
    // the gate) rejects — or after it, in which case the wait's
    // flush_gen_ != fg comparison still rejects. Capturing it after the
    // merge would let a flushed-and-discarded push be confirmed once the
    // NEW membership's round commits.
    int64_t fg = flush_gen_;
    // re-check under the entry lock: the dispatch-time gate in Handle()
    // and this merge are not atomic — Reconfigure() stores epoch_ before
    // it flushes entries, so a stale push that slipped past the gate while
    // a reconfiguration ran must be rejected HERE, or an old-membership
    // gradient could join the fresh round
    if (elastic_ && key >= 0 && mepoch != epoch_) return false;
    if (!e->inited || key < 0) {
      // first push initializes; negative (diagnostic) keys ALWAYS take
      // this overwrite path — BSP merge semantics never apply to reserved
      // slots, so a reused or stale diagnostic key can neither join a
      // merge round nor block its publisher waiting for num_workers_
      // pushes (reserved-key sequences wrap, kvstore.py/mxtop.py)
      e->weight.assign(data, data + n);
      e->inited = true;
      e->version++;
      e->cv.notify_all();
      return true;
    }
    if (e->weight.size() != n) e->weight.resize(n, 0.f);
    if (!sync_) {  // async: apply immediately (dist_server.h:199-207)
      ApplyLocked(key, e, data, n);
      return true;
    }
    // sync: merge; the worker completing the round applies + commits
    if (e->merged.size() != n) e->merged.assign(n, 0.f);
    for (uint64_t i = 0; i < n; ++i) e->merged[i] += data[i];
    e->pending++;
    if (e->pending >= num_workers_) {
      ApplyLocked(key, e, e->merged.data(), n);
      e->merged.assign(n, 0.f);
      e->pending = 0;
      e->version++;
      e->cv.notify_all();
      return true;
    }
    int64_t v = e->version;
    e->cv.wait(lk, [&] {
      return e->version != v || flush_gen_ != fg || stopping_;
    });
    return flush_gen_ == fg;
  }

  // Elastic membership reconfiguration (command "mepoch:<epoch>:<workers>",
  // sent by the membership registry to every server): adopt the new epoch +
  // worker count, discard every partially merged BSP round, and wake blocked
  // pushers/barrier-waiters with a rejection — the survivors roll back to a
  // consistent step and re-push, so a half-merged round from the old
  // membership must never commit.
  void Reconfigure(int64_t epoch, int workers) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      epoch_ = epoch;
      if (workers > 0) num_workers_ = workers;
      flush_gen_++;
      for (auto& kv : entries_) {
        Entry* e = kv.second.get();
        std::unique_lock<std::mutex> elk(e->mu);
        e->merged.assign(e->merged.size(), 0.f);
        e->pending = 0;
        e->cv.notify_all();
      }
    }
    {
      std::unique_lock<std::mutex> lk(barrier_mu_);
      barrier_count_ = 0;
      barrier_flush_++;
      barrier_cv_.notify_all();
    }
  }

  void ApplyLocked(int key, Entry* e, const float* grad, uint64_t n) {
    if (updater_) {
      updater_(key, grad, e->weight.data(), n);
    } else {
      // no updater: store the merged value (dist_server.h else-branch —
      // update_on_kvstore=False workers pull merged grads back)
      memcpy(e->weight.data(), grad, n * sizeof(float));
    }
  }

  // One reader per connection; each request dispatches to its own handler
  // thread so a BSP-blocked push never blocks later requests on the same
  // connection (ps-lite's async stream semantics). Responses serialize on a
  // per-connection write mutex and carry the request id.
  struct Conn {
    int fd;
    std::mutex wmu;
    std::mutex hmu;
    std::condition_variable hcv;
    int inflight = 0;
  };

  void Respond(Conn* c, const MsgHeader& h, const void* payload) {
    std::unique_lock<std::mutex> lk(c->wmu);
    WriteAll(c->fd, &h, sizeof(h));
    if (h.nbytes && payload) WriteAll(c->fd, payload, h.nbytes);
  }

  // Trace identity: per-rank attribution of data-path handling. Recorded
  // BEFORE the epoch gate so a rejected request still updates the rank's
  // last-seen step — the whole point is knowing where a worker WAS when
  // its traffic stopped landing. Diagnostic traffic (negative keys) is not
  // counted: a stats poll must not read as training progress.
  void RecordTrace(const MsgHeader& h) {
    if (h.rank < 0) return;
    bool data_key = h.key >= 0;
    std::unique_lock<std::mutex> lk(tmu_);
    RankTrace& t = trace_[h.rank];
    t.last_step = h.step_id;
    t.last_mepoch = h.mepoch;
    switch (h.type) {
      case kPush:
        if (data_key) t.pushes++;
        break;
      case kPull:
        if (data_key) t.pulls++;
        break;
      case kPushPull:
        if (data_key) {
          t.pushes++;
          t.pulls++;
        }
        break;
      case kInit:
        if (data_key) t.inits++;
        break;
      case kBarrier:
        t.barriers++;
        break;
      default:
        break;
    }
  }

  void Handle(Conn* c, MsgHeader h, std::vector<float> buf, std::string cmd) {
    if (h.type == kPush || h.type == kPull || h.type == kPushPull ||
        h.type == kBarrier || h.type == kInit) {
      RecordTrace(h);
    }
    // membership-epoch gate (elastic mode only; negative keys are the
    // reserved diagnostic slots — stats/membership self-publish — and stay
    // reachable from any epoch, or a stale worker could never resync)
    if (elastic_ && h.key >= 0 &&
        (h.type == kPush || h.type == kPull || h.type == kPushPull ||
         h.type == kBarrier || h.type == kInit) &&
        h.mepoch != epoch_) {
      Respond(c, MsgHeader{kRejectEpoch, h.key, h.req_id, 0, epoch_, -1, 0},
              nullptr);
      std::unique_lock<std::mutex> lk(c->hmu);
      if (--c->inflight == 0) c->hcv.notify_all();
      return;
    }
    switch (h.type) {
      case kPush: {
        Entry* e = GetEntry(h.key);
        bool ok = HandlePush(h.key, e, buf.data(), buf.size(), h.mepoch);
        Respond(c, MsgHeader{ok ? kResp : kRejectEpoch, h.key, h.req_id, 0,
                             epoch_, -1, 0},
                nullptr);
        break;
      }
      case kInit: {
        // direct overwrite: no merge/optimizer and — deliberately — no
        // version bump or notify. A pending partial round keeps waiting:
        // the elastic protocol sends kInit after the reconfigure flush and
        // before the coordinator's first push, so waking merged-but-blocked
        // pushers here would return their pushes before a round committed.
        Entry* e = GetEntry(h.key);
        std::unique_lock<std::mutex> lk(e->mu);
        if (elastic_ && h.key >= 0 && h.mepoch != epoch_) {
          // same lock-held re-check as HandlePush: an overwrite from a
          // membership that ended mid-dispatch must not land
          lk.unlock();
          Respond(c, MsgHeader{kRejectEpoch, h.key, h.req_id, 0, epoch_, -1, 0},
                  nullptr);
          break;
        }
        e->weight.assign(buf.data(), buf.data() + buf.size());
        e->inited = true;
        lk.unlock();
        Respond(c, MsgHeader{kResp, h.key, h.req_id, 0, epoch_, -1, 0}, nullptr);
        break;
      }
      case kPull: {
        // no blocking on un-inited keys: init is barriered by the caller
        // (kvstore.py init), so an empty entry is a user error — a 0-byte
        // response lets the client raise instead of wedging
        Entry* e = GetEntry(h.key);
        std::unique_lock<std::mutex> lk(e->mu);
        std::vector<float> w = e->weight;  // copy under lock, send outside
        lk.unlock();
        Respond(c, MsgHeader{kResp, h.key, h.req_id,
                             static_cast<uint64_t>(w.size() * sizeof(float)),
                             0, -1, 0},
                w.data());
        if (h.key < 0 && h.key > kPersistentKeyMax) {
          // negative keys are reserved single-shot diagnostic slots (the
          // stats_to self-publish, kvstore_server.py): exactly one reader
          // pulls each once, so erase after serving — without this every
          // stats poll would permanently leak one Entry per server.
          // Keys at or below kPersistentKeyMax are PERSISTENT telemetry
          // slots (one per worker rank — bounded by cluster size, kvstore.py
          // TELEMETRY_KEY_BASE): each worker kInit-overwrites its own slot
          // periodically and any number of observers (cluster_stats,
          // tools/mxtop.py) pull it repeatedly, so these survive the pull.
          std::unique_lock<std::mutex> mlk(mu_);
          entries_.erase(h.key);
        }
        break;
      }
      case kPushPull: {
        Entry* e = GetEntry(h.key);
        if (!HandlePush(h.key, e, buf.data(), buf.size(), h.mepoch)) {
          Respond(c, MsgHeader{kRejectEpoch, h.key, h.req_id, 0, epoch_, -1, 0},
                  nullptr);
          break;
        }
        std::unique_lock<std::mutex> lk(e->mu);
        std::vector<float> w = e->weight;
        lk.unlock();
        Respond(c, MsgHeader{kResp, h.key, h.req_id,
                             static_cast<uint64_t>(w.size() * sizeof(float)),
                             0, -1, 0},
                w.data());
        break;
      }
      case kBarrier: {
        std::unique_lock<std::mutex> lk(barrier_mu_);
        // lock-held epoch re-check (see HandlePush): a stale arrival after
        // Reconfigure() reset barrier_count_ must not count toward — or
        // prematurely release — the new membership's smaller rendezvous
        if (elastic_ && h.mepoch != epoch_) {
          lk.unlock();
          Respond(c, MsgHeader{kRejectEpoch, 0, h.req_id, 0, epoch_, -1, 0},
                  nullptr);
          break;
        }
        int64_t gen = barrier_gen_;
        int64_t bfg = barrier_flush_;
        bool ok = true;
        if (++barrier_count_ >= num_workers_) {
          barrier_count_ = 0;
          barrier_gen_++;
          barrier_cv_.notify_all();
        } else {
          barrier_cv_.wait(lk, [&] {
            return barrier_gen_ != gen || barrier_flush_ != bfg || stopping_;
          });
          // a reconfiguration flushed this rendezvous: the membership the
          // waiter was synchronizing with no longer exists
          ok = barrier_flush_ == bfg;
        }
        lk.unlock();
        Respond(c, MsgHeader{ok ? kResp : kRejectEpoch, 0, h.req_id, 0,
                             epoch_, -1, 0},
                nullptr);
        break;
      }
      case kCommand: {
        if (cmd.rfind("sync:", 0) == 0) sync_ = cmd[5] == '1';
        if (cmd.rfind("elastic:", 0) == 0) elastic_ = cmd[8] == '1';
        if (cmd.rfind("mepoch:", 0) == 0) {
          long long e = 0;
          int w = 0;
          if (sscanf(cmd.c_str() + 7, "%lld:%d", &e, &w) == 2)
            Reconfigure(e, w);
        }
        int refused = cmd_handler_ ? cmd_handler_(cmd.data(), cmd.size()) : 0;
        Respond(c, MsgHeader{refused ? kRefused : kResp, 0, h.req_id, 0, 0,
                             -1, 0},
                nullptr);
        break;
      }
      default:
        break;
    }
    std::unique_lock<std::mutex> lk(c->hmu);
    if (--c->inflight == 0) c->hcv.notify_all();
  }

  void ConnLoop(int fd) {
    Conn conn;
    conn.fd = fd;
    for (;;) {
      MsgHeader h;
      if (!ReadAll(fd, &h, sizeof(h))) break;
      if (h.type == kStop) {
        Respond(&conn, MsgHeader{kResp, 0, h.req_id, 0, 0, -1, 0}, nullptr);
        std::unique_lock<std::mutex> lk(stop_mu_);
        stop_requested_ = true;
        stop_cv_.notify_all();
        break;
      }
      std::vector<float> buf;
      std::string cmd;
      if (h.type == kPush || h.type == kPushPull || h.type == kInit) {
        buf.resize(h.nbytes / sizeof(float));
        if (h.nbytes && !ReadAll(fd, buf.data(), h.nbytes)) break;
      } else if (h.type == kCommand) {
        cmd.resize(h.nbytes);
        if (h.nbytes && !ReadAll(fd, &cmd[0], h.nbytes)) break;
      }
      {
        std::unique_lock<std::mutex> lk(conn.hmu);
        conn.inflight++;
      }
      // detached: a long-lived worker connection makes millions of RPCs, so
      // retaining joinable threads until teardown would accumulate without
      // bound; the inflight counter below is the (only) join point, and it
      // is reached before `conn` goes out of scope.
      std::thread(&PSServer::Handle, this, &conn, h, std::move(buf),
                  std::move(cmd))
          .detach();
    }
    {  // drain outstanding handlers before closing the socket
      std::unique_lock<std::mutex> lk(conn.hmu);
      conn.hcv.wait(lk, [&] { return conn.inflight == 0; });
    }
    ::close(fd);
  }

  int listen_fd_ = -1;
  std::atomic<int> num_workers_;
  std::atomic<bool> sync_{true};
  std::atomic<bool> stopping_{false};
  // elastic membership: epoch checked on data-path requests once elastic_
  // is switched on; flush_gen_/barrier_flush_ invalidate in-flight BSP
  // rounds and barriers across a reconfiguration
  std::atomic<bool> elastic_{false};
  std::atomic<int64_t> epoch_{0};
  std::atomic<int64_t> flush_gen_{0};
  int64_t barrier_flush_ = 0;  // guarded by barrier_mu_
  bool failed_ = false;
  std::thread accept_thread_;
  std::mutex mu_;
  std::map<int, std::unique_ptr<Entry>> entries_;
  std::mutex tmu_;  // guards trace_ (bumped on conn handler threads)
  std::map<int, RankTrace> trace_;
  std::vector<std::thread> conn_threads_;
  std::mutex barrier_mu_;
  std::condition_variable barrier_cv_;
  int barrier_count_ = 0;
  int64_t barrier_gen_ = 0;
  std::mutex stop_mu_;
  std::condition_variable stop_cv_;
  bool stop_requested_ = false;
  UpdaterFn updater_ = nullptr;
  CommandFn cmd_handler_ = nullptr;

  // PSServer is non-copyable
  PSServer(const PSServer&) = delete;
  PSServer& operator=(const PSServer&) = delete;
};

class PSClient {
 public:
  // attempts × 100ms bounds the connect retry: the default (600 = 60s)
  // covers the worker-before-server launch race; replication / failover
  // reconnect paths pass a small budget so a dead peer costs a bounded
  // wait, not a minute per round.
  PSClient(const char* host, int port, int attempts = 600) {
    fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons(static_cast<uint16_t>(port));
    inet_pton(AF_INET, host, &addr.sin_addr);
    // retry: workers may start before the server (launch.py races too)
    for (int attempt = 0; attempt < attempts; ++attempt) {
      if (::connect(fd_, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) ==
          0) {
        int one = 1;
        setsockopt(fd_, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        reader_ = std::thread([this] { ReaderLoop(); });
        return;
      }
      ::close(fd_);
      struct timespec ts = {0, 100 * 1000 * 1000};
      nanosleep(&ts, nullptr);
      fd_ = ::socket(AF_INET, SOCK_STREAM, 0);
    }
    ::close(fd_);
    fd_ = -1;
  }

  ~PSClient() {
    if (fd_ >= 0) {
      ::shutdown(fd_, SHUT_RDWR);
      if (reader_.joinable()) reader_.join();
      ::close(fd_);
    }
  }

  bool ok() const { return fd_ >= 0; }

  // True once the reader observed a socket failure: every outstanding and
  // future RPC on this handle fails. The HA tier uses this to decide which
  // client handles to rebuild after adopting a new key→server map.
  bool IsDead() {
    std::unique_lock<std::mutex> lk(pmu_);
    return dead_;
  }

  // Membership epoch stamped on every subsequent request (elastic mode);
  // adopted by the Python tier after a registry sync.
  void SetEpoch(int64_t e) { epoch_ = e; }
  int64_t GetEpoch() const { return epoch_; }

  // Trace identity stamped on every subsequent request: the worker's rank
  // (set once at store construction; stays -1 = unidentified on loopback/
  // observer clients so they never pollute per-rank attribution) and its
  // current training step (the fit loop bumps it each batch).
  void SetIdentity(int rank) { rank_ = rank; }
  void SetStep(int64_t s) { step_ = s; }

  // 0 ok, -1 transport failure, -2 stale membership epoch
  int Push(int key, const float* data, uint64_t n) {
    Pending p;
    if (!Send(kPush, key, &p, data, n * sizeof(float))) return -1;
    int64_t r = Await(&p);
    return r >= 0 ? 0 : static_cast<int>(r);
  }

  // Direct weight overwrite (kInit): bypasses merge + optimizer. Same
  // result convention as Push.
  int Init(int key, const float* data, uint64_t n) {
    Pending p;
    if (!Send(kInit, key, &p, data, n * sizeof(float))) return -1;
    int64_t r = Await(&p);
    return r >= 0 ? 0 : static_cast<int>(r);
  }

  // Pull into caller buffer of capacity cap floats; returns #floats or -1.
  int64_t Pull(int key, float* out, uint64_t cap) {
    Pending p;
    p.out = out;
    p.cap = cap;
    if (!Send(kPull, key, &p, nullptr, 0)) return -1;
    return Await(&p);
  }

  int64_t PushPull(int key, const float* data, uint64_t n, float* out,
                   uint64_t cap) {
    Pending p;
    p.out = out;
    p.cap = cap;
    if (!Send(kPushPull, key, &p, data, n * sizeof(float))) return -1;
    return Await(&p);
  }

  // 0 ok, -1 transport failure, -2 membership reconfiguration flushed it
  int Barrier() {
    Pending p;
    if (!Send(kBarrier, 0, &p, nullptr, 0)) return -1;
    int64_t r = Await(&p);
    return r >= 0 ? 0 : static_cast<int>(r);
  }

  bool Command(const char* cmd) {
    Pending p;
    if (!Send(kCommand, 0, &p, cmd, strlen(cmd))) return false;
    return Await(&p) >= 0;
  }

  // Liveness probe: a command round-trip with a deadline. A wedged server
  // (socket open, not responding) must yield false, not a hang — the one
  // case get_num_dead_node exists for (reference: ps-lite heartbeats).
  bool CommandTimeout(const char* cmd, int timeout_ms) {
    Pending p;
    uint64_t id = 0;
    if (!Send(kCommand, 0, &p, cmd, strlen(cmd), &id)) return false;
    std::unique_lock<std::mutex> lk(p.mu);
    if (p.cv.wait_for(lk, std::chrono::milliseconds(timeout_ms),
                      [&] { return p.done; }))
      return p.result >= 0;
    lk.unlock();
    bool removed;
    {
      std::unique_lock<std::mutex> plk(pmu_);
      removed = pending_.erase(id) > 0;
    }
    lk.lock();
    if (removed) return false;  // reader never saw a response; p is ours again
    // the reader popped p and is mid-fill: the response arrived, wait for the
    // signal (prompt — payload for command responses is empty)
    p.cv.wait(lk, [&] { return p.done; });
    return p.result >= 0;
  }

  bool Stop() {
    Pending p;
    if (!Send(kStop, 0, &p, nullptr, 0)) return false;
    return Await(&p) >= 0;
  }

 private:
  // One outstanding RPC registration: the reader thread fills result/copies
  // payload and signals. Many may be in flight on the single socket.
  struct Pending {
    std::mutex mu;
    std::condition_variable cv;
    bool done = false;
    int64_t result = -1;  // #floats (or 0) on success, -1 on failure
    float* out = nullptr;
    uint64_t cap = 0;
  };

  bool Send(uint32_t type, int key, Pending* p, const void* payload,
            uint64_t nbytes, uint64_t* out_id = nullptr) {
    if (fd_ < 0) return false;
    uint64_t id;
    {
      std::unique_lock<std::mutex> lk(pmu_);
      if (dead_) return false;
      id = next_id_++;
      pending_[id] = p;
    }
    if (out_id) *out_id = id;
    MsgHeader h{type, key, id, nbytes, epoch_.load(), rank_.load(),
                step_.load()};
    std::unique_lock<std::mutex> lk(wmu_);
    if (!WriteAll(fd_, &h, sizeof(h)) ||
        (nbytes && !WriteAll(fd_, payload, nbytes))) {
      lk.unlock();
      std::unique_lock<std::mutex> plk(pmu_);
      pending_.erase(id);
      return false;
    }
    return true;
  }

  int64_t Await(Pending* p) {
    std::unique_lock<std::mutex> lk(p->mu);
    p->cv.wait(lk, [&] { return p->done; });
    return p->result;
  }

  void ReaderLoop() {
    std::vector<float> scratch;
    for (;;) {
      MsgHeader h;
      if (!ReadAll(fd_, &h, sizeof(h))) break;
      Pending* p = nullptr;
      {
        std::unique_lock<std::mutex> lk(pmu_);
        auto it = pending_.find(h.req_id);
        if (it != pending_.end()) {
          p = it->second;
          pending_.erase(it);
        }
      }
      uint64_t n = h.nbytes / sizeof(float);
      // kRejectEpoch carries no payload: -2 distinguishes a membership
      // rejection (deterministic, never retried) from a transport -1;
      // kRefused (-3) is a command its handler declined
      int64_t result = h.type == kRejectEpoch ? -2
                       : h.type == kRefused   ? -3
                                              : static_cast<int64_t>(n);
      bool read_ok = true;
      if (p && p->out && n) {
        if (n <= p->cap) {
          read_ok = ReadAll(fd_, p->out, h.nbytes);
        } else {  // drain oversized payload, report true size
          scratch.resize(n);
          read_ok = ReadAll(fd_, scratch.data(), h.nbytes);
          if (read_ok) memcpy(p->out, scratch.data(), p->cap * sizeof(float));
        }
      } else if (n) {
        scratch.resize(n);
        read_ok = ReadAll(fd_, scratch.data(), h.nbytes);
      }
      if (p) {
        // p was already popped from pending_, so the failure sweep below
        // cannot see it — signal (with -1 on a failed payload read) here
        std::unique_lock<std::mutex> lk(p->mu);
        p->done = true;
        p->result = read_ok ? result : -1;
        p->cv.notify_all();
      }
      if (!read_ok) break;
    }
    // socket failed/closed: fail every outstanding + future RPC
    std::unique_lock<std::mutex> lk(pmu_);
    dead_ = true;
    for (auto& kv : pending_) {
      std::unique_lock<std::mutex> plk(kv.second->mu);
      kv.second->done = true;
      kv.second->result = -1;
      kv.second->cv.notify_all();
    }
    pending_.clear();
  }

  int fd_ = -1;
  std::atomic<int64_t> epoch_{0};
  std::atomic<int> rank_{-1};
  std::atomic<int64_t> step_{0};
  std::thread reader_;
  std::mutex wmu_;   // serializes frame writes
  std::mutex pmu_;   // guards pending_/next_id_/dead_
  std::map<uint64_t, Pending*> pending_;
  uint64_t next_id_ = 1;
  bool dead_ = false;
};

}  // namespace mxt

extern "C" {

void* mxt_ps_server_create(int port, int num_workers, int sync) {
  auto* s = new mxt::PSServer(port, num_workers, sync != 0);
  if (s->failed()) {
    delete s;
    return nullptr;
  }
  return s;
}
void mxt_ps_server_set_updater(void* h, mxt::UpdaterFn fn) {
  static_cast<mxt::PSServer*>(h)->SetUpdater(fn);
}
void mxt_ps_server_set_command_handler(void* h, mxt::CommandFn fn) {
  static_cast<mxt::PSServer*>(h)->SetCommandHandler(fn);
}
void mxt_ps_server_wait(void* h) {
  static_cast<mxt::PSServer*>(h)->WaitStopped();
}
// Per-rank trace attribution (cluster observability): flat doubles
// [rank, last_step, last_mepoch, pushes, pulls, barriers, inits] x N;
// returns the number of doubles written.
int mxt_ps_server_trace_stats(void* h, double* out, int cap) {
  return static_cast<mxt::PSServer*>(h)->TraceStats(out, cap);
}
void mxt_ps_server_destroy(void* h) { delete static_cast<mxt::PSServer*>(h); }

void* mxt_ps_client_create(const char* host, int port) {
  auto* c = new mxt::PSClient(host, port);
  if (!c->ok()) {
    delete c;
    return nullptr;
  }
  return c;
}
// HA reconnect path: bounded connect budget (attempts × 100ms) so dialing
// a still-dead server costs a deterministic wait, not the 60s launch-race
// budget of mxt_ps_client_create.
void* mxt_ps_client_create2(const char* host, int port, int attempts) {
  auto* c = new mxt::PSClient(host, port, attempts);
  if (!c->ok()) {
    delete c;
    return nullptr;
  }
  return c;
}
int mxt_ps_client_is_dead(void* h) {
  return static_cast<mxt::PSClient*>(h)->IsDead() ? 1 : 0;
}
int mxt_ps_client_push(void* h, int key, const float* data,
                       unsigned long long n) {
  return static_cast<mxt::PSClient*>(h)->Push(key, data, n);
}
// Elastic membership surface: direct weight overwrite (reconfiguration
// re-seed), and the epoch stamped on every request from this client.
int mxt_ps_client_init(void* h, int key, const float* data,
                       unsigned long long n) {
  return static_cast<mxt::PSClient*>(h)->Init(key, data, n);
}
void mxt_ps_client_set_epoch(void* h, long long epoch) {
  static_cast<mxt::PSClient*>(h)->SetEpoch(epoch);
}
// Trace identity (cluster observability): rank set once per worker store,
// step bumped by the fit loop each batch.
void mxt_ps_client_set_identity(void* h, int rank) {
  static_cast<mxt::PSClient*>(h)->SetIdentity(rank);
}
void mxt_ps_client_set_step(void* h, long long step) {
  static_cast<mxt::PSClient*>(h)->SetStep(step);
}
long long mxt_ps_client_get_epoch(void* h) {
  return static_cast<mxt::PSClient*>(h)->GetEpoch();
}
long long mxt_ps_client_pull(void* h, int key, float* out,
                             unsigned long long cap) {
  return static_cast<mxt::PSClient*>(h)->Pull(key, out, cap);
}
long long mxt_ps_client_pushpull(void* h, int key, const float* data,
                                 unsigned long long n, float* out,
                                 unsigned long long cap) {
  return static_cast<mxt::PSClient*>(h)->PushPull(key, data, n, out, cap);
}
int mxt_ps_client_barrier(void* h) {
  return static_cast<mxt::PSClient*>(h)->Barrier();
}
int mxt_ps_client_command(void* h, const char* cmd) {
  return static_cast<mxt::PSClient*>(h)->Command(cmd) ? 0 : -1;
}
int mxt_ps_client_probe(void* h, const char* cmd, int timeout_ms) {
  return static_cast<mxt::PSClient*>(h)->CommandTimeout(cmd, timeout_ms) ? 0 : -1;
}

// Standalone liveness probe on a FRESH connection with a deadline on every
// phase (connect, send, receive). Unlike client_probe it cannot block on the
// shared client socket's write mutex when a bulk Push has wedged — the
// failure mode a liveness check exists to detect.
int mxt_ps_probe(const char* host, int port, int timeout_ms) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return -1;
  fcntl(fd, F_SETFL, fcntl(fd, F_GETFL, 0) | O_NONBLOCK);
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  inet_pton(AF_INET, host, &addr.sin_addr);
  int rc = ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr));
  if (rc != 0 && errno != EINPROGRESS) {
    ::close(fd);
    return -1;
  }
  auto wait_io = [&](short events) {
    pollfd p{fd, events, 0};
    return ::poll(&p, 1, timeout_ms) == 1 && !(p.revents & (POLLERR | POLLHUP));
  };
  if (rc != 0) {
    if (!wait_io(POLLOUT)) {
      ::close(fd);
      return -1;
    }
    int err = 0;
    socklen_t len = sizeof(err);
    if (getsockopt(fd, SOL_SOCKET, SO_ERROR, &err, &len) != 0 || err != 0) {
      ::close(fd);
      return -1;
    }
  }
  const char ping[] = "ping";
  mxt::MsgHeader h{mxt::kCommand, 0, 1, sizeof(ping) - 1, 0, -1, 0};
  char buf[sizeof(h) + sizeof(ping) - 1];
  memcpy(buf, &h, sizeof(h));
  memcpy(buf + sizeof(h), ping, sizeof(ping) - 1);
  size_t sent = 0;
  while (sent < sizeof(buf)) {
    if (!wait_io(POLLOUT)) {
      ::close(fd);
      return -1;
    }
    ssize_t n = ::send(fd, buf + sent, sizeof(buf) - sent, MSG_NOSIGNAL);
    if (n <= 0 && errno != EAGAIN && errno != EWOULDBLOCK) {
      ::close(fd);
      return -1;
    }
    if (n > 0) sent += static_cast<size_t>(n);
  }
  mxt::MsgHeader resp;
  size_t got = 0;
  while (got < sizeof(resp)) {
    if (!wait_io(POLLIN)) {
      ::close(fd);
      return -1;
    }
    ssize_t n = ::recv(fd, reinterpret_cast<char*>(&resp) + got,
                       sizeof(resp) - got, 0);
    if (n == 0 || (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK)) {
      ::close(fd);  // n == 0: peer closed before responding
      return -1;
    }
    if (n > 0) got += static_cast<size_t>(n);
  }
  ::close(fd);
  return resp.type == mxt::kResp ? 0 : -1;
}
int mxt_ps_client_stop(void* h) {
  return static_cast<mxt::PSClient*>(h)->Stop() ? 0 : -1;
}
void mxt_ps_client_destroy(void* h) { delete static_cast<mxt::PSClient*>(h); }

}  // extern "C"
