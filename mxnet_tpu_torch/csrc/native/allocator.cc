// Pooled host allocator — rebuild of the reference's storage managers
// (reference: src/storage/pooled_storage_manager.h GPUPooledStorageManager
// recycles blocks by exact size; src/storage/cpu_device_storage.h 64-byte
// aligned host alloc). On TPU the device pool belongs to the XLA runtime, so
// this pool serves HOST staging memory: recordio record buffers, decoded
// image batches, kvstore wire buffers.
//
// Design differs from the reference: buckets are rounded up to the next
// power of two above 64B (exact-size recycling like the reference fragments
// badly for variable-length records), with a global byte cap that evicts
// largest-first (reference env MXNET_GPU_MEM_POOL_RESERVE is the analog).

#include <atomic>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <mutex>
#include <vector>

namespace mxt {

struct Pool {
  std::mutex mu;
  // bucket (log2 size) -> free blocks
  std::map<int, std::vector<void*>> free_lists;
  std::atomic<int64_t> in_use{0};
  std::atomic<int64_t> pooled{0};
  int64_t max_pooled = 1LL << 30;  // 1 GiB default cap on cached bytes

  static int Bucket(size_t nbytes) {
    int b = 6;  // 64B min
    while ((1ULL << b) < nbytes) ++b;
    return b;
  }

  void* Alloc(size_t nbytes) {
    if (nbytes == 0) nbytes = 1;
    int b = Bucket(nbytes);
    {
      std::unique_lock<std::mutex> lk(mu);
      auto it = free_lists.find(b);
      if (it != free_lists.end() && !it->second.empty()) {
        void* p = it->second.back();
        it->second.pop_back();
        pooled.fetch_sub(1LL << b, std::memory_order_relaxed);
        in_use.fetch_add(1LL << b, std::memory_order_relaxed);
        return p;
      }
    }
    void* p = nullptr;
    if (posix_memalign(&p, 64, 1ULL << b) != 0) return nullptr;
    in_use.fetch_add(1LL << b, std::memory_order_relaxed);
    return p;
  }

  void Free(void* p, size_t nbytes) {
    if (p == nullptr) return;
    if (nbytes == 0) nbytes = 1;
    int b = Bucket(nbytes);
    in_use.fetch_sub(1LL << b, std::memory_order_relaxed);
    std::unique_lock<std::mutex> lk(mu);
    if (pooled.load(std::memory_order_relaxed) + (1LL << b) > max_pooled) {
      lk.unlock();
      free(p);
      return;
    }
    free_lists[b].push_back(p);
    pooled.fetch_add(1LL << b, std::memory_order_relaxed);
  }

  void Clear() {
    std::unique_lock<std::mutex> lk(mu);
    for (auto& kv : free_lists)
      for (void* p : kv.second) free(p);
    free_lists.clear();
    pooled.store(0, std::memory_order_relaxed);
  }
};

static Pool g_pool;

}  // namespace mxt

extern "C" {

void* mxt_alloc(size_t nbytes) { return mxt::g_pool.Alloc(nbytes); }
void mxt_free(void* p, size_t nbytes) { mxt::g_pool.Free(p, nbytes); }
void mxt_pool_clear() { mxt::g_pool.Clear(); }
void mxt_pool_set_cap(long long nbytes) { mxt::g_pool.max_pooled = nbytes; }
long long mxt_pool_in_use() {
  return mxt::g_pool.in_use.load(std::memory_order_relaxed);
}
long long mxt_pool_pooled() {
  return mxt::g_pool.pooled.load(std::memory_order_relaxed);
}

}  // extern "C"
