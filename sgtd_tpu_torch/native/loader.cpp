// Native data loader for sgtd_tpu_torch (a copy of sgtd_tpu's, built and
// bound by the port's own sgtd_tpu_torch/native/__init__.py).
//
// Equivalent of the reference's C++ scan/label readers
// (readBinFile, semantic_graph_localization.cpp:132-182; gen_labels' raw
// readers, get_json.cpp:47-88) plus a background prefetcher the reference
// lacks (its main loop does blocking file IO per query).
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency):
//   sgtd_read_bin      — .bin float32 x,y,z,i records -> packed floats
//   sgtd_read_label    — .label uint32 records -> sem (low16) / inst (high16)
//   sgtd_load_scan     — fused bin+label read with near-origin point
//                        filtering (ref :655-657)
//   sgtd_prefetch_*    — N-thread readahead pool over a scan list: while the
//                        accelerator crunches scan i, workers pull i+1..i+k
//                        from disk into an LRU slot cache.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread loader.cpp -o libsgtd_native.so
// (sgtd_tpu_torch.native does this at first use, into build/sgtd_tpu_torch/).

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <memory>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Blob {
  std::vector<char> data;
};

static bool read_file(const char* path, std::vector<char>& out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out.resize(static_cast<size_t>(n));
  size_t got = n > 0 ? std::fread(out.data(), 1, static_cast<size_t>(n), f) : 0;
  std::fclose(f);
  return got == static_cast<size_t>(n);
}

}  // namespace

extern "C" {

// Read a .bin scan. Returns number of points written (<= cap), -1 on error.
// out_xyzi must hold cap * 4 floats.
long long sgtd_read_bin(const char* path, float* out_xyzi, long long cap) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  long long n = static_cast<long long>(buf.size() / (4 * sizeof(float)));
  if (n > cap) n = cap;
  std::memcpy(out_xyzi, buf.data(), static_cast<size_t>(n) * 4 * sizeof(float));
  return n;
}

// Read a .label file. sem = low 16 bits, inst = high 16 bits.
long long sgtd_read_label(const char* path, int32_t* out_sem,
                          int32_t* out_inst, long long cap) {
  std::vector<char> buf;
  if (!read_file(path, buf)) return -1;
  long long n = static_cast<long long>(buf.size() / sizeof(uint32_t));
  if (n > cap) n = cap;
  const uint32_t* lab = reinterpret_cast<const uint32_t*>(buf.data());
  for (long long i = 0; i < n; ++i) {
    out_sem[i] = static_cast<int32_t>(lab[i] & 0xFFFFu);
    out_inst[i] = static_cast<int32_t>(lab[i] >> 16);
  }
  return n;
}

// Fused scan+label load with near-origin filtering (squared norm < min_sq
// dropped, ref semantic_graph_localization.cpp:655-657). Returns point count.
long long sgtd_load_scan(const char* bin_path, const char* label_path,
                         float min_sq, float* out_xyz, int32_t* out_sem,
                         int32_t* out_inst, long long cap) {
  std::vector<char> bbuf, lbuf;
  if (!read_file(bin_path, bbuf)) return -1;
  const float* pts = reinterpret_cast<const float*>(bbuf.data());
  long long n = static_cast<long long>(bbuf.size() / (4 * sizeof(float)));

  const uint32_t* lab = nullptr;
  long long nl = 0;
  if (label_path && label_path[0]) {
    if (!read_file(label_path, lbuf)) return -2;
    lab = reinterpret_cast<const uint32_t*>(lbuf.data());
    nl = static_cast<long long>(lbuf.size() / sizeof(uint32_t));
    if (nl < n) n = nl;
  }

  long long k = 0;
  for (long long i = 0; i < n && k < cap; ++i) {
    const float x = pts[i * 4], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
    if (x * x + y * y + z * z < min_sq) continue;
    out_xyz[k * 3] = x;
    out_xyz[k * 3 + 1] = y;
    out_xyz[k * 3 + 2] = z;
    if (lab) {
      out_sem[k] = static_cast<int32_t>(lab[i] & 0xFFFFu);
      out_inst[k] = static_cast<int32_t>(lab[i] >> 16);
    } else {
      out_sem[k] = 0;
      out_inst[k] = 0;
    }
    ++k;
  }
  return k;
}

// ---------------- prefetching dataset reader ----------------

struct Prefetcher {
  std::vector<std::string> bin_paths;
  std::vector<std::string> label_paths;
  float min_sq = 0.0f;
  int depth = 4;

  std::mutex mu;
  std::condition_variable cv_work;
  std::condition_variable cv_done;
  std::unordered_map<long long, std::shared_ptr<Blob>> bin_cache;
  std::unordered_map<long long, std::shared_ptr<Blob>> label_cache;
  std::deque<long long> order;  // for LRU eviction
  std::deque<long long> queue;  // indices to fetch
  std::vector<std::thread> workers;
  std::atomic<bool> stop{false};

  void worker() {
    for (;;) {
      long long idx;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_work.wait(lk, [&] { return stop.load() || !queue.empty(); });
        if (stop.load()) return;
        idx = queue.front();
        queue.pop_front();
        if (bin_cache.count(idx)) {
          cv_done.notify_all();
          continue;
        }
      }
      auto b = std::make_shared<Blob>();
      auto l = std::make_shared<Blob>();
      read_file(bin_paths[idx].c_str(), b->data);
      if (!label_paths.empty()) read_file(label_paths[idx].c_str(), l->data);
      {
        std::unique_lock<std::mutex> lk(mu);
        bin_cache[idx] = b;
        label_cache[idx] = l;
        order.push_back(idx);
        while (order.size() > static_cast<size_t>(2 * depth + 2)) {
          long long victim = order.front();
          order.pop_front();
          bin_cache.erase(victim);
          label_cache.erase(victim);
        }
      }
      cv_done.notify_all();
    }
  }
};

void* sgtd_prefetch_open(const char** bin_paths, const char** label_paths,
                         long long n, int n_threads, int depth, float min_sq) {
  auto* p = new Prefetcher();
  p->bin_paths.reserve(n);
  for (long long i = 0; i < n; ++i) p->bin_paths.emplace_back(bin_paths[i]);
  if (label_paths) {
    p->label_paths.reserve(n);
    for (long long i = 0; i < n; ++i)
      p->label_paths.emplace_back(label_paths[i]);
  }
  p->min_sq = min_sq;
  p->depth = depth;
  for (int i = 0; i < n_threads; ++i)
    p->workers.emplace_back(&Prefetcher::worker, p);
  return p;
}

long long sgtd_prefetch_get(void* handle, long long idx, float* out_xyz,
                            int32_t* out_sem, int32_t* out_inst,
                            long long cap) {
  auto* p = static_cast<Prefetcher*>(handle);
  const long long n = static_cast<long long>(p->bin_paths.size());
  if (idx < 0 || idx >= n) return -1;
  std::shared_ptr<Blob> b, l;
  {
    std::unique_lock<std::mutex> lk(p->mu);
    // Schedule this index plus readahead.
    for (long long j = idx; j < idx + p->depth && j < n; ++j) {
      if (!p->bin_cache.count(j)) p->queue.push_back(j);
    }
    p->cv_work.notify_all();
    // Timed re-request loop: guards against the (unlikely) eviction of idx
    // between a worker's insert and this waiter waking up.
    while (p->bin_cache.count(idx) == 0) {
      if (p->cv_done.wait_for(lk, std::chrono::milliseconds(100)) ==
          std::cv_status::timeout) {
        p->queue.push_back(idx);
        p->cv_work.notify_all();
      }
    }
    b = p->bin_cache[idx];
    l = p->label_cache[idx];
  }
  const float* pts = reinterpret_cast<const float*>(b->data.data());
  long long np = static_cast<long long>(b->data.size() / (4 * sizeof(float)));
  const uint32_t* lab = nullptr;
  if (l && !l->data.empty()) {
    lab = reinterpret_cast<const uint32_t*>(l->data.data());
    long long nl = static_cast<long long>(l->data.size() / sizeof(uint32_t));
    if (nl < np) np = nl;
  }
  long long k = 0;
  const float min_sq = p->min_sq;
  for (long long i = 0; i < np && k < cap; ++i) {
    const float x = pts[i * 4], y = pts[i * 4 + 1], z = pts[i * 4 + 2];
    if (x * x + y * y + z * z < min_sq) continue;
    out_xyz[k * 3] = x;
    out_xyz[k * 3 + 1] = y;
    out_xyz[k * 3 + 2] = z;
    if (lab) {
      out_sem[k] = static_cast<int32_t>(lab[i] & 0xFFFFu);
      out_inst[k] = static_cast<int32_t>(lab[i] >> 16);
    } else {
      out_sem[k] = 0;
      out_inst[k] = 0;
    }
    ++k;
  }
  return k;
}

void sgtd_prefetch_close(void* handle) {
  auto* p = static_cast<Prefetcher*>(handle);
  p->stop.store(true);
  p->cv_work.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
