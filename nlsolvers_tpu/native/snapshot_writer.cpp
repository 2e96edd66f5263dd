// Async .npy snapshot writer: the native IO runtime of the framework.
//
// Reference equivalents: the C++ npy IO in nlsolvers/common/include/util.hpp
// (save_to_npy / read_from_npy via libnpy) and the online snapshot streaming
// of the device solvers (store_snapshot_online, nlse_dev.hpp:323-334), which
// copy each snapshot device->host synchronously inside the step loop. Here
// the host side is a thread pool: the Python pipeline hands a finished
// snapshot buffer over (one memcpy) and the accelerator moves on while
// worker threads serialize .npy files to disk — disk IO overlaps device compute
// during datagen sweeps.
//
// Plain C ABI for ctypes (no pybind11 in this environment). All functions
// are thread-safe; handles are opaque.
//
// .npy format: v1.0 spec (numpy/lib/format.py) — magic, header with dict
// {'descr': dtype, 'fortran_order': False, 'shape': (...)}, padded to a
// multiple of 64 bytes, then raw little-endian data.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Task {
  std::string path;
  std::string descr;                 // numpy descr, e.g. "<f4", "<c8"
  std::vector<int64_t> shape;
  std::vector<uint8_t> data;         // owned copy
};

std::string npy_header(const std::string &descr,
                       const std::vector<int64_t> &shape) {
  std::string dict = "{'descr': '" + descr + "', 'fortran_order': False, "
                     "'shape': (";
  for (size_t i = 0; i < shape.size(); ++i) {
    dict += std::to_string(shape[i]);
    if (shape.size() == 1 || i + 1 < shape.size()) dict += ",";
    if (i + 1 < shape.size()) dict += " ";
  }
  dict += "), }";
  // total header (magic 8 + 2 len + dict + pad + '\n') % 64 == 0
  size_t base = 8 + 2 + dict.size() + 1;
  size_t pad = (64 - base % 64) % 64;
  dict += std::string(pad, ' ');
  dict += '\n';

  std::string out;
  out += "\x93NUMPY";
  out += '\x01';
  out += '\x00';
  uint16_t hlen = static_cast<uint16_t>(dict.size());
  out += static_cast<char>(hlen & 0xff);
  out += static_cast<char>((hlen >> 8) & 0xff);
  out += dict;
  return out;
}

bool write_npy(const Task &t) {
  std::FILE *f = std::fopen(t.path.c_str(), "wb");
  if (!f) return false;
  std::string header = npy_header(t.descr, t.shape);
  bool ok = std::fwrite(header.data(), 1, header.size(), f) == header.size();
  if (ok && !t.data.empty())
    ok = std::fwrite(t.data.data(), 1, t.data.size(), f) == t.data.size();
  std::fclose(f);
  return ok;
}

class Writer {
 public:
  explicit Writer(int n_threads) : stop_(false), pending_(0), errors_(0) {
    if (n_threads < 1) n_threads = 1;
    for (int i = 0; i < n_threads; ++i)
      workers_.emplace_back([this] { this->loop(); });
  }

  ~Writer() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    for (auto &w : workers_) w.join();
  }

  void submit(Task &&t) {
    {
      std::unique_lock<std::mutex> lk(mu_);
      pending_++;
      queue_.push_back(std::move(t));
    }
    cv_.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu_);
    done_cv_.wait(lk, [this] { return pending_ == 0; });
  }

  int64_t pending() {
    std::unique_lock<std::mutex> lk(mu_);
    return pending_;
  }

  int64_t errors() { return errors_.load(); }

 private:
  void loop() {
    for (;;) {
      Task t;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        t = std::move(queue_.front());
        queue_.pop_front();
      }
      if (!write_npy(t)) errors_.fetch_add(1);
      {
        std::unique_lock<std::mutex> lk(mu_);
        if (--pending_ == 0) done_cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_, done_cv_;
  std::deque<Task> queue_;
  std::vector<std::thread> workers_;
  bool stop_;
  int64_t pending_;
  std::atomic<int64_t> errors_;
};

}  // namespace

extern "C" {

void *sw_create(int n_threads) { return new Writer(n_threads); }

void sw_destroy(void *h) { delete static_cast<Writer *>(h); }

// Copies `nbytes` from `data` and enqueues an async .npy write.
// descr: numpy dtype descr string ("<f4", "<f8", "<c8", "<c16", "<i8", ...).
int sw_submit(void *h, const char *path, const void *data, int64_t nbytes,
              const char *descr, int ndim, const int64_t *shape) {
  if (!h || !path || !descr || ndim < 0) return -1;
  Task t;
  t.path = path;
  t.descr = descr;
  t.shape.assign(shape, shape + ndim);
  t.data.resize(static_cast<size_t>(nbytes));
  if (nbytes > 0) std::memcpy(t.data.data(), data, t.data.size());
  static_cast<Writer *>(h)->submit(std::move(t));
  return 0;
}

// Blocks until every queued write has hit the filesystem.
void sw_flush(void *h) { static_cast<Writer *>(h)->flush(); }

int64_t sw_pending(void *h) { return static_cast<Writer *>(h)->pending(); }

// Number of failed writes since creation (0 in a healthy run).
int64_t sw_errors(void *h) { return static_cast<Writer *>(h)->errors(); }

// Synchronous single-shot write (no queue) — parity with save_to_npy.
int sw_write_sync(const char *path, const void *data, int64_t nbytes,
                  const char *descr, int ndim, const int64_t *shape) {
  Task t;
  t.path = path;
  t.descr = descr;
  t.shape.assign(shape, shape + ndim);
  t.data.assign(static_cast<const uint8_t *>(data),
                static_cast<const uint8_t *>(data) + nbytes);
  return write_npy(t) ? 0 : -1;
}

}  // extern "C"
