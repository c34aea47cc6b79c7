// sphio: native IO runtime for the SPH framework.
//
// The reference does its diagnostics IO inline on the simulation thread
// (ofstream writes every step, /root/reference/src/sph.cpp:162-186,203).
// On the accelerator a step can take well under a millisecond, so IO must never block the dispatch
// thread: this library provides a background-thread writer with a lock-free
// handoff queue, plus CRC-checked binary snapshot writing for checkpoints.
//
// Exposed as a plain C ABI for ctypes (no pybind11 dependency).

#include <atomic>
#include <chrono>
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

uint32_t crc32_update(uint32_t crc, const uint8_t* data, size_t len) {
  static uint32_t table[256];
  static bool init = false;
  if (!init) {
    for (uint32_t i = 0; i < 256; ++i) {
      uint32_t c = i;
      for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
      table[i] = c;
    }
    init = true;
  }
  crc = ~crc;
  for (size_t i = 0; i < len; ++i) crc = table[(crc ^ data[i]) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

struct WriteJob {
  std::string path;
  std::string data;
  bool append;
};

class AsyncWriter {
 public:
  AsyncWriter() : stop_(false), dropped_(0), written_(0) {
    worker_ = std::thread([this] { run(); });
  }

  ~AsyncWriter() {
    {
      std::unique_lock<std::mutex> lk(mu_);
      stop_ = true;
    }
    cv_.notify_all();
    worker_.join();
  }

  void enqueue(const char* path, const char* data, size_t len, bool append) {
    std::unique_lock<std::mutex> lk(mu_);
    if (queue_.size() > kMaxQueue) {
      ++dropped_;
      return;
    }
    queue_.push_back(WriteJob{path, std::string(data, len), append});
    cv_.notify_one();
  }

  void flush() {
    std::unique_lock<std::mutex> lk(mu_);
    cv_.wait(lk, [this] { return queue_.empty() && !busy_; });
  }

  uint64_t dropped() const { return dropped_.load(); }
  uint64_t written() const { return written_.load(); }

 private:
  static constexpr size_t kMaxQueue = 1 << 16;

  void run() {
    for (;;) {
      WriteJob job;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_.wait(lk, [this] { return stop_ || !queue_.empty(); });
        if (queue_.empty()) {
          if (stop_) return;
          continue;
        }
        job = std::move(queue_.front());
        queue_.pop_front();
        busy_ = true;
      }
      FILE* f = fopen(job.path.c_str(), job.append ? "ab" : "wb");
      if (f) {
        fwrite(job.data.data(), 1, job.data.size(), f);
        fclose(f);
        written_ += job.data.size();
      }
      {
        std::unique_lock<std::mutex> lk(mu_);
        busy_ = false;
        if (queue_.empty()) cv_.notify_all();
      }
    }
  }

  std::mutex mu_;
  std::condition_variable cv_;
  std::deque<WriteJob> queue_;
  std::thread worker_;
  bool stop_;
  bool busy_ = false;
  std::atomic<uint64_t> dropped_;
  std::atomic<uint64_t> written_;
};

}  // namespace

extern "C" {

void* sphio_writer_create() { return new AsyncWriter(); }

void sphio_writer_destroy(void* w) { delete static_cast<AsyncWriter*>(w); }

void sphio_writer_enqueue(void* w, const char* path, const char* data,
                          uint64_t len, int append) {
  static_cast<AsyncWriter*>(w)->enqueue(path, data, len, append != 0);
}

void sphio_writer_flush(void* w) { static_cast<AsyncWriter*>(w)->flush(); }

uint64_t sphio_writer_dropped(void* w) {
  return static_cast<AsyncWriter*>(w)->dropped();
}

uint64_t sphio_writer_written(void* w) {
  return static_cast<AsyncWriter*>(w)->written();
}

// ---------------------------------------------------------------------------
// Snapshot: length-prefixed named f32/i32 arrays + trailing CRC32.
// Layout: magic "SPHS" | u32 version | u32 n_arrays |
//         per array: u32 name_len | name | u32 dtype(0=f32,1=i32) |
//                    u64 byte_len | bytes
//         u32 crc32 of everything before it
// ---------------------------------------------------------------------------

struct SnapshotWriter {
  std::string buf;
};

void* sphio_snapshot_create() {
  auto* s = new SnapshotWriter();
  s->buf.append("SPHS", 4);
  uint32_t version = 1, count = 0;
  s->buf.append(reinterpret_cast<char*>(&version), 4);
  s->buf.append(reinterpret_cast<char*>(&count), 4);
  return s;
}

void sphio_snapshot_add(void* sp, const char* name, int dtype,
                        const void* data, uint64_t byte_len) {
  auto* s = static_cast<SnapshotWriter*>(sp);
  uint32_t name_len = static_cast<uint32_t>(strlen(name));
  uint32_t dt = static_cast<uint32_t>(dtype);
  s->buf.append(reinterpret_cast<char*>(&name_len), 4);
  s->buf.append(name, name_len);
  s->buf.append(reinterpret_cast<char*>(&dt), 4);
  s->buf.append(reinterpret_cast<char*>(&byte_len), 8);
  s->buf.append(static_cast<const char*>(data), byte_len);
  uint32_t* count = reinterpret_cast<uint32_t*>(&s->buf[8]);
  ++*count;
}

int sphio_snapshot_finish(void* sp, const char* path) {
  auto* s = static_cast<SnapshotWriter*>(sp);
  uint32_t crc = crc32_update(
      0, reinterpret_cast<const uint8_t*>(s->buf.data()), s->buf.size());
  s->buf.append(reinterpret_cast<char*>(&crc), 4);
  std::string tmp = std::string(path) + ".tmp";
  FILE* f = fopen(tmp.c_str(), "wb");
  if (!f) {
    delete s;
    return -1;
  }
  size_t n = fwrite(s->buf.data(), 1, s->buf.size(), f);
  fclose(f);
  int ok = (n == s->buf.size()) ? rename(tmp.c_str(), path) : -1;
  delete s;
  return ok;
}

int sphio_snapshot_verify(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  if (size < 16) {
    fclose(f);
    return -2;
  }
  std::vector<uint8_t> buf(size);
  if (fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
    fclose(f);
    return -3;
  }
  fclose(f);
  uint32_t stored;
  memcpy(&stored, buf.data() + size - 4, 4);
  uint32_t actual = crc32_update(0, buf.data(), size - 4);
  return stored == actual ? 0 : -4;
}

}  // extern "C"
