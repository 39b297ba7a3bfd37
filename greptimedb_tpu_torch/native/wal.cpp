// Native WAL: segmented append log with group commit.
//
// Reference behavior: src/log-store/src/raft_engine/log_store.rs — the
// reference delegates WAL throughput to raft-engine (a native Rust log
// with batched fsync). This is the C++ twin for the host runtime (the
// port's copy of greptimedb_tpu/native/wal.cpp): many writer threads
// append under one mutex; a single group-commit thread turns N
// concurrent durability requests into one fdatasync (the classic group
// commit), with epoch tickets so writers wait only for *their* sync.
//
// On-disk format is IDENTICAL to the Python Wal (storage/wal.py):
//   segments named {first_seq:020}.wal, records
//   [len u32][crc32 u32][seq u64][schema_version u32][payload]
// so either implementation can replay the other's log.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <dirent.h>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// zlib-compatible CRC32 (slice-by-1 table; matches Python zlib.crc32)
uint32_t crc_table[256];
std::once_flag crc_once;

void init_crc() {
  for (uint32_t i = 0; i < 256; i++) {
    uint32_t c = i;
    for (int k = 0; k < 8; k++)
      c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    crc_table[i] = c;
  }
}

uint32_t crc32(const uint8_t* data, size_t len) {
  std::call_once(crc_once, init_crc);
  uint32_t c = 0xFFFFFFFFu;
  for (size_t i = 0; i < len; i++)
    c = crc_table[(c ^ data[i]) & 0xFF] ^ (c >> 8);
  return c ^ 0xFFFFFFFFu;
}

struct Wal {
  std::string dir;
  uint64_t segment_bytes;
  uint32_t group_interval_us;

  std::mutex mu;                 // guards fd/size/dirty/epoch bookkeeping
  int fd = -1;
  std::string fd_path;
  uint64_t fd_size = 0;

  // group commit state
  std::condition_variable cv;
  uint64_t requested_epoch = 0;  // bumped per append needing durability
  uint64_t synced_epoch = 0;
  bool dirty = false;
  bool stop = false;
  std::thread syncer;

  ~Wal() {
    {
      std::lock_guard<std::mutex> g(mu);
      stop = true;
    }
    cv.notify_all();
    if (syncer.joinable()) syncer.join();
    if (fd >= 0) {
      ::fdatasync(fd);
      ::close(fd);
    }
  }
};

std::string segment_name(uint64_t first_seq) {
  char buf[32];
  std::snprintf(buf, sizeof(buf), "%020llu.wal",
                (unsigned long long)first_seq);
  return std::string(buf);
}

int open_segment(Wal* w, uint64_t first_seq) {
  if (w->fd >= 0) {
    ::fdatasync(w->fd);
    ::close(w->fd);
    w->fd = -1;
  }
  std::string path = w->dir + "/" + segment_name(first_seq);
  int fd = ::open(path.c_str(), O_WRONLY | O_CREAT | O_APPEND, 0644);
  if (fd < 0) return -errno;
  struct stat st;
  if (::fstat(fd, &st) != 0) {
    int e = errno;
    ::close(fd);
    return -e;
  }
  w->fd = fd;
  w->fd_path = path;
  w->fd_size = (uint64_t)st.st_size;
  return 0;
}

// resume onto the highest existing segment (append continues there)
int resume(Wal* w) {
  DIR* d = ::opendir(w->dir.c_str());
  if (d == nullptr) return -errno;
  uint64_t best = 0;
  bool found = false;
  struct dirent* ent;
  while ((ent = ::readdir(d)) != nullptr) {
    std::string fn(ent->d_name);
    if (fn.size() == 24 && fn.substr(20) == ".wal") {
      uint64_t v = std::strtoull(fn.substr(0, 20).c_str(), nullptr, 10);
      if (!found || v > best) best = v;
      found = true;
    }
  }
  ::closedir(d);
  if (found) return open_segment(w, best);
  return 0;  // first append opens a segment
}

void sync_loop(Wal* w) {
  std::unique_lock<std::mutex> lk(w->mu);
  while (!w->stop) {
    w->cv.wait_for(lk, std::chrono::microseconds(w->group_interval_us),
                   [w] { return w->stop || w->dirty; });
    if (w->stop) break;
    if (!w->dirty) continue;
    uint64_t target = w->requested_epoch;
    int fd = w->fd;
    w->dirty = false;
    lk.unlock();
    if (fd >= 0) ::fdatasync(fd);   // ONE sync covers every waiter <= target
    lk.lock();
    if (w->synced_epoch < target) w->synced_epoch = target;
    w->cv.notify_all();
  }
}

}  // namespace

extern "C" {

void* wal_open(const char* dir, uint64_t segment_bytes,
               uint32_t group_interval_us) {
  ::mkdir(dir, 0755);  // best-effort; parents made by caller
  Wal* w = new Wal();
  w->dir = dir;
  w->segment_bytes = segment_bytes ? segment_bytes : (64ull << 20);
  w->group_interval_us = group_interval_us ? group_interval_us : 1000;
  if (resume(w) < 0) {
    delete w;
    return nullptr;
  }
  w->syncer = std::thread(sync_loop, w);
  return w;
}

// Appends one record; returns the durability ticket (epoch) to pass to
// wal_wait, or a negative errno.
int64_t wal_append(void* h, uint64_t seq, uint32_t schema_version,
                   const uint8_t* data, uint32_t len) {
  Wal* w = (Wal*)h;
  uint8_t hdr[20];
  uint32_t crc = crc32(data, len);
  std::memcpy(hdr + 0, &len, 4);
  std::memcpy(hdr + 4, &crc, 4);
  std::memcpy(hdr + 8, &seq, 8);
  std::memcpy(hdr + 16, &schema_version, 4);

  std::lock_guard<std::mutex> g(w->mu);
  if (w->fd < 0 || w->fd_size >= w->segment_bytes) {
    int rc = open_segment(w, seq);
    if (rc < 0) return rc;
  }
  // one buffer, one write syscall: records stay atomic wrt other
  // appenders (O_APPEND)
  std::vector<uint8_t> rec(20 + len);
  std::memcpy(rec.data(), hdr, 20);
  if (len) std::memcpy(rec.data() + 20, data, len);
  ssize_t n = ::write(w->fd, rec.data(), rec.size());
  if (n != (ssize_t)rec.size()) return n < 0 ? -errno : -EIO;
  w->fd_size += rec.size();
  w->dirty = true;
  uint64_t ticket = ++w->requested_epoch;
  w->cv.notify_all();
  return (int64_t)ticket;
}

// Block until the given ticket (or everything, ticket==0 → current) is
// durable. Returns 0, or -ETIMEDOUT after timeout_ms (0 = forever).
int wal_wait(void* h, int64_t ticket, uint32_t timeout_ms) {
  Wal* w = (Wal*)h;
  std::unique_lock<std::mutex> lk(w->mu);
  uint64_t target = ticket > 0 ? (uint64_t)ticket : w->requested_epoch;
  auto pred = [w, target] { return w->synced_epoch >= target; };
  if (timeout_ms == 0) {
    w->cv.wait(lk, pred);
    return 0;
  }
  if (!w->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), pred))
    return -ETIMEDOUT;
  return 0;
}

int wal_sync(void* h) {
  Wal* w = (Wal*)h;
  std::unique_lock<std::mutex> lk(w->mu);
  uint64_t target = w->requested_epoch;
  if (w->synced_epoch >= target && !w->dirty) return 0;
  int fd = w->fd;
  w->dirty = false;
  lk.unlock();
  if (fd >= 0 && ::fdatasync(fd) != 0) return -errno;
  lk.lock();
  if (w->synced_epoch < target) w->synced_epoch = target;
  w->cv.notify_all();
  return 0;
}

// Delete whole segments entirely <= seq (same rule as the Python Wal:
// a segment is deletable when the NEXT segment starts at <= seq+1 and it
// is not the active segment).
int wal_obsolete(void* h, uint64_t seq) {
  Wal* w = (Wal*)h;
  std::vector<uint64_t> firsts;
  {
    DIR* d = ::opendir(w->dir.c_str());
    if (d == nullptr) return -errno;
    struct dirent* ent;
    while ((ent = ::readdir(d)) != nullptr) {
      std::string fn(ent->d_name);
      if (fn.size() == 24 && fn.substr(20) == ".wal")
        firsts.push_back(
            std::strtoull(fn.substr(0, 20).c_str(), nullptr, 10));
    }
    ::closedir(d);
  }
  std::sort(firsts.begin(), firsts.end());
  std::lock_guard<std::mutex> g(w->mu);
  for (size_t i = 0; i + 1 < firsts.size(); i++) {
    if (firsts[i + 1] <= seq + 1) {
      std::string path = w->dir + "/" + segment_name(firsts[i]);
      if (path == w->fd_path) continue;
      ::unlink(path.c_str());
    }
  }
  return 0;
}

void wal_close(void* h) { delete (Wal*)h; }

}  // extern "C"
