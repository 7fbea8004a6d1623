// POSIX shared-memory SPSC ring: the transport of the process pool on
// shared memory (petastorm_tpu_torch; its own copy of the JAX package's
// native/src/shm_ring.cc).
//
// One producer process, one consumer process, variable-size messages in an
// mmapped ring, C++11 atomics for the head/tail handshake, a short spin and
// then 0.2 ms naps while waiting.
//
// Layout of the segment:
//   [ PsttRingHeader (one 4 KiB page) | data bytes (capacity) ]
// head/tail are monotonically increasing byte offsets (mod capacity for
// indexing). Messages are 8-byte aligned: u32 length + payload. A length of
// 0xFFFFFFFF is a wrap marker: skip to the start of the ring.
//
// Differences from the JAX package's ring:
// - create reserves the segment's pages (posix_fallocate, or writing them
//   where the filesystem cannot fallocate). A ring sized with ftruncate
//   alone is sparse: on a full /dev/shm the first write past the free
//   space kills the writer with SIGBUS. Here creation fails with ENOSPC.
// - a tagged message (one tag byte, then the payload) can be peeked for its
//   tag and popped without its tag into a caller's buffer at any offset, so
//   the consumer assembles a chunked payload with one copy.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t kMagic = 0x7073747452494e47ULL;  // "psttRING"
constexpr uint32_t kWrapMarker = 0xFFFFFFFFu;
constexpr size_t kHeaderSize = 4096;
// Modest spin before napping: high spin counts starve peers on low-core
// hosts (the transport is memcpy-bound, not latency-bound).
constexpr int kSpinIters = 64;

struct PsttRingHeader {
  uint64_t magic;
  uint64_t capacity;
  alignas(64) std::atomic<uint64_t> head;  // producer cursor
  alignas(64) std::atomic<uint64_t> tail;  // consumer cursor
  alignas(64) std::atomic<uint32_t> flags;  // control word, either side sets it
  std::atomic<uint32_t> producer_closed;
};

struct PsttRing {
  PsttRingHeader* hdr;
  uint8_t* data;
  size_t map_size;
};

inline uint64_t align8(uint64_t v) { return (v + 7) & ~7ULL; }

void nap() {
  struct timespec ts {0, 200000};  // 0.2 ms
  nanosleep(&ts, nullptr);
}

// timeout_ms < 0 means forever.
struct Deadline {
  explicit Deadline(int timeout_ms) : forever(timeout_ms < 0) {
    if (!forever) {
      clock_gettime(CLOCK_MONOTONIC, &end);
      end.tv_sec += timeout_ms / 1000;
      end.tv_nsec += (timeout_ms % 1000) * 1000000L;
      if (end.tv_nsec >= 1000000000L) {
        end.tv_sec += 1;
        end.tv_nsec -= 1000000000L;
      }
    }
  }
  bool expired() const {
    if (forever) return false;
    struct timespec now;
    clock_gettime(CLOCK_MONOTONIC, &now);
    if (now.tv_sec != end.tv_sec) return now.tv_sec > end.tv_sec;
    return now.tv_nsec >= end.tv_nsec;
  }
  bool forever;
  struct timespec end;
};

// Make every page of fd's first `total` bytes resident: an error, not a
// SIGBUS later, when the filesystem is short of space. Returns 0 or errno.
int reserve(int fd, size_t total) {
  int rc = posix_fallocate(fd, 0, total);
  if (rc != EOPNOTSUPP && rc != EINVAL) return rc;
  static const char zeros[4096] = {0};
  for (size_t off = 0; off < total; off += sizeof(zeros)) {
    size_t n = total - off < sizeof(zeros) ? total - off : sizeof(zeros);
    if (pwrite(fd, zeros, n, off) != static_cast<ssize_t>(n)) return errno ? errno : EIO;
  }
  return 0;
}

}  // namespace

extern "C" {

enum PsttRingError {
  PSTT_RING_OK = 0,
  PSTT_RING_ERR_SYS = -1,       // errno-level failure
  PSTT_RING_ERR_ARGS = -2,
  PSTT_RING_ERR_TIMEOUT = -3,
  PSTT_RING_ERR_CLOSED = -4,    // producer closed and ring drained, or flag set
  PSTT_RING_ERR_TOO_BIG = -5,   // message larger than capacity/2
  PSTT_RING_ERR_AGAIN = -6,     // nothing available right now
  PSTT_RING_ERR_CAPACITY = -7,  // caller buffer too small
};

// A new ring of `capacity` data bytes, its pages reserved. On failure
// returns null with the errno in *err.
PsttRing* pstt_ring_create(const char* name, uint64_t capacity, int* err) {
  *err = 0;
  if (!name || capacity < 4096) {
    *err = EINVAL;
    return nullptr;
  }
  capacity = align8(capacity);
  shm_unlink(name);  // stale segment of a crashed run
  int fd = shm_open(name, O_CREAT | O_EXCL | O_RDWR, 0600);
  if (fd < 0) {
    *err = errno;
    return nullptr;
  }
  size_t total = kHeaderSize + capacity;
  int rc = ftruncate(fd, total) != 0 ? errno : reserve(fd, total);
  if (rc != 0) {
    *err = rc;
    close(fd);
    shm_unlink(name);
    return nullptr;
  }
  void* mem = mmap(nullptr, total, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  if (mem == MAP_FAILED) *err = errno;
  close(fd);
  if (mem == MAP_FAILED) {
    shm_unlink(name);
    return nullptr;
  }
  auto* hdr = new (mem) PsttRingHeader();
  hdr->capacity = capacity;
  hdr->head.store(0, std::memory_order_relaxed);
  hdr->tail.store(0, std::memory_order_relaxed);
  hdr->flags.store(0, std::memory_order_relaxed);
  hdr->producer_closed.store(0, std::memory_order_relaxed);
  hdr->magic = kMagic;  // set last: openers validate
  PsttRing* ring = new PsttRing();
  ring->hdr = hdr;
  ring->data = static_cast<uint8_t*>(mem) + kHeaderSize;
  ring->map_size = total;
  return ring;
}

PsttRing* pstt_ring_open(const char* name) {
  if (!name) return nullptr;
  int fd = shm_open(name, O_RDWR, 0600);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || static_cast<size_t>(st.st_size) <= kHeaderSize) {
    close(fd);
    return nullptr;
  }
  void* mem = mmap(nullptr, st.st_size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  if (mem == MAP_FAILED) return nullptr;
  auto* hdr = static_cast<PsttRingHeader*>(mem);
  if (hdr->magic != kMagic || kHeaderSize + hdr->capacity != static_cast<uint64_t>(st.st_size)) {
    munmap(mem, st.st_size);
    return nullptr;
  }
  PsttRing* ring = new PsttRing();
  ring->hdr = hdr;
  ring->data = static_cast<uint8_t*>(mem) + kHeaderSize;
  ring->map_size = st.st_size;
  return ring;
}

void pstt_ring_close(PsttRing* ring) {
  if (!ring) return;
  munmap(ring->hdr, ring->map_size);
  delete ring;
}

int pstt_ring_unlink(const char* name) {
  return shm_unlink(name) == 0 ? PSTT_RING_OK : PSTT_RING_ERR_SYS;
}

// --------------------------------------------------------------- producer

// One message: the tag byte (when has_tag) then len bytes of data.
int pstt_ring_write(PsttRing* ring, int has_tag, uint8_t tag, const uint8_t* data, uint64_t len,
                    int timeout_ms) {
  if (!ring || (!data && len)) return PSTT_RING_ERR_ARGS;
  PsttRingHeader* h = ring->hdr;
  const uint64_t cap = h->capacity;
  const uint64_t total = (has_tag ? 1 : 0) + len;
  const uint64_t need = align8(4 + total);
  if (need > cap / 2) return PSTT_RING_ERR_TOO_BIG;

  Deadline deadline(timeout_ms);
  int spins = 0;
  for (;;) {
    uint64_t head = h->head.load(std::memory_order_relaxed);
    uint64_t tail = h->tail.load(std::memory_order_acquire);
    uint64_t idx = head % cap;
    uint64_t contiguous = cap - idx;
    // Reserve a wrap marker's worth when the message does not fit at the end.
    uint64_t effective_need = contiguous >= need ? need : contiguous + need;
    if (cap - (head - tail) >= effective_need) {
      if (contiguous < need) {
        if (contiguous >= 4) memcpy(ring->data + idx, &kWrapMarker, 4);
        head += contiguous;
        idx = 0;
      }
      uint32_t len32 = static_cast<uint32_t>(total);
      memcpy(ring->data + idx, &len32, 4);
      uint8_t* out = ring->data + idx + 4;
      if (has_tag) *out++ = tag;
      if (len) memcpy(out, data, len);
      h->head.store(head + need, std::memory_order_release);
      return PSTT_RING_OK;
    }
    // The control flag (the FINISHED broadcast): abort instead of blocking
    // on a full ring nobody will drain.
    if (h->flags.load(std::memory_order_relaxed) != 0) return PSTT_RING_ERR_CLOSED;
    if (++spins < kSpinIters) continue;
    if (deadline.expired()) return PSTT_RING_ERR_TIMEOUT;
    nap();
  }
}

void pstt_ring_mark_closed(PsttRing* ring) {
  if (ring) ring->hdr->producer_closed.store(1, std::memory_order_release);
}

// --------------------------------------------------------------- consumer

// Length of the next message, or AGAIN/CLOSED. Advances past wrap markers.
int pstt_ring_peek(PsttRing* ring, uint64_t* len_out) {
  if (!ring || !len_out) return PSTT_RING_ERR_ARGS;
  PsttRingHeader* h = ring->hdr;
  const uint64_t cap = h->capacity;
  for (;;) {
    uint64_t tail = h->tail.load(std::memory_order_relaxed);
    uint64_t head = h->head.load(std::memory_order_acquire);
    if (head == tail) {
      if (h->producer_closed.load(std::memory_order_acquire)) {
        // Re-check: the producer may have written between the loads.
        if (h->head.load(std::memory_order_acquire) == tail) return PSTT_RING_ERR_CLOSED;
        continue;
      }
      return PSTT_RING_ERR_AGAIN;
    }
    uint64_t idx = tail % cap;
    uint64_t contiguous = cap - idx;
    uint32_t len32;
    if (contiguous < 4) {
      // Too small even for a wrap marker: an implicit wrap.
      h->tail.store(tail + contiguous, std::memory_order_release);
      continue;
    }
    memcpy(&len32, ring->data + idx, 4);
    if (len32 == kWrapMarker) {
      h->tail.store(tail + contiguous, std::memory_order_release);
      continue;
    }
    *len_out = len32;
    return PSTT_RING_OK;
  }
}

// Wait up to timeout_ms for a message: its length, and its first byte in
// *tag_out (0 for an empty message).
int pstt_ring_wait(PsttRing* ring, uint64_t* len_out, uint8_t* tag_out, int timeout_ms) {
  Deadline deadline(timeout_ms);
  int spins = 0;
  for (;;) {
    int rc = pstt_ring_peek(ring, len_out);
    if (rc == PSTT_RING_OK) {
      if (tag_out) {
        uint64_t idx = ring->hdr->tail.load(std::memory_order_relaxed) % ring->hdr->capacity;
        *tag_out = *len_out ? ring->data[idx + 4] : 0;
      }
      return rc;
    }
    if (rc != PSTT_RING_ERR_AGAIN) return rc;
    if (++spins < kSpinIters) continue;
    if (deadline.expired()) return PSTT_RING_ERR_TIMEOUT;
    nap();
  }
}

// Copy the next message, less its first `skip` bytes, into `out` and
// advance. Call after a wait that returned OK.
int pstt_ring_pop(PsttRing* ring, uint64_t skip, uint8_t* out, uint64_t out_capacity) {
  if (!ring) return PSTT_RING_ERR_ARGS;
  uint64_t len;
  int rc = pstt_ring_peek(ring, &len);
  if (rc != PSTT_RING_OK) return rc;
  if (skip > len || len - skip > out_capacity) return PSTT_RING_ERR_CAPACITY;
  PsttRingHeader* h = ring->hdr;
  uint64_t tail = h->tail.load(std::memory_order_relaxed);
  uint64_t idx = tail % h->capacity;
  if (len > skip) memcpy(out, ring->data + idx + 4 + skip, len - skip);
  h->tail.store(tail + align8(4 + len), std::memory_order_release);
  return PSTT_RING_OK;
}

uint64_t pstt_ring_capacity(PsttRing* ring) { return ring ? ring->hdr->capacity : 0; }

void pstt_ring_set_flags(PsttRing* ring, uint32_t flags) {
  if (ring) ring->hdr->flags.store(flags, std::memory_order_release);
}

uint32_t pstt_ring_get_flags(PsttRing* ring) {
  return ring ? ring->hdr->flags.load(std::memory_order_acquire) : 0;
}

}  // extern "C"
