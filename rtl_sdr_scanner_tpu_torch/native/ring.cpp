// Lock-free single-producer/single-consumer byte ring for live IQ ingest.
//
// The reference couples its SDR read loop to the processing graph through
// GNU Radio's ring buffers (gr::sync_block work(), sdr_source.cpp:34-41).
// Here the hardware reader thread (SoapySDR readStream) and the device feeder
// decouple through this ring: the producer never blocks (overflow drops the
// newest data and counts it -- the same drop-when-full policy the reference
// applies to its MQTT queue, mqtt.cpp:52-74), the consumer reads what is
// available. Head/tail are C++11 atomics with acquire/release ordering; one
// producer thread and one consumer thread need no locks.

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Ring {
  uint8_t* buf;
  size_t capacity;  // power of two
  std::atomic<size_t> head;  // next write position (monotonic)
  std::atomic<size_t> tail;  // next read position (monotonic)
  std::atomic<unsigned long long> dropped;
};

size_t round_pow2(size_t n) {
  size_t p = 1;
  while (p < n) p <<= 1;
  return p;
}

}  // namespace

extern "C" {

void* sdr_ring_create(size_t capacity_bytes) {
  Ring* r = new (std::nothrow) Ring;
  if (!r) return nullptr;
  r->capacity = round_pow2(capacity_bytes < 64 ? 64 : capacity_bytes);
  r->buf = new (std::nothrow) uint8_t[r->capacity];
  if (!r->buf) {
    delete r;
    return nullptr;
  }
  r->head.store(0, std::memory_order_relaxed);
  r->tail.store(0, std::memory_order_relaxed);
  r->dropped.store(0, std::memory_order_relaxed);
  return r;
}

void sdr_ring_destroy(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  if (!r) return;
  delete[] r->buf;
  delete r;
}

size_t sdr_ring_capacity(void* ring) { return static_cast<Ring*>(ring)->capacity; }

size_t sdr_ring_available(void* ring) {
  Ring* r = static_cast<Ring*>(ring);
  return r->head.load(std::memory_order_acquire) - r->tail.load(std::memory_order_acquire);
}

unsigned long long sdr_ring_dropped(void* ring) {
  return static_cast<Ring*>(ring)->dropped.load(std::memory_order_relaxed);
}

// Producer side: copy as much of data as fits; excess is dropped (counted).
// Returns bytes actually written.
size_t sdr_ring_write(void* ring, const void* data, size_t n) {
  Ring* r = static_cast<Ring*>(ring);
  const size_t head = r->head.load(std::memory_order_relaxed);
  const size_t tail = r->tail.load(std::memory_order_acquire);
  const size_t free_bytes = r->capacity - (head - tail);
  const size_t to_write = n < free_bytes ? n : free_bytes;
  const uint8_t* src = static_cast<const uint8_t*>(data);

  const size_t pos = head & (r->capacity - 1);
  const size_t first = to_write < (r->capacity - pos) ? to_write : (r->capacity - pos);
  std::memcpy(r->buf + pos, src, first);
  std::memcpy(r->buf, src + first, to_write - first);

  r->head.store(head + to_write, std::memory_order_release);
  if (to_write < n) {
    r->dropped.fetch_add(n - to_write, std::memory_order_relaxed);
  }
  return to_write;
}

// Consumer side: copy up to n available bytes into out. Returns bytes read.
size_t sdr_ring_read(void* ring, void* out, size_t n) {
  Ring* r = static_cast<Ring*>(ring);
  const size_t tail = r->tail.load(std::memory_order_relaxed);
  const size_t head = r->head.load(std::memory_order_acquire);
  const size_t avail = head - tail;
  const size_t to_read = n < avail ? n : avail;
  uint8_t* dst = static_cast<uint8_t*>(out);

  const size_t pos = tail & (r->capacity - 1);
  const size_t first = to_read < (r->capacity - pos) ? to_read : (r->capacity - pos);
  std::memcpy(dst, r->buf + pos, first);
  std::memcpy(dst + first, r->buf, to_read - first);

  r->tail.store(tail + to_read, std::memory_order_release);
  return to_read;
}

}  // extern "C"
