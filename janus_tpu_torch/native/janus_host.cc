// janus_host: native host-runtime primitives for the serving path.
//
// The reference's runtime concurrency was Python queue.Queue + threads
// (reference: backend/services/engine.py:428-436); at hundreds of
// concurrent sessions per host those queues and the byte-wise framing
// become measurable CPU overhead on the feeding path. This library
// provides the three hot host-side primitives as lock-free/branch-light
// C++ with a plain C ABI consumed via ctypes:
//
//   - SPSC ring buffer for float32 audio chunks (producer: capture/socket
//     thread; consumer: batching engine)
//   - streaming length-prefix deframer (4-byte big-endian, matching the
//     wire format of backend/services/link_simulator.py:87-96)
//   - token-bucket pacer for the 300 bps link (returns the sleep the
//     caller owes; never blocks inside the library)
//
// Built at first use by janus_tpu_torch/native/__init__.py with
//   g++ -O3 -std=c++17 -fPIC -Wall -Wextra -shared
// into build/janus_tpu_torch/libjanus_host.so.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// SPSC float ring buffer
// ---------------------------------------------------------------------------

struct RingBuffer {
  std::vector<float> data;
  uint64_t capacity;
  std::atomic<uint64_t> head;  // write position (producer)
  std::atomic<uint64_t> tail;  // read position (consumer)
};

RingBuffer* rb_create(uint64_t capacity) {
  auto* rb = new RingBuffer();
  rb->data.resize(capacity);
  rb->capacity = capacity;
  rb->head.store(0, std::memory_order_relaxed);
  rb->tail.store(0, std::memory_order_relaxed);
  return rb;
}

void rb_destroy(RingBuffer* rb) { delete rb; }

uint64_t rb_size(const RingBuffer* rb) {
  return rb->head.load(std::memory_order_acquire) -
         rb->tail.load(std::memory_order_acquire);
}

uint64_t rb_capacity(const RingBuffer* rb) { return rb->capacity; }

// Returns samples actually written (0 if not enough space for all-or-none).
uint64_t rb_push(RingBuffer* rb, const float* src, uint64_t n) {
  const uint64_t head = rb->head.load(std::memory_order_relaxed);
  const uint64_t tail = rb->tail.load(std::memory_order_acquire);
  if (rb->capacity - (head - tail) < n) return 0;  // all-or-none
  const uint64_t start = head % rb->capacity;
  const uint64_t first = std::min(n, rb->capacity - start);
  std::memcpy(rb->data.data() + start, src, first * sizeof(float));
  if (n > first) std::memcpy(rb->data.data(), src + first, (n - first) * sizeof(float));
  rb->head.store(head + n, std::memory_order_release);
  return n;
}

// Returns samples actually read (0 if fewer than n available).
uint64_t rb_pop(RingBuffer* rb, float* dst, uint64_t n) {
  const uint64_t tail = rb->tail.load(std::memory_order_relaxed);
  const uint64_t head = rb->head.load(std::memory_order_acquire);
  if (head - tail < n) return 0;
  const uint64_t start = tail % rb->capacity;
  const uint64_t first = std::min(n, rb->capacity - start);
  std::memcpy(dst, rb->data.data() + start, first * sizeof(float));
  if (n > first) std::memcpy(dst + first, rb->data.data(), (n - first) * sizeof(float));
  rb->tail.store(tail + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------------
// Streaming length-prefix deframer (4-byte big-endian headers)
// ---------------------------------------------------------------------------

struct Deframer {
  std::vector<uint8_t> buf;
  uint64_t pos = 0;  // consumed prefix
};

Deframer* dfr_create() { return new Deframer(); }
void dfr_destroy(Deframer* d) { delete d; }

void dfr_feed(Deframer* d, const uint8_t* bytes, uint64_t n) {
  // compact occasionally so the buffer doesn't grow unboundedly
  if (d->pos > 0 && d->pos == d->buf.size()) {
    d->buf.clear();
    d->pos = 0;
  } else if (d->pos > (1u << 20)) {
    d->buf.erase(d->buf.begin(), d->buf.begin() + d->pos);
    d->pos = 0;
  }
  d->buf.insert(d->buf.end(), bytes, bytes + n);
}

// Peek length of the next complete packet, or -1 if incomplete.
int64_t dfr_next_len(const Deframer* d) {
  const uint64_t avail = d->buf.size() - d->pos;
  if (avail < 4) return -1;
  const uint8_t* p = d->buf.data() + d->pos;
  const uint64_t len = (uint64_t(p[0]) << 24) | (uint64_t(p[1]) << 16) |
                       (uint64_t(p[2]) << 8) | uint64_t(p[3]);
  if (avail < 4 + len) return -1;
  return (int64_t)len;
}

// Copy next packet into dst (must hold dfr_next_len bytes); returns its
// length, or -1 if no complete packet buffered.
int64_t dfr_pop(Deframer* d, uint8_t* dst, uint64_t cap) {
  const int64_t len = dfr_next_len(d);
  if (len < 0 || (uint64_t)len > cap) return -1;
  std::memcpy(dst, d->buf.data() + d->pos + 4, len);
  d->pos += 4 + len;
  return len;
}

// ---------------------------------------------------------------------------
// Token-bucket pacer
// ---------------------------------------------------------------------------

struct Pacer {
  double bytes_per_second;
  double available;     // tokens (bytes)
  double burst;         // max tokens
  double last_time;     // caller-provided monotonic seconds
};

Pacer* pacer_create(double bytes_per_second, double burst_bytes) {
  auto* p = new Pacer();
  p->bytes_per_second = bytes_per_second;
  p->burst = burst_bytes;
  p->available = burst_bytes;
  p->last_time = -1.0;
  return p;
}

void pacer_destroy(Pacer* p) { delete p; }

// Account `n` bytes at monotonic time `now`; returns seconds the caller
// must sleep before sending (0 when within budget).
double pacer_acquire(Pacer* p, uint64_t n, double now) {
  if (p->last_time >= 0.0) {
    p->available += (now - p->last_time) * p->bytes_per_second;
    if (p->available > p->burst) p->available = p->burst;
  }
  p->last_time = now;
  p->available -= (double)n;
  if (p->available >= 0.0) return 0.0;
  return -p->available / p->bytes_per_second;
}

}  // extern "C"
