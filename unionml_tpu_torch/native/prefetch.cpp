// Native batch prefetcher: multi-threaded row gathering into a ring of slots.
// The port's own copy of unionml_tpu/native/prefetch.cpp, unchanged but for
// its comments.
//
// Role: the Python training loop's per-batch work is a fancy gather (rows at
// shuffled indices copied into a contiguous batch buffer) followed by a
// host->device copy. Doing the gather in C++ worker threads overlaps it with
// the previous step's kernels and the Python loop, keeping the card fed.
//
// Model: N slots (ring buffer), each holding one batch's buffers for every source
// array. Worker threads claim batch indices in order, wait for their slot to free,
// gather rows, and mark the slot ready. The consumer (`upf_next`) takes batches in
// order and releases slots after the device copy has finished reading them.
//
//  - slot buffers are owned by PYTHON (pinned torch tensors when the loader feeds a
//    CUDA device, registered through `upf_start`), so the consumer copies the
//    gathered batch to the card with no extra host copy; the slot is released
//    only after the copy has completed.
//  - per-array dtype conversion runs INSIDE the worker threads during the gather:
//    float64->float32, int64->int32, and float32->bfloat16 (round-to-nearest-even),
//    so Python never pays element-wise conversion on the hot path.
//
// Build: g++ -O3 -shared -fPIC -pthread -std=c++17 prefetch.cpp pack.cpp
// (driven by unionml_tpu_torch/native/__init__.py; pure C ABI, consumed via ctypes).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// conversion codes (mirrored in unionml_tpu_torch/native/__init__.py)
enum Conv : long {
  kCopy = 0,      // raw memcpy
  kF64ToF32 = 1,  // float64 -> float32
  kI64ToI32 = 2,  // int64 -> int32
  kF32ToBf16 = 3, // float32 -> bfloat16 (round to nearest even)
};

inline uint16_t f32_to_bf16(float value) {
  uint32_t bits;
  std::memcpy(&bits, &value, sizeof(bits));
  // round-to-nearest-even on the dropped 16 bits; NaN stays NaN
  if ((bits & 0x7fffffffu) > 0x7f800000u) return (uint16_t)((bits >> 16) | 0x0040u);
  const uint32_t rounding = 0x7fffu + ((bits >> 16) & 1u);
  return (uint16_t)((bits + rounding) >> 16);
}

inline void convert_row(uint8_t* dst, const uint8_t* src, long src_bytes, long conv) {
  switch (conv) {
    case kCopy:
      std::memcpy(dst, src, (size_t)src_bytes);
      break;
    case kF64ToF32: {
      const long n = src_bytes / 8;
      const double* in = reinterpret_cast<const double*>(src);
      float* out = reinterpret_cast<float*>(dst);
      for (long i = 0; i < n; ++i) out[i] = (float)in[i];
      break;
    }
    case kI64ToI32: {
      const long n = src_bytes / 8;
      const int64_t* in = reinterpret_cast<const int64_t*>(src);
      int32_t* out = reinterpret_cast<int32_t*>(dst);
      for (long i = 0; i < n; ++i) out[i] = (int32_t)in[i];
      break;
    }
    case kF32ToBf16: {
      const long n = src_bytes / 4;
      const float* in = reinterpret_cast<const float*>(src);
      uint16_t* out = reinterpret_cast<uint16_t*>(dst);
      for (long i = 0; i < n; ++i) out[i] = f32_to_bf16(in[i]);
      break;
    }
  }
}

struct Slot {
  std::vector<uint8_t*> buffers;  // PYTHON-owned destination, one per source array
  long batch_idx = -1;            // which batch currently occupies the slot
  long next_fill = 0;             // the only batch allowed to fill next
  bool ready = false;
  bool in_use = false;
};

struct Prefetcher {
  std::vector<const uint8_t*> sources;
  std::vector<long> row_bytes;      // source row strides
  std::vector<long> conv;           // per-array conversion code
  std::vector<long> dst_row_bytes;  // destination row strides (post-conversion)
  long n_rows = 0;

  std::vector<long> indices;
  long n_batches = 0;
  long batch_size = 0;

  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::atomic<long> next_claim{0};
  long next_deliver = 0;

  std::mutex mu;
  std::condition_variable cv_ready;   // consumer waits for ready slots
  std::condition_variable cv_free;    // workers wait for freed slots
  bool stopping = false;

  void gather(long batch) {
    Slot& slot = slots[batch % (long)slots.size()];
    {
      std::unique_lock<std::mutex> lock(mu);
      // fill strictly in per-slot order: a worker holding batch s+k*n_slots must not
      // occupy the slot before batch s+(k-1)*n_slots has been delivered + released,
      // or the in-order consumer deadlocks
      cv_free.wait(lock, [&] { return stopping || (!slot.in_use && slot.next_fill == batch); });
      if (stopping) return;
      slot.in_use = true;
      slot.batch_idx = batch;
      slot.next_fill = batch + (long)slots.size();
      slot.ready = false;
    }
    const long* batch_indices = indices.data() + batch * batch_size;
    for (size_t a = 0; a < sources.size(); ++a) {
      const long rb = row_bytes[a];
      const long drb = dst_row_bytes[a];
      const long cv = conv[a];
      uint8_t* dst = slot.buffers[a];
      const uint8_t* src = sources[a];
      for (long r = 0; r < batch_size; ++r) {
        convert_row(dst + r * drb, src + batch_indices[r] * rb, rb, cv);
      }
    }
    {
      std::lock_guard<std::mutex> lock(mu);
      slot.ready = true;
    }
    cv_ready.notify_all();
  }

  void worker_loop() {
    while (true) {
      long batch = next_claim.fetch_add(1);
      if (batch >= n_batches) return;
      gather(batch);
      {
        std::lock_guard<std::mutex> lock(mu);
        if (stopping) return;
      }
    }
  }

  void stop() {
    {
      std::lock_guard<std::mutex> lock(mu);
      stopping = true;
    }
    cv_free.notify_all();
    cv_ready.notify_all();
    for (auto& t : workers) {
      if (t.joinable()) t.join();
    }
    workers.clear();
  }
};

}  // namespace

extern "C" {

// conv_codes/dst_row_bytes describe the per-array worker-side conversion; pass
// kCopy + row_bytes[i] for raw gathering.
Prefetcher* upf_create(const void** sources, const long* row_bytes, const long* conv_codes,
                       const long* dst_row_bytes, long n_arrays, long n_rows) {
  auto* p = new Prefetcher();
  p->n_rows = n_rows;
  for (long i = 0; i < n_arrays; ++i) {
    p->sources.push_back(static_cast<const uint8_t*>(sources[i]));
    p->row_bytes.push_back(row_bytes[i]);
    p->conv.push_back(conv_codes[i]);
    p->dst_row_bytes.push_back(dst_row_bytes[i]);
  }
  return p;
}

// Begin an epoch. `indices` must stay valid until the epoch completes.
// `slot_buffers` is a row-major [n_slots][n_arrays] table of PYTHON-owned
// destination pointers (each sized batch_size * dst_row_bytes[a]); they must stay
// alive until upf_destroy or the next upf_start.
void upf_start(Prefetcher* p, const long* indices, long n_batches, long batch_size,
               long n_slots, long n_threads, void** slot_buffers) {
  p->stop();
  p->indices.assign(indices, indices + n_batches * batch_size);
  p->n_batches = n_batches;
  p->batch_size = batch_size;
  p->next_claim.store(0);
  p->next_deliver = 0;
  p->stopping = false;

  p->slots.assign((size_t)n_slots, Slot{});
  const size_t n_arrays = p->sources.size();
  for (long s = 0; s < n_slots; ++s) {
    Slot& slot = p->slots[(size_t)s];
    slot.next_fill = s;
    slot.buffers.resize(n_arrays);
    for (size_t a = 0; a < n_arrays; ++a) {
      slot.buffers[a] = static_cast<uint8_t*>(slot_buffers[s * n_arrays + a]);
    }
  }
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_slots) n_threads = n_slots;  // more would deadlock on slot waits
  for (long t = 0; t < n_threads; ++t) {
    p->workers.emplace_back([p] { p->worker_loop(); });
  }
}

// Blocks until the next in-order batch is ready. Returns the batch index (the
// consumer reads the python-owned slot buffers directly), or -1 when exhausted.
long upf_next(Prefetcher* p) {
  if (p->next_deliver >= p->n_batches) return -1;
  long batch = p->next_deliver++;
  Slot& slot = p->slots[batch % (long)p->slots.size()];
  std::unique_lock<std::mutex> lock(p->mu);
  p->cv_ready.wait(lock, [&] { return p->stopping || (slot.ready && slot.batch_idx == batch); });
  if (p->stopping) return -1;
  return batch;
}

// Release a delivered batch's slot so workers can refill it. Call only after the
// consumer no longer reads the slot buffers (e.g. the device transfer committed).
void upf_release(Prefetcher* p, long batch) {
  Slot& slot = p->slots[batch % (long)p->slots.size()];
  {
    std::lock_guard<std::mutex> lock(p->mu);
    slot.in_use = false;
    slot.ready = false;
    slot.batch_idx = -1;
  }
  p->cv_free.notify_all();
}

void upf_destroy(Prefetcher* p) {
  p->stop();
  delete p;
}

}  // extern "C"
