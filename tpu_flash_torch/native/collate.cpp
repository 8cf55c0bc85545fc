// Native batch packing / prefetch loader for the MT training pipeline.
//
// The port's own copy of the JAX package's native/collate.cpp (the same
// code): a native data-loader runtime.  The reference's
// collate_batch (project/run_machine_translation.py:87-154) runs on the
// Python hot path between device steps; here a C++ worker pool packs
// src+eos+tgt+eos+pad batches with next-token labels and source-masked
// label weights into a bounded ring buffer on background threads, so host
// collation fully overlaps device execution (Python threads cannot do this
// under the GIL).
//
// Exposed as a plain C ABI consumed via ctypes
// (tpu_flash_torch/data/native_loader.py).  Tokenization stays in Python
// (tpu_flash_torch/data/bpe.py), once a corpus;
// this loader consumes pre-tokenized flat id arrays.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC collate.cpp -o libcollate.so -lpthread

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <vector>

namespace {

struct Batch {
  std::vector<int32_t> input_ids;
  std::vector<int32_t> labels;
  std::vector<float> weights;
  std::vector<int32_t> segment_ids;  // packed mode only
  std::vector<int32_t> positions;    // packed mode only
  int32_t n_examples = 0;
  bool end_of_epoch = false;
};

// One example's ids (src+eos+tgt+eos truncated to max_len) appended into a
// packed row at `off` with segment id `sid`: per-segment next-token labels,
// source-masked weights, per-example positions.  Mirrors the Python
// collate_packed (tpu_flash_torch/data/mt.py) exactly.
inline void emit_packed_example(const int32_t* ex_ids, int32_t ln,
                                int32_t n_src, int32_t off, int32_t sid,
                                int32_t pad_id, int32_t* ids, int32_t* labels,
                                float* w, int32_t* seg, int32_t* pos) {
  for (int32_t i = 0; i < ln; ++i) {
    ids[off + i] = ex_ids[i];
    labels[off + i] = (i + 1 < ln) ? ex_ids[i + 1] : pad_id;
    float wi = 1.f;
    if (i < std::min(ln, n_src - 1)) wi = 0.f;  // predicting source tokens
    if (i == ln - 1) wi = 0.f;                  // last position: no target
    w[off + i] = wi;
    seg[off + i] = sid;
    pos[off + i] = i;
  }
}

struct Loader {
  // corpus (borrowed copies — the loader owns its own storage)
  std::vector<int32_t> src_flat, tgt_flat;
  std::vector<int64_t> src_off, tgt_off;  // n+1 offsets
  int64_t n_examples = 0;

  // config
  int32_t max_len = 0, pad_id = 0, batch_size = 0;
  bool mask_padding = false;
  bool packed = false;       // sequence-packed rows (segment ids + positions)
  int32_t fixed_rows = 0;    // packed mode: static row count per batch
  mutable std::atomic<int64_t> dropped{0};  // packed examples trimmed away
  uint64_t seed = 0;

  // epoch state
  std::vector<int64_t> order;
  int64_t cursor = 0;
  uint64_t epoch = 0;

  // ring buffer
  std::queue<Batch> ring;
  size_t ring_cap = 8;
  std::mutex mu;
  std::condition_variable not_full, not_empty;
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;

  void reshuffle_locked() {
    std::mt19937_64 rng(seed + epoch);
    order.resize(n_examples);
    for (int64_t i = 0; i < n_examples; ++i) order[i] = i;
    std::shuffle(order.begin(), order.end(), rng);
    cursor = 0;
  }

  void pack_one(int64_t ex, int32_t* ids, int32_t* labels, float* w) const {
    const int64_t s0 = src_off[ex], s1 = src_off[ex + 1];
    const int64_t t0 = tgt_off[ex], t1 = tgt_off[ex + 1];
    const int32_t n_src = static_cast<int32_t>(s1 - s0);
    const int32_t n_tgt = static_cast<int32_t>(t1 - t0);
    int32_t n = 0;
    for (int64_t i = s0; i < s1 && n < max_len; ++i) ids[n++] = src_flat[i];
    for (int64_t i = t0; i < t1 && n < max_len; ++i) ids[n++] = tgt_flat[i];
    const int32_t n_real = n;
    for (; n < max_len; ++n) ids[n] = pad_id;
    for (int32_t i = 0; i + 1 < max_len; ++i) labels[i] = ids[i + 1];
    labels[max_len - 1] = pad_id;
    // weights: 0 on the source prefix (reference keeps pads at 1;
    // mask_padding additionally zeroes them)
    const int32_t zero_upto = std::min(max_len, n_src - 1);
    for (int32_t i = 0; i < max_len; ++i) {
      float wi = (i < zero_upto) ? 0.f : 1.f;
      if (mask_padding && i >= n_real) wi = 0.f;
      w[i] = wi;
    }
    (void)n_tgt;
  }

  // Packed-mode batch over the claimed examples: greedy whole-example row
  // fill, exactly fixed_rows rows (extra examples dropped, missing rows are
  // all-pad with zero weight).
  void pack_packed(const std::vector<int64_t>& claim, Batch* b) const {
    const size_t total = static_cast<size_t>(fixed_rows) * max_len;
    b->n_examples = fixed_rows;
    b->input_ids.assign(total, pad_id);
    b->labels.assign(total, pad_id);
    b->weights.assign(total, 0.f);
    b->segment_ids.assign(total, 0);
    b->positions.assign(total, 0);
    std::vector<int32_t> ex_ids;
    int32_t row = 0, off = 0, sid = 0;
    for (size_t ci = 0; ci < claim.size(); ++ci) {
      const int64_t ex = claim[ci];
      const int64_t s0 = src_off[ex], s1 = src_off[ex + 1];
      const int64_t t0 = tgt_off[ex], t1 = tgt_off[ex + 1];
      const int32_t n_src = static_cast<int32_t>(s1 - s0);
      ex_ids.clear();
      for (int64_t i = s0; i < s1 && (int32_t)ex_ids.size() < max_len; ++i)
        ex_ids.push_back(src_flat[i]);
      for (int64_t i = t0; i < t1 && (int32_t)ex_ids.size() < max_len; ++i)
        ex_ids.push_back(tgt_flat[i]);
      const int32_t ln = static_cast<int32_t>(ex_ids.size());
      if (off + ln > max_len) {           // close this row
        finish_row(b, row, off, sid);
        ++row;
        off = 0;
        sid = 0;
        if (row >= fixed_rows) {          // batch full: drop the rest
          dropped.fetch_add(static_cast<int64_t>(claim.size() - ci),
                            std::memory_order_relaxed);
          return;
        }
      }
      const int64_t base = int64_t(row) * max_len;
      emit_packed_example(ex_ids.data(), ln, n_src, off, sid, pad_id,
                          b->input_ids.data() + base,
                          b->labels.data() + base,
                          b->weights.data() + base,
                          b->segment_ids.data() + base,
                          b->positions.data() + base);
      off += ln;
      ++sid;
    }
    if (off > 0 && row < fixed_rows) finish_row(b, row, off, sid);
    // remaining rows stay all-pad/zero-weight; give their pad tails
    // arange positions + segment 0 (matches the Python collate)
    for (int32_t r = (off > 0 ? row + 1 : row); r < fixed_rows; ++r)
      finish_row(b, r, 0, 0);
  }

  // pad tail of a packed row: own segment id, arange positions
  void finish_row(Batch* b, int32_t row, int32_t off, int32_t sid) const {
    const int64_t base = int64_t(row) * max_len;
    for (int32_t i = off; i < max_len; ++i) {
      b->segment_ids[base + i] = sid;
      b->positions[base + i] = i - off;
    }
  }

  void worker_loop() {
    for (;;) {
      // claim a slice of the epoch order
      std::vector<int64_t> claim;
      {
        std::unique_lock<std::mutex> lk(mu);
        if (stop.load()) return;
        if (cursor + batch_size > n_examples) {
          ++epoch;
          reshuffle_locked();
        }
        claim.assign(order.begin() + cursor,
                     order.begin() + cursor + batch_size);
        cursor += batch_size;
      }
      Batch b;
      if (packed) {
        pack_packed(claim, &b);
      } else {
      b.n_examples = batch_size;
      b.input_ids.resize(static_cast<size_t>(batch_size) * max_len);
      b.labels.resize(static_cast<size_t>(batch_size) * max_len);
      b.weights.resize(static_cast<size_t>(batch_size) * max_len);
      for (int32_t i = 0; i < batch_size; ++i) {
        pack_one(claim[i], b.input_ids.data() + int64_t(i) * max_len,
                 b.labels.data() + int64_t(i) * max_len,
                 b.weights.data() + int64_t(i) * max_len);
      }
      }
      {
        std::unique_lock<std::mutex> lk(mu);
        not_full.wait(lk, [&] { return ring.size() < ring_cap || stop.load(); });
        if (stop.load()) return;
        ring.push(std::move(b));
      }
      not_empty.notify_one();
    }
  }
};

}  // namespace

extern "C" {

void* loader_create(const int32_t* src_flat, const int64_t* src_off,
                    const int32_t* tgt_flat, const int64_t* tgt_off,
                    int64_t n_examples, int32_t max_len, int32_t pad_id,
                    int32_t batch_size, int32_t mask_padding, uint64_t seed,
                    int32_t n_threads, int32_t ring_capacity,
                    int32_t packed, int32_t fixed_rows) {
  auto* L = new Loader();
  L->src_flat.assign(src_flat, src_flat + src_off[n_examples]);
  L->tgt_flat.assign(tgt_flat, tgt_flat + tgt_off[n_examples]);
  L->src_off.assign(src_off, src_off + n_examples + 1);
  L->tgt_off.assign(tgt_off, tgt_off + n_examples + 1);
  L->n_examples = n_examples;
  L->max_len = max_len;
  L->pad_id = pad_id;
  L->batch_size = batch_size;
  L->mask_padding = mask_padding != 0;
  L->packed = packed != 0;
  L->fixed_rows = fixed_rows;
  L->seed = seed;
  L->ring_cap = ring_capacity > 0 ? static_cast<size_t>(ring_capacity) : 8;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->reshuffle_locked();
  }
  const int nt = n_threads > 0 ? n_threads : 2;
  for (int i = 0; i < nt; ++i)
    L->workers.emplace_back(&Loader::worker_loop, L);
  return L;
}

// Blocks until a batch is available; copies into caller-owned buffers of
// shape [batch_size, max_len]. Returns the number of examples.
int32_t loader_next(void* handle, int32_t* input_ids, int32_t* labels,
                    float* weights) {
  auto* L = static_cast<Loader*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->not_empty.wait(lk, [&] { return !L->ring.empty() || L->stop.load(); });
    if (L->stop.load() && L->ring.empty()) return 0;
    b = std::move(L->ring.front());
    L->ring.pop();
  }
  L->not_full.notify_one();
  std::memcpy(input_ids, b.input_ids.data(),
              b.input_ids.size() * sizeof(int32_t));
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
  std::memcpy(weights, b.weights.data(), b.weights.size() * sizeof(float));
  return b.n_examples;
}

// Packed-mode drain: buffers are [fixed_rows, max_len]; returns fixed_rows.
int32_t loader_next_packed(void* handle, int32_t* input_ids, int32_t* labels,
                           float* weights, int32_t* segment_ids,
                           int32_t* positions) {
  auto* L = static_cast<Loader*>(handle);
  Batch b;
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->not_empty.wait(lk, [&] { return !L->ring.empty() || L->stop.load(); });
    if (L->stop.load() && L->ring.empty()) return 0;
    b = std::move(L->ring.front());
    L->ring.pop();
  }
  L->not_full.notify_one();
  std::memcpy(input_ids, b.input_ids.data(),
              b.input_ids.size() * sizeof(int32_t));
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
  std::memcpy(weights, b.weights.data(), b.weights.size() * sizeof(float));
  std::memcpy(segment_ids, b.segment_ids.data(),
              b.segment_ids.size() * sizeof(int32_t));
  std::memcpy(positions, b.positions.data(),
              b.positions.size() * sizeof(int32_t));
  return b.n_examples;
}

// One-shot synchronous packed collation over explicit indices (test/eval
// parity path for the Python collate_packed).
void pack_batch_packed(const int32_t* src_flat, const int64_t* src_off,
                       const int32_t* tgt_flat, const int64_t* tgt_off,
                       const int64_t* indices, int32_t n, int32_t max_len,
                       int32_t pad_id, int32_t fixed_rows,
                       int32_t* input_ids, int32_t* labels, float* weights,
                       int32_t* segment_ids, int32_t* positions) {
  Loader L;
  // copy the corpus prefix that covers every referenced example
  int64_t max_ex = 0;
  for (int32_t i = 0; i < n; ++i) max_ex = std::max(max_ex, indices[i]);
  L.src_flat.assign(src_flat, src_flat + src_off[max_ex + 1]);
  L.tgt_flat.assign(tgt_flat, tgt_flat + tgt_off[max_ex + 1]);
  L.src_off.assign(src_off, src_off + max_ex + 2);
  L.tgt_off.assign(tgt_off, tgt_off + max_ex + 2);
  L.max_len = max_len;
  L.pad_id = pad_id;
  L.packed = true;
  L.fixed_rows = fixed_rows;
  std::vector<int64_t> claim(indices, indices + n);
  Batch b;
  L.pack_packed(claim, &b);
  std::memcpy(input_ids, b.input_ids.data(),
              b.input_ids.size() * sizeof(int32_t));
  std::memcpy(labels, b.labels.data(), b.labels.size() * sizeof(int32_t));
  std::memcpy(weights, b.weights.data(), b.weights.size() * sizeof(float));
  std::memcpy(segment_ids, b.segment_ids.data(),
              b.segment_ids.size() * sizeof(int32_t));
  std::memcpy(positions, b.positions.data(),
              b.positions.size() * sizeof(int32_t));
}

// Total packed examples dropped (batch overflow) since creation.
int64_t loader_dropped(void* handle) {
  return static_cast<Loader*>(handle)->dropped.load();
}

void loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  L->stop.store(true);
  L->not_full.notify_all();
  L->not_empty.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

// One-shot synchronous packing (no threads) — the collate_batch fast path
// for eval loops and tests.
void pack_batch(const int32_t* src_flat, const int64_t* src_off,
                const int32_t* tgt_flat, const int64_t* tgt_off,
                const int64_t* indices, int32_t n, int32_t max_len,
                int32_t pad_id, int32_t mask_padding, int32_t* input_ids,
                int32_t* labels, float* weights) {
  Loader L;
  // borrow-free: operate directly over the caller's arrays
  L.max_len = max_len;
  L.pad_id = pad_id;
  L.mask_padding = mask_padding != 0;
  for (int32_t i = 0; i < n; ++i) {
    const int64_t ex = indices[i];
    const int64_t s0 = src_off[ex], s1 = src_off[ex + 1];
    const int64_t t0 = tgt_off[ex], t1 = tgt_off[ex + 1];
    int32_t* ids = input_ids + int64_t(i) * max_len;
    int32_t* lb = labels + int64_t(i) * max_len;
    float* w = weights + int64_t(i) * max_len;
    const int32_t n_src = static_cast<int32_t>(s1 - s0);
    int32_t m = 0;
    for (int64_t j = s0; j < s1 && m < max_len; ++j) ids[m++] = src_flat[j];
    for (int64_t j = t0; j < t1 && m < max_len; ++j) ids[m++] = tgt_flat[j];
    const int32_t n_real = m;
    for (; m < max_len; ++m) ids[m] = pad_id;
    for (int32_t j = 0; j + 1 < max_len; ++j) lb[j] = ids[j + 1];
    lb[max_len - 1] = pad_id;
    const int32_t zero_upto = std::min(max_len, n_src - 1);
    for (int32_t j = 0; j < max_len; ++j) {
      float wj = (j < zero_upto) ? 0.f : 1.f;
      if (L.mask_padding && j >= n_real) wj = 0.f;
      w[j] = wj;
    }
  }
}

}  // extern "C"
