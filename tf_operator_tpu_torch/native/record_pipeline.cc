// Source note: the port's copy of tf_operator_tpu/native/record_pipeline.cc, the JAX
// package's host C++, unchanged below this note and with the same C ABI.
// It is host code, not a TPU kernel, so it has no CUDA counterpart: the
// port builds it with g++ (native/__init__.py::load_library) into
// native/_build/ and binds it with ctypes (native/pipeline.py).
//
// Threaded prefetching record loader — the framework's native data plane.
//
// Role: the host-side input pipeline that keeps a TPU fed (HBM is idle while
// the host blocks on IO; the reference delegates this entirely to
// tf.data inside the user's container — SURVEY.md notes the repo itself has
// zero native code, so this is a capability the rebuild adds with real
// C++ rather than a Python thread pool throttled by the GIL).
//
// Semantics:
//  - a file of fixed-size records (n = file_size / record_bytes)
//  - epochs iterate every record exactly once; optional per-epoch
//    Fisher-Yates shuffle from a splitmix64/xorshift PRNG seeded by
//    (seed, epoch) => deterministic given the seed
//  - multi-host sharding: all shards compute the SAME epoch order, then
//    shard k consumes positions k, k+num_shards, ..., truncated to the
//    common floor(n / num_shards) length — shards are disjoint and all
//    exactly equal-sized (lockstep hosts), the <num_shards remainder is
//    dropped for the epoch, and the shuffle re-deals between epochs
//  - worker threads pread() record runs into batch slots; a bounded ring
//    of filled slots decouples producers from the consumer
//  - dp_next() hands back one batch (blocking), in batch order
//  - loop=0: one epoch then EOF (0 return); loop=1: epochs forever
//
// C ABI (ctypes-friendly); thread-safe for one consumer.

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct Prng {
  uint64_t s;
  explicit Prng(uint64_t seed) : s(seed ^ 0x9e3779b97f4a7c15ULL) {}
  uint64_t next() {
    // splitmix64
    uint64_t z = (s += 0x9e3779b97f4a7c15ULL);
    z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ULL;
    z = (z ^ (z >> 27)) * 0x94d049bb133111ebULL;
    return z ^ (z >> 31);
  }
  // unbiased bounded draw (Lemire)
  uint64_t bounded(uint64_t n) { return n ? next() % n : 0; }
};

struct Batch {
  std::vector<char> data;
  uint64_t records = 0;
  uint64_t seq = 0;
};

// One definition of the epoch order (identity + optional Fisher-Yates +
// equal-size strided shard slice), shared by the in-engine reshuffle and
// the standalone dp_epoch_order export so the two can never drift.
std::vector<uint64_t> compute_epoch_order(uint64_t num_records, uint64_t seed,
                                          uint64_t epoch, bool shuffle,
                                          uint64_t shard_id,
                                          uint64_t num_shards) {
  std::vector<uint64_t> order(num_records);
  for (uint64_t i = 0; i < num_records; i++) order[i] = i;
  if (shuffle && num_records > 1) {
    Prng rng(seed * 1000003ULL + epoch);
    for (uint64_t i = num_records - 1; i > 0; i--) {
      uint64_t j = rng.bounded(i + 1);
      std::swap(order[i], order[j]);
    }
  }
  if (num_shards > 1) {
    std::vector<uint64_t> mine;
    uint64_t keep = num_records / num_shards;  // equal-size shards
    for (uint64_t i = shard_id; i < order.size() && mine.size() < keep;
         i += num_shards)
      mine.push_back(order[i]);
    order = std::move(mine);
  }
  return order;
}

struct Pipeline {
  int fd = -1;
  uint64_t record_bytes = 0;
  uint64_t batch = 0;
  uint64_t num_records = 0;
  bool shuffle = false;
  bool loop = false;
  uint64_t seed = 0;
  uint64_t shard_id = 0;
  uint64_t num_shards = 1;

  // work assignment
  std::vector<uint64_t> order;   // record indices for the current epoch
  uint64_t epoch = 0;
  uint64_t next_batch_to_claim = 0;   // producer cursor (batch index in epoch)
  uint64_t batches_per_epoch = 0;

  // slot ring (filled batches, delivered in seq order)
  std::vector<Batch> ring;
  uint64_t capacity = 0;
  uint64_t next_seq_to_produce = 0;   // global batch sequence
  uint64_t next_seq_to_consume = 0;
  std::vector<bool> filled;

  std::mutex mu;
  std::condition_variable cv_produce;
  std::condition_variable cv_consume;
  std::atomic<bool> stop{false};
  bool io_error = false;
  std::vector<std::thread> workers;

  void reshuffle_locked() {
    order = compute_epoch_order(num_records, seed, epoch, shuffle,
                                shard_id, num_shards);
  }

  // Claim the next batch of this epoch (or roll the epoch / signal done).
  // Returns false when there is no more work forever.
  bool claim(uint64_t* seq_out, std::vector<uint64_t>* records_out) {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      if (stop.load()) return false;
      if (next_batch_to_claim < batches_per_epoch) {
        uint64_t b = next_batch_to_claim++;
        uint64_t lo = b * batch;
        uint64_t hi = std::min((uint64_t)order.size(), lo + batch);
        records_out->assign(order.begin() + lo, order.begin() + hi);
        *seq_out = next_seq_to_produce++;
        return true;
      }
      if (!loop) {
        return false;
      }
      epoch++;
      reshuffle_locked();
      next_batch_to_claim = 0;
    }
  }

  void worker() {
    std::vector<uint64_t> recs;
    uint64_t seq;
    while (claim(&seq, &recs)) {
      // Wait for the ring slot BEFORE reading, then pread straight into the
      // slot's preallocated buffer. The previous shape (read into a fresh
      // vector, move into the ring, shrink_to_fit on consume) paid a 62 MB
      // malloc + zero-page faulting + free on EVERY batch at bench shapes —
      // the dominant cost of the single-core loader. Slot exclusivity: seq
      // values are unique and the window admits at most one in-flight seq
      // per slot (window size == capacity).
      {
        std::unique_lock<std::mutex> lk(mu);
        cv_produce.wait(lk, [&] {
          return stop.load() || seq < next_seq_to_consume + capacity;
        });
        if (stop.load()) return;
      }
      Batch& b = ring[seq % capacity];
      b.seq = seq;
      b.records = recs.size();
      bool ok = true;
      for (size_t i = 0; i < recs.size(); i++) {
        ssize_t got = pread(fd, b.data.data() + i * record_bytes,
                            record_bytes, (off_t)(recs[i] * record_bytes));
        if (got != (ssize_t)record_bytes) { ok = false; break; }
      }
      std::unique_lock<std::mutex> lk(mu);
      if (stop.load()) return;
      if (!ok) { io_error = true; cv_consume.notify_all(); return; }
      filled[seq % capacity] = true;
      cv_consume.notify_all();
    }
    // No more work (non-loop EOF or stop): the consumer detects EOF from
    // next_seq_to_consume >= batches_per_epoch, no flag needed.
  }
};

}  // namespace

extern "C" {

void* dp_open(const char* path, uint64_t record_bytes, uint64_t batch,
              uint64_t prefetch, uint64_t threads, uint64_t seed,
              int shuffle, int loop, uint64_t shard_id,
              uint64_t num_shards) {
  if (record_bytes == 0 || batch == 0) return nullptr;
  if (num_shards == 0 || shard_id >= num_shards) return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size <= 0 ||
      (uint64_t)st.st_size % record_bytes != 0) {
    close(fd);
    return nullptr;
  }
  auto* p = new Pipeline();
  p->fd = fd;
  p->record_bytes = record_bytes;
  p->batch = batch;
  p->num_records = (uint64_t)st.st_size / record_bytes;
  p->shuffle = shuffle != 0;
  p->loop = loop != 0;
  p->seed = seed;
  p->shard_id = shard_id;
  p->num_shards = num_shards;
  // Equal-size shards: every shard gets exactly floor(n / num_shards)
  // records per epoch (lockstep multi-host contract).
  uint64_t mine = p->num_records / num_shards;
  if (mine == 0) {  // empty shard: more shards than records
    close(fd);
    delete p;
    return nullptr;
  }
  p->batches_per_epoch = (mine + batch - 1) / batch;
  p->capacity = prefetch ? prefetch : 4;
  p->ring.resize(p->capacity);
  for (auto& slot : p->ring) slot.data.resize(batch * record_bytes);
  p->filled.assign(p->capacity, false);
  p->reshuffle_locked();
  uint64_t n_threads = threads ? threads : 2;
  for (uint64_t i = 0; i < n_threads; i++)
    p->workers.emplace_back(&Pipeline::worker, p);
  return p;
}

// Blocks for the next batch. Returns number of records copied into out
// (record_bytes each), 0 on EOF, -1 on error/undersized buffer.
int64_t dp_next(void* handle, char* out, uint64_t out_bytes) {
  auto* p = static_cast<Pipeline*>(handle);
  if (!p) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  if (!p->loop && p->next_seq_to_consume >= p->batches_per_epoch)
    return 0;  // clean EOF: every batch of the single epoch was consumed
  p->cv_consume.wait(lk, [&] {
    return p->stop.load() || p->io_error ||
           p->filled[p->next_seq_to_consume % p->capacity];
  });
  if (p->stop.load() || p->io_error) return -1;
  uint64_t slot = p->next_seq_to_consume % p->capacity;
  Batch& b = p->ring[slot];
  uint64_t bytes = b.records * p->record_bytes;
  if (bytes > out_bytes) return -1;
  std::memcpy(out, b.data.data(), bytes);
  int64_t n = (int64_t)b.records;
  p->filled[slot] = false;
  p->next_seq_to_consume++;
  p->cv_produce.notify_all();
  return n;
}

// Epoch order as a standalone export: the Python-side MMapRecordPipeline
// (and any gather-style consumer) needs the same order the in-engine
// shuffle produces, and the interpreter's Fisher-Yates loop is ~1000x
// slower at million-record scale. Writes min(out_len, shard length)
// indices; returns the shard length, or -1 on bad args.
int64_t dp_epoch_order(uint64_t num_records, uint64_t seed, uint64_t epoch,
                       int shuffle, uint64_t shard_id, uint64_t num_shards,
                       uint64_t* out, uint64_t out_len) {
  if (!out || num_shards == 0 || shard_id >= num_shards) return -1;
  std::vector<uint64_t> order = compute_epoch_order(
      num_records, seed, epoch, shuffle != 0, shard_id, num_shards);
  std::memcpy(out, order.data(),
              std::min(out_len, (uint64_t)order.size()) * sizeof(uint64_t));
  return (int64_t)order.size();
}

uint64_t dp_num_records(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  return p ? p->num_records : 0;
}

uint64_t dp_batches_per_epoch(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  return p ? p->batches_per_epoch : 0;
}

void dp_close(void* handle) {
  auto* p = static_cast<Pipeline*>(handle);
  if (!p) return;
  p->stop.store(true);
  p->cv_produce.notify_all();
  p->cv_consume.notify_all();
  for (auto& t : p->workers) t.join();
  close(p->fd);
  delete p;
}

}  // extern "C"
