// The port's host library: chained block hashing, the router's radix tree
// and the KV-event queue of the C ABI, behind a plain C interface loaded
// with ctypes (dynamo_tpu_torch/native.py). It is built with the host
// compiler (c++ -O3 -std=c++17 -shared -fPIC) at first use and needs no
// header beyond the C++ standard library: XXH3-64 is written out below for
// inputs of at most 240 bytes (a block of up to 60 token ids), the lengths
// llm/tokens.py's pure-Python xxh3_64 covers.
//
// Functions (all return plain integers; no exception crosses the ABI):
//   hashing     dtn_hash_tokens, dtn_hash_token_blocks
//   radix tree  dtn_tree_new/free/clear, dtn_tree_apply_stored/removed,
//               dtn_tree_remove_worker, dtn_tree_find_matches, dtn_tree_size,
//               dtn_tree_worker_count, dtn_tree_workers, dtn_tree_dump_sizes,
//               dtn_tree_dump
//   C ABI       dynamo_tpu_llm_init/shutdown,
//               dynamo_tpu_kv_event_publish_stored/removed (what a native
//               runtime calls), dtn_kv_events_pending/drain/dropped (what
//               the Python pump reads)

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <new>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#define DTN_EXPORT extern "C" __attribute__((visibility("default")))

namespace {

// ---------------------------------------------------------------------------
// XXH3-64 with seed, inputs of 0..240 bytes
// ---------------------------------------------------------------------------

constexpr uint64_t kP64_1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP64_2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP64_3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kMx1 = 0x165667919E3779F9ULL;
constexpr uint64_t kMx2 = 0x9FB21C651E98DF25ULL;
constexpr size_t kMaxHashBytes = 240;

// XXH3's default 192-byte secret.
const uint8_t kSecret[192] = {
    0xb8, 0xfe, 0x6c, 0x39, 0x23, 0xa4, 0x4b, 0xbe, 0x7c, 0x01, 0x81, 0x2c, 0xf7, 0x21, 0xad, 0x1c,
    0xde, 0xd4, 0x6d, 0xe9, 0x83, 0x90, 0x97, 0xdb, 0x72, 0x40, 0xa4, 0xa4, 0xb7, 0xb3, 0x67, 0x1f,
    0xcb, 0x79, 0xe6, 0x4e, 0xcc, 0xc0, 0xe5, 0x78, 0x82, 0x5a, 0xd0, 0x7d, 0xcc, 0xff, 0x72, 0x21,
    0xb8, 0x08, 0x46, 0x74, 0xf7, 0x43, 0x24, 0x8e, 0xe0, 0x35, 0x90, 0xe6, 0x81, 0x3a, 0x26, 0x4c,
    0x3c, 0x28, 0x52, 0xbb, 0x91, 0xc3, 0x00, 0xcb, 0x88, 0xd0, 0x65, 0x8b, 0x1b, 0x53, 0x2e, 0xa3,
    0x71, 0x64, 0x48, 0x97, 0xa2, 0x0d, 0xf9, 0x4e, 0x38, 0x19, 0xef, 0x46, 0xa9, 0xde, 0xac, 0xd8,
    0xa8, 0xfa, 0x76, 0x3f, 0xe3, 0x9c, 0x34, 0x3f, 0xf9, 0xdc, 0xbb, 0xc7, 0xc7, 0x0b, 0x4f, 0x1d,
    0x8a, 0x51, 0xe0, 0x4b, 0xcd, 0xb4, 0x59, 0x31, 0xc8, 0x9f, 0x7e, 0xc9, 0xd9, 0x78, 0x73, 0x64,
    0xea, 0xc5, 0xac, 0x83, 0x34, 0xd3, 0xeb, 0xc3, 0xc5, 0x81, 0xa0, 0xff, 0xfa, 0x13, 0x63, 0xeb,
    0x17, 0x0d, 0xdd, 0x51, 0xb7, 0xf0, 0xda, 0x49, 0xd3, 0x16, 0x55, 0x26, 0x29, 0xd4, 0x68, 0x9e,
    0x2b, 0x16, 0xbe, 0x58, 0x7d, 0x47, 0xa1, 0xfc, 0x8f, 0xf8, 0xb8, 0xd1, 0x7a, 0xd0, 0x31, 0xce,
    0x45, 0xcb, 0x3a, 0x8f, 0x95, 0x16, 0x04, 0x28, 0xaf, 0xd7, 0xfb, 0xca, 0xbb, 0x4b, 0x40, 0x7e,
};

inline uint64_t read64(const uint8_t* p) {
  uint64_t v = 0;
  for (int i = 7; i >= 0; i--) v = (v << 8) | p[i];  // little-endian on any host
  return v;
}

inline uint32_t read32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
}

inline uint64_t rotl64(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }

inline uint32_t swap32(uint32_t x) {
  return ((x << 24) & 0xff000000U) | ((x << 8) & 0x00ff0000U) | ((x >> 8) & 0x0000ff00U) | (x >> 24);
}

inline uint64_t swap64(uint64_t x) {
  return ((uint64_t)swap32((uint32_t)x) << 32) | swap32((uint32_t)(x >> 32));
}

inline uint64_t fold64(uint64_t a, uint64_t b) {
  unsigned __int128 p = (unsigned __int128)a * b;
  return (uint64_t)p ^ (uint64_t)(p >> 64);
}

inline uint64_t xxh64_avalanche(uint64_t h) {
  h ^= h >> 33;
  h *= kP64_2;
  h ^= h >> 29;
  h *= kP64_3;
  return h ^ (h >> 32);
}

inline uint64_t xxh3_avalanche(uint64_t h) {
  h ^= h >> 37;
  h *= kMx1;
  return h ^ (h >> 32);
}

inline uint64_t rrmxmx(uint64_t h, uint64_t n) {
  h ^= rotl64(h, 49) ^ rotl64(h, 24);
  h *= kMx2;
  h ^= (h >> 35) + n;
  h *= kMx2;
  return h ^ (h >> 28);
}

inline uint64_t mix16(const uint8_t* data, const uint8_t* secret, uint64_t seed) {
  uint64_t lo = read64(data) ^ (read64(secret) + seed);
  uint64_t hi = read64(data + 8) ^ (read64(secret + 8) - seed);
  return fold64(lo, hi);
}

// XXH3_64bits_withSeed for n <= 240 (the caller checks the length).
uint64_t xxh3_64(const uint8_t* data, size_t n, uint64_t seed) {
  const uint8_t* s = kSecret;
  if (n == 0) return xxh64_avalanche(seed ^ read64(s + 56) ^ read64(s + 64));
  if (n <= 3) {
    uint32_t combined = ((uint32_t)data[0] << 16) | ((uint32_t)data[n >> 1] << 24) | data[n - 1] |
                        ((uint32_t)n << 8);
    uint64_t bitflip = (uint64_t)(read32(s) ^ read32(s + 4)) + seed;
    return xxh64_avalanche((uint64_t)combined ^ bitflip);
  }
  if (n <= 8) {
    seed ^= (uint64_t)swap32((uint32_t)seed) << 32;
    uint64_t bitflip = (read64(s + 8) ^ read64(s + 16)) - seed;
    uint64_t keyed = ((uint64_t)read32(data + n - 4) + ((uint64_t)read32(data) << 32)) ^ bitflip;
    return rrmxmx(keyed, n);
  }
  if (n <= 16) {
    uint64_t lo = read64(data) ^ ((read64(s + 24) ^ read64(s + 32)) + seed);
    uint64_t hi = read64(data + n - 8) ^ ((read64(s + 40) ^ read64(s + 48)) - seed);
    uint64_t acc = n + swap64(lo) + hi + fold64(lo, hi);
    return xxh3_avalanche(acc);
  }
  uint64_t acc = n * kP64_1;
  if (n <= 128) {
    if (n > 32) {
      if (n > 64) {
        if (n > 96) acc += mix16(data + 48, s + 96, seed) + mix16(data + n - 64, s + 112, seed);
        acc += mix16(data + 32, s + 64, seed) + mix16(data + n - 48, s + 80, seed);
      }
      acc += mix16(data + 16, s + 32, seed) + mix16(data + n - 32, s + 48, seed);
    }
    acc += mix16(data, s, seed) + mix16(data + n - 16, s + 16, seed);
    return xxh3_avalanche(acc);
  }
  for (size_t i = 0; i < 8; i++) acc += mix16(data + 16 * i, s + 16 * i, seed);
  acc = xxh3_avalanche(acc);
  for (size_t i = 8; i < n / 16; i++) acc += mix16(data + 16 * i, s + 16 * (i - 8) + 3, seed);
  acc += mix16(data + n - 16, s + 136 - 17, seed);
  return xxh3_avalanche(acc);
}

// Token ids as little-endian u32 bytes, hashed with a seed.
uint64_t hash_u32(const uint32_t* toks, size_t n, uint64_t seed) {
  uint8_t buf[kMaxHashBytes];
  for (size_t i = 0; i < n; i++) {
    buf[4 * i] = (uint8_t)toks[i];
    buf[4 * i + 1] = (uint8_t)(toks[i] >> 8);
    buf[4 * i + 2] = (uint8_t)(toks[i] >> 16);
    buf[4 * i + 3] = (uint8_t)(toks[i] >> 24);
  }
  return xxh3_64(buf, 4 * n, seed);
}

// ---------------------------------------------------------------------------
// radix tree over chained block hashes (the pure-Python RadixTree's rules)
// ---------------------------------------------------------------------------

struct Node {
  uint64_t hash = 0;
  uint64_t seq = 0;  // creation order: a snapshot lists children in it, as a Python dict iterates
  Node* parent = nullptr;
  bool is_root = false;
  std::unordered_set<uint64_t> workers;
  std::unordered_map<uint64_t, Node*> children;
};

struct Tree {
  Node root;
  std::unordered_map<uint64_t, Node*> by_hash;
  std::unordered_map<uint64_t, std::unordered_set<uint64_t>> worker_nodes;
  uint64_t next_seq = 0;

  Tree() { root.is_root = true; }
  ~Tree() { clear(); }

  void clear() {
    for (auto& kv : by_hash) delete kv.second;
    by_hash.clear();
    worker_nodes.clear();
    root.children.clear();
  }

  void apply_stored(uint64_t worker, const uint64_t* hashes, size_t n, bool has_parent, uint64_t parent_hash) {
    Node* node = &root;
    if (has_parent) {
      // An orphan chain (its parent's event was missed) is rooted, so
      // partial matching still works.
      auto it = by_hash.find(parent_hash);
      if (it != by_hash.end()) node = it->second;
    }
    for (size_t i = 0; i < n; i++) {
      uint64_t h = hashes[i];
      auto it = by_hash.find(h);
      if (it != by_hash.end()) {
        node = it->second;
      } else {
        auto cit = node->children.find(h);
        if (cit != node->children.end()) {
          node = cit->second;
        } else {
          Node* child = new Node();
          child->hash = h;
          child->seq = next_seq++;
          child->parent = node;
          node->children.emplace(h, child);
          by_hash.emplace(h, child);
          node = child;
        }
      }
      node->workers.insert(worker);
      worker_nodes[worker].insert(h);
    }
  }

  // Remove leaves no worker holds, toward the root.
  void maybe_prune(Node* node) {
    while (!node->is_root && node->workers.empty() && node->children.empty()) {
      Node* parent = node->parent;
      parent->children.erase(node->hash);
      by_hash.erase(node->hash);
      delete node;
      node = parent;
    }
  }

  void apply_removed(uint64_t worker, const uint64_t* hashes, size_t n) {
    for (size_t i = 0; i < n; i++) {
      auto it = by_hash.find(hashes[i]);
      if (it == by_hash.end()) continue;
      Node* node = it->second;
      node->workers.erase(worker);
      auto wn = worker_nodes.find(worker);
      if (wn != worker_nodes.end()) wn->second.erase(hashes[i]);
      maybe_prune(node);
    }
  }

  void remove_worker(uint64_t worker) {
    auto wn = worker_nodes.find(worker);
    if (wn == worker_nodes.end()) return;
    std::vector<uint64_t> hashes(wn->second.begin(), wn->second.end());  // pruning edits by_hash
    for (uint64_t h : hashes) {
      auto it = by_hash.find(h);
      if (it == by_hash.end()) continue;
      it->second->workers.erase(worker);
      maybe_prune(it->second);
    }
    worker_nodes.erase(worker);
  }
};

// ---------------------------------------------------------------------------
// KV events queued through the C ABI
// ---------------------------------------------------------------------------

struct CKvEvent {
  uint64_t worker_id;
  int32_t kind;  // 0 = stored, 1 = removed
  std::vector<uint64_t> hashes;
  uint64_t parent;
  int32_t has_parent;
};

std::mutex g_mu;
std::deque<CKvEvent> g_events;
size_t g_event_hashes = 0;  // hashes held by g_events
bool g_initialized = false;
uint64_t g_dropped = 0;
// Bounded: with no pump running, publishes are refused and counted rather
// than growing the queue without limit.
constexpr size_t kQueueCap = 65536;

int push_event(CKvEvent&& ev) {
  std::lock_guard<std::mutex> lock(g_mu);
  if (!g_initialized) return -1;
  if (g_events.size() >= kQueueCap) {
    g_dropped++;
    return -2;
  }
  g_event_hashes += ev.hashes.size();
  g_events.push_back(std::move(ev));
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// hashing
// ---------------------------------------------------------------------------

// xxh3_64 over n little-endian u32 ids; -1 if 4n exceeds 240 bytes.
DTN_EXPORT int dtn_hash_tokens(const uint32_t* toks, size_t n, uint64_t seed, uint64_t* out) {
  if (n * 4 > kMaxHashBytes) return -1;
  *out = hash_u32(toks, n, seed);
  return 0;
}

// Chained hashes of the n / block_size complete blocks into out; returns
// their count, or -1 if a block exceeds 240 bytes.
DTN_EXPORT long dtn_hash_token_blocks(const uint32_t* toks, size_t n, size_t block_size, uint64_t seed,
                                      uint64_t* out) {
  if (block_size == 0 || block_size * 4 > kMaxHashBytes) return -1;
  size_t blocks = n / block_size;
  uint64_t s = seed;
  for (size_t i = 0; i < blocks; i++) {
    s = hash_u32(toks + i * block_size, block_size, s);
    out[i] = s;
  }
  return (long)blocks;
}

// ---------------------------------------------------------------------------
// radix tree
// ---------------------------------------------------------------------------

DTN_EXPORT void* dtn_tree_new(void) { return new (std::nothrow) Tree(); }

DTN_EXPORT void dtn_tree_free(void* t) { delete static_cast<Tree*>(t); }

DTN_EXPORT void dtn_tree_clear(void* t) { static_cast<Tree*>(t)->clear(); }

DTN_EXPORT void dtn_tree_apply_stored(void* t, uint64_t worker, const uint64_t* hashes, size_t n, uint64_t parent,
                                      int has_parent) {
  static_cast<Tree*>(t)->apply_stored(worker, hashes, n, has_parent != 0, parent);
}

DTN_EXPORT void dtn_tree_apply_removed(void* t, uint64_t worker, const uint64_t* hashes, size_t n) {
  static_cast<Tree*>(t)->apply_removed(worker, hashes, n);
}

DTN_EXPORT void dtn_tree_remove_worker(void* t, uint64_t worker) { static_cast<Tree*>(t)->remove_worker(worker); }

DTN_EXPORT size_t dtn_tree_size(void* t) { return static_cast<Tree*>(t)->by_hash.size(); }

DTN_EXPORT size_t dtn_tree_worker_count(void* t) { return static_cast<Tree*>(t)->worker_nodes.size(); }

// Each worker's depth of the deepest matched node it holds, walking the
// chain from the root; at most cap pairs are written (cap >= the tree's
// worker count holds them all). Returns the pairs written.
DTN_EXPORT size_t dtn_tree_find_matches(void* t, const uint64_t* hashes, size_t n, int early_exit,
                                        uint64_t* workers_out, int64_t* scores_out, size_t cap) {
  Tree* tree = static_cast<Tree*>(t);
  std::unordered_map<uint64_t, int64_t> scores;
  Node* node = &tree->root;
  int64_t depth = 0;
  for (size_t i = 0; i < n; i++) {
    auto it = node->children.find(hashes[i]);
    if (it == node->children.end()) break;
    depth++;
    node = it->second;
    for (uint64_t w : node->workers) scores[w] = depth;
    if (early_exit && node->children.empty()) break;
  }
  size_t k = 0;
  for (auto& kv : scores) {
    if (k == cap) break;
    workers_out[k] = kv.first;
    scores_out[k] = kv.second;
    k++;
  }
  return k;
}

// The sorted worker ids (at most cap); returns how many were written.
DTN_EXPORT size_t dtn_tree_workers(void* t, uint64_t* out, size_t cap) {
  Tree* tree = static_cast<Tree*>(t);
  std::vector<uint64_t> ws;
  ws.reserve(tree->worker_nodes.size());
  for (auto& kv : tree->worker_nodes) ws.push_back(kv.first);
  std::sort(ws.begin(), ws.end());
  size_t k = std::min(cap, ws.size());
  std::copy(ws.begin(), ws.begin() + k, out);
  return k;
}

// The snapshot's record count and the workers summed over its records.
DTN_EXPORT void dtn_tree_dump_sizes(void* t, size_t* records, size_t* workers) {
  Tree* tree = static_cast<Tree*>(t);
  size_t w = 0;
  for (auto& kv : tree->by_hash) w += kv.second->workers.size();
  *records = tree->by_hash.size();
  *workers = w;
}

// Snapshot records (hash, parent or none, sorted workers), parents before
// children, into arrays sized by dtn_tree_dump_sizes: record i's workers
// are workers[sum(n_workers[:i]) : sum(n_workers[:i + 1])]. The order is
// the pure-Python tree's (a stack, children in creation order), so both
// trees' snapshots are the same bytes.
DTN_EXPORT void dtn_tree_dump(void* t, uint64_t* hashes, uint64_t* parents, int32_t* has_parent, uint32_t* n_workers,
                              uint64_t* workers) {
  Tree* tree = static_cast<Tree*>(t);
  std::vector<Node*> stack{&tree->root};
  size_t r = 0, w = 0;
  while (!stack.empty()) {
    Node* node = stack.back();
    stack.pop_back();
    std::vector<Node*> kids;
    kids.reserve(node->children.size());
    for (auto& kv : node->children) kids.push_back(kv.second);
    std::sort(kids.begin(), kids.end(), [](const Node* a, const Node* b) { return a->seq < b->seq; });
    for (Node* child : kids) {
      hashes[r] = child->hash;
      parents[r] = node->is_root ? 0 : node->hash;
      has_parent[r] = node->is_root ? 0 : 1;
      std::vector<uint64_t> ws(child->workers.begin(), child->workers.end());
      std::sort(ws.begin(), ws.end());
      n_workers[r] = (uint32_t)ws.size();
      std::copy(ws.begin(), ws.end(), workers + w);
      w += ws.size();
      r++;
      stack.push_back(child);
    }
  }
}

// ---------------------------------------------------------------------------
// C ABI: KV events from a native runtime (called without the GIL; events
// wait in a mutex-guarded queue until the Python pump drains them)
// ---------------------------------------------------------------------------

// 0 on success; idempotent.
DTN_EXPORT int dynamo_tpu_llm_init(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_initialized = true;
  return 0;
}

DTN_EXPORT int dynamo_tpu_llm_shutdown(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  g_initialized = false;
  g_events.clear();
  g_event_hashes = 0;
  return 0;
}

// hashes: n chained block hashes; parent: the hash of the block before
// hashes[0], or has_parent = 0 for a sequence's head. 0 on success, -1
// before init, -2 when the queue is full.
DTN_EXPORT int dynamo_tpu_kv_event_publish_stored(uint64_t worker_id, const uint64_t* hashes, size_t n,
                                                  uint64_t parent, int has_parent) {
  CKvEvent ev{worker_id, 0, std::vector<uint64_t>(hashes, hashes + n), parent, has_parent != 0};
  return push_event(std::move(ev));
}

DTN_EXPORT int dynamo_tpu_kv_event_publish_removed(uint64_t worker_id, const uint64_t* hashes, size_t n) {
  CKvEvent ev{worker_id, 1, std::vector<uint64_t>(hashes, hashes + n), 0, 0};
  return push_event(std::move(ev));
}

// The queued events and the hashes they hold.
DTN_EXPORT void dtn_kv_events_pending(size_t* events, size_t* hashes) {
  std::lock_guard<std::mutex> lock(g_mu);
  *events = g_events.size();
  *hashes = g_event_hashes;
}

// Pop whole events from the queue's head while they fit max_events and
// max_hashes, in order; returns how many were popped. Event i's hashes are
// hashes[sum(counts[:i]) : sum(counts[:i + 1])].
DTN_EXPORT size_t dtn_kv_events_drain(uint64_t* worker_ids, int32_t* kinds, uint64_t* parents, int32_t* has_parent,
                                      uint64_t* counts, uint64_t* hashes, size_t max_events, size_t max_hashes) {
  std::lock_guard<std::mutex> lock(g_mu);
  size_t e = 0, h = 0;
  while (!g_events.empty() && e < max_events && h + g_events.front().hashes.size() <= max_hashes) {
    CKvEvent& ev = g_events.front();
    worker_ids[e] = ev.worker_id;
    kinds[e] = ev.kind;
    parents[e] = ev.parent;
    has_parent[e] = ev.has_parent;
    counts[e] = ev.hashes.size();
    std::copy(ev.hashes.begin(), ev.hashes.end(), hashes + h);
    h += ev.hashes.size();
    g_event_hashes -= ev.hashes.size();
    g_events.pop_front();
    e++;
  }
  return e;
}

// Publishes refused because the queue was full.
DTN_EXPORT uint64_t dtn_kv_events_dropped(void) {
  std::lock_guard<std::mutex> lock(g_mu);
  return g_dropped;
}
