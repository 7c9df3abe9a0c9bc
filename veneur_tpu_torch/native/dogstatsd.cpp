// Native DogStatsD ingest engine: parse + key table + batch staging.
//
// Replaces the Python host hot loop (samplers/parser.py parse_metric +
// aggregation/host.py KeyTable/Batcher) below the UDP socket with one C++
// pass per packet buffer. Semantics are bit-identical to the Python parser
// (itself mirroring reference samplers/parser.go:298 ParseMetric):
//   - `name:value|type[|@rate][|#tags]`, sections at most once
//   - type by first byte: c/g/d/h/m(s)/s (parser.go:331-344)
//   - tags sorted then joined with ","; first sorted tag with prefix
//     veneurlocalonly/veneurglobalonly stripped into the scope
//     (parser.go:397-407)
//   - 32-bit FNV-1a digest over name+type+joined-tags = shard key
//   - set members hashed MetroHash64 seed 1337 (utils/hashing.py
//     hll_reg_rho; the reference sketch's member hash)
//   - slot = shard*per_shard + next_free[shard], shard = digest % n_shards
//     (aggregation/host.py KeyTable.slot_for / _KindTable.alloc)
//
// Events (_e{) and service checks (_sc) are rare; they are handed back to
// Python verbatim (vt_next_special).
//
// Exposed as a C ABI for ctypes; see veneur_tpu/native/__init__.py.

#include <algorithm>
#include <array>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <shared_mutex>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include <pthread.h>
#include <sched.h>
#include <sys/socket.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint32_t FNV32_OFFSET = 0x811C9DC5u;
constexpr uint32_t FNV32_PRIME = 0x01000193u;
constexpr uint64_t FNV64_OFFSET = 0xCBF29CE484222325ull;
constexpr uint64_t FNV64_PRIME = 0x100000001B3ull;

inline uint32_t fnv32(const char* p, size_t n, uint32_t h) {
  for (size_t i = 0; i < n; i++) {
    h ^= (uint8_t)p[i];
    h *= FNV32_PRIME;
  }
  return h;
}

inline uint64_t fnv64(const char* p, size_t n) {
  uint64_t h = FNV64_OFFSET;
  for (size_t i = 0; i < n; i++) {
    h ^= (uint8_t)p[i];
    h *= FNV64_PRIME;
  }
  return h;
}

inline uint64_t rotr64(uint64_t x, int r) {
  return (x >> r) | (x << (64 - r));
}

inline uint64_t load64(const char* p) {
  uint64_t v;
  memcpy(&v, p, 8);  // little-endian host assumed (x86/arm LE)
  return v;
}
inline uint32_t load32(const char* p) {
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
}
inline uint16_t load16(const char* p) {
  uint16_t v;
  memcpy(&v, p, 2);
  return v;
}

// MetroHash64 (J. Andrew Rogers, public domain), seed 1337 — the member
// hash of the reference's vendored HLL sketch; must match the Python
// utils/hashing.py metro_hash_64 bit-for-bit so both ingest paths place a
// member in the same register, and match the reference fleet for
// cross-implementation sketch unions.
inline uint64_t metro64(const char* p, size_t n, uint64_t seed = 1337) {
  const uint64_t k0 = 0xD6D018F5, k1 = 0xA2AA033B, k2 = 0x62992FC1,
                 k3 = 0x30BC5B29;
  const char* end = p + n;
  uint64_t h = (seed + k2) * k0;
  if (n >= 32) {
    uint64_t v0 = h, v1 = h, v2 = h, v3 = h;
    while (end - p >= 32) {
      v0 += load64(p) * k0; p += 8; v0 = rotr64(v0, 29) + v2;
      v1 += load64(p) * k1; p += 8; v1 = rotr64(v1, 29) + v3;
      v2 += load64(p) * k2; p += 8; v2 = rotr64(v2, 29) + v0;
      v3 += load64(p) * k3; p += 8; v3 = rotr64(v3, 29) + v1;
    }
    v2 ^= rotr64(((v0 + v3) * k0) + v1, 37) * k1;
    v3 ^= rotr64(((v1 + v2) * k1) + v0, 37) * k0;
    v0 ^= rotr64(((v0 + v2) * k0) + v3, 37) * k1;
    v1 ^= rotr64(((v1 + v3) * k1) + v2, 37) * k0;
    h += v0 ^ v1;
  }
  if (end - p >= 16) {
    uint64_t w0 = h + load64(p) * k2; p += 8; w0 = rotr64(w0, 29) * k3;
    uint64_t w1 = h + load64(p) * k2; p += 8; w1 = rotr64(w1, 29) * k3;
    w0 ^= rotr64(w0 * k0, 21) + w1;
    w1 ^= rotr64(w1 * k3, 21) + w0;
    h += w1;
  }
  if (end - p >= 8) {
    h += load64(p) * k3; p += 8;
    h ^= rotr64(h, 55) * k1;
  }
  if (end - p >= 4) {
    h += (uint64_t)load32(p) * k3; p += 4;
    h ^= rotr64(h, 26) * k1;
  }
  if (end - p >= 2) {
    h += (uint64_t)load16(p) * k3; p += 2;
    h ^= rotr64(h, 48) * k1;
  }
  if (end - p >= 1) {
    h += (uint64_t)(uint8_t)(*p) * k3;
    h ^= rotr64(h, 37) * k1;
  }
  h ^= rotr64(h, 28);
  h *= k0;
  h ^= rotr64(h, 29);
  return h;
}

enum Kind { K_COUNTER = 0, K_GAUGE = 1, K_HISTO = 2, K_SET = 3, K_TIMER = 4 };
enum Scope { S_MIXED = 0, S_LOCAL = 1, S_GLOBAL = 2 };

// ---------------------------------------------------------------------------
// Multi-tenant identity + fairness (reliability/tenancy.py mirror).
// One TenantTable lives on the MASTER parser and is shared by every ring:
// tenant ids are interned once, entry pointers are stable for the process
// lifetime (vector of unique_ptr, grown under mu), and the weighted token
// buckets are host-wide — SO_REUSEPORT flow hashing can concentrate one
// tenant on one ring, so splitting a tenant's budget per ring would let
// placement, not weight, decide its fair share.

constexpr size_t kTenantValueMax = 64;   // oversized values -> default
constexpr int32_t kMaxTenants = 4096;    // intern cap; overflow -> default

// strict UTF-8 validation: an invalid tenant value maps to the default
// tenant instead of interning arbitrary bytes as an identity
inline bool utf8_valid(const char* p, size_t n) {
  size_t i = 0;
  while (i < n) {
    uint8_t c = (uint8_t)p[i];
    size_t need;
    if (c < 0x80) { i++; continue; }
    if ((c & 0xE0) == 0xC0) { need = 1; if (c < 0xC2) return false; }
    else if ((c & 0xF0) == 0xE0) need = 2;
    else if ((c & 0xF8) == 0xF0) { need = 3; if (c > 0xF4) return false; }
    else return false;
    if (i + need >= n) return false;
    for (size_t k = 1; k <= need; k++)
      if (((uint8_t)p[i + k] & 0xC0) != 0x80) return false;
    i += need + 1;
  }
  return true;
}

struct TenantEntry {
  std::string name;
  double weight = 1.0;           // guarded by TenantTable.mu
  // weighted token bucket (guarded by TenantTable.mu)
  double tokens = 0.0;
  std::chrono::steady_clock::time_point last;
  bool primed = false;
  // tag-explosion detector: additive-error distinct-key estimate. The
  // per-window count is exact (every new-key alloc bumps it); the
  // carried estimate decays geometrically at each flush reset, so the
  // additive error vs the true live-key count is bounded by the decay
  // tail — the cheap end of the 2004.10332 counter family.
  std::atomic<uint64_t> window_keys{0};
  std::atomic<double> key_est{0.0};
  std::atomic<bool> demoted{false};
};

struct TenantTable {
  std::mutex mu;                       // entries growth, by_name, buckets
  std::atomic<bool> enabled{false};
  std::string tag;                     // e.g. "tenant:"; set once, pre-rings
  std::atomic<double> base_rate{0.0};  // admitted/s per unit weight
  double burst_mult = 2.0;             // guarded by mu
  uint32_t q_max_keys = 0;             // 0 = quarantine off; set once
  double q_decay = 0.5;                // guarded by mu
  double q_readmit_frac = 0.5;         // guarded by mu
  std::vector<std::unique_ptr<TenantEntry>> entries;  // id -> entry
  std::unordered_map<std::string, int32_t> by_name;
  std::vector<int32_t> fresh;          // interned since the last name drain
  TenantEntry* dflt = nullptr;         // entries[0], stable once created
};

// Locate a well-formed `tag` value inside the raw datagram's tag section
// (the occurrence must follow '#' or ','; first occurrence wins, so
// duplicate tags resolve deterministically). Returns false — mapping the
// datagram to the default tenant — for missing tags, tags split across a
// truncated datagram, and empty/oversized/invalid-UTF-8 values: every
// anomaly is still admitted-and-accounted, never silently dropped.
inline bool tenant_extract(const std::string& tag, const char* p, size_t n,
                           const char** v, size_t* vlen) {
  if (tag.empty() || n <= tag.size()) return false;
  const char* cur = p;
  size_t rem = n;
  while (rem >= tag.size()) {
    const char* hit =
        (const char*)memmem(cur, rem, tag.data(), tag.size());
    if (!hit) return false;
    if (hit > p && (hit[-1] == '#' || hit[-1] == ',')) {
      const char* val = hit + tag.size();
      size_t vmax = (size_t)(p + n - val);
      size_t len = 0;
      while (len < vmax && val[len] != ',' && val[len] != '|' &&
             val[len] != '\n')
        len++;
      if (len == 0 || len > kTenantValueMax || !utf8_valid(val, len))
        return false;
      *v = val;
      *vlen = len;
      return true;
    }
    cur = hit + 1;
    rem = (size_t)(p + n - cur);
  }
  return false;
}

// Intern (or look up) a tenant name; *te gets the stable entry pointer.
// At the kMaxTenants cap new names collapse onto the default tenant —
// identity cardinality must stay bounded even under a hostile name flood.
inline int32_t tenant_intern(TenantTable& tt, const char* name, size_t n,
                             TenantEntry** te) {
  std::lock_guard<std::mutex> lk(tt.mu);
  std::string key(name, n);
  auto it = tt.by_name.find(key);
  if (it != tt.by_name.end()) {
    *te = tt.entries[it->second].get();
    return it->second;
  }
  if ((int32_t)tt.entries.size() >= kMaxTenants) {
    *te = tt.dflt;
    return 0;
  }
  int32_t id = (int32_t)tt.entries.size();
  auto e = std::make_unique<TenantEntry>();
  e->name = key;
  *te = e.get();
  tt.entries.push_back(std::move(e));
  tt.by_name.emplace(std::move(key), id);
  tt.fresh.push_back(id);
  return id;
}

// TokenBucket.allow with rate = base_rate * weight (reliability/
// tenancy.py TenantFairness.allow). Host-wide: one bucket per tenant
// regardless of which ring the datagram landed on.
inline bool tenant_allow(TenantTable& tt, TenantEntry& e,
                         std::chrono::steady_clock::time_point now) {
  std::lock_guard<std::mutex> lk(tt.mu);
  double rate = tt.base_rate.load(std::memory_order_relaxed) * e.weight;
  if (rate <= 0.0) return true;
  double burst = rate * tt.burst_mult;
  if (burst < 1.0) burst = 1.0;
  if (!e.primed) {
    e.tokens = burst;
    e.last = now;
    e.primed = true;
  }
  double dt = std::chrono::duration<double>(now - e.last).count();
  e.last = now;
  double t = e.tokens + dt * rate;
  if (t > burst) t = burst;
  if (t >= 1.0) {
    e.tokens = t - 1.0;
    return true;
  }
  e.tokens = t;
  return false;
}

struct KindTable {
  uint32_t capacity = 0;
  uint32_t n_shards = 1;
  uint32_t per_shard = 0;
  std::unordered_map<std::string, int32_t> by_key;
  std::vector<uint32_t> next_free;
  uint64_t dropped = 0;

  void init(uint32_t cap, uint32_t shards) {
    capacity = cap;
    n_shards = shards;
    per_shard = cap / shards;
    next_free.assign(shards, 0);
  }
  void reset() {
    by_key.clear();
    next_free.assign(n_shards, 0);
  }
};

// serialized record of a newly-allocated slot, drained by Python for
// flush-time labeling (SlotMeta)
struct NewKey {
  uint8_t kind;
  int32_t slot;
  uint8_t scope;
  uint8_t imported;  // slot first created by the import path
  std::string name;
  std::string joined_tags;
};

// per-imported-histogram scalar stats (min/max/reciprocal-sum
// correction), drained by Python into the histo_stat batch lane
struct ImportStat {
  int32_t slot;
  float mn, mx, recip_corr;
};

struct Parser {
  // tables: counter, gauge, set, histo (histogram+timer share, key
  // prefixed with the kind byte like Python's ("timer", name, tags) keys)
  KindTable counters, gauges, sets, histos;
  int hll_precision = 14;
  // staged shard-map change (live resharding): set under a unique
  // key_mu lock by vt_shard_map_set, applied by vt_reset at the next
  // buffer-swap boundary so no packed batch ever straddles two maps.
  // 0 = nothing staged.
  uint32_t pending_shards = 0;
  // staged per-kind capacity change (live key-table growth,
  // veneur_tpu/tables/growth.py): counter/gauge/set/histo, 0 = nothing
  // staged. Same discipline as pending_shards — set under key_mu by
  // vt_capacity_set, applied by vt_reset while the tables are empty, so
  // no slot ever straddles two capacities and the per-shard slot
  // rebase (slot = shard * per_shard + local) changes only between
  // intervals.
  uint32_t pending_caps[4] = {0, 0, 0, 0};

  // Multi-ring sharing: ring parsers keep their own staging lanes and
  // scratch but route every key-table/new-key/special access to the
  // master parser so all rings share ONE slot space. Steady-state lookups
  // are served from a ring-local replica cache with no lock at all; the
  // shared table is touched only on cache miss (shared lock) and on
  // first-allocation (unique lock, once per key per flush interval).
  Parser* master = nullptr;
  std::shared_mutex key_mu;                          // tables + new_keys
  std::mutex specials_mu;                            // specials deque
  std::unordered_map<std::string, int32_t> local_cache;

  Parser& rt() { return master ? *master : *this; }

  // Multi-tenant identity (master only; rings route via rt()). The
  // cur_* fields are per-parser parse context: set before each vt_feed
  // (by the ring worker under stage_mu, or by vt_set_tenant on the
  // Python feed path) and read only inside parse_line/slot_for.
  std::unique_ptr<TenantTable> tenants;
  int32_t cur_tenant = 0;
  TenantEntry* cur_entry = nullptr;
  bool cur_demoted = false;
  // demoted-row accounting per tenant id; written during parse (under
  // stage_mu in the ring engine, under the GIL on the Python feed
  // path), drained by vrm_tenant_counters / vt_tenant_rows
  std::unordered_map<int32_t, uint64_t> demoted_rows;

  // staging (fixed batch capacities; slot sentinel fill done by Python)
  uint32_t bc, bg, bs, bh;
  std::vector<int32_t> c_slot;  std::vector<float> c_inc;
  std::vector<int32_t> g_slot;  std::vector<float> g_val;
  std::vector<int32_t> s_slot;  std::vector<int32_t> s_reg;
  std::vector<uint8_t> s_rho;
  std::vector<int32_t> h_slot;  std::vector<float> h_val;
  std::vector<float> h_wt;
  uint32_t nc = 0, ng = 0, ns = 0, nh = 0;

  std::vector<NewKey> new_keys;
  std::deque<std::string> specials;  // _e{ / _sc lines for Python

  // import path (vi_import): per-histogram stats + alloc marking
  std::vector<ImportStat> import_stats;
  bool alloc_imported = false;

  // atomics: ring workers bump these off-GIL while vt_stats/vrm_stats
  // snapshot from the pipeline thread
  std::atomic<uint64_t> processed{0};
  std::atomic<uint64_t> parse_errors{0};

  // emit_packed timing: atomics because the poll thread snapshots
  // (vr_stats) while the pipeline thread emits; relaxed is enough for a
  // monotonic telemetry pair read independently.
  std::atomic<uint64_t> emit_packed_calls{0};
  std::atomic<uint64_t> emit_packed_ns{0};

  // scratch
  std::vector<std::pair<const char*, size_t>> tag_views;
  std::string keybuf, joined;
  // shard counting-sort scratch (vt_emit_sharded); grown once, reused
  std::vector<uint32_t> ss_cnt, ss_pos, ss_order;

  void init(uint32_t cc, uint32_t gc, uint32_t sc, uint32_t hc,
            uint32_t shards, int precision, uint32_t bc_, uint32_t bg_,
            uint32_t bs_, uint32_t bh_) {
    counters.init(cc, shards);
    gauges.init(gc, shards);
    sets.init(sc, shards);
    histos.init(hc, shards);
    hll_precision = precision;
    bc = bc_; bg = bg_; bs = bs_; bh = bh_;
    c_slot.resize(bc); c_inc.resize(bc);
    g_slot.resize(bg); g_val.resize(bg);
    s_slot.resize(bs); s_reg.resize(bs); s_rho.resize(bs);
    h_slot.resize(bh); h_val.resize(bh); h_wt.resize(bh);
  }

  bool any_full() const {
    return nc >= bc || ng >= bg || ns >= bs || nh >= bh;
  }

  // `t` must be a table of rt() — callers route through rt().counters etc.
  int32_t slot_for(KindTable& t, uint8_t kind, uint8_t scope,
                   const char* name, size_t name_len, uint32_t digest) {
    // key = kind byte + name + '\x1f' + joined tags (joined is in `joined`)
    keybuf.clear();
    keybuf.push_back((char)kind);
    keybuf.append(name, name_len);
    keybuf.push_back('\x1f');
    keybuf.append(joined);
    if (master) {
      // lock-free hot path: the ring-local replica (slots are stable
      // within a flush interval; vrm_reset clears these under quiesce)
      auto cit = local_cache.find(keybuf);
      if (cit != local_cache.end()) return cit->second;
    }
    Parser& m = rt();
    {
      std::shared_lock<std::shared_mutex> lk(m.key_mu);
      auto it = t.by_key.find(keybuf);
      if (it != t.by_key.end()) {
        int32_t slot = it->second;
        lk.unlock();
        if (master) local_cache.emplace(keybuf, slot);
        return slot;
      }
    }
    std::unique_lock<std::shared_mutex> lk(m.key_mu);
    auto it = t.by_key.find(keybuf);
    if (it == t.by_key.end()) {
      uint32_t shard = digest % t.n_shards;
      uint32_t nxt = t.next_free[shard];
      if (nxt >= t.per_shard) {
        t.dropped++;
        return -1;
      }
      t.next_free[shard] = nxt + 1;
      int32_t slot = (int32_t)(shard * t.per_shard + nxt);
      it = t.by_key.emplace(keybuf, slot).first;
      m.new_keys.push_back(NewKey{kind, slot, scope,
                                  (uint8_t)(alloc_imported ? 1 : 0),
                                  std::string(name, name_len), joined});
      // tag-explosion detector: every distinct-key allocation charges
      // the owning tenant's window counter; crossing the budget demotes
      // it (subsequent datagrams collapse onto rollup keys instead of
      // evicting healthy tenants' hot keys out of shard capacity)
      if (cur_entry) {
        uint64_t w =
            cur_entry->window_keys.fetch_add(1, std::memory_order_relaxed)
            + 1;
        TenantTable* tt = m.tenants.get();
        if (tt && tt->q_max_keys &&
            !cur_entry->demoted.load(std::memory_order_relaxed) &&
            cur_entry->key_est.load(std::memory_order_relaxed) +
                    (double)w > (double)tt->q_max_keys)
          cur_entry->demoted.store(true, std::memory_order_relaxed);
      }
    }
    int32_t slot = it->second;
    lk.unlock();
    if (master) local_cache.emplace(keybuf, slot);
    return slot;
  }

  // strict float parse: Go strconv.ParseFloat-alike (no surrounding
  // whitespace, full consumption, finite)
  static bool parse_value(const char* p, size_t n, double* out) {
    if (n == 0) return false;
    if (isspace((unsigned char)p[0])) return false;
    char buf[64];
    if (n >= sizeof(buf)) return false;
    // strtod accepts C99 hex floats; Python float() / the wire format do not
    if (memchr(p, 'x', n) || memchr(p, 'X', n)) return false;
    memcpy(buf, p, n);
    buf[n] = 0;
    char* end = nullptr;
    double v = strtod(buf, &end);
    if (end != buf + n) return false;
    if (!std::isfinite(v)) return false;
    return *out = v, true;
  }

  // returns 0 ok, 1 parse error, 2 special (event/service check), 3 full
  int parse_line(const char* line, size_t len) {
    if (len == 0) return 0;
    if (len >= 3 && line[0] == '_' &&
        ((line[1] == 'e' && line[2] == '{') ||
         (line[1] == 's' && line[2] == 'c'))) {
      Parser& m = rt();
      std::lock_guard<std::mutex> lk(m.specials_mu);
      m.specials.emplace_back(line, len);
      return 2;
    }
    // split into pipe chunks
    const char* colon = (const char*)memchr(line, ':', len);
    const char* pipe1 = (const char*)memchr(line, '|', len);
    if (!colon || !pipe1 || colon > pipe1) return 1;
    const char* name = line;
    size_t name_len = colon - line;
    if (name_len == 0) return 1;
    const char* value = colon + 1;
    size_t value_len = pipe1 - value;

    const char* rest = pipe1 + 1;
    size_t rest_len = len - (rest - line);
    // type chunk
    const char* pipe2 = (const char*)memchr(rest, '|', rest_len);
    size_t type_len = pipe2 ? (size_t)(pipe2 - rest) : rest_len;
    if (type_len == 0) return 1;

    uint8_t kind;
    const char* kind_str;
    size_t kind_str_len;
    switch (rest[0]) {
      case 'c': kind = K_COUNTER; kind_str = "counter"; kind_str_len = 7; break;
      case 'g': kind = K_GAUGE;   kind_str = "gauge";   kind_str_len = 5; break;
      case 'd':
      case 'h': kind = K_HISTO;   kind_str = "histogram"; kind_str_len = 9; break;
      case 'm': kind = K_TIMER;   kind_str = "timer";   kind_str_len = 5; break;
      case 's': kind = K_SET;     kind_str = "set";     kind_str_len = 3; break;
      default: return 1;
    }

    uint32_t h = fnv32(name, name_len, FNV32_OFFSET);
    h = fnv32(kind_str, kind_str_len, h);

    double value_f = 0;
    if (kind != K_SET) {
      // reject '_' (Python/Go reject digit separators, strtod would too
      // via full-consumption, but be explicit for e.g. "1_0")
      if (!parse_value(value, value_len, &value_f)) return 1;
    }

    // optional sections
    double rate = 1.0;
    bool found_rate = false, found_tags = false;
    uint8_t scope = S_MIXED;
    joined.clear();
    const char* p = pipe2 ? pipe2 : rest + rest_len;
    while (p < line + len) {
      p++;  // skip '|'
      size_t remain = len - (p - line);
      const char* next = (const char*)memchr(p, '|', remain);
      size_t clen = next ? (size_t)(next - p) : remain;
      if (clen == 0) return 1;
      if (p[0] == '@') {
        if (found_rate) return 1;
        double r;
        if (!parse_value(p + 1, clen - 1, &r)) return 1;
        if (r <= 0.0 || r > 1.0) return 1;
        rate = r;
        found_rate = true;
      } else if (p[0] == '#') {
        if (found_tags) return 1;
        found_tags = true;
        // split tags on ',', sort, strip first magic, join
        tag_views.clear();
        const char* t = p + 1;
        const char* tag_end = p + clen;
        while (t <= tag_end) {
          const char* comma =
              (const char*)memchr(t, ',', tag_end - t);
          size_t tl = comma ? (size_t)(comma - t) : (size_t)(tag_end - t);
          tag_views.emplace_back(t, tl);
          if (!comma) break;
          t = comma + 1;
        }
        std::sort(tag_views.begin(), tag_views.end(),
                  [](const auto& a, const auto& b) {
                    int c = memcmp(a.first, b.first,
                                   std::min(a.second, b.second));
                    if (c != 0) return c < 0;
                    return a.second < b.second;
                  });
        // first sorted tag with a magic prefix is stripped into the scope
        static const char LOCALONLY[] = "veneurlocalonly";
        static const char GLOBALONLY[] = "veneurglobalonly";
        size_t strip = SIZE_MAX;
        for (size_t i = 0; i < tag_views.size(); i++) {
          const auto& tv = tag_views[i];
          if (tv.second >= 15 && memcmp(tv.first, LOCALONLY, 15) == 0) {
            scope = S_LOCAL;
            strip = i;
            break;
          }
          if (tv.second >= 16 && memcmp(tv.first, GLOBALONLY, 16) == 0) {
            scope = S_GLOBAL;
            strip = i;
            break;
          }
        }
        bool first = true;
        for (size_t i = 0; i < tag_views.size(); i++) {
          if (i == strip) continue;
          if (!first) joined.push_back(',');
          joined.append(tag_views[i].first, tag_views[i].second);
          first = false;
        }
        h = fnv32(joined.data(), joined.size(), h);
      } else {
        return 1;
      }
      if (!next) break;
      p = next;
    }
    if (!found_tags) joined.clear();

    // quarantine demotion: a demoted tenant's rows collapse onto ONE
    // rollup key per kind — name, tags, and route digest all rewritten
    // so the slot space this tenant can touch is bounded while its
    // traffic stays measured (demoted_rows is the exact row count)
    if (cur_demoted && cur_entry) {
      static const char kRollup[] = "veneur.tenant.rollup";
      name = kRollup;
      name_len = sizeof(kRollup) - 1;
      scope = S_MIXED;
      joined.clear();
      TenantTable* tt = rt().tenants.get();
      if (tt) joined.append(tt->tag);
      joined.append(cur_entry->name);
      h = fnv32(name, name_len, FNV32_OFFSET);
      h = fnv32(kind_str, kind_str_len, h);
      h = fnv32(joined.data(), joined.size(), h);
      demoted_rows[cur_tenant]++;
    }

    switch (kind) {
      case K_COUNTER: {
        int32_t slot = slot_for(rt().counters, kind, scope, name, name_len, h);
        if (slot < 0) return 0;
        c_slot[nc] = slot;
        c_inc[nc] = (float)(value_f * (1.0 / rate));
        nc++;
        break;
      }
      case K_GAUGE: {
        int32_t slot = slot_for(rt().gauges, kind, scope, name, name_len, h);
        if (slot < 0) return 0;
        g_slot[ng] = slot;
        g_val[ng] = (float)value_f;
        ng++;
        break;
      }
      case K_SET: {
        int32_t slot = slot_for(rt().sets, kind, scope, name, name_len, h);
        if (slot < 0) return 0;
        uint64_t mh = metro64(value, value_len);
        uint32_t reg = (uint32_t)(mh >> (64 - hll_precision));
        uint64_t restbits = mh << hll_precision;
        int rho;
        if (restbits == 0) {
          rho = 64 - hll_precision + 1;
        } else {
          int lz = __builtin_clzll(restbits);
          rho = std::min(lz, 64 - hll_precision) + 1;
        }
        s_slot[ns] = slot;
        s_reg[ns] = (int32_t)reg;
        s_rho[ns] = (uint8_t)rho;
        ns++;
        break;
      }
      case K_HISTO:
      case K_TIMER: {
        int32_t slot = slot_for(rt().histos, kind, scope, name, name_len, h);
        if (slot < 0) return 0;
        h_slot[nh] = slot;
        h_val[nh] = (float)value_f;
        h_wt[nh] = (float)(1.0 / rate);
        nh++;
        break;
      }
    }
    processed++;
    return 0;
  }
};

}  // namespace

extern "C" {

void* vt_new(uint32_t counter_cap, uint32_t gauge_cap, uint32_t set_cap,
             uint32_t histo_cap, uint32_t n_shards, int hll_precision,
             uint32_t bc, uint32_t bg, uint32_t bs, uint32_t bh) {
  auto* p = new Parser();
  p->init(counter_cap, gauge_cap, set_cap, histo_cap,
          n_shards ? n_shards : 1, hll_precision, bc, bg, bs, bh);
  return p;
}

void vt_free(void* h) { delete (Parser*)h; }

// Feed a newline-separated packet buffer starting at byte `start` (so a
// caller resuming after a full-lane stop passes the same buffer back with
// the previous *consumed — no remainder slice/copy, mirroring vi_import's
// offset). Stops early if a staging area fills; *consumed reports the
// absolute offset of the first unhandled byte. Returns 1 if
// stopped-for-full, else 0.
int vt_feed(void* hp, const char* data, int len, int start, int* consumed) {
  auto* p = (Parser*)hp;
  int off = start < 0 ? 0 : start;
  while (off < len) {
    if (p->any_full()) {
      *consumed = off;
      return 1;
    }
    const char* nl = (const char*)memchr(data + off, '\n', len - off);
    int line_len = nl ? (int)(nl - (data + off)) : (len - off);
    int rc = p->parse_line(data + off, line_len);
    if (rc == 1) p->parse_errors++;
    off += line_len + (nl ? 1 : 0);
  }
  *consumed = off;
  return 0;
}

// Copy staged samples into caller-provided buffers (caller pre-fills slot
// buffers with sentinels) and reset staging. counts_out: [nc, ng, ns, nh].
void vt_emit(void* hp, int32_t* c_slot, float* c_inc, int32_t* g_slot,
             float* g_val, int32_t* s_slot, int32_t* s_reg, uint8_t* s_rho,
             int32_t* h_slot, float* h_val, float* h_wt,
             uint32_t* counts_out) {
  auto* p = (Parser*)hp;
  memcpy(c_slot, p->c_slot.data(), p->nc * sizeof(int32_t));
  memcpy(c_inc, p->c_inc.data(), p->nc * sizeof(float));
  memcpy(g_slot, p->g_slot.data(), p->ng * sizeof(int32_t));
  memcpy(g_val, p->g_val.data(), p->ng * sizeof(float));
  memcpy(s_slot, p->s_slot.data(), p->ns * sizeof(int32_t));
  memcpy(s_reg, p->s_reg.data(), p->ns * sizeof(int32_t));
  memcpy(s_rho, p->s_rho.data(), p->ns * sizeof(uint8_t));
  memcpy(h_slot, p->h_slot.data(), p->nh * sizeof(int32_t));
  memcpy(h_val, p->h_val.data(), p->nh * sizeof(float));
  memcpy(h_wt, p->h_wt.data(), p->nh * sizeof(float));
  counts_out[0] = p->nc;
  counts_out[1] = p->ng;
  counts_out[2] = p->ns;
  counts_out[3] = p->nh;
  p->nc = p->ng = p->ns = p->nh = 0;
}

// Zero-copy emit: write staged lanes straight into a caller-owned flat
// i32 buffer laid out exactly like aggregation/step.py pack_batch (word 0
// is the control word, then lanes in Batch._fields order; f32 lanes bit-
// cast, set_rho as packed bytes). `off` gives the word offset of each of
// the ten native lanes in that buffer (c_slot, c_inc, g_slot, g_val,
// s_slot, s_reg, s_rho, h_slot, h_val, h_wt — Python computes these once
// since it alone knows the status/histo_stat lane sizes interleaved
// between them; those regions are Python-initialized constants we never
// touch). Sentinel tails are maintained INCREMENTALLY: `prev` carries the
// row counts this buffer held after ITS previous emit (in/out, [4]), and
// only rows [n_new, prev_n) are re-sentineled — the rest of the buffer is
// already in the padded state Batcher.emit would have produced, so the
// flat bytes stay byte-identical to pack_batch(batch) of the old copy
// path (including harmlessly-stale value-lane rows past the counts,
// which the slot sentinels make the scatter drop — same contract as
// aggregation/host.py Batcher.emit's partial reset). counts_out: [nc,
// ng, ns, nh]; staging is reset like vt_emit.
void vt_emit_packed(void* hp, int32_t* buf, const int32_t* off,
                    uint32_t* prev, uint32_t* counts_out) {
  auto* p = (Parser*)hp;
  auto t0 = std::chrono::steady_clock::now();
  int32_t* c_slot = buf + off[0];
  float*   c_inc  = (float*)(buf + off[1]);
  int32_t* g_slot = buf + off[2];
  float*   g_val  = (float*)(buf + off[3]);
  int32_t* s_slot = buf + off[4];
  int32_t* s_reg  = buf + off[5];
  uint8_t* s_rho  = (uint8_t*)(buf + off[6]);
  int32_t* h_slot = buf + off[7];
  float*   h_val  = (float*)(buf + off[8]);
  float*   h_wt   = (float*)(buf + off[9]);
  const int32_t c_cap = (int32_t)p->counters.capacity;
  const int32_t g_cap = (int32_t)p->gauges.capacity;
  const int32_t s_cap = (int32_t)p->sets.capacity;
  const int32_t h_cap = (int32_t)p->histos.capacity;
  for (uint32_t i = p->nc; i < prev[0]; i++) { c_slot[i] = c_cap; c_inc[i] = 0.0f; }
  for (uint32_t i = p->ng; i < prev[1]; i++) g_slot[i] = g_cap;
  for (uint32_t i = p->ns; i < prev[2]; i++) s_slot[i] = s_cap;
  for (uint32_t i = p->nh; i < prev[3]; i++) { h_slot[i] = h_cap; h_wt[i] = 0.0f; }
  memcpy(c_slot, p->c_slot.data(), p->nc * sizeof(int32_t));
  memcpy(c_inc, p->c_inc.data(), p->nc * sizeof(float));
  memcpy(g_slot, p->g_slot.data(), p->ng * sizeof(int32_t));
  memcpy(g_val, p->g_val.data(), p->ng * sizeof(float));
  memcpy(s_slot, p->s_slot.data(), p->ns * sizeof(int32_t));
  memcpy(s_reg, p->s_reg.data(), p->ns * sizeof(int32_t));
  memcpy(s_rho, p->s_rho.data(), p->ns * sizeof(uint8_t));
  memcpy(h_slot, p->h_slot.data(), p->nh * sizeof(int32_t));
  memcpy(h_val, p->h_val.data(), p->nh * sizeof(float));
  memcpy(h_wt, p->h_wt.data(), p->nh * sizeof(float));
  counts_out[0] = p->nc; prev[0] = p->nc;
  counts_out[1] = p->ng; prev[1] = p->ng;
  counts_out[2] = p->ns; prev[2] = p->ns;
  counts_out[3] = p->nh; prev[3] = p->nh;
  p->nc = p->ng = p->ns = p->nh = 0;
  p->emit_packed_calls.fetch_add(1, std::memory_order_relaxed);
  p->emit_packed_ns.fetch_add(
      (uint64_t)std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now() - t0)
          .count(),
      std::memory_order_relaxed);
}

int vt_pending(void* hp) {
  auto* p = (Parser*)hp;
  return (int)(p->nc + p->ng + p->ns + p->nh);
}

namespace {

// Stable counting sort of a staged slot lane by owner shard. Slots already
// encode the route: slot = shard*per_shard + local with shard =
// route_digest % n_shards (KindTable alloc), so grouping by slot/per_shard
// IS grouping by route_digest — no rehash. Stability preserves arrival
// order within each shard (gauge last-write-wins exactness). `bnd` gets
// n_shards+1 prefix bounds; `order` maps output row -> staged row.
void shard_order(Parser* p, const std::vector<int32_t>& sv, uint32_t n,
                 uint32_t per_shard, uint32_t n_shards, int32_t* bnd) {
  uint32_t ps = per_shard ? per_shard : 1;
  p->ss_cnt.assign(n_shards + 1, 0);
  for (uint32_t i = 0; i < n; i++) p->ss_cnt[(uint32_t)sv[i] / ps + 1]++;
  for (uint32_t s = 0; s < n_shards; s++) p->ss_cnt[s + 1] += p->ss_cnt[s];
  for (uint32_t s = 0; s <= n_shards; s++) bnd[s] = (int32_t)p->ss_cnt[s];
  p->ss_pos.assign(p->ss_cnt.begin(), p->ss_cnt.end());
  if (p->ss_order.size() < n) p->ss_order.resize(n);
  for (uint32_t i = 0; i < n; i++)
    p->ss_order[p->ss_pos[(uint32_t)sv[i] / ps]++] = i;
}

}  // namespace

// Pre-sharded emit: like vt_emit but rows arrive grouped by owner shard
// with slots rebased shard-local, plus a per-kind bounds table
// (int32[4*(n_shards+1)], kinds in counter/gauge/set/histo order) so the
// sharded aggregator feeds per-shard batchers with contiguous slices —
// no argsort, no slot subtraction, and the collective all_to_all shuffle
// sees rows already in owner order. counts_out like vt_emit; staging is
// reset.
void vt_emit_sharded(void* hp, int32_t* c_slot, float* c_inc,
                     int32_t* g_slot, float* g_val, int32_t* s_slot,
                     int32_t* s_reg, uint8_t* s_rho, int32_t* h_slot,
                     float* h_val, float* h_wt, int32_t* bounds,
                     uint32_t* counts_out) {
  auto* p = (Parser*)hp;
  const uint32_t S = p->counters.n_shards;  // all tables share n_shards
  uint32_t ps;

  ps = p->counters.per_shard ? p->counters.per_shard : 1;
  shard_order(p, p->c_slot, p->nc, ps, S, bounds);
  for (uint32_t k = 0; k < p->nc; k++) {
    uint32_t j = p->ss_order[k];
    int32_t sl = p->c_slot[j];
    c_slot[k] = sl - (int32_t)((uint32_t)sl / ps * ps);
    c_inc[k] = p->c_inc[j];
  }
  ps = p->gauges.per_shard ? p->gauges.per_shard : 1;
  shard_order(p, p->g_slot, p->ng, ps, S, bounds + (S + 1));
  for (uint32_t k = 0; k < p->ng; k++) {
    uint32_t j = p->ss_order[k];
    int32_t sl = p->g_slot[j];
    g_slot[k] = sl - (int32_t)((uint32_t)sl / ps * ps);
    g_val[k] = p->g_val[j];
  }
  ps = p->sets.per_shard ? p->sets.per_shard : 1;
  shard_order(p, p->s_slot, p->ns, ps, S, bounds + 2 * (S + 1));
  for (uint32_t k = 0; k < p->ns; k++) {
    uint32_t j = p->ss_order[k];
    int32_t sl = p->s_slot[j];
    s_slot[k] = sl - (int32_t)((uint32_t)sl / ps * ps);
    s_reg[k] = p->s_reg[j];
    s_rho[k] = p->s_rho[j];
  }
  ps = p->histos.per_shard ? p->histos.per_shard : 1;
  shard_order(p, p->h_slot, p->nh, ps, S, bounds + 3 * (S + 1));
  for (uint32_t k = 0; k < p->nh; k++) {
    uint32_t j = p->ss_order[k];
    int32_t sl = p->h_slot[j];
    h_slot[k] = sl - (int32_t)((uint32_t)sl / ps * ps);
    h_val[k] = p->h_val[j];
    h_wt[k] = p->h_wt[j];
  }
  counts_out[0] = p->nc;
  counts_out[1] = p->ng;
  counts_out[2] = p->ns;
  counts_out[3] = p->nh;
  p->nc = p->ng = p->ns = p->nh = 0;
  p->emit_packed_calls.fetch_add(1, std::memory_order_relaxed);
}

// Drain new-key records into buf as
// [u8 kind][i32 slot][u8 scope][u16 name_len][name][u16 tags_len][tags]*.
// Returns bytes written, or -needed when cap is too small (nothing
// consumed in that case).
int vt_new_keys(void* hp, char* buf, int cap) {
  auto* p = (Parser*)hp;
  std::unique_lock<std::shared_mutex> lk(p->key_mu);
  int need = 0;
  for (const auto& k : p->new_keys)
    need += 1 + 4 + 1 + 2 + (int)k.name.size() + 2 + (int)k.joined_tags.size();
  if (need > cap) return -need;
  char* w = buf;
  for (const auto& k : p->new_keys) {
    *w++ = (char)k.kind;
    memcpy(w, &k.slot, 4); w += 4;
    // scope rides the low bits; bit 7 marks import-created slots
    // (imported_only flush semantics, aggregation/host.py alloc)
    *w++ = (char)(k.scope | (k.imported ? 0x80 : 0));
    uint16_t nl = (uint16_t)k.name.size();
    memcpy(w, &nl, 2); w += 2;
    memcpy(w, k.name.data(), nl); w += nl;
    uint16_t tl = (uint16_t)k.joined_tags.size();
    memcpy(w, &tl, 2); w += 2;
    memcpy(w, k.joined_tags.data(), tl); w += tl;
  }
  p->new_keys.clear();
  return (int)(w - buf);
}

// Pop one escalated (_e{ / _sc) line; returns its length, 0 if none,
// -needed if cap too small (line stays queued).
int vt_next_special(void* hp, char* buf, int cap) {
  auto* p = (Parser*)hp;
  std::lock_guard<std::mutex> slk(p->specials_mu);
  if (p->specials.empty()) return 0;
  const std::string& s = p->specials.front();
  if ((int)s.size() > cap) return -(int)s.size();
  memcpy(buf, s.data(), s.size());
  int n = (int)s.size();
  p->specials.pop_front();
  return n;
}

// Slot allocation for Python-side callers (imports, span-extracted
// metrics) so native wire ingest and the Python paths share one slot
// space. kind: 0=counter 1=gauge 2=histogram 3=set 4=timer. *was_new is
// set to 1 when this call allocated the slot. Returns -1 when the shard
// is at capacity.
int32_t vt_slot_for(void* hp, int kind, int scope, const char* name,
                    int name_len, const char* tags, int tags_len,
                    uint32_t digest, int* was_new) {
  auto* p = (Parser*)hp;
  KindTable* t;
  switch (kind) {
    case K_COUNTER: t = &p->counters; break;
    case K_GAUGE: t = &p->gauges; break;
    case K_SET: t = &p->sets; break;
    case K_HISTO:
    case K_TIMER: t = &p->histos; break;
    default: return -1;
  }
  p->joined.assign(tags, tags_len);
  size_t before = p->new_keys.size();
  int32_t slot = p->slot_for(*t, (uint8_t)kind, (uint8_t)scope, name,
                             name_len, digest);
  *was_new = p->new_keys.size() > before ? 1 : 0;
  return slot;
}

// Flush boundary: clear key maps (state is flush-scoped, worker.go:498).
// A staged shard map (vt_shard_map_set) is applied HERE — tables are
// empty at this instant, so re-deriving per_shard/next_free under the
// new count re-keys nothing and no packed batch straddles two maps.
void vt_reset(void* hp) {
  auto* p = (Parser*)hp;
  std::unique_lock<std::shared_mutex> lk(p->key_mu);
  p->counters.reset();
  p->gauges.reset();
  p->sets.reset();
  p->histos.reset();
  p->new_keys.clear();
  if (p->pending_shards) {
    uint32_t n = p->pending_shards;
    p->pending_shards = 0;
    p->counters.init(p->counters.capacity, n);
    p->gauges.init(p->gauges.capacity, n);
    p->sets.init(p->sets.capacity, n);
    p->histos.init(p->histos.capacity, n);
  }
  // staged per-kind growth applies after any shard-map change so a
  // combined stage lands as (new shards, new caps) in one quiesce
  if (p->pending_caps[0] | p->pending_caps[1] | p->pending_caps[2] |
      p->pending_caps[3]) {
    KindTable* ts[4] = {&p->counters, &p->gauges, &p->sets, &p->histos};
    for (int i = 0; i < 4; i++) {
      if (p->pending_caps[i])
        ts[i]->init(p->pending_caps[i], ts[i]->n_shards);
      p->pending_caps[i] = 0;
    }
  }
  // tenant quarantine decay: fold this window's exact distinct-key count
  // into the carried estimate (est = est*decay + window) and re-admit a
  // demoted tenant once its estimate has decayed under the re-admission
  // fraction of the budget — the flush boundary is the detector's clock
  if (p->tenants) {
    TenantTable& tt = *p->tenants;
    std::lock_guard<std::mutex> tlk(tt.mu);
    for (auto& e : tt.entries) {
      uint64_t w = e->window_keys.exchange(0, std::memory_order_relaxed);
      double est =
          e->key_est.load(std::memory_order_relaxed) * tt.q_decay +
          (double)w;
      e->key_est.store(est, std::memory_order_relaxed);
      if (tt.q_max_keys && e->demoted.load(std::memory_order_relaxed) &&
          est <= tt.q_readmit_frac * (double)tt.q_max_keys)
        e->demoted.store(false, std::memory_order_relaxed);
    }
  }
}

// Stage a new shard count for the tables (all tables share n_shards).
// Takes effect at the next vt_reset — i.e. inside the caller's swap
// quiesce — never immediately. The swap-boundary sequencing lives in
// veneur_tpu/reshard/quiesce.py; call it from there only.
void vt_shard_map_set(void* hp, uint32_t n_shards) {
  auto* p = (Parser*)hp;
  std::unique_lock<std::shared_mutex> lk(p->key_mu);
  p->pending_shards = n_shards ? n_shards : 1;
}

// Stage new per-kind capacities (0 = keep current). Takes effect at the
// next vt_reset — i.e. inside the caller's swap quiesce — never
// immediately. The swap-boundary sequencing lives in tables/growth.py;
// call it from there only.
void vt_capacity_set(void* hp, uint32_t cc, uint32_t gc, uint32_t sc,
                     uint32_t hc) {
  auto* p = (Parser*)hp;
  std::unique_lock<std::shared_mutex> lk(p->key_mu);
  p->pending_caps[0] = cc;
  p->pending_caps[1] = gc;
  p->pending_caps[2] = sc;
  p->pending_caps[3] = hc;
}

// Per-kind occupancy snapshot for the growth planner: 3 u64 per kind in
// counter/gauge/set/histo order — [allocated slots, cumulative dropped,
// capacity]. Takes key_mu shared; safe to call from the pipeline thread
// while ring workers parse.
void vt_table_stats(void* hp, uint64_t* out) {
  auto* p = (Parser*)hp;
  std::shared_lock<std::shared_mutex> lk(p->key_mu);
  const KindTable* ts[4] = {&p->counters, &p->gauges, &p->sets,
                            &p->histos};
  for (int i = 0; i < 4; i++) {
    uint64_t used = 0;
    for (uint32_t nf : ts[i]->next_free) used += nf;
    out[i * 3 + 0] = used;
    out[i * 3 + 1] = ts[i]->dropped;
    out[i * 3 + 2] = ts[i]->capacity;
  }
}

// Batch FNV-1a 64 over concatenated byte strings (offsets has n+1
// entries). Standalone — no parser handle; used for count-min member
// hashing where a per-member Python byte loop dominated the sketch path.
void vt_hash64_batch(const char* buf, const int64_t* offsets, int n,
                     uint64_t* out) {
  for (int i = 0; i < n; i++)
    out[i] = fnv64(buf + offsets[i], (size_t)(offsets[i + 1] - offsets[i]));
}

void vt_stats(void* hp, uint64_t* out) {
  auto* p = (Parser*)hp;
  out[0] = p->processed.load(std::memory_order_relaxed);
  out[1] = p->parse_errors.load(std::memory_order_relaxed);
  std::shared_lock<std::shared_mutex> lk(p->key_mu);
  out[2] = p->counters.dropped + p->gauges.dropped + p->sets.dropped +
           p->histos.dropped;
}

// The routing digest the collective key table shards on
// (collective/keytable.py route_digest): fnv1a-32 over name, then the
// lowercase kind string, then the joined tags — exactly the running `h`
// parse_line feeds slot_for, exported so a test can pin C++/Python
// byte-parity over raw (surrogateescape) corpora.
uint32_t vt_route_digest(const char* name, int name_len, const char* kind,
                         int kind_len, const char* tags, int tags_len) {
  uint32_t h = fnv32(name, (size_t)name_len, FNV32_OFFSET);
  h = fnv32(kind, (size_t)kind_len, h);
  return fnv32(tags, (size_t)tags_len, h);
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native metricpb import decoder (vi_import): the global tier's gRPC
// /forwardrpc.Forward/SendMetrics payload (a serialized
// forwardrpc.MetricList — veneur_tpu/proto/{forwardrpc,metricpb,
// tdigestpb}.proto, wire-compatible with the reference's
// forwardrpc/forward.proto) decoded with a hand-rolled proto3 walker and
// staged STRAIGHT into the batch lanes, the import-path mirror of the
// wire parse path (reference importsrv/server.go:97 SendMetrics →
// worker.go:438 ImportMetricGRPC). Counters, gauges, and
// histogram/timer digests (the fleet bulk) stage natively; sets,
// valueless metrics, and any type/value oneof mismatch are handed back
// as (offset, length) spans for the Python slow path, which preserves
// the reference's per-metric error accounting exactly.

namespace {

inline bool rd_varint(const char* p, int len, int* off, uint64_t* v) {
  uint64_t out = 0;
  int shift = 0;
  while (*off < len && shift < 64) {
    uint8_t b = (uint8_t)p[(*off)++];
    out |= (uint64_t)(b & 0x7f) << shift;
    if (!(b & 0x80)) {
      *v = out;
      return true;
    }
    shift += 7;
  }
  return false;
}

inline bool skip_field(const char* p, int len, int* off, int wt) {
  uint64_t v;
  switch (wt) {
    case 0: return rd_varint(p, len, off, &v);
    case 1: if (*off + 8 > len) return false; *off += 8; return true;
    case 2:
      if (!rd_varint(p, len, off, &v)) return false;
      if (v > (uint64_t)(len - *off)) return false;
      *off += (int)v;
      return true;
    case 5: if (*off + 4 > len) return false; *off += 4; return true;
    default: return false;
  }
}

inline double rd_double_fixed(const char* p) {
  double d;
  memcpy(&d, p, 8);
  return d;
}

// enum Type names, capitalized — the digest hashes Type.String()
// (reference importsrv/server.go:141-148 hashMetric)
constexpr const char* kTypeNames[5] = {"Counter", "Gauge", "Histogram",
                                       "Set", "Timer"};
constexpr int kTypeNameLen[5] = {7, 5, 9, 3, 5};
// metricpb.Type enum -> engine kind byte (convert.py _TYPE_NAMES)
constexpr int kTypeKind[5] = {K_COUNTER, K_GAUGE, K_HISTO, K_SET, K_TIMER};

struct MetricView {
  const char* name = nullptr;
  int name_len = 0;
  uint64_t type = 0;
  uint64_t scope = 0;
  int which = 0;        // last value-oneof field seen (proto3: last wins)
  const char* val = nullptr;
  int val_len = 0;
};

// parse one metricpb.Metric submessage; tags collected into `tags`
inline bool parse_metric_view(const char* p, int len, MetricView* m,
                              std::vector<std::pair<const char*, size_t>>*
                                  tags) {
  int off = 0;
  tags->clear();
  while (off < len) {
    uint64_t key;
    if (!rd_varint(p, len, &off, &key)) return false;
    int field = (int)(key >> 3), wt = (int)(key & 7);
    if (wt == 2) {
      uint64_t n;
      if (!rd_varint(p, len, &off, &n)) return false;
      if (n > (uint64_t)(len - off)) return false;
      const char* body = p + off;
      off += (int)n;
      switch (field) {
        case 1: m->name = body; m->name_len = (int)n; break;
        case 2: tags->emplace_back(body, (size_t)n); break;
        case 5: case 6: case 7: case 8:
          m->which = field; m->val = body; m->val_len = (int)n; break;
        default: break;
      }
    } else {
      uint64_t v;
      if (wt == 0) {
        if (!rd_varint(p, len, &off, &v)) return false;
        if (field == 3) m->type = v;
        else if (field == 9) m->scope = v;
      } else if (!skip_field(p, len, &off, wt)) {
        return false;
      }
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode + stage a serialized forwardrpc.MetricList. Returns the number
// of metrics staged natively; *consumed reports how many input bytes
// were fully handled (always a top-level field boundary — re-enter with
// data+consumed after emitting when staging filled). Fallback spans
// (Python slow path) are (offset-within-data, length) pairs of Metric
// submessages; if fb_cap would overflow, decoding stops early.
int vi_import(void* hp, const char* data, int len, int start,
              int* consumed, int32_t* fb_off, int32_t* fb_len, int fb_cap,
              int* n_fb, int* full_stop) {
  auto* p = (Parser*)hp;
  p->alloc_imported = true;
  int staged = 0;   // metrics HANDLED natively (capacity drops included,
                    // matching the Python path's imported_total)
  *n_fb = 0;
  *full_stop = 0;
  int off = start;
  *consumed = start;
  while (off < len) {
    int metric_start = off;
    uint64_t key;
    if (!rd_varint(data, len, &off, &key)) break;  // truncated tail
    int field = (int)(key >> 3), wt = (int)(key & 7);
    if (field != 1 || wt != 2) {      // unknown top-level field: skip
      if (!skip_field(data, len, &off, wt)) break;
      *consumed = off;
      continue;
    }
    uint64_t n;
    if (!rd_varint(data, len, &off, &n)) break;
    if (n > (uint64_t)(len - off)) break;
    const char* body = data + off;
    int body_off = off;
    off += (int)n;

    MetricView m;
    bool ok = parse_metric_view(body, (int)n, &m, &p->tag_views);
    bool native = ok && m.name && m.type < 5 &&
                  ((m.type == 0 && m.which == 5) ||     // Counter
                   (m.type == 1 && m.which == 6) ||     // Gauge
                   ((m.type == 2 || m.type == 4) && m.which == 7));
    if (!native) {
      if (*n_fb >= fb_cap) {    // drain fallbacks first, then re-enter
        p->alloc_imported = false;
        return staged;
      }
      fb_off[*n_fb] = body_off;
      fb_len[(*n_fb)++] = (int)n;
      *consumed = off;
      continue;
    }

    // capacity check BEFORE staging so a metric never half-stages;
    // histograms need one histo-lane row per centroid (count them)
    int need_h = 0;
    if (m.which == 7) {
      // HistogramValue { tdigest.MergingDigestData t_digest = 1 }
      int o2 = 0;
      const char* hv = m.val;
      uint64_t k2, n2;
      const char* td = nullptr;
      int td_len = 0;
      while (o2 < m.val_len) {
        if (!rd_varint(hv, m.val_len, &o2, &k2)) { td = nullptr; break; }
        if ((k2 >> 3) == 1 && (k2 & 7) == 2) {
          if (!rd_varint(hv, m.val_len, &o2, &n2) ||
              n2 > (uint64_t)(m.val_len - o2)) { td = nullptr; break; }
          td = hv + o2;
          td_len = (int)n2;
          o2 += (int)n2;
        } else if (!skip_field(hv, m.val_len, &o2, (int)(k2 & 7))) {
          td = nullptr;
          break;
        }
      }
      if (!td) {   // malformed digest wrapper -> Python (error counting)
        if (*n_fb >= fb_cap) {
          p->alloc_imported = false;
          return staged;
        }
        fb_off[*n_fb] = body_off;
        fb_len[(*n_fb)++] = (int)n;
        *consumed = off;
        continue;
      }
      m.val = td;             // walk the MergingDigestData directly
      m.val_len = td_len;
      int o3 = 0;
      uint64_t k3, n3;
      while (o3 < td_len) {
        if (!rd_varint(td, td_len, &o3, &k3)) break;
        if ((k3 >> 3) == 1 && (k3 & 7) == 2) {
          if (!rd_varint(td, td_len, &o3, &n3) ||
              n3 > (uint64_t)(td_len - o3)) break;
          o3 += (int)n3;
          need_h++;
        } else if (!skip_field(td, td_len, &o3, (int)(k3 & 7))) {
          break;
        }
      }
      if ((uint32_t)need_h > p->bh) {  // digest larger than a whole
        if (*n_fb >= fb_cap) {          // batch: Python path
          p->alloc_imported = false;
          return staged;
        }
        fb_off[*n_fb] = body_off;
        fb_len[(*n_fb)++] = (int)n;
        *consumed = off;
        continue;
      }
    }
    bool full = (m.which == 5 && p->nc >= p->bc) ||
                (m.which == 6 && p->ng >= p->bg) ||
                (m.which == 7 && p->nh + need_h > p->bh);
    if (full) {
      *consumed = metric_start;   // emit, then re-enter at this metric
      *full_stop = 1;             // distinguishes from an undecodable
      p->alloc_imported = false;  // boundary (which makes no progress
      return staged;              // AND isn't a lane stop)
    }

    // digest: fnv1a-32 over name, Type.String(), then each tag
    // (reference importsrv/server.go:141-148; convert.py metric_digest)
    uint32_t digest = fnv32(m.name, (size_t)m.name_len, FNV32_OFFSET);
    digest = fnv32(kTypeNames[m.type], (size_t)kTypeNameLen[m.type],
                   digest);
    p->joined.clear();
    for (size_t i = 0; i < p->tag_views.size(); i++) {
      digest = fnv32(p->tag_views[i].first, p->tag_views[i].second,
                     digest);
      if (i) p->joined.push_back(',');
      p->joined.append(p->tag_views[i].first, p->tag_views[i].second);
    }

    int kind = kTypeKind[m.type];
    // scope coercion (convert.py import_into / worker.go:442-447):
    // counters/gauges arriving via import are global by definition;
    // histos keep Global else collapse to mixed
    uint8_t scope = (kind == K_COUNTER || kind == K_GAUGE)
                        ? 2 : (m.scope == 2 ? 2 : 0);
    KindTable* t = (kind == K_COUNTER) ? &p->counters
                   : (kind == K_GAUGE) ? &p->gauges : &p->histos;
    int32_t slot = p->slot_for(*t, (uint8_t)kind, scope, m.name,
                               (size_t)m.name_len, digest);
    if (slot < 0) {   // capacity drop, counted in t->dropped —
      staged++;       // still a HANDLED metric (imported_total parity
      p->processed++; // with the Python path, which counts before drops)
      *consumed = off;
      continue;
    }

    if (m.which == 5) {            // CounterValue { int64 value = 1 }
      int o2 = 0;
      uint64_t k2, v2 = 0;
      while (o2 < m.val_len) {
        if (!rd_varint(m.val, m.val_len, &o2, &k2)) break;
        if ((k2 >> 3) == 1 && (k2 & 7) == 0) {
          if (!rd_varint(m.val, m.val_len, &o2, &v2)) break;
        } else if (!skip_field(m.val, m.val_len, &o2, (int)(k2 & 7))) {
          break;
        }
      }
      p->c_slot[p->nc] = slot;
      p->c_inc[p->nc++] = (float)(double)(int64_t)v2;
    } else if (m.which == 6) {     // GaugeValue { double value = 1 }
      int o2 = 0;
      uint64_t k2;
      double v2 = 0;
      while (o2 < m.val_len) {
        if (!rd_varint(m.val, m.val_len, &o2, &k2)) break;
        if ((k2 >> 3) == 1 && (k2 & 7) == 1) {
          if (o2 + 8 > m.val_len) break;
          v2 = rd_double_fixed(m.val + o2);
          o2 += 8;
        } else if (!skip_field(m.val, m.val_len, &o2, (int)(k2 & 7))) {
          break;
        }
      }
      p->g_slot[p->ng] = slot;
      p->g_val[p->ng++] = (float)v2;
    } else {                       // MergingDigestData (unwrapped above)
      // proto3 elides default fields: absent min/max/reciprocalSum
      // mean 0.0 on the wire, and the Python path stages exactly that
      // (convert.py reads td.min etc., getting the proto3 default) —
      // +-inf sentinels here would silently no-op the scatter-min/max
      double mn = 0.0, mx = 0.0, recip = 0;
      double readd_recip = 0;      // f32-cast sum like the Python path
      bool all_nonzero = true;
      int o3 = 0;
      uint64_t k3, n3;
      while (o3 < m.val_len) {
        if (!rd_varint(m.val, m.val_len, &o3, &k3)) break;
        int f3 = (int)(k3 >> 3), w3 = (int)(k3 & 7);
        if (f3 == 1 && w3 == 2) {  // Centroid { mean=1 weight=2 }
          if (!rd_varint(m.val, m.val_len, &o3, &n3) ||
              n3 > (uint64_t)(m.val_len - o3)) break;
          const char* c = m.val + o3;
          o3 += (int)n3;
          double mean = 0, weight = 0;
          int oc = 0;
          uint64_t kc;
          while (oc < (int)n3) {
            if (!rd_varint(c, (int)n3, &oc, &kc)) break;
            int fc = (int)(kc >> 3);
            if ((kc & 7) == 1 && oc + 8 <= (int)n3) {
              double d = rd_double_fixed(c + oc);
              oc += 8;
              if (fc == 1) mean = d;
              else if (fc == 2) weight = d;
            } else if (!skip_field(c, (int)n3, &oc, (int)(kc & 7))) {
              break;
            }
          }
          float fm = (float)mean, fw = (float)weight;
          if (fw > 0) {            // live-centroid filter (import_metric)
            p->h_slot[p->nh] = slot;
            p->h_val[p->nh] = fm;
            p->h_wt[p->nh++] = fw;
            if (fm == 0.0f) all_nonzero = false;
            else readd_recip += (double)(fw / fm);
          }
        } else if (w3 == 1 && o3 + 8 <= m.val_len) {
          double d = rd_double_fixed(m.val + o3);
          o3 += 8;
          if (f3 == 3) mn = d;
          else if (f3 == 4) mx = d;
          else if (f3 == 5) recip = d;
        } else if (!skip_field(m.val, m.val_len, &o3, w3)) {
          break;
        }
      }
      double corr = all_nonzero ? recip - readd_recip : 0;
      p->import_stats.push_back(ImportStat{slot, (float)mn, (float)mx,
                                           (float)corr});
    }
    staged++;
    p->processed++;
    *consumed = off;
  }
  p->alloc_imported = false;
  return staged;
}

// Drain the per-imported-histogram stats staged by vi_import. Returns
// the count written (≤ cap); remaining entries stay queued.
int vi_stats(void* hp, int32_t* slot, float* mn, float* mx, float* recip,
             int cap) {
  auto* p = (Parser*)hp;
  int n = (int)p->import_stats.size();
  if (n > cap) n = cap;
  for (int i = 0; i < n; i++) {
    const auto& s = p->import_stats[i];
    slot[i] = s.slot;
    mn[i] = s.mn;
    mx[i] = s.mx;
    recip[i] = s.recip_corr;
  }
  p->import_stats.erase(p->import_stats.begin(),
                        p->import_stats.begin() + n);
  return n;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Native UDP reader group: N C++ threads recvmmsg into a shared datagram
// ring; the pipeline thread drains it via vr_pump (GIL released during the
// ctypes call), so neither the socket reads nor the parse hold the GIL.
// This replaces the Python per-datagram recv -> queue.put loop, whose
// interpreter overhead capped ingest around 6k datagrams/s and produced
// the 31% drop fraction in BASELINE config 1. The reference gets the same
// effect with N reader goroutines (networking.go:41-91); goroutines are
// free, Python threads are not, hence the native group.

namespace {

// In-ring admission control: the OverloadController's statsd-source
// admission decision (reliability/overload.py OverloadController.admit)
// replicated at the ring boundary so the native path honors the same
// shedding guarantees as _process_packets instead of bypassing them.
// State is pushed down on every controller poll (vr_admission_set) and
// exact per-class counts are drained back (vr_admission_counters), so
// sent == admitted + shed stays exact with the decision running off-GIL.
struct Admission {
  bool enabled = false;
  int state = 0;                      // 0 HEALTHY .. 3 CRITICAL
  double rate = 0.0, burst = 0.0;     // token bucket params (rate<=0: allow)
  std::vector<std::string> high_tags; // shed_priority_tags substrings
  // token buckets: [0] = "statsd" (low), [1] = "statsd/high"
  double tokens[2] = {0.0, 0.0};
  std::chrono::steady_clock::time_point last[2];
  bool primed = false;
  // exact per-class accounting: [self, high, low]
  uint64_t admitted[3] = {0, 0, 0};
  uint64_t shed[3] = {0, 0, 0};
  // exact per-(tenant, class) accounting (guarded by the owning mutex):
  // [admitted self/high/low, shed self/high/low]. Populated whenever the
  // tenant table is enabled — tenant accounting stays exact even with
  // class admission off.
  std::unordered_map<int32_t, std::array<uint64_t, 6>> per_tenant;
};

struct ReaderGroup {
  void* parser = nullptr;
  std::vector<std::thread> threads;
  std::vector<int> owned_fds;  // dup()s — closed in vr_stop after join
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::string> ring;   // one entry per datagram
  size_t ring_cap = 0;
  uint64_t ring_dropped = 0;      // guarded by mu
  uint64_t datagrams = 0;         // guarded by mu
  uint64_t toolong = 0;           // guarded by mu; MSG_TRUNC drops
  uint64_t ring_highwater = 0;    // guarded by mu; max depth ever seen
  uint64_t pump_batches = 0;      // guarded by mu; vr_pump calls that parsed
  uint64_t pump_stalls = 0;       // guarded by mu; vr_pump forced a swap
  Admission adm;                  // guarded by mu
  // datagram whose parse hit a full lane, parked whole with a resume
  // offset (no remainder copy)
  std::string tail;
  size_t tail_off = 0;
};

// Priority classes mirror reliability/overload.py PriorityClassifier:
// self-metrics (never shed) / high (shed last) / low.
enum { CLS_SELF = 0, CLS_HIGH = 1, CLS_LOW = 2 };

int classify_datagram(const Admission& a, const char* p, size_t n) {
  static const char kSelf1[] = "veneur.";
  static const char kSelf2[] = "veneur_tpu.";
  if ((n >= sizeof(kSelf1) - 1 && !memcmp(p, kSelf1, sizeof(kSelf1) - 1)) ||
      (n >= sizeof(kSelf2) - 1 && !memcmp(p, kSelf2, sizeof(kSelf2) - 1)))
    return CLS_SELF;
  for (const auto& tag : a.high_tags) {
    if (tag.empty() || tag.size() > n) continue;
    if (memmem(p, n, tag.data(), tag.size()) != nullptr) return CLS_HIGH;
  }
  return CLS_LOW;
}

// TokenBucket.allow (overload.py:63-84) under the ring mutex. rate<=0
// means the bucket is disabled (always admit), matching _bucket_allow.
bool bucket_allow(Admission& a, int which,
                  std::chrono::steady_clock::time_point now) {
  if (a.rate <= 0.0) return true;
  double burst = a.burst > 0.0 ? a.burst : a.rate;
  if (!a.primed) {
    a.tokens[0] = a.tokens[1] = burst;
    a.last[0] = a.last[1] = now;
    a.primed = true;
  }
  double dt = std::chrono::duration<double>(now - a.last[which]).count();
  a.last[which] = now;
  double t = a.tokens[which] + dt * a.rate;
  if (t > burst) t = burst;
  if (t >= 1.0) {
    a.tokens[which] = t - 1.0;
    return true;
  }
  a.tokens[which] = t;
  return false;
}

// OverloadController.admit for source="statsd", states per overload.py:
// HEALTHY(0) admits all; self never shed; high-priority admits until
// CRITICAL(3) then runs the "statsd/high" bucket; low is shed outright
// at SHEDDING(2)+ and bucketed at PRESSURED(1). Returns true to admit;
// counts either way.
// Apply pushed-down controller knobs to one Admission (caller holds the
// owning mutex). Rate/burst changes re-prime the buckets on the next
// decision.
void apply_admission(Admission& a, int enabled, int state, double rate,
                     double burst, const char* tags, int tags_len) {
  if (a.rate != rate || a.burst != burst) a.primed = false;
  a.enabled = enabled != 0;
  a.state = state;
  a.rate = rate;
  a.burst = burst;
  a.high_tags.clear();
  const char* p = tags;
  const char* end = tags + (tags_len > 0 ? tags_len : 0);
  while (p && p < end) {
    const char* nl = (const char*)memchr(p, '\n', (size_t)(end - p));
    size_t n = nl ? (size_t)(nl - p) : (size_t)(end - p);
    if (n) a.high_tags.emplace_back(p, n);
    p += n + 1;
  }
}

bool admit_datagram(Admission& a, const char* p, size_t n,
                    std::chrono::steady_clock::time_point now) {
  int cls = classify_datagram(a, p, n);
  bool ok;
  if (a.state <= 0 || cls == CLS_SELF) {
    ok = true;
  } else if (cls == CLS_HIGH) {
    ok = a.state < 3 || bucket_allow(a, 1, now);
  } else if (a.state >= 2) {
    ok = false;
  } else {
    ok = bucket_allow(a, 0, now);
  }
  if (ok) a.admitted[cls]++; else a.shed[cls]++;
  return ok;
}

// Tenant-aware admission ladder: the per-class decision above, with the
// tenant's weighted bucket layered under it at SHEDDING(2)+ — a tenant
// over its fair share is throttled to its bucket while isolated tenants
// keep their full budget (low-class traffic that the class ladder would
// shed outright at SHEDDING+ instead runs the tenant bucket). Per-class
// counters bump only when class admission is enabled (preserving the
// pre-tenant counter contract); per-(tenant, class) counters bump
// whenever a tenant entry is attached.
bool admit_datagram2(Admission& a, TenantTable* tt, TenantEntry* te,
                     int32_t tenant, const char* p, size_t n,
                     std::chrono::steady_clock::time_point now) {
  int cls = classify_datagram(a, p, n);
  bool fair =
      tt && te && tt->base_rate.load(std::memory_order_relaxed) > 0.0;
  bool ok;
  if (!a.enabled || a.state <= 0 || cls == CLS_SELF) {
    ok = true;
  } else if (cls == CLS_HIGH) {
    ok = a.state < 3 || bucket_allow(a, 1, now);
    if (ok && fair && a.state >= 2) ok = tenant_allow(*tt, *te, now);
  } else if (a.state >= 2) {
    ok = fair ? tenant_allow(*tt, *te, now) : false;
  } else {
    ok = bucket_allow(a, 0, now);
  }
  if (a.enabled) {
    if (ok) a.admitted[cls]++; else a.shed[cls]++;
  }
  if (te) a.per_tenant[tenant][(ok ? 0 : 3) + cls]++;
  return ok;
}

// recvmmsg(MSG_WAITFORONE): block for the first datagram (up to the
// socket's SO_RCVTIMEO), then take what else is queued without waiting.
// Some kernels refuse the flag with EINVAL (gVisor's, for one); there
// the same batch is read in two calls, a blocking one for the first
// datagram and a MSG_DONTWAIT one for the rest. The refusal is
// remembered process-wide, so it costs one failed call.
std::atomic<bool> g_no_waitforone{false};

int recv_batch(int fd, mmsghdr* msgs, int vlen) {
  if (!g_no_waitforone.load(std::memory_order_relaxed)) {
    int n = recvmmsg(fd, msgs, vlen, MSG_WAITFORONE, nullptr);
    if (n >= 0 || errno != EINVAL) return n;
    g_no_waitforone.store(true, std::memory_order_relaxed);
  }
  int n = recvmmsg(fd, msgs, 1, 0, nullptr);
  if (n != 1 || vlen == 1) return n;
  int more = recvmmsg(fd, msgs + 1, vlen - 1, MSG_DONTWAIT, nullptr);
  return more > 0 ? 1 + more : 1;
}

void reader_main(ReaderGroup* g, int fd, int max_len) {
  constexpr int VLEN = 64;
  std::vector<std::vector<char>> bufs(VLEN, std::vector<char>(max_len));
  mmsghdr msgs[VLEN];
  iovec iovs[VLEN];
  // a receive timeout lets the thread observe the stop flag; fd is our
  // own dup (vr_start), closed in vr_stop after this thread joins
  struct timeval tv;
  tv.tv_sec = 0;
  tv.tv_usec = 200 * 1000;
  setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  while (!g->stop.load(std::memory_order_relaxed)) {
    for (int i = 0; i < VLEN; i++) {
      iovs[i].iov_base = bufs[i].data();
      iovs[i].iov_len = (size_t)max_len;
      memset(&msgs[i], 0, sizeof(msgs[i]));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    int n = recv_batch(fd, msgs, VLEN);
    if (n <= 0) {
      // rcvtimeo/EINTR: just recheck stop. A persistent error (EBADF —
      // shutdown closed the fd before we were joined) must not busy-spin.
      if (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
          errno != EINTR)
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
      continue;
    }
    {
      std::lock_guard<std::mutex> lk(g->mu);
      for (int i = 0; i < n; i++) {
        g->datagrams++;
        // buffers are sized metric_max_length+1: a datagram the kernel
        // truncated (MSG_TRUNC) exceeded the configured limit — drop
        // the whole packet and count it, like the reference's
        // processMetricPacket "toolong" guard (server.go:1082)
        // MSG_TRUNC only fires when the datagram EXCEEDS the buffer; a
        // datagram of exactly max_len (= limit+1) bytes fits, so the
        // length check catches the boundary case the flag misses —
        // keeping this path byte-identical to the Python reader's
        // `len(data) > limit`
        if ((msgs[i].msg_hdr.msg_flags & MSG_TRUNC) ||
            msgs[i].msg_len >= (unsigned)max_len) {
          g->toolong++;
          continue;
        }
        // admission runs here — before the ring, off the GIL — so a shed
        // datagram costs one classify, not a parse + Python round-trip.
        // Every under-limit datagram is counted exactly once as admitted
        // or shed (ring-full drops below are post-admission and counted
        // separately), preserving sent == admitted + shed.
        if (g->adm.enabled &&
            !admit_datagram(g->adm, bufs[i].data(), (size_t)msgs[i].msg_len,
                            std::chrono::steady_clock::now()))
          continue;
        if (g->ring.size() >= g->ring_cap) {
          g->ring_dropped++;  // kernel-rcvbuf-overflow analogue, counted
          continue;
        }
        g->ring.emplace_back(bufs[i].data(), (size_t)msgs[i].msg_len);
        if ((uint64_t)g->ring.size() > g->ring_highwater)
          g->ring_highwater = (uint64_t)g->ring.size();
      }
    }
    g->cv.notify_one();
  }
}

}  // namespace

extern "C" {

// Start n_fds reader threads (one per SO_REUSEPORT socket). Each fd is
// dup()ed into C++ ownership, so Python may close its socket objects at
// any point during shutdown without racing a reader's recvmmsg onto a
// recycled fd number; the dups are closed in vr_stop after the join.
void* vr_start(void* parser, const int* fds, int n_fds, int max_len,
               int ring_cap) {
  auto* g = new ReaderGroup();
  g->parser = parser;
  g->ring_cap = (size_t)(ring_cap > 0 ? ring_cap : 65536);
  for (int i = 0; i < n_fds; i++) {
    int own = dup(fds[i]);
    if (own < 0) continue;  // fd table exhausted; skip this reader
    g->owned_fds.push_back(own);
    g->threads.emplace_back(reader_main, g, own,
                            max_len > 0 ? max_len : 65536);
  }
  return g;
}

// Drain ring -> parser staging. Blocks up to max_wait_ms while the ring is
// empty (GIL is released for the whole call). Returns 1 when a staging
// lane filled — the caller must emit a batch and call again — else 0.
// out: [0]=datagrams parsed this call, [1]=ring depth now,
//      [2]=ring_dropped total, [3]=datagrams received total.
int vr_pump(void* gp, int max_wait_ms, uint64_t* out) {
  auto* g = (ReaderGroup*)gp;
  uint64_t parsed_dg = 0;
  int full = 0;
  int consumed = 0;
  if (g->tail_off < g->tail.size()) {
    full = vt_feed(g->parser, g->tail.data(), (int)g->tail.size(),
                   (int)g->tail_off, &consumed);
    g->tail_off = (size_t)consumed;
    if (!full) {
      g->tail.clear();
      g->tail_off = 0;
    }
  }
  std::string local;
  while (!full) {
    {
      std::unique_lock<std::mutex> lk(g->mu);
      if (g->ring.empty() && parsed_dg == 0 && max_wait_ms > 0)
        g->cv.wait_for(lk, std::chrono::milliseconds(max_wait_ms));
      if (g->ring.empty()) break;
      local = std::move(g->ring.front());
      g->ring.pop_front();
    }
    parsed_dg++;
    full = vt_feed(g->parser, local.data(), (int)local.size(), 0, &consumed);
    if (full) {
      // park the whole datagram with a resume offset — no remainder copy
      g->tail = std::move(local);
      g->tail_off = (size_t)consumed;
    }
  }
  {
    std::lock_guard<std::mutex> lk(g->mu);
    out[1] = (uint64_t)g->ring.size();
    out[2] = g->ring_dropped;
    out[3] = g->datagrams;
    if (parsed_dg > 0) g->pump_batches++;
    if (full) g->pump_stalls++;  // staging lane filled: forced buffer swap
  }
  out[0] = parsed_dg;
  return full;
}

// Push the OverloadController's current admission knobs down into the
// ring (called from the controller's poll thread and at reader start).
// `tags` is a '\n'-joined shed_priority_tags list (tags_len bytes; may be
// empty). Rate/burst changes re-prime the buckets on the next decision.
void vr_admission_set(void* gp, int enabled, int state, double rate,
                      double burst, const char* tags, int tags_len) {
  auto* g = (ReaderGroup*)gp;
  std::lock_guard<std::mutex> lk(g->mu);
  apply_admission(g->adm, enabled, state, rate, burst, tags, tags_len);
}

// Drain-and-reset the exact per-class admission deltas so the controller
// can fold them into its registry counters: out = [admitted_self,
// admitted_high, admitted_low, shed_self, shed_high, shed_low].
void vr_admission_counters(void* gp, uint64_t* out) {
  auto* g = (ReaderGroup*)gp;
  std::lock_guard<std::mutex> lk(g->mu);
  for (int i = 0; i < 3; i++) {
    out[i] = g->adm.admitted[i];
    out[3 + i] = g->adm.shed[i];
    g->adm.admitted[i] = 0;
    g->adm.shed[i] = 0;
  }
}

// Thread-safe counter snapshot (any thread): [0]=datagrams received,
// [1]=ring_dropped, [2]=ring depth, [3]=toolong drops.
void vr_counters(void* gp, uint64_t* out) {
  auto* g = (ReaderGroup*)gp;
  std::lock_guard<std::mutex> lk(g->mu);
  out[0] = g->datagrams;
  out[1] = g->ring_dropped;
  out[2] = (uint64_t)g->ring.size();
  out[3] = g->toolong;
}

// Deep ring/emit telemetry snapshot (any thread, one lock, no allocation):
// [0]=ring depth now, [1]=ring depth high-water, [2]=pump batches (vr_pump
// calls that parsed >=1 datagram), [3]=buffer-swap stalls (vr_pump returned
// full), [4]=emit_packed calls, [5]=emit_packed ns total, [6]=datagrams
// received, [7]=ring_dropped. Per-class admission is NOT repeated here —
// vr_admission_counters already drains it exactly.
void vr_stats(void* gp, uint64_t* out) {
  auto* g = (ReaderGroup*)gp;
  {
    std::lock_guard<std::mutex> lk(g->mu);
    out[0] = (uint64_t)g->ring.size();
    out[1] = g->ring_highwater;
    out[2] = g->pump_batches;
    out[3] = g->pump_stalls;
    out[6] = g->datagrams;
    out[7] = g->ring_dropped;
  }
  auto* p = (Parser*)g->parser;
  out[4] = p->emit_packed_calls.load(std::memory_order_relaxed);
  out[5] = p->emit_packed_ns.load(std::memory_order_relaxed);
}

void vr_stop(void* gp) {
  auto* g = (ReaderGroup*)gp;
  g->stop.store(true);
  for (auto& t : g->threads)
    if (t.joinable()) t.join();
  for (int fd : g->owned_fds) close(fd);
  delete g;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Multi-ring reader groups (vrm_*): one ring + parser + staging pair per
// reader core. The single-ring design above parses on the pipeline thread
// (vr_pump), which caps the host at one core of parse; here each ring owns
// a reader thread (recvmmsg -> ring, optional) AND a worker thread (ring ->
// parse -> staging), so N rings parse on N cores concurrently while the
// pipeline thread only memcpys staged lanes into its packed arena rows and
// steps the device. All rings share the master parser's key tables (see
// Parser::slot_for: ring-local replica cache, shared lock on miss), so a
// flow-hashed key landing on any ring maps to the same device slot.
// Admission, toolong, and ring-cap accounting run per ring with the same
// datagrams == toolong + admitted + shed invariant, summed by Python.

namespace {

struct MultiRing;

// One queued datagram plus the tenant identity resolved at admission time
// (ring_push), so the worker parses under the same identity the admission
// decision was charged to — re-extracting at parse time could disagree
// after a weights push or intern-cap overflow.
struct Dgram {
  std::string data;
  TenantEntry* te = nullptr;
  int32_t tenant = 0;
};

struct Ring {
  Parser parser;                 // staging + key cache; tables -> master
  int fd = -1;                   // dup()ed socket; -1 = inject-only ring
  int max_len = 65536;
  int pin_core = -1;
  std::thread reader;
  std::thread worker;
  std::mutex mu;                 // ring deque + counters + admission
  std::condition_variable cv;        // ring became non-empty
  std::condition_variable space_cv;  // staging emitted / resumed
  std::deque<Dgram> ring;
  size_t ring_cap = 65536;
  // ring-local tenant-id replica (guarded by mu): hits skip the shared
  // intern table's mutex, mirroring the key-table local_cache pattern
  std::unordered_map<std::string, std::pair<int32_t, TenantEntry*>> tcache;
  uint64_t datagrams = 0;        // guarded by mu
  uint64_t toolong = 0;          // guarded by mu
  uint64_t ring_dropped = 0;     // guarded by mu
  uint64_t ring_highwater = 0;   // guarded by mu
  uint64_t parse_batches = 0;    // guarded by mu; datagrams parsed
  uint64_t stalls = 0;           // guarded by mu; staging filled mid-parse
  Admission adm;                 // guarded by mu
  std::atomic<bool> stalled{false};
  std::mutex stage_mu;           // staging lanes: worker parse vs emit
};

struct MultiRing {
  Parser* master = nullptr;
  std::vector<std::unique_ptr<Ring>> rings;
  std::atomic<bool> stop{false};
  std::atomic<bool> pause{false};        // swap-boundary quiesce
  std::mutex wait_mu;
  std::condition_variable wait_cv;       // pipeline wakeup
};

void pin_self(int core) {
  if (core < 0) return;
  cpu_set_t set;
  CPU_ZERO(&set);
  CPU_SET(core, &set);
  pthread_setaffinity_np(pthread_self(), sizeof(set), &set);
}

// Shared push for the socket reader and the inject path so bench traffic
// hits the same invariant: every arriving datagram is counted exactly once
// as toolong, admitted, or shed (ring-full drops are post-admission and
// counted separately). Returns 1 when queued, 0 when counted-and-
// rejected (toolong / admission shed / ring-full drop).
//
// With `backpressure` (the inject path), a full ring returns -1 with NO
// counting at all: the caller holds the datagram and retries, and
// counting here would double-count it on the retry (the PR 19 footgun).
// The socket reader never passes backpressure — a kernel-delivered
// datagram cannot be retried, so a full ring must count it dropped.
int ring_push2(Ring* r, const char* data, size_t n, bool kernel_trunc,
               bool backpressure) {
  {
    std::lock_guard<std::mutex> lk(r->mu);
    // only the worker pops, so under r->mu the ring can only shrink —
    // checking before counting is race-free
    if (backpressure && r->ring.size() >= r->ring_cap) return -1;
    r->datagrams++;
    if (kernel_trunc || n >= (size_t)r->max_len) {
      r->toolong++;
      return 0;
    }
    // tenant identity resolves here, before admission, so the fairness
    // decision and the per-tenant shed count land on the same identity.
    // Lock order r->mu -> tt.mu (tenant_intern / tenant_allow); nothing
    // takes them in reverse.
    TenantTable* tt = r->parser.rt().tenants.get();
    TenantEntry* te = nullptr;
    int32_t tenant = 0;
    if (tt && tt->enabled.load(std::memory_order_relaxed)) {
      te = tt->dflt;
      const char* v = nullptr;
      size_t vlen = 0;
      if (tenant_extract(tt->tag, data, n, &v, &vlen)) {
        std::string key(v, vlen);
        auto it = r->tcache.find(key);
        if (it != r->tcache.end()) {
          tenant = it->second.first;
          te = it->second.second;
        } else {
          tenant = tenant_intern(*tt, v, vlen, &te);
          // an intern-cap overflow maps onto the default tenant; don't
          // cache that as this name's identity (the cap could in theory
          // be lifted by a restore re-interning in a different order)
          if (tenant != 0 || key == te->name)
            r->tcache.emplace(std::move(key), std::make_pair(tenant, te));
        }
      }
    }
    if ((r->adm.enabled || te) &&
        !admit_datagram2(r->adm, tt, te, tenant, data, n,
                         std::chrono::steady_clock::now()))
      return 0;
    if (r->ring.size() >= r->ring_cap) {
      r->ring_dropped++;
      return 0;
    }
    r->ring.push_back(Dgram{std::string(data, n), te, tenant});
    if ((uint64_t)r->ring.size() > r->ring_highwater)
      r->ring_highwater = (uint64_t)r->ring.size();
  }
  r->cv.notify_one();
  return 1;
}

bool ring_push(Ring* r, const char* data, size_t n, bool kernel_trunc) {
  return ring_push2(r, data, n, kernel_trunc, false) == 1;
}

void vrm_reader_main(MultiRing* mr, Ring* r) {
  pin_self(r->pin_core);
  constexpr int VLEN = 64;
  std::vector<std::vector<char>> bufs(VLEN, std::vector<char>(r->max_len));
  mmsghdr msgs[VLEN];
  iovec iovs[VLEN];
  struct timeval tv;
  tv.tv_sec = 0;
  tv.tv_usec = 200 * 1000;
  setsockopt(r->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  while (!mr->stop.load(std::memory_order_relaxed)) {
    for (int i = 0; i < VLEN; i++) {
      iovs[i].iov_base = bufs[i].data();
      iovs[i].iov_len = (size_t)r->max_len;
      memset(&msgs[i], 0, sizeof(msgs[i]));
      msgs[i].msg_hdr.msg_iov = &iovs[i];
      msgs[i].msg_hdr.msg_iovlen = 1;
    }
    int n = recv_batch(r->fd, msgs, VLEN);
    if (n <= 0) {
      if (n < 0 && errno != EAGAIN && errno != EWOULDBLOCK &&
          errno != EINTR)
        std::this_thread::sleep_for(std::chrono::milliseconds(50));
      continue;
    }
    for (int i = 0; i < n; i++)
      ring_push(r, bufs[i].data(), (size_t)msgs[i].msg_len,
                (msgs[i].msg_hdr.msg_flags & MSG_TRUNC) != 0);
  }
}

// Per-ring parse loop: pop one datagram, parse it into this ring's staging
// under stage_mu (held only for the parse itself). A full staging lane
// parks the datagram with its resume offset and waits for the pipeline to
// emit; the swap-boundary pause parks it the same way.
void vrm_worker_main(MultiRing* mr, Ring* r) {
  pin_self(r->pin_core);
  Dgram local;
  size_t off = 0;
  bool have = false;
  while (!mr->stop.load(std::memory_order_relaxed)) {
    if (!have) {
      std::unique_lock<std::mutex> lk(r->mu);
      if (r->ring.empty())
        r->cv.wait_for(lk, std::chrono::milliseconds(100));
      if (mr->stop.load(std::memory_order_relaxed)) break;
      if (r->ring.empty() || mr->pause.load(std::memory_order_relaxed))
        continue;
      local = std::move(r->ring.front());
      r->ring.pop_front();
      r->parse_batches++;
      off = 0;
      have = true;
    }
    bool full = false;
    bool parsed = false;
    bool rich = false;
    {
      std::unique_lock<std::mutex> lk(r->stage_mu);
      if (!mr->pause.load(std::memory_order_relaxed)) {
        // parse context: the tenant resolved at admission time, with the
        // demotion flag re-read per attempt so a parked datagram resumes
        // under the tenant's current quarantine state
        r->parser.cur_tenant = local.tenant;
        r->parser.cur_entry = local.te;
        r->parser.cur_demoted =
            local.te && local.te->demoted.load(std::memory_order_relaxed);
        int consumed = 0;
        full = vt_feed(&r->parser, local.data.data(),
                       (int)local.data.size(), (int)off, &consumed) != 0;
        off = (size_t)consumed;
        if (!full) have = false;
        parsed = true;
        Parser& p = r->parser;
        rich = p.nc * 2 >= p.bc || p.ng * 2 >= p.bg || p.ns * 2 >= p.bs ||
               p.nh * 2 >= p.bh;
      }
    }
    if (parsed && !full) {
      // opportunistic wake when lanes run half full so emits don't wait
      // for a hard stall (lost wakeups here only cost one wait timeout)
      if (rich) mr->wait_cv.notify_all();
      continue;
    }
    if (full) {
      {
        std::lock_guard<std::mutex> lk(r->mu);
        r->stalls++;
      }
      r->stalled.store(true, std::memory_order_release);
      // ordered notify: the pipeline checks stalled under wait_mu, so
      // taking it here makes the stall wakeup lossless
      { std::lock_guard<std::mutex> lk(mr->wait_mu); }
      mr->wait_cv.notify_all();
    }
    // stalled (wait for an emit) or paused (wait for resume)
    std::unique_lock<std::mutex> lk(r->mu);
    r->space_cv.wait_for(lk, std::chrono::milliseconds(50), [&] {
      return mr->stop.load(std::memory_order_relaxed) ||
             (!mr->pause.load(std::memory_order_relaxed) &&
              !r->stalled.load(std::memory_order_acquire));
    });
  }
}

}  // namespace

extern "C" {

// Start n_rings independent ingest lanes against the master parser.
// fds[i] >= 0 attaches a dup()ed SO_REUSEPORT socket to ring i (fds may be
// null / entries -1 for inject-only rings, e.g. benches). pin_cores[i] >= 0
// pins ring i's reader+worker threads to that core (null = no pinning).
void* vrm_start(void* parser, const int* fds, int n_rings, int max_len,
                int ring_cap, const int* pin_cores) {
  auto* mr = new MultiRing();
  auto* m = (Parser*)parser;
  mr->master = m;
  for (int i = 0; i < n_rings; i++) {
    auto r = std::make_unique<Ring>();
    r->max_len = max_len > 0 ? max_len : 65536;
    r->ring_cap = (size_t)(ring_cap > 0 ? ring_cap : 65536);
    r->pin_core = pin_cores ? pin_cores[i] : -1;
    r->parser.init(m->counters.capacity, m->gauges.capacity,
                   m->sets.capacity, m->histos.capacity,
                   m->counters.n_shards, m->hll_precision, m->bc, m->bg,
                   m->bs, m->bh);
    r->parser.master = m;
    if (fds && fds[i] >= 0) {
      int own = dup(fds[i]);
      if (own >= 0) r->fd = own;
    }
    mr->rings.push_back(std::move(r));
  }
  for (auto& r : mr->rings) {
    Ring* rp = r.get();
    if (rp->fd >= 0) rp->reader = std::thread(vrm_reader_main, mr, rp);
    rp->worker = std::thread(vrm_worker_main, mr, rp);
  }
  return mr;
}

int vrm_n_rings(void* h) { return (int)((MultiRing*)h)->rings.size(); }

// Queue one datagram onto ring i through the same toolong/admission/
// ring-cap accounting as the socket path (benches and tests use this for
// deterministic ring placement — SO_REUSEPORT flow hashing is opaque).
// Verdicts: 1 = queued, 0 = counted-and-rejected (toolong or admission
// shed — the datagrams == toolong + admitted + shed identity holds),
// -1 = backpressure: the ring is full and NOTHING was counted — the
// caller still owns the datagram and paces/retries without inflating
// any counter.
int vrm_inject(void* h, int ring, const char* data, int len) {
  auto* mr = (MultiRing*)h;
  return ring_push2(mr->rings[ring].get(), data, (size_t)len, false, true);
}

// Block the pipeline thread until a ring stalls on full staging (or the
// opportunistic half-full wake fires, or max_wait_ms passes). Returns the
// number of currently-stalled rings.
int vrm_wait(void* h, int max_wait_ms) {
  auto* mr = (MultiRing*)h;
  auto pred = [&] {
    if (mr->stop.load(std::memory_order_relaxed)) return true;
    for (auto& r : mr->rings) {
      if (r->stalled.load(std::memory_order_acquire)) return true;
      Parser& p = r->parser;
      if (p.nc * 2 >= p.bc || p.ng * 2 >= p.bg || p.ns * 2 >= p.bs ||
          p.nh * 2 >= p.bh)
        return true;
    }
    return false;
  };
  {
    std::unique_lock<std::mutex> lk(mr->wait_mu);
    if (max_wait_ms > 0 && !pred())
      mr->wait_cv.wait_for(lk, std::chrono::milliseconds(max_wait_ms),
                           pred);
  }
  int n = 0;
  for (auto& r : mr->rings)
    if (r->stalled.load(std::memory_order_acquire)) n++;
  return n;
}

// Staged rows across all rings (racy snapshot; idle heuristic only).
int vrm_pending(void* h) {
  auto* mr = (MultiRing*)h;
  uint64_t n = 0;
  for (auto& r : mr->rings) {
    Parser& p = r->parser;
    n += p.nc + p.ng + p.ns + p.nh;
  }
  return (int)n;
}

// Emit ring i's staged lanes into its packed arena row (same layout/
// sentinel contract as vt_emit_packed). stage_mu holds off the worker's
// parse for the copy; clearing the stall under the ring mutex makes the
// worker's resume wakeup lossless.
void vrm_emit(void* h, int ring, int32_t* buf, const int32_t* off,
              uint32_t* prev, uint32_t* counts_out) {
  auto* mr = (MultiRing*)h;
  Ring* r = mr->rings[ring].get();
  {
    std::lock_guard<std::mutex> lk(r->stage_mu);
    vt_emit_packed(&r->parser, buf, off, prev, counts_out);
  }
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stalled.store(false, std::memory_order_release);
  }
  r->space_cv.notify_all();
}

// Pre-sharded emit of ring i's staging (vt_emit_sharded semantics: rows
// grouped by owner shard, slots rebased shard-local, per-kind shard
// bounds). Same locking/stall discipline as vrm_emit — this is the
// sharded backend's per-ring drain.
void vrm_emit_sharded(void* h, int ring, int32_t* c_slot, float* c_inc,
                      int32_t* g_slot, float* g_val, int32_t* s_slot,
                      int32_t* s_reg, uint8_t* s_rho, int32_t* h_slot,
                      float* h_val, float* h_wt, int32_t* bounds,
                      uint32_t* counts_out) {
  auto* mr = (MultiRing*)h;
  Ring* r = mr->rings[ring].get();
  {
    std::lock_guard<std::mutex> lk(r->stage_mu);
    vt_emit_sharded(&r->parser, c_slot, c_inc, g_slot, g_val, s_slot,
                    s_reg, s_rho, h_slot, h_val, h_wt, bounds, counts_out);
  }
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stalled.store(false, std::memory_order_release);
  }
  r->space_cv.notify_all();
}

// Swap-boundary quiesce: after vrm_pause returns no worker is inside a
// parse and none will enter one until vrm_resume, so the caller can emit
// every ring and reset the shared tables without racing staged rows
// against a cleared key space.
void vrm_pause(void* h) {
  auto* mr = (MultiRing*)h;
  mr->pause.store(true, std::memory_order_release);
  for (auto& r : mr->rings) {
    // barrier: any in-flight parse (which checks pause under stage_mu)
    // completes before we proceed
    std::lock_guard<std::mutex> lk(r->stage_mu);
  }
}

void vrm_resume(void* h) {
  auto* mr = (MultiRing*)h;
  mr->pause.store(false, std::memory_order_release);
  for (auto& r : mr->rings) {
    { std::lock_guard<std::mutex> lk(r->mu); }
    r->space_cv.notify_all();
    r->cv.notify_all();
  }
}

// Flush boundary: reset the master tables and every ring's key-replica
// cache. Caller must hold the quiesce (vrm_pause) and have emitted all
// rings first.
void vrm_reset(void* h) {
  auto* mr = (MultiRing*)h;
  vt_reset(mr->master);
  for (auto& r : mr->rings) r->parser.local_cache.clear();
}

// Multi-ring shard-map staging: the rings route every table access to
// the master, so staging on the master covers all of them. Applied by
// the vrm_reset inside the next swap quiesce (ring local caches are
// cleared there too, so no ring can hit an old-map slot afterwards).
void vrm_shard_map_set(void* h, uint32_t n_shards) {
  auto* mr = (MultiRing*)h;
  vt_shard_map_set(mr->master, n_shards);
}

// Multi-ring capacity staging: the rings route every table access to the
// master, so staging there covers all of them; the local replica caches
// hold (key -> slot) entries that the vrm_reset inside the same quiesce
// clears before any ring can hit an old-capacity slot.
void vrm_capacity_set(void* h, uint32_t cc, uint32_t gc, uint32_t sc,
                      uint32_t hc) {
  auto* mr = (MultiRing*)h;
  vt_capacity_set(mr->master, cc, gc, sc, hc);
}

// Master-table occupancy snapshot (vt_table_stats layout): the rings
// share the master's slot space, so this IS the multi-ring occupancy.
void vrm_table_stats(void* h, uint64_t* out) {
  auto* mr = (MultiRing*)h;
  vt_table_stats(mr->master, out);
}

// Per-ring counter snapshot: [0]=datagrams, [1]=ring_dropped,
// [2]=ring depth, [3]=toolong (vr_counters layout).
void vrm_counters(void* h, int ring, uint64_t* out) {
  auto* mr = (MultiRing*)h;
  Ring* r = mr->rings[ring].get();
  std::lock_guard<std::mutex> lk(r->mu);
  out[0] = r->datagrams;
  out[1] = r->ring_dropped;
  out[2] = (uint64_t)r->ring.size();
  out[3] = r->toolong;
}

// Per-ring deep telemetry (vr_stats layout): [0]=ring depth, [1]=depth
// high-water, [2]=parse batches (datagrams parsed), [3]=staging stalls,
// [4]=emit calls, [5]=emit ns, [6]=datagrams received, [7]=ring_dropped.
void vrm_ring_stats(void* h, int ring, uint64_t* out) {
  auto* mr = (MultiRing*)h;
  Ring* r = mr->rings[ring].get();
  {
    std::lock_guard<std::mutex> lk(r->mu);
    out[0] = (uint64_t)r->ring.size();
    out[1] = r->ring_highwater;
    out[2] = r->parse_batches;
    out[3] = r->stalls;
    out[6] = r->datagrams;
    out[7] = r->ring_dropped;
  }
  out[4] = r->parser.emit_packed_calls.load(std::memory_order_relaxed);
  out[5] = r->parser.emit_packed_ns.load(std::memory_order_relaxed);
}

// Push controller admission knobs to every ring. The aggregate token rate
// and burst split evenly across rings so the host-level admit rate matches
// the single-ring contract while each ring buckets independently off-GIL.
void vrm_admission_set(void* h, int enabled, int state, double rate,
                       double burst, const char* tags, int tags_len) {
  auto* mr = (MultiRing*)h;
  double n = (double)mr->rings.size();
  double rr = rate > 0.0 ? rate / n : rate;
  double bb = burst > 0.0 ? burst / n : burst;
  for (auto& r : mr->rings) {
    std::lock_guard<std::mutex> lk(r->mu);
    apply_admission(r->adm, enabled, state, rr, bb, tags, tags_len);
  }
}

// Drain-and-reset ring i's exact per-class admission deltas
// (vr_admission_counters layout). Callers must fold across ALL rings.
void vrm_admission_counters(void* h, int ring, uint64_t* out) {
  auto* mr = (MultiRing*)h;
  Ring* r = mr->rings[ring].get();
  std::lock_guard<std::mutex> lk(r->mu);
  for (int i = 0; i < 3; i++) {
    out[i] = r->adm.admitted[i];
    out[3 + i] = r->adm.shed[i];
    r->adm.admitted[i] = 0;
    r->adm.shed[i] = 0;
  }
}

// Engine-wide parse stats summed over ring parsers + master (vt_stats
// layout: processed, parse_errors, table drops).
void vrm_stats(void* h, uint64_t* out) {
  auto* mr = (MultiRing*)h;
  uint64_t pr = 0, pe = 0;
  for (auto& r : mr->rings) {
    pr += r->parser.processed.load(std::memory_order_relaxed);
    pe += r->parser.parse_errors.load(std::memory_order_relaxed);
  }
  vt_stats(mr->master, out);
  out[0] += pr;
  out[1] += pe;
}

// ---- tenant identity / fairness / quarantine ABI ----
//
// vt_tenant_config must run before rings start (tt.tag is read lock-free
// on the admission path); everything else is safe at any time. All vt_*
// tenant calls target the MASTER parser handle.

// Create (or reconfigure) the tenant table. Interns "default" as id 0.
void vt_tenant_config(void* hp, int enabled, const char* tag, int tag_len,
                      double burst_mult, uint32_t q_max_keys,
                      double q_decay, double q_readmit_frac) {
  auto* p = (Parser*)hp;
  if (!p->tenants) {
    p->tenants = std::make_unique<TenantTable>();
    auto e = std::make_unique<TenantEntry>();
    e->name = "default";
    p->tenants->dflt = e.get();
    p->tenants->entries.push_back(std::move(e));
    p->tenants->by_name.emplace("default", 0);
  }
  TenantTable& tt = *p->tenants;
  {
    std::lock_guard<std::mutex> lk(tt.mu);
    tt.tag.assign(tag ? tag : "", tag && tag_len > 0 ? (size_t)tag_len : 0);
    tt.burst_mult = burst_mult > 0.0 ? burst_mult : 2.0;
    tt.q_max_keys = q_max_keys;
    tt.q_decay = q_decay >= 0.0 && q_decay < 1.0 ? q_decay : 0.5;
    tt.q_readmit_frac = q_readmit_frac > 0.0 ? q_readmit_frac : 0.5;
  }
  tt.enabled.store(enabled != 0, std::memory_order_release);
}

// Per-poll push: base admit rate (tokens/s per unit weight; <=0 disables
// the fairness buckets) plus a "name\tweight\n" blob. A weight change
// re-primes that tenant's bucket; unknown names are interned so weights
// can be configured ahead of first traffic.
void vt_tenant_params(void* hp, double base_rate, const char* blob,
                      int len) {
  auto* p = (Parser*)hp;
  if (!p->tenants) return;
  TenantTable& tt = *p->tenants;
  tt.base_rate.store(base_rate, std::memory_order_relaxed);
  const char* q = blob;
  const char* end = blob + (blob && len > 0 ? len : 0);
  while (q && q < end) {
    const char* nl = (const char*)memchr(q, '\n', (size_t)(end - q));
    size_t n = nl ? (size_t)(nl - q) : (size_t)(end - q);
    const char* tab = (const char*)memchr(q, '\t', n);
    if (tab && tab > q) {
      std::string wstr(tab + 1, n - (size_t)(tab - q) - 1);
      double w = strtod(wstr.c_str(), nullptr);
      TenantEntry* te = nullptr;
      tenant_intern(tt, q, (size_t)(tab - q), &te);
      if (te) {
        std::lock_guard<std::mutex> lk(tt.mu);
        if (te->weight != w) {
          te->weight = w;
          te->primed = false;
        }
      }
    }
    q += n + 1;
  }
}

// Drain names interned since the last call as [i32 id][u16 len][name]*.
// Returns the entry count, or -bytes_needed (nothing drained) when cap
// is too small.
int vt_tenant_names(void* hp, char* buf, int cap) {
  auto* p = (Parser*)hp;
  if (!p->tenants) return 0;
  TenantTable& tt = *p->tenants;
  std::lock_guard<std::mutex> lk(tt.mu);
  size_t need = 0;
  for (int32_t id : tt.fresh) need += 6 + tt.entries[id]->name.size();
  if (need > (size_t)(cap > 0 ? cap : 0)) return -(int)need;
  char* w = buf;
  int n = 0;
  for (int32_t id : tt.fresh) {
    const std::string& nm = tt.entries[id]->name;
    uint16_t l = (uint16_t)nm.size();
    memcpy(w, &id, 4);
    memcpy(w + 4, &l, 2);
    memcpy(w + 6, nm.data(), nm.size());
    w += 6 + nm.size();
    n++;
  }
  tt.fresh.clear();
  return n;
}

// Non-destructive snapshot of every tenant for checkpoint / telemetry:
// [i32 id][u8 demoted][f64 key_est][u16 len][name]* in id order. The
// estimate folds in the current window so a checkpoint taken mid-flush
// carries the full count. Returns entries or -bytes_needed.
int vt_tenant_table(void* hp, char* buf, int cap) {
  auto* p = (Parser*)hp;
  if (!p->tenants) return 0;
  TenantTable& tt = *p->tenants;
  std::lock_guard<std::mutex> lk(tt.mu);
  size_t need = 0;
  for (auto& e : tt.entries) need += 15 + e->name.size();
  if (need > (size_t)(cap > 0 ? cap : 0)) return -(int)need;
  char* w = buf;
  int n = 0;
  for (auto& e : tt.entries) {
    int32_t id = n;
    uint8_t dem = e->demoted.load(std::memory_order_relaxed) ? 1 : 0;
    double est = e->key_est.load(std::memory_order_relaxed) +
                 (double)e->window_keys.load(std::memory_order_relaxed);
    uint16_t l = (uint16_t)e->name.size();
    memcpy(w, &id, 4);
    memcpy(w + 4, &dem, 1);
    memcpy(w + 5, &est, 8);
    memcpy(w + 13, &l, 2);
    memcpy(w + 15, e->name.data(), e->name.size());
    w += 15 + e->name.size();
    n++;
  }
  return n;
}

// Restore quarantine state from a checkpoint: [u8 demoted][f64 key_est]
// [u16 len][name]* — names are (re-)interned in blob order, so a table
// restored into a fresh process reproduces the same id assignment it was
// snapshotted with. Returns entries applied.
int vt_tenant_restore(void* hp, const char* blob, int len) {
  auto* p = (Parser*)hp;
  if (!p->tenants || !blob) return 0;
  TenantTable& tt = *p->tenants;
  const char* q = blob;
  const char* end = blob + (len > 0 ? len : 0);
  int n = 0;
  while (q + 11 <= end) {
    uint8_t dem = (uint8_t)*q;
    double est;
    uint16_t l;
    memcpy(&est, q + 1, 8);
    memcpy(&l, q + 9, 2);
    q += 11;
    if (q + l > end) break;
    TenantEntry* te = nullptr;
    tenant_intern(tt, q, (size_t)l, &te);
    q += l;
    if (te) {
      te->key_est.store(est, std::memory_order_relaxed);
      te->demoted.store(dem != 0, std::memory_order_relaxed);
    }
    n++;
  }
  return n;
}

// Python-feed-path parse context (the ring engine sets it per datagram in
// vrm_worker_main): subsequent vt_feed calls parse as `name`. Empty name
// or disabled table -> default tenant / no tenant context.
void vt_set_tenant(void* hp, const char* name, int name_len) {
  auto* p = (Parser*)hp;
  TenantTable* tt = p->rt().tenants.get();
  if (!tt || !tt->enabled.load(std::memory_order_relaxed)) {
    p->cur_tenant = 0;
    p->cur_entry = nullptr;
    p->cur_demoted = false;
    return;
  }
  if (!name || name_len <= 0) {
    p->cur_tenant = 0;
    p->cur_entry = tt->dflt;
  } else {
    TenantEntry* te = nullptr;
    p->cur_tenant = tenant_intern(*tt, name, (size_t)name_len, &te);
    p->cur_entry = te;
  }
  p->cur_demoted =
      p->cur_entry && p->cur_entry->demoted.load(std::memory_order_relaxed);
}

// Drain this parser's exact demoted-row counts as parallel id/count
// arrays. Returns entries, or -entries_needed (nothing drained) when cap
// is too small. Python-feed-path counterpart of vrm_tenant_counters.
int vt_tenant_rows(void* hp, int32_t* ids, uint64_t* counts, int cap) {
  auto* p = (Parser*)hp;
  if (p->demoted_rows.empty()) return 0;
  if ((int)p->demoted_rows.size() > cap)
    return -(int)p->demoted_rows.size();
  int n = 0;
  for (auto& kv : p->demoted_rows) {
    ids[n] = kv.first;
    counts[n] = kv.second;
    n++;
  }
  p->demoted_rows.clear();
  return n;
}

// Standalone extraction (no parser handle) so tests can fuzz the exact
// C++ tenant_extract against the Python mirror. Returns the value length
// copied into out, 0 for default-tenant outcomes, -len_needed on a small
// cap.
int vt_tenant_extract(const char* tag, int tag_len, const char* data,
                      int len, char* out, int cap) {
  std::string t(tag ? tag : "", tag && tag_len > 0 ? (size_t)tag_len : 0);
  const char* v = nullptr;
  size_t vlen = 0;
  if (!data || len <= 0 || !tenant_extract(t, data, (size_t)len, &v, &vlen))
    return 0;
  if (vlen > (size_t)(cap > 0 ? cap : 0)) return -(int)vlen;
  memcpy(out, v, vlen);
  return (int)vlen;
}

// Drain-and-reset ring i's exact per-(tenant, class) admission deltas and
// its parser's demoted-row deltas, merged per tenant id. Output stride 7:
// [admitted self, high, low, shed self, high, low, demoted_rows]. Returns
// tenant count, or -count_needed (NOTHING drained) when cap is too small.
// Callers must fold across ALL rings, like vrm_admission_counters.
int vrm_tenant_counters(void* h, int ring, int32_t* ids, uint64_t* counts,
                        int cap) {
  auto* mr = (MultiRing*)h;
  Ring* r = mr->rings[ring].get();
  // r->mu guards adm.per_tenant, stage_mu guards parser.demoted_rows;
  // scoped_lock avoids ordering against the worker's r->mu -> stage_mu
  std::scoped_lock lk(r->mu, r->stage_mu);
  std::unordered_map<int32_t, std::array<uint64_t, 7>> acc;
  for (auto& kv : r->adm.per_tenant) {
    auto& row = acc[kv.first];
    for (int i = 0; i < 6; i++) row[i] += kv.second[i];
  }
  for (auto& kv : r->parser.demoted_rows) acc[kv.first][6] += kv.second;
  if ((int)acc.size() > cap) return -(int)acc.size();
  int n = 0;
  for (auto& kv : acc) {
    ids[n] = kv.first;
    memcpy(counts + (size_t)n * 7, kv.second.data(), 7 * sizeof(uint64_t));
    n++;
  }
  r->adm.per_tenant.clear();
  r->parser.demoted_rows.clear();
  return n;
}

void vrm_stop(void* h) {
  auto* mr = (MultiRing*)h;
  mr->stop.store(true);
  for (auto& r : mr->rings) {
    { std::lock_guard<std::mutex> lk(r->mu); }
    r->cv.notify_all();
    r->space_cv.notify_all();
  }
  { std::lock_guard<std::mutex> lk(mr->wait_mu); }
  mr->wait_cv.notify_all();
  for (auto& r : mr->rings) {
    if (r->reader.joinable()) r->reader.join();
    if (r->worker.joinable()) r->worker.join();
    if (r->fd >= 0) close(r->fd);
  }
  delete mr;
}

}  // extern "C"
