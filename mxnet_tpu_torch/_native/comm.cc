// Native distributed KVStore transport — the ps-lite equivalent, the
// port's own copy of the JAX package's transport (one wire protocol, so
// either package's workers and servers speak it; built by
// mxnet_tpu_torch/_native/__init__.py load_comm into build/native/).
//
// The reference's multi-process story is a ZMQ parameter server
// (ref: src/kvstore/kvstore_dist.h:44-771 worker, kvstore_dist_server.h:
// 155-798 server, ps-lite Van/Postoffice for rendezvous+transport).
// This is a small TCP server that
// assigns worker ranks at connect (rendezvous), aggregates pushes per
// key with BSP sync semantics (merge buffer + per-key round counting,
// exactly DataHandleDefault's protocol), answers queued pulls when a
// round completes, runs barriers, and optionally calls back into the
// host language to apply an optimizer server-side (the reference ships
// a pickled Python optimizer to its servers, python/mxnet/kvstore.py:
// 450-495 — here the callback crosses the C/Python seam via ctypes).
//
// Robustness layer (the ps-lite resend/timeout analogue, ref:
// kvstore_dist.h:118-123 + ps-lite van resend):
//   * every request carries a per-client monotonically increasing
//     request id, so a RESEND after a reconnect is idempotent at the
//     server (pushes merge once, barriers complete once);
//   * a worker may reconnect and reclaim its rank ("MXT2r" rendezvous),
//     resuming the in-flight BSP round — its parked pulls are purged on
//     disconnect and simply resent;
//   * with a recovery grace window armed (mxtpu_server_set_recovery_
//     grace) a missing worker does NOT degrade the job immediately; a
//     watchdog degrades only after the grace expires;
//   * the whole server state (committed stores, in-flight merges,
//     per-rank idempotency watermarks) snapshots to a flat buffer and
//     restores before listening, so a restarted server rejoins with
//     state intact (mxtpu_server_snapshot / mxtpu_server_preload);
//   * a deterministic fault-injection layer (mxtpu_fault_*) can drop
//     connections, delay or truncate frames, reject accepts, and kill
//     the server at exact protocol points — driven by the Python-side
//     MXNET_KVSTORE_FAULT_PLAN parser (kvstore/fault.py).
//
// Wire protocol v2 (little-endian):
//   request:  u8 op | u32 key | u64 req_id | u64 nbytes
//             | u64 trace_id | u64 span_id | payload
//   response: u8 ok | u64 nbytes | payload
// trace_id/span_id carry the caller's tracing context (0 = untraced);
// the server reports each traced request to an optional host-language
// sink (mxtpu_server_set_trace_sink) with CLOCK_MONOTONIC recv/done
// timestamps, and exposes the in-flight request's context to the host
// updater via mxtpu_server_current_trace. Both sides build from THIS
// file, so there is no version-skew window; a future header change
// must bump the rendezvous magic again (v1 was "MXTW", this
// 16-byte header growth bumped it to "MXT2" so a mixed v1/v2 pair
// fails fast at handshake instead of desyncing the stream).
// Ops: 1=INIT 2=PUSH 3=PULL 4=BARRIER 5=COMMAND 6=PUSH_2BIT 7=PULL_ROWS
// Commands (key field): 1=set_sync_mode(payload u8) 2=stop
//   3=server_profiler(opaque directive blob, enqueued for the host
//   loop — the reference's kSetProfilerParams command family,
//   ref: include/mxnet/kvstore.h:43-49) 4=set_optimizer(opaque blob;
//   ack deferred until the host loop installs the updater). Both blob
//   commands share one FIFO drained by mxtpu_server_poll; the host
//   side distinguishes them by payload prefix.
// Rendezvous: client sends 5 magic bytes — "MXT2w" fresh worker (rank
//   assigned), "MXT2p" probe (no rank), "MXT2r" reconnect (followed by
//   a u32 rank to reclaim); server answers u32 rank | u32 num_workers.
//
// Build: g++ -O2 -shared -fPIC -pthread comm.cc -o libmxtorch_comm.so

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <chrono>
#include <condition_variable>
#include <csignal>
#include <cstdint>
#include <cstring>
#include <deque>
#include <map>
#include <mutex>
#include <set>
#include <thread>
#include <vector>

namespace {

struct Header {
  uint8_t op;
  uint32_t key;
  uint64_t req_id;
  uint64_t nbytes;
  uint64_t trace_id;  // tracing context (0 = untraced)
  uint64_t span_id;
} __attribute__((packed));

constexpr uint8_t kInit = 1, kPush = 2, kPull = 3, kBarrier = 4,
                  kCommand = 5, kPush2Bit = 6, kPullRows = 7;

// ------------------------------------------------------------ trace sink
// Host-language tracing callback: invoked once per traced request after
// its handling completes (queued pulls report recv->parked). Timestamps
// are CLOCK_MONOTONIC ns — the same clock Python's time.monotonic_ns()
// reads on Linux, so worker spans and these nest on one axis.
typedef void (*TraceSinkFn)(uint8_t op, uint32_t key, uint64_t req_id,
                            int rank, uint64_t trace_id, uint64_t span_id,
                            uint64_t recv_ns, uint64_t done_ns);
TraceSinkFn g_trace_sink = nullptr;
// context of the request THIS connection thread is handling, so a host
// updater running inside it can parent its span to the worker's push
thread_local uint64_t t_cur_trace = 0;
thread_local uint64_t t_cur_span = 0;

uint64_t mono_ns() {
  return static_cast<uint64_t>(
      std::chrono::duration_cast<std::chrono::nanoseconds>(
          std::chrono::steady_clock::now().time_since_epoch())
          .count());
}

// RAII per-request scope: sets the thread-local context for the host
// updater and fires the sink on every exit path (continue/break/return)
struct TraceScope {
  const Header& h;
  int rank;
  uint64_t recv_ns = 0;
  TraceScope(const Header& hh, int r) : h(hh), rank(r) {
    t_cur_trace = hh.trace_id;
    t_cur_span = hh.span_id;
    if (hh.trace_id != 0 && g_trace_sink != nullptr) recv_ns = mono_ns();
  }
  ~TraceScope() {
    t_cur_trace = 0;
    t_cur_span = 0;
    TraceSinkFn sink = g_trace_sink;
    if (recv_ns != 0 && sink != nullptr)
      sink(h.op, h.key, h.req_id, rank, h.trace_id, h.span_id, recv_ns,
           mono_ns());
  }
};

bool read_full(int fd, void* buf, size_t n) {
  char* p = static_cast<char*>(buf);
  while (n > 0) {
    ssize_t r = ::read(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void* buf, size_t n) {
  const char* p = static_cast<const char*>(buf);
  while (n > 0) {
    ssize_t r = ::write(fd, p, n);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool send_response(int fd, uint8_t ok, const void* payload, uint64_t n) {
  char hdr[9];
  hdr[0] = static_cast<char>(ok);
  std::memcpy(hdr + 1, &n, 8);
  if (!write_full(fd, hdr, 9)) return false;
  if (n > 0 && !write_full(fd, payload, n)) return false;
  return true;
}

typedef void (*UpdaterFn)(uint32_t key, const float* recved, uint64_t n,
                          float* stored);

// ------------------------------------------------------------ fault rules
// Deterministic fault injection (the test-only analogue of real network
// failure). Rules are installed from Python (kvstore/fault.py parses
// MXNET_KVSTORE_FAULT_PLAN) and consulted at the protocol seams.
// `round` counts DISTINCT matching request ids (a resend of the same
// request never re-advances the count, so a fired fault cannot refire
// on its own recovery), except for server kill rules where it counts
// completed merge rounds.
constexpr int kFaultDropConn = 1, kFaultDelayMs = 2, kFaultTruncFrame = 3,
              kFaultKillServer = 4, kFaultRejectAccept = 5,
              kFaultDieServer = 6;

struct FaultRule {
  int kind = 0;
  int op = 0;             // 0 = any op (client-side filter)
  long long key = -1;     // -1 = any key
  long long round = -1;   // -1 = every match; else fire once at match N
  long long arg = 0;      // delay ms / reject count
  // round-counting state PER (RANK, KEY) stream: request ids are only
  // monotonic within one worker (a shared counter would move the firing
  // point with cross-worker interleaving, breaking the determinism
  // contract), and per-key counting makes round=N mean "BSP round N"
  // on a multi-key model — each key sees exactly one matching push per
  // round, like the server kill rules. Keyed by rank (stable across
  // reconnects), so a resend never re-advances the count; the rule
  // fires at most ONCE per rank, on the first stream to reach round N.
  std::map<std::pair<long long, long long>,
           std::pair<long long, uint64_t>> streams;  // count, last_id
  std::set<long long> fired_who;
  bool fired = false;  // kill rules: fired once globally
};

std::mutex g_fault_mu;
std::vector<FaultRule> g_client_faults;
std::vector<FaultRule> g_server_faults;

// returns the rule kind to fire for this request (0 = none); delay rules
// return their ms via *delay_ms and multiple delay rules accumulate.
// `who` is the requester's rank: round counting and once-only firing
// are per rank.
int fault_match(std::vector<FaultRule>* rules, long long who, uint8_t op,
                uint32_t key, uint64_t req_id, long long* delay_ms) {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  int fire = 0;
  for (auto& r : *rules) {
    if (r.kind == kFaultKillServer || r.kind == kFaultRejectAccept ||
        r.kind == kFaultDieServer)
      continue;  // not request-seam rules
    if (r.op != 0 && r.op != op) continue;
    if (r.key >= 0 && static_cast<uint32_t>(r.key) != key) continue;
    bool hit;
    if (r.round < 0) {
      hit = true;  // unconditional: fires on every match (permanent fault)
    } else {
      auto& st = r.streams[{who, static_cast<long long>(key)}];
      if (req_id != st.second) {
        ++st.first;
        st.second = req_id;
      }
      hit = (st.first == r.round && !r.fired_who.count(who));
      if (hit) r.fired_who.insert(who);
    }
    if (!hit) continue;
    if (r.kind == kFaultDelayMs) {
      *delay_ms += r.arg;
    } else if (fire == 0) {
      fire = r.kind;
    }
  }
  return fire;
}

// consume one accept-rejection (arg = remaining count)
bool fault_take_reject_accept() {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  for (auto& r : g_server_faults) {
    if (r.kind == kFaultRejectAccept && r.arg > 0) {
      --r.arg;
      return true;
    }
  }
  return false;
}

// server kill rules fire on a KEY's Nth completed merge round (per-key
// counting: with uniform BSP pushes every key's count equals the BSP
// round number, independent of how many keys the model has — a global
// apply counter would fire at round N/nkeys instead). A key= condition
// pins the rule to one key; without it the first key to reach round N
// fires it.
void fault_check_round(uint32_t key, uint64_t key_rounds) {
  int kind = 0;
  {
    std::lock_guard<std::mutex> lk(g_fault_mu);
    for (auto& r : g_server_faults) {
      if ((r.kind != kFaultKillServer && r.kind != kFaultDieServer) ||
          r.fired)
        continue;
      if (r.key >= 0 && static_cast<uint32_t>(r.key) != key) continue;
      if (r.round >= 0 &&
          static_cast<uint64_t>(r.round) == key_rounds) {
        r.fired = true;
        kind = r.kind;
        break;
      }
    }
  }
  if (kind == kFaultKillServer) {
    // graceful: SIGTERM reaches the host-language handler, which
    // snapshots the server state and exits (kvstore/dist.py run_server)
    std::raise(SIGTERM);
  } else if (kind == kFaultDieServer) {
    ::_exit(86);  // abrupt: no snapshot, models a hard crash
  }
}

struct Server;
bool sync_unhealthy_locked(Server* s);
void mark_degraded_locked(Server* s);

struct KeyState {
  std::vector<float> store;
  std::vector<float> merge;
  int pushed = 0;              // workers reported this round
  // which ranks contributed to the in-flight round: a pull from a rank
  // that has NOT pushed yet is for the PREVIOUS round's result and must
  // be answered from the store immediately — queueing it would deadlock
  // BSP when a fast worker opens round N+1 before a slow worker pulled
  // round N (the reference keys requests by timestamp for the same
  // reason, ps-lite van timestamps)
  std::set<int> pushed_ranks;
  std::vector<int> pending_pulls;  // fds waiting for round completion
  // row-granular pulls queued on the in-flight round: fd + request body
  std::vector<std::pair<int, std::vector<char>>> pending_row_pulls;
  // rank -> highest push request id merged; a resent push (same id,
  // after a reconnect) acks without merging again — the idempotency
  // watermark that makes resend-on-timeout safe
  std::map<int, uint64_t> last_push_id;
  uint64_t rounds = 0;  // completed merge rounds of THIS key
};

// answer one row-granular pull from the committed store; ok=0 when the
// key is uninitialized or any row id is out of range (silent zeros
// would read as valid embeddings)
void answer_row_pull(const KeyState& ks, int fd,
                     const std::vector<char>& body) {
  uint64_t row_len = 0;
  if (body.size() >= 8) std::memcpy(&row_len, body.data(), 8);
  uint64_t n_rows = row_len ? (body.size() - 8) / 4 : 0;
  if (row_len == 0 || ks.store.empty()) {
    send_response(fd, 0, nullptr, 0);
    return;
  }
  const int32_t* ids = reinterpret_cast<const int32_t*>(body.data() + 8);
  std::vector<float> out(n_rows * row_len);
  for (uint64_t r = 0; r < n_rows; ++r) {
    if (ids[r] < 0 ||
        (static_cast<uint64_t>(ids[r]) + 1) * row_len > ks.store.size()) {
      send_response(fd, 0, nullptr, 0);
      return;
    }
    std::memcpy(out.data() + r * row_len,
                ks.store.data() + static_cast<uint64_t>(ids[r]) * row_len,
                row_len * 4);
  }
  send_response(fd, 1, out.data(), out.size() * 4);
}

struct Server {
  int listen_fd = -1;
  int num_workers = 0;
  bool sync_mode = false;
  bool stop = false;
  // a ranked worker disconnected while a round / barrier / pull was in
  // flight: the job cannot complete — fail fast instead of hanging
  // (the reference's dead-node detection, kvstore_dist.h:118-123)
  bool degraded = false;
  // a snapshot with freeze=1 was taken: no further state mutation may
  // be acked (an ack for a mutation the snapshot missed would be lost
  // on restart); connections close instead, clients resend after the
  // restart
  bool frozen = false;
  // recovery grace: >0 arms reconnect-tolerant mode — a missing worker
  // degrades the job only after this many ms without a reconnect
  int recovery_grace_ms = 0;
  bool missing = false;
  std::chrono::steady_clock::time_point missing_since{};
  // ranks with at least one live connection. Counted per rank via
  // conns_per_rank because a reconnect can briefly overlap its
  // half-open predecessor: a raw connection count would read
  // num_workers+1 and then mask a DIFFERENT worker's death from the
  // grace watchdog when it dropped back to num_workers
  int active_workers = 0;
  std::map<int, int> conns_per_rank;
  UpdaterFn updater = nullptr;
  std::map<uint32_t, KeyState> keys;
  std::mutex mu;
  std::condition_variable cv;
  // command-blob FIFO (optimizer installs, profiler directives): a
  // single overwritable slot would let a quick optimizer push clobber
  // an unpolled profiler directive
  std::deque<std::vector<char>> blobs;
  uint64_t barrier_gen = 0;
  // rank -> (fd, req_id) waiting in the current barrier; keyed by rank
  // so a reconnect-resend replaces the dead fd instead of double
  // counting
  std::map<int, std::pair<int, uint64_t>> barrier_waiters;
  // rank -> last barrier request id completed; a resend of a completed
  // barrier acks immediately instead of joining the next generation
  std::map<int, uint64_t> barrier_done;
  uint64_t rounds_applied = 0;  // completed merge rounds (all keys)
  std::vector<std::thread> threads;
  std::thread accept_thread;
  std::thread watchdog;
  bool watchdog_stop = false;
  int next_rank = 0;
};

Server* g_server = nullptr;
Server* g_pending_restore = nullptr;  // state staged by mxtpu_server_preload
// staged before start: a RESTORED server must come up with its grace
// and updater already armed, or a worker resend racing the start could
// degrade the job (grace 0) or complete a merge round without the
// optimizer — acked, then wrong
int g_pending_grace_ms = 0;
UpdaterFn g_pending_updater = nullptr;

// 2-bit stochastic-quantization wire format (ref:
// src/kvstore/gradient_compression.h:37-121): f32 threshold, u64
// original length, then ceil(n/16) little-endian u32 words holding 16
// 2-bit codes each: 0 -> 0, 1 -> +threshold, 2 -> -threshold.
void accumulate_2bit(const char* payload, uint64_t nbytes,
                     std::vector<float>* acc) {
  if (nbytes < 12) return;
  float threshold;
  uint64_t n;
  std::memcpy(&threshold, payload, 4);
  std::memcpy(&n, payload + 4, 8);
  const char* words = payload + 12;
  uint64_t nwords = (nbytes - 12) / 4;
  if (acc->size() < n) acc->resize(n, 0.f);
  for (uint64_t w = 0; w < nwords; ++w) {
    uint32_t word;
    std::memcpy(&word, words + 4 * w, 4);
    for (int j = 0; j < 16; ++j) {
      uint64_t idx = w * 16 + static_cast<uint64_t>(j);
      if (idx >= n) break;
      uint32_t code = (word >> (2 * j)) & 0x3u;
      if (code == 1u)
        (*acc)[idx] += threshold;
      else if (code == 2u)
        (*acc)[idx] -= threshold;
    }
  }
}

void apply_round(Server* s, uint32_t key, KeyState* ks) {
  // all workers reported: fold merge into store, answer queued pulls
  if (s->updater) {
    if (ks->store.size() < ks->merge.size())
      ks->store.resize(ks->merge.size(), 0.f);
    s->updater(key, ks->merge.data(), ks->merge.size(), ks->store.data());
  } else {
    ks->store = ks->merge;
  }
  ks->pushed = 0;
  ks->pushed_ranks.clear();
  for (int fd : ks->pending_pulls) {
    send_response(fd, 1, ks->store.data(), ks->store.size() * 4);
  }
  ks->pending_pulls.clear();
  for (auto& rp : ks->pending_row_pulls) {
    answer_row_pull(*ks, rp.first, rp.second);
  }
  ks->pending_row_pulls.clear();
  ++ks->rounds;
  ++s->rounds_applied;  // total applies across keys (stats/telemetry)
  fault_check_round(key, ks->rounds);
}

// returns false when the connection must close without a response
// (frozen server: the client retries against the restarted instance)
bool handle_push(Server* s, int fd, uint32_t key, uint64_t req_id,
                 const char* payload, uint64_t nbytes, bool compressed,
                 int rank) {
  std::unique_lock<std::mutex> lk(s->mu);
  if (s->frozen) return false;
  if (s->sync_mode && sync_unhealthy_locked(s)) {
    lk.unlock();
    send_response(fd, 0, nullptr, 0);
    return true;
  }
  KeyState& ks = s->keys[key];
  if (rank >= 0 && req_id != 0) {
    uint64_t& last = ks.last_push_id[rank];
    if (req_id <= last) {
      // resend of an already-merged push (the ack was lost with the
      // connection): idempotent — ack without merging again
      lk.unlock();
      send_response(fd, 1, nullptr, 0);
      return true;
    }
    last = req_id;
  }
  bool first = ks.pushed == 0;
  if (s->sync_mode) {
    if (rank >= 0) ks.pushed_ranks.insert(rank);
    if (first) ks.merge.assign(ks.store.size(), 0.f);
    if (compressed) {
      accumulate_2bit(payload, nbytes, &ks.merge);
    } else {
      uint64_t n = nbytes / 4;
      if (ks.merge.size() < n) ks.merge.resize(n, 0.f);
      const float* src = reinterpret_cast<const float*>(payload);
      for (uint64_t i = 0; i < n; ++i) ks.merge[i] += src[i];
    }
    if (++ks.pushed >= s->num_workers) apply_round(s, key, &ks);
  } else {
    // async: apply on arrival (ref: kvstore_dist_server.h async branch)
    std::vector<float> recved;
    if (compressed) {
      accumulate_2bit(payload, nbytes, &recved);
    } else {
      recved.assign(reinterpret_cast<const float*>(payload),
                    reinterpret_cast<const float*>(payload) + nbytes / 4);
    }
    if (recved.size() < ks.store.size()) recved.resize(ks.store.size(), 0.f);
    if (s->updater) {
      if (ks.store.size() < recved.size())
        ks.store.resize(recved.size(), 0.f);
      s->updater(key, recved.data(), recved.size(), ks.store.data());
    } else {
      if (ks.store.size() < recved.size()) ks.store.resize(recved.size());
      for (uint64_t i = 0; i < recved.size(); ++i) ks.store[i] += recved[i];
    }
  }
  lk.unlock();
  send_response(fd, 1, nullptr, 0);
  return true;
}

void mark_degraded_locked(Server* s) {
  s->degraded = true;
  for (auto& kv : s->keys) {
    for (int pfd : kv.second.pending_pulls)
      send_response(pfd, 0, nullptr, 0);
    kv.second.pending_pulls.clear();
    for (auto& rp : kv.second.pending_row_pulls)
      send_response(rp.first, 0, nullptr, 0);
    kv.second.pending_row_pulls.clear();
  }
  for (auto& bw : s->barrier_waiters)
    send_response(bw.second.first, 0, nullptr, 0);
  s->barrier_waiters.clear();
  s->cv.notify_all();
}

// sync-mode health gate: once the full worker set has connected
// (next_rank reached num_workers), any missing worker means BSP rounds
// can never complete — new sync ops must fail instead of queueing.
// With a recovery grace armed, degrading is the watchdog's job: until
// the grace expires a missing worker is presumed to be reconnecting.
bool sync_unhealthy_locked(Server* s) {
  if (s->degraded) return true;
  if (s->stop) return false;
  if (s->next_rank >= s->num_workers &&
      s->active_workers < s->num_workers) {
    if (s->recovery_grace_ms > 0) return false;
    mark_degraded_locked(s);
    return true;
  }
  return false;
}

void worker_disconnected(Server* s, int rank, int fd) {
  if (rank < 0) return;
  std::lock_guard<std::mutex> lk(s->mu);
  if (--s->conns_per_rank[rank] <= 0) {
    s->conns_per_rank.erase(rank);
    --s->active_workers;
  }
  // purge this connection's parked requests; after a reconnect the
  // worker resends them (same request ids) on the new fd — answering a
  // dead fd would silently drop the response anyway
  for (auto& kv : s->keys) {
    auto& pp = kv.second.pending_pulls;
    pp.erase(std::remove(pp.begin(), pp.end(), fd), pp.end());
    auto& rp = kv.second.pending_row_pulls;
    rp.erase(std::remove_if(
                 rp.begin(), rp.end(),
                 [fd](const std::pair<int, std::vector<char>>& p) {
                   return p.first == fd;
                 }),
             rp.end());
  }
  auto bw = s->barrier_waiters.find(rank);
  if (bw != s->barrier_waiters.end() && bw->second.first == fd)
    s->barrier_waiters.erase(bw);
  if (s->recovery_grace_ms > 0) {
    if (!s->stop && !s->degraded &&
        s->active_workers < s->num_workers && !s->missing) {
      s->missing = true;
      s->missing_since = std::chrono::steady_clock::now();
      s->cv.notify_all();  // wake the watchdog
    }
    return;
  }
  // legacy fail-fast path (recovery off): any in-flight round/barrier/
  // pull can now never complete — degrade immediately
  if (s->sync_mode && !s->stop && !s->degraded) {
    bool pending = !s->barrier_waiters.empty();
    for (auto& kv : s->keys)
      if (kv.second.pushed > 0 || !kv.second.pending_pulls.empty())
        pending = true;
    if (pending) mark_degraded_locked(s);
  }
}

void worker_reconnected(Server* s, int rank) {
  std::lock_guard<std::mutex> lk(s->mu);
  if (++s->conns_per_rank[rank] == 1) ++s->active_workers;
  if (s->active_workers >= s->num_workers) s->missing = false;
}

void handle_conn(Server* s, int fd) {
  int rank = -1;
  {
    // rendezvous: the client first identifies itself ("MXT2w" worker /
    // "MXT2p" probe / "MXT2r" reconnect+rank); stray TCP connects never
    // consume a worker rank (a 5s deadline bounds the wait)
    timeval tv{5, 0};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    char magic[5];
    if (!read_full(fd, magic, 5) || std::memcmp(magic, "MXT2", 4) != 0) {
      ::close(fd);
      return;
    }
    bool reconnect = magic[4] == 'r';
    uint32_t claimed = 0;
    if (reconnect && !read_full(fd, &claimed, 4)) {
      ::close(fd);
      return;
    }
    timeval off{0, 0};
    ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
    if (reconnect) {
      if (static_cast<int>(claimed) >= s->num_workers) {
        ::close(fd);
        return;
      }
      rank = static_cast<int>(claimed);
      worker_reconnected(s, rank);
    } else {
      std::lock_guard<std::mutex> lk(s->mu);
      if (magic[4] == 'w') {
        rank = s->next_rank++;
        if (++s->conns_per_rank[rank] == 1) ++s->active_workers;
        // a restored server may refill its set with FRESH ranks too
        // (snapshot taken before every worker had joined): a full house
        // clears the missing clock however it was reached, or a much
        // later disconnect would be measured against the stale restart
        // timestamp and degraded with zero grace
        if (s->active_workers >= s->num_workers) s->missing = false;
      }
    }
    uint32_t hello[2] = {static_cast<uint32_t>(rank),
                         static_cast<uint32_t>(s->num_workers)};
    if (!write_full(fd, hello, 8)) {
      worker_disconnected(s, rank, fd);  // rank was consumed — account it
      ::close(fd);
      return;
    }
  }
  std::vector<char> payload;
  for (;;) {
    Header h;
    if (!read_full(fd, &h, sizeof(h))) break;
    payload.resize(h.nbytes);
    if (h.nbytes > 0 && !read_full(fd, payload.data(), h.nbytes)) break;
    // per-request tracing scope: thread-local context for the host
    // updater + sink report on every exit path of this iteration
    TraceScope trace_scope(h, rank);
    // server-seam fault rules (delayed responses etc.) fire per request
    long long delay_ms = 0;
    int fault = fault_match(&g_server_faults, rank, h.op, h.key, h.req_id,
                            &delay_ms);
    if (delay_ms > 0)
      std::this_thread::sleep_for(std::chrono::milliseconds(delay_ms));
    if (fault == kFaultDropConn) break;
    if (h.op == kInit) {
      std::unique_lock<std::mutex> lk(s->mu);
      if (s->frozen) break;
      KeyState& ks = s->keys[h.key];
      if (ks.store.empty()) {
        const float* src = reinterpret_cast<const float*>(payload.data());
        ks.store.assign(src, src + h.nbytes / 4);
      }
      lk.unlock();
      send_response(fd, 1, nullptr, 0);
    } else if (h.op == kPush || h.op == kPush2Bit) {
      if (!handle_push(s, fd, h.key, h.req_id, payload.data(), h.nbytes,
                       h.op == kPush2Bit, rank))
        break;
    } else if (h.op == kPull) {
      std::unique_lock<std::mutex> lk(s->mu);
      if (s->frozen) break;
      if (s->sync_mode && sync_unhealthy_locked(s)) {
        lk.unlock();
        send_response(fd, 0, nullptr, 0);
        continue;
      }
      KeyState& ks = s->keys[h.key];
      if (s->sync_mode && ks.pushed > 0 &&
          ks.pushed_ranks.count(rank)) {
        // this worker already contributed to the in-flight round —
        // its pull wants the round's RESULT: queue until the last
        // worker pushes. Pulls from not-yet-pushed ranks are for the
        // previous round and are answered from the store right away.
        ks.pending_pulls.push_back(fd);
        lk.unlock();
      } else {
        std::vector<float> snapshot = ks.store;
        lk.unlock();
        send_response(fd, 1, snapshot.data(), snapshot.size() * 4);
      }
    } else if (h.op == kPullRows) {
      // row-granular sparse pull (ref: kvstore_dist.h:470 PullRowSparse):
      // payload = u64 row_len | i32 row_ids...; response = rows matrix
      std::unique_lock<std::mutex> lk(s->mu);
      if (s->frozen) break;
      if (s->sync_mode && sync_unhealthy_locked(s)) {
        lk.unlock();
        send_response(fd, 0, nullptr, 0);
        continue;
      }
      KeyState& ks = s->keys[h.key];
      if (s->sync_mode && ks.pushed > 0 &&
          ks.pushed_ranks.count(rank)) {
        // round in flight and this rank contributed: queue like kPull
        // so the puller sees the post-round rows
        ks.pending_row_pulls.emplace_back(fd, payload);
        lk.unlock();
      } else {
        KeyState snapshot = ks;
        lk.unlock();
        answer_row_pull(snapshot, fd, payload);
      }
    } else if (h.op == kBarrier) {
      std::unique_lock<std::mutex> lk(s->mu);
      if (s->frozen) break;
      if (s->sync_mode && sync_unhealthy_locked(s)) {
        lk.unlock();
        send_response(fd, 0, nullptr, 0);
        continue;
      }
      if (rank >= 0 && h.req_id != 0 &&
          h.req_id <= s->barrier_done[rank]) {
        // resend of a barrier that already completed (ack lost with the
        // connection) — joining the next generation would skew every
        // barrier after it by one participant
        lk.unlock();
        send_response(fd, 1, nullptr, 0);
        continue;
      }
      s->barrier_waiters[rank] = {fd, static_cast<uint64_t>(h.req_id)};
      if (static_cast<int>(s->barrier_waiters.size()) >= s->num_workers) {
        for (auto& bw : s->barrier_waiters) {
          if (bw.second.second > s->barrier_done[bw.first])
            s->barrier_done[bw.first] = bw.second.second;
          send_response(bw.second.first, 1, nullptr, 0);
        }
        s->barrier_waiters.clear();
        ++s->barrier_gen;
        s->cv.notify_all();
      }
      lk.unlock();
    } else if (h.op == kCommand) {
      // one lock for the whole command: the frozen check and the
      // mutation must be atomic, or a post-snapshot command could be
      // applied-and-acked yet missing from the restored state
      std::unique_lock<std::mutex> lk(s->mu);
      if (s->frozen) break;
      if (h.key == 1) {
        s->sync_mode = h.nbytes > 0 && payload[0] != 0;
      } else if (h.key == 2) {
        s->stop = true;
        s->cv.notify_all();
      } else if (h.key == 3) {
        // profiler directive: enqueue for the host loop and ack — the
        // toggle is asynchronous by design (the reference logs-and-
        // continues when servers can't run it, kvstore.h:387)
        s->blobs.emplace_back(payload.begin(), payload.end());
        s->cv.notify_all();
      } else if (h.key == 4) {
        // ack only after the host loop picked the blob up and installed
        // the updater — otherwise the next push round races the install.
        // Bounded wait: a server started without run_server's poll loop
        // must reject instead of deadlocking this connection thread.
        s->blobs.emplace_back(payload.begin(), payload.end());
        s->cv.notify_all();
        bool ok = s->cv.wait_for(
            lk, std::chrono::seconds(60),
            [s] { return s->updater != nullptr || s->stop; });
        if (!ok) {
          lk.unlock();
          send_response(fd, 0, nullptr, 0);
          continue;
        }
      }
      lk.unlock();
      send_response(fd, 1, nullptr, 0);
    } else {
      send_response(fd, 0, nullptr, 0);
    }
  }
  worker_disconnected(s, rank, fd);
  ::close(fd);
}

// ------------------------------------------------------ snapshot format
// Flat little-endian buffer, versioned by magic:
//   "MXTSNP01"
//   u32 num_workers | u32 next_rank | u8 sync_mode | u64 rounds_applied
//   u64 nkeys, then per key:
//     u32 key
//     u64 store_n  | f32[store_n]
//     u64 merge_n  | f32[merge_n]
//     u32 pushed
//     u32 n_pushed_ranks | i32[...]
//     u32 n_last_push    | (i32 rank, u64 id)[...]
//     u64 rounds (completed merge rounds of this key)
//   u32 n_barrier_done   | (i32 rank, u64 id)[...]
// The in-flight merge state ships too: a push acked before the snapshot
// must survive the restart (its sender will NOT resend it), or the
// round would silently lose a gradient.
constexpr char kSnapMagic[8] = {'M', 'X', 'T', 'S', 'N', 'P', '0', '1'};

void put_bytes(std::vector<char>* out, const void* p, size_t n) {
  const char* c = static_cast<const char*>(p);
  out->insert(out->end(), c, c + n);
}

template <typename T>
void put(std::vector<char>* out, T v) {
  put_bytes(out, &v, sizeof(v));
}

std::vector<char> serialize_locked(Server* s) {
  std::vector<char> out;
  put_bytes(&out, kSnapMagic, 8);
  put<uint32_t>(&out, static_cast<uint32_t>(s->num_workers));
  put<uint32_t>(&out, static_cast<uint32_t>(s->next_rank));
  put<uint8_t>(&out, s->sync_mode ? 1 : 0);
  put<uint64_t>(&out, s->rounds_applied);
  put<uint64_t>(&out, s->keys.size());
  for (auto& kv : s->keys) {
    const KeyState& ks = kv.second;
    put<uint32_t>(&out, kv.first);
    put<uint64_t>(&out, ks.store.size());
    put_bytes(&out, ks.store.data(), ks.store.size() * 4);
    put<uint64_t>(&out, ks.merge.size());
    put_bytes(&out, ks.merge.data(), ks.merge.size() * 4);
    put<uint32_t>(&out, static_cast<uint32_t>(ks.pushed));
    put<uint32_t>(&out, static_cast<uint32_t>(ks.pushed_ranks.size()));
    for (int r : ks.pushed_ranks) put<int32_t>(&out, r);
    put<uint32_t>(&out, static_cast<uint32_t>(ks.last_push_id.size()));
    for (auto& lp : ks.last_push_id) {
      put<int32_t>(&out, lp.first);
      put<uint64_t>(&out, lp.second);
    }
    put<uint64_t>(&out, ks.rounds);
  }
  put<uint32_t>(&out, static_cast<uint32_t>(s->barrier_done.size()));
  for (auto& bd : s->barrier_done) {
    put<int32_t>(&out, bd.first);
    put<uint64_t>(&out, bd.second);
  }
  return out;
}

struct Cursor {
  const char* p;
  const char* end;
  bool ok = true;
  bool take(void* dst, size_t n) {
    if (!ok || p + n > end) {
      ok = false;
      return false;
    }
    std::memcpy(dst, p, n);
    p += n;
    return true;
  }
  template <typename T>
  T get() {
    T v{};
    take(&v, sizeof(v));
    return v;
  }
};

Server* deserialize(const char* buf, uint64_t n) {
  Cursor c{buf, buf + n};
  char magic[8];
  if (!c.take(magic, 8) || std::memcmp(magic, kSnapMagic, 8) != 0)
    return nullptr;
  Server* s = new Server();
  s->num_workers = static_cast<int>(c.get<uint32_t>());
  s->next_rank = static_cast<int>(c.get<uint32_t>());
  s->sync_mode = c.get<uint8_t>() != 0;
  s->rounds_applied = c.get<uint64_t>();
  uint64_t nkeys = c.get<uint64_t>();
  for (uint64_t i = 0; c.ok && i < nkeys; ++i) {
    uint32_t key = c.get<uint32_t>();
    KeyState& ks = s->keys[key];
    uint64_t sn = c.get<uint64_t>();
    // validate declared sizes against the remaining buffer BEFORE
    // allocating: a bit-rotted snapshot with valid magic must come back
    // as preload rc -1 ("starting empty"), not a bad_alloc crossing the
    // extern "C" boundary and killing the restarting server
    if (!c.ok || sn > static_cast<uint64_t>(c.end - c.p) / 4) {
      delete s;
      return nullptr;
    }
    ks.store.resize(sn);
    c.take(ks.store.data(), sn * 4);
    uint64_t mn = c.get<uint64_t>();
    if (!c.ok || mn > static_cast<uint64_t>(c.end - c.p) / 4) {
      delete s;
      return nullptr;
    }
    ks.merge.resize(mn);
    c.take(ks.merge.data(), mn * 4);
    ks.pushed = static_cast<int>(c.get<uint32_t>());
    uint32_t npr = c.get<uint32_t>();
    for (uint32_t j = 0; c.ok && j < npr; ++j)
      ks.pushed_ranks.insert(c.get<int32_t>());
    uint32_t nlp = c.get<uint32_t>();
    for (uint32_t j = 0; c.ok && j < nlp; ++j) {
      int32_t r = c.get<int32_t>();
      ks.last_push_id[r] = c.get<uint64_t>();
    }
    ks.rounds = c.get<uint64_t>();
  }
  uint32_t nbd = c.get<uint32_t>();
  for (uint32_t j = 0; c.ok && j < nbd; ++j) {
    int32_t r = c.get<int32_t>();
    s->barrier_done[r] = c.get<uint64_t>();
  }
  if (!c.ok) {
    delete s;
    return nullptr;
  }
  return s;
}

void start_watchdog_locked(Server* s) {
  if (s->watchdog.joinable() || s->recovery_grace_ms <= 0) return;
  s->watchdog = std::thread([s] {
    std::unique_lock<std::mutex> lk(s->mu);
    while (!s->watchdog_stop && !s->stop) {
      s->cv.wait_for(lk, std::chrono::milliseconds(100));
      if (s->watchdog_stop || s->stop || s->degraded || !s->missing)
        continue;
      auto waited = std::chrono::duration_cast<std::chrono::milliseconds>(
                        std::chrono::steady_clock::now() - s->missing_since)
                        .count();
      if (s->active_workers < s->num_workers &&
          waited > s->recovery_grace_ms) {
        // grace expired with a worker still gone: the fault is
        // permanent — fail every parked and future sync op cleanly
        mark_degraded_locked(s);
      }
    }
  });
}

}  // namespace

extern "C" {

// -------------------------------------------------------------- faults
// Install one fault rule. kind: 1=drop_conn 2=delay_ms 3=trunc_frame
// 4=kill_server 5=reject_accept 6=die_server. op filters client rules
// by wire op (0 = any); key -1 = any; round -1 = every match, else the
// rule fires once at the Nth distinct matching request (client) or the
// Nth completed merge round (kill_server/die_server). arg carries the
// delay in ms / the number of accepts to reject.
void mxtpu_fault_client_add(int kind, int op, long long key,
                            long long round, long long arg) {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  FaultRule r;
  r.kind = kind;
  r.op = op;
  r.key = key;
  r.round = round;
  r.arg = arg;
  g_client_faults.push_back(r);
}

void mxtpu_fault_server_add(int kind, int op, long long key,
                            long long round, long long arg) {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  FaultRule r;
  r.kind = kind;
  r.op = op;
  r.key = key;
  r.round = round;
  r.arg = arg;
  g_server_faults.push_back(r);
}

void mxtpu_fault_clear(void) {
  std::lock_guard<std::mutex> lk(g_fault_mu);
  g_client_faults.clear();
  g_server_faults.clear();
}

// ---------------------------------------------------------------- server
// port < 0 starts a state-only server: no listening socket, no accept
// thread — the in-process harness for snapshot/restore and key
// round-trip tests (and the substrate a future embedded server mode
// can reuse).
int mxtpu_server_start(int port, int num_workers) {
  if (g_server) return -1;
  int fd = -1;
  if (port >= 0) {
    fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (fd < 0) return -2;
    int one = 1;
    ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(port));
    if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
      ::close(fd);
      return -3;
    }
    if (::listen(fd, 64) != 0) {
      ::close(fd);
      return -4;
    }
  }
  if (g_pending_restore) {
    // restart-with-state: adopt the preloaded snapshot before the first
    // accept so no request can observe an empty store
    g_server = g_pending_restore;
    g_pending_restore = nullptr;
    g_server->num_workers = num_workers;  // launcher env wins
    if (g_server->next_rank > num_workers) g_server->next_rank = num_workers;
    // every worker must reconnect; treat them as missing from t0 so a
    // job whose workers never come back still degrades after the grace
    g_server->missing = g_server->next_rank > 0;
    g_server->missing_since = std::chrono::steady_clock::now();
  } else {
    g_server = new Server();
    g_server->num_workers = num_workers;
  }
  {
    // adopt pre-staged grace/updater BEFORE the accept thread exists:
    // no request may ever be processed by a restored server that is
    // missing either
    std::lock_guard<std::mutex> lk(g_server->mu);
    if (g_pending_grace_ms > 0) {
      g_server->recovery_grace_ms = g_pending_grace_ms;
      g_pending_grace_ms = 0;
      start_watchdog_locked(g_server);
    }
    if (g_pending_updater) {
      g_server->updater = g_pending_updater;
      g_pending_updater = nullptr;
    }
  }
  g_server->listen_fd = fd;
  if (fd >= 0) {
    g_server->accept_thread = std::thread([s = g_server] {
      for (;;) {
        int cfd = ::accept(s->listen_fd, nullptr, nullptr);
        if (cfd < 0) break;
        if (fault_take_reject_accept()) {
          ::close(cfd);  // injected accept-seam fault: refuse this one
          continue;
        }
        int one = 1;
        ::setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        std::lock_guard<std::mutex> lk(s->mu);
        s->threads.emplace_back(handle_conn, s, cfd);
      }
    });
  }
  return 0;
}

// arm reconnect-tolerant mode: a missing worker degrades the job only
// after grace_ms without a reconnect (0 = legacy immediate fail-fast).
// Callable BEFORE mxtpu_server_start: the value is staged and adopted
// pre-accept, so a restored server never serves a request ungraced.
void mxtpu_server_set_recovery_grace(int grace_ms) {
  if (!g_server) {
    g_pending_grace_ms = grace_ms;
    return;
  }
  std::lock_guard<std::mutex> lk(g_server->mu);
  g_server->recovery_grace_ms = grace_ms;
  start_watchdog_locked(g_server);
}

// host-language tracing sink for traced requests (wire v2 trace ids).
// Installable any time (pointer store); nullptr disables.
void mxtpu_server_set_trace_sink(TraceSinkFn fn) { g_trace_sink = fn; }

// tracing context of the request the CURRENT connection thread is
// handling — (0, 0) outside a request or for untraced ones. Lets the
// host updater parent its span to the worker push it is applying.
void mxtpu_server_current_trace(unsigned long long* trace_id,
                                unsigned long long* span_id) {
  if (trace_id) *trace_id = t_cur_trace;
  if (span_id) *span_id = t_cur_span;
}

// likewise stageable pre-start: a restored server's first merge round
// must run the restored optimizer, not a plain sum
void mxtpu_server_set_updater(UpdaterFn fn) {
  if (!g_server) {
    g_pending_updater = fn;
    return;
  }
  std::lock_guard<std::mutex> lk(g_server->mu);
  g_server->updater = fn;
  g_server->cv.notify_all();
}

// blocks until a stop command arrives
void mxtpu_server_run(void) {
  if (!g_server) return;
  std::unique_lock<std::mutex> lk(g_server->mu);
  g_server->cv.wait(lk, [] { return g_server->stop; });
}

// host-language server loop: wait up to timeout_ms for an event.
// Returns -1 on stop, >0 = size of a freshly received optimizer blob
// (copied into buf if it fits, else truncated-to-0 and still cleared),
// 0 on timeout with nothing new.
long mxtpu_server_poll(char* buf, uint64_t cap, int timeout_ms) {
  if (!g_server) return -1;
  std::unique_lock<std::mutex> lk(g_server->mu);
  g_server->cv.wait_for(lk, std::chrono::milliseconds(timeout_ms), [] {
    return g_server->stop || !g_server->blobs.empty();
  });
  if (!g_server->blobs.empty()) {
    std::vector<char> blob = std::move(g_server->blobs.front());
    g_server->blobs.pop_front();
    uint64_t n = blob.size();
    if (buf && n <= cap) {
      std::memcpy(buf, blob.data(), n);
      return static_cast<long>(n);
    }
    return 0;
  }
  return g_server->stop ? -1 : 0;
}

// Serialize the whole server state. With buf == NULL (or too small)
// returns the needed size without copying or freezing. With freeze != 0
// the copy and the freeze happen atomically under the server lock: no
// later request can mutate-and-ack state the snapshot missed —
// connections close instead, and clients resend against the restarted
// instance.
long mxtpu_server_snapshot(char* buf, uint64_t cap, int freeze) {
  if (!g_server) return -1;
  std::lock_guard<std::mutex> lk(g_server->mu);
  std::vector<char> out = serialize_locked(g_server);
  if (!buf || out.size() > cap)
    return static_cast<long>(out.size());
  std::memcpy(buf, out.data(), out.size());
  if (freeze) g_server->frozen = true;
  return static_cast<long>(out.size());
}

// Stage a snapshot for the NEXT mxtpu_server_start (which adopts it
// before listening). Returns 0 on success, -1 on a malformed buffer.
int mxtpu_server_preload(const char* buf, uint64_t n) {
  Server* s = deserialize(buf, n);
  if (!s) return -1;
  delete g_pending_restore;
  g_pending_restore = s;
  return 0;
}

// direct key access (restore tooling + in-process tests; the snapshot
// path is the production consumer)
int mxtpu_server_key_write(uint32_t key, const float* data, uint64_t n) {
  if (!g_server) return -1;
  std::lock_guard<std::mutex> lk(g_server->mu);
  KeyState& ks = g_server->keys[key];
  ks.store.assign(data, data + n);
  return 0;
}

long mxtpu_server_key_read(uint32_t key, float* out, uint64_t cap) {
  if (!g_server) return -1;
  std::lock_guard<std::mutex> lk(g_server->mu);
  auto it = g_server->keys.find(key);
  if (it == g_server->keys.end()) return -2;
  if (it->second.store.size() > cap) return -3;
  std::memcpy(out, it->second.store.data(), it->second.store.size() * 4);
  return static_cast<long>(it->second.store.size());
}

void mxtpu_server_shutdown(void) {
  if (!g_server) return;
  Server* s = g_server;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    s->watchdog_stop = true;
    s->cv.notify_all();
  }
  if (s->watchdog.joinable()) s->watchdog.join();
  if (s->listen_fd >= 0) {
    ::shutdown(s->listen_fd, SHUT_RDWR);
    ::close(s->listen_fd);
  }
  if (s->accept_thread.joinable()) s->accept_thread.join();
  std::vector<std::thread> workers;
  {
    std::lock_guard<std::mutex> lk(s->mu);
    workers.swap(s->threads);
  }
  for (auto& t : workers) t.detach();  // blocked on dead fds; reclaimed at exit
  g_server = nullptr;
}

// ---------------------------------------------------------------- client
struct Client {
  int fd;
  int rank;
  int num_workers;
  // a timed-out/failed request leaves the stream desynchronized (a late
  // response would be parsed as the NEXT request's reply) — poison the
  // connection instead
  bool broken = false;
  // monotonically increasing request id; a reconnecting client pins the
  // next id to the failed request's id so its resend is idempotent
  uint64_t next_req_id = 1;
  std::mutex mu;
};

// tracing context stamped on the next request ISSUED BY THIS THREAD
// (consumed by it); 0 = untraced. Thread-local, NOT per-client: the
// transport supports concurrent callers on one connection, and a
// set-then-send stash on the handle would let caller B's request()
// consume caller A's context between A's set_trace and A's send.
thread_local uint64_t t_next_trace_id = 0;
thread_local uint64_t t_next_span_id = 0;

static void* connect_common(const char* host, int port, const char* magic,
                            const uint32_t* claim_rank) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
    ::close(fd);
    return nullptr;
  }
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (!write_full(fd, magic, 5) ||
      (claim_rank && !write_full(fd, claim_rank, 4))) {
    ::close(fd);
    return nullptr;
  }
  uint32_t hello[2];
  // a bounded hello wait: a half-open server (accepted but frozen or
  // wedged mid-restart) must look like a failed connect, not a hang
  timeval tv{10, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  if (!read_full(fd, hello, 8)) {
    ::close(fd);
    return nullptr;
  }
  timeval off{0, 0};
  ::setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &off, sizeof(off));
  Client* c = new Client();
  c->fd = fd;
  c->rank = static_cast<int>(hello[0]);
  c->num_workers = static_cast<int>(hello[1]);
  return c;
}

void* mxtpu_client_connect(const char* host, int port) {
  return connect_common(host, port, "MXT2w", nullptr);
}

// reconnect after a transport failure, reclaiming a previously assigned
// rank (the rendezvous re-run of the recovery protocol)
void* mxtpu_client_connect_as(const char* host, int port, int rank) {
  uint32_t r = static_cast<uint32_t>(rank);
  return connect_common(host, port, "MXT2r", &r);
}

// per-request deadline: a request outliving this fails with rc -1
// instead of hanging forever on a dead server/worker set
void mxtpu_client_set_timeout(void* h, int ms) {
  Client* c = static_cast<Client*>(h);
  timeval tv{ms / 1000, (ms % 1000) * 1000};
  ::setsockopt(c->fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  ::setsockopt(c->fd, SOL_SOCKET, SO_SNDTIMEO, &tv, sizeof(tv));
}

int mxtpu_client_rank(void* h) { return static_cast<Client*>(h)->rank; }
int mxtpu_client_num_workers(void* h) {
  return static_cast<Client*>(h)->num_workers;
}

// request-id plumbing for the Python recovery loop: after a failure the
// caller reads the id the failed request consumed (next-1), reconnects,
// and pins the fresh connection's next id to it so the resend carries
// the SAME id (idempotent at the server).
unsigned long long mxtpu_client_get_next_req_id(void* h) {
  Client* c = static_cast<Client*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  return c->next_req_id;
}

void mxtpu_client_set_next_req_id(void* h, unsigned long long id) {
  Client* c = static_cast<Client*>(h);
  std::lock_guard<std::mutex> lk(c->mu);
  c->next_req_id = id;
}

// stamp the tracing context on this thread's next request (consumed by
// it; call again before a recovery resend — the Python span wrapper
// does). The handle parameter is kept for ABI symmetry; the stash is
// thread-local, so set_trace and the request it decorates must run on
// the same thread (they do: the span wrapper calls both inline).
void mxtpu_client_set_trace(void* /*h*/, unsigned long long trace_id,
                            unsigned long long span_id) {
  t_next_trace_id = trace_id;
  t_next_span_id = span_id;
}

static int request(Client* c, uint8_t op, uint32_t key, const void* payload,
                   uint64_t nbytes, void* out, uint64_t out_cap,
                   uint64_t* out_n) {
  std::lock_guard<std::mutex> lk(c->mu);
  // consume the id BEFORE the broken check: the recovery loop derives
  // the resend id as next-1, so a request failing on an already-broken
  // handle must still own a fresh id — resending a PREVIOUS request's
  // id would be deduped by the server's watermark into a silent no-op
  uint64_t rid = c->next_req_id++;
  uint64_t tid = t_next_trace_id, sid = t_next_span_id;
  t_next_trace_id = t_next_span_id = 0;
  if (c->broken) return -1;
  Header h{op, key, rid, nbytes, tid, sid};
  // client-seam fault rules: drop/delay/truncate at the exact request
  long long delay_ms = 0;
  int fault = fault_match(&g_client_faults, c->rank, op, key, h.req_id,
                          &delay_ms);
  if (delay_ms > 0)
    std::this_thread::sleep_for(std::chrono::milliseconds(delay_ms));
  if (fault == kFaultDropConn) {
    ::shutdown(c->fd, SHUT_RDWR);
    c->broken = true;
    return -1;
  }
  if (fault == kFaultTruncFrame) {
    // write the header promising nbytes, deliver only half, then drop:
    // the server must treat the torn frame as a dead connection
    write_full(c->fd, &h, sizeof(h));
    if (nbytes > 0) write_full(c->fd, payload, nbytes / 2);
    ::shutdown(c->fd, SHUT_RDWR);
    c->broken = true;
    return -1;
  }
  if (!write_full(c->fd, &h, sizeof(h))) { c->broken = true; return -1; }
  if (nbytes > 0 && !write_full(c->fd, payload, nbytes)) {
    c->broken = true;
    return -1;
  }
  char rhdr[9];
  if (!read_full(c->fd, rhdr, 9)) { c->broken = true; return -1; }
  uint64_t rn;
  std::memcpy(&rn, rhdr + 1, 8);
  if (out_n) *out_n = rn;
  if (rn > 0) {
    if (out == nullptr || rn > out_cap) {
      // drain
      std::vector<char> sink(rn);
      if (!read_full(c->fd, sink.data(), rn)) c->broken = true;
      return -2;
    }
    if (!read_full(c->fd, out, rn)) { c->broken = true; return -1; }
  }
  return rhdr[0] == 1 ? 0 : -3;
}

int mxtpu_client_init(void* h, uint32_t key, const float* data, uint64_t n) {
  return request(static_cast<Client*>(h), kInit, key, data, n * 4, nullptr,
                 0, nullptr);
}

int mxtpu_client_push(void* h, uint32_t key, const float* data, uint64_t n) {
  return request(static_cast<Client*>(h), kPush, key, data, n * 4, nullptr,
                 0, nullptr);
}

int mxtpu_client_push_2bit(void* h, uint32_t key, const void* buf,
                           uint64_t nbytes) {
  return request(static_cast<Client*>(h), kPush2Bit, key, buf, nbytes,
                 nullptr, 0, nullptr);
}

int mxtpu_client_pull(void* h, uint32_t key, float* out, uint64_t n) {
  uint64_t got = 0;
  int rc = request(static_cast<Client*>(h), kPull, key, nullptr, 0, out,
                   n * 4, &got);
  if (rc != 0) return rc;
  return static_cast<int>(got / 4);
}

// row-granular sparse pull: out must hold n_rows*row_len floats;
// returns number of floats received or <0 on error
long mxtpu_client_pull_rows(void* h, uint32_t key, const int32_t* row_ids,
                            uint64_t n_rows, uint64_t row_len,
                            float* out) {
  std::vector<char> body(8 + n_rows * 4);
  std::memcpy(body.data(), &row_len, 8);
  std::memcpy(body.data() + 8, row_ids, n_rows * 4);
  uint64_t got = 0;
  int rc = request(static_cast<Client*>(h), kPullRows, key, body.data(),
                   body.size(), out, n_rows * row_len * 4, &got);
  if (rc != 0) return rc;
  return static_cast<long>(got / 4);
}

int mxtpu_client_barrier(void* h) {
  return request(static_cast<Client*>(h), kBarrier, 0, nullptr, 0, nullptr,
                 0, nullptr);
}

int mxtpu_client_command(void* h, uint32_t cmd, const char* body,
                         uint64_t n) {
  return request(static_cast<Client*>(h), kCommand, cmd, body, n, nullptr,
                 0, nullptr);
}

void mxtpu_client_close(void* h) {
  Client* c = static_cast<Client*>(h);
  ::close(c->fd);
  delete c;
}

}  // extern "C"
