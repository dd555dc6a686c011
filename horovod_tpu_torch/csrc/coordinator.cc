// Copied from csrc/coordinator.cc:1-2294 (verbatim below this line; common/native.py builds it into the port's own library).
// TPU-native coordinator control plane: TCP negotiation over DCN.
//
// Native equivalent of the reference's controller transports
// (horovod/common/mpi/mpi_controller.cc, horovod/common/gloo/gloo_controller.cc
// — SURVEY.md §2a N2/N3/N4) with the transport swapped per SURVEY.md §5
// ("distributed communication backend"): instead of MPI gather/bcast of
// serialized Request/Response messages, a rank-0 TCP server runs lock-step
// negotiation rounds with every worker over DCN.  The data plane is NOT
// here — fused collectives execute as XLA programs over ICI; this is purely
// the out-of-graph readiness protocol (which tensors are pending on every
// rank, in what order), plus rank-0 stall tracking (N11's role).
//
// Wire protocol (all little-endian, length-prefixed frames):
//   frame  := uint32 payload_len, payload
//   C->S   := uint32 n_announce, n_announce * { uint16 required,
//                                               uint16 len, bytes name,
//                                               uint16 dlen, bytes digest,
//                                               uint16 glen, bytes group,
//                                               uint16 plen, bytes datadep,
//                                               uint16 tlen, bytes tag }
//             uint32 bv_len, bytes bitvec       (bit i = cache slot i pending)
//             uint32 n_tag, n_tag * { uint32 slot, uint16 len, bytes tag }
//             [optional, protocol v3] uint32 magic "MON1",
//                                     uint32 blen, bytes monitor_blob
//             (the monitor side-channel: an opaque telemetry snapshot the
//              rank ships at its HOROVOD_MONITOR_INTERVAL — absent on most
//              rounds.  A pre-v3 server never parses past the tag section,
//              so the trailing bytes are ignored: old servers tolerate new
//              clients.  Low priority by construction: the blob rides the
//              same lock-step frame, so it can never delay a negotiation
//              verdict — it only adds bytes to rounds that carry it)
//             (the bitvector is the steady-state fast path: a slot id is a
//              replicated handle for a (name, digest, required, datadep,
//              grouped) tuple the server assigned on its first full
//              announce; a round in the warm regime carries ONLY the
//              fixed-size bitvector — no per-tensor metadata.  `tag` is the
//              runtime sanitizer's seq/call-site tag: on the full path it
//              used to ride inside the digest, now it travels beside it so
//              the slot key stays step-invariant while divergence detection
//              keeps working on the cached path via the sparse tag section)
//             (names newly enqueued on this rank since the last round;
//              `required` = number of ranks that must announce before the
//              tensor is ready — process-set size; 0 means the full world.
//              `digest` describes the submission — op|dtype|shape|root —
//              so rank 0 can reject divergent submissions (the reference
//              controller's shape/dtype consistency checks, SURVEY.md N2).
//              `group` is the announcer's local grouped-collective id ("-1"
//              for ungrouped) — NOT part of the mismatch comparison, since
//              group counters legitimately drift across ranks (uneven join
//              epochs); the server namespaces it by first-announcer rank
//              and echoes it so joined ranks preserve group batching.
//              `datadep` marks collectives that need real data from
//              specific ranks: "-1" none (reductions), "-2" every rank
//              (allgather/alltoall), or a root rank (broadcast) — if the
//              needed rank has JOINED the server answers with a per-tensor
//              error instead of fabricating data.
//              A round with nothing new sends n_announce = 0)
//   S->C   := uint32 n_ready,   n_ready * { uint16 len, bytes name,
//                                           uint16 dlen, bytes digest,
//                                           uint16 glen, bytes group }
//             uint32 n_warn,    n_warn  * { uint16 len, bytes text }
//             uint32 n_err,     n_err   * { uint16 len, bytes name,
//                                           uint16 mlen, bytes message }
//             uint32 n_assign,  n_assign * { name, digest, datadep,
//                                            uint16 required,
//                                            uint16 grouped, uint32 id }
//             uint32 bv_len, bytes ready_bitvec (bit i = slot i ready; only
//                                                used while no rank is
//                                                joined — joined ranks need
//                                                the digest strings to
//                                                synthesize contributions)
//             uint32 n_evict, n_evict * uint32 slot
//             [protocol v3] uint32 magic "MON1", uint32 n_blob,
//                           n_blob * { uint32 rank, uint32 blen, bytes }
//             (store-and-forward of the monitor blobs received THIS round,
//              re-broadcast to every rank so each process — most usefully
//              rank 0's HTTP exporter — can hold the fleet-wide telemetry
//              table.  Always appended (even empty): the magic doubles as
//              the server's protocol-v3 capability advertisement, which is
//              how clients version-gate their own monitor frames.  Pre-v3
//              clients stop parsing after the eviction section and ignore
//              the trailing bytes)
//             [protocol v4, FIRST ROUND ONLY] uint32 magic "FLT1",
//                           uint32 0
//             (the server's fault-tolerance capability advertisement.
//              Appended only to round 1's response so the warm path pays
//              ZERO extra bytes — by round 2 every client has latched it.
//              Symmetrically, a v4 client appends an empty FLT1 section to
//              its FIRST request only; the server latches the rank as
//              v4-capable and may send it the typed ABORT frame below.
//              Trailing sections in both directions are (magic, len,
//              payload) tuples walked generically, so MON1 and FLT1
//              compose in any order and unknown magics are skipped — the
//              same old-peers-ignore-trailing-bytes contract as MON1)
//
//   [protocol v5, FIRST ROUND ONLY] uint32 magic "AGG5", uint32 0
//             (the hierarchical-control-plane capability advertisement,
//              both directions, round 1 only — exactly the FLT1 pattern,
//              so the warm path carries zero extra bytes.  On the request
//              side it rides BEFORE the FLT1 section: the server's
//              pre-processing FLT1 salvage reads the frame's final 8
//              bytes, so FLT1 must stay last.)
//
//   LEAVE  := uint32 0xFFFFFFFE, uint32 magic "LVE6"
//             (protocol v6 clean departure: a rank announces its own
//              orderly exit IN PLACE of a round frame, immediately before
//              severing its socket.  0xFFFFFFFE is an impossible
//              n_announce, so the frame is unambiguous against every
//              normal request.  The server drops the rank from the gather
//              with NO dead-peer verdict: the rank stops counting toward
//              world-level readiness (pending entries keep their raw
//              required=0 marker and re-materialize against the shrunk
//              effective world at verdict time), its connection leaves the
//              poller, and survivors are told through a trailing LVE6
//              response section.  The ONE abort case: the leaver still has
//              outstanding negotiated work (a pending tensor it announced,
//              or — while joined — an implicit world-level credit) whose
//              readiness would include a rank that will never execute it;
//              then the server broadcasts the typed ABORT naming the
//              leaver, exactly like a crash, because the departure was NOT
//              clean.  Version gating: the client advertises v6 with a
//              round-1 LVE6 request section (between AGG5 and the final
//              FLT1) and the server advertises with a round-1 LVE6
//              response section (after AGG5); the server honors a LEAVE
//              only when EVERY survivor has latched v6 — a pre-v6 survivor
//              cannot parse the leave notice and would execute
//              shrunk-world verdicts its fixed-size data plane cannot
//              resolve — otherwise the LEAVE is ignored and the leaver's
//              subsequent socket sever produces the legacy v4 verdict.
//              Races: a LEAVE landing mid-gather counts as the rank's
//              round frame (the deadline is satisfied, the gather
//              completes with the survivors); one landing during a
//              response write sits in the reassembly buffer and is taken
//              as the NEXT round's frame — the sock_dead the sever leaves
//              behind is ignored for a left connection, never a verdict.)
//
//   S->C   += [protocol v6] uint32 magic "LVE6", uint32 len,
//             uint32 n_left, n_left * uint32 rank
//             (ranks that left THIS round, appended after the MON1
//              section only on rounds where someone actually left — the
//              warm path carries zero extra bytes — plus an empty
//              (n_left = 0) section on round 1 as the capability ad.
//              Pre-v6 clients stop their trailing walk at the unknown
//              magic and lose nothing.)
//
//   [protocol v7, zero-RTT warm path] uint32 magic "ZRT7"
//             Speculative readiness: when a cache slot has been
//             ready-on-first-announce for spec_ready_after consecutive
//             rounds (hvdtpu_server_start's 6th arg; 0 = off), the server
//             piggybacks a PREDICTED next-round ready verdict on this
//             round's response:
//               S->C   += uint32 "ZRT7", uint32 len,
//                         uint32 n_pred, n_pred * uint32 slot
//             (appended only on rounds that actually predict — the warm
//              path with speculation off carries zero extra bytes — plus
//              an empty (n_pred = 0) section on round 1 as the capability
//              ad, after the LVE6 ad so pre-v7 clients latch everything
//              older before their trailing walk stops.)  A client whose
//              ENTIRE next-round announce is exactly the predicted slot
//              set may then dispatch the verdict without waiting for the
//              response: it sends the round frame with a one-byte confirm
//              section appended —
//               C->S   += uint32 "ZRT7", uint32 1, uint8 1
//              — and defers reading the response to the start of its next
//              round (the zero-RTT skip; the v4 abort and LVE6 notices a
//              deferred response may carry are honored there, one round
//              late, bounded by the client's in-flight window).  The
//              request-side ad is an empty ZRT7 section on round 1,
//              between LVE6 and the final FLT1.  Predictions are only
//              emitted while EVERY rank has latched v7 (no wire bytes
//              change for old peers), no rank is joined, and no rank left
//              this round.  A mispredict (a predicted slot not ready next
//              round — a rank skipped a cycle, or any slot-invalidation
//              event: digest change, eviction, join epoch, LEAVE) resets
//              the slot's streak, so speculation disengages and the
//              verdict resolves through normal full rounds until the
//              streak rebuilds; the speculating client merely consumed a
//              verdict early — its announce stays pending server-side and
//              the late real verdict is absorbed by its next entry, so
//              results stay bitwise identical.
//
//   AGENT  := a per-host aggregator (horovod_tpu/common/host_agent.py) may
//             connect IN PLACE of its host's ranks: handshake word
//             0xFFFFFF05 ("v5 agent hello", outside the rank space), then
//             one frame { u32 host_index, u32 n_ranks, n_ranks * u32 rank }
//             claiming the ranks it serves.  Each round the agent sends ONE
//             uplink frame for the whole host:
//
//   uplink := u32 magic "HUP5"
//             u32 n_dead, n_dead * u32 rank      (local ranks whose socket
//                                                 died — propagated up so
//                                                 the root can abort with
//                                                 rank attribution)
//             u32 agg_nranks                     (0 = no aggregate section)
//             [if agg_nranks>0] u32 bv_len, bytes bitvec
//             u32 n_sub, n_sub * { u32 rank, u32 flen, bytes rank-frame }
//             u32 n_mon, n_mon * { u32 rank, u32 blen, bytes blob }
//
//             (the aggregate bitvector is the warm-path win: when every
//              local rank's round frame is a pure warm frame — no full
//              announces, no tags, no trailing sections — with an
//              IDENTICAL pending bitvector (the synchronized steady state:
//              all ranks submit the same tensors in the same cycle), the
//              agent collapses them into ONE fixed-size section that
//              counts for all agg_nranks ranks at once.  Any asymmetric or
//              non-warm frame is forwarded per-rank in the sub section,
//              byte-identical to what the rank sent (minus extracted MON1
//              blobs, which travel deduplicated in the mon section), so
//              full negotiation, sanitizer tags, FLT1 ads and join frames
//              keep their exact flat-mode semantics.  The root answers
//              with its ordinary response frame, written ONCE per host;
//              the agent fans it down verbatim — responses were already
//              rank-agnostic.  Root-side gather work therefore scales
//              with hosts, not ranks: one readable fd, one frame parse
//              and one response write per host per round.)
//
//   ABORT  := uint32 0xFFFFFFFF, uint32 magic "ABT4",
//             uint32 n_dead, n_dead * uint32 rank, { u16 len, reason }
//             (protocol v4 liveness verdict, sent IN PLACE of a normal
//              response when the server declares ranks dead — a client
//              socket died (recv 0 / ECONNRESET / write failure) or a
//              rank missed the per-round deadline.  0xFFFFFFFF is an
//              impossible n_ready, so v4 clients detect the frame
//              unambiguously and raise a typed PeerFailureError carrying
//              the dead-rank list; v3 clients never receive it — the
//              server version-gates on the request-side FLT1 ad and
//              simply severs pre-v4 clients (they fail with the legacy
//              rc=-1 path, exactly the pre-v4 behavior).  The server
//              stops after an abort: the surviving world re-forms through
//              the elastic driver, never through a half-dead server)
//             (evictions are broadcast in the same lock-step round on every
//              rank, so client slot tables can never diverge; a join epoch
//              flushes ALL slots — full renegotiation while the world is
//              uneven, and fresh slot state afterwards)
//             (ready = pending on ALL ranks, in deterministic order:
//              first-announce round, then name; the digest rides along so
//              JOINED ranks can synthesize zero contributions for tensors
//              they never submitted — the reference's hvd.join() semantics;
//              warn = stall diagnoses naming the missing ranks, the
//              reference's stall_inspector output; err = per-tensor
//              negotiation failures — digest mismatch across ranks —
//              broadcast until every required rank has announced the name,
//              the reference's per-tensor error Response)
//
// join protocol: announcing the reserved name "\x1f__join__" marks the
// sender joined (reference: hvd.join, horovod/common/controller.cc's join
// handling).  Joined ranks count as implicitly ready for every world-level
// tensor.  When ALL ranks have joined, the server broadcasts the reserved
// ready entry "\x1f__all_joined__" whose digest is the last joining rank,
// then resets join state (the world resumes normal operation).
//
// Exported C ABI (ctypes-consumed by horovod_tpu/common/native.py):
//   hvdtpu_server_start(port, world, stall_warn_s, cache_capacity,
//                       round_deadline_ms, spec_ready_after,
//                       spec_seed) -> handle
//       (spec_seed: initial speculation streak for newly created cache
//        slots — the elastic streak-carryover hint a re-rendezvous
//        survivor passes so warm speculation re-engages in O(1) rounds;
//        0 = relearn from zero, the non-elastic default)
//   hvdtpu_server_stop(handle)
//   hvdtpu_client_connect(host, port, rank, timeout_ms) -> handle
//   hvdtpu_client_round(handle, req, req_len, resp_buf, resp_cap) -> resp_len
//   hvdtpu_client_send(handle, req, req_len) -> 0 / -1
//   hvdtpu_client_recv(handle, resp_buf, resp_cap, timeout_ms)
//       -> resp_len / -1 (error) / -2 (overflow) / -3 (timeout)
//   hvdtpu_client_pending(handle) -> 1 if a frame is already readable
//   hvdtpu_client_close(handle)

#include <arpa/inet.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#ifdef __linux__
#include <sys/epoll.h>
#endif
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <set>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

// Monitor side-channel section marker ("MON1" little-endian).  Doubles as
// the protocol-v3 capability advertisement in responses.
constexpr uint32_t kMonMagic = 0x314e4f4d;
// Fault-tolerance capability section marker ("FLT1" little-endian) —
// protocol v4.  Rides a trailing (magic, len) section exactly like MON1:
// request side on round 1 only (client ad), response side on round 1 only
// (server ad), so the warm path carries zero extra bytes.
constexpr uint32_t kFltMagic = 0x31544c46;
// Typed abort frame marker ("ABT4") behind the 0xFFFFFFFF escape.
constexpr uint32_t kAbortMagic = 0x34544241;
constexpr uint32_t kAbortEscape = 0xffffffffu;
// Hierarchical control plane (protocol v5): capability ad ("AGG5", round 1
// only in both directions, exactly the FLT1 pattern), the per-host agent's
// hello word (outside the rank space — ranks are < world < 2^31), and the
// host uplink frame magic ("HUP5").
constexpr uint32_t kAggMagic = 0x35474741;
constexpr uint32_t kAgentHello = 0xffffff05u;
constexpr uint32_t kHupMagic = 0x35505548;
// Clean-LEAVE (protocol v6): the request-side escape word (an impossible
// n_announce, mirroring the response side's 0xFFFFFFFF abort escape) and
// the "LVE6" magic that doubles as the capability ad in both directions.
constexpr uint32_t kLeaveEscape = 0xfffffffeu;
constexpr uint32_t kLeaveMagic = 0x3645564c;
// Zero-RTT warm path (protocol v7): "ZRT7" doubles as the round-1
// capability ad (both directions), the response-side prediction section
// marker, and the request-side one-byte speculation confirm.
constexpr uint32_t kZrtMagic = 0x3754525a;

// A standalone clean-LEAVE frame: { kLeaveEscape, kLeaveMagic }.
bool is_leave_frame(const uint8_t* p, size_t n) {
  if (n < 8) return false;
  uint32_t esc = 0, magic = 0;
  std::memcpy(&esc, p, 4);
  std::memcpy(&magic, p + 4, 4);
  return esc == kLeaveEscape && magic == kLeaveMagic;
}
// Per-blob and per-response caps for the monitor section: the aggregate
// re-broadcast must stay well inside the client's fixed 4MB receive
// buffer (_RESP_CAP in common/controller.py) no matter how many ranks
// report in one round — telemetry that overflows is dropped, never a
// negotiation failure.  Dropped blobs are naturally retried: the rank
// re-reports at its next interval.
constexpr uint32_t kMonBlobCap = 64 * 1024;
constexpr size_t kMonSectionCap = 1024 * 1024;

// ---------------------------------------------------------------- framing
bool read_exact(int fd, void* buf, size_t n) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_exact(int fd, const void* buf, size_t n) {
  const auto* p = static_cast<const uint8_t*>(buf);
  while (n > 0) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) return false;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool read_frame(int fd, std::vector<uint8_t>* out) {
  uint32_t len = 0;
  if (!read_exact(fd, &len, 4)) return false;
  out->resize(len);
  return len == 0 || read_exact(fd, out->data(), len);
}

// Deadline-bounded read: like read_exact, but every recv is gated on a
// poll() against an ABSOLUTE deadline, so a peer that wedges mid-frame-
// write (SIGSTOPped / paged out after the length prefix) cannot block
// the caller past its deadline — a blocking read here would defeat both
// the server's per-round deadline and the client's round timeout.
// Returns 1 on success, 0 on deadline expiry, -1 on a dead socket (or
// `stop`, polled each quantum so teardown never waits the deadline out).
int read_exact_deadline(int fd, void* buf, size_t n,
                        Clock::time_point deadline,
                        const std::atomic<bool>* stop = nullptr) {
  auto* p = static_cast<uint8_t*>(buf);
  while (n > 0) {
    auto rem = std::chrono::duration_cast<std::chrono::milliseconds>(
                   deadline - Clock::now())
                   .count();
    if (rem <= 0) return 0;
    if (stop != nullptr && stop->load()) return -1;
    pollfd pfd{fd, POLLIN, 0};
    int pn = ::poll(&pfd, 1, static_cast<int>(std::min<int64_t>(rem, 100)));
    if (pn < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (pn == 0) continue;
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) return -1;
    p += r;
    n -= static_cast<size_t>(r);
  }
  return 1;
}

int read_frame_deadline(int fd, std::vector<uint8_t>* out,
                        Clock::time_point deadline,
                        const std::atomic<bool>* stop = nullptr) {
  uint32_t len = 0;
  int rc = read_exact_deadline(fd, &len, 4, deadline, stop);
  if (rc <= 0) return rc;
  out->resize(len);
  if (len == 0) return 1;
  return read_exact_deadline(fd, out->data(), len, deadline, stop);
}

bool write_frame(int fd, const std::vector<uint8_t>& payload) {
  uint32_t len = static_cast<uint32_t>(payload.size());
  if (!write_exact(fd, &len, 4)) return false;
  return payload.empty() || write_exact(fd, payload.data(), payload.size());
}

void put_u16(std::vector<uint8_t>* b, uint16_t v) {
  b->push_back(v & 0xff);
  b->push_back((v >> 8) & 0xff);
}

void put_u32(std::vector<uint8_t>* b, uint32_t v) {
  for (int i = 0; i < 4; ++i) b->push_back((v >> (8 * i)) & 0xff);
}

void put_str(std::vector<uint8_t>* b, const std::string& s) {
  put_u16(b, static_cast<uint16_t>(s.size()));
  b->insert(b->end(), s.begin(), s.end());
}

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint16_t u16() {
    if (p + 2 > end) { ok = false; return 0; }
    uint16_t v = p[0] | (p[1] << 8);
    p += 2;
    return v;
  }
  uint32_t u32() {
    if (p + 4 > end) { ok = false; return 0; }
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= static_cast<uint32_t>(p[i]) << (8 * i);
    p += 4;
    return v;
  }
  std::string str() {
    uint16_t n = u16();
    if (p + n > end) { ok = false; return ""; }
    std::string s(reinterpret_cast<const char*>(p), n);
    p += n;
    return s;
  }
};

// ------------------------------------------------------- connection state
// One accepted control-plane connection: a single rank (flat mode) or a
// per-host agent speaking for several ranks (protocol v5).  Reads are
// non-blocking (MSG_DONTWAIT; the fd itself stays blocking so response
// writes need no EAGAIN handling) into a per-connection reassembly buffer:
// the gather loop never blocks inside one peer's half-written frame, so a
// wedged peer can only cost its own round-deadline verdict, never the
// whole control plane's liveness.
struct Conn {
  int fd = -1;
  std::vector<int> ranks;           // ranks this connection speaks for
  bool is_agent = false;
  std::vector<uint8_t> inbuf;       // partial frame bytes (reassembly)
  std::vector<std::vector<uint8_t>> frames;  // complete frames, FIFO
  bool sock_dead = false;
  // Every rank this connection spoke for departed via clean LEAVE
  // (protocol v6): removed from the poller, skipped by the gather, the
  // deadline verdicts and the response write — its inevitable trailing
  // EOF must never become a dead-peer verdict.  (An agent connection
  // only flips this once its LAST local rank left; individual leaves
  // just shrink `ranks`.)
  bool left = false;

  // Drain everything currently readable without blocking; extract complete
  // frames.  Returns false once the socket is dead (EOF / hard error).
  int dead_errno = 0;   // diagnostic: errno at death (0 = orderly EOF)
  bool drain() {
    if (sock_dead) return false;
    uint8_t tmp[65536];
    for (;;) {
      ssize_t r = ::recv(fd, tmp, sizeof(tmp), MSG_DONTWAIT);
      if (r > 0) {
        inbuf.insert(inbuf.end(), tmp, tmp + r);
        if (static_cast<size_t>(r) < sizeof(tmp)) break;  // likely drained
        continue;
      }
      if (r == 0) { sock_dead = true; dead_errno = 0; break; }
      if (errno == EAGAIN || errno == EWOULDBLOCK) break;
      if (errno == EINTR) continue;
      sock_dead = true;
      dead_errno = errno;
      break;
    }
    // Reassemble: length-prefixed frames, possibly several per drain.
    while (inbuf.size() >= 4) {
      uint32_t len = inbuf[0] | (inbuf[1] << 8) | (inbuf[2] << 16)
          | (static_cast<uint32_t>(inbuf[3]) << 24);
      if (inbuf.size() < 4 + static_cast<size_t>(len)) break;
      frames.emplace_back(inbuf.begin() + 4, inbuf.begin() + 4 + len);
      inbuf.erase(inbuf.begin(), inbuf.begin() + 4 + len);
    }
    return !sock_dead;
  }
};

// Readiness multiplexer for the gather loop: epoll on Linux, a pollfd-set
// fallback elsewhere (or under HVD_TPU_COORD_EPOLL=0, which keeps the
// fallback testable on Linux).  One instance per server lifetime — fds are
// registered once after the world assembles, not rebuilt per round like
// the old poll-per-fd gather.
class Poller {
 public:
  Poller() {
#ifdef __linux__
    const char* env = std::getenv("HVD_TPU_COORD_EPOLL");
    if (env == nullptr || env[0] != '0') epfd_ = ::epoll_create1(0);
#endif
  }
  ~Poller() {
#ifdef __linux__
    if (epfd_ >= 0) ::close(epfd_);
#endif
  }
  bool using_epoll() const { return epfd_ >= 0; }
  void add(int fd, int idx) {
#ifdef __linux__
    if (epfd_ >= 0) {
      epoll_event ev{};
      ev.events = EPOLLIN;
      ev.data.u32 = static_cast<uint32_t>(idx);
      ::epoll_ctl(epfd_, EPOLL_CTL_ADD, fd, &ev);
      return;
    }
#endif
    pfds_.push_back(pollfd{fd, POLLIN, 0});
    idxs_.push_back(idx);
  }
  void remove(int fd) {
#ifdef __linux__
    if (epfd_ >= 0) {
      ::epoll_ctl(epfd_, EPOLL_CTL_DEL, fd, nullptr);
      return;
    }
#endif
    for (size_t i = 0; i < pfds_.size(); ++i)
      if (pfds_[i].fd == fd) {
        pfds_.erase(pfds_.begin() + i);
        idxs_.erase(idxs_.begin() + i);
        break;
      }
  }
  // Fills `ready` with registered indices that have data (or EOF/error)
  // pending.  Returns poll()/epoll_wait() rc (<0 only on a real error).
  int wait(int timeout_ms, std::vector<int>* ready) {
    ready->clear();
#ifdef __linux__
    if (epfd_ >= 0) {
      epoll_event evs[64];
      int n = ::epoll_wait(epfd_, evs, 64, timeout_ms);
      for (int i = 0; i < n; ++i)
        ready->push_back(static_cast<int>(evs[i].data.u32));
      return n;
    }
#endif
    int n = ::poll(pfds_.data(), static_cast<nfds_t>(pfds_.size()),
                   timeout_ms);
    if (n > 0)
      for (size_t i = 0; i < pfds_.size(); ++i)
        if (pfds_[i].revents & (POLLIN | POLLHUP | POLLERR))
          ready->push_back(idxs_[i]);
    return n;
  }

 private:
  int epfd_ = -1;
  std::vector<pollfd> pfds_;   // fallback set
  std::vector<int> idxs_;
};

// ----------------------------------------------------------------- server
struct PendingInfo {
  uint64_t order;            // announce sequence for deterministic ordering
  std::set<int> ready_ranks;
  // Ranks needed.  Kept RAW (0 = the full world, the announce-side
  // marker) and materialized against the EFFECTIVE world — world minus
  // clean leavers — at verdict time, so a rank departing via LEAVE
  // (protocol v6) shrinks the threshold of already-pending world-level
  // tensors instead of wedging them on a contribution that will never
  // come.  Sub-process-set thresholds (required > 0) are unaffected.
  int required = 0;
  Clock::time_point first_seen;
  bool warned = false;
  // Shape/dtype consistency: digest of the first announce, plus who
  // announced what when a divergence appears (for rank attribution).
  std::string digest;
  std::map<std::string, std::set<int>> by_digest;
  bool errored = false;
  // Cache slot this pending instance may be answered through (-1 = must use
  // the string path: no slot exists, a full announcer could not be assigned
  // one, or a join epoch flushed the table mid-negotiation).
  int64_t slot = INT64_MIN;  // INT64_MIN = unset
  // First announcer's group id, namespaced by their rank ("3:7"; "-1" for
  // ungrouped) — echoed to joined ranks so synthesized entries batch
  // exactly like the peers' grouped entries.
  std::string group = "-1";
  // Group STRUCTURE consistency: ids legitimately drift across ranks, but
  // grouped-vs-ungrouped divergence means ranks would batch differently at
  // the fusion threshold and execute mismatched programs — error instead.
  std::set<int> grouped_ranks;
  std::set<int> ungrouped_ranks;
  // Data dependency: -1 none, -2 needs every rank, >=0 needs that root.
  int data_dep = -1;
  // Round this pending instance was created in: a slot verdict counts
  // toward its speculation streak (protocol v7) only when announce and
  // ready landed in the SAME round — the warm steady-state shape.
  uint64_t round_created = 0;
};

struct Server {
  int listen_fd = -1;
  int world = 0;
  // Per-rank sockets: fixed-size, preallocated before the loop thread
  // starts, written by run() and shutdown() by server_stop concurrently —
  // hence atomic slots rather than a resizable vector.
  std::unique_ptr<std::atomic<int>[]> fds;
  // Accepted-but-unidentified connection (rank handshake in flight); tracked
  // so server_stop can unblock a handshake read too.
  std::atomic<int> handshake_fd{-1};
  std::thread loop;
  std::atomic<bool> stop{false};
  // Held by run_inner() across a round's compute+write phase.  server_stop
  // acquires it (with a grace timeout) BEFORE severing client sockets, so a
  // shutdown initiated by rank 0 the instant its own response lands can
  // never cut off the same round's responses to the other ranks mid-write
  // (observed: rank 0 completes the final barrier and calls shutdown while
  // ranks 1..n-1's responses are still being written — they then die with
  // rc=-1 and a pending entry instead of completing).
  std::timed_mutex phase_mu;
  std::map<std::string, PendingInfo> pending;
  // Response cache (reference N8 response_cache.cc, re-derived for this
  // wire protocol): steady-state training announces the same
  // (name, digest, required, datadep, grouped) tuple every step; the server
  // assigns each tuple a compact uint32 slot on first full announce and
  // broadcasts the assignment, after which clients announce via a single
  // fixed-size bitvector (bit i = slot i pending) — zero per-tensor
  // metadata in the warm regime.  `group` remembers the first announcer's
  // namespaced group tag so joined ranks batch synthesized entries exactly
  // like the peers' grouped entries; grouped-ness is part of the slot key,
  // so a rank flipping a tensor grouped<->ungrouped misses the cache, full-
  // announces, and trips the existing structure-divergence error.
  struct CacheRec {
    std::string name, digest, datadep, group;
    uint16_t required = 0;
    bool live = false;
    uint64_t last_used = 0;  // round counter, for LRU eviction
    // Speculation streak (protocol v7): consecutive rounds this slot was
    // ready-on-first-announce.  Prediction state hangs off the slot table
    // so every existing invalidation path (eviction, join-epoch flush,
    // relearn-after-digest-change) resets it for free: a reassigned or
    // relearned record starts from a zeroed streak.
    uint32_t streak = 0;
    // Per-slot instability backoff (ISSUE 12): mispredict count.  Each
    // mispredict doubles the streak this slot must rebuild before it is
    // predicted again (spec_ready_after << unstable, capped) — so a
    // chronically unstable slot (one rank's irregular announce pattern)
    // is WITHHELD from predictions instead of repeatedly entering them,
    // mispredicting, and zeroing every speculating client's engagement
    // streak for the stable slots too.  Stable slots keep speculating
    // (frame-guarded).  The penalty decays one step per kValidRunDecay
    // CONSECUTIVE validated predictions (valid_run) — deliberately much
    // slower than the escalation, so a slot that alternates short stable
    // stretches with mispredicts cannot oscillate back into predictions.
    uint32_t unstable = 0;
    uint32_t valid_run = 0;
  };
  static constexpr uint32_t kValidRunDecay = 16;
  // Bounded like the reference's capacity-limited cache; at capacity the
  // least-recently-used non-pending slot is evicted and the eviction is
  // broadcast, so client tables track the server's exactly.  An evicted
  // slot's RECORD stays intact and its id is only reusable from the NEXT
  // round: a client that bit-announced the slot in the same round the
  // eviction happened (it could not have known yet) must still resolve
  // against the old tuple — via the string verdict path — never against a
  // freshly reassigned one.
  size_t cache_capacity = 65536;
  size_t cache_live = 0;
  std::unordered_map<std::string, uint32_t> cache_keys;  // key -> slot
  std::vector<CacheRec> cache_recs;                      // slot -> record
  std::vector<uint32_t> cache_free;                      // reusable slots
  uint64_t round_no = 0;
  uint64_t announce_seq = 0;
  double stall_warn_s = 60.0;
  std::set<int> joined;
  int last_joined = -1;
  // Liveness (protocol v4): per-rank fault-tolerance capability (latched
  // from the request-side FLT1 ad) and the per-round deadline.  The
  // deadline is armed when a round's FIRST frame arrives — an idle fleet
  // (no rank negotiating) can never be declared dead, only a fleet where
  // some ranks reached the round and others failed to.  0 disables the
  // deadline; socket-death detection is always on.
  std::unique_ptr<std::atomic<char>[]> v4;
  int round_deadline_ms = 0;
  // Protocol v5: per-rank hierarchical capability (AGG5 ad / agent
  // handshake) and the accepted connections (loop-thread-only once the
  // world has assembled; server_stop severs through `fds`, which holds
  // every rank's serving fd — duplicated across an agent's ranks).
  // NB: nothing reads v5[] yet — the server sends no v5-only per-rank
  // sections (responses are rank-agnostic by design).  The latch exists
  // for protocol symmetry with v4[] so a future v5-gated section has its
  // capability record already on the wire; today it is diagnostic only.
  std::unique_ptr<std::atomic<char>[]> v5;
  // Protocol v6 (clean LEAVE): per-rank capability latch (round-1 LVE6
  // request ad; an agent's ranks latch from their forwarded round-1
  // subframes) and the set of ranks that departed cleanly.  eff_world()
  // is the readiness world every verdict materializes against.
  std::unique_ptr<std::atomic<char>[]> v6;
  std::set<int> left;
  // Protocol v7 (zero-RTT warm path): per-rank capability latch (round-1
  // ZRT7 request ad), the streak threshold (0 = speculation off), and the
  // slots predicted ready for the NEXT round (validated — and the
  // mispredicted slots' streaks reset — when that round's verdict lands).
  std::unique_ptr<std::atomic<char>[]> v7;
  int spec_ready_after = 0;
  // Elastic streak carryover (ISSUE 12): initial streak for NEWLY created
  // slots.  A survivor of a re-rendezvous passes the previous generation's
  // engagement hint through hvdtpu_server_start so the fresh slot table
  // re-predicts after ONE ready-on-first-announce round instead of
  // relearning spec_ready_after rounds from zero.  0 (default) = no seed.
  int spec_seed = 0;
  std::set<uint32_t> pred_slots;
  int pred_carry_rounds = 0;   // consecutive rounds a prediction carried
  // Diagnostic speculation accounting (not exported through the stats
  // ABI; the client-side counters are the observability surface).
  uint64_t spec_predictions = 0;
  uint64_t spec_confirms = 0;
  uint64_t spec_mispredicts = 0;
  int eff_world() const { return world - static_cast<int>(left.size()); }
  std::vector<Conn> conns;
  // Root-side service accounting (hvdtpu_server_stats): per-round time
  // from gather completion to the last response write — the serialized
  // root work the hierarchical control plane exists to shrink (parse +
  // verdict compute + one write per CONNECTION).  Client wall clocks
  // can't isolate this on a shared test box; the bench reads it directly.
  std::atomic<uint64_t> stat_rounds{0};
  std::atomic<uint64_t> stat_service_ns{0};

  void run();
  void run_inner();
  void broadcast_abort(const std::set<int>& dead, const std::string& why);
};

void Server::broadcast_abort(const std::set<int>& dead,
                             const std::string& why) {
  // Typed liveness verdict to surviving v4 clients; pre-v4 clients are
  // simply severed (run()'s epilogue shuts every socket down), which is
  // exactly the legacy rc=-1 failure they already understand.  One write
  // per CONNECTION: an agent gets the frame once and fans it to its
  // surviving local ranks itself.
  std::vector<uint8_t> resp;
  put_u32(&resp, kAbortEscape);
  put_u32(&resp, kAbortMagic);
  put_u32(&resp, static_cast<uint32_t>(dead.size()));
  for (int r : dead) put_u32(&resp, static_cast<uint32_t>(r));
  put_str(&resp, why);
  for (Conn& c : conns) {
    if (c.sock_dead || c.left || c.fd < 0) continue;
    bool any_live_v4 = false;
    for (int r : c.ranks)
      if (!dead.count(r) && v4[r].load()) any_live_v4 = true;
    if (any_live_v4) write_frame(c.fd, resp);
  }
}

void Server::run() {
  run_inner();
  // Whatever ended the loop (peer death, accept failure, stop), surviving
  // clients must see EOF rather than hang in read_frame.  shutdown only —
  // close stays with server_stop after the join (fd-recycling discipline).
  for (int r = 0; r < world; ++r) {
    int fd = fds[r].load();
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  }
}

void Server::run_inner() {
  // Accept until every rank is claimed: one connection per rank (flat
  // mode), or one per-host agent connection claiming several ranks
  // (protocol v5 — hello word kAgentHello outside the rank space, then a
  // rank-list frame).  All accepted fds land in `fds` (one slot per
  // claimed rank; an agent's fd is duplicated across its ranks) so
  // server_stop's cleanup owns closing them — run() never closes a
  // registered fd, which avoids shutdown() on a recycled fd number.
  int claimed = 0;
  while (claimed < world && !stop.load()) {
    int fd = ::accept(listen_fd, nullptr, nullptr);
    if (fd < 0) return;
    int one = 1;
    ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
    handshake_fd.store(fd);
    if (stop.load()) {  // stop raced the accept; don't block in the read
      if (handshake_fd.exchange(-1) != -2) ::close(fd);
      return;
    }
    uint32_t hello = 0;
    bool ok = read_exact(fd, &hello, 4);
    bool is_agent = ok && hello == kAgentHello;
    std::vector<uint8_t> rank_list;
    if (is_agent) ok = read_frame(fd, &rank_list);
    // Ownership handoff: if server_stop already exchanged the slot to -2 it
    // owns shutdown() on this fd, so we must not close it (the number could
    // be recycled under its feet); we're stopping anyway.
    if (handshake_fd.exchange(-1) == -2) return;
    Conn conn;
    conn.fd = fd;
    conn.is_agent = is_agent;
    if (ok && is_agent) {
      Reader rd{rank_list.data(), rank_list.data() + rank_list.size()};
      rd.u32();  // host index: diagnostic only
      uint32_t n = rd.u32();
      std::set<int> uniq;
      for (uint32_t i = 0; i < n && rd.ok; ++i) {
        uint32_t r = rd.u32();
        if (!rd.ok || r >= static_cast<uint32_t>(world)
            || fds[r].load() >= 0 || !uniq.insert(int(r)).second) {
          rd.ok = false;
          break;
        }
        conn.ranks.push_back(static_cast<int>(r));
      }
      ok = rd.ok && !conn.ranks.empty();
    } else if (ok) {
      if (hello >= static_cast<uint32_t>(world) || fds[hello].load() >= 0)
        ok = false;
      else
        conn.ranks.push_back(static_cast<int>(hello));
    }
    if (!ok) {
      ::close(fd);
      continue;
    }
    for (int r : conn.ranks) {
      fds[r].store(fd);
      if (is_agent) {
        // The agent handshake IS the v4+v5 capability proof: agents only
        // exist in v5 builds, and they fan typed aborts down to their
        // local ranks themselves.
        v4[r].store(1);
        v5[r].store(1);
      }
    }
    claimed += static_cast<int>(conn.ranks.size());
    conns.push_back(std::move(conn));
  }
  for (int r = 0; r < world; ++r)
    if (fds[r].load() < 0) return;  // stopped before the world assembled
  // Deterministic processing order: connections sorted by first rank, so
  // announce_seq ordering matches the flat per-rank gather's rank order.
  std::sort(conns.begin(), conns.end(), [](const Conn& a, const Conn& b) {
    return a.ranks.front() < b.ranks.front();
  });
  // Readiness multiplexer, registered ONCE: the old gather rebuilt a
  // pollfd set and issued a bounded blocking read per readable fd every
  // round — O(ranks) setup + the risk of blocking inside one peer's
  // half-written frame.  Frames now reassemble per connection off
  // non-blocking reads, and root-side gather work is one event + one
  // frame + one response write per CONNECTION (= per host under the
  // hierarchical control plane).
  Poller poller;
  for (size_t i = 0; i < conns.size(); ++i)
    poller.add(conns[i].fd, static_cast<int>(i));

  // Gather-phase containers, hoisted out of the round loop and cleared
  // per round so each connection's frame buffer keeps its capacity across
  // rounds — the steady-state warm path (13-byte frames) allocates
  // nothing here, matching the pre-v4 reusable frame buffer.
  std::vector<std::vector<uint8_t>> round_frames(conns.size());
  std::vector<char> have_frame(conns.size(), 0);
  std::set<int> dead_conn, dead_late;
  std::vector<int> ready_idx;

  while (!stop.load()) {
    ++round_no;
    // One lock-step round: a frame from every rank, then a reply to all.
    // Cache assignments created/confirmed this round, broadcast to all
    // ranks in the response (deduped; a client only adopts assignments
    // for names it announced itself).
    // value = the FULL cache key (name, digest, datadep, required) so a
    // client adopting the id can match it against exactly the tuple it
    // announced — two announces sharing (name, digest) but differing in
    // datadep/required (same tensor name under different process sets)
    // must not cross-adopt each other's ids.
    struct AssignRec {
      std::string name, digest, datadep;
      uint16_t required;
      uint16_t grouped;  // part of the slot key; echoed so clients adopt
                         // against exactly the tuple they announced
    };
    std::map<uint32_t, AssignRec> assigns;
    std::vector<uint32_t> evictions;   // ids freed this round: broadcast,
                                       // reusable only from the next round
    // Monitor blobs received this round (rank, opaque payload) — pure
    // store-and-forward: re-broadcast in this round's response so every
    // client's aggregation table tracks the fleet.  The server never
    // parses the payload.
    std::vector<std::pair<int, std::string>> mon_blobs;
    // Ranks whose clean LEAVE (protocol v6) was processed this round —
    // broadcast to survivors in the trailing LVE6 response section.
    std::vector<int> left_this_round;
    bool join_started = false;
    // slot: >= 0 answers may ride the ready bitvector; -1 forces strings.
    auto handle_announce = [&](int r, uint16_t required,
                               const std::string& name,
                               const std::string& digest,
                               const std::string& group,
                               const std::string& datadep, int64_t slot) {
      auto it = pending.find(name);
      if (it == pending.end()) {
        PendingInfo info;
        info.order = announce_seq++;
        info.required = required;   // raw: 0 = full (effective) world
        info.first_seen = Clock::now();
        info.round_created = round_no;
        info.digest = digest;
        info.group = group == "-1" ? group : std::to_string(r) + ":" + group;
        info.data_dep = datadep.empty() ? -1 : std::atoi(datadep.c_str());
        it = pending.emplace(name, std::move(info)).first;
      }
      it->second.ready_ranks.insert(r);
      it->second.by_digest[digest].insert(r);
      (group == "-1" ? it->second.ungrouped_ranks
                     : it->second.grouped_ranks)
          .insert(r);
      // Slot eligibility is sticky-downward: every announcing rank must be
      // able to resolve a slot-bit verdict (slot known or assigned this
      // same round), else the verdict stays on the string path.
      if (slot < 0 || (it->second.slot != INT64_MIN && it->second.slot < 0))
        it->second.slot = -1;
      else
        it->second.slot = slot;
      if (digest != it->second.digest) {
        // Divergent submission (reference controller's consistency
        // check).  The message is rebuilt at response time so late
        // announcers still appear in the rank attribution.
        it->second.errored = true;
      }
    };
    // Evictions reclaim least-recently-used live slots not referenced by
    // a pending negotiation; broadcast so clients drop them in lock-step.
    // ONE candidate scan + sort per round (built lazily, only under
    // capacity pressure), validated per pop — so a digest-churning
    // workload (new key every announce, table pinned at capacity) costs
    // one O(capacity log capacity) pass per round, and the per-round
    // budget degrades the overflow to string-path negotiation (correct
    // either way) instead of burning the rank-0 hot path.
    int evict_budget = 256;
    std::vector<uint32_t> evict_queue;   // LRU-ascending candidates
    size_t evict_pos = 0;
    bool evict_queue_built = false;
    auto evict_lru = [&]() -> bool {
      if (evict_budget <= 0) return false;
      if (!evict_queue_built) {
        evict_queue_built = true;
        std::vector<std::pair<uint64_t, uint32_t>> cands;
        cands.reserve(cache_live);
        for (size_t i = 0; i < cache_recs.size(); ++i)
          if (cache_recs[i].live)
            cands.emplace_back(cache_recs[i].last_used,
                               static_cast<uint32_t>(i));
        std::sort(cands.begin(), cands.end());
        evict_queue.reserve(cands.size());
        for (auto& c : cands) evict_queue.push_back(c.second);
      }
      auto evict_one = [&](uint32_t victim) {
        CacheRec& rec = cache_recs[victim];
        --evict_budget;
        std::string key = rec.name;
        key += '\x1f';
        key += rec.digest;
        key += '\x1f';
        key += rec.datadep;
        key += '\x1f';
        key += std::to_string(rec.required);
        key += '\x1f';
        key += rec.group == "-1" ? '0' : '1';
        cache_keys.erase(key);
        rec.live = false;  // record kept intact for same-round bit
        --cache_live;      // resolves; id reusable only after the round
        evictions.push_back(victim);
      };
      while (evict_pos < evict_queue.size()) {
        uint32_t victim = evict_queue[evict_pos++];
        CacheRec& rec = cache_recs[victim];
        // Revalidate at pop time: the slot may have been used (bit
        // announce / confirm) or referenced by a fresh pending entry
        // since the queue was built.
        if (!rec.live || rec.last_used == round_no) continue;
        // GROUP-ATOMIC eviction: every live record sharing the victim's
        // group tag goes with it.  A group announces atomically, so all
        // its records were learned in the same round and their frozen
        // tags agree ("same tag ⇒ same version"); a PARTIAL eviction
        // breaks that — the relearned member freezes a fresh per-step
        // tag while survivors keep the old one, and in the one boundary
        // round where a join announce lands beside peers' bit announces
        // the joined rank's synthesizer would see one logical group
        // under two tags (split clusters, divergent batching at the
        // fusion threshold).  Evicting the whole group keeps the
        // invariant: live same-group records always carry one tag.
        std::vector<uint32_t> victims;
        victims.push_back(victim);
        if (rec.group != "-1") {
          victims.clear();
          for (size_t i = 0; i < cache_recs.size(); ++i)
            if (cache_recs[i].live && cache_recs[i].group == rec.group)
              victims.push_back(static_cast<uint32_t>(i));
        }
        bool blocked = false;
        for (uint32_t v : victims) {
          if (cache_recs[v].last_used == round_no) {
            blocked = true;  // a sibling is hot this round: skip the group
            break;
          }
          for (auto& [n, info] : pending)
            if (info.slot == static_cast<int64_t>(v)) {
              blocked = true;
              break;
            }
          if (blocked) break;
        }
        if (blocked) continue;
        // The whole group is evicted even when it overruns the per-round
        // budget — a partial group eviction is exactly the hazard.
        for (uint32_t v : victims) evict_one(v);
        return true;
      }
      evict_budget = 0;    // candidates exhausted: stop for this round
      return false;
    };
    // ---- gather phase (protocol v4 liveness): ONE frame per connection,
    // collected through the readiness multiplexer with per-connection
    // reassembly, so a dead socket (recv 0 / ECONNRESET), an agent's
    // dead-local-rank report, or a missed round deadline turns into a
    // typed ABORT to the survivors — and a peer wedged mid-frame-write
    // can never block the gather (its bytes just sit in the reassembly
    // buffer until the deadline names it).  Frames are still PROCESSED in
    // rank order below, so announce_seq ordering (and with it the
    // deterministic ready order) is unchanged from the serial protocol.
    for (size_t i = 0; i < conns.size(); ++i) {
      round_frames[i].clear();
      have_frame[i] = 0;
    }
    dead_conn.clear();
    dead_late.clear();
    bool deadline_armed = false;
    Clock::time_point deadline_tp{};
    // Take this round's frame for connection i (from the reassembly
    // queue), arm the deadline at the round's FIRST complete frame (an
    // idle fleet can never be declared dead — only ranks that failed to
    // reach a round their peers already reached), and peek an agent
    // uplink's dead-rank section: a local rank death the agent observed
    // is a root-level liveness verdict with exact rank attribution.
    auto take_frame = [&](size_t i) {
      round_frames[i] = std::move(conns[i].frames.front());
      conns[i].frames.erase(conns[i].frames.begin());
      have_frame[i] = 1;
      if (!deadline_armed && round_deadline_ms > 0) {
        deadline_armed = true;
        deadline_tp = Clock::now() +
                      std::chrono::milliseconds(round_deadline_ms);
      }
      if (conns[i].is_agent) {
        const std::vector<uint8_t>& f = round_frames[i];
        const std::vector<int>& claimed = conns[i].ranks;
        Reader rd{f.data(), f.data() + f.size()};
        if (rd.u32() == kHupMagic && rd.ok) {
          uint32_t nd = rd.u32();
          for (uint32_t k = 0; k < nd && rd.ok; ++k) {
            uint32_t r = rd.u32();
            // Membership check: an agent may only declare ITS OWN ranks
            // dead — a corrupted uplink must not abort a healthy rank on
            // another host.
            if (rd.ok && std::find(claimed.begin(), claimed.end(),
                                   static_cast<int>(r)) != claimed.end())
              dead_conn.insert(static_cast<int>(r));
          }
        }
      }
    };
    // Leftover frames (they reassembled while the previous round was
    // still writing responses) satisfy this round immediately; a
    // connection that died after delivering its last frame is found dead
    // here, not silently skipped.
    int pending_frames = 0;
    for (size_t i = 0; i < conns.size(); ++i) {
      if (conns[i].left) continue;   // departed cleanly: not in this round
      if (!conns[i].frames.empty()) {
        take_frame(i);
      } else if (conns[i].sock_dead) {
        for (int r : conns[i].ranks) dead_conn.insert(r);
      } else {
        ++pending_frames;
      }
    }
    // Grace drain for the failure-at-startup class: when a rank dies in
    // round 1, survivors that have not yet SENT their round-1 frame have
    // not advertised FLT1 either — aborting immediately would sever them
    // with the untyped legacy rc=-1.  So after a death the gather keeps
    // collecting frames from live ranks whose capability is still
    // unknown, for a bounded window; once every live rank is either
    // latched v4 or has its frame in hand (the common case within
    // milliseconds — peers are in lock-step and about to send anyway),
    // the abort goes out.  Rounds where every survivor is already
    // latched (any round past the first) break immediately as before.
    constexpr int kAbortGraceMs = 2000;
    bool grace_armed = false;
    Clock::time_point grace_tp{};
    while (pending_frames > 0 && !stop.load() && dead_late.empty()) {
      // Short wait quantum keeps the loop responsive to server_stop (the
      // pre-v4 design relied on stop shutting the socket under a blocked
      // recv; poller wakeups serve the same purpose with a bound).
      int timeout = 100;
      if (deadline_armed) {
        auto rem = std::chrono::duration_cast<std::chrono::milliseconds>(
                       deadline_tp - Clock::now())
                       .count();
        if (rem <= 0) {
          // Final non-blocking drain before the verdict: a frame already
          // buffered in the kernel at expiry proves its sender reached
          // the round — declaring it dead would abort the fleet with a
          // verdict naming a healthy rank.
          for (size_t i = 0; i < conns.size(); ++i) {
            if (have_frame[i] || conns[i].sock_dead || conns[i].left)
              continue;
            conns[i].drain();
            if (!conns[i].frames.empty()) {
              take_frame(i);
              --pending_frames;
            }
          }
          for (size_t i = 0; i < conns.size(); ++i) {
            if (have_frame[i] || conns[i].left) continue;
            if (conns[i].sock_dead) {
              poller.remove(conns[i].fd);
              for (int r : conns[i].ranks) dead_conn.insert(r);
            } else {
              // Mid-frame wedge or silence: the connection reached (or
              // never reached) the round but missed its deadline.
              for (int r : conns[i].ranks) dead_late.insert(r);
            }
          }
          break;
        }
        timeout = static_cast<int>(std::min<int64_t>(timeout, rem));
      }
      int n = poller.wait(timeout, &ready_idx);
      if (n < 0) {
        if (errno == EINTR) continue;
        stop.store(true);
        break;
      }
      for (int idx : ready_idx) {
        Conn& c = conns[static_cast<size_t>(idx)];
        if (c.sock_dead) continue;
        c.drain();
        if (!have_frame[idx] && !c.frames.empty()) {
          take_frame(static_cast<size_t>(idx));
          --pending_frames;
        }
        if (c.sock_dead) {
          // Removed from the poller either way (a dead level-triggered fd
          // would spin the loop); if the round's frame never arrived,
          // these ranks are this round's verdict.
          poller.remove(c.fd);
          if (!have_frame[idx])
            for (int r : c.ranks) dead_conn.insert(r);
        }
      }
      if (!dead_late.empty()) break;  // deadline verdict: abort the round
      if (!dead_conn.empty()) {
        bool awaiting_ad = false;
        for (size_t i = 0; i < conns.size(); ++i) {
          if (have_frame[i] || conns[i].sock_dead || conns[i].left)
            continue;
          for (int r : conns[i].ranks)
            if (!dead_conn.count(r) && !v4[r].load()) {
              awaiting_ad = true;
              break;
            }
          if (awaiting_ad) break;
        }
        if (!awaiting_ad) break;
        auto now = Clock::now();
        if (!grace_armed) {
          grace_armed = true;
          grace_tp = now + std::chrono::milliseconds(kAbortGraceMs);
        } else if (now >= grace_tp) {
          break;
        }
      }
    }
    if (!stop.load() && (!dead_conn.empty() || !dead_late.empty())) {
      // Salvage still-buffered frames from live connections before the
      // verdict: frames may have landed since the last poller wakeup.
      // Most importantly this recovers round 1's trailing FLT1 capability
      // ads — without the frame, v4[] never latches and the survivor gets
      // the untyped legacy sever (unattributed rc=-1) instead of the
      // typed ABORT.
      for (size_t i = 0; i < conns.size(); ++i) {
        if (have_frame[i] || conns[i].sock_dead || conns[i].left) continue;
        bool all_dead = true;
        for (int r : conns[i].ranks)
          if (!dead_conn.count(r) && !dead_late.count(r)) all_dead = false;
        if (all_dead) continue;
        conns[i].drain();
        if (!conns[i].frames.empty()) take_frame(i);
      }
      auto list = [](const std::set<int>& s) {
        std::string out;
        for (int r : s) {
          if (!out.empty()) out += ",";
          out += std::to_string(r);
        }
        return out;
      };
      if (std::getenv("HVD_TPU_COORD_DEBUG") != nullptr) {
        for (size_t i = 0; i < conns.size(); ++i)
          fprintf(stderr,
                  "[coord] round=%llu conn=%zu ranks0=%d agent=%d left=%d "
                  "have=%d dead=%d errno=%d inbuf=%zu frames=%zu\n",
                  (unsigned long long)round_no, i,
                  conns[i].ranks.empty() ? -1 : conns[i].ranks.front(),
                  (int)conns[i].is_agent, (int)conns[i].left,
                  (int)have_frame[i],
                  (int)conns[i].sock_dead, conns[i].dead_errno,
                  conns[i].inbuf.size(), conns[i].frames.size());
      }
      std::string why;
      if (!dead_conn.empty())
        why += "rank(s) [" + list(dead_conn) +
               "] lost connection mid-negotiation (process crash, "
               "ECONNRESET, or network failure)";
      if (!dead_late.empty()) {
        if (!why.empty()) why += "; ";
        why += "rank(s) [" + list(dead_late) + "] missed the " +
               std::to_string(round_deadline_ms) +
               "ms round deadline (hung or wedged)";
      }
      why += " in negotiation round " + std::to_string(round_no);
      std::set<int> all_dead = dead_conn;
      all_dead.insert(dead_late.begin(), dead_late.end());
      // A death in round 1 finds the FLT1 capability ads still sitting in
      // the gathered-but-unPROCESSED frames (processing only starts once
      // every rank's frame is in), so v4[] would gate the abort away from
      // every survivor and the fleet would fail with the untyped legacy
      // rc=-1 — losing dead-rank attribution exactly for the failure-at-
      // startup class.  Latch the ads now: the client contract
      // (controller.py) appends FLT1 as the FINAL trailing section of the
      // round-1 request (AGG5 rides before it), so the ad is exactly the
      // frame's last 8 bytes.  Agent connections were latched at
      // handshake and need no salvage.
      for (size_t i = 0; i < conns.size(); ++i) {
        if (!have_frame[i] || conns[i].is_agent) continue;
        int r = conns[i].ranks.front();
        if (v4[r].load()) continue;
        const std::vector<uint8_t>& f = round_frames[i];
        if (f.size() < 8) continue;
        uint32_t magic = 0, blen = 0;
        std::memcpy(&magic, f.data() + f.size() - 8, 4);
        std::memcpy(&blen, f.data() + f.size() - 4, 4);
        if (magic == kFltMagic && blen == 0) v4[r].store(1);
      }
      broadcast_abort(all_dead, why);
      stop.store(true);
      break;
    }
    if (stop.load()) break;
    auto svc_t0 = Clock::now();   // gather complete: root service begins
    // One rank's frame (a flat connection's round frame, or one agent
    // subframe — byte-identical to what the rank itself sent).
    auto process_rank_frame = [&](int r, const uint8_t* fdata, size_t flen) {
      Reader rd{fdata, fdata + flen};
      // Sanitizer tag side-channel for this rank's bitvector announces
      // (slot -> tag); parsed after the bitvector but needed while
      // resolving it, so the sections are walked full -> bits -> tags and
      // bit announces are resolved afterwards.
      std::vector<uint32_t> bit_slots;
      uint32_t n = rd.u32();
      for (uint32_t i = 0; i < n && rd.ok; ++i) {
        uint16_t required = rd.u16();
        std::string name = rd.str();
        std::string digest = rd.str();
        std::string group = rd.str();
        std::string datadep = rd.str();
        std::string tag = rd.str();
        if (name == "\x1f__join__") {
          joined.insert(r);
          last_joined = r;
          join_started = true;
          continue;
        }
        // Assign (or confirm) the tuple's cache slot so every announcer
        // eventually learns it and drops to the bitvector form.  The key
        // excludes the sanitizer tag (per-submission, never repeats) but
        // includes grouped-ness (see CacheRec comment).  No assignments
        // while any rank is joined: the epoch started with a table flush,
        // and relearning mid-epoch would freeze per-step group tags into
        // slot records while the joined rank's synthesizer still consumes
        // them — full announces (with CURRENT tags) for the whole epoch
        // keep grouped batching exact; slots relearn once the world
        // resumes.
        if (!joined.empty()) {
          std::string eff0 = tag.empty() ? digest : digest + "|" + tag;
          handle_announce(r, required, name, eff0, group, datadep, -1);
          continue;
        }
        std::string key = name;
        key += '\x1f';
        key += digest;
        key += '\x1f';
        key += datadep;
        key += '\x1f';
        key += std::to_string(required);
        key += '\x1f';
        key += group == "-1" ? '0' : '1';
        auto ck = cache_keys.find(key);
        if (ck == cache_keys.end()) {
          if (cache_live >= cache_capacity && cache_capacity > 0)
            evict_lru();
          if (cache_live < cache_capacity) {
            uint32_t id;
            if (!cache_free.empty()) {
              id = cache_free.back();
              cache_free.pop_back();
            } else {
              id = static_cast<uint32_t>(cache_recs.size());
              cache_recs.push_back(CacheRec{});
            }
            std::string g = group == "-1"
                ? group : std::to_string(r) + ":" + group;
            cache_recs[id] = CacheRec{name, digest, datadep, g, required,
                                      true, round_no};
            // Streak carryover: a seeded fresh slot matures on its FIRST
            // ready-on-first-announce round (seed + 1 >= spec_ready_after),
            // re-engaging warm speculation in O(1) rounds after an elastic
            // re-rendezvous instead of relearning from zero.
            if (spec_seed > 0)
              cache_recs[id].streak = static_cast<uint32_t>(spec_seed);
            cache_keys.emplace(key, id);
            ++cache_live;
            ck = cache_keys.find(key);
          }
        }
        int64_t slot = -1;
        if (ck != cache_keys.end()) {
          slot = ck->second;
          cache_recs[ck->second].last_used = round_no;
          assigns[ck->second] = AssignRec{
              name, digest, datadep, required,
              static_cast<uint16_t>(group == "-1" ? 0 : 1)};
        }
        std::string eff = tag.empty() ? digest : digest + "|" + tag;
        handle_announce(r, required, name, eff, group, datadep, slot);
      }
      // Bitvector section: slot i pending on this rank.
      if (rd.ok && rd.p < rd.end) {
        uint32_t nbytes = rd.u32();
        for (uint32_t b = 0; b < nbytes && rd.ok; ++b) {
          if (rd.p >= rd.end) { rd.ok = false; break; }
          uint8_t byte = *rd.p++;
          for (int bit = 0; bit < 8; ++bit)
            if (byte & (1u << bit)) bit_slots.push_back(b * 8 + bit);
        }
      }
      // Sanitizer tag side-channel (sparse; empty outside sanitizer mode).
      std::map<uint32_t, std::string> bit_tags;
      if (rd.ok && rd.p < rd.end) {
        uint32_t nt = rd.u32();
        for (uint32_t i = 0; i < nt && rd.ok; ++i) {
          uint32_t slot = rd.u32();
          bit_tags[slot] = rd.str();
        }
      }
      // Optional trailing sections, walked generically as (magic, len,
      // payload) tuples so protocol extensions compose in any order and
      // unknown magics are skipped.  MON1 (protocol v3): an opaque
      // telemetry blob for store-and-forward — a malformed/truncated
      // section is dropped without failing the round (telemetry must
      // never cost negotiation), and oversized blobs (> kMonBlobCap) are
      // dropped so the re-broadcast never pushes a response past the
      // client's fixed receive buffer.  FLT1 (protocol v4): the client's
      // fault-tolerance capability ad, sent on its first round only —
      // latches the rank as eligible for the typed ABORT frame.
      while (rd.ok && rd.p + 8 <= rd.end) {
        uint32_t magic = rd.u32();
        uint32_t blen = rd.u32();
        if (!rd.ok || rd.p + blen > rd.end) break;
        if (magic == kMonMagic) {
          if (blen <= kMonBlobCap)
            mon_blobs.emplace_back(
                r, std::string(reinterpret_cast<const char*>(rd.p), blen));
        } else if (magic == kFltMagic) {
          v4[r].store(1);
        } else if (magic == kAggMagic) {
          v5[r].store(1);
        } else if (magic == kLeaveMagic) {
          v6[r].store(1);
        } else if (magic == kZrtMagic) {
          // Empty payload: the round-1 capability ad.  One byte 0x01: the
          // rank consumed last round's prediction and dispatched its
          // verdict speculatively (accounting only — the announce itself
          // already rides the ordinary bitvector section).
          v7[r].store(1);
          if (blen >= 1 && *rd.p == 1) ++spec_confirms;
        }
        rd.p += blen;
      }
      for (uint32_t id : bit_slots) {
        // A non-live slot with an intact record was evicted THIS round
        // (ids are only reused from the next round, and the announcing
        // client sees the eviction broadcast before its next request):
        // the announce must still count — resolved via the old tuple,
        // answered on the string path (slot hint -1) — or the tensor
        // would wedge with the client believing it announced.
        if (id >= cache_recs.size() || cache_recs[id].name.empty())
          continue;
        CacheRec& rec = cache_recs[id];
        int64_t hint = rec.live ? static_cast<int64_t>(id) : -1;
        if (rec.live) rec.last_used = round_no;
        auto tg = bit_tags.find(id);
        std::string eff = tg == bit_tags.end()
            ? rec.digest : rec.digest + "|" + tg->second;
        // rec.group is already namespaced by its first announcer; pass
        // "-1" vs non-"-1" through (handle_announce re-namespaces only
        // raw tags, so hand it the raw suffix when grouped).
        auto it = pending.find(rec.name);
        bool fresh = it == pending.end();
        if (fresh) {
          PendingInfo info;
          info.order = announce_seq++;
          info.required = rec.required;   // raw: 0 = full world
          info.first_seen = Clock::now();
          info.round_created = round_no;
          info.digest = eff;
          info.group = rec.group;
          info.data_dep =
              rec.datadep.empty() ? -1 : std::atoi(rec.datadep.c_str());
          info.slot = hint;
          it = pending.emplace(rec.name, std::move(info)).first;
        }
        it->second.ready_ranks.insert(r);
        it->second.by_digest[eff].insert(r);
        (rec.group == "-1" ? it->second.ungrouped_ranks
                           : it->second.grouped_ranks)
            .insert(r);
        if (!fresh) {
          if (hint < 0)
            it->second.slot = -1;
          else if (it->second.slot == INT64_MIN)
            it->second.slot = hint;
          if (eff != it->second.digest) it->second.errored = true;
        }
      }
    };
    // Aggregate warm-path announce (protocol v5): one fixed-size bitvector
    // that counts for EVERY rank its agent speaks for.  The agent only
    // emits it when all its local ranks sent identical pure-warm frames,
    // so per-rank semantics (readiness counting, stall attribution, digest
    // consistency) reduce to inserting each covered rank; sanitizer-tagged
    // frames are forwarded per-rank by construction, so the aggregate
    // digest is always the slot record's untagged one.
    auto process_agg_bits = [&](const std::vector<int>& ranks,
                                const uint8_t* bv, uint32_t nbytes) {
      for (uint32_t b = 0; b < nbytes; ++b) {
        uint8_t byte = bv[b];
        if (!byte) continue;
        for (int bit = 0; bit < 8; ++bit) {
          if (!(byte & (1u << bit))) continue;
          uint32_t id = b * 8 + bit;
          // Same evicted-this-round contract as the per-rank bit path: a
          // non-live slot with an intact record still resolves, on the
          // string path.
          if (id >= cache_recs.size() || cache_recs[id].name.empty())
            continue;
          CacheRec& rec = cache_recs[id];
          int64_t hint = rec.live ? static_cast<int64_t>(id) : -1;
          if (rec.live) rec.last_used = round_no;
          const std::string& eff = rec.digest;
          auto it = pending.find(rec.name);
          bool fresh = it == pending.end();
          if (fresh) {
            PendingInfo info;
            info.order = announce_seq++;
            info.required = rec.required;   // raw: 0 = full world
            info.first_seen = Clock::now();
            info.round_created = round_no;
            info.digest = eff;
            info.group = rec.group;
            info.data_dep =
                rec.datadep.empty() ? -1 : std::atoi(rec.datadep.c_str());
            info.slot = hint;
            it = pending.emplace(rec.name, std::move(info)).first;
          }
          for (int r : ranks) {
            it->second.ready_ranks.insert(r);
            it->second.by_digest[eff].insert(r);
            (rec.group == "-1" ? it->second.ungrouped_ranks
                               : it->second.grouped_ranks)
                .insert(r);
          }
          if (!fresh) {
            if (hint < 0)
              it->second.slot = -1;
            else if (it->second.slot == INT64_MIN)
              it->second.slot = hint;
            if (eff != it->second.digest) it->second.errored = true;
          }
        }
      }
    };
    // Clean LEAVE (protocol v6): drop the rank from the gather with no
    // dead-peer verdict.  Honored only when every survivor latched v6 —
    // a pre-v6 survivor cannot parse the leave notice and would execute
    // shrunk-world verdicts its fixed-size data plane cannot resolve —
    // otherwise the LEAVE is ignored and the leaver's subsequent socket
    // sever produces the legacy v4 verdict.  The ONE abort case: the
    // leaver still has outstanding negotiated work (a pending tensor it
    // announced, or an implicit world-level credit while joined) whose
    // readiness would include a rank that will never execute it.
    auto handle_leave = [&](int r, Conn& c) {
      if (left.count(r)) return;
      for (int rr = 0; rr < world; ++rr) {
        if (rr == r || left.count(rr) || v6[rr].load()) continue;
        return;   // pre-v6 survivor: degrade to the legacy sever path
      }
      std::string stuck;
      for (auto& [n, info] : pending) {
        bool involved = info.ready_ranks.count(r) > 0;
        if (!involved && joined.count(r) && info.required == 0 &&
            n.find('\x1f') == std::string::npos)
          involved = true;   // joined rank: implicit world-level credit
        if (involved) {
          stuck = n;
          break;
        }
      }
      if (!stuck.empty()) {
        broadcast_abort(std::set<int>{r},
                        "rank " + std::to_string(r) +
                            " sent a clean LEAVE with outstanding "
                            "negotiated work (tensor '" + stuck +
                            "') in round " + std::to_string(round_no));
        stop.store(true);
        return;
      }
      left.insert(r);
      left_this_round.push_back(r);
      joined.erase(r);
      if (c.is_agent) {
        // The host's uplink SHRINKS instead of dying: the agent keeps
        // speaking for its remaining ranks (its own uplink already
        // dropped the leaver); only the last local rank's departure
        // retires the whole connection.
        c.ranks.erase(std::remove(c.ranks.begin(), c.ranks.end(), r),
                      c.ranks.end());
        if (c.ranks.empty()) {
          c.left = true;
          poller.remove(c.fd);
        }
      } else {
        c.left = true;
        poller.remove(c.fd);
      }
    };
    // Dispatch this round's frames in connection (= ascending first-rank)
    // order: flat frames parse exactly as before; an agent uplink unpacks
    // into its aggregate section, verbatim per-rank subframes, and
    // deduplicated MON1 blobs.
    for (size_t ci = 0; ci < conns.size(); ++ci) {
      Conn& c = conns[ci];
      if (c.left || stop.load()) continue;
      const std::vector<uint8_t>& f = round_frames[ci];
      if (!c.is_agent) {
        if (is_leave_frame(f.data(), f.size())) {
          handle_leave(c.ranks.front(), c);
          continue;
        }
        process_rank_frame(c.ranks.front(), f.data(), f.size());
        continue;
      }
      Reader rd{f.data(), f.data() + f.size()};
      if (rd.u32() != kHupMagic || !rd.ok) continue;  // malformed: dropped
      uint32_t nd = rd.u32();
      for (uint32_t k = 0; k < nd && rd.ok; ++k) rd.u32();  // peeked in gather
      uint32_t agg_n = rd.u32();
      if (rd.ok && agg_n > 0) {
        uint32_t nbytes = rd.u32();
        if (rd.ok && rd.p + nbytes <= rd.end) {
          process_agg_bits(c.ranks, rd.p, nbytes);
          rd.p += nbytes;
        } else {
          rd.ok = false;
        }
      }
      // Membership check on every per-rank section: an agent speaks ONLY
      // for its claimed ranks — a corrupted uplink must not announce (or
      // attribute telemetry) on behalf of another host's ranks.
      auto owns = [&c](uint32_t r) {
        return std::find(c.ranks.begin(), c.ranks.end(),
                         static_cast<int>(r)) != c.ranks.end();
      };
      uint32_t n_sub = rd.ok ? rd.u32() : 0;
      for (uint32_t k = 0; k < n_sub && rd.ok; ++k) {
        uint32_t r = rd.u32();
        uint32_t flen = rd.u32();
        if (!rd.ok || rd.p + flen > rd.end) break;
        if (owns(r)) {
          // A local rank's clean LEAVE travels as a verbatim subframe
          // (the agent cannot aggregate it): same semantics as flat mode,
          // but the HOST connection persists for the remaining ranks.
          if (is_leave_frame(rd.p, flen))
            handle_leave(static_cast<int>(r), c);
          else
            process_rank_frame(static_cast<int>(r), rd.p, flen);
        }
        rd.p += flen;
        if (stop.load()) break;
      }
      uint32_t n_mon = rd.ok ? rd.u32() : 0;
      for (uint32_t k = 0; k < n_mon && rd.ok; ++k) {
        uint32_t r = rd.u32();
        uint32_t blen = rd.u32();
        if (!rd.ok || rd.p + blen > rd.end) break;
        if (blen <= kMonBlobCap && owns(r))
          mon_blobs.emplace_back(
              static_cast<int>(r),
              std::string(reinterpret_cast<const char*>(rd.p), blen));
        rd.p += blen;
      }
    }
    if (stop.load()) break;
    if (eff_world() <= 0) break;   // every rank departed cleanly: done
    if (join_started) {
      // A join epoch begins: flush every slot (broadcast as evictions) so
      // the whole epoch renegotiates in full — joined ranks need digest
      // strings to synthesize, and stale per-step group structure must not
      // outlive the epoch.  Clients relearn slots once the world resumes.
      for (size_t i = 0; i < cache_recs.size(); ++i) {
        if (!cache_recs[i].live) continue;
        cache_recs[i].live = false;
        evictions.push_back(static_cast<uint32_t>(i));
      }
      cache_keys.clear();
      cache_live = 0;
      assigns.clear();
      for (auto& [n, info] : pending) info.slot = -1;
    }
    // Compute+write under phase_mu: see the field's comment.  Reads stay
    // outside the lock (they block on peers, and server_stop must be able
    // to sever a blocked read).
    std::lock_guard<std::timed_mutex> phase_lock(phase_mu);

    // Ready = reported by every rank (joined ranks count as implicitly
    // ready for world-level tensors); deterministic order by announce seq.
    // Errored tensors are never ready: their error is broadcast every round
    // until all required ranks have announced (so each has a local entry to
    // fail), then dropped.
    std::vector<std::tuple<uint64_t, std::string, std::string, std::string>>
        ready;
    std::vector<uint32_t> ready_slots;
    // Parallel to ready_slots: announce and ready landed in the SAME
    // round — the speculation streak's increment condition (v7).
    std::vector<char> ready_slot_first;
    std::vector<std::string> warns;
    std::vector<std::pair<std::string, std::string>> errs;
    auto now = Clock::now();
    for (auto it = pending.begin(); it != pending.end();) {
      auto& info = it->second;
      // Effective announce count: joined ranks are implicitly ready, but
      // only toward DEFAULT-process-set world tensors (wire names of other
      // sets carry a "\x1f" prefix the joined client cannot synthesize
      // for; join is a world-level operation in the reference too).
      bool world_level = info.required == 0 &&
                         it->first.find('\x1f') == std::string::npos;
      // The readiness threshold, materialized HERE (not at announce time):
      // raw required 0 means "the full world", which a clean LEAVE
      // (protocol v6) may have shrunk since the announce — the effective
      // world is what the survivors can actually deliver.
      int req = info.required ? info.required : eff_world();
      int have = static_cast<int>(info.ready_ranks.size());
      if (world_level) {
        for (int jr : joined)
          if (!info.ready_ranks.count(jr)) ++have;
        // A leaver that announced before departing would have aborted the
        // fleet (outstanding work); a leaver that had NOT announced simply
        // stops being counted — but it may have been counted implicitly
        // while joined, so clamp against the shrunk threshold.
        if (have > req) have = req;
      }
      // A collective that needs real data from a joined rank cannot be
      // satisfied with synthesized identity values: answer with a
      // per-tensor error instead of fabricating data (broadcast from a
      // joined root / allgather / alltoall — the reference errors here).
      if (!info.errored && world_level && !joined.empty() &&
          (info.data_dep == -2 ||
           (info.data_dep >= 0 && joined.count(info.data_dep)))) {
        std::string who;
        for (int jr : joined) {
          if (info.data_dep >= 0 && jr != info.data_dep) continue;
          if (!who.empty()) who += ",";
          who += std::to_string(jr);
        }
        errs.emplace_back(
            it->first, "tensor '" + it->first + "' requires data from " +
                           (info.data_dep >= 0 ? "root rank [" : "ranks [") +
                           who + "] which joined; collectives that need a "
                           "joined rank's data cannot run until all ranks "
                           "join");
        if (have >= req) {
          it = pending.erase(it);
          continue;
        }
        ++it;
        continue;
      }
      if (!info.grouped_ranks.empty() && !info.ungrouped_ranks.empty()) {
        // Grouped on some ranks, ungrouped on others: batching at the
        // fusion threshold would diverge → mismatched fused programs.
        std::string g, u;
        for (int rr : info.grouped_ranks) {
          if (!g.empty()) g += ",";
          g += std::to_string(rr);
        }
        for (int rr : info.ungrouped_ranks) {
          if (!u.empty()) u += ",";
          u += std::to_string(rr);
        }
        errs.emplace_back(
            it->first, "tensor '" + it->first +
                           "' negotiation failed: ranks [" + g +
                           "] submitted it as a GROUPED collective but "
                           "ranks [" + u + "] submitted it ungrouped");
        if (have >= req) {
          it = pending.erase(it);
          continue;
        }
        ++it;
        continue;
      }
      if (info.errored) {
        // Per-tensor error naming every rank on each side of the
        // divergence, rebuilt each round so late announcers are included.
        std::string msg = "tensor '" + it->first +
                          "' negotiation failed: mismatched submissions: ";
        bool first_d = true;
        for (auto& [d, ranks] : info.by_digest) {
          if (!first_d) msg += " vs ";
          first_d = false;
          std::string rs;
          for (int rr : ranks) {
            if (!rs.empty()) rs += ",";
            rs += std::to_string(rr);
          }
          msg += "ranks [" + rs + "] announced " + d;
        }
        errs.emplace_back(it->first, msg);
        if (have >= req) {
          it = pending.erase(it);
          continue;
        }
        ++it;
        continue;
      }
      if (have >= req) {
        // Slot-bit verdict only when every rank can resolve it: the slot
        // exists, every announcer was (or is being, via this round's
        // assigns broadcast) taught it, and no rank is joined (joined
        // ranks need the digest string to synthesize a contribution).
        if (joined.empty() && info.slot >= 0) {
          ready_slots.push_back(static_cast<uint32_t>(info.slot));
          ready_slot_first.push_back(info.round_created == round_no ? 1 : 0);
        } else
          ready.emplace_back(info.order, it->first, info.digest, info.group);
        it = pending.erase(it);
        continue;
      }
      double age =
          std::chrono::duration<double>(now - info.first_seen).count();
      if (age > stall_warn_s && !info.warned) {
        info.warned = true;
        std::string missing;
        for (int r = 0; r < world; ++r) {
          // Joined ranks are exempt only where they get implicit-ready
          // credit (world-level tensors); for subgroup tensors a joined
          // member really is the missing party — name it.  Clean leavers
          // are never "missing": they stopped counting entirely.
          if (left.count(r)) continue;
          if (!info.ready_ranks.count(r) &&
              !(world_level && joined.count(r))) {
            if (!missing.empty()) missing += ",";
            missing += std::to_string(r);
          }
        }
        warns.push_back("stall: tensor '" + it->first + "' waited " +
                        std::to_string(age) + "s; missing ranks [" + missing +
                        "]");
      }
      ++it;
    }
    std::sort(ready.begin(), ready.end());
    if (eff_world() > 0 && static_cast<int>(joined.size()) == eff_world()) {
      // Every rank joined: announce the epoch end (digest = last joiner)
      // and reset so the world can resume normal collectives.
      ready.emplace_back(UINT64_MAX, "\x1f__all_joined__",
                         std::to_string(last_joined), "-1");
      joined.clear();
      last_joined = -1;
    }

    // ---- speculative readiness (protocol v7).  Validate last round's
    // prediction against THIS round's actual slot verdicts: a predicted
    // slot that did not go ready is a mispredict — its streak resets, so
    // speculation disengages for it until the streak rebuilds through
    // normal rounds (the speculating client's early-consumed verdict is
    // absorbed by the merge of its next announce into the still-pending
    // entry; nothing to repair here).
    {
      std::set<uint32_t> ready_now(ready_slots.begin(), ready_slots.end());
      std::set<uint32_t> carried;
      if (!pred_slots.empty()) {
        for (uint32_t s : pred_slots) {
          if (ready_now.count(s)) {
            // Validated: after a long consecutive run of good
            // predictions the slot earns one step of its instability
            // penalty back (slow decay — see the field comment).
            if (s < cache_recs.size() && cache_recs[s].unstable > 0 &&
                ++cache_recs[s].valid_run >= kValidRunDecay) {
              --cache_recs[s].unstable;
              cache_recs[s].valid_run = 0;
            }
            continue;
          }
          // Not ready: distinguish a genuine mispredict (SOMEONE
          // announced the slot — a speculating client may have consumed
          // the verdict, and the partial announce proves a rank skipped)
          // from an idle round (NOBODY announced it — the engine's
          // timer-driven cycles legitimately interleave empty rounds
          // between step bursts; no client can have speculated, because
          // speculating requires announcing, so the prediction simply
          // CARRIES to the next round with its streak intact).
          bool announced = s < cache_recs.size() &&
                           pending.count(cache_recs[s].name) > 0;
          if (announced || s >= cache_recs.size() ||
              !cache_recs[s].live) {
            ++spec_mispredicts;
            if (s < cache_recs.size()) {
              // Per-slot backoff (ISSUE 12): beyond resetting the streak,
              // escalate this slot's re-qualification threshold so a
              // chronically unstable announce pattern withholds ONLY this
              // slot from future predictions — a repeated mispredict
              // would otherwise keep zeroing every speculating client's
              // engagement streak fleet-wide.
              cache_recs[s].streak = 0;
              cache_recs[s].valid_run = 0;
              if (cache_recs[s].unstable < 6) ++cache_recs[s].unstable;
            }
          } else {
            carried.insert(s);
          }
        }
        pred_slots.clear();
      }
      // Bound the carry: a prediction for a tensor the workload stopped
      // submitting must not ride every response forever.  Dropping it
      // keeps the streak, so the next use re-predicts immediately.
      if (!carried.empty()) {
        if (++pred_carry_rounds > 256) carried.clear();
      } else {
        pred_carry_rounds = 0;
      }
      // Streak update: ready-on-first-announce extends it, a slow
      // (multi-round) resolution resets it, and a slot left PENDING this
      // round resets it too — "k consecutive rounds" means exactly that.
      for (size_t i = 0; i < ready_slots.size(); ++i) {
        uint32_t s = ready_slots[i];
        if (s >= cache_recs.size()) continue;
        CacheRec& rec = cache_recs[s];
        rec.streak = ready_slot_first[i] ? rec.streak + 1 : 0;
      }
      for (auto& [n, info] : pending)
        if (info.slot >= 0 &&
            info.slot < static_cast<int64_t>(cache_recs.size()))
          cache_recs[info.slot].streak = 0;
      if (!left_this_round.empty()) {
        // A clean LEAVE shrinks the effective world mid-stream: every
        // streak restarts against the new readiness threshold.
        for (auto& rec : cache_recs) rec.streak = 0;
      }
      // Emit the next-round prediction: every rank v7, nobody joined, no
      // membership change this round, and only slots that went ready THIS
      // round with a mature streak (so the clients re-announcing them next
      // round is the overwhelmingly likely case).
      bool all_v7 = spec_ready_after > 0 && joined.empty() &&
                    left_this_round.empty() && !join_started;
      if (all_v7)
        for (int r = 0; r < world; ++r)
          if (!left.count(r) && !v7[r].load()) {
            all_v7 = false;
            break;
          }
      if (all_v7) {
        for (size_t i = 0; i < ready_slots.size(); ++i) {
          uint32_t s = ready_slots[i];
          if (s >= cache_recs.size() || !cache_recs[s].live) continue;
          // Per-slot qualification: an unstable slot must rebuild a
          // streak of spec_ready_after << unstable (capped) before it is
          // predicted again — the withholding that keeps one flaky
          // tensor from disengaging speculation for the stable ones.
          uint64_t need = static_cast<uint64_t>(spec_ready_after)
              << std::min<uint32_t>(cache_recs[s].unstable, 6u);
          if (static_cast<uint64_t>(cache_recs[s].streak) >= need)
            pred_slots.insert(s);
        }
        // Idle-round carry: unconsumed predictions stand (re-emitted so
        // clients, whose predictions are one-round-valid, stay primed).
        pred_slots.insert(carried.begin(), carried.end());
        spec_predictions += pred_slots.size();
      }
    }

    std::vector<uint8_t> resp;
    put_u32(&resp, static_cast<uint32_t>(ready.size()));
    for (auto& [ord, name, digest, group] : ready) {
      put_str(&resp, name);
      put_str(&resp, digest);
      put_str(&resp, group);
    }
    put_u32(&resp, static_cast<uint32_t>(warns.size()));
    for (auto& w : warns) put_str(&resp, w);
    put_u32(&resp, static_cast<uint32_t>(errs.size()));
    for (auto& [name, msg] : errs) {
      put_str(&resp, name);
      put_str(&resp, msg);
    }
    put_u32(&resp, static_cast<uint32_t>(assigns.size()));
    for (auto& [id, rec] : assigns) {
      put_str(&resp, rec.name);
      put_str(&resp, rec.digest);
      put_str(&resp, rec.datadep);
      put_u16(&resp, rec.required);
      put_u16(&resp, rec.grouped);
      put_u32(&resp, id);
    }
    // Ready bitvector (steady-state fast path) + coordinated evictions.
    uint32_t max_slot = 0;
    for (uint32_t s : ready_slots) max_slot = std::max(max_slot, s + 1);
    uint32_t bv_bytes = (max_slot + 7) / 8;
    put_u32(&resp, bv_bytes);
    size_t bv_off = resp.size();
    resp.resize(resp.size() + bv_bytes, 0);
    for (uint32_t s : ready_slots) resp[bv_off + s / 8] |= (1u << (s % 8));
    put_u32(&resp, static_cast<uint32_t>(evictions.size()));
    for (uint32_t s : evictions) put_u32(&resp, s);
    // Monitor section (protocol v3): this round's blobs, re-broadcast to
    // every rank.  Appended even when empty — the magic is the server's
    // capability advertisement clients version-gate on.  Bounded by
    // kMonSectionCap: at very large worlds a synchronized reporting
    // interval lands every rank's blob in one round, and the section must
    // stay far from the client receive cap — the overflow is dropped
    // (those ranks' tables lag one interval, nothing worse).
    size_t mon_budget = kMonSectionCap;
    std::vector<std::pair<int, std::string>*> mon_send;
    for (auto& b : mon_blobs) {
      if (b.second.size() + 8 > mon_budget) continue;
      mon_budget -= b.second.size() + 8;
      mon_send.push_back(&b);
    }
    put_u32(&resp, kMonMagic);
    put_u32(&resp, static_cast<uint32_t>(mon_send.size()));
    for (auto* b : mon_send) {
      put_u32(&resp, static_cast<uint32_t>(b->first));
      put_u32(&resp, static_cast<uint32_t>(b->second.size()));
      resp.insert(resp.end(), b->second.begin(), b->second.end());
    }
    // Clean-LEAVE notice (protocol v6): ranks that departed THIS round.
    // Appended only on rounds where someone actually left (warm rounds
    // carry zero extra bytes — frame-guarded) and, empty, on round 1 as
    // the capability ad; it rides AFTER the v4/v5 ads below so older
    // clients latch everything they understand before their trailing
    // walk stops at the unknown magic.
    // Fault-tolerance capability ad (protocol v4): round 1's response only,
    // so the warm path carries zero extra bytes — see the header comment.
    if (round_no == 1) {
      put_u32(&resp, kFltMagic);
      put_u32(&resp, 0);
      // Hierarchical-control-plane capability ad (protocol v5): also
      // round-1 only.  Appended AFTER FLT1 so pre-v5 clients — whose
      // trailing walk stops at the first unknown magic — still latch
      // their fault capability before ignoring the rest.
      put_u32(&resp, kAggMagic);
      put_u32(&resp, 0);
    }
    if (round_no == 1 || !left_this_round.empty()) {
      put_u32(&resp, kLeaveMagic);
      put_u32(&resp, 4 + 4 * static_cast<uint32_t>(left_this_round.size()));
      put_u32(&resp, static_cast<uint32_t>(left_this_round.size()));
      for (int r : left_this_round) put_u32(&resp, static_cast<uint32_t>(r));
    }
    // Zero-RTT prediction section (protocol v7): appended only on rounds
    // that actually predict — the warm path with speculation off carries
    // zero extra bytes — plus an empty section on round 1 as the
    // capability ad.  LAST among the trailing sections: pre-v7 clients
    // stop their order-agnostic-until-unknown walk here having latched
    // every older capability.
    if (round_no == 1 || !pred_slots.empty()) {
      put_u32(&resp, kZrtMagic);
      put_u32(&resp, 4 + 4 * static_cast<uint32_t>(pred_slots.size()));
      put_u32(&resp, static_cast<uint32_t>(pred_slots.size()));
      for (uint32_t s : pred_slots) put_u32(&resp, s);
    }
    // Attempt EVERY connection before honoring a failure: one dead/closing
    // peer must not cut the survivors off from a round's computed verdicts
    // (they may contain the ready broadcast that lets them finish cleanly).
    // A failed write marks the connection's ranks dead and the survivors
    // get a typed ABORT (queued behind the response they just received;
    // consumed at their next recv) instead of a blind socket sever.  One
    // write per connection: an agent fans the (already rank-agnostic)
    // response down to its local ranks itself.
    std::set<int> write_dead;
    for (Conn& c : conns) {
      if (c.left) continue;   // departed cleanly: no response owed
      if (!write_frame(c.fd, resp)) {
        c.sock_dead = true;
        poller.remove(c.fd);
        for (int r : c.ranks) write_dead.insert(r);
      }
    }
    if (!write_dead.empty()) {
      if (!stop.load()) {
        std::string who;
        for (int r : write_dead) {
          if (!who.empty()) who += ",";
          who += std::to_string(r);
        }
        broadcast_abort(write_dead,
                        "rank(s) [" + who +
                            "] lost connection while the round " +
                            std::to_string(round_no) +
                            " response was being broadcast");
      }
      stop.store(true);
    }
    // Freed slot ids become reusable only now that every client has (or
    // will, before its next request) processed the eviction broadcast —
    // a same-round reassignment could otherwise collide with in-flight
    // bit announces for the old tuple.
    for (uint32_t s : evictions) cache_free.push_back(s);
    stat_service_ns.fetch_add(static_cast<uint64_t>(
        std::chrono::duration_cast<std::chrono::nanoseconds>(
            Clock::now() - svc_t0)
            .count()));
    stat_rounds.fetch_add(1);
  }
  // fds are closed by hvdtpu_server_stop after the thread joins.
}

struct Client {
  int fd = -1;
};

}  // namespace

extern "C" {

void* hvdtpu_server_start(int port, int world, double stall_warn_s,
                          int cache_capacity, int round_deadline_ms,
                          int spec_ready_after, int spec_seed) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  ::setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, world) < 0) {
    ::close(fd);
    return nullptr;
  }
  auto* s = new Server();
  s->listen_fd = fd;
  s->world = world;
  s->stall_warn_s = stall_warn_s;
  s->cache_capacity = cache_capacity < 0 ? 0
      : static_cast<size_t>(cache_capacity);
  s->round_deadline_ms = round_deadline_ms < 0 ? 0 : round_deadline_ms;
  s->spec_ready_after = spec_ready_after < 0 ? 0 : spec_ready_after;
  // The seed is only meaningful below the qualification threshold (a
  // fresh slot must still prove ONE ready-on-first-announce round), and
  // only while speculation is armed at all.
  s->spec_seed = (spec_seed < 0 || s->spec_ready_after == 0)
      ? 0 : std::min(spec_seed, s->spec_ready_after);
  s->fds = std::make_unique<std::atomic<int>[]>(world);
  s->v4 = std::make_unique<std::atomic<char>[]>(world);
  s->v5 = std::make_unique<std::atomic<char>[]>(world);
  s->v6 = std::make_unique<std::atomic<char>[]>(world);
  s->v7 = std::make_unique<std::atomic<char>[]>(world);
  for (int i = 0; i < world; ++i) {
    s->fds[i].store(-1);
    s->v4[i].store(0);
    s->v5[i].store(0);
    s->v6[i].store(0);
    s->v7[i].store(0);
  }
  s->loop = std::thread([s] { s->run(); });
  return s;
}

// Root-side service accounting: out[0] = rounds served, out[1] = mean
// root service microseconds per round (gather-complete -> last response
// write).  Safe while the server runs (atomics) — the negotiation-scaling
// bench reads it before stopping the server.
int hvdtpu_server_stats(void* handle, double* out) {
  auto* s = static_cast<Server*>(handle);
  if (!s || !out) return -1;
  uint64_t rounds = s->stat_rounds.load();
  uint64_t ns = s->stat_service_ns.load();
  out[0] = static_cast<double>(rounds);
  out[1] = rounds ? static_cast<double>(ns) / 1e3 / rounds : 0.0;
  return 0;
}

void hvdtpu_server_stop(void* handle) {
  auto* s = static_cast<Server*>(handle);
  if (!s) return;
  // shutdown (not close) unblocks the loop thread's blocking accept/recv;
  // actual closes happen only after the join so no fd is closed (and
  // potentially recycled) while the loop might still read it.
  s->stop.store(true);
  ::shutdown(s->listen_fd, SHUT_RDWR);
  int hs = s->handshake_fd.exchange(-2);
  if (hs >= 0) ::shutdown(hs, SHUT_RDWR);
  // Let an in-flight round finish broadcasting its responses before
  // severing the sockets (phase_mu comment): without this, peers whose
  // response for the CURRENT round had not been written yet fail their
  // round with a pending entry.  Timed: a peer wedged enough to block a
  // small write for 5s is a dead peer; proceed and sever.
  bool locked = s->phase_mu.try_lock_for(std::chrono::seconds(5));
  for (int i = 0; i < s->world; ++i) {
    int fd = s->fds[i].load();
    if (fd >= 0) ::shutdown(fd, SHUT_RDWR);
  }
  if (locked) s->phase_mu.unlock();
  if (s->loop.joinable()) s->loop.join();
  // If we took ownership of a mid-handshake fd (exchanged to -2 above),
  // run() deliberately did not close it — close it now, after the join.
  if (hs >= 0) ::close(hs);
  ::close(s->listen_fd);
  // An agent connection's fd appears once per claimed rank: close each
  // DISTINCT fd exactly once (a double close could hit a recycled number).
  std::set<int> closed;
  for (int i = 0; i < s->world; ++i) {
    int fd = s->fds[i].load();
    if (fd >= 0 && closed.insert(fd).second) ::close(fd);
  }
  delete s;
}

void* hvdtpu_client_connect(const char* host, int port, int rank,
                            int timeout_ms) {
  auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
  std::string port_str = std::to_string(port);
  while (Clock::now() < deadline) {
    // Resolve every attempt (DNS, not just dotted IPv4 — hostnames from
    // `-H node1:2,...` must work; resolution can also succeed late while
    // hosts boot).
    addrinfo hints{};
    hints.ai_family = AF_UNSPEC;
    hints.ai_socktype = SOCK_STREAM;
    addrinfo* res = nullptr;
    if (::getaddrinfo(host, port_str.c_str(), &hints, &res) != 0) {
      std::this_thread::sleep_for(std::chrono::milliseconds(200));
      continue;
    }
    for (addrinfo* ai = res; ai; ai = ai->ai_next) {
      int fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
      if (fd < 0) continue;
      if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) {
        int one = 1;
        ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        uint32_t r = static_cast<uint32_t>(rank);
        if (!write_exact(fd, &r, 4)) {
          ::close(fd);
          break;  // retry from scratch
        }
        ::freeaddrinfo(res);
        auto* c = new Client();
        c->fd = fd;
        return c;
      }
      ::close(fd);
    }
    ::freeaddrinfo(res);
    std::this_thread::sleep_for(std::chrono::milliseconds(50));
  }
  return nullptr;
}

// Send half of a lock-step round: write the request frame.  0 on success,
// -1 on a dead/closed socket.
int hvdtpu_client_send(void* handle, const uint8_t* req, int req_len) {
  auto* c = static_cast<Client*>(handle);
  if (!c || c->fd < 0) return -1;
  std::vector<uint8_t> payload(req, req + req_len);
  return write_frame(c->fd, payload) ? 0 : -1;
}

// Receive half: block for the response frame, bounded by timeout_ms
// (<= 0 = wait forever, the pre-v4 behavior).  Returns the response
// length, -1 on a dead socket, -2 on overflow, -3 on deadline expiry.
// The deadline bounds the ENTIRE frame, not just its first byte: a
// coordinator wedged mid-frame-write (SIGSTOPped / paged out after the
// length prefix) must still surface as RoundTimeoutError — this timeout
// is the documented backstop for exactly that wedged-coordinator case,
// where the server-side round deadline cannot help.
int hvdtpu_client_recv(void* handle, uint8_t* resp_buf, int resp_cap,
                       int timeout_ms) {
  auto* c = static_cast<Client*>(handle);
  if (!c || c->fd < 0) return -1;
  std::vector<uint8_t> resp;
  if (timeout_ms > 0) {
    auto deadline = Clock::now() + std::chrono::milliseconds(timeout_ms);
    int rc = read_frame_deadline(c->fd, &resp, deadline);
    if (rc == 0) return -3;
    if (rc < 0) return -1;
  } else if (!read_frame(c->fd, &resp)) {
    return -1;
  }
  if (static_cast<int>(resp.size()) > resp_cap) return -2;
  if (!resp.empty()) std::memcpy(resp_buf, resp.data(), resp.size());
  return static_cast<int>(resp.size());
}

// 1 when a frame is already readable (used to drain a queued ABORT before
// sending the next request — a send into a reset socket would make the
// kernel discard the buffered abort frame), else 0.
int hvdtpu_client_pending(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (!c || c->fd < 0) return 0;
  pollfd pfd{c->fd, POLLIN, 0};
  return ::poll(&pfd, 1, 0) > 0 ? 1 : 0;
}

// One lock-step round: send req frame, block for response frame.
// Returns response length, 0 on empty response, -1 on error, -2 if the
// response exceeds resp_cap.  (Legacy composite of send + recv, kept for
// unit tests and out-of-tree callers.)
int hvdtpu_client_round(void* handle, const uint8_t* req, int req_len,
                        uint8_t* resp_buf, int resp_cap) {
  int rc = hvdtpu_client_send(handle, req, req_len);
  if (rc < 0) return rc;
  return hvdtpu_client_recv(handle, resp_buf, resp_cap, 0);
}

// Unblock a thread stuck in hvdtpu_client_round (recv returns 0 after the
// socket shutdown) WITHOUT freeing the Client — call before client_close so
// shutdown ordering can't use-after-free a blocked round.
void hvdtpu_client_interrupt(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (c && c->fd >= 0) ::shutdown(c->fd, SHUT_RDWR);
}

void hvdtpu_client_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (!c) return;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

}  // extern "C"
