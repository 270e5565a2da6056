// The whole raft tick in one launch, hand-written for Hopper (sm_90a).
//
// Computes what tpuraft_torch/ops/tick.py::raft_tick_reference computes
// (the JAX package's tpuraft/ops/tick.py::raft_tick, whose jitted program
// tpuraft/ops/tick.py:303 wraps the Pallas kernel
// tpuraft/ops/quorum_pallas.py::_fused_quorum_pallas): the three quorum
// reductions, the witness commit clamp, the current-term commit gate, the
// election tally and timeout, lease and step-down, the periodic stepdown
// lane, the read fence, heartbeat and snapshot cadence.  The 11 outputs go
// into one packed byte buffer:
//   int32 rows  commit_rel, q_ack                       at 4 * G * i
//   bool rows   commit_advanced, elected, election_due, step_down, hb_due,
//               lease_valid, snap_due, stepdown_due, fence_ok
//                                                       at 8 * G + G * j
// (the engine's _OUT_I32 / _OUT_BOOL order), so the host fetches them in
// one copy.  The three advanced deadline rows (hb, snapshot, stepdown) are
// written only where their pointers are not null.
//
// Design: each group is a warp segment of S = next_pow2(P) lanes
// (quorum_core.cuh), and the kernel waits on memory once: every lane
// first requests its slot of the six [G, P] planes and its group's 13 [G]
// values the epilogue reads (9 state rows, 4 parameters; the same words
// across a segment, so one request a warp), and only then do the quorum's
// ballots and shuffles start.  Every lane of a segment computes the
// group's epilogue and stores its share of the results (result j by lane
// j % S) straight to the output rows.
// Integer semantics follow torch and JAX exactly: time sums and
// differences wrap in two's complement (computed in uint32_t: signed
// overflow is undefined in C++), election_timeout_ms // 2 is a floor
// division, and a bool byte is true when it is not 0.  Parameters are a
// 0-d scalar (stride 0) or a [G] row (stride 1).  Rows need only their
// natural alignment.  The kernel allocates nothing and does not
// synchronise; the wrapper (tpuraft_torch/ops/tick.py) launches it on
// PyTorch's current stream.
//
// Bound on an H100 SXM: memory.  It reads 8 int32 [G] rows, quiescent, 2
// int32 and 4 bool [G, P] planes and 4 int32 [G] parameter rows, and
// writes 2 int32 and 9 bool [G] rows: G * (66 + 12 P) bytes, 2.65 MB at
// G = 16,384, P = 8 (0.79 us at 3.35 TB/s); the three deadline rows add
// 12 bytes per group.  At the engine's sizes one launch's fixed cost and
// the rounds of memory latency dominate: the point of the fusion is one
// launch per tick instead of one per torch op, and of the load order one
// round of latency where the epilogue's own loads made a second.  At large
// G the bytes in flight bound it: each lane moves 1 or 4 bytes a request.

#include <utility>

#include "quorum_core.cuh"

namespace {

using namespace tpuraft;

constexpr int32_t kRoleFollower = 0;
constexpr int32_t kRoleCandidate = 1;
constexpr int32_t kRoleLeader = 2;
constexpr int32_t kRoleInactive = 3;

struct TickArgs {
  // GroupState, in field order
  const int32_t* role;
  const int32_t* commit_rel;
  const int32_t* pending_rel;
  const int32_t* match_rel;       // [G, P]
  const uint8_t* granted;         // [G, P]
  const uint8_t* voter_mask;      // [G, P]
  const uint8_t* old_voter_mask;  // [G, P]
  const int32_t* elect_deadline;
  const int32_t* hb_deadline;
  const int32_t* last_ack;        // [G, P]
  const int32_t* snap_deadline;
  const uint8_t* quiescent;
  const uint8_t* witness_mask;    // [G, P]
  const int32_t* stepdown_deadline;
  const int32_t* fence_start;
  // TickParams: element g is param[g * stride], stride 0 or 1
  const int32_t* eto;
  const int32_t* hb;
  const int32_t* lease;
  const int32_t* snap;
  int eto_stride, hb_stride, lease_stride, snap_stride;
  int32_t now;
  uint8_t* out;                 // packed outputs, 17 * G bytes
  int32_t* new_hb_deadline;     // nullable
  int32_t* new_snap_deadline;   // nullable
  int32_t* new_stepdown_deadline;  // nullable
  int G, P;
};

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

// a // 2 rounded toward negative infinity, as torch and JAX divide
__device__ __forceinline__ int32_t floor_half(int32_t a) {
  return a / 2 - ((a < 0 && (a & 1)) ? 1 : 0);
}

// the [G] values the epilogue reads
enum GroupValue {
  kRole, kCommit, kPending, kElect, kHbDeadline, kSnapDeadline,
  kStepdownDeadline, kFence, kEto, kHbMs, kLeaseMs, kSnapMs, kQuiescent,
  kGroupValues
};

// group g's value R (a bool byte as 0 or 1)
template <int R>
__device__ __forceinline__ int32_t group_value(const TickArgs& t, int g) {
  if constexpr (R == kRole) return __ldg(t.role + g);
  if constexpr (R == kCommit) return __ldg(t.commit_rel + g);
  if constexpr (R == kPending) return __ldg(t.pending_rel + g);
  if constexpr (R == kElect) return __ldg(t.elect_deadline + g);
  if constexpr (R == kHbDeadline) return __ldg(t.hb_deadline + g);
  if constexpr (R == kSnapDeadline) return __ldg(t.snap_deadline + g);
  if constexpr (R == kStepdownDeadline)
    return __ldg(t.stepdown_deadline + g);
  if constexpr (R == kFence) return __ldg(t.fence_start + g);
  if constexpr (R == kEto) return __ldg(t.eto + g * t.eto_stride);
  if constexpr (R == kHbMs) return __ldg(t.hb + g * t.hb_stride);
  if constexpr (R == kLeaseMs) return __ldg(t.lease + g * t.lease_stride);
  if constexpr (R == kSnapMs) return __ldg(t.snap + g * t.snap_stride);
  if constexpr (R == kQuiescent) return __ldg(t.quiescent + g) != 0;
  return 0;
}

template <int... R>
__device__ __forceinline__ void load_values(const TickArgs& t, int g,
                                            int32_t (&v)[kGroupValues],
                                            std::integer_sequence<int, R...>) {
  ((v[R] = group_value<R>(t, g)), ...);
}

// a group's results: the int32 rows commit_rel, q_ack and the three
// advanced deadlines, then the 9 bool rows in the packed order
constexpr int kOutI32 = 5;
constexpr int kOutBool = 9;
constexpr int kOutRows = kOutI32 + kOutBool;

// result j's index in its int32 or bool array (in range either way)
__device__ __forceinline__ constexpr int ri(int j) {
  return j < kOutI32 ? j : 0;
}
__device__ __forceinline__ constexpr int rb(int j) {
  return j < kOutI32 ? 0 : j - kOutI32;
}

struct Results {
  int32_t i32[kOutI32];
  bool b[kOutBool];
};

// The epilogue of one group, line by line of tpuraft/ops/tick.py, from
// its 13 [G] values and its quorum.
__device__ __forceinline__ Results epilogue(const int32_t (&v)[kGroupValues],
                                            const Quorum& q,
                                            int32_t data_best,
                                            uint32_t wit_bits, int32_t now) {
  const int32_t role = v[kRole];
  const bool leader = role == kRoleLeader;
  const bool candidate = role == kRoleCandidate;
  const bool follower = role == kRoleFollower;
  const bool awake = v[kQuiescent] == 0;
  const int32_t eto = v[kEto];

  // commit advancement: the current-term gate (tick.py:179-183), the
  // witness clamp (tick.py:176) first
  const int32_t quorum_idx = (q.voters & wit_bits) != 0u
                                 ? min(q.quorum_idx, data_best)
                                 : q.quorum_idx;
  const int32_t commit = v[kCommit];
  const bool can_commit = leader && quorum_idx >= v[kPending];
  const int32_t new_commit = can_commit ? max(commit, quorum_idx) : commit;

  // election tally and timeout (tick.py:186, :193)
  const bool elected = candidate && q.elected;
  const bool election_due =
      (follower || candidate) && awake && now >= v[kElect];

  // lease and step-down (tick.py:203-207); now - q_ack wraps for NEG rows,
  // which have_quorum_ack masks out
  const bool have_quorum_ack = q.q_ack > kNegInf;
  const int32_t ack_age = wrap_sub(now, q.q_ack);
  const bool lease_valid = leader && have_quorum_ack && ack_age < v[kLeaseMs];
  const bool step_down = leader && have_quorum_ack && ack_age >= eto;

  // periodic stepdown lane (tick.py:218-223)
  const int32_t sd_deadline = v[kStepdownDeadline];
  const bool stepdown_due = leader && awake && now >= sd_deadline;

  // read fence (tick.py:232)
  const int32_t fence = v[kFence];
  const bool fence_ok =
      leader && fence > kNegInf && have_quorum_ack && q.q_ack >= fence;

  // heartbeat (tick.py:241-242)
  const int32_t hb_deadline = v[kHbDeadline];
  const bool hb_due = leader && awake && now >= hb_deadline;

  // snapshot cadence (tick.py:248-252)
  const int32_t snap_ms = v[kSnapMs];
  const int32_t snap_deadline = v[kSnapDeadline];
  const bool snap_due =
      role != kRoleInactive && snap_ms > 0 && now >= snap_deadline;

  return Results{
      {new_commit, q.q_ack, hb_due ? wrap_add(now, v[kHbMs]) : hb_deadline,
       snap_due ? wrap_add(now, snap_ms) : snap_deadline,
       stepdown_due ? wrap_add(now, max(floor_half(eto), 1)) : sd_deadline},
      {new_commit > commit, elected, election_due, step_down, hb_due,
       lease_valid, snap_due, stepdown_due, fence_ok}};
}

// Result j of group g into its output row (the deadline rows only where
// their pointers are not null).
__device__ __forceinline__ void store_result(const TickArgs& t, int j, int g,
                                             int32_t value) {
  const int G = t.G;
  if (j < 2) {
    reinterpret_cast<int32_t*>(t.out)[static_cast<size_t>(j) * G + g] = value;
  } else if (j < kOutI32) {
    int32_t* row = j == 2   ? t.new_hb_deadline
                   : j == 3 ? t.new_snap_deadline
                            : t.new_stepdown_deadline;
    if (row) row[g] = value;
  } else {
    t.out[static_cast<size_t>(8 + j - kOutI32) * G + g] =
        static_cast<uint8_t>(value);
  }
}

// Blocks of 128 threads measured best on an H100 80GB HBM3 at 700 W
// (CUDA graphs of 100 launches at G = 64 and 2,048, P = 4): 1.82-2.13 us
// against 1.97-2.21 in blocks of 64 or 256.
constexpr int kTickThreads = 128;

template <int S>
__global__ void __launch_bounds__(kTickThreads)
    fused_tick_kernel(TickArgs t) {
  const int G = t.G, P = t.P;
  const Lane<S> ln(G, P);

  // every request before the first wait: the lane's slots of the [G, P]
  // planes, then its group's [G] values
  const Slot slot = load_slot<S>(ln, P, t.match_rel, t.granted, t.last_ack,
                                 t.voter_mask, t.old_voter_mask);
  const size_t off = static_cast<size_t>(ln.g) * P + ln.k;
  const bool wit = ln.live && __ldg(t.witness_mask + off) != 0;
  int32_t v[kGroupValues];
  if (ln.g < G)
    load_values(t, ln.g, v, std::make_integer_sequence<int, kGroupValues>{});

  const Quorum q = quorum_of<S>(ln, P, slot);
  // the witness clamp's input (tick.py:176): the best data-replica match,
  // max over the P slots of (data ? match : 0), data = voter of either
  // config and not a witness
  const uint32_t wit_bits = ln.ballot(wit);
  const bool data = ((q.voters >> ln.k) & 1u) && !wit;
  const int32_t data_best =
      segment_max<S>(ln.live ? (data ? slot.match : 0) : INT32_MIN);

  if (ln.g < G) {
    const Results res = epilogue(v, q, data_best, wit_bits, t.now);
#pragma unroll
    for (int j = 0; j < kOutRows; ++j)
      if (ln.k == j % S)
        store_result(t, j, ln.g,
                     j < kOutI32 ? res.i32[ri(j)] : res.b[rb(j)]);
  }
}

}  // namespace

// Returns cudaSuccess (0) or the launch error; G == 0 launches nothing.
// Pointers follow GroupState's field order, then TickParams' (each with
// its stride), then the outputs.
extern "C" cudaError_t tpuraft_fused_tick(
    const int32_t* role, const int32_t* commit_rel,
    const int32_t* pending_rel, const int32_t* match_rel,
    const uint8_t* granted, const uint8_t* voter_mask,
    const uint8_t* old_voter_mask, const int32_t* elect_deadline,
    const int32_t* hb_deadline, const int32_t* last_ack,
    const int32_t* snap_deadline, const uint8_t* quiescent,
    const uint8_t* witness_mask, const int32_t* stepdown_deadline,
    const int32_t* fence_start, const int32_t* eto, int eto_stride,
    const int32_t* hb, int hb_stride, const int32_t* lease, int lease_stride,
    const int32_t* snap, int snap_stride, int32_t now, uint8_t* out,
    int32_t* new_hb_deadline, int32_t* new_snap_deadline,
    int32_t* new_stepdown_deadline, int G, int P, cudaStream_t stream) {
  if (G < 0 || P < 1 || P > kMaxPeers) return cudaErrorInvalidValue;
  for (int s : {eto_stride, hb_stride, lease_stride, snap_stride})
    if (s != 0 && s != 1) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  const TickArgs t{role, commit_rel, pending_rel, match_rel, granted,
                   voter_mask, old_voter_mask, elect_deadline, hb_deadline,
                   last_ack, snap_deadline, quiescent, witness_mask,
                   stepdown_deadline, fence_start, eto, hb, lease, snap,
                   eto_stride, hb_stride, lease_stride, snap_stride, now,
                   out, new_hb_deadline, new_snap_deadline,
                   new_stepdown_deadline, G, P};
  return with_segment(P, [&](auto seg) {
    constexpr int S = decltype(seg)::value;
    fused_tick_kernel<S>
        <<<grid_for<S>(G, kTickThreads), kTickThreads, 0, stream>>>(t);
    return cudaGetLastError();
  });
}
