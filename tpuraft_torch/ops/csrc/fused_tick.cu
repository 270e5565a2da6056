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
// Design: the quorum stage is quorum_core.cuh (one warp segment of
// S = next_pow2(P) lanes per group).  After it every lane of a segment
// holds the group's reductions; lane 0 then loads the group's [G] rows and
// runs the epilogue, line by line of tpuraft/ops/tick.py.  Integer
// semantics follow torch and JAX exactly: time sums and differences wrap
// in two's complement (computed in uint32_t: signed overflow is undefined
// in C++), election_timeout_ms // 2 is a floor division, and a bool byte
// is true when it is not 0.  Parameters are a 0-d scalar (stride 0) or a
// [G] row (stride 1).  The kernel allocates nothing and does not
// synchronise; the wrapper (tpuraft_torch/ops/tick.py) launches it on
// PyTorch's current stream.
//
// Bound on an H100 SXM: memory.  It reads 8 int32 [G] rows, quiescent, 2
// int32 and 4 bool [G, P] planes and 4 int32 [G] parameter rows, and
// writes 2 int32 and 9 bool [G] rows: G * (66 + 12 P) bytes, 2.65 MB at
// G = 16,384, P = 8 (0.79 us at 3.35 TB/s); the three deadline rows add
// 12 bytes per group.  At the engine's sizes one launch's fixed cost
// dominates: the point of the fusion is one launch per tick instead of one
// per torch op.

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

template <int S>
__global__ void __launch_bounds__(kThreads) fused_tick_kernel(TickArgs t) {
  const int G = t.G, P = t.P;
  const Lane<S> ln(G, P);
  const Quorum q = quorum_stage<S>(ln, P, t.match_rel, t.granted,
                                   t.last_ack, t.voter_mask,
                                   t.old_voter_mask);

  // witness commit clamp (tick.py:176): the best data-replica match,
  // max over the P slots of (data ? match : 0), data = voter of either
  // config and not a witness
  const size_t off = static_cast<size_t>(ln.g) * P + ln.k;
  const bool wit = ln.live && __ldg(t.witness_mask + off) != 0;
  const uint32_t wit_bits = ln.ballot(wit);
  const bool data = ((q.voters >> ln.k) & 1u) && !wit;
  const int32_t data_best =
      segment_max<S>(ln.live ? (data ? q.match : 0) : INT32_MIN);
  if (ln.k != 0 || ln.g >= G) return;  // after the last collective

  const int g = ln.g;
  const int32_t now = t.now;
  const int32_t role = __ldg(t.role + g);
  const bool leader = role == kRoleLeader;
  const bool candidate = role == kRoleCandidate;
  const bool follower = role == kRoleFollower;
  const bool awake = __ldg(t.quiescent + g) == 0;
  const int32_t eto = __ldg(t.eto + g * t.eto_stride);
  const int32_t hb_ms = __ldg(t.hb + g * t.hb_stride);
  const int32_t lease_ms = __ldg(t.lease + g * t.lease_stride);
  const int32_t snap_ms = __ldg(t.snap + g * t.snap_stride);

  // commit advancement: the current-term gate (tick.py:179-183)
  const int32_t quorum_idx = (q.voters & wit_bits) != 0u
                                 ? min(q.quorum_idx, data_best)
                                 : q.quorum_idx;
  const int32_t commit = __ldg(t.commit_rel + g);
  const bool can_commit = leader && quorum_idx >= __ldg(t.pending_rel + g);
  const int32_t new_commit = can_commit ? max(commit, quorum_idx) : commit;

  // election tally and timeout (tick.py:186, :193)
  const bool elected = candidate && q.elected;
  const bool election_due = (follower || candidate) && awake &&
                            now >= __ldg(t.elect_deadline + g);

  // lease and step-down (tick.py:203-207); now - q_ack wraps for NEG rows,
  // which have_quorum_ack masks out
  const bool have_quorum_ack = q.q_ack > kNegInf;
  const int32_t ack_age = wrap_sub(now, q.q_ack);
  const bool lease_valid = leader && have_quorum_ack && ack_age < lease_ms;
  const bool step_down = leader && have_quorum_ack && ack_age >= eto;

  // periodic stepdown lane (tick.py:218-223)
  const int32_t sd_deadline = __ldg(t.stepdown_deadline + g);
  const bool stepdown_due = leader && awake && now >= sd_deadline;

  // read fence (tick.py:232)
  const int32_t fence = __ldg(t.fence_start + g);
  const bool fence_ok =
      leader && fence > kNegInf && have_quorum_ack && q.q_ack >= fence;

  // heartbeat (tick.py:241-242)
  const int32_t hb_deadline = __ldg(t.hb_deadline + g);
  const bool hb_due = leader && awake && now >= hb_deadline;

  // snapshot cadence (tick.py:248-252)
  const int32_t snap_deadline = __ldg(t.snap_deadline + g);
  const bool snap_due =
      role != kRoleInactive && snap_ms > 0 && now >= snap_deadline;

  int32_t* out_i32 = reinterpret_cast<int32_t*>(t.out);
  uint8_t* out_b = t.out + static_cast<size_t>(8) * G;
  out_i32[g] = new_commit;
  out_i32[G + g] = q.q_ack;
  out_b[g] = new_commit > commit;
  out_b[G + g] = elected;
  out_b[2 * G + g] = election_due;
  out_b[3 * G + g] = step_down;
  out_b[4 * G + g] = hb_due;
  out_b[5 * G + g] = lease_valid;
  out_b[6 * G + g] = snap_due;
  out_b[7 * G + g] = stepdown_due;
  out_b[8 * G + g] = fence_ok;
  if (t.new_hb_deadline)
    t.new_hb_deadline[g] = hb_due ? wrap_add(now, hb_ms) : hb_deadline;
  if (t.new_snap_deadline)
    t.new_snap_deadline[g] =
        snap_due ? wrap_add(now, snap_ms) : snap_deadline;
  if (t.new_stepdown_deadline)
    t.new_stepdown_deadline[g] =
        stepdown_due ? wrap_add(now, max(floor_half(eto), 1)) : sd_deadline;
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
    fused_tick_kernel<S><<<grid_for<S>(G), kThreads, 0, stream>>>(t);
    return cudaGetLastError();
  });
}
