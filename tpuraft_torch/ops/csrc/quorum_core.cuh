// Warp-segmented quorum core shared by the fused-quorum kernel
// (fused_quorum.cu) and the fused tick (fused_tick.cu), for Hopper (sm_90a).
//
// Layout: each raft group owns a segment of S lanes of a warp, S the next
// power of two >= P (S in {1, 2, 4, 8, 16, 32}); lane k < P holds peer slot
// k of the group's row of the public [G, P] planes, so neighbouring lanes
// read neighbouring addresses (at P = 8 a warp carries 4 groups and reads
// 128 contiguous bytes of match_rel).  Lanes k >= P of a segment (P not a
// power of two) and the lanes of groups g >= G (the ragged end) run every
// collective with neutral values: they load nothing, set no ballot bit and
// take part in no count or maximum.  No lane returns before the last
// collective, so every __shfl_sync / __ballot_sync names the full warp.
// Any block size that is a multiple of 32 works: a lane's group is
// (blockIdx.x * blockDim.x + threadIdx.x) / S.
//
// The replica quorum (replica_quorum.cu) runs on the same lanes with the
// planes transposed: lane k of a segment holds replica row k of the
// [R, G] planes, and segment_kth_largest takes the plain q-th largest of
// the segment (no voter mask, no joint row), V values a lane.
//
// The order statistic equals the sort-based oracle (tpuraft_torch/ops/
// ballot.py) bit for bit: masked-out slots take the value -2^30, all P slots
// of the row are ranked, and the value at sorted position q - 1 is picked,
// q = n_voters / 2 + 1.  Rank counting finds it without a sort: the q-th
// largest of a multiset w is max{ w_j : #{k : w_k >= w_j} >= q }.  Each lane
// counts for its own values in one loop of S shuffle pairs, which ranks its
// masked match and its masked ack together; a warp that holds a joint row
// makes one more such loop for the old configuration.  A xor-butterfly then
// takes the maximum over the segment's candidates.
//
// Replaces the quorum math of the JAX package's Pallas TPU kernel,
// tpuraft/ops/quorum_pallas.py::_fused_quorum_pallas (helpers _qth_largest,
// _vote_quorum), which transposes to [P, G] for the TPU's 128-lane axis;
// here the [P] axis maps to lanes of one warp instead.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace tpuraft {

constexpr int32_t kNegInf = -(1 << 30);
constexpr unsigned kFullWarp = 0xffffffffu;
constexpr int kMaxPeers = 32;
constexpr int kThreads = 256;  // a multiple of 32: every warp is full

// One lane's place: group g, slot k of the group's segment, and whether it
// holds a real slot (k < P and g < G).
template <int S>
struct Lane {
  int g;
  int k;
  int seg_base;  // first warp lane of this segment
  bool live;

  __device__ __forceinline__ Lane(int G, int P) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    g = t / S;
    k = t % S;
    seg_base = (threadIdx.x & 31) & ~(S - 1);
    live = g < G && k < P;
  }

  // The segment's bits of a warp-wide ballot: bit k set when lane k's
  // predicate holds.  Every lane of the warp must call it.
  __device__ __forceinline__ uint32_t ballot(bool pred) const {
    const uint32_t b = __ballot_sync(kFullWarp, pred);
    return S == 32 ? b : (b >> seg_base) & ((1u << S) - 1u);
  }
};

// Maximum over the segment; every lane of the warp must call it.
template <int S>
__device__ __forceinline__ int32_t segment_max(int32_t v) {
#pragma unroll
  for (int off = S / 2; off > 0; off >>= 1)
    v = max(v, __shfl_xor_sync(kFullWarp, v, off, S));
  return v;
}

// The q-th largest of the values a segment holds, V a lane (lane k holds
// slots k, k + S, ..., k + (V - 1) * S), 1 <= q <= the number of live
// slots; every lane of the warp must call it, and every lane of the
// segment ends with the result.  Rank counting, as order_stats does: the
// q-th largest of a multiset w is max{ w_j : #{i : w_i >= w_j} >= q }, one
// loop of S shuffles of each of the V values.  A dead slot must hold
// INT32_MIN: it adds to no count but that of a slot whose own value is
// INT32_MIN, whose rank test holds anyway (every live value is >= it and
// q <= the live count), and as a candidate it is the least value, so a
// live INT32_MIN or INT32_MAX needs no special case either.
template <int S, int V>
__device__ __forceinline__ int32_t segment_kth_largest(
    const int32_t (&v)[V], int q) {
  int c[V] = {};
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int32_t o = __shfl_sync(kFullWarp, v[j], i, S);
#pragma unroll
      for (int m = 0; m < V; ++m) c[m] += o >= v[m] ? 1 : 0;
    }
  }
  int32_t best = INT32_MIN;
#pragma unroll
  for (int m = 0; m < V; ++m)
    if (c[m] >= q) best = max(best, v[m]);
  return segment_max<S>(best);
}

// One lane's slot of the five [G, P] planes the quorum reads (0 and false
// on a dead lane).
struct Slot {
  int32_t match;
  int32_t ack;
  bool voter;
  bool old_voter;
  bool granted;
};

template <int S>
__device__ __forceinline__ Slot load_slot(
    const Lane<S>& ln, int P, const int32_t* __restrict__ match,
    const uint8_t* __restrict__ granted, const int32_t* __restrict__ last_ack,
    const uint8_t* __restrict__ voter_mask,
    const uint8_t* __restrict__ old_voter_mask) {
  Slot s{0, 0, false, false, false};
  if (ln.live) {
    const size_t off = static_cast<size_t>(ln.g) * P + ln.k;
    s.match = __ldg(match + off);
    s.ack = __ldg(last_ack + off);
    s.voter = __ldg(voter_mask + off) != 0;
    s.old_voter = __ldg(old_voter_mask + off) != 0;
    s.granted = __ldg(granted + off) != 0;
  }
  return s;
}

// The q-th largest of the segment's P match values and of its P ack
// values under one voter mask (slots outside the mask at kNegInf), q =
// n / 2 + 1 with n = popcount(mask); kNegInf when n == 0.  One loop of S
// shuffle pairs counts both ranks.  A dead lane sends INT32_MIN: below
// every value, it adds to no count but that of a lane whose own value is
// INT32_MIN, whose rank test holds anyway (every one of the P slots is >=
// it, and q <= P), so no slot-index test is needed in the loop.  Every
// lane of the warp must call it.
template <int S>
__device__ __forceinline__ void order_stats(const Lane<S>& ln, int P,
                                            int32_t m, int32_t a,
                                            uint32_t mask, int32_t& qm,
                                            int32_t& qa) {
  const bool in = (mask >> ln.k) & 1u;
  const int32_t wm = in ? m : kNegInf;
  const int32_t wa = in ? a : kNegInf;
  const int32_t sm = ln.live ? wm : INT32_MIN;
  const int32_t sa = ln.live ? wa : INT32_MIN;
  int cm = 0, ca = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    cm += __shfl_sync(kFullWarp, sm, i, S) >= wm ? 1 : 0;
    ca += __shfl_sync(kFullWarp, sa, i, S) >= wa ? 1 : 0;
  }
  const int n = __popc(mask);
  const int q = n / 2 + 1;
  const int32_t bm = segment_max<S>(ln.k < P && cm >= q ? wm : INT32_MIN);
  const int32_t ba = segment_max<S>(ln.k < P && ca >= q ? wa : INT32_MIN);
  qm = n == 0 ? kNegInf : bm;
  qa = n == 0 ? kNegInf : ba;
}

__device__ __forceinline__ bool vote_quorum(uint32_t granted, uint32_t mask) {
  const int n = __popc(mask);
  return n > 0 && __popc(granted & mask) >= n / 2 + 1;
}

// The three [G, P] -> [G] reductions of the tick, joint-consensus aware
// (a row is joint when any old-config voter is set).  Every lane of the
// segment ends with the group's results.
struct Quorum {
  int32_t quorum_idx;  // q-th largest voter match; joint: min of both configs
  int32_t q_ack;       // the same order statistic over last_ack
  bool elected;        // granted voters >= q; joint: in both configs
  uint32_t voters;     // voter_mask | old_voter_mask bits of the segment
};

// The reductions of a lane's loaded slot; every lane of the warp must call
// it.
template <int S>
__device__ __forceinline__ Quorum quorum_of(const Lane<S>& ln, int P,
                                            const Slot& s) {
  const uint32_t vm = ln.ballot(s.voter);
  const uint32_t ovm = ln.ballot(s.old_voter);
  const uint32_t gr = ln.ballot(s.granted);
  Quorum r;
  order_stats<S>(ln, P, s.match, s.ack, vm, r.quorum_idx, r.q_ack);
  r.elected = vote_quorum(gr, vm);
  // the old configuration's pass only where the warp holds a joint row: a
  // warp-uniform branch, so the shuffles inside name the whole warp
  if (__any_sync(kFullWarp, ovm != 0u)) {
    int32_t oqm, oqa;
    order_stats<S>(ln, P, s.match, s.ack, ovm, oqm, oqa);
    if (ovm != 0u) {
      r.quorum_idx = min(r.quorum_idx, oqm);
      r.q_ack = min(r.q_ack, oqa);
      r.elected = r.elected && vote_quorum(gr, ovm);
    }
  }
  r.voters = vm | ovm;
  return r;
}

// One launch over G groups at segment width S in blocks of `threads`.
template <int S>
inline dim3 grid_for(int G, int threads = kThreads) {
  const long long lanes = static_cast<long long>(G) * S;
  return dim3(static_cast<unsigned>((lanes + threads - 1) / threads));
}

// launch(std::integral_constant<int, S>{}) with S the segment width of P
// slots (the next power of two); cudaErrorInvalidValue when P is outside
// 1..32.
template <typename Launch>
inline cudaError_t with_segment(int P, Launch&& launch) {
  if (P < 1 || P > kMaxPeers) return cudaErrorInvalidValue;
  if (P == 1) return launch(std::integral_constant<int, 1>{});
  if (P == 2) return launch(std::integral_constant<int, 2>{});
  if (P <= 4) return launch(std::integral_constant<int, 4>{});
  if (P <= 8) return launch(std::integral_constant<int, 8>{});
  if (P <= 16) return launch(std::integral_constant<int, 16>{});
  return launch(std::integral_constant<int, 32>{});
}

}  // namespace tpuraft
