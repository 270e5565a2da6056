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
//
// The order statistic equals the sort-based oracle (tpuraft_torch/ops/
// ballot.py) bit for bit: masked-out slots take the value -2^30, all P slots
// of the row are ranked, and the value at sorted position q - 1 is picked,
// q = n_voters / 2 + 1.  Rank counting finds it without a sort: the q-th
// largest of a multiset w is max{ w_j : #{k : w_k >= w_j} >= q }.  Each lane
// counts for its own value with S shuffles (O(P) work per lane), and a
// xor-butterfly takes the maximum over the segment's candidates.
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
    const int t = blockIdx.x * kThreads + threadIdx.x;
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

// q-th largest of the segment's P slot values with slots outside `mask`
// set to kNegInf, q = n / 2 + 1 with n = popcount(mask); kNegInf when
// n == 0.  Every lane of the warp must call it.
template <int S>
__device__ __forceinline__ int32_t qth_largest(const Lane<S>& ln, int P,
                                               int32_t v, uint32_t mask) {
  const int32_t w = ((mask >> ln.k) & 1u) ? v : kNegInf;
  int c = 0;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int32_t x = __shfl_sync(kFullWarp, w, i, S);
    c += (i < P && x >= w) ? 1 : 0;
  }
  const int n = __popc(mask);
  const bool candidate = ln.k < P && c >= n / 2 + 1;
  const int32_t best = segment_max<S>(candidate ? w : INT32_MIN);
  return n == 0 ? kNegInf : best;
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
  int32_t match;       // this lane's match_rel (0 on a dead lane)
};

template <int S>
__device__ __forceinline__ Quorum quorum_stage(
    const Lane<S>& ln, int P, const int32_t* __restrict__ match,
    const uint8_t* __restrict__ granted, const int32_t* __restrict__ last_ack,
    const uint8_t* __restrict__ voter_mask,
    const uint8_t* __restrict__ old_voter_mask) {
  const size_t off = static_cast<size_t>(ln.g) * P + ln.k;
  const int32_t m = ln.live ? __ldg(match + off) : 0;
  const int32_t a = ln.live ? __ldg(last_ack + off) : 0;
  const uint32_t vm = ln.ballot(ln.live && __ldg(voter_mask + off) != 0);
  const uint32_t ovm =
      ln.ballot(ln.live && __ldg(old_voter_mask + off) != 0);
  const uint32_t gr = ln.ballot(ln.live && __ldg(granted + off) != 0);

  Quorum r;
  r.quorum_idx = qth_largest<S>(ln, P, m, vm);
  r.q_ack = qth_largest<S>(ln, P, a, vm);
  r.elected = vote_quorum(gr, vm);
  // the old config's statistics only where the warp holds a joint row: a
  // warp-uniform branch, so the shuffles inside name the whole warp
  if (__any_sync(kFullWarp, ovm != 0u)) {
    const int32_t oqi = qth_largest<S>(ln, P, m, ovm);
    const int32_t oqa = qth_largest<S>(ln, P, a, ovm);
    if (ovm != 0u) {
      r.quorum_idx = min(r.quorum_idx, oqi);
      r.q_ack = min(r.q_ack, oqa);
      r.elected = r.elected && vote_quorum(gr, ovm);
    }
  }
  r.voters = vm | ovm;
  r.match = m;
  return r;
}

// One launch over G groups at segment width S: the grid of kThreads blocks.
template <int S>
inline dim3 grid_for(int G) {
  const long long threads = static_cast<long long>(G) * S;
  return dim3(static_cast<unsigned>((threads + kThreads - 1) / kThreads));
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
