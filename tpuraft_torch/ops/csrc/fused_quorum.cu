// Fused quorum reduction of the raft tick, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   tpuraft/ops/quorum_pallas.py::_fused_quorum_pallas (pl.pallas_call),
//   body _fused_quorum_kernel, helpers _qth_largest and _vote_quorum.
//
// For each raft group g (one row of the [G, P] state planes) it computes,
// joint-consensus aware (a row is joint when any old-config voter is set):
//   quorum_idx[g]  q-th largest voter match, q = n_voters / 2 + 1,
//                  -2^30 for a row without voters; joint: min of both configs
//   elected[g]     granted voters >= q; joint: in both configs
//   q_ack[g]       the same order statistic over last_ack
//
// Design: the warp-segmented core of quorum_core.cuh.  Each group owns a
// segment of S = next_pow2(P) lanes, one lane per peer slot, so every load
// is a scalar load by neighbouring lanes of neighbouring addresses; the
// masks are segment ballots and the order statistic costs O(P) shuffles
// per lane.  S is the only template parameter (6 instantiations); P is a
// runtime argument.  Lane 0 of each segment writes the group's results.
// The kernel allocates nothing and does not synchronise; the wrapper
// (tpuraft_torch/ops/quorum_cuda.py) allocates the outputs and launches on
// PyTorch's current stream.  The same core is the first stage of the fused
// tick (fused_tick.cu), which is what the engine launches.
//
// Bound on an H100 SXM: the work is memory-bound.  It reads 2 int32 and
// 3 bool planes (11 * G * P bytes) and writes 2 int32 and 1 bool rows
// (9 * G bytes): 1.59 MB at G = 16,384, P = 8, about 0.47 us at 3.35 TB/s.
// At these sizes one launch's fixed cost dominates.

#include "quorum_core.cuh"

namespace {

using namespace tpuraft;

template <int S>
__global__ void __launch_bounds__(kThreads) fused_quorum_kernel(
    const int32_t* __restrict__ match, const uint8_t* __restrict__ granted,
    const int32_t* __restrict__ last_ack,
    const uint8_t* __restrict__ voter_mask,
    const uint8_t* __restrict__ old_voter_mask, int32_t* __restrict__ qidx,
    uint8_t* __restrict__ elected, int32_t* __restrict__ qack, int G,
    int P) {
  const Lane<S> ln(G, P);
  const Quorum q = quorum_stage<S>(ln, P, match, granted, last_ack,
                                   voter_mask, old_voter_mask);
  if (ln.k == 0 && ln.g < G) {
    qidx[ln.g] = q.quorum_idx;
    qack[ln.g] = q.q_ack;
    elected[ln.g] = q.elected ? 1 : 0;
  }
}

}  // namespace

extern "C" int tpuraft_fused_quorum_max_peers() { return kMaxPeers; }

// Returns cudaSuccess (0) or the launch error; G == 0 launches nothing.
extern "C" cudaError_t tpuraft_fused_quorum(
    const int32_t* match, const uint8_t* granted, const int32_t* last_ack,
    const uint8_t* voter_mask, const uint8_t* old_voter_mask, int32_t* qidx,
    uint8_t* elected, int32_t* qack, int G, int P, cudaStream_t stream) {
  if (G < 0 || P < 1 || P > kMaxPeers) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  return with_segment(P, [&](auto seg) {
    constexpr int S = decltype(seg)::value;
    fused_quorum_kernel<S><<<grid_for<S>(G), kThreads, 0, stream>>>(
        match, granted, last_ack, voter_mask, old_voter_mask, qidx, elected,
        qack, G, P);
    return cudaGetLastError();
  });
}
