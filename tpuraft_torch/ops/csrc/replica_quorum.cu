// Replica-axis quorum for Hopper (sm_90a): the commit point and the vote
// count of every raft group from the [R, G] planes of the replica plane
// (tpuraft_torch/parallel/replica_plane.py), in one launch.
//
// Replaces the XLA program of the JAX package's replicated_tick
// (tpuraft/parallel/collective.py: replica_commit_point's all_gather, sort
// and pick, replica_vote_count's psum), on one device.
//
// commit[g] is the q-th largest of rel[0..R-1, g], q = R / 2 + 1, equal bit
// for bit to the sort oracle np.sort(rel, 0)[::-1][q - 1], INT32_MIN and
// INT32_MAX included; votes[g] counts the nonzero granted[r, g].
//
// Bound: bytes, R * G * 5 read and G * 8 written (0.11 us at R = 3,
// G = 16,384 on an H100's 3.35 TB/s).  At the plane's shapes the launch
// itself, about a microsecond, and one round of memory latency are most
// of the time, so the design keeps the work after the loads short and
// spread over many SMs:
//
// - One warp segment of S lanes a group (quorum_core.cuh's Lane<S>), S the
//   next power of two >= R, up to 32: lane r loads rel[r * G + g] and
//   granted[r * G + g] once, so a warp holds 32 / S groups and each row's
//   part of it is one contiguous run.  Every load is issued before the
//   first shuffle: one memory round.
// - Commit: segment_kth_largest, a rank count over S shuffles a lane
//   (O(R) a lane where one thread a group made O(R^2) dependent compares);
//   dead lanes hold INT32_MIN, which q <= R keeps out of the result.
// - Votes: the popcount of the segment's ballot of granted != 0.
// - 32 < R <= 64: a 32-lane segment, two replicas a lane (rows k, k + 32).
// - R > 64 (no raft deployment runs it; the wrapper accepts it): one
//   thread a group, counting over the column read from global memory.
//
// The layout is picked by R alone, here in the launcher.  Lane 0 of a
// segment stores both results.  Lane<S> numbers a launch's lanes with an
// int, so the grid's rows (blockIdx.y) take kChunkGroups groups each: one
// row below 2^30 lanes, a few rows past it (R * G < 2^31 keeps G * S below
// 2^32).

#include "quorum_core.cuh"

namespace {

using namespace tpuraft;

constexpr int kChunkLanes = 1 << 30;

template <int S, int V>
__global__ void __launch_bounds__(kThreads)
    replica_quorum_kernel(const int32_t* __restrict__ rel,
                          const uint8_t* __restrict__ granted,
                          int32_t* __restrict__ commit,
                          int32_t* __restrict__ votes, int R, int G, int q) {
  constexpr int kChunkGroups = kChunkLanes / S;
  const int base = blockIdx.y * kChunkGroups;
  const Lane<S> ln(min(G - base, kChunkGroups), R);
  const int g = base + ln.g;
  const size_t stride = static_cast<size_t>(G);
  int32_t v[V];
  bool gr[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const int r = ln.k + j * S;
    const bool live = g < G && r < R;
    const size_t off = static_cast<size_t>(r) * stride + g;
    v[j] = live ? __ldg(rel + off) : INT32_MIN;
    gr[j] = live && __ldg(granted + off) != 0;
  }
  int n = 0;
#pragma unroll
  for (int j = 0; j < V; ++j) n += __popc(ln.ballot(gr[j]));
  const int32_t c = segment_kth_largest<S, V>(v, q);
  if (ln.k == 0 && g < G) {
    commit[g] = c;
    votes[g] = n;
  }
}

// R > 64: one thread a group, the count over the column in global memory.
__global__ void __launch_bounds__(kThreads)
    replica_quorum_wide_kernel(const int32_t* __restrict__ rel,
                               const uint8_t* __restrict__ granted,
                               int32_t* __restrict__ commit,
                               int32_t* __restrict__ votes, int R, int G,
                               int q) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const size_t stride = static_cast<size_t>(G);
  int nv = 0;
  int32_t best = INT32_MIN;
  for (int j = 0; j < R; ++j) {
    nv += __ldg(granted + j * stride + g) != 0;
    const int32_t wj = __ldg(rel + j * stride + g);
    int c = 0;
    for (int k = 0; k < R; ++k) c += __ldg(rel + k * stride + g) >= wj;
    if (c >= q && wj > best) best = wj;
  }
  commit[g] = best;
  votes[g] = nv;
}

template <int S, int V>
cudaError_t launch(const int32_t* rel, const uint8_t* granted, int32_t* commit,
                   int32_t* votes, int R, int G, int q, cudaStream_t stream) {
  constexpr int kChunkGroups = kChunkLanes / S;
  const dim3 grid(grid_for<S>(G < kChunkGroups ? G : kChunkGroups).x,
                  G / kChunkGroups + (G % kChunkGroups != 0));
  replica_quorum_kernel<S, V><<<grid, kThreads, 0, stream>>>(
      rel, granted, commit, votes, R, G, q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tpuraft_replica_quorum(const int32_t* rel,
                                      const uint8_t* granted, int32_t* commit,
                                      int32_t* votes, int R, int G,
                                      cudaStream_t stream) {
  if (R < 1 || G < 0) return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  const int q = R / 2 + 1;
  if (R <= kMaxPeers)
    return with_segment(R, [&](auto seg) {
      constexpr int S = decltype(seg)::value;
      return launch<S, 1>(rel, granted, commit, votes, R, G, q, stream);
    });
  if (R <= 2 * kMaxPeers)
    return launch<32, 2>(rel, granted, commit, votes, R, G, q, stream);
  const int blocks = (G + kThreads - 1) / kThreads;
  replica_quorum_wide_kernel<<<blocks, kThreads, 0, stream>>>(
      rel, granted, commit, votes, R, G, q);
  return cudaGetLastError();
}
