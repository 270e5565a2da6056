// Replica-axis quorum for Hopper (sm_90a): the commit point and the vote
// count of every raft group from the [R, G] planes of the replica plane
// (tpuraft_torch/parallel/replica_plane.py), in one launch.
//
// Layout: one thread per group.  The planes are replica-major, as the plane
// holds them: row r is replica r's view of all G groups, contiguous, so for
// each r the threads of a warp read 32 neighbouring words (coalesced).
//
// commit[g] is the q-th largest of rel[0..R-1, g], q = R / 2 + 1, equal bit
// for bit to the sort oracle np.sort(rel, 0)[::-1][q - 1]: rank counting
// finds it without a sort, as quorum_core.cuh does across the lanes of a
// warp segment -- the q-th largest of a multiset w is
// max{ w_j : #{k : w_k >= w_j} >= q }.  votes[g] counts the nonzero
// granted[r, g] in the same pass.  Each thread does O(R^2) comparisons.
//
// For R <= 64 the column sits in a register array sized by an R bucket
// (every index is a compile-time constant after unrolling); larger R reads
// the column from global memory in the count loop instead.
//
// Bound: bytes, R * G * 5 read and G * 8 written (0.11 us at R=3,
// G=16,384 on an H100's 3.35 TB/s); at the plane's shapes the launch
// itself, about a microsecond, is most of the time.
//
// Replaces the XLA program of the JAX package's replicated_tick
// (tpuraft/parallel/collective.py: replica_commit_point's all_gather, sort
// and pick, replica_vote_count's psum), on one device.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int RMAX>
__global__ void __launch_bounds__(kThreads)
    replica_quorum_kernel(const int32_t* __restrict__ rel,
                          const uint8_t* __restrict__ granted,
                          int32_t* __restrict__ commit,
                          int32_t* __restrict__ votes, int R, int G, int q) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= G) return;
  const size_t stride = static_cast<size_t>(G);
  int32_t w[RMAX];
  int nv = 0;
  // every loop is unrolled over the bucket, so w[] stays in registers,
  // and leaves at R, so a thread does R^2 comparisons, not RMAX^2
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    w[r] = __ldg(rel + r * stride + g);
    nv += __ldg(granted + r * stride + g) != 0;
  }
  int32_t best = INT32_MIN;
#pragma unroll
  for (int j = 0; j < RMAX; ++j) {
    if (j >= R) break;
    int c = 0;
#pragma unroll
    for (int k = 0; k < RMAX; ++k) {
      if (k >= R) break;
      c += w[k] >= w[j];
    }
    if (c >= q && w[j] > best) best = w[j];
  }
  commit[g] = best;
  votes[g] = nv;
}

// R > 64: the same count, with the column read from global memory.
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

template <int RMAX>
cudaError_t launch(const int32_t* rel, const uint8_t* granted, int32_t* commit,
                   int32_t* votes, int R, int G, int q, cudaStream_t stream) {
  const int blocks = (G + kThreads - 1) / kThreads;
  replica_quorum_kernel<RMAX><<<blocks, kThreads, 0, stream>>>(
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
  if (R <= 1) return launch<1>(rel, granted, commit, votes, R, G, q, stream);
  if (R <= 2) return launch<2>(rel, granted, commit, votes, R, G, q, stream);
  if (R <= 4) return launch<4>(rel, granted, commit, votes, R, G, q, stream);
  if (R <= 8) return launch<8>(rel, granted, commit, votes, R, G, q, stream);
  if (R <= 16) return launch<16>(rel, granted, commit, votes, R, G, q, stream);
  if (R <= 32) return launch<32>(rel, granted, commit, votes, R, G, q, stream);
  if (R <= 64) return launch<64>(rel, granted, commit, votes, R, G, q, stream);
  const int blocks = (G + kThreads - 1) / kThreads;
  replica_quorum_wide_kernel<<<blocks, kThreads, 0, stream>>>(
      rel, granted, commit, votes, R, G, q);
  return cudaGetLastError();
}
