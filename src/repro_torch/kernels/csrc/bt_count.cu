// Bit transitions of an (F, L) word stream: the count at each flit boundary
// and the stream's total, in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/bt_count.py
// (bt_boundaries_pallas): counts[i] = sum_j popcount(w[i][j] ^ w[i+1][j]),
// the paper's Fig. 8 BT recorder over a materialised stream. On the TPU the
// total was a jnp.sum that XLA fused behind the kernel; in eager PyTorch it
// was a second launch, and the caller's read of it a sync of its own. Here
// one launch writes the counts, the int32 total, or both.
//
// Bound: bytes - each word read once from device memory (row i+1's second
// read, L words further on, comes from L1/L2), 4 bytes a boundary written;
// one XOR, one __popc and one add a word.
//
// Design. Boundary i pairs w[i L + j] with w[i L + j + L], so the work is
// one flat stream over (F-1) L words, each against the word L further on.
// Threads walk it in chunks of V words (16-byte loads when L % 4 == 0 and
// the base is aligned), consecutive threads on consecutive chunks, so all
// 32 lanes of a warp work at any L:
//  * the total alone (bt_flat): a block takes a fixed run of chunks;
//  * the counts for L <= 32 (bt_segments): a block takes whole boundaries,
//    a boundary's C = L / V chunks sit on adjacent lanes, and a segmented
//    warp scan (a lane adds the lane d below it while that lane holds the
//    same boundary) leaves each boundary's sum - or its share in this warp -
//    in its last lane, which adds it to the boundary's slot in shared
//    memory;
//  * the counts for wider rows (bt_rows): a warp loops over one boundary.
// The total: each block adds its sum to an accumulator in a two-word
// workspace, then draws a ticket; the block that draws the last one reads
// the accumulator out and resets both words, so the workspace is zero again
// for the next launch (the wrapper zeroes it once, when it allocates it, and
// keeps one a stream). Sums are unsigned 32-bit: the total wraps as the
// reference's int32 sum does.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;    // 2,048 threads an SM at 256 a block
constexpr int kMaxRounds = 16;

template <int V> struct Chunk;
template <> struct Chunk<1> { using T = unsigned; };
template <> struct Chunk<2> { using T = uint2; };
template <> struct Chunk<4> { using T = uint4; };

__device__ __forceinline__ unsigned popc_xor(unsigned a, unsigned b) {
    return __popc(a ^ b);
}
__device__ __forceinline__ unsigned popc_xor(uint2 a, uint2 b) {
    return __popc(a.x ^ b.x) + __popc(a.y ^ b.y);
}
__device__ __forceinline__ unsigned popc_xor(uint4 a, uint4 b) {
    return __popc(a.x ^ b.x) + __popc(a.y ^ b.y) + __popc(a.z ^ b.z) +
           __popc(a.w ^ b.w);
}

// Transitions of chunk c: words c V .. c V + V - 1 against those L further.
template <int V>
__device__ __forceinline__ unsigned chunk_bt(const unsigned* __restrict__ w,
                                             long long c, int L) {
    using T = typename Chunk<V>::T;
    const unsigned* a = w + c * V;
    return popc_xor(__ldg(reinterpret_cast<const T*>(a)),
                    __ldg(reinterpret_cast<const T*>(a + L)));
}

// Adds this block's share (`part`, one a thread) to the stream's total; the
// block that finishes last writes the total and re-arms the workspace
// (work[0]: tickets drawn, work[1]: the running sum). Every thread calls it.
__device__ void add_total(unsigned part, unsigned* work, int* total) {
    __shared__ unsigned warp_sum[kThreads / 32];
    part = __reduce_add_sync(kFull, part);
    if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = part;
    __syncthreads();
    if (threadIdx.x != 0) return;
    unsigned s = 0;
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i) s += warp_sum[i];
    atomicAdd(&work[1], s);
    __threadfence();
    if (atomicAdd(&work[0], 1u) != gridDim.x - 1) return;
    __threadfence();
    *total = (int)atomicExch(&work[1], 0u);
    atomicExch(&work[0], 0u);
}

// The total alone: block b sums chunks [b per_block, (b + 1) per_block).
template <int V>
__global__ void __launch_bounds__(kThreads)
bt_flat(const unsigned* __restrict__ w, int* total, unsigned* work,
        long long chunks, int L, int per_block) {
    const long long c0 = (long long)blockIdx.x * per_block;
    const long long c1 = min(c0 + per_block, chunks);
    const int step = blockDim.x;
    unsigned acc = 0;
    long long c = c0 + threadIdx.x;
    for (; c + 3 * step < c1; c += 4 * step) {   // four loads in flight
        const unsigned a = chunk_bt<V>(w, c, L);
        const unsigned b = chunk_bt<V>(w, c + step, L);
        const unsigned d = chunk_bt<V>(w, c + 2 * step, L);
        const unsigned e = chunk_bt<V>(w, c + 3 * step, L);
        acc += a + b + d + e;
    }
    for (; c < c1; c += step) acc += chunk_bt<V>(w, c, L);
    add_total(acc, work, total);
}

// Counts (and the total when `total` is set) for 1 <= L <= 32: block b
// owns boundaries [b S, b S + S); seg[s] sums its boundary s.
template <int V>
__global__ void __launch_bounds__(kThreads)
bt_segments(const unsigned* __restrict__ w, int* __restrict__ counts,
            int* total, unsigned* work, long long nb, int L, int S) {
    extern __shared__ unsigned seg[];
    const int C = L / V;
    const long long b0 = (long long)blockIdx.x * S;
    const int nseg = (int)min((long long)S, nb - b0);
    const int n = nseg * C;                   // this block's chunks
    const long long c0 = b0 * C;
    const int lane = threadIdx.x & 31;
    for (int s = threadIdx.x; s < nseg; s += blockDim.x) seg[s] = 0;
    __syncthreads();
    unsigned acc = 0;
    for (int base = 0; base < n; base += blockDim.x) {   // block-uniform
        const int c = base + threadIdx.x;
        const bool live = c < n;
        unsigned v = live ? chunk_bt<V>(w, c0 + c, L) : 0u;
        acc += v;
        const int pos = c % C;                // chunk's place in its boundary
        for (int d = 1; d < C; d <<= 1) {
            const unsigned u = __shfl_up_sync(kFull, v, d);
            if (lane >= d && d <= pos) v += u;
        }
        if (live && (pos == C - 1 || lane == 31)) atomicAdd(&seg[c / C], v);
    }
    __syncthreads();
    for (int s = threadIdx.x; s < nseg; s += blockDim.x)
        counts[b0 + s] = (int)seg[s];
    if (total) add_total(acc, work, total);
}

// Counts (and the total) for wide rows and L = 0: a warp a boundary.
template <int V>
__global__ void __launch_bounds__(kThreads)
bt_rows(const unsigned* __restrict__ w, int* __restrict__ counts, int* total,
        unsigned* work, long long nb, int L) {
    const long long i =
        (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
    const int lane = threadIdx.x & 31;
    unsigned acc = 0;
    if (i < nb) {                             // warp-uniform
        const int C = L / V;
        for (int j = lane; j < C; j += 32) acc += chunk_bt<V>(w, i * C + j, L);
        const unsigned s = __reduce_add_sync(kFull, acc);
        if (lane == 0) counts[i] = (int)s;
    }
    if (total) add_total(acc, work, total);
}

int sm_count() {
    static int n = 0;
    if (n == 0) {
        int dev = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                   dev) != cudaSuccess || n < 1)
            n = 132;
    }
    return n;
}

// Rounds of kThreads chunks a block, so that one wave of blocks covers
// the stream.
int rounds(long long chunks) {
    const long long wave = (long long)kThreads * kBlocksPerSm * sm_count();
    long long k = (chunks + wave - 1) / wave;
    return (int)(k < 1 ? 1 : k > kMaxRounds ? kMaxRounds : k);
}

template <int V>
int launch(const unsigned* w, int* counts, int* total, unsigned* work,
           long long nb, int L, cudaStream_t s) {
    const long long chunks = nb > 0 ? nb * (L / V) : 0;
    if (counts == nullptr) {
        const int per_block = kThreads * rounds(chunks);
        const long long blocks = chunks ? (chunks + per_block - 1) / per_block
                                        : 1;
        bt_flat<V><<<(unsigned)blocks, kThreads, 0, s>>>(w, total, work,
                                                         chunks, L, per_block);
    } else if (L >= 1 && L <= 32) {
        const int C = L / V;
        const int S = kThreads * rounds(chunks) / C;   // boundaries a block
        const long long blocks = (nb + S - 1) / S;
        bt_segments<V><<<(unsigned)blocks, kThreads, S * sizeof(unsigned),
                         s>>>(w, counts, total, work, nb, L, S);
    } else {
        const long long blocks = (nb + kThreads / 32 - 1) / (kThreads / 32);
        bt_rows<V><<<(unsigned)blocks, kThreads, 0, s>>>(w, counts, total,
                                                         work, nb, L);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// counts: (F-1,) int32 or null; total: one int32 or null (at least one
// set); work: two zeroed words (re-armed by the launch), used when total is
// set. Launches nothing when only the counts are asked for and F <= 1.
extern "C" int bt_count(const void* words, void* counts, void* total,
                        void* work, long long F, int L, void* stream) {
    const long long nb = F > 1 ? F - 1 : 0;
    if (counts != nullptr && nb == 0 && total == nullptr) return 0;
    if (counts == nullptr && total == nullptr) return (int)cudaErrorInvalidValue;
    if (nb == 0) counts = nullptr;            // nothing to count
    const uintptr_t p = reinterpret_cast<uintptr_t>(words);
    const unsigned* w = static_cast<const unsigned*>(words);
    int* c = static_cast<int*>(counts);
    int* t = static_cast<int*>(total);
    unsigned* k = static_cast<unsigned*>(work);
    cudaStream_t s = (cudaStream_t)stream;
    if (L > 0 && L % 4 == 0 && p % 16 == 0)
        return launch<4>(w, c, t, k, nb, L, s);
    if (L > 0 && L % 2 == 0 && p % 8 == 0)
        return launch<2>(w, c, t, k, nb, L, s);
    return launch<1>(w, c, t, k, nb, L, s);
}
