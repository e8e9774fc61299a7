// Bit transitions of an (F, L) word stream: the count at each flit boundary
// and the stream's total, in one launch; and, for the no-NoC recorder, the
// total with the two popcount sums of the paper's Eq. 3 in one launch.
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
// The total: each block adds its sum to an accumulator in a workspace,
// then draws a ticket; the block that draws the last one reads the
// accumulator out and resets the workspace, so it is zero again for the
// next launch (the wrapper zeroes it once, when it allocates it, and keeps
// one a stream). The total's sums are unsigned 32-bit: it wraps as the
// reference's int32 sum does.
//
// bt_measure (the second entry point) is what one no-NoC measure takes:
// bt_flat's walk, whose accumulator (Acc<3>) also sums, over the same
// (F-1) L word pairs (a, b) = (w[i][j], w[i+1][j]), S1 = sum(x + y) and
// S2 = sum(x y) with x = popcount(a) and y = popcount(b), from which the
// host forms the expected BT of Eq. 3, S1 - 2 S2 / b. It replaces, besides
// the Pallas kernel above, the reference's popcount_words_pallas
// (repro/kernels/popcount.py) on that path: there the counts were an (F, L)
// array in device memory, and Eq. 2's float arithmetic and a sum ran
// behind it. Here the two counts of a pair are two more __popc on words
// already in registers, and a multiply-add: still far below the bytes. S2
// reaches 1,024 a pair, past 2^32 at 2^22 pairs, so S1 and S2 meet in two
// 64-bit words of the same workspace, read out and re-armed by the last
// block with the total.
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

// A thread's sums: N = 1, the BT alone; N = 3, the BT, S1 and S2.
template <int N>
struct Acc {
    unsigned v[N];
};

__device__ __forceinline__ void add_pair(Acc<1>& s, unsigned a, unsigned b) {
    s.v[0] += __popc(a ^ b);
}
__device__ __forceinline__ void add_pair(Acc<3>& s, unsigned a, unsigned b) {
    const unsigned x = __popc(a), y = __popc(b);
    s.v[0] += __popc(a ^ b);
    s.v[1] += x + y;
    s.v[2] += x * y;
}
template <int N>
__device__ __forceinline__ void add_chunk(Acc<N>& s, unsigned a, unsigned b) {
    add_pair(s, a, b);
}
template <int N>
__device__ __forceinline__ void add_chunk(Acc<N>& s, uint2 a, uint2 b) {
    add_pair(s, a.x, b.x);
    add_pair(s, a.y, b.y);
}
template <int N>
__device__ __forceinline__ void add_chunk(Acc<N>& s, uint4 a, uint4 b) {
    add_pair(s, a.x, b.x);
    add_pair(s, a.y, b.y);
    add_pair(s, a.z, b.z);
    add_pair(s, a.w, b.w);
}

// Adds chunk c to s: words c V .. c V + V - 1 against those L further.
template <int V, int N>
__device__ __forceinline__ void chunk_add(Acc<N>& s,
                                          const unsigned* __restrict__ w,
                                          long long c, int L) {
    using T = typename Chunk<V>::T;
    const unsigned* a = w + c * V;
    add_chunk(s, __ldg(reinterpret_cast<const T*>(a)),
              __ldg(reinterpret_cast<const T*>(a + L)));
}

// Transitions of chunk c.
template <int V>
__device__ __forceinline__ unsigned chunk_bt(const unsigned* __restrict__ w,
                                             long long c, int L) {
    Acc<1> s{{0u}};
    chunk_add<V>(s, w, c, L);
    return s.v[0];
}

// Adds this block's sums (`part`, one a thread) to the stream's; the block
// that finishes last writes them out and re-arms the workspace. Every
// thread calls it. A warp's sums stay below 2^32 (at most kMaxRounds chunks
// of 4 pairs a thread, 1,024 a pair in S2: 2^21); the block's S1 and S2 are
// 64-bit. work: [tickets, total, S1 lo, S1 hi, S2 lo, S2 hi] (S1 and S2
// with N = 3 only, then 8-byte aligned). out: the total as int32 (N = 1),
// or [total as int32, S1, S2] as int64 (N = 3).
template <int N, class Out>
__device__ void add_total(const Acc<N>& part, unsigned* work, Out* out) {
    static_assert(N == 1 || N == 3, "the total, or the total, S1 and S2");
    __shared__ unsigned long long warp_sum[N][kThreads / 32];
    const int wid = threadIdx.x >> 5;
#pragma unroll
    for (int k = 0; k < N; ++k) {
        const unsigned v = __reduce_add_sync(kFull, part.v[k]);
        if ((threadIdx.x & 31) == 0) warp_sum[k][wid] = v;
    }
    __syncthreads();
    if (threadIdx.x != 0) return;
    unsigned long long t[N] = {};
    for (int i = 0; i < (int)(blockDim.x >> 5); ++i)
        for (int k = 0; k < N; ++k) t[k] += warp_sum[k][i];
    unsigned long long* wide = reinterpret_cast<unsigned long long*>(work + 2);
    atomicAdd(&work[1], (unsigned)t[0]);
    if constexpr (N == 3) {
        atomicAdd(&wide[0], t[1]);
        atomicAdd(&wide[1], t[2]);
    }
    __threadfence();
    if (atomicAdd(&work[0], 1u) != gridDim.x - 1) return;
    __threadfence();
    out[0] = (Out)(int)atomicExch(&work[1], 0u);
    if constexpr (N == 3) {
        out[1] = (Out)atomicExch(&wide[0], 0ull);
        out[2] = (Out)atomicExch(&wide[1], 0ull);
    }
    atomicExch(&work[0], 0u);
}

// The total (N = 1) or the measure sums (N = 3) alone: block b sums chunks
// [b per_block, (b + 1) per_block).
template <int V, int N, class Out>
__global__ void __launch_bounds__(kThreads)
bt_flat(const unsigned* __restrict__ w, Out* out, unsigned* work,
        long long chunks, int L, int per_block) {
    const long long c0 = (long long)blockIdx.x * per_block;
    const long long c1 = min(c0 + per_block, chunks);
    const int step = blockDim.x;
    Acc<N> s{};
    long long c = c0 + threadIdx.x;
    for (; c + 3 * step < c1; c += 4 * step) {   // four loads in flight
        chunk_add<V>(s, w, c, L);
        chunk_add<V>(s, w, c + step, L);
        chunk_add<V>(s, w, c + 2 * step, L);
        chunk_add<V>(s, w, c + 3 * step, L);
    }
    for (; c < c1; c += step) chunk_add<V>(s, w, c, L);
    add_total(s, work, out);
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
    if (total) add_total(Acc<1>{{acc}}, work, total);
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
    if (total) add_total(Acc<1>{{acc}}, work, total);
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

// The total or the measure sums alone, one wave of blocks.
template <int V, int N, class Out>
int launch_flat(const unsigned* w, Out* out, unsigned* work, long long nb,
                int L, cudaStream_t s) {
    const long long chunks = nb > 0 ? nb * (L / V) : 0;
    const int per_block = kThreads * rounds(chunks);
    const long long blocks = chunks ? (chunks + per_block - 1) / per_block
                                    : 1;
    bt_flat<V, N><<<(unsigned)blocks, kThreads, 0, s>>>(w, out, work,
                                                        chunks, L, per_block);
    return (int)cudaGetLastError();
}

template <int V>
int launch(const unsigned* w, int* counts, int* total, unsigned* work,
           long long nb, int L, cudaStream_t s) {
    const long long chunks = nb > 0 ? nb * (L / V) : 0;
    if (counts == nullptr) {
        return launch_flat<V, 1>(w, total, work, nb, L, s);
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

// out: three int64 - the BT total (as the int32 sum wraps), S1 = sum(x + y)
// and S2 = sum(x y) over the (F-1) L word pairs; work: six zeroed words,
// 8-byte aligned (re-armed by the launch). One launch at any F (F <= 1:
// zeros).
extern "C" int bt_measure(const void* words, void* out, void* work,
                          long long F, int L, void* stream) {
    const long long nb = F > 1 && L > 0 ? F - 1 : 0;
    const uintptr_t p = reinterpret_cast<uintptr_t>(words);
    const unsigned* w = static_cast<const unsigned*>(words);
    long long* o = static_cast<long long*>(out);
    unsigned* k = static_cast<unsigned*>(work);
    cudaStream_t s = (cudaStream_t)stream;
    if (reinterpret_cast<uintptr_t>(work) % 8 != 0)
        return (int)cudaErrorInvalidValue;
    if (L > 0 && L % 4 == 0 && p % 16 == 0)
        return launch_flat<4, 3>(w, o, k, nb, L, s);
    if (L > 0 && L % 2 == 0 && p % 8 == 0)
        return launch_flat<2, 3>(w, o, k, nb, L, s);
    return launch_flat<1, 3>(w, o, k, nb, L, s);
}
