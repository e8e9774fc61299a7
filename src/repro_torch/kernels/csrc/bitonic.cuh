// The bitonic compare-exchange network shared by the window-sort (K4),
// ordering-unit (K5) and chain-select (K6) kernels, in shared memory for a
// block, and in registers for a row one or two warps hold (warp_bitonic:
// K4's and K5's rows of 32 to 1,024).
//
// It is the network of repro/kernels/bitonic_sort.py (_compare_exchange),
// stage for stage: in stage (k, j), lane i pairs with lane i ^ 2^j, and the
// pair sorts in output order when ((i >> (k+1)) & 1) == 0, in reverse order
// otherwise. The lower lane takes the other's element only on a strict
// comparison, so equal elements never move and the result is bit-identical
// to the reference's on ties (a bitonic network is not stable).
//
// The segments live in shared memory: `rows` consecutive segments of width
// w (a power of two), one key array and up to two int32 payload arrays
// riding the same swaps. One thread handles one compare-exchange pair per
// pass (a block-stride loop covers rows * w / 2 pairs), with one
// __syncthreads() between substages.
#pragma once

#include <climits>

// Output order of the window sort and the ordering unit: key descending.
struct KeyDesc {
    __device__ __forceinline__ bool operator()(int ka, int, int kb,
                                               int) const {
        return ka > kb;
    }
};

// Output order of the chain select: (key, lane index) ascending - a stable
// ascending sort of the key, whatever ties the keys hold.
struct KeyIdxAsc {
    __device__ __forceinline__ bool operator()(int ka, int ia, int kb,
                                               int ib) const {
        return ka < kb || (ka == kb && ia < ib);
    }
};

__host__ __device__ inline int ilog2(int x) {
    int r = 0;
    while ((1 << (r + 1)) <= x) ++r;
    return r;
}

// `before(ka, pa, kb, pb)`: element a must precede element b in the output
// (pa, pb: the first payload, when there is one).
template <int NP, class Before>
__device__ void bitonic_network(int* key, int* p0, int* p1, int w, int rows,
                                Before before) {
    const int half = w >> 1;
    if (half == 0) return;
    const int lh = ilog2(half);
    const int pairs = rows * half;
    for (int k = 0; (2 << k) <= w; ++k) {
        for (int j = k; j >= 0; --j) {
            const int s = 1 << j;
            for (int p = threadIdx.x; p < pairs; p += blockDim.x) {
                const int q = p & (half - 1);
                const int i = ((q >> j) << (j + 1)) | (q & (s - 1));
                const int lo = ((p >> lh) * w) + i;
                const int hi = lo + s;
                const bool fwd = ((i >> (k + 1)) & 1) == 0;
                const int ka = key[lo], kb = key[hi];
                const int pa = NP > 0 ? p0[lo] : 0;
                const int pb = NP > 0 ? p0[hi] : 0;
                const bool swap = fwd ? before(kb, pb, ka, pa)
                                      : before(ka, pa, kb, pb);
                if (swap) {
                    key[lo] = kb;
                    key[hi] = ka;
                    if (NP > 0) {
                        p0[lo] = pb;
                        p0[hi] = pa;
                    }
                    if (NP > 1) {
                        const int t = p1[lo];
                        p1[lo] = p1[hi];
                        p1[hi] = t;
                    }
                }
            }
            __syncthreads();
        }
    }
}

// The same network over one row of W = 32 E G elements held in registers
// by G = 2^LG warps (W <= 1,024 at E <= 32): element i = (part 32 + lane) E
// + r is key[r] of lane `lane` of the row's warp `part` (E a power of two,
// so every register index is a compile-time constant), and pay[p][r] its NP
// payloads (NP = 0 to 2; with NP = 0 the one-row array is a placeholder):
// order_unit.cu takes NP = 0 (its packed word), bitonic_sort.cu NP = 0 or
// 1 (the int32 key, the element's index) on one warp or two,
// tools/k5_probe.py NP = 1 and 2 on one.
// Substage (k, j) pairs element i with i ^ 2^j:
//  * 2^j < E: two registers of one thread;
//  * E <= 2^j < 32 E: lane l with lane l ^ (2^j / E), same register, the
//    words exchanged by __shfl_xor_sync;
//  * 2^j >= 32 E (G > 1): warp `part` with warp part ^ (2^j / 32 E), same
//    lane and register, the words exchanged through the row's `xbuf` ((1 +
//    NP) W words of shared memory: the keys, then each payload) between
//    two waits at the row's named barrier `bar` (1 to 15, for its 32 G
//    threads).
// Across threads both partners reach the same decision: the pair's
// direction from bit k+1 of i, the lower element taking the other only on a
// strict `before`. With G = 1 there is no barrier: the warp is the row.
//
// before(a, b): key word a must precede key word b in the output.
// Before::kFlip: a mask that reverses `before` - before(a ^ kFlip, b ^
// kFlip) == before(b, a) - so a comparison whose direction is known only
// at run time (it depends on the lane) is one `before` on words XORed with
// 0 or kFlip, not two comparisons and a select.
template <int E, int NP, int LG, class Before>
__device__ __forceinline__ void warp_bitonic(
    unsigned (&key)[E], unsigned (&pay)[NP > 0 ? NP : 1][E], int lane,
    Before before, int part = 0, unsigned* xbuf = nullptr, int bar = 0) {
    constexpr unsigned kFullMask = 0xffffffffu;
    constexpr int LE = E == 1 ? 0 : E == 2 ? 1 : E == 4 ? 2 : E == 8 ? 3
                     : E == 16 ? 4 : 5;               // log2(E)
    constexpr int LT = LE + 5;                        // log2(32 E)
    constexpr int LW = LT + LG;                       // log2(W)
    constexpr int W = 1 << LW;
    static_assert((1 << LE) == E, "E must be a power of two <= 32");
    // Bit b >= LE of element i: the lane's below LT, the part's above.
    auto high_bit = [&](int b) {
        return b < LT ? (lane >> (b - LE)) & 1 : (part >> (b - LT)) & 1;
    };
#pragma unroll
    for (int k = 0; k < LW; ++k) {
#pragma unroll
        for (int j = k; j >= 0; --j) {
            if (j < LE) {           // inside the thread: r against r | 2^j
                // In the output order (fwd) the pair swaps on before(b, a).
                const unsigned flip =
                    k + 1 < LE || high_bit(k + 1) == 0 ? Before::kFlip : 0u;
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    if (r & (1 << j)) continue;
                    const int q = r | (1 << j);
                    const unsigned a = key[r], b = key[q];
                    bool swap;
                    if (k + 1 < LE) {
                        swap = ((r >> (k + 1)) & 1) == 0 ? before(b, a)
                                                         : before(a, b);
                    } else {
                        swap = before(a ^ flip, b ^ flip);
                    }
                    key[r] = swap ? b : a;
                    key[q] = swap ? a : b;
#pragma unroll
                    for (int p = 0; p < NP; ++p) {
                        const unsigned u = pay[p][r], v = pay[p][q];
                        pay[p][r] = swap ? v : u;
                        pay[p][q] = swap ? u : v;
                    }
                }
                continue;
            }
            // Across threads. lo holds a, its partner b: lo takes b on (fwd
            // ? before(b, a) : before(a, b)); hi takes a on the same
            // condition, so each takes its partner's word on before(other,
            // mine) when fwd == lo, else on before(mine, other).
            const bool lo = high_bit(j) == 0;
            const bool fwd = k + 1 >= LW || high_bit(k + 1) == 0;
            const unsigned flip = fwd == lo ? Before::kFlip : 0u;
            if (j < LT) {           // across lanes: l against l ^ 2^(j-LE)
                const int m = 1 << (j - LE);
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    const unsigned mine = key[r];
                    const unsigned other = __shfl_xor_sync(kFullMask, mine, m);
                    const bool take = before(mine ^ flip, other ^ flip);
                    key[r] = take ? other : mine;
#pragma unroll
                    for (int p = 0; p < NP; ++p) {
                        const unsigned po =
                            __shfl_xor_sync(kFullMask, pay[p][r], m);
                        pay[p][r] = take ? po : pay[p][r];
                    }
                }
            } else {                // across warps: part ^ 2^(j-LT)
                // A warp's E words a lane at xbuf[part 32 E + r 32 + lane]
                // (payload p W words further on): no bank conflicts either
                // way.
                unsigned* own = xbuf + part * 32 * E + lane;
                const unsigned* theirs =
                    xbuf + (part ^ (1 << (j - LT))) * 32 * E + lane;
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    own[r * 32] = key[r];
#pragma unroll
                    for (int p = 0; p < NP; ++p)
                        own[(p + 1) * W + r * 32] = pay[p][r];
                }
                asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 << LG)
                             : "memory");
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    const unsigned mine = key[r], other = theirs[r * 32];
                    const bool take = before(mine ^ flip, other ^ flip);
                    key[r] = take ? other : mine;
#pragma unroll
                    for (int p = 0; p < NP; ++p)
                        pay[p][r] = take ? theirs[(p + 1) * W + r * 32]
                                         : pay[p][r];
                }
                asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 << LG)
                             : "memory");
            }
        }
    }
}

// Lane l's E adjacent words, in 16-byte loads and stores where E >= 4 (the
// run's address 16-byte aligned).
template <int E>
__device__ __forceinline__ void load_run(const unsigned* p, unsigned (&v)[E]) {
    if constexpr (E >= 4) {
#pragma unroll
        for (int c = 0; c < E / 4; ++c) {
            const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + c);
            v[4 * c] = q.x;
            v[4 * c + 1] = q.y;
            v[4 * c + 2] = q.z;
            v[4 * c + 3] = q.w;
        }
    } else if constexpr (E == 2) {
        const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
        v[0] = q.x;
        v[1] = q.y;
    } else {
        v[0] = __ldg(p);
    }
}

template <int E>
__device__ __forceinline__ void store_run(unsigned* p,
                                          const unsigned (&v)[E]) {
    if constexpr (E >= 4) {
#pragma unroll
        for (int c = 0; c < E / 4; ++c)
            reinterpret_cast<uint4*>(p)[c] =
                make_uint4(v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]);
    } else if constexpr (E == 2) {
        *reinterpret_cast<uint2*>(p) = make_uint2(v[0], v[1]);
    } else {
        p[0] = v[0];
    }
}

// Launch geometry shared by the three kernels: whole segments per block,
// at least 2048 elements a block where segments are short, one thread per
// compare-exchange pair up to 1024.
struct SegmentLaunch {
    int rows_per_block;
    int threads;
    long long blocks;
};

inline SegmentLaunch segment_launch(long long rows, int w) {
    SegmentLaunch g;
    g.rows_per_block = w >= 2048 ? 1 : 2048 / w;
    if (g.rows_per_block > rows) g.rows_per_block = (int)rows;
    if (g.rows_per_block < 1) g.rows_per_block = 1;
    long long pairs = (long long)g.rows_per_block * (w / 2);
    int t = pairs >= 1024 ? 1024 : (int)pairs;
    t = (t + 31) / 32 * 32;
    g.threads = t < 32 ? 32 : t;
    g.blocks = (rows + g.rows_per_block - 1) / g.rows_per_block;
    return g;
}
