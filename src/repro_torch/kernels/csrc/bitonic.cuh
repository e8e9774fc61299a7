// The bitonic compare-exchange network shared by the window-sort (K4),
// ordering-unit (K5) and chain-select (K6) kernels.
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
