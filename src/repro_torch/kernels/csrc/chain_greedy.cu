// The whole greedy beam-lookahead O3 chain in one launch: for every window
// r of the partitioned (P, R, W) planes and every start s, the w - 1 chain
// steps from start[r, s] -> orders (R, S, W) and costs (R, S), int32.
//
// Replaces _greedy_from's lax.scan (repro/kernels/min_hamming.py:146-166,
// vmapped over starts and windows), whose distance + select body
// chain_select_pallas (:288) computes on a TPU. There the scan is one
// compiled loop; step by step from the host it was ~33 small launches a
// step. Here one block owns one window and one warp owns one start, and
// the warp runs every step of its chain without leaving the SM:
//
//  * the window's P planes are loaded into shared memory once (P * W
//    words: 1.2 KB for LeNet's 152-value windows, 125 KB at W = 16,000
//    with two planes); each warp keeps its visited set as a W-bit mask in
//    shared memory, and the zero region j >= z is computed, not stored;
//  * lane l handles candidates j = l, l + 32, ...: a step computes each
//    distance d_j = sum_p popc(q_p[j] ^ q_p[cur]) and takes the beam
//    smallest keys d_j * W + j + pen_j (pen: 2^30 visited, 2^28 zone) by
//    beam min-reductions over (key, j) pairs, each above the last pair
//    taken - the keys embed j, so they are distinct and this is the
//    reference's iterated argmin (and the plain version's stable sort);
//  * each beam candidate c gets its lookahead min d(c, j) over unvisited
//    live j != c (2^20, then 0, if there is none) and the score
//    (d_c + la) * 130W + d_c * W + c + pen_c; the first smallest score
//    wins, is marked visited and adds d_c to the cost;
//  * reductions are redux.sync on 32-bit words (a (key, j) pair is two:
//    the key, then j among the lanes holding that key); the step loop has
//    only __syncwarp(), no block barrier, and writes nothing to device
//    memory but the order column and, at the end, the cost.
//
// The distances are recomputed in every beam pass rather than kept: a lane
// would need ceil(W/32) of them in registers, up to 500 at W = 16,000.
// Keys and scores are 32-bit unsigned arithmetic that wraps as the plain
// int32 version does, compared as signed int32 (ROADMAP C5).
//
// Bound: per step and lane, the distance costs 2P + 3 integer operations,
// each beam pass 2, and each candidate's lookahead 2P + 3; bytes are the
// planes read once and the orders written once, so operations bound it
// (conv2 under O3a: 1,600 windows x 8 starts x 152 lanes x 151 steps,
// ~0.1 ms of operations against ~0.003 ms of bytes on an H100).
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kVisited = 1u << 30;
constexpr unsigned kZone = 1u << 28;
constexpr unsigned kInf = 1u << 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // starts a block (one warp each)

template <int NPL>
__device__ __forceinline__ unsigned dist(const int* __restrict__ sq, int w,
                                         int j, const int (&c)[NPL]) {
    unsigned d = __popc((unsigned)(sq[j] ^ c[0]));
    if (NPL > 1) d += __popc((unsigned)(sq[w + j] ^ c[1]));
    return d;
}

// Warp minimum of a (key, index) pair held as (key ^ sign bit) << 32 | j,
// so that unsigned order is signed-key order, then index order.
__device__ __forceinline__ unsigned long long warp_min_pair(
        unsigned long long v) {
    const unsigned hi = (unsigned)(v >> 32), lo = (unsigned)v;
    const unsigned hmin = __reduce_min_sync(kFull, hi);
    const unsigned lmin = __reduce_min_sync(kFull, hi == hmin ? lo : UINT_MAX);
    return ((unsigned long long)hmin << 32) | lmin;
}

template <int NPL>
__global__ void __launch_bounds__(kWarps * 32)
chain_greedy_kernel(const int* __restrict__ q, const int* __restrict__ z,
                    const int* __restrict__ start, int* __restrict__ orders,
                    int* __restrict__ costs, int R, int S, int w, int beam) {
    extern __shared__ int smem[];
    int* sq = smem;                                   // NPL planes of w words
    const int nwords = (w + 31) >> 5;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    unsigned* vis = (unsigned*)(sq + NPL * w) + warp * nwords;
    const int r = blockIdx.x;
    const int s = blockIdx.y * kWarps + warp;
    for (int e = threadIdx.x; e < NPL * w; e += blockDim.x) {
        const int p = e >= w;                         // NPL <= 2
        sq[e] = q[((long long)p * R + r) * w + (e - p * w)];
    }
    for (int t = lane; t < nwords; t += 32) vis[t] = 0u;
    __syncthreads();
    if (s >= S) return;

    const long long rs = (long long)r * S + s;
    int* ord = orders + rs * w;
    const int zr = z[r];
    const int live = zr < w ? zr : w;
    const unsigned uw = (unsigned)w, k1 = 130u * uw;
    int cur = start[rs];
    if (lane == 0) {
        vis[cur >> 5] |= 1u << (cur & 31);
        ord[0] = cur;
    }
    __syncwarp();
    unsigned cost = 0;
    for (int i = 1; i < w; ++i) {
        int qc[NPL];
        for (int p = 0; p < NPL; ++p) qc[p] = sq[p * w + cur];
        unsigned long long prev = 0;   // the last (key, j) pair taken
        int best = 0, nxt = 0;
        unsigned dnxt = 0;
        for (int b = 0; b < beam; ++b) {
            unsigned long long lmin = ~0ull;
            for (int j = lane, t = 0; j < w; j += 32, ++t) {
                const unsigned pen = ((vis[t] >> lane) & 1u ? kVisited : 0u)
                                     + (j >= zr ? kZone : 0u);
                const unsigned key =
                    dist<NPL>(sq, w, j, qc) * uw + (unsigned)j + pen;
                const unsigned long long pk =
                    ((unsigned long long)(key ^ 0x80000000u) << 32) | j;
                if ((b == 0 || pk > prev) && pk < lmin) lmin = pk;
            }
            prev = warp_min_pair(lmin);
            const int c = (int)(unsigned)prev;
            const unsigned dc = dist<NPL>(sq, w, c, qc);
            const unsigned penc =
                ((vis[c >> 5] >> (c & 31)) & 1u ? kVisited : 0u)
                + (c >= zr ? kZone : 0u);
            int qb[NPL];
            for (int p = 0; p < NPL; ++p) qb[p] = sq[p * w + c];
            unsigned la = kInf;
            for (int j = lane, t = 0; j < live; j += 32, ++t) {
                if (j != c && !((vis[t] >> lane) & 1u)) {
                    const unsigned d = dist<NPL>(sq, w, j, qb);
                    la = d < la ? d : la;
                }
            }
            la = __reduce_min_sync(kFull, la);
            if (la >= kInf) la = 0;
            const int score = (int)((dc + la) * k1 + dc * uw + (unsigned)c
                                    + penc);
            if (b == 0 || score < best) {
                best = score;
                nxt = c;
                dnxt = dc;
            }
        }
        cost += dnxt;
        cur = nxt;
        if (lane == (cur & 31)) vis[cur >> 5] |= 1u << lane;
        if (lane == 0) ord[i] = cur;
        __syncwarp();
    }
    if (lane == 0) costs[rs] = (int)cost;
}

template <int NPL>
int launch(const void* q, const void* z, const void* start, void* orders,
           void* costs, int R, int S, int w, int beam, cudaStream_t st) {
    const int warps = S < kWarps ? S : kWarps;
    const size_t smem = sizeof(int) * ((size_t)NPL * w
                                       + (size_t)warps * ((w + 31) / 32));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            chain_greedy_kernel<NPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)R, (unsigned)((S + kWarps - 1) / kWarps));
    chain_greedy_kernel<NPL><<<grid, warps * 32, smem, st>>>(
        (const int*)q, (const int*)z, (const int*)start, (int*)orders,
        (int*)costs, R, S, w, beam);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int chain_greedy(const void* q, const void* z, const void* start,
                            void* orders, void* costs, int n_planes, int R,
                            int S, int w, int beam, void* stream) {
    if (R <= 0 || S <= 0 || w <= 0) return 0;
    if (beam < 1 || beam > w) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (n_planes) {
        case 1: return launch<1>(q, z, start, orders, costs, R, S, w, beam, st);
        case 2: return launch<2>(q, z, start, orders, costs, R, S, w, beam, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
