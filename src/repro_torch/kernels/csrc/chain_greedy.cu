// The whole greedy beam-lookahead O3 chain in one launch: for every window
// r of the partitioned (P, R, W) planes and every start s, the w - 1 chain
// steps from start[r, s] -> orders (R, S, W) and costs (R, S), int32.
//
// Replaces _greedy_from's lax.scan (repro/kernels/min_hamming.py:135-166,
// vmapped over starts and windows), whose distance + select body
// chain_select_pallas (:288, pl.pallas_call :320) computes on a TPU. There
// the scan is one compiled loop; here one warp runs every step of one chain
// without leaving the SM. A step: the distances d(cur, j) = sum_p
// popc(q_p[j] ^ q_p[cur]); the beam smallest keys d*W + j + pen (pen: 2^30
// visited, 2^28 zero region j >= z); each candidate c's lookahead, the
// least d(c, j) over unvisited live j != c (2^20, then 0, if none); the
// score (d_c + la) * 130W + d_c * W + c + pen_c; the first smallest score
// wins, is marked visited and adds d_c to the cost.
//
// Bound (recounted from the least work): a step needs the beam candidates'
// distances to every live lane - P XORs, P popcounts and P - 1 adds a lane
// and candidate; a zero-region lane's words are 0, so its distance is the
// candidate's own popcount, 2P - 1 operations once - plus a compare a live
// lane for each candidate's lookahead minimum and a beam selection of
// W + (beam - 1) * ceil(log2 W) compares (the minimum, then each next one
// from its tournament); d(cur, .) is the winner's lookahead vector of the
// step before, so it costs nothing. Bytes are the planes read once and the
// orders written once, so operations bound it. chip_smoke.py divides them
// by 67 TOP/s, the H100's published float32 rate outside the tensor cores,
// as it does for every kernel of the port: the published table gives no
// integer rate. An SM issues 64 integer lanes and 16 popcounts a clock
// (16.7 and 4.2 T a second at 1.98 GHz), so the bound is a floor the card
// cannot reach; at conv2 under O3a the call's 1.24e9 popcounts alone take
// 0.30 ms.
//
// Two tiers, chosen by the wrapper from the shape alone
// (chain_greedy.py tier_of):
//
//  * register tier, W <= 1,024 and beam <= 2 (every window of the main
//    path, at its beam of 2: LeNet 25-400, DarkNet 27-576). Lane l owns
//    the slots j = l + 32t, t < K = ceil(W/32) (rounded up to 24 or 32
//    past 18), K a template parameter and every slot loop unrolled, so the
//    lane's plane words, its penalty words
//    j | zone << 17 | visited << 18 and its distance vector sit in
//    registers. A step is one fused pass that computes the distances of
//    every slot from all beam candidates at once, each plane word loaded
//    once, and folds the lookahead minima into the same pass; the winner's
//    vector is the next step's d(cur, .), so a step makes beam distance
//    passes where the wide tier makes 2 * beam from shared memory. The
//    key d << 10 | pen orders lanes as d*W + j + pen does (pen class, then
//    d, then j) and carries j in its low 10 bits: one 32-bit
//    __reduce_min_sync finds a candidate and its lane, no (key, j) pair.
//    Each lane keeps its beam smallest keys sorted; a round takes the warp
//    minimum and its owner lane moves to its next key. The lookahead skips
//    a slot by bit 31 of its distance (visited, zone and all candidates:
//    the others' distances are added back from the broadcast words), and a
//    visit is the owner lane's branch to its slot. The planes also
//    sit in shared memory (a region a warp), read only to broadcast
//    q[cur] and the candidates' words. A warp runs one (window, start)
//    chain and the grid is a block for every eight, which the card's
//    block scheduler deals to the SMs as they free up; a grid sized to the
//    resident blocks, each warp walking the chains with a stride, measured
//    0.3-20 % slower from 8,192 chains up on an H100 (tools/k6_probe.py
//    --variants, `strided`): a stride deals the chains statically, so the
//    warps with one chain more set the end.
//  * wide tier, any other W up to _MAX_WINDOW = 16,000 or beam: one block
//    a window, one warp a start, the planes in shared memory and each
//    warp's visited set as a W-bit mask there; every pass recomputes the
//    distances from shared memory (a lane would need ceil(W/32) of them in
//    registers, up to 500); a (key, j) minimum is two redux.sync. Its
//    work is the first design's count: 2P + 3 operations a lane for
//    d(cur, .), 2 a lane for each beam pass and 2P + 3 a live lane for
//    each candidate's lookahead.
//
// The wide tier's keys and scores are 32-bit unsigned arithmetic that wraps
// as the plain int32 version does, compared as signed int32 (ROADMAP C5);
// the register tier's never reach 2^31 (W <= 1,024), so its 19-bit keys and
// 27-bit scores keep the same order.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kVisited = 1u << 30;
constexpr unsigned kZone = 1u << 28;
constexpr unsigned kInf = 1u << 20;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;  // warps a block in both tiers

// Register tier: the widest row and the largest beam it takes.
constexpr int kRegMaxWindow = 1024;
constexpr int kRegMaxBeam = 2;
// Register-tier key bits: j in 0-9, d in 10-16 (d <= 64), zone 17,
// visited 18; a lane past the row sorts after every real one.
constexpr unsigned kKeyZone = 1u << 17;
constexpr unsigned kKeyVisited = 1u << 18;
constexpr unsigned kKeyDead = 0x7fe00000u;
constexpr unsigned kSkipBit = 0x80000000u;

// --- register tier -------------------------------------------------------

// The lane's beam smallest keys, m[0] < m[1] < ... (keys are distinct).
template <int B>
__device__ __forceinline__ void keep_smallest(unsigned (&m)[B], unsigned k) {
#pragma unroll
    for (int b = B - 1; b > 0; --b) m[b] = min(m[b], max(m[b - 1], k));
    m[0] = min(m[0], k);
}

template <int NPL>
__device__ __forceinline__ unsigned popdist(const unsigned (&a)[NPL],
                                            const unsigned (&b)[NPL]) {
    unsigned d = __popc(a[0] ^ b[0]);
    if constexpr (NPL > 1) d += __popc(a[1] ^ b[1]);
    return d;
}

// Mark slot c visited: its key's visited bit and the lane's skip bit. Only
// the owner lane branches, and it jumps to its slot: no pass over the K.
#define CHAIN_VISIT(T)                                   \
    case T:                                              \
        if constexpr (T < K) pen[T] |= kKeyVisited;      \
        break;
template <int K>
__device__ __forceinline__ void visit(unsigned (&pen)[K], unsigned& skip,
                                      int c, int lane) {
    if (lane != (c & 31)) return;
    skip |= 1u << (c >> 5);
    switch (c >> 5) {
        CHAIN_VISIT(0)
        CHAIN_VISIT(1)
        CHAIN_VISIT(2)
        CHAIN_VISIT(3)
        CHAIN_VISIT(4)
        CHAIN_VISIT(5)
        CHAIN_VISIT(6)
        CHAIN_VISIT(7)
        CHAIN_VISIT(8)
        CHAIN_VISIT(9)
        CHAIN_VISIT(10)
        CHAIN_VISIT(11)
        CHAIN_VISIT(12)
        CHAIN_VISIT(13)
        CHAIN_VISIT(14)
        CHAIN_VISIT(15)
        CHAIN_VISIT(16)
        CHAIN_VISIT(17)
        CHAIN_VISIT(18)
        CHAIN_VISIT(19)
        CHAIN_VISIT(20)
        CHAIN_VISIT(21)
        CHAIN_VISIT(22)
        CHAIN_VISIT(23)
        CHAIN_VISIT(24)
        CHAIN_VISIT(25)
        CHAIN_VISIT(26)
        CHAIN_VISIT(27)
        CHAIN_VISIT(28)
        CHAIN_VISIT(29)
        CHAIN_VISIT(30)
        CHAIN_VISIT(31)
    }
}
#undef CHAIN_VISIT

template <int NPL, int K, int B>
__global__ void __launch_bounds__(kWarps * 32)
chain_greedy_reg(const int* __restrict__ q, const int* __restrict__ z,
                 const int* __restrict__ start, int* __restrict__ orders,
                 int* __restrict__ costs, int R, int S, int w) {
    extern __shared__ unsigned sreg[];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long rs = (long long)blockIdx.x * kWarps + warp;  // chain
    if (rs >= (long long)R * S) return;
    unsigned* sq = sreg + warp * NPL * w;            // this warp's planes
    const int r = (int)(rs / S);
    const int zr = z[r];
    unsigned qv[NPL][K], pen[K], skip = 0;
#pragma unroll
    for (int t = 0; t < K; ++t) {
        const int j = lane + 32 * t;
#pragma unroll
        for (int p = 0; p < NPL; ++p) {
            unsigned x = 0;
            if (j < w) {
                x = (unsigned)q[((long long)p * R + r) * w + j];
                sq[p * w + j] = x;
            }
            qv[p][t] = x;
        }
        const bool zone = j >= zr;
        pen[t] = j >= w ? kKeyDead : (unsigned)j | (zone ? kKeyZone : 0u);
        if (zone || j >= w) skip |= 1u << t;
    }
    __syncwarp();
    int cur = start[rs];
    int* ord = orders + rs * w;
    if (lane == 0) ord[0] = cur;
    visit<K>(pen, skip, cur, lane);
    unsigned dv[K];                                  // d(cur, j)
    {
        unsigned cq[NPL];
#pragma unroll
        for (int p = 0; p < NPL; ++p) cq[p] = sq[p * w + cur];
#pragma unroll
        for (int t = 0; t < K; ++t) {
            unsigned d = __popc(qv[0][t] ^ cq[0]);
            if constexpr (NPL > 1) d += __popc(qv[1][t] ^ cq[1]);
            dv[t] = d;
        }
    }
    unsigned cost = 0;
    for (int i = 1; i < w; ++i) {
        // Beam selection: the lane's B smallest keys, then B rounds of
        // a warp minimum; the owner of each moves to its next key.
        unsigned m[B];
#pragma unroll
        for (int b = 0; b < B; ++b) m[b] = UINT_MAX;
#pragma unroll
        for (int t = 0; t < K; ++t) keep_smallest<B>(m, dv[t] * 1024u + pen[t]);
        unsigned g[B];
#pragma unroll
        for (int b = 0; b < B; ++b) {
            g[b] = __reduce_min_sync(kFull, m[0]);
            if (b + 1 < B) {
                const bool own = lane == (int)(g[b] & 31u);
#pragma unroll
                for (int e = 0; e + 1 < B; ++e)
                    m[e] = own ? m[e + 1] : m[e];
                m[B - 1] = own ? UINT_MAX : m[B - 1];
            }
        }
        int c[B];
        unsigned cq[B][NPL], cand = 0;
#pragma unroll
        for (int b = 0; b < B; ++b) {
            c[b] = (int)(g[b] & 1023u);
#pragma unroll
            for (int p = 0; p < NPL; ++p) cq[b][p] = sq[p * w + c[b]];
            if (lane == (c[b] & 31)) cand |= 1u << (c[b] >> 5);
        }
        // One pass: every candidate's distance to every slot, bit 31
        // set where the lookahead skips the slot (visited, zone and
        // every candidate); a key's shift drops the bit again.
        const unsigned skc = skip | cand;
        unsigned v[B][K], la[B];
#pragma unroll
        for (int b = 0; b < B; ++b) la[b] = UINT_MAX;
#pragma unroll
        for (int t = 0; t < K; ++t) {
            const unsigned hb = (skc << (31 - t)) & kSkipBit;
#pragma unroll
            for (int b = 0; b < B; ++b) {
                unsigned d = __popc(qv[0][t] ^ cq[b][0]) + hb;
                if constexpr (NPL > 1) d += __popc(qv[1][t] ^ cq[b][1]);
                v[b][t] = d;
                la[b] = min(la[b], d);
            }
        }
#pragma unroll
        for (int b = 0; b < B; ++b) la[b] = __reduce_min_sync(kFull, la[b]);
        // The pass skipped every candidate; a live unvisited one is in
        // the other candidates' lookahead.
#pragma unroll
        for (int b = 0; b < B; ++b)
#pragma unroll
            for (int o = 0; o < B; ++o)
                if (o != b && g[o] < kKeyZone)
                    la[b] = min(la[b], popdist<NPL>(cq[b], cq[o]));
        // The reference's score (d_c + la) * 130W + d_c * W + c + pen_c
        // stays below 2^31 for W <= 1,024, so it orders the candidates
        // by (pen class, d_c + la, d_c, c): the compact score below,
        // which carries the winner's c and d_c in its low 17 bits.
        unsigned sc[B], best = UINT_MAX;
#pragma unroll
        for (int b = 0; b < B; ++b) {
            const unsigned lab = la[b] >= kSkipBit ? 0u : la[b];
            sc[b] = ((g[b] & (kKeyZone | kKeyVisited)) << 8)
                    + ((((g[b] >> 10) & 127u) + lab) << 17)
                    + (g[b] & 0x1ffffu);
            best = min(best, sc[b]);
        }
        const unsigned dw = (best >> 10) & 127u;
        cur = (int)(best & 1023u);
#pragma unroll
        for (int t = 0; t < K; ++t) {
            unsigned x = v[0][t];
#pragma unroll
            for (int b = 1; b < B; ++b) x = best == sc[b] ? v[b][t] : x;
            dv[t] = x;
        }
        cost += dw;
        visit<K>(pen, skip, cur, lane);
        if (lane == 0) ord[i] = cur;
    }
    if (lane == 0) costs[rs] = (int)cost;
}

template <int NPL, int K, int B>
int launch_reg_k(const void* q, const void* z, const void* start,
                 void* orders, void* costs, int R, int S, int w,
                 cudaStream_t st) {
    auto kern = chain_greedy_reg<NPL, K, B>;
    const size_t smem = sizeof(unsigned) * (size_t)kWarps * NPL * w;
    if (smem > 48 * 1024) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = ((long long)R * S + kWarps - 1) / kWarps;
    kern<<<(unsigned)blocks, kWarps * 32, smem, st>>>(
        (const int*)q, (const int*)z, (const int*)start, (int*)orders,
        (int*)costs, R, S, w);
    return (int)cudaGetLastError();
}

// The instantiated slot counts: every K up to 18 (DarkNet's 576-lane
// windows, the widest of the main path), then 24 and 32; a row takes the
// least K >= ceil(w/32).
template <int K>
constexpr int kNextK = K < 18 ? K + 1 : K + 8 - K % 8;

template <int NPL, int B, int K = 1>
int launch_reg(const void* q, const void* z, const void* start, void* orders,
               void* costs, int R, int S, int w, cudaStream_t st) {
    if ((w + 31) / 32 <= K)
        return launch_reg_k<NPL, K, B>(q, z, start, orders, costs, R, S, w,
                                       st);
    if constexpr (K < kRegMaxWindow / 32)
        return launch_reg<NPL, B, kNextK<K>>(q, z, start, orders, costs, R,
                                             S, w, st);
    return (int)cudaErrorInvalidValue;
}

template <int NPL>
int launch_reg_beam(const void* q, const void* z, const void* start,
                    void* orders, void* costs, int R, int S, int w, int beam,
                    cudaStream_t st) {
    return beam == 1
        ? launch_reg<NPL, 1>(q, z, start, orders, costs, R, S, w, st)
        : launch_reg<NPL, 2>(q, z, start, orders, costs, R, S, w, st);
}

// --- wide tier -----------------------------------------------------------

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
chain_greedy_wide(const int* __restrict__ q, const int* __restrict__ z,
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
int launch_wide(const void* q, const void* z, const void* start, void* orders,
                void* costs, int R, int S, int w, int beam, cudaStream_t st) {
    const int warps = S < kWarps ? S : kWarps;
    const size_t smem = sizeof(int) * ((size_t)NPL * w
                                       + (size_t)warps * ((w + 31) / 32));
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            chain_greedy_wide<NPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    dim3 grid((unsigned)R, (unsigned)((S + kWarps - 1) / kWarps));
    chain_greedy_wide<NPL><<<grid, warps * 32, smem, st>>>(
        (const int*)q, (const int*)z, (const int*)start, (int*)orders,
        (int*)costs, R, S, w, beam);
    return (int)cudaGetLastError();
}

}  // namespace

// tier 0: the register tier (w <= 1,024, beam <= 2); tier 1: the wide tier.
extern "C" int chain_greedy(const void* q, const void* z, const void* start,
                            void* orders, void* costs, int n_planes, int R,
                            int S, int w, int beam, int tier, void* stream) {
    if (R <= 0 || S <= 0 || w <= 0) return 0;
    if (beam < 1 || beam > w || n_planes < 1 || n_planes > 2)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (tier == 0) {
        if (w > kRegMaxWindow || beam > kRegMaxBeam)
            return (int)cudaErrorInvalidValue;
        return n_planes == 1
            ? launch_reg_beam<1>(q, z, start, orders, costs, R, S, w, beam, st)
            : launch_reg_beam<2>(q, z, start, orders, costs, R, S, w, beam,
                                 st);
    }
    if (tier != 1) return (int)cudaErrorInvalidValue;
    return n_planes == 1
        ? launch_wide<1>(q, z, start, orders, costs, R, S, w, beam, st)
        : launch_wide<2>(q, z, start, orders, costs, R, S, w, beam, st);
}
