// Distance + select body of one O3 chain step: for each row of one or two
// (R, W) XOR planes (window ^ current value), the summed popcount distance
// dvec, and the lane indices sorted stably ascending by the int32 key
// dvec * k2 + idx + penalty (32-bit wrapping arithmetic, compared signed).
//
// Replaces the Pallas TPU kernel repro/kernels/min_hamming.py
// (chain_select_pallas, body _make_select_kernel), which computed SWAR
// popcounts in VMEM, negated the keys and ran the descending bitonic
// network with the lane index as payload over a row padded to a power of
// two >= 128. That network is not stable and the negation overflows on
// INT32_MIN (ROADMAP C10); the port keeps the order of the reference's
// _select_beam, a stable ascending sort of the key, for any penalty.
//
// Bound: bytes - per lane 4 read a plane and 4 for the penalty, 8 written
// (dvec, order); the sort's compare-exchanges are the operations.
//
// Design, W <= 1,024: one warp a row, Wp / 32 elements a lane (Wp the next
// power of two >= max(W, 32)), the whole sort in registers with no block
// barrier. Each element is the pair (key, lane) packed into one unsigned
// word, compared as a number, so the order is (key, lane) ascending - the
// stable order - and the lane rides the swaps for free:
//  * key ^ 0x80000000 orders as unsigned as the key does as signed;
//  * the bits that differ between the row's keys are found with two warp
//    reductions (OR ^ AND); only those bits decide the order, so the key
//    is compacted to them (pext, a run of contiguous bits at a time), and
//    when they and the lane's log2(Wp) bits fit 32 bits an element is one
//    32-bit word: (compacted key << log2 Wp) | lane. The chain's own
//    penalties at W = 152 leave 16 varying bits: 24 bits in all. Otherwise
//    an element is the 64-bit word (key ^ 0x80000000) << 32 | lane;
//  * padding lanes hold the all-ones word, above every real element;
//  * loads and stores are coalesced (element r * 32 + lane); a transpose
//    through the warp's own shared memory (skewed, conflict-free, behind
//    __syncwarp) gives each lane Wp / 32 adjacent elements, so the network's
//    substages below Wp / 32 run inside a thread (a min and a max a pair)
//    and the others are one __shfl_xor_sync and one compare-select an
//    element: every comparator is ascending (each merge opens with a flip),
//    so no substage picks min or max by direction. The sort's compare-
//    selects on the integer pipe, not the bytes, set the pace at W = 152.
// Wider rows (up to 16,384: two 64 KB arrays) keep the shared-memory
// network of bitonic.cuh on (key, lane), several rows a block below 2,048.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;              // rows (warps) a block, W <= 1,024
constexpr int kMaxWarpRow = 1024;

__host__ __device__ constexpr int skew(int i) { return i + (i >> 5); }

// x, hidden from the compiler: the store guards e < w are computed afresh
// after a sort rather than held in predicate registers across it, which
// the cross-lane substages need for their lane roles.
__device__ __forceinline__ int opaque(int x) {
    asm volatile("" : "+r"(x));
    return x;
}

__device__ __forceinline__ unsigned shfl_xor(unsigned v, int m) {
    return __shfl_xor_sync(kFull, v, m);
}
__device__ __forceinline__ unsigned long long shfl_xor(unsigned long long v,
                                                       int m) {
    return __shfl_xor_sync(kFull, v, m);
}

// Ascending bitonic sort of the warp's 32 N elements. In: v[r] is element
// r * 32 + lane; out: the same, sorted. buf: the warp's skew(32 N) words.
// Every comparator puts the smaller element at the lower index (each merge
// opens with a flip, e against e ^ (size - 1)), so a pair inside a thread is
// one min and one max, and a pair across lanes one compare-select a lane.
template <int N, typename T>
__device__ __forceinline__ void warp_sort(T (&v)[N], T* buf, int lane) {
    // skew(r * 32 + lane) = r * 33 + lane; skew(lane * N + r) = the
    // blocked base + r, as N divides 32.
    T* striped = buf + lane;
    T* blocked = buf + skew(lane * N);
#pragma unroll
    for (int r = 0; r < N; ++r) striped[r * 33] = v[r];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = blocked[r];
    // Element e = lane * N + r from here to the transpose back.
#pragma unroll
    for (int size = 2; size <= 32 * N; size <<= 1) {
        if (size <= N) {       // flip inside the thread: r against r ^ (size - 1)
#pragma unroll
            for (int r = 0; r < N; ++r) {
                const int q = r ^ (size - 1);
                if (q < r) continue;
                const T a = v[r], b = v[q];
                v[r] = min(a, b);
                v[q] = max(a, b);
            }
        } else {               // flip across lanes: lane ^ (size / N - 1), N-1-r
            const bool lower = (lane & (size / N / 2)) == 0;
            T t[N];            // t[r]: the partner's element r
#pragma unroll
            for (int r = 0; r < N; ++r) t[r] = shfl_xor(v[r], size / N - 1);
#pragma unroll
            for (int r = 0; r < N; ++r) {
                const T p = t[N - 1 - r];
                v[r] = ((v[r] < p) == lower) ? v[r] : p;
            }
        }
#pragma unroll
        for (int j = size >> 2; j > 0; j >>= 1) {
            if (j >= N) {      // lane ^ (j / N), same r
                const bool lower = (lane & (j / N)) == 0;
#pragma unroll
                for (int r = 0; r < N; ++r) {
                    const T p = shfl_xor(v[r], j / N);
                    v[r] = ((v[r] < p) == lower) ? v[r] : p;
                }
            } else {           // r against r | j
#pragma unroll
                for (int r = 0; r < N; ++r) {
                    if (r & j) continue;
                    const T a = v[r], b = v[r | j];
                    v[r] = min(a, b);
                    v[r | j] = max(a, b);
                }
            }
        }
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < N; ++r) blocked[r] = v[r];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < N; ++r) v[r] = striped[r * 33];
}

template <int N, int NPL>
__global__ void __launch_bounds__(kWarps * 32)
chain_select_warp(const int* __restrict__ x0, const int* __restrict__ x1,
                  const int* __restrict__ pen, int* __restrict__ dvec,
                  int* __restrict__ order, long long R, int w, int k2) {
    extern __shared__ unsigned long long tbuf[];
    constexpr int WP = 32 * N;
    constexpr int IB = N == 1 ? 5 : N == 2 ? 6 : N == 4 ? 7 : N == 8 ? 8
                     : N == 16 ? 9 : 10;            // log2(WP)
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const long long row = (long long)blockIdx.x * kWarps + wid;
    if (row >= R) return;                           // warp-uniform
    unsigned long long* buf = tbuf + (long long)wid * skew(WP);
    const long long off = row * w + lane;           // this lane's element 0
    unsigned u[N];                                  // key ^ 0x80000000
    unsigned all_and = kFull, any_or = 0;
#pragma unroll
    for (int r = 0; r < N; ++r) {
        const int e = r * 32 + lane;
        u[r] = 0;
        if (e < w) {
            int d = __popc((unsigned)x0[off + r * 32]);
            if (NPL > 1) d += __popc((unsigned)x1[off + r * 32]);
            dvec[off + r * 32] = d;
            u[r] = ((unsigned)d * (unsigned)k2 + (unsigned)e +
                    (unsigned)pen[off + r * 32]) ^ 0x80000000u;
            all_and &= u[r];
            any_or |= u[r];
        }
    }
    const unsigned varying =
        __reduce_or_sync(kFull, any_or) ^ __reduce_and_sync(kFull, all_and);
    if (__popc(varying) + IB <= 32) {
        // pext(u, varying), one run of contiguous varying bits at a time,
        // the highest run first.
        unsigned c[N];
#pragma unroll
        for (int r = 0; r < N; ++r) c[r] = 0;
        for (unsigned m = varying; m;) {
            const int hi = 31 - __clz(m);
            const unsigned below = ~m & ((1u << hi) - 1u);
            const int lo = below ? 32 - __clz(below) : 0;
            const int len = hi - lo + 1;                // <= 27
            // The run's top bit to bit 31, then funnel it in below c.
#pragma unroll
            for (int r = 0; r < N; ++r)
                c[r] = __funnelshift_l(u[r] << (31 - hi), c[r], len);
            m &= ~(((1u << len) - 1u) << lo);
        }
        unsigned v[N];
#pragma unroll
        for (int r = 0; r < N; ++r) {
            const int e = r * 32 + lane;
            v[r] = e < w ? (c[r] << IB) | (unsigned)e : kFull;
        }
        warp_sort<N>(v, reinterpret_cast<unsigned*>(buf), lane);
        const int ws = opaque(w);
#pragma unroll
        for (int r = 0; r < N; ++r)
            if (r * 32 + lane < ws)
                order[off + r * 32] = (int)(v[r] & (WP - 1));
    } else {
        unsigned long long v[N];
#pragma unroll
        for (int r = 0; r < N; ++r) {
            const int e = r * 32 + lane;
            v[r] = e < w ? ((unsigned long long)u[r] << 32) | (unsigned)e
                         : ~0ull;
        }
        warp_sort<N>(v, buf, lane);
        const int ws = opaque(w);
#pragma unroll
        for (int r = 0; r < N; ++r)
            if (r * 32 + lane < ws) order[off + r * 32] = (int)(unsigned)v[r];
    }
}

template <int N, int NPL>
int launch_warp(const void* x0, const void* x1, const void* pen, void* dvec,
                void* order, long long R, int w, int k2, cudaStream_t s) {
    const size_t smem = (size_t)kWarps * skew(32 * N) *
                        sizeof(unsigned long long);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            chain_select_warp<N, NPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (R + kWarps - 1) / kWarps;
    chain_select_warp<N, NPL><<<(unsigned)blocks, kWarps * 32, smem, s>>>(
        (const int*)x0, (const int*)x1, (const int*)pen, (int*)dvec,
        (int*)order, R, w, k2);
    return (int)cudaGetLastError();
}

template <int NPL>
int launch_warp_any(const void* x0, const void* x1, const void* pen,
                    void* dvec, void* order, long long R, int w, int k2,
                    cudaStream_t s) {
    const int n = w <= 32 ? 1 : w <= 64 ? 2 : w <= 128 ? 4 : w <= 256 ? 8
                : w <= 512 ? 16 : 32;
    switch (n) {
        case 1: return launch_warp<1, NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
        case 2: return launch_warp<2, NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
        case 4: return launch_warp<4, NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
        case 8: return launch_warp<8, NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
        case 16: return launch_warp<16, NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
        default: return launch_warp<32, NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
    }
}

// Rows wider than kMaxWarpRow: the shared-memory network, a block a row
// (or several rows below 2,048 lanes).
template <int NPL>
__global__ void chain_select_block(const int* __restrict__ x0,
                                   const int* __restrict__ x1,
                                   const int* __restrict__ pen,
                                   int* __restrict__ dvec,
                                   int* __restrict__ order, long long R,
                                   int w, int wp, int k2, int rpb) {
    extern __shared__ int smem[];
    int* sk = smem;
    int* si = sk + (long long)rpb * wp;
    const long long row0 = (long long)blockIdx.x * rpb;
    const int rows = (int)(R - row0 < rpb ? R - row0 : rpb);
    const int lwp = ilog2(wp);
    const int n = rows * wp;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int i = e & (wp - 1);
        int key = INT_MAX;
        if (i < w) {
            const long long g = (row0 + (e >> lwp)) * w + i;
            int d = __popc((unsigned)x0[g]);
            if (NPL > 1) d += __popc((unsigned)x1[g]);
            dvec[g] = d;
            key = (int)((unsigned)d * (unsigned)k2 + (unsigned)i +
                        (unsigned)pen[g]);
        }
        sk[e] = key;
        si[e] = i;
    }
    __syncthreads();
    bitonic_network<1>(sk, si, nullptr, wp, rows, KeyIdxAsc());
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int i = e & (wp - 1);
        if (i < w) order[(row0 + (e >> lwp)) * w + i] = si[e];
    }
}

template <int NPL>
int launch_block(const void* x0, const void* x1, const void* pen, void* dvec,
                 void* order, long long R, int w, int k2, cudaStream_t s) {
    int wp = 1;
    while (wp < w) wp <<= 1;
    SegmentLaunch g = segment_launch(R, wp);
    size_t smem = (size_t)g.rows_per_block * wp * sizeof(int) * 2;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            chain_select_block<NPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    chain_select_block<NPL><<<(unsigned)g.blocks, g.threads, smem, s>>>(
        (const int*)x0, (const int*)x1, (const int*)pen, (int*)dvec,
        (int*)order, R, w, wp, k2, g.rows_per_block);
    return (int)cudaGetLastError();
}

template <int NPL>
int launch(const void* x0, const void* x1, const void* pen, void* dvec,
           void* order, long long R, int w, int k2, cudaStream_t s) {
    return w <= kMaxWarpRow
               ? launch_warp_any<NPL>(x0, x1, pen, dvec, order, R, w, k2, s)
               : launch_block<NPL>(x0, x1, pen, dvec, order, R, w, k2, s);
}

}  // namespace

extern "C" int chain_select(const void* x0, const void* x1, const void* pen,
                            void* dvec, void* order, long long R, int w,
                            int n_planes, int k2, void* stream) {
    if (R <= 0 || w <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    switch (n_planes) {
        case 1: return launch<1>(x0, x1, pen, dvec, order, R, w, k2, s);
        case 2: return launch<2>(x0, x1, pen, dvec, order, R, w, k2, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
