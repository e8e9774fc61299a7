// Popcount window order: each window's '1'-bit counts decide its order in
// one launch, and the counts never leave the SM.
//
// Replaces the Pallas TPU kernel repro/kernels/popcount.py
// (popcount_words_pallas) where the port orders by it. On a TPU the
// kernel was a standalone SWAR popcount because the vector unit lacked
// one, and XLA fused the keys, the stable argsort and the window offsets
// around it. Eager PyTorch fuses nothing: the same work was a popcount
// launch plus ~10-15 torch launches (a segmented stable sort among them)
// per ordering call, each writing its intermediate to device memory. Here
// the count stays in a register until the order it decides is written.
//
// Two entry points share one device routine, a stable counting sort of a
// window by a small key, in shared memory:
//
//  * descending_perm_rows - the O1/O2 order of each (R, W) row by count,
//    descending, ties in position order ("stable": one pass on the key
//    32 - count, 33 buckets), or ties by bit pattern descending as
//    unsigned ("pattern": the reference's argsort(~u) then stable
//    argsort(-count), as LSD counting passes - one 8-bit digit pass of ~u
//    per byte of the nbits-wide pattern, low byte first, then the count
//    pass). Writes the flat int64 permutation with the window offsets
//    added (row * W + index).
//  * chain_inputs - the O3/O3a chain preamble of each (P, R, W) window in
//    one counting pass on the plane-summed count (32P + 1 buckets): the
//    zeros-to-tail partition `part` and the partitioned planes `q` from
//    the same pass's stable ranks (ballots over live / zero), the live
//    count z, the partitioned identity's cost, and the start positions
//    dperm[(s * z) // S] (64-bit product). dperm, the stable descending
//    count order of the partitioned window, needs no sort of its own: a
//    count group is all live or all zero, and `part` keeps the order
//    inside each, so dperm[rank(i)] = part^-1(i) for the count-order rank
//    of each original position i - the count pass gives both.
//
// Design. A group of G warps owns one row (G = 1 for LeNet's windows of
// 25-400 values, up to 32 for O3's 16,000); a block holds 256 / (32 G)
// rows when G <= 8. Each warp owns a contiguous 32-aligned segment of the
// row. The row's words are read once with coalesced loads into shared
// memory; a pass counts its keys per warp (__match_any_sync: the leader of
// each key's lanes adds their number), takes one exclusive scan of the
// (key, warp) counts in key-major order over the group, then walks its
// segment again in 32-position tiles: a lane's stable destination is its
// warp's running offset for its key plus __popc(peers & lanemask_lt), and
// the key's leader advances the offset. The permutation is assembled in
// shared memory and written once, coalesced. A row whose buffers do not
// fit a block's shared memory (the no-NoC path orders the whole ~62,000-
// value weight stream as one window) keeps them in a device scratch the
// wrapper allocates; the code is the same through generic pointers.
//
// Bound: bytes - each word read once, the int64 permutation (or the
// preamble's outputs) written once; a pass costs a few integer operations
// a value.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlockThreads = 256;  // for G <= 8: 256 / (32 G) rows a block

struct Group {   // the warps that own one row
    int G;       // warps in the group
    int w;       // this warp's index in the group
    int lane;
    int gl;      // this thread's index in the group
};

__device__ __forceinline__ unsigned lanemask_lt() {
    unsigned m;
    asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
    return m;
}

// Exclusive scan of a[0, n) in place by the group's 32 G threads, each a
// contiguous chunk; wsum holds G ints. Block-wide barriers: every group of
// the block calls it together.
__device__ void group_scan(int* a, int n, const Group& g, int* wsum) {
    const int T = 32 * g.G;
    const int per = (n + T - 1) / T;
    const int lo = min(g.gl * per, n), hi = min(lo + per, n);
    int s = 0;
    for (int i = lo; i < hi; ++i) s += a[i];
    int x = s;
    for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(kFull, x, d);
        if (g.lane >= d) x += y;
    }
    if (g.lane == 31) wsum[g.w] = x;
    __syncthreads();
    int run = x - s;
    for (int k = 0; k < g.w; ++k) run += wsum[k];
    for (int i = lo; i < hi; ++i) {
        const int v = a[i];
        a[i] = run;
        run += v;
    }
    __syncthreads();
}

// Count the keys of the warp's segment [lo, hi) into hist[k * G + w],
// then scan: hist[k * G + w] becomes the slot of warp w's first position
// with key k. key(j) must lie in [0, B).
template <class KeyF>
__device__ void count_and_scan(int lo, int hi, int B, const Group& g,
                               int* hist, int* wsum, KeyF key) {
    for (int i = g.gl; i < B * g.G; i += 32 * g.G) hist[i] = 0;
    __syncthreads();
    for (int t = lo; t < hi; t += 32) {
        const int j = t + g.lane;
        const bool ok = j < hi;
        const int k = ok ? key(j) : -1;
        const unsigned peers = __match_any_sync(kFull, k);
        if (ok && g.lane == __ffs(peers) - 1)
            hist[k * g.G + g.w] += __popc(peers);
        __syncwarp();
    }
    __syncthreads();
    group_scan(hist, B * g.G, g, wsum);
}

// Stable slot of this lane's position (key k) in its tile: the warp's
// running offset off[k * G] plus the lanes before it that hold k; the
// key's leader then advances the offset. All 32 lanes call it.
__device__ __forceinline__ int tile_slot(int* off, int G, int k, bool ok,
                                         int lane) {
    const unsigned peers = __match_any_sync(kFull, ok ? k : -1);
    const int slot = ok ? off[k * G] + __popc(peers & lanemask_lt()) : -1;
    __syncwarp();
    if (ok && lane == __ffs(peers) - 1) off[k * G] += __popc(peers);
    __syncwarp();
    return slot;
}

// One stable counting pass over the row: position j (key(j) in [0, B))
// goes to slot dst[slot] = src(j); src(j) = j when src is null.
template <class KeyF>
__device__ void counting_pass(int lo, int hi, int B, const Group& g,
                              int* hist, int* wsum, const int* src, int* dst,
                              KeyF key) {
    count_and_scan(lo, hi, B, g, hist, wsum, key);
    for (int t = lo; t < hi; t += 32) {
        const int j = t + g.lane;
        const bool ok = j < hi;
        const int slot = tile_slot(hist + g.w, g.G, ok ? key(j) : 0, ok,
                                   g.lane);
        if (ok) dst[slot] = src ? src[j] : j;
    }
    __syncthreads();
}

__device__ __forceinline__ Group make_group(int G) {
    const int t = threadIdx.x % (32 * G);
    return Group{G, t >> 5, (int)(threadIdx.x & 31), t};
}

// The warp's segment of an n-position row: 32-aligned, contiguous.
__device__ __forceinline__ void segment(int n, int W, const Group& g,
                                        int& lo, int& hi) {
    const int seg = ((W + g.G - 1) / g.G + 31) / 32 * 32;
    lo = min(g.w * seg, n);
    hi = min(lo + seg, n);
}

// rows: int32 carriers of zero-extended nbits-wide words. scratch: used
// (2 or 3 arrays of W ints a row; the words stay in device memory) when
// in_smem is 0, else the arrays sit in shared memory after the histogram.
__global__ void descending_perm_kernel(const int* __restrict__ words,
                                       long long* __restrict__ perm,
                                       int* __restrict__ scratch, int R, int W,
                                       int G, int digits, int in_smem) {
    extern __shared__ int smem[];
    const Group g = make_group(G);
    const int grp = threadIdx.x / (32 * G);
    const int rows_per_block = blockDim.x / (32 * G);
    const long long row = (long long)blockIdx.x * rows_per_block + grp;
    const int n = row < R ? W : 0;
    const int B = digits ? 256 : 33;
    const int bufs = digits ? 2 : 1;
    int* hist = smem + (size_t)grp * (B * G + G + (in_smem ? (1 + bufs) * W : 0));
    int* wsum = hist + B * G;
    const int* ws;
    int *a, *b;
    if (in_smem) {
        int* s = wsum + G;
        for (int j = g.gl; j < n; j += 32 * G) s[j] = words[row * W + j];
        ws = s;
        a = s + W;
    } else {
        ws = words + row * W;
        a = scratch + (n ? row : 0) * bufs * (long long)W;
    }
    b = a + W;
    __syncthreads();
    int lo, hi;
    segment(n, W, g, lo, hi);
    const int* cur = nullptr;  // null: the identity
    int* nxt = a;
    for (int d = 0; d < digits; ++d) {
        const int sh = 8 * d;
        counting_pass(lo, hi, 256, g, hist, wsum, cur, nxt, [&](int j) {
            const int i = cur ? cur[j] : j;
            return 255 - (int)(((unsigned)ws[i] >> sh) & 255u);
        });
        cur = nxt;
        nxt = nxt == a ? b : a;
    }
    counting_pass(lo, hi, 33, g, hist, wsum, cur, nxt, [&](int j) {
        return 32 - __popc((unsigned)ws[cur ? cur[j] : j]);
    });
    const long long base = row * W;
    for (int j = g.gl; j < n; j += 32 * G) perm[base + j] = base + nxt[j];
}

// u: (NP, R, W) int32 words. Outputs: part (R, W) int64, q (NP, R, W)
// int32, z (R,) int32, cid (R,) int32, start (R, S) int64.
template <int NP>
__global__ void chain_inputs_kernel(const int* __restrict__ u,
                                    long long* __restrict__ part,
                                    int* __restrict__ q, int* __restrict__ zout,
                                    int* __restrict__ cidout,
                                    long long* __restrict__ start, int R,
                                    int W, int S, int G) {
    extern __shared__ int smem[];
    constexpr int B = 32 * NP + 1;   // key 32 NP - count; B - 1 = zero
    const Group g = make_group(G);
    const int grp = threadIdx.x / (32 * G);
    const int rows_per_block = blockDim.x / (32 * G);
    const long long row = (long long)blockIdx.x * rows_per_block + grp;
    const int n = row < R ? W : 0;
    const long long plane = (long long)R * W;
    int* hist = smem + (size_t)grp * (B * G + G + (NP + 1) * W);
    int* wsum = hist + B * G;
    int* qs = wsum + G;          // partitioned planes, NP x W
    int* ps = qs + NP * W;       // part
    const int* ur = u + (n ? row * W : 0);
    int lo, hi;
    segment(n, W, g, lo, hi);
    auto count = [&](int j) {
        int c = __popc((unsigned)ur[j]);
        if (NP > 1) c += __popc((unsigned)ur[plane + j]);
        return c;
    };
    count_and_scan(lo, hi, B, g, hist, wsum,
                   [&](int j) { return 32 * NP - count(j); });
    const int z = hist[(B - 1) * G];    // slots before the zero bucket
    int zrun = hist[(B - 1) * G + g.w];  // this warp's first zero's slot
    int nzrun = lo - (zrun - z);         // live positions before lo
    __syncthreads();                     // z read before any offset moves
    for (int t = lo; t < hi; t += 32) {
        const int j = t + g.lane;
        const bool ok = j < hi;
        const int w0 = ok ? ur[j] : 0;
        const int w1 = (NP > 1 && ok) ? ur[plane + j] : 0;
        const int c = __popc((unsigned)w0) + (NP > 1 ? __popc((unsigned)w1) : 0);
        const int rank = tile_slot(hist + g.w, G, 32 * NP - c, ok, g.lane);
        const unsigned live = __ballot_sync(kFull, ok && c > 0);
        const unsigned dead = __ballot_sync(kFull, ok && c == 0);
        const unsigned lt = lanemask_lt();
        const int slot = c > 0 ? nzrun + __popc(live & lt)
                               : zrun + __popc(dead & lt);
        nzrun += __popc(live);
        zrun += __popc(dead);
        if (!ok) continue;
        qs[slot] = w0;
        if (NP > 1) qs[W + slot] = w1;
        ps[slot] = j;
        // dperm[rank] = slot; start[s] = dperm[(s * z) // S].
        if (z == 0) {
            if (rank == 0)
                for (int s = 0; s < S; ++s) start[row * S + s] = slot;
        } else if (rank < z) {
            for (long long s = ((long long)rank * S + z - 1) / z;
                 s < S && s * z / S == rank; ++s)
                start[row * S + s] = slot;
        }
    }
    __syncthreads();
    unsigned cid = 0;
    for (int j = g.gl; j < n; j += 32 * G) {
        part[row * W + j] = ps[j];
        q[row * W + j] = qs[j];
        if (NP > 1) q[plane + row * W + j] = qs[W + j];
        if (j + 1 < n) {
            cid += __popc((unsigned)(qs[j] ^ qs[j + 1]));
            if (NP > 1) cid += __popc((unsigned)(qs[W + j] ^ qs[W + j + 1]));
        }
    }
    for (int d = 16; d; d >>= 1) cid += __shfl_xor_sync(kFull, cid, d);
    if (g.lane == 0) wsum[g.w] = (int)cid;
    __syncthreads();
    if (g.gl == 0 && n) {
        int total = 0;
        for (int k = 0; k < G; ++k) total += wsum[k];
        cidout[row] = total;
        zout[row] = z;
    }
}

int blocks_for(int R, int G, int& threads) {
    const int rows = G <= 8 ? kBlockThreads / (32 * G) : 1;
    threads = rows * 32 * G;
    return (R + rows - 1) / rows;
}

template <class K>
int set_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <int NP>
int launch_chain(const void* u, void* part, void* q, void* z, void* cid,
                 void* start, int R, int W, int S, int G, size_t smem,
                 cudaStream_t st) {
    int err = set_smem(chain_inputs_kernel<NP>, smem);
    if (err) return err;
    int threads;
    const int blocks = blocks_for(R, G, threads);
    chain_inputs_kernel<NP><<<blocks, threads, smem, st>>>(
        (const int*)u, (long long*)part, (int*)q, (int*)z, (int*)cid,
        (long long*)start, R, W, S, G);
    return (int)cudaGetLastError();
}

}  // namespace

// G warps a row and the dynamic shared memory of a block come from the
// wrapper (repro_torch/kernels/popcount_order.py layout), which also
// allocates the scratch when in_smem is 0.
extern "C" int descending_perm_rows(const void* words, void* perm,
                                    void* scratch, int R, int W, int nbits,
                                    int pattern, int G, int in_smem,
                                    long long smem, void* stream) {
    if (R <= 0 || W <= 0) return 0;
    if (G < 1 || G > 32 || (nbits != 8 && nbits != 16 && nbits != 32))
        return (int)cudaErrorInvalidValue;
    int err = set_smem(descending_perm_kernel, (size_t)smem);
    if (err) return err;
    int threads;
    const int blocks = blocks_for(R, G, threads);
    descending_perm_kernel<<<blocks, threads, (size_t)smem,
                             (cudaStream_t)stream>>>(
        (const int*)words, (long long*)perm, (int*)scratch, R, W, G,
        pattern ? nbits / 8 : 0, in_smem);
    return (int)cudaGetLastError();
}

extern "C" int chain_inputs(const void* u, void* part, void* q, void* z,
                            void* cid, void* start, int n_planes, int R,
                            int W, int S, int G, long long smem,
                            void* stream) {
    if (R <= 0 || W <= 0) return 0;
    if (G < 1 || G > 32 || S < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    switch (n_planes) {
        case 1: return launch_chain<1>(u, part, q, z, cid, start, R, W, S, G,
                                       (size_t)smem, st);
        case 2: return launch_chain<2>(u, part, q, z, cid, start, R, W, S, G,
                                       (size_t)smem, st);
        default: return (int)cudaErrorInvalidValue;
    }
}
