// The fused ordering unit: popcount keys + descending bitonic sort of each
// row of (R, W) 32-bit words, returning the ordered words and the
// window-local permutation (O2's recovery index).
//
// Replaces the Pallas TPU kernel repro/kernels/order_unit.py
// (order_unit_pallas), which computed SWAR popcount keys in VMEM (the TPU
// vector unit has no popcount) and ran the bitonic network with (value,
// lane index) as payloads. Here each key is one __popc as the row is
// loaded; the network is the reference's, substage for substage, with the
// same strict comparisons, so the output equals the reference's bit for
// bit, ties included (a bitonic network is not stable, so no other sort
// will do). Bound: bytes on paper (4 read and 8 written a lane); the keys
// never touch HBM.
//
// Design, 32 <= W <= 1,024: the row in registers (warp_bitonic in
// bitonic.cuh), four warps a block. Lane l loads its E adjacent words
// (16-byte loads, its own 64-byte run at E = 16), leaves them in the row's
// copy in shared memory, and holds each element as one register: the key
// word (popcount << 16) | index. The comparison reads only the high half,
// strictly, as KeyDesc reads the key; the index rides in the low half, so
// the network moves one word an element and no payload, and the ordered
// values are gathered from the row by the final indices (the reference
// carries the value as a payload; the order, ties included, is the same).
// Substages below E run inside a thread, the others with one shuffle an
// element; none waits at a block barrier, where the shared-memory network
// (one thread a compare-exchange pair, a __syncthreads() after each of
// log2(W) (log2(W) + 1) / 2 substages) spent its time. The compare-selects
// run on the integer pipe and each waits on the one before, so rows of 256
// words and more take two warps (E = W / 64 a lane), which meet at a named
// barrier for the substages that pair the two halves: twice the warps to
// hide that latency. Narrower rows take one warp (E = W / 32), where two
// would lose more to the barriers than they gain (tools/k5_probe.py times
// both). Other widths (W < 32, and up to three int32 arrays of a row in a
// block's 227 KB) keep the shared-memory network of bitonic.cuh.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block (rows: kWarps / G)

// Element a precedes element b: a's popcount (the key word's high half) is
// strictly greater. a > (b | 0xffff) compares the high halves alone;
// XORing both words with kFlip reverses the order of the high halves.
struct PackedKeyDesc {
    static constexpr unsigned kFlip = 0xffff0000u;
    __device__ __forceinline__ bool operator()(unsigned a, unsigned b) const {
        return a > (b | 0xffffu);
    }
};

// A row of W = 32 E G words on G = 2^LG warps; kWarps / G rows a block.
template <int E, int LG>
__global__ void __launch_bounds__(kWarps * 32)
order_unit_warp(const unsigned* __restrict__ vals,
                unsigned* __restrict__ ovals, unsigned* __restrict__ operm,
                long long R) {
    constexpr int W = 32 * E << LG;
    __shared__ unsigned srow[kWarps * 32 * E];      // the rows' values
    __shared__ unsigned xbuf[LG ? kWarps * 32 * E : 1];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int slot = wid >> LG;                     // the block's row
    const int part = wid & ((1 << LG) - 1);         // this warp's part of it
    const long long row = (long long)blockIdx.x * (kWarps >> LG) + slot;
    if (row >= R) return;                           // the row's warps alike
    const int first = (part * 32 + lane) * E;       // this lane's elements
    const long long base = row * W + first;
    unsigned* values = srow + slot * W;
    unsigned key[E], none[1][E];
    load_run<E>(vals + base, key);                  // the values, first
    store_run<E>(values + first, key);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < E; ++r)
        key[r] = ((unsigned)__popc(key[r]) << 16) | (unsigned)(first + r);
    // With G > 1 the last substage exchanges across warps behind the row's
    // barrier, so the gather below sees every part's values.
    warp_bitonic<E, 0, LG>(key, none, lane, PackedKeyDesc(), part,
                           xbuf + slot * W, 1 + slot);
    unsigned out[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
        key[r] &= 0xffffu;                          // the index
        out[r] = values[key[r]];
    }
    store_run<E>(ovals + base, out);
    store_run<E>(operm + base, key);
}

template <int E, int LG>
int launch_warp(const void* vals, void* ovals, void* operm, long long R,
                cudaStream_t s) {
    constexpr int rows = kWarps >> LG;
    const long long blocks = (R + rows - 1) / rows;
    order_unit_warp<E, LG><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const unsigned*)vals, (unsigned*)ovals, (unsigned*)operm, R);
    return (int)cudaGetLastError();
}

__global__ void order_unit_kernel(const int* __restrict__ vals,
                                  int* __restrict__ ovals,
                                  int* __restrict__ operm, long long R,
                                  int w, int rpb) {
    extern __shared__ int smem[];
    int* sk = smem;
    int* sv = sk + (long long)rpb * w;
    int* si = sv + (long long)rpb * w;
    const long long row0 = (long long)blockIdx.x * rpb;
    const int rows = (int)(R - row0 < rpb ? R - row0 : rpb);
    const long long base = row0 * w;
    const int n = rows * w;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int v = vals[base + e];
        sk[e] = __popc((unsigned)v);
        sv[e] = v;
        si[e] = e & (w - 1);
    }
    __syncthreads();
    bitonic_network<2>(sk, sv, si, w, rows, KeyDesc());
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        ovals[base + e] = sv[e];
        operm[base + e] = si[e];
    }
}

int launch_shared(const void* vals, void* ovals, void* operm, long long R,
                  int w, cudaStream_t s) {
    SegmentLaunch g = segment_launch(R, w);
    size_t smem = (size_t)g.rows_per_block * w * sizeof(int) * 3;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            order_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    order_unit_kernel<<<(unsigned)g.blocks, g.threads, smem, s>>>(
        (const int*)vals, (int*)ovals, (int*)operm, R, w, g.rows_per_block);
    return (int)cudaGetLastError();
}

}  // namespace

// vals, ovals, operm: (R, w) int32, w a power of two. Rows of 32 to 1,024
// words are sorted in registers: a warp a row below 256 words, two warps a
// row from 256. The vector loads and stores need 16-byte aligned rows
// (torch's allocations are); a row base off that alignment, and any other
// width, takes the shared-memory network.
extern "C" int order_unit(const void* vals, void* ovals, void* operm,
                          long long R, int w, void* stream) {
    if (R <= 0 || w <= 0) return 0;
    if (w & (w - 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const uintptr_t a = reinterpret_cast<uintptr_t>(vals) |
                        reinterpret_cast<uintptr_t>(ovals) |
                        reinterpret_cast<uintptr_t>(operm);
    if (a % 16 == 0) {
        switch (w) {
            case 32: return launch_warp<1, 0>(vals, ovals, operm, R, s);
            case 64: return launch_warp<2, 0>(vals, ovals, operm, R, s);
            case 128: return launch_warp<4, 0>(vals, ovals, operm, R, s);
            case 256: return launch_warp<4, 1>(vals, ovals, operm, R, s);
            case 512: return launch_warp<8, 1>(vals, ovals, operm, R, s);
            case 1024: return launch_warp<16, 1>(vals, ovals, operm, R, s);
        }
    }
    return launch_shared(vals, ovals, operm, R, w, s);
}
