// Descending bitonic key sort of each row of an (R, W) int32 key array,
// with up to two int32 payload arrays riding the same swaps.
//
// Replaces the Pallas TPU kernel repro/kernels/bitonic_sort.py
// (sort_windows_pallas), which ran the network over (8, W) row tiles in
// VMEM. The network is the reference's, substage for substage, with the
// same strict comparisons, so equal keys never move and the output,
// payloads included, equals the reference's bit for bit (a bitonic network
// is not stable, so no other sort will do). Bound: a row costs W/2 log2(W)
// (log2(W) + 1) / 2 compare-exchanges (11,520 at W = 512) against 8 bytes
// a lane read and written per array, so on paper the bytes bound it (W =
// 512, one payload: 2.4 ns of HBM time a row against 0.9 ns of ALU time).
//
// Design, 32 <= W <= 1,024 (16-byte aligned arrays): the row in registers
// (warp_bitonic in bitonic.cuh), four warps a block, a warp a row below 256
// words and two from 256 (E = W / 32 G adjacent elements a lane, 16-byte
// loads and stores). The shared-memory network it replaces ran one thread
// a compare-exchange pair and a __syncthreads() over the whole block after
// each of the log2(W) (log2(W) + 1) / 2 substages (45 at W = 512); here
// substages below E run inside a thread, those up to 32 E with one shuffle
// a word, and those that pair a row's two warps through shared memory at
// the row's own named barrier: no block-wide barrier is left. Keys are
// full int32, compared signed (SignedDesc). With no payload only the keys
// travel. With payloads, each element's index rides beside its key as a
// register payload (two words an element: a shuffle and a select more a
// substage), the payloads wait in shared memory, and each is gathered by
// the final index at write-out. tools/k4_probe.py times this layout against
// the key and index packed in one 64-bit word, and one warp against two.
// Other widths (W < 32, and rows up to what check_fits allows) keep the
// shared-memory network of bitonic.cuh.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

namespace {

constexpr int kWarps = 4;              // warps a block (rows: kWarps / G)

// int32 keys carried as their bits, descending: a precedes b when a > b as
// signed integers. ~x = -x - 1 reverses the signed order, so flipping every
// bit reverses `before`, INT32_MIN and INT32_MAX included.
struct SignedDesc {
    static constexpr unsigned kFlip = 0xffffffffu;
    __device__ __forceinline__ bool operator()(unsigned a, unsigned b) const {
        return (int)a > (int)b;
    }
};

// A row of W = 32 E G keys on G = 2^LG warps, kWarps / G rows a block, NP
// payloads gathered by the final index.
template <int E, int LG, int NP>
__global__ void __launch_bounds__(kWarps * 32)
sort_windows_warp(const unsigned* __restrict__ keys,
                  const unsigned* __restrict__ pay0,
                  const unsigned* __restrict__ pay1,
                  unsigned* __restrict__ okeys, unsigned* __restrict__ opay0,
                  unsigned* __restrict__ opay1, long long R) {
    constexpr int W = 32 * E << LG;
    constexpr int NI = NP > 0 ? 1 : 0;      // the index, a register payload
    // The rows' payloads, and the exchange buffer of rows on two warps.
    __shared__ unsigned spay[NP > 0 ? NP * kWarps * 32 * E : 1];
    __shared__ unsigned xbuf[LG ? (1 + NI) * kWarps * 32 * E : 1];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int slot = wid >> LG;                     // the block's row
    const int part = wid & ((1 << LG) - 1);         // this warp's part of it
    const long long row = (long long)blockIdx.x * (kWarps >> LG) + slot;
    if (row >= R) return;                           // the row's warps alike
    const int first = (part * 32 + lane) * E;       // this lane's elements
    const long long base = row * W + first;
    unsigned* xrow = LG ? xbuf + slot * (1 + NI) * W : nullptr;
    unsigned key[E];
    load_run<E>(keys + base, key);
    if constexpr (NP == 0) {
        unsigned none[1][E];
        warp_bitonic<E, 0, LG>(key, none, lane, SignedDesc(), part, xrow,
                               1 + slot);
        store_run<E>(okeys + base, key);
    } else {
        unsigned* sp = spay + slot * NP * W;
        unsigned v[E];
        load_run<E>(pay0 + base, v);
        store_run<E>(sp + first, v);
        if constexpr (NP > 1) {
            load_run<E>(pay1 + base, v);
            store_run<E>(sp + W + first, v);
        }
        // With G > 1 the network's barriers order these stores before the
        // gather below; one warp has only itself to wait for.
        __syncwarp();
        unsigned idx[1][E];
#pragma unroll
        for (int r = 0; r < E; ++r) idx[0][r] = (unsigned)(first + r);
        warp_bitonic<E, 1, LG>(key, idx, lane, SignedDesc(), part, xrow,
                               1 + slot);
        store_run<E>(okeys + base, key);
#pragma unroll
        for (int r = 0; r < E; ++r) v[r] = sp[idx[0][r]];
        store_run<E>(opay0 + base, v);
        if constexpr (NP > 1) {
#pragma unroll
            for (int r = 0; r < E; ++r) v[r] = sp[W + idx[0][r]];
            store_run<E>(opay1 + base, v);
        }
    }
}

template <int E, int LG, int NP>
int launch_warp(const void* keys, const void* pay0, const void* pay1,
                void* okeys, void* opay0, void* opay1, long long R,
                cudaStream_t s) {
    constexpr int rows = kWarps >> LG;
    const long long blocks = (R + rows - 1) / rows;
    sort_windows_warp<E, LG, NP><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const unsigned*)keys, (const unsigned*)pay0, (const unsigned*)pay1,
        (unsigned*)okeys, (unsigned*)opay0, (unsigned*)opay1, R);
    return (int)cudaGetLastError();
}

// The register layout at width w: a warp a row below 256, two from 256.
// -1: not a register width.
template <int NP>
int launch_registers(const void* keys, const void* pay0, const void* pay1,
                     void* okeys, void* opay0, void* opay1, long long R,
                     int w, cudaStream_t s) {
    switch (w) {
        case 32: return launch_warp<1, 0, NP>(keys, pay0, pay1, okeys, opay0, opay1, R, s);
        case 64: return launch_warp<2, 0, NP>(keys, pay0, pay1, okeys, opay0, opay1, R, s);
        case 128: return launch_warp<4, 0, NP>(keys, pay0, pay1, okeys, opay0, opay1, R, s);
        case 256: return launch_warp<4, 1, NP>(keys, pay0, pay1, okeys, opay0, opay1, R, s);
        case 512: return launch_warp<8, 1, NP>(keys, pay0, pay1, okeys, opay0, opay1, R, s);
        case 1024: return launch_warp<16, 1, NP>(keys, pay0, pay1, okeys, opay0, opay1, R, s);
    }
    return -1;
}

template <int NP>
__global__ void sort_windows_kernel(const int* __restrict__ keys,
                                    const int* __restrict__ pay0,
                                    const int* __restrict__ pay1,
                                    int* __restrict__ okeys,
                                    int* __restrict__ opay0,
                                    int* __restrict__ opay1, long long R,
                                    int w, int rpb) {
    extern __shared__ int smem[];
    int* sk = smem;
    int* s0 = sk + (long long)rpb * w;
    int* s1 = s0 + (long long)rpb * w;
    const long long row0 = (long long)blockIdx.x * rpb;
    const int rows = (int)(R - row0 < rpb ? R - row0 : rpb);
    const long long base = row0 * w;
    const int n = rows * w;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        sk[e] = keys[base + e];
        if (NP > 0) s0[e] = pay0[base + e];
        if (NP > 1) s1[e] = pay1[base + e];
    }
    __syncthreads();
    bitonic_network<NP>(sk, s0, s1, w, rows, KeyDesc());
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
        okeys[base + e] = sk[e];
        if (NP > 0) opay0[base + e] = s0[e];
        if (NP > 1) opay1[base + e] = s1[e];
    }
}

template <int NP>
int launch(const void* keys, const void* pay0, const void* pay1,
           void* okeys, void* opay0, void* opay1, long long R, int w,
           bool aligned, cudaStream_t s) {
    if (aligned) {
        const int e = launch_registers<NP>(keys, pay0, pay1, okeys, opay0,
                                           opay1, R, w, s);
        if (e >= 0) return e;
    }
    SegmentLaunch g = segment_launch(R, w);
    size_t smem = (size_t)g.rows_per_block * w * sizeof(int) * (1 + NP);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            sort_windows_kernel<NP>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    sort_windows_kernel<NP><<<(unsigned)g.blocks, g.threads, smem, s>>>(
        (const int*)keys, (const int*)pay0, (const int*)pay1, (int*)okeys,
        (int*)opay0, (int*)opay1, R, w, g.rows_per_block);
    return (int)cudaGetLastError();
}

}  // namespace

// keys, okeys and the n_payloads payload arrays: (R, w) int32, w a power
// of two. Rows of 32 to 1,024 are sorted in registers when every array is
// 16-byte aligned (torch's allocations are); any other width or alignment
// takes the shared-memory network.
extern "C" int sort_windows(const void* keys, const void* pay0,
                            const void* pay1, void* okeys, void* opay0,
                            void* opay1, long long R, int w, int n_payloads,
                            void* stream) {
    if (R <= 0 || w <= 0) return 0;
    if (w & (w - 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    const uintptr_t a = reinterpret_cast<uintptr_t>(keys) |
                        reinterpret_cast<uintptr_t>(okeys) |
                        reinterpret_cast<uintptr_t>(pay0) |
                        reinterpret_cast<uintptr_t>(pay1) |
                        reinterpret_cast<uintptr_t>(opay0) |
                        reinterpret_cast<uintptr_t>(opay1);
    const bool aligned = a % 16 == 0;
    switch (n_payloads) {
        case 0: return launch<0>(keys, pay0, pay1, okeys, opay0, opay1, R, w, aligned, s);
        case 1: return launch<1>(keys, pay0, pay1, okeys, opay0, opay1, R, w, aligned, s);
        case 2: return launch<2>(keys, pay0, pay1, okeys, opay0, opay1, R, w, aligned, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
