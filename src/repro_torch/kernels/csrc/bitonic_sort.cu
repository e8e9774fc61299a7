// Descending bitonic key sort of each row of an (R, W) int32 key array,
// with up to two int32 payload arrays riding the same swaps.
//
// Replaces the Pallas TPU kernel repro/kernels/bitonic_sort.py
// (sort_windows_pallas), which ran the network over (8, W) row tiles in
// VMEM. Here whole rows sit in shared memory (several rows a block where
// W is small, see bitonic.cuh), are sorted by the shared network with one
// thread per compare-exchange pair, and are written back once. Bound: a
// row costs W/2 * log2(W) * (log2(W)+1) / 2 compare-exchanges (11,520 at
// W = 512, about 5 integer ops each with one payload) against 8 bytes a
// lane read and written per array, so on paper the bytes bound it (W = 512:
// 2.4 ns of HBM time a row against 0.9 ns of ALU time); in practice the
// 45 dependent substages, each behind a block barrier, do. The design
// keeps every substage in shared memory so HBM is touched once each way.
// W must be a power of two; a row of keys and its payloads must fit a
// block's 227 KB of shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

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
static int launch(const void* keys, const void* pay0, const void* pay1,
                  void* okeys, void* opay0, void* opay1, long long R, int w,
                  cudaStream_t s) {
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

extern "C" int sort_windows(const void* keys, const void* pay0,
                            const void* pay1, void* okeys, void* opay0,
                            void* opay1, long long R, int w, int n_payloads,
                            void* stream) {
    if (R <= 0 || w <= 0) return 0;
    if (w & (w - 1)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    switch (n_payloads) {
        case 0: return launch<0>(keys, pay0, pay1, okeys, opay0, opay1, R, w, s);
        case 1: return launch<1>(keys, pay0, pay1, okeys, opay0, opay1, R, w, s);
        case 2: return launch<2>(keys, pay0, pay1, okeys, opay0, opay1, R, w, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
