// The fused ordering unit: popcount keys + descending bitonic sort of each
// row of (R, W) 32-bit words, returning the ordered words and the
// window-local permutation (O2's recovery index).
//
// Replaces the Pallas TPU kernel repro/kernels/order_unit.py
// (order_unit_pallas), which computed SWAR popcount keys in VMEM (the TPU
// vector unit has no popcount) and ran the bitonic network with (value,
// lane index) as payloads. Here each key is one __popc as the row is
// loaded into shared memory; the network is the one the window sort uses
// (bitonic.cuh), with the same payloads in the same order, so the output
// equals the reference's bit for bit, ties included. Bound: as for the
// window sort - bytes on paper (4 read and 8 written a lane), the chain of
// log2(W) * (log2(W)+1) / 2 barrier-separated substages in practice; the
// keys never touch HBM. W must be a power of two; three int32 arrays of a
// row must fit a block's 227 KB of shared memory.
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

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

extern "C" int order_unit(const void* vals, void* ovals, void* operm,
                          long long R, int w, void* stream) {
    if (R <= 0 || w <= 0) return 0;
    if (w & (w - 1)) return (int)cudaErrorInvalidValue;
    SegmentLaunch g = segment_launch(R, w);
    size_t smem = (size_t)g.rows_per_block * w * sizeof(int) * 3;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            order_unit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    order_unit_kernel<<<(unsigned)g.blocks, g.threads, smem,
                        (cudaStream_t)stream>>>(
        (const int*)vals, (int*)ovals, (int*)operm, R, w, g.rows_per_block);
    return (int)cudaGetLastError();
}
