// Distance + select body of one O3 chain step: for each row of one or two
// (R, W) XOR planes (window ^ current value), the summed popcount distance
// dvec, and the lane indices sorted ascending by dvec * k2 + idx + penalty.
//
// Replaces the Pallas TPU kernel repro/kernels/min_hamming.py
// (chain_select_pallas, body _make_select_kernel), which computed SWAR
// popcounts in VMEM, negated the keys and ran the descending bitonic
// network with the lane index as payload over a row padded to a power of
// two >= 128. Here the distance is one __popc a plane as the row is loaded
// into shared memory, the row is padded only to the next power of two
// (padding lanes take key INT_MAX and their own index, so they sort behind
// every real lane), and the shared network (bitonic.cuh) sorts ascending
// on (key, lane index): a stable ascending sort of the key for any input,
// so there is no negation that could overflow. All key arithmetic is
// 32-bit and wraps as the plain int32 version does.
//
// Bound: per row, 4 bytes read a plane and the penalty and 8 written per
// lane, against log2(Wp) * (log2(Wp)+1) / 2 substages of Wp/2
// compare-exchanges; as for the window sort the bytes bound it on paper
// and the barrier-separated substages in practice. Rows of W < 2048 share
// a block (see bitonic.cuh). Wp = 16384 (two 64 KB arrays) is the widest
// row that fits a block's shared memory.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bitonic.cuh"

template <int NPL>
__global__ void chain_select_kernel(const int* __restrict__ x0,
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
static int launch(const void* x0, const void* x1, const void* pen, void* dvec,
                  void* order, long long R, int w, int wp, int k2,
                  cudaStream_t s) {
    SegmentLaunch g = segment_launch(R, wp);
    size_t smem = (size_t)g.rows_per_block * wp * sizeof(int) * 2;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            chain_select_kernel<NPL>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    chain_select_kernel<NPL><<<(unsigned)g.blocks, g.threads, smem, s>>>(
        (const int*)x0, (const int*)x1, (const int*)pen, (int*)dvec,
        (int*)order, R, w, wp, k2, g.rows_per_block);
    return (int)cudaGetLastError();
}

extern "C" int chain_select(const void* x0, const void* x1, const void* pen,
                            void* dvec, void* order, long long R, int w,
                            int n_planes, int k2, void* stream) {
    if (R <= 0 || w <= 0) return 0;
    int wp = 1;
    while (wp < w) wp <<= 1;
    cudaStream_t s = (cudaStream_t)stream;
    switch (n_planes) {
        case 1: return launch<1>(x0, x1, pen, dvec, order, R, w, wp, k2, s);
        case 2: return launch<2>(x0, x1, pen, dvec, order, R, w, wp, k2, s);
        default: return (int)cudaErrorInvalidValue;
    }
}
