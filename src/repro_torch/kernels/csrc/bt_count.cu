// Bit transitions at each flit boundary of an (F, L) word stream.
//
// Replaces the Pallas TPU kernel repro/kernels/bt_count.py
// (bt_boundaries_pallas): out[i] = sum_j popcount(words[i][j] ^ words[i+1][j]),
// the paper's Fig. 8 BT recorder over a materialised stream. Bound: memory -
// each word is read (twice: as row i and as row i+1; the second read hits L2)
// and one int32 is written per boundary; the arithmetic is one XOR, one
// __popc and one add per word. Design: one warp per boundary; lane j walks
// words j, j+32, ... of the two rows, then a warp-shuffle sum. Eight warps
// (eight boundaries) per block.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void bt_boundaries_kernel(const int32_t* __restrict__ words,
                                     int32_t* __restrict__ out, int F,
                                     int L) {
    int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    int lane = threadIdx.x & 31;
    if (warp >= F - 1) return;
    const int32_t* a = words + (long long)warp * L;
    const int32_t* b = a + L;
    int acc = 0;
    for (int j = lane; j < L; j += 32)
        acc += __popc((unsigned)(a[j] ^ b[j]));
    for (int off = 16; off > 0; off >>= 1)
        acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[warp] = acc;
}

extern "C" int bt_boundaries(const void* words, void* out, int F, int L,
                             void* stream) {
    if (F <= 1) return 0;
    const int threads = 256;                       // 8 warps per block
    long long warps = F - 1;
    int blocks = (int)((warps * 32 + threads - 1) / threads);
    bt_boundaries_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)words, (int32_t*)out, F, L);
    return (int)cudaGetLastError();
}
