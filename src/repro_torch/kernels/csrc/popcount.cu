// Popcount of each 32-bit word: '1'-bit count as int32.
//
// Replaces the Pallas TPU kernel repro/kernels/popcount.py
// (popcount_words_pallas), which ran the SWAR reduction because the TPU's
// vector unit has no popcount. Hopper has one (__popc), so each word is one
// instruction. Bound: memory - 4 bytes read and 4 written per word, one
// integer op. Design: 16-byte vector loads and stores (int4) over the
// aligned body, a scalar loop for the tail, grid-stride so any size fits a
// fixed grid.
#include <cstdint>
#include <cuda_runtime.h>

__global__ void popcount_vec4(const int4* __restrict__ in,
                              int4* __restrict__ out, long long n4) {
    long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (; i < n4; i += stride) {
        int4 v = in[i];
        int4 r;
        r.x = __popc((unsigned)v.x);
        r.y = __popc((unsigned)v.y);
        r.z = __popc((unsigned)v.z);
        r.w = __popc((unsigned)v.w);
        out[i] = r;
    }
}

__global__ void popcount_scalar(const int32_t* __restrict__ in,
                                int32_t* __restrict__ out, long long start,
                                long long n) {
    long long i = start + blockIdx.x * (long long)blockDim.x + threadIdx.x;
    long long stride = (long long)gridDim.x * blockDim.x;
    for (; i < n; i += stride) out[i] = __popc((unsigned)in[i]);
}

extern "C" int popcount_words(const void* in, void* out, long long n,
                              void* stream) {
    if (n <= 0) return 0;
    cudaStream_t s = (cudaStream_t)stream;
    const int threads = 256;
    const int max_blocks = 132 * 16;
    bool aligned = ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    long long n4 = aligned ? n / 4 : 0;
    if (n4 > 0) {
        long long blocks = (n4 + threads - 1) / threads;
        if (blocks > max_blocks) blocks = max_blocks;
        popcount_vec4<<<(int)blocks, threads, 0, s>>>(
            (const int4*)in, (int4*)out, n4);
    }
    long long rest = n - n4 * 4;
    if (rest > 0) {
        long long blocks = (rest + threads - 1) / threads;
        if (blocks > max_blocks) blocks = max_blocks;
        popcount_scalar<<<(int)blocks, threads, 0, s>>>(
            (const int32_t*)in, (int32_t*)out, n4 * 4, n);
    }
    return (int)cudaGetLastError();
}
