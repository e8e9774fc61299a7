// NoC router cycles: `cycles` steps of the whole-mesh router in one launch.
//
// Replaces the Pallas TPU kernel repro/kernels/router_step.py
// (make_router_step / router_step_pallas, body _make_kernel), which ran ONE
// cycle per pallas_call under the lax.scan of repro/noc/sim.py
// (_chunk_runner). Semantics are those of the plain step
// (repro_torch.noc.sim.plain_step, itself a copy of repro.noc.sim._make_step
// with faults=None, track=False), bit for bit:
//   1. front-sideband gather, closed-form X-Y route, credit check against
//      the downstream FIFO counts at the start of the cycle;
//   2. masked-min round-robin switch allocation per (router, out-port),
//      pops, link BT (XOR + popcount, with or without count_headers);
//   3. receiver-side pushes into post-pop FIFOs, and the injection reads;
//   4. injection writes, NI-link BT, ejected/drained/cycle bookkeeping.
// A __syncthreads() separates the phases, so every phase reads the state
// the previous one left, exactly as the JAX step's dataflow does.
//
// Design. One thread block per variant lane (gridDim.x = B); a loop inside
// the block replaces the scan, so a launch runs a whole chunk of cycles.
// The FIFO tensor stays in global memory (an 8x8 lane's is ~350 KB, more
// than an SM's shared memory) and is L2-resident; per-cycle arbitration
// scratch lives in shared memory. The injection-row gather happens inside
// the kernel. Masked-out writes (the reference's phantom-row scatters) are
// skipped, so the phantom router row of the FIFO is never written.
// A lane whose every flit has ejected (and whose drain cycle is recorded)
// can change no state but `cycle`, so the remaining cycles of the launch
// are added at once.
//
// Bound: a cycle depends on the previous one, so the work is a chain of
// `cycles` dependent steps of a few hundred integer ops per router; the
// card's memory rate and ALU rate are far from the limit. Latency of the
// four barrier-separated phases per cycle is what bounds it.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 5;          // ports: N E S W Local
constexpr int PORT_N = 0, PORT_E = 1, PORT_S = 2, PORT_W = 3, PORT_LOCAL = 4;
constexpr int DEST_MASK = (1 << 9) - 1;
constexpr int META_SHIFT = 9;
constexpr int VC_SHIFT = 11;
constexpr int META_PAYLOAD = 1;

struct Dims {
    int rows, cols, nr, V, D, L, LF, M, T, nslots;
};

__device__ __forceinline__ bool dir_ok(const Dims& g, int r, int dir) {
    int rr = r / g.cols, cc = r % g.cols;
    switch (dir) {
        case PORT_N: return rr > 0;
        case PORT_E: return cc < g.cols - 1;
        case PORT_S: return rr < g.rows - 1;
        default: return cc > 0;       // PORT_W
    }
}

__device__ __forceinline__ int neighbor(const Dims& g, int r, int dir) {
    switch (dir) {
        case PORT_N: return r - g.cols;
        case PORT_E: return r + 1;
        case PORT_S: return r + g.cols;
        default: return r - 1;        // PORT_W
    }
}

__global__ void router_cycles(
        int32_t* __restrict__ fifo_all, int32_t* __restrict__ head_all,
        int32_t* __restrict__ count_all, int32_t* __restrict__ rr_all,
        int32_t* __restrict__ link_last_all, int32_t* __restrict__ link_bt_all,
        int32_t* __restrict__ link_flits_all, int32_t* __restrict__ inj_ptr_all,
        int32_t* __restrict__ inj_last_all, int32_t* __restrict__ inj_bt_all,
        int32_t* __restrict__ ejected_all, int32_t* __restrict__ cycle_all,
        int32_t* __restrict__ drained_all, const int32_t* __restrict__ wire_all,
        const int32_t* __restrict__ length_all,
        const int32_t* __restrict__ mc_all, Dims g, int cycles,
        int count_headers) {
    extern __shared__ int smem[];
    const int npo = g.nr * P;                 // (router, port) pairs
    int* s_row = smem;                        // winner flit row, per (r, o)
    int* s_winv = s_row + npo;                // winner VC, per (r, o)
    int* s_irow = s_winv + npo;               // injection FIFO row, per m
    int* s_ipv = s_irow + g.M;                // injection FIFO block, per m
    signed char* s_req = (signed char*)(s_ipv + g.M);  // out-port or -1
    signed char* s_has = s_req + g.nr * g.nslots;
    signed char* s_can = s_has + npo;
    __shared__ int s_eject, s_total, s_done;

    const int b = blockIdx.x;
    const long long fifo_rows = (long long)(g.nr + 1) * P * g.V * g.D;
    int32_t* fifo = fifo_all + b * fifo_rows * g.LF;
    int32_t* head = head_all + (long long)b * (g.nr + 1) * P * g.V;
    int32_t* count = count_all + (long long)b * (g.nr + 1) * P * g.V;
    int32_t* rr = rr_all + (long long)b * npo;
    int32_t* link_last = link_last_all + (long long)b * npo * g.L;
    int32_t* link_bt = link_bt_all + (long long)b * npo;
    int32_t* link_flits = link_flits_all + (long long)b * npo;
    int32_t* inj_ptr = inj_ptr_all + (long long)b * g.M;
    int32_t* inj_last = inj_last_all + (long long)b * g.M * g.L;
    int32_t* inj_bt = inj_bt_all + (long long)b * g.M;
    const int32_t* wire = wire_all + (long long)b * g.M * g.T * g.LF;
    const int32_t* length = length_all + (long long)b * g.M;
    const int32_t* mc = mc_all + (long long)b * g.M;
    const int tid = threadIdx.x, nt = blockDim.x;

    if (tid == 0) {
        int tot = 0;
        for (int m = 0; m < g.M; ++m) tot += length[m];
        s_total = tot;
        s_eject = 0;
        s_done = (ejected_all[b] >= tot) && (drained_all[b] >= 0);
    }
    __syncthreads();

    int c = 0;
    for (; c < cycles; ++c) {
        if (s_done) break;

        // --- phase 1: route + credit check per (router, slot) ---
        for (int i = tid; i < g.nr * g.nslots; i += nt) {
            int r = i / g.nslots;
            int hc = i;                      // (r * P + p) * V + v
            int out = -1;
            int cnt = count[hc];
            if (cnt > 0) {
                int h = head[hc];
                int side = fifo[((long long)hc * g.D + h) * g.LF + g.L];
                int fd = side & DEST_MASK;
                int dr = fd / g.cols, dc = fd % g.cols;
                int rrow = r / g.cols, rcol = r % g.cols;
                int o = dc > rcol ? PORT_E : dc < rcol ? PORT_W
                      : dr > rrow ? PORT_S : dr < rrow ? PORT_N : PORT_LOCAL;
                bool space = true;           // off-mesh: phantom block, 0 < D
                if (o != PORT_LOCAL && dir_ok(g, r, o)) {
                    int v = (i % g.nslots) % g.V;
                    int blk = (neighbor(g, r, o) * P + ((o + 2) & 3)) * g.V + v;
                    space = count[blk] < g.D;
                }
                if (space) out = o;
            }
            s_req[i] = (signed char)out;
        }
        __syncthreads();

        // --- phase 2: round-robin allocation, pops, link BT ---
        for (int j = tid; j < npo; j += nt) {
            int r = j / P, o = j % P;
            int rrv = rr[j];
            int best = g.nslots;
            const signed char* req = s_req + r * g.nslots;
            for (int s = 0; s < g.nslots; ++s) {
                if (req[s] == o) {
                    int rel = s - rrv;
                    if (rel < 0) rel += g.nslots;
                    if (rel < best) best = rel;
                }
            }
            if (best < g.nslots) {
                int winner = rrv + best;
                if (winner >= g.nslots) winner -= g.nslots;
                int nxt = winner + 1;
                rr[j] = nxt >= g.nslots ? nxt - g.nslots : nxt;
                int hc = r * g.nslots + winner;
                int h = head[hc];
                head[hc] = (h + 1) % g.D;
                count[hc] -= 1;
                long long row = (long long)hc * g.D + h;
                const int32_t* flit = fifo + row * g.LF;
                int32_t* last = link_last + (long long)j * g.L;
                int tog = 0;
                for (int k = 0; k < g.L; ++k) {
                    int w = flit[k];
                    tog += __popc((unsigned)(last[k] ^ w));
                    last[k] = w;
                }
                int meta = (flit[g.L] >> META_SHIFT) & 3;
                if (count_headers || (meta & META_PAYLOAD)) link_bt[j] += tog;
                link_flits[j] += 1;
                s_has[j] = 1;
                s_winv[j] = winner % g.V;
                s_row[j] = (int)row;
                if (o == PORT_LOCAL) atomicAdd(&s_eject, 1);
            } else {
                s_has[j] = 0;
            }
        }
        __syncthreads();

        // --- phase 3: receiver-side pushes; injection reads ---
        for (int i = tid; i < g.nr * 4 + g.M; i += nt) {
            if (i < g.nr * 4) {
                int r = i >> 2, ip = i & 3;
                if (!dir_ok(g, r, ip)) continue;
                int src = neighbor(g, r, ip) * P + ((ip + 2) & 3);
                if (!s_has[src]) continue;
                int hc = (r * P + ip) * g.V + s_winv[src];
                int wslot = (head[hc] + count[hc]) % g.D;
                const int32_t* from = fifo + (long long)s_row[src] * g.LF;
                int32_t* to = fifo + ((long long)hc * g.D + wslot) * g.LF;
                for (int k = 0; k < g.LF; ++k) to[k] = from[k];
                count[hc] += 1;
            } else {
                int m = i - g.nr * 4;
                int ptr = inj_ptr[m];
                s_can[m] = 0;
                if (ptr >= length[m]) continue;
                const int32_t* w = wire + ((long long)m * g.T + ptr) * g.LF;
                int ivc = w[g.L] >> VC_SHIFT;
                int pv = (mc[m] * P + PORT_LOCAL) * g.V + ivc;
                int cnt = count[pv];
                if (cnt < g.D) {
                    s_can[m] = 1;
                    s_ipv[m] = pv;
                    s_irow[m] = pv * g.D + (head[pv] + cnt) % g.D;
                }
            }
        }
        __syncthreads();

        // --- phase 4: injection writes, NI-link BT, bookkeeping ---
        for (int m = tid; m < g.M; m += nt) {
            if (!s_can[m]) continue;
            int ptr = inj_ptr[m];
            const int32_t* w = wire + ((long long)m * g.T + ptr) * g.LF;
            int32_t* to = fifo + (long long)s_irow[m] * g.LF;
            int32_t* last = inj_last + (long long)m * g.L;
            int tog = 0;
            for (int k = 0; k < g.L; ++k) {
                int x = w[k];
                to[k] = x;
                tog += __popc((unsigned)(last[k] ^ x));
                last[k] = x;
            }
            to[g.L] = w[g.L];
            atomicAdd(&count[s_ipv[m]], 1);
            inj_ptr[m] = ptr + 1;
            int meta = (w[g.L] >> META_SHIFT) & 3;
            if (count_headers || (meta & META_PAYLOAD)) inj_bt[m] += tog;
        }
        if (tid == 0) {
            int ej = ejected_all[b] + s_eject;
            s_eject = 0;
            ejected_all[b] = ej;
            int cyc = cycle_all[b];
            if (drained_all[b] < 0 && ej >= s_total) drained_all[b] = cyc + 1;
            cycle_all[b] = cyc + 1;
            s_done = (ej >= s_total) && (drained_all[b] >= 0);
        }
        __syncthreads();
    }
    if (tid == 0 && c < cycles) cycle_all[b] += cycles - c;
}

}  // namespace

extern "C" int router_step_run(
        void* fifo, void* head, void* count, void* rr, void* link_last,
        void* link_bt, void* link_flits, void* inj_ptr, void* inj_last,
        void* inj_bt, void* ejected, void* cycle, void* drained,
        const void* wire, const void* length, const void* mc_nodes, int B,
        int rows, int cols, int V, int D, int L, int M, int T, int cycles,
        int count_headers, void* stream) {
    if (B <= 0 || cycles <= 0) return 0;
    Dims g;
    g.rows = rows; g.cols = cols; g.nr = rows * cols; g.V = V; g.D = D;
    g.L = L; g.LF = L + 1; g.M = M; g.T = T; g.nslots = P * V;
    size_t smem = sizeof(int) * (2 * (size_t)g.nr * P + 2 * (size_t)M)
                + (size_t)g.nr * g.nslots + (size_t)g.nr * P + (size_t)M;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            router_cycles, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    router_cycles<<<B, 512, smem, (cudaStream_t)stream>>>(
        (int32_t*)fifo, (int32_t*)head, (int32_t*)count, (int32_t*)rr,
        (int32_t*)link_last, (int32_t*)link_bt, (int32_t*)link_flits,
        (int32_t*)inj_ptr, (int32_t*)inj_last, (int32_t*)inj_bt,
        (int32_t*)ejected, (int32_t*)cycle, (int32_t*)drained,
        (const int32_t*)wire, (const int32_t*)length, (const int32_t*)mc_nodes,
        g, cycles, count_headers);
    return (int)cudaGetLastError();
}
