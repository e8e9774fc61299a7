// NoC router cycles: `cycles` steps of the whole-mesh router in one launch,
// with each lane's routing state held in shared memory for the whole launch.
//
// Replaces the Pallas TPU kernel repro/kernels/router_step.py
// (make_router_step / router_step_pallas, body _make_kernel), which ran ONE
// cycle per pallas_call under the lax.scan of repro/noc/sim.py
// (_chunk_runner). Semantics are those of the plain step
// (repro_torch.noc.sim.plain_step, itself a copy of repro.noc.sim._make_step
// with faults=None, track=False), bit for bit on every real router row.
//
// Bound. A cycle reads the state the previous one left, so a launch is a
// chain of `cycles` dependent steps. One cycle of an 8x8 lane moves at most
// 320 flits (~22 KB) and does a few thousand integer operations: the card's
// memory and ALU rates are far from the limit. What bounds it is the
// latency of one cycle: its chains of dependent shared-memory loads (~30
// clocks each on an H100), one L2 round trip for the popped flits where the
// FIFO payload stays in global memory (~450-700 clocks with the block's
// other loads in flight), shared-memory atomics (~170 clocks under load),
// a few thousand warp instructions to dispatch on the SM's four
// schedulers, and the block barriers (~50 clocks at 640 threads). Floor,
// an estimate and not a measurement: ~10 dependent shared-memory steps and
// one L2 round trip, ~1,500 clocks, about 0.8 us a cycle at 8x8 (PERF.md
// has the measured time, which is several times this).
//
// Design.
//  * One block per variant lane (gridDim.x = B); a loop over the chunk's
//    cycles inside the block replaces the scan, with no host
//    synchronisation inside a launch.
//  * At launch start the block loads head, count, rr, the link BT and flit
//    counters, the injection pointers, NI-link words and BT, and the
//    sideband word of every FIFO slot into dynamic shared memory, and stores
//    them back once at the end. link_last and the FIFO payload join them
//    where they fit. The wrapper (router_step.py, smem_layout) places every
//    array by the mesh's shape and passes the word offsets; a template
//    parameter per optional placement keeps one source for every mesh.
//  * The paper's routers (4 VCs of 4 flits, 16-word flits) run an
//    instantiation with that geometry compiled in, which folds every
//    division and word loop: a cycle is a chain of dependent steps, so
//    fewer instructions on it is less time.
//  * Two barriers a cycle:
//    1. route + credit: per FIFO, the front sideband, the closed-form X-Y
//       route and the credit check against the start-of-cycle counts; the
//       request is one byte per FIFO; the FIFO's tail slot (head + count)
//       % D and its count are recorded. Per stream, the local FIFO its next
//       flit goes to; wire rows are fetched RING - 1 cycles ahead with
//       cp.async. The previous cycle's ejected / drained / cycle
//       bookkeeping.
//    2. arbitration + pops + pushes + injection: two threads per (router,
//       out-port); the even one takes the first requesting slot at or after
//       the round-robin pointer (the router's request bytes compared four
//       at a time), pops it, and each moves half of the flit's words,
//       adding the link BT, straight into the downstream FIFO's recorded
//       tail slot. A pop adds one to head and takes one from count, so that
//       slot is the one the plain step pushes to after the pops; the credit
//       check keeps count < D, so it is never the head slot another thread
//       pops in the same phase. Sixteen threads per stream inject into the
//       local FIFO (which no push reaches) at its recorded tail slot when it
//       had room. When it was full, the injection needs that FIFO's pop,
//       which the stream's threads work out from the request bytes and the
//       round-robin pointers of the cycle's start (kept in two buffers), and
//       the popping thread, which reads the head slot, writes the new flit
//       into it. That thread finds the stream in one read: phase 1 records,
//       for each local FIFO, the stream whose next flit goes there (a
//       result drain has up to 240 streams, one per PE, where a scan of
//       every stream would sit on each such pop: 12 % of a cycle at 240
//       streams on an H100 80GB HBM3 at 700 W, tools/k1_pop_probe.py).
//       Two streams with flits left never share a router (one stream an
//       MC, or a PE; padding streams are empty), so each local FIFO has at
//       most one writer.
//       Counts move by shared-memory atomics (a FIFO may be popped and
//       pushed in one phase).
//  * The phantom router row of the FIFO is never read or written.
//  * A lane whose every flit has ejected (and whose drain cycle is recorded)
//    can change no state but `cycle`, so the remaining cycles of the launch
//    are added at once.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int P = 5;          // ports: N E S W Local
constexpr int PORT_N = 0, PORT_E = 1, PORT_S = 2, PORT_W = 3, PORT_LOCAL = 4;
constexpr int DEST_MASK = (1 << 9) - 1;
constexpr int META_SHIFT = 9;
constexpr int VC_SHIFT = 11;
constexpr int META_PAYLOAD = 1;
constexpr int MAX_THREADS = 1024;
constexpr int CHUNK = 8;      // flit words a thread holds in registers at once
constexpr int GROUP = 16;     // threads per injecting stream
constexpr unsigned char NO_REQUEST = 0xFF;
// Wire rows fetched ahead per stream: a stream's row is fetched RING - 1
// cycles before its injection can first use it (and RING - 2 before the
// route phase reads its sideband), so the wire's HBM latency hides behind
// that many cycles. A power of two; router_step.py INJ_RING.
constexpr int RING = 4;
// A stream's next injection: its local FIFO, and the ring slot of its row
// above bit RING_SHIFT.
constexpr int RING_SHIFT = 24;

struct Dims {
    int rows, cols, nr, V, D, L, M, T;
    // ceil(2^32 / n): x / n == (x * mag) >> 32 for every x the kernel divides
    unsigned long long mag_slots, mag_v, mag_cols, mag_lf, mag_d;
};

// Word offsets of each array in dynamic shared memory, in the order of
// router_step.py LAYOUT_FIELDS; side, last and pay are -1 where that leaf
// stays in global memory.
struct Layout {
    int head, count, rr, link_bt, link_flits, inj_ptr, inj_bt, inj_last,
        length, mc, inj_top, inj_next, tail, req, inj_row, local_stream, side,
        last, pay;
};
constexpr int LAYOUT_FIELDS = 19;

// One lane's tensors (lane 0's base pointers; the kernel adds its lane).
struct Lanes {
    int32_t *fifo, *head, *count, *rr, *link_last, *link_bt, *link_flits,
        *inj_ptr, *inj_last, *inj_bt, *ejected, *cycle, *drained;
    const int32_t *wire, *length, *mc;
};

__device__ __forceinline__ unsigned div_mag(unsigned x,
                                            unsigned long long mag) {
    return (unsigned)((x * mag) >> 32);
}

// x / n: by the constant N when it is known at compile time (N > 0).
template <int N>
__device__ __forceinline__ int divide(unsigned x, unsigned long long mag) {
    return N ? (int)(x / (unsigned)N) : (int)div_mag(x, mag);
}

__device__ __forceinline__ bool dir_ok(const Dims& g, int rrow, int rcol,
                                       int dir) {
    switch (dir) {
        case PORT_N: return rrow > 0;
        case PORT_E: return rcol < g.cols - 1;
        case PORT_S: return rrow < g.rows - 1;
        default: return rcol > 0;     // PORT_W
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

// The round-robin winner of out-port o: the first slot at or after `from`
// (cyclically) whose request byte is o, or -1. `req` is the router's row of
// request bytes (4-byte aligned, padded with NO_REQUEST).
__device__ __forceinline__ int arbitrate(int nslots,
                                         const unsigned char* req, int o,
                                         int from) {
    if (nslots <= 32) {
        const unsigned* w = (const unsigned*)req;
        const unsigned pat = 0x01010101u * (unsigned)o;
        unsigned bits = 0;
#pragma unroll
        for (int q = 0; q < 8; ++q)
            if (4 * q < nslots) {
                // 0xFF in each byte equal to o, then one bit per byte
                unsigned x = __vcmpeq4(w[q], pat) & 0x01010101u;
                bits |= ((x * 0x01020408u) >> 24) << (4 * q);
            }
        if (!bits) return -1;
        unsigned hi = bits & (~0u << from);
        return __ffs(hi ? hi : bits) - 1;
    }
    int best = -1, best_rel = nslots;
    for (int s = 0; s < nslots; ++s)
        if (req[s] == o) {
            int rel = s - from;
            if (rel < 0) rel += nslots;
            if (rel < best_rel) { best_rel = rel; best = s; }
        }
    return best;
}

// One word from global into shared memory without waiting for it.
__device__ __forceinline__ void fetch_word_async(int* dst, const int* src) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(s), "l"(src) : "memory");
}

// Close this thread's fetches of the cycle into one group.
__device__ __forceinline__ void fetch_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's fetches of all but the last RING - 2 cycles.
__device__ __forceinline__ void fetch_wait_ring() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(RING - 2) : "memory");
}

// Wait for every fetch this thread started.
__device__ __forceinline__ void fetch_wait_all() {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Fetch word k of stream m's wire row `row` into its ring slot.
__device__ __forceinline__ void fetch_row_word(int* irow, const int32_t* wire,
                                               const Dims& g, int LF, int m,
                                               int k, int row) {
    fetch_word_async(irow + (m * RING + (row & (RING - 1))) * LF + k,
                     wire + ((long long)m * g.T + row) * LF + k);
}

// CV, CD, CL: the VCs per port, the FIFO depth and the flit's words when
// fixed at compile time (the paper's routers: 4, 4, 16), else 0 and read
// from Dims; fixed, every division and word loop folds.
template <bool SIDE_S, bool LAST_S, bool PAY_S, int CV, int CD, int CL>
__global__ void __launch_bounds__(MAX_THREADS) router_cycles(
        Lanes a, Dims g, Layout lay, int cycles, int count_headers) {
    extern __shared__ int smem[];
    __shared__ int s_eject, s_done;

    const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
    const int lane = tid & 31;
    const int npo = g.nr * P;                 // (router, port) pairs
    const int V = CV ? CV : g.V, D = CD ? CD : g.D, L = CL ? CL : g.L;
    const int LF = L + 1, nslots = P * V, RS = (nslots + 3) & ~3;
    constexpr int CS = P * CV, CLF = CL ? CL + 1 : 0;
    const int nf = npo * V;                   // real FIFOs (router, port, VC)
    const int nrow = nf * D;                  // real FIFO slots
    // link_last rows: padded to LF words in shared memory (an odd stride, so
    // the threads of a warp hit distinct banks), L in global memory.
    const int LST = LAST_S ? LF : L;
    const long long fifo_rows = (long long)(g.nr + 1) * P * V * D;
    int32_t* fifo = a.fifo + b * fifo_rows * LF;
    int32_t* head_g = a.head + (long long)b * (g.nr + 1) * P * V;
    int32_t* count_g = a.count + (long long)b * (g.nr + 1) * P * V;
    int32_t* rr_g = a.rr + (long long)b * npo;
    int32_t* last_g = a.link_last + (long long)b * npo * L;
    int32_t* lbt_g = a.link_bt + (long long)b * npo;
    int32_t* lfl_g = a.link_flits + (long long)b * npo;
    int32_t* iptr_g = a.inj_ptr + (long long)b * g.M;
    int32_t* ilast_g = a.inj_last + (long long)b * g.M * L;
    int32_t* ibt_g = a.inj_bt + (long long)b * g.M;
    const int32_t* wire = a.wire + (long long)b * g.M * g.T * LF;

    int* head = smem + lay.head;
    int* count = smem + lay.count;
    int* rr_cur = smem + lay.rr;              // two buffers of npo words
    int* rr_nxt = rr_cur + npo;
    int* lbt = smem + lay.link_bt;
    int* lfl = smem + lay.link_flits;
    int* iptr = smem + lay.inj_ptr;
    int* ibt = smem + lay.inj_bt;
    int* ilast = smem + lay.inj_last;         // rows of LF words
    int* len = smem + lay.length;
    int* mcn = smem + lay.mc;
    int* itop = smem + lay.inj_top;           // wire rows fetched: [.., itop)
    int* inext = smem + lay.inj_next;         // FIFO | ring slot, or -1
    int* tail = smem + lay.tail;              // tail slot | count << 16
    unsigned char* req = (unsigned char*)(smem + lay.req);
    int* irow = smem + lay.inj_row;
    // Per local FIFO (router, VC): the stream that last found its next flit
    // bound there; a reader checks it against that stream's inj_next.
    int* lstream = smem + lay.local_stream;
    int* side = smem + lay.side;              // [slot][FIFO], when SIDE_S
    int* last = LAST_S ? smem + lay.last : last_g;
    int* pay = smem + lay.pay;                // FIFO rows, when PAY_S
    const bool keeper = tid == nt - 1;        // the lane's bookkeeping
    // Phase 2's items: a pair of threads per (router, out-port), then, from
    // a warp boundary on, GROUP threads per stream.
    const int ibase = (2 * npo + 31) & ~31;
    const int items = ibase + GROUP * g.M;

    // --- launch start: the lane's routing state into shared memory ---
    for (int i = tid; i < nf; i += nt) {
        head[i] = head_g[i];
        count[i] = count_g[i];
    }
    for (int j = tid; j < npo; j += nt) {
        rr_cur[j] = rr_g[j];
        lbt[j] = lbt_g[j];
        lfl[j] = lfl_g[j];
    }
    for (int k = tid; k < g.nr * RS; k += nt) req[k] = NO_REQUEST;
    for (int k = tid; k < g.nr * V; k += nt) lstream[k] = -1;
    for (int m = tid; m < g.M; m += nt) {
        iptr[m] = iptr_g[m];
        ibt[m] = ibt_g[m];
        len[m] = a.length[(long long)b * g.M + m];
        mcn[m] = a.mc[(long long)b * g.M + m];
        for (int k = 0; k < L; ++k) ilast[m * LF + k] = ilast_g[m * L + k];
    }
    // The first RING rows of every stream's ring.
    for (int j = tid; j < g.M * LF; j += nt) {
        int m = divide<CLF>(j, g.mag_lf);
        int ptr = iptr_g[m], n = a.length[(long long)b * g.M + m];
        for (int row = ptr; row < ptr + RING && row < n; ++row)
            fetch_row_word(irow, wire, g, LF, m, j - m * LF, row);
        if (j == m * LF) itop[m] = ptr + RING;
    }
    fetch_wait_all();
    if (LAST_S)
        for (int j = tid; j < npo; j += nt)
            for (int k = 0; k < L; ++k) last[j * LST + k] = last_g[j * L + k];
    if (PAY_S)
        for (int k = tid; k < nrow * LF; k += nt) pay[k] = fifo[k];
    if (SIDE_S)
        for (int i = tid; i < nf; i += nt)
            for (int h = 0; h < D; ++h)
                side[h * nf + i] = fifo[((long long)i * D + h) * LF + L];
    int tot = 0, ej = 0, cyc = 0, drained = 0;
    if (keeper) {
        for (int m = 0; m < g.M; ++m) tot += a.length[(long long)b * g.M + m];
        ej = a.ejected[b];
        cyc = a.cycle[b];
        drained = a.drained[b];
        s_eject = 0;
        s_done = (ej >= tot) && (drained >= 0);
    }
    __syncthreads();

    int c = 0;
    for (; c < cycles; ++c) {
        // --- phase 1: route + credit per FIFO; tail slots; streams ---
        if (keeper && c > 0) {               // the previous cycle's bookkeeping
            ej += s_eject;
            s_eject = 0;
            if (drained < 0 && ej >= tot) drained = cyc + 1;
            ++cyc;
            s_done = (ej >= tot) && (drained >= 0);
        }
        // A stream that injected last cycle needs row ptr + RING - 1 in its
        // ring. Its first thread records the local FIFO its row ptr goes to.
        for (int j = tid; j < g.M * LF; j += nt) {
            int m = divide<CLF>(j, g.mag_lf), k = j - m * LF;
            int ptr = iptr[m], n = len[m];
            int row = ptr + RING - 1;
            if (row >= itop[m] && row < n)
                fetch_row_word(irow, wire, g, LF, m, k, row);
            if (k == 0) {
                int next = -1;
                if (ptr < n) {
                    int slot = ptr & (RING - 1);
                    int sd = irow[(m * RING + slot) * LF + L];
                    next = ((mcn[m] * P + PORT_LOCAL) * V + (sd >> VC_SHIFT))
                         | slot << RING_SHIFT;
                    lstream[mcn[m] * V + (sd >> VC_SHIFT)] = m;
                }
                inext[m] = next;
            }
        }
        fetch_commit();
        for (int i = tid; i < nf; i += nt) {
            int cnt = count[i], h = head[i];
            int t = h + cnt;
            tail[i] = (t >= D ? t - D : t) | cnt << 16;
            int r = divide<CS>(i, g.mag_slots);
            int out = NO_REQUEST;
            if (cnt > 0) {
                int sd = SIDE_S ? side[h * nf + i]
                                : fifo[((long long)i * D + h) * LF + L];
                int fd = sd & DEST_MASK;
                int rrow = (int)div_mag(r, g.mag_cols);
                int rcol = r - rrow * g.cols;
                int drow = (int)div_mag(fd, g.mag_cols);
                int dcol = fd - drow * g.cols;
                int o = dcol > rcol ? PORT_E : dcol < rcol ? PORT_W
                      : drow > rrow ? PORT_S : drow < rrow ? PORT_N
                      : PORT_LOCAL;
                bool space = true;           // off-mesh: phantom block, 0 < D
                if (o != PORT_LOCAL && dir_ok(g, rrow, rcol, o)) {
                    int v = i - divide<CV>(i, g.mag_v) * V;
                    space = count[(neighbor(g, r, o) * P + ((o + 2) & 3)) * V
                                  + v] < D;
                }
                if (space) out = o;
            }
            req[r * RS + (i - r * nslots)] = (unsigned char)out;
        }
        fetch_wait_ring();
        __syncthreads();
        if (s_done) break;

        // --- phase 2: allocation, pops, link BT, pushes, injection ---
        for (int jj = tid; jj < items; jj += nt) {
            if (jj < 2 * npo) {
                const int j = jj >> 1, half = jj & 1;
                const unsigned pair = 3u << (lane & 30);
                int from = -1, to = -1, inj = -1;
                int sd = 0, dhc = 0, dslot = 0, hc = 0, h = 0;
                if (!half) {
                    const int r = j / P, o = j - r * P;
                    const int rrv = rr_cur[j];
                    const int winner = arbitrate(nslots, req + r * RS, o,
                                                 rrv);
                    rr_nxt[j] = winner < 0 ? rrv
                              : winner + 1 == nslots ? 0 : winner + 1;
                    if (winner >= 0) {
                        hc = r * nslots + winner;
                        h = head[hc];
                        head[hc] = h + 1 == D ? 0 : h + 1;
                        atomicSub(&count[hc], 1);
                        from = hc * D + h;
                        sd = SIDE_S ? side[h * nf + hc]
                                    : fifo[(long long)from * LF + L];
                        // The downstream FIFO (neighbor, opposite in-port,
                        // same VC) and its tail slot from phase 1; -1 for an
                        // ejection or an off-mesh port.
                        if (o == PORT_LOCAL) {
                            atomicAdd(&s_eject, 1);
                        } else {
                            int rrow = (int)div_mag(r, g.mag_cols);
                            if (dir_ok(g, rrow, r - rrow * g.cols, o)) {
                                int v = winner
                                      - divide<CV>(winner, g.mag_v) * V;
                                dhc = (neighbor(g, r, o) * P + ((o + 2) & 3))
                                    * V + v;
                                dslot = tail[dhc] & 0xFFFF;
                                to = dhc * D + dslot;
                                atomicAdd(&count[dhc], 1);
                            }
                        }
                        // A full local FIFO that pops takes its stream's
                        // injection into the slot just read: the ring row.
                        if (winner >= (P - 1) * V && (tail[hc] >> 16) >= D) {
                            const int m = lstream[r * V + winner - (P - 1) * V];
                            const int next = m < 0 ? -1 : inext[m];
                            if (next >= 0
                                && (next & ((1 << RING_SHIFT) - 1)) == hc)
                                inj = (m * RING + (next >> RING_SHIFT)) * LF;
                        }
                    }
                }
                from = __shfl_sync(pair, from, lane & 30);
                if (from < 0) continue;
                to = __shfl_sync(pair, to, lane & 30);
                inj = __shfl_sync(pair, inj, lane & 30);
                int32_t* src = PAY_S ? pay + from * LF
                                     : fifo + (long long)from * LF;
                int32_t* dst = to < 0 ? nullptr
                             : PAY_S ? pay + to * LF
                                     : fifo + (long long)to * LF;
                int32_t* lst = last + (long long)j * LST;
                const int per = (L + 1) >> 1;
                const int k_end = min(L, (half + 1) * per);
                int tog = 0;
                for (int k0 = half * per; k0 < k_end; k0 += CHUNK) {
                    // every load of the chunk in flight before any store: one
                    // round trip, whatever the compiler assumes about aliasing
                    int wv[CHUNK], lv[CHUNK];
#pragma unroll
                    for (int q = 0; q < CHUNK; ++q)
                        if (k0 + q < k_end) {
                            wv[q] = src[k0 + q];
                            lv[q] = lst[k0 + q];
                        }
#pragma unroll
                    for (int q = 0; q < CHUNK; ++q)
                        if (k0 + q < k_end) {
                            tog += __popc((unsigned)(lv[q] ^ wv[q]));
                            lst[k0 + q] = wv[q];
                            if (dst) dst[k0 + q] = wv[q];
                        }
                }
                if (inj >= 0)                // after this thread's reads
                    for (int k = half * per; k < k_end; ++k)
                        src[k] = irow[inj + k];
                tog += __shfl_xor_sync(pair, tog, 1);
                if (!half) {
                    if (to >= 0) {
                        if (SIDE_S) side[dslot * nf + dhc] = sd;
                        else dst[L] = sd;
                    }
                    if (inj >= 0) {
                        if (SIDE_S) side[h * nf + hc] = irow[inj + L];
                        else src[L] = irow[inj + L];
                    }
                    int meta = (sd >> META_SHIFT) & 3;
                    if (count_headers || (meta & META_PAYLOAD)) lbt[j] += tog;
                    lfl[j] += 1;
                }
            } else if (jj >= ibase) {
                // GROUP threads per stream, a word each; the stream's state
                // is theirs alone in this phase.
                const int m = (jj - ibase) / GROUP, k = (jj - ibase) % GROUP;
                const unsigned grp = 0xFFFFu << (lane & 16);
                const int next = inext[m];
                const int ptr = iptr[m];
                if (k == 0) itop[m] = ptr + RING;  // phase 1 fetched up to here
                if (next < 0) continue;
                const int pv = next & ((1 << RING_SHIFT) - 1);
                const int tl = tail[pv];
                const int slot = tl & 0xFFFF;
                const bool room = (tl >> 16) < D;    // else the popper writes
                if (!room) {
                    // Full: only if this cycle pops it (the winner of the
                    // out-port it requested, by the start-of-cycle pointer).
                    const int r = mcn[m], s = pv - r * nslots;
                    const int o = req[r * RS + s];
                    if (o == NO_REQUEST
                        || arbitrate(nslots, req + r * RS, o,
                                     rr_cur[r * P + o]) != s)
                        continue;
                }
                const int* w = irow + (m * RING + (next >> RING_SHIFT)) * LF;
                const int sd = w[L];
                int* il = ilast + m * LF;
                const int row = pv * D + slot;
                int32_t* dst = PAY_S ? pay + row * LF
                                     : fifo + (long long)row * LF;
                int tog = 0;
                for (int q = k; q < L; q += GROUP) {
                    int x = w[q];
                    tog += __popc((unsigned)(il[q] ^ x));
                    il[q] = x;
                    if (room) dst[q] = x;
                }
#pragma unroll
                for (int off = GROUP / 2; off; off >>= 1)
                    tog += __shfl_xor_sync(grp, tog, off);
                if (k == 0) {
                    if (room) {
                        if (SIDE_S) side[slot * nf + pv] = sd;
                        else dst[L] = sd;
                    }
                    atomicAdd(&count[pv], 1);
                    iptr[m] = ptr + 1;
                    int meta = (sd >> META_SHIFT) & 3;
                    if (count_headers || (meta & META_PAYLOAD)) ibt[m] += tog;
                }
            }
        }
        int* t = rr_cur;
        rr_cur = rr_nxt;
        rr_nxt = t;
        __syncthreads();
    }
    if (keeper && c == cycles) {            // the last cycle's bookkeeping
        ej += s_eject;
        if (drained < 0 && ej >= tot) drained = cyc + 1;
        ++cyc;
    }

    // --- launch end: the state back to global memory (every cycle ended
    // on a barrier, so shared memory is final; the ring's last fetches are
    // waited for before the block exits) ---
    fetch_wait_all();
    for (int i = tid; i < nf; i += nt) {
        head_g[i] = head[i];
        count_g[i] = count[i];
    }
    for (int j = tid; j < npo; j += nt) {
        rr_g[j] = rr_cur[j];
        lbt_g[j] = lbt[j];
        lfl_g[j] = lfl[j];
    }
    for (int m = tid; m < g.M; m += nt) {
        iptr_g[m] = iptr[m];
        ibt_g[m] = ibt[m];
        for (int k = 0; k < L; ++k) ilast_g[m * L + k] = ilast[m * LF + k];
    }
    if (LAST_S)
        for (int j = tid; j < npo; j += nt)
            for (int k = 0; k < L; ++k) last_g[j * L + k] = last[j * LST + k];
    if (PAY_S) {
        for (int k = tid; k < nrow * LF; k += nt) {
            int r = divide<CLF>(k, g.mag_lf);
            int i = divide<CD>(r, g.mag_d);
            fifo[k] = k - r * LF == L ? side[(r - i * D) * nf + i] : pay[k];
        }
    } else if (SIDE_S) {
        for (int i = tid; i < nf; i += nt)
            for (int h = 0; h < D; ++h)
                fifo[((long long)i * D + h) * LF + L] = side[h * nf + i];
    }
    if (keeper) {
        a.ejected[b] = ej;
        a.cycle[b] = cyc + (cycles - c);
        a.drained[b] = drained;
    }
}

unsigned long long magic(int n) {
    return ((1ull << 32) + (unsigned long long)n - 1) / (unsigned long long)n;
}

Dims make_dims(int rows, int cols, int V, int D, int L, int M, int T) {
    Dims g;
    g.rows = rows; g.cols = cols; g.nr = rows * cols; g.V = V; g.D = D;
    g.L = L; g.M = M; g.T = T;
    g.mag_slots = magic(P * V); g.mag_v = magic(V);
    g.mag_cols = magic(cols); g.mag_lf = magic(L + 1); g.mag_d = magic(D);
    return g;
}

template <bool SIDE_S, bool LAST_S, bool PAY_S, int CV, int CD, int CL>
int launch_geom(const Lanes& a, const Dims& g, const Layout& lay, int B,
                int threads, int smem, int cycles, int count_headers,
                cudaStream_t stream) {
    auto kernel = router_cycles<SIDE_S, LAST_S, PAY_S, CV, CD, CL>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<B, threads, smem, stream>>>(a, g, lay, cycles, count_headers);
    return (int)cudaGetLastError();
}

// The paper's routers (4 VCs of 4 flits, 16-word flits) get the kernel with
// that geometry compiled in; any other runs the general one.
template <bool SIDE_S, bool LAST_S, bool PAY_S>
int launch_cycles(const Lanes& a, const Dims& g, const Layout& lay, int B,
                  int threads, int smem, int cycles, int count_headers,
                  cudaStream_t stream) {
    if (g.V == 4 && g.D == 4 && g.L == 16)
        return launch_geom<SIDE_S, LAST_S, PAY_S, 4, 4, 16>(
            a, g, lay, B, threads, smem, cycles, count_headers, stream);
    return launch_geom<SIDE_S, LAST_S, PAY_S, 0, 0, 0>(
        a, g, lay, B, threads, smem, cycles, count_headers, stream);
}

}  // namespace

extern "C" int router_step_run(
        void* fifo, void* head, void* count, void* rr, void* link_last,
        void* link_bt, void* link_flits, void* inj_ptr, void* inj_last,
        void* inj_bt, void* ejected, void* cycle, void* drained,
        const void* wire, const void* length, const void* mc_nodes, int B,
        int rows, int cols, int V, int D, int L, int M, int T, int cycles,
        int count_headers, const void* layout, int ring, int threads,
        int smem, void* stream) {
    if (B <= 0 || cycles <= 0) return 0;
    if (threads <= 0 || threads > MAX_THREADS || threads % 32)
        return (int)cudaErrorInvalidConfiguration;
    if (ring != RING) return (int)cudaErrorInvalidValue;
    Lanes a{(int32_t*)fifo, (int32_t*)head, (int32_t*)count, (int32_t*)rr,
            (int32_t*)link_last, (int32_t*)link_bt, (int32_t*)link_flits,
            (int32_t*)inj_ptr, (int32_t*)inj_last, (int32_t*)inj_bt,
            (int32_t*)ejected, (int32_t*)cycle, (int32_t*)drained,
            (const int32_t*)wire, (const int32_t*)length,
            (const int32_t*)mc_nodes};
    Dims g = make_dims(rows, cols, V, D, L, M, T);
    const int* off = (const int*)layout;
    Layout lay{off[0], off[1], off[2], off[3], off[4], off[5], off[6], off[7],
               off[8], off[9], off[10], off[11], off[12], off[13], off[14],
               off[15], off[16], off[17], off[18]};
    static_assert(sizeof(Layout) == LAYOUT_FIELDS * sizeof(int),
                  "Layout mirrors router_step.py LAYOUT_FIELDS");
    const int placed = (lay.side >= 0) | (lay.last >= 0) << 1
                     | (lay.pay >= 0) << 2;
    cudaStream_t s = (cudaStream_t)stream;
    switch (placed) {
        case 0: return launch_cycles<false, false, false>(
            a, g, lay, B, threads, smem, cycles, count_headers, s);
        case 1: return launch_cycles<true, false, false>(
            a, g, lay, B, threads, smem, cycles, count_headers, s);
        case 2: return launch_cycles<false, true, false>(
            a, g, lay, B, threads, smem, cycles, count_headers, s);
        case 3: return launch_cycles<true, true, false>(
            a, g, lay, B, threads, smem, cycles, count_headers, s);
        case 5: return launch_cycles<true, false, true>(
            a, g, lay, B, threads, smem, cycles, count_headers, s);
        case 7: return launch_cycles<true, true, true>(
            a, g, lay, B, threads, smem, cycles, count_headers, s);
        default:   // the payload in shared memory needs the sideband there
            return (int)cudaErrorInvalidValue;
    }
}
