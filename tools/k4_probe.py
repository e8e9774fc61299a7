"""Layouts of the window sort's register network on the card: a probe for
the K4 kernel (``src/repro_torch/kernels/csrc/bitonic_sort.cu``).

    python3 tools/k4_probe.py [--out REPORT.json]

Needs one CUDA card and nvcc; builds into ``build/probe/`` (gitignored) a
library that includes ``bitonic_sort.cu`` as it stands (the source is not
changed) and launches, for rows of 128 to 1,024 keys with one payload, the
layouts the shipped design was chosen among:

* ``shipped`` - ``sort_windows`` itself;
* ``shared`` - the shared-memory network every width took before the
  register design (one thread a compare-exchange pair, a block barrier a
  substage);
* ``index_one_warp`` / ``index_two_warps`` - the int32 key compared signed,
  the element's index a register payload (two words an element, each
  shuffled), on one warp a row or two;
* ``wide_one_warp`` / ``wide_two_warps`` - the key and the index in one
  64-bit word, (key ^ 2^31) << 32 | index, compared on its high half (one
  64-bit shuffle, two 32-bit ones on the card).

Each layout's output is held against ``ref.sort_windows_ref`` exactly on
tie-heavy keys in [0, 33) and on full-range int32 keys (INT32_MIN and
INT32_MAX among them), then timed: one C call launches a layout ``--reps``
times back to back on the current stream, between two CUDA events, so the
time a launch is the device's (no Python between launches). Layouts
alternate within each repeat; every time of every repeat is reported.
Prints one JSON object; ``--out`` also writes it.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
OUT = os.path.join(REPO, "build", "probe")

LAYOUTS = ("shipped", "shared", "index_one_warp", "index_two_warps",
           "wide_one_warp", "wide_two_warps")
SHAPES = ((512, 128), (512, 256), (512, 512), (512, 1024), (2048, 512),
          (2200, 1024))

VARIANTS_CU = r"""
#include "bitonic_sort.cu"

namespace {

// The key and the index in one word, (key ^ 2^31) << 32 | index: the biased
// key orders as unsigned as the key does as signed, and a > (b | 2^32 - 1)
// compares the high halves alone, strictly.
struct WideDesc {
    static constexpr unsigned long long kFlip = 0xffffffff00000000ull;
    __device__ __forceinline__ bool operator()(unsigned long long a,
                                               unsigned long long b) const {
        return a > (b | 0xffffffffull);
    }
};

// warp_bitonic (bitonic.cuh) on 64-bit key words with no payloads: the
// same substages, pairings and directions, the key words exchanged across
// lanes by 64-bit shuffles and across a row's two warps through `xbuf` (W
// words). Only this probe's wide layouts use it.
template <int E, int LG>
__device__ __forceinline__ void warp_bitonic_wide(
    unsigned long long (&key)[E], int lane, int part,
    unsigned long long* xbuf, int bar) {
    using T = unsigned long long;
    constexpr unsigned kFullMask = 0xffffffffu;
    constexpr int LE = E == 1 ? 0 : E == 2 ? 1 : E == 4 ? 2 : E == 8 ? 3
                     : E == 16 ? 4 : 5;
    constexpr int LT = LE + 5;
    constexpr int LW = LT + LG;
    const WideDesc before;
    auto high_bit = [&](int b) {
        return b < LT ? (lane >> (b - LE)) & 1 : (part >> (b - LT)) & 1;
    };
#pragma unroll
    for (int k = 0; k < LW; ++k) {
#pragma unroll
        for (int j = k; j >= 0; --j) {
            if (j < LE) {
                const T flip = k + 1 < LE || high_bit(k + 1) == 0
                                   ? WideDesc::kFlip : T(0);
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    if (r & (1 << j)) continue;
                    const int q = r | (1 << j);
                    const T a = key[r], b = key[q];
                    const bool swap =
                        k + 1 < LE ? (((r >> (k + 1)) & 1) == 0
                                          ? before(b, a) : before(a, b))
                                   : before(a ^ flip, b ^ flip);
                    key[r] = swap ? b : a;
                    key[q] = swap ? a : b;
                }
                continue;
            }
            const bool lo = high_bit(j) == 0;
            const bool fwd = k + 1 >= LW || high_bit(k + 1) == 0;
            const T flip = fwd == lo ? WideDesc::kFlip : T(0);
            if (j < LT) {
                const int m = 1 << (j - LE);
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    const T mine = key[r];
                    const T other = __shfl_xor_sync(kFullMask, mine, m);
                    key[r] = before(mine ^ flip, other ^ flip) ? other : mine;
                }
            } else {
                T* own = xbuf + part * 32 * E + lane;
                const T* theirs =
                    xbuf + (part ^ (1 << (j - LT))) * 32 * E + lane;
#pragma unroll
                for (int r = 0; r < E; ++r) own[r * 32] = key[r];
                asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 << LG)
                             : "memory");
#pragma unroll
                for (int r = 0; r < E; ++r) {
                    const T mine = key[r], other = theirs[r * 32];
                    key[r] = before(mine ^ flip, other ^ flip) ? other : mine;
                }
                asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(32 << LG)
                             : "memory");
            }
        }
    }
}

// sort_windows_warp with one payload, the key and the index one wide word.
template <int E, int LG>
__global__ void __launch_bounds__(kWarps * 32)
sort_windows_wide(const unsigned* __restrict__ keys,
                  const unsigned* __restrict__ pay,
                  unsigned* __restrict__ okeys, unsigned* __restrict__ opay,
                  long long R) {
    constexpr int W = 32 * E << LG;
    __shared__ unsigned spay[kWarps * 32 * E];
    __shared__ unsigned long long xbuf[LG ? kWarps * 32 * E : 1];
    const int lane = threadIdx.x & 31;
    const int wid = threadIdx.x >> 5;
    const int slot = wid >> LG;
    const int part = wid & ((1 << LG) - 1);
    const long long row = (long long)blockIdx.x * (kWarps >> LG) + slot;
    if (row >= R) return;
    const int first = (part * 32 + lane) * E;
    const long long base = row * W + first;
    unsigned* sp = spay + slot * W;
    unsigned key[E], v[E];
    unsigned long long word[E];
    load_run<E>(keys + base, key);
    load_run<E>(pay + base, v);
    store_run<E>(sp + first, v);
    __syncwarp();
#pragma unroll
    for (int r = 0; r < E; ++r)
        word[r] = (unsigned long long)(key[r] ^ 0x80000000u) << 32
                  | (unsigned)(first + r);
    warp_bitonic_wide<E, LG>(word, lane, part, LG ? xbuf + slot * W : nullptr,
                             1 + slot);
#pragma unroll
    for (int r = 0; r < E; ++r) {
        key[r] = (unsigned)(word[r] >> 32) ^ 0x80000000u;
        v[r] = sp[(unsigned)word[r]];
    }
    store_run<E>(okeys + base, key);
    store_run<E>(opay + base, v);
}

template <int E, int LG>
int launch_wide(const void* k, const void* p, void* ok, void* op,
                long long R, cudaStream_t s) {
    constexpr int rows = kWarps >> LG;
    sort_windows_wide<E, LG><<<(unsigned)((R + rows - 1) / rows),
                               kWarps * 32, 0, s>>>(
        (const unsigned*)k, (const unsigned*)p, (unsigned*)ok, (unsigned*)op,
        R);
    return (int)cudaGetLastError();
}

// Layouts 2-5 at width 32 E (one payload): the index or the wide word, on
// one warp a row or two.
template <int E>
int launch_layout(int layout, const void* k, const void* p, void* ok,
                  void* op, long long R, cudaStream_t s) {
    switch (layout) {
        case 2: return launch_warp<E, 0, 1>(k, p, nullptr, ok, op, nullptr, R, s);
        case 3: return launch_warp<E / 2, 1, 1>(k, p, nullptr, ok, op, nullptr, R, s);
        case 4: return launch_wide<E, 0>(k, p, ok, op, R, s);
        case 5: return launch_wide<E / 2, 1>(k, p, ok, op, R, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Layout 0 (sort_windows) to 5, `reps` launches back to back; keys, pay,
// okeys, opay: (R, w) int32, 16-byte aligned, 128 <= w <= 1,024.
extern "C" int k4_layout(int layout, const void* keys, const void* pay,
                         void* okeys, void* opay, long long R, int w,
                         int reps, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    for (int i = 0; i < reps; ++i) {
        int e = (int)cudaErrorInvalidValue;
        if (layout == 0) {
            e = sort_windows(keys, pay, nullptr, okeys, opay, nullptr, R, w,
                             1, stream);
        } else if (layout == 1) {
            e = launch<1>(keys, pay, nullptr, okeys, opay, nullptr, R, w,
                          false, s);
        } else {
            switch (w) {
                case 128: e = launch_layout<4>(layout, keys, pay, okeys, opay, R, s); break;
                case 256: e = launch_layout<8>(layout, keys, pay, okeys, opay, R, s); break;
                case 512: e = launch_layout<16>(layout, keys, pay, okeys, opay, R, s); break;
                case 1024: e = launch_layout<32>(layout, keys, pay, okeys, opay, R, s); break;
            }
        }
        if (e) return e;
    }
    return 0;
}
"""

_LIB = None
BUILD_LOG = ""


def build():
    """Build (once a process) and bind the layouts' library."""
    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    from repro_torch.kernels._build import CSRC, NVCC_FLAGS, _nvcc
    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, "k4_layouts.cu")
    so = os.path.join(OUT, f"libk4_layouts_{os.getpid()}.so")
    with open(cu, "w") as f:
        f.write(VARIANTS_CU)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", so,
                           cu], capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
    fn = ctypes.CDLL(so).k4_layout
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB = fn
    return fn


def run_layout(name: str, keys, pay, reps: int = 1):
    """``(sorted keys, payload)`` of (R, W) int32 CUDA tensors by layout
    ``name``, launched ``reps`` times."""
    import torch
    fn = build()
    okeys, opay = torch.empty_like(keys), torch.empty_like(pay)
    r, w = keys.shape
    err = fn(LAYOUTS.index(name), keys.data_ptr(), pay.data_ptr(),
             okeys.data_ptr(), opay.data_ptr(), r, w, reps,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k4 layout {name} at {tuple(keys.shape)}: "
                           f"cudaError {err}")
    return okeys, opay


def tie_heavy(rng, r, w):
    """Keys in [0, 33), as benchmarks/ordering_throughput.py makes them."""
    return rng.integers(0, 33, (r, w)).astype(np.int32)


def full_range(rng, r, w):
    """Full-range int32 keys, INT32_MIN and INT32_MAX in every row, and a
    few repeated values."""
    k = rng.integers(-2**31, 2**31, (r, w), dtype=np.int64)
    k[:, 0], k[:, 1], k[:, 2] = -2**31, 2**31 - 1, -2**31
    k[:, 3:8] = rng.integers(-2, 2, (r, 5))
    return k.astype(np.int32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        sys.exit("k4_probe needs a CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    build()
    regs = [ln.strip() for ln in BUILD_LOG.splitlines()
            if "registers" in ln or "spill" in ln]
    rng = np.random.default_rng(0)
    report = {"card": card, "reps": args.reps, "build_registers": regs,
              "check": {}, "ms": {}}
    for r, w in SHAPES:
        pay = torch.from_numpy(rng.integers(-2**31, 2**31, (r, w))
                               .astype(np.int32)).cuda()
        cases = {kind: torch.from_numpy(make(rng, r, w)).cuda()
                 for kind, make in (("ties", tie_heavy),
                                    ("full range", full_range))}
        want = {kind: ref.sort_windows_ref(x, pay)
                for kind, x in cases.items()}
        for name in LAYOUTS:
            ok = all(all(torch.equal(g, v) for g, v in
                         zip(run_layout(name, x, pay), want[kind]))
                     for kind, x in cases.items())
            report["check"][f"{name} ({r}, {w})"] = ok
            if not ok:
                print(f"MISMATCH {name} at ({r}, {w})", flush=True)
        x = cases["ties"]
        times = {}
        for _ in range(args.repeats):
            for name in LAYOUTS:
                run_layout(name, x, pay)
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run_layout(name, x, pay, args.reps)
                b.record()
                b.synchronize()
                times.setdefault(name, []).append(
                    a.elapsed_time(b) / args.reps)
        report["ms"][f"({r}, {w})"] = times
        print(f"({r}, {w}) " + "  ".join(
            f"{n} {min(t):.5f}" for n, t in times.items()), flush=True)
    report["ok"] = all(report["check"].values())
    text = json.dumps(report, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(json.dumps({k: report[k] for k in ("card", "ok", "ms")}))
    sys.exit(0 if report["ok"] else 1)


if __name__ == "__main__":
    main()
