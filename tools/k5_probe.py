"""Layouts of the ordering unit's register network on the card: a probe for
the K5 kernel (``src/repro_torch/kernels/csrc/order_unit.cu``).

    python3 tools/k5_probe.py [--out REPORT.json]

Needs one CUDA card and nvcc; builds into ``build/probe/`` (gitignored) a
library that includes ``order_unit.cu`` as it stands (the source is not
changed) and adds, for rows of 32 to 1,024 words, the layouts the shipped
design was chosen among:

* ``shipped`` - ``order_unit`` itself: a warp a row below 256 words, two
  from 256, the values gathered by the final indices;
* ``one_warp`` - that gather layout on one warp a row at every width;
* ``two_warps`` - the same on two warps a row at every width from 64;
* ``value_register`` - one warp a row, the key word (popcount << 16) |
  index compared on its high half, the value a second register that rides
  every swap (``warp_bitonic`` with one payload): two shuffles an element
  across lanes;
* ``reference_layout`` - one warp a row, the popcount alone as the key,
  the value and the lane index both riding the swaps (two payloads), as
  the reference's ``order_unit_pallas`` carries them: three shuffles.

Each layout's output is held against ``ref.order_unit_ref`` exactly on
random and on tie-heavy words at every shape, then timed: one C call
launches a layout ``--reps`` times back to back on the current stream,
between two CUDA events, so the time a launch is the device's (no Python
between launches). Layouts alternate within each repeat; every time of
every repeat is reported. Prints one JSON object; ``--out`` also writes it.
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

LAYOUTS = ("shipped", "one_warp", "two_warps", "value_register",
           "reference_layout")
SHAPES = ((512, 128), (512, 256), (512, 512), (512, 1024), (1600, 256),
          (2048, 512), (4096, 512), (2200, 1024))

VARIANTS_CU = r"""
#include "order_unit.cu"

namespace {

// Key words compared whole (the popcount alone): ~a > ~b is b > a.
struct CountDesc {
    static constexpr unsigned kFlip = 0xffffffffu;
    __device__ __forceinline__ bool operator()(unsigned a, unsigned b) const {
        return a > b;
    }
};

// One warp a row, the value (NP = 1: key word (popcount << 16) | index)
// or the value and the index (NP = 2: key the popcount) as payloads.
template <int E, int NP>
__global__ void __launch_bounds__(kWarps * 32)
order_unit_payload(const unsigned* __restrict__ vals,
                   unsigned* __restrict__ ovals, unsigned* __restrict__ operm,
                   long long R) {
    constexpr int W = 32 * E;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
    if (row >= R) return;
    const int first = lane * E;
    const long long base = row * W + first;
    unsigned key[E], pay[NP][E];
    load_run<E>(vals + base, pay[0]);
#pragma unroll
    for (int r = 0; r < E; ++r) {
        const unsigned c = (unsigned)__popc(pay[0][r]);
        if constexpr (NP == 1) {
            key[r] = (c << 16) | (unsigned)(first + r);
        } else {
            key[r] = c;
            pay[1][r] = (unsigned)(first + r);
        }
    }
    if constexpr (NP == 1) {
        warp_bitonic<E, 1, 0>(key, pay, lane, PackedKeyDesc());
#pragma unroll
        for (int r = 0; r < E; ++r) key[r] &= 0xffffu;
        store_run<E>(operm + base, key);
    } else {
        warp_bitonic<E, 2, 0>(key, pay, lane, CountDesc());
        store_run<E>(operm + base, pay[1]);
    }
    store_run<E>(ovals + base, pay[0]);
}

template <int E, int NP>
int launch_payload(const void* vals, void* ovals, void* operm, long long R,
                   cudaStream_t s) {
    const long long blocks = (R + kWarps - 1) / kWarps;
    order_unit_payload<E, NP><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        (const unsigned*)vals, (unsigned*)ovals, (unsigned*)operm, R);
    return (int)cudaGetLastError();
}

template <int E>
int launch_layout(int layout, const void* v, void* o, void* p, long long R,
                  cudaStream_t s) {
    switch (layout) {
        case 1: return launch_warp<E, 0>(v, o, p, R, s);
        case 2:
            if constexpr (E >= 2) return launch_warp<E / 2, 1>(v, o, p, R, s);
            break;
        case 3: return launch_payload<E, 1>(v, o, p, R, s);
        case 4: return launch_payload<E, 2>(v, o, p, R, s);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// Layout 0 (order_unit) to 4, `reps` launches back to back; vals, ovals,
// operm: (R, w) int32, 16-byte aligned, 32 <= w <= 1,024.
extern "C" int k5_layout(int layout, const void* vals, void* ovals,
                         void* operm, long long R, int w, int reps,
                         void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    for (int i = 0; i < reps; ++i) {
        int e = (int)cudaErrorInvalidValue;
        if (layout == 0) {
            e = order_unit(vals, ovals, operm, R, w, stream);
        } else {
            switch (w) {
                case 32: e = launch_layout<1>(layout, vals, ovals, operm, R, s); break;
                case 64: e = launch_layout<2>(layout, vals, ovals, operm, R, s); break;
                case 128: e = launch_layout<4>(layout, vals, ovals, operm, R, s); break;
                case 256: e = launch_layout<8>(layout, vals, ovals, operm, R, s); break;
                case 512: e = launch_layout<16>(layout, vals, ovals, operm, R, s); break;
                case 1024: e = launch_layout<32>(layout, vals, ovals, operm, R, s); break;
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
    cu = os.path.join(OUT, "k5_layouts.cu")
    so = os.path.join(OUT, f"libk5_layouts_{os.getpid()}.so")
    with open(cu, "w") as f:
        f.write(VARIANTS_CU)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", so,
                           cu], capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
    fn = ctypes.CDLL(so).k5_layout
    fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB = fn
    return fn


def run_layout(name: str, words, reps: int = 1):
    """``(ordered words, permutation)`` of an (R, W) int32 CUDA tensor by
    layout ``name``, launched ``reps`` times."""
    import torch
    fn = build()
    ovals, operm = torch.empty_like(words), torch.empty_like(words)
    r, w = words.shape
    err = fn(LAYOUTS.index(name), words.data_ptr(), ovals.data_ptr(),
             operm.data_ptr(), r, w, reps,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k5 layout {name} at {tuple(words.shape)}: "
                           f"cudaError {err}")
    return ovals, operm


def tie_heavy(rng, r, w):
    """Rows drawn from 12 words of 3 popcounts (bit 31 set in some), row 0
    of distinct words of one popcount."""
    pool = np.array([0x0000000F, 0x80000007, 0x00F00000, 0xF0000000,
                     0x000003FF, 0x800001FF, 0x3FF00000, 0xFFC00000,
                     0x00000000, 0x00000000, 0xFFFFFFFF, 0x7FFFFFFF],
                    np.uint32)
    rows = rng.choice(pool, (r, w))
    bits = np.argsort(rng.random((w, 32)), axis=1)[:, :7]
    rows[0] = (np.uint32(1) << bits.astype(np.uint32)).sum(
        axis=1, dtype=np.uint64).astype(np.uint32)
    return rows.view(np.int32)


def random_words(rng, r, w):
    return rng.integers(0, 2**32, (r, w), dtype=np.uint64).astype(
        np.uint32).view(np.int32)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    from repro_torch.kernels import ref
    if not torch.cuda.is_available():
        sys.exit("k5_probe needs a CUDA card")
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
        cases = {kind: torch.from_numpy(make(rng, r, w)).cuda()
                 for kind, make in (("ties", tie_heavy),
                                    ("random", random_words))}
        want = {kind: ref.order_unit_ref(x) for kind, x in cases.items()}
        for name in LAYOUTS:
            if name == "two_warps" and w < 64:
                continue
            ok = all(all(torch.equal(g, v) for g, v in
                         zip(run_layout(name, x), want[kind]))
                     for kind, x in cases.items())
            report["check"][f"{name} ({r}, {w})"] = ok
            if not ok:
                print(f"MISMATCH {name} at ({r}, {w})", flush=True)
        x = cases["random"]
        times = {}
        for _ in range(args.repeats):
            for name in LAYOUTS:
                if name == "two_warps" and w < 64:
                    continue
                run_layout(name, x)
                torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                run_layout(name, x, args.reps)
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
