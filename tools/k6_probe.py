"""The K6 chain kernel's two tiers and launch forms on the card: a probe for
``src/repro_torch/kernels/csrc/chain_greedy.cu``.

    python3 tools/k6_probe.py [--out REPORT.json] [--reps N]

Needs one CUDA card and nvcc (the kernel builds as the port builds it, into
``build/kernels/``). Prints the build's seconds and, from ``-Xptxas -v``,
the most registers and any spill of the register tier's instantiations.
Then:

* checks: both tiers against ``ref.chain_greedy_ref`` exactly, on one and
  two planes, beams 1-3, at W = 1 to 1,025 (the register tier up to 1,024),
  on random words, words with bit 31 set, live counts of 0 and 1 and
  all-zero windows, starts anywhere in the row (the zero region too);
* times, at conv2-under-O3a's chain shape (2 x 1,600 x 152, 8 starts, beam
  2) and at DarkNet-like shapes (W = 576 and 288, one and two planes, R
  from 16 to 4,096): the register tier as shipped (a warp a chain, a block
  for every eight chains; ``shipped``) and the wide tier (``wide``). One
  timing is
  CUDA events around ``--reps`` launches after a warm-up; the forms
  alternate within each of three repeats and every time is kept.

Live counts are drawn from [W/2, W] (DarkNet's and LeNet's windows are
partly zero); the chain's work does not depend on the words' values.
At the conv2 shape the shipped form is also read four ways: CUDA events
around 20 launches, the host's clock around 100 launches and a
synchronise, and one torch.profiler window of 10 launches (the kernels'
own time from ``key_averages`` and the union of the window's device
spans). ``--builds`` also times nvcc on the source alone (into
``build/probe/``) with the port's flags and with each of
``BUILD_VARIANTS`` added. ``--sass`` counts, with ``cuobjdump -sass`` on
the built library, the instructions of the register tier's instantiations
at the main path's shapes (``SASS_SHAPES``: P, K, beam) by opcode, and
writes each listing under ``build/probe/``. Prints one JSON object;
``--out`` also writes it. ``--variants`` builds ``VARIANTS`` (the source
with parts of the design swapped, into ``build/probe/``) and times each
beside the shipped form at ``TIME_SHAPES``: among them ``strided``, a
grid sized to the resident blocks, each warp walking the chains with a
stride.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))

CHECK_WIDTHS = (1, 4, 31, 32, 33, 64, 152, 576, 1024, 1025)
BUILD_VARIANTS = ((), ("--split-compile=0",),
                  ("--split-compile=0", "-Xptxas", "--split-compile=0"))
# Design parts swapped in a copy of the source, each (first marker, last
# marker, text): the visit as a predicated pass over the K slots (the first
# design's).
LOOP_VISIT = """template <int K>
__device__ __forceinline__ void visit(unsigned (&pen)[K], unsigned& skip,
                                      int c, int lane) {
    const bool own = lane == (c & 31);
    const int tc = c >> 5;
#pragma unroll
    for (int t = 0; t < K; ++t)
        if (own && t == tc) pen[t] |= kKeyVisited;
    if (own) skip |= 1u << tc;
}
"""
# The lookahead's skip as a predicate a slot rather than bit 31 of the
# distance.
SKIP_PREDICATE = """#pragma unroll
        for (int t = 0; t < K; ++t) {
            const bool skipped = (skc >> t) & 1u;
#pragma unroll
            for (int b = 0; b < B; ++b) {
                unsigned d = __popc(qv[0][t] ^ cq[b][0]);
                if constexpr (NPL > 1) d += __popc(qv[1][t] ^ cq[b][1]);
                v[b][t] = d;
                if (!skipped) la[b] = min(la[b], d);
            }
        }
"""
# The register tier on a grid sized to the resident blocks, each warp
# walking the chains with a stride.
STRIDED_HEAD = """    for (long long rs = (long long)blockIdx.x * kWarps + warp;
         rs < (long long)R * S; rs += (long long)gridDim.x * kWarps) {
    __syncwarp();                        // the last chain's reads are done
"""
STRIDED_TAIL = """    if (lane == 0) costs[rs] = (int)cost;
    }
}
"""
STRIDED_GRID = """    long long blocks = ((long long)R * S + kWarps - 1) / kWarps;
    int per_sm = 0, dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kWarps * 32,
                                                  smem);
    per_sm = per_sm > 0 ? per_sm : 1;
    if ((long long)per_sm * sms < blocks) blocks = (long long)per_sm * sms;
"""
VARIANTS = {
    "loop_visit": [("template <int K>\n__device__ __forceinline__ void visit(",
                    "#undef CHAIN_VISIT\n", LOOP_VISIT)],
    "skip_predicate": [("#pragma unroll\n        for (int t = 0; t < K; "
                        "++t) {\n            const unsigned hb",
                        "            }\n        }\n", SKIP_PREDICATE)],
    "strided": [
        ("    const long long rs = (long long)blockIdx.x * kWarps + warp;",
         "    if (rs >= (long long)R * S) return;\n", STRIDED_HEAD),
        ("    if (lane == 0) costs[rs] = (int)cost;\n}\n",
         "    if (lane == 0) costs[rs] = (int)cost;\n}\n", STRIDED_TAIL),
        ("    const long long blocks = ", "/ kWarps;\n", STRIDED_GRID)],
}
SASS_SHAPES = ((2, 5, 2), (1, 5, 2), (1, 9, 2), (1, 18, 2), (1, 1, 2))
TIME_SHAPES = ((2, 1600, 152), (2, 16, 576), (2, 256, 576), (2, 1024, 576),
               (2, 4096, 576), (1, 1024, 576), (2, 1024, 288))


def inputs(rng, planes, r, w, s, kind, torch):
    u = rng.integers(0, 2**32, (planes, r, w), dtype=np.uint64).astype(
        np.uint32)
    if kind == "bit31":
        u |= np.uint32(0x80000000)
    live = {"allzero": np.zeros(r, np.int64), "zlow": rng.integers(0, 2, r),
            "half": rng.integers(w // 2, w + 1, r)}.get(
                kind, rng.integers(0, w + 1, r))
    live = np.minimum(live, w)
    u[:, np.arange(w)[None, :] >= live[:, None]] = 0
    start = rng.integers(0, w, (r, s)).astype(np.int32)
    return (torch.from_numpy(u.view(np.int32)).cuda(),
            torch.from_numpy(live.astype(np.int32)).cuda(),
            torch.from_numpy(start).cuda())


def sass_counts(lib) -> dict:
    """Opcode counts of the register tier's SASS_SHAPES instantiations in
    the built library (cuobjdump -sass), each listing written beside."""
    from repro_torch.kernels import _build
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    out_dir = os.path.join(REPO, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    found = {}
    for block in text.split("Function : ")[1:]:
        m = re.search(r"chain_greedy_regILi(\d+)ELi(\d+)ELi(\d+)E", block)
        if not m:
            continue
        shape = tuple(int(x) for x in m.groups())
        if shape not in SASS_SHAPES:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
                         block)
        counts = {}
        for op in ops:
            base = op.split(".")[0]
            counts[base] = counts.get(base, 0) + 1
        key = "P{}_K{}_B{}".format(*shape)
        with open(os.path.join(out_dir, key + ".sass"), "w") as f:
            f.write(block)
        found[key] = {"total": len(ops), "top": sorted(
            counts.items(), key=lambda kv: -kv[1])[:14]}
    return found


def build_variant(name: str):
    """The chain library built from the source with VARIANTS[name] swapped
    in (each part's text from its first marker to its last, inclusive, in
    turn), bound with the shipped argument types."""
    import ctypes
    from repro_torch.kernels import _build
    from repro_torch.kernels import chain_greedy as kg
    src = kg.KERNEL.source.read_text()
    for start, end, text in VARIANTS[name]:
        a = src.index(start)
        b = src.index(end, a) + len(end)
        src = src[:a] + text + src[b:]
    out_dir = os.path.join(REPO, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"chain_{name}.cu")
    with open(cu, "w") as f:
        f.write(src)
    lib = os.path.join(out_dir, f"libchain_{name}.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(lib).chain_greedy
    fn.argtypes = kg.KERNEL.argtypes
    fn.restype = ctypes.c_int
    return fn


def events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--builds", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("k6_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import chain_greedy as kg
    from repro_torch.kernels import ref
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report = {"card": smi, "torch": torch.__version__}
    print(smi, flush=True)

    if args.builds:
        from repro_torch.kernels import _build
        out_dir = os.path.join(REPO, "build", "probe")
        os.makedirs(out_dir, exist_ok=True)
        report["builds"] = []
        for extra in BUILD_VARIANTS:
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_build._nvcc(), *_build.NVCC_FLAGS, *extra, "-o",
                 os.path.join(out_dir, "libchain_greedy_probe.so"),
                 str(kg.KERNEL.source)], capture_output=True, text=True)
            row = {"flags": list(extra), "rc": proc.returncode,
                   "s": time.perf_counter() - t0}
            if proc.returncode:
                row["log"] = (proc.stdout + proc.stderr)[-600:]
            report["builds"].append(row)
            print(f"nvcc {' '.join(extra) or '(port flags)'}: rc "
                  f"{proc.returncode}, {row['s']:.1f} s", flush=True)

    t0 = time.perf_counter()
    kg.KERNEL.fn()
    report["build_s"] = time.perf_counter() - t0
    log = kg.KERNEL.build_log
    regs = [(m.group(1), int(m.group(2))) for m in re.finditer(
        r"Compiling entry function '(\S+)'[\s\S]*?Used (\d+) registers", log)]
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        log)
    report["instantiations"] = len(regs)
    report["max_registers"] = max((n for _, n in regs), default=None)
    report["spill_lines"] = [s for s in spills if s != ("0", "0")]
    report["registers"] = {name: n for name, n in regs}
    print(f"build {report['build_s']:.1f} s; {len(regs)} entry functions, "
          f"at most {report['max_registers']} registers; spills "
          f"{report['spill_lines'] or 'none'}", flush=True)

    if args.sass:
        report["sass"] = sass_counts(kg.KERNEL.library_path())
        for key, row in report["sass"].items():
            print(f"sass {key}: {row['total']} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in row["top"]),
                  flush=True)

    rng = np.random.default_rng(27)
    bad, cases = [], 0
    for w in CHECK_WIDTHS:
        for planes in (1, 2):
            for beam in (1, 2, 3):
                if beam > w:
                    continue
                for kind in ("random", "bit31", "zlow", "allzero"):
                    q, z, st = inputs(rng, planes, 16, w, 8, kind, torch)
                    want = ref.chain_greedy_ref(q, z, st, beam)
                    tiers = ["wide"] + (["register"] if kg.tier_of(w, beam)
                                        == "register" else [])
                    for tier in tiers:
                        got = kg.chain_greedy(q, z, st, beam, tier=tier)
                        torch.cuda.synchronize()
                        cases += 1
                        if not all(torch.equal(g, v)
                                   for g, v in zip(got, want)):
                            bad.append([tier, w, planes, beam, kind])
    report["check_cases"], report["check_bad"] = cases, bad
    print(f"checks: {cases} cases, {len(bad)} differ {bad[:8]}", flush=True)
    if bad:
        print(json.dumps(report))
        return 1

    variants = {}
    if args.variants:
        for name in VARIANTS:
            variants[name] = build_variant(name)
    timings = []
    for planes, r, w in TIME_SHAPES:
        q, z, st = inputs(rng, planes, r, w, 8, "half", torch)
        forms = {
            "shipped": lambda: kg.chain_greedy(q, z, st, 2),
            "wide": lambda: kg.chain_greedy(q, z, st, 2, tier="wide"),
        }
        for name, fn in variants.items():
            def run(fn=fn, q=q, z=z, st=st):
                o = torch.empty((r, 8, w), dtype=torch.int32, device="cuda")
                c = torch.empty((r, 8), dtype=torch.int32, device="cuda")
                err = fn(q.data_ptr(), z.data_ptr(), st.data_ptr(),
                         o.data_ptr(), c.data_ptr(), planes, r, 8, w, 2, 0,
                         torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"variant launch failed: {err}")
                return o, c
            forms[name] = run
        want = ref.chain_greedy_ref(q, z, st, 2)
        for name, fn in forms.items():
            if not all(torch.equal(g, v) for g, v in zip(fn(), want)):
                print(json.dumps(report))
                print(f"{name} differs at {(planes, r, w)}")
                return 1
        reps = max(2, args.reps if w * r <= 1600 * 152 else args.reps // 4)
        times = {k: [] for k in forms}
        for _ in range(3):
            for name, fn in forms.items():
                times[name].append(events_ms(torch, fn, reps))
        row = {"shape": [planes, r, w], "starts": 8, "beam": 2,
               "reps": reps, "ms": times}
        timings.append(row)
        print(f"  {planes} x {r} x {w}: " + ", ".join(
            f"{k} {min(v):.4f} ms (of {', '.join(f'{x:.4f}' for x in v)})"
            for k, v in times.items()), flush=True)
    report["timings"] = timings

    # One shape, four readings of the shipped form.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    q, z, st = inputs(rng, 2, 1600, 152, 8, "half", torch)

    def shipped():
        return kg.chain_greedy(q, z, st, 2)

    reading = {"events_ms": events_ms(torch, shipped, 20)}
    shipped()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(100):
        shipped()
    torch.cuda.synchronize()
    reading["host_clock_ms"] = (time.perf_counter() - t0) * 1e3 / 100
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            shipped()
        torch.cuda.synchronize()
    reading["kernel_ms"] = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA and "chain_greedy" in e.key
    ) / 1e3 / 10
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    reading["span_union_ms"] = busy / 1e3 / 10
    reading["spans"] = len(spans)
    reading["kernel_events"] = [
        [e.key[:60], e.count, e.self_device_time_total]
        for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    report["conv2_readings"] = reading
    print("conv2 readings: " + json.dumps(reading), flush=True)
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text[:2000])
    return 0


if __name__ == "__main__":
    sys.exit(main())
