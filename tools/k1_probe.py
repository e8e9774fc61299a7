"""Where a router cycle's time goes on the card: a probe for the K1 kernel.

    python3 tools/k1_probe.py [--out REPORT.json]

Needs one CUDA card and nvcc; builds into ``build/probe/`` (gitignored).
Two parts:

1. latencies - a microbenchmark kernel, 12 blocks as the 12-lane drains
   run, at 96, 320, 640 and 1024 threads: one ``__syncthreads()``, a
   dependent shared-memory load, a dependent returning shared atomic (every
   thread issuing them), a dependent L2-hit global load (``__ldcg``), a
   dependent warp shuffle, and a global store / barrier / load of another
   thread's word / barrier round trip; SM clocks per step, each a mean over
   the block's thread 0.
2. phases - ``csrc/router_step.cu`` with ``clock64()`` stamps added at each
   barrier of the cycle loop (a copy; the source is not changed): per
   simulated cycle, the clocks from one barrier to the next and, within
   that, until the last warp reached the barrier (its work), on the warm
   full-width state of each paper mesh (the trained LeNet's O0/O1/O2 batch,
   12 lanes, after 4,096 cycles), 256 cycles; beside them the uninstrumented
   kernel's microseconds per cycle. The stamps cost clocks themselves (one
   shared atomic per warp a phase), so the phase clocks are upper bounds.

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
CKPT = os.path.join(REPO, "experiments", "weights", "lenet", "step_000000400")
NVCC = ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]

LATENCY_CU = r"""
#include <cuda_runtime.h>
__global__ void probe(int* g, long long* out, int n) {
    extern __shared__ int s[];
    const int tid = threadIdx.x;
    for (int i = tid; i < 8192; i += blockDim.x) s[i] = (i * 7 + 1) & 8191;
    __syncthreads();
    long long t0 = clock64();
    for (int i = 0; i < 100; ++i) __syncthreads();
    if (tid == 0) out[0] = (clock64() - t0) / 100;
    int x = tid & 8191;
    t0 = clock64();
    for (int i = 0; i < 100; ++i) x = s[x];
    if (tid == 0) out[1] = (clock64() - t0) / 100 + (x == -1);
    __syncthreads();
    x = tid & 1023;
    t0 = clock64();
    for (int i = 0; i < 100; ++i) x = (atomicAdd(&s[x], 0) + tid) & 1023;
    if (tid == 0) out[2] = (clock64() - t0) / 100 + (x == -1);
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) g[i] = (i * 97 + 13) % n;
    __syncthreads();
    x = tid % n;
    t0 = clock64();
    for (int i = 0; i < 50; ++i) x = __ldcg(&g[x]);
    if (tid == 0) out[3] = (clock64() - t0) / 50 + (x == -1);
    x = tid;
    t0 = clock64();
    for (int i = 0; i < 100; ++i) x = __shfl_xor_sync(0xffffffffu, x, 1) + 1;
    if (tid == 0) out[4] = (clock64() - t0) / 100 + (x == -1);
    __syncthreads();
    int acc = 0;
    t0 = clock64();
    for (int i = 0; i < 50; ++i) {
        g[(tid * 17 + i) % n] = i + acc;
        __syncthreads();
        acc += g[((tid + 1) * 17 + i) % n];
        __syncthreads();
    }
    if (tid == 0) out[5] = (clock64() - t0) / 50 + (acc == -1);
}
extern "C" int run_probe(int threads, long long* host) {
    int* g; long long* out;
    if (cudaMalloc(&g, 1 << 22) || cudaMalloc(&out, 64)) return 1;
    cudaFuncSetAttribute(probe, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         64 * 1024);
    for (int rep = 0; rep < 2; ++rep)
        probe<<<12, threads, 64 * 1024>>>(g, out, 40000);
    cudaMemcpy(host, out, 6 * sizeof(long long), cudaMemcpyDeviceToHost);
    cudaFree(g);
    cudaFree(out);
    return (int)cudaGetLastError();
}
"""
LATENCIES = ("barrier", "shared_load", "shared_atomic", "l2_load",
             "shuffle", "store_barrier_load_barrier")


def build(name: str, source: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, name + ".cu"), os.path.join(OUT, name + ".so")
    with open(cu, "w") as f:
        f.write(source)
    subprocess.run(NVCC + ["-o", so, cu], check=True, capture_output=True)
    return ctypes.CDLL(so)


def instrument(src: str) -> str:
    """The router kernel with clock64() stamps at every barrier of the cycle
    loop (all but the first barrier of the source, which ends the launch's
    loads), accumulated per block into a device array read by prof_read."""
    src = src.replace("namespace {\n", "namespace {\n__device__ long long "
                      "g_prof[4096][8];\n", 1)
    parts = src.split("__syncthreads();")
    phases = len(parts) - 2
    out = parts[0] + (
        "__syncthreads();\n    __shared__ unsigned long long s_end[3];\n"
        "    if (threadIdx.x < 3) s_end[threadIdx.x] = 0;\n"
        "    __syncthreads();\n    long long t_prev = clock64();\n"
        "    long long acc[3] = {0, 0, 0}, work[3] = {0, 0, 0};")
    for k in range(phases):
        out += parts[k + 1] + (
            f"if ((threadIdx.x & 31) == 0) atomicMax(&s_end[{k}], "
            "(unsigned long long)clock64());\n        __syncthreads();\n"
            "        if (threadIdx.x == 0) { long long t = clock64(); "
            f"acc[{k}] += t - t_prev; work[{k}] += (long long)s_end[{k}] - "
            f"t_prev; s_end[{k}] = 0; t_prev = t; }}")
    out += parts[-1]
    tail = "    if (keeper) {\n        a.ejected[b] = ej;"
    if tail not in out:
        raise RuntimeError("router_step.cu changed: update the probe's "
                           "instrumentation anchors")
    out = out.replace(tail, (
        "    if (threadIdx.x == 0) { for (int k = 0; k < 3; ++k) { "
        "g_prof[b][k] = acc[k]; g_prof[b][4 + k] = work[k]; } "
        "g_prof[b][3] = c; }\n") + tail)
    return out + ('\nextern "C" int prof_read(void* out) { return (int)'
                  'cudaMemcpyFromSymbol(out, g_prof, sizeof(g_prof)); }\n')


def warm_states(meshes):
    """The full-width O0/O1/O2 LeNet batch of each mesh after 4,096 cycles."""
    import torch
    from repro_torch.core import wire
    from repro_torch.data import glyph_batch
    from repro_torch.kernels import ops
    from repro_torch.models import LeNet, load_checkpoint
    from repro_torch.noc import sim
    from repro_torch.noc.sweep import _QUANTIZERS
    from repro_torch.noc.topology import mesh_by_name
    from repro_torch.noc.traffic import build_traffic_streamed
    net = LeNet(load_checkpoint(CKPT, device="cuda").params, device="cuda")
    img, _ = glyph_batch(torch.Generator(device="cuda").manual_seed(7), 1,
                         device="cuda")
    layers = net.layer_traffic(img[0])
    variants = [(wire.by_name(tr, tiebreak=tb), _QUANTIZERS[p])
                for p in ("float32", "fixed8") for tb in ("stable", "pattern")
                for tr in ("O0", "O1", "O2")]
    for mesh, streams in meshes:
        cfg = mesh_by_name(mesh)
        key = (cfg.rows, cfg.cols, cfg.num_vcs, cfg.vc_depth, cfg.lanes)
        wr = sim.fuse_traffic(build_traffic_streamed(
            layers, cfg, variants, num_streams=streams))
        b = wr.length.shape[0]
        mc = torch.as_tensor(np.broadcast_to(np.asarray(
            tuple(cfg.mc_nodes) + (0,) * (streams - cfg.num_mcs), np.int32),
            (b, streams)).copy(), device="cuda")
        st = sim.make_state(cfg, streams, batch=b, device="cuda")
        ops.router_step(st, wr, mc, 4096, key, True)
        torch.cuda.synchronize()
        yield mesh, cfg, key, wr, mc, st


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("k1_probe: needs a CUDA card")
    from repro_torch.kernels import ops, router_step as rs
    from repro_torch.noc import sim
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    report = {"card": card, "latency_clocks": {}, "phases": {}}
    lat = build("latency", LATENCY_CU)
    for threads in (96, 320, 640, 1024):
        buf = (ctypes.c_longlong * 6)()
        if lat.run_probe(threads, buf):
            sys.exit("k1_probe: the latency kernel failed")
        report["latency_clocks"][threads] = dict(zip(LATENCIES, list(buf)))
    with open(os.path.join(REPO, "src", "repro_torch", "kernels", "csrc",
                           "router_step.cu")) as f:
        lib = build("router_phases", instrument(f.read()))
    cycles = 256
    for mesh, cfg, key, wr, mc, st in warm_states(
            (("4x4_mc2", 2), ("8x8_mc4", 8), ("8x8_mc8", 8))):
        b, m, t, _ = wr.wire.shape
        lay = rs.smem_layout(key, m)
        times = []
        for _ in range(6):
            s2 = sim.SimState(*(x.clone() for x in st))
            e0, e1 = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            e0.record()
            ops.router_step(s2, wr, mc, cycles, key, True)
            e1.record()
            e1.synchronize()
            times.append(e0.elapsed_time(e1))
        offs = (ctypes.c_int * len(rs.LAYOUT_FIELDS))(
            *(lay.offsets[n] for n in rs.LAYOUT_FIELDS))
        s2 = sim.SimState(*(x.clone() for x in st))
        torch.cuda.synchronize()
        err = lib.router_step_run(
            *(ctypes.c_void_p(x.data_ptr()) for x in s2),
            ctypes.c_void_p(wr.wire.data_ptr()),
            ctypes.c_void_p(wr.length.data_ptr()),
            ctypes.c_void_p(mc.data_ptr()), b, cfg.rows, cfg.cols,
            cfg.num_vcs, cfg.vc_depth, cfg.lanes, m, t, cycles, 1,
            ctypes.cast(offs, ctypes.c_void_p), rs.INJ_RING, lay.threads,
            lay.bytes, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        torch.cuda.synchronize()
        if err:
            sys.exit(f"k1_probe: the instrumented kernel failed ({err})")
        buf = np.zeros((4096, 8), np.int64)
        lib.prof_read(buf.ctypes.data_as(ctypes.c_void_p))
        run = max(float(buf[:b, 3].mean()), 1.0)
        report["phases"][mesh] = {
            "us_per_cycle": float(np.median(times[1:])) * 1e3 / cycles,
            "threads": lay.threads, "lanes": b,
            "phase_clocks": [float(x) for x in buf[:b, :3].mean(0) / run],
            "work_clocks": [float(x) for x in buf[:b, 4:7].mean(0) / run]}
    text = json.dumps(report)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)


if __name__ == "__main__":
    main()
