"""Where the time of the fused acyclicity gradient #9 goes, on one CUDA card.

    python tools/acyclic_grad_split.py

builds ``dibs_tpu_torch/csrc/acyclic_grad.cu`` as it is and in variants
made by source substitution, each into its own library under
``_tree_check/acyclic_split/``:

* ``nodraw``: g from the score alone (no Philox draw, no division);
* ``nochain``: the power chain cut to its first step (the copy);
* ``nodraw_nochain``: both.

The variants compute wrong numbers on purpose; they only time the phases.
Each library is timed in turns (kernel, variants, then in reverse) at the
microbenchmark's P=1000, d=128, K=8 and at P=132 (one wave), the median of
CUDA-event-timed calls after a warm-up. It prints the registers
``-Xptxas -v`` reports, the card's name and power limit, and its SM clock
and power sampled every 0.2 s while the kernel runs. The chain's share is
``kernel - nochain``, the draw's ``kernel - nodraw``.

Then it reads the SASS of ``acyclic_grad_quad_kernel<2>`` (``cuobjdump
-sass``) and, for each product loop (a backward branch over more than 100
FFMA, at least 70% of its instructions), counts its instructions by kind
and the FFMA whose two or three sources not marked ``.reuse`` have the same
register parity (a conflict if the register file has two banks, register
n in bank n % 2).
"""
import ctypes
import os
import re
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "_tree_check", "acyclic_split")
SRC = os.path.join(ROOT, "dibs_tpu_torch", "csrc", "acyclic_grad.cu")
DRAW = ("float g = kInjected ? g_logistic(x[j], s[j], alpha)\n"
        "                        : g_uniform(row * d + col, m, p, k0, k1, "
        "s[j], alpha);")
CHAIN = "    for (int n = d - 1; n > 0;) {"
VARIANTS = ("kernel", "nodraw", "nochain", "nodraw_nochain")


def variant_source(name):
    src = open(SRC).read()
    for needle in (DRAW, CHAIN):
        if needle not in src:
            raise SystemExit(f"the source no longer holds {needle!r}")
    if "nodraw" in name:
        src = src.replace(DRAW, "float g = 0.25f + 1e-3f * s[j];")
    if "nochain" in name:
        src = src.replace(CHAIN, "    for (int n = 1; n > 0;) {")
    return src


def build(names):
    from dibs_tpu_torch.ops import gpu_kernels as gk

    os.makedirs(OUT, exist_ok=True)
    procs = []
    for name in names:
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(variant_source(name))
        cmd = [gk._nvcc(), *gk._NVCC_FLAGS, "-shared",
               f"-I{os.path.dirname(SRC)}", cu, "-o",
               os.path.join(OUT, f"lib{name}.so")]
        procs.append((name, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"{name}: registers of the tiers' kernels {regs}", flush=True)


def main():
    import torch

    from dibs_tpu_torch.ops import gpu_kernels as gk

    build(VARIANTS)
    dev = torch.device("cuda:0")
    p, d, k = 1000, 128, 8
    plan = gk.acyclic_grad_plan(d)
    gen = torch.Generator(device=dev).manual_seed(0)
    scores = 0.5 * torch.randn((p, d, d), generator=gen, device=dev)
    out = torch.empty_like(scores)
    scratch = torch.empty((p, plan.tile * plan.tile * 256), device=dev)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name in VARIANTS:
        lib = ctypes.CDLL(os.path.join(OUT, f"lib{name}.so"))
        lib.dibs_acyclic_grad.argtypes = [vp] * 4 + [
            i32, i32, i32, ctypes.c_uint64, ctypes.c_float, i32, i32, vp]
        libs[name] = lib

    def run(lib, n_particles):
        rc = lib.dibs_acyclic_grad(
            scores.data_ptr(), None, out.data_ptr(), scratch.data_ptr(),
            n_particles, d, k, 7, 0.2, plan.tile, plan.stride,
            torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise SystemExit(f"launch failed: {rc}")

    def median_ms(fn, reps=15):
        for _ in range(5):
            fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    run(libs["kernel"], p)
    torch.cuda.synchronize(dev)
    want = gk.acyclic_grad(scores, 7, 0.2, k)
    if not torch.equal(out, want):
        raise SystemExit("the unchanged source's library disagrees with "
                         "gpu_kernels.acyclic_grad")
    times = {name: [] for name in VARIANTS}
    for name in VARIANTS + VARIANTS[::-1]:
        times[name].append((median_ms(lambda: run(libs[name], p)),
                            median_ms(lambda: run(libs[name], 132))))
    for name in VARIANTS:
        print(f"{name}: P={p} " + " / ".join(f"{a:.4f}" for a, _ in
                                             times[name])
              + " ms; P=132 (one wave) "
              + " / ".join(f"{b:.4f}" for _, b in times[name]) + " ms",
              flush=True)
    mean = {name: statistics.mean(a for a, _ in times[name])
            for name in VARIANTS}
    print(f"at P={p}, d={d}, K={k}: chain (kernel - nochain) "
          f"{mean['kernel'] - mean['nochain']:.4f} ms, draw (kernel - "
          f"nodraw) {mean['kernel'] - mean['nodraw']:.4f} ms, the rest "
          f"(nodraw_nochain) {mean['nodraw_nochain']:.4f} ms of "
          f"{mean['kernel']:.4f}", flush=True)

    samples, done = [], threading.Event()

    def poll():
        while not done.is_set():
            smi = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True)
            samples.append(smi.stdout.strip())
            time.sleep(0.2)

    thread = threading.Thread(target=poll)
    thread.start()
    t0 = time.time()
    while time.time() - t0 < 3.0:
        for _ in range(20):
            run(libs["kernel"], p)
        torch.cuda.synchronize(dev)
    done.set()
    thread.join()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}; SM clock and power under the kernel: "
          f"{samples[2:]}", flush=True)


def sass_loops(so):
    """Instruction counts of the product loops of acyclic_grad_quad_kernel
    <2> in the library ``so`` (see the module docstring)."""
    from dibs_tpu_torch.ops import gpu_kernels as gk

    cuobjdump = os.path.join(os.path.dirname(gk._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", so], capture_output=True,
                          text=True, check=True).stdout
    funcs = re.split(r"\n\s*Function : ", text)
    body = next(f for f in funcs
                if re.match(r"\S*acyclic_grad_quad_kernelILi2EE", f))
    insts = re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)
    addrs = [int(a, 16) for a, _ in insts]
    for idx, (_, inst) in enumerate(insts):
        m = re.search(r"BRA (0x[0-9a-f]+)", inst)
        if not m or int(m.group(1), 16) >= addrs[idx]:
            continue
        loop = [i for _, i in insts[addrs.index(int(m.group(1), 16)):idx + 1]]
        kinds = {}
        for i in loop:
            op = i.split()[1] if i.startswith("@") else i.split()[0]
            kinds[op] = kinds.get(op, 0) + 1
        if kinds.get("FFMA", 0) <= 100 or kinds["FFMA"] < 0.7 * len(loop):
            continue  # not an innermost product loop
        same = 0
        for i in loop:
            f = re.match(r"FFMA R\d+, (R\d+)(\.reuse)?, (R\d+)(\.reuse)?, "
                         r"(R\d+)(\.reuse)?", i)
            if f:
                live = [int(f.group(k)[1:]) % 2 for k in (1, 3, 5)
                        if not f.group(k + 1)]
                same += len(live) != len(set(live))
        top = sorted(kinds.items(), key=lambda kv: -kv[1])
        print(f"quad<2> loop of {len(loop)} instructions: {top}; FFMA with "
              f"two non-reused sources of one parity: {same}", flush=True)


if __name__ == "__main__":
    main()
    sass_loops(os.path.join(OUT, "libkernel.so"))
