"""``bf16x3_mm.cu``'s short-k instance at the solve-precision path's K = 1
outer products, in the layouts the path gives them, against another source
of the kernel.

    python -m zigp_tpu_torch.experiments.bf16x3_short_k [--baseline OLD.cu] [--sass DIR]

The factored contraction's backward makes two K = 1 products a step at
each configuration (the 105 × 250 grid at B = 8192, the champion at
B = 4000, the flagship at B = 1000; G = 2·B): dF = dC·tᵀ, (G, 1, 1)·(G, 1,
n) with t contiguous along n ("n-major"), and dt = Fᵀ·dC, (G, n, 1)·(G, 1,
1) with Fᵀ a view of the (2, n, B) factor, stride B along m and 1 along the
batch ("batch-major"); beside them the contiguous (G, n, 1) operand
("m-major"); and the flagship's factor-10 products (K = 10, G = 2: V =
L⁻¹ K_mn, L⁻ᵀ V, a served chunk of 4096 rows). For each, one JSON line:
the plan (label, members, span); device µs a call (``REPS`` calls
captured in a CUDA graph, one replay timed) of the kernel as planned and
with each count of members a CTA forced; of the ``--baseline`` source's
kernel on the same operands, and whether its bits equal this kernel's; for
K = 1 of ``torch.mul`` (the broadcast outer product, exact float32); of
exact-float32 ``torch.matmul``; the byte bound (A, B and C once over 3.35
TB/s); the largest difference from ``bf16x3_mm_plain``. Then, for each
library, the short-k kernels' registers and spills (``nvcc -Xptxas -v``)
and their SASS (``cuobjdump -sass``): instructions, the subroutines they
call (call sites, length), and the 32-bit reciprocal-based division
sequences (``MUFU.RCP`` after ``I2F.*.RP``); ``--sass DIR`` writes the SASS
of each short-k kernel there. Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import subprocess
from collections import Counter
from pathlib import Path

import torch

from ..ops.cuda import _build
from ..ops.cuda import bf16x3 as bx

PEAK_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
REPS = 50
CONFIGS = {"grid": (8192, 250), "champion": (4000, 200), "flagship": (1000, 100)}  # B, the later factor's n
# the flagship's factor-10 products, K = 10 (its first factor has 10 inducing points): V = L⁻¹ K_mn at B = 1000,
# L⁻ᵀ V, and a served chunk of 4096 rows
FACTOR10 = {"flagship L V": lambda r: (r(2, 10, 10), r(2, 10, 1000)),
            "flagship L-T V": lambda r: (r(2, 10, 10).mT, r(2, 10, 1000)),
            "flagship served chunk": lambda r: (r(2, 10, 10), r(2, 10, 4096))}


def operands(layout: str, B: int, n: int, r):
    """(a, b) of one K = 1 product of the path at B rows (G = 2·B) and the
    later factor's n, in ``layout``."""
    if layout == "n-major":  # dF = dC·tᵀ: t (2, B, n, 1) contiguous, transposed
        return r(2, B, 1, 1), r(2, B, n, 1).mT
    if layout == "batch-major":  # dt = Fᵀ·dC: F the (2, n, B) factor, Fᵀ (2, B, n, 1)
        return r(2, n, B).mT.unsqueeze(-1), r(2, B, 1, 1)
    return r(2, B, n, 1), r(2, B, 1, 1)  # m-major: a contiguous (2, B, n, 1)


def device_us(fn) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(REPS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / REPS * 1e3


def with_patch(fn, **patches):
    """``fn()`` with attributes of ``bf16x3`` replaced, the call cache
    emptied before and after (a plan is cached by signature)."""
    saved = {k: getattr(bx, k) for k in patches}
    bx._CALLS.clear()
    for k, v in patches.items():
        setattr(bx, k, v)
    try:
        return fn()
    finally:
        for k, v in saved.items():
            setattr(bx, k, v)
        bx._CALLS.clear()


def build_baseline(src: Path) -> tuple[ctypes.CDLL, Path, str]:
    """Another ``bf16x3_mm.cu`` built with the library's flags: (its
    ``zigp_bf16x3_mm_f32``'s library, its path, nvcc's output). Its C
    interface takes a prefix of the 23 parameters."""
    out = _build.BUILD_DIR / "libbf16x3_baseline.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(src)]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(out))
    lib.zigp_bf16x3_mm_f32.argtypes = [ctypes.c_void_p] * 5
    lib.zigp_bf16x3_mm_f32.restype = ctypes.c_int
    return lib, out, done.stdout + done.stderr


def ptxas_lines(log: str) -> list[str]:
    """``-Xptxas -v``'s lines about the short-k kernels: the function line and
    the two after it (stack and spills; registers and shared memory)."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "short_k" in line:
            out.extend(s.strip() for s in lines[i:i + 4] if "bytes" in s or "registers" in s or "Compiling" in s)
    return out


def sass_functions(lib: Path) -> dict[str, list[str]]:
    """{function: its SASS lines} of the short-k kernels in ``lib``."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1) if "short_k" in m.group(1) else None
            if name:
                funcs[name] = []
        elif name:
            funcs[name].append(line)
    return funcs


def sass_summary(lines: list[str]) -> dict:
    """Instructions and opcodes; the subroutines called (by target address:
    call sites and instructions up to the RET); the 32-bit reciprocal-based
    division sequences (``MUFU.RCP`` after ``I2F.*.RP``)."""
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")
    ops = [(int(m.group(1), 16), m.group(2), m.group(3)) for m in map(instr.search, lines) if m]
    calls = Counter(int(re.search(r"0x([0-9a-f]+)", arg).group(1), 16) for _, op, arg in ops
                    if op.startswith("CALL") and re.search(r"0x[0-9a-f]+", arg))
    subs = {}
    for target in calls:
        start = next((i for i, (addr, _, _) in enumerate(ops) if addr == target), None)
        if start is not None:
            end = next((i for i in range(start, len(ops)) if ops[i][1].startswith("RET")), len(ops) - 1)
            subs[hex(target)] = {"calls": calls[target], "instructions": end - start + 1}
    count = Counter(op.split(".")[0] for _, op, _ in ops)
    return {"instructions": len(ops), "subroutines": subs, "rcp": count["MUFU"],
            "i2f_rp": sum(op.startswith("I2F") and ".RP" in op for _, op, _ in ops),
            "imad_hi": sum(op.startswith("IMAD.HI") for _, op, _ in ops), "top": count.most_common(12)}


def card() -> str:
    q = "--query-gpu=name,power.limit"
    return subprocess.run(["nvidia-smi", q, "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, help="another bf16x3_mm.cu to build and time beside this one")
    ap.add_argument("--configs", nargs="*", default=list(CONFIGS), choices=list(CONFIGS))
    ap.add_argument("--layouts", nargs="*", default=["n-major", "batch-major", "m-major"])
    ap.add_argument("--sass", type=Path, help="a directory for the short-k kernels' SASS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bf16x3_short_k: needs a CUDA device")
    libs = {"this": _build.build_all()["bf16x3_mm"]}
    logs = {"this": _build.build_log("bf16x3_mm")}
    base_fn = None
    if args.baseline is not None:
        lib, libs["baseline"], logs["baseline"] = build_baseline(args.baseline)
        base_fn = lib.zigp_bf16x3_mm_f32
    info = card()
    gen = torch.Generator(device="cuda").manual_seed(19)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    cases = [(cfg, layout, lambda r, B=CONFIGS[cfg][0], n=CONFIGS[cfg][1], layout=layout: operands(layout, B, n, r))
             for cfg in args.configs for layout in args.layouts]
    cases += [(name, "", make) for name, make in FACTOR10.items()]
    for cfg, layout, make in cases:
        a, b = make(r)
        p = bx.plan_of(a, b)
        G, M, N, K = math.prod(a.shape[:-2]), a.shape[-2], b.shape[-1], a.shape[-1]
        c = bx.bf16x3_mm_cuda(a, b)
        row = {"config": cfg, "layout": layout, "G": G, "M": M, "N": N, "K": K, "plan": p.label,
               "members": p.members, "span": p.span,
               "max_abs_vs_plain": (c - bx.bf16x3_mm_plain(a, b)).abs().max().item(),
               "device_us": device_us(lambda: bx.bf16x3_mm_cuda(a, b))}
        for m in bx.SK_MEMBERS if p.layout != "batch-major" else ():  # batch-major: 32 members, a lane each
            row[f"members_{m}_us"] = with_patch(lambda: device_us(lambda: bx.bf16x3_mm_cuda(a, b)),
                                                SK_MEMBERS=(m,))
        if base_fn is not None:
            old = with_patch(lambda: bx.bf16x3_mm_cuda(a, b), _fn=base_fn)
            row["baseline_same_bits"] = bool(torch.equal(old, c))
            row["baseline_us"] = with_patch(lambda: device_us(lambda: bx.bf16x3_mm_cuda(a, b)), _fn=base_fn)
        if K == 1:
            row["mul_us"] = device_us(lambda: torch.mul(a, b))
        row["matmul_us"] = device_us(lambda: torch.matmul(a, b))
        row["bound_us"] = 4 * G * (M * K + K * N + M * N) / PEAK_BYTES_PER_S * 1e6
        row["card"] = info
        print(json.dumps(row), flush=True)
    for name, path in libs.items():
        funcs = sass_functions(path)
        if args.sass is not None:
            args.sass.mkdir(parents=True, exist_ok=True)
            for i, (f, lines) in enumerate(sorted(funcs.items())):
                (args.sass / f"{name}_short_k_{i}.sass").write_text(f + "\n" + "\n".join(lines) + "\n")
        print(json.dumps({"library": name, "ptxas": ptxas_lines(logs[name]),
                          "sass": {f: sass_summary(lines) for f, lines in sorted(funcs.items())}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
