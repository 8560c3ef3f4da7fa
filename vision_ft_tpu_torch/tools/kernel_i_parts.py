"""Where kernel I's time goes: the kernel with parts compiled out, timed.

Builds copies of ``csrc/flash_attention_shortk.cu`` in which parts of
kernel I (the short-K attention backward) are compiled out by ``#if``
guards put into the text (``PARTS``), and times each copy's kernel on the
card by torch.profiler (the card's time a call, 10 calls) at a few SDXL
shapes, every copy in turn on the same inputs. A part's cost is the whole
kernel's time less the time without it; parts overlap, so the costs do not
add up, and a copy without a part computes wrong gradients. With
``--against SOURCE`` it times that copy of the source beside this one
instead, in turns (this, that, that, this), and reports whether the two
give the same bits. The copies are measurements only; the package uses
none of them. Run on the card:

    python -m vision_ft_tpu_torch.tools.kernel_i_parts [--against path/to/flash_attention_shortk.cu]

Prints one line a shape, then one JSON line of {shape: {copy: [us, ...]}}.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import struct
import subprocess
from pathlib import Path

from ..ops import _build

SOURCE = _build.CSRC / "flash_attention_shortk.cu"
OUT_DIR = _build.BUILD_DIR / "kernel_i_parts"
SHAPES = [(4, 10, 4096, 77, 64), (4, 20, 1024, 77, 64), (2, 20, 1024, 77, 64),
          (4, 10, 4096, 152, 64)]

# (macro, first text of the part, the text just after it): kernel I's score
# products, softmax, dQ, gradient products, partial slots and their sum
GUARDS = [
    ("NO_SCORE_PRODUCTS", "        wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < DIN / 16; ++kk) {\n"
     "          wgmma_ss<S::kChunk>(s,", "        // the buffers are free once"),
    ("NO_SCORE_PRODUCTS", "        wgmma_wait<1>();\n        fence_operands(s);\n", "        // P = exp2("),
    ("NO_SOFTMAX", "#pragma unroll\n        for (int j = 0; j < S::kChunk / 8; ++j) {\n"
     "          const int key = c * S::kChunk + 8 * j + c0;\n          const bool all_in",
     "        wgmma_wait<0>();\n        fence_operands(dp);"),
    ("NO_SCORE_PRODUCTS", "        wgmma_wait<0>();\n        fence_operands(dp);\n", "        // dS = P (dP - delta) scale"),
    ("NO_SOFTMAX", "        // dS = P (dP - delta) scale\n", "      }\n      // P and dS visible to wgmma"),
    ("NO_DQ", "      float dq_acc[32];\n", "      if (last_of_head && lane == 0) mbar_arrive(&sm.kv_empty[buf]);"),
    ("NO_DQ", "#pragma unroll\n      for (int j = 0; j < 8; ++j) {\n        *reinterpret_cast<uint32_t*>(dq_box",
     "      ++own;"),
    ("NO_GRADIENT_PRODUCTS", "      wgmma_fence();\n#pragma unroll\n      for (int a = 0; a < kAccs; ++a) {\n        // dV^T",
     "      if (lane == 0) {\n        mbar_arrive(&sm.q_empty[stage]);"),
    ("NO_PARTIALS", "#pragma unroll\n      for (int a = 0; a < kAccs; ++a) {\n#pragma unroll\n"
     "        for (int g = 0; g < SKP / 8; ++g) {", "    }\n  }\n\n  // Every block's"),
    ("NO_SUM", "  cg::this_grid().sync();", "}\n\ntemplate <int D, int SKP>\nint launch_fwd("),
]
# each copy: the macros it defines (the parts it leaves out)
PARTS = {
    "whole": [],
    "no sum": ["NO_SUM"],
    "no partials, no sum": ["NO_PARTIALS", "NO_SUM"],
    "no gradient products": ["NO_GRADIENT_PRODUCTS"],
    "no dQ": ["NO_DQ"],
    "no softmax": ["NO_SOFTMAX"],
    "loads only": ["NO_SCORE_PRODUCTS", "NO_SOFTMAX", "NO_DQ", "NO_GRADIENT_PRODUCTS",
                   "NO_PARTIALS", "NO_SUM"],
}


def guarded_source(source: str) -> str:
    """``source`` with every part of ``GUARDS`` inside ``#if !defined(macro)``;
    raises if a part's text is not found (the source has moved on)."""
    for macro, start, end in GUARDS:
        i = source.index(start)
        j = source.index(end, i + len(start))
        source = source[:i] + f"#if !defined({macro})\n" + source[i:j] + "#endif\n" + source[j:]
    return source


def build(copies: dict[str, tuple[Path, list[str]]]) -> dict[str, Path]:
    """{name: library} from {name: (source, macros)}, one nvcc each, started together."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    running = {}
    for name, (source, macros) in copies.items():
        lib = OUT_DIR / (name.replace(" ", "_").replace(",", "") + ".so")
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
               *[f"-D{m}" for m in macros], "-o", str(lib), str(source)]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True), lib)
    libs = {}
    for name, (proc, lib) in running.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{out[-2000:]}")
        libs[name] = lib
    return libs


def main() -> None:
    args = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    args.add_argument("--against", type=Path,
                      help="another copy of csrc/flash_attention_shortk.cu to time beside this one")
    options = args.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ..ops import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("kernel_i_parts: needs a CUDA device")
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    if options.against:
        copies = {"this": (SOURCE, []), "that": (options.against.resolve(), [])}
        order = ["this", "that", "that", "this"]
    else:
        guarded = OUT_DIR / "guarded.cu"
        guarded.write_text(guarded_source(SOURCE.read_text()))
        copies = {name: (guarded, macros) for name, macros in PARTS.items()}
        order = list(PARTS)
    libs = build(copies)
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(0)
    results = {}
    for b, h, sq, sk, d in SHAPES:
        heads = lambda t: t.view(b, t.shape[1], h, d).transpose(1, 2)  # noqa: E731
        q, k, v, dout = (heads(torch.randn(b, n, h * d, device=device, generator=gen).bfloat16())
                         for n in (sq, sk, sk, sq))
        out, lse = fa.flash_attention_shortk(q, k, v, return_lse=True)
        delta = fa.flash_attention_masked_delta(out, dout)
        plan = fa.shortk_bwd_plan(b, h, sq, d, _build.sm_count(device))
        row, bits = {}, {}
        for name in order:
            grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
            scratch = torch.empty(fa._shortk_scratch_bytes(plan, sk), device=device,
                                  dtype=torch.uint8)
            dims = struct.pack("27q", b, h, sq, sk, d, plan.blocks,
                               *(s for t in (q, k, v, dout, *grads) for s in t.stride()[:3]))
            fn = ctypes.CDLL(str(libs[name])).flash_attention_shortk_bwd
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_float, ctypes.c_void_p]
            fn.restype = ctypes.c_int

            def call():
                err = fn(*(t.data_ptr() for t in (q, k, v, dout, lse, delta, *grads, scratch)),
                         dims, d**-0.5, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            bits.setdefault(name, tuple(g.clone() for g in grads))
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            us = sum(e.self_device_time_total / e.count for e in prof.key_averages()
                     if "shortk_bwd" in e.key)
            row.setdefault(name, []).append(round(us, 2))
        shape = str((b, h, sq, sk, d))
        results[shape] = row
        same = (f"; same bits: {all(torch.equal(x, y) for x, y in zip(bits['this'], bits['that']))}"
                if options.against else "")
        print(f"{shape}: " + ", ".join(f"{n} {ts}" for n, ts in row.items()) + " us" + same,
              flush=True)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "kernel_i_us": results}))


if __name__ == "__main__":
    main()
