"""Time probes of the inverse-chain kernel: variants of csrc/chain.cu that skip a part.

    python3 tools/probe_chain.py [--f32] [VARIANT,VARIANT,...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  Each variant
is the current ``hcflow_tpu_torch/csrc/chain.cu`` with one textual edit (``EDITS``),
built with nvcc into a temporary directory and called through the same C entry point
on the same padded pack and inputs (the bf16 recipe at hid 64, the kernel
``chain_step_mma_kernel``; with ``--f32`` the float32 recipe, ``chain_step_f32_kernel``
and ``EDITS_F32``): 13-step chains at batch 16 of the x4 / x8 shapes
c 12 at 80x80, c 6 at 80x80 with cond terms, c 24 at 40x40 and c 48 at 20x20.  Prints
one line of ms per chain per shape, variants in the order given (default: all, the
full kernel first and last to show drift).  The variants that skip work give wrong
results on purpose; ``no_pdl`` must match ``full`` bit for bit, and is checked.

Variants: ``full``; ``no_pdl``, launched without programmatic stream serialization;
``empty``, each block returns at once (launch and scheduling cost); ``no_mma``, the
tensor-core products dropped (ldmatrix loads kept); ``no_tail``, the float32 Wt
product dropped (its stores kept).  The float32 kernel's (``--f32``): ``full``,
``empty``, ``no_tail``; ``one_mma``, one TF32 product a product (hi x hi) instead of
three; ``no_split``, the operands passed to the products unsplit (no cvt, no subtraction);
``no_w3``, conv3's weights not staged (its products read whatever the region holds).  An
edit whose text is no longer in the source raises: update EDITS with the kernel.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.getcwd()
SRC = os.path.join(ROOT, "hcflow_tpu_torch", "csrc", "chain.cu")
EDITS = {
    "full": [],
    "no_pdl": [("programmaticStreamSerializationAllowed = 1",
                "programmaticStreamSerializationAllowed = 0")],
    "empty": [("  const Lay L(c, th, tw);\n", "  if (H > 0) return;\n  const Lay L(c, th, tw);\n")],
    "no_mma": [("      \"mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, \"\n"
                "      \"{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n\"",
                "      \"// {%0, %1, %2, %3} {%4, %5, %6, %7}, {%8, %9}\\n\"")],
    "no_tail": [("    for (int k = 0; k < c; ++k) {\n      const float4 w",
                 "    for (int k = 0; k < 0; ++k) {\n      const float4 w")],
}
# float32 probes: helpers put in front of the float32 kernel, and edits that apply to
# every occurrence (count -1)
_F32_ANCHOR = "constexpr int MAX_MT3 = 2;"
_F32_HELPERS = """
__device__ __forceinline__ void probe_split(uint32_t x, uint32_t& hi, uint32_t& lo) { hi = lo = x; }
template <int N>
__device__ __forceinline__ void probe_split(const uint32_t (&x)[N], uint32_t (&hi)[N],
                                            uint32_t (&lo)[N]) {
  for (int i = 0; i < N; ++i) hi[i] = lo[i] = x[i];
}
__device__ __forceinline__ void probe_1mma(float& d0, float& d1, float& d2, float& d3,
                                           const uint32_t (&ah)[4], const uint32_t (&al)[4],
                                           uint32_t bh0, uint32_t bh1, uint32_t bl0,
                                           uint32_t bl1) {
  asm volatile("" ::"r"(al[0]), "r"(al[1]), "r"(al[2]), "r"(al[3]), "r"(bl0), "r"(bl1));
  conv3x3::mma_tf32(d0, d1, d2, d3, ah, bh0, bh1);
}
"""
EDITS_F32 = {
    "full": [],
    "empty": [("  const uint32_t s0 = smem_addr(smem);\n  const float* s_w1",
               "  if (H > 0) return;\n"
               "  const uint32_t s0 = smem_addr(smem);\n  const float* s_w1")],
    "no_tail": EDITS["no_tail"],
    "one_mma": [(_F32_ANCHOR, _F32_ANCHOR + _F32_HELPERS),
                ("conv3x3::mma_3xtf32(", "probe_1mma(", -1)],
    "no_split": [(_F32_ANCHOR, _F32_ANCHOR + _F32_HELPERS),
                 ("conv3x3::split_tf32(", "probe_split(", -1)],
    "no_w3": [("    for (int i = tid; i < 3 * HID * (N3P / 4); i += NTHREADS)\n"
               "      conv3x3::cp_async16",
               "    for (int i = tid; i < 0; i += NTHREADS)\n      conv3x3::cp_async16")],
}
SHAPES = [(12, 80, False), (6, 80, True), (24, 40, False), (48, 20, False)]


def build(names, out, edits=EDITS):
    from hcflow_tpu_torch import _build

    text = open(SRC).read()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
             "-Xcompiler", "-fPIC", f"-I{os.path.dirname(SRC)}"]
    procs = {}
    for name in names:
        src = text
        for old, new, *count in edits[name]:
            if old not in src:
                raise RuntimeError(f"probe {name}: edit not found in chain.cu: {old!r}")
            src = src.replace(old, new, *(count or [1]))
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen([_build._nvcc(), *flags, "-o", path[:-3] + ".so", path],
                                       stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
                                       text=True)
    for name, proc in procs.items():
        err = proc.communicate()[1]
        if proc.returncode != 0:
            raise RuntimeError(f"probe {name} did not build:\n{err}")


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    f32 = bool(args) and args[0] == "--f32"
    args = args[1:] if f32 else args
    edits = EDITS_F32 if f32 else EDITS
    default = (["full", "empty", "no_tail", "one_mma", "no_split", "no_w3", "full"] if f32 else
               ["full", "no_pdl", "empty", "no_mma", "no_tail", "full"])
    names = args[0].split(",") if args else default
    cd = None if f32 else "bfloat16"
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch.flow import stack
    from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
    from hcflow_tpu_torch.ops import chain

    if not torch.cuda.is_available():
        print("probe_chain: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    out = tempfile.mkdtemp(prefix="probe_chain_")
    t0 = time.perf_counter()
    build(dict.fromkeys(names), out, edits)
    print(f"built {len(set(names))} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    libs = {}
    for name in dict.fromkeys(names):
        lib = ctypes.CDLL(os.path.join(out, f"{name}.so"))
        lib.hcflow_chain_inverse.argtypes = chain._ARGTYPES
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, K = 16, 13
    print("ms per 13-step chain:", " ".join(names), flush=True)
    for c, hw, cond in SHAPES:
        spec = FlowStepSpec(in_channels=c, cond_channels=128 if cond else None,
                            hidden_channels=64, compute_dtype=cd)
        steps = stack.init_stack(spec, torch.Generator().manual_seed(12), K)
        steps = cs._to(stack.precompute_invconv(cs.perturb(steps, gen)), "cuda")
        pk = chain.pack_inverse_chain(steps, cd, padded=True)
        z = torch.randn(B, hw, hw, c, device="cuda", generator=gen)
        uc = None
        if cond:
            u = torch.randn(B, hw, hw, 128, device="cuda", generator=gen)
            uc = stack.compute_u_contribs(spec, steps, u).to(pk["w1"].dtype).contiguous()
        bufs = [torch.empty_like(z), torch.empty_like(z)]
        times, results = [], {}
        for name in names:
            def run(lib=libs[name]):
                err = lib.hcflow_chain_inverse(
                    z.data_ptr(), bufs[0].data_ptr(), bufs[1].data_ptr(),
                    uc.data_ptr() if uc is not None else None,
                    *(pk[k].data_ptr() for k in ("w1", "w2", "w3", "vec", "wt", "ab")),
                    B, hw, hw, c, 64, K, int(f32), torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"probe {name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            results.setdefault(name, bufs[(K - 1) % 2].clone())
            times.append(cs.cuda_time(run, reps=20))
        if "no_pdl" in results and "full" in results and not torch.equal(results["no_pdl"],
                                                                          results["full"]):
            raise AssertionError("no_pdl differs from full")
        print(f"c {c} {hw}x{hw}{' cond' if cond else ''}:", " ".join(f"{t:.4f}" for t in times),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
