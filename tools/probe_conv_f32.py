"""Time variants of the float32 tile convs (csrc/conv3x3.cuh: the wide
``conv_tile_f32w``, output channels x pixels, at COUT 32 and 64; the narrow
``conv_tile_f32``, pixels x output channels, at COUT 16) under the float32 per-RRDB and
resident-trunk kernels.

    python3 tools/probe_conv_f32.py [VARIANT,VARIANT,...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.  Each variant
is the current ``hcflow_tpu_torch/csrc/conv3x3.cuh`` (or a kernel source) with textual
edits (``EDITS``, each applied wherever its text occurs), built with ``csrc/rrdb.cu`` and
``csrc/rrdb_trunk.cu`` by nvcc into a temporary directory (all in parallel) and called
through the same C entry points (``hcflow_rrdb_apply_f32``,
``hcflow_rrdb_trunk_apply_f32``) on the same float32 packs and inputs: one RRDB at nf 64
/ gc 32 at batch 16 40x40 and 80x80 (the x4 SR shapes) and batch 1 339x510 (a DIV2K
photo's LR), nf 64 / gc 16 at 16x80x80 (the rescaling model's) and nf 32 / gc 16 at
16x80x80 (the tiny checkpoint's), and a trunk of nb 5 at nf 64 / gc 32 at batch 16
20x20, 40x40 and 80x80 (the x8 model's).  Prints the card; each variant's ptxas spill
stores for every float32 per-RRDB and trunk instance; one line of ms per RRDB or trunk
per shape, variants in the order given (default: the full kernel first and last to show
drift); and each variant's largest error against the plain version relative to its
largest magnitude (a trunk's also whether it equals the variant's per-RRDB kernel bit for
bit).  The design variants must hold chip_smoke.py's 1e-5 and are checked; the variants
that skip work give wrong results on purpose and are not.

Design variants: ``full``; ``narrow``, the narrow orientation at every width (the
per-RRDB kernels as they were before the wide conv; the trunk keeps its rolled-up copy
loops); ``deep``, 16 input channels a stage (two k8 steps a tap)
and one block an SM, the stages as deep as fit (2); ``deep8``, 8 channels a stage and one
block an SM (4 stages); ``s2`` and ``s3``, at most 2 or 3 stages; ``unfused``, three
products a k8 step in the narrow conv at COUT 16 (no hi x [B hi | B lo] product);
``late_split``, the next stage split after the products are waited out, not while they
run; ``trunk_mt2``, the float32 trunk on 16-wide tiles at every width.  Probes:
``one_mma``, one product a k8 step (W hi x X hi; at COUT 32 [W hi; W lo] x X hi; in the
narrow conv hi x hi, or the fused hi x [B hi | B lo]); ``no_split``, the input's stage
not split (the lo plane left as it is); ``no_b``, the weights' planes not staged (the
products read whatever the region holds).  With ``one_mma`` the products' share of the
time shows, with ``no_b`` and ``no_split`` the ring's.  An edit whose text is no longer in
the source raises: update EDITS with the kernel.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.getcwd()
CSRC = os.path.join(ROOT, "hcflow_tpu_torch", "csrc")
HEADER = "conv3x3.cuh"
_LO_HI = "          WgmmaTF32<COUT>::mma(acc.v[s], al, bh);\n"
_HI_LO = "            WgmmaTF32<COUT>::mma(acc.v[s], ah, bl);\n"
_W_LO = "          WgmmaTF32<N>::mma(acc.v, wl, xh);\n"
_X_LO = "        WgmmaTF32<N>::mma(acc.v, wh, xl);\n"
_WIDE = "constexpr bool wide_f32(int cout) { return 2 * cout >= 64; }"
_FUSE = "constexpr int F32_FUSE = 16;"
_RING = "constexpr int CK_F32 = 8, F32_BLOCKS = 2, F32_STAGES = 4;"
_SPLIT = ("    if (c + 1 < nchunks) {\n"
          "      cp_async_wait<S - 2>();  // this thread's copies of chunk c+1 have landed\n"
          "      split_chunk_f32<MT>(smem + (c + 1) % S * SB);\n"
          "      fence_proxy_async();\n"
          "    }\n")
EDITS = {
    "full": [],
    "narrow": [(_WIDE, "constexpr bool wide_f32(int cout) { return false; }")],
    "deep": [(_RING, "constexpr int CK_F32 = 16, F32_BLOCKS = 1, F32_STAGES = 4;")],
    "deep8": [(_RING, "constexpr int CK_F32 = 8, F32_BLOCKS = 1, F32_STAGES = 4;")],
    "s2": [(_RING, "constexpr int CK_F32 = 8, F32_BLOCKS = 2, F32_STAGES = 2;")],
    "s3": [(_RING, "constexpr int CK_F32 = 8, F32_BLOCKS = 2, F32_STAGES = 3;")],
    "unfused": [(_FUSE, "constexpr int F32_FUSE = 0;")],
    "one_mma": [(_LO_HI, ""), (_HI_LO, ""), (_W_LO, ""), (_X_LO, "")],
    "no_split": [("      split_chunk_f32<MT>(smem + (c + 1) % S * SB);\n", "")],
    "no_b": [("for_each_thread<WIDE || LEAN, 2 * ROWS>(", "for_each_thread<WIDE || LEAN, 0>(")],
    "late_split": [(_SPLIT + "    wgmma_wait0();\n", "    wgmma_wait0();\n" + _SPLIT)],
    "trunk_mt2": [("  return conv3x3::with_mt(a.W, [&](auto mt) {",
                   "  if constexpr (std::is_same<T, float>::value)\n"
                   "    return launch_trunk<NF, GC, 2>(a, stream);\n"
                   "  return conv3x3::with_mt(a.W, [&](auto mt) {", "rrdb_trunk.cu")],
}
CHECKED = ("full", "narrow", "deep", "deep8", "s2", "s3", "unfused", "late_split", "trunk_mt2")
# (batch, nf, gc, H, W)
SHAPES = [(16, 64, 32, 40, 40), (16, 64, 32, 80, 80), (1, 64, 32, 339, 510),
          (16, 64, 16, 80, 80), (16, 32, 16, 80, 80)]
TRUNK_HW, TRUNK_NB = (20, 40, 80), 5  # nf 64, gc 32
SOURCES = ("rrdb", "rrdb_trunk")


def build(names, out) -> dict:
    """Build every variant's libraries in parallel; returns {variant: {float32 instance:
    ptxas's spill stores in bytes}}, an instance as "trunk 64,32,2" (nf, gc, MT),
    "feature 32,2" or "residual 64,2" (COUT, MT)."""
    from hcflow_tpu_torch import _build

    procs = {}
    for name in names:
        d = os.path.join(out, name)
        os.makedirs(d)
        files = {f: open(os.path.join(CSRC, f)).read()
                 for f in (HEADER, *(f"{lib}.cu" for lib in SOURCES))}
        for old, new, *file in EDITS[name]:
            f = file[0] if file else HEADER
            if old not in files[f]:
                raise RuntimeError(f"probe {name}: edit not found in {f}: {old!r}")
            files[f] = files[f].replace(old, new)
        for f, text in files.items():
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        for lib in SOURCES:
            procs[name, lib] = subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", os.path.join(d, f"{lib}.so"),
                 os.path.join(d, f"{lib}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
    spills = {}
    for (name, lib), proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"probe {name} {lib} did not build:\n{log}")
        lines = log.splitlines()
        for i, line in enumerate(lines):
            m = re.search(
                r"Function properties for \S*(feature|residual|trunk)_kernelI((?:Li\d+E)+)fE", line)
            if m:
                args = ",".join(re.findall(r"Li(\d+)E", m.group(2)))
                stores = re.search(r"(\d+) bytes spill stores", lines[i + 1])
                spills.setdefault(name, {})[f"{m.group(1)} {args}"] = int(stores.group(1))
    return spills


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    names = args[0].split(",") if args else ["full", "narrow", "one_mma", "no_b", "no_split",
                                             "full"]
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch.ops import nets, rrdb

    if not torch.cuda.is_available():
        print("probe_conv_f32: no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line(), flush=True)
    out = tempfile.mkdtemp(prefix="probe_conv_f32_")
    t0 = time.perf_counter()
    spills = build(dict.fromkeys(names), out)
    print(f"built {len(set(names))} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, found in spills.items():
        print(f"{name} float32 spill stores (bytes):",
              "; ".join(f"{k}: {v}" for k, v in sorted(found.items())), flush=True)
    libs = {}
    for name in dict.fromkeys(names):
        lib = ctypes.CDLL(os.path.join(out, name, "rrdb.so"))
        lib.hcflow_rrdb_apply_f32.argtypes = rrdb._ARGTYPES
        tlib = ctypes.CDLL(os.path.join(out, name, "rrdb_trunk.so"))
        tlib.hcflow_rrdb_trunk_apply_f32.argtypes = rrdb._TRUNK_ARGTYPES
        libs[name] = lib, tlib
    gen = torch.Generator(device="cuda").manual_seed(0)
    B = cs.BATCH  # the trunks' batch
    stream = torch.cuda.current_stream().cuda_stream

    def per_rrdb(lib, name, packed, x, out_t, gc):
        b, H, W, nf = x.shape
        dense = [torch.empty(b, H, W, nf + 4 * gc, device="cuda") for _ in range(2)]
        w_ptrs = (ctypes.c_void_p * 15)(*(t.data_ptr() for t in packed["tf32"]))
        b_ptrs = (ctypes.c_void_p * 15)(*(b.data_ptr() for b in packed["b"]))
        err = lib.hcflow_rrdb_apply_f32(
            x.data_ptr(), out_t.data_ptr(), dense[0].data_ptr(), dense[1].data_ptr(),
            ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), b, H, W, nf, gc, stream)
        if err != 0:
            raise RuntimeError(f"probe {name}: CUDA error {err}")

    def check(name, got, ref):
        rel = (got - ref).abs().max().item() / ref.abs().max().item()
        if name in CHECKED and not rel <= cs.F32_RTOL:
            raise AssertionError(f"probe {name}: {rel:.3e} x max |plain| from the plain version")
        return rel

    print("ms per RRDB:", " ".join(names), flush=True)
    for b, nf, gc, h, w in SHAPES:
        trunk = cs.perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(11), 1, nf, gc), gen)
        packed = cs._to(rrdb.pack_rrdb(trunk[0]), "cuda")
        x = torch.randn(b, h, w, nf, device="cuda", generator=gen)
        ref = rrdb.rrdb_apply_plain(packed, x)
        out_t = torch.empty_like(x)
        times, errs = [], []
        for name in names:
            def run(lib=libs[name][0], name=name):
                per_rrdb(lib, name, packed, x, out_t, gc)
            run()
            torch.cuda.synchronize()
            errs.append(check(name, out_t, ref))
            times.append(cs.cuda_time(run, reps=10))
        print(f"nf {nf} gc {gc} {b}x{h}x{w}:", " ".join(f"{t:.4f}" for t in times), "| err",
              " ".join(f"{e:.1e}" for e in errs), flush=True)
    print(f"ms per trunk (nb {TRUNK_NB}, gc 32):", " ".join(names), flush=True)
    nf, gc = 64, 32
    trunk = cs.perturb(nets.init_rrdb_trunk(torch.Generator().manual_seed(14), TRUNK_NB, nf, gc),
                       gen)
    res = cs._to(rrdb.pack_rrdb_trunk(trunk, None, resident=True), "cuda")
    per = [cs._to(p, "cuda") for p in rrdb.pack_rrdb_trunk(trunk, None)]
    for hw in TRUNK_HW:
        x = torch.randn(B, hw, hw, nf, device="cuda", generator=gen)
        ref = rrdb.trunk_apply_resident_plain(res, x)
        out_t, carry = torch.empty_like(x), torch.empty_like(x)
        dense = [torch.empty(B, hw, hw, nf + 4 * gc, device="cuda") for _ in range(2)]
        w_ptrs = (ctypes.c_void_p * 5)(*(t.data_ptr() for t in res["tf32"]))
        b_ptrs = (ctypes.c_void_p * 5)(*(b.data_ptr() for b in res["b"]))
        times, errs, same = [], [], []
        for name in names:
            def run(tlib=libs[name][1], name=name):
                err = tlib.hcflow_rrdb_trunk_apply_f32(
                    x.data_ptr(), out_t.data_ptr(), carry.data_ptr(), dense[0].data_ptr(),
                    dense[1].data_ptr(), ctypes.addressof(w_ptrs), ctypes.addressof(b_ptrs), B,
                    hw, hw, nf, gc, TRUNK_NB, stream)
                if err != 0:
                    raise RuntimeError(f"probe {name}: CUDA error {err}")
            run()
            torch.cuda.synchronize()
            errs.append(check(name, out_t, ref))
            y, z = x.clone(), torch.empty_like(x)
            for p in per:  # the variant's per-RRDB kernel, nb times
                per_rrdb(libs[name][0], name, p, y, z, gc)
                y, z = z, y
            torch.cuda.synchronize()
            same.append(torch.equal(out_t, y))
            times.append(cs.cuda_time(run, reps=5))
        print(f"trunk {B}x{hw}x{hw}:", " ".join(f"{t:.4f}" for t in times), "| err",
              " ".join(f"{e:.1e}" for e in errs), "| equals per-RRDB", same, flush=True)
    shutil.rmtree(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
