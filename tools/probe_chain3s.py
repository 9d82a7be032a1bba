"""Time the rescaling main-chain kernel (csrc/chain3s.cu): checkouts side by side, and the
design choices of its fused step.

    python3 tools/probe_chain3s.py roots ROOT [ROOT ...]
    python3 tools/probe_chain3s.py variants [--f32] [VARIANT,VARIANT,...]

Run from the root of a checkout on a machine with a CUDA card and nvcc.

``roots``: for each ROOT (``.`` for this checkout; another commit unpacked with ``git
archive`` into a git-ignored directory), in the order given (list a pair as A B B A to
cancel drift), a fresh process builds that checkout's chain3s kernel and runs its
``chain3s.inverse_chain`` at phase 2's shapes of ``chip_smoke.py`` (K 8, growth 32,
batch 16: L1 c 24 at 40x40, L0 c 12 at 80x80), in both recipes, checked against the
plain version (bf16 within 1e-3 x max |plain|, float32 1e-5 x).  Each row prints the
host-issued time (CUDA events around 20 calls, as ``chip_smoke.cuda_time``), the device
time of one call captured as a CUDA graph (``chip_smoke.graph_time``: launch gaps on the
device included, the host's issue not) and the sum of the kernels' device time under
``torch.profiler`` (gaps excluded), each in ms a call, the launches a call, and a hash
of the output (equal hashes across roots: bit-identical results on the same inputs).

``variants``: variants of this checkout's ``csrc/chain3s.cu``, each one textual edit
(``EDITS``: the bf16 fused step kernel; ``--f32``: the float32 recipe's persistent
launch, ``EDITS_F32``), built with nvcc into a temporary directory (trimmed to growth 32
and conv5 16, 32 or 48 wide: ``TRIM``) and called through the same C entry point on the
same pack and inputs at the same two shapes, and tile plans (``tileTHxTW``: the full
bf16 kernel with both step parities on that tile, in place of ``chain3s.plan``'s
choice); prints each variant's ptxas wgmma notes and spills, then the device ms of one
chain (a CUDA graph of one call) per variant and shape, the full kernel first and last
to show drift.  The variants that change the arithmetic or skip work give wrong results
on purpose and are not checked; ``no_pdl`` and ``grid_sync`` must match ``full`` bit for
bit, and are checked.  An edit whose text is no longer in the source raises: update
``EDITS`` with the kernel.  The float32 recipe's launch a conv, the design before the
persistent launch, is the parent commit's: time it with ``roots``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.getcwd()
SRC = os.path.join(ROOT, "hcflow_tpu_torch", "csrc", "chain3s.cu")
SHAPES = (("L1 main", 24, 40), ("L0 main", 12, 80))
B, K, GC = 16, 8, 32
TOL = {"bfloat16": 1e-3, None: 1e-5}


def _setup(torch, cs, cd, c, hw, gen):
    from hcflow_tpu_torch.flow.flowstep import FlowStepSpec
    from hcflow_tpu_torch.ops import chain3s

    specs = [FlowStepSpec(in_channels=c, hidden_channels=GC, compute_dtype=cd,
                          flow_permutation="none", flow_coupling="Affine3shift",
                          nn_module="DenseBlock", lr_vs_others=(k % 2 == 0)) for k in range(K)]
    g = torch.Generator().manual_seed(13)
    steps = cs._to(cs.perturb([s.init(g) for s in specs], gen), "cuda")
    pk = chain3s.pack_inverse_chain3s(steps, cd)
    z = torch.randn(B, hw, hw, c, device="cuda", generator=gen)
    return pk, z


def _device_ms(torch, fn, calls=10):
    """The kernels' device time a call under torch.profiler (gaps excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(ev.self_device_time_total for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA) / calls / 1e3


def run_root(root: str) -> None:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch import _build
    from hcflow_tpu_torch.ops import chain3s

    _build.build(["chain3s"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for cd in ("bfloat16", None):
        for name, c, hw in SHAPES:
            pk, z = _setup(torch, cs, cd, c, hw, gen)
            got = chain3s.inverse_chain(pk, z)[0]
            ref = chain3s.inverse_chain3s_plain(pk, z)[0]
            torch.cuda.synchronize()
            err = (got - ref).abs().max().item() / ref.abs().max().item()
            if not (torch.isfinite(got).all() and err <= TOL[cd]):
                raise AssertionError(f"{root} {name}: {err:.3e} x max |plain|")
            chain3s.launches_by.clear()
            chain3s.inverse_chain(pk, z)
            launches = sum(chain3s.launches_by.values())
            run = lambda: chain3s.inverse_chain(pk, z)  # noqa: E731
            host = cs.cuda_time(run, reps=20)
            graph = cs.graph_time(run, reps=20)
            dev = _device_ms(torch, run)
            digest = hashlib.sha1(got.cpu().numpy().tobytes()).hexdigest()[:12]
            print(f"{root} {cd or 'float32'} {name} {B}x{hw}x{hw}x{c}: host-issued {host:.4f} "
                  f"graph {graph:.4f} kernels {dev:.4f} ms, {launches} launches, err "
                  f"{err:.2e} x max |plain|, output sha1 {digest}", flush=True)


# -------------------------------------------------------------------------- variants
# Every variant keeps only the instances the probe's shapes run (growth 32; conv5 16, 32
# and 48 wide): a build of a few seconds, not the full source's minute.
TRIM = [("    case 64: return fn(Int<64>());\n", ""),
        ("    case 16: return with_n5(n5, [&](auto n) { return fn(Int<16>(), n); });\n", ""),
        ("    case 64: return with_n5(n5, [&](auto n) { return fn(Int<64>(), n); });\n", ""),
        ("      case 16: return launch_f32<16, MT>(a, stream);\n", ""),
        ("      case 64: return launch_f32<64, MT>(a, stream);\n", "")]
_HELPERS_AT = "using conv3x3::smem_addr;\n"
_HELPERS = """
template <int N>
__device__ __forceinline__ void probe_no_wgmma(float (&d)[N / 2], uint64_t a, uint64_t b) {
  asm volatile("" : "+f"(d[0]) : "l"(a), "l"(b));
}
"""
_STORE = "        *reinterpret_cast<uint32_t*>(base + (p * npx + r) * 16 + 4 * q) = "
_NO_SYNC = [("    if (stages == 3)\n      conv3x3::cp_async_wait<1>();\n    else\n"
             "      conv3x3::cp_async_wait<0>();\n    conv3x3::fence_proxy_async();  // this "
             "thread's copies and stores, before wgmma reads\n    __syncthreads();\n", "")]
_NO_EPI = [("dense_conv<GC, MG_G>(g, s0, i, s, ring, feature);",
            "dense_conv<GC, MG_G>(g, s0, i, s, ring, [](int, int, const auto&) {});"),
           ("dense_conv<N5, MG_5, true>(g, s0, 4, s, ring, stage);",
            "dense_conv<N5, MG_5, true>(g, s0, 4, s, ring, [](int, int, const auto&) {});")]
EDITS = {
    "full": [],
    # the steps launched in stream order, without programmatic serialization (checked)
    "no_pdl": [("programmaticStreamSerializationAllowed = 1",
                "programmaticStreamSerializationAllowed = 0")],
    # each block returns once it may read z: launch, scheduling and the first weights
    "empty": [("  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n",
               "  asm volatile(\"griddepcontrol.wait;\\n\" ::: \"memory\");\n"
               "  if (a.H > 0) return;\n")],
    # the products dropped (descriptors, fences and waits kept)
    "no_mma": [(_HELPERS_AT, _HELPERS_AT + _HELPERS),
               ("conv3x3::Wgmma<N>::mma(", "probe_no_wgmma<N>(")],
    # no wait for the products at the end of each chunk
    "no_wait": [("      conv3x3::wgmma_wait0();\n", "")],
    # no wait for the ring's copies and no barrier a chunk
    "no_sync": _NO_SYNC,
    # the weights' copies dropped (the ring keeps what it holds)
    "no_copy": [("      if (i < 4)\n        load_chunk<GC>(st, w, cin, k);\n      else\n"
                 "        load_chunk<N5>(st, w, cin, k);\n", "")],
    # no epilogue: the features and z are not written
    "no_epi": _NO_EPI,
    "no_feature_epi": _NO_EPI[:1],
    "no_coupling_epi": _NO_EPI[1:],
    # the features' stores all to pixel 0 of their array (the same instructions)
    "epi_one_pixel": [(_STORE + "pack_bf16(v0, v1);",
                       _STORE.replace("+ r)", "+ 0 * r)") + "pack_bf16(v0, v1);")],
    # the features stored as zeros (no arithmetic)
    "epi_zeros": [(_STORE + "pack_bf16(v0, v1);", _STORE + "0u;")],
    # a barrier before each feature epilogue
    "epi_sync": [("dense_conv<GC, MG_G>(g, s0, i, s, ring, feature);",
                  "dense_conv<GC, MG_G, true>(g, s0, i, s, ring, feature);")],
    # no proxy fence a chunk (wgmma may read stale features: timing only)
    "no_fence": [("    conv3x3::fence_proxy_async();  // this thread's copies and stores, before "
                  "wgmma reads\n", "")],
    # every pass MG M tiles a warpgroup, the missing ones repeating the region's last
    # (one instance of the pass a conv: less code, more products)
    "fixed_cnt": [("    const int mt = mt0 + NWG * m;\n",
                   "    const int mt = min(mt0 + NWG * m, nbx * ((rh + 7) / 8) - 1);\n"),
                  ("    switch (cnt) {\n",
                   "    (void)cnt;\n    run(std::integral_constant<int, MG>());\n"
                   "    if (false) switch (cnt) {\n")],
    # up to 4 M tiles a warpgroup (gc 32: 64 accumulator floats a thread)
    "mg4": [("constexpr int MAX_MG = 3;", "constexpr int MAX_MG = 4;"),
            ("      default: if constexpr (MG >= 3) run(std::integral_constant<int, 3>()); break;",
             "      case 3: if constexpr (MG >= 3) run(std::integral_constant<int, 3>()); break;\n"
             "      default: if constexpr (MG >= 4) "
             "run(std::integral_constant<int, 4>()); break;")],
    # 4 warpgroups a block (registers capped at 128 a thread); fewer would not run the
    # plans, whose conv5 takes one pass of 3 warpgroups
    "threads512": [("constexpr int NTHREADS = 384;", "constexpr int NTHREADS = 512;")],
    # the net input not staged
    "no_stage": [("    for (int e = tid; e < npx * U; e += NTHREADS) {",
                  "    for (int e = tid; e < 0; e += NTHREADS) {")],
}
# the float32 recipe: one persistent launch a chain, items waiting on their neighbours
EDITS_F32 = {
    "full": [],
    # a grid-wide barrier between stages instead of each item's wait on its neighbours
    # (the persistent form of the resident trunk; checked)
    "grid_sync": [("""#pragma unroll 1
  for (int e = blockIdx.x; e < a.items; e += gridDim.x) {
    const int s = e / a.tiles, t = e - s * a.tiles;
    item(s, t, true);  // its first weights' copies, before it waits for its input
    wait_tiles(a.done, s, t, a.tx, a.ty);
    item(s, t, false);
    mark_done(a.done, s, t);
  }
""", """#pragma unroll 1
  for (int s = 0; s < 5 * a.K; ++s) {
    if (s > 0) cg::this_grid().sync();
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
      __syncthreads();  // the ring is free
      item(s, t, true);
      item(s, t, false);
    }
  }
""")],
    # each item's wait dropped (wrong results: the launch's floor without waits)
    "no_wait": [("    wait_tiles(a.done, s, t, a.tx, a.ty);\n", "")],
    # no weights copied before the wait (checked)
    "no_prefetch": [("    item(s, t, true);  // its first weights' copies", "    // (no prefetch)"),
                    (", MT, true>(", ", MT, false>(", 2)],
    # a full fence before each release of a count (checked)
    "fence": [("  if (threadIdx.x == 0)\n    asm volatile(\"st.release",
               "  if (threadIdx.x == 0) __threadfence();\n  if (threadIdx.x == 0)\n"
               "    asm volatile(\"st.release")],
    # the waits spin without sleeping (checked)
    "no_sleep": [("        __nanosleep(32);\n", "")],
}


def _lib_of(name: str) -> str:
    """A variant's library: a tile plan (``tileTHxTW``) runs the full kernel."""
    return "full" if name.startswith("tile") else name


def _tile_of(name: str):
    return tuple(int(t) for t in name[4:].split("x")) if name.startswith("tile") else None


def _with_tile(chain3s, tile, pk, z, out, scratch):
    """The C entry point's arguments, with both step parities on the th x tw tile given
    (and the deepest ring that fits) instead of plan()'s choice."""
    if tile is None:
        return chain3s._args(pk, z, out, GC, scratch)
    B_, H, W, c = z.shape
    p = chain3s.plan(B_, H, W, c, GC)
    forced = {}
    for t, (cinp, n5) in zip(("even", "odd"), chain3s.step_widths(c)):
        stages = next(st for st in (3, 2) if chain3s.smem_bytes(*tile, cinp, GC, n5, st)
                      <= chain3s.BLOCK_SMEM)
        forced[t] = dict(p[t], th=tile[0], tw=tile[1], stages=stages,
                         smem=chain3s.smem_bytes(*tile, cinp, GC, n5, stages))
    saved = chain3s.plan
    chain3s.plan = lambda *args, **kw: {**p, **forced}
    try:
        return chain3s._args(pk, z, out, GC, scratch)
    finally:
        chain3s.plan = saved


def build_variants(names, out, edits):
    from hcflow_tpu_torch import _build

    text = open(SRC).read()
    flags = [*_build.NVCC_FLAGS, f"-I{os.path.dirname(SRC)}"]
    procs = {}
    for name in names:
        src = text
        for old, new, *count in [*TRIM, *edits[name]]:
            if old not in src:
                raise RuntimeError(f"probe {name}: edit not found in chain3s.cu: {old!r}")
            src = src.replace(old, new, *(count or [1]))
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen([_build._nvcc(), *flags, "-o", path[:-3] + ".so", path],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"probe {name} did not build:\n{log}")
        notes = [ln.strip() for ln in log.splitlines() if "C75" in ln or "erformance" in ln]
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill s" not in ln]
        print(f"  {name}: {len(notes)} ptxas wgmma notes, {len(spills)} kernels spilling",
              flush=True)
        for line in sorted(set(notes))[:6] + spills[:4]:
            print(f"    {line[:300]}", flush=True)


def run_variants(args) -> int:
    f32 = bool(args) and args[0] == "--f32"
    args = args[1:] if f32 else args
    edits = EDITS_F32 if f32 else EDITS
    names = args[0].split(",") if args else [*edits, "full"]
    cd = None if f32 else "bfloat16"
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from hcflow_tpu_torch.ops import chain3s

    print(cs.card_line(), flush=True)
    out = tempfile.mkdtemp(prefix="probe_chain3s_")
    t0 = time.perf_counter()
    build_variants(dict.fromkeys(_lib_of(n) for n in names), out, edits)
    print(f"built {len(set(names))} variants in {time.perf_counter() - t0:.1f} s", flush=True)
    fn = chain3s._FN[torch.float32 if f32 else torch.bfloat16]
    libs = {}
    for name in dict.fromkeys(names):
        lib = ctypes.CDLL(os.path.join(out, f"{_lib_of(name)}.so"))
        getattr(lib, fn).argtypes = chain3s._ARGTYPES_F32 if f32 else chain3s._ARGTYPES
        libs[name] = lib
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(f"device ms per {K}-step chain ({cd or 'float32'}):", " ".join(names), flush=True)
    for label, c, hw in SHAPES:
        pk, z = _setup(torch, cs, cd, c, hw, gen)
        times, results = [], {}
        for name in names:
            out_t = torch.empty_like(z)

            def run(lib=libs[name], o=out_t, tile=_tile_of(name)):
                scratch = []
                err = getattr(lib, fn)(*_with_tile(chain3s, tile, pk, z, o, scratch))
                if err != 0:
                    raise RuntimeError(f"probe {name}: CUDA error {err}")

            run()
            torch.cuda.synchronize()
            results.setdefault(name, out_t.clone())
            times.append(cs.graph_time(run, reps=20))
        for name in ("no_pdl", "grid_sync", "no_prefetch", "fence", "no_sleep"):
            if name in results and "full" in results and not torch.equal(results[name],
                                                                          results["full"]):
                raise AssertionError(f"{name} differs from full")
        print(f"{label} {B}x{hw}x{hw}x{c}:", " ".join(f"{t:.4f}" for t in times), flush=True)
    return 0


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if not args or args[0] not in ("roots", "variants"):
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("probe_chain3s: no CUDA device", file=sys.stderr)
        return 1
    if args[0] == "variants":
        return run_variants(args[1:])
    sys.path.insert(0, ROOT)
    import chip_smoke as cs

    print(cs.card_line(), flush=True)
    for root in args[1:]:
        if subprocess.run([sys.executable, __file__, "_one", root]).returncode != 0:
            return 1
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["_one"]:
        run_root(os.path.abspath(sys.argv[2]))
        sys.exit(0)
    sys.exit(main())
