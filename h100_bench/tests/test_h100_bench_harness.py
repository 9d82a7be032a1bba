"""CPU tests of the benchmark harness at tiny widths; card tests are marked ``cuda``.

    python -m pytest h100_bench/tests -q -p no:cacheprovider

A tiny configuration (every width cut to 8, K 4) runs every entry of the harness on
the CPU, where the program's kernels run their plain versions and there is no trace of
a device.
"""

from __future__ import annotations

import ast
import copy
import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "h100_bench"
sys.path.insert(0, str(REPO))

from h100_bench import harness, spec, trace, weights, work  # noqa: E402
from h100_bench.reference import tiles as ref_tiles  # noqa: E402
from h100_bench.reference.hcflow import HCFlowReference, Topology  # noqa: E402
from h100_bench.traffic import Traffic  # noqa: E402

SEED = 2**31 + 977  # past 32 signed bits, as the client's seeds are
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _tiny(config: dict) -> dict:
    cfg = copy.deepcopy(config)
    fd = cfg["network_G"]["flowDownsampler"]
    fd.update(K=4, hidden_channels=8)
    fd["splitOff"].update(after_flowstep=[2, 2], hidden_channels=8, RRDB_nf=8, RRDB_gc=8,
                          RRDB_nb=[1, 2] if "SR" in cfg["model"] else [2, 1])
    return cfg


TINY_TRAFFIC = {
    "photos": {"entry": "reverse", "lr_hw": [9, 14], "in_flight": 2, "heat": 0.9, "pool": 3,
               "sample": 2},
    "view": {"entry": "reverse", "lr_hw": [9, 14], "in_flight": 1, "heat": 1.0, "pool": 3,
             "sample": 3},
    "tiles": {"entry": "tiled_reverse", "lr_hw": [19, 30], "tile": 12, "overlap": 2,
              "tile_batch": 4, "in_flight": 1, "heat": 0.9, "pool": 2, "sample": 2},
    "ingest": {"entry": "forward", "hr_hw": [36, 56], "in_flight": 2, "pool": 3, "sample": 2},
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A copy of the benchmark's data in which every cell runs at tiny widths on the CPU:
    each shipped cell's file with its configuration and traffic mix shrunk."""
    r = tmp_path_factory.mktemp("bench")
    for d in ("cells", "configs", "traffic", "metrics"):
        shutil.copytree(BENCH / d, r / d)
    for p in (r / "configs").glob("*.json"):
        p.write_text(json.dumps(_tiny(json.loads(p.read_text()))))
    for name, t in TINY_TRAFFIC.items():
        (r / "traffic" / f"{name}.json").write_text(json.dumps(t))
    return r


def _run(root, name, traced=False, seconds=0.3, program="port", seed=SEED):
    return harness.run_cell(name, seed, seconds, traced, device="cpu", root=root,
                            program=program)


# ------------------------------------------------------------------ the contract
@pytest.mark.parametrize("name", spec.cell_names())
def test_every_cell_runs_correct_with_the_contracts_keys(root, name):
    res = _run(root, name)
    assert list(res) == KEYS  # checks last
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == set(json.loads((BENCH / "cells" / f"{name}.json").read_text())
                                      ["end_to_end"])
    assert all(set(m) == {"value", "unit"} and m["value"] > 0 for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert res["attempted"] >= 1 and res["failed"] == 0


def test_traced_run_adds_busy_window_and_breakdown(root):
    res = _run(root, "sr_x4_f32.tiles", traced=True)
    assert list(res) == KEYS[:5] + ["breakdown", "checks"]
    assert res["device"]["window_s"] > 0 and res["device"]["busy_s"] == 0  # no device here
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # the host-clock readers find their spans; the device readers find nothing on a CPU
    assert set(res["metrics"]) == {"entry.host_ms.tiled", "step_mfu.tiled", "tiled.host_ms",
                                   "device.idle_pct.tiled"}


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run([sys.executable, str(BENCH / "run.py"), "--workload",
                          "sr_x4_f32.photos", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=REPO, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_needs_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a run fails."""
    shutil.copytree(BENCH, tmp_path / "h100_bench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = subprocess.run([sys.executable, "h100_bench/run.py", "--workload", "sr_x4_f32.photos",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


# --------------------------------------------------------------- driven by data
def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_a_new_cell_configuration_and_metric_run_by_name_without_an_edit(root, tmp_path):
    r = tmp_path / "bench"
    shutil.copytree(root, r)
    before = _digest(r)
    cfg = json.loads((r / "configs" / "sr_x4_f32.json").read_text())
    cfg["network_G"]["flowDownsampler"]["K"] = 6
    (r / "configs" / "sr_x6steps.json").write_text(json.dumps(cfg))
    (r / "traffic" / "pairs.json").write_text(json.dumps(
        {"entry": "reverse", "lr_hw": [8, 10], "in_flight": 2, "heat": 0.5, "pool": 2,
         "sample": 1}))
    (r / "cells" / "sr_x6steps.pairs.json").write_text(json.dumps(
        {"config": "sr_x6steps", "traffic": "pairs", "chips": 1, "why": "a test",
         "end_to_end": ["hr_mps", "setup_s"], "limits": {"hr_max_abs": 1e-4, "hr_rms": 1e-5}}))
    (r / "metrics" / "wait.host_ms.py").write_text(
        'UNIT, BETTER, SOURCE = "ms", "lower", "host_clock"\nLAYER = "harness"\n'
        'MOVES = "hr_mps"\nWORKLOADS = ["sr_x6steps.pairs"]\n\n\ndef read(r):\n'
        '    return 1e3 * r.host_s("bench.wait") / r.requests\n')
    assert {k: v for k, v in _digest(r).items() if k in before} == before
    res = _run(r, "sr_x6steps.pairs")
    assert res["correct"] and set(res["metrics"]) == {"hr_mps", "setup_s"}
    traced = _run(r, "sr_x6steps.pairs", traced=True)
    assert traced["metrics"]["wait.host_ms"]["value"] > 0


def test_benchmark_json_agrees_with_the_files():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert bench["command"] == ["python3", "h100_bench/run.py"] and bench["paths"] == ["h100_bench"]
    cells = {c["name"]: c for c in bench["workloads"]}
    assert set(cells) <= set(spec.cell_names())
    for name, c in cells.items():
        f = json.loads((BENCH / "cells" / f"{name}.json").read_text())
        assert {k: f[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: c[k] for k in ("config", "traffic", "chips", "why")}
    for c in bench["configs"]:
        f = json.loads((REPO / c["file"]).read_text())
        assert c["file"] == f"h100_bench/configs/{c['name']}.json"
        assert (c["source"], c["reduced"]) == (f["source"], f["reduced"])
        import yaml
        published = yaml.safe_load((BENCH / "configs" / f["option_file"]).read_text())
        assert published["network_G"] == f["network_G"]
        assert all(published[k] == f[k] for k in ("model", "scale") if k in published)
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for name, c in cells.items():
        want = set(json.loads((BENCH / "cells" / f"{name}.json").read_text())["end_to_end"])
        have = {k for k, m in e2e.items() if name in m.get("workloads", cells)}
        assert want == have, name
    mods = {m.NAME: m for m in spec.metric_modules()}
    for m in bench["per_layer"]:
        mod = mods[m["name"]]
        assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"]) == \
            (mod.UNIT, mod.BETTER, mod.SOURCE, mod.LAYER, mod.MOVES)
        assert m["workloads"] == [w for w in mod.WORKLOADS if w in cells]
        assert all(m["moves"] in {k for k, e in e2e.items() if w in e.get("workloads", [w])}
                   for w in m["workloads"])


# ------------------------------------------------------------------- yardstick
def test_work_functions_match_hand_counts():
    # one RRDB at nf 64, gc 32: a dense block's five convs take 64, 96, 128, 160 and 192
    # inputs, the first four give 32 outputs and the fifth 64; three blocks
    block = 9 * (64 * 32 + 96 * 32 + 128 * 32 + 160 * 32 + 192 * 64)
    assert block == 239_616
    flops, nbytes = work.rrdb_work(1, 10, 10, 64, 32)
    assert flops == 2 * 3 * block * 100
    assert nbytes == 2 * 100 * 64 * 4 + 4 * 3 * block + 4 * 3 * (4 * 32 + 64)
    # one chain step at c 6, hid 64: conv1 3x3 3 -> 64, conv2 1x1 64 -> 64, conv3 3x3
    # 64 -> 6 (shift, scale for 3 channels), the 6x6 invconv
    _, f32, nbytes = work.chain_work(1, 10, 10, 6, 64, 1, cond=False)
    assert f32 == 2 * 100 * (9 * 3 * 64 + 64 * 64 + 9 * 64 * 6) + 2 * 100 * 36
    # one chain3s step (even: the 3 LR channels drive the other 9 of c 12), growth 32
    _, f32, _ = work.chain3s_work(1, 10, 10, 12, 32, 1)
    macs = 9 * (3 * 32 + 35 * 32 + 67 * 32 + 99 * 32 + 131 * 18)
    assert f32 == 2 * 100 * macs + 4 * 100 * 12
    # a trunk is nb RRDBs, its activations read and written once
    tf, tb = work.trunk_work(2, 5, 5, 64, 32, 7)
    rf, rb = work.rrdb_work(2, 5, 5, 64, 32)
    assert tf == 7 * rf and tb == 7 * rb - 6 * 2 * 50 * 64 * 4


def test_model_flops_of_the_x4_pass():
    """The whole x4 SR pass: about 7 TFLOP a HR megapixel, 87% of it in the trunks."""
    cfg = json.loads((BENCH / "configs" / "sr_x4_f32.json").read_text())
    top = Topology(cfg["network_G"], True)
    total = work.model_flops(top, 1, 1000, 1000)
    trunks = sum(work.trunk_work(1, 1000 >> (i + 1), 1000 >> (i + 1), 64, 32, 14)[0]
                 for i in range(2))
    assert 6.5e12 < total < 7.5e12 and 0.85 < trunks / total < 0.92


# -------------------------------------------------------------------- reference
def _port_and_ref(cfg, sr, seed=5):
    from hcflow_tpu_torch import convert

    model = harness.build_model(cfg)
    top = Topology(cfg["network_G"], sr)
    sd = weights.state_dict(top, seed, "cpu")
    params = model.flow.precompute_inference(
        convert.params_from_state_dict(sd, model, "cpu"), fused=True)
    return model, params, HCFlowReference(sd, cfg["network_G"], sr, "cpu"), top


@pytest.mark.parametrize("config", ["sr_x4_f32", "rescaling_x4_f32"])
def test_reference_agrees_with_the_port_on_the_cpu(config):
    cfg = _tiny(json.loads((BENCH / "configs" / f"{config}.json").read_text()))
    sr = config.startswith("sr")
    model, params, ref, top = _port_and_ref(cfg, sr)
    t = Traffic({"entry": "reverse", "lr_hw": [10, 12], "heat": 0.8}, top, 4, 3, "cpu")
    lr = torch.rand(2, 10, 12, 3, generator=torch.Generator().manual_seed(0))
    eps = t.eps(0, 0, 2)
    with torch.no_grad():
        hr = model.reverse(params, lr, 0.8, eps_list=eps)
    want = ref.reverse(lr.permute(0, 3, 1, 2), [e.permute(0, 3, 1, 2) for e in eps])
    assert (hr.permute(0, 3, 1, 2) - want).abs().max() < 1e-5
    assert ((want > 0) & (want < 1)).float().mean() > 0.1  # not all clamped away
    if not sr:
        with torch.no_grad():
            lr_p, zs = model.forward(params, hr)
        lr_r, zs_r = ref.forward(want)
        assert (lr_p.permute(0, 3, 1, 2) - lr_r).abs().max() < 1e-5
        for a, b in zip(zs, zs_r):
            assert (a.permute(0, 3, 1, 2) - b).abs().max() < 1e-4 * b.abs().max()


def test_reference_tile_plan_is_the_predictors():
    """The x4 photo of the cells: LR 339 x 510, padded to 340, tile 128, overlap 8: 3 x 5
    tiles, two batches of 8, the last with one zero tile; the canvas is the tiles'."""
    origins, ph, pw = ref_tiles.plan(340, 510, 128, 8)
    assert len(origins) == 15 and (ph, pw) == (2 * 112 + 128 - 340, 4 * 112 + 128 - 510)
    from hcflow_tpu_torch.cli.tiled import tiled_reverse

    rng = np.random.default_rng(0)
    lr = rng.random((19, 30, 3), dtype=np.float32)
    seen = []

    def up(batch):  # a deterministic "model": nearest x2 plus the tile's mean
        out = batch.repeat(2, 1).repeat(2, 2)
        return out + batch.mean(axis=(1, 2, 3))[:, None, None, None]

    def port_fn(params, b, heat, gen):
        seen.append(b.shape)
        return up(b)

    lr_even = np.pad(lr, ((0, 1), (0, 0), (0, 0)), mode="reflect")
    got = tiled_reverse(port_fn, None, lr_even, 2, 0.0, None, tile=12, overlap=2, batch=4)[:38]
    want = ref_tiles.tiled(lambda b, t: up(t), lr, 2, 12, 2, 4)
    assert np.array_equal(got, want) and all(s[0] == 4 for s in seen)


# ---------------------------------------------------------------- the controls
def test_the_bf16_control_comes_out_not_correct(root):
    """The program's own bf16 recipe in its place fails the float32 limits (the TF32
    control needs a card: ``test_tf32_control_on_the_card``)."""
    assert not _run(root, "sr_x4_f32.photos", program="port_bf16")["correct"]
    assert not _run(root, "rescaling_x4_f32.ingest", program="port_bf16")["correct"]


def _alter_one(t: torch.Tensor, by: float) -> torch.Tensor:
    t = t.clone()
    v = t.reshape(-1)  # the first value: a tiled image keeps its first tile's corner
    v[0] += by if v[0] < 0.5 else -by
    return t


@pytest.mark.parametrize("name", ["sr_x4_f32.photos", "rescaling_x4_f32.view",
                                  "sr_x4_f32.tiles"])
def test_an_answer_altered_where_produced_is_not_correct(root, name, monkeypatch):
    from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec

    cls = HCFlowSRSpec if name.startswith("sr") else HCFlowRescalingSpec
    orig = cls.reverse
    monkeypatch.setattr(cls, "reverse",
                        lambda self, *a, **k: _alter_one(orig(self, *a, **k), 2.0 / 255))
    assert not _run(root, name)["correct"]


@pytest.mark.parametrize("part", ["codes", "latents"])
def test_an_ingest_answer_altered_is_not_correct(root, part, monkeypatch):
    from hcflow_tpu_torch.models import HCFlowRescalingSpec

    orig = HCFlowRescalingSpec.forward

    def forward(self, *a, **k):
        lr, zs = orig(self, *a, **k)
        if part == "codes":  # a row of codes one step off
            return torch.cat([lr[:, :1] + 1.0 / 255, lr[:, 1:]], 1), zs
        return lr, [_alter_one(zs[0], 1e-2 * float(zs[0].abs().max()))] + zs[1:]

    monkeypatch.setattr(HCFlowRescalingSpec, "forward", forward)
    assert not _run(root, "rescaling_x4_f32.ingest")["correct"]


def test_half_of_a_tile_batch_left_out_is_not_correct(root, monkeypatch):
    from hcflow_tpu_torch.models import HCFlowSRSpec

    orig = HCFlowSRSpec.reverse

    def half(self, params, lr, *a, **k):
        B = lr.shape[0]
        out = orig(self, params, lr, *a, **k)
        return torch.cat([out[: B // 2], out[: B - B // 2]])  # the rest not served

    monkeypatch.setattr(HCFlowSRSpec, "reverse", half)
    assert not _run(root, "sr_x4_f32.tiles")["correct"]


# ----------------------------------------------------------------- pieces
def test_reservoir_is_a_seeded_uniform_sample():
    def draw(seed):
        res = harness.Reservoir(3, seed)
        for i in range(100):
            res.offer(i)
        return sorted(res.kept)

    assert draw(1) == draw(1) and draw(1) != draw(2) and len(draw(3)) == 3
    counts = np.zeros(20)
    for s in range(2000):
        for k in draw(s):
            counts[k // 5] += 1
    assert counts.min() > 0.7 * counts.mean()


def test_trace_reading_gives_kernels_to_the_wrapper_that_launched_them():
    def x(cat, name, ts, dur, corr=None):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": {} if corr is None else {"correlation": corr}}

    ev = [x("user_annotation", "bench.window", 0, 1000),
          x("user_annotation", "bench.entry", 10, 100),
          x("user_annotation", "bench.rrdb", 20, 30),
          x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
          x("cuda_runtime", "cudaLaunchKernel", 60, 1, corr=2),
          x("cuda_runtime", "cudaMemcpyAsync", 150, 1, corr=3),
          x("user_annotation", "bench.wait", 140, 800),
          x("kernel", "conv_tile_f32", 100, 300, corr=1),
          x("kernel", "conv_tile_f32", 350, 100, corr=1),  # overlaps: counted once
          x("kernel", "cudnn_conv", 460, 40, corr=2),
          x("gpu_memcpy", "Memcpy DtoH", 600, 50, corr=3)]
    calls = trace.Calls(Topology(json.loads((BENCH / "configs" / "sr_x4_f32.json")
                                            .read_text())["network_G"], True))
    calls.work["rrdb"] = [4.95e9, 0.0, 1e-5, 1]  # 10 us at the peak
    r = trace.Reading(ev, calls, requests=2)
    assert r.window_s == 1e-3 and r.busy_s == pytest.approx(440e-6)
    assert r.device_s == pytest.approx({"rrdb": 350e-6, "library": 40e-6,
                                        "outside the entry": 50e-6})
    assert r.roofline_pct("rrdb") == pytest.approx(100 * 10 / 350)
    assert r.roofline_pct("chain") is None
    gaps = dict(r.idle_gaps)  # 0-100 in no span; 450-460, 500-600 and 650-1000 waiting
    assert gaps == pytest.approx({"no span": 100e-6, "bench.wait": 460e-6})
    assert sum(gaps.values()) == pytest.approx(1e-3 - 440e-6)


# ------------------------------------------------------------------ imports
FORBIDDEN = {"jax", "jaxlib", "flax", "hcflow_tpu"}


def _imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imported_tops(path) & FORBIDDEN, path
    for path in (BENCH / "reference").glob("*.py"):
        assert "hcflow_tpu_torch" not in _imported_tops(path), path


def test_a_run_loads_no_jax_and_the_reference_nothing_of_the_program(root):
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "from h100_bench import harness\n"
            f"harness.run_cell('sr_x4_f32.photos', 3, 0.2, True, device='cpu', "
            f"root={str(root)!r})\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert "hcflow_tpu_torch" in tops and not tops & FORBIDDEN
    code = (f"import sys; sys.path.insert(0, {str(REPO)!r})\n"
            "import h100_bench.reference.hcflow, h100_bench.reference.tiles\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    tops = set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"hcflow_tpu_torch"})


# --------------------------------------------------------------------- card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the port's kernels have no CPU build")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["sr_x4_f32.photos", "rescaling_x4_f32.ingest"])
def test_tf32_control_on_the_card(card, name):
    """At the cell's own size on the card, a short window: the program is correct, the
    reference with TF32 on in its place is not."""
    assert harness.run_cell(name, SEED, 1.0, False)["correct"]
    assert not harness.run_cell(name, SEED, 1.0, False, program="reference_tf32")["correct"]
