"""The bf16 serving recipe of the published x4 DF2K model (``compute_dtype: bfloat16``)
as the benchmark serves it: configuration ``sr_x4_bf16``, cell ``sr_x4_bf16.photos``.

On the CPU, at the tiny widths the benchmark's own tests use (every width 8, K 4), the
port packs the recipe as the card serves it (``precompute_inference(fused=True)``; here
the kernels' plain versions run behind the same wrappers):

- against the plain float32 reference (``h100_bench/reference/hcflow.py``) the bf16
  recipe's HR lies within 1e-2 at most and 1e-3 in rms: every conv of the encoder and
  the coupling nets rounds its operands to bf16 (2^-9 relative), about 30 convs deep
  here, and the flow's inverse carries that into the HR (measured 9.9e-4 and 1.2e-4 on
  the first weights).  It also lies farther than the float32 cells' 1e-5 (float32
  measured 1.5e-6), so that a silent fall back to float32 fails;
- the trunk and chain packs are bf16, with no TF32 planes;
- the cell runs correct through the harness, and an HR altered where it is produced, past
  a limit of the cell, does not;
- ``rrdb_bf16_roofline`` reads nothing where it cannot be exact; ``cast.device_ms``
  reads the device time launched inside ``hcflow.cast``, and the conv between the casts
  stays with its layer's reader; the cell's copies of the float32 cells' readers read
  as their originals, and ``chain.device_ms.bf16`` the chain kernel's device time;
- a bf16 ``nets.conv2d`` opens two ``hcflow.cast`` spans, one around the operands'
  casts and one around the output's upcast, with the conv outside both, and a float32
  call opens none;
- the controls of ``tools/probe_bf16_control.py`` change what is served and are undone,
  and the probe runs ``h100_bench/control.py`` once a control with it in force.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BENCH = REPO / "h100_bench"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(BENCH / "tests"))
sys.path.insert(0, str(REPO / "tools"))

import probe_bf16_control as probe  # noqa: E402
from h100_bench import harness, program_trace, spec, trace, weights  # noqa: E402
from h100_bench.reference.hcflow import HCFlowReference, Topology  # noqa: E402
from h100_bench.traffic import Traffic  # noqa: E402
from hcflow_tpu_torch.ops import nets  # noqa: E402
from test_h100_bench_harness import SEED, TINY_TRAFFIC, _alter_one, _tiny  # noqa: E402

CELL, CONFIG = "sr_x4_bf16.photos", "sr_x4_bf16"
NEW = ["rrdb_bf16_roofline", "step_mfu_bf16", "cast.device_ms", "library.device_ms.bf16",
       "device.idle_pct.bf16", "chain.device_ms.bf16", "encoder.device_ms.bf16",
       "cond.device_ms.bf16", "entry.host_ms.bf16", "entry.idle_ms.bf16"]
# the readers copied from the float32 cells', each with the reader it copies
COPIES = {"library.device_ms.bf16": "library.device_ms",
          "device.idle_pct.bf16": "device.idle_pct",
          "encoder.device_ms.bf16": "encoder.device_ms", "cond.device_ms.bf16": "cond.device_ms",
          "entry.host_ms.bf16": "entry.host_ms", "entry.idle_ms.bf16": "entry.idle_ms"}


def _config(name=CONFIG) -> dict:
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The new cell's files with its configuration and traffic at tiny widths."""
    r = tmp_path_factory.mktemp("bench")
    for d in ("cells", "metrics"):
        shutil.copytree(BENCH / d, r / d)
    (r / "configs").mkdir()
    (r / "configs" / f"{CONFIG}.json").write_text(json.dumps(_tiny(_config())))
    (r / "traffic").mkdir()
    (r / "traffic" / "photos.json").write_text(json.dumps(TINY_TRAFFIC["photos"]))
    return r


@pytest.fixture(scope="module")
def served():
    """The tiny bf16 model packed for serving, its reference and a batch of two."""
    from hcflow_tpu_torch import convert

    cfg = _tiny(_config())
    top = Topology(cfg["network_G"], True)
    model = harness.build_model(cfg)
    sd = weights.state_dict(top, 5, "cpu")
    params = model.flow.precompute_inference(
        convert.params_from_state_dict(sd, model, "cpu"), fused=True)
    lr = torch.rand(2, 10, 12, 3, generator=torch.Generator().manual_seed(0))
    eps = Traffic({"entry": "reverse", "lr_hw": [10, 12], "heat": 0.9}, top, 4, 3,
                  "cpu").eps(0, 0, 2)
    ref = HCFlowReference(sd, cfg["network_G"], True, "cpu")
    want = ref.reverse(lr.permute(0, 3, 1, 2), [e.permute(0, 3, 1, 2) for e in eps])
    return model, params, lr, eps, want.permute(0, 2, 3, 1)


def _serve(served):
    model, params, lr, eps, _ = served
    with torch.no_grad():
        return model.reverse(params, lr, 0.9, eps_list=eps)


# ------------------------------------------------------------------ the recipe
def test_the_configuration_is_the_published_model_in_bf16():
    """sr_x4_f32 with one key added, network_G's compute_dtype, and nothing cut: reduced
    names the group that holds the added key."""
    import yaml

    bf16, f32 = _config(), _config("sr_x4_f32")
    published = yaml.safe_load((BENCH / "configs" / bf16["option_file"]).read_text())
    net = dict(bf16["network_G"])
    assert net.pop("compute_dtype") == "bfloat16"
    assert net == published["network_G"] == f32["network_G"]
    assert bf16["reduced"] == ["network_G"] and bf16["source"] == f32["source"]
    assert bf16["assumed"]["changed_from_source"] == {"network_G.compute_dtype": "bfloat16"}
    own = ("network_G", "precision", "assumed", "reduced")
    assert {k: v for k, v in bf16.items() if k not in own} \
        == {k: v for k, v in f32.items() if k not in own}
    spec_ = harness.build_model(bf16).flow
    assert spec_.compute_dtype == "bfloat16" and spec_.hidden_channels == 64


def test_the_bf16_recipe_agrees_with_the_reference_within_bf16(served):
    hr, want = _serve(served), served[4]
    d = (hr - want).abs()
    assert d.max() < 1e-2 and d.pow(2).mean().sqrt() < 1e-3
    assert d.max() > 1e-5  # not the float32 recipe's agreement
    assert ((want > 0) & (want < 1)).float().mean() > 0.1  # not all clamped away


def test_the_trunk_and_chain_packs_are_bf16(served):
    params = served[1]
    for lv in ("level0", "level1"):
        cond = params[lv]["cond"]
        for trunk in ("trunk0_fused", "trunk1_fused"):
            for p in cond[trunk]:
                assert {w.dtype for w in p["w"]} == {torch.bfloat16} and "tf32" not in p
                assert {b.dtype for b in p["b"]} == {torch.float32}
        for chain in (params[lv]["main_fused"], cond["steps_fused"]):
            assert {chain[n].dtype for n in ("w1", "w2", "w3")} == {torch.bfloat16}


# ------------------------------------------------------------------ the cell
def test_the_cell_runs_correct_through_the_harness(root):
    res = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", root=root)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"hr_mps", "setup_s"} and res["attempted"] >= 1
    assert all(0 < c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("past", ["hr_max_abs", "hr_rms"])
def test_an_hr_altered_past_a_limit_is_not_correct(root, past, monkeypatch):
    """One value moved by 1.5 times the cell's hr_max_abs, or every value by 1.5 times its
    hr_rms, where the HR is produced."""
    from hcflow_tpu_torch.models import HCFlowSRSpec

    limit = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())["limits"][past]
    orig = HCFlowSRSpec.reverse

    def reverse(self, *a, **k):
        out = orig(self, *a, **k)
        if past == "hr_max_abs":
            return _alter_one(out, 1.5 * limit)
        return out + 1.5 * limit

    monkeypatch.setattr(HCFlowSRSpec, "reverse", reverse)
    res = harness.run_cell(CELL, SEED, 0.3, False, device="cpu", root=root)
    assert not res["correct"] and res["checks"][past]["value"] > limit


def _named(entries, name):
    return next(e for e in entries if e["name"] == name)


def test_the_cells_entries_in_benchmark_json():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    cell = json.loads((BENCH / "cells" / f"{CELL}.json").read_text())
    config = _named(bench["configs"], CONFIG)
    assert config["reduced"] == ["network_G"] and config["file"] == f"h100_bench/configs/{CONFIG}.json"
    # the same source as sr_x4_f32, so the changed group tells the two configurations apart
    f32 = _named(bench["configs"], "sr_x4_f32")
    assert (config["source"], config["reduced"]) != (f32["source"], f32["reduced"])
    assert _named(bench["workloads"], CELL) == {"name": CELL, **{k: cell[k] for k in
                                                ("config", "traffic", "chips", "why")}}
    assert cell["chips"] == 1 and cell["end_to_end"] == ["hr_mps", "setup_s"]
    assert CELL in _named(bench["end_to_end"], "hr_mps")["workloads"]
    # the new cell reads only its own readers; no earlier reader lists it
    assert [m.NAME for m in spec.load_cell(CELL).metrics] == sorted(NEW)
    for m in bench["per_layer"]:
        reader = _reader(m["name"])
        if m["name"] in NEW:
            assert m["workloads"] == reader.WORKLOADS == [CELL] and m["moves"] == "hr_mps"
            assert (m["unit"], m["better"], m["source"], m["layer"]) == \
                (reader.UNIT, reader.BETTER, reader.SOURCE, reader.LAYER)
        else:
            assert CELL not in m.get("workloads", [])
    assert {m["name"] for m in bench["per_layer"]} >= set(NEW)


# ------------------------------------------------------------------ readers
def _x(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _reading(rrdb_work=None, events=()):
    calls = trace.Calls(Topology(_config()["network_G"], True))
    if rrdb_work is not None:
        calls.work["rrdb"] = list(rrdb_work)
    ev = [_x("user_annotation", "bench.window", 0, 1000),
          _x("user_annotation", "bench.entry", 10, 900),
          _x("user_annotation", "bench.rrdb", 20, 30),
          _x("cuda_runtime", "cudaLaunchKernel", 25, 1, corr=1),
          _x("kernel", "to_dense_kernel", 100, 200, corr=1), *events]
    return trace.Reading(ev, calls, requests=2)


def _reader(name):
    return next(m for m in spec.metric_modules() if m.NAME == name)


def test_the_bf16_rrdb_roofline_reads_only_where_it_is_exact():
    read = _reader("rrdb_bf16_roofline").read
    peak = 989e12
    assert read(_reading()) is None  # no call in the window
    # 200 us of device time; 19.78 GFLOP is 20 us at the bf16 peak
    ops_bound = _reading([19.78e9, 1e6, 0.0, 1])
    assert read(ops_bound) == pytest.approx(100 * 19.78e9 / peak / 200e-6) == pytest.approx(10)
    bytes_bound = _reading([19.78e9, 3.35e12 * 21e-6, 0.0, 1])  # 21 us of bytes
    assert read(bytes_bound) is None
    assert _reader("rrdb_f32_roofline").read(bytes_bound) is not None


def _conv_events(layer="hcflow.encoder"):
    """One bf16 library conv in ``layer``: its operand casts, the conv, its output's upcast;
    and the host time the conv's launch leaves the card idle (556 to 576 us)."""
    launch, a = "cuda_runtime", "user_annotation"
    return [_x(a, "hcflow.reverse", 400, 300),
            _x(a, layer, 405, 200),
            _x(a, "hcflow.cast", 410, 20),
            _x(a, "hcflow.cast", 470, 20),
            _x(launch, "cudaLaunchKernel", 420, 1, corr=11),  # the operand casts
            _x(launch, "cudaLaunchKernel", 450, 1, corr=12),  # the conv
            _x(launch, "cudaLaunchKernel", 480, 1, corr=13),  # the output's upcast
            _x("kernel", "elementwise_kernel", 500, 6, corr=11),
            _x("kernel", "sm90_xmma_fprop_bf16", 506, 50, corr=12),
            _x("kernel", "elementwise_kernel", 576, 10, corr=13)]


@pytest.mark.parametrize("layer", ["hcflow.encoder", "hcflow.cond"])
def test_cast_device_ms_reads_the_casts_and_the_layer_keeps_the_conv(layer):
    events = _conv_events(layer)
    r = _reading(events=events)
    assert _reader("cast.device_ms").read(r) == pytest.approx(1e3 * 16e-6 / 2)
    name = {"hcflow.encoder": "encoder.device_ms.bf16", "hcflow.cond": "cond.device_ms.bf16"}
    assert _reader(name[layer]).read(r) == pytest.approx(1e3 * 50e-6 / 2)
    other = (set(name.values()) - {name[layer]}).pop()
    assert _reader(other).read(r) is None
    assert _reader("library.device_ms.bf16").read(r) == pytest.approx(1e3 * 66e-6 / 2)
    # the parent program opens no hcflow.cast: the reader finds nothing
    bare = _reading(events=[e for e in events if not e["name"].startswith("hcflow.")])
    assert _reader("cast.device_ms").read(bare) is None
    assert isinstance(r, program_trace.Reading)


@pytest.mark.parametrize("copy", sorted(COPIES))
def test_a_copied_reader_reads_as_its_float32_original(copy):
    orig = _reader(COPIES[copy])
    layer = "hcflow.cond" if copy.startswith("cond.") else "hcflow.encoder"
    cases = [_reading(events=_conv_events(layer)), _reading()]
    got = [_reader(copy).read(r) for r in cases]
    assert got == [orig.read(r) for r in cases] and got[0] is not None
    assert (_reader(copy).UNIT, _reader(copy).LAYER) == (orig.UNIT, orig.LAYER)


def test_chain_device_ms_reads_what_the_chain_calls_launched():
    events = [_x("user_annotation", "bench.chain", 600, 40),
              _x("cuda_runtime", "cudaLaunchKernel", 610, 1, corr=21),
              _x("kernel", "chain_bf16", 700, 120, corr=21)]
    read = _reader("chain.device_ms.bf16").read
    assert read(_reading(events=events)) == pytest.approx(1e3 * 120e-6 / 2)
    assert read(_reading()) is None  # no chain call in the window


# ------------------------------------------------------------------ the span
def _spans(prof, tmp_path):
    """The program's spans and the operators, each (name, start, end), in start order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    ev = sorted((e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"),
                key=lambda e: e["ts"])
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev
             if e.get("cat") == "user_annotation" and e["name"].startswith("hcflow.")]
    ops = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev if e.get("cat") == "cpu_op"]
    return spans, ops


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_a_bf16_conv_opens_two_cast_spans_and_a_float32_conv_none(tmp_path, compute_dtype):
    from torch.profiler import ProfilerActivity, profile

    g = torch.Generator().manual_seed(0)
    x, w, b = torch.randn(1, 6, 7, 8, generator=g), torch.randn(4, 8, 3, 3, generator=g), \
        torch.randn(4, generator=g)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y = nets.conv2d(x, w, b, compute_dtype)
    assert y.dtype == torch.float32 and y.shape == (1, 6, 7, 4)
    spans, ops = _spans(prof, tmp_path)
    if compute_dtype is None:
        assert spans == []
        return
    assert [n for n, _, _ in spans] == ["hcflow.cast", "hcflow.cast"]
    (_, s0, e0), (_, s1, e1) = spans
    conv = [(s, e) for n, s, e in ops if n == "aten::conv2d"]
    casts = [(s, e) for n, s, e in ops if n == "aten::_to_copy"]
    assert len(conv) == 1 and e0 <= conv[0][0] and conv[0][1] <= s1  # the conv between
    assert len(casts) == 3 and all(s0 <= s and e <= e0 or s1 <= s and e <= e1
                                   for s, e in casts)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2).bfloat16(), w.bfloat16(),
                                      padding=1).float().permute(0, 2, 3, 1) + b
    assert torch.equal(y, want)


# ------------------------------------------------------------------ the controls
def test_round_e4m3_scales_each_tensor_to_e4m3s_range():
    """The largest magnitude maps to 448 and back; every value keeps e4m3's 3 bits of
    mantissa (within 2^-4 relative): 1.1e-3 is 246.4 on e4m3's scale, which rounds to 240."""
    t = torch.tensor([1.1e-3, -2e-3, 0.3e-3, 0.0])
    q = probe.round_e4m3(t)
    assert float(q[1]) == pytest.approx(-2e-3) and q[3] == 0
    assert float(q[0]) == pytest.approx(240 * 2e-3 / 448)
    assert ((q - t).abs() <= 2 ** -4 * t.abs()).all()
    assert torch.equal(probe.round_e4m3(torch.zeros(3)), torch.zeros(3))


@pytest.mark.parametrize("control", ["carry_bf16", "conv_fp8"])
def test_a_control_changes_what_is_served_and_is_undone(served, control):
    from hcflow_tpu_torch.ops import chain, rrdb

    fns = (rrdb.trunk_apply, chain.inverse_chain, nets.conv2d)
    hr = _serve(served)
    with probe.patched(control):
        below = _serve(served)
    assert (rrdb.trunk_apply, chain.inverse_chain, nets.conv2d) == fns
    assert torch.equal(_serve(served), hr)
    want = served[4]
    assert (below - want).pow(2).mean() > (hr - want).pow(2).mean()


def test_the_probe_runs_control_main_once_a_control_in_force(monkeypatch):
    from h100_bench import control
    from hcflow_tpu_torch.ops import rrdb

    orig, seen = rrdb.trunk_apply, []
    monkeypatch.setattr(control, "main",
                        lambda argv: seen.append((argv, rrdb.trunk_apply is orig)) or 0)
    assert probe.main(["--workload", CELL, "--seeds", "1,2", "--controls", "port,carry_bf16",
                       "--json", "out"]) == 0
    argv = ["--workload", CELL, "--seeds", "1,2", "--seconds", "4", "--programs", "port"]
    assert seen == [(argv + ["--json", "out.port"], True),
                    (argv + ["--json", "out.carry_bf16"], False)]
    assert rrdb.trunk_apply is orig
