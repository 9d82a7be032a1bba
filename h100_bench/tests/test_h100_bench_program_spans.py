"""CPU tests of the readers of the program's own spans (``h100_bench/program_trace.py``)
and of the per-layer metrics that read them.

    python -m pytest h100_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "h100_bench"
sys.path.insert(0, str(REPO))

from h100_bench import harness, program_trace, spec, trace  # noqa: E402
from h100_bench.reference.hcflow import Topology  # noqa: E402

from test_h100_bench_harness import SEED, root  # noqa: E402,F401  (the tiny cells)

NEW = {"entry.idle_ms", "encoder.device_ms", "cond.device_ms", "main.device_ms",
       "cond.host_ms", "main.host_ms"}


def _x(cat, name, ts, dur, corr=None):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {} if corr is None else {"correlation": corr}}


def _events():
    """One request's window (us): the entry with a level's cond (its encoder, an RRDB
    trunk inside the benchmark's wrapper span) and main chain (a chain call whose two
    spans share one interval), then the wait for the output."""
    a, launch = "user_annotation", "cuda_runtime"
    return [
        _x(a, "bench.window", 0, 1000),
        _x(a, "bench.entry", 10, 290),
        _x(a, "hcflow.reverse", 12, 286),
        _x(a, "hcflow.cond", 20, 130),
        _x(a, "hcflow.encoder", 22, 78),
        _x(a, "bench.rrdb", 30, 30),
        _x(a, "hcflow.rrdb", 31, 28),
        _x(a, "hcflow.main", 160, 130),
        _x(a, "hcflow.chain", 180, 20),  # listed before its benchmark twin
        _x(a, "bench.chain", 180, 20),
        _x(a, "bench.wait", 310, 680),
        _x(launch, "cudaLaunchKernel", 40, 1, corr=1),   # in hcflow.rrdb
        _x(launch, "cudaLaunchKernel", 70, 1, corr=2),   # the encoder's own
        _x(launch, "cudaLaunchKernel", 120, 1, corr=3),  # the cond's own
        _x(launch, "cudaLaunchKernel", 170, 1, corr=4),  # the main chain's own
        _x(launch, "cudaLaunchKernelExC", 190, 1, corr=7),  # in hcflow.chain
        _x(launch, "cudaLaunchKernel", 295, 1, corr=5),  # the entry's own (the clamp)
        _x(launch, "cudaMemcpyAsync", 305, 1, corr=6),   # outside the entry
        _x("kernel", "residual_kernel", 45, 45, corr=1),
        _x("kernel", "cudnn_conv", 90, 20, corr=2),
        _x("kernel", "prior_conv", 125, 15, corr=3),
        _x("kernel", "cudnn_conv", 175, 40, corr=4),
        _x("kernel", "chain_step_f32_kernel", 215, 15, corr=7),
        _x("kernel", "clamp", 296, 4, corr=5),
        _x("gpu_memcpy", "Memcpy DtoH", 600, 50, corr=6),
    ]


def _reading(events, requests=2):
    calls = trace.Calls(Topology(json.loads((BENCH / "configs" / "sr_x4_f32.json")
                                            .read_text())["network_G"], True))
    calls.rrdb(torch.empty(1, 10, 12, 64))  # the benchmark's own count of the call
    r = trace.Reading(events, calls, requests)
    assert isinstance(r, program_trace.Reading)
    return r


def test_program_spans_reduce_to_device_host_self_and_idle_time():
    r = _reading(_events())
    pt = r.program
    us = 1e-6
    # (a) device time by the innermost program span open at each launch
    assert pt.device_s == pytest.approx({"hcflow.rrdb": 45 * us, "hcflow.encoder": 20 * us,
                                         "hcflow.cond": 15 * us, "hcflow.main": 40 * us,
                                         "hcflow.chain": 15 * us, "hcflow.reverse": 4 * us,
                                         None: 50 * us})
    # what the benchmark's own spans read is as before: the library time is the
    # encoder's, the cond's, the main chain's and the entry's own
    assert r.device_s == pytest.approx({"rrdb": 45 * us, "chain": 15 * us, "library": 79 * us,
                                        "outside the entry": 50 * us})
    assert sum(pt.device_s[n] for n in ("hcflow.encoder", "hcflow.cond", "hcflow.main",
                                        "hcflow.reverse")) == pytest.approx(r.device_s["library"])
    # (b) host self time: less the child spans, the benchmark's among them
    assert pt.self_s == pytest.approx({"hcflow.reverse": 26 * us, "hcflow.cond": 52 * us,
                                       "hcflow.encoder": 48 * us, "hcflow.rrdb": 28 * us,
                                       "hcflow.main": 110 * us, "hcflow.chain": 20 * us})
    # (c) idle gaps by the innermost span, the program's inside bench.entry
    assert pt.idle_s == pytest.approx({"bench.window": 45 * us, "hcflow.cond": 50 * us,
                                       "hcflow.main": 66 * us, "bench.entry": 300 * us,
                                       "bench.wait": 350 * us})
    assert sum(pt.idle_s.values()) == pytest.approx(r.window_s - r.busy_s)
    assert dict(r.idle_gaps) == pytest.approx({"no span": 45 * us, "bench.entry": 416 * us,
                                               "bench.wait": 350 * us})


def test_the_reduction_waits_for_its_first_reader(capsys):
    """A cell whose readers read no program span (``tiles``) pays nothing: the Reading
    keeps the events, and reduces and logs them once, when first read."""
    r = _reading(_events())
    assert "program" not in vars(r) and "program spans:" not in capsys.readouterr().err
    assert r.program is r.program and r._trace_events is None
    assert capsys.readouterr().err.count("program spans: reduced in") == 1


def test_the_six_readers_read_the_program_spans(capsys):
    r = _reading(_events())
    got = {m.NAME: m.read(r) for m in spec.metric_modules() if m.NAME in NEW}
    assert got == pytest.approx({"entry.idle_ms": 0.058, "encoder.device_ms": 0.010,
                                 "cond.device_ms": 0.0075, "main.device_ms": 0.020,
                                 "cond.host_ms": 0.026, "main.host_ms": 0.055})
    err = capsys.readouterr().err
    assert ("agreement rrdb: device ms a request hcflow.rrdb 0.0225 bench.rrdb 0.0225 "
            "(+0.000%); 1 hcflow.rrdb spans, 1 calls") in err
    assert "= 0.0395 ms a request, library.device_ms 0.0395 (+0.000%)" in err


def test_without_program_spans_the_readers_find_nothing():
    """A program that opens no span (the parent of the spans): every new reader returns
    None, and the benchmark's own readers read as before."""
    events = [e for e in _events() if not e["name"].startswith("hcflow.")]
    r = _reading(events)
    assert {m.NAME: m.read(r) for m in spec.metric_modules() if m.NAME in NEW} == \
        dict.fromkeys(NEW)
    assert r.device_s["library"] == pytest.approx(79e-6)


def test_traced_ingest_on_the_cpu_reports_the_host_self_times(root):
    res = harness.run_cell("rescaling_x4_f32.ingest", SEED, 0.3, True, device="cpu", root=root)
    assert res["correct"]
    m = res["metrics"]
    assert m["cond.host_ms"]["value"] > 0 and m["main.host_ms"]["value"] > 0
    assert not {"entry.idle_ms", "encoder.device_ms", "cond.device_ms", "main.device_ms"} & set(m)
    assert {"entry.host_ms", "step_mfu", "device.idle_pct"} <= set(m)


def test_a_program_without_spans_runs_traced(root, monkeypatch):
    """The benchmark laid over a program that opens no span: the traced run succeeds and
    leaves the new metrics out."""
    import contextlib

    from hcflow_tpu_torch.utils import profiling

    monkeypatch.setattr(profiling, "span", lambda name: contextlib.nullcontext())
    res = harness.run_cell("rescaling_x4_f32.ingest", SEED, 0.3, True, device="cpu", root=root)
    assert res["correct"] and not NEW & set(res["metrics"])
    assert "entry.host_ms" in res["metrics"]


def test_benchmark_json_lists_the_new_metrics():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    names = [m["name"] for m in bench["per_layer"]]
    assert names[-6:] == ["entry.idle_ms", "encoder.device_ms", "cond.device_ms",
                          "main.device_ms", "cond.host_ms", "main.host_ms"]
    assert all(m["moves"] == "hr_mps" and "sr_x4_f32.tiles" not in m["workloads"]
               for m in bench["per_layer"][-6:])
