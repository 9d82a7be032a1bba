"""The port's spans (``hcflow_tpu_torch/utils/profiling.py``) on the CPU.

Under a CPU ``torch.profiler`` profile, a tiny x4 SR model and a tiny x4 rescaling
model, packed as the card serves them (``precompute_inference(fused=True)``: on the
CPU the kernels' plain versions run behind the same wrappers), run ``reverse`` and
``forward``; their Chrome trace holds the span tree of the layers, one
``hcflow.cond``, ``hcflow.encoder`` and ``hcflow.main`` a level and call, and the
kernel wrappers' spans in the order of their calls.  Outside a profile a span is one
shared null context.
"""

import contextlib
import json

import pytest
import torch

from hcflow_tpu_torch.models import HCFlowRescalingSpec, HCFlowSRSpec
from hcflow_tpu_torch.utils import profiling

# widths the kernels take unpadded (RRDB nf, gc 16; chain hid 32; chain3s growth 16)
SR = dict(K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(1, 2), rrdb_nf=16, rrdb_gc=16,
          hidden_channels=32, so_hidden_channels=32)
RESCALING = dict(K=(4, 4), after_splitoff=(2, 2), rrdb_nb=(2, 1), rrdb_nf=16, rrdb_gc=16,
                 hidden_channels=16, so_hidden_channels=32)
LEVELS = 2


def _model(kind):
    if kind == "sr":
        model = HCFlowSRSpec.for_scale(4, **SR)
    else:
        model = HCFlowRescalingSpec.default_x4(**RESCALING)
    params = model.flow.init(torch.Generator().manual_seed(0))
    return model, model.flow.precompute_inference(params, fused=True)


def _spans(prof, tmp_path):
    """The trace's hcflow.* spans as (name, start, end, parent index or None)."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e["name"].startswith("hcflow.")]
    out = []
    for i, (name, s, e) in enumerate(spans):
        holders = [j for j, (_, s2, e2) in enumerate(spans)
                   if j != i and s2 <= s and e <= e2 and (s2, -e2) < (s, -e)]
        parent = min(holders, key=lambda j: spans[j][2] - spans[j][1]) if holders else None
        out.append((name, s, e, parent))
    return out


def _tree(spans):
    """{name: sorted list of the parents' names} and the count of each name."""
    parents, counts = {}, {}
    for name, _, _, p in spans:
        parents.setdefault(name, []).append(None if p is None else spans[p][0])
        counts[name] = counts.get(name, 0) + 1
    return {k: sorted(v, key=str) for k, v in parents.items()}, counts


def _run(kind, entry):
    model, params = _model(kind)
    g = torch.Generator().manual_seed(1)
    lr = torch.rand(1, 6, 8, 3, generator=g)
    hr = torch.rand(1, 24, 32, 3, generator=g)
    with torch.no_grad():
        if entry == "reverse":
            return model.reverse(params, lr, 0.8, generator=g)
        if kind == "sr":
            return model.forward(params, hr, lr, noise=torch.zeros_like(hr))
        return model.forward(params, hr)


# the inverse chains' kernel wrappers a reverse pass calls a level: (span, parent)
REVERSE = {"sr": [("hcflow.chain", "hcflow.main"), ("hcflow.chain", "hcflow.cond")],
           "rescaling": [("hcflow.chain3s", "hcflow.main"), ("hcflow.chain", "hcflow.cond")]}


@pytest.mark.parametrize("entry", ["reverse", "forward"])
@pytest.mark.parametrize("kind", ["sr", "rescaling"])
def test_a_pass_opens_the_span_tree_of_its_layers(tmp_path, kind, entry):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(kind, entry)
    spans = _spans(prof, tmp_path)
    parents, counts = _tree(spans)
    top = f"hcflow.{entry}"
    want = {top: [None] * 1,
            "hcflow.cond": [top] * LEVELS,
            "hcflow.encoder": ["hcflow.cond"] * LEVELS,
            "hcflow.rrdb": ["hcflow.encoder"] * 2 * LEVELS,
            "hcflow.main": [top] * LEVELS}
    if entry == "reverse":
        for name, parent in REVERSE[kind]:
            want.setdefault(name, []).extend([parent] * LEVELS)
    assert parents == {k: sorted(v) for k, v in want.items()}
    # the levels in turn: each level's encoder inside its own cond span
    conds = [i for i, sp in enumerate(spans) if sp[0] == "hcflow.cond"]
    assert sorted(spans[i][3] for i, sp in enumerate(spans) if sp[0] == "hcflow.encoder") == conds
    assert counts[top] == 1


def test_the_kernel_spans_follow_the_call_order(tmp_path):
    """x4 SR reverse, the deepest level first: a level's encoder calls trunk0 then trunk1,
    then its conditional flow the split-off chain, then the level's main chain."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run("sr", "reverse")
    spans = _spans(prof, tmp_path)
    kernel = sorted((s, name, spans[p][0]) for name, s, _, p in spans
                    if name in ("hcflow.rrdb", "hcflow.chain", "hcflow.chain3s"))
    assert [(name, parent) for _, name, parent in kernel] == LEVELS * [
        ("hcflow.rrdb", "hcflow.encoder"), ("hcflow.rrdb", "hcflow.encoder"),
        ("hcflow.chain", "hcflow.cond"), ("hcflow.chain", "hcflow.main")]


def test_no_profiler_no_span():
    """Outside a profile every span is one shared null context; a profile with CPU
    activity turns them into ``record_function`` spans, and its end turns them back."""
    from torch.profiler import ProfilerActivity, profile

    assert not torch.autograd._profiler_enabled()
    assert profiling.span("hcflow.reverse") is profiling.span("hcflow.main")
    assert isinstance(profiling.span("hcflow.cond"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert isinstance(profiling.span("hcflow.cond"), torch.profiler.record_function)
    assert profiling.span("hcflow.rrdb") is profiling.span("hcflow.chain")
