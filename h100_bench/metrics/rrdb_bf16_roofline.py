"""The bf16 RRDB kernel's share of its roofline: the window's calls to ops/rrdb.py
`trunk_apply` (csrc/rrdb.cu, bf16 instance), their operations (`work.trunk_work` of each
call's shapes) at the card's dense bf16 tensor-core peak, over the device time of what
those calls launched.  Exact where the calls are bound by their operations: the calls'
float32 byte count (an upper bound on what the bf16 kernel moves) at the HBM peak must
take less time than their operations, or the reader returns None."""

from h100_bench import work

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "RRDB kernel"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]

PEAK_BF16 = 989e12  # FLOP/s, dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet)


def read(r):
    flops, nbytes, _, calls = r.calls.work["rrdb"]
    dev = r.device_s.get("rrdb", 0.0)
    if calls == 0 or dev <= 0 or nbytes / work.PEAK_BYTES >= flops / PEAK_BF16:
        return None
    return 100.0 * flops / PEAK_BF16 / dev
