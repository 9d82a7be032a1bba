"""Device milliseconds a request of what the window's calls to ops/chain.py
`inverse_chain` launched (csrc/chain.cu, bf16 instance), in the bf16 recipe's cell: the
time in place of a bf16 roofline of the chain kernel, whose bf16 byte counts the window's
calls do not keep."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER = "chain kernel"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_bf16.photos"]


def read(r):
    dev = r.device_s.get("chain")
    return 1e3 * dev / r.requests if dev and r.requests else None
