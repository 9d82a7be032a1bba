"""The float32 chain kernel's share of its roofline: the least time of the window's calls to
ops/chain.py `inverse_chain` (csrc/chain.cu), their float32 operations at the TF32 peak or their bytes at the HBM peak
(`work.chain_work` of each call's shapes), over the device time of what those calls
launched."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "chain kernel"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view"]


def read(r):
    return r.roofline_pct("chain")
