"""The float32 chain3s kernel's share of its roofline: the least time of the window's calls to
ops/chain3s.py `inverse_chain` (csrc/chain3s.cu), their float32 operations at the TF32 peak or their bytes at the HBM peak
(`work.chain3s_work` of each call's shapes), over the device time of what those calls
launched."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "chain3s kernel"
MOVES = "hr_mps"
WORKLOADS = ["rescaling_x4_f32.view"]


def read(r):
    return r.roofline_pct("chain3s")
