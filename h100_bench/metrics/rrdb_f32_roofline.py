"""The float32 RRDB kernel's share of its roofline: the least time of the window's calls to
ops/rrdb.py `trunk_apply` (csrc/rrdb.cu), their float32 operations at the TF32 peak or their bytes at the HBM peak
(`work.trunk_work` of each call's shapes), over the device time of what those calls
launched."""

UNIT, BETTER, SOURCE = "%", "higher", "device_trace"
LAYER = "RRDB kernel"
MOVES = "hr_mps"
WORKLOADS = ["sr_x4_f32.photos", "rescaling_x4_f32.view", "rescaling_x4_f32.ingest"]


def read(r):
    return r.roofline_pct("rrdb")
