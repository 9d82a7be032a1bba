from .hcflow_rescaling import HCFlowRescalingSpec, quantize
from .hcflow_sr import HCFlowSRSpec

__all__ = ["HCFlowRescalingSpec", "HCFlowSRSpec", "quantize"]
