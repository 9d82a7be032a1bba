from .hcflow_sr import HCFlowSRSpec

__all__ = ["HCFlowSRSpec"]
