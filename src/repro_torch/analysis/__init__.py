from repro_torch.analysis.cost import StepCost, count_step
from repro_torch.analysis.roofline import HW, RooflineTerms, roofline_terms

__all__ = ["StepCost", "count_step", "HW", "RooflineTerms", "roofline_terms"]
