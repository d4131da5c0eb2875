"""Three-term roofline with the H100's peaks (torch twin of
``repro.roofline``)."""
from repro_torch.roofline.analysis import (
    HW,
    collective_bytes_from_hlo,
    collective_bytes_from_mesh,
    roofline_terms,
    model_flops_estimate,
)

__all__ = ["HW", "collective_bytes_from_hlo", "collective_bytes_from_mesh",
           "roofline_terms", "model_flops_estimate"]
