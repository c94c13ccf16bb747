"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W) and
the roofline bound, copied from chip_smoke.py's `bound`."""

HBM_BPS = 3.35e12            # HBM3 bytes/s
FP64_FLOPS = 34e12           # float64 outside the tensor cores
FP64_TC_FLOPS = 67e12        # float64 on the tensor cores (DMMA)


def bound_s(flops, nbytes, peak):
    """The least time of `flops` operations at `peak` and `nbytes` moved at
    HBM_BPS, in seconds: the larger of the two."""
    return max(flops / peak, nbytes / HBM_BPS)
