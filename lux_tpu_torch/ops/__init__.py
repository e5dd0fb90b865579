"""Segmented reductions, routed gathers and the hand-written CUDA kernels
behind them."""


def kernel_wrappers() -> dict:
    """Every hand-written kernel's wrapper, by kernel name.  Each wrapper
    counts its own launches in ``.launches`` (a CPU tensor runs the plain
    version and counts nothing)."""
    from lux_tpu_torch.ops import scan, segment, shuffle, spmv

    return {"spmv_blockcsr": spmv.spmv_blockcsr, "spmv_blockcsr_2d": spmv.spmv_blockcsr_2d,
            "mxscan_segmented": scan.mxscan_segmented, **shuffle.KERNELS,
            "segment_sum_sorted": segment.segment_sum_sorted}
