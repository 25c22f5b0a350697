"""Hand-written Hopper kernels of the port, one subpackage per kernel
of ``repro.kernels``: the CUDA source, its build, the wrapper and the
plain PyTorch version the CPU tests use.  :func:`libraries` lists every
kernel library, for a build of all of them at once
(:func:`repro_torch.kernels._build.build_all`)."""


def libraries() -> list:
    """The :class:`~repro_torch.kernels._build.KernelLibrary` of every
    kernel, in the order of ``repro.kernels``' TPU kernels."""
    from repro_torch.kernels.flash_attention.build import \
        LIB as flash_attention
    from repro_torch.kernels.rmsnorm.build import LIB as rmsnorm
    from repro_torch.kernels.segment_sum.build import LIB as segment_sum
    from repro_torch.kernels.ssd_scan.build import LIB as ssd_scan
    return [segment_sum, flash_attention, ssd_scan, rmsnorm]
