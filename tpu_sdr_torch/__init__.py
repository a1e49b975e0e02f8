"""tpu-sdr on PyTorch and CUDA — the port of the ``tpu_sdr`` data plane.

The JAX package ``tpu_sdr`` stays the reference; this package holds the
same receive chains in PyTorch, with its TPU kernels rewritten by hand as
CUDA C++ for Hopper (``csrc/``).  It imports ``torch`` and never ``jax``:
it reuses only the jax-free host modules of ``tpu_sdr`` (filter design,
synthetic captures, the native s16 conversion, the feeder and the device
control plane).  Keep ``TPU_SDR_PLATFORM`` unset when importing it: that
variable makes ``tpu_sdr/__init__.py`` load JAX.

Ported so far: the single-station WBFM receive path, as the f32 float
chain (``models.wbfm``) and as the fused two-kernel chain
(``ops.fused_fm``), behind ``python -m tpu_sdr_torch.apps.simple_fm``; and
the wideband multi-station path (``models.wbfm_wideband``) with the plain
or the K3 channelizer (``ops.channelizer``, ``ops.fused_channelizer``),
behind ``python -m tpu_sdr_torch.apps.multi_fm``; and the sharded (dp, sp)
receive chains with the K4/K5 halo exchange (``parallel``).
"""
