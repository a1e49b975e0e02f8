"""tpu-sdr on PyTorch and CUDA — the port of the ``tpu_sdr`` data plane.

The JAX package ``tpu_sdr`` stays the reference; this package holds the
same receive chains in PyTorch, with its TPU kernels rewritten by hand as
CUDA C++ for Hopper (``csrc/``).  It imports ``torch`` and never ``jax``,
nor anything of ``tpu_sdr``: it keeps its own copies of the host layer it
runs on (filter design ``utils.firdes``, synthetic captures ``utils.synth``,
``utils.profiling.BlockStats``, the native C++ runtime ``native`` over its
own ``csrc/tpusdr_io.cpp``, the feeder ``stream.feeder``, the rtl_tcp
server ``stream.rtl_tcp_server`` and the device control plane ``api``,
``errors``, ``control``), under the JAX package's module names.

Ported so far: the single-station WBFM receive path, as the f32 float
chain (``models.wbfm``) and as the fused two-kernel chain
(``ops.fused_fm``), behind ``python -m tpu_sdr_torch.apps.simple_fm``; and
the wideband multi-station path (``models.wbfm_wideband``) with the plain
or the K3 channelizer (``ops.channelizer``, ``ops.fused_channelizer``),
behind ``python -m tpu_sdr_torch.apps.multi_fm``; the sharded (dp, sp)
receive chains with the K4/K5 halo exchange (``parallel``); the stereo
decoder and RDS (``models.wbfm_stereo``, ``models.rds``; ``simple_fm
--mode stereo --rds``, ``multi_fm --rds``); the AM/NBFM/SSB receiver
(``models.multimode``, ``apps.rtl_fm``); the spectrum scanner
(``ops.spectrum``, ``apps.rtl_power``); checkpoint/resume
(``stream.checkpoint``); the read path's spans and counters, kept as
totals and, under a profiler, as a timeline (``utils.profiling``), and
traces with that timeline as a track of their own
(``utils.profiling.trace``); the streaming runtime (the native ring and
pump, the feeder's pinned double buffer ``BlockFeeder.device_blocks``) and the host CLIs ``rtl_tcp``,
``rtl_test``, ``rtl_sdr_capture``, ``rtl_eeprom``, ``device_list`` and
``demo_device_id``.
"""

DEFAULT_BUF_LENGTH = 16 * 16384  # bytes per sync-read block (ref src/lib.rs:25)
