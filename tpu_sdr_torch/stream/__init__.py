"""Host streaming: the block feeder (the port's copy of ``tpu_sdr.stream``)."""
