"""The plain reference that decides ``correct``: textbook DSP in PyTorch
(``dsp``) and the RDS group comparison against the groups the generator
sent (``rds``).  It imports nothing of the program and takes none of its
weights: every filter is designed here again from the configuration."""
