"""Host-side helpers of the port (numpy filter-bank designers)."""
