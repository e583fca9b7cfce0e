"""Host utilities of the port (counterparts of `tpufusion/utils/`)."""
