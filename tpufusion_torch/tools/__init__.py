"""Host tools of the port (counterparts of `tpufusion/tools/`)."""
