"""Tools of the port: FLOP and MFU accounting (`tools.mfu`)."""
