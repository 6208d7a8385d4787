"""Device scoring programs, term selection, packing and the TAAT kernel."""
