"""Host-side data for the with-flow eval: the simulator, the PNG codec and
the sequence reader (numpy only)."""
