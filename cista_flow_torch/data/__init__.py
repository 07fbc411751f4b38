"""Host-side data for the with-flow eval and for training: the simulator,
the PNG codec, the sequence reader and the training loader (numpy only)."""
