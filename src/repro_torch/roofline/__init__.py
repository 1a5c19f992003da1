"""Roofline analysis: the reference's HLO analyzers (copies, for its
dry-run artifacts), the port's op counter over a torch step on the ``meta``
device, and the three-term roofline against a chip's peaks."""
