"""Share of its roofline of ``shift_dmem_kernel``, the shift walk's route for
registers of m >= 13, in the traced stretch: ``shiftbank_roofline``'s reader
(the summed bound of the steps' bank launches, ``counters.bank_bound_s``,
over the summed device time of the kernel's launches) on this kernel, so both
rooflines keep one body."""
from harness import load_reader

read = load_reader("shiftbank_roofline")
read.__globals__["KERNEL"] = "shift_dmem_kernel"  # its own copy of the module
