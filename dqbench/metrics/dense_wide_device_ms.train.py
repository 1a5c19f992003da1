"""Device ms a step of the operations launched inside the program's
``grad_shift.dense`` span on the wide route (the chain weights, psi's build,
the wide kernel and the reduction), on any thread, from the profiled stretch
with the program's recorder installed: the reader of
``dense_grad_device_ms.train`` itself, so both names keep one yardstick."""
from harness import load_reader

read = load_reader("dense_grad_device_ms.train")
