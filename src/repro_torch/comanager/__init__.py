"""co-Manager data plane: per-worker execution of circuit banks."""
