"""Plain tensor functions and the hand-written kernels with their wrappers."""
