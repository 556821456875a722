"""The decode pool's step functions (bind, micro-step, sampling)."""
