"""Model-level constants the port keeps its own copies of."""
