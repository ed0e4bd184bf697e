"""Elementwise physics ops of the port (counterparts of ``tpudes/ops``)."""
