"""Device engines of the port (counterparts of ``tpudes/parallel``)."""
