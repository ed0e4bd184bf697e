"""Host-side core of the port (counterparts of ``tpudes/core``)."""
