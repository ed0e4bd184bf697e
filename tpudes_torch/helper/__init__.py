"""Scenario helpers of the port (counterparts of ``tpudes/helper``)."""
