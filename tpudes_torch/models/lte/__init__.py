"""LTE model constants (copies from ``tpudes/models/lte``)."""
