"""Workload models as operands: the port of ``tpudes/traffic``.

- :mod:`tpudes_torch.traffic.program` — :class:`TrafficProgram`, its
  factories and the ``fold_in``-keyed table realizations;
- :mod:`tpudes_torch.traffic.device` — the offered-bits table the LTE
  engine's finite backlogs are filled from, and the WiFi BSS's next
  inter-arrival gaps;
- :mod:`tpudes_torch.traffic.host` — the numpy mirrors behind the
  ``offered_bits`` result field.
"""
