"""Validate tpudes_torch.obs export files against their schemas.

Usage::

    python -m tpudes_torch.obs --flowmon <flowmon.xml> [more.xml ...]
    python -m tpudes_torch.obs --pcap <capture.pcap> [more.pcap ...]
    python -m tpudes_torch.obs --distributed <metrics.json> [more.json ...]
    python -m tpudes_torch.obs --geometry <metrics.json> [more.json ...]
    python -m tpudes_torch.obs --traffic <metrics.json> [more.json ...]
    python -m tpudes_torch.obs --serving <metrics.json> [more.json ...]
    python -m tpudes_torch.obs --grad <metrics.json> [more.json ...]

The reference CLI's modes (``tpudes/obs/__main__.py``) for what the port
records: ``--flowmon`` checks FlowMonitor XML exports
(:class:`~tpudes_torch.obs.flowmon.DeviceFlowMonitor`'s, or upstream
ns-3's ``SerializeToXmlFile``) for the standard FlowStats attributes;
``--pcap`` validates classic libpcap captures record by record;
``--distributed``, ``--geometry``, ``--traffic``, ``--serving`` and
``--grad`` check the telemetry snapshots dumped as JSON.  The
Chrome-trace default and ``--fuzz`` have no port counterpart.  Exit 0 when every
file is valid, 1 on violations, 2 on usage or unreadable input.
"""

from __future__ import annotations

import json
import sys

from tpudes_torch.obs.distributed import validate_distributed_metrics
from tpudes_torch.obs.flowmon import validate_flowmon_xml, validate_pcap
from tpudes_torch.obs.geometry import validate_geometry_metrics
from tpudes_torch.obs.grad import validate_grad_metrics
from tpudes_torch.obs.serving import validate_serving_metrics
from tpudes_torch.obs.traffic import validate_traffic_metrics

#: the JSON modes: flag -> (validator, what it checks, the record count)
_JSON_MODES = {
    "--distributed": (validate_distributed_metrics, "distributed metrics",
                      lambda d: d["counters"]["windows"]),
    "--geometry": (validate_geometry_metrics, "geometry metrics",
                   lambda d: len(d["engines"])),
    "--traffic": (validate_traffic_metrics, "traffic metrics",
                  lambda d: len(d["engines"])),
    "--serving": (validate_serving_metrics, "serving metrics",
                  lambda d: len(d["engines"])),
    "--grad": (validate_grad_metrics, "grad metrics",
               lambda d: len(d["engines"])),
}
_MODES = ("--flowmon", "--pcap", *_JSON_MODES)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    modes = [a for a in argv if a in _MODES]
    paths = [a for a in argv if a not in _MODES]
    if (len(modes) != 1 or not paths
            or any(a in ("-h", "--help") for a in argv)):
        print(__doc__, file=sys.stderr)
        return 2
    mode = modes[0]
    rc = 0
    for path in paths:
        try:
            if mode == "--pcap":
                with open(path, "rb") as f:
                    problems, n = validate_pcap(f.read())
                kind = "pcap capture"
            elif mode == "--flowmon":
                with open(path, encoding="utf-8") as f:
                    problems, n = validate_flowmon_xml(f.read())
                kind = "FlowMonitor XML"
            else:
                validate, kind, count = _JSON_MODES[mode]
                with open(path) as f:
                    doc = json.load(f)
                problems = validate(doc)
                n = 0 if problems else count(doc)
        except (OSError, json.JSONDecodeError) as e:
            print(f"{path}: unreadable ({e})", file=sys.stderr)
            return 2
        if problems:
            rc = 1
            for p in problems:
                print(f"{path}: {p}")
        else:
            print(f"{path}: valid {kind} ({n} records)")
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
