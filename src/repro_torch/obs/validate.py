"""CLI: validate a Chrome trace-event JSON artifact (port of
``repro.obs.validate``).

    python -m repro_torch.obs.validate trace.json \
        --require-phase engine.iteration engine.micro_step decode.bind

Exits non-zero (with the violation on stderr) when the trace fails the
structural schema — unbalanced or improperly nested B/E events, regressed
timestamps, unstable per-track tids — or when any required phase has no
completed span.  On success prints the span census so the CI log shows
what the timeline actually contains.
"""
from __future__ import annotations

import argparse
import json
import sys

from repro_torch.obs.tracing import validate_chrome_trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("trace", help="Chrome trace-event JSON file")
    ap.add_argument("--require-phase", nargs="*", default=[],
                    action="extend",
                    help="span names that must each appear >= 1 time "
                         "(repeatable; occurrences accumulate)")
    ap.add_argument("--require-tenants", type=int, default=0,
                    help="minimum number of distinct tenant tracks")
    args = ap.parse_args(argv)
    with open(args.trace) as f:
        doc = json.load(f)
    try:
        stats = validate_chrome_trace(doc, require_phases=args.require_phase)
    except ValueError as e:
        print(f"TRACE INVALID: {e}", file=sys.stderr)
        return 1
    if len(stats["tenant_tids"]) < args.require_tenants:
        print(f"TRACE INVALID: {len(stats['tenant_tids'])} tenant track(s), "
              f"need >= {args.require_tenants}", file=sys.stderr)
        return 1
    print(json.dumps(stats, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
