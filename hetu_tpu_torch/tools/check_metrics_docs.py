"""check_metrics_docs: every metric the port registers must be documented
(a copy of ``hetu_tpu/tools/check_metrics_docs.py``, scanning
``hetu_tpu_torch/`` against the same ``docs/OBSERVABILITY.md``: the port
emits ``hetu_tpu``'s series under ``hetu_tpu``'s names, so a name the
doc lacks is a name the port got wrong).

``docs/OBSERVABILITY.md`` is the operator's contract for what the
registry emits; a metric that exists in code but not in the doc is
invisible at exactly the moment someone greps the doc for it. This lint
extracts every *literal* metric name passed to
``registry.counter/gauge/histogram(...)`` anywhere under
``hetu_tpu_torch/``
and asserts it appears in the doc. Dynamic names (f-strings like
``f"{category}_seconds_total"``) cannot be resolved statically and are
skipped — document their families by hand.

Run as a quick-tier test (``tests/test_torch_observability.py``) or::

    python -m hetu_tpu_torch.tools.check_metrics_docs
"""

from __future__ import annotations

import os
import re
import sys
from typing import Optional

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_DOC = os.path.join(os.path.dirname(_ROOT), "docs", "OBSERVABILITY.md")

#: .counter("name" | .gauge('name' | .histogram("name"  — literal first
#: args only (an f-prefix right before the quote marks a dynamic name)
_PATTERN = re.compile(
    r"\.(?:counter|gauge|histogram)\(\s*(f?)([\"'])([A-Za-z0-9_]+)\2")


def registered_metric_names(root: str = _ROOT) -> dict[str, list[str]]:
    """``{metric_name: [file:line, ...]}`` for every literal
    registration site under ``root``."""
    out: dict[str, list[str]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in filenames:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                text = f.read()
            # whole-file scan: registration calls regularly wrap the
            # name onto the next line
            for m in _PATTERN.finditer(text):
                if m.group(1):               # f-string: dynamic name
                    continue
                line_no = text.count("\n", 0, m.start()) + 1
                rel = os.path.relpath(path, os.path.dirname(root))
                out.setdefault(m.group(3), []).append(
                    f"{rel}:{line_no}")
    return out


def missing_from_docs(doc_path: str = _DOC,
                      root: str = _ROOT) -> dict[str, list[str]]:
    """Registered names absent from the doc text (substring match — the
    doc tables write names with label suffixes and escapes)."""
    with open(doc_path) as f:
        doc = f.read()
    names = registered_metric_names(root)
    return {name: sites for name, sites in sorted(names.items())
            if name not in doc}


def missing_traceparent_verbs(doc_path: str = _DOC) -> list[str]:
    """Every line-protocol verb that carries a ``traceparent``
    (``telemetry.tracecontext.TRACEPARENT_VERBS``) must appear as a row
    in the doc's verb-instrumentation tables — a verb that propagates
    trace context but is absent from the operator tables is exactly the
    hop nobody can explain in a merged fleet trace. A table row is a
    markdown line whose first cell starts with the verb name."""
    from hetu_tpu_torch.telemetry.tracecontext import TRACEPARENT_VERBS
    with open(doc_path) as f:
        doc = f.read()
    missing = []
    for verb in TRACEPARENT_VERBS:
        if not re.search(rf"^\|\s*`?{verb}`?\b", doc, re.MULTILINE):
            missing.append(verb)
    return missing


def main(argv: Optional[list[str]] = None) -> int:
    missing = missing_from_docs()
    verbs = missing_traceparent_verbs()
    if not missing and not verbs:
        print(f"check_metrics_docs: all "
              f"{len(registered_metric_names())} registered metric "
              f"names documented in docs/OBSERVABILITY.md; every "
              f"traceparent-carrying verb has a doc table row")
        return 0
    if missing:
        print("check_metrics_docs: metrics registered in code but "
              "missing from docs/OBSERVABILITY.md:", file=sys.stderr)
        for name, sites in missing.items():
            print(f"  {name}  ({', '.join(sites[:3])})", file=sys.stderr)
    if verbs:
        print("check_metrics_docs: traceparent-carrying verbs without "
              "a verb-table row in docs/OBSERVABILITY.md:",
              file=sys.stderr)
        for verb in verbs:
            print(f"  {verb}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
