"""Metric-name catalog: every metric the port can register, scanned from
source, and the docs-completeness gate over it (the port's own copy of
``horovod_tpu/telemetry/catalog.py``).

The registry (registry.py) has no central declaration site — call sites
register metrics ad hoc (``tm.counter("horovod_x_total", ...)``), some
through wrappers that take the name as a plain argument.  So the
catalog is an AST sweep: every string constant that (a) looks like a
metric name (``horovod_[a-z0-9_]+``, no trailing underscore — those
are prefixes being concatenated) and (b) appears as an argument of some
call, anywhere under ``horovod_tpu_torch/``.  That over-approximates (any
horovod_-shaped string constant passed to any function qualifies), so
non-metric names go in :data:`ALLOWLIST` rather than weakening the
pattern.

:func:`undocumented_metrics` is the docs contract for metrics: every
cataloged name must appear in a table row of docs/observability.md (as
`` `name` `` or `` `name{labels}` ``), and the tests assert the result is
empty (tests/test_torch_perfscope.py) — a new metric cannot land
undocumented.
"""
from __future__ import annotations

import ast
import os
import re
from pathlib import Path

# String constants that match the metric shape but are not metrics:
# logger/package names and similar call arguments.
ALLOWLIST = frozenset({"horovod_tpu", "horovod_tpu_init",
                       "horovod_tpu_torch"})

_METRIC_RE = re.compile(r"^horovod_[a-z0-9_]+$")

_PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _names_in_source(source: str) -> set[str]:
    names: set[str] = set()
    try:
        tree = ast.parse(source)
    except SyntaxError:
        return names
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        for arg in list(node.args) + [kw.value for kw in node.keywords]:
            if isinstance(arg, ast.Constant) \
                    and isinstance(arg.value, str) \
                    and _METRIC_RE.match(arg.value) \
                    and not arg.value.endswith("_") \
                    and arg.value not in ALLOWLIST:
                names.add(arg.value)
    return names


def registered_metric_names(root: str | None = None) -> set[str]:
    """Every metric name any module under ``root`` (default: the
    horovod_tpu_torch package) can register, by static AST scan."""
    base = Path(root or _PACKAGE_ROOT)
    names: set[str] = set()
    for path in sorted(base.rglob("*.py")):
        try:
            names |= _names_in_source(path.read_text())
        except OSError:
            continue
    return names


def undocumented_metrics(doc_text: str,
                         root: str | None = None) -> list[str]:
    """Metric names with no table row in the given documentation text
    (docs/observability.md's metric tables; names render backticked,
    optionally with an attached ``{label,...}`` set) — the same contract
    as analysis.rules.undocumented_rules: CI asserts this returns []."""
    rows = "\n".join(line for line in doc_text.splitlines()
                     if line.lstrip().startswith("|"))
    return sorted(name for name in registered_metric_names(root)
                  if f"`{name}`" not in rows and f"`{name}{{" not in rows)
