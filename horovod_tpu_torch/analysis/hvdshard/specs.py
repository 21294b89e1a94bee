"""Canonical sharding-spec tokens and the rule-table checks.

The port's own copy of what ``parallel/sharding.py``'s ``validate`` needs
from ``horovod_tpu/analysis/hvdshard/specs.py``: ``spec_token``,
``token_axes``, ``missing_axes`` (the HVD802 core) and ``rule_coverage``
(the HVD801 core), with the same results and the same order.  A spec is
the port's plain form: a sequence of per-dim entries, each None (a
replicated dim), a mesh axis name, or a tuple of axis names (a dim
sharded over several axes).

The canonical token grammar::

    ""            unannotated
    "*"           explicitly replicated (an empty spec)
    "(tp)"        dim 0 sharded over mesh axis tp
    "(dp+fsdp,*)" dim 0 over two axes, dim 1 replicated
"""
from __future__ import annotations

import re

__all__ = ["spec_token", "token_axes", "missing_axes", "rule_coverage"]


def spec_token(spec=None) -> str:
    """Canonical token of a spec: None (unannotated), an already canonical
    string (passed through), or a sequence of per-dim entries."""
    if spec is None:
        return ""
    if isinstance(spec, str):
        return spec.strip()
    entries = []
    for e in spec:
        if e is None:
            entries.append("*")
        elif isinstance(e, (tuple, list)):
            entries.append("+".join(str(a) for a in e))
        else:
            entries.append(str(e))
    if not entries:
        return "*"
    return "(" + ",".join(entries) + ")"


def token_axes(token: str) -> set[str]:
    """Mesh axis names a canonical token references."""
    if not token or token == "*":
        return set()
    inner = token[1:-1] if token.startswith("(") else token
    axes = set()
    for entry in inner.split(","):
        for ax in entry.split("+"):
            ax = ax.strip()
            if ax and ax != "*":
                axes.add(ax)
    return axes


def missing_axes(token: str, mesh_axes) -> list[str]:
    """Axes the token names that the mesh does not carry (HVD802)."""
    vocab = set(mesh_axes)
    return sorted(a for a in token_axes(token) if a not in vocab)


def rule_coverage(rules, paths):
    """HVD801: ``rules`` is the ordered ``[(pattern, token)]`` table (first
    match wins), ``paths`` the parameter paths (``"layer/attn/wq/kernel"``).

    Returns ``(dead_rules, uncovered)``: the patterns that match no path,
    and ``[(path, sibling pattern)]`` for each path that falls through to
    the replicated default while a path with the same parent matched a
    sharding (not replicated) rule, that sibling's rule named.
    """
    compiled = []
    for pat, tok in rules:
        try:
            compiled.append((pat, re.compile(pat), tok))
        except re.error:
            compiled.append((pat, None, tok))
    hits = {pat: 0 for pat, _, _ in compiled}
    matched_by = {}
    for path in paths:
        m = None
        for pat, rx, tok in compiled:
            if rx is not None and rx.search(path):
                m = (pat, tok)
                hits[pat] += 1
                break
        matched_by[path] = m

    dead = [pat for pat, rx, _ in compiled
            if rx is not None and hits[pat] == 0]

    def _parent(p: str) -> str:
        return p.rsplit("/", 1)[0] if "/" in p else ""

    sharded_sib: dict[str, str] = {}
    for path in sorted(matched_by):
        m = matched_by[path]
        if m is not None and m[1] not in ("", "*"):
            sharded_sib.setdefault(_parent(path), m[0])

    uncovered = []
    for path in sorted(matched_by):
        if matched_by[path] is not None:
            continue
        sib = sharded_sib.get(_parent(path))
        if sib is not None:
            uncovered.append((path, sib))
    return dead, uncovered
