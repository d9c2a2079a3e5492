"""Replay plane (``tpubench/replay``): only the ``report --fail-on`` gate
(:mod:`.gate`) is ported so far; recording and replaying bundles come
with ``ROADMAP.md`` A.7."""
