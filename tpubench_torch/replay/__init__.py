"""Record/replay plane (a copy of ``tpubench/replay``).

* :mod:`.bundle` — the portable, versioned replay bundle (``record``):
  distilled from a run's flight journal, gzip-JSON, byte-deterministic
  for a given run, in ``tpubench``'s format;
* :mod:`.driver` — ``replay <bundle>``: re-drives a bundle's scenario
  (serve or drill) through the caller's system configuration and stamps
  the replay-vs-original scorecard diff;
* :mod:`.gate` — the ``report --fail-on <metric><op><threshold>``
  exit-code contract that turns any diff into a CI gate.
"""
