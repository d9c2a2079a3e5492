"""Replay plane (``tpubench/replay``). Ported so far: the ``report
--fail-on`` gate (:mod:`.gate`) and the replay stamp a serve run writes
into its flight journal (:mod:`.bundle`: ``config_fingerprint``,
``journal_replay_stamp``). Recording, loading and replaying bundles come
with ``ROADMAP.md`` A.7."""
